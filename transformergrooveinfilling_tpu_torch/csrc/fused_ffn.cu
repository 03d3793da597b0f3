// Fused feed-forward block for training, forward and backward, sm_90a.
//
// Replaces the Pallas TPU kernels of transformergrooveinfilling_tpu/ops/
// fused_ffn.py under ffn_train: the forward in both its layouts (_fwd_call →
// _fwd_kernel, weights resident in VMEM; _fwd_call_tiled → _fwd_kernel_tiled,
// weights streamed as ff tiles) and the backward (_bwd_call → _bwd_kernel):
//
//   h = round(drop(relu(x·W1ᵀ + b1)));  out = h·W2ᵀ + b2
//   g = dy·W2;  dh = round(where(h > 0, g / keep, 0));  dx = dh·W1
//   dW1 = dhᵀ·x;  dW2 = dyᵀ·h;  db1 = Σ dh;  db2 = Σ dy
//
// h, rounded to the storage dtype before the second product, is the only
// intermediate that reaches device memory and the backward's only residual:
// h > 0 says both that the mask kept the unit and that the ReLU was active.
//
// What bounds it on the H100: operations, 4·rows·d·ff FLOP for the forward,
// as much for the row backward and again for the weight gradients, against
// rows·(2d + ff) + 2·d·ff values moved (2.1 GFLOP and 7 MB at rows 1,024, d
// 256, ff 2048 in bf16). Only the tensor cores (989 TFLOP/s in bf16, 15× the
// CUDA cores' f32 rate) come near that bound, so the bf16 route is five
// products on one wgmma core (gemm_sm90.cuh: TMA into a 4-stage ring, one or
// two consumer warpgroups, f32 accumulators in registers, persistent blocks),
// each with its own epilogue on the accumulator fragment:
//   ffn_fwd_h        x·W1ᵀ (K-major A and B) → + b1, ReLU, mask, ÷ keep,
//                    round: h. One dropout draw per (row, 16 columns) a
//                    thread holds, bit for bit dropout_mask's.
//   ffn_fwd_out      h·W2ᵀ → + b2, round: out.
//   ffn_bwd_dh       dy·W2 (W2 read MN-major, wgmma's transpose bit) →
//                    h > 0 ? g / keep : 0, round: dh.
//   ffn_bwd_dx       dh·W1 (MN-major B) → round: dx.
//   ffn_bwd_weights  dhᵀ·x and dyᵀ·h in one launch (both operands MN-major,
//                    the reduction over rows), cut into row splits of whole
//                    64-row chunks when the tiles alone do not fill the card;
//                    f32 partials (dW1 | dW2 | db1 | db2 per split), the
//                    biases as column sums in a fixed order by blocks of
//                    their own; reduce_splits adds the splits in order. No float
//                    atomics: two runs with one seed agree bit for bit.
// A launch takes 64 × 64 tiles (one consumer warpgroup, several blocks an
// SM) where 128 × 128 ones would leave SMs idle, 128 × 256 for dh·W1 and for
// weight gradients whose tiles fill the card (their epilogues read nothing
// but the accumulator; those that read a bias or h spill at 128 × 256), and
// 128 × 128 otherwise: ops/fused_ffn.py::tile_configs, by measurement.
// The TPU kernel fuses the two forward products to keep h in VMEM; here h
// must reach device memory anyway as the backward's residual, and the fusion
// would cost an on-chip (rows, d) f32 accumulator, which is what capped the
// CUDA-core forward at one block an SM and d ≤ 1,508. The ragged edges are
// TMA's zero fill; the epilogues mask their stores. d and ff must be
// multiples of 8 (TMA's 16-byte strides); rows is free. On an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py, phase 17), device time per launch at
// rows 4,096 × d 1024 × ff 4096: ffn_fwd_h 0.086 ms, ffn_fwd_out 0.060,
// ffn_bwd_dh 0.092, ffn_bwd_dx 0.049, ffn_bwd_weights 0.143 (38-71 % of the
// tensor cores' bound), where the CUDA-core kernels took 3.75 ms forward and
// 3.47 + 2.02 backward.
//
// f32 storage keeps the CUDA-core kernels below (ffn_fwd, ffn_bwd_rows,
// ffn_bwd_weights): the tensor cores' f32 mode is TF32, which would miss the
// f32 bars of 1e-4. They stream ff tiles of 128 through shared memory with a
// (32, d) f32 accumulator a block (d ≤ 1,508), 4×4 register tiles of f32 FMAs.
//
// Dropout is the layer kernels' 8-bit rule and stream (layer_common.cuh), site
// 2, counted by (row, column) of the (rows, ff) hidden: the mask does not
// depend on the tiling, and ops/fused_ffn.py::ffn_reference draws the same.
//
// Weights and their gradients are in nn.Linear's (out, in) layout: W1 (ff, d),
// W2 (d, ff). Biases and the gradients of weights and biases are f32. Plain C
// entry points, bound from Python with ctypes (ops/fused_ffn.py); each returns
// cudaGetLastError() after its launch.

#include "epilogues_sm90.cuh"
#include "vec4.cuh"

namespace {

constexpr int kSiteFfn = 2;
constexpr int BM = 32;    // rows a block
constexpr int BN = 128;   // output columns a tile
constexpr int BK = 32;    // reduction chunk
constexpr int LDK = BK + 4;        // row stride of a staged tile that is contiguous along k
constexpr int kStage = BN * LDK;   // floats of the weight staging buffer (≥ BK·BN)
constexpr int WK = 32;    // rows a chunk in the weight-gradient kernel

struct FfnShape {
  int rows, d, ff, thresh;
};

// ---------------------------------------------------------------- one tile product
//
// acc[i][j] += Σ_{k<K} A(r_i, k)·B(k, c_j) for the 32 × 128 tile of a block of
// 256 threads: lane tx, warp ty; rows r_i = 4·ty + i.
//   TRANS true:  B(k, n) = W[n·ldw + k] (a forward product against an
//                (out, in) weight), columns c_j = tx + 32·j.
//   TRANS false: B(k, n) = W[k·ldw + n] (a backward product), c_j = 4·tx + j.
//   AG true:  A is in device memory (S, row stride lda, rows ≥ rows_valid
//             read as 0) and is staged through sA; AG false: A is a (32, lda)
//             f32 tile in shared memory.
// Columns n ≥ n_valid and k ≥ K read as 0 (K and, without TRANS, n_valid are
// multiples of 4). Both layouts keep every shared-memory load 16 bytes wide
// and free of bank conflicts: with TRANS the staged tile is sW[n][LDK] and
// the lanes' rows lie 36 floats apart; without, sW[k][BN] and the lanes read
// neighbouring float4s.

template <bool TRANS>
__device__ __forceinline__ int col_of(int tx, int j) { return TRANS ? tx + 32 * j : 4 * tx + j; }

template <bool TRANS>
__device__ __forceinline__ void fetch_w(const float* __restrict__ W, int ldw, int n_valid, int K,
                                        int kc, float (&w)[4][4]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = TRANS ? (t >> 3) + 32 * i : (t & 31) * 4;
    const int k = kc + (TRANS ? (t & 7) * 4 : (t >> 5) + 8 * i);
    if (n < n_valid && k < K) {
      load4(TRANS ? W + static_cast<size_t>(n) * ldw + k : W + static_cast<size_t>(k) * ldw + n,
            w[i]);
    } else {
      w[i][0] = w[i][1] = w[i][2] = w[i][3] = 0.f;
    }
  }
}

template <bool TRANS>
__device__ __forceinline__ void store_w(float* sW, const float (&w)[4][4]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (TRANS) store4(sW + ((t >> 3) + 32 * i) * LDK + (t & 7) * 4, w[i]);
    else store4(sW + ((t >> 5) + 8 * i) * BN + (t & 31) * 4, w[i]);
  }
}

__device__ __forceinline__ void fetch_a(const float* __restrict__ A, int lda, int rows_valid, int K,
                                        int kc, float (&a)[4]) {
  const int r = threadIdx.x >> 3, k = kc + (threadIdx.x & 7) * 4;
  if (r < rows_valid && k < K) {
    load4(A + static_cast<size_t>(r) * lda + k, a);
  } else {
    a[0] = a[1] = a[2] = a[3] = 0.f;
  }
}

// one chunk of BK: A rows of stride lda (shared memory, f32), the staged sW
template <bool TRANS>
__device__ __forceinline__ void chunk_fma(const float* A, int lda, const float* sW,
                                          float (&acc)[4][4]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 4) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(A + (4 * ty + i) * lda + kk);
      a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
    }
    if (TRANS) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(sW + (tx + 32 * j) * LDK + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(a[i][0], b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i][1], b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i][2], b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i][3], b.w, acc[i][j]);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b = *reinterpret_cast<const float4*>(sW + (kk + q) * BN + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(a[i][q], b.x, acc[i][0]);
          acc[i][1] = fmaf(a[i][q], b.y, acc[i][1]);
          acc[i][2] = fmaf(a[i][q], b.z, acc[i][2]);
          acc[i][3] = fmaf(a[i][q], b.w, acc[i][3]);
        }
      }
    }
  }
}

template <bool TRANS, bool AG>
__device__ __forceinline__ void tile_mm(const float* A, int lda, int rows_valid,
                                        const float* __restrict__ W, int ldw, int n_valid, int K,
                                        float* sW, float* sA, float (&acc)[4][4]) {
  float w[4][4], a[4];
  fetch_w<TRANS>(W, ldw, n_valid, K, 0, w);
  if (AG) fetch_a(A, lda, rows_valid, K, 0, a);
  for (int kc = 0; kc < K; kc += BK) {
    store_w<TRANS>(sW, w);
    if (AG) store4(sA + (threadIdx.x >> 3) * LDK + (threadIdx.x & 7) * 4, a);
    __syncthreads();
    if (kc + BK < K) {  // the next chunk travels while this one is used
      fetch_w<TRANS>(W, ldw, n_valid, K, kc + BK, w);
      if (AG) fetch_a(A, lda, rows_valid, K, kc + BK, a);
    }
    if (AG) chunk_fma<TRANS>(sA, LDK, sW, acc);
    else chunk_fma<TRANS>(A + kc, lda, sW, acc);
    __syncthreads();
  }
}

// acc ← the block's accumulator tile at columns n0.. (0 beyond n_valid), and back
template <bool TRANS>
__device__ __forceinline__ void acc_load(const float* sAcc, int d, int n0, int n_valid,
                                         float (&acc)[4][4]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col_of<TRANS>(tx, j);
      acc[i][j] = c < n_valid ? sAcc[(4 * ty + i) * d + n0 + c] : 0.f;
    }
}
template <bool TRANS>
__device__ __forceinline__ void acc_store(float* sAcc, int d, int n0, int n_valid,
                                          const float (&acc)[4][4]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col_of<TRANS>(tx, j);
      if (c < n_valid) sAcc[(4 * ty + i) * d + n0 + c] = acc[i][j];
    }
}

__device__ __forceinline__ void acc_zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// ---------------------------------------------------------------- f32 route: forward

struct FwdArgs {
  const float *x, *w1, *w2, *b1, *b2;
  const int* seed;
  float *out, *h;
};

__global__ void __launch_bounds__(kThreads) ffn_fwd(FwdArgs p, FfnShape sh) {
  extern __shared__ __align__(16) float sm[];
  const int d = sh.d, ff = sh.ff;
  float* sAcc = sm;             // (BM, d): out, f32 until the end
  float* sH = sAcc + BM * d;    // (BM, BN): this tile of h
  float* sW = sH + BM * BN;     // weight staging
  float* sA = sW + kStage;      // (BM, LDK): x staging
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int row0 = blockIdx.x * BM, rows_valid = min(BM, sh.rows - row0);
  const Drop dr = make_drop(p.seed, sh.thresh);
  for (int idx = threadIdx.x; idx < BM * d; idx += blockDim.x) sAcc[idx] = p.b2[idx % d];

  float acc[4][4];
  for (int j0 = 0; j0 < ff; j0 += BN) {
    const int nv = min(BN, ff - j0);
    acc_zero(acc);
    tile_mm<true, true>(p.x + static_cast<size_t>(row0) * d, d, rows_valid,
                        p.w1 + static_cast<size_t>(j0) * d, d, nv, d, sW, sA, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ty + i, c = col_of<true>(tx, j);
        float hv = 0.f;
        if (r < rows_valid && c < nv) {
          hv = dr.apply(fmaxf(acc[i][j] + p.b1[j0 + c], 0.f), kSiteFfn, row0 + r, j0 + c);
          p.h[static_cast<size_t>(row0 + r) * ff + j0 + c] = hv;
        }
        sH[r * BN + c] = hv;
      }
    // out += h_tile·W2ᵀ, 128 columns of d at a time (tile_mm's first barrier
    // comes after its first staging store and before it reads sH)
    for (int n0 = 0; n0 < d; n0 += BN) {
      const int nv2 = min(BN, d - n0);
      acc_load<true>(sAcc, d, n0, nv2, acc);
      tile_mm<true, false>(sH, BN, BM, p.w2 + static_cast<size_t>(n0) * ff + j0, ff, nv2, nv, sW,
                           sA, acc);
      acc_store<true>(sAcc, d, n0, nv2, acc);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows_valid * d; idx += blockDim.x)
    p.out[static_cast<size_t>(row0) * d + idx] = sAcc[idx];
}

// ---------------------------------------------------------------- backward, rows

struct BwdArgs {
  const float *dy, *h, *w1, *w2;
  float *dx, *dh;
};

__global__ void __launch_bounds__(kThreads) ffn_bwd_rows(BwdArgs p, FfnShape sh) {
  extern __shared__ __align__(16) float sm[];
  const int d = sh.d, ff = sh.ff;
  float* sAcc = sm;             // (BM, d): dx, f32 until the end
  float* sH = sAcc + BM * d;    // (BM, BN): this tile of dh
  float* sW = sH + BM * BN;
  float* sA = sW + kStage;      // (BM, LDK): dy staging
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int row0 = blockIdx.x * BM, rows_valid = min(BM, sh.rows - row0);
  const float keep = sh.thresh / 256.f;
  for (int idx = threadIdx.x; idx < BM * d; idx += blockDim.x) sAcc[idx] = 0.f;

  float acc[4][4];
  for (int j0 = 0; j0 < ff; j0 += BN) {
    const int nv = min(BN, ff - j0);
    acc_zero(acc);
    tile_mm<false, true>(p.dy + static_cast<size_t>(row0) * d, d, rows_valid, p.w2 + j0, ff, nv,
                         d, sW, sA, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ty + i, c = col_of<false>(tx, j);
        float v = 0.f;
        if (r < rows_valid && c < nv) {
          const size_t at = static_cast<size_t>(row0 + r) * ff + j0 + c;
          v = p.h[at] > 0.f ? acc[i][j] / keep : 0.f;
          p.dh[at] = v;
        }
        sH[r * BN + c] = v;
      }
    for (int n0 = 0; n0 < d; n0 += BN) {
      const int nv2 = min(BN, d - n0);
      acc_load<false>(sAcc, d, n0, nv2, acc);
      tile_mm<false, false>(sH, BN, BM, p.w1 + static_cast<size_t>(j0) * d + n0, d, nv2, nv, sW,
                            sA, acc);
      acc_store<false>(sAcc, d, n0, nv2, acc);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows_valid * d; idx += blockDim.x)
    p.dx[static_cast<size_t>(row0) * d + idx] = sAcc[idx];
}

// ---------------------------------------------------------------- backward, weights

struct WgradArgs {
  const float *dy, *x, *h, *dh;
  float* part;  // (splits, 2·d·ff + ff + d): dW1 | dW2 | db1 | db2 per split
};

// gridDim.x: the 64×64 tiles of dW1 (ff, d), then of dW2 (d, ff), then blocks
// of 64 bias columns (db1 | db2); gridDim.y: the row splits. A tile is
// Σ_r A[r][m]·B[r][n] over the split's rows in order: dW1 = dhᵀ·x, dW2 = dyᵀ·h.
__global__ void __launch_bounds__(kThreads)
ffn_bwd_weights(WgradArgs p, FfnShape sh, int rows_per_split) {
  __shared__ __align__(16) float sA[WK * kTile];
  __shared__ __align__(16) float sB[WK * kTile];
  const int d = sh.d, ff = sh.ff, t = threadIdx.x;
  const size_t total = 2 * static_cast<size_t>(d) * ff + ff + d;
  float* base = p.part + blockIdx.y * total;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(sh.rows, r_begin + rows_per_split);
  const int n_tiles = tiles(ff) * tiles(d);
  int b = blockIdx.x;

  if (b >= 2 * n_tiles) {  // 64 columns of db1 | db2, four rows at a time
    const int cx = t & 63, ry = t >> 6, gc = (b - 2 * n_tiles) * 64 + cx;
    float s = 0.f;
    if (gc < ff + d) {
      const float* src = gc < ff ? p.dh + gc : p.dy + (gc - ff);
      const int ld_ = gc < ff ? ff : d;
      for (int r = r_begin + ry; r < r_end; r += 4) s += src[static_cast<size_t>(r) * ld_];
    }
    sA[ry * 64 + cx] = s;
    __syncthreads();
    if (ry == 0 && gc < ff + d)
      base[2 * static_cast<size_t>(d) * ff + gc] = ((sA[cx] + sA[64 + cx]) + sA[128 + cx]) +
                                                    sA[192 + cx];
    return;
  }

  const bool second = b >= n_tiles;
  if (second) b -= n_tiles;
  const float* A = second ? p.dy : p.dh;
  const float* B = second ? p.h : p.x;
  const int M = second ? d : ff, N = second ? ff : d;
  const int m0 = (b / tiles(N)) * kTile, n0 = (b % tiles(N)) * kTile;
  const int tx = t & 15, ty = t >> 4;
  // staging: each thread two float4s of each operand, rows rr and rr + 16
  const int rr = t >> 4, q4 = (t & 15) * 4;
  const bool a_in = m0 + q4 < M, b_in = n0 + q4 < N;
  float acc[4][4], ra[2][4], rb[2][4];
  acc_zero(acc);

  auto fetch = [&](int r0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + rr + 16 * i;
      if (r < r_end && a_in) load4(A + static_cast<size_t>(r) * M + m0 + q4, ra[i]);
      else ra[i][0] = ra[i][1] = ra[i][2] = ra[i][3] = 0.f;
      if (r < r_end && b_in) load4(B + static_cast<size_t>(r) * N + n0 + q4, rb[i]);
      else rb[i][0] = rb[i][1] = rb[i][2] = rb[i][3] = 0.f;
    }
  };

  fetch(r_begin);
  for (int r0 = r_begin; r0 < r_end; r0 += WK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      store4(sA + (rr + 16 * i) * kTile + q4, ra[i]);
      store4(sB + (rr + 16 * i) * kTile + q4, rb[i]);
    }
    __syncthreads();
    if (r0 + WK < r_end) fetch(r0 + WK);
#pragma unroll
    for (int k = 0; k < WK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(sA + k * kTile + 4 * ty);
      const float4 bb = *reinterpret_cast<const float4*>(sB + k * kTile + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = base + (second ? static_cast<size_t>(d) * ff : 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- bf16 route

// The products' epilogues are in epilogues_sm90.cuh (shared with the layer
// chains of layer_sm90.cu).

// ---------------------------------------------------------------- launch

size_t rows_smem(const FfnShape& s) {
  return sizeof(float) * (static_cast<size_t>(BM) * s.d + BM * BN + kStage + BM * LDK);
}

int fwd(void* const* ptr, const FfnShape& sh, cudaStream_t stream) {
  FwdArgs a;
  a.x = static_cast<const float*>(ptr[0]);
  a.w1 = static_cast<const float*>(ptr[1]);
  a.b1 = static_cast<const float*>(ptr[2]);
  a.w2 = static_cast<const float*>(ptr[3]);
  a.b2 = static_cast<const float*>(ptr[4]);
  a.seed = static_cast<const int*>(ptr[5]);
  a.out = static_cast<float*>(ptr[6]);
  a.h = static_cast<float*>(ptr[7]);
  const size_t smem = rows_smem(sh);
  if (const int err = opt_in(ffn_fwd, smem)) return err;
  ffn_fwd<<<(sh.rows + BM - 1) / BM, kThreads, smem, stream>>>(a, sh);
  return static_cast<int>(cudaGetLastError());
}

int bwd_rows(void* const* ptr, const FfnShape& sh, cudaStream_t stream) {
  BwdArgs a;
  a.dy = static_cast<const float*>(ptr[0]);
  a.h = static_cast<const float*>(ptr[1]);
  a.w1 = static_cast<const float*>(ptr[2]);
  a.w2 = static_cast<const float*>(ptr[3]);
  a.dx = static_cast<float*>(ptr[4]);
  a.dh = static_cast<float*>(ptr[5]);
  const size_t smem = rows_smem(sh);
  if (const int err = opt_in(ffn_bwd_rows, smem)) return err;
  ffn_bwd_rows<<<(sh.rows + BM - 1) / BM, kThreads, smem, stream>>>(a, sh);
  return static_cast<int>(cudaGetLastError());
}

int bwd_weights(void* const* ptr, const FfnShape& sh, int splits, cudaStream_t stream) {
  WgradArgs a;
  a.dy = static_cast<const float*>(ptr[0]);
  a.x = static_cast<const float*>(ptr[1]);
  a.h = static_cast<const float*>(ptr[2]);
  a.dh = static_cast<const float*>(ptr[3]);
  float* part = static_cast<float*>(ptr[4]);
  float* out = static_cast<float*>(ptr[5]);
  a.part = splits > 1 ? part : out;  // one split writes the result itself
  const int d = sh.d, ff = sh.ff;
  // rows a split, a multiple of the chunk
  const int per = ((sh.rows + splits - 1) / splits + WK - 1) / WK * WK;
  const dim3 grid(2 * tiles(ff) * tiles(d) + (ff + d + 63) / 64, splits);
  ffn_bwd_weights<<<grid, kThreads, 0, stream>>>(a, sh, per);
  int err = static_cast<int>(cudaGetLastError());
  if (err || splits == 1) return err;
  const size_t total = 2 * static_cast<size_t>(d) * ff + ff + d;
  reduce_splits<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                  stream>>>(part, out, total, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 route. rows × d inputs, ff hidden units; thresh the 8-bit keep
// threshold (256: no dropout); config the tile shape (gemm_sm90.cuh's run; another
// returns cudaErrorInvalidValue and launches nothing). All
// pointers are device pointers of contiguous bf16 tensors, 16-byte aligned,
// except the f32 biases and the int32 seed.

int tgi_ffn_fwd_h(void* x, void* w1, void* b1, void* seed, void* h, int rows, int d, int ff,
                  int thresh, int config, void* stream) {
  const Operand a{x, rows}, b{w1, ff};
  const EpiHidden<bf16> epi{{}, static_cast<bf16*>(h), static_cast<const float*>(b1),
                      static_cast<const int*>(seed), rows, ff, thresh, kSiteFfn};
  return run<0b011, false, false>(config, &a, &b, 1, d, d, 1, 0, epi,
                                  static_cast<cudaStream_t>(stream));
}

int tgi_ffn_fwd_out(void* h, void* w2, void* b2, void* out, int rows, int d, int ff, int config,
                    void* stream) {
  const Operand a{h, rows}, b{w2, d};
  const EpiOut<bf16> epi{{}, static_cast<bf16*>(out), static_cast<const float*>(b2), rows, d};
  return run<0b011, false, false>(config, &a, &b, 1, ff, ff, 1, 0, epi,
                                  static_cast<cudaStream_t>(stream));
}

int tgi_ffn_bwd_dh(void* dy, void* w2, void* h, void* dh, int rows, int d, int ff, int thresh,
                   int config, void* stream) {
  const Operand a{dy, rows}, b{w2, ff};
  const EpiDh<bf16> epi{{}, static_cast<bf16*>(dh), static_cast<const bf16*>(h), rows, ff, thresh};
  return run<0b011, false, true>(config, &a, &b, 1, d, d, 1, 0, epi,
                                 static_cast<cudaStream_t>(stream));
}

int tgi_ffn_bwd_dx(void* dh, void* w1, void* dx, int rows, int d, int ff, int config,
                   void* stream) {
  const Operand a{dh, rows}, b{w1, d};
  const EpiRound<bf16> epi{{}, static_cast<bf16*>(dx), nullptr, rows, d};
  return run<0b101, false, true>(config, &a, &b, 1, ff, ff, 1, 0, epi,
                                 static_cast<cudaStream_t>(stream));
}

// part: `splits` × (2·d·ff + ff + d) f32 (dW1 | dW2 | db1 | db2 each), the
// rows cut into splits of rows_per_split (a multiple of 64 when splits > 1)
int tgi_ffn_bwd_wgrad(void* dy, void* x, void* h, void* dh, void* part, int rows, int d, int ff,
                      int splits, int rows_per_split, int config, void* stream) {
  const Operand a[2] = {{dh, ff}, {dy, d}}, b[2] = {{x, d}, {h, ff}};
  EpiWgrad<bf16> epi{};  // dW1 = dhᵀ·x, dW2 = dyᵀ·h; db1 = Σ dh, db2 = Σ dy
  epi.part = static_cast<float*>(part);
  epi.m[0] = ff, epi.n[0] = d, epi.m[1] = d, epi.n[1] = ff;
  epi.seg[0].x = dh, epi.seg[0].width = ff;
  epi.seg[1].x = dy, epi.seg[1].width = d;
  const int bias_blocks = wgrad_layout(epi, 2, 2);
  return run<0b110, true, true>(config, a, b, 2, rows, rows_per_split, splits, bias_blocks, epi,
                                static_cast<cudaStream_t>(stream));
}

// out[i] = Σ_s part[s][i] in split order, for i < total
int tgi_ffn_reduce(void* part, void* out, int total, int splits, void* stream) {
  reduce_splits<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(part),
                                                       static_cast<float*>(out), total, splits);
  return static_cast<int>(cudaGetLastError());
}

// f32 route (the CUDA-core kernels): the same shapes and threshold.

int tgi_ffn_fwd_f32(void* x, void* w1, void* b1, void* w2, void* b2, void* seed, void* out,
                    void* h, int rows, int d, int ff, int thresh, void* stream) {
  void* const ptr[] = {x, w1, b1, w2, b2, seed, out, h};
  return fwd(ptr, FfnShape{rows, d, ff, thresh}, static_cast<cudaStream_t>(stream));
}

// dh: (rows, ff) scratch, read by tgi_ffn_bwd_weights_f32
int tgi_ffn_bwd_rows_f32(void* dy, void* h, void* w1, void* w2, void* dx, void* dh, int rows,
                         int d, int ff, int thresh, void* stream) {
  void* const ptr[] = {dy, h, w1, w2, dx, dh};
  return bwd_rows(ptr, FfnShape{rows, d, ff, thresh}, static_cast<cudaStream_t>(stream));
}

// out: 2·d·ff + ff + d f32 (dW1 | dW2 | db1 | db2); part: `splits` times that
// (unused when splits is 1); the reduce is part of the call.
int tgi_ffn_bwd_weights_f32(void* dy, void* x, void* h, void* dh, void* part, void* out,
                            int rows, int d, int ff, int splits, void* stream) {
  void* const ptr[] = {dy, x, h, dh, part, out};
  return bwd_weights(ptr, FfnShape{rows, d, ff, 256}, splits,
                            static_cast<cudaStream_t>(stream));
}

const char* tgi_ffn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
