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
// One forward design stands in for both TPU layouts. "Resident" against
// "tiled" is a question of 16 MB of VMEM; no FFN weight pair fits an SM's
// 227 KB, so the forward streams ff tiles at every width, as _fwd_kernel_tiled
// does:
//   ffn_fwd          one block per 32 rows. It keeps an f32 accumulator of
//                    out (32, d) in shared memory, and for each tile of 128
//                    hidden units computes relu(x·W1ᵀ + b1), drops, rounds,
//                    writes that tile of h, and adds h_tile·W2ᵀ into the
//                    accumulator. x and the weights stream through shared
//                    memory in chunks of 32 along the reduction, the next
//                    chunk on its way in registers while this one is used.
//   ffn_bwd_rows     the same walk backward: g tile = dy·W2, dh from h,
//                    written to a scratch in the storage dtype, and
//                    dh_tile·W1 added into an f32 accumulator of dx.
//   ffn_bwd_weights  dW1 and dW2 by 64×64 tiles, the rows split over
//                    gridDim.y; each block sums its rows in order into a
//                    partial, and blocks of 64 columns do the same for db1 and
//                    db2. ffn_reduce then adds the partials in split order. No
//                    float atomics: two runs with one seed agree bit for bit.
//
// What bounds it on the H100: operations. Forward 4·rows·d·ff FLOP against
// rows·(2d + ff) + 2·d·ff values moved (2.1 GFLOP and 7 MB at rows 1,024,
// d 256, ff 2048 in bf16), each backward kernel about the same again. The
// products run as f32 FMAs on CUDA cores (67 TFLOP/s peak), every thread a
// 4×4 register tile fed by 16-byte shared-memory loads (8 loads for 64 FMAs);
// a block reuses each weight for its 32 rows, so the weights stream from the
// 50 MB L2 once per 32 rows. Tensor cores (wgmma) are later work.
//
// Dropout is the layer kernels' 8-bit rule and stream (layer_common.cuh), site
// 2, counted by (row, column) of the (rows, ff) hidden: the mask does not
// depend on the tiling, and ops/fused_ffn.py::ffn_reference draws the same.
//
// Weights and their gradients are in nn.Linear's (out, in) layout: W1 (ff, d),
// W2 (d, ff); d and ff multiples of 4. S is the storage dtype (f32 or bf16);
// biases and gradients of weights and biases are f32. Plain C entry points,
// bound from Python with ctypes (ops/fused_ffn.py); each returns
// cudaGetLastError() after its launch.

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

template <typename S, bool TRANS>
__device__ __forceinline__ void fetch_w(const S* __restrict__ W, int ldw, int n_valid, int K,
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

template <typename S>
__device__ __forceinline__ void fetch_a(const S* __restrict__ A, int lda, int rows_valid, int K,
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

template <typename S, bool TRANS, bool AG>
__device__ __forceinline__ void tile_mm(const void* A, int lda, int rows_valid,
                                        const S* __restrict__ W, int ldw, int n_valid, int K,
                                        float* sW, float* sA, float (&acc)[4][4]) {
  float w[4][4], a[4];
  fetch_w<S, TRANS>(W, ldw, n_valid, K, 0, w);
  if (AG) fetch_a<S>(static_cast<const S*>(A), lda, rows_valid, K, 0, a);
  for (int kc = 0; kc < K; kc += BK) {
    store_w<TRANS>(sW, w);
    if (AG) store4(sA + (threadIdx.x >> 3) * LDK + (threadIdx.x & 7) * 4, a);
    __syncthreads();
    if (kc + BK < K) {  // the next chunk travels while this one is used
      fetch_w<S, TRANS>(W, ldw, n_valid, K, kc + BK, w);
      if (AG) fetch_a<S>(static_cast<const S*>(A), lda, rows_valid, K, kc + BK, a);
    }
    if (AG) chunk_fma<TRANS>(sA, LDK, sW, acc);
    else chunk_fma<TRANS>(static_cast<const float*>(A) + kc, lda, sW, acc);
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

// ---------------------------------------------------------------- forward

template <typename S>
struct FwdArgs {
  const S *x, *w1, *w2;
  const float *b1, *b2;
  const int* seed;
  S *out, *h;
};

template <typename S>
__global__ void __launch_bounds__(kThreads) ffn_fwd(FwdArgs<S> p, FfnShape sh) {
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
    tile_mm<S, true, true>(p.x + static_cast<size_t>(row0) * d, d, rows_valid,
                           p.w1 + static_cast<size_t>(j0) * d, d, nv, d, sW, sA, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ty + i, c = col_of<true>(tx, j);
        float hv = 0.f;
        if (r < rows_valid && c < nv) {
          const S v = st<S>(dr.apply(fmaxf(acc[i][j] + p.b1[j0 + c], 0.f), kSiteFfn, row0 + r,
                                     j0 + c));
          p.h[static_cast<size_t>(row0 + r) * ff + j0 + c] = v;
          hv = ld(v);
        }
        sH[r * BN + c] = hv;
      }
    // out += h_tile·W2ᵀ, 128 columns of d at a time (tile_mm's first barrier
    // comes after its first staging store and before it reads sH)
    for (int n0 = 0; n0 < d; n0 += BN) {
      const int nv2 = min(BN, d - n0);
      acc_load<true>(sAcc, d, n0, nv2, acc);
      tile_mm<S, true, false>(sH, BN, BM, p.w2 + static_cast<size_t>(n0) * ff + j0, ff, nv2, nv,
                              sW, sA, acc);
      acc_store<true>(sAcc, d, n0, nv2, acc);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows_valid * d; idx += blockDim.x)
    p.out[static_cast<size_t>(row0) * d + idx] = st<S>(sAcc[idx]);
}

// ---------------------------------------------------------------- backward, rows

template <typename S>
struct BwdArgs {
  const S *dy, *h, *w1, *w2;
  S *dx, *dh;
};

template <typename S>
__global__ void __launch_bounds__(kThreads) ffn_bwd_rows(BwdArgs<S> p, FfnShape sh) {
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
    tile_mm<S, false, true>(p.dy + static_cast<size_t>(row0) * d, d, rows_valid, p.w2 + j0, ff,
                            nv, d, sW, sA, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ty + i, c = col_of<false>(tx, j);
        float v = 0.f;
        if (r < rows_valid && c < nv) {
          const size_t at = static_cast<size_t>(row0 + r) * ff + j0 + c;
          const S dv = st<S>(ld(p.h[at]) > 0.f ? acc[i][j] / keep : 0.f);
          p.dh[at] = dv;
          v = ld(dv);
        }
        sH[r * BN + c] = v;
      }
    for (int n0 = 0; n0 < d; n0 += BN) {
      const int nv2 = min(BN, d - n0);
      acc_load<false>(sAcc, d, n0, nv2, acc);
      tile_mm<S, false, false>(sH, BN, BM, p.w1 + static_cast<size_t>(j0) * d + n0, d, nv2, nv,
                               sW, sA, acc);
      acc_store<false>(sAcc, d, n0, nv2, acc);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows_valid * d; idx += blockDim.x)
    p.dx[static_cast<size_t>(row0) * d + idx] = st<S>(sAcc[idx]);
}

// ---------------------------------------------------------------- backward, weights

template <typename S>
struct WgradArgs {
  const S *dy, *x, *h, *dh;
  float* part;  // (splits, 2·d·ff + ff + d): dW1 | dW2 | db1 | db2 per split
};

// gridDim.x: the 64×64 tiles of dW1 (ff, d), then of dW2 (d, ff), then blocks
// of 64 bias columns (db1 | db2); gridDim.y: the row splits. A tile is
// Σ_r A[r][m]·B[r][n] over the split's rows in order: dW1 = dhᵀ·x, dW2 = dyᵀ·h.
template <typename S>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_weights(WgradArgs<S> p, FfnShape sh, int rows_per_split) {
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
      const S* src = gc < ff ? p.dh + gc : p.dy + (gc - ff);
      const int ld_ = gc < ff ? ff : d;
      for (int r = r_begin + ry; r < r_end; r += 4) s += ld(src[static_cast<size_t>(r) * ld_]);
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
  const S* A = second ? p.dy : p.dh;
  const S* B = second ? p.h : p.x;
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

// out[i] = Σ_s part[s][i], in split order
__global__ void ffn_reduce(const float* __restrict__ part, float* __restrict__ out, size_t total,
                           int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s += part[k * total + i];
  out[i] = s;
}

// ---------------------------------------------------------------- launch

size_t rows_smem(const FfnShape& s) {
  return sizeof(float) * (static_cast<size_t>(BM) * s.d + BM * BN + kStage + BM * LDK);
}

template <typename S>
int fwd(void* const* ptr, const FfnShape& sh, cudaStream_t stream) {
  FwdArgs<S> a;
  a.x = static_cast<const S*>(ptr[0]);
  a.w1 = static_cast<const S*>(ptr[1]);
  a.b1 = static_cast<const float*>(ptr[2]);
  a.w2 = static_cast<const S*>(ptr[3]);
  a.b2 = static_cast<const float*>(ptr[4]);
  a.seed = static_cast<const int*>(ptr[5]);
  a.out = static_cast<S*>(ptr[6]);
  a.h = static_cast<S*>(ptr[7]);
  const size_t smem = rows_smem(sh);
  if (const int err = opt_in(ffn_fwd<S>, smem)) return err;
  ffn_fwd<S><<<(sh.rows + BM - 1) / BM, kThreads, smem, stream>>>(a, sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int bwd_rows(void* const* ptr, const FfnShape& sh, cudaStream_t stream) {
  BwdArgs<S> a;
  a.dy = static_cast<const S*>(ptr[0]);
  a.h = static_cast<const S*>(ptr[1]);
  a.w1 = static_cast<const S*>(ptr[2]);
  a.w2 = static_cast<const S*>(ptr[3]);
  a.dx = static_cast<S*>(ptr[4]);
  a.dh = static_cast<S*>(ptr[5]);
  const size_t smem = rows_smem(sh);
  if (const int err = opt_in(ffn_bwd_rows<S>, smem)) return err;
  ffn_bwd_rows<S><<<(sh.rows + BM - 1) / BM, kThreads, smem, stream>>>(a, sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int bwd_weights(void* const* ptr, const FfnShape& sh, int splits, cudaStream_t stream) {
  WgradArgs<S> a;
  a.dy = static_cast<const S*>(ptr[0]);
  a.x = static_cast<const S*>(ptr[1]);
  a.h = static_cast<const S*>(ptr[2]);
  a.dh = static_cast<const S*>(ptr[3]);
  float* part = static_cast<float*>(ptr[4]);
  float* out = static_cast<float*>(ptr[5]);
  a.part = splits > 1 ? part : out;  // one split writes the result itself
  const int d = sh.d, ff = sh.ff;
  // rows a split, a multiple of the chunk
  const int per = ((sh.rows + splits - 1) / splits + WK - 1) / WK * WK;
  const dim3 grid(2 * tiles(ff) * tiles(d) + (ff + d + 63) / 64, splits);
  ffn_bwd_weights<S><<<grid, kThreads, 0, stream>>>(a, sh, per);
  int err = static_cast<int>(cudaGetLastError());
  if (err || splits == 1) return err;
  const size_t total = 2 * static_cast<size_t>(d) * ff + ff + d;
  ffn_reduce<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, out, total, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows × d inputs, ff hidden units; thresh the 8-bit keep threshold (256: no
// dropout); is_bf16 picks the storage dtype (0 float32, 1 bfloat16). All
// pointers are device pointers of contiguous tensors; seed points to one int32.

int tgi_ffn_fwd(void* x, void* w1, void* b1, void* w2, void* b2, void* seed, void* out, void* h,
                int rows, int d, int ff, int thresh, int is_bf16, void* stream) {
  void* const ptr[] = {x, w1, b1, w2, b2, seed, out, h};
  const FfnShape sh{rows, d, ff, thresh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fwd<__nv_bfloat16>(ptr, sh, s) : fwd<float>(ptr, sh, s);
}

// dh: (rows, ff) scratch in the storage dtype, read by tgi_ffn_bwd_weights
int tgi_ffn_bwd_rows(void* dy, void* h, void* w1, void* w2, void* dx, void* dh, int rows, int d,
                     int ff, int thresh, int is_bf16, void* stream) {
  void* const ptr[] = {dy, h, w1, w2, dx, dh};
  const FfnShape sh{rows, d, ff, thresh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd_rows<__nv_bfloat16>(ptr, sh, s) : bwd_rows<float>(ptr, sh, s);
}

// out: 2·d·ff + ff + d f32 (dW1 | dW2 | db1 | db2); part: `splits` times that
// (unused when splits is 1). The rows are cut into `splits` ranges.
int tgi_ffn_bwd_weights(void* dy, void* x, void* h, void* dh, void* part, void* out, int rows,
                        int d, int ff, int splits, int is_bf16, void* stream) {
  void* const ptr[] = {dy, x, h, dh, part, out};
  const FfnShape sh{rows, d, ff, 256};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd_weights<__nv_bfloat16>(ptr, sh, splits, s)
                 : bwd_weights<float>(ptr, sh, splits, s);
}

const char* tgi_ffn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
