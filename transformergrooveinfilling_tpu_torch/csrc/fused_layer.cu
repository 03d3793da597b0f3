// Whole post-LN encoder layer for training, forward and backward, sm_90a:
// the f32 route (the bf16 route is layer_sm90.cu's chain of launches).
//
// Replaces the Pallas TPU kernel transformergrooveinfilling_tpu/ops/
// fused_layer.py::encoder_layer_train (forward _fwd_call/_fwd_kernel,
// backward _bwd_call/_bwd_kernel):
//
//   qkv = x·Wqkv + b;  per head P = softmax(QKᵀ/√hd), A = drop(P)·V
//   y1 = LN1(x + drop(A·Wo + bo));  h = drop(relu(y1·W1 + b1))
//   y2 = LN2(y1 + drop(h·W2 + b2))
//
// Three kernels (their shared device functions, which the decoder layer's
// kernels use too, are in layer_common.cuh):
//   layer_fwd          one block per sequence (T ≤ 32 rows): writes y and
//                      the residuals qkv, a1, h_drop, a2.
//   layer_bwd_rows     one block per sequence: recomputes LN statistics and
//                      the attention forward from the stored qkv and a1,
//                      writes dx and the row-wise gradients (df, dhpre,
//                      dproj, dqkv, dy1·zh1, dy1, dy·zh2, LN1 mean/rstd)
//                      into an f32 scratch.
//   layer_bwd_weights  one block per 64×64 tile of dWqkv, dWo, dW1, dW2
//                      (Σ over all rows of dYᵀ·X, sequence by sequence, in
//                      a fixed order), plus blocks that sum the bias and LN
//                      parameter gradients, 32 columns a block. No atomics:
//                      two runs with one seed agree bit for bit.
//
// What bounds it on the H100: about 1.05 MFLOP of products per row forward
// and twice that backward at d 256 / ff 512, on CUDA cores (f32 FMAs,
// 67 TFLOP/s peak), against a few KB of activations per row: compute-bound.
// The weights (1 MB in bf16) do not fit a block's 227 KB of shared memory;
// each thread streams one output's weights from global memory, where the
// whole set stays in the 50 MB L2, and reuses every weight for all T rows of its
// block (T accumulators in registers). Activations of one sequence live in
// shared memory in f32, buffers reused as the layer goes (h takes qkv's
// place). Neither the probabilities, nor the attention output, nor any mask
// ever reaches device memory: the backward and the weight-gradient kernel
// recompute them (the same device functions in the same order, so the
// recompute is bit-identical to the forward).
//
// Dropout sites (layer_common.cuh has the stream): 0 attention probabilities
// (row = (seq·H + head)·T + i, col = j), 1 the attention projection, 2 the FFN
// hidden, 3 the FFN output (row = global row).
//
// Everything is f32 here: the TPU kernel's rounding points (qkv, P after
// dropout, the attention output, y1, h, rounded to the storage dtype) round
// only on the bf16 route, layer_sm90.cu; LayerNorms take a one-pass variance,
// clamped at 0.
//
// Weights and their gradients are in nn.Linear's (out, in) layout: Wqkv
// (3d, d), Wo (d, d), W1 (ff, d), W2 (d, ff). Plain C entry points, bound
// from Python with ctypes (ops/fused_layer.py); each returns
// cudaGetLastError() after its launch.

#include "layer_common.cuh"

namespace {

constexpr int kSiteAttn = 0, kSiteProj = 1, kSiteFfn = 2, kSiteOut = 3;

// ---------------------------------------------------------------- forward

struct FwdArgs {
  const float *x, *wqkv, *wo, *w1, *w2;
  const float *bqkv, *bo, *g1, *b1, *b1f, *b2f, *g2, *b2;
  const int* seed;
  float *y, *qkv, *a1, *h, *a2;
};

__global__ void __launch_bounds__(kThreads) layer_fwd(FwdArgs p, Shape sh) {
  extern __shared__ __align__(16) float sm[];
  const int T = sh.T, d = sh.d, H = sh.H, ff = sh.ff, d3 = 3 * d;
  const int hd = d / H, big = d3 > ff ? d3 : ff;
  float* sX = sm;             // (T, d): x, then y1
  float* sBig = sX + T * d;   // (T, 3d): qkv; then a1 (T, d); then h (T, ff)
  float* sA = sBig + T * big;  // (T, d): attention output, then a2
  float* sP = sA + T * d;     // (T, T)
  const int s = blockIdx.x, r0 = s * T;
  const Drop dr = make_drop(p.seed, sh.thresh);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;

  for (int idx = threadIdx.x; idx < T * d; idx += blockDim.x)
    sX[idx] = ld(p.x[static_cast<size_t>(r0) * d + idx]);
  __syncthreads();

  rowmm<float, true>(sX, d, p.wqkv, d, d3, T, [&](int r, int n, float acc) {
    const float v = acc + p.bqkv[n];
    sBig[r * d3 + n] = ld(v);
    p.qkv[static_cast<size_t>(r0 + r) * d3 + n] = v;
  });
  __syncthreads();

  for (int hh = 0; hh < H; ++hh)
    attn_head_fwd<float>(sBig + hh * hd, d3, sBig + d + hh * hd, sBig + 2 * d + hh * hd, d3, hd, T,
                     scale, false, dr, kSiteAttn, (s * H + hh) * T, sP, sA + hh * hd, d);

  // a1 = x + drop(A·Wo + bo), into sBig (qkv is no longer needed)
  rowmm<float, true>(sA, d, p.wo, d, d, T, [&](int r, int n, float acc) {
    const float pr = dr.apply(acc + p.bo[n], kSiteProj, r0 + r, n);
    const float a = sX[r * d + n] + pr;
    sBig[r * d + n] = a;
    p.a1[static_cast<size_t>(r0 + r) * d + n] = a;
  });
  __syncthreads();
  for (int r = warp; r < T; r += nwarps) {
    float mu, rstd;
    const float* a = sBig + r * d;
    ln_stats(d, [&](int c) { return a[c]; }, mu, rstd);
    for (int c = lane; c < d; c += 32)
      sX[r * d + c] = affine(zhat(a[c], mu, rstd), p.g1[c], p.b1[c]);
  }
  __syncthreads();

  // h = drop(relu(y1·W1 + b1)), into sBig
  rowmm<float, true>(sX, d, p.w1, d, ff, T, [&](int r, int n, float acc) {
    const float v = dr.apply(fmaxf(acc + p.b1f[n], 0.f), kSiteFfn, r0 + r, n);
    sBig[r * ff + n] = ld(v);
    p.h[static_cast<size_t>(r0 + r) * ff + n] = v;
  });
  __syncthreads();

  // a2 = y1 + drop(h·W2 + b2), into sA
  rowmm<float, true>(sBig, ff, p.w2, ff, d, T, [&](int r, int n, float acc) {
    const float f = dr.apply(acc + p.b2f[n], kSiteOut, r0 + r, n);
    const float a = sX[r * d + n] + f;
    sA[r * d + n] = a;
    p.a2[static_cast<size_t>(r0 + r) * d + n] = a;
  });
  __syncthreads();
  for (int r = warp; r < T; r += nwarps) {
    float mu, rstd;
    const float* a = sA + r * d;
    ln_stats(d, [&](int c) { return a[c]; }, mu, rstd);
    for (int c = lane; c < d; c += 32)
      p.y[static_cast<size_t>(r0 + r) * d + c] =
          affine(zhat(a[c], mu, rstd), p.g2[c], p.b2[c]);
  }
}

// ---------------------------------------------------------------- backward, rows

// scratch columns per row (f32), width 8d + ff + 2
struct Cols {
  int df, dhpre, dproj, dqkv, dy1zh1, dy1, dyzh2, stats, width;
  __host__ __device__ Cols(int d, int ff)
      : df(0), dhpre(d), dproj(d + ff), dqkv(2 * d + ff), dy1zh1(5 * d + ff),
        dy1(6 * d + ff), dyzh2(7 * d + ff), stats(8 * d + ff), width(8 * d + ff + 2) {}
};

struct BwdArgs {
  const float *dy, *x, *qkv, *a1, *h, *a2, *wqkv, *wo, *w1, *w2;
  const float *g1, *b1, *g2;
  const int* seed;
  float* dx;
  float* scratch;
};

__global__ void __launch_bounds__(kThreads) layer_bwd_rows(BwdArgs p, Shape sh) {
  extern __shared__ __align__(16) float sm[];
  const int T = sh.T, d = sh.d, H = sh.H, ff = sh.ff, d3 = 3 * d;
  const int hd = d / H, big = d3 > ff ? d3 : ff;
  const Cols col(d, ff);
  float* B0 = sm;              // (T, d): da2, then da1
  float* B1 = B0 + T * d;      // (T, d): df, then dproj
  float* B2 = B1 + T * d;      // (T, d): zh1, then dattn
  float* sBig = B2 + T * d;    // (T, ff): dhpre; (T, 3d): qkv, then dqkv
  float* sP = sBig + T * big;  // (T, T): P, then P after dropout
  float* sD = sP + T * T;      // (T, T): dP, then dS
  float* sStat = sD + T * T;   // (T, 2): LN1 mean, rstd
  const int s = blockIdx.x, r0 = s * T;
  const Drop dr = make_drop(p.seed, sh.thresh);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float* scr = p.scratch + static_cast<size_t>(r0) * col.width;

  // LN2 backward from the stored a2; df = drop(da2)
  for (int r = warp; r < T; r += nwarps) {
    const size_t g = static_cast<size_t>(r0 + r) * d;
    float mu, rstd;
    ln_stats(d, [&](int c) { return ld(p.a2[g + c]); }, mu, rstd);
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float z = zhat(ld(p.a2[g + c]), mu, rstd);
      const float dyv = ld(p.dy[g + c]);
      const float dz = dyv * p.g2[c];
      m1 += dz;
      m2 = fmaf(dz, z, m2);
      scr[r * col.width + col.dyzh2 + c] = dyv * z;
    }
    m1 = warp_sum(m1) / d;
    m2 = warp_sum(m2) / d;
    for (int c = lane; c < d; c += 32) {
      const float z = zhat(ld(p.a2[g + c]), mu, rstd);
      const float dz = ld(p.dy[g + c]) * p.g2[c];
      const float da2 = rstd * (dz - m1 - z * m2);
      B0[r * d + c] = da2;
      const float df = dr.apply(da2, kSiteOut, r0 + r, c);
      scr[r * col.width + col.df + c] = df;
      B1[r * d + c] = df;
    }
  }
  // LN1 statistics and zh1 from the stored a1
  for (int r = warp; r < T; r += nwarps) {
    const size_t g = static_cast<size_t>(r0 + r) * d;
    float mu, rstd;
    ln_stats(d, [&](int c) { return ld(p.a1[g + c]); }, mu, rstd);
    for (int c = lane; c < d; c += 32) B2[r * d + c] = zhat(ld(p.a1[g + c]), mu, rstd);
    if (lane == 0) {
      sStat[2 * r] = mu;
      sStat[2 * r + 1] = rstd;
      scr[r * col.width + col.stats] = mu;
      scr[r * col.width + col.stats + 1] = rstd;
    }
  }
  __syncthreads();

  // dhpre = (h > 0) · (df·W2ᵀ) / keep: h_drop > 0 carries both mask and ReLU
  rowmm<float, false>(B1, d, p.w2, d, ff, T, [&](int r, int n, float acc) {
    const float hv = ld(p.h[static_cast<size_t>(r0 + r) * ff + n]);
    const float dh = hv > 0.f ? acc / dr.keep : 0.f;
    scr[r * col.width + col.dhpre + n] = dh;
    sBig[r * ff + n] = dh;
  });
  __syncthreads();

  // dy1 = dhpre·W1ᵀ + da2, into B0
  rowmm<float, false>(sBig, ff, p.w1, ff, d, T, [&](int r, int n, float acc) {
    const float dy1 = acc + B0[r * d + n];
    B0[r * d + n] = dy1;
    scr[r * col.width + col.dy1 + n] = dy1;
    scr[r * col.width + col.dy1zh1 + n] = dy1 * B2[r * d + n];
  });
  __syncthreads();

  // LN1 backward: da1 into B0; dproj = drop(da1)
  ln_bwd_rows(
      T, d, p.g1, [&](int r, int c) { return B0[r * d + c]; },
      [&](int r, int c) { return B2[r * d + c]; }, [&](int r) { return sStat[2 * r + 1]; },
      [&](int r, int c, float da1) {
        B0[r * d + c] = da1;
        const float dproj = dr.apply(da1, kSiteProj, r0 + r, c);
        scr[r * col.width + col.dproj + c] = dproj;
        B1[r * d + c] = dproj;
      });
  __syncthreads();

  // dattn = round(dproj·Woᵀ) into B2; qkv into sBig
  for (int idx = threadIdx.x; idx < T * d3; idx += blockDim.x)
    sBig[idx] = ld(p.qkv[static_cast<size_t>(r0) * d3 + idx]);
  rowmm<float, false>(B1, d, p.wo, d, d, T,
                      [&](int r, int n, float acc) { B2[r * d + n] = acc; });
  __syncthreads();

  // attention backward, head by head; dq, dk, dv go to the scratch
  for (int hh = 0; hh < H; ++hh) {
    const int q0 = hh * hd, k0 = d + hh * hd, v0 = 2 * d + hh * hd;
    attn_head_bwd<float>(sBig + q0, d3, sBig + k0, sBig + v0, d3, B2 + q0, d, hd, T, scale, false,
                     dr, kSiteAttn, (s * H + hh) * T, sP, sD,
                     [&](int j, int c, float dq, float dk, float dv) {
                       float* out = scr + j * col.width + col.dqkv;
                       out[q0 + c] = dq;
                       out[k0 + c] = dk;
                       out[v0 + c] = dv;
                     });
  }

  // dx = da1 + dqkv·Wqkvᵀ
  for (int idx = threadIdx.x; idx < T * d3; idx += blockDim.x) {
    const int r = idx / d3, c = idx - r * d3;
    sBig[idx] = scr[r * col.width + col.dqkv + c];
  }
  __syncthreads();
  rowmm<float, false>(sBig, d3, p.wqkv, d3, d, T, [&](int r, int n, float acc) {
    p.dx[static_cast<size_t>(r0 + r) * d + n] = B0[r * d + n] + acc;
  });
}

// ---------------------------------------------------------------- backward, weights

struct WgradArgs {
  const float *dy, *x, *qkv, *a1, *h;
  const float *g1, *b1;
  const int* seed;
  const float* scratch;
  float *dwqkv, *dwo, *dw1, *dw2, *vec;
};

__global__ void __launch_bounds__(kThreads) layer_bwd_weights(WgradArgs p, Shape sh) {
  extern __shared__ __align__(16) float sm[];
  const int T = sh.T, d = sh.d, H = sh.H, ff = sh.ff, d3 = 3 * d;
  const int hd = d / H, m = sh.nseq * T;
  const Cols col(d, ff);
  const Drop dr = make_drop(p.seed, sh.thresh);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));

  // which matrix, as (K inputs, N outputs); each is stored (N, K):
  // 0 dWqkv (d, 3d), 1 dWo (d, d), 2 dW1 (d, ff), 3 dW2 (ff, d)
  const int counts[4] = {tiles(d) * tiles(d3), tiles(d) * tiles(d), tiles(d) * tiles(ff),
                         tiles(ff) * tiles(d)};
  int b = blockIdx.x, mat = 0;
  while (mat < 4 && b >= counts[mat]) b -= counts[mat++];

  if (mat == 4) {  // bias and LN parameter sums: 32 columns a block, a lane
                   // per column, the 8 warps over interleaved rows
    __shared__ float part[kThreads / 32][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const int c = b * 32 + lane;
    // vec: dbqkv 3d | dbo d | dg1 d | db1 d | db1f ff | db2f d | dg2 d | db2 d
    int src = -1;
    if (c < d3) src = col.dqkv + c;
    else if (c < 4 * d) src = col.dproj + c - d3;
    else if (c < 5 * d) src = col.dy1zh1 + c - 4 * d;
    else if (c < 6 * d) src = col.dy1 + c - 5 * d;
    else if (c < 6 * d + ff) src = col.dhpre + c - 6 * d;
    else if (c < 7 * d + ff) src = col.df + c - 6 * d - ff;
    else if (c < 8 * d + ff) src = col.dyzh2 + c - 7 * d - ff;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (c < 9 * d + ff) {
      for (int r = warp, i = 0; r < m; r += nwarps, ++i)
        acc[i & 3] += src >= 0 ? p.scratch[static_cast<size_t>(r) * col.width + src]
                               : ld(p.dy[static_cast<size_t>(r) * d + c - 8 * d - ff]);
    }
    part[warp][lane] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    __syncthreads();
    if (warp == 0 && c < 9 * d + ff) {
      float total = 0.f;
      for (int w = 0; w < nwarps; ++w) total += part[w][lane];
      p.vec[c] = total;
    }
    return;
  }

  const int K = mat == 3 ? ff : d;
  const int N = mat == 0 ? d3 : mat == 2 ? ff : d;
  const int k0 = (b / tiles(N)) * kTile, n0 = (b % tiles(N)) * kTile;
  float* sA = sm;                  // (T, 64)
  float* sB = sA + T * kTile;      // (T, 64)
  float* sQ = sB + T * kTile;      // (T, hd)
  float* sK = sQ + T * hd;         // (T, hd)
  float* sP = sK + T * hd;         // (T, T)
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int s = 0; s < sh.nseq; ++s) {
    const int r0 = s * T;
    const float* scr = p.scratch + static_cast<size_t>(r0) * col.width;
    // B: the row gradients of columns n0..
    for (int idx = threadIdx.x; idx < T * kTile; idx += blockDim.x) {
      const int r = idx / kTile, n = n0 + idx - r * kTile;
      float v = 0.f;
      if (n < N) {
        const float* row = scr + r * col.width;
        v = mat == 0 ? row[col.dqkv + n]
            : mat == 1 ? (row[col.dproj + n])
            : mat == 2 ? (row[col.dhpre + n])
                       : row[col.df + n];
      }
      sB[idx] = v;
    }
    // A: the layer inputs of rows k0.. (x, attention output, y1, h)
    if (mat == 1) {
      const int kend = min(k0 + kTile, d);
      for (int hh = k0 / hd; hh * hd < kend; ++hh) {
        const int c_lo = max(k0, hh * hd), c_hi = min(kend, (hh + 1) * hd);
        const float* q = p.qkv + static_cast<size_t>(r0) * d3 + hh * hd;
        attn_head_cols<float>(q, d3, q + d, q + 2 * d, d3, hd, T, scale, false, dr, kSiteAttn,
                          (s * H + hh) * T, c_lo - hh * hd, c_hi - hh * hd, sQ, sK, sP,
                          sA + c_lo - k0, kTile);
      }
      for (int idx = threadIdx.x; idx < T * kTile; idx += blockDim.x)
        if (k0 + idx % kTile >= d) sA[idx] = 0.f;
    } else {
      for (int idx = threadIdx.x; idx < T * kTile; idx += blockDim.x) {
        const int r = idx / kTile, k = k0 + idx - r * kTile;
        float v = 0.f;
        if (k < K) {
          const size_t row = static_cast<size_t>(r0 + r);
          if (mat == 0) {
            v = ld(p.x[row * d + k]);
          } else if (mat == 3) {
            v = ld(p.h[row * ff + k]);
          } else {  // y1 from the stored a1 and the row kernel's statistics
            const float* st_ = scr + r * col.width + col.stats;
            v = affine(zhat(ld(p.a1[row * d + k]), st_[0], st_[1]), p.g1[k], p.b1[k]);
          }
        }
        sA[idx] = v;
      }
    }
    __syncthreads();
    for (int r = 0; r < T; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(sA + r * kTile + ty * 4);
      const float4 bb = *reinterpret_cast<const float4*>(sB + r * kTile + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = mat == 0 ? p.dwqkv : mat == 1 ? p.dwo : mat == 2 ? p.dw1 : p.dw2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (k < K && n < N) out[static_cast<size_t>(n) * K + k] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- launch

size_t fwd_smem(const Shape& s) {
  const int big = 3 * s.d > s.ff ? 3 * s.d : s.ff;
  return 4 * (static_cast<size_t>(s.T) * (2 * s.d + big) + s.T * s.T);
}
size_t rows_smem(const Shape& s) {
  const int big = 3 * s.d > s.ff ? 3 * s.d : s.ff;
  return 4 * (static_cast<size_t>(s.T) * (3 * s.d + big) + 2 * s.T * s.T + 4 * s.T);
}
size_t weights_smem(const Shape& s) {
  return 4 * (2 * static_cast<size_t>(s.T) * kTile + 2 * s.T * (s.d / s.H) + s.T * s.T);
}

int fwd(void* const* ptr, const Shape& sh, cudaStream_t stream) {
  FwdArgs a;
  a.x = static_cast<const float*>(ptr[0]);
  a.wqkv = static_cast<const float*>(ptr[1]);
  a.bqkv = static_cast<const float*>(ptr[2]);
  a.wo = static_cast<const float*>(ptr[3]);
  a.bo = static_cast<const float*>(ptr[4]);
  a.g1 = static_cast<const float*>(ptr[5]);
  a.b1 = static_cast<const float*>(ptr[6]);
  a.w1 = static_cast<const float*>(ptr[7]);
  a.b1f = static_cast<const float*>(ptr[8]);
  a.w2 = static_cast<const float*>(ptr[9]);
  a.b2f = static_cast<const float*>(ptr[10]);
  a.g2 = static_cast<const float*>(ptr[11]);
  a.b2 = static_cast<const float*>(ptr[12]);
  a.seed = static_cast<const int*>(ptr[13]);
  a.y = static_cast<float*>(ptr[14]);
  a.qkv = static_cast<float*>(ptr[15]);
  a.a1 = static_cast<float*>(ptr[16]);
  a.h = static_cast<float*>(ptr[17]);
  a.a2 = static_cast<float*>(ptr[18]);
  return launch(layer_fwd, sh.nseq, fwd_smem(sh), stream, a, sh);
}

int bwd_rows(void* const* ptr, const Shape& sh, cudaStream_t stream) {
  BwdArgs a;
  a.dy = static_cast<const float*>(ptr[0]);
  a.x = static_cast<const float*>(ptr[1]);
  a.qkv = static_cast<const float*>(ptr[2]);
  a.a1 = static_cast<const float*>(ptr[3]);
  a.h = static_cast<const float*>(ptr[4]);
  a.a2 = static_cast<const float*>(ptr[5]);
  a.wqkv = static_cast<const float*>(ptr[6]);
  a.wo = static_cast<const float*>(ptr[7]);
  a.w1 = static_cast<const float*>(ptr[8]);
  a.w2 = static_cast<const float*>(ptr[9]);
  a.g1 = static_cast<const float*>(ptr[10]);
  a.b1 = static_cast<const float*>(ptr[11]);
  a.g2 = static_cast<const float*>(ptr[12]);
  a.seed = static_cast<const int*>(ptr[13]);
  a.dx = static_cast<float*>(ptr[14]);
  a.scratch = static_cast<float*>(ptr[15]);
  return launch(layer_bwd_rows, sh.nseq, rows_smem(sh), stream, a, sh);
}

int bwd_weights(void* const* ptr, const Shape& sh, cudaStream_t stream) {
  WgradArgs a;
  a.dy = static_cast<const float*>(ptr[0]);
  a.x = static_cast<const float*>(ptr[1]);
  a.qkv = static_cast<const float*>(ptr[2]);
  a.a1 = static_cast<const float*>(ptr[3]);
  a.h = static_cast<const float*>(ptr[4]);
  a.g1 = static_cast<const float*>(ptr[5]);
  a.b1 = static_cast<const float*>(ptr[6]);
  a.seed = static_cast<const int*>(ptr[7]);
  a.scratch = static_cast<const float*>(ptr[8]);
  a.dwqkv = static_cast<float*>(ptr[9]);
  a.dwo = static_cast<float*>(ptr[10]);
  a.dw1 = static_cast<float*>(ptr[11]);
  a.dw2 = static_cast<float*>(ptr[12]);
  a.vec = static_cast<float*>(ptr[13]);
  const int d = sh.d, ff = sh.ff;
  const int blocks = tiles(d) * tiles(3 * d) + tiles(d) * tiles(d) + tiles(d) * tiles(ff) +
                     tiles(ff) * tiles(d) + (9 * d + ff + 31) / 32;
  return launch(layer_bwd_weights, blocks, weights_smem(sh), stream, a, sh);
}

}  // namespace

extern "C" {

// Shapes: nseq sequences of T rows (rows = nseq·T), width d, H heads, ff
// hidden; thresh the 8-bit keep threshold (256: no dropout); is_bf16 must
// be 0 (float32; bf16 returns cudaErrorInvalidValue). All pointers are device
// pointers of contiguous tensors; seed points to one int32.

int tgi_layer_fwd(void* x, void* wqkv, void* bqkv, void* wo, void* bo, void* g1,
                  void* b1, void* w1, void* b1f, void* w2, void* b2f, void* g2,
                  void* b2, void* seed, void* y, void* qkv, void* a1, void* h,
                  void* a2, int nseq, int T, int d, int H, int ff, int thresh,
                  int is_bf16, void* stream) {
  void* const ptr[] = {x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2,
                       seed, y, qkv, a1, h, a2};
  const Shape sh{nseq, T, d, H, ff, thresh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);  // layer_sm90.cu's route
  return fwd(ptr, sh, s);
}

int tgi_layer_bwd_rows(void* dy, void* x, void* qkv, void* a1, void* h, void* a2,
                       void* wqkv, void* wo, void* w1, void* w2, void* g1, void* b1,
                       void* g2, void* seed, void* dx, void* scratch, int nseq, int T,
                       int d, int H, int ff, int thresh, int is_bf16, void* stream) {
  void* const ptr[] = {dy, x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed,
                       dx, scratch};
  const Shape sh{nseq, T, d, H, ff, thresh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);  // layer_sm90.cu's route
  return bwd_rows(ptr, sh, s);
}

int tgi_layer_bwd_weights(void* dy, void* x, void* qkv, void* a1, void* h, void* g1,
                          void* b1, void* seed, void* scratch, void* dwqkv, void* dwo,
                          void* dw1, void* dw2, void* vec, int nseq, int T, int d,
                          int H, int ff, int thresh, int is_bf16, void* stream) {
  void* const ptr[] = {dy, x, qkv, a1, h, g1, b1, seed, scratch, dwqkv, dwo, dw1,
                       dw2, vec};
  const Shape sh{nseq, T, d, H, ff, thresh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);  // layer_sm90.cu's route
  return bwd_weights(ptr, sh, s);
}

const char* tgi_layer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
