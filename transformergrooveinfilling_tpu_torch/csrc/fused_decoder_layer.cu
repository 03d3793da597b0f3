// Whole post-LN decoder layer for training, forward and backward, sm_90a:
// the f32 route (the bf16 route is layer_sm90.cu's chain of launches).
//
// Replaces the Pallas TPU kernel transformergrooveinfilling_tpu/ops/
// fused_decoder_layer.py::decoder_layer_train (forward _fwd_call/_fwd_kernel,
// backward _bwd_call/_bwd_kernel):
//
//   qkv = y·Wqkv + b;  per head P = softmax(causal(Q·Kᵀ/√hd)); A = drop(P)·V
//   a1 = y + drop(A·Wo + bo);   y1 = LN1(a1)
//   qc = y1·Wq + bq;  kv = mem·Wkv + bkv;  per head Pc = softmax(Qc·Kcᵀ/√hd);
//   B = drop(Pc)·Vc;  a2 = y1 + drop(B·Wo2 + bo2);  y2 = LN2(a2)
//   h = drop(relu(y2·W1 + b1));  a3 = y2 + drop(h·W2 + b2);  y3 = LN3(a3)
//
// The design is the encoder layer's (fused_layer.cu), with the same device
// functions (layer_common.cuh). Three kernels:
//   dec_fwd          one block per sequence (T ≤ 32 target rows and the T
//                    memory rows of the same sequence): writes y3 and the
//                    residuals qkv, a1, qc, kv, a2, h_drop, a3.
//   dec_bwd_rows     one block per sequence, in three stages that reuse the
//                    same shared-memory buffers: FFN + LN3 + LN2, then the
//                    cross-attention + LN1, then the causal self-attention.
//                    Both attentions are recomputed from the stored
//                    projections. Writes dx, dmem = dkv·Wkv and the row-wise
//                    gradients into an f32 scratch of 14d + ff + 4 columns.
//   dec_bwd_weights  one block per 64×64 tile of the seven weight gradients
//                    (Σ over all rows of dYᵀ·X, sequence by sequence, in a
//                    fixed order), plus blocks that sum the 13 bias and LN
//                    parameter gradients, 32 columns a block. No atomics: two
//                    runs with one seed agree bit for bit.
//
// What bounds it on the H100: about 1.6 MFLOP of products per row forward
// (6d² + 2·d·ff multiply-adds) and twice that backward at d 256 / ff 512, on
// CUDA cores (f32 FMAs, 67 TFLOP/s peak), against a few KB of activations per
// row: compute-bound. The seven weight matrices (1.4 MB in bf16) stream from
// the 50 MB L2; a thread reuses each weight for all T rows of its block.
// Shared memory is the encoder kernels': T·(2d + max(3d, ff)) + T² floats
// forward, T·(3d + max(3d, ff)) + 2T² + 8T in the row backward (168 KB and
// 205 KB at T 32, d 256, ff 512): qc (d) and kv (2d) take the place qkv (3d)
// had, and the stages hand da3 → dy2 → da2 → dy1 → da1 on in one buffer.
//
// Dropout sites (layer_common.cuh has the stream), in the order the layer
// reaches them: 0 self-attention probabilities, 1 the self-attention
// projection, 2 cross-attention probabilities, 3 the cross-attention
// projection, 4 the FFN hidden, 5 the FFN output. h > 0 recovers the FFN
// mask and the ReLU's side in the backward. A masked (future) score gets
// probability exactly 0, so its dS vanishes without masking again.
//
// Everything is f32 here: the TPU kernel's rounding points (qkv, qc, kv, P
// after dropout, both attention outputs, y1, y2, h, dS, dq/dk/dv, both dattn
// and the row gradients that feed a product, rounded to the storage dtype)
// round only on the bf16 route, layer_sm90.cu; LayerNorms take a one-pass
// variance, clamped at 0. The backward takes its LayerNorm statistics from
// the stored a1, a2, a3.
//
// Weights and their gradients are in nn.Linear's (out, in) layout: Wqkv
// (3d, d), Wo (d, d), Wq (d, d), Wkv (2d, d), Wo2 (d, d), W1 (ff, d), W2
// (d, ff). Plain C entry points, bound from Python with ctypes
// (ops/fused_decoder_layer.py): each takes its device pointers as one array
// whose length it checks, and returns cudaGetLastError() after its launch.

#include "layer_common.cuh"

namespace {

constexpr int kSiteSelf = 0, kSiteProj1 = 1, kSiteCross = 2, kSiteProj2 = 3, kSiteFfn = 4,
              kSiteOut = 5;
constexpr int kBadPointerCount = -1;

// ---------------------------------------------------------------- forward

struct FwdArgs {
  const float *y, *mem, *wqkv, *wo, *wq, *wkv, *wo2, *w1, *w2;
  const float *bqkv, *bo, *bq, *bkv, *bo2, *g1, *b1, *b1f, *b2f, *g2, *b2, *g3, *b3;
  const int* seed;
  float *out, *qkv, *a1, *qc, *kv, *a2, *h, *a3;
};

// y = LN(a)·g + b for the T rows of `a` (shared memory, f32); emit(r, c, y)
// writes
template <typename Emit>
__device__ __forceinline__ void ln_rows(const float* a, int T, int d, const float* g,
                                        const float* b, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < T; r += nwarps) {
    float mu, rstd;
    const float* row = a + r * d;
    ln_stats(d, [&](int c) { return row[c]; }, mu, rstd);
    for (int c = lane; c < d; c += 32)
      emit(r, c, affine(zhat(row[c], mu, rstd), g[c], b[c]));
  }
}

__global__ void __launch_bounds__(kThreads) dec_fwd(FwdArgs p, Shape sh) {
  extern __shared__ __align__(16) float sm[];
  const int T = sh.T, d = sh.d, H = sh.H, ff = sh.ff, d2 = 2 * d, d3 = 3 * d;
  const int hd = d / H, big = d3 > ff ? d3 : ff;
  float* sX = sm;              // (T, d): y, then y1, then y2
  float* sBig = sX + T * d;    // (T, 3d): qkv; a1 (T, d); qc (T, d) | kv (T, 2d); a2; h (T, ff)
  float* sA = sBig + T * big;  // (T, d): attention output; mem; cross-attention output; a3
  float* sP = sA + T * d;      // (T, T)
  float* sKv = sBig + T * d;   // (T, 2d), beside qc
  const int s = blockIdx.x, r0 = s * T;
  const Drop dr = make_drop(p.seed, sh.thresh);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));

  for (int idx = threadIdx.x; idx < T * d; idx += blockDim.x)
    sX[idx] = ld(p.y[static_cast<size_t>(r0) * d + idx]);
  __syncthreads();

  rowmm<float, true>(sX, d, p.wqkv, d, d3, T, [&](int r, int n, float acc) {
    const float v = acc + p.bqkv[n];
    sBig[r * d3 + n] = ld(v);
    p.qkv[static_cast<size_t>(r0 + r) * d3 + n] = v;
  });
  __syncthreads();

  for (int hh = 0; hh < H; ++hh)
    attn_head_fwd<float>(sBig + hh * hd, d3, sBig + d + hh * hd, sBig + d2 + hh * hd, d3, hd, T,
                     scale, true, dr, kSiteSelf, (s * H + hh) * T, sP, sA + hh * hd, d);

  // a1 = y + drop(A·Wo + bo), into sBig (qkv is no longer needed)
  rowmm<float, true>(sA, d, p.wo, d, d, T, [&](int r, int n, float acc) {
    const float a = sX[r * d + n] + dr.apply(acc + p.bo[n], kSiteProj1, r0 + r, n);
    sBig[r * d + n] = a;
    p.a1[static_cast<size_t>(r0 + r) * d + n] = a;
  });
  __syncthreads();
  ln_rows(sBig, T, d, p.g1, p.b1, [&](int r, int c, float v) { sX[r * d + c] = ld(v); });
  // mem into sA (the self-attention output is no longer needed)
  for (int idx = threadIdx.x; idx < T * d; idx += blockDim.x)
    sA[idx] = ld(p.mem[static_cast<size_t>(r0) * d + idx]);
  __syncthreads();

  // qc = y1·Wq + bq into sBig's first (T, d); kv = mem·Wkv + bkv beside it
  rowmm<float, true>(sX, d, p.wq, d, d, T, [&](int r, int n, float acc) {
    const float v = acc + p.bq[n];
    sBig[r * d + n] = ld(v);
    p.qc[static_cast<size_t>(r0 + r) * d + n] = v;
  });
  rowmm<float, true>(sA, d, p.wkv, d, d2, T, [&](int r, int n, float acc) {
    const float v = acc + p.bkv[n];
    sKv[r * d2 + n] = ld(v);
    p.kv[static_cast<size_t>(r0 + r) * d2 + n] = v;
  });
  __syncthreads();

  for (int hh = 0; hh < H; ++hh)
    attn_head_fwd<float>(sBig + hh * hd, d, sKv + hh * hd, sKv + d + hh * hd, d2, hd, T, scale,
                     false, dr, kSiteCross, (s * H + hh) * T, sP, sA + hh * hd, d);

  // a2 = y1 + drop(B·Wo2 + bo2), into sBig (qc is no longer needed)
  rowmm<float, true>(sA, d, p.wo2, d, d, T, [&](int r, int n, float acc) {
    const float a = sX[r * d + n] + dr.apply(acc + p.bo2[n], kSiteProj2, r0 + r, n);
    sBig[r * d + n] = a;
    p.a2[static_cast<size_t>(r0 + r) * d + n] = a;
  });
  __syncthreads();
  ln_rows(sBig, T, d, p.g2, p.b2, [&](int r, int c, float v) { sX[r * d + c] = ld(v); });
  __syncthreads();

  // h = drop(relu(y2·W1 + b1)), into sBig
  rowmm<float, true>(sX, d, p.w1, d, ff, T, [&](int r, int n, float acc) {
    const float v = dr.apply(fmaxf(acc + p.b1f[n], 0.f), kSiteFfn, r0 + r, n);
    sBig[r * ff + n] = ld(v);
    p.h[static_cast<size_t>(r0 + r) * ff + n] = v;
  });
  __syncthreads();

  // a3 = y2 + drop(h·W2 + b2), into sA
  rowmm<float, true>(sBig, ff, p.w2, ff, d, T, [&](int r, int n, float acc) {
    const float a = sX[r * d + n] + dr.apply(acc + p.b2f[n], kSiteOut, r0 + r, n);
    sA[r * d + n] = a;
    p.a3[static_cast<size_t>(r0 + r) * d + n] = a;
  });
  __syncthreads();
  ln_rows(sA, T, d, p.g3, p.b3,
          [&](int r, int c, float v) { p.out[static_cast<size_t>(r0 + r) * d + c] = v; });
}

// ---------------------------------------------------------------- backward, rows

// scratch columns per row (f32), width 14d + ff + 4
struct Cols {
  int df, dhpre, dproj2, dqc, dkv, dproj, dqkv, dyzh3, dy2zh2, dy2, dy1zh1, dy1, stats, width;
  __host__ __device__ Cols(int d, int ff)
      : df(0), dhpre(d), dproj2(d + ff), dqc(2 * d + ff), dkv(3 * d + ff), dproj(5 * d + ff),
        dqkv(6 * d + ff), dyzh3(9 * d + ff), dy2zh2(10 * d + ff), dy2(11 * d + ff),
        dy1zh1(12 * d + ff), dy1(13 * d + ff), stats(14 * d + ff), width(14 * d + ff + 4) {}
};

struct RowArgs {
  const float *dy, *qkv, *a1, *qc, *kv, *a2, *h, *a3, *wqkv, *wo, *wq, *wkv, *wo2, *w1, *w2;
  const float *g1, *g2, *g3;
  const int* seed;
  float *dx, *dmem;
  float* scratch;
};

// zh = (a − mean)·rstd of the T stored pre-norm rows a (device memory) into
// zh (shared memory); (mean, rstd) into stat[2r], stat[2r + 1]
__device__ __forceinline__ void zhat_rows(const float* a, int T, int d, float* zh, float* stat,
                                          int stat_stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < T; r += nwarps) {
    const float* row = a + static_cast<size_t>(r) * d;
    float mu, rstd;
    ln_stats(d, [&](int c) { return ld(row[c]); }, mu, rstd);
    for (int c = lane; c < d; c += 32) zh[r * d + c] = zhat(ld(row[c]), mu, rstd);
    if (lane == 0) {
      stat[r * stat_stride] = mu;
      stat[r * stat_stride + 1] = rstd;
    }
  }
}

__global__ void __launch_bounds__(kThreads) dec_bwd_rows(RowArgs p, Shape sh) {
  extern __shared__ __align__(16) float sm[];
  const int T = sh.T, d = sh.d, H = sh.H, ff = sh.ff, d2 = 2 * d, d3 = 3 * d;
  const int hd = d / H, big = d3 > ff ? d3 : ff;
  const Cols col(d, ff);
  float* B0 = sm;              // (T, d): da3, dy2, da2, dy1, da1 in turn
  float* B1 = B0 + T * d;      // (T, d): df, dproj2, dproj in turn
  float* B2 = B1 + T * d;      // (T, d): zh3, zh2, dcatt, zh1, dattn in turn
  float* sBig = B2 + T * d;    // (T, ff): dhpre; (T, 3d): qc | kv, dqc | dkv, qkv, dqkv
  float* sP = sBig + T * big;  // (T, T): P, then P after dropout
  float* sD = sP + T * T;      // (T, T): dP, then dS
  float* sStat = sD + T * T;   // (T, 8): mean, rstd of LN1, LN2, LN3
  float* sKv = sBig + T * d;   // (T, 2d), beside qc
  const int s = blockIdx.x, r0 = s * T;
  const size_t g0 = static_cast<size_t>(r0) * d;
  const Drop dr = make_drop(p.seed, sh.thresh);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  float* scr = p.scratch + static_cast<size_t>(r0) * col.width;
  const auto b0 = [&](int r, int c) { return B0[r * d + c]; };
  const auto b2 = [&](int r, int c) { return B2[r * d + c]; };

  // ---- stage 1: LN3, the FFN, LN2
  zhat_rows(p.a3 + g0, T, d, B2, sStat + 4, 8);
  __syncthreads();
  for (int idx = threadIdx.x; idx < T * d; idx += blockDim.x) {
    const int r = idx / d, c = idx - r * d;
    scr[r * col.width + col.dyzh3 + c] = ld(p.dy[g0 + idx]) * B2[idx];
  }
  ln_bwd_rows(
      T, d, p.g3, [&](int r, int c) { return ld(p.dy[g0 + r * d + c]); }, b2,
      [&](int r) { return sStat[8 * r + 5]; },
      [&](int r, int c, float da3) {
        B0[r * d + c] = da3;
        const float df = dr.apply(da3, kSiteOut, r0 + r, c);
        scr[r * col.width + col.df + c] = df;
        B1[r * d + c] = df;
      });
  __syncthreads();
  zhat_rows(p.a2 + g0, T, d, B2, sStat + 2, 8);
  __syncthreads();

  // dhpre = (h > 0) · (df·W2ᵀ) / keep: h_drop > 0 carries both mask and ReLU
  rowmm<float, false>(B1, d, p.w2, d, ff, T, [&](int r, int n, float acc) {
    const float hv = ld(p.h[static_cast<size_t>(r0 + r) * ff + n]);
    const float dh = hv > 0.f ? acc / dr.keep : 0.f;
    scr[r * col.width + col.dhpre + n] = dh;
    sBig[r * ff + n] = dh;
  });
  __syncthreads();

  // dy2 = dhpre·W1ᵀ + da3, into B0
  rowmm<float, false>(sBig, ff, p.w1, ff, d, T, [&](int r, int n, float acc) {
    const float dy2 = acc + B0[r * d + n];
    B0[r * d + n] = dy2;
    scr[r * col.width + col.dy2 + n] = dy2;
    scr[r * col.width + col.dy2zh2 + n] = dy2 * B2[r * d + n];
  });
  __syncthreads();

  // LN2 backward: da2 into B0; dproj2 = drop(da2)
  ln_bwd_rows(
      T, d, p.g2, b0, b2, [&](int r) { return sStat[8 * r + 3]; },
      [&](int r, int c, float da2) {
        B0[r * d + c] = da2;
        const float dproj2 = dr.apply(da2, kSiteProj2, r0 + r, c);
        scr[r * col.width + col.dproj2 + c] = dproj2;
        B1[r * d + c] = dproj2;
      });
  __syncthreads();

  // ---- stage 2: the cross-attention, LN1
  // dcatt = round(dproj2·Wo2ᵀ) into B2; qc | kv into sBig
  for (int idx = threadIdx.x; idx < T * d; idx += blockDim.x) sBig[idx] = ld(p.qc[g0 + idx]);
  for (int idx = threadIdx.x; idx < T * d2; idx += blockDim.x)
    sKv[idx] = ld(p.kv[static_cast<size_t>(r0) * d2 + idx]);
  rowmm<float, false>(B1, d, p.wo2, d, d, T,
                      [&](int r, int n, float acc) { B2[r * d + n] = acc; });
  __syncthreads();
  for (int hh = 0; hh < H; ++hh) {
    const int q0 = hh * hd;
    attn_head_bwd<float>(sBig + q0, d, sKv + q0, sKv + d + q0, d2, B2 + q0, d, hd, T, scale, false,
                     dr, kSiteCross, (s * H + hh) * T, sP, sD,
                     [&](int j, int c, float dq, float dk, float dv) {
                       float* row = scr + j * col.width;
                       row[col.dqc + q0 + c] = dq;
                       row[col.dkv + q0 + c] = dk;
                       row[col.dkv + d + q0 + c] = dv;
                     });
  }
  // dqc | dkv back into sBig; zh1 into B2
  for (int idx = threadIdx.x; idx < T * d; idx += blockDim.x) {
    const int r = idx / d, c = idx - r * d;
    sBig[idx] = scr[r * col.width + col.dqc + c];
  }
  for (int idx = threadIdx.x; idx < T * d2; idx += blockDim.x) {
    const int r = idx / d2, c = idx - r * d2;
    sKv[idx] = scr[r * col.width + col.dkv + c];
  }
  zhat_rows(p.a1 + g0, T, d, B2, sStat, 8);
  __syncthreads();
  for (int idx = threadIdx.x; idx < T * 4; idx += blockDim.x) {
    const int r = idx / 4, k = idx - r * 4;  // LN1 and LN2 statistics, for y1 and y2 again
    scr[r * col.width + col.stats + k] = sStat[8 * r + k];
  }
  // dy1 = dqc·Wqᵀ + da2, into B0;  dmem = dkv·Wkvᵀ
  rowmm<float, false>(sBig, d, p.wq, d, d, T, [&](int r, int n, float acc) {
    const float dy1 = acc + B0[r * d + n];
    B0[r * d + n] = dy1;
    scr[r * col.width + col.dy1 + n] = dy1;
    scr[r * col.width + col.dy1zh1 + n] = dy1 * B2[r * d + n];
  });
  rowmm<float, false>(sKv, d2, p.wkv, d2, d, T, [&](int r, int n, float acc) {
    p.dmem[g0 + r * d + n] = acc;
  });
  __syncthreads();

  // LN1 backward: da1 into B0; dproj = drop(da1)
  ln_bwd_rows(
      T, d, p.g1, b0, b2, [&](int r) { return sStat[8 * r + 1]; },
      [&](int r, int c, float da1) {
        B0[r * d + c] = da1;
        const float dproj = dr.apply(da1, kSiteProj1, r0 + r, c);
        scr[r * col.width + col.dproj + c] = dproj;
        B1[r * d + c] = dproj;
      });
  __syncthreads();

  // ---- stage 3: the causal self-attention
  // dattn = round(dproj·Woᵀ) into B2; qkv into sBig
  for (int idx = threadIdx.x; idx < T * d3; idx += blockDim.x)
    sBig[idx] = ld(p.qkv[static_cast<size_t>(r0) * d3 + idx]);
  rowmm<float, false>(B1, d, p.wo, d, d, T,
                      [&](int r, int n, float acc) { B2[r * d + n] = acc; });
  __syncthreads();
  for (int hh = 0; hh < H; ++hh) {
    const int q0 = hh * hd, k0 = d + hh * hd, v0 = d2 + hh * hd;
    attn_head_bwd<float>(sBig + q0, d3, sBig + k0, sBig + v0, d3, B2 + q0, d, hd, T, scale, true,
                     dr, kSiteSelf, (s * H + hh) * T, sP, sD,
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
    p.dx[g0 + r * d + n] = B0[r * d + n] + acc;
  });
}

// ---------------------------------------------------------------- backward, weights

constexpr int kMats = 7, kVecs = 13;
enum AKind { kRows = 0, kLayerNorm = 1, kAttention = 2 };

// One weight gradient dW (N, K) = Σ_rows dY[row][n]·A[row][k]. dY is a scratch
// column. A is rows of a stored tensor, or y = LN(a)·g + b of a stored
// pre-norm tensor with the row kernel's statistics, or an attention output
// recomputed from its stored projections.
struct MatDesc {
  int K, N, a_kind;
  const float* a;          // kRows: (rows, K); kLayerNorm: the pre-norm tensor (rows, d)
  int stat_col;            // kLayerNorm: scratch column of (mean, rstd)
  const float *g, *b;      // kLayerNorm
  const float *q, *k, *v;  // kAttention: the first head's first column of each
  int ldq, ldk, causal, site;
  int dy_col;
  float* out;
};

struct WgradArgs {
  MatDesc mat[kMats];
  const float* dy;
  const int* seed;
  const float* scratch;
  float* vec;
  int vec_col[kVecs];    // scratch column of each summed vector; -1: dy itself
  int vec_width[kVecs];
};

__global__ void __launch_bounds__(kThreads) dec_bwd_weights(WgradArgs p, Shape sh) {
  extern __shared__ __align__(16) float sm[];
  const int T = sh.T, d = sh.d, H = sh.H, ff = sh.ff;
  const int hd = d / H, m = sh.nseq * T;
  const Cols col(d, ff);
  const Drop dr = make_drop(p.seed, sh.thresh);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));

  int b = blockIdx.x, mi = 0;
  while (mi < kMats && b >= tiles(p.mat[mi].K) * tiles(p.mat[mi].N)) {
    b -= tiles(p.mat[mi].K) * tiles(p.mat[mi].N);
    ++mi;
  }

  if (mi == kMats) {  // bias and LN parameter sums: 32 columns a block, a lane
                      // per column, the 8 warps over interleaved rows
    __shared__ float part[kThreads / 32][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const int c = b * 32 + lane;
    int src = -2, off = c;  // -2: past the last vector
    for (int i = 0; i < kVecs; ++i) {
      if (off < p.vec_width[i]) {
        src = p.vec_col[i] < 0 ? -1 : p.vec_col[i] + off;
        break;
      }
      off -= p.vec_width[i];
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (src != -2) {
      for (int r = warp, i = 0; r < m; r += nwarps, ++i)
        acc[i & 3] += src >= 0 ? p.scratch[static_cast<size_t>(r) * col.width + src]
                               : ld(p.dy[static_cast<size_t>(r) * d + off]);
    }
    part[warp][lane] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    __syncthreads();
    if (warp == 0 && src != -2) {
      float total = 0.f;
      for (int w = 0; w < nwarps; ++w) total += part[w][lane];
      p.vec[c] = total;
    }
    return;
  }

  const MatDesc& md = p.mat[mi];
  const int K = md.K, N = md.N;
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
        v = scr[r * col.width + md.dy_col + n];
      }
      sB[idx] = v;
    }
    // A: the product's inputs of columns k0..
    if (md.a_kind == kAttention) {
      const int kend = min(k0 + kTile, K);
      for (int hh = k0 / hd; hh * hd < kend; ++hh) {
        const int c_lo = max(k0, hh * hd), c_hi = min(kend, (hh + 1) * hd);
        const size_t qoff = static_cast<size_t>(r0) * md.ldq + hh * hd;
        const size_t koff = static_cast<size_t>(r0) * md.ldk + hh * hd;
        attn_head_cols<float>(md.q + qoff, md.ldq, md.k + koff, md.v + koff, md.ldk, hd, T, scale,
                          md.causal != 0, dr, md.site, (s * H + hh) * T, c_lo - hh * hd,
                          c_hi - hh * hd, sQ, sK, sP, sA + c_lo - k0, kTile);
      }
      for (int idx = threadIdx.x; idx < T * kTile; idx += blockDim.x)
        if (k0 + idx % kTile >= K) sA[idx] = 0.f;
    } else {
      for (int idx = threadIdx.x; idx < T * kTile; idx += blockDim.x) {
        const int r = idx / kTile, k = k0 + idx - r * kTile;
        float v = 0.f;
        if (k < K) {
          const size_t row = static_cast<size_t>(r0 + r);
          v = ld(md.a[row * K + k]);
          if (md.a_kind == kLayerNorm) {
            const float* st_ = scr + r * col.width + md.stat_col;
            v = affine(zhat(v, st_[0], st_[1]), md.g[k], md.b[k]);
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (k < K && n < N) md.out[static_cast<size_t>(n) * K + k] = acc[i][j];
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
  return 4 * (static_cast<size_t>(s.T) * (3 * s.d + big) + 2 * s.T * s.T + 8 * s.T);
}
size_t weights_smem(const Shape& s) {
  return 4 * (2 * static_cast<size_t>(s.T) * kTile + 2 * s.T * (s.d / s.H) + s.T * s.T);
}

// the entry points' pointer arrays, read in order
struct Pointers {
  void* const* p;
  int i;
  template <typename T>
  T* next() { return static_cast<T*>(p[i++]); }
};

constexpr int kFwdPointers = 31, kRowPointers = 22, kWeightPointers = 23;

int fwd(void* const* ptr, const Shape& sh, cudaStream_t stream) {
  Pointers in{ptr, 0};
  FwdArgs a;
  a.y = in.next<const float>();
  a.mem = in.next<const float>();
  a.wqkv = in.next<const float>();
  a.bqkv = in.next<const float>();
  a.wo = in.next<const float>();
  a.bo = in.next<const float>();
  a.wq = in.next<const float>();
  a.bq = in.next<const float>();
  a.wkv = in.next<const float>();
  a.bkv = in.next<const float>();
  a.wo2 = in.next<const float>();
  a.bo2 = in.next<const float>();
  a.g1 = in.next<const float>();
  a.b1 = in.next<const float>();
  a.w1 = in.next<const float>();
  a.b1f = in.next<const float>();
  a.w2 = in.next<const float>();
  a.b2f = in.next<const float>();
  a.g2 = in.next<const float>();
  a.b2 = in.next<const float>();
  a.g3 = in.next<const float>();
  a.b3 = in.next<const float>();
  a.seed = in.next<const int>();
  a.out = in.next<float>();
  a.qkv = in.next<float>();
  a.a1 = in.next<float>();
  a.qc = in.next<float>();
  a.kv = in.next<float>();
  a.a2 = in.next<float>();
  a.h = in.next<float>();
  a.a3 = in.next<float>();
  if (in.i != kFwdPointers) return kBadPointerCount;
  return launch(dec_fwd, sh.nseq, fwd_smem(sh), stream, a, sh);
}

int bwd_rows(void* const* ptr, const Shape& sh, cudaStream_t stream) {
  Pointers in{ptr, 0};
  RowArgs a;
  a.dy = in.next<const float>();
  a.qkv = in.next<const float>();
  a.a1 = in.next<const float>();
  a.qc = in.next<const float>();
  a.kv = in.next<const float>();
  a.a2 = in.next<const float>();
  a.h = in.next<const float>();
  a.a3 = in.next<const float>();
  a.wqkv = in.next<const float>();
  a.wo = in.next<const float>();
  a.wq = in.next<const float>();
  a.wkv = in.next<const float>();
  a.wo2 = in.next<const float>();
  a.w1 = in.next<const float>();
  a.w2 = in.next<const float>();
  a.g1 = in.next<const float>();
  a.g2 = in.next<const float>();
  a.g3 = in.next<const float>();
  a.seed = in.next<const int>();
  a.dx = in.next<float>();
  a.dmem = in.next<float>();
  a.scratch = in.next<float>();
  if (in.i != kRowPointers) return kBadPointerCount;
  return launch(dec_bwd_rows, sh.nseq, rows_smem(sh), stream, a, sh);
}

int bwd_weights(void* const* ptr, const Shape& sh, cudaStream_t stream) {
  Pointers in{ptr, 0};
  const int d = sh.d, ff = sh.ff;
  const Cols col(d, ff);
  WgradArgs a;
  a.dy = in.next<const float>();
  const float* y = in.next<const float>();
  const float* mem = in.next<const float>();
  const float* qkv = in.next<const float>();
  const float* a1 = in.next<const float>();
  const float* qc = in.next<const float>();
  const float* kv = in.next<const float>();
  const float* a2 = in.next<const float>();
  const float* h = in.next<const float>();
  const float* g1 = in.next<const float>();
  const float* b1 = in.next<const float>();
  const float* g2 = in.next<const float>();
  const float* b2 = in.next<const float>();
  a.seed = in.next<const int>();
  a.scratch = in.next<const float>();

  const auto mat = [&](int i, int K, int N, int a_kind, int dy_col) -> MatDesc& {
    MatDesc& md = a.mat[i];
    md = MatDesc{};
    md.K = K; md.N = N; md.a_kind = a_kind; md.dy_col = dy_col;
    md.out = in.next<float>();
    return md;
  };
  const auto attention = [](MatDesc& md, const float* q, int ldq, const float* k,
                            const float* v, int ldk, int causal, int site) {
    md.q = q; md.ldq = ldq; md.k = k; md.v = v; md.ldk = ldk; md.causal = causal; md.site = site;
  };
  const auto layer_norm = [&](MatDesc& md, const float* pre, int stat, const float* g,
                              const float* b) {
    md.a = pre; md.stat_col = col.stats + stat; md.g = g; md.b = b;
  };
  // in the order of the outputs: dwqkv, dwo, dwq, dwkv, dwo2, dw1, dw2
  mat(0, d, 3 * d, kRows, col.dqkv).a = y;
  attention(mat(1, d, d, kAttention, col.dproj), qkv, 3 * d, qkv + d, qkv + 2 * d, 3 * d, 1,
            kSiteSelf);
  layer_norm(mat(2, d, d, kLayerNorm, col.dqc), a1, 0, g1, b1);
  mat(3, d, 2 * d, kRows, col.dkv).a = mem;
  attention(mat(4, d, d, kAttention, col.dproj2), qc, d, kv, kv + d, 2 * d, 0, kSiteCross);
  layer_norm(mat(5, d, ff, kLayerNorm, col.dhpre), a2, 2, g2, b2);
  mat(6, ff, d, kRows, col.df).a = h;
  a.vec = in.next<float>();
  if (in.i != kWeightPointers) return kBadPointerCount;

  // vec: dbqkv 3d | dbo d | dbq d | dbkv 2d | dbo2 d | dg1 d | db1 d | db1f ff
  //      | db2f d | dg2 d | db2 d | dg3 d | db3 d
  const int cols[kVecs] = {col.dqkv, col.dproj, col.dqc, col.dkv, col.dproj2, col.dy1zh1,
                           col.dy1, col.dhpre, col.df, col.dy2zh2, col.dy2, col.dyzh3, -1};
  const int widths[kVecs] = {3 * d, d, d, 2 * d, d, d, d, ff, d, d, d, d, d};
  int blocks = (15 * d + ff + 31) / 32;
  for (int i = 0; i < kVecs; ++i) {
    a.vec_col[i] = cols[i];
    a.vec_width[i] = widths[i];
  }
  for (int i = 0; i < kMats; ++i) blocks += tiles(a.mat[i].K) * tiles(a.mat[i].N);
  return launch(dec_bwd_weights, blocks, weights_smem(sh), stream, a, sh);
}

}  // namespace

extern "C" {

// Each entry point: `ptr` an array of `n_ptr` device pointers of contiguous
// tensors, in the order the function above reads them (a wrong count returns
// -1 and launches nothing); nseq sequences of T rows (rows = nseq·T), width
// d, H heads, ff hidden; thresh the 8-bit keep threshold (256: no dropout);
// is_bf16 must be 0 (float32; bf16 returns cudaErrorInvalidValue); the seed
// pointer is to one int32.

int tgi_dec_fwd(void* const* ptr, int n_ptr, int nseq, int T, int d, int H, int ff, int thresh,
                int is_bf16, void* stream) {
  if (n_ptr != kFwdPointers) return kBadPointerCount;
  const Shape sh{nseq, T, d, H, ff, thresh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);  // layer_sm90.cu's route
  return fwd(ptr, sh, s);
}

int tgi_dec_bwd_rows(void* const* ptr, int n_ptr, int nseq, int T, int d, int H, int ff,
                     int thresh, int is_bf16, void* stream) {
  if (n_ptr != kRowPointers) return kBadPointerCount;
  const Shape sh{nseq, T, d, H, ff, thresh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);  // layer_sm90.cu's route
  return bwd_rows(ptr, sh, s);
}

int tgi_dec_bwd_weights(void* const* ptr, int n_ptr, int nseq, int T, int d, int H, int ff,
                        int thresh, int is_bf16, void* stream) {
  if (n_ptr != kWeightPointers) return kBadPointerCount;
  const Shape sh{nseq, T, d, H, ff, thresh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);  // layer_sm90.cu's route
  return bwd_weights(ptr, sh, s);
}

const char* tgi_dec_error_string(int code) {
  if (code == kBadPointerCount) return "wrong number of pointers for this entry point";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
