// Device functions shared by the whole-layer training kernels
// (fused_layer.cu: the encoder layer; fused_decoder_layer.cu: the decoder
// layer): storage-dtype loads and rounding, the Philox dropout stream, the
// row product, one head's softmax and its backward, LayerNorm statistics,
// and the launch helper. Every kernel that recomputes a piece of the forward
// calls the same function here in the same order, so the recompute is
// bit-identical to the forward.
//
// Dropout: Philox4x32-10, keyed by (seed, 0) and counted by
// (col / 16, row, site, 0); element (row, col) takes byte col % 16. A byte
// below `thresh` keeps the element, which is then divided by thresh/256
// (ops/fused_layer.py::dropout_mask draws the same bytes). Attention sites
// count rows as (seq·H + head)·T + i and columns as j; elementwise sites
// count the global row. Site numbers are each kernel file's own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxT = 32;
constexpr int kTile = 64;
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float ld(float x) { return x; }
__device__ __forceinline__ float ld(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename S>
__device__ __forceinline__ S st(float x);
template <>
__device__ __forceinline__ float st<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}
// round an f32 value through S
template <typename S>
__device__ __forceinline__ float rnd(float x) { return ld(st<S>(x)); }

__device__ __forceinline__ void load4(const float* p, float* w) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* w) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  w[0] = __low2float(lo); w[1] = __high2float(lo);
  w[2] = __low2float(hi); w[3] = __high2float(hi);
}

// ---------------------------------------------------------------- dropout

// the four words of (seed, site, row, col16): the bytes of columns 16·col16
// to 16·col16 + 15, column c in byte c % 4 of word (c / 4) % 4
__device__ __forceinline__ uint4 dropout_words(uint32_t seed, uint32_t site, uint32_t row,
                                               uint32_t col16) {
  uint32_t c0 = col16, c1 = row, c2 = site, c3 = 0u, k0 = seed, k1 = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// column col's byte of a draw of dropout_words
__device__ __forceinline__ uint32_t word_byte(const uint4& w4, uint32_t col) {
  const uint32_t w = (col & 8) ? ((col & 4) ? w4.w : w4.z) : ((col & 4) ? w4.y : w4.x);
  return (w >> (8 * (col & 3))) & 0xFFu;
}

__device__ __forceinline__ uint32_t dropout_byte(uint32_t seed, uint32_t site,
                                                 uint32_t row, uint32_t col) {
  return word_byte(dropout_words(seed, site, row, col >> 4), col);
}

struct Drop {
  uint32_t seed;
  int thresh;
  float keep;
  // dropout of v at (site, row, col): v / keep where kept, else 0
  __device__ __forceinline__ float apply(float v, int site, int row, int col) const {
    if (thresh >= 256) return v;
    return dropout_byte(seed, site, row, col) < static_cast<uint32_t>(thresh) ? v / keep : 0.f;
  }
};

__device__ __forceinline__ Drop make_drop(const int* seed, int thresh) {
  Drop dr;
  dr.seed = static_cast<uint32_t>(*seed);
  dr.thresh = thresh;
  dr.keep = thresh / 256.f;
  return dr;
}

// ---------------------------------------------------------------- shared pieces

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// out[r][n] = Σ_k A[r][k]·W(k, n) for r < T, n < N: A in shared memory (f32,
// row stride lda), W in device memory, W(k, n) = W[k·N + n] (TRANS false) or
// W[n·K + k] (TRANS true). Weights come in nn.Linear's (out, in) layout, so
// the forward's A·Wᵀ takes TRANS true and the backward's dY·W TRANS false.
// One thread per output column keeps T sums in registers; K is a multiple
// of 4. epi(r, n, sum) writes the result.
template <typename S, bool TRANS, typename Epi>
__device__ __forceinline__ void rowmm(const float* A, int lda, const S* __restrict__ W,
                                      int K, int N, int T, Epi epi) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc[kMaxT];
#pragma unroll
    for (int r = 0; r < kMaxT; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; k += 4) {
      float w[4];
      if (TRANS) {
        load4(W + static_cast<size_t>(n) * K + k, w);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = ld(W[static_cast<size_t>(k + j) * N + n]);
      }
#pragma unroll
      for (int r = 0; r < kMaxT; ++r) {
        if (r < T) {
          const float4 a = *reinterpret_cast<const float4*>(A + r * lda + k);
          acc[r] = fmaf(a.x, w[0], acc[r]);
          acc[r] = fmaf(a.y, w[1], acc[r]);
          acc[r] = fmaf(a.z, w[2], acc[r]);
          acc[r] = fmaf(a.w, w[3], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxT; ++r)
      if (r < T) epi(r, n, acc[r]);
  }
}

// One head's softmax(q·kᵀ·scale) into P (T, T), f32, unrounded. q and k are
// rows of stride ldq and ldk in shared memory. With `causal`, column j > i
// of row i is left out of the softmax and gets probability exactly 0, so
// its dS vanishes in the backward without masking again. Each dot product
// walks the head dim starting at column j (rotated), so the 32 lanes of a
// warp, which read 32 key rows, hit 32 banks. Every kernel calls this one
// function, so the backward's recompute is bit-identical to the forward.
__device__ void head_probs(const float* q, int ldq, const float* k, int ldk, int hd, int T,
                           float scale, bool causal, float* P) {
  for (int idx = threadIdx.x; idx < T * T; idx += blockDim.x) {
    const int i = idx / T, j = idx - i * T;
    const float* qi = q + i * ldq;
    const float* kj = k + j * ldk;
    float acc = 0.f;
    int c = j % hd;
    for (int t = 0; t < hd; ++t) {
      acc = fmaf(qi[c], kj[c], acc);
      if (++c == hd) c = 0;
    }
    P[idx] = acc * scale;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < T; i += blockDim.x >> 5) {
    const bool live = lane < T && !(causal && lane > i);
    const float v = live ? P[i * T + lane] : -INFINITY;
    const float m = warp_max(v);
    const float e = live ? expf(v - m) : 0.f;
    const float sum = warp_sum(e);
    if (lane < T) P[i * T + lane] = e / sum;
  }
  __syncthreads();
}

// One head's attention forward: P = softmax(q·kᵀ·scale), P = round(drop(P)),
// out[i][c] = round(Σ_j P[i][j]·v[j][c]) for c < hd. q, k, v point at the
// head's first column (rows of stride ldq, ldk, ldk, in shared memory); out
// has row stride ldo. `row0` = (seq·H + head)·T is the head's first row in
// the dropout stream at `site`. Leaves round(drop(P)) in P.
template <typename S>
__device__ void attn_head_fwd(const float* q, int ldq, const float* k, const float* v, int ldk,
                              int hd, int T, float scale, bool causal, const Drop& dr, int site,
                              int row0, float* P, float* out, int ldo) {
  head_probs(q, ldq, k, ldk, hd, T, scale, causal, P);
  for (int idx = threadIdx.x; idx < T * T; idx += blockDim.x) {
    const int i = idx / T, j = idx - i * T;
    P[idx] = rnd<S>(dr.apply(P[idx], site, row0 + i, j));
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < T * hd; idx += blockDim.x) {
    const int i = idx / hd, c = idx - i * hd;
    float acc = 0.f;
    for (int j = 0; j < T; ++j) acc = fmaf(P[i * T + j], v[j * ldk + c], acc);
    out[i * ldo + c] = rnd<S>(acc);
  }
  __syncthreads();
}

// Columns [c_lo, c_hi) of one head's attention output, recomputed from the
// stored projections in device memory (for the weight-gradient kernels):
// q, k, v point at the sequence's first row and the head's first column (row
// strides ldq, ldk, ldk). sQ, sK (T, hd) and sP (T, T) are shared-memory
// scratch; out[i·ldo + c − c_lo] gets round(Σ_j round(drop(P))[i][j]·v[j][c]).
template <typename S>
__device__ void attn_head_cols(const S* q, int ldq, const S* k, const S* v, int ldk, int hd,
                               int T, float scale, bool causal, const Drop& dr, int site,
                               int row0, int c_lo, int c_hi, float* sQ, float* sK, float* sP,
                               float* out, int ldo) {
  for (int idx = threadIdx.x; idx < T * hd; idx += blockDim.x) {
    const int r = idx / hd, c = idx - r * hd;
    sQ[idx] = ld(q[static_cast<size_t>(r) * ldq + c]);
    sK[idx] = ld(k[static_cast<size_t>(r) * ldk + c]);
  }
  __syncthreads();
  head_probs(sQ, hd, sK, hd, hd, T, scale, causal, sP);
  for (int idx = threadIdx.x; idx < T * T; idx += blockDim.x) {
    const int i = idx / T, j = idx - i * T;
    sP[idx] = rnd<S>(dr.apply(sP[idx], site, row0 + i, j));
  }
  __syncthreads();
  const int w = c_hi - c_lo;
  for (int idx = threadIdx.x; idx < T * w; idx += blockDim.x) {
    const int i = idx / w, c = c_lo + idx - i * w;
    float a = 0.f;
    for (int j = 0; j < T; ++j)
      a = fmaf(sP[i * T + j], ld(v[static_cast<size_t>(j) * ldk + c]), a);
    out[i * ldo + c - c_lo] = rnd<S>(a);
  }
  __syncthreads();
}

// One head's attention backward from da = d(attention output) (rows of
// stride ldda, at the head's first column, already rounded to S): recomputes
// P, then dP = drop(da·vᵀ), dS = round(P·(dP − Σ_j dP·P)·scale), and per key
// or query row j and column c < hd calls out(j, c, dq, dk, dv), each rounded
// to S. P and D are (T, T) scratch in shared memory.
template <typename S, typename Out>
__device__ void attn_head_bwd(const float* q, int ldq, const float* k, const float* v, int ldk,
                              const float* da, int ldda, int hd, int T, float scale,
                              bool causal, const Drop& dr, int site, int row0, float* P,
                              float* D, Out out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  head_probs(q, ldq, k, ldk, hd, T, scale, causal, P);
  for (int idx = threadIdx.x; idx < T * T; idx += blockDim.x) {
    const int i = idx / T, j = idx - i * T;
    const float* di = da + i * ldda;
    const float* vj = v + j * ldk;
    float acc = 0.f;
    int c = j % hd;
    for (int t = 0; t < hd; ++t) {
      acc = fmaf(di[c], vj[c], acc);
      if (++c == hd) c = 0;
    }
    D[idx] = dr.apply(acc, site, row0 + i, j);
  }
  __syncthreads();
  for (int i = warp; i < T; i += nwarps) {
    const int idx = i * T + lane;
    const float pv = lane < T ? P[idx] : 0.f;
    const float dp = lane < T ? D[idx] : 0.f;
    const float dot = warp_sum(dp * pv);
    if (lane < T) {
      D[idx] = rnd<S>(pv * (dp - dot) * scale);
      P[idx] = rnd<S>(dr.apply(pv, site, row0 + i, lane));
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < T * hd; idx += blockDim.x) {
    const int j = idx / hd, c = idx - j * hd;
    float dv = 0.f, dk = 0.f, dq = 0.f;
    for (int i = 0; i < T; ++i) {
      dv = fmaf(P[i * T + j], da[i * ldda + c], dv);
      dk = fmaf(D[i * T + j], q[i * ldq + c], dk);
      dq = fmaf(D[j * T + i], k[i * ldk + c], dq);
    }
    out(j, c, rnd<S>(dq), rnd<S>(dk), rnd<S>(dv));
  }
  __syncthreads();
}

// mean and 1/sqrt(var + eps) of one row of width d (f32 values from get(c)),
// one-pass variance clamped at 0; called by a whole warp
template <typename Get>
__device__ __forceinline__ void ln_stats(int d, Get get, float& mu, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float a = get(c);
    s += a;
    s2 = fmaf(a, a, s2);
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  mu = s / d;
  const float var = fmaxf(s2 / d - mu * mu, 0.f);
  rstd = rsqrtf(var + kLnEps);
}

__device__ __forceinline__ float zhat(float a, float mu, float rstd) {
  return __fmul_rn(__fsub_rn(a, mu), rstd);
}
__device__ __forceinline__ float affine(float z, float g, float b) {
  return __fadd_rn(__fmul_rn(z, g), b);
}

// The backward of y = LN(a)·g + b over the rows of one sequence: da[r][c] =
// rstd·(dz − mean(dz) − zh·mean(dz·zh)) with dz = dy·g. dy(r, c) and zh(r, c)
// read the row's values, rstd(r) its statistic; emit(r, c, da) writes. Each
// warp takes whole rows.
template <typename Dy, typename Zh, typename Rstd, typename Emit>
__device__ __forceinline__ void ln_bwd_rows(int T, int d, const float* g, Dy dy, Zh zh,
                                            Rstd rstd, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < T; r += nwarps) {
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float dz = dy(r, c) * g[c];
      m1 += dz;
      m2 = fmaf(dz, zh(r, c), m2);
    }
    m1 = warp_sum(m1) / d;
    m2 = warp_sum(m2) / d;
    const float rs = rstd(r);
    for (int c = lane; c < d; c += 32) {
      const float dz = dy(r, c) * g[c];
      emit(r, c, rs * (dz - m1 - zh(r, c) * m2));
    }
  }
}

struct Shape {
  int nseq, T, d, H, ff, thresh;
};

__host__ __device__ inline int tiles(int n) { return (n + kTile - 1) / kTile; }

// launch kernel with `smem` dynamic shared memory, opting in above 48 KB
template <typename Kernel, typename Args>
int launch(Kernel kernel, int blocks, size_t smem, cudaStream_t stream, const Args& args,
           const Shape& sh) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kThreads, smem, stream>>>(args, sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
