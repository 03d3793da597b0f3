// Device functions shared by the layer kernels (layer_sm90.cu, fused_ffn.cu,
// fused_ln.cu): vector loads, the Philox dropout stream, warp sums and the
// LayerNorm's normalisation.
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
constexpr int kTile = 64;
constexpr float kLnEps = 1e-5f;

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
__device__ __forceinline__ float zhat(float a, float mu, float rstd) {
  return __fmul_rn(__fsub_rn(a, mu), rstd);
}
__device__ __forceinline__ float affine(float z, float g, float b) {
  return __fadd_rn(__fmul_rn(z, g), b);
}

__host__ __device__ inline int tiles(int n) { return (n + kTile - 1) / kTile; }

}  // namespace
