// Device functions shared by the layer kernels (layer_sm90.cu, fused_ffn.cu,
// fused_ln.cu): the Philox dropout stream, warp sums and the LayerNorm's
// normalisation.
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
constexpr float kLnEps = 1e-5f;

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

// the four dropout words of 16-column group 4t + q of a row, when the quad's
// thread q drew group 4t + q (`mine`)
__device__ __forceinline__ uint4 quad_word(const uint4& mine, int q) {
  const int src = (threadIdx.x & 28) | q;
  return make_uint4(__shfl_sync(0xffffffffu, mine.x, src), __shfl_sync(0xffffffffu, mine.y, src),
                    __shfl_sync(0xffffffffu, mine.z, src), __shfl_sync(0xffffffffu, mine.w, src));
}

// ---------------------------------------------------------------- shared pieces

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

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

}  // namespace
