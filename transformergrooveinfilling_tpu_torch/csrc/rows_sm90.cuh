// Row passes of the whole-layer chains (layer_sm90.cu, layer_wide_sm90.cu):
// one warp a row of d ≤ 1,024 columns, lane l holding the 8 columns 256c + 8l
// .. 256c + 8l + 7 of each of the row's C chunks of 256 columns (C = 1 up to d
// 256). A lane sums its columns in order, chunk by chunk, and the warp's
// shuffle tree adds the lanes: a fixed order, so two runs agree bit for bit.
// The LayerNorm statistics are the one-pass variance clamped at 0, and a
// dropout site's mask is layer_common.cuh's, counted by (site, row, column).

#pragma once

#include <type_traits>

#include "epilogues_sm90.cuh"

namespace {

constexpr int kLnChunk = 8 * 32;  // a warp's 32 lanes × 8 columns
constexpr int kMaxWide = 4 * kLnChunk;  // the row passes take d ≤ 1,024
constexpr int kRowsPerBlock = kThreads / 32;  // a warp a row

__device__ __forceinline__ float drop_by(float v, uint32_t byte, int thresh, float keep) {
  return byte < static_cast<uint32_t>(thresh) ? v / keep : 0.f;
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// this warp's row of a row pass (or -1 past the rows) and this lane's first
// column of each chunk
template <int C>
__device__ __forceinline__ int row_lanes(int rows, int (&c0)[C]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < C; ++c) c0[c] = kLnChunk * c + 8 * lane;
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  return r < rows ? r : -1;
}

// the row's mean and rstd from this lane's values of it, the one-pass
// variance clamped at 0 (ln_stats)
template <int C>
__device__ __forceinline__ void row_stats(const float (&a)[C][8], int d, float& mu, float& rstd) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += a[c][i];
      s2 = fmaf(a[c][i], a[c][i], s2);
    }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  mu = s / d;
  rstd = rsqrtf(fmaxf(s2 / d - mu * mu, 0.f) + kLnEps);
}

// da = rstd·(dz − mean(dz) − ẑ·mean(dz·ẑ)) with dz = dy·g, ẑ = zhat(a), over
// this lane's columns; dz is replaced by da, and drop(da) at the row's site
// goes to df (the mask counted by (site, row, column))
template <int C>
__device__ __forceinline__ void row_backward(float (&dz)[C][8], float (&df)[C][8],
                                             const float (&a)[C][8], const int (&c0)[C], int d,
                                             float mu, float rstd, uint32_t seed, int site,
                                             int row, int thresh) {
  float m1 = 0.f, m2 = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m1 += dz[c][i];
      m2 = fmaf(dz[c][i], zhat(a[c][i], mu, rstd), m2);
    }
  m1 = warp_sum(m1) / d;
  m2 = warp_sum(m2) / d;
  const float keep = thresh / 256.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c0[c] >= d) continue;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (thresh < 256) w = dropout_words(seed, site, row, c0[c] >> 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      dz[c][i] = rstd * (dz[c][i] - m1 - zhat(a[c][i], mu, rstd) * m2);
      df[c][i] = thresh < 256 ? drop_by(dz[c][i], word_byte(w, (c0[c] + i) & 15), thresh, keep)
                              : dz[c][i];
    }
  }
}

// fn(std::integral_constant<int, C>{}) for the row passes' C = ⌈d / 256⌉
// chunks; cudaErrorInvalidValue (nothing launched) unless 1 ≤ d ≤ kMaxWide
template <class F>
int by_chunks(int d, F&& fn) {
  if (d < 1 || d > kMaxWide) return static_cast<int>(cudaErrorInvalidValue);
  switch ((d + kLnChunk - 1) / kLnChunk) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 4: return fn(std::integral_constant<int, 4>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
