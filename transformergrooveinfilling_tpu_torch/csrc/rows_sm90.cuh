// Row passes of the whole-layer chains (layer_sm90.cu, layer_wide_sm90.cu): a
// group of G threads a row, thread l of it holding the 8 columns 8Gc + 8l ..
// 8Gc + 8l + 7 of each of the row's C chunks of 8G columns. Up to d 1,024 the
// group is a warp (C ≤ 4 chunks of 256; C = 1 up to d 256); past it, up to
// kMaxWide (8,192), the block's 256 threads (C ≤ 4 chunks of 2,048), so a
// thread holds at most 32 values of a row at any width. A thread sums its
// columns in order, chunk by chunk, the warp's shuffle tree adds the lanes,
// and a block adds its warps' sums in warp order through shared memory: a
// fixed order, so two runs agree bit for bit. The LayerNorm statistics are
// the one-pass variance clamped at 0, and a dropout site's mask is
// layer_common.cuh's, counted by (site, row, column).

#pragma once

#include <type_traits>

#include "epilogues_sm90.cuh"

namespace {

constexpr int kWarpWide = 4 * 8 * 32;  // a warp a row up to d 1,024
// the row passes take d ≤ 8,192: four chunks of the block's 256 × 8 columns,
// 32 values of a row a thread (a thread holds three such arrays in ln_rows)
constexpr int kMaxWide = 4 * 8 * kThreads;

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

// this group's row of a row pass (or -1 past the rows) and this thread's
// first column of each chunk
template <int C, int G>
__device__ __forceinline__ int row_lanes(int rows, int (&c0)[C]) {
  const int l = threadIdx.x % G;
#pragma unroll
  for (int c = 0; c < C; ++c) c0[c] = 8 * G * c + 8 * l;
  const int r = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  return r < rows ? r : -1;
}

// the sums of x and y over a row's G threads: the warp's shuffle tree, then
// (G > 32) the warps' sums in warp order through shared memory
template <int G>
__device__ __forceinline__ float2 row_sum(float x, float y) {
  x = warp_sum(x);
  y = warp_sum(y);
  if constexpr (G > 32) {
    __shared__ float2 part[G / 32];
    __syncthreads();  // an earlier sum's reads are done
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = make_float2(x, y);
    __syncthreads();
    x = part[0].x;
    y = part[0].y;
#pragma unroll
    for (int w = 1; w < G / 32; ++w) {
      x += part[w].x;
      y += part[w].y;
    }
  }
  return make_float2(x, y);
}

// the row's mean and rstd from this thread's values of it, the one-pass
// variance clamped at 0 (ln_stats)
template <int C, int G>
__device__ __forceinline__ void row_stats(const float (&a)[C][8], int d, float& mu, float& rstd) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += a[c][i];
      s2 = fmaf(a[c][i], a[c][i], s2);
    }
  const float2 t = row_sum<G>(s, s2);
  mu = t.x / d;
  rstd = rsqrtf(fmaxf(t.y / d - mu * mu, 0.f) + kLnEps);
}

// da = rstd·(dz − mean(dz) − ẑ·mean(dz·ẑ)) with dz = dy·g, ẑ = zhat(a), over
// this lane's columns; dz is replaced by da, and drop(da) at the row's site
// goes to df (the mask counted by (site, row, column))
template <int C, int G>
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
  const float2 m = row_sum<G>(m1, m2);
  m1 = m.x / d;
  m2 = m.y / d;
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

// a row pass's shape: C chunks of 8·G columns, a group of G threads a row,
// kRows rows a block of kThreads
template <int C, int G>
struct Chunks {
  static constexpr int kC = C, kG = G, kRows = kThreads / G;
};

// fn(Chunks<C, G>{}) for a row of d columns: a warp a row in C = ⌈d / 256⌉
// chunks up to d 1,024, past it the block in C = ⌈d / 2,048⌉;
// cudaErrorInvalidValue (nothing launched) unless 1 ≤ d ≤ kMaxWide
template <class F>
int by_chunks(int d, F&& fn) {
  if (d < 1 || d > kMaxWide) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= kWarpWide) {
    switch ((d + 255) / 256) {
      case 1: return fn(Chunks<1, 32>{});
      case 2: return fn(Chunks<2, 32>{});
      case 3: return fn(Chunks<3, 32>{});
      case 4: return fn(Chunks<4, 32>{});
    }
  }
  switch ((d + 8 * kThreads - 1) / (8 * kThreads)) {
    case 1: return fn(Chunks<1, kThreads>{});
    case 2: return fn(Chunks<2, kThreads>{});
    case 3: return fn(Chunks<3, kThreads>{});
    case 4: return fn(Chunks<4, kThreads>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
