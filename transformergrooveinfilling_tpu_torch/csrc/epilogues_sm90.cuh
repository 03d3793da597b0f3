// Epilogues of the wgmma core (gemm_sm90.cuh) shared by the fused FFN
// (fused_ffn.cu) and the whole-layer chains (layer_sm90.cu): bias and
// rounding, the FFN hidden (bias, ReLU, dropout, rounding), the hidden's
// gradient (the ReLU and mask recovered from h > 0), a plain rounding with an
// optional f32 residual, and the weight gradients with their column sums and
// the fixed-order reduce of their row splits.
//
// store() gets the values at (row, col), (row, col+1), (row, col+8),
// (row, col+9); col is even and the widths are multiples of 8, so a pair is
// in or out of the matrix as a whole. load() fetches what store() reads
// besides them, for a whole tile before its first store. Dropout is the
// layer kernels' 8-bit rule and Philox stream (layer_common.cuh).

#pragma once

#include "gemm_sm90.cuh"
#include "layer_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// h = round(drop(relu(x·W1ᵀ + b1))) at dropout site `site`. The four threads
// of a quad hold one row's columns of the same 16-column groups, so they
// share its dropout draws: each computes a quarter of them and passes on the
// two words that each of the others needs (word q/2 for columns 2q, 2q+1 of
// a group, word 2 + q/2 for columns 8 + 2q, 9 + 2q).
struct EpiHidden : NoExtra {
  bf16* h;
  const float* b1;
  const int* seed;
  int rows, ff, thresh, site;
  struct Aux {
    float4 b;
    uint32_t lo, hi;  // this thread's words of the (row, group) draw
  };
  template <int G>
  __device__ __forceinline__ void load(int, int, int row, int col, Aux (&aux)[G][2]) const {
#pragma unroll
    for (int g = 0; g < G; ++g) aux[g][0].b = aux[g][1].b = bias4(b1, col + 16 * g, ff);
    if (thresh >= 256) return;
    const int j = threadIdx.x & 3, q2 = (threadIdx.x >> 1) & 1;
    const uint32_t s = static_cast<uint32_t>(*seed);
    uint4 mine[G / 2];  // draws i = 2g + h with i % 4 == j: g = 2t + j/2, h = j % 2
#pragma unroll
    for (int t = 0; t < G / 2; ++t)
      mine[t] = dropout_words(s, site, row + 8 * (j & 1), (col >> 4) + 2 * t + (j >> 1));
    const int quad = threadIdx.x & 28;  // lane of the quad's first thread
#pragma unroll
    for (int i = 0; i < 2 * G; ++i) {
      const int src = quad | (i & 3);
      const uint4& m = mine[i >> 2];
      const uint32_t w0 = __shfl_sync(0xffffffffu, m.x, src);
      const uint32_t w1 = __shfl_sync(0xffffffffu, m.y, src);
      const uint32_t w2 = __shfl_sync(0xffffffffu, m.z, src);
      const uint32_t w3 = __shfl_sync(0xffffffffu, m.w, src);
      aux[i >> 1][i & 1].lo = q2 ? w1 : w0;
      aux[i >> 1][i & 1].hi = q2 ? w3 : w2;
    }
  }
  __device__ __forceinline__ void store(int, int, int row, int col, const float (&v)[4],
                                        const Aux& a) const {
    if (row >= rows) return;
    const float inv_keep = 256.f / thresh;
    const int shift = 16 * (threadIdx.x & 1);  // byte 2(q % 2) of a word, then the next
    const float b[4] = {a.b.x, a.b.y, a.b.z, a.b.w};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = col + 8 * p;
      if (c >= ff) continue;
      const uint32_t w = p ? a.hi : a.lo;
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        o[e] = fmaxf(v[2 * p + e] + b[2 * p + e], 0.f);
        if (thresh < 256)
          o[e] = ((w >> (shift + 8 * e)) & 0xFFu) < static_cast<uint32_t>(thresh) ? o[e] * inv_keep
                                                                                 : 0.f;
      }
      store2(h + static_cast<size_t>(row) * ff + c, o[0], o[1]);
    }
  }
};

// out = round(A·Wᵀ + bias)
struct EpiOut : NoExtra {
  bf16* out;
  const float* bias;
  int rows, width;
  using Aux = float4;
  __device__ __forceinline__ Aux load_one(int, int, int, int col) const {
    return bias4(bias, col, width);
  }
  template <int G>
  __device__ __forceinline__ void load(int problem, int split, int row, int col,
                                       Aux (&aux)[G][2]) const {
    load_quads(*this, problem, split, row, col, aux);
  }
  __device__ __forceinline__ void store(int, int, int row, int col, const float (&v)[4],
                                        const Aux& b) const {
    if (row >= rows) return;
    bf16* o = out + static_cast<size_t>(row) * width + col;
    if (col < width) store2(o, v[0] + b.x, v[1] + b.y);
    if (col + 8 < width) store2(o + 8, v[2] + b.z, v[3] + b.w);
  }
};

// out = round(A·W + resid), resid an f32 (rows, width) matrix or null
struct EpiRound : NoExtra {
  bf16* out;
  const float* resid;
  int rows, width;
  using Aux = NoAux;
  template <int G>
  __device__ __forceinline__ void load(int, int, int, int, Aux (&)[G][2]) const {}
  __device__ __forceinline__ void store(int, int, int row, int col, const float (&v)[4],
                                        const Aux&) const {
    if (row >= rows) return;
    const size_t at = static_cast<size_t>(row) * width + col;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (col + 8 * p >= width) continue;
      float2 r = make_float2(0.f, 0.f);
      if (resid) r = *reinterpret_cast<const float2*>(resid + at + 8 * p);
      store2(out + at + 8 * p, v[2 * p] + r.x, v[2 * p + 1] + r.y);
    }
  }
};

// dh = round(h > 0 ? g / keep : 0), g = dy·W2
struct EpiDh : NoExtra {
  bf16* dh;
  const bf16* h;
  int rows, ff, thresh;
  using Aux = uint2;  // the bf16 pairs of h at col and col + 8
  __device__ __forceinline__ Aux load_one(int, int, int row, int col) const {
    uint2 a = make_uint2(0u, 0u);
    if (row >= rows) return a;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(h + static_cast<size_t>(row) * ff + col);
    if (col < ff) a.x = p[0];
    if (col + 8 < ff) a.y = p[4];
    return a;
  }
  template <int G>
  __device__ __forceinline__ void load(int problem, int split, int row, int col,
                                       Aux (&aux)[G][2]) const {
    load_quads(*this, problem, split, row, col, aux);
  }
  __device__ __forceinline__ void store(int, int, int row, int col, const float (&v)[4],
                                        const Aux& a) const {
    if (row >= rows) return;
    const float inv_keep = 256.f / thresh;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = col + 8 * p;
      if (c >= ff) continue;
      const uint32_t bits = p ? a.y : a.x;
      const float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bits));
      store2(dh + static_cast<size_t>(row) * ff + c, hv.x > 0.f ? v[2 * p] * inv_keep : 0.f,
             hv.y > 0.f ? v[2 * p + 1] * inv_keep : 0.f);
    }
  }
};

// ---------------------------------------------------------------- weight gradients

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

constexpr int kMaxSegs = 16;

// A column-sum segment: Σ_r x[r][c]·(z ? ẑ(z[r][c]) : 1) over the split's
// rows (x bf16 or f32, rows a multiple of 8 wide), ẑ the LayerNorm-normalised
// z with row r's (mean, rstd) at stats[r·stats_ld]: a bias gradient (z null)
// or a LayerNorm gain's.
struct ColSeg {
  const void* x;
  const bf16* z;
  const float* stats;
  int width, x_f32, stats_ld, blocks, out;
};

// Weight gradients as products over the rows (both operands MN-major):
// problem p's dW_p (m_p × n_p) = dYᵀ·X into its split's f32 partial at
// off[p]; the extra blocks of a split sum the segments, 64 columns each, over
// the split's rows in a fixed order into the partial's vector part (vec +
// seg.out). A split's partial: the problems' results in order, then the
// segments' sums in order (wgrad_layout). No atomics: a reduce adds the
// splits in order (reduce_splits).
struct EpiWgrad {
  float* part;
  size_t split_stride, vec;
  size_t off[sm90::kMaxProblems];
  int m[sm90::kMaxProblems], n[sm90::kMaxProblems];
  ColSeg seg[kMaxSegs];
  using Aux = NoAux;
  template <int G>
  __device__ __forceinline__ void load(int, int, int, int, Aux (&)[G][2]) const {}
  __device__ __forceinline__ void store(int problem, int split, int row, int col,
                                        const float (&v)[4], const Aux&) const {
    const int mp = m[problem], np = n[problem];
    if (row >= mp) return;
    float* out = part + split * split_stride + off[problem] + static_cast<size_t>(row) * np;
    if (col < np) *reinterpret_cast<float2*>(out + col) = make_float2(v[0], v[1]);
    if (col + 8 < np) *reinterpret_cast<float2*>(out + col + 8) = make_float2(v[2], v[3]);
  }
  __device__ __forceinline__ void extra(int b, int split, int r_begin, int r_end) const {
    __shared__ float sums[48][64];  // (row groups, columns); up to 384 threads
    int si = 0;
    while (b >= seg[si].blocks) b -= seg[si++].blocks;
    const ColSeg& sg = seg[si];
    const int c0 = b * 64, cg = threadIdx.x & 7, rg = threadIdx.x >> 3;
    const int groups = blockDim.x >> 3, c = c0 + 8 * cg;
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (c < sg.width) {
      for (int r = r_begin + rg; r < r_end; r += groups) {
        const size_t at = static_cast<size_t>(r) * sg.width + c;
        float x[8];
        if (sg.x_f32) {
          const float4* f = reinterpret_cast<const float4*>(static_cast<const float*>(sg.x) + at);
          const float4 lo = f[0], hi = f[1];
          x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
          x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
        } else {
          load8(static_cast<const bf16*>(sg.x) + at, x);
        }
        if (sg.z) {
          float z[8];
          load8(sg.z + at, z);
          const float mu = sg.stats[static_cast<size_t>(r) * sg.stats_ld];
          const float rstd = sg.stats[static_cast<size_t>(r) * sg.stats_ld + 1];
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] *= zhat(z[i], mu, rstd);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] += x[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sums[rg][8 * cg + i] = s[i];
    __syncthreads();
    if (threadIdx.x < 64 && c0 + static_cast<int>(threadIdx.x) < sg.width) {
      float t = 0.f;
      for (int gi = 0; gi < groups; ++gi) t += sums[gi][threadIdx.x];
      part[split * split_stride + vec + sg.out + c0 + threadIdx.x] = t;
    }
  }
};

// Lays out a split's partial from m, n and each segment's width: off, vec,
// the segments' blocks and offsets, split_stride. Returns the extra blocks a
// split.
inline int wgrad_layout(EpiWgrad& e, int problems, int segments) {
  size_t at = 0;
  for (int p = 0; p < problems; ++p) {
    e.off[p] = at;
    at += static_cast<size_t>(e.m[p]) * e.n[p];
  }
  e.vec = at;
  int extra = 0, out = 0;
  for (int s = 0; s < segments; ++s) {
    e.seg[s].blocks = (e.seg[s].width + 63) / 64;
    e.seg[s].out = out;
    out += e.seg[s].width;
    extra += e.seg[s].blocks;
  }
  e.split_stride = at + out;
  return extra;
}

// out[i] = Σ_s part[s][i], in split order
__global__ void reduce_splits(const float* __restrict__ part, float* __restrict__ out,
                              size_t total, int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s += part[k * total + i];
  out[i] = s;
}

}  // namespace
