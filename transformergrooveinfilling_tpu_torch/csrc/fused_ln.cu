// Fused dropout + residual add + LayerNorm for training, forward and
// backward, sm_90a.
//
// Replaces the Pallas TPU kernels transformergrooveinfilling_tpu/ops/
// fused_ln.py::_fwd_kernel (under _run_fwd) and ::_bwd_kernel (under
// _run_bwd), the two halves of dropout_add_layernorm:
//
//   a = x + dropout(y);  out = (a − mean(a))·rsqrt(var(a) + 1e-5)·scale + bias
//
// in f32 with the two-pass variance (mean((a − mean)²)), and its backward,
// which draws the mask again from the seed and returns dx, dy and the
// parameter gradients.
//
// Two kernels:
//   ln_fwd   one warp per row, 8 rows a block. The row's a = x + drop(y)
//            stays in shared memory between the three passes (sum, squared
//            deviations, output).
//   ln_bwd   one warp per row at a time, `rows_per_warp` rows one after the
//            other; recomputes a, the mask and the statistics, writes dx and
//            dy, and adds g·zhat and g of its rows into per-warp sums in
//            shared memory. The block then adds its 8 warps' sums in warp
//            order and writes one partial (dscale | dbias) per block; the
//            wrapper sums the partials over blocks (as the TPU code sums its
//            per-block partials outside the Pallas call). No float atomics:
//            two runs with one seed agree bit for bit.
//
// What bounds it on the H100: bytes. Forward reads x and y and writes out
// (3 values an element), backward reads x, y, g and writes dx, dy (5), against
// about 20 f32 operations an element: far below the 20 operations a byte at
// which f32 arithmetic would bind. So each value crosses device memory once
// (the mask never does, in either direction), loads and stores are 4 elements
// a lane (16 bytes in f32, 8 in bf16), and one Philox call serves 4 elements.
//
// Dropout here is not the layer kernels' 8-bit rule: one 32-bit word per
// element, kept when word ≥ thresh = int(rate·2³²), rescaled by 1/(1 − rate)
// (fused_ln.py::_keep_mask). The words are Philox4x32-10 under key (seed, 0)
// at counter (col / 4, row, site 4, 0); element (row, col) takes word col % 4
// (ops/fused_ln.py::dropout_words draws the same ones).
//
// x, y, g, out, dx, dy: (rows, d) in the storage dtype S (f32 or bf16), d a
// multiple of 4; scale, bias and the partials f32. Plain C entry points, bound
// from Python with ctypes (ops/fused_ln.py); each returns cudaGetLastError()
// after its launch.

#include "vec4.cuh"

namespace {

constexpr uint32_t kSiteLn = 4;
constexpr int kWarps = kThreads / 32;

struct LnShape {
  int rows, d;
  uint32_t thresh;  // keep when word >= thresh
  float inv_keep;   // 1 / (1 - rate)
  int drop;         // rate > 0
  int rows_per_warp;
};

struct Words {
  uint32_t w[4];
};

// the four 32-bit words of one Philox4x32-10 call
__device__ __forceinline__ Words dropout_words(uint32_t seed, uint32_t row, uint32_t group) {
  uint32_t c0 = group, c1 = row, c2 = kSiteLn, c3 = 0u, k0 = seed, k1 = 0u;
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
  Words out;
  out.w[0] = c0; out.w[1] = c1; out.w[2] = c2; out.w[3] = c3;
  return out;
}

// the factor dropout puts on y at 4 columns of one row: 1/(1 − rate) where
// kept, else 0
__device__ __forceinline__ void keep_scale(const LnShape& sh, uint32_t seed, int row, int group,
                                           float* ks) {
  if (!sh.drop) {
    ks[0] = ks[1] = ks[2] = ks[3] = 1.f;
    return;
  }
  const Words w = dropout_words(seed, static_cast<uint32_t>(row), static_cast<uint32_t>(group));
#pragma unroll
  for (int e = 0; e < 4; ++e) ks[e] = w.w[e] >= sh.thresh ? sh.inv_keep : 0.f;
}

// One row, called by a whole warp: a = x + drop(y) into `a` (shared memory,
// each lane its own column groups), then the row's mean and
// 1/sqrt(var + eps) by the two-pass variance.
template <typename S>
__device__ __forceinline__ void row_stats(const S* x, const S* y, const LnShape& sh,
                                          uint32_t seed, int row, float* a, float& mu,
                                          float& rstd) {
  const int lane = threadIdx.x & 31, groups = sh.d >> 2;
  const size_t base = static_cast<size_t>(row) * sh.d;
  float s = 0.f;
  for (int g = lane; g < groups; g += 32) {
    float xv[4], yv[4], ks[4];
    load4(x + base + 4 * g, xv);
    load4(y + base + 4 * g, yv);
    keep_scale(sh, seed, row, g, ks);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float av = sh.drop ? __fadd_rn(xv[e], __fmul_rn(yv[e], ks[e])) : xv[e] + yv[e];
      a[4 * g + e] = av;
      s += av;
    }
  }
  mu = warp_sum(s) / sh.d;
  float v = 0.f;
  for (int g = lane; g < groups; g += 32) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float t = a[4 * g + e] - mu;
      v = fmaf(t, t, v);
    }
  }
  rstd = rsqrtf(warp_sum(v) / sh.d + kLnEps);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
ln_fwd(const S* __restrict__ x, const S* __restrict__ y, const float* __restrict__ scale,
       const float* __restrict__ bias, const int* __restrict__ seed, S* __restrict__ out,
       LnShape sh) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, groups = sh.d >> 2;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= sh.rows) return;  // no block-wide barrier below
  float* a = sm + warp * sh.d;
  float mu, rstd;
  row_stats(x, y, sh, static_cast<uint32_t>(*seed), row, a, mu, rstd);
  const size_t base = static_cast<size_t>(row) * sh.d;
  for (int g = lane; g < groups; g += 32) {
    float sc[4], bi[4], o[4];
    load4(scale + 4 * g, sc);
    load4(bias + 4 * g, bi);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = affine(zhat(a[4 * g + e], mu, rstd), sc[e], bi[e]);
    store4(out + base + 4 * g, o);
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
ln_bwd(const S* __restrict__ x, const S* __restrict__ y, const float* __restrict__ scale,
       const int* __restrict__ seed, const S* __restrict__ g_out, S* __restrict__ dx,
       S* __restrict__ dy, float* __restrict__ partials, LnShape sh) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, groups = sh.d >> 2, d = sh.d;
  float* a = sm + warp * d;                        // (warps, d)
  float* acc_s = sm + (kWarps + warp) * d;         // (warps, d): Σ g·zhat
  float* acc_b = sm + (2 * kWarps + warp) * d;     // (warps, d): Σ g
  const uint32_t sd = static_cast<uint32_t>(*seed);
  // each lane zeroes the column groups it will add into
  for (int g = lane; g < groups; g += 32)
    for (int e = 0; e < 4; ++e) acc_s[4 * g + e] = acc_b[4 * g + e] = 0.f;
  const int first = (blockIdx.x * kWarps + warp) * sh.rows_per_warp;
  for (int i = 0; i < sh.rows_per_warp; ++i) {
    const int row = first + i;
    if (row >= sh.rows) break;
    float mu, rstd;
    row_stats(x, y, sh, sd, row, a, mu, rstd);
    const size_t base = static_cast<size_t>(row) * d;
    float m1 = 0.f, m2 = 0.f;
    for (int g = lane; g < groups; g += 32) {
      float gv[4], sc[4];
      load4(g_out + base + 4 * g, gv);
      load4(scale + 4 * g, sc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float gs = gv[e] * sc[e];
        m1 += gs;
        m2 = fmaf(gs, zhat(a[4 * g + e], mu, rstd), m2);
      }
    }
    m1 = warp_sum(m1) / d;
    m2 = warp_sum(m2) / d;
    for (int g = lane; g < groups; g += 32) {
      float gv[4], sc[4], ks[4], da[4], dyv[4];
      load4(g_out + base + 4 * g, gv);
      load4(scale + 4 * g, sc);
      keep_scale(sh, sd, row, g, ks);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float zh = zhat(a[4 * g + e], mu, rstd);
        da[e] = rstd * (gv[e] * sc[e] - m1 - zh * m2);
        dyv[e] = da[e] * ks[e];
        acc_s[4 * g + e] = fmaf(gv[e], zh, acc_s[4 * g + e]);
        acc_b[4 * g + e] += gv[e];
      }
      store4(dx + base + 4 * g, da);
      store4(dy + base + 4 * g, dyv);
    }
  }
  __syncthreads();
  // the block's partial: its warps' sums in warp order
  float* part = partials + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f, b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      s += sm[(kWarps + w) * d + c];
      b += sm[(2 * kWarps + w) * d + c];
    }
    part[c] = s;
    part[d + c] = b;
  }
}

template <typename S>
int fwd(void* x, void* y, void* scale, void* bias, void* seed, void* out, const LnShape& sh,
        cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * sh.d;
  if (const int err = opt_in(ln_fwd<S>, smem)) return err;
  const int blocks = (sh.rows + kWarps - 1) / kWarps;
  ln_fwd<S><<<blocks, kThreads, smem, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(y), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const int*>(seed), static_cast<S*>(out), sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int bwd(void* x, void* y, void* scale, void* seed, void* g, void* dx, void* dy, void* partials,
        const LnShape& sh, int blocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * kWarps * sh.d;
  if (const int err = opt_in(ln_bwd<S>, smem)) return err;
  ln_bwd<S><<<blocks, kThreads, smem, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(y), static_cast<const float*>(scale),
      static_cast<const int*>(seed), static_cast<const S*>(g), static_cast<S*>(dx),
      static_cast<S*>(dy), static_cast<float*>(partials), sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows × d elements, d a multiple of 4; thresh = int(rate·2³²) and inv_keep =
// 1/(1 − rate) with drop = (rate > 0); is_bf16 picks the storage dtype. All
// pointers are device pointers of contiguous tensors; seed points to one int32.

int tgi_ln_fwd(void* x, void* y, void* scale, void* bias, void* seed, void* out, int rows, int d,
               unsigned int thresh, float inv_keep, int drop, int is_bf16, void* stream) {
  const LnShape sh{rows, d, thresh, inv_keep, drop, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fwd<__nv_bfloat16>(x, y, scale, bias, seed, out, sh, s)
                 : fwd<float>(x, y, scale, bias, seed, out, sh, s);
}

// partials: (blocks, 2, d) f32 with blocks = ceil(rows / (8 · rows_per_warp));
// block b writes its rows' Σ g·zhat and Σ g.
int tgi_ln_bwd(void* x, void* y, void* scale, void* seed, void* g, void* dx, void* dy,
               void* partials, int rows, int d, unsigned int thresh, float inv_keep, int drop,
               int rows_per_warp, int is_bf16, void* stream) {
  const LnShape sh{rows, d, thresh, inv_keep, drop, rows_per_warp};
  const int per_block = kWarps * rows_per_warp;
  const int blocks = (rows + per_block - 1) / per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd<__nv_bfloat16>(x, y, scale, seed, g, dx, dy, partials, sh, blocks, s)
                 : bwd<float>(x, y, scale, seed, g, dx, dy, partials, sh, blocks, s);
}

const char* tgi_ln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
