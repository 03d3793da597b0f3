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
// What bounds it on the H100: bytes. Forward reads x and y and writes out (3
// values an element), backward reads x, y, g and writes dx, dy (5), against
// about 20 f32 operations an element. So each value crosses device memory
// once (the mask never does, in either direction), and the design is about
// keeping enough bytes in flight:
//
//   * A row lives in registers. Lane l of a warp owns the 16-byte chunks l,
//     l + 32, ... of each row (8 bf16 or 4 f32 values; 8 bytes, 4 bf16, where
//     a bf16 width is a multiple of 4 but not of 8), up to 8 chunks, so x, y
//     and g are each loaded once, with one load instruction a chunk.
//   * The grid is one wave. Forward: 2 blocks of 8 warps an SM. Backward: one
//     block an SM, of 24 warps while a lane holds at most 16 values of a row,
//     16 up to 32, 8 beyond (what the registers allow). Each warp takes an
//     equal, contiguous share of the rows (the wrapper sizes the grid from
//     the SM count), R at a time (R = 4, 2 or 1 as the row widens: about 32
//     f32 values a lane in the forward, 16 in the backward), its last rows
//     one at a time: it loads the chunks of all R rows before any reduction,
//     then runs their warp sums side by side.
//   * Mean and variance by two passes over the registers; one Philox call per
//     4 columns.
//   * Backward: each lane adds its columns' g·zhat and g into its own slots
//     of two f32 arrays in shared memory (laid out lane-minor, so a warp's
//     accesses hit 32 banks, and with no barrier: registers would not hold
//     them beside a row at d 1,024); the block adds its warps' sums once, in
//     warp order, and writes one partial. dscale and dbias are then summed in
//     the same launch, without float atomics, by a tree of tickets: 16 blocks
//     make a node, 16 nodes the next (two levels on 132 SMs); the last of a
//     node's blocks to finish (an integer ticket: atomicInc after
//     __threadfence) adds their partials in order, 8 loads a thread in
//     flight, and the root writes dscale and dbias. atomicInc wraps each
//     ticket back to 0 as the last one takes it, so the counters are zero
//     again at the end of every launch with no memset launch. Reruns are
//     bit-identical; the order depends on the grid only.
//
// The tickets are one buffer per (device, stream) that the wrapper caches:
// two backward launches on one stream run one after the other, and two
// streams never share a counter (ops/fused_ln.py::ln_backward).
//
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 17; PERF.md §6),
// bf16, rows 16,384 × d 256 / 4,096 × d 1,024: forward 12.1 / 13.5 µs of
// device time (bound 7.5), backward with dscale and dbias 22.2 / 26.5 µs
// (bound 12.5), in one launch each; rows 1,024 × d 256: 3.5 and 11.9 µs,
// launch and tree latency. What still holds it back: the backward's two
// levels of tickets at the end of the launch, and at d 1,024 warps of about
// two rows each, whose loads, Philox-heavy arithmetic and stores run in step.
//
// Dropout here is not the layer kernels' 8-bit rule: one 32-bit word per
// element, kept when word ≥ thresh = int(rate·2³²), rescaled by 1/(1 − rate)
// (fused_ln.py::_keep_mask). The words are Philox4x32-10 under key (seed, 0)
// at counter (col / 4, row, site 4, 0); element (row, col) takes word col % 4
// (ops/fused_ln.py::dropout_words draws the same ones). A 16-byte bf16 chunk
// is two calls.
//
// x, y, g, out, dx, dy: (rows, d) in the storage dtype S (f32 or bf16), d a
// multiple of 4 of at most 8 chunks a lane (2,048 in bf16 with d % 8 = 0,
// else 1,024), rows 16-byte aligned (8 for the narrow bf16 path); scale,
// bias, dparams and the partials f32. Plain C entry points, bound from Python
// with ctypes (ops/fused_ln.py); each returns cudaGetLastError() after its
// launch.

#include <type_traits>

#include "layer_common.cuh"

namespace {

constexpr uint32_t kSiteLn = 4;
constexpr int kMaxChunks = 8;  // a lane's chunks of a row, at most
constexpr int kFan = 16;       // partials one block of the backward's tree adds
constexpr int kFanLoads = 8;   // ... with this many loads in flight

struct LnShape {
  int rows, d;
  uint32_t thresh;  // keep when word >= thresh
  float inv_keep;   // 1 / (1 - rate)
  int drop;         // rate > 0
};

// warps a backward block has (one block an SM): 24 while a lane holds at most
// 16 values of a row (85 registers a thread), 16 up to 32 (128), else 8;
// ops/fused_ln.py::bwd_warps mirrors it
__host__ __device__ constexpr int bwd_warps(int lane_values) {
  return lane_values <= 16 ? 24 : lane_values <= 32 ? 16 : 8;
}

// rows a warp has in flight: about 32 (forward) or 16 (backward) f32 values a
// lane, at most 4 rows
__host__ __device__ constexpr int rows_in_flight(int lane_values, bool backward) {
  return (backward ? 16 : 32) / lane_values >= 4   ? 4
         : (backward ? 16 : 32) / lane_values >= 2 ? 2
                                                   : 1;
}

// One chunk of V values of S: its raw bits (16 or 8 bytes), loaded and stored
// with one instruction.
template <typename S, int V>
struct Chunk {
  static constexpr int kBytes = V * static_cast<int>(sizeof(S));
  static_assert(kBytes == 16 || kBytes == 8, "a chunk is 16 or 8 bytes");
  using Raw = std::conditional_t<kBytes == 16, uint4, uint2>;

  static __device__ __forceinline__ Raw load(const S* p) {
    return __ldg(reinterpret_cast<const Raw*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&r);
    if constexpr (std::is_same_v<S, float>) {
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = __uint_as_float(w[e]);
    } else {  // bf16 pairs: the low half is the earlier column
#pragma unroll
      for (int e = 0; e < V / 2; ++e) {
        f[2 * e] = __uint_as_float(w[e] << 16);
        f[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
      }
    }
  }
  static __device__ __forceinline__ void store(S* p, const float* f) {
    Raw r;
    uint32_t* w = reinterpret_cast<uint32_t*>(&r);
    if constexpr (std::is_same_v<S, float>) {
#pragma unroll
      for (int e = 0; e < V; ++e) w[e] = __float_as_uint(f[e]);
    } else {  // round to nearest even, as astype(bf16)
#pragma unroll
      for (int e = 0; e < V / 2; ++e) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
        w[e] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    *reinterpret_cast<Raw*>(p) = r;
  }
};

// V f32 values of a parameter vector (scale or bias) from the read-only path
template <int V>
__device__ __forceinline__ void load_params(const float* p, float* f) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + q);
    f[4 * q] = v.x; f[4 * q + 1] = v.y; f[4 * q + 2] = v.z; f[4 * q + 3] = v.w;
  }
}

// the keep bits of chunk c (columns c·V ... c·V + V − 1) of one row: bit e
// set when column c·V + e is kept
template <int V>
__device__ __forceinline__ uint32_t keep_bits(const LnShape& sh, uint32_t seed, int row, int c) {
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const uint4 w = dropout_words(seed, kSiteLn, static_cast<uint32_t>(row),
                                  static_cast<uint32_t>(c * (V / 4) + q));
    bits |= (w.x >= sh.thresh ? 1u : 0u) << (4 * q);
    bits |= (w.y >= sh.thresh ? 2u : 0u) << (4 * q);
    bits |= (w.z >= sh.thresh ? 4u : 0u) << (4 * q);
    bits |= (w.w >= sh.thresh ? 8u : 0u) << (4 * q);
  }
  return bits;
}

// The rows first .. first + R − 1 (those below end), loaded and turned
// into a = x + drop(y) in registers, with each row's mean and 1/sqrt(var +
// eps) by two passes. keep[r][k] holds chunk k's keep bits (all set at rate
// 0). Lanes past the row's chunks hold zeros and add nothing.
template <typename S, int V, int NC, int R>
__device__ __forceinline__ void rows_stats(const S* __restrict__ x, const S* __restrict__ y,
                                           const LnShape& sh, uint32_t seed, int first, int end,
                                           float (&a)[R][NC][V], uint32_t (&keep)[R][NC],
                                           float (&mu)[R], float (&rstd)[R]) {
  using C = Chunk<S, V>;
  const int lane = threadIdx.x & 31, chunks = sh.d / V;
  typename C::Raw xr[R][NC], yr[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane + 32 * k, row = first + r;
      xr[r][k] = yr[r][k] = typename C::Raw{};
      if (row < end && c < chunks) {
        const size_t off = static_cast<size_t>(row) * sh.d + static_cast<size_t>(c) * V;
        xr[r][k] = C::load(x + off);
        yr[r][k] = C::load(y + off);
      }
    }
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s[r] = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane + 32 * k, row = first + r;
      float xv[V], yv[V];
      C::unpack(xr[r][k], xv);
      C::unpack(yr[r][k], yv);
      keep[r][k] = sh.drop && row < end && c < chunks ? keep_bits<V>(sh, seed, row, c)
                                                      : 0xFFFFFFFFu;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float ks = (keep[r][k] >> e) & 1u ? sh.inv_keep : 0.f;
        a[r][k][e] = sh.drop ? __fadd_rn(xv[e], __fmul_rn(yv[e], ks)) : xv[e] + yv[e];
        s[r] += a[r][k][e];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) mu[r] = warp_sum(s[r]) / sh.d;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s[r] = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (lane + 32 * k < chunks)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float t = a[r][k][e] - mu[r];
          s[r] = fmaf(t, t, s[r]);
        }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) rstd[r] = rsqrtf(warp_sum(s[r]) / sh.d + kLnEps);
}

// the rows of this warp: an equal share (to one row) of the grid's warps,
// contiguous, so that every warp of the one wave the grid makes has as many
// rows in flight as the others
__device__ __forceinline__ void warp_rows(int rows, int& begin, int& end) {
  const int per_block = blockDim.x >> 5;
  const long long warps = static_cast<long long>(gridDim.x) * per_block;
  const long long w = static_cast<long long>(blockIdx.x) * per_block + (threadIdx.x >> 5);
  begin = static_cast<int>(w * rows / warps);
  end = static_cast<int>((w + 1) * rows / warps);
}

// rows first .. first + R − 1 (those below end) of the forward
template <typename S, int V, int NC, int R>
__device__ __forceinline__ void fwd_rows(const S* __restrict__ x, const S* __restrict__ y,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias, S* __restrict__ out,
                                         const LnShape& sh, uint32_t seed, int first, int end) {
  using C = Chunk<S, V>;
  const int lane = threadIdx.x & 31, chunks = sh.d / V;
  float a[R][NC][V], mu[R], rstd[R];
  uint32_t keep[R][NC];
  rows_stats<S, V, NC, R>(x, y, sh, seed, first, end, a, keep, mu, rstd);
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    if (c >= chunks) continue;
    float sc[V], bi[V];
    load_params<V>(scale + c * V, sc);
    load_params<V>(bias + c * V, bi);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (first + r >= end) continue;
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = affine(zhat(a[r][k][e], mu[r], rstd[r]), sc[e], bi[e]);
      C::store(out + static_cast<size_t>(first + r) * sh.d + c * V, o);
    }
  }
}

// R rows at a time, then the warp's last rows one at a time (a warp with one
// row pays one row's reductions)
template <typename S, int V, int NC, int R>
__global__ void __launch_bounds__(kThreads, NC * V > 32 ? 1 : 2)
ln_fwd(const S* __restrict__ x, const S* __restrict__ y, const float* __restrict__ scale,
       const float* __restrict__ bias, const int* __restrict__ seed, S* __restrict__ out,
       LnShape sh) {
  const uint32_t sd = static_cast<uint32_t>(*seed);
  int first, end;
  warp_rows(sh.rows, first, end);
  for (; first + R <= end; first += R)
    fwd_rows<S, V, NC, R>(x, y, scale, bias, out, sh, sd, first, end);
  if constexpr (R > 1)
    for (; first < end; ++first) fwd_rows<S, V, NC, 1>(x, y, scale, bias, out, sh, sd, first, end);
}

// rows first .. first + R − 1 (those below end) of the backward: dx, dy, and
// their g·zhat and g added into the lane's slots acc_s, acc_b
template <typename S, int V, int NC, int R>
__device__ __forceinline__ void bwd_rows(const S* __restrict__ x, const S* __restrict__ y,
                                         const float* __restrict__ scale,
                                         const S* __restrict__ g_out, S* __restrict__ dx,
                                         S* __restrict__ dy, float* acc_s, float* acc_b,
                                         const LnShape& sh, uint32_t sd, int first, int end) {
  using C = Chunk<S, V>;
  const int lane = threadIdx.x & 31, chunks = sh.d / V, d = sh.d;
  typename C::Raw gr[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane + 32 * k;
      gr[r][k] = typename C::Raw{};
      if (first + r < end && c < chunks)
        gr[r][k] = C::load(g_out + static_cast<size_t>(first + r) * d + c * V);
    }
  float a[R][NC][V], mu[R], rstd[R];
  uint32_t keep[R][NC];
  rows_stats<S, V, NC, R>(x, y, sh, sd, first, end, a, keep, mu, rstd);
  // a becomes zhat; the row's means of g·scale and g·scale·zhat
  float m1[R], m2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m1[r] = m2[r] = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane + 32 * k;
      if (c >= chunks) continue;
      float gv[V], sc[V];
      C::unpack(gr[r][k], gv);
      load_params<V>(scale + c * V, sc);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        a[r][k][e] = zhat(a[r][k][e], mu[r], rstd[r]);
        const float gs = gv[e] * sc[e];
        m1[r] += gs;
        m2[r] = fmaf(gs, a[r][k][e], m2[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m1[r] = warp_sum(m1[r]) / d;
    m2[r] = warp_sum(m2[r]) / d;
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    if (c >= chunks) continue;
    float sc[V];
    load_params<V>(scale + c * V, sc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (first + r >= end) continue;
      float gv[V], da[V], dyv[V];
      C::unpack(gr[r][k], gv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float zh = a[r][k][e];
        da[e] = rstd[r] * (gv[e] * sc[e] - m1[r] - zh * m2[r]);
        dyv[e] = da[e] * ((keep[r][k] >> e) & 1u ? sh.inv_keep : 0.f);
        acc_s[32 * (k * V + e)] = fmaf(gv[e], zh, acc_s[32 * (k * V + e)]);
        acc_b[32 * (k * V + e)] += gv[e];
      }
      const size_t off = static_cast<size_t>(first + r) * d + c * V;
      C::store(dx + off, da);
      C::store(dy + off, dyv);
    }
  }
}

template <typename S, int V, int NC, int R, int W = bwd_warps(NC * V)>
__global__ void __launch_bounds__(32 * W, 1)
ln_bwd(const S* __restrict__ x, const S* __restrict__ y, const float* __restrict__ scale,
       const int* __restrict__ seed, const S* __restrict__ g_out, S* __restrict__ dx,
       S* __restrict__ dy, float* __restrict__ dparams, float* __restrict__ partials,
       unsigned int* __restrict__ tickets, LnShape sh) {
  // (2, warps, NC·V, 32): Σ g·zhat, then Σ g, of each warp; lane l's value e
  // of its chunk k at [(k·V + e)·32 + l], so a warp's accesses hit 32 banks
  constexpr int kSlots = NC * V * 32;
  extern __shared__ __align__(16) float sm[];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, d = sh.d;
  float* acc_s = sm + warp * kSlots + lane;
  float* acc_b = sm + (W + warp) * kSlots + lane;
  const uint32_t sd = static_cast<uint32_t>(*seed);
#pragma unroll
  for (int i = 0; i < NC * V; ++i) acc_s[32 * i] = acc_b[32 * i] = 0.f;

  int first, end;
  warp_rows(sh.rows, first, end);
  for (; first + R <= end; first += R)
    bwd_rows<S, V, NC, R>(x, y, scale, g_out, dx, dy, acc_s, acc_b, sh, sd, first, end);
  if constexpr (R > 1)
    for (; first < end; ++first)
      bwd_rows<S, V, NC, 1>(x, y, scale, g_out, dx, dy, acc_s, acc_b, sh, sd, first, end);
  __syncthreads();

  // the block's partial (Σ g·zhat | Σ g): its warps' sums in warp order
  const int width = 2 * d;
  float* part = gridDim.x == 1 ? dparams : partials + static_cast<size_t>(blockIdx.x) * width;
  for (int i = threadIdx.x; i < width; i += 32 * W) {
    const int col = i >= d ? i - d : i, c = col / V;
    const float* at = sm + (i >= d ? W * kSlots : 0) + ((c >> 5) * V + col % V) * 32 + (c & 31);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) s += at[w * kSlots];
    part[i] = s;
  }

  // a tree of tickets: a node of level l + 1 is kFan nodes of level l (level
  // 0: the blocks); the last of them to finish adds their sums in node order
  int node = blockIdx.x, count = gridDim.x;
  const float* in = partials;
  float* out = partials + static_cast<size_t>(count) * width;
  while (count > 1) {
    const int parent = node / kFan, first = parent * kFan, n = min(kFan, count - first);
    const int parents = (count + kFan - 1) / kFan;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicInc(tickets + parent, n - 1) == static_cast<unsigned>(n - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    float* dst = parents == 1 ? dparams : out + static_cast<size_t>(parent) * width;
    const float4* src = reinterpret_cast<const float4*>(in + static_cast<size_t>(first) * width);
    for (int q = threadIdx.x; q < width / 4; q += 32 * W) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k0 = 0; k0 < kFan; k0 += kFanLoads) {  // kFanLoads loads in flight
        float4 v[kFanLoads];
#pragma unroll
        for (int k = 0; k < kFanLoads; ++k)
          if (k0 + k < n) v[k] = __ldcg(src + static_cast<size_t>(k0 + k) * (width / 4) + q);
#pragma unroll
        for (int k = 0; k < kFanLoads; ++k)
          if (k0 + k < n) {
            s.x += v[k].x; s.y += v[k].y; s.z += v[k].z; s.w += v[k].w;
          }
      }
      reinterpret_cast<float4*>(dst)[q] = s;
    }
    tickets += parents;
    in = out;
    out += static_cast<size_t>(parents) * width;
    node = parent;
    count = parents;
  }
}

struct FwdArgs {
  void *x, *y, *scale, *bias, *seed, *out;
};
struct BwdArgs {
  void *x, *y, *scale, *seed, *g, *dx, *dy, *dparams, *partials, *tickets;
};

template <typename S, int V, int NC>
int launch(const FwdArgs& p, const LnShape& sh, int blocks, cudaStream_t stream) {
  constexpr int R = rows_in_flight(NC * V, false);
  ln_fwd<S, V, NC, R><<<blocks, kThreads, 0, stream>>>(
      static_cast<const S*>(p.x), static_cast<const S*>(p.y), static_cast<const float*>(p.scale),
      static_cast<const float*>(p.bias), static_cast<const int*>(p.seed), static_cast<S*>(p.out),
      sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int V, int NC>
int launch(const BwdArgs& p, const LnShape& sh, int blocks, cudaStream_t stream) {
  constexpr int R = rows_in_flight(NC * V, true);
  constexpr int W = bwd_warps(NC * V);
  const size_t smem = sizeof(float) * 2 * W * NC * V * 32;
  auto kernel = ln_bwd<S, V, NC, R, W>;
  // the static `last` flag counts against the 48 KB a block may take unasked
  if (smem + sizeof(int) > 48 * 1024)
    if (const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)))
      return static_cast<int>(err);
  kernel<<<blocks, 32 * W, smem, stream>>>(
      static_cast<const S*>(p.x), static_cast<const S*>(p.y), static_cast<const float*>(p.scale),
      static_cast<const int*>(p.seed), static_cast<const S*>(p.g), static_cast<S*>(p.dx),
      static_cast<S*>(p.dy), static_cast<float*>(p.dparams), static_cast<float*>(p.partials),
      static_cast<unsigned int*>(p.tickets), sh);
  return static_cast<int>(cudaGetLastError());
}

// the instance whose NC (chunks a lane, a power of 2) holds a row of d
template <typename S, int V, typename Args>
int dispatch(const Args& p, const LnShape& sh, int blocks, cudaStream_t stream) {
  const int per_lane = (sh.d / V + 31) / 32;
  if (per_lane <= 1) return launch<S, V, 1>(p, sh, blocks, stream);
  if (per_lane <= 2) return launch<S, V, 2>(p, sh, blocks, stream);
  if (per_lane <= 4) return launch<S, V, 4>(p, sh, blocks, stream);
  if (per_lane <= kMaxChunks) return launch<S, V, kMaxChunks>(p, sh, blocks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Args>
int run(const Args& p, const LnShape& sh, int is_bf16, int blocks, cudaStream_t stream) {
  if (sh.rows < 1 || sh.d < 4 || sh.d % 4 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!is_bf16) return dispatch<float, 4>(p, sh, blocks, stream);
  if (sh.d % 8 == 0) return dispatch<__nv_bfloat16, 8>(p, sh, blocks, stream);
  return dispatch<__nv_bfloat16, 4>(p, sh, blocks, stream);
}

}  // namespace

extern "C" {

// rows × d elements, d a multiple of 4 whose chunks fill at most 8 a lane
// (d ≤ 2,048 in bf16 with d % 8 = 0, else d ≤ 1,024); thresh = int(rate·2³²)
// and inv_keep = 1/(1 − rate) with drop = (rate > 0); is_bf16 picks the
// storage dtype; blocks is the grid (any positive count is right). All
// pointers are device pointers of contiguous tensors; seed points to one
// int32.
int tgi_ln_fwd(void* x, void* y, void* scale, void* bias, void* seed, void* out, int rows, int d,
               unsigned int thresh, float inv_keep, int drop, int is_bf16, int blocks,
               void* stream) {
  const LnShape sh{rows, d, thresh, inv_keep, drop};
  return run(FwdArgs{x, y, scale, bias, seed, out}, sh, is_bf16, blocks,
             static_cast<cudaStream_t>(stream));
}

// dparams: (2, d) f32, dscale then dbias; partials: f32 scratch of (2, d)
// for every node of the tree but its root (blocks, ceil(blocks / 8), ...,
// while more than 1); tickets: one unsigned int for every node above the
// blocks, zero before the first launch on them and zero again after each.
int tgi_ln_bwd(void* x, void* y, void* scale, void* seed, void* g, void* dx, void* dy,
               void* dparams, void* partials, void* tickets, int rows, int d,
               unsigned int thresh, float inv_keep, int drop, int is_bf16, int blocks,
               void* stream) {
  const LnShape sh{rows, d, thresh, inv_keep, drop};
  return run(BwdArgs{x, y, scale, seed, g, dx, dy, dparams, partials, tickets}, sh, is_bf16,
             blocks, static_cast<cudaStream_t>(stream));
}

const char* tgi_ln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
