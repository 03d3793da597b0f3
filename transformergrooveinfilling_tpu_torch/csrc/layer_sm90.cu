// The whole encoder and decoder layers for training on Hopper (sm_90a), in
// bf16 or f32, as chains of launches.
//
// Replaces the Pallas TPU kernels transformergrooveinfilling_tpu/ops/
// fused_layer.py::encoder_layer_train (_fwd_call → _fwd_kernel, _bwd_call →
// _bwd_kernel) and ops/fused_decoder_layer.py::decoder_layer_train (the same
// two). ops/fused_layer.py and ops/fused_decoder_layer.py compose the
// launches below into each layer's forward and backward, one chain for both
// dtypes (13 launches an encoder layer, 21 a decoder layer); each launch's
// plain PyTorch version is in ops/layer_sm90.py.
//
// What bounds a layer on the H100: its dense products, 2·rows·(4d² + 2·d·ff)
// FLOP forward at the encoder (8d² + 2·d·ff at the decoder) and twice that
// backward, against a few hundred bytes a row of activations: at the flagship
// (d 256, ff 512, rows 16,384) 17.2 GFLOP forward, 17 µs of the tensor cores
// at 989 TFLOP/s in bf16 and 104 µs at 165 TFLOP/s in f32 (495 / 3: the split
// TF32 product is three tensor-core products), against 37 µs (bf16) and 74 µs
// (f32) of the whole layer's own bytes; FMAs on the CUDA cores (67 TFLOP/s)
// would take 257 µs. This design puts every product on the wgmma core of
// gemm_sm90.cuh (TMA, a ring of stages, f32 accumulators, persistent blocks)
// with the layer's elementwise work in the products' epilogues ("round" is to
// bf16, and the identity in f32):
//
//   sm90_bias      A·Wᵀ + b, rounded (qkv; the decoder's qc and kv)
//   sm90_res_ln    a = resid + drop(A·Wᵀ + b); y = round(LN(a)): the row's
//                  256 columns in one 64 × 256 tile, so the LayerNorm's row
//                  sums are each thread's own and two shuffles in its quad;
//                  writes round(a) (a residual of the backward) and y
//   sm90_hidden    round(drop(relu(A·Wᵀ + b))) (epilogues_sm90.cuh)
//   sm90_dh        round(h > 0 ? (dF·W2)/keep : 0) (epilogues_sm90.cuh)
//   sm90_ln_bwd    v = dH·W + da (the next LayerNorm's input gradient);
//                  the LayerNorm's backward in the epilogue: da' (f32), v
//                  (f32, for the LN parameters' sums) and round(drop(da'))
//   sm90_round     round(dY·W [+ an f32 residual]) (dattn, dx, dmem)
//   sm90_ln_rows   one warp a row: the LayerNorm statistics of the stored
//                  inputs, y recomputed where a weight gradient needs it, and
//                  the last LayerNorm's backward from dy, with its site's mask
//                  (a lane holds 8 columns of each 256-column chunk of a row)
//   sm90_attn_fwd  one block per (sequence, head): P = softmax(QKᵀ/√hd)
//                  (causal for the decoder's self-attention), its dropout
//                  mask, round(drop(P))·V
//   sm90_attn_bwd  the same block: P again, dS, dQ, dK, dV rounded, and the
//                  attention output again for dWo
//   sm90_wgrad     every weight gradient of a layer, dYᵀ·X over the rows
//                  with both operands MN-major, in one grouped launch of
//                  128 × 128 tiles, the rows cut into splits of whole 64-row
//                  stages with f32 partials, and the bias and LayerNorm-
//                  parameter sums in blocks of their own
//   sm90_reduce    adds the splits' partials in split order
//
// The operands' layouts, and how each dtype's products take them. bias,
// hidden and res_ln read row-major activations and (out, in) weights, both
// K-major. round (dY·W for dx, dattn, dmem), dh (dF·W2) and ln_bwd (dH·W1)
// read the weight with the reduction on its rows (B MN-major); wgrad reads
// dY and X with the reduction on their rows (both MN-major). bf16: wgmma's
// transpose bits take every MN-major tile from shared memory as TMA wrote
// it. f32: wgmma's TF32 forms take only K-major shared-memory operands and
// have no transpose bits, so the consumer warpgroups split each raw f32
// stage into K-major hi and lo planes (gemm_sm90.cuh), reading it in its own
// layout: one route for every launch, no copy of a weight in device memory
// and no launch more, at the price of the split's shared-memory traffic
// (a read and two writes of each value, against the three products' reads).
//
// No float atomics anywhere: two runs with one seed agree bit for bit. The
// forward stores what the TPU kernel stores (qkv, a1, h, a2; the decoder's
// qkv, a1, qc, kv, a2, h, a3), in the activations' dtype; in bf16 the
// backward's buffers are bf16 where the TPU kernel rounds (dqkv, dattn, dS,
// dproj, dh, df, y1, the attention output), and the residual gradients that
// reach a LayerNorm (da, v) are f32 in both dtypes.
//
// The attention (4·T·d FLOP a row forward at T ≤ 32, 3 % of the layer's
// products, but a (sequence, head)'s Q, K, V and dA cross device memory
// once). bf16: on the tensor cores as mma.sync m16n8k16, two warps a
// (sequence, head) (fused_mha.cu's layout: the 64-row wgmma tiles would leave
// most of a warpgroup idle at T 32); hd is a multiple of 8 (16-byte rows for
// cp.async), zero-filled in shared memory to a multiple of 16 (the mma's k).
// f32: split TF32 on mma.sync, one block of two warps a (sequence, head), any
// hd (the configs' f32 layers have heads of 2, 4, 8, 16 and 128). A
// (sequence, head) of hd 512 takes 100 KB (bf16 forward) to 138 KB (bf16
// backward) of shared memory, and the f32 forward 203 KB; the f32 backward
// would need 273 KB there, so past the 232,448 bytes a block may take it
// reads V from device memory (L2) instead of staging it: 207 KB at hd 512.
//
// The wide route. A 64 × 256 tile spans a row up to d 256, which the
// LayerNorm epilogues need (kLnTile). Past it, up to d 1,024, each
// LayerNorm-epilogue launch becomes a product and a row pass, the launches of
// layer_wide_sm90.cu; the chain takes 16 launches an encoder layer and 26 a
// decoder layer there. The row pass of the backward (sm90_ln_rows) walks a row
// in chunks of 256 columns (rows_sm90.cuh) in both routes.
//
// Dropout: the layer kernels' 8-bit rule and Philox stream (layer_common.cuh),
// sites and counters as the TPU kernels number them, so the masks are
// ops/fused_layer.py::dropout_mask's.
//
// Plain C entry points, bound from Python with ctypes (ops/layer_sm90.py);
// `f32` picks the activations' dtype, and each returns cudaGetLastError()
// after its launch. Activations and weights are contiguous (the attention's
// q, k, v and their gradients may be column slices of a packed buffer, given
// by a row stride) and 16-byte aligned; biases, LayerNorm parameters,
// statistics and residual gradients are f32.

#include <type_traits>

#include "rows_sm90.cuh"  // and epilogues_sm90.cuh

namespace {

constexpr int kLnTile = 256;  // the LayerNorm epilogues' tile width: d ≤ 256
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory one block may take
// the longest reduction an f32 plain-rounding product runs unpromoted: the
// route up to d 256 reduces over at most 3·256 = 768 there, unchanged
constexpr int kPromoteK = 3 * kLnTile;
constexpr int kLnConfig = 3;  // run()'s 64 × 256 tile
constexpr int kWgradConfig = 1;  // run()'s 128 × 128 tile
constexpr int kMaxLn = 3;

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------- LayerNorm epilogues

// The accumulator of a 64 × BN tile with BN ≥ d (one tile spans the row): for
// row `row + 8h` the thread holds the column pairs col + 8i, i < BN/8, in
// acc[4i + 2h], acc[4i + 2h + 1]; pair i lies in 16-column group i / 2. The
// epilogue is latency-bound on its loads, so each row's residual pairs are
// fetched at once before they are used, the per-column vectors come from
// shared memory, and a dropout draw (one per row and group) is made by one
// thread of the lane quad that shares it and passed round by shuffles.

// up to three per-column vectors of kLnTile floats (0 past d), staged once a
// block by the consumer warpgroup
__device__ __forceinline__ float* ln_vectors() {
  __shared__ __align__(16) float v[3 * kLnTile];
  return v;
}

__device__ __forceinline__ void stage_vectors(const float* a, const float* b, const float* c,
                                              int d, int threads) {
  float* v = ln_vectors();
  for (int i = threadIdx.x; i < kLnTile; i += threads) {
    v[i] = i < d ? a[i] : 0.f;
    if (b) v[kLnTile + i] = i < d ? b[i] : 0.f;
    if (c) v[2 * kLnTile + i] = i < d ? c[i] : 0.f;
  }
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// the four dropout words of 16-column group 4t + q of a row, when the quad's
// thread q drew group 4t + q (`mine`)
__device__ __forceinline__ uint4 quad_word(const uint4& mine, int q) {
  const int src = (threadIdx.x & 28) | q;
  return make_uint4(__shfl_sync(0xffffffffu, mine.x, src), __shfl_sync(0xffffffffu, mine.y, src),
                    __shfl_sync(0xffffffffu, mine.z, src), __shfl_sync(0xffffffffu, mine.w, src));
}

// a = resid + drop(A·Wᵀ + bias) at `site`; a_out = round(a), y_out =
// round(LN(a)·g + beta), statistics from the f32 a (one-pass variance
// clamped at 0)
template <class T>
struct EpiResLn : NoExtra {
  static constexpr bool kWholeTile = true;
  T *a_out, *y_out;
  const T* resid;
  const float *bias, *g, *beta;
  const int* seed;
  int rows, d, thresh, site;

  __device__ __forceinline__ void prologue(int threads) const {
    stage_vectors(bias, g, beta, d, threads);
  }

  template <int BN>
  __device__ __forceinline__ void tile(int, int, int row, int col, float (&acc)[BN / 2]) const {
    constexpr int Q = BN / 16;  // 16-column groups
    // the residual's pairs fetched ahead: a bf16 row's at once (a register a
    // pair), an f32 row's by four groups (eight pairs), to stay in registers
    constexpr int kAhead = sizeof(T) == 2 ? 2 * Q : 8;
    using Raw = typename Pair<T>::type;
    const float* vb = ln_vectors();
    const float *vg = vb + kLnTile, *vbeta = vg + kLnTile;
    const uint32_t s = static_cast<uint32_t>(*seed);
    const float keep = thresh / 256.f;
    const int g0 = col >> 4, j = threadIdx.x & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      const bool live = r < rows;
      const size_t base = static_cast<size_t>(r) * d;
      Raw rv[kAhead];  // the residual's pairs
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int t = 0; t < Q / 4; ++t) {
        if (t == 0 || kAhead < 2 * Q) {
#pragma unroll
          for (int k = 0; k < kAhead; ++k) {
            const int i = (kAhead < 2 * Q ? 8 * t : 0) + k;
            rv[k] = live && col + 8 * i < d ? load_pair(resid + base + col + 8 * i) : Raw{};
          }
        }
        uint4 mine = make_uint4(0u, 0u, 0u, 0u);
        if (thresh < 256) mine = dropout_words(s, site, r, g0 + 4 * t + j);
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const uint4 w = thresh < 256 ? quad_word(mine, qq) : mine;
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int i = 2 * (4 * t + qq) + p, c = col + 8 * i;
            if (c >= d) continue;
            const float2 rf = unpack(rv[kAhead < 2 * Q ? i - 8 * t : i]);
            const float2 bb = *reinterpret_cast<const float2*>(vb + c);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& a = acc[4 * i + 2 * h + e];
              float v = a + (e ? bb.y : bb.x);
              if (thresh < 256) v = drop_by(v, word_byte(w, (c + e) & 15), thresh, keep);
              v += e ? rf.y : rf.x;
              a = v;
              sum += v;
              sq = fmaf(v, v, sq);
            }
          }
        }
      }
      sum = quad_sum(sum);
      sq = quad_sum(sq);
      const float mu = sum / d;
      const float rstd = rsqrtf(fmaxf(sq / d - mu * mu, 0.f) + kLnEps);
      if (!live) continue;
#pragma unroll
      for (int i = 0; i < 2 * Q; ++i) {
        const int c = col + 8 * i;
        if (c >= d) continue;
        const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        const float2 gg = *reinterpret_cast<const float2*>(vg + c);
        const float2 bt = *reinterpret_cast<const float2*>(vbeta + c);
        store2(a_out + base + c, v0, v1);
        store2(y_out + base + c, affine(zhat(v0, mu, rstd), gg.x, bt.x),
               affine(zhat(v1, mu, rstd), gg.y, bt.y));
      }
    }
  }
};

// v = A·W + resid, the gradient at a LayerNorm's output (y = LN(a_ln)·g + b);
// its backward da = rstd·(dz − mean(dz) − ẑ·mean(dz·ẑ)), dz = v·g, with ẑ
// and rstd from the stored a_ln and its row statistics. Writes v and da in
// f32 and round(drop(da)) at `site`.
template <class T>
struct EpiLnBwd : NoExtra {
  static constexpr bool kWholeTile = true;
  float *da_out, *v_out;
  T* dp_out;
  const float *resid, *g;
  const T* a_ln;
  const float* stats;  // (mean, rstd) of row r at stats[r·stats_ld]
  const int* seed;
  int rows, d, stats_ld, thresh, site;

  __device__ __forceinline__ void prologue(int threads) const {
    stage_vectors(g, nullptr, nullptr, d, threads);
  }

  template <int BN>
  __device__ __forceinline__ void tile(int, int, int row, int col, float (&acc)[BN / 2]) const {
    // groups; the row's pairs are read in kParts parts of H: halves in bf16,
    // quarters in f32 (an f32 pair takes two registers)
    constexpr int Q = BN / 16, kParts = sizeof(T) == 2 ? 2 : 4, H = 2 * Q / kParts;
    using Raw = typename Pair<T>::type;
    const float* vg = ln_vectors();
    const uint32_t s = static_cast<uint32_t>(*seed);
    const float keep = thresh / 256.f;
    const int g0 = col >> 4, j = threadIdx.x & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      const bool live = r < rows;
      const size_t base = static_cast<size_t>(r) * d;
      const float mu = live ? stats[static_cast<size_t>(r) * stats_ld] : 0.f;
      const float rstd = live ? stats[static_cast<size_t>(r) * stats_ld + 1] : 0.f;
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int part = 0; part < kParts; ++part) {  // the row's pairs, a part at a time
        float2 rf[H];
        Raw av[H];
#pragma unroll
        for (int k = 0; k < H; ++k) {
          const int c = col + 8 * (part * H + k);
          const bool in = live && c < d;
          rf[k] = in ? *reinterpret_cast<const float2*>(resid + base + c) : make_float2(0.f, 0.f);
          av[k] = in ? load_pair(a_ln + base + c) : Raw{};
        }
#pragma unroll
        for (int k = 0; k < H; ++k) {
          const int i = part * H + k, c = col + 8 * i;
          if (c >= d) continue;
          const float2 a2 = unpack(av[k]);
          const float2 gg = *reinterpret_cast<const float2*>(vg + c);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& a = acc[4 * i + 2 * h + e];
            a += e ? rf[k].y : rf[k].x;
            const float dz = a * (e ? gg.y : gg.x);
            m1 += dz;
            m2 = fmaf(dz, zhat(e ? a2.y : a2.x, mu, rstd), m2);
          }
        }
      }
      m1 = quad_sum(m1) / d;
      m2 = quad_sum(m2) / d;
#pragma unroll
      for (int t = 0; t < Q / 4; ++t) {
        uint4 mine = make_uint4(0u, 0u, 0u, 0u);
        if (thresh < 256) mine = dropout_words(s, site, r, g0 + 4 * t + j);
        Raw av[8];  // a_ln's pairs of the four groups
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = col + 8 * (8 * t + k);
          av[k] = live && c < d ? load_pair(a_ln + base + c) : Raw{};
        }
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const uint4 w = thresh < 256 ? quad_word(mine, qq) : mine;
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int i = 2 * (4 * t + qq) + p, c = col + 8 * i;
            if (!live || c >= d) continue;
            const float2 a2 = unpack(av[2 * qq + p]);
            const float2 gg = *reinterpret_cast<const float2*>(vg + c);
            float v[2], da[2], dp[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              v[e] = acc[4 * i + 2 * h + e];
              const float dz = v[e] * (e ? gg.y : gg.x);
              da[e] = rstd * (dz - m1 - zhat(e ? a2.y : a2.x, mu, rstd) * m2);
              dp[e] = thresh < 256 ? drop_by(da[e], word_byte(w, (c + e) & 15), thresh, keep)
                                   : da[e];
            }
            *reinterpret_cast<float2*>(v_out + base + c) = make_float2(v[0], v[1]);
            *reinterpret_cast<float2*>(da_out + base + c) = make_float2(da[0], da[1]);
            store2(dp_out + base + c, dp[0], dp[1]);
          }
        }
      }
    }
  }
};

// ---------------------------------------------------------------- LayerNorm rows

// One warp a row in C chunks of 256 columns (rows_sm90.cuh; C = 1 up to d
// 256, the route of every width the LayerNorm epilogues take).
// LayerNorm k of n_ln: statistics of the stored a[k] into stats (rows ×
// 2·n_ln: mean, rstd), and y[k] = round(LN(a[k])·g + b) where y[k] is not
// null. The last one's backward from dy: da (f32) and df = round(drop(da))
// at `site`.
template <class T>
struct LnRowsArgs {
  const T* a[kMaxLn];
  const float* g[kMaxLn];
  const float* b[kMaxLn];
  T* y[kMaxLn];
  float* stats;
  const T* dy;
  float* da;
  T* df;
  const int* seed;
  int n_ln, rows, d, thresh, site;
};

template <class T, int C>
__global__ void __launch_bounds__(kThreads) ln_rows(const LnRowsArgs<T> p) {
  int c0[C];
  const int r = row_lanes(p.rows, c0);
  if (r < 0) return;  // a whole warp
  const int d = p.d;
  const size_t base = static_cast<size_t>(r) * d;
  for (int k = 0; k < p.n_ln; ++k) {
    float a[C][8];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int i = 0; i < 8; ++i) a[c][i] = 0.f;
      if (c0[c] < d) load8(p.a[k] + base + c0[c], a[c]);
    }
    float mu, rstd;
    row_stats(a, d, mu, rstd);
    if ((threadIdx.x & 31) == 0) {
      p.stats[static_cast<size_t>(r) * 2 * p.n_ln + 2 * k] = mu;
      p.stats[static_cast<size_t>(r) * 2 * p.n_ln + 2 * k + 1] = rstd;
    }
    if (p.y[k]) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c0[c] >= d) continue;
        float y[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          y[i] = affine(zhat(a[c][i], mu, rstd), p.g[k][c0[c] + i], p.b[k][c0[c] + i]);
        store8(p.y[k] + base + c0[c], y);
      }
    }
    if (k < p.n_ln - 1) continue;
    float dz[C][8], df[C][8];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dz[c][i] = 0.f;
      if (c0[c] >= d) continue;
      load8(p.dy + base + c0[c], dz[c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) dz[c][i] *= p.g[k][c0[c] + i];
    }
    row_backward(dz, df, a, c0, d, mu, rstd, static_cast<uint32_t>(*p.seed), p.site, r,
                 p.thresh);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c0[c] >= d) continue;
      store8(p.da + base + c0[c], dz[c]);
      store8(p.df + base + c0[c], df[c]);
    }
  }
}

// ---------------------------------------------------------------- attention

// One block per (sequence, head). q, k, v (and da, dq, dk, dv, out) point at
// column 0 of row 0 of packed buffers; the head's columns start at head·hd,
// the sequence's rows at seq·T, with the row strides given.
template <class E>
struct AttnArgs {
  const E *q, *k, *v, *da;
  E *dq, *dk, *dv, *out;
  const int* seed;
  int ldq, ldkv, ldda, lddq, lddkv, ldo;
  int T, H, hd, thresh, site, causal;
};

// ---------------------------------------------------------------- attention on mma.sync

// The two attention kernels (hd a multiple of 8, rows 16-byte aligned): one
// block of two warps per (sequence, head), warp w taking query rows
// 16w .. 16w + 15 (T ≤ 32: keys padded to 32, rows past T zero-filled and
// their results dropped; hd zero-filled to a multiple of 16, columns past hd
// not stored, so the zeros add nothing to S, dP or a stored output). Q, K, V
// (and dA) arrive by cp.async in rows padded by 16 bytes; S = Q·Kᵀ, O = P·V, dP = dA·Vᵀ,
// dQ = dS·K, dV = Pᵀ·dA and dK = dSᵀ·Q run as mma.sync m16n8k16 bf16 → f32
// (the layout of fused_mha.cu's serving kernel); the softmax, its dropout
// mask and dS in f32 on the accumulator fragments. A lane holds rows
// 16w + lane/4 (h = 0) and + 8 (h = 1), keys 8n + 2·(lane % 4) + {0, 1}. The
// forward and the backward compute S and P by the same code, so the
// backward's output again equals the forward's bit for bit.

constexpr int kAttnRows = 32;  // the padded T

__host__ __device__ __forceinline__ int pad16(int hd) { return (hd + 15) & ~15; }
__host__ __device__ __forceinline__ int attn_ld(int hd) { return pad16(hd) + 8; }  // bf16
constexpr int kPld = kAttnRows + 8;  // row stride of the (32, 32) P and dS tiles

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a·b, m16n8k16, bf16 inputs, f32 accumulator
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// the sequence's T rows of one head (columns col0 .. col0 + hd) into 32
// padded shared-memory rows, rows past T and columns past hd zero-filled;
// both warps
__device__ __forceinline__ void stage_head(bf16* dst, const bf16* src, int stride, int row0,
                                           int col0, int T, int hd) {
  const int chunks = pad16(hd) / 8, ld = attn_ld(hd);
  for (int idx = threadIdx.x; idx < kAttnRows * chunks; idx += blockDim.x) {
    const int r = idx / chunks, c = 8 * (idx - r * chunks);
    const bool valid = r < T && c < hd;
    cp_async16(dst + r * ld + c,
               valid ? src + static_cast<size_t>(row0 + r) * stride + col0 + c : src, valid);
  }
}

// acc (16 × 32, 4 tiles of 8 columns) = A (this warp's 16 rows of `a`) ·
// B (the 32 rows of `b`)ᵀ over hd
__device__ __forceinline__ void rows_by_rows(float (&acc)[4][4], const bf16* a, const bf16* b,
                                             int hd) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7, ld = attn_ld(hd);
#pragma unroll
  for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int kc = 0; kc < pad16(hd) / 16; ++kc) {
    uint32_t fa[4];
    ldsm_x4(fa, a + ((mi & 1) * 8 + mr) * ld + 16 * kc + (mi >> 1) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t fb[4];
      ldsm_x4(fb, b + (16 * np + (mi >> 1) * 8 + mr) * ld + 16 * kc + (mi & 1) * 8);
      mma16816(acc[2 * np], fa, fb[0], fb[1]);
      mma16816(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// out (16 × hd, stored rounded) = P (A fragments, 16 × 32) · V (32 rows of
// `v`); rows ≥ rows_valid and columns ≥ hd are not stored
__device__ __forceinline__ void frags_by_rows(const uint32_t (&pa)[2][4], const bf16* v, int hd,
                                              bf16* out, int ldo, int rows_valid) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7, ld = attn_ld(hd);
  const int r0 = lane >> 2, c0 = 2 * (lane & 3);
  for (int dp = 0; dp < pad16(hd) / 16; ++dp) {
    float acc[2][4] = {};
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      uint32_t fb[4];
      ldsm_x4_trans(fb, v + (16 * kc + (mi & 1) * 8 + mr) * ld + 16 * dp + (mi >> 1) * 8);
      mma16816(acc[0], pa[kc], fb[0], fb[1]);
      mma16816(acc[1], pa[kc], fb[2], fb[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (16 * dp + 8 * n >= hd) break;  // the zero-filled columns
      const int col = 16 * dp + 8 * n + c0;
      if (r0 < rows_valid)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r0) * ldo + col) =
            pack2(acc[n][0], acc[n][1]);
      if (r0 + 8 < rows_valid)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r0 + 8) * ldo + col) =
            pack2(acc[n][2], acc[n][3]);
    }
  }
}

// out (16 × hd, rounded) = Mᵀ·X over the 32 rows k: M (32 × 32, row k, column
// m) in shared memory, this warp's columns m = 16w ..; X the 32 rows of `x`
__device__ __forceinline__ void tiles_t_by_rows(const bf16* m, const bf16* x, int hd, bf16* out,
                                                int ldo, int rows_valid) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7, w = threadIdx.x >> 5;
  uint32_t fa[2][4];
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
    ldsm_x4_trans(fa[kc], m + (16 * kc + (mi >> 1) * 8 + mr) * kPld + 16 * w + (mi & 1) * 8);
  frags_by_rows(fa, x, hd, out, ldo, rows_valid);
}

// the softmax of this warp's score rows (scaled, causal, keys ≥ T masked):
// p = exp(s - max) / sum, in place
__device__ __forceinline__ void softmax_frags(float (&s)[4][4], float scale, int T, bool causal) {
  const int lane = threadIdx.x & 31, i0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + (e >> 1) * 8, j = 8 * n + c0 + (e & 1);
      float x = s[n][e] * scale;
      if (j >= T || (causal && j > i)) x = -INFINITY;
      s[n][e] = x;
      m[e >> 1] = fmaxf(m[e >> 1], x);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = expf(s[n][e] - m[e >> 1]);
      s[n][e] = x;
      sum[e >> 1] += x;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) sum[h] = quad_sum(sum[h]);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] / sum[e >> 1];
}

// the dropout words of this lane's rows (h) and 16-key groups (g): the four
// draws of a lane quad's rows are made one a lane and shared
__device__ __forceinline__ void attn_words(uint4 (&w)[2][2], uint32_t seed, int site, int row0,
                                           int thresh) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int i = 16 * (threadIdx.x >> 5) + (lane >> 2) + 8 * (q >> 1);
  uint4 mine = make_uint4(0u, 0u, 0u, 0u);
  if (thresh < 256) mine = dropout_words(seed, site, row0 + i, q & 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k >> 1][k & 1] = quad_word(mine, k);
}

// x → x / keep where the site's byte at (row h, key j) keeps it, else 0
__device__ __forceinline__ void drop_frags(float (&x)[4][4], const uint4 (&w)[2][2], int thresh) {
  if (thresh >= 256) return;
  const float keep = thresh / 256.f;
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * n + c0 + (e & 1);
      x[n][e] = drop_by(x[n][e], word_byte(w[e >> 1][j >> 4], j & 15), thresh, keep);
    }
}

// P (f32 fragments) → round(drop(P)) as the A fragments of P·V
__device__ __forceinline__ void dropped_frags(uint32_t (&pa)[2][4], const float (&p)[4][4],
                                              const uint4 (&w)[2][2], int thresh) {
  float x[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = p[n][e];
  drop_frags(x, w, thresh);
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) {
    pa[kc][0] = pack2(x[2 * kc][0], x[2 * kc][1]);
    pa[kc][1] = pack2(x[2 * kc][2], x[2 * kc][3]);
    pa[kc][2] = pack2(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    pa[kc][3] = pack2(x[2 * kc + 1][2], x[2 * kc + 1][3]);
  }
}

// A fragments (16 × 32) into the (32, kPld) tile `t` at this warp's rows
__device__ __forceinline__ void frags_to_tile(bf16* t, const uint32_t (&fa)[2][4]) {
  const int lane = threadIdx.x & 31, r = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<uint32_t*>(t + (r + 8 * (k & 1)) * kPld + 16 * kc + 8 * (k >> 1) + c0) =
          fa[kc][k];
}

size_t attn_mma_smem(int hd, bool backward) {
  return sizeof(bf16) * (static_cast<size_t>(backward ? 4 : 3) * kAttnRows * attn_ld(hd) +
                         (backward ? 2 * kAttnRows * kPld : 0));
}

__global__ void __launch_bounds__(64) attn_fwd_mma(const AttnArgs<bf16> p) {
  extern __shared__ __align__(16) float sm[];
  const int T = p.T, hd = p.hd, ld = attn_ld(hd), s = blockIdx.x / p.H, hh = blockIdx.x - s * p.H;
  bf16* sq = reinterpret_cast<bf16*>(sm);
  bf16* sk = sq + kAttnRows * ld;
  bf16* sv = sk + kAttnRows * ld;
  stage_head(sq, p.q, p.ldq, s * T, hh * hd, T, hd);
  stage_head(sk, p.k, p.ldkv, s * T, hh * hd, T, hd);
  asm volatile("cp.async.commit_group;\n" ::);
  stage_head(sv, p.v, p.ldkv, s * T, hh * hd, T, hd);
  asm volatile("cp.async.commit_group;\n" ::);
  uint4 w[2][2];
  attn_words(w, static_cast<uint32_t>(*p.seed), p.site, (s * p.H + hh) * T, p.thresh);
  asm volatile("cp.async.wait_group 1;\n" ::);
  __syncthreads();
  const int w16 = 16 * (threadIdx.x >> 5);
  float sc[4][4];
  rows_by_rows(sc, sq + w16 * ld, sk, hd);
  softmax_frags(sc, 1.f / sqrtf(static_cast<float>(hd)), T, p.causal != 0);
  uint32_t pa[2][4];
  dropped_frags(pa, sc, w, p.thresh);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  frags_by_rows(pa, sv, hd, p.out + static_cast<size_t>(s * T + w16) * p.ldo + hh * hd, p.ldo,
                T - w16);
}

__global__ void __launch_bounds__(64) attn_bwd_mma(const AttnArgs<bf16> p) {
  extern __shared__ __align__(16) float sm[];
  const int T = p.T, hd = p.hd, ld = attn_ld(hd), s = blockIdx.x / p.H, hh = blockIdx.x - s * p.H;
  bf16* sq = reinterpret_cast<bf16*>(sm);
  bf16* sk = sq + kAttnRows * ld;
  bf16* sv = sk + kAttnRows * ld;
  bf16* sa = sv + kAttnRows * ld;  // dA
  bf16* sp = sa + kAttnRows * ld;  // round(drop(P)), (32, kPld)
  bf16* sd = sp + kAttnRows * kPld;  // dS
  const int c0 = hh * hd;
  stage_head(sq, p.q, p.ldq, s * T, c0, T, hd);
  stage_head(sk, p.k, p.ldkv, s * T, c0, T, hd);
  stage_head(sv, p.v, p.ldkv, s * T, c0, T, hd);
  stage_head(sa, p.da, p.ldda, s * T, c0, T, hd);
  asm volatile("cp.async.commit_group;\n" ::);
  uint4 w[2][2];
  attn_words(w, static_cast<uint32_t>(*p.seed), p.site, (s * p.H + hh) * T, p.thresh);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int w16 = 16 * (threadIdx.x >> 5);
  const size_t row_w = static_cast<size_t>(s * T + w16);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  // P again, exactly as the forward, and the attention output again
  float pr[4][4];
  rows_by_rows(pr, sq + w16 * ld, sk, hd);
  softmax_frags(pr, scale, T, p.causal != 0);
  uint32_t pa[2][4];
  dropped_frags(pa, pr, w, p.thresh);
  frags_to_tile(sp, pa);
  frags_by_rows(pa, sv, hd, p.out + row_w * p.ldo + c0, p.ldo, T - w16);
  // dP = drop(dA·Vᵀ); dS = round(P·(dP − Σ_j dP·P)·scale)
  float dp[4][4];
  rows_by_rows(dp, sa + w16 * ld, sv, hd);
  drop_frags(dp, w, p.thresh);
  float dot[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dot[e >> 1] = fmaf(dp[n][e], pr[n][e], dot[e >> 1]);
  dot[0] = quad_sum(dot[0]);
  dot[1] = quad_sum(dot[1]);
  uint32_t da[2][4];
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = 2 * kc + (k >> 1), h = k & 1;
      da[kc][k] = pack2(pr[n][2 * h] * (dp[n][2 * h] - dot[h]) * scale,
                        pr[n][2 * h + 1] * (dp[n][2 * h + 1] - dot[h]) * scale);
    }
  frags_to_tile(sd, da);
  // dQ = dS·K for this warp's rows
  frags_by_rows(da, sk, hd, p.dq + row_w * p.lddq + c0, p.lddq, T - w16);
  __syncthreads();
  // dV = Pᵀ·dA and dK = dSᵀ·Q for keys 16w ..
  tiles_t_by_rows(sp, sa, hd, p.dv + row_w * p.lddkv + c0, p.lddkv, T - w16);
  tiles_t_by_rows(sd, sq, hd, p.dk + row_w * p.lddkv + c0, p.lddkv, T - w16);
}

// what the kernels take: hd a multiple of 8 and every row 16 bytes aligned
// (q, k, v and the outputs; backward dA, dq, dk and dv too)
bool attn_args_ok(const AttnArgs<bf16>& a, bool backward) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  bool ok = a.T >= 1 && a.T <= kAttnRows && a.hd >= 8 && a.hd % 8 == 0 && a.ldq % 8 == 0 &&
            a.ldkv % 8 == 0 && a.ldo % 8 == 0 && aligned(a.q) && aligned(a.k) &&
            aligned(a.v) && aligned(a.out);
  if (backward)
    ok = ok && a.ldda % 8 == 0 && a.lddq % 8 == 0 && a.lddkv % 8 == 0 && aligned(a.da) &&
         aligned(a.dq) && aligned(a.dk) && aligned(a.dv);
  return ok;
}

// ---------------------------------------------------------------- attention in f32

// The f32 route's two attention kernels, the bf16 kernels' layout on split
// TF32 (3xTF32): one block of two warps per (sequence, head), warp w taking
// query rows 16w .. 16w + 15 of 32 (keys padded to 32, rows past T and
// columns past hd zero-filled, so they add nothing), every product as
// mma.sync m16n8k8 .tf32 on fragments split in registers (A_lo·B_hi +
// A_hi·B_lo + A_hi·B_hi into f32 accumulators), any hd (the configs' f32
// layers have heads of 2, 4, 8, 16 and 128; hd is zero-filled to a multiple
// of 8, the mma's k). Fragments are read from shared memory by scalar loads:
// Q, K, V and dA in rows whose stride is 4 mod 32 (a fragment's 32 loads hit
// 32 banks), P and dS in rows of 36. The softmax, its mask and dS run on the
// accumulator fragments (the bf16 kernels' functions: the m16n8 accumulator
// layout is the same), and the forward and the backward's recompute of P and
// of the output are one code, so both equal the forward's bit for bit.
// Nothing is rounded.

constexpr int kPld32 = 36;  // row stride of the (32, 32) f32 P and dS tiles

// the row stride of an f32 head tile: at least hd padded to 8, and 4 mod 32
__host__ __device__ __forceinline__ int attn_f32_ld(int hd) {
  const int p = (hd + 7) & ~7;
  return p + ((36 - p % 32) % 32);
}

// the f32 kernels' shared memory: Q, K, V (unless v_staged is false: the
// backward past the limit reads V from device memory) and dA in head tiles,
// P (and dS) in (32, kPld32) tiles
size_t attn_f32_smem(int hd, bool backward, bool v_staged = true) {
  const int tiles = (backward ? 4 : 3) - (v_staged ? 0 : 1);
  return sizeof(float) * (static_cast<size_t>(tiles) * kAttnRows * attn_f32_ld(hd) +
                          static_cast<size_t>(backward ? 2 : 1) * kAttnRows * kPld32);
}

// The rows of a head tile as the f32 products read them: staged in shared
// memory (rows past T and columns past hd zero-filled there), or straight
// from device memory with the same zeros
struct StagedRows {
  const float* p;
  int ld;
  __device__ __forceinline__ float at(int r, int c) const { return p[r * ld + c]; }
};
struct DeviceRows {
  const float* p;  // the head's row 0, column 0
  int ld, rows, cols;
  __device__ __forceinline__ float at(int r, int c) const {
    return r < rows && c < cols ? __ldg(p + static_cast<size_t>(r) * ld + c) : 0.f;
  }
};

// BYTES (4, 8 or 16) global → shared; zero-filled (nothing read) when !valid
template <int BYTES>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, bool valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
}

// chunks of V floats of the head's rows into the padded tile (see below)
template <int V>
__device__ __forceinline__ void stage_chunks_f32(float* dst, const float* src, int stride,
                                                 int row0, int col0, int T, int hd) {
  const int ld = attn_f32_ld(hd), per_row = ld / V;
  for (int idx = threadIdx.x; idx < kAttnRows * per_row; idx += blockDim.x) {
    const int r = idx / per_row, c = V * (idx - r * per_row);
    const bool valid = r < T && c < hd;
    cp_async_n<4 * V>(dst + r * ld + c,
                      valid ? src + static_cast<size_t>(row0 + r) * stride + col0 + c : src,
                      valid);
  }
}

// the sequence's T rows of one head (columns col0 .. col0 + hd) into 32 rows
// of attn_f32_ld(hd), rows past T and columns past hd zero, by cp.async in
// chunks of 16 bytes (hd a multiple of 4), 8 (even hd) or 4: every copy in
// flight at once; both warps, the caller commits and waits
__device__ __forceinline__ void stage_head_f32(float* dst, const float* src, int stride, int row0,
                                               int col0, int T, int hd) {
  if (hd % 4 == 0 && stride % 4 == 0 && col0 % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0)
    stage_chunks_f32<4>(dst, src, stride, row0, col0, T, hd);
  else if (hd % 2 == 0 && stride % 2 == 0 && col0 % 2 == 0 &&
           (reinterpret_cast<uintptr_t>(src) & 7) == 0)
    stage_chunks_f32<2>(dst, src, stride, row0, col0, T, hd);
  else
    stage_chunks_f32<1>(dst, src, stride, row0, col0, T, hd);
}

__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An m16n8k8 A fragment split into TF32 parts: a0 (g, t), a1 (g + 8, t), a2
// (g, t + 4), a3 (g + 8, t + 4), g = lane / 4, t = lane % 4
struct SplitA {
  uint32_t hi[4], lo[4];
};

// the A fragment of rows 0..15, columns k0 .. k0 + 7 of the row-major `m`
// (or, with TRANS, of its transpose: rows are m's columns), split
template <bool TRANS>
__device__ __forceinline__ SplitA a_frag(const float* m, int ld, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  SplitA a;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e & 1), c = k0 + t + 4 * (e >> 1);
    const float x = TRANS ? m[c * ld + r] : m[r * ld + c], h = sm90::tf32_round(x);
    a.hi[e] = __float_as_uint(h);
    a.lo[e] = __float_as_uint(sm90::tf32_round(x - h));
  }
  return a;
}

// d += a·b of an m16n8k8 step in split TF32, b the f32 B fragment (b0 (k t,
// n g), b1 (k t + 4, n g))
__device__ __forceinline__ void mma_x3(float (&d)[4], const SplitA& a, float b0, float b1) {
  const float bh0 = sm90::tf32_round(b0), bh1 = sm90::tf32_round(b1);
  mma1688(d, a.lo, __float_as_uint(bh0), __float_as_uint(bh1));
  mma1688(d, a.hi, __float_as_uint(sm90::tf32_round(b0 - bh0)),
          __float_as_uint(sm90::tf32_round(b1 - bh1)));
  mma1688(d, a.hi, __float_as_uint(bh0), __float_as_uint(bh1));
}

// acc (16 × 32) = A (this warp's 16 rows of `a`) · B (the 32 rows of `b`)ᵀ
// over hd: S = Q·Kᵀ and dP = dA·Vᵀ
template <class Rows = StagedRows>
__device__ __forceinline__ void rows_by_rows_f32(float (&acc)[4][4], const float* a,
                                                 const Rows& b, int hd) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, ld = attn_f32_ld(hd);
#pragma unroll
  for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int k0 = 0; k0 < hd; k0 += 8) {
    const SplitA fa = a_frag<false>(a, ld, k0);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      mma_x3(acc[n], fa, b.at(8 * n + g, k0 + t), b.at(8 * n + g, k0 + t + 4));
  }
}

// out (16 × hd) = M (16 rows of the (32, kPld32) tile `m`, or with TRANS its
// columns 16w ..) · X (the 32 rows of `x`), columns ≥ hd and rows ≥
// rows_valid not stored: O = P·V, dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dA
template <bool TRANS, class Rows = StagedRows>
__device__ __forceinline__ void tile_by_rows_f32(const float* m, const Rows& x, int hd,
                                                 float* out, int ldo, int rows_valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  SplitA fa[kAttnRows / 8];  // M's four k steps, split once for every column tile
#pragma unroll
  for (int k = 0; k < kAttnRows / 8; ++k) fa[k] = a_frag<TRANS>(m, kPld32, 8 * k);
  // two column tiles a step, each its own chain of products
  for (int n0 = 0; n0 < hd; n0 += 16) {
    float acc[2][4] = {};
#pragma unroll
    for (int k = 0; k < kAttnRows / 8; ++k) {
      const int r = 8 * k + t, c = n0 + g;
      mma_x3(acc[0], fa[k], x.at(r, c), x.at(r + 4, c));
      if (n0 + 8 < hd) mma_x3(acc[1], fa[k], x.at(r, c + 8), x.at(r + 4, c + 8));
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), c = n0 + 8 * j + 2 * t + (e & 1);
        if (r < rows_valid && c < hd) out[static_cast<size_t>(r) * ldo + c] = acc[j][e];
      }
  }
}

// this warp's 16 × 32 fragments into rows 16w .. of the (32, kPld32) tile `t`
__device__ __forceinline__ void frags_to_tile_f32(float* tile, const float (&x)[4][4]) {
  const int lane = threadIdx.x & 31, r = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) tile[(r + 8 * (e >> 1)) * kPld32 + 8 * n + c0 + (e & 1)] = x[n][e];
}

__global__ void __launch_bounds__(64) attn_fwd_f32(const AttnArgs<float> p) {
  extern __shared__ __align__(16) float sm[];
  const int T = p.T, hd = p.hd, ld = attn_f32_ld(hd), s = blockIdx.x / p.H,
            hh = blockIdx.x - s * p.H;
  float *sq = sm, *sk = sq + kAttnRows * ld, *sv = sk + kAttnRows * ld;
  float* sp = sv + kAttnRows * ld;  // drop(P), (32, kPld32)
  stage_head_f32(sq, p.q, p.ldq, s * T, hh * hd, T, hd);
  stage_head_f32(sk, p.k, p.ldkv, s * T, hh * hd, T, hd);
  stage_head_f32(sv, p.v, p.ldkv, s * T, hh * hd, T, hd);
  asm volatile("cp.async.commit_group;\n" ::);
  uint4 w[2][2];
  attn_words(w, static_cast<uint32_t>(*p.seed), p.site, (s * p.H + hh) * T, p.thresh);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int w16 = 16 * (threadIdx.x >> 5);
  float sc[4][4];
  rows_by_rows_f32(sc, sq + w16 * ld, StagedRows{sk, ld}, hd);
  softmax_frags(sc, 1.f / sqrtf(static_cast<float>(hd)), T, p.causal != 0);
  drop_frags(sc, w, p.thresh);
  frags_to_tile_f32(sp, sc);
  __syncwarp();
  tile_by_rows_f32<false>(sp + w16 * kPld32, StagedRows{sv, ld}, hd,
                          p.out + static_cast<size_t>(s * T + w16) * p.ldo + hh * hd, p.ldo,
                          T - w16);
}

// V_STAGED false (a head too wide for four staged tiles): V is read from
// device memory (DeviceRows) by the two products that take it
template <bool V_STAGED>
__global__ void __launch_bounds__(64) attn_bwd_f32(const AttnArgs<float> p) {
  extern __shared__ __align__(16) float sm[];
  const int T = p.T, hd = p.hd, ld = attn_f32_ld(hd), s = blockIdx.x / p.H,
            hh = blockIdx.x - s * p.H;
  float *sq = sm, *sk = sq + kAttnRows * ld, *sv = sk + kAttnRows * ld;
  float* sa = V_STAGED ? sv + kAttnRows * ld : sv;  // dA
  float* sp = sa + kAttnRows * ld;  // drop(P), (32, kPld32)
  float* sd = sp + kAttnRows * kPld32;  // dS
  const int c0 = hh * hd;
  using VRows = std::conditional_t<V_STAGED, StagedRows, DeviceRows>;
  VRows vr;
  if constexpr (V_STAGED)
    vr = StagedRows{sv, ld};
  else
    vr = DeviceRows{p.v + static_cast<size_t>(s * T) * p.ldkv + c0, p.ldkv, T, hd};
  stage_head_f32(sq, p.q, p.ldq, s * T, c0, T, hd);
  stage_head_f32(sk, p.k, p.ldkv, s * T, c0, T, hd);
  if constexpr (V_STAGED) stage_head_f32(sv, p.v, p.ldkv, s * T, c0, T, hd);
  stage_head_f32(sa, p.da, p.ldda, s * T, c0, T, hd);
  asm volatile("cp.async.commit_group;\n" ::);
  uint4 w[2][2];
  attn_words(w, static_cast<uint32_t>(*p.seed), p.site, (s * p.H + hh) * T, p.thresh);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int w16 = 16 * (threadIdx.x >> 5);
  const size_t row_w = static_cast<size_t>(s * T + w16);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  // P again, exactly as the forward, and the attention output again
  float pr[4][4];
  rows_by_rows_f32(pr, sq + w16 * ld, StagedRows{sk, ld}, hd);
  softmax_frags(pr, scale, T, p.causal != 0);
  float pd[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) pd[n][e] = pr[n][e];
  drop_frags(pd, w, p.thresh);
  frags_to_tile_f32(sp, pd);
  __syncwarp();
  tile_by_rows_f32<false>(sp + w16 * kPld32, vr, hd, p.out + row_w * p.ldo + c0, p.ldo, T - w16);
  // dP = drop(dA·Vᵀ); dS = P·(dP − Σ_j dP·P)·scale
  float dp[4][4];
  rows_by_rows_f32(dp, sa + w16 * ld, vr, hd);
  drop_frags(dp, w, p.thresh);
  float dot[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dot[e >> 1] = fmaf(dp[n][e], pr[n][e], dot[e >> 1]);
  dot[0] = quad_sum(dot[0]);
  dot[1] = quad_sum(dot[1]);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[n][e] = pr[n][e] * (dp[n][e] - dot[e >> 1]) * scale;
  frags_to_tile_f32(sd, dp);
  __syncwarp();
  // dQ = dS·K for this warp's rows
  tile_by_rows_f32<false>(sd + w16 * kPld32, StagedRows{sk, ld}, hd,
                          p.dq + row_w * p.lddq + c0, p.lddq, T - w16);
  __syncthreads();
  // dV = Pᵀ·dA and dK = dSᵀ·Q for keys 16w ..
  tile_by_rows_f32<true>(sp + w16, StagedRows{sa, ld}, hd, p.dv + row_w * p.lddkv + c0,
                         p.lddkv, T - w16);
  tile_by_rows_f32<true>(sd + w16, StagedRows{sq, ld}, hd, p.dk + row_w * p.lddkv + c0,
                         p.lddkv, T - w16);
}

template <class E, typename Kernel>
int launch_attn(Kernel kernel, const AttnArgs<E>& a, int nseq, bool backward, size_t smem,
                cudaStream_t stream) {
  constexpr bool kF32 = sizeof(E) == 4;
  bool ok;
  if constexpr (kF32)
    ok = a.T >= 1 && a.T <= kAttnRows && a.hd >= 1;
  else
    ok = attn_args_ok(a, backward);
  if (!ok || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<nseq * a.H, 64, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
AttnArgs<E> attn_args(void* q, void* k, void* v, void* da, void* dq, void* dk, void* dv,
                      void* out, void* seed, int ldq, int ldkv, int ldda, int lddq, int lddkv,
                      int ldo, int T, int H, int hd, int thresh, int site, int causal) {
  AttnArgs<E> a{};
  a.q = as<const E>(q);
  a.k = as<const E>(k);
  a.v = as<const E>(v);
  a.da = as<const E>(da);
  a.dq = as<E>(dq);
  a.dk = as<E>(dk);
  a.dv = as<E>(dv);
  a.out = as<E>(out);
  a.seed = as<const int>(seed);
  a.ldq = ldq;
  a.ldkv = ldkv;
  a.ldda = ldda;
  a.lddq = lddq;
  a.lddkv = lddkv;
  a.ldo = ldo;
  a.T = T;
  a.H = H;
  a.hd = hd;
  a.thresh = thresh;
  a.site = site;
  a.causal = causal;
  return a;
}

}  // namespace

extern "C" {

// Products: A (rows × k) and W in the activations' type (bf16, or f32 when
// `f32`: split TF32 on the tensor cores), W in nn.Linear's (out, in) layout;
// n output columns; config a tile shape of gemm_sm90.cuh's run() (0 or 1 here).

// out = round(A·Wᵀ + bias)
int tgi_sm90_bias(void* a, void* w, void* bias, void* out, int rows, int n, int k, int config,
                  int f32, void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    const Operand A{a, rows}, B{w, n};
    const EpiOut<T> epi{{}, as<T>(out), as<const float>(bias), rows, n};
    return run<0b011, false, false, 2, T>(config, &A, &B, 1, k, k, 1, 0, epi,
                                          static_cast<cudaStream_t>(stream));
  });
}

// h = round(drop(relu(A·Wᵀ + bias))) at `site`
int tgi_sm90_hidden(void* a, void* w, void* bias, void* seed, void* h, int rows, int n, int k,
                    int thresh, int site, int config, int f32, void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    const Operand A{a, rows}, B{w, n};
    const EpiHidden<T> epi{{}, as<T>(h), as<const float>(bias), as<const int>(seed), rows, n,
                           thresh, site};
    return run<0b011, false, false, 2, T>(config, &A, &B, 1, k, k, 1, 0, epi,
                                          static_cast<cudaStream_t>(stream));
  });
}

// a = resid + drop(A·Wᵀ + bias) at `site`; a_out = round(a), y = round(LN(a))
int tgi_sm90_res_ln(void* a, void* w, void* bias, void* resid, void* g, void* beta, void* seed,
                    void* a_out, void* y, int rows, int d, int k, int thresh, int site, int f32,
                    void* stream) {
  if (d > kLnTile) return static_cast<int>(cudaErrorInvalidValue);
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    const Operand A{a, rows}, B{w, d};
    const EpiResLn<T> epi{{}, as<T>(a_out), as<T>(y), as<const T>(resid),
                          as<const float>(bias), as<const float>(g), as<const float>(beta),
                          as<const int>(seed), rows, d, thresh, site};
    return run<0b1000, false, false, 2, T>(kLnConfig, &A, &B, 1, k, k, 1, 0, epi,
                                           static_cast<cudaStream_t>(stream));
  });
}

// dh = round(h > 0 ? (dF·W)/keep : 0); W (k × n), the FFN's second weight
int tgi_sm90_dh(void* df, void* w, void* h, void* dh, int rows, int n, int k, int thresh,
                int config, int f32, void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    const Operand A{df, rows}, B{w, n};
    const EpiDh<T> epi{{}, as<T>(dh), as<const T>(h), rows, n, thresh};
    return run<0b011, false, true, 2, T>(config, &A, &B, 1, k, k, 1, 0, epi,
                                         static_cast<cudaStream_t>(stream));
  });
}

// v = A·W + resid (W (k × d)); the LayerNorm backward of a_ln (row stats at
// stats[r·stats_ld]) with gain g: da, v (f32) and dp = round(drop(da)) at `site`
int tgi_sm90_ln_bwd(void* a, void* w, void* resid, void* g, void* a_ln, void* stats, void* seed,
                    void* da, void* v, void* dp, int rows, int d, int k, int stats_ld, int thresh,
                    int site, int f32, void* stream) {
  if (d > kLnTile) return static_cast<int>(cudaErrorInvalidValue);
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    const Operand A{a, rows}, B{w, d};
    const EpiLnBwd<T> epi{{}, as<float>(da), as<float>(v), as<T>(dp), as<const float>(resid),
                          as<const float>(g), as<const T>(a_ln), as<const float>(stats),
                          as<const int>(seed), rows, d, stats_ld, thresh, site};
    return run<0b1000, false, true, 2, T>(kLnConfig, &A, &B, 1, k, k, 1, 0, epi,
                                          static_cast<cudaStream_t>(stream));
  });
}

// out = round(A·W + resid); W (k × n); resid f32 (rows × n) or null. In f32
// a k past kPromoteK promotes each stage's sums (gemm_sm90.cuh's kPromote):
// dx over 3d and dmem over 2d in the wide route drift past 1e-5 of their
// largest value unpromoted (1.05e-5 to 1.7e-5 at d 512 and 1,024 on an H100)
int tgi_sm90_round(void* a, void* w, void* resid, void* out, int rows, int n, int k, int config,
                   int f32, void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    const Operand A{a, rows}, B{w, n};
    if constexpr (sizeof(T) == 4) {
      if (k > kPromoteK) {
        const EpiRound<T, true> epi{{}, as<T>(out), as<const float>(resid), rows, n};
        return run<0b011, false, true, 2, T>(config, &A, &B, 1, k, k, 1, 0, epi,
                                             static_cast<cudaStream_t>(stream));
      }
    }
    const EpiRound<T> epi{{}, as<T>(out), as<const float>(resid), rows, n};
    return run<0b011, false, true, 2, T>(config, &A, &B, 1, k, k, 1, 0, epi,
                                         static_cast<cudaStream_t>(stream));
  });
}

// ptr: n_ln × (a, g, b, y) (y null where not wanted), then stats, dy, da,
// df, seed
int tgi_sm90_ln_rows(void* const* ptr, int n_ln, int rows, int d, int thresh, int site, int f32,
                     void* stream) {
  if (n_ln < 1 || n_ln > kMaxLn) return static_cast<int>(cudaErrorInvalidValue);
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    LnRowsArgs<T> a{};
    for (int k = 0; k < n_ln; ++k) {
      a.a[k] = as<const T>(ptr[4 * k]);
      a.g[k] = as<const float>(ptr[4 * k + 1]);
      a.b[k] = as<const float>(ptr[4 * k + 2]);
      a.y[k] = as<T>(ptr[4 * k + 3]);
    }
    void* const* rest = ptr + 4 * n_ln;
    a.stats = as<float>(rest[0]);
    a.dy = as<const T>(rest[1]);
    a.da = as<float>(rest[2]);
    a.df = as<T>(rest[3]);
    a.seed = as<const int>(rest[4]);
    a.n_ln = n_ln;
    a.rows = rows;
    a.d = d;
    a.thresh = thresh;
    a.site = site;
    return by_chunks(d, [&](auto chunks) {
      ln_rows<T, decltype(chunks)::value><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads,
                                            0, static_cast<cudaStream_t>(stream)>>>(a);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// out = round(round(drop(softmax(QKᵀ/√hd))) · V) per (sequence, head)
int tgi_sm90_attn_fwd(void* q, void* k, void* v, void* out, void* seed, int ldq, int ldkv,
                      int ldo, int nseq, int T, int H, int hd, int thresh, int site, int causal,
                      int f32, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (f32)
    return launch_attn(attn_fwd_f32,
                       attn_args<float>(q, k, v, nullptr, nullptr, nullptr, nullptr, out, seed,
                                        ldq, ldkv, 0, 0, 0, ldo, T, H, hd, thresh, site, causal),
                       nseq, false, attn_f32_smem(hd, false), st);
  return launch_attn(attn_fwd_mma,
                     attn_args<bf16>(q, k, v, nullptr, nullptr, nullptr, nullptr, out, seed, ldq,
                                     ldkv, 0, 0, 0, ldo, T, H, hd, thresh, site, causal),
                     nseq, false, attn_mma_smem(hd, false), st);
}

// dq, dk, dv from da = d(attention output), and out = the attention output again
int tgi_sm90_attn_bwd(void* q, void* k, void* v, void* da, void* dq, void* dk, void* dv,
                      void* out, void* seed, int ldq, int ldkv, int ldda, int lddq, int lddkv,
                      int ldo, int nseq, int T, int H, int hd, int thresh, int site, int causal,
                      int f32, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (f32) {
    const auto a = attn_args<float>(q, k, v, da, dq, dk, dv, out, seed, ldq, ldkv, ldda, lddq,
                                    lddkv, ldo, T, H, hd, thresh, site, causal);
    if (attn_f32_smem(hd, true) <= kMaxSmem)
      return launch_attn(attn_bwd_f32<true>, a, nseq, true, attn_f32_smem(hd, true), st);
    return launch_attn(attn_bwd_f32<false>, a, nseq, true, attn_f32_smem(hd, true, false), st);
  }
  return launch_attn(attn_bwd_mma,
                     attn_args<bf16>(q, k, v, da, dq, dk, dv, out, seed, ldq, ldkv, ldda, lddq,
                                     lddkv, ldo, T, H, hd, thresh, site, causal),
                     nseq, true, attn_mma_smem(hd, true), st);
}

// ptr: per problem dY (rows × m), X (rows × n); per segment x, z, stats.
// ints: per problem m, n; per segment width, x_f32, stats_ld. part: splits ×
// (the problems' m·n results in order, then the segments' sums in order), f32;
// the rows cut into splits of rows_per_split (a multiple of 64 when splits > 1)
int tgi_sm90_wgrad(void* const* ptr, const int* ints, int problems, int segments, int rows,
                   int splits, int rows_per_split, void* part, int f32, void* stream) {
  if (problems < 1 || problems > sm90::kMaxProblems || segments < 0 || segments > kMaxSegs)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    Operand A[sm90::kMaxProblems], B[sm90::kMaxProblems];
    EpiWgrad<T> epi{};
    epi.part = as<float>(part);
    for (int p = 0; p < problems; ++p) {
      epi.m[p] = ints[2 * p];
      epi.n[p] = ints[2 * p + 1];
      A[p] = Operand{ptr[2 * p], epi.m[p]};
      B[p] = Operand{ptr[2 * p + 1], epi.n[p]};
    }
    for (int s = 0; s < segments; ++s) {
      ColSeg<T>& sg = epi.seg[s];
      sg.x = ptr[2 * problems + 3 * s];
      sg.z = as<const T>(ptr[2 * problems + 3 * s + 1]);
      sg.stats = as<const float>(ptr[2 * problems + 3 * s + 2]);
      sg.width = ints[2 * problems + 3 * s];
      sg.x_f32 = ints[2 * problems + 3 * s + 1];
      sg.stats_ld = ints[2 * problems + 3 * s + 2];
    }
    const int extra = wgrad_layout(epi, problems, segments);
    return run<0b010, true, true, sm90::kMaxProblems, T>(kWgradConfig, A, B, problems, rows,
                                                         rows_per_split, splits, extra, epi,
                                                         static_cast<cudaStream_t>(stream));
  });
}

// out[i] = Σ_s part[s][i] in split order, for i < total
int tgi_sm90_reduce(void* part, void* out, long long total, int splits, void* stream) {
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  reduce_splits<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      as<const float>(part), as<float>(out), static_cast<size_t>(total), splits);
  return static_cast<int>(cudaGetLastError());
}

const char* tgi_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
