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
//   sm90_ln_rows   one warp a row (past d 1,024 one block): the LayerNorm
//                  statistics of the stored inputs, y recomputed where a
//                  weight gradient needs it, and the last LayerNorm's
//                  backward from dy, with its site's mask (a thread holds 8
//                  columns of each 256- or 2,048-column chunk of a row)
//   sm90_attn_fwd  P = softmax(QKᵀ/√hd) per (sequence, head) (causal for the
//                  decoder's self-attention), its dropout mask,
//                  round(drop(P))·V (layer_attn_sm90.cu)
//   sm90_attn_bwd  P again, dS, dQ, dK, dV rounded, and the attention
//                  output again for dWo (layer_attn_sm90.cu)
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
// The attention launches (sm90_attn_fwd, sm90_attn_bwd) are
// layer_attn_sm90.cu's, built apart so that nvcc compiles the two in
// parallel: kernel #1's streamed-head design (attn_stream_sm90.cuh).
//
// The wide route. A 64 × 256 tile spans a row up to d 256, which the
// LayerNorm epilogues need (kLnTile). Past it, up to d 8,192, each
// LayerNorm-epilogue launch becomes a product and a row pass, the launches of
// layer_wide_sm90.cu; the chain takes 16 launches an encoder layer and 26 a
// decoder layer there. The row passes, the backward's (sm90_ln_rows) in both
// routes, hold a row in a warp up to d 1,024 and in a block past it
// (rows_sm90.cuh).
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

#include <numeric>
#include <type_traits>

#include "rows_sm90.cuh"  // and epilogues_sm90.cuh

namespace {

constexpr int kLnTile = 256;  // the LayerNorm epilogues' tile width: d ≤ 256
// the longest reduction an f32 product with a plain epilogue runs unpromoted:
// the route up to d 256 reduces over at most 3·256 = 768 there, unchanged
constexpr int kPromoteK = 3 * kLnTile;

// fn(std::bool_constant<promote>): an f32 launch over k past kPromoteK
// promotes each stage's sums (gemm_sm90.cuh's kPromote). Unpromoted, the
// tensor cores' truncating accumulation took dx over 3d and dmem over 2d past
// 1e-5 of their largest value (1.05e-5 to 1.7e-5 at d 512 and 1,024 on an
// H100), and the qkv product over d 2,048 to 1.7e-5.
template <class T, class F>
int by_promote(int k, F&& fn) {
  if constexpr (sizeof(T) == 4)
    if (k > kPromoteK) return fn(std::true_type{});
  return fn(std::false_type{});
}
constexpr int kLnConfig = 3;  // run()'s 64 × 256 tile
constexpr int kWgradConfig = 1;  // run()'s 128 × 128 tile
constexpr int kMaxLn = 3;

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

// A group of G threads a row in C chunks of 8·G columns (rows_sm90.cuh: a
// warp up to d 1,024, C = 1 up to d 256, the route of every width the
// LayerNorm epilogues take; the block past d 1,024).
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

template <class T, int C, int G>
__global__ void __launch_bounds__(kThreads) ln_rows(const LnRowsArgs<T> p) {
  int c0[C];
  const int r = row_lanes<C, G>(p.rows, c0);
  if (r < 0) return;  // a whole group
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
    row_stats<C, G>(a, d, mu, rstd);
    if (threadIdx.x % G == 0) {
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
    row_backward<C, G>(dz, df, a, c0, d, mu, rstd, static_cast<uint32_t>(*p.seed), p.site, r,
                       p.thresh);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c0[c] >= d) continue;
      store8(p.da + base + c0[c], dz[c]);
      store8(p.df + base + c0[c], df[c]);
    }
  }
}

}  // namespace

extern "C" {

// Products: A (rows × k) and W in the activations' type (bf16, or f32 when
// `f32`: split TF32 on the tensor cores; over k past kPromoteK its sums
// promoted a stage at a time, by_promote), W in nn.Linear's (out, in) layout;
// n output columns; config a tile shape of gemm_sm90.cuh's run() (0 or 1 here).

// out = round(A·Wᵀ + bias)
int tgi_sm90_bias(void* a, void* w, void* bias, void* out, int rows, int n, int k, int config,
                  int f32, void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    return by_promote<T>(k, [&](auto promote) {
      const Operand A{a, rows}, B{w, n};
      const EpiOut<T, decltype(promote)::value> epi{{}, as<T>(out), as<const float>(bias), rows,
                                                    n};
      return run<0b011, false, false, 2, T>(config, &A, &B, 1, k, k, 1, 0, epi,
                                            static_cast<cudaStream_t>(stream));
    });
  });
}

// h = round(drop(relu(A·Wᵀ + bias))) at `site`
int tgi_sm90_hidden(void* a, void* w, void* bias, void* seed, void* h, int rows, int n, int k,
                    int thresh, int site, int config, int f32, void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    return by_promote<T>(k, [&](auto promote) {
      const Operand A{a, rows}, B{w, n};
      const EpiHidden<T, decltype(promote)::value> epi{
          {}, as<T>(h), as<const float>(bias), as<const int>(seed), rows, n, thresh, site};
      return run<0b011, false, false, 2, T>(config, &A, &B, 1, k, k, 1, 0, epi,
                                            static_cast<cudaStream_t>(stream));
    });
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
    return by_promote<T>(k, [&](auto promote) {
      const Operand A{df, rows}, B{w, n};
      const EpiDh<T, decltype(promote)::value> epi{{}, as<T>(dh), as<const T>(h), rows, n, thresh};
      return run<0b011, false, true, 2, T>(config, &A, &B, 1, k, k, 1, 0, epi,
                                           static_cast<cudaStream_t>(stream));
    });
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

// out = round(A·W + resid); W (k × n); resid f32 (rows × n) or null
int tgi_sm90_round(void* a, void* w, void* resid, void* out, int rows, int n, int k, int config,
                   int f32, void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    return by_promote<T>(k, [&](auto promote) {
      const Operand A{a, rows}, B{w, n};
      const EpiRound<T, decltype(promote)::value> epi{{}, as<T>(out), as<const float>(resid),
                                                      rows, n};
      return run<0b011, false, true, 2, T>(config, &A, &B, 1, k, k, 1, 0, epi,
                                           static_cast<cudaStream_t>(stream));
    });
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
      using S = decltype(chunks);
      ln_rows<T, S::kC, S::kG><<<(rows + S::kRows - 1) / S::kRows, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(a);
      return static_cast<int>(cudaGetLastError());
    });
  });
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
