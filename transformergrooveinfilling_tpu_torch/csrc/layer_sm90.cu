// The whole encoder and decoder layers for training in bf16 on Hopper
// (sm_90a), as chains of launches.
//
// Replaces, on the bf16 route, the Pallas TPU kernels transformergrooveinfilling_
// tpu/ops/fused_layer.py::encoder_layer_train (_fwd_call → _fwd_kernel,
// _bwd_call → _bwd_kernel) and ops/fused_decoder_layer.py::decoder_layer_train
// (the same two), whose f32 route stays fused_layer.cu and
// fused_decoder_layer.cu. ops/fused_layer.py and ops/fused_decoder_layer.py
// compose the launches below into each layer's forward and backward; each
// launch's plain PyTorch version is in ops/layer_sm90.py.
//
// What bounds a layer on the H100: its dense products, 2·rows·(4d² + 2·d·ff)
// FLOP forward at the encoder (8d² + 2·d·ff at the decoder) and twice that
// backward, against a few hundred bytes a row of activations: at the flagship
// (d 256, ff 512, rows 16,384) 17.2 GFLOP forward, 17 µs of the tensor cores
// at 989 TFLOP/s, against 37 µs of the whole layer's own bytes. The CUDA-core
// kernels of fused_layer.cu ran every product as f32 FMAs (67 TFLOP/s peak)
// with one block per sequence, one sequence's weights read from L2 per
// block, and summed the weight gradients of all rows in one block per tile.
// This design puts every product on the wgmma core of gemm_sm90.cuh (TMA, a
// 4-stage ring, f32 accumulators, persistent blocks) with the layer's
// elementwise work in the products' epilogues:
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
//   sm90_attn_fwd  one block per (sequence, head): P = softmax(QKᵀ/√hd)
//                  (causal for the decoder's self-attention), its dropout
//                  mask, round(drop(P))·V; P stays in registers
//   sm90_attn_bwd  the same block: P again, dS, dQ, dK, dV rounded, and the
//                  attention output again for dWo
//   sm90_wgrad     every weight gradient of a layer, dYᵀ·X over the rows
//                  with both operands MN-major (wgmma's transpose bits), in
//                  one grouped launch of 128 × 128 tiles, the rows cut into
//                  splits of whole 64-row stages with f32 partials, and the
//                  bias and LayerNorm-parameter sums in blocks of their own
//   sm90_reduce    adds the splits' partials in split order
//
// No float atomics anywhere: two runs with one seed agree bit for bit. The
// forward stores what the TPU kernel stores (qkv, a1, h, a2; the decoder's
// qkv, a1, qc, kv, a2, h, a3); the backward's buffers are bf16 where the TPU
// kernel rounds (dqkv, dattn, dS, dproj, dh, df, y1, the attention output)
// and f32 for the residual gradients that reach a LayerNorm (da, v).
//
// The attention (4·T·d FLOP a row forward at T ≤ 32, 3 % of the layer's
// products, but a (sequence, head)'s Q, K, V and dA cross device memory
// once) runs on the tensor cores as mma.sync m16n8k16, two warps a
// (sequence, head) (fused_mha.cu's layout: the 64-row wgmma tiles would leave
// most of a warpgroup idle at T 32); hd is a multiple of 8 (16-byte rows for
// cp.async), zero-filled in shared memory to a multiple of 16 (the mma's k).
//
// Dropout: the layer kernels' 8-bit rule and Philox stream (layer_common.cuh),
// sites and counters as fused_layer.cu and fused_decoder_layer.cu number
// them, so the masks are ops/fused_layer.py::dropout_mask's.
//
// Plain C entry points, bound from Python with ctypes (ops/layer_sm90.py);
// each returns cudaGetLastError() after its launch. bf16 tensors are
// contiguous (the attention's q, k, v and their gradients may be column
// slices of a packed buffer, given by a row stride) and 16-byte aligned;
// biases, LayerNorm parameters, statistics and residual gradients are f32.

#include "epilogues_sm90.cuh"

namespace {

constexpr int kLnTile = 256;  // the LayerNorm epilogues' tile width: d ≤ 256
constexpr int kLnConfig = 3;  // run()'s 64 × 256 tile
constexpr int kWgradConfig = 1;  // run()'s 128 × 128 tile
constexpr int kMaxLn = 3;
constexpr int kRowsPerBlock = kThreads / 32;  // sm90_ln_rows: a warp a row

__device__ __forceinline__ float drop_by(float v, uint32_t byte, int thresh, float keep) {
  return byte < static_cast<uint32_t>(thresh) ? v / keep : 0.f;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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
// clamped at 0, as layer_common.cuh's ln_stats)
struct EpiResLn : NoExtra {
  static constexpr bool kWholeTile = true;
  bf16 *a_out, *y_out;
  const bf16* resid;
  const float *bias, *g, *beta;
  const int* seed;
  int rows, d, thresh, site;

  __device__ __forceinline__ void prologue(int threads) const {
    stage_vectors(bias, g, beta, d, threads);
  }

  template <int BN>
  __device__ __forceinline__ void tile(int, int, int row, int col, float (&acc)[BN / 2]) const {
    constexpr int Q = BN / 16;  // 16-column groups
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
      uint32_t rv[2 * Q];  // the residual's bf16 pairs
#pragma unroll
      for (int i = 0; i < 2 * Q; ++i)
        rv[i] = live && col + 8 * i < d
                    ? *reinterpret_cast<const uint32_t*>(resid + base + col + 8 * i) : 0u;
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int t = 0; t < Q / 4; ++t) {
        uint4 mine = make_uint4(0u, 0u, 0u, 0u);
        if (thresh < 256) mine = dropout_words(s, site, r, g0 + 4 * t + j);
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const uint4 w = thresh < 256 ? quad_word(mine, qq) : mine;
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int i = 2 * (4 * t + qq) + p, c = col + 8 * i;
            if (c >= d) continue;
            const float2 rf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv[i]));
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
struct EpiLnBwd : NoExtra {
  static constexpr bool kWholeTile = true;
  float *da_out, *v_out;
  bf16* dp_out;
  const float *resid, *g;
  const bf16* a_ln;
  const float* stats;  // (mean, rstd) of row r at stats[r·stats_ld]
  const int* seed;
  int rows, d, stats_ld, thresh, site;

  __device__ __forceinline__ void prologue(int threads) const {
    stage_vectors(g, nullptr, nullptr, d, threads);
  }

  template <int BN>
  __device__ __forceinline__ void tile(int, int, int row, int col, float (&acc)[BN / 2]) const {
    constexpr int Q = BN / 16, H = Q;  // groups; pairs a half row
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
      for (int half = 0; half < 2; ++half) {  // the row's pairs, half of them at a time
        float2 rf[H];
        uint32_t av[H];
#pragma unroll
        for (int k = 0; k < H; ++k) {
          const int c = col + 8 * (half * H + k);
          const bool in = live && c < d;
          rf[k] = in ? *reinterpret_cast<const float2*>(resid + base + c) : make_float2(0.f, 0.f);
          av[k] = in ? *reinterpret_cast<const uint32_t*>(a_ln + base + c) : 0u;
        }
#pragma unroll
        for (int k = 0; k < H; ++k) {
          const int i = half * H + k, c = col + 8 * i;
          if (c >= d) continue;
          const float2 a2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[k]));
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
        uint32_t av[8];  // a_ln's pairs of the four groups
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = col + 8 * (8 * t + k);
          av[k] = live && c < d ? *reinterpret_cast<const uint32_t*>(a_ln + base + c) : 0u;
        }
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const uint4 w = thresh < 256 ? quad_word(mine, qq) : mine;
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int i = 2 * (4 * t + qq) + p, c = col + 8 * i;
            if (!live || c >= d) continue;
            const float2 a2 =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[2 * qq + p]));
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

// One warp a row; lane l holds the 8 columns 8l .. 8l + 7 (d ≤ 256).
// LayerNorm k of n_ln: statistics of the stored a[k] into stats (rows ×
// 2·n_ln: mean, rstd), and y[k] = round(LN(a[k])·g + b) where y[k] is not
// null. The last one's backward from dy: da (f32) and df = round(drop(da))
// at `site`.
struct LnRowsArgs {
  const bf16* a[kMaxLn];
  const float* g[kMaxLn];
  const float* b[kMaxLn];
  bf16* y[kMaxLn];
  float* stats;
  const bf16* dy;
  float* da;
  bf16* df;
  const int* seed;
  int n_ln, rows, d, thresh, site;
};

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

__global__ void __launch_bounds__(kThreads) ln_rows(const LnRowsArgs p) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= p.rows) return;  // a whole warp
  const int d = p.d, c0 = 8 * lane;
  const bool mine = c0 < d;
  const size_t base = static_cast<size_t>(r) * d + c0;
  for (int k = 0; k < p.n_ln; ++k) {
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (mine) load8(p.a[k] + base, a);
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += a[i];
      s2 = fmaf(a[i], a[i], s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / d;
    const float rstd = rsqrtf(fmaxf(s2 / d - mu * mu, 0.f) + kLnEps);
    if (lane == 0) {
      p.stats[static_cast<size_t>(r) * 2 * p.n_ln + 2 * k] = mu;
      p.stats[static_cast<size_t>(r) * 2 * p.n_ln + 2 * k + 1] = rstd;
    }
    if (p.y[k] && mine) {
      float y[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        y[i] = affine(zhat(a[i], mu, rstd), p.g[k][c0 + i], p.b[k][c0 + i]);
      store8(p.y[k] + base, y);
    }
    if (k < p.n_ln - 1) continue;
    float dz[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, m1 = 0.f, m2 = 0.f;
    if (mine) {
      load8(p.dy + base, dz);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dz[i] *= p.g[k][c0 + i];
        m1 += dz[i];
        m2 = fmaf(dz[i], zhat(a[i], mu, rstd), m2);
      }
    }
    m1 = warp_sum(m1) / d;
    m2 = warp_sum(m2) / d;
    if (!mine) continue;
    const float keep = p.thresh / 256.f;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (p.thresh < 256) w = dropout_words(static_cast<uint32_t>(*p.seed), p.site, r, c0 >> 4);
    float df[8];
#pragma unroll
    for (int i = 0; i < 8; i += 4) {
      float da[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        da[e] = rstd * (dz[i + e] - m1 - zhat(a[i + e], mu, rstd) * m2);
        df[i + e] = p.thresh < 256
                        ? drop_by(da[e], word_byte(w, (c0 + i + e) & 15), p.thresh, keep)
                        : da[e];
      }
      *reinterpret_cast<float4*>(p.da + base + i) = make_float4(da[0], da[1], da[2], da[3]);
    }
    store8(p.df + base, df);
  }
}

// ---------------------------------------------------------------- attention

// One block per (sequence, head). q, k, v (and da, dq, dk, dv, out) point at
// column 0 of row 0 of packed buffers; the head's columns start at head·hd,
// the sequence's rows at seq·T, with the row strides given.
struct AttnArgs {
  const bf16 *q, *k, *v, *da;
  bf16 *dq, *dk, *dv, *out;
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

__global__ void __launch_bounds__(64) attn_fwd_mma(const AttnArgs p) {
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

__global__ void __launch_bounds__(64) attn_bwd_mma(const AttnArgs p) {
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
bool attn_args_ok(const AttnArgs& a, bool backward) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  bool ok = a.T >= 1 && a.T <= kAttnRows && a.hd >= 8 && a.hd % 8 == 0 && a.ldq % 8 == 0 &&
            a.ldkv % 8 == 0 && a.ldo % 8 == 0 && aligned(a.q) && aligned(a.k) &&
            aligned(a.v) && aligned(a.out);
  if (backward)
    ok = ok && a.ldda % 8 == 0 && a.lddq % 8 == 0 && a.lddkv % 8 == 0 && aligned(a.da) &&
         aligned(a.dq) && aligned(a.dk) && aligned(a.dv);
  return ok;
}

template <typename Kernel>
int launch_attn(Kernel kernel, const AttnArgs& a, int nseq, bool backward,
                cudaStream_t stream) {
  if (!attn_args_ok(a, backward)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = attn_mma_smem(a.hd, backward);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<nseq * a.H, 64, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
T* as(void* p) {
  return static_cast<T*>(p);
}

}  // namespace

extern "C" {

// Products: A (rows × k) bf16, W in nn.Linear's (out, in) layout; n output
// columns; config a tile shape of gemm_sm90.cuh's run() (0 or 1 here).

// out = round(A·Wᵀ + bias)
int tgi_sm90_bias(void* a, void* w, void* bias, void* out, int rows, int n, int k, int config,
                  void* stream) {
  const Operand A{a, rows}, B{w, n};
  const EpiOut epi{{}, as<bf16>(out), as<const float>(bias), rows, n};
  return run<0b011, false, false>(config, &A, &B, 1, k, k, 1, 0, epi,
                                  static_cast<cudaStream_t>(stream));
}

// h = round(drop(relu(A·Wᵀ + bias))) at `site`
int tgi_sm90_hidden(void* a, void* w, void* bias, void* seed, void* h, int rows, int n, int k,
                    int thresh, int site, int config, void* stream) {
  const Operand A{a, rows}, B{w, n};
  const EpiHidden epi{{}, as<bf16>(h), as<const float>(bias), as<const int>(seed), rows, n,
                      thresh, site};
  return run<0b011, false, false>(config, &A, &B, 1, k, k, 1, 0, epi,
                                  static_cast<cudaStream_t>(stream));
}

// a = resid + drop(A·Wᵀ + bias) at `site`; a_out = round(a), y = round(LN(a))
int tgi_sm90_res_ln(void* a, void* w, void* bias, void* resid, void* g, void* beta, void* seed,
                    void* a_out, void* y, int rows, int d, int k, int thresh, int site,
                    void* stream) {
  if (d > kLnTile) return static_cast<int>(cudaErrorInvalidValue);
  const Operand A{a, rows}, B{w, d};
  const EpiResLn epi{{}, as<bf16>(a_out), as<bf16>(y), as<const bf16>(resid),
                     as<const float>(bias), as<const float>(g), as<const float>(beta),
                     as<const int>(seed), rows, d, thresh, site};
  return run<0b1000, false, false>(kLnConfig, &A, &B, 1, k, k, 1, 0, epi,
                                   static_cast<cudaStream_t>(stream));
}

// dh = round(h > 0 ? (dF·W)/keep : 0); W (k × n), the FFN's second weight
int tgi_sm90_dh(void* df, void* w, void* h, void* dh, int rows, int n, int k, int thresh,
                int config, void* stream) {
  const Operand A{df, rows}, B{w, n};
  const EpiDh epi{{}, as<bf16>(dh), as<const bf16>(h), rows, n, thresh};
  return run<0b011, false, true>(config, &A, &B, 1, k, k, 1, 0, epi,
                                 static_cast<cudaStream_t>(stream));
}

// v = A·W + resid (W (k × d)); the LayerNorm backward of a_ln (row stats at
// stats[r·stats_ld]) with gain g: da, v (f32) and dp = round(drop(da)) at `site`
int tgi_sm90_ln_bwd(void* a, void* w, void* resid, void* g, void* a_ln, void* stats, void* seed,
                    void* da, void* v, void* dp, int rows, int d, int k, int stats_ld, int thresh,
                    int site, void* stream) {
  if (d > kLnTile) return static_cast<int>(cudaErrorInvalidValue);
  const Operand A{a, rows}, B{w, d};
  const EpiLnBwd epi{{}, as<float>(da), as<float>(v), as<bf16>(dp), as<const float>(resid),
                     as<const float>(g), as<const bf16>(a_ln), as<const float>(stats),
                     as<const int>(seed), rows, d, stats_ld, thresh, site};
  return run<0b1000, false, true>(kLnConfig, &A, &B, 1, k, k, 1, 0, epi,
                                  static_cast<cudaStream_t>(stream));
}

// out = round(A·W + resid); W (k × n); resid f32 (rows × n) or null
int tgi_sm90_round(void* a, void* w, void* resid, void* out, int rows, int n, int k, int config,
                   void* stream) {
  const Operand A{a, rows}, B{w, n};
  const EpiRound epi{{}, as<bf16>(out), as<const float>(resid), rows, n};
  return run<0b011, false, true>(config, &A, &B, 1, k, k, 1, 0, epi,
                                 static_cast<cudaStream_t>(stream));
}

// ptr: n_ln × (a, g, b, y) (y null where not wanted), then stats, dy, da,
// df, seed
int tgi_sm90_ln_rows(void* const* ptr, int n_ln, int rows, int d, int thresh, int site,
                     void* stream) {
  if (n_ln < 1 || n_ln > kMaxLn || d > kLnTile) return static_cast<int>(cudaErrorInvalidValue);
  LnRowsArgs a{};
  for (int k = 0; k < n_ln; ++k) {
    a.a[k] = as<const bf16>(ptr[4 * k]);
    a.g[k] = as<const float>(ptr[4 * k + 1]);
    a.b[k] = as<const float>(ptr[4 * k + 2]);
    a.y[k] = as<bf16>(ptr[4 * k + 3]);
  }
  void* const* rest = ptr + 4 * n_ln;
  a.stats = as<float>(rest[0]);
  a.dy = as<const bf16>(rest[1]);
  a.da = as<float>(rest[2]);
  a.df = as<bf16>(rest[3]);
  a.seed = as<const int>(rest[4]);
  a.n_ln = n_ln;
  a.rows = rows;
  a.d = d;
  a.thresh = thresh;
  a.site = site;
  ln_rows<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0,
            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out = round(round(drop(softmax(QKᵀ/√hd))) · V) per (sequence, head)
int tgi_sm90_attn_fwd(void* q, void* k, void* v, void* out, void* seed, int ldq, int ldkv,
                      int ldo, int nseq, int T, int H, int hd, int thresh, int site, int causal,
                      void* stream) {
  AttnArgs a{};
  a.q = as<const bf16>(q);
  a.k = as<const bf16>(k);
  a.v = as<const bf16>(v);
  a.out = as<bf16>(out);
  a.seed = as<const int>(seed);
  a.ldq = ldq;
  a.ldkv = ldkv;
  a.ldo = ldo;
  a.T = T;
  a.H = H;
  a.hd = hd;
  a.thresh = thresh;
  a.site = site;
  a.causal = causal;
  return launch_attn(attn_fwd_mma, a, nseq, false, static_cast<cudaStream_t>(stream));
}

// dq, dk, dv from da = d(attention output), and out = the attention output again
int tgi_sm90_attn_bwd(void* q, void* k, void* v, void* da, void* dq, void* dk, void* dv,
                      void* out, void* seed, int ldq, int ldkv, int ldda, int lddq, int lddkv,
                      int ldo, int nseq, int T, int H, int hd, int thresh, int site, int causal,
                      void* stream) {
  AttnArgs a{};
  a.q = as<const bf16>(q);
  a.k = as<const bf16>(k);
  a.v = as<const bf16>(v);
  a.da = as<const bf16>(da);
  a.dq = as<bf16>(dq);
  a.dk = as<bf16>(dk);
  a.dv = as<bf16>(dv);
  a.out = as<bf16>(out);
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
  return launch_attn(attn_bwd_mma, a, nseq, true, static_cast<cudaStream_t>(stream));
}

// ptr: per problem dY (rows × m), X (rows × n); per segment x, z, stats.
// ints: per problem m, n; per segment width, x_f32, stats_ld. part: splits ×
// (the problems' m·n results in order, then the segments' sums in order), f32;
// the rows cut into splits of rows_per_split (a multiple of 64 when splits > 1)
int tgi_sm90_wgrad(void* const* ptr, const int* ints, int problems, int segments, int rows,
                   int splits, int rows_per_split, void* part, void* stream) {
  if (problems < 1 || problems > sm90::kMaxProblems || segments < 0 || segments > kMaxSegs)
    return static_cast<int>(cudaErrorInvalidValue);
  Operand A[sm90::kMaxProblems], B[sm90::kMaxProblems];
  EpiWgrad epi{};
  epi.part = as<float>(part);
  for (int p = 0; p < problems; ++p) {
    epi.m[p] = ints[2 * p];
    epi.n[p] = ints[2 * p + 1];
    A[p] = Operand{ptr[2 * p], epi.m[p]};
    B[p] = Operand{ptr[2 * p + 1], epi.n[p]};
  }
  for (int s = 0; s < segments; ++s) {
    ColSeg& sg = epi.seg[s];
    sg.x = ptr[2 * problems + 3 * s];
    sg.z = as<const bf16>(ptr[2 * problems + 3 * s + 1]);
    sg.stats = as<const float>(ptr[2 * problems + 3 * s + 2]);
    sg.width = ints[2 * problems + 3 * s];
    sg.x_f32 = ints[2 * problems + 3 * s + 1];
    sg.stats_ld = ints[2 * problems + 3 * s + 2];
  }
  const int extra = wgrad_layout(epi, problems, segments);
  return run<0b010, true, true, sm90::kMaxProblems>(kWgradConfig, A, B, problems, rows,
                                                    rows_per_split, splits, extra, epi,
                                                    static_cast<cudaStream_t>(stream));
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
