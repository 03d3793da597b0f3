// The whole-layer chains' attention launches on Hopper (sm_90a), bf16 or
// f32: sm90_attn_fwd and sm90_attn_bwd of layer_sm90.cu's chains (ops/
// layer_sm90.py composes them; ops/fused_layer.py and ops/
// fused_decoder_layer.py run them, the decoder's for its causal
// self-attention and its cross-attention). Built apart from layer_sm90.cu so
// that nvcc compiles the two in parallel.
//
// Replaces the attention inside the Pallas TPU kernels transformergrooveinfilling_tpu/
// ops/fused_layer.py::_fwd_kernel / _bwd_kernel and ops/fused_decoder_layer.py's.
//
// What bounds it on the H100: 4·T·d FLOP a row forward (12·T·d backward), 3 %
// of the layer's products at T 32 and 25 % at T 256, against a (sequence,
// head)'s Q, K, V (and dA, dQ, dK, dV) crossing device memory: bytes at the
// flagship (at B 32 × T 128 in bf16, 8 MB forward, 2.5 µs). Kernel #1's
// streamed-head design (attn_stream_sm90.cuh): the head's columns through a
// cp.async ring, so a block's shared memory does not grow with hd (a head of
// 1,024 and more). bf16 on mma.sync m16n8k16 (the 64-row wgmma tiles would
// leave most of a warpgroup idle at T 32), hd a multiple of 8 (16-byte rows
// for cp.async) zero-filled to the mma's 16; f32 in split TF32 on mma.sync
// m16n8k8, any hd (the configs' f32 layers have heads of 2, 4, 8, 16 and
// 128), rows copied 16, 8 or 4 bytes at a time as they allow.
//
// Dropout on P: the layer kernels' 8-bit rule and Philox stream
// (layer_common.cuh), rows counted (sequence·H + head)·T + i and columns j,
// so the masks are ops/fused_layer.py::dropout_mask's at every T.
//
// Plain C entry points, bound from Python with ctypes (ops/layer_sm90.py);
// `f32` picks the activations' dtype, and each returns cudaGetLastError()
// after its launches.

#include <numeric>

#include "attn_regs_sm90.cuh"
#include "attn_stream_sm90.cuh"
#include "rows_sm90.cuh"  // drop_by; by_type and as (gemm_sm90.cuh)

namespace {

// ---------------------------------------------------------------- attention

// One block of two warps per (sequence, head), warp w taking query rows 16w ..
// 16w + 15 (T ≤ 32: keys padded to 32, rows past T zero-filled and their
// results dropped). The head's columns stream through kernel #1's ring
// (attn_stream_sm90.cuh: the scores in registers, Q and K then V in chunks
// through three cp.async stages, every product on mma.sync, bf16 m16n8k16 or
// split-TF32 m16n8k8, the score sums promoted a chunk at a time), so a
// block's shared memory does not grow with hd: 41 KB (bf16) and 45 KB (f32)
// forward, 38 and 42 KB backward, at every width; each warp's output chunks
// are staged in shared memory and stored 16 bytes a lane. The forward is
// #1's with the site's dropout mask on P. The backward keeps each warp's (16 × 32) P,
// dP and dS in registers and streams Q, K, V and dA twice, the four a stage:
// first S = Q·Kᵀ and dP = drop(dA·Vᵀ); then P, dS = P·(dP − Σ_j dP·P)·scale
// and their tiles for the transposed products; then, chunk by chunk, the
// attention output again (for dWo), dQ = dS·K, dV = Pᵀ·dA and dK = dSᵀ·Q.
// bf16 rounds drop(P), dS and every output; f32 rounds nothing. The forward
// and the backward compute S and P by the same code (and split a head over
// the same cluster), so the backward's output again equals the forward's bit
// for bit. A lane holds rows 16w +
// lane/4 (h = 0) and + 8 (h = 1), keys 8n + 2·(lane % 4) + {0, 1}.
//
// Past T 32, up to 256 (loops of 2 to 16 bars), bf16 heads up to 128 take
// the registers form of attn_regs_sm90.cuh (TMA, wgmma, a row's scores in
// registers; the backward one launch of a cluster a (sequence, head), no
// scratch): regs_form is the rule, ops/layer_sm90.py::attention_route its
// mirror. Elsewhere past T 32 (f32, wider heads), the scores form: the long
// route of attn_stream_sm90.cuh, a block of four warps per 64 query rows of a
// (sequence, head), their (64 × T) f32 scores in shared memory (106 KB a block
// at T 256): P is normalised before it is rounded to bf16, as the plain
// version rounds it. (#1's flash form rounds the unnormalised P̃ of each key
// tile instead; a whole bf16 layer on it flipped about ten times the scores
// form's ReLU units against the twin at T 128 on an H100.) The
// backward is two kernels: rows (32 query rows a block: S and dP again, P,
// dS, the output again and dQ; drop(P) and dS rounded into a scratch the
// wrapper allocates), then columns (a block per 64 keys: dV and dK summed
// over the query tiles in order); its output again equals the forward's bit
// for bit. The dropout draws the same bytes as the short route's, a draw of
// 16 columns a lane (AttnDropRow).

// q, k, v (and da, dq, dk, dv, out) point at column 0 of row 0 of packed
// buffers; the head's columns start at head·hd, the sequence's rows at
// seq·T, with the row strides given; copy: the bytes of each cp.async
template <class E>
struct AttnArgs {
  const E *q, *k, *v, *da;
  E *dq, *dk, *dv, *out;
  E* scratch;  // the long backward's drop(P) and dS: two (sequence·H, T, sld) arrays
  const int* seed;
  int ldq, ldkv, ldda, lddq, lddkv, ldo;
  int T, H, hd, thresh, site, causal, copy;
  int ranks;  // the blocks of a (sequence, head): a cluster that splits its columns
};

constexpr int kAttnRows = 32;  // the padded T of the short route
// the longest T, the long route's (attn_stream_sm90.cuh: a (sequence, head)
// split by query rows, the scores in shared memory); the JAX gate's longest
// is 256 (a 128- or 256-row tile holds whole sequences)
constexpr int kAttnMaxT = 256;
constexpr int kAttnKt = kAttnRows / 16;
// the rings' stages: the forward's three chunks in flight (a head of 128
// at once), the backward's two (its stages hold four operands)
constexpr int kAttnFwdStages = 4, kAttnBwdStages = 3;

// the row stride of the backward's (32, 32) P and dS tiles: bf16 rows padded
// by 16 bytes (ldmatrix), f32 rows of 36
template <class E>
__host__ __device__ constexpr int attn_tile_ld() {
  return sizeof(E) == 2 ? kAttnRows + 8 : kAttnRows + 4;
}

// the backward's: its ring, the P and dS tiles, the warps' output staging tiles
template <class E>
__host__ __device__ constexpr size_t attn_bwd_smem() {
  return attn::Ring<E, attn::bwd_cw<E>(), kAttnRows, 4, kAttnBwdStages>::kBytes +
         sizeof(E) * (2 * kAttnRows * attn_tile_ld<E>() +
                      kAttnKt * attn::out_tile<E, attn::bwd_cw<E>()>());
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

// The site's dropout of this warp's (16 × 32) fragments: x → x / keep where
// the byte at (row h, key j) keeps it, else 0
struct AttnDrop {
  uint4 w[2][2];
  int thresh;

  __device__ __forceinline__ AttnDrop(uint32_t seed, int site, int row0, int thresh_)
      : thresh(thresh_) {
    attn_words(w, seed, site, row0, thresh_);
  }

  __device__ __forceinline__ void operator()(float (&x)[4][4]) const {
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
};

// The long route's dropout of query row i (of the (sequence, head)), columns
// 16g .. 16g + 15: one draw of the site's stream, its 16 bytes
struct AttnDropRow {
  uint32_t seed;
  int site, row0, thresh;

  __device__ __forceinline__ void operator()(int i, int g, float (&x)[16]) const {
    if (thresh >= 256) return;
    const float keep = thresh / 256.f;
    const uint4 w = dropout_words(seed, site, row0 + i, g);
#pragma unroll
    for (int e = 0; e < 16; ++e) x[e] = drop_by(x[e], word_byte(w, e), thresh, keep);
  }
};

// a head of a packed (rows, ·) buffer: the sequence's row 0, the head's column 0
template <class E>
__device__ __forceinline__ attn::Rows<E> head_rows(const E* base, int ld, int row0, int col0) {
  return {base + static_cast<size_t>(row0) * ld + col0, ld};
}
template <class E>
__device__ __forceinline__ attn::Out<E> head_out(E* base, int ld, int row0, int col0, int T,
                                                 int hd) {
  return attn::Out<E>(base + static_cast<size_t>(row0) * ld + col0, ld, T, hd);
}

// block (sequence·H + head)·ranks + rank: the rank's share of the head's
// columns (attn::Share, in the forward's chunks)
template <class E>
__global__ void __launch_bounds__(64) attn_fwd(const AttnArgs<E> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = blockIdx.x % p.ranks, head = blockIdx.x / p.ranks;
  const int T = p.T, hd = p.hd, s = head / p.H, hh = head - s * p.H;
  const int r0 = s * T, c0 = hh * hd;
  const attn::Share sh(hd, attn::fwd_cw<E>(), rank, p.ranks);
  const AttnDrop drop(static_cast<uint32_t>(*p.seed), p.site, (s * p.H + hh) * T, p.thresh);
  attn::forward<E, kAttnKt, kAttnFwdStages>(
      smem, head_rows(p.q, p.ldq, r0, c0), head_rows(p.k, p.ldkv, r0, c0),
      head_rows(p.v, p.ldkv, r0, c0), head_out(p.out, p.ldo, r0, c0, T, hd), T, sh.per,
      sh.c_begin, sh.c_end, 1.f / sqrtf(static_cast<float>(hd)), p.causal != 0, -INFINITY,
      p.copy, drop, attn::Split{rank, p.ranks});
}

template <class E>
__global__ void __launch_bounds__(64) attn_bwd(const AttnArgs<E> p) {
  constexpr int CW = attn::bwd_cw<E>(), KT = kAttnKt, kTld = attn_tile_ld<E>();
  static_assert(2 * CW == attn::fwd_cw<E>(), "two backward chunks a forward chunk");
  using Ring = attn::Ring<E, CW, kAttnRows, 4, kAttnBwdStages>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Ring ring{reinterpret_cast<E*>(smem)};
  E* sp = reinterpret_cast<E*>(smem + Ring::kBytes);  // drop(P), (32, kTld)
  E* sd = sp + kAttnRows * kTld;  // dS
  const int rank = blockIdx.x % p.ranks, head = blockIdx.x / p.ranks;
  const int T = p.T, hd = p.hd, s = head / p.H, hh = head - s * p.H;
  const int r0 = s * T, c0 = hh * hd, w16 = 16 * (threadIdx.x >> 5);
  const attn::Share sh(hd, attn::fwd_cw<E>(), rank, p.ranks);  // the forward's share
  E* wt = sd + kAttnRows * kTld + (w16 / 16) * attn::out_tile<E, CW>();  // this warp's staging
  const attn::Rows<E> src[4] = {head_rows(p.q, p.ldq, r0, c0), head_rows(p.k, p.ldkv, r0, c0),
                                head_rows(p.v, p.ldkv, r0, c0), head_rows(p.da, p.ldda, r0, c0)};
  const attn::Out<E> out = head_out(p.out, p.ldo, r0, c0, T, hd);
  const attn::Out<E> dq = head_out(p.dq, p.lddq, r0, c0, T, hd);
  const attn::Out<E> dk = head_out(p.dk, p.lddkv, r0, c0, T, hd);
  const attn::Out<E> dv = head_out(p.dv, p.lddkv, r0, c0, T, hd);
  const AttnDrop drop(static_cast<uint32_t>(*p.seed), p.site, (s * p.H + hh) * T, p.thresh);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const int n_c = 2 * sh.per;  // this rank's chunks, the same in every rank
  float pr[4][4] = {}, dp[4][4] = {};  // S, then P; dP, then dS
  float ps[4][4] = {}, pdp[4][4] = {};  // their promotion groups' sums: two chunks each
  uint32_t pa[KT][4], da[KT][4];  // bf16: round(drop(P)), round(dS) as A fragments
  auto load = [&](int i) {
    const int c = sh.c_begin + (i % n_c) * CW, cols[4] = {c, c, c, c};
    attn::load_chunk<E, CW, kAttnRows, 4>(ring.tile(i, 0), src, cols, T, sh.c_end, p.copy);
  };
  auto compute = [&](int i) {
    const E *tq = ring.tile(i, 0), *tk = ring.tile(i, 1), *tv = ring.tile(i, 2),
            *ta = ring.tile(i, 3);
    if (i < n_c) {
      attn::rows_by_rows<CW, KT>(ps, tq + w16 * Ring::kLd, tk);
      attn::rows_by_rows<CW, KT>(pdp, ta + w16 * Ring::kLd, tv);
      if (i % 2 == 1 || i == n_c - 1) {  // the forward's 128 bytes of a row
        attn::promote(pr, ps);
        attn::promote(dp, pdp);
      }
      if (i < n_c - 1) return;
      if (p.ranks > 1) {  // the cluster's partial S and dP added in rank order
        float* red = reinterpret_cast<float*>(ring.tile(i, 0));
        attn::cluster_sum<KT>(pr, p.ranks, red);
        attn::cluster_sum<KT>(dp, p.ranks, red);
      }
      // P again, exactly as the forward; dP = drop(dA·Vᵀ); dS = P·(dP − Σ_j dP·P)·scale
      attn::softmax(pr, scale, T, p.causal != 0, -INFINITY);
      float pd[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pd[n][e] = pr[n][e];
      drop(pd);
      drop(dp);
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
      if constexpr (sizeof(E) == 2) {
        attn::to_a_frags(pa, pd);
        attn::to_a_frags(da, dp);
        attn::frags_to_tile(sp, kTld, pa);
        attn::frags_to_tile(sd, kTld, da);
      } else {
        attn::frags_to_tile(sp, kTld, pd);
        attn::frags_to_tile(sd, kTld, dp);
      }
      return;  // the next step's barrier orders the tiles before the other warp reads them
    }
    // the output again, dQ = dS·K for this warp's rows; dV = Pᵀ·dA and dK =
    // dSᵀ·Q for keys 16w .., the rank's columns
    const int col = sh.c_begin + (i - n_c) * CW;
    if (col >= sh.c_end) return;
    if constexpr (sizeof(E) == 2) {
      attn::frags_by_chunk<CW, KT>(pa, tv, wt, out, w16, col);
      attn::frags_by_chunk<CW, KT>(da, tk, wt, dq, w16, col);
      attn::tile_t_by_chunk<CW, KT>(sp, kTld, ta, wt, dv, w16, col);
      attn::tile_t_by_chunk<CW, KT>(sd, kTld, tq, wt, dk, w16, col);
    } else {
      attn::tile_by_chunk<false, CW, KT>(sp + w16 * kTld, kTld, tv, wt, out, w16, col);
      attn::tile_by_chunk<false, CW, KT>(sd + w16 * kTld, kTld, tk, wt, dq, w16, col);
      attn::tile_by_chunk<true, CW, KT>(sp + w16, kTld, ta, wt, dv, w16, col);
      attn::tile_by_chunk<true, CW, KT>(sd + w16, kTld, tq, wt, dk, w16, col);
    }
  };
  attn::pipeline<kAttnBwdStages>(2 * n_c, load, compute);
}

// The long route (T past 32). Forward: block (sequence·H + head)·n_qb + qb
// takes query rows 16·QW·qb ..; the backward's rows kernel the same with 32
// rows a block, its columns kernel block (sequence·H + head)·n_kt + kt the
// keys 64·kt ..
template <class E>
struct LongHead {
  int s, hh, r0, c0, part;
  __device__ __forceinline__ LongHead(const AttnArgs<E>& p, int per) {
    const int n = (p.T + per - 1) / per, head = blockIdx.x / n;
    part = blockIdx.x - head * n;
    s = head / p.H;
    hh = head - s * p.H;
    r0 = s * p.T;
    c0 = hh * p.hd;
  }
  __device__ __forceinline__ AttnDropRow drop(const AttnArgs<E>& p) const {
    return {static_cast<uint32_t>(*p.seed), p.site, (s * p.H + hh) * p.T, p.thresh};
  }
  // this head's scratch rows: drop(P) (which = 0) or dS (1)
  __device__ __forceinline__ E* scratch(const AttnArgs<E>& p, int nseq, int which) const {
    const size_t rows = static_cast<size_t>(nseq) * p.H * p.T;
    return p.scratch + (which * rows + static_cast<size_t>(s * p.H + hh) * p.T) *
                           attn::scratch_ld(p.T);
  }
};

template <class E, int QW>
__global__ void __launch_bounds__(32 * attn::kLongWarps) attn_fwd_long(const AttnArgs<E> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LongHead<E> h(p, 16 * QW);
  attn::long_forward<E, QW>(smem, head_rows(p.q, p.ldq, h.r0, h.c0),
                            head_rows(p.k, p.ldkv, h.r0, h.c0), head_rows(p.v, p.ldkv, h.r0, h.c0),
                            head_out(p.out, p.ldo, h.r0, h.c0, p.T, p.hd), p.T, p.hd,
                            16 * QW * h.part, 1.f / sqrtf(static_cast<float>(p.hd)),
                            p.causal != 0, -INFINITY, p.copy, h.drop(p));
}

template <class E>
__global__ void __launch_bounds__(32 * attn::kLongWarps) attn_bwd_rows(const AttnArgs<E> p,
                                                                      int nseq) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LongHead<E> h(p, attn::LongBwd<E>::QR);
  attn::long_backward_rows<E>(
      smem, head_rows(p.q, p.ldq, h.r0, h.c0), head_rows(p.k, p.ldkv, h.r0, h.c0),
      head_rows(p.v, p.ldkv, h.r0, h.c0), head_rows(p.da, p.ldda, h.r0, h.c0),
      head_out(p.out, p.ldo, h.r0, h.c0, p.T, p.hd), head_out(p.dq, p.lddq, h.r0, h.c0, p.T, p.hd),
      h.scratch(p, nseq, 0), h.scratch(p, nseq, 1), attn::scratch_ld(p.T), p.T, p.hd,
      attn::LongBwd<E>::QR * h.part, 1.f / sqrtf(static_cast<float>(p.hd)), p.causal != 0,
      -INFINITY, p.copy, h.drop(p));
}

template <class E>
__global__ void __launch_bounds__(32 * attn::kLongWarps) attn_bwd_cols(const AttnArgs<E> p,
                                                                      int nseq) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LongHead<E> h(p, attn::kKeys);
  const int sld = attn::scratch_ld(p.T);
  attn::long_backward_cols<E>(
      smem, attn::Rows<E>{h.scratch(p, nseq, 0), sld}, attn::Rows<E>{h.scratch(p, nseq, 1), sld},
      head_rows(p.q, p.ldq, h.r0, h.c0), head_rows(p.da, p.ldda, h.r0, h.c0),
      head_out(p.dk, p.lddkv, h.r0, h.c0, p.T, p.hd), head_out(p.dv, p.lddkv, h.r0, h.c0, p.T, p.hd),
      sld, p.T, p.hd, h.part, p.copy);
}

// the registers form's rule (ops/layer_sm90.py::attention_route): bf16, T
// past 32, hd ≤ 128; the views TMA reads (every base and row stride a 16-byte
// multiple, hd a multiple of 8) are what attn_args_ok asks of bf16
template <class E>
bool regs_form(const AttnArgs<E>& a) {
  return sizeof(E) == 2 && a.T > kAttnRows && a.T <= regs::kMaxT && a.hd <= regs::kMaxHd;
}

// what the kernels take: T ≤ 256, hd ≥ 1; bf16 also hd a multiple of 8 and
// every row 16 bytes aligned (q, k, v and the outputs; backward dA, dq, dk
// and dv too)
template <class E>
bool attn_args_ok(const AttnArgs<E>& a, bool backward) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  bool ok = a.T >= 1 && a.T <= kAttnMaxT && a.hd >= 1;
  if (backward && a.T > kAttnRows && !regs_form(a))  // the scores form's scratch: 16-byte aligned
    ok = ok && a.scratch != nullptr && (reinterpret_cast<uintptr_t>(a.scratch) & 15) == 0;
  if constexpr (sizeof(E) == 2) {
    ok = ok && a.hd % 8 == 0 && a.ldq % 8 == 0 && a.ldkv % 8 == 0 && a.ldo % 8 == 0 &&
         aligned(a.q) && aligned(a.k) && aligned(a.v) && aligned(a.out);
    if (backward)
      ok = ok && a.ldda % 8 == 0 && a.lddq % 8 == 0 && a.lddkv % 8 == 0 && aligned(a.da) &&
           aligned(a.dq) && aligned(a.dk) && aligned(a.dv);
  }
  return ok;
}

// the widest cp.async copy, 16, 8 or 4 bytes, that every operand's pointer,
// row stride and the head width allow (the head's columns start at multiples
// of hd); bf16 rows are 16-byte aligned (attn_args_ok)
template <class E>
int attn_copy(const AttnArgs<E>& a, bool backward) {
  uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                   reinterpret_cast<uintptr_t>(a.v);
  long long g = std::gcd(std::gcd(a.ldq, a.ldkv), a.hd);
  if (backward) {
    ptrs |= reinterpret_cast<uintptr_t>(a.da);
    g = std::gcd(g, static_cast<long long>(a.ldda));
  }
  g *= sizeof(E);
  if (g % 16 == 0 && ptrs % 16 == 0) return 16;
  return g % 8 == 0 && ptrs % 8 == 0 ? 8 : 4;
}

// the short route (T ≤ 32): a block of two warps a (sequence, head), in
// clusters splitting a head's columns where the heads are fewer than two an SM
// (attn::ranks_for: the forward and the backward of a call split alike)
template <class E, typename Kernel>
int launch_attn(Kernel kernel, AttnArgs<E> a, int nseq, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const long long heads = static_cast<long long>(nseq) * a.H;
  a.ranks = attn::ranks_for(heads, (a.hd + attn::fwd_cw<E>() - 1) / attn::fwd_cw<E>());
  return static_cast<int>(attn::launch_clustered(kernel, heads, a.ranks, 64, smem, stream, a));
}

// a long-route kernel: `per` rows (query or key) of a (sequence, head) a
// block, `smem` bytes of it (opted in above 48 KB, to the most asked so far)
template <typename Kernel, class... Args>
int launch_long(Kernel kernel, size_t& opted, size_t smem, long long nseq, int H, int T, int per,
                cudaStream_t stream, const Args&... args) {
  if (smem > 48 * 1024 && smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  const long long blocks = nseq * H * ((T + per - 1) / per);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), 32 * attn::kLongWarps, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The registers form at NT key tiles of 64 and NB column boxes of 64: 4-D
// tensor maps of every operand encoded each call (so that a CUDA graph
// captures the launch with its maps), a block per 64 query rows of a
// (sequence, head), the backward's ⌈T/64⌉ blocks of a (sequence, head) a
// cluster. 0, or the launch's error (cudaErrorInvalidValue for a map the
// driver refuses).
template <int NT, int NB, bool BWD>
int launch_regs(const AttnArgs<__nv_bfloat16>& a, int nseq, cudaStream_t stream) {
  constexpr size_t smem = BWD ? regs::Bwd<NT, NB>::kSmem : regs::Fwd<NT, NB>::kSmem;
  void (*kernel)(const regs::Maps, const regs::Params) =
      BWD ? regs::bwd_kernel<NT, NB> : regs::fwd_kernel<NT, NB>;
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  if (const int err = sm90::bind_context()) return err;
  regs::Maps maps{};
  auto map = [&](CUtensorMap* m, const void* base, int ld) {
    return regs::map_of(m, base, a.hd, a.T, a.H, nseq, ld);
  };
  int err = map(&maps.q, a.q, a.ldq);
  if (!err) err = map(&maps.k, a.k, a.ldkv);
  if (!err) err = map(&maps.v, a.v, a.ldkv);
  if (!err) err = map(&maps.out, a.out, a.ldo);
  if (BWD && !err) err = map(&maps.da, a.da, a.ldda);
  if (BWD && !err) err = map(&maps.dq, a.dq, a.lddq);
  if (BWD && !err) err = map(&maps.dk, a.dk, a.lddkv);
  if (BWD && !err) err = map(&maps.dv, a.dv, a.lddkv);
  if (err) return err;
  const regs::Params p{a.T, a.H, a.causal, a.thresh, a.site,
                       1.f / sqrtf(static_cast<float>(a.hd)), -INFINITY, a.seed};
  const long long blocks = static_cast<long long>(nseq) * a.H * NT;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(regs::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = BWD ? NT : 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, maps, p);
  return static_cast<int>(launched != cudaSuccess ? launched : cudaGetLastError());
}

template <bool BWD>
int launch_regs_by(const AttnArgs<__nv_bfloat16>& a, int nseq, cudaStream_t stream) {
  const bool wide = a.hd > 64;
  switch ((a.T + 63) / 64) {
    case 1: return wide ? launch_regs<1, 2, BWD>(a, nseq, stream) : launch_regs<1, 1, BWD>(a, nseq, stream);
    case 2: return wide ? launch_regs<2, 2, BWD>(a, nseq, stream) : launch_regs<2, 1, BWD>(a, nseq, stream);
    case 3: return wide ? launch_regs<3, 2, BWD>(a, nseq, stream) : launch_regs<3, 1, BWD>(a, nseq, stream);
    default: return wide ? launch_regs<4, 2, BWD>(a, nseq, stream) : launch_regs<4, 1, BWD>(a, nseq, stream);
  }
}

template <class E>
int attn_forward(AttnArgs<E> a, int nseq, cudaStream_t stream) {
  if (!attn_args_ok(a, false)) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(E) == 2)
    if (regs_form(a)) return launch_regs_by<false>(a, nseq, stream);
  a.copy = attn_copy(a, false);
  if (a.T <= kAttnRows)
    return launch_attn(attn_fwd<E>, a, nseq,
                       attn::forward_smem<E, kAttnKt, kAttnFwdStages>(), stream);
  static_assert(attn::long_qw(kAttnMaxT) == 4, "64 query rows a block at every T");
  static size_t opted = 0;
  return launch_long(attn_fwd_long<E, 4>, opted, attn::LongFwd<E, 4>::smem(a.T), nseq, a.H, a.T,
                     attn::LongFwd<E, 4>::QR, stream, a);
}

template <class E>
int attn_backward(AttnArgs<E> a, int nseq, cudaStream_t stream) {
  if (!attn_args_ok(a, true)) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(E) == 2)
    if (regs_form(a)) return launch_regs_by<true>(a, nseq, stream);
  a.copy = attn_copy(a, true);
  if (a.T <= kAttnRows) return launch_attn(attn_bwd<E>, a, nseq, attn_bwd_smem<E>(), stream);
  static size_t rows_opted = 0, cols_opted = 0;
  const int err = launch_long(attn_bwd_rows<E>, rows_opted, attn::LongBwd<E>::smem(a.T), nseq,
                              a.H, a.T, attn::LongBwd<E>::QR, stream, a, nseq);
  if (err) return err;
  return launch_long(attn_bwd_cols<E>, cols_opted, attn::LongCols<E>::smem(), nseq, a.H, a.T,
                     attn::kKeys, stream, a, nseq);
}

template <class E>
AttnArgs<E> attn_args(void* q, void* k, void* v, void* da, void* dq, void* dk, void* dv,
                      void* out, void* scratch, void* seed, int ldq, int ldkv, int ldda, int lddq,
                      int lddkv, int ldo, int T, int H, int hd, int thresh, int site, int causal) {
  AttnArgs<E> a{};
  a.scratch = as<E>(scratch);
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

// out = round(round(drop(softmax(QKᵀ/√hd))) · V) per (sequence, head)
int tgi_sm90_attn_fwd(void* q, void* k, void* v, void* out, void* seed, int ldq, int ldkv,
                      int ldo, int nseq, int T, int H, int hd, int thresh, int site, int causal,
                      int f32, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return by_type(f32, [&](auto type) {
    using T_ = typename decltype(type)::type;
    return attn_forward(attn_args<T_>(q, k, v, nullptr, nullptr, nullptr, nullptr, out, nullptr,
                                      seed, ldq, ldkv, 0, 0, 0, ldo, T, H, hd, thresh, site,
                                      causal),
                        nseq, st);
  });
}

// dq, dk, dv from da = d(attention output), and out = the attention output
// again; past T 32 the scores form's scratch holds 2·nseq·H·T·⌈T / 8⌉·8
// values of the activations' dtype (drop(P) and dS, written by the rows
// kernel and read by the columns kernel), else (T ≤ 32, the registers form)
// it may be null
int tgi_sm90_attn_bwd(void* q, void* k, void* v, void* da, void* dq, void* dk, void* dv,
                      void* out, void* scratch, void* seed, int ldq, int ldkv, int ldda, int lddq,
                      int lddkv, int ldo, int nseq, int T, int H, int hd, int thresh, int site,
                      int causal, int f32, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return by_type(f32, [&](auto type) {
    using T_ = typename decltype(type)::type;
    return attn_backward(attn_args<T_>(q, k, v, da, dq, dk, dv, out, scratch, seed, ldq, ldkv,
                                       ldda, lddq, lddkv, ldo, T, H, hd, thresh, site, causal),
                         nseq, st);
  });
}

const char* tgi_sm90_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
