// The whole-layer chains' attention past T 32 in bf16 on Hopper (sm_90a):
// the "registers" form of layer_attn_sm90.cu's tgi_sm90_attn_fwd and
// tgi_sm90_attn_bwd, where 33 ≤ T ≤ 256, hd ≤ 128 and TMA reads the views
// (every base and row stride a 16-byte multiple, hd·2 bytes too: what the
// chains' bf16 views are). ops/layer_sm90.py::attention_route is the rule;
// f32, wider heads and T ≤ 32 keep attn_stream_sm90.cuh's forms.
//
// Replaces the attention inside the Pallas TPU kernels
// transformergrooveinfilling_tpu/ops/fused_layer.py::_fwd_kernel (its
// _block_diag_softmax, then P rounded to the compute dtype) and _bwd_kernel,
// and the same inside fused_decoder_layer.py::_fwd_call and _bwd_call (the
// causal self-attention, and the cross-attention on a packed kv).
//
// What it computes, per (sequence, head): out = round(round(drop(P))·V), P =
// softmax(Q·Kᵀ/√hd) (keys after a row's own filled with `fill` where
// causal), and backward dq, dk, dv and the output again from da: dP =
// drop(dA·Vᵀ), dS = round(P·(dP − Σ_j dP·P)·scale), dQ = dS·K, dK = dSᵀ·Q,
// dV = round(drop(P))ᵀ·dA. P is normalised before it is dropped and rounded,
// as the plain version and _block_diag_softmax do (the flash form's
// unnormalised P̃ flipped ten times the ReLU units of a whole bf16 layer).
//
// What bounds it on the H100: a (sequence, head) is 4·T²·hd FLOP forward
// (12 backward) against 4·T·hd values (8 backward); at T ≤ 256 and hd 128
// that is under 64 FLOP a byte forward and 96 backward, below the 295 at
// which bf16's 989 TFLOP/s would bound it: bytes at 3.35 TB/s bound it (2.5
// µs forward at B 32, T 128, d 256).
//
// Design. A block takes 64 query rows of one (sequence, head) in two
// warpgroups (256 threads), each warpgroup the same rows and half of every
// 64-key tile (keys 32w .. 32w + 31 of each), so that a thread holds half a
// row pair's scores and does half its elementwise work (with one warpgroup
// the backward at T 256 held P and dP in 255 registers, and its second dP
// sweep and the scheduling ptxas managed there cost 30–40 µs; PERF.md §6).
// One thread loads the operands whole by TMA, each a stack of 64-column
// boxes with the 128-byte swizzle (4-D tensor maps over (hd, T, H,
// sequences) with the views' own row strides; rows past T and columns past
// hd are TMA's zero fill): the block's Q rows, and K and V of all T keys in
// tiles of 64 keys, each tile under its own mbarrier, so the products start
// on the first tile while the others land.
//   S = Q·Kᵀ on wgmma m64n32k16, one accumulator a key tile and warpgroup:
//   the (64 × T) f32 scores in registers, T/4 a thread (64 at T 256). The
//   exact softmax in registers: a row's max and sum over the row's quad, then
//   over the two warpgroups through shared memory (max(m0, m1), l0 + l1: one
//   order in both), e = 2^(x·log2e − m·log2e), P = e · (1 / Σ e), then the
//   dropout, then round(drop(P)) to bf16 into shared memory (a K-major A
//   operand), and out = round(drop(P))·V on wgmma m64n64k16 (V MN-major
//   through the transpose bit), warpgroup w the columns of box w. The
//   dropout draws the site's Philox bytes of row (sequence·H + head)·T + i,
//   16 keys a draw: the four lanes of a quad (one row pair) draw one each and
//   share each draw's 16 keep bits by one shuffle, each thread taking the
//   bits of its accumulator columns (keys 8j + 2·(lane % 4) + e). The
//   dropout's scale x / (thresh / 256) is a product and one FMA correction
//   (`Keep`), not a division: the division's slow path on zeros and tiny
//   numerators cost the causal rows 2–3× (scripts/chain_attention_variants.py).
//   Backward: a cluster of ⌈T/64⌉ blocks per (sequence, head), block r its
//   query rows 64r .. and key rows 64r ... Block r computes S and P by the
//   forward's code (so the output again is the forward's bit for bit), dP =
//   drop(dA·Vᵀ) beside P (each warpgroup its keys), Σ_j dP·P over the row's
//   quad and the two warpgroups (one order), round(drop(P)) and round(dS)
//   into its shared memory, then the output again and dQ = dS·K. After a
//   cluster barrier warpgroup 0 sums dV_r = Σ_b drop(P)[b, r]ᵀ·dA_b and
//   warpgroup 1 dK_r = Σ_b dS[b, r]ᵀ·Q_b in rank order b (from b = r where
//   causal: the tiles before are 0): block b's tiles of this block's keys
//   copied from its shared memory (distributed shared memory) into slots
//   where K and V were, the next one's beside the products, Q_b and dA_b by
//   TMA, two slots in flight. No device-memory scratch and no float atomics:
//   a rerun is bit for bit.
// Shared memory (T 256, hd 128): forward 149,576 bytes (two blocks an SM at T
// 128), backward 232,024 (ops/layer_sm90.py::registers_smem_bytes).

#pragma once

#include "attn_flash_sm90.cuh"
#include "layer_common.cuh"

namespace {
namespace regs {

using flash::kRowBytes;
constexpr int kBox = 64 * kRowBytes;  // a box: 64 rows of 64 bf16 values
constexpr int kThreads = 256;         // two warpgroups a block, half the keys each
constexpr int kRed = 2 * 64 * 4;      // a row's partial of each warpgroup (f32)
constexpr int kMaxT = 256, kMaxHd = 128;
constexpr int kSmemLimit = 232448;

// the forward's shared memory: Q (NB boxes; then the output's staging), K (NB
// boxes of NT·64 key rows; then round(drop(P)), NT boxes), V, the mbarriers
// (Q, then a K tile's and a V tile's each), the rows' max and sum of each
// warpgroup
template <int NT, int NB>
struct Fwd {
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + NB * kBox;
  static constexpr int kV = kK + NB * NT * kBox;
  static constexpr int kBar = kV + NB * NT * kBox;
  static constexpr int kBars = 1 + 2 * NT;
  static constexpr int kReds = kBar + 8 * kBars;
  static constexpr size_t kSmem = static_cast<size_t>(kReds) + 2 * kRed + 1024;
  static_assert(kSmem <= kSmemLimit, "a block takes at most 232,448 bytes of shared memory");
};

// the backward's: Q and dA of the block's rows, K and V (then the output's
// and dQ's staging, then the sums' slots), round(drop(P)) and round(dS) of
// the block's rows (NT boxes each, box c the keys of block c), the mbarriers
// (Q and dA; a K tile's, a V tile's; a slot's), the rows' max, sum and Σ_j
// dP·P of each warpgroup. A slot: another block's Q and dA, and its drop(P)
// and dS boxes of this block's keys.
template <int NT, int NB>
struct Bwd {
  static constexpr int kQ = 0;
  static constexpr int kDA = kQ + NB * kBox;
  static constexpr int kK = kDA + NB * kBox;
  static constexpr int kV = kK + NB * NT * kBox;
  static constexpr int kPD = kV + NB * NT * kBox;
  static constexpr int kDS = kPD + NT * kBox;
  static constexpr int kBar = kDS + NT * kBox;
  static constexpr int kSlot = (2 * NB + 2) * kBox;
  static constexpr int kFit = 2 * NB * NT * kBox / kSlot;
  static constexpr int kSlots = kFit < 1 ? 1 : kFit > 2 ? 2 : kFit;
  static constexpr int kBars = 1 + 2 * NT + kSlots;
  static constexpr int kReds = kBar + 8 * kBars;
  static constexpr size_t kSmem = static_cast<size_t>(kReds) + 3 * kRed + 1024;
  static_assert(kSmem <= kSmemLimit, "a block takes at most 232,448 bytes of shared memory");
  static_assert(NT == 1 || kFit >= 1, "a slot fits where K and V were");
};

// the tensor maps of a launch, each 4-D over (hd, T, H, sequences) with
// boxes of 64 columns × 64 rows: q, k, v read and out written (forward);
// also da read and dq, dk, dv written (backward)
struct Maps {
  CUtensorMap q, k, v, out, da, dq, dk, dv;
};

struct Params {
  int t, heads, causal, thresh, site;
  float scale, fill;
  const int* seed;
};

// ---------------------------------------------------------------- PTX

#define RG_D8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define RG_D32 RG_D8(0), RG_D8(8), RG_D8(16), RG_D8(24)
#define RG_D64 RG_D32, RG_D8(32), RG_D8(40), RG_D8(48), RG_D8(56)
#define RG_R32                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"               \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define RG_R64                                                                          \
  RG_R32 ","                                                                            \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"     \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 × 64 f32) += A (64 × 16) · B (64 × 16)ᵀ, bf16, both in shared memory:
// descriptors da and db plus the compile-time offsets OA and OB (16-byte
// units, added in PTX so that only the base descriptors stay live), the
// transpose bits TA and TB (1: MN-major)
template <int TA, int TB, int OA, int OB>
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\nsetp.ne.b32 p, %34, 0;\n"
      "add.s64 a, %32, %35;\nadd.s64 b, %33, %36;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" RG_R32
      "}, a, b, p, 1, 1, %37, %38;\n}\n"
      : RG_D32
      : "l"(da), "l"(db), "r"(1), "n"(OA), "n"(OB), "n"(TA), "n"(TB));
}
// ... d (64 × 128 f32)
template <int TA, int TB, int OA, int OB>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\nsetp.ne.b32 p, %66, 0;\n"
      "add.s64 a, %64, %67;\nadd.s64 b, %65, %68;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" RG_R64
      "}, a, b, p, 1, 1, %69, %70;\n}\n"
      : RG_D64
      : "l"(da), "l"(db), "r"(1), "n"(OA), "n"(OB), "n"(TA), "n"(TB));
}

#define RG_D16 RG_D8(0), RG_D8(8)
#define RG_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
// ... d (64 × 32 f32)
template <int TA, int TB, int OA, int OB>
__device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\nsetp.ne.b32 p, %18, 0;\n"
      "add.s64 a, %16, %19;\nadd.s64 b, %17, %20;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" RG_R16
      "}, a, b, p, 1, 1, %21, %22;\n}\n"
      : RG_D16
      : "l"(da), "l"(db), "r"(1), "n"(OA), "n"(OB), "n"(TA), "n"(TB));
}

#undef RG_D16
#undef RG_R16
#undef RG_D8
#undef RG_D32
#undef RG_D64
#undef RG_R32
#undef RG_R64

// an MN-major operand's descriptor: boxes of 64 (m or n) values `box` bytes
// apart (LBO), each k row 128 bytes, 8 k rows 1,024 bytes apart (SBO); a k16
// step adds 2,048 bytes
__device__ __forceinline__ uint64_t mn_major(uint32_t addr, int box) {
  return sm90::desc(addr, static_cast<uint32_t>(box) >> 4, 1024 >> 4);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// ---------------------------------------------------------------- loads

// rows row0 .. row0 + 63 of (head hh, sequence s) into `dst`: NB boxes
// `stride` bytes apart, reported to `bar` (expect_tx: the caller's)
template <int NB>
__device__ __forceinline__ void load_rows(uint8_t* dst, int stride, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int hh, int s) {
#pragma unroll
  for (int c = 0; c < NB; ++c) flash::tma_load4(dst + c * stride, map, bar, 64 * c, row0, hh, s);
}

// K and V of the (sequence, head): key tile kt's boxes under bars[kt] and
// bars[NT + kt]
template <int NT, int NB>
__device__ __forceinline__ void load_keys(uint8_t* k, uint8_t* v, const Maps& maps,
                                          uint64_t* bars, int hh, int s) {
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    sm90::mbar_expect_tx(&bars[kt], NB * kBox);
    load_rows<NB>(k + kt * kBox, NT * kBox, &maps.k, &bars[kt], 64 * kt, hh, s);
  }
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    sm90::mbar_expect_tx(&bars[NT + kt], NB * kBox);
    load_rows<NB>(v + kt * kBox, NT * kBox, &maps.v, &bars[NT + kt], 64 * kt, hh, s);
  }
}

// ---------------------------------------------------------------- the rows

// A thread's place: warpgroup w = threadIdx.x / 128 takes keys 32w .. 32w + 31
// of every 64-key tile; in its accumulator of m64nN register 4j + 2h + e
// holds row 16·warp + lane/4 + 8h (warp within the warpgroup), column 8j +
// 2·(lane % 4) + e.
__device__ __forceinline__ int wg_of() { return static_cast<int>(threadIdx.x) >> 7; }
__device__ __forceinline__ int row_of(int h) {
  const int t = threadIdx.x & 127;
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * h;
}

// Issue S = Q·Kᵀ of this warpgroup's keys: s[kt] the (64 × 32) scores of key
// tile kt, each tile's products once its K tile has landed (kbar[kt]); q, k:
// the Q tile (NB boxes of 64 rows) and K (NB boxes of NT·64 rows). Waited for
// by the caller.
template <int NT, int NB>
__device__ __forceinline__ void issue_scores(float (&s)[NT][16], uint32_t q, uint32_t k,
                                             uint64_t* kbar) {
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) zero(s[kt]);
  const uint64_t qd = flash::kmajor(q), kd = flash::kmajor(k + wg_of() * 32 * kRowBytes);
  flash::unroll<0, NT>([&](auto kt_) {
    constexpr int KT = decltype(kt_)::value;
    flash::wait(&kbar[KT], 0);
    sm90::fence_regs(s[KT]);
    sm90::wgmma_fence();
    flash::unroll<0, 4 * NB>([&](auto st_) {
      constexpr int ST = decltype(st_)::value;
      constexpr int OA = (ST / 4) * kBox / 16 + (ST % 4) * 2;
      constexpr int OB = ((ST / 4) * NT + KT) * kBox / 16 + (ST % 4) * 2;
      mma<0, 0, OA, OB>(s[KT], qd, kd);
    });
    sm90::wgmma_commit();
  });
}

template <int NT>
__device__ __forceinline__ void wait_scores(float (&s)[NT][16]) {
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) sm90::fence_regs(s[kt]);
}

// The dropout's keep bits of this thread's accumulator columns: bit 4j + 2h +
// e of keep[kt] keeps (row i0 + 8h, key 64kt + 32w + 8j + 2·(lane % 4) + e).
// Row i of the (sequence, head) draws the site's bytes of row `row0` + i, 16
// keys a draw (layer_common.cuh); a quad's four lanes hold the same two rows
// and the same two 16-key groups of each tile, so lane q draws (row h = q %
// 2, group 4kt + 2w + q / 2) in round kt and the quad shares each draw's 16
// keep bits by one shuffle.
template <int NT>
__device__ __forceinline__ void keep_bits(uint32_t (&keep)[NT], uint32_t seed, int site, int row0,
                                          int i0, int thresh) {
  const int lane = threadIdx.x & 31, q4 = lane & 3, w = wg_of();
  const int my_row = row0 + i0 + 8 * (q4 & 1);
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    keep[kt] = 0u;
    const uint4 d = dropout_words(seed, site, my_row, 4 * kt + 2 * w + (q4 >> 1));
    uint32_t bits = 0u;
#pragma unroll
    for (int b = 0; b < 16; ++b)
      bits |= static_cast<uint32_t>(word_byte(d, b) < static_cast<uint32_t>(thresh)) << b;
#pragma unroll
    for (int src = 0; src < 4; ++src) {
      const uint32_t m = __shfl_sync(0xffffffffu, bits, (lane & 28) | src);
      const int h = src & 1, j0 = 2 * (src >> 1);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          keep[kt] |= ((m >> (8 * jj + 2 * q4 + e)) & 1u) << (4 * (j0 + jj) + 2 * h + e);
    }
  }
}

// The dropout's scale: x / kf (kf = thresh / 256) rounded as IEEE division
// rounds it, from r = 1 / kf and one FMA correction (Markstein: with r
// correctly rounded, the corrected quotient is x / kf correctly rounded for
// every x of the normal range, and exactly 0 for x = 0). The division itself
// takes a slow path on zero and tiny numerators: half of a causal row's P.
struct Keep {
  float kf, r;
  __device__ __forceinline__ explicit Keep(int thresh) : kf(thresh / 256.f), r(1.f / kf) {}
  // x where the bit keeps it, divided by thresh / 256, else 0 (drop_by's rule)
  __device__ __forceinline__ float operator()(float x, uint32_t keep, int bit) const {
    const float q = x * r;
    return (keep >> bit) & 1u ? fmaf(fmaf(-kf, q, x), r, q) : 0.f;
  }
};

// This thread's rows' values v[h] (each already over its quad) combined over
// the two warpgroups through `red` (64 rows a warpgroup): the max, or the sum
// warpgroup 0's + warpgroup 1's; one order in both warpgroups
template <bool MAX>
__device__ __forceinline__ void across(float* red, float (&v)[2]) {
  const int w = wg_of();
  if ((threadIdx.x & 3) == 0) {
    red[64 * w + row_of(0)] = v[0];
    red[64 * w + row_of(1)] = v[1];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float a = red[row_of(h)], b = red[64 + row_of(h)];
    v[h] = MAX ? fmaxf(a, b) : a + b;
  }
}

// The softmax of this thread's rows (query rows i0 and i0 + 8 of the
// sequence) over all T keys, in place: x = S·scale (keys ≥ t no weight, keys
// past the row's own `fill` where causal), m the row's max (its quad, then
// both warpgroups), e = exp(x − m) = 2^(x·log2e − m·log2e) (one FFMA and one
// ex2 a score), P = e · (1 / Σ e), Σ over the thread's columns in order, its
// quad, then warpgroup 0's + warpgroup 1's. red: two kRed buffers.
template <int NT>
__device__ __forceinline__ void softmax(float (&s)[NT][16], int i0, const Params& p, float* red) {
  const int q4 = threadIdx.x & 3, w = wg_of();
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int kt = 0; kt < NT; ++kt)
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int h = (x >> 1) & 1, key = 64 * kt + 32 * w + 8 * (x >> 2) + 2 * q4 + (x & 1);
      const float v = key >= p.t ? -INFINITY
                      : p.causal && key > i0 + 8 * h ? p.fill
                                                     : s[kt][x] * p.scale;
      s[kt][x] = v;
      m[h] = fmaxf(m[h], v);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
  across<true>(red, m);
  const float ml[2] = {m[0] * flash::kLog2e, m[1] * flash::kLog2e};
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int kt = 0; kt < NT; ++kt)
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int h = (x >> 1) & 1;
      s[kt][x] = flash::ex2(fmaf(s[kt][x], flash::kLog2e, -ml[h]));
      sum[h] += s[kt][x];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) sum[h] = quad_sum(sum[h]);
  across<false>(red + 2 * 64, sum);
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
  for (int kt = 0; kt < NT; ++kt)
#pragma unroll
    for (int x = 0; x < 16; ++x) s[kt][x] *= inv[(x >> 1) & 1];
}

// 16-byte chunk c of this thread's row h, rounded pairs: (row, 8c + 2·(lane %
// 4)) into a box of 64 rows × 128 bytes with the 128-byte swizzle
__device__ __forceinline__ void put_pair(uint8_t* box, int c, int h, float x0, float x1) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  *reinterpret_cast<uint32_t*>(box + row_of(h) * kRowBytes + (((c & 7) ^ g) << 4) +
                               4 * (lane & 3)) = flash::pack_bf16(x0, x1);
}

// this warpgroup's keys of (64 × 64·NT) rows (P, or dS) into `tile`, NT
// boxes of 64 rows × 64 keys, each value through f(x, kt, register)
template <int NT, class F>
__device__ __forceinline__ void store_keys(uint8_t* tile, const float (&s)[NT][16], const F& f) {
  const int w = wg_of();
#pragma unroll
  for (int kt = 0; kt < NT; ++kt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = 4 * j + 2 * h;
        put_pair(tile + kt * kBox, 4 * w + j, h, f(s[kt][x], kt, x), f(s[kt][x + 1], kt, x + 1));
      }
}

// round(drop(P)) (keep: keep_bits; every value where thresh ≥ 256)
template <int NT>
__device__ __forceinline__ void store_p(uint8_t* tile, const float (&s)[NT][16],
                                        const uint32_t (&keep)[NT], int thresh) {
  const Keep drop(thresh);
  store_keys<NT>(tile, s, [&](float x, int kt, int bit) {
    return thresh < 256 ? drop(x, keep[kt], bit) : x;
  });
}

// a 64 × 64 accumulator (o) rounded into a box of 64 rows
__device__ __forceinline__ void stage(uint8_t* box, const float (&o)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) put_pair(box, j, h, o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
}

// Issue o (64 × 64) += A (64 × 64·NT, K-major boxes at `a`) · B (64·NT × 64,
// MN-major: the box of 64·NT rows at `b`), one straight run of products
template <int NT>
__device__ __forceinline__ void issue_by_keys(float (&o)[32], uint32_t a, uint32_t b) {
  const uint64_t ad = flash::kmajor(a), bd = mn_major(b, NT * kBox);
  sm90::wgmma_fence();
  flash::unroll<0, 4 * NT>([&](auto st_) {
    constexpr int ST = decltype(st_)::value;
    mma<0, 1, (ST / 4) * kBox / 16 + (ST % 4) * 2, ST * 2048 / 16>(o, ad, bd);
  });
  sm90::wgmma_commit();
}

// store the staged boxes `boxes` (64 rows × 64 columns each, kBox apart from
// `tile`: column boxes c of `c_first` ..) by TMA into rows row0 .. of (head
// hh, sequence s), rows past T clipped; one thread
__device__ __forceinline__ void store_boxes(const CUtensorMap* map, const uint8_t* tile,
                                            int c_first, int boxes, int row0, int hh, int s) {
  for (int c = 0; c < boxes; ++c)
    flash::tma_store4(map, tile + c * kBox, 64 * (c_first + c), row0, hh, s);
}

// the block's (sequence, head) and its place in it: blocks (sequence·H +
// head)·NT + r
struct Place {
  int s, hh, r;
};

template <int NT>
__device__ __forceinline__ Place place_of(const Params& p) {
  const int head = blockIdx.x / NT;
  return {head / p.heads, head % p.heads, static_cast<int>(blockIdx.x % NT)};
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// S, the dropout's bits and P of the block's rows (this warpgroup's keys),
// by one code path in the forward and the backward (so the backward's output
// again is the forward's bit for bit)
template <int NT, int NB>
__device__ __forceinline__ void probabilities(float (&s)[NT][16], uint32_t (&keep)[NT], uint32_t q,
                                              uint32_t k, uint64_t* kbar, const Params& p,
                                              const Place& at, float* red) {
  const int i0 = 64 * at.r + row_of(0);
  issue_scores<NT, NB>(s, q, k, kbar);
  if (p.thresh < 256)  // beside the products
    keep_bits<NT>(keep, static_cast<uint32_t>(*p.seed), p.site, (at.s * p.heads + at.hh) * p.t,
                  i0, p.thresh);
  wait_scores<NT>(s);
  softmax<NT>(s, i0, p, red);
}

// The output (or dQ): o (64 × 64) = A · B over all keys, A round(drop(P))
// (or round(dS)) at `a`, B the column box `c` of V (or K) at `b` (NB boxes of
// NT·64 rows); one code path in the forward and the backward
template <int NT>
__device__ __forceinline__ void by_keys(float (&o)[32], uint32_t a, uint32_t b, int c) {
  zero(o);
  issue_by_keys<NT>(o, a, b + c * NT * kBox);
}

// ---------------------------------------------------------------- forward

template <int NT, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ Maps maps, const Params p) {
  using L = Fwd<NT, NB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  float* red = reinterpret_cast<float*>(smem + L::kReds);
  const uint32_t base = sm90::smem_u32(smem);
  const Place at = place_of<NT>(p);
  const int w = wg_of();
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kBars; ++i) sm90::mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    sm90::mbar_expect_tx(&bars[0], NB * kBox);
    load_rows<NB>(smem + L::kQ, kBox, &maps.q, &bars[0], 64 * at.r, at.hh, at.s);
    load_keys<NT, NB>(smem + L::kK, smem + L::kV, maps, bars + 1, at.hh, at.s);
  }
  __syncthreads();
  flash::wait(&bars[0], 0);
  float s[NT][16];
  uint32_t keep[NT];
  probabilities<NT, NB>(s, keep, base + L::kQ, base + L::kK, bars + 1, p, at, red);
  // every warp's products have read K (the softmax's barriers): round(drop(P))
  // takes its place
  store_p<NT>(smem + L::kK, s, keep, p.thresh);
  sm90::fence_proxy_async();
  __syncthreads();
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) flash::wait(&bars[1 + NT + kt], 0);
  // warpgroup w the output's column box w (hd ≤ 64: both warpgroups box 0)
  const int c = NB == 2 ? w : 0;
  float o[32];
  by_keys<NT>(o, base + L::kK, base + L::kV, c);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  if (NB == 2 || w == 0) stage(smem + L::kQ + c * kBox, o);  // Q is spent
  sm90::fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    store_boxes(&maps.out, smem + L::kQ, 0, NB, 64 * at.r, at.hh, at.s);
    flash::tma_store_wait();
  }
}

// ---------------------------------------------------------------- backward

// dP = drop(dA·V_ktᵀ) of key tile kt, this warpgroup's keys (dA: NB boxes of
// 64 rows; V: NB boxes of NT·64 rows, its tile kt landed at vbar), into d
template <int NT, int NB>
__device__ __forceinline__ void dp_tile(float (&d)[16], int kt, uint32_t da, uint32_t v,
                                        uint64_t* vbar, uint32_t keep, const Params& p) {
  flash::wait(vbar, 0);
  zero(d);
  const uint64_t ad = flash::kmajor(da);
  const uint64_t vd = flash::kmajor(v + kt * kBox + wg_of() * 32 * kRowBytes);
  sm90::fence_regs(d);
  sm90::wgmma_fence();
  flash::unroll<0, 4 * NB>([&](auto st_) {
    constexpr int ST = decltype(st_)::value;
    mma<0, 0, (ST / 4) * kBox / 16 + (ST % 4) * 2, (ST / 4) * NT * kBox / 16 + (ST % 4) * 2>(
        d, ad, vd);
  });
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(d);
  if (p.thresh < 256) {
    const Keep drop(p.thresh);
#pragma unroll
    for (int x = 0; x < 16; ++x) d[x] = drop(d[x], keep, x);
  }
}

// 16·N bytes from `off` in the shared memory of the cluster's block `rank`
// to `dst` in this block's, the block's threads 16 bytes each at a time
template <int N>
__device__ __forceinline__ void pull(uint8_t* dst, uint32_t off, int rank) {
  static_assert(N % kThreads == 0, "whole rounds of 16-byte copies");
  uint32_t src;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(src) : "r"(off), "r"(rank));
  constexpr int kPer = N / kThreads;
  uint4 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const uint32_t a = src + 16 * (threadIdx.x + kThreads * i);
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v[i].x), "=r"(v[i].y), "=r"(v[i].z), "=r"(v[i].w)
                 : "r"(a)
                 : "memory");
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    reinterpret_cast<uint4*>(dst)[threadIdx.x + kThreads * i] = v[i];
}

template <int NT, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_kernel(const __grid_constant__ Maps maps, const Params p) {
  using L = Bwd<NT, NB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* slot_bars = bars + 1 + 2 * NT;
  float* red = reinterpret_cast<float*>(smem + L::kReds);
  const uint32_t base = sm90::smem_u32(smem);
  const Place at = place_of<NT>(p);  // r: the cluster's rank
  const int r = at.r, tid = threadIdx.x, w = wg_of();
  // the query tiles whose drop(P) and dS reach this block's keys, in rank
  // order: b0 .. NT − 1 (b0 = r where causal), r's own read in place and the
  // others' (remote m, the m-th of them) through the slots
  const int b0 = p.causal ? r : 0, n_remote = NT - 1 - b0;
  auto remote = [&](int m) { return b0 + m + (b0 + m >= r ? 1 : 0); };
  auto load_slot = [&](int m) {  // another block's Q and dA into slot m % kSlots
    const int b = remote(m), sl = m % L::kSlots;
    uint8_t* dst = smem + L::kK + sl * L::kSlot;
    sm90::mbar_expect_tx(&slot_bars[sl], 2 * NB * kBox);
    load_rows<NB>(dst, kBox, &maps.q, &slot_bars[sl], 64 * b, at.hh, at.s);
    load_rows<NB>(dst + NB * kBox, kBox, &maps.da, &slot_bars[sl], 64 * b, at.hh, at.s);
  };
  if (tid == 0) {
    for (int i = 0; i < L::kBars; ++i) sm90::mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    sm90::mbar_expect_tx(&bars[0], 2 * NB * kBox);
    load_rows<NB>(smem + L::kQ, kBox, &maps.q, &bars[0], 64 * r, at.hh, at.s);
    load_rows<NB>(smem + L::kDA, kBox, &maps.da, &bars[0], 64 * r, at.hh, at.s);
    load_keys<NT, NB>(smem + L::kK, smem + L::kV, maps, bars + 1, at.hh, at.s);
  }
  __syncthreads();
  flash::wait(&bars[0], 0);

  // ---- the block's query rows: P as the forward, round(drop(P)), dP, dS
  {
    float s[NT][16];
    uint32_t keep[NT];
    probabilities<NT, NB>(s, keep, base + L::kQ, base + L::kK, bars + 1, p, at, red);
    store_p<NT>(smem + L::kPD, s, keep, p.thresh);
    float d[NT][16], dot[2] = {0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      dp_tile<NT, NB>(d[kt], kt, base + L::kDA, base + L::kV, &bars[1 + NT + kt], keep[kt], p);
#pragma unroll
      for (int x = 0; x < 16; ++x) dot[(x >> 1) & 1] = fmaf(d[kt][x], s[kt][x], dot[(x >> 1) & 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) dot[h] = quad_sum(dot[h]);
    across<false>(red + 4 * 64, dot);
    // dS = P·(dP − Σ_j dP·P)·scale, rounded
    store_keys<NT>(smem + L::kDS, s, [&](float x, int kt, int i) {
      return x * (d[kt][i] - dot[(i >> 1) & 1]) * p.scale;
    });
  }
  sm90::fence_proxy_async();
  __syncthreads();
  // the output again (as the forward's) and dQ = dS·K: hd past 64, warpgroup
  // w both in column box w; up to 64, warpgroup 0 the output, 1 dQ
  {
    float o[32], dq[32];
    const int c = NB == 2 ? w : 0;
    if (NB == 2 || w == 0) by_keys<NT>(o, base + L::kPD, base + L::kV, c);
    if (NB == 2 || w == 1) by_keys<NT>(dq, base + L::kDS, base + L::kK, c);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(dq);
    __syncthreads();  // K and V are spent
    if (NB == 2 || w == 0) stage(smem + L::kK + c * kBox, o);
    if (NB == 2 || w == 1) stage(smem + L::kV + c * kBox, dq);
    sm90::fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      store_boxes(&maps.out, smem + L::kK, 0, NB, 64 * r, at.hh, at.s);
      store_boxes(&maps.dq, smem + L::kV, 0, NB, 64 * r, at.hh, at.s);
      flash::tma_store_wait();
      for (int m = 0; m < n_remote && m < L::kSlots; ++m) load_slot(m);
    }
  }
  cluster_sync();  // every block's drop(P) and dS are written

  // ---- the block's keys: warpgroup 0 dV = Σ_b drop(P)[b, r]ᵀ·dA_b,
  // warpgroup 1 dK = Σ_b dS[b, r]ᵀ·Q_b; remote m's drop(P) and dS pulled into
  // its slot beside the products of the one before (two slots), its Q and dA
  // by TMA
  auto pull_slot = [&](int m) {
    uint8_t* slot = smem + L::kK + (m % L::kSlots) * L::kSlot;
    pull<kBox / 16>(slot + 2 * NB * kBox, base + L::kPD + r * kBox, remote(m));
    pull<kBox / 16>(slot + (2 * NB + 1) * kBox, base + L::kDS + r * kBox, remote(m));
  };
  if (n_remote > 0) pull_slot(0);
  float acc[32 * NB];
  zero(acc);
  int m = 0;
  for (int b = b0; b < NT; ++b) {
    uint32_t pd, qb;  // this block's keys of block b's drop(P) (dS a box on), its Q (dA NB on)
    if (b == r) {
      pd = base + L::kPD + r * kBox;
      qb = base + L::kQ;
    } else {
      sm90::fence_proxy_async();  // this thread's pulls, to the tensor cores
      __syncthreads();
      const int sl = m % L::kSlots;
      flash::wait(&slot_bars[sl], (m / L::kSlots) & 1);
      qb = base + L::kK + sl * L::kSlot;
      pd = qb + 2 * NB * kBox;
    }
    const uint32_t a = b == r ? (w == 0 ? pd : base + L::kDS + r * kBox) : pd + w * kBox;
    const uint32_t bb = w == 0 ? (b == r ? base + L::kDA : qb + NB * kBox) : qb;
    const uint64_t ad = mn_major(a, kBox), bd = mn_major(bb, kBox);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    flash::unroll<0, 4>([&](auto st_) {
      constexpr int O = decltype(st_)::value * 2048 / 16;
      mma<1, 1, O, O>(acc, ad, bd);
    });
    sm90::wgmma_commit();
    if (b != r && L::kSlots > 1 && m + 1 < n_remote) pull_slot(m + 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (b != r) {
      __syncthreads();  // the slot is read
      if (tid == 0 && m + L::kSlots < n_remote) load_slot(m + L::kSlots);
      if (L::kSlots == 1 && m + 1 < n_remote) pull_slot(m + 1);
      ++m;
    }
  }
  __syncthreads();
  uint8_t* out = smem + (w == 0 ? L::kDA : L::kQ);  // this block's Q and dA are spent
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = acc[32 * c + i];
    stage(out + c * kBox, o);
  }
  sm90::fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    store_boxes(&maps.dv, smem + L::kDA, 0, NB, 64 * r, at.hh, at.s);
    store_boxes(&maps.dk, smem + L::kQ, 0, NB, 64 * r, at.hh, at.s);
    flash::tma_store_wait();
  }
  cluster_sync();  // no block leaves while another reads its tiles
}

// ---------------------------------------------------------------- host side

// a (rows, ·) view of bf16 values, row stride ld (elements), as the 4-D map
// over (hd, T, H, sequences) of a head's columns: boxes of 64 × 64
inline int map_of(CUtensorMap* map, const void* base, int hd, int t, int heads, int nseq, int ld) {
  return flash::make_map<__nv_bfloat16>(map, base, hd, t, heads, nseq, ld, hd,
                                        static_cast<long long>(t) * ld, 64);
}

}  // namespace regs
}  // namespace
