// Kernel #1's flash forward on Hopper (sm_90a): heads up to 128 past T 64.
//
// Counterpart of the Pallas kernel transformergrooveinfilling_tpu/ops/
// attention.py::_mha_kernel where fused_mha.cu's rule sends a long sequence
// here: T > 64, hd ≤ 128, and hd·element size, every (batch, head, token)
// stride and every base pointer a multiple of 16 bytes, no stride 0 (what
// TMA reads). softmax(Q·Kᵀ/√hd, keys after a row's own filled with -1e9 where
// causal)·V per (batch, head), the output a (B, T, H, hd) buffer.
//
// What bounds it on the H100: a (batch, head) is 4·T²·hd FLOP against 4·T·hd
// values, so past T ~300 in bf16 the tensor cores' operations (989 TFLOP/s)
// bound it, below that the bytes (3.35 TB/s); f32 runs in split TF32 (three
// TF32 products a term, 165 TFLOP/s). Beside the products, each score takes
// an ex2 on the special-function units (16 a clock an SM): half the products'
// time at hd 128, so the softmax has to run beside them.
//
// Design. A work item is 64·WG query rows of one (batch, head); a block has
// WG consumer warpgroups of 64 rows and one producer warpgroup, one thread of
// which issues every load by TMA from 4-D tensor maps over (hd, T, H, B) with
// the views' own strides: each item's Q, and its key tiles' K and V into a
// ring of stages under full and empty mbarriers (rows past T and columns past
// hd are TMA's zero fill). Blocks are persistent, at most one an SM, each
// walking items blockIdx.x, + gridDim.x, ..., so that the producer loads the
// next item's tiles beside this item's last products and output stores. Per
// key tile a consumer warpgroup runs S = Q·Kᵀ on wgmma with both operands in
// shared memory (128-byte swizzle, K-major), the online softmax in registers
// (a row's running max and sum shared by the 4 lanes of a quad, as the
// accumulator lays it), and O += P̃·V on wgmma with P̃ from registers. The
// output, divided by Σ at the end, is staged in the warpgroup's own Q rows and
// stored by TMA (rows past T clipped). A causal item stops at its last row's
// key tile and masks only tiles that reach past its first row.
//
//   bf16  A consumer warpgroup issues the next tile's S = Q·Kᵀ before this
//         tile's P̃·V, and runs the softmax while P̃·V is in flight.
//         WG 2: 128 query rows, key tiles of 128 in a two-stage ring, two Q
//         buffers (193 KB). A warpgroup holds O, S and P̃ (64 + 64 + 32
//         registers a thread) at once, past the 168 a thread of 384 threads
//         that the launch bounds give: setmaxnreg moves the producer
//         warpgroup down to 40 and the consumers up to 232 (without it ptxas
//         serialises the products and spills; PERF.md §6, PR 24). The two
//         consumer warpgroups take turns to issue their products (named
//         barriers 3 and 4), so one's softmax runs beside the other's.
//         WG 1, where B·H·⌈T/64⌉ items fill no more than one wave (B 1
//         serving): 64 rows, key tiles of 64 (81 KB, 255 registers).
//         V enters P̃·V through wgmma's transpose bit. P̃ is rounded
//         unnormalised to bf16 (the plain version rounds P; #1's bf16 bar
//         takes it).
//   f32   split TF32 (3xTF32 as in gemm_sm90.cuh: each value x a TF32 high
//         part hi and remainder lo, A_lo·B_hi + A_hi·B_lo + A_hi·B_hi),
//         128 rows and key tiles of 32 (WG 2, 209 KB) or 64 rows and key tiles
//         of 64 (WG 1, the same rule, 225 KB), one stage. .tf32 reads only
//         K-major operands, so the producer warpgroup's warps 1-3 split Q
//         and each K tile in place (hi over the raw values, lo in a plane
//         beside) and split and transpose V into K-major planes, beside the
//         consumers' products; P̃ is split in registers. The register
//         fragment of A pairs columns (t, t + 4) where the score accumulator
//         holds (2t, 2t + 1), so the V planes take the keys of each 8 in the
//         order 0 2 4 6 1 3 5 7. As the short route does, the score sums are
//         promoted every 128 bytes of a row (a fresh accumulator a box) and
//         each key tile's P̃·V is a fresh accumulator added in key order: the
//         tensor cores truncate as they accumulate, and 768 products in one
//         accumulator would drift past f32's 1e-5.
// A rerun is bit for bit in both: every sum has one order.

#pragma once

#include <type_traits>

#include "gemm_sm90.cuh"

namespace {
namespace flash {

using bf16 = __nv_bfloat16;
using sm90::smem_u32;

constexpr int kHd = 128;        // the widest head; every P̃·V product is this wide
constexpr int kRowBytes = 128;  // a box row: the 128-byte swizzle's span
constexpr float kLog2e = 1.4426950408889634f;

template <class E, int WG>
struct Cfg {
  static constexpr bool kF32 = sizeof(E) == 4;
  static constexpr int kElems = kRowBytes / static_cast<int>(sizeof(E));  // a box row's values
  static constexpr int kBoxes = kHd / kElems;                // boxes of the widest head
  static constexpr int kRows = 64 * WG;                      // query rows a work item
  static constexpr int kKeys = WG == 1 ? 64 : kF32 ? 32 : 128;  // keys a tile
  static constexpr int kStages = kF32 ? 1 : 2;
  // two Q buffers: the next item's Q loads during this item's tiles; one (f32):
  // it loads after the first K and V tiles, once this item's output is stored
  static constexpr int kQBufs = WG == 2 && !kF32 ? 2 : 1;
  static constexpr int kThreads = 128 * (WG + 1);
  // bf16, two consumer warpgroups: the registers setmaxnreg moves from the
  // producer warpgroup to them, of the 168 a thread the launch bounds give
  // (65,536 / 384, rounded down to 8)
  static constexpr bool kMoveRegs = WG == 2 && !kF32;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kQBox = kRows * kRowBytes;  // one box of the Q tile
  static constexpr int kKBox = kKeys * kRowBytes;  // one box of a key tile
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kTileBytes = kBoxes * kKBox;
  static constexpr int kPlaneRegion = kHd * kRowBytes;  // f32: 32 keys of V's transposed planes
  static constexpr int kRegions = kKeys / 32;
  // f32: Q and each K stage hold hi in place and lo beside; V's raw stage and
  // its two transposed planes
  static constexpr int kQ = (kF32 ? 2 : 1) * kQBytes;
  static constexpr int kK = (kF32 ? 2 : 1) * kTileBytes;
  static constexpr int kV = kTileBytes;
  static constexpr int kVPlanes = kF32 ? 2 * kTileBytes : 0;
  static constexpr int kKOff = kQBufs * kQ;
  static constexpr int kVOff = kKOff + kStages * kK;
  static constexpr int kPOff = kVOff + kStages * kV;
  static constexpr int kBarOff = kPOff + kVPlanes;
  // Q full and empty a buffer; K full, K empty, V full, V empty a stage; f32:
  // Q, K and V split, and V's planes free
  static constexpr int kBars = 2 * kQBufs + 4 * kStages + (kF32 ? 4 : 0);
  // f32: the producer warpgroup's warps 1-3 split Q, K and V for the consumers
  static constexpr int kSplitters = 96;
  // and slack to align the base to 1,024 bytes, as the swizzle needs
  static constexpr size_t kSmem = static_cast<size_t>(kBarOff) + 8 * kBars + 1024;
  static_assert(kSmem <= 232448, "a block takes at most 232,448 bytes of shared memory");
  static_assert(!kMoveRegs || kProducerRegs * 128 + kConsumerRegs * 128 * WG <= 65536,
                "setmaxnreg stays within the block's registers");
};

// the tensor maps of a launch: q, k and v read, o written, each 4-D over (hd, T, H, B)
struct Maps {
  CUtensorMap q, k, v, o;
};

struct Params {
  int t, heads, hd, n_qb, items, causal;  // items: the (batch, head, query block)s
  float scale, fill;
};

struct Bars {
  uint64_t *qfull, *qempty, *kfull, *kempty, *vfull, *vempty;
  uint64_t *qsplit, *ksplit, *vsplit, *pfree;  // f32
};

// One work item, the j-th of its block: query rows m0 .. of (batch bi, head
// hi), its n_kt key tiles, the block's tiles before it (n0). Its Q buffer is
// j % kQBufs; key tile kt sits in stage (n0 + kt) % kStages.
struct Work {
  int m0, hi, bi, n_kt, j, n0;
};

template <class C>
__device__ __forceinline__ Work work_of(const Params& p, int item, int j, int n0) {
  const int qb = item % p.n_qb, bh = item / p.n_qb;
  Work w{qb * C::kRows, bh % p.heads, bh / p.heads, (p.t + C::kKeys - 1) / C::kKeys, j, n0};
  if (p.causal) w.n_kt = min(w.n_kt, (min(w.m0 + C::kRows, p.t) - 1) / C::kKeys + 1);
  return w;
}

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store4(const CUtensorMap* map, const void* src, int c0, int c1,
                                           int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// a named barrier of `threads` threads (a warpgroup's own, or both consumer
// warpgroups' turns: one syncs, the other arrives)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wait until the phase of `parity` has completed; a wait of seconds is a
// broken pipeline, and traps rather than hangs the card
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, polls = 0;
  uint64_t start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if ((++polls & 1023) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (!start) start = now;
      else if (now - start > 4000000000ull) __trap();
    }
  }
}

// a warpgroup's arrival: its first thread's, once its products are done (a
// warpgroup's wgmma completes as one)
__device__ __forceinline__ void wg_arrive(uint64_t* bar) {
  if ((threadIdx.x & 127) == 0) sm90::mbar_arrive(bar);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// ---------------------------------------------------------------- wgmma

#define FL_D8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FL_D32 FL_D8(0), FL_D8(8), FL_D8(16), FL_D8(24)
#define FL_D64 FL_D32, FL_D8(32), FL_D8(40), FL_D8(48), FL_D8(56)
#define FL_R32                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"               \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define FL_R64                                                                          \
  FL_R32 ","                                                                            \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"     \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// The bf16 products take descriptors and compile-time offsets (16-byte units)
// added in PTX, so that only a base descriptor an operand stays live across a
// product's k steps (the offsets' descriptors, all live at once, cost some
// 40 registers and spilled).

// d (64 × N f32) = A (64 × 16) · B (N × 16)ᵀ (+ d where scale_d), bf16, both
// K-major in shared memory, at da + OA and db + OB
template <int OA, int OB>
__device__ __forceinline__ void ss_bf16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\nsetp.ne.b32 p, %34, 0;\n"
      "add.s64 a, %32, %35;\nadd.s64 b, %33, %36;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" FL_R32
      "}, a, b, p, 1, 1, 0, 0;\n}\n"
      : FL_D32
      : "l"(da), "l"(db), "r"(scale_d), "n"(OA), "n"(OB));
}
template <int OA, int OB>
__device__ __forceinline__ void ss_bf16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\nsetp.ne.b32 p, %66, 0;\n"
      "add.s64 a, %64, %67;\nadd.s64 b, %65, %68;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FL_R64
      "}, a, b, p, 1, 1, 0, 0;\n}\n"
      : FL_D64
      : "l"(da), "l"(db), "r"(scale_d), "n"(OA), "n"(OB));
}

// d (64 × 128 f32) += A (64 × 16, bf16 fragments in registers) · B, B (16 keys × 128) read
// MN-major through the transpose bit, at db + OB
template <int OB>
__device__ __forceinline__ void rs_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 b;\nsetp.ne.b32 p, %69, 0;\n"
      "add.s64 b, %68, %70;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FL_R64
      "}, {%64, %65, %66, %67}, b, p, 1, 1, 1;\n}\n"
      : FL_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(OB));
}

// d (64 × 64 f32) = A (64 × 8, TF32 fragments in registers) · B (64 × 8)ᵀ (+ d where
// scale_d), B K-major
__device__ __forceinline__ void rs_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" FL_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : FL_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#define FL_D16 FL_D8(0), FL_D8(8)
#define FL_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"

// d (64 × 32 f32) = A (64 × 8) · B (32 × 8)ᵀ (+ d where scale_d), TF32, both K-major
__device__ __forceinline__ void ss_tf32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" FL_R16
      "}, %16, %17, p, 1, 1;\n}\n"
      : FL_D16
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void ss_tf32(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  sm90::wgmma_tf32<64>(d, da, db, scale_d);
}

#undef FL_D16
#undef FL_R16
#undef FL_D8
#undef FL_D32
#undef FL_D64
#undef FL_R32
#undef FL_R64

// a K-major operand of 128-byte rows (SBO: 8 rows), at byte address `addr`
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) { return sm90::desc(addr, 1, 1024 >> 4); }

// f(integral_constant<int, I>) for I = I0 .. N − 1: a loop whose index is a constant expression
template <int I, int N, class F>
__device__ __forceinline__ void unroll(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>());
    unroll<I + 1, N>(f);
  }
}

// ---------------------------------------------------------------- the softmax

// One key tile of the online softmax over this thread's accumulator S (64 ×
// N; element i at row row0 + 8·((i / 2) % 2), key key0 + 8·(i / 4) + 2·(lane
// % 4) + i % 2), in place: masked where `edge` (keys ≥ t no weight, keys after
// the row's own `fill` where causal), the running max m and sum l (this
// thread's columns; the quad adds them at the end) taken on, alpha the factor
// the output so far takes, and S replaced by P̃ = exp(S·scale − m). f32 scales
// each score, then takes expf; bf16 keeps the max of the raw scores (the scale
// is positive) and takes 2^(S·scale·log2e − m·scale·log2e), one FFMA and one
// ex2 a score, its fill divided by the scale (any fill below −1e8 of the
// scaled scores gives the weight 0 exactly, as −1e9 does).
template <int N, bool F32>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int key0, int row0, bool edge,
                                               const Params& p) {
  const int c0 = 2 * (threadIdx.x & 3);
  const float fill = F32 ? p.fill : p.fill / p.scale;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int h = (i >> 1) & 1;
    float x = F32 ? s[i] * p.scale : s[i];
    if (edge) {
      const int j = key0 + 8 * (i >> 2) + c0 + (i & 1);
      x = j >= p.t ? -INFINITY : p.causal && j > row0 + 8 * h ? fill : x;
    }
    s[i] = x;
    mx[h] = fmaxf(mx[h], x);
  }
  const float k = F32 ? 1.f : p.scale * kLog2e;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = F32 ? expf(m[h] - mx[h]) : ex2((m[h] - mx[h]) * k);
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
  const float mk[2] = {m[0] * k, m[1] * k};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int h = (i >> 1) & 1;
    const float e = F32 ? expf(s[i] - m[h]) : ex2(fmaf(s[i], k, -mk[h]));
    s[i] = e;
    l[h] += e;
  }
}

// the running sums of this thread's rows added over its quad; the output / Σ
__device__ __forceinline__ void normalise(float (&o)[64], const float (&l)[2]) {
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    inv[h] = 1.f / x;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= inv[(i >> 1) & 1];
}

__device__ __forceinline__ void rescale(float (&o)[64], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// The warpgroup's 64 × 128 output (its fragment) as E into its own rows of
// the Q tile (boxes of kQBox bytes, the rows' 16-byte chunks swizzled), then
// stored by TMA from there: the boxes that hold the head's nb·kElems columns,
// rows row0 .. (those below t)
// (its Q buffer handed back to the producer once the stores have read it)
template <class C, class E>
__device__ __forceinline__ void store_output(const float (&o)[64], uint8_t* q_tile, int nb,
                                             const CUtensorMap* map, int row0, int t, int hi,
                                             int bi, uint64_t* qempty) {
  const int tid = threadIdx.x & 127, w = threadIdx.x >> 7, lane = tid & 31, g = lane >> 2;
  const int t4 = lane & 3, r = 64 * w + 16 * (tid >> 5) + g;
  uint8_t* rows = q_tile + r * kRowBytes;
  bar_sync(1 + w, 128);  // every warp's products have read the warpgroup's Q rows
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j;
    if (c >= nb * C::kElems) break;
    uint8_t* box = rows + (c / C::kElems) * C::kQBox;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x0 = o[4 * j + 2 * h], x1 = o[4 * j + 2 * h + 1];
      uint8_t* row = box + 8 * h * kRowBytes;  // row r + 8h: the same swizzle phase g
      if constexpr (C::kF32) {
        const int chunk = (2 * (j % 4) + (t4 >> 1)) ^ g;
        *reinterpret_cast<float2*>(row + (chunk << 4) + 8 * (t4 & 1)) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(row + (((j % 8) ^ g) << 4) + 4 * t4) = pack_bf16(x0, x1);
      }
    }
  }
  sm90::fence_proxy_async();
  bar_sync(1 + w, 128);
  if (tid == 0) {
    if (row0 < t) {
      for (int c = 0; c < nb; ++c)
        tma_store4(map, q_tile + c * C::kQBox + 64 * w * kRowBytes, c * C::kElems, row0, hi, bi);
      tma_store_wait();
    }
    sm90::mbar_arrive(qempty);
  }
}

// ---------------------------------------------------------------- the producer

// An item's loads: Q, then each key tile's K and V; with one Q buffer (f32)
// Q after the first tile's K and V, which then load beside the last item's
// products and output stores, whose end the Q buffer waits for.
template <class C>
__device__ __forceinline__ void produce(const Maps& maps, uint8_t* smem, const Bars& bars, int nb,
                                        const Work& w) {
  auto load_q = [&]() {
    const int b = w.j % C::kQBufs;
    uint8_t* q = smem + b * C::kQ;
    wait(&bars.qempty[b], ((w.j / C::kQBufs) & 1) ^ 1);
    sm90::mbar_expect_tx(&bars.qfull[b], nb * C::kQBox);
    for (int c = 0; c < nb; ++c)
      tma_load4(q + c * C::kQBox, &maps.q, &bars.qfull[b], c * C::kElems, w.m0, w.hi, w.bi);
  };
  if (C::kQBufs > 1) load_q();
  for (int kt = 0; kt < w.n_kt; ++kt) {
    const int n = w.n0 + kt, s = n % C::kStages;
    const uint32_t ph = ((n / C::kStages) & 1) ^ 1;
    uint8_t* k = smem + C::kKOff + s * C::kK;
    uint8_t* v = smem + C::kVOff + s * C::kV;
    wait(&bars.kempty[s], ph);
    sm90::mbar_expect_tx(&bars.kfull[s], nb * C::kKBox);
    for (int c = 0; c < nb; ++c)
      tma_load4(k + c * C::kKBox, &maps.k, &bars.kfull[s], c * C::kElems, kt * C::kKeys, w.hi,
                w.bi);
    wait(&bars.vempty[s], ph);
    sm90::mbar_expect_tx(&bars.vfull[s], nb * C::kKBox);
    for (int c = 0; c < nb; ++c)
      tma_load4(v + c * C::kKBox, &maps.v, &bars.vfull[s], c * C::kElems, kt * C::kKeys, w.hi,
                w.bi);
    if (C::kQBufs == 1 && kt == 0) load_q();
  }
}

// ---------------------------------------------------------------- bf16 consumers

template <int WG>
__device__ __forceinline__ void consume_bf16(const Maps& maps, uint8_t* smem, const Bars& bars,
                                             int nb, const Work& wk, const Params& p) {
  using C = Cfg<bf16, WG>;
  constexpr int N = C::kKeys, KC = N / 16, S = C::kStages;
  const int tid = threadIdx.x & 127, w = threadIdx.x >> 7, qb = wk.j % C::kQBufs;
  const int n_kt = wk.n_kt, n0 = wk.n0;
  uint64_t *kfull = bars.kfull, *kempty = bars.kempty, *vfull = bars.vfull, *vempty = bars.vempty;
  const int wg_row0 = wk.m0 + 64 * w, row0 = wg_row0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  // the shared memory's address, made opaque at every key tile, so that the
  // compiler does not hoist the products' descriptors (some 40 registers) out
  // of the loop
  uint32_t base = smem_u32(smem);
  float o[64], s[N / 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
  uint32_t pa[KC][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  // S = Q·Kᵀ of the key tile in stage st, and O += P̃·V of the one in stage vt
  // (the k steps of the boxes that hold the head: one box up to hd 64, both
  // past it; a branch per box count, each a straight run of products, so
  // that ptxas keeps them asynchronous)
  auto issue_s = [&](int st) {
    const uint64_t qd = kmajor(base + qb * C::kQ + 64 * w * kRowBytes);
    const uint64_t kd = kmajor(base + C::kKOff + st * C::kK);
    auto steps = [&](auto n) {
      sm90::wgmma_fence();
      unroll<0, decltype(n)::value>([&](auto kk) {
        constexpr int K = decltype(kk)::value, QO = (K / 4) * C::kQBox / 16 + (K % 4) * 2;
        ss_bf16<QO, (K / 4) * C::kKBox / 16 + (K % 4) * 2>(s, qd, kd, K > 0);
      });
      sm90::wgmma_commit();
    };
    if (nb == 1) steps(std::integral_constant<int, kHd / 32>());
    else steps(std::integral_constant<int, kHd / 16>());
  };
  auto issue_pv = [&](int vt) {
    const uint64_t vd = sm90::desc(base + C::kVOff + vt * C::kV, C::kKBox >> 4, 1024 >> 4);
    sm90::wgmma_fence();
    unroll<0, KC>([&](auto kc) {
      constexpr int K = decltype(kc)::value;
      rs_bf16<K * 16 * kRowBytes / 16>(o, pa[K], vd);
    });
    sm90::wgmma_commit();
  };
  auto pack = [&]() {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kc][r] = pack_bf16(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1]);
  };
  // the warpgroup's turn to issue products, and the other's after it
  auto my_turn = [&]() {
    if constexpr (WG == 2) bar_sync(3 + w, 256);
  };
  auto their_turn = [&]() {
    if constexpr (WG == 2) bar_arrive(4 - w, 256);
  };
  // a tile needs masks where it holds keys ≥ t or, causal, keys past the warpgroup's first row
  auto edge = [&](int kt) {
    return (kt + 1) * N > p.t || (p.causal && (kt + 1) * N - 1 > wg_row0);
  };

  wait(&bars.qfull[qb], (wk.j / C::kQBufs) & 1);
  // tile kt sits in stage (n0 + kt) % S, its barriers in phase ((n0 + kt) / S) % 2
  auto stage = [&](int kt) { return (n0 + kt) % S; };
  auto phase = [&](int kt) { return static_cast<uint32_t>(((n0 + kt) / S) & 1); };
  wait(&kfull[stage(0)], phase(0));
  sm90::fence_regs(s);
  my_turn();
  issue_s(stage(0));
  their_turn();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  wg_arrive(&kempty[stage(0)]);
  online_softmax<N, false>(s, m, l, alpha, 0, row0, edge(0), p);
  pack();
  for (int kt = 1; kt < n_kt; ++kt) {
    const int st = stage(kt), vt = stage(kt - 1);
    asm volatile("" : "+r"(base));
    wait(&kfull[st], phase(kt));
    sm90::fence_regs(s);
    sm90::fence_regs(o);
    fence_regs(pa);
    my_turn();
    issue_s(st);
    wait(&vfull[vt], phase(kt - 1));
    issue_pv(vt);
    their_turn();
    sm90::wgmma_wait<1>();  // S is done; P̃·V of the tile before runs on
    sm90::fence_regs(s);
    wg_arrive(&kempty[st]);
    online_softmax<N, false>(s, m, l, alpha, kt * N, row0, edge(kt), p);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    fence_regs(pa);
    wg_arrive(&vempty[vt]);
    rescale(o, alpha);
    pack();
  }
  const int vt = stage(n_kt - 1);
  asm volatile("" : "+r"(base));
  wait(&vfull[vt], phase(n_kt - 1));
  sm90::fence_regs(o);
  fence_regs(pa);
  my_turn();
  issue_pv(vt);
  their_turn();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  fence_regs(pa);
  wg_arrive(&vempty[vt]);
  normalise(o, l);
  store_output<C, bf16>(o, smem + qb * C::kQ, nb, &maps.o, wg_row0, p.t, wk.hi, wk.bi,
                        &bars.qempty[qb]);
}

// ---------------------------------------------------------------- f32 consumers

// n16 16-byte chunks at `raw` split in place: hi over the raw value, lo at
// raw + lo_off, by `threads` threads (t the thread's index among them)
__device__ __forceinline__ void split_in_place(uint8_t* raw, int lo_off, int n16, int t,
                                               int threads) {
  for (int i = t; i < n16; i += threads) {
    const float4 x = reinterpret_cast<const float4*>(raw)[i];  // read before hi overwrites it
    sm90::split4(x, raw + 16 * i, raw + lo_off + 16 * i);
  }
}

// The raw V tile (boxes of 32 columns × 64 key rows) split and transposed into
// K-major planes: region R (keys 32R ..) row n (column n of V) holds its keys
// in the order of P̃'s register fragment (each 8 as 0 2 4 6 1 3 5 7), hi at
// `planes`, lo at planes + lo_off; rows below 32·nb, row n by thread n %
// threads (t the thread's index among them).
template <class C>
__device__ __forceinline__ void split_v(const uint8_t* v, uint8_t* planes, int lo_off, int nb,
                                        int t, int threads) {
  for (int n = t; n < 32 * nb; n += threads) {
  const uint8_t* col = v + (n >> 5) * C::kKBox + ((n & 3) << 2);
  const int chunk = (n & 31) >> 2;
#pragma unroll
  for (int q = 0; q < 8 * C::kRegions; ++q) {  // region q / 8, chunk q % 8 of the row
    const int key0 = 32 * (q >> 3) + 8 * ((q & 7) >> 1) + (q & 1);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 2 * e;
      x[e] = *reinterpret_cast<const float*>(col + key * kRowBytes + ((chunk ^ (key & 7)) << 4));
    }
    const int off = (q >> 3) * C::kPlaneRegion + n * kRowBytes + (((q & 7) ^ (n & 7)) << 4);
    sm90::split4(make_float4(x[0], x[1], x[2], x[3]), planes + off, planes + lo_off + off);
  }
  }
}

// The f32 splitters (the producer warpgroup's warps 1-3, t their index): Q
// once, then each key tile's K in place and V into its planes, beside the
// consumers' products: K as soon as it lands (the consumers released the
// stage after their S = Q·Kᵀ), V once it lands and the consumers' P̃·V of the
// tile before has read the planes (pfree)
template <int WG>
__device__ __forceinline__ void split_f32(uint8_t* smem, const Bars& bars, int nb, const Work& w,
                                          int t) {
  using C = Cfg<float, WG>;
  constexpr int T = C::kSplitters;
  wait(bars.qfull, w.j & 1);
  split_in_place(smem, C::kQBytes, nb * C::kQBox / 16, t, T);
  sm90::fence_proxy_async();
  sm90::mbar_arrive(bars.qsplit);
  for (int kt = 0; kt < w.n_kt; ++kt) {
    const int n = w.n0 + kt;  // the block's tiles so far: each barrier's phase
    wait(bars.kfull, n & 1);
    split_in_place(smem + C::kKOff, C::kTileBytes, nb * C::kKBox / 16, t, T);
    sm90::fence_proxy_async();
    sm90::mbar_arrive(bars.ksplit);
    wait(bars.vfull, n & 1);
    if (n > 0) wait(bars.pfree, (n - 1) & 1);
    split_v<C>(smem + C::kVOff, smem + C::kPOff, C::kTileBytes, nb, t, T);
    sm90::fence_proxy_async();
    sm90::mbar_arrive(bars.vempty);  // the raw V is read: the producer may refill it
    sm90::mbar_arrive(bars.vsplit);
  }
}

// (one Q buffer and one stage: each barrier's phase the parity of the block's
// items or tiles so far). P̃·V runs in halves of 64 columns, one after the
// other: both halves' accumulators at once spilled registers.
template <int WG>
__device__ __forceinline__ void consume_f32(const Maps& maps, uint8_t* smem, const Bars& bars,
                                            int nb, const Work& wk, const Params& p) {
  using C = Cfg<float, WG>;
  static_assert(C::kQBufs == 1 && C::kStages == 1, "one Q buffer, one stage");
  constexpr int N = C::kKeys;
  const int n_kt = wk.n_kt, tid = threadIdx.x & 127, w = threadIdx.x >> 7;
  const int m0 = wk.m0 + 64 * w, row0 = m0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const uint32_t base = smem_u32(smem), qa = base + 64 * w * kRowBytes, pb = base + C::kPOff;
  float o[64], s[N / 2], part[2][N / 2], pv[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) part[0][i] = part[1][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) pv[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

  wait(bars.qsplit, wk.j & 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    wait(bars.ksplit, (wk.n0 + kt) & 1);
    // S = Q·Kᵀ, a fresh accumulator every box (128 bytes of a row) added in
    // order; two accumulators alternate, so a box's products run while the
    // one before is added
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
    auto add_part = [&](float (&x)[N / 2]) {
      sm90::fence_regs(x);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) s[i] += x[i];
    };
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
      float (&x)[N / 2] = part[c & 1];
      if (c < nb) {
        sm90::fence_regs(x);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t a = qa + c * C::kQBox + kk * 32;
          const uint32_t b = base + C::kKOff + c * C::kKBox + kk * 32;
          ss_tf32(x, kmajor(a + C::kQBytes), kmajor(b), kk > 0);
          ss_tf32(x, kmajor(a), kmajor(b + C::kTileBytes), 1);
          ss_tf32(x, kmajor(a), kmajor(b), 1);
        }
        sm90::wgmma_commit();
      }
      if (c >= 1 && c <= nb) {  // box c − 1's products are done
        if (c < nb) sm90::wgmma_wait<1>();
        else sm90::wgmma_wait<0>();
        add_part(part[(c - 1) & 1]);
      }
    }
    if (nb == C::kBoxes) {
      sm90::wgmma_wait<0>();
      add_part(part[(C::kBoxes - 1) & 1]);
    }
    wg_arrive(bars.kempty);
    const bool edge = (kt + 1) * N > p.t || (p.causal && (kt + 1) * N - 1 > m0);
    online_softmax<N, true>(s, m, l, alpha, kt * N, row0, edge, p);
    rescale(o, alpha);
    // P̃ split in registers: the A fragment of keys 8kk .. (columns t, t + 4 hold keys 2t, 2t + 1)
    uint32_t ph[N / 8][4], pl[N / 8][4];
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = s[4 * kk + ((r & 1) << 1) + (r >> 1)], h = sm90::tf32_round(x);
        ph[kk][r] = __float_as_uint(h);
        pl[kk][r] = __float_as_uint(sm90::tf32_round(x - h));
      }
    wait(bars.vsplit, (wk.n0 + kt) & 1);
    // O += P̃·V, a fresh accumulator a key tile and 64 columns
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sm90::fence_regs(pv);
      fence_regs(ph);
      fence_regs(pl);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 8; ++kk) {
        const uint32_t b = pb + (kk / 4) * C::kPlaneRegion + hh * 64 * kRowBytes + (kk % 4) * 32;
        rs_tf32(pv, pl[kk], kmajor(b), kk > 0);
        rs_tf32(pv, ph[kk], kmajor(b + C::kTileBytes), 1);
        rs_tf32(pv, ph[kk], kmajor(b), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(pv);
      fence_regs(ph);
      fence_regs(pl);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[32 * hh + i] += pv[i];
    }
    wg_arrive(bars.pfree);
  }
  normalise(o, l);
  store_output<C, float>(o, smem, nb, &maps.o, m0, p.t, wk.hi, wk.bi, bars.qempty);
}

// ---------------------------------------------------------------- the kernel

// Work item (batch·heads + head)·n_qb + qb is query rows kRows·qb .. of its
// (batch, head); block b takes items b, b + gridDim.x, ... (one, where the
// grid has a block an item)
template <class E, int WG>
__global__ void __launch_bounds__(Cfg<E, WG>::kThreads, 1)
    flash_kernel(const __grid_constant__ Maps maps, const Params p) {
  using C = Cfg<E, WG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bar0 = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* split0 = bar0 + 2 * C::kQBufs + 4 * C::kStages;
  const Bars bars{bar0,
                  bar0 + C::kQBufs,
                  bar0 + 2 * C::kQBufs,
                  bar0 + 2 * C::kQBufs + C::kStages,
                  bar0 + 2 * C::kQBufs + 2 * C::kStages,
                  bar0 + 2 * C::kQBufs + 3 * C::kStages,
                  split0,
                  split0 + 1,
                  split0 + 2,
                  split0 + 3};
  const int nb = (p.hd * static_cast<int>(sizeof(E)) + kRowBytes - 1) / kRowBytes;
  if (threadIdx.x == 0) {
    for (int b = 0; b < C::kQBufs; ++b) {
      sm90::mbar_init(&bars.qfull[b], 1);
      sm90::mbar_init(&bars.qempty[b], WG);
    }
    for (int s = 0; s < C::kStages; ++s) {
      sm90::mbar_init(&bars.kfull[s], 1);
      sm90::mbar_init(&bars.vfull[s], 1);
      sm90::mbar_init(&bars.kempty[s], WG);
      sm90::mbar_init(&bars.vempty[s], C::kF32 ? C::kSplitters : WG);
    }
    if (C::kF32) {
      sm90::mbar_init(bars.qsplit, C::kSplitters);
      sm90::mbar_init(bars.ksplit, C::kSplitters);
      sm90::mbar_init(bars.vsplit, C::kSplitters);
      sm90::mbar_init(bars.pfree, WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the warpgroup's index, broadcast from lane 0 so that the compiler knows
  // it is the same across a warp
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == WG) {  // the producer warpgroup
    if constexpr (C::kMoveRegs) regs_dec<C::kProducerRegs>();
    const int t = threadIdx.x - 128 * WG;
    if (t == 0 || (C::kF32 && t >= 32)) {
      int n0 = 0;
      for (int j = 0, item = blockIdx.x; item < p.items; ++j, item += gridDim.x) {
        const Work w = work_of<C>(p, item, j, n0);
        if (t == 0)
          produce<C>(maps, smem, bars, nb, w);
        else if constexpr (C::kF32)
          split_f32<WG>(smem, bars, nb, w, t - 32);
        n0 += w.n_kt;
      }
    }
  } else {
    if constexpr (C::kMoveRegs) regs_inc<C::kConsumerRegs>();
    if (WG == 2 && !C::kF32 && wg == 1) bar_arrive(3, 256);  // the first warpgroup goes first
    int n0 = 0;
    for (int j = 0, item = blockIdx.x; item < p.items; ++j, item += gridDim.x) {
      const Work w = work_of<C>(p, item, j, n0);
      if constexpr (C::kF32)
        consume_f32<WG>(maps, smem, bars, nb, w, p);
      else
        consume_bf16<WG>(maps, smem, bars, nb, w, p);
      n0 += w.n_kt;
    }
  }
}

// ---------------------------------------------------------------- host side

// a (B, H, T, hd) view's 4-D map over (hd, T, H, B): its token, head and batch
// strides (elements), boxes of kElems columns × box_rows rows. 0, or
// cudaErrorInvalidValue if the driver refuses it.
template <class E>
int make_map(CUtensorMap* map, const void* base, int hd, int t, int heads, int b, long long s_tok,
             long long s_head, long long s_batch, int box_rows) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorInvalidValue);
  constexpr cuuint64_t es = sizeof(E);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_tok) * es,
                                 static_cast<cuuint64_t>(s_head) * es,
                                 static_cast<cuuint64_t>(s_batch) * es};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kRowBytes / sizeof(E)),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, sizeof(E) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash
}  // namespace
