// A matrix-product core for Hopper (sm_90a) over bf16 or f32 operands: TMA
// tile loads into a ring of shared-memory stages under mbarriers, wgmma on the
// tensor cores with f32 accumulators in registers, and an epilogue that the
// caller supplies.
//
// A unit of work is a (64·WG) × BN tile of C = A·Bᵀ over a range of the
// reduction, and persistent blocks walk the units: in each, WG consumer
// warpgroups of 64 rows issue wgmma.mma_async from the stage in shared
// memory, and one more warpgroup, of which one thread works, keeps up to
// kStages tile pairs in flight with cp.async.bulk.tensor (TMA), running on
// into the next unit while the consumers finish this one's epilogue.
//
// A (M × K) and B (N × K) lie in device memory, each either K-major (k
// contiguous: a row-major activation, or a weight in nn.Linear's (out, in)
// layout read as Bᵀ) or MN-major (m or n contiguous: a row-major matrix whose
// rows are the reduction, as in the weight gradients Xᵀ·Y). Ragged edges are
// TMA's zero fill: rows and columns past M, N or K read as 0, and the
// epilogue masks its stores.
//
// The operand type T:
//   bf16  wgmma m64nBNk16 .bf16 reads each stage's tiles as TMA wrote them;
//         its transpose bits take an MN-major tile as it is.
//   float split TF32 (3xTF32): each f32 value x is split into a TF32 high
//         part hi = cvt.rna.tf32(x) and a remainder lo = cvt.rna.tf32(x − hi),
//         and each product sums three tensor-core products in the f32
//         accumulators, A_lo·B_hi + A_hi·B_lo + A_hi·B_hi (A_lo·B_lo, ~2⁻²²
//         of the product, is left out; x − hi − lo is ~2⁻²² of x). wgmma's
//         .tf32 forms read only K-major tiles from shared memory and have no
//         transpose bits, so the consumer warpgroups split every stage: they
//         read the raw f32 tile in its layout (K-major or MN-major) and write
//         K-major hi and lo planes with the same 128-byte swizzle, then hand
//         the raw stage back to the producer at once (the producer
//         warpgroup's three idle warps take a share of each split). wgmma m64nBNk8 .tf32
//         reads the planes through the descriptors of a K-major bf16 tile: a
//         128-byte row holds 32 f32 values, and a k8 step is 32 bytes, as a
//         bf16 k16 step. Two plane sets alternate, so the split of the next
//         stage runs while the tensor cores work on this one, beside one or
//         two raw stages (as many as fit).
//         The tensor cores add each product into the accumulator with
//         truncation, so a sum over K drifts by up to K/8 · 3 / 2 units in
//         the last place (768, 4.6e-5 of the sum, at 4,096 rows a split of
//         the weight gradients). An epilogue that sets kPromote (the
//         weight gradients, whose reduction is the rows; the fused FFN's
//         h·W2ᵀ and dh·W1, over ff up to 4,096) has each stage's 12
//         products summed in registers of their own and added to the f32
//         sum with round-to-nearest (32 values of k a stage); the layer
//         chains' other launches reduce over d, 2d, 3d or ff (≤ 2,048),
//         where the drift stays near 1e-5 of the sum or below, and keep the
//         registers.
//
// Shared memory of a stage: the A tile, then the B tile, each a stack of
// 128-byte rows (kBK = 128 / sizeof(T) values of k) that TMA writes with the
// 128-byte swizzle and wgmma reads through matrix descriptors of the same
// swizzle (layout type 1):
//   K-major, R rows:  row r at 128·r; 8-row groups 1,024 bytes apart (SBO
//                     1,024); a k step (k16 bf16, k8 f32) adds 32 bytes to
//                     the start address.
//   MN-major, R cols: R/kBK boxes of kBK (mn) × kBK (k), kBK·128 bytes each
//                     (LBO: the next box), k row at 128·k (SBO 1,024: the
//                     next 8 k); a bf16 k16 step adds 2,048 bytes.
// Each tile and plane is 1,024-byte aligned, as the swizzle needs. An f32
// stage of a 64 × 256 tile is 40 KB, its two plane sets 160 KB (a hi and a lo
// plane of each operand, a set); of a 128 × 128 tile 32 KB and 128 KB.
//
// The accumulator fragment of m64nN (thread t of a warpgroup, warp w = t/32,
// lane l): register 4j + 2h + e holds row 16w + l/4 + 8h, column 8j + 2(l%4)
// + e. The epilogue gets it by quads: (row, col), (row, col+1), (row, col+8),
// (row, col+9) with col = 16g + 2(l%4), so that a 16-column group (one
// dropout draw, layer_common.cuh) is one call.
//
// Tensor maps are made on the host with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint so that no driver library is linked, and
// passed to the kernel by value as __grid_constant__ parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace sm90 {

constexpr int kRowBytes = 128;

// what an operand type changes: the values a 128-byte row holds (the
// reduction a stage covers), and whether the consumers split each stage
template <class T>
struct Elem {
  static constexpr int kBK = kRowBytes / static_cast<int>(sizeof(T));
  static constexpr bool kSplit = sizeof(T) == 4;
  static constexpr int kBoxBytes = kBK * kRowBytes;  // one MN-major kBK × kBK box
};

// Shared memory a block of the f32 split may take for its stages and planes
// (above it the block's static arrays and the alignment slack).
constexpr size_t kSplitBudget = 204800;

template <int WG, int BN, class T>
struct Tile {
  static constexpr int kBM = 64 * WG;
  static constexpr int kThreads = 128 * (WG + 1);
  static constexpr int kConsumers = 128 * WG;
  // threads that split an f32 stage: the consumers and the producer
  // warpgroup's warps 1-3; the threads that hand a stage back
  static constexpr int kSplitters = kConsumers + (Elem<T>::kSplit ? 96 : 0);
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // f32: two sets of planes (the hi and lo planes of both operands a set),
  // and up to two raw stages beside them
  static constexpr int kPlaneBytes = Elem<T>::kSplit ? 2 * kStageBytes : 0;
  static constexpr int kPlaneSets = Elem<T>::kSplit ? 2 : 0;
  static constexpr int kFit = static_cast<int>(
      (kSplitBudget - static_cast<size_t>(kPlaneSets) * kPlaneBytes) / kStageBytes);
  static constexpr int kStages = !Elem<T>::kSplit ? 4 : kFit > 2 ? 2 : kFit;
  // stages, planes, their barriers, and slack to align the base to 1,024 bytes
  static constexpr size_t kSmem = static_cast<size_t>(kStages) * kStageBytes +
                                  static_cast<size_t>(kPlaneSets) * kPlaneBytes +
                                  2 * kStages * 8 + 1024;
  static_assert(kSmem <= 232448, "a block takes at most 232,448 bytes of shared memory");
  static_assert(kStages >= 1, "at least one raw stage beside the planes");
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of `parity` has completed; a wait of tens of millions of
// polls is a broken pipeline, and traps rather than hangs the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one 2-D box of `map` at (inner c0, outer c1) into shared memory, reported to `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// the shared-memory writes of this thread (generic proxy) made visible to
// the tensor cores' reads (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the consumer warpgroups' own barrier, with the f32 split's helpers (the
// producing thread does not take part)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 2, %0;" ::"r"(threads) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// matrix descriptor, 128-byte swizzle: start address, LBO and SBO in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

// the descriptor of the 64-wide slice `slice` (along m or n) of a bf16 tile
// (MN-major: 64 × 64 boxes) or of any K-major tile or plane, at its k step kk
template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(uint32_t tile, int slice, int kk) {
  constexpr int kBox = Elem<__nv_bfloat16>::kBoxBytes;
  return MN ? desc(tile + slice * kBox + kk * 16 * kRowBytes, kBox >> 4, 1024 >> 4)
            : desc(tile + slice * 64 * kRowBytes + kk * 32, 1, 1024 >> 4);
}

// ---------------------------------------------------------------- wgmma

// the accumulator operands of a 64 × N tile, N/2 f32 registers, and their names
#define SM90_D8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_D32 SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24)
#define SM90_D64 SM90_D32, SM90_D8(32), SM90_D8(40), SM90_D8(48), SM90_D8(56)
#define SM90_D128 \
  SM90_D64, SM90_D8(64), SM90_D8(72), SM90_D8(80), SM90_D8(88), SM90_D8(96), SM90_D8(104), \
      SM90_D8(112), SM90_D8(120)
#define SM90_R32                                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define SM90_R64                                                                       \
  SM90_R32 ","                                                                         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"    \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define SM90_R128                                                                              \
  SM90_R64 ","                                                                                 \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"            \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"            \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// d (64 x 64 f32, the fragment layout above) += A (64 x 16) . B (64 x 16)^T, bf16
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SM90_R32
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : SM90_D32
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 128 f32) += A (64 x 16) . B (128 x 16)^T, bf16
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SM90_R64
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : SM90_D64
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 256 f32) += A (64 x 16) . B (256 x 16)^T, bf16
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" SM90_R128
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : SM90_D128
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 64 f32) = A (64 x 8) . B (64 x 8)^T (+ d where scale_d), TF32, both K-major
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" SM90_R32
      "}, %32, %33, p, 1, 1;\n}\n"
      : SM90_D32
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 f32) = A (64 x 8) . B (128 x 8)^T (+ d where scale_d), TF32, both K-major
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" SM90_R64
      "}, %64, %65, p, 1, 1;\n}\n"
      : SM90_D64
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 256 f32) = A (64 x 8) . B (256 x 8)^T (+ d where scale_d), TF32, both K-major
__device__ __forceinline__ void wgmma_tf32_n256(float (&d)[128], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {" SM90_R128
      "}, %128, %129, p, 1, 1;\n}\n"
      : SM90_D128
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef SM90_D8
#undef SM90_D32
#undef SM90_D64
#undef SM90_D128
#undef SM90_R32
#undef SM90_R64
#undef SM90_R128

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  static_assert(BN == 64 || BN == 128 || BN == 256, "tiles 64, 128 or 256 columns wide");
  if constexpr (BN == 64) wgmma_n64<TA, TB>(d, da, db);
  else if constexpr (BN == 128) wgmma_n128<TA, TB>(d, da, db);
  else wgmma_n256<TA, TB>(d, da, db);
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  static_assert(BN == 64 || BN == 128 || BN == 256, "tiles 64, 128 or 256 columns wide");
  if constexpr (BN == 64) wgmma_tf32_n64(d, da, db, scale_d);
  else if constexpr (BN == 128) wgmma_tf32_n128(d, da, db, scale_d);
  else wgmma_tf32_n256(d, da, db, scale_d);
}

// ---------------------------------------------------------------- the f32 split

// x → (hi, lo): hi = x rounded to TF32 (to nearest, ties away from zero),
// lo = (x − hi) rounded likewise
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split4(const float4& v, uint8_t* hi, uint8_t* lo) {
  const float4 h = make_float4(tf32_round(v.x), tf32_round(v.y), tf32_round(v.z), tf32_round(v.w));
  *reinterpret_cast<float4*>(hi) = h;
  *reinterpret_cast<float4*>(lo) = make_float4(tf32_round(v.x - h.x), tf32_round(v.y - h.y),
                                               tf32_round(v.z - h.z), tf32_round(v.w - h.w));
}

// One operand's raw f32 tile of ROWS rows (along m or n) and 32 k, as TMA
// wrote it, into K-major hi and lo planes with TMA's 128-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r % 8)), by the `threads` consumer threads
// (t the thread's index among them), a chunk of 4 k values each step. A
// K-major tile is read at the plane's own offsets, neighbouring threads on
// neighbouring chunks of a row; an MN-major one from its 32 × 32 boxes (k row
// at 128·k), neighbouring threads on neighbouring rows m, so that a warp
// reads one 128-byte box row and writes eight distinct chunks a quarter warp.
template <bool MN, int ROWS>
__device__ __forceinline__ void split_operand(const uint8_t* raw, uint8_t* hi, uint8_t* lo, int t,
                                              int threads) {
  constexpr int kChunks = ROWS * 8;
#pragma unroll 4
  for (int c = t; c < kChunks; c += threads) {
    const int r = MN ? c % ROWS : c >> 3, kc = MN ? c / ROWS : c & 7;
    const int off = r * kRowBytes + ((kc ^ (r & 7)) << 4);
    float4 v;
    if constexpr (MN) {
      const uint8_t* box = raw + (r >> 5) * Elem<float>::kBoxBytes;
      const int m = r & 31;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * kc + e;
        x[e] = *reinterpret_cast<const float*>(box + k * kRowBytes + (((m >> 2) ^ (k & 7)) << 4) +
                                               ((m & 3) << 2));
      }
      v = make_float4(x[0], x[1], x[2], x[3]);
    } else {
      v = *reinterpret_cast<const float4*>(raw + off);
    }
    split4(v, hi + off, lo + off);
  }
}

// Stage m of an f32 launch, by each of the kSplitters threads (t its index
// among them): wait for its raw tiles, split them into the plane set m % 2
// once every consumer warpgroup is done with that set's last products (each
// waits for its own before it syncs), hand the raw stage back, and make the
// planes whole for wgmma.
template <class Tl, bool A_MN, bool B_MN, int BN>
__device__ __forceinline__ void split_stage(uint8_t* smem, uint8_t* planes, uint64_t* full,
                                            uint64_t* empty, int m, int t) {
  const int s = m % Tl::kStages;
  mbar_wait(&full[s], (m / Tl::kStages) & 1);
  consumers_sync(Tl::kSplitters);
  const uint8_t* stage = smem + s * Tl::kStageBytes;
  uint8_t* set = planes + (m & 1) * Tl::kPlaneBytes;  // A hi, A lo, B hi, B lo
  split_operand<A_MN, Tl::kBM>(stage, set, set + Tl::kABytes, t, Tl::kSplitters);
  split_operand<B_MN, BN>(stage + Tl::kABytes, set + 2 * Tl::kABytes,
                          set + 2 * Tl::kABytes + Tl::kBBytes, t, Tl::kSplitters);
  fence_proxy_async();
  mbar_arrive(&empty[s]);  // the raw stage is read: the producer may refill it
  consumers_sync(Tl::kSplitters);
}

// d = (fresh ? 0 : d) + the stage's A·Bᵀ from a plane set at shared address
// `set`, this warpgroup's 64 rows, as A_lo·B_hi + A_hi·B_lo + A_hi·B_hi at
// each k8 step
template <class Tl, int BN>
__device__ __forceinline__ void split_products(float (&d)[BN / 2], uint32_t set, int wg,
                                               bool fresh) {
  const uint32_t pb = set + 2 * Tl::kABytes;
#pragma unroll
  for (int kk = 0; kk < Elem<float>::kBK / 8; ++kk) {
    const uint64_t a_hi = operand_desc<false>(set, wg, kk);
    const uint64_t a_lo = operand_desc<false>(set + Tl::kABytes, wg, kk);
    const uint64_t b_hi = operand_desc<false>(pb, 0, kk);
    const uint64_t b_lo = operand_desc<false>(pb + Tl::kBBytes, 0, kk);
    wgmma_tf32<BN>(d, a_lo, b_hi, fresh && kk == 0 ? 0 : 1);
    wgmma_tf32<BN>(d, a_hi, b_lo, 1);
    wgmma_tf32<BN>(d, a_hi, b_hi, 1);
  }
}

// ---------------------------------------------------------------- the kernel

// The work of one launch: up to kMaxProblems products ("problems") that share
// the reduction length, each cut into tiles (n fastest), times `splits`
// ranges of the reduction, each k_len long (a multiple of the stage's kBK
// when there are several). The first `workers` blocks walk the (split, tile)
// items persistently, blockIdx.x, + workers, ...; the producer runs on into
// the next item's stages while the consumers finish the last one's epilogue.
// Blocks past them are the epilogue's own, `extra` a split, run by all the
// block's threads (Epi::extra), e.g. column sums that need no product.
constexpr int kMaxProblems = 8;

struct GemmGrid {
  int n_tiles[kMaxProblems];    // tiles along n of each problem
  int start[kMaxProblems + 1];  // first tile of each problem; start[problems] = tiles
  int problems;
  int tiles;    // tiles of all problems
  int splits;   // ranges of the reduction
  int k_len;    // reduction a split
  int k_total;  // reduction length
  int workers;  // blocks that walk the tiles
  int extra;    // Epi::extra blocks a split
};

// the tensor maps of a launch's operands, problem by problem
template <int P>
struct Maps {
  CUtensorMap a[P], b[P];
};

struct Item {
  int problem, split, m0, n0, k_begin, nk;
};

template <int BM, int BN, int BK>
__device__ __forceinline__ Item item_of(const GemmGrid& g, int i) {
  Item it;
  it.split = i / g.tiles;
  const int t = i - it.split * g.tiles;
  it.problem = 0;
  while (it.problem + 1 < g.problems && t >= g.start[it.problem + 1]) ++it.problem;
  const int tp = t - g.start[it.problem];
  it.m0 = (tp / g.n_tiles[it.problem]) * BM;
  it.n0 = (tp % g.n_tiles[it.problem]) * BN;
  it.k_begin = it.split * g.k_len;
  it.nk = (min(g.k_total, it.k_begin + g.k_len) - it.k_begin + BK - 1) / BK;
  return it;
}

// An f32 launch whose epilogue defines kPromote = true sums each stage's
// products in registers of their own before they join the accumulator.
template <class E, class = void>
struct Promote {
  static constexpr bool value = false;
};
template <class E>
struct Promote<E, decltype(void(E::kPromote))> {
  static constexpr bool value = E::kPromote;
};

// An epilogue that defines kWholeTile = true gets the tile's whole
// accumulator at once, tile<BN>(problem, split, row, col, acc), in place of
// load() and store() by quads: a row's columns of one tile sit in the four
// threads of a lane quad, so a row sum is the thread's own sum and two
// shuffles (LayerNorm in the epilogue, where BN spans the row). Its
// prologue(threads) runs once in the consumer warpgroups before their first
// tile (threadIdx.x < threads; they may sync by named barrier 1).
template <class E, class = void>
struct WholeTile {
  static constexpr bool value = false;
};
template <class E>
struct WholeTile<E, decltype(void(E::kWholeTile))> {
  static constexpr bool value = E::kWholeTile;
};

// Loads of one stage's A or B tile: one box for a K-major operand, rows/kBK
// boxes side by side for an MN-major one.
template <bool MN, int ROWS, class T>
__device__ __forceinline__ void load_operand(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                             int mn0, int k0) {
  constexpr int kBK = Elem<T>::kBK;
  if (MN) {
#pragma unroll
    for (int c = 0; c < ROWS / kBK; ++c)
      tma_load(dst + c * Elem<T>::kBoxBytes, map, bar, mn0 + kBK * c, k0);
  } else {
    tma_load(dst, map, bar, k0, mn0);
  }
}

// Epi, its members all inlined:
//   load(problem, split, row, col, Aux (&aux)[BN / 16][2]): what store()
//     reads besides the accumulator, aux[g][h] for the quad at (row + 8h,
//     col + 16g), all of it fetched before the first store so that the
//     loads of a tile overlap (a whole warp calls it);
//   store(problem, split, row, col, v, aux) for v at (row, col), (row,
//     col+1), (row, col+8), (row, col+9), unmasked (rows and columns past
//     the problem are the epilogue's to drop);
//   extra(block, split, k_begin, k_end).
template <int WG, int BN, bool A_MN, bool B_MN, int P, class T, class Epi>
__global__ void __launch_bounds__(Tile<WG, BN, T>::kThreads, 1)
    gemm_kernel(const __grid_constant__ Maps<P> maps, const Epi epi, const GemmGrid g) {
  using Tl = Tile<WG, BN, T>;
  constexpr int kBK = Elem<T>::kBK;
  constexpr int kStages = Tl::kStages;
  if (static_cast<int>(blockIdx.x) >= g.workers) {
    const int b = blockIdx.x - g.workers, split = b / g.extra;
    const int k_begin = split * g.k_len;
    epi.extra(b - split * g.extra, split, k_begin, min(g.k_total, k_begin + g.k_len));
    return;
  }
  const int items = g.tiles * g.splits;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* planes = smem + kStages * Tl::kStageBytes;  // f32: the split's plane sets
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + Tl::kPlaneSets * Tl::kPlaneBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Tl::kSplitters);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == WG) {  // the producer warpgroup: one thread issues every load
    if constexpr (Elem<T>::kSplit) {
      if (threadIdx.x >= 128 * WG + 32) {  // warps 1-3 split a share of every stage
        int n = 0;
        for (int i = blockIdx.x; i < items; i += g.workers) {
          const Item it = item_of<Tl::kBM, BN, kBK>(g, i);
          for (int kt = 0; kt < it.nk; ++kt, ++n)
            split_stage<Tl, A_MN, B_MN, BN>(smem, planes, full, empty, n, threadIdx.x - 32);
        }
      }
    }
    if (threadIdx.x == 128 * WG) {
      int n = 0;  // stages filled so far, over all items
      for (int i = blockIdx.x; i < items; i += g.workers) {
        const Item it = item_of<Tl::kBM, BN, kBK>(g, i);
        const CUtensorMap* ma = &maps.a[it.problem];
        const CUtensorMap* mb = &maps.b[it.problem];
        for (int kt = 0; kt < it.nk; ++kt, ++n) {
          const int s = n % kStages;
          mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], Tl::kStageBytes);
          uint8_t* stage = smem + s * Tl::kStageBytes;
          const int k0 = it.k_begin + kt * kBK;
          load_operand<A_MN, Tl::kBM, T>(stage, ma, &full[s], it.m0, k0);
          load_operand<B_MN, BN, T>(stage + Tl::kABytes, mb, &full[s], it.n0, k0);
        }
      }
    }
  } else {  // a consumer warpgroup: rows 64·wg .. of each tile
    if constexpr (WholeTile<Epi>::value) epi.prologue(128 * WG);  // the consumers' own setup
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    int n = 0;  // stages consumed so far, over all items
    for (int i = blockIdx.x; i < items; i += g.workers) {
      const Item it = item_of<Tl::kBM, BN, kBK>(g, i);
      float acc[BN / 2];
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
      if constexpr (Elem<T>::kSplit) {
        constexpr bool kPromote = Promote<Epi>::value;
        // the stage's products before they join acc (kPromote), else unused
        float part[kPromote ? BN / 2 : 1];
#pragma unroll
        for (int r = 0; r < (kPromote ? BN / 2 : 1); ++r) part[r] = 0.f;
        if (it.nk > 0) split_stage<Tl, A_MN, B_MN, BN>(smem, planes, full, empty, n, threadIdx.x);
        for (int kt = 0; kt < it.nk; ++kt, ++n) {
          const uint32_t set = smem_u32(planes + (n & 1) * Tl::kPlaneBytes);
          fence_regs(acc);
          fence_regs(part);
          wgmma_fence();
          if constexpr (kPromote) split_products<Tl, BN>(part, set, wg, true);
          else split_products<Tl, BN>(acc, set, wg, false);
          wgmma_commit();
          fence_regs(acc);
          fence_regs(part);
          // the next stage's split into the other plane set, beside the products
          if (kt + 1 < it.nk)
            split_stage<Tl, A_MN, B_MN, BN>(smem, planes, full, empty, n + 1, threadIdx.x);
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(part);
          if constexpr (kPromote) {
#pragma unroll
            for (int r = 0; r < BN / 2; ++r) acc[r] += part[r];
          }
        }
      } else {
        for (int kt = 0; kt < it.nk; ++kt, ++n) {
          const int s = n % kStages;
          mbar_wait(&full[s], (n / kStages) & 1);
          const uint32_t ta = smem_u32(smem) + s * Tl::kStageBytes, tb = ta + Tl::kABytes;
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma<BN, A_MN, B_MN>(acc, operand_desc<A_MN>(ta, wg, kk),
                                  operand_desc<B_MN>(tb, 0, kk));
          wgmma_commit();
          fence_regs(acc);
          // the products of the stage before have finished: hand it back
          wgmma_wait<1>();
          if (kt > 0) mbar_arrive(&empty[(n - 1) % kStages]);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (it.nk > 0) mbar_arrive(&empty[(n - 1) % kStages]);
      }

      const int row = it.m0 + 64 * wg + 16 * warp + (lane >> 2), col = it.n0 + 2 * (lane & 3);
      if constexpr (WholeTile<Epi>::value) {
        epi.template tile<BN>(it.problem, it.split, row, col, acc);
      } else {
        typename Epi::Aux aux[BN / 16][2];
        epi.load(it.problem, it.split, row, col, aux);
#pragma unroll
        for (int q = 0; q < BN / 16; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v[4] = {acc[8 * q + 2 * h], acc[8 * q + 2 * h + 1],
                                acc[8 * q + 4 + 2 * h], acc[8 * q + 5 + 2 * h]};
            epi.store(it.problem, it.split, row + 8 * h, col + 16 * q, v, aux[q][h]);
          }
      }
    }
  }
}

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// cuTensorMapEncodeTiled is a driver call: it needs the thread's context
// current, which a runtime call on a fresh thread (an autograd worker, say)
// would have bound lazily. cudaSetDevice binds it now.
inline int bind_context() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  return static_cast<int>(err);
}

// A row-major matrix of T, `outer` rows of `inner` values (inner·sizeof(T) a
// multiple of 16, the base 16-byte aligned), in boxes of box_outer rows of
// kBK values (128 bytes). 0, or cudaErrorInvalidValue if the driver refuses it.
template <class T>
int make_map(CUtensorMap* map, const void* base, int inner, int outer, int box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(Elem<T>::kBK),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map,
                            Elem<T>::kSplit ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            2, const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The map of one operand, (rows × k) in device memory: K-major in boxes of
// the tile's rows, MN-major (k rows of `rows` values) in kBK × kBK boxes.
template <bool MN, class T>
int operand_map(CUtensorMap* map, const void* base, int rows, int k, int tile_rows) {
  return MN ? make_map<T>(map, base, rows, k, Elem<T>::kBK)
            : make_map<T>(map, base, k, rows, tile_rows);
}

template <int WG, int BN, bool A_MN, bool B_MN, int P, class T, class Epi>
int launch_gemm(const Maps<P>& maps, const Epi& epi, GemmGrid g, cudaStream_t stream) {
  using Tl = Tile<WG, BN, T>;
  auto kernel = gemm_kernel<WG, BN, A_MN, B_MN, P, T, Epi>;
  static int per_sm = 0, sms = 0;  // once per kernel: its blocks an SM, and the SMs
  if (!per_sm) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(Tl::kSmem));
    int dev = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Tl::kThreads, Tl::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  g.workers = min(g.tiles * g.splits, per_sm * sms);
  const int blocks = g.workers + g.extra * g.splits;
  if (blocks == 0) return 0;
  kernel<<<blocks, Tl::kThreads, Tl::kSmem, stream>>>(maps, epi, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

// ---------------------------------------------------------------- running a launch

// One operand of a problem: a contiguous matrix of the launch's operand type
// in device memory and its extent along m (A) or n (B); the other extent is
// the launch's reduction.
struct Operand {
  const void* ptr;
  int rows;
};

// Launch `problems` (≤ P) products of one tile shape: A[p] (M × K) and B[p]
// (N × K) of T, each K-major or MN-major as A_MN and B_MN say, over a
// reduction of k_total cut into `splits` ranges of k_len, with extra_blocks
// Epi::extra blocks a split.
template <int WG, int BN, bool A_MN, bool B_MN, int P, class T, class Epi>
int run_tiles(const Operand* a, const Operand* b, int problems, int k_total, int k_len,
              int splits, int extra_blocks, const Epi& epi, cudaStream_t stream) {
  if (problems < 1 || problems > P) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = sm90::bind_context()) return err;
  sm90::Maps<P> maps;
  sm90::GemmGrid g;
  g.start[0] = 0;
  for (int p = 0; p < P; ++p) {
    const int q = p < problems ? p : 0;  // unused maps repeat the first
    if (const int err =
            sm90::operand_map<A_MN, T>(&maps.a[p], a[q].ptr, a[q].rows, k_total, 64 * WG))
      return err;
    if (const int err = sm90::operand_map<B_MN, T>(&maps.b[p], b[q].ptr, b[q].rows, k_total, BN))
      return err;
    if (p < problems) {
      g.n_tiles[p] = (b[p].rows + BN - 1) / BN;
      g.start[p + 1] = g.start[p] + (a[p].rows + 64 * WG - 1) / (64 * WG) * g.n_tiles[p];
    }
  }
  g.problems = problems;
  g.tiles = g.start[problems];
  g.splits = splits;
  g.k_len = k_len;
  g.k_total = k_total;
  g.extra = extra_blocks;
  return sm90::launch_gemm<WG, BN, A_MN, B_MN, P, T>(maps, epi, g, stream);
}

// The tile shapes a launch may take, by `config`: 0 is 64 × 64 (one consumer
// warpgroup: several blocks an SM, one's epilogue beside another's products),
// 1 is 128 × 128 and 2 is 128 × 256 (two), 3 is 64 × 256 (one: a whole row of
// up to 256 columns in one tile, for LayerNorm in the epilogue). A product is
// built for the configs whose bits are set in Shapes; another config returns
// cudaErrorInvalidValue and launches nothing. T is the operands' type, bf16
// or float (split TF32; not config 2, whose planes would not fit).
template <unsigned Shapes, bool A_MN, bool B_MN, int P = 2, class T = __nv_bfloat16, class Epi>
int run(int config, const Operand* a, const Operand* b, int problems, int k_total, int k_len,
        int splits, int extra_blocks, const Epi& epi, cudaStream_t stream) {
  if constexpr ((Shapes & 1u) != 0) {
    if (config == 0)
      return run_tiles<1, 64, A_MN, B_MN, P, T>(a, b, problems, k_total, k_len, splits,
                                                extra_blocks, epi, stream);
  }
  if constexpr ((Shapes & 2u) != 0) {
    if (config == 1)
      return run_tiles<2, 128, A_MN, B_MN, P, T>(a, b, problems, k_total, k_len, splits,
                                                 extra_blocks, epi, stream);
  }
  if constexpr ((Shapes & 4u) != 0) {
    if (config == 2)
      return run_tiles<2, 256, A_MN, B_MN, P, T>(a, b, problems, k_total, k_len, splits,
                                                 extra_blocks, epi, stream);
  }
  if constexpr ((Shapes & 8u) != 0) {
    if (config == 3)
      return run_tiles<1, 256, A_MN, B_MN, P, T>(a, b, problems, k_total, k_len, splits,
                                                 extra_blocks, epi, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class T>
struct Type {
  using type = T;
};

// fn(Type<float>{}) where `f32`, else fn(Type<bf16>{}): one C entry point a
// launch type, its activations and weights f32 or bf16
template <class F>
int by_type(int f32, F&& fn) {
  return f32 ? fn(Type<float>{}) : fn(Type<__nv_bfloat16>{});
}

template <class T>
T* as(void* p) {
  return static_cast<T*>(p);
}

// ---------------------------------------------------------------- epilogue helpers

// Epi's members (gemm_kernel): load() fetches what store() reads besides the
// accumulator, for a whole tile before its first store; store() gets the
// values at (row, col), (row, col+1), (row, col+8), (row, col+9), col even.
struct NoAux {};
struct NoExtra {
  __device__ __forceinline__ void extra(int, int, int, int) const {}
};

// the tile's aux by load_one(problem, split, row, col) of each quad
template <class Epi, int G>
__device__ __forceinline__ void load_quads(const Epi& epi, int problem, int split, int row,
                                           int col, typename Epi::Aux (&aux)[G][2]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h) aux[g][h] = epi.load_one(problem, split, row + 8 * h, col + 16 * g);
}

// a pair of activations stored: rounded to bf16, or f32 as it is
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// a pair of activations as loaded (a bf16 pair's 32 bits, an f32 pair), and
// as two floats
template <class T>
struct Pair {
  using type = float2;
};
template <>
struct Pair<__nv_bfloat16> {
  using type = uint32_t;
};
template <class T>
__device__ __forceinline__ typename Pair<T>::type load_pair(const T* p) {
  return *reinterpret_cast<const typename Pair<T>::type*>(p);
}
__device__ __forceinline__ float2 unpack(uint32_t bits) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bits));
}
__device__ __forceinline__ float2 unpack(float2 v) { return v; }

// the bias at columns col, col + 1, col + 8, col + 9 (0 past the width)
__device__ __forceinline__ float4 bias4(const float* bias, int col, int width) {
  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < width) b.x = bias[col], b.y = bias[col + 1];
  if (col + 8 < width) b.z = bias[col + 8], b.w = bias[col + 9];
  return b;
}

}  // namespace
