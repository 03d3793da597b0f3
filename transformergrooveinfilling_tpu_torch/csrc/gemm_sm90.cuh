// A bf16 matrix-product core for Hopper (sm_90a): TMA tile loads into a ring
// of shared-memory stages under mbarriers, wgmma on the tensor cores with f32
// accumulators in registers, and an epilogue that the caller supplies.
//
// A unit of work is a (64·WG) × BN tile of C = A·Bᵀ over a range of the
// reduction, and persistent blocks walk the units: in each, WG consumer
// warpgroups of 64 rows issue wgmma.mma_async m64nBNk16 from the stage in
// shared memory, and one more warpgroup, of which one thread works, keeps up
// to kStages tile pairs in flight with cp.async.bulk.tensor (TMA), running on
// into the next unit while the consumers finish this one's epilogue.
//
// A (M × K) and B (N × K) are bf16 in device
// memory, each either K-major (k contiguous: a row-major activation, or a
// weight in nn.Linear's (out, in) layout read as Bᵀ) or MN-major (m or n
// contiguous: a row-major matrix whose rows are the reduction, as in the
// weight gradients Xᵀ·Y); wgmma's transpose bits take either from shared
// memory. Ragged edges are TMA's zero fill: rows and columns past M, N or K
// read as 0, and the epilogue masks its stores.
//
// Shared memory of a stage: the A tile, then the B tile, each a stack of
// 128-byte rows that TMA writes with the 128-byte swizzle and wgmma reads
// through matrix descriptors of the same swizzle (layout type 1):
//   K-major, R rows:  row r (64 k values) at 128·r; 8-row groups 1,024 bytes
//                     apart (SBO 1,024); a k16 step adds 32 bytes to the
//                     start address.
//   MN-major, R cols: R/64 boxes of 64 (mn) × 64 (k), 8,192 bytes each (LBO
//                     8,192: the next 64 mn), k row at 128·k (SBO 1,024: the
//                     next 8 k); a k16 step adds 2,048 bytes.
// Each tile is 1,024-byte aligned, as the swizzle needs.
//
// The accumulator fragment of m64nNk16 (thread t of a warpgroup, warp w =
// t/32, lane l): register 4j + 2h + e holds row 16w + l/4 + 8h, column 8j +
// 2(l%4) + e. The epilogue gets it by quads: (row, col), (row, col+1),
// (row, col+8), (row, col+9) with col = 16g + 2(l%4), so that a 16-column
// group (one dropout draw, layer_common.cuh) is one call.
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

constexpr int kBK = 64;  // reduction a stage: one 128-byte row of bf16
constexpr int kStages = 4;
constexpr int kRowBytes = 128;
constexpr int kBoxBytes = 64 * kRowBytes;  // one 64 × 64 box

template <int WG, int BN>
struct Tile {
  static constexpr int kBM = 64 * WG;
  static constexpr int kThreads = 128 * (WG + 1);
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // stages, their barriers, and slack to align the base to 1,024 bytes
  static constexpr size_t kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
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

// the descriptor of the 64-wide slice `slice` (along m or n) of a tile at its
// k16 step kk
template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(uint32_t tile, int slice, int kk) {
  return MN ? desc(tile + slice * kBoxBytes + kk * 16 * kRowBytes, kBoxBytes >> 4, 1024 >> 4)
            : desc(tile + slice * 64 * kRowBytes + kk * 32, 1, 1024 >> 4);
}

// ---------------------------------------------------------------- wgmma

// d (64 x 64 f32, the fragment layout above) += A (64 x 16) . B (64 x 16)^T
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 128 f32, the fragment layout above) += A (64 x 16) . B (128 x 16)^T
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 256 f32, the fragment layout above) += A (64 x 16) . B (256 x 16)^T
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  static_assert(BN == 64 || BN == 128 || BN == 256, "tiles 64, 128 or 256 columns wide");
  if constexpr (BN == 64) wgmma_n64<TA, TB>(d, da, db);
  else if constexpr (BN == 128) wgmma_n128<TA, TB>(d, da, db);
  else wgmma_n256<TA, TB>(d, da, db);
}

// ---------------------------------------------------------------- the kernel

// The work of one launch: up to kMaxProblems products ("problems") that share
// the reduction length, each cut into tiles (n fastest), times `splits`
// ranges of the reduction, each k_len long (a multiple of kBK when there are
// several). The first `workers` blocks walk the (split, tile) items
// persistently, blockIdx.x, + workers, ...; the producer runs on into the
// next item's stages while the consumers finish the last one's epilogue.
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

template <int BM, int BN>
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
  it.nk = (min(g.k_total, it.k_begin + g.k_len) - it.k_begin + kBK - 1) / kBK;
  return it;
}

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

// Loads of one stage's A or B tile: one box for a K-major operand, rows/64
// boxes side by side for an MN-major one.
template <bool MN, int ROWS>
__device__ __forceinline__ void load_operand(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                             int mn0, int k0) {
  if (MN) {
#pragma unroll
    for (int c = 0; c < ROWS / 64; ++c) tma_load(dst + c * kBoxBytes, map, bar, mn0 + 64 * c, k0);
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
template <int WG, int BN, bool A_MN, bool B_MN, int P, class Epi>
__global__ void __launch_bounds__(Tile<WG, BN>::kThreads, 1)
    gemm_kernel(const __grid_constant__ Maps<P> maps, const Epi epi, const GemmGrid g) {
  using T = Tile<WG, BN>;
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
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * T::kStageBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == WG) {  // the producer warpgroup: one thread issues every load
    if (threadIdx.x == 128 * WG) {
      int n = 0;  // stages filled so far, over all items
      for (int i = blockIdx.x; i < items; i += g.workers) {
        const Item it = item_of<T::kBM, BN>(g, i);
        const CUtensorMap* ma = &maps.a[it.problem];
        const CUtensorMap* mb = &maps.b[it.problem];
        for (int kt = 0; kt < it.nk; ++kt, ++n) {
          const int s = n % kStages;
          mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], T::kStageBytes);
          uint8_t* stage = smem + s * T::kStageBytes;
          const int k0 = it.k_begin + kt * kBK;
          load_operand<A_MN, T::kBM>(stage, ma, &full[s], it.m0, k0);
          load_operand<B_MN, BN>(stage + T::kABytes, mb, &full[s], it.n0, k0);
        }
      }
    }
  } else {  // a consumer warpgroup: rows 64·wg .. of each tile
    if constexpr (WholeTile<Epi>::value) epi.prologue(128 * WG);  // the consumers' own setup
    const uint32_t base = smem_u32(smem);
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    int n = 0;  // stages consumed so far, over all items
    for (int i = blockIdx.x; i < items; i += g.workers) {
      const Item it = item_of<T::kBM, BN>(g, i);
      float acc[BN / 2];
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
      for (int kt = 0; kt < it.nk; ++kt, ++n) {
        const int s = n % kStages;
        mbar_wait(&full[s], (n / kStages) & 1);
        const uint32_t ta = base + s * T::kStageBytes, tb = ta + T::kABytes;
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

// A row-major bf16 matrix of `outer` rows of `inner` values (inner a multiple
// of 8, the base 16-byte aligned) in boxes of box_outer rows of 64 values.
// 0, or cudaErrorInvalidValue if the driver refuses it.
inline int make_map(CUtensorMap* map, const void* base, int inner, int outer, int box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The map of one operand, (rows × k) in device memory: K-major in boxes of
// the tile's rows, MN-major (k rows of `rows` values) in 64 × 64 boxes.
template <bool MN>
int operand_map(CUtensorMap* map, const void* base, int rows, int k, int tile_rows) {
  return MN ? make_map(map, base, rows, k, 64) : make_map(map, base, k, rows, tile_rows);
}

template <int WG, int BN, bool A_MN, bool B_MN, int P, class Epi>
int launch_gemm(const Maps<P>& maps, const Epi& epi, GemmGrid g, cudaStream_t stream) {
  using T = Tile<WG, BN>;
  auto kernel = gemm_kernel<WG, BN, A_MN, B_MN, P, Epi>;
  static int per_sm = 0, sms = 0;  // once per kernel: its blocks an SM, and the SMs
  if (!per_sm) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(T::kSmem));
    int dev = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T::kThreads, T::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  g.workers = min(g.tiles * g.splits, per_sm * sms);
  const int blocks = g.workers + g.extra * g.splits;
  if (blocks == 0) return 0;
  kernel<<<blocks, T::kThreads, T::kSmem, stream>>>(maps, epi, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

// ---------------------------------------------------------------- running a launch

// One operand of a problem: a contiguous bf16 matrix in device memory and its
// extent along m (A) or n (B); the other extent is the launch's reduction.
struct Operand {
  const void* ptr;
  int rows;
};

// Launch `problems` (≤ P) products of one tile shape: A[p] (M × K) and B[p]
// (N × K), each K-major or MN-major as A_MN and B_MN say, over a reduction of
// k_total cut into `splits` ranges of k_len, with extra_blocks Epi::extra
// blocks a split.
template <int WG, int BN, bool A_MN, bool B_MN, int P, class Epi>
int run_tiles(const Operand* a, const Operand* b, int problems, int k_total, int k_len,
              int splits, int extra_blocks, const Epi& epi, cudaStream_t stream) {
  if (problems < 1 || problems > P) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = sm90::bind_context()) return err;
  sm90::Maps<P> maps;
  sm90::GemmGrid g;
  g.start[0] = 0;
  for (int p = 0; p < P; ++p) {
    const int q = p < problems ? p : 0;  // unused maps repeat the first
    if (const int err = sm90::operand_map<A_MN>(&maps.a[p], a[q].ptr, a[q].rows, k_total, 64 * WG))
      return err;
    if (const int err = sm90::operand_map<B_MN>(&maps.b[p], b[q].ptr, b[q].rows, k_total, BN))
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
  return sm90::launch_gemm<WG, BN, A_MN, B_MN, P>(maps, epi, g, stream);
}

// The tile shapes a launch may take, by `config`: 0 is 64 × 64 (one consumer
// warpgroup: several blocks an SM, one's epilogue beside another's products),
// 1 is 128 × 128 and 2 is 128 × 256 (two), 3 is 64 × 256 (one: a whole row of
// up to 256 columns in one tile, for LayerNorm in the epilogue). A product is
// built for the configs whose bits are set in Shapes; another config returns
// cudaErrorInvalidValue and launches nothing.
template <unsigned Shapes, bool A_MN, bool B_MN, int P = 2, class Epi>
int run(int config, const Operand* a, const Operand* b, int problems, int k_total, int k_len,
        int splits, int extra_blocks, const Epi& epi, cudaStream_t stream) {
  if constexpr ((Shapes & 1u) != 0) {
    if (config == 0)
      return run_tiles<1, 64, A_MN, B_MN, P>(a, b, problems, k_total, k_len, splits,
                                             extra_blocks, epi, stream);
  }
  if constexpr ((Shapes & 2u) != 0) {
    if (config == 1)
      return run_tiles<2, 128, A_MN, B_MN, P>(a, b, problems, k_total, k_len, splits,
                                              extra_blocks, epi, stream);
  }
  if constexpr ((Shapes & 4u) != 0) {
    if (config == 2)
      return run_tiles<2, 256, A_MN, B_MN, P>(a, b, problems, k_total, k_len, splits,
                                              extra_blocks, epi, stream);
  }
  if constexpr ((Shapes & 8u) != 0) {
    if (config == 3)
      return run_tiles<1, 256, A_MN, B_MN, P>(a, b, problems, k_total, k_len, splits,
                                              extra_blocks, epi, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the bias at columns col, col + 1, col + 8, col + 9 (0 past the width)
__device__ __forceinline__ float4 bias4(const float* bias, int col, int width) {
  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < width) b.x = bias[col], b.y = bias[col + 1];
  if (col + 8 < width) b.z = bias[col + 8], b.w = bias[col + 9];
  return b;
}

}  // namespace
