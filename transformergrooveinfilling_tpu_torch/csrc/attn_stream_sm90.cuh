// Streamed-head attention on Hopper (sm_90a): the device code that kernel #1
// (fused_mha.cu) and the whole-layer chains' attention launches
// (layer_sm90.cu) share.
//
// The shape of the work. A (sequence, head) is T ≤ 64 query rows against T
// keys: the (T × T) scores are tiny, the head's width hd is not (1,024 for a
// d 1,024 model with one head). So a block takes one (sequence, head) with
// all its query rows, one warp for every 16 of them, and keeps each warp's
// (16 × T) scores, probabilities and (backward) score gradients in registers
// for the whole head, while the head's columns stream past: Q and K (then
// V; backward Q, K, V and dA twice) arrive in chunks of CW columns through a
// ring of S shared-memory stages that cp.async fills S − 1 chunks ahead of
// the one being multiplied. A block's shared memory is the ring's, whatever
// hd is, so several blocks share an SM at any width, and each of Q, K and V
// crosses device memory once in the forward. A block walks its head's
// chunks in turn, so a wide head at a small batch is split over a cluster of
// blocks (fused_mha.cu), each walking its share of the columns.
//
// Products. bf16: mma.sync m16n8k16 bf16 → f32 on ldmatrix fragments, rows
// of the stages padded by 16 bytes (8 rows read at one column fall in 8
// different bank groups). f32: split TF32 (3xTF32: each operand a TF32 high
// part and a TF32 remainder, lo·hi + hi·lo + hi·hi on mma.sync m16n8k8 into
// f32 accumulators, within ~2⁻²² of each f32 term), fragments read by scalar
// loads from rows whose stride is 4 mod 8 floats. The tensor cores truncate
// as they accumulate, so each chunk's score products go into fresh
// accumulators that are then added to the running sums in chunk order: a
// sum over hd 1,024 in one accumulator would drift past f32's 1e-5, a chunk
// of 32 or 64 does not, and a rerun is bit for bit. Columns past hd and rows
// past T are zero in the stages, so they add nothing; outputs past them are
// not stored.
//
// Copies. Rows arrive by cp.async in copies of 16, 8 or 4 bytes (the widest
// that every source's rows, pointers and hd allow), or, for bf16 rows that
// allow none of them, by element loads and stores (no overlap, the same
// results).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

namespace {
namespace attn {

using bf16 = __nv_bfloat16;

constexpr int kMaxKt = 4;  // 16-row tiles of T: T ≤ 64

// a stage row of CW columns: bf16 rows padded by 8 values (16 bytes), f32
// rows by 4 (a stride of 4 mod 8 floats)
template <class E, int CW>
__host__ __device__ constexpr int stage_ld() {
  return sizeof(E) == 2 ? CW + 8 : CW + 4;
}

// ---------------------------------------------------------------- primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (16, 8 or 4) global → shared; zero-filled (nothing read) when !valid
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a·b, m16n8k16, bf16 inputs, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b, m16n8k8, TF32 inputs, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// f32 rounded to TF32 (10 mantissa bits), to nearest, ties away
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
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
    const float x = TRANS ? m[c * ld + r] : m[r * ld + c], h = tf32_round(x);
    a.hi[e] = __float_as_uint(h);
    a.lo[e] = __float_as_uint(tf32_round(x - h));
  }
  return a;
}

// d += a·b of an m16n8k8 step in split TF32, b the f32 B fragment (b0 (k t,
// n g), b1 (k t + 4, n g)); the small terms first
__device__ __forceinline__ void mma_x3(float (&d)[4], const SplitA& a, float b0, float b1) {
  const float bh0 = tf32_round(b0), bh1 = tf32_round(b1);
  mma_tf32(d, a.lo, __float_as_uint(bh0), __float_as_uint(bh1));
  mma_tf32(d, a.hi, __float_as_uint(tf32_round(b0 - bh0)), __float_as_uint(tf32_round(b1 - bh1)));
  mma_tf32(d, a.hi, __float_as_uint(bh0), __float_as_uint(bh1));
}

// ---------------------------------------------------------------- operands

// a head's rows in device memory: row 0, column 0, and the elements between rows
template <class E>
struct Rows {
  const E* p;
  long long ld;
};

// An output head: rows [0, rows) and columns [0, cols) of p. A warp writes
// its 16 rows of a chunk from a staging tile in shared memory, 16 bytes a
// lane where every row allows it (a lane's 16 bytes, a warp's 512: whole
// 128-byte lines), else value by value: the mma fragments stored directly
// are 4 bytes a lane, 16 bytes of a row a quad, half-filled sectors that
// slowed the whole forward at large batches.
template <class E>
struct Out {
  static constexpr int kVec = 16 / sizeof(E);  // values of a 16-byte store
  E* p;
  long long ld;
  int rows, cols;
  bool vec;

  __device__ __forceinline__ Out(E* p_, long long ld_, int rows_, int cols_)
      : p(p_), ld(ld_), rows(rows_), cols(cols_),
        vec(reinterpret_cast<uintptr_t>(p_) % 16 == 0 && (ld_ * sizeof(E)) % 16 == 0 &&
            cols_ % kVec == 0) {}

  // this warp's rows row0 .. row0 + 15, columns c0 .. c0 + CW, from the
  // staging tile `wt` (16 rows of stage_ld<E, CW>() values); the warp's lanes
  template <int CW, int TLD>
  __device__ __forceinline__ void store(const E* wt, int row0, int c0) const {
    const int lane = threadIdx.x & 31;
    if (vec) {
      constexpr int kPieces = CW / kVec;
#pragma unroll
      for (int idx = lane; idx < 16 * kPieces; idx += 32) {
        const int r = idx / kPieces, c = kVec * (idx - r * kPieces);
        if (row0 + r < rows && c0 + c < cols)
          *reinterpret_cast<uint4*>(p + (row0 + r) * ld + c0 + c) =
              *reinterpret_cast<const uint4*>(wt + r * TLD + c);
      }
      return;
    }
    for (int idx = lane; idx < 16 * CW; idx += 32) {
      const int r = idx / CW, c = idx - r * CW;
      if (row0 + r < rows && c0 + c < cols) p[(row0 + r) * ld + c0 + c] = wt[r * TLD + c];
    }
  }
};

// ---------------------------------------------------------------- the ring

// Columns cols[n] .. cols[n] + CW of rows [0, R) of each of N sources into
// consecutive (R, stage_ld) tiles at dst, rows ≥ t and columns ≥ hd (the
// columns' bound) zero, in copies of BYTES; a copy's values all lie below hd
// or all past it (hd a multiple of a copy's values). The block's threads
// share the copies.
template <int BYTES, class E, int CW, int R, int N>
__device__ __forceinline__ void load_by(E* dst, const Rows<E> (&src)[N], const int (&cols)[N],
                                        int t, int hd) {
  constexpr int kLd = stage_ld<E, CW>(), kPer = BYTES / sizeof(E), kRow = CW / kPer;
  constexpr int kTotal = N * R * kRow;
  for (int idx = threadIdx.x; idx < kTotal; idx += blockDim.x) {
    const int n = idx / (R * kRow), rem = idx - n * (R * kRow);
    const int r = rem / kRow, c = kPer * (rem - r * kRow);
    const int col = cols[n] + c;
    const bool valid = r < t && col < hd;
    E* d = dst + (n * R + r) * kLd + c;
    const E* s = valid ? src[n].p + r * src[n].ld + col : src[n].p;
    if constexpr (BYTES >= 4)
      cp_async<BYTES>(d, s, valid);
    else
      *d = valid ? *s : __float2bfloat16(0.f);  // bf16 element by element
  }
}

template <class E, int CW, int R, int N>
__device__ __forceinline__ void load_chunk(E* dst, const Rows<E> (&src)[N], const int (&cols)[N],
                                           int t, int hd, int copy) {
  if (copy == 16)
    load_by<16, E, CW, R, N>(dst, src, cols, t, hd);
  else if (copy == 8)
    load_by<8, E, CW, R, N>(dst, src, cols, t, hd);
  else if constexpr (sizeof(E) == 2) {
    if (copy == 4)
      load_by<4, E, CW, R, N>(dst, src, cols, t, hd);
    else
      load_by<2, E, CW, R, N>(dst, src, cols, t, hd);
  } else {
    load_by<4, E, CW, R, N>(dst, src, cols, t, hd);
  }
}

// S stages of N (R, stage_ld) tiles each
template <class E, int CW, int R, int N, int S>
struct Ring {
  static constexpr int kLd = stage_ld<E, CW>();
  static constexpr int kStage = N * R * kLd;  // elements
  static constexpr size_t kBytes = sizeof(E) * S * kStage;
  E* base;

  __device__ __forceinline__ E* tile(int step, int n) const {
    return base + (step % S) * kStage + n * R * kLd;
  }
};

// steps 0 .. steps − 1 of a ring of S stages: load(i) issues step i's
// copies (into ring.tile(i, ·)), compute(i) reads them; S − 1 steps ahead.
// The barrier before each step also orders whatever compute(i − 1) wrote to
// shared memory before compute(i) reads it.
template <int S, class Load, class Compute>
__device__ __forceinline__ void pipeline(int steps, Load&& load, Compute&& compute) {
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < steps) load(i);
    commit();
  }
  for (int i = 0; i < steps; ++i) {
    wait<S - 2>();
    __syncthreads();
    if (i + S - 1 < steps) load(i + S - 1);
    commit();
    compute(i);
  }
}

// ---------------------------------------------------------------- scores

// part (16 × 16·KT: 2·KT tiles of 8 keys) += A (16 rows of `a`) · B (16·KT
// rows of `b`)ᵀ over a chunk of CW columns (rows kLd apart: a stage's)
template <int CW, int KT, int kLd = stage_ld<bf16, CW>()>
__device__ __forceinline__ void rows_by_rows(float (&part)[2 * KT][4], const bf16* a,
                                             const bf16* b) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kc = 0; kc < CW / 16; ++kc) {
    uint32_t fa[4];
    ldsm_x4(fa, a + ((mi & 1) * 8 + mr) * kLd + 16 * kc + (mi >> 1) * 8);
#pragma unroll
    for (int np = 0; np < KT; ++np) {
      uint32_t fb[4];
      ldsm_x4(fb, b + (16 * np + (mi >> 1) * 8 + mr) * kLd + 16 * kc + (mi & 1) * 8);
      mma_bf16(part[2 * np], fa, fb[0], fb[1]);
      mma_bf16(part[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

template <int CW, int KT, int kLd = stage_ld<float, CW>()>
__device__ __forceinline__ void rows_by_rows(float (&part)[2 * KT][4], const float* a,
                                             const float* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < CW; k0 += 8) {
    const SplitA fa = a_frag<false>(a, kLd, k0);
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
      mma_x3(part[n], fa, b[(8 * n + g) * kLd + k0 + t], b[(8 * n + g) * kLd + k0 + t + 4]);
  }
}

// acc += part, then part = 0: the running sums take a promotion group's
// products (128 bytes of each row: fwd_cw columns) at once
template <int NT>
__device__ __forceinline__ void promote(float (&acc)[NT][4], float (&part)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] += part[n][e];
      part[n][e] = 0.f;
    }
}

// The softmax of this warp's score rows, in place: scaled, keys ≥ t masked
// (no weight), keys after the row's own filled with `causal_fill` where
// causal; p = exp(s − max) / sum. A lane holds rows 16w + lane/4 (e < 2) and
// + 8 (e ≥ 2), keys 8n + 2·(lane % 4) + (e & 1); the 4 lanes of a quad hold a row.
template <int NT>
__device__ __forceinline__ void softmax(float (&s)[NT][4], float scale, int t, bool causal,
                                        float causal_fill) {
  const int lane = threadIdx.x & 31, i0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + (e >> 1) * 8, j = 8 * n + c0 + (e & 1);
      float x = s[n][e] * scale;
      if (j >= t) x = -INFINITY;
      else if (causal && j > i) x = causal_fill;
      s[n][e] = x;
      m[e >> 1] = fmaxf(m[e >> 1], x);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = expf(s[n][e] - m[e >> 1]);
      s[n][e] = x;
      sum[e >> 1] += x;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] / sum[e >> 1];
}

// (16 × 16·KT) f32 fragments → bf16 A fragments of a product over the keys
// (key chunk kc is the accumulator tiles 2kc and 2kc + 1)
template <int KT>
__device__ __forceinline__ void to_a_frags(uint32_t (&pa)[KT][4], const float (&x)[2 * KT][4]) {
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    pa[kc][0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
    pa[kc][1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
    pa[kc][2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    pa[kc][3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
  }
}

// bf16 A fragments (16 × 16·KT) into this warp's 16 rows of the (16·KT, ld) tile
template <int KT>
__device__ __forceinline__ void frags_to_tile(bf16* tile, int ld, const uint32_t (&fa)[KT][4]) {
  const int lane = threadIdx.x & 31, r = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int kc = 0; kc < KT; ++kc)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<uint32_t*>(tile + (r + 8 * (k & 1)) * ld + 16 * kc + 8 * (k >> 1) + c0) =
          fa[kc][k];
}

// f32 fragments (16 × 8·NT) into this warp's 16 rows of the (16·KT, ld) tile
template <int NT>
__device__ __forceinline__ void frags_to_tile(float* tile, int ld, const float (&x)[NT][4]) {
  const int lane = threadIdx.x & 31, r = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) tile[(r + 8 * (e >> 1)) * ld + 8 * n + c0 + (e & 1)] = x[n][e];
}

// ---------------------------------------------------------------- outputs

// out columns c0 .. c0 + CW of this warp's 16 rows (row0: the warp's first)
// = A (16 × 16·KT, bf16 fragments) · X (the 16·KT rows of a stage tile),
// through this warp's staging tile `wt`
template <int CW, int KT>
__device__ __forceinline__ void frags_by_chunk(const uint32_t (&fa)[KT][4], const bf16* x,
                                               bf16* wt, const Out<bf16>& out, int row0, int c0) {
  constexpr int kLd = stage_ld<bf16, CW>();
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  const int r0 = lane >> 2, cl = 2 * (lane & 3);
#pragma unroll
  for (int dp = 0; dp < CW / 16; ++dp) {
    float acc[2][4] = {};
#pragma unroll
    for (int kc = 0; kc < KT; ++kc) {
      uint32_t fb[4];
      ldsm_x4_t(fb, x + (16 * kc + (mi & 1) * 8 + mr) * kLd + 16 * dp + (mi >> 1) * 8);
      mma_bf16(acc[0], fa[kc], fb[0], fb[1]);
      mma_bf16(acc[1], fa[kc], fb[2], fb[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = 16 * dp + 8 * n + cl;
      *reinterpret_cast<uint32_t*>(wt + r0 * kLd + col) = pack_bf16(acc[n][0], acc[n][1]);
      *reinterpret_cast<uint32_t*>(wt + (r0 + 8) * kLd + col) = pack_bf16(acc[n][2], acc[n][3]);
    }
  }
  __syncwarp();
  out.template store<CW, kLd>(wt, row0, c0);
  __syncwarp();  // the tile is read before it is written again
}

// ... with A this warp's 16 columns (TRANS) of the (16·KT, ld) bf16 tile `m`:
// out = Mᵀ·X over the tile's rows
template <int CW, int KT>
__device__ __forceinline__ void tile_t_by_chunk(const bf16* m, int ld, const bf16* x, bf16* wt,
                                                const Out<bf16>& out, int row0, int c0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7, w = threadIdx.x >> 5;
  uint32_t fa[KT][4];
#pragma unroll
  for (int kc = 0; kc < KT; ++kc)
    ldsm_x4_t(fa[kc], m + (16 * kc + (mi >> 1) * 8 + mr) * ld + 16 * w + (mi & 1) * 8);
  frags_by_chunk<CW, KT>(fa, x, wt, out, row0, c0);
}

// out columns c0 .. c0 + CW of this warp's 16 rows = M (16 rows of the f32
// (16·KT, ld) tile `m`, or with TRANS 16 of its columns) · X (the 16·KT rows
// of a stage tile), in split TF32, through this warp's staging tile `wt`
template <bool TRANS, int CW, int KT>
__device__ __forceinline__ void tile_by_chunk(const float* m, int ld, const float* x, float* wt,
                                              const Out<float>& out, int row0, int c0) {
  constexpr int kLd = stage_ld<float, CW>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[CW / 8][4] = {};
#pragma unroll
  for (int k = 0; k < 2 * KT; ++k) {
    const SplitA fa = a_frag<TRANS>(m, ld, 8 * k);
    const int r = 8 * k + t;
#pragma unroll
    for (int n = 0; n < CW / 8; ++n)
      mma_x3(acc[n], fa, x[r * kLd + 8 * n + g], x[(r + 4) * kLd + 8 * n + g]);
  }
#pragma unroll
  for (int n = 0; n < CW / 8; ++n) {
    *reinterpret_cast<float2*>(wt + g * kLd + 8 * n + 2 * t) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(wt + (g + 8) * kLd + 8 * n + 2 * t) =
        make_float2(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  out.template store<CW, kLd>(wt, row0, c0);
  __syncwarp();  // the tile is read before it is written again
}

// each warp's staging tile of an output chunk: 16 rows of stage_ld values
template <class E, int CW>
__host__ __device__ constexpr int out_tile() {
  return 16 * stage_ld<E, CW>();
}

// ---------------------------------------------------------------- the forward

// The chunk widths: the forward's Q, K and V in chunks of 128 bytes a row
// (bf16 64 columns, f32 32); the backward's four operands a stage in 64
// bytes (bf16 32, f32 16), so both stay within ~40 KB at T 32. The score
// sums are promoted every 128 bytes of a row in both, so the backward's
// scores equal the forward's bit for bit.
template <class E>
__host__ __device__ constexpr int fwd_cw() {
  return 128 / sizeof(E);
}
template <class E>
__host__ __device__ constexpr int bwd_cw() {
  return 64 / sizeof(E);
}

// (16·KT, 16·KT + 4) f32 probabilities of the f32 forward
template <int KT>
__host__ __device__ constexpr int p_ld() {
  return 16 * KT + 4;
}

// A (sequence, head) split by its columns over the `ranks` blocks of a
// thread-block cluster (#1 where the heads are fewer than the SMs): block
// `rank` streams its share of the head's chunks, the blocks add their partial
// scores through distributed shared memory in rank order, so every block
// holds the same S, and each computes and stores its columns of the output.
struct Split {
  int rank, ranks;
};

// s = Σ over the cluster's blocks, in rank order, of their partial s, each
// block's staged in `red` (the ring's stage of the last score chunk, which
// no copy refills before the next step's barrier, at the same offset in
// every block: they all take the same number of score steps; a warp's 16 ×
// 16·KT fragments lane by lane, 4 KB at T 32, a stage 9 KB)
template <int KT>
__device__ __forceinline__ void cluster_sum(float (&s)[2 * KT][4], int ranks, float* red) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, at = (threadIdx.x >> 5) * (2 * KT * 4 * 32) + lane;
  __syncthreads();  // every warp has read the stage
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[at + (4 * n + e) * 32] = s[n][e];
  cluster.sync();
  float sum[2 * KT][4] = {};
  for (int r = 0; r < ranks; ++r) {
    const float* theirs = cluster.map_shared_rank(red, r);
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[n][e] += theirs[at + (4 * n + e) * 32];
  }
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = sum[n][e];
  cluster.sync();  // every block has read the others' partials before any goes on
}

// a forward's dynamic shared memory: the ring of S stages (Q and K chunks,
// then two V chunks, a stage), the warps' output staging tiles, and in f32
// the probabilities
template <class E, int KT, int S>
__host__ __device__ constexpr size_t forward_smem() {
  constexpr size_t ring = Ring<E, fwd_cw<E>(), 16 * KT, 2, S>::kBytes +
                          sizeof(E) * KT * out_tile<E, fwd_cw<E>()>();
  static_assert(Ring<E, fwd_cw<E>(), 16 * KT, 2, S>::kStage * sizeof(E) >=
                    sizeof(float) * KT * 2 * KT * 4 * 32,
                "a stage holds the partial scores a cluster adds");
  return sizeof(E) == 2 ? ring : ring + sizeof(float) * 16 * KT * p_ld<KT>();
}

// The attention of one (sequence, head) by the block's KT warps: out =
// drop(P)·V with P = softmax(q·kᵀ · scale), P rounded to E, keys after a
// row's own filled with causal_fill where causal, through a ring of S
// stages; this block's `chunks` chunks of CW columns from c_begin, the
// columns past c_end zero (a cluster's last blocks may have fewer to take),
// its scores added over a cluster's blocks where split.ranks > 1.
// drop(x) applies a
// dropout mask to the (16 × 16·KT) probabilities of this warp in place.
template <class E, int KT, int S, class Drop>
__device__ __forceinline__ void forward(unsigned char* smem, const Rows<E>& q, const Rows<E>& k,
                                        const Rows<E>& v, const Out<E>& out, int t, int chunks,
                                        int c_begin, int c_end, float scale, bool causal,
                                        float causal_fill, int copy, const Drop& drop,
                                        const Split& split) {
  constexpr int CW = fwd_cw<E>(), R = 16 * KT;
  using RingT = Ring<E, CW, R, 2, S>;
  const RingT ring{reinterpret_cast<E*>(smem)};
  const int w16 = 16 * (threadIdx.x >> 5);
  E* wt = reinterpret_cast<E*>(smem + RingT::kBytes) + (w16 / 16) * out_tile<E, CW>();
  float* ptile = reinterpret_cast<float*>(  // f32 only
      smem + RingT::kBytes + sizeof(E) * KT * out_tile<E, CW>());
  const int n_s = chunks, n_v = (n_s + 1) / 2;
  float s[2 * KT][4] = {}, part[2 * KT][4] = {};
  uint32_t pa[KT][4];  // bf16: round(drop(P)) as A fragments
  auto load = [&](int i) {
    if (i < n_s) {
      const Rows<E> src[2] = {q, k};
      const int cols[2] = {c_begin + i * CW, c_begin + i * CW};
      load_chunk<E, CW, R, 2>(ring.tile(i, 0), src, cols, t, c_end, copy);
    } else {
      const Rows<E> src[2] = {v, v};
      const int c = c_begin + 2 * (i - n_s) * CW, cols[2] = {c, c + CW};
      load_chunk<E, CW, R, 2>(ring.tile(i, 0), src, cols, t, c_end, copy);
    }
  };
  auto compute = [&](int i) {
    if (i < n_s) {
      rows_by_rows<CW, KT>(part, ring.tile(i, 0) + w16 * RingT::kLd, ring.tile(i, 1));
      promote(s, part);
      if (i == n_s - 1) {
        if (split.ranks > 1)
          cluster_sum<KT>(s, split.ranks, reinterpret_cast<float*>(ring.tile(i, 0)));
        softmax(s, scale, t, causal, causal_fill);
        drop(s);
        if constexpr (sizeof(E) == 2) {
          to_a_frags(pa, s);
        } else {
          frags_to_tile(ptile, p_ld<KT>(), s);
          __syncwarp();
        }
      }
      return;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int c0 = c_begin + (2 * (i - n_s) + n) * CW;
      if (c0 >= c_end) break;
      if constexpr (sizeof(E) == 2)
        frags_by_chunk<CW, KT>(pa, ring.tile(i, n), wt, out, w16, c0);
      else
        tile_by_chunk<false, CW, KT>(ptile + w16 * p_ld<KT>(), p_ld<KT>(), ring.tile(i, n), wt,
                                     out, w16, c0);
    }
  };
  pipeline<S>(n_s + n_v, load, compute);
}

// ---------------------------------------------------------------- clusters (host)

constexpr int kMaxRanks = 8;  // a portable cluster's blocks

// the blocks a (sequence, head) is split over: enough for two blocks an SM
// where the heads are fewer, at most kMaxRanks and a chunk each
inline int ranks_for(long long heads, int chunks) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  const long long want = 2LL * sms / heads;
  long long r = want < chunks ? want : chunks;
  r = r < kMaxRanks ? r : kMaxRanks;
  return static_cast<int>(r < 1 ? 1 : r);
}

// kernel<<<heads · ranks, threads, smem, stream>>>(args) in clusters of `ranks`
template <class Kernel, class Args>
cudaError_t launch_clustered(Kernel kernel, long long heads, int ranks, int threads, size_t smem,
                             cudaStream_t stream, const Args& args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(heads * ranks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = ranks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// this rank's share of a head's n chunks of CW columns: ⌈n / ranks⌉ chunks
// from rank·⌈n / ranks⌉ (the last ranks fewer, past n none), the columns
// [c_begin, c_end)
struct Share {
  int per, c_begin, c_end;
  __device__ __forceinline__ Share(int hd, int cw, int rank, int ranks)
      : per(((hd + cw - 1) / cw + ranks - 1) / ranks),
        c_begin(rank * per * cw),
        c_end(min(hd, c_begin + per * cw)) {}
};

struct NoDrop {
  template <int NT>
  __device__ __forceinline__ void operator()(float (&)[NT][4]) const {}
  // the long route's: query row i, columns 16g .. 16g + 15
  __device__ __forceinline__ void operator()(int, int, float (&)[16]) const {}
};

// ---------------------------------------------------------------- the long route
//
// Past the short route's rows (#1 past T 64, the chains past T 32) a warp's
// (16 × T) scores no longer fit its registers (at T 256, 128 of a lane's
// registers a score array, and the backward holds four). So a (sequence,
// head) is split over blocks by its query rows, QR = 16·QW of them a block of
// kLongWarps warps, and the block's (QR × T) f32 scores live in shared memory
// (4·QR·(T + 4) bytes: QR 64 up to T 256, 32 up to 512, 16 past it, so a
// block takes 66 KB of scores at T 256, 512 and 1,024). The head's columns
// still stream through a cp.async ring, so shared memory does not grow with
// hd. A block's work, through one ring:
//   scores  for each key tile of kKeys keys, for each chunk of CW columns
//           (64 bytes of a row): S_tile += Q_chunk · K_tileᵀ, each warp its
//           16 rows × kKeys / P keys (P = kLongWarps / QW parts of a tile),
//           the sums promoted every 128 bytes of a row as in the short route,
//           then stored to the scores;
//   softmax each row from shared memory in three sweeps (max; exp and sum;
//           divide and drop), a row's 16-column groups one a lane;
//   output  for each chunk of CWO columns, for each key tile: O_chunk +=
//           round(P_tile) · V_tile (each warp its 16 rows × CWO / P columns),
//           a fresh accumulator a key tile added to the running sums in key
//           order, then stored 16 bytes a lane through a staging tile.
// The backward (the chains) runs two kernels: rows (the forward's scores and
// softmax, dP = drop(dA·Vᵀ) beside S, dS, then the output again and dQ, and
// round(drop(P)) and round(dS) written to a scratch (heads, T, ldT)), then
// columns, a block per key tile, dV = Σ over the query tiles of
// drop(P)ᵀ·dA and dK = Σ dSᵀ·Q read from that scratch, a fresh accumulator
// a query tile. Every sum has one order, and no block adds into another's
// output: a rerun is bit for bit.

constexpr int kKeys = 64;  // a key tile
constexpr int kLongMaxT = 2048;  // the long forward's longest sequence (#1's ceiling)
constexpr int kLongWarps = 4;
constexpr int kLongStages = 3;  // the forward's ring (the backward's: 2)

template <class E>
__host__ __device__ constexpr int long_cw() {
  return bwd_cw<E>();  // 64 bytes of a row a score chunk
}

// the scores' row stride (floats): T rounded up to a key tile, + 4 (4 mod 8:
// the fragments' scalar reads fall in 32 banks)
__host__ __device__ constexpr int scores_ld(int t) {
  return kKeys * ((t + kKeys - 1) / kKeys) + 4;
}

// a long forward's blocks: QW 16-row groups of query rows a block
__host__ __device__ constexpr int long_qw(int t) { return t <= 256 ? 4 : t <= 512 ? 2 : 1; }

template <class E, int QW>
struct LongFwd {
  static constexpr int QR = 16 * QW, P = kLongWarps / QW, CW = long_cw<E>(), CWO = 2 * CW;
  static constexpr int CWW = CWO / P;  // a warp's output columns
  static constexpr int S = kLongStages;
  static constexpr size_t kStage =
      sizeof(E) * ((QR + kKeys) * stage_ld<E, CW>() > kKeys * stage_ld<E, CWO>()
                       ? (QR + kKeys) * stage_ld<E, CW>()
                       : kKeys * stage_ld<E, CWO>());
  static constexpr size_t kFixed = S * kStage + sizeof(E) * kLongWarps * out_tile<E, CWW>();
  static constexpr size_t smem(int t) { return kFixed + sizeof(float) * QR * scores_ld(t); }
};

// ... the backward's rows kernel: 32 query rows a block, Q, K, dA and V a
// stage, the output and dQ in chunks of CW (16 of a warp's columns in bf16, 8
// in f32), two ring stages and two score arrays (S then P; dP then dS)
template <class E>
struct LongBwd {
  static constexpr int QW = 2, QR = 32, P = kLongWarps / QW, CW = long_cw<E>(), CWO = CW;
  static constexpr int CWW = CWO / P;
  static constexpr int S = 2;
  static constexpr size_t kStage = sizeof(E) * 2 * (QR + kKeys) * stage_ld<E, CW>();
  static constexpr size_t kFixed = S * kStage + sizeof(E) * kLongWarps * out_tile<E, CWW>();
  static constexpr size_t smem(int t) { return kFixed + 2 * sizeof(float) * QR * scores_ld(t); }
};

// ... and its columns kernel: a block per key tile, a warp its 16 keys; a
// stage holds the key tile's (64 query rows × kKeys) drop(P) and dS and the
// query tile's chunk of dA and Q
template <class E>
struct LongCols {
  static constexpr int CW = long_cw<E>(), S = 2;
  static constexpr size_t kStage =
      sizeof(E) * 2 * kKeys * (stage_ld<E, kKeys>() + stage_ld<E, CW>());
  static constexpr size_t smem() { return S * kStage + sizeof(E) * kLongWarps * out_tile<E, CW>(); }
};

// scratch rows: T rounded up to 8 (16-byte rows in both dtypes)
__host__ __device__ constexpr int scratch_ld(int t) { return (t + 7) / 8 * 8; }

// rows [0, n) of `src` (rows < valid and columns col .. col + CW below hd
// read, the rest zero) into `dst` (rows of stage_ld<E, CW>()), copies of
// BYTES shared by the block's threads
template <int BYTES, class E, int CW>
__device__ __forceinline__ void load_tile_by(E* dst, const Rows<E>& src, int n, int valid,
                                             int col, int hd) {
  constexpr int kLd = stage_ld<E, CW>(), kPer = BYTES / sizeof(E), kRow = CW / kPer;
  for (int idx = threadIdx.x; idx < n * kRow; idx += blockDim.x) {
    const int r = idx / kRow, c = kPer * (idx - r * kRow);
    const bool ok = r < valid && col + c < hd;
    E* d = dst + r * kLd + c;
    const E* s = ok ? src.p + r * src.ld + col + c : src.p;
    if constexpr (BYTES >= 4)
      cp_async<BYTES>(d, s, ok);
    else
      *d = ok ? *s : __float2bfloat16(0.f);
  }
}

template <class E, int CW>
__device__ __forceinline__ void load_tile(E* dst, const Rows<E>& src, int n, int valid, int col,
                                          int hd, int copy) {
  if (copy == 16)
    load_tile_by<16, E, CW>(dst, src, n, valid, col, hd);
  else if (copy == 8)
    load_tile_by<8, E, CW>(dst, src, n, valid, col, hd);
  else if constexpr (sizeof(E) == 2) {
    if (copy == 4)
      load_tile_by<4, E, CW>(dst, src, n, valid, col, hd);
    else
      load_tile_by<2, E, CW>(dst, src, n, valid, col, hd);
  } else {
    load_tile_by<4, E, CW>(dst, src, n, valid, col, hd);
  }
}

// rows [row0, ...) of a head's rows
template <class E>
__device__ __forceinline__ Rows<E> from_row(const Rows<E>& h, int row0) {
  return {h.p + row0 * h.ld, h.ld};
}

// f32 fragments (16 × 8·NT) into 16 rows of `dst` (row stride ld floats)
template <int NT>
__device__ __forceinline__ void frags_store(float* dst, int ld, const float (&x)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c0 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<float2*>(dst + g * ld + 8 * n + c0) = make_float2(x[n][0], x[n][1]);
    *reinterpret_cast<float2*>(dst + (g + 8) * ld + 8 * n + c0) = make_float2(x[n][2], x[n][3]);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// The A fragment (16 × 16, k chunk kc) of 16 f32 rows `p` (stride ld),
// rounded to bf16
__device__ __forceinline__ void a_frag_f32(uint32_t (&a)[4], const float* p, int ld, int kc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = 16 * kc + 2 * (lane & 3);
  const float2 x0 = *reinterpret_cast<const float2*>(p + g * ld + c);
  const float2 x1 = *reinterpret_cast<const float2*>(p + (g + 8) * ld + c);
  const float2 x2 = *reinterpret_cast<const float2*>(p + g * ld + c + 8);
  const float2 x3 = *reinterpret_cast<const float2*>(p + (g + 8) * ld + c + 8);
  a[0] = pack_bf16(x0.x, x0.y);
  a[1] = pack_bf16(x1.x, x1.y);
  a[2] = pack_bf16(x2.x, x2.y);
  a[3] = pack_bf16(x3.x, x3.y);
}

// The A fragment (16 × 16, k chunk kc) of 16 columns (TRANS: rows are the
// tile's columns c0 .. c0 + 15) of the bf16 tile `m` (stride ld)
__device__ __forceinline__ void a_frag_t(uint32_t (&a)[4], const bf16* m, int ld, int c0,
                                         int kc) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  ldsm_x4_t(a, m + (16 * kc + (mi >> 1) * 8 + mr) * ld + c0 + (mi & 1) * 8);
}

// acc (16 × 8·NT) += A (16 × 16·KT) · X (16·KT rows of `x`, stride XLD,
// columns 0 .. 8·NT), bf16: A's fragments from `a(kc, frag)`
template <int NT, int KT, int XLD, class AFrag>
__device__ __forceinline__ void mma_into(float (&acc)[NT][4], const AFrag& a, const bf16* x) {
  static_assert(NT % 2 == 0, "bf16 products take 16 columns at a time");
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    uint32_t fa[4];
    a(kc, fa);
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t fb[4];
      ldsm_x4_t(fb, x + (16 * kc + (mi & 1) * 8 + mr) * XLD + 16 * dp + (mi >> 1) * 8);
      mma_bf16(acc[2 * dp], fa, fb[0], fb[1]);
      mma_bf16(acc[2 * dp + 1], fa, fb[2], fb[3]);
    }
  }
}

// ... f32 in split TF32: A the 16 rows (TRANS: 16 columns) of the f32 `m`
// (stride ld), k = 16·KT
template <int NT, int KT, int XLD, bool TRANS>
__device__ __forceinline__ void mma_into(float (&acc)[NT][4], const float* m, int ld,
                                         const float* x) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < 2 * KT; ++k) {
    const SplitA fa = a_frag<TRANS>(m, ld, 8 * k);
    const int r = 8 * k + t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_x3(acc[n], fa, x[r * XLD + 8 * n + g], x[(r + 4) * XLD + 8 * n + g]);
  }
}

// acc (16 × 8·NT) as E through this warp's staging tile `wt` (16 rows of
// TLD) into out's rows row0 .. row0 + 15, columns c0 .. c0 + 8·NT
template <int NT, int TLD, class E>
__device__ __forceinline__ void store_acc(const float (&acc)[NT][4], E* wt, const Out<E>& out,
                                          int row0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, cl = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if constexpr (sizeof(E) == 2) {
      *reinterpret_cast<uint32_t*>(wt + g * TLD + 8 * n + cl) = pack_bf16(acc[n][0], acc[n][1]);
      *reinterpret_cast<uint32_t*>(wt + (g + 8) * TLD + 8 * n + cl) =
          pack_bf16(acc[n][2], acc[n][3]);
    } else {
      *reinterpret_cast<float2*>(wt + g * TLD + 8 * n + cl) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(wt + (g + 8) * TLD + 8 * n + cl) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncwarp();
  out.template store<8 * NT, TLD>(wt, row0, c0);
  __syncwarp();  // the tile is read before it is written again
}

// acc (16 × 8·NT) += round(P) · X: P 16 f32 rows of the scores (keys k0 ..
// k0 + kKeys), X a stage tile of kKeys rows (stride XLD) from its column 0
template <int NT, int XLD, class E>
__device__ __forceinline__ void scores_by_tile(float (&acc)[NT][4], const float* p, int ld,
                                               const E* x) {
  if constexpr (sizeof(E) == 2)
    mma_into<NT, kKeys / 16, XLD>(
        acc, [&](int kc, uint32_t(&fa)[4]) { a_frag_f32(fa, p, ld, kc); }, x);
  else
    mma_into<NT, kKeys / 16, XLD, false>(acc, p, ld, x);
}

// ... and acc += Mᵀ · X: M this warp's 16 columns c0 .. of a (kKeys, ML)
// stage tile (the columns kernel: drop(P)ᵀ or dSᵀ over a query tile)
template <int NT, int ML, int XLD, class E>
__device__ __forceinline__ void tile_t_by_tile(float (&acc)[NT][4], const E* m, int c0,
                                               const E* x) {
  if constexpr (sizeof(E) == 2)
    mma_into<NT, kKeys / 16, XLD>(
        acc, [&](int kc, uint32_t(&fa)[4]) { a_frag_t(fa, m, ML, c0, kc); }, x);
  else
    mma_into<NT, kKeys / 16, XLD, true>(acc, m + c0, ML, x);
}

// ---------------------------------------------------------------- its softmax

// a row's lanes: one for each of its groups of 16 columns, a power of two ≤ 32
__device__ __forceinline__ int lanes_per_row(int groups) {
  int l = 1;
  while (l < groups && l < 32) l <<= 1;
  return l;
}

__device__ __forceinline__ float lanes_max(float x, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float lanes_sum(float x, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void load16(float (&x)[16], const float* p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}
__device__ __forceinline__ void store16(float* p, const float (&x)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(p)[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2],
                                                  x[4 * i + 3]);
}

// The rows of the block's scores this warp takes, in sets of 32 / lanes, a
// row's lanes on one aligned group: fn(r, sub, on), r the block's row, sub
// the lane's place in the row's group, on unless past `rows` or T. Every
// lane of the warp calls fn the same number of times (fn's shuffles).
template <class Fn>
__device__ __forceinline__ void warp_rows(int rows, int row0, int t, int lanes, Fn&& fn) {
  const int lane = threadIdx.x & 31, per = 32 / lanes, w = threadIdx.x >> 5;
  const int first = w * rows;
  for (int base = 0; base < rows; base += per) {
    const int r = first + base + lane / lanes;
    fn(r, lane & (lanes - 1), base + lane / lanes < rows && row0 + r < t);
  }
}

// This lane's groups of 16 columns of a row (groups sub, sub + lanes, ..., NG
// of them at most), scaled and masked: keys ≥ t no weight, keys after the
// row's own (i) `fill` where causal; returns the lane's largest value
template <int NG>
__device__ __forceinline__ float load_masked(float (&x)[NG][16], const float* row, int i, int t,
                                             int groups, int sub, int lanes, bool on, float scale,
                                             bool causal, float fill) {
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    const int g = sub + k * lanes;
    if (!on || g >= groups) continue;
    load16(x[k], row + 16 * g);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int j = 16 * g + e;
      x[k][e] = j >= t ? -INFINITY : causal && j > i ? fill : x[k][e] * scale;
      m = fmaxf(m, x[k][e]);
    }
  }
  return m;
}

// The softmax of a row held by its lanes' groups, in place: e = exp(x − max)
// times 1 / Σ e, the max and the sum over the row's lanes
template <int NG>
__device__ __forceinline__ void softmax_vals(float (&x)[NG][16], float m, int groups, int sub,
                                             int lanes, bool on) {
  m = lanes_max(m, lanes);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    if (!on || sub + k * lanes >= groups) continue;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      x[k][e] = expf(x[k][e] - m);
      sum += x[k][e];
    }
  }
  const float inv = 1.f / lanes_sum(sum, lanes);
#pragma unroll
  for (int k = 0; k < NG; ++k)
#pragma unroll
    for (int e = 0; e < 16; ++e) x[k][e] *= inv;
}

// The forward's softmax of the block's QR rows (query rows row0 ..), in
// place: P = drop(softmax), drop(i, g, x) the dropout of row i's columns 16g
// .. 16g + 15; a lane holds NG groups of a row in registers (lanes · NG · 16
// ≥ T), so each score is read and written once
template <int NG, class Drop>
__device__ __forceinline__ void softmax_rows(float* sc, int ld, int qr, int row0, int t,
                                             float scale, bool causal, float fill,
                                             const Drop& drop) {
  const int groups = (t + 15) / 16, lanes = lanes_per_row(groups);
  warp_rows(qr / kLongWarps, row0, t, lanes, [&](int r, int sub, bool on) {
    float* row = sc + r * ld;
    float x[NG][16];
    const float m = load_masked(x, row, row0 + r, t, groups, sub, lanes, on, scale, causal, fill);
    softmax_vals(x, m, groups, sub, lanes, on);
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const int g = sub + k * lanes;
      if (!on || g >= groups) continue;
      drop(row0 + r, g, x[k]);
      store16(row + 16 * g, x[k]);
    }
  });
}

// ---------------------------------------------------------------- its forward

// The (QR × kKeys) score tile of key tile kt over a chunk of CW columns, this
// warp's 16 rows (rg) × kKeys / P keys (pw); the sums promoted every 128
// bytes of a row (every two chunks), stored to the scores after the last
template <class E, int QR, int P, int CW>
__device__ __forceinline__ void score_step(float (&acc)[8 / P][4], float (&part)[8 / P][4],
                                           const E* tq, const E* tk, int c, int n_c, float* sc,
                                           int ld, int kt) {
  constexpr int KT = 4 / P, kLd = stage_ld<E, CW>(), QW = QR / 16;
  const int w = threadIdx.x >> 5, rg = w % QW, pw = w / QW;
  rows_by_rows<CW, KT>(part, tq + 16 * rg * kLd, tk + 16 * KT * pw * kLd);
  if (c % 2 == 1 || c == n_c - 1) promote(acc, part);
  if (c == n_c - 1) {
    frags_store(sc + 16 * rg * ld + kKeys * kt + 16 * KT * pw, ld, acc);
    zero(acc);
  }
}

// The attention of query rows row0 .. row0 + QR of one (sequence, head):
// out = round(drop(P))·V, P = softmax(q·kᵀ · scale) (keys after a row's own
// filled with `fill` where causal), by the block's kLongWarps warps
template <class E, int QW, class Drop>
__device__ __forceinline__ void long_forward(unsigned char* smem, const Rows<E>& q,
                                             const Rows<E>& k, const Rows<E>& v,
                                             const Out<E>& out, int t, int hd, int row0,
                                             float scale, bool causal, float fill, int copy,
                                             const Drop& drop) {
  using L = LongFwd<E, QW>;
  constexpr int QR = L::QR, P = L::P, CW = L::CW, CWO = L::CWO, CWW = L::CWW;
  constexpr int kLd = stage_ld<E, CW>(), kOld = stage_ld<E, CWO>();
  const int n_kt = (t + kKeys - 1) / kKeys, n_c = (hd + CW - 1) / CW;
  const int n_co = (hd + CWO - 1) / CWO, n_s = n_kt * n_c, ld = scores_ld(t);
  E* wt = reinterpret_cast<E*>(smem + L::S * L::kStage) + (threadIdx.x >> 5) * out_tile<E, CWW>();
  float* sc = reinterpret_cast<float*>(smem + L::kFixed);
  auto stage = [&](int i) { return reinterpret_cast<E*>(smem + (i % L::S) * L::kStage); };
  const int w = threadIdx.x >> 5, rg = w % QW, pw = w / QW;
  float acc[8 / P][4] = {}, part[8 / P][4] = {};
  float o[CWW / 8][4] = {}, po[CWW / 8][4] = {};
  auto load = [&](int i) {
    E* st = stage(i);
    if (i < n_s) {
      const int kt = i / n_c, c = (i % n_c) * CW;
      load_tile<E, CW>(st, from_row(q, row0), QR, t - row0, c, hd, copy);
      load_tile<E, CW>(st + QR * kLd, from_row(k, kKeys * kt), kKeys, t - kKeys * kt, c, hd, copy);
    } else {
      const int j = i - n_s, kt = j % n_kt;
      load_tile<E, CWO>(st, from_row(v, kKeys * kt), kKeys, t - kKeys * kt, (j / n_kt) * CWO, hd,
                        copy);
    }
  };
  auto compute = [&](int i) {
    const E* st = stage(i);
    if (i < n_s) {
      score_step<E, QR, P, CW>(acc, part, st, st + QR * kLd, i % n_c, n_c, sc, ld, i / n_c);
      return;
    }
    const int j = i - n_s, co = j / n_kt, kt = j % n_kt;
    if (j == 0) {  // every warp's scores stored (the step's barrier)
      softmax_rows<QW == 1 ? kLongMaxT / (32 * 16) : 1>(sc, ld, QR, row0, t, scale, causal, fill,
                                                          drop);
      __syncthreads();
    }
    scores_by_tile<CWW / 8, kOld>(po, sc + 16 * rg * ld + kKeys * kt, ld, st + CWW * pw);
    promote(o, po);
    if (kt == n_kt - 1) {
      if (co * CWO + CWW * pw < hd)
        store_acc<CWW / 8, stage_ld<E, CWW>()>(o, wt, out, row0 + 16 * rg, co * CWO + CWW * pw);
      zero(o);
    }
  };
  pipeline<L::S>(n_s + n_co * n_kt, load, compute);
}

// ---------------------------------------------------------------- its backward

__device__ __forceinline__ void put8(bf16* p, const float* v) {
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void put8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// columns 16g .. 16g + 15 of a scratch row (stride-ld rows, columns < ld)
template <class E>
__device__ __forceinline__ void put16(E* row, int g, int ld, const float (&x)[16]) {
  if (16 * g < ld) put8(row + 16 * g, x);
  if (16 * g + 8 < ld) put8(row + 16 * g + 8, x + 8);
}

// The backward's softmax of the block's QR rows (T ≤ 512: a group of each
// row a lane): P again as the forward computes it, dP = drop(dP) and Σ_j
// dP·P, then dS = P·(dP − Σ_j dP·P)·scale into `sdp` and drop(P) into `sc`
// (both f32), and round(drop(P)), round(dS) into the scratch rows (query row
// i at sp + i·sld)
template <class E, class Drop>
__device__ __forceinline__ void softmax_bwd_rows(float* sc, float* sdp, int ld, int qr, int row0,
                                                 int t, float scale, bool causal, float fill,
                                                 const Drop& drop, E* sp, E* sd, int sld) {
  const int groups = (t + 15) / 16, lanes = lanes_per_row(groups);
  warp_rows(qr / kLongWarps, row0, t, lanes, [&](int r, int sub, bool on) {
    float *row = sc + r * ld, *drow = sdp + r * ld;
    const int i = row0 + r;
    float p[1][16], dp[16];
    const float m = load_masked(p, row, i, t, groups, sub, lanes, on, scale, causal, fill);
    softmax_vals(p, m, groups, sub, lanes, on);
    on = on && sub < groups;
    float dot = 0.f;
    if (on) {
      load16(dp, drow + 16 * sub);
      drop(i, sub, dp);
#pragma unroll
      for (int e = 0; e < 16; ++e) dot = fmaf(dp[e], p[0][e], dot);
    }
    dot = lanes_sum(dot, lanes);
    if (on) {
#pragma unroll
      for (int e = 0; e < 16; ++e) dp[e] = p[0][e] * (dp[e] - dot) * scale;
      drop(i, sub, p[0]);
      store16(row + 16 * sub, p[0]);
      store16(drow + 16 * sub, dp);
      put16(sp + static_cast<size_t>(i) * sld, sub, sld, p[0]);
      put16(sd + static_cast<size_t>(i) * sld, sub, sld, dp);
    }
  });
}

// The backward's rows kernel, query rows row0 .. row0 + 32 of one (sequence,
// head): S = Q·Kᵀ and dP = dA·Vᵀ by the forward's score steps, the softmax
// above, then chunk by chunk the output again (round(drop(P))·V, for dWo) and
// dQ = round(dS)·K; drop(P) and dS to the scratch rows for the columns kernel
template <class E, class Drop>
__device__ __forceinline__ void long_backward_rows(unsigned char* smem, const Rows<E>& q,
                                                   const Rows<E>& k, const Rows<E>& v,
                                                   const Rows<E>& da, const Out<E>& out,
                                                   const Out<E>& dq, E* sp, E* sd, int sld, int t,
                                                   int hd, int row0, float scale, bool causal,
                                                   float fill, int copy, const Drop& drop) {
  using L = LongBwd<E>;
  constexpr int QR = L::QR, QW = L::QW, P = L::P, CW = L::CW, CWW = L::CWW;
  constexpr int kLd = stage_ld<E, CW>();
  const int n_kt = (t + kKeys - 1) / kKeys, n_c = (hd + CW - 1) / CW, n_s = n_kt * n_c;
  const int ld = scores_ld(t);
  E* wt = reinterpret_cast<E*>(smem + L::S * L::kStage) + (threadIdx.x >> 5) * out_tile<E, CWW>();
  float* sc = reinterpret_cast<float*>(smem + L::kFixed);
  float* sdp = sc + QR * ld;
  auto stage = [&](int i) { return reinterpret_cast<E*>(smem + (i % L::S) * L::kStage); };
  const int w = threadIdx.x >> 5, rg = w % QW, pw = w / QW;
  float s_acc[8 / P][4] = {}, s_part[8 / P][4] = {}, d_acc[8 / P][4] = {}, d_part[8 / P][4] = {};
  float o[CWW / 8][4] = {}, po[CWW / 8][4] = {}, dqa[CWW / 8][4] = {}, pdq[CWW / 8][4] = {};
  // a stage: Q, K, dA, V (the scores' steps) or V, K (the outputs')
  auto load = [&](int i) {
    E* st = stage(i);
    if (i < n_s) {
      const int kt = i / n_c, c = (i % n_c) * CW;
      load_tile<E, CW>(st, from_row(q, row0), QR, t - row0, c, hd, copy);
      load_tile<E, CW>(st + QR * kLd, from_row(k, kKeys * kt), kKeys, t - kKeys * kt, c, hd, copy);
      load_tile<E, CW>(st + (QR + kKeys) * kLd, from_row(da, row0), QR, t - row0, c, hd, copy);
      load_tile<E, CW>(st + (2 * QR + kKeys) * kLd, from_row(v, kKeys * kt), kKeys,
                       t - kKeys * kt, c, hd, copy);
    } else {
      const int j = i - n_s, kt = j % n_kt, c = (j / n_kt) * CW;
      load_tile<E, CW>(st, from_row(v, kKeys * kt), kKeys, t - kKeys * kt, c, hd, copy);
      load_tile<E, CW>(st + kKeys * kLd, from_row(k, kKeys * kt), kKeys, t - kKeys * kt, c, hd,
                       copy);
    }
  };
  auto compute = [&](int i) {
    const E* st = stage(i);
    if (i < n_s) {
      const int c = i % n_c, kt = i / n_c;
      score_step<E, QR, P, CW>(s_acc, s_part, st, st + QR * kLd, c, n_c, sc, ld, kt);
      score_step<E, QR, P, CW>(d_acc, d_part, st + (QR + kKeys) * kLd,
                               st + (2 * QR + kKeys) * kLd, c, n_c, sdp, ld, kt);
      return;
    }
    const int j = i - n_s, c = (j / n_kt) * CW, kt = j % n_kt;
    if (j == 0) {
      softmax_bwd_rows(sc, sdp, ld, QR, row0, t, scale, causal, fill, drop, sp, sd, sld);
      __syncthreads();
    }
    const int at = 16 * rg * ld + kKeys * kt;
    scores_by_tile<CWW / 8, kLd>(po, sc + at, ld, st + CWW * pw);
    scores_by_tile<CWW / 8, kLd>(pdq, sdp + at, ld, st + kKeys * kLd + CWW * pw);
    promote(o, po);
    promote(dqa, pdq);
    if (kt == n_kt - 1) {
      if (c + CWW * pw < hd) {
        store_acc<CWW / 8, stage_ld<E, CWW>()>(o, wt, out, row0 + 16 * rg, c + CWW * pw);
        store_acc<CWW / 8, stage_ld<E, CWW>()>(dqa, wt, dq, row0 + 16 * rg, c + CWW * pw);
      }
      zero(o);
      zero(dqa);
    }
  };
  pipeline<L::S>(n_s + ((hd + CW - 1) / CW) * n_kt, load, compute);
}

// The backward's columns kernel, keys kt·kKeys .. + kKeys of one (sequence,
// head), a warp its 16: chunk by chunk over hd, dV = Σ over the query tiles
// of drop(P)ᵀ·dA and dK = Σ dSᵀ·Q, drop(P) and dS read from the rows
// kernel's scratch (the head's (T, sld) rows `ps`, `ds`; columns past T zero)
template <class E>
__device__ __forceinline__ void long_backward_cols(unsigned char* smem, const Rows<E>& ps,
                                                   const Rows<E>& ds, const Rows<E>& q,
                                                   const Rows<E>& da, const Out<E>& dk,
                                                   const Out<E>& dv, int sld, int t, int hd,
                                                   int kt, int copy) {
  using L = LongCols<E>;
  constexpr int CW = L::CW, kLd = stage_ld<E, CW>(), kPld = stage_ld<E, kKeys>();
  const int n_qt = (t + kKeys - 1) / kKeys, n_c = (hd + CW - 1) / CW;
  const int w = threadIdx.x >> 5, key0 = kKeys * kt + 16 * w;
  E* wt = reinterpret_cast<E*>(smem + L::S * L::kStage) + w * out_tile<E, CW>();
  auto stage = [&](int i) { return reinterpret_cast<E*>(smem + (i % L::S) * L::kStage); };
  float dv_acc[CW / 8][4] = {}, dv_part[CW / 8][4] = {};
  float dk_acc[CW / 8][4] = {}, dk_part[CW / 8][4] = {};
  // a stage: drop(P) and dS of (the query tile, this key tile), dA and Q of the chunk
  auto load = [&](int i) {
    E* st = stage(i);
    const int qt = i % n_qt, c = (i / n_qt) * CW, r0 = kKeys * qt;
    load_tile<E, kKeys>(st, from_row(ps, r0), kKeys, t - r0, kKeys * kt, sld, 16);
    load_tile<E, kKeys>(st + kKeys * kPld, from_row(ds, r0), kKeys, t - r0, kKeys * kt, sld, 16);
    E* x = st + 2 * kKeys * kPld;
    load_tile<E, CW>(x, from_row(da, r0), kKeys, t - r0, c, hd, copy);
    load_tile<E, CW>(x + kKeys * kLd, from_row(q, r0), kKeys, t - r0, c, hd, copy);
  };
  auto compute = [&](int i) {
    const E* st = stage(i);
    const E* x = st + 2 * kKeys * kPld;
    tile_t_by_tile<CW / 8, kPld, kLd>(dv_part, st, 16 * w, x);
    tile_t_by_tile<CW / 8, kPld, kLd>(dk_part, st + kKeys * kPld, 16 * w, x + kKeys * kLd);
    promote(dv_acc, dv_part);
    promote(dk_acc, dk_part);
    if (i % n_qt == n_qt - 1) {
      const int c = (i / n_qt) * CW;
      store_acc<CW / 8, kLd>(dv_acc, wt, dv, key0, c);
      store_acc<CW / 8, kLd>(dk_acc, wt, dk, key0, c);
      zero(dv_acc);
      zero(dk_acc);
    }
  };
  pipeline<L::S>(n_c * n_qt, load, compute);
}

}  // namespace attn
}  // namespace
