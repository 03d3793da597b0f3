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
// rows of `b`)ᵀ over a chunk of CW columns
template <int CW, int KT>
__device__ __forceinline__ void rows_by_rows(float (&part)[2 * KT][4], const bf16* a,
                                             const bf16* b) {
  constexpr int kLd = stage_ld<bf16, CW>();
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

template <int CW, int KT>
__device__ __forceinline__ void rows_by_rows(float (&part)[2 * KT][4], const float* a,
                                             const float* b) {
  constexpr int kLd = stage_ld<float, CW>();
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
};

}  // namespace attn
}  // namespace
