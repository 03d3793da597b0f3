// Fused multi-head attention for the serving path, sm_90a.
//
// Counterpart of the Pallas kernel transformergrooveinfilling_tpu/ops/
// attention.py::_mha_kernel: softmax(Q·Kᵀ/√hd, optional causal mask)·V over
// (batch, head, T, hd), T ≤ 64, hd ≤ 256, float32 or bfloat16. Math as the
// TPU kernel does it:
//   s = (q·kᵀ in f32) · scale; causal: s[i][j] = -1e9 for j > i;
//   p = exp(s - rowmax) / rowsum;  p rounded to the input dtype (bf16);
//   o = (p·v in f32) cast to the input dtype.
//
// Layout. q, k and v are read through their own (batch, head, token)
// strides with unit stride on hd, so the slices of a packed qkv (B, T, 3, H,
// hd) or kv projection pass without a copy. The output is written as
// (B, T, H, hd), the layout the model's out-projection reads, so the caller's
// transpose back to (B, T, d) is a view.
//
// What bounds it on the H100: one (batch, head) at the serving shapes (T 32,
// hd 128) is two 32×32×128 products around a 32×32 softmax, about 0.5 MFLOP
// against 48 KB of Q/K/V read and 16 KB written in f32 (half in bf16): below
// the card's balance point in either type, so the floor is memory (20 µs at
// batch 512 in f32, 10 µs in bf16); at batch 1 it is one block's latency.
//
// Grid: one block per (batch·head, 16 query rows), each with all of K and V,
// so batch 1 × 2 heads × T 32 is 4 blocks and batch 512 is 2,048. Two paths:
//
// - bf16 with hd % 16 == 0 and 16-byte aligned rows: one warp a block. Q, K
//   and V arrive by cp.async in rows padded by 16 bytes (8 rows at one column
//   hit 8 different bank groups, so ldmatrix is conflict-free); S = Q·Kᵀ and
//   O = P·V run on the tensor cores as mma.sync m16n8k16 bf16 → f32, the
//   softmax in f32 on the accumulator fragments with shuffles within a quad,
//   P rounded to bf16 and reused from registers as the A operand of P·V. V
//   arrives while S is computed. At T ≤ 64 a head is at most four 16-row
//   tiles, so wgmma's 64-row warpgroup tiles would leave most of a warpgroup
//   idle; mma.sync fits the shape.
// - everything else (f32; bf16 with other hd or alignment): 128 threads,
//   f32 in shared memory (rows padded to ≡ 4 mod 8 floats), register tiles
//   of 4 query rows × 1 key for S and 4 rows × 4 columns for O, read as
//   float4s, so an FMA no longer costs two shared-memory loads. Full f32: no
//   TF32, sums over d and over keys in order.
//
// Plain C entry points, bound from Python with ctypes
// (ops/attention.py); the launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 16;          // query rows a block
constexpr int kSimtThreads = 128;
constexpr int kMaxT = 64;
constexpr int kMaxHd = 256;
constexpr size_t kStaticSmemLimit = 48 * 1024;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3];  // batch, head, token strides (elements)
  int heads, t, hd, causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}

// ------------------------------------------------------------ CUDA-core path

// padded row of the f32 path: hd rounded up to 8, plus 4 (≡ 4 mod 8 floats,
// so 8 rows read at one column fall in 8 different bank groups)
__host__ __device__ __forceinline__ int simt_ld(int hd) { return (hd + 7) / 8 * 8 + 4; }
__host__ __device__ __forceinline__ int round4(int t) { return (t + 3) / 4 * 4; }

__host__ __device__ __forceinline__ size_t simt_smem_bytes(int t, int hd) {
  // Q (16 rows), K (t rows), V (t rounded up to 4 rows), P (16 × t rounded to 4)
  return sizeof(float) * (static_cast<size_t>(kRows + t + round4(t)) * simt_ld(hd) +
                          static_cast<size_t>(kRows) * round4(t));
}

// rows [0, n) of a (rows, hd) operand into shared memory as f32, columns
// [hd, hdp) and rows [n, n_pad) zero; vec4: float4 loads (f32, hd % 4 == 0,
// aligned rows). Each thread issues 8 loads before it stores any, so a
// block's loads are in flight together.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* __restrict__ src,
                                           long long stride, int n, int n_pad, int hd,
                                           bool vec4) {
  constexpr int kBatch = 8;
  const int hdp = (hd + 7) / 8 * 8;
  if constexpr (std::is_same<T, float>::value) {
    if (vec4) {
      const int per_row = hdp / 4, total = n_pad * per_row;
      for (int base = threadIdx.x; base < total; base += kBatch * blockDim.x) {
        float4 x[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int idx = base + u * blockDim.x, r = idx / per_row, c = 4 * (idx - r * per_row);
          x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (idx < total && r < n && c < hd)
            x[u] = __ldg(reinterpret_cast<const float4*>(src + r * stride + c));
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int idx = base + u * blockDim.x, r = idx / per_row, c = 4 * (idx - r * per_row);
          if (idx < total) *reinterpret_cast<float4*>(dst + r * ld + c) = x[u];
        }
      }
      return;
    }
  }
  const int total = n_pad * hdp;
  for (int base = threadIdx.x; base < total; base += kBatch * blockDim.x) {
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * blockDim.x, r = idx / hdp, c = idx - r * hdp;
      x[u] = (idx < total && r < n && c < hd) ? to_f32(src[r * stride + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * blockDim.x, r = idx / hdp, c = idx - r * hdp;
      if (idx < total) dst[r * ld + c] = x[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kSimtThreads)
    mha_simt_kernel(Args a, int vec4) {
  extern __shared__ float4 smem4[];
  const int t = a.t, hd = a.hd, ld = simt_ld(hd), tp = round4(t);
  const int hdp = (hd + 7) / 8 * 8;
  float* sq = reinterpret_cast<float*>(smem4);  // (16, ld)
  float* sk = sq + kRows * ld;                  // (t, ld)
  float* sv = sk + t * ld;                      // (tp, ld)
  float* sp = sv + tp * ld;                     // (16, tp) scores, then p

  const int bi = blockIdx.x / a.heads, hi = blockIdx.x % a.heads;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, t - row0);
  const T* q = static_cast<const T*>(a.q) + bi * a.qs[0] + hi * a.qs[1] + row0 * a.qs[2];
  const T* k = static_cast<const T*>(a.k) + bi * a.ks[0] + hi * a.ks[1];
  const T* v = static_cast<const T*>(a.v) + bi * a.vs[0] + hi * a.vs[1];
  stage_rows(sq, ld, q, a.qs[2], rows, kRows, hd, vec4);
  stage_rows(sk, ld, k, a.ks[2], t, t, hd, vec4);
  stage_rows(sv, ld, v, a.vs[2], t, tp, hd, vec4);
  __syncthreads();

  // scores: a unit is 4 query rows × 1 key; the lanes of a warp take
  // neighbouring keys of the same 4 rows (Q read by broadcast)
  for (int u = threadIdx.x; u < 4 * t; u += kSimtThreads) {
    const int g = u / t, j = u - g * t;
    const float* kj = sk + j * ld;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < hdp; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kj + d);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(sq + (4 * g + r) * ld + d);
        acc[r] = fmaf(qv.x, kv.x, acc[r]);
        acc[r] = fmaf(qv.y, kv.y, acc[r]);
        acc[r] = fmaf(qv.z, kv.z, acc[r]);
        acc[r] = fmaf(qv.w, kv.w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = row0 + 4 * g + r;
      sp[(4 * g + r) * tp + j] = (a.causal && j > i) ? -1e9f : acc[r] * a.scale;
    }
  }
  __syncthreads();

  // row softmax: one warp per row, T ≤ 64 so each lane holds ≤ 2 entries;
  // the padding keys [t, tp) get p = 0
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kRows; r += kSimtThreads / 32) {
    float* row = sp + r * tp;
    float m = -INFINITY;
    for (int j = lane; j < t; j += 32) m = fmaxf(m, row[j]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int j = lane; j < t; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < tp; j += 32)
      row[j] = j < t ? to_f32(from_f32<T>(row[j] / sum)) : 0.f;  // p.astype(v.dtype)
  }
  __syncthreads();

  // output: a unit is 4 query rows × 4 columns; the lanes of a warp take
  // neighbouring column groups of the same 4 rows (P read by broadcast)
  const int groups = hdp / 4;
  T* o = static_cast<T*>(a.o);
  for (int u = threadIdx.x; u < 4 * groups; u += kSimtThreads) {
    const int g = u / groups, c = 4 * (u - g * groups);
    float acc[4][4] = {};
    for (int j = 0; j < tp; j += 4) {
      float4 p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = *reinterpret_cast<const float4*>(sp + (4 * g + r) * tp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(sv + (j + jj) * ld + c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float pr = jj == 0 ? p[r].x : jj == 1 ? p[r].y : jj == 2 ? p[r].z : p[r].w;
          acc[r][0] = fmaf(pr, vv.x, acc[r][0]);
          acc[r][1] = fmaf(pr, vv.y, acc[r][1]);
          acc[r][2] = fmaf(pr, vv.z, acc[r][2]);
          acc[r][3] = fmaf(pr, vv.w, acc[r][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = row0 + 4 * g + r;
      if (i >= t) continue;
      T* dst = o + ((static_cast<size_t>(bi) * t + i) * a.heads + hi) * hd + c;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        if (c + cc < hd) dst[cc] = from_f32<T>(acc[r][cc]);
    }
  }
}

// ------------------------------------------------------------ tensor-core path

__host__ __device__ __forceinline__ int mma_ld(int hd) { return hd + 8; }  // bf16
__host__ __device__ __forceinline__ int round16(int t) { return (t + 15) / 16 * 16; }

__host__ __device__ __forceinline__ size_t mma_smem_bytes(int t, int hd) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(kRows + 2 * round16(t)) * mma_ld(hd);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// rows [0, n_pad) of a (rows, hd) bf16 operand into shared memory by cp.async
// (rows ≥ n zero-filled); one warp
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                           long long stride, int n, int n_pad, int hd) {
  const int chunks = hd / 8;
  for (int idx = threadIdx.x; idx < n_pad * chunks; idx += 32) {
    const int r = idx / chunks, c = 8 * (idx - r * chunks);
    const bool valid = r < n;
    cp_async16(dst + r * ld + c, valid ? src + r * stride + c : src, valid);
  }
}

__global__ void __launch_bounds__(32) mha_mma_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int t = a.t, hd = a.hd, ld = mma_ld(hd), tp = round16(t);
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem4);  // (16, ld)
  __nv_bfloat16* sk = sq + kRows * ld;                          // (tp, ld)
  __nv_bfloat16* sv = sk + tp * ld;                             // (tp, ld)
  const int lane = threadIdx.x;
  const int bi = blockIdx.x / a.heads, hi = blockIdx.x % a.heads;
  const int row0 = blockIdx.y * kRows;
  using bf16 = __nv_bfloat16;
  stage_bf16(sq, ld, static_cast<const bf16*>(a.q) + bi * a.qs[0] + hi * a.qs[1] + row0 * a.qs[2],
             a.qs[2], min(kRows, t - row0), kRows, hd);
  stage_bf16(sk, ld, static_cast<const bf16*>(a.k) + bi * a.ks[0] + hi * a.ks[1], a.ks[2], t,
             tp, hd);
  cp_async_commit();
  stage_bf16(sv, ld, static_cast<const bf16*>(a.v) + bi * a.vs[0] + hi * a.vs[1], a.vs[2], t,
             tp, hd);
  cp_async_commit();
  cp_async_wait<1>();  // Q and K; V still in flight
  __syncwarp();

  // S = Q·Kᵀ: key tiles of 8 columns, up to 8 (T ≤ 64)
  const int mi = lane >> 3, mr = lane & 7;
  const int key_tiles = tp / 16;
  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  for (int kc = 0; kc < hd / 16; ++kc) {
    uint32_t qa[4];
    ldmatrix_x4(qa, sq + ((mi & 1) * 8 + mr) * ld + 16 * kc + (mi >> 1) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np < key_tiles) {
        uint32_t kb[4];
        ldmatrix_x4(kb, sk + (16 * np + (mi >> 1) * 8 + mr) * ld + 16 * kc + (mi & 1) * 8);
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }
  }

  // softmax on the fragments: a lane holds rows r0 = lane/4 (s[n][0..1]) and
  // r0 + 8 (s[n][2..3]) at columns 8n + 2·(lane % 4) + {0, 1}; the 4 lanes
  // of a quad hold one row
  const int r0 = lane >> 2, c0 = 2 * (lane & 3);
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n < 2 * key_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + r0 + (e >> 1) * 8, j = 8 * n + c0 + (e & 1);
        float x = s[n][e] * a.scale;
        if (j >= t) x = -INFINITY;  // padding key: no weight
        else if (a.causal && j > i) x = -1e9f;
        s[n][e] = x;
        m[e >> 1] = fmaxf(m[e >> 1], x);
      }
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n < 2 * key_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(s[n][e] - m[e >> 1]);
        s[n][e] = x;
        sum[e >> 1] += x;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
  // P rounded to bf16, laid out as the A operand of P·V: key chunk kc is
  // the accumulator tiles 2kc and 2kc + 1
  uint32_t pa[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    if (kc < key_tiles) {
      pa[kc][0] = pack_bf16(s[2 * kc][0] / sum[0], s[2 * kc][1] / sum[0]);
      pa[kc][1] = pack_bf16(s[2 * kc][2] / sum[1], s[2 * kc][3] / sum[1]);
      pa[kc][2] = pack_bf16(s[2 * kc + 1][0] / sum[0], s[2 * kc + 1][1] / sum[0]);
      pa[kc][3] = pack_bf16(s[2 * kc + 1][2] / sum[1], s[2 * kc + 1][3] / sum[1]);
    }
  }

  cp_async_wait<0>();  // V
  __syncwarp();
  // O = P·V, 16 columns at a time, stored as (B, T, H, hd)
  bf16* o = static_cast<bf16*>(a.o);
  const int i0 = row0 + r0;
  bf16* row_a = o + ((static_cast<size_t>(bi) * t + i0) * a.heads + hi) * hd;
  bf16* row_b = row_a + static_cast<size_t>(8) * a.heads * hd;
  for (int dp = 0; dp < hd / 16; ++dp) {
    float acc[2][4] = {};
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      if (kc < key_tiles) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sv + (16 * kc + (mi & 1) * 8 + mr) * ld + 16 * dp + (mi >> 1) * 8);
        mma_bf16(acc[0], pa[kc], vb[0], vb[1]);
        mma_bf16(acc[1], pa[kc], vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = 16 * dp + 8 * n + c0;
      if (i0 < t)
        *reinterpret_cast<uint32_t*>(row_a + col) = pack_bf16(acc[n][0], acc[n][1]);
      if (i0 + 8 < t)
        *reinterpret_cast<uint32_t*>(row_b + col) = pack_bf16(acc[n][2], acc[n][3]);
    }
  }
}

// the opt-in above 48 KB is per kernel; raise it once to the largest size
// asked for so far (a repeated or racing call only sets it again)
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, size_t& opted_in) {
  if (smem <= opted_in) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) opted_in = smem;
  return err;
}

}  // namespace

extern "C" {

// q, k, v: (b, heads, t, hd) views with unit stride on hd and the given
// batch, head and token strides (elements); o: a contiguous (b, t, heads, hd)
// buffer; all of one dtype (is_bf16 = 0: float32, 1: bfloat16). path 1 is
// the tensor-core path (bf16, hd % 16 == 0, 16-byte aligned pointers,
// strides multiples of 8); path 0 the CUDA-core path, vec4 = 1 reading f32
// rows as float4 (hd % 4 == 0, 16-byte aligned pointers, strides multiples
// of 4). Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for arguments the kernel does not take); 0 is success.
int tgi_fused_mha(const void* q, const void* k, const void* v, void* o, long long qsb,
                  long long qsh, long long qst, long long ksb, long long ksh, long long kst,
                  long long vsb, long long vsh, long long vst, int b, int heads, int t, int hd,
                  int causal, int is_bf16, int path, int vec4, float scale, void* stream) {
  if (b < 1 || heads < 1 || t < 1 || t > kMaxT || hd < 1 || hd > kMaxHd ||
      static_cast<long long>(b) * heads > 0x7fffffffLL || (path == 1 && (!is_bf16 || hd % 16)) ||
      (vec4 && (is_bf16 || hd % 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, {qsb, qsh, qst}, {ksb, ksh, kst}, {vsb, vsh, vst},
               heads, t, hd, causal, scale};
  const dim3 grid(b * heads, (t + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (path == 1) {
    static size_t opted = kStaticSmemLimit;
    const size_t smem = mma_smem_bytes(t, hd);
    if ((err = opt_in(mha_mma_kernel, smem, opted)) != cudaSuccess) return static_cast<int>(err);
    mha_mma_kernel<<<grid, 32, smem, s>>>(a);
  } else if (is_bf16) {
    static size_t opted = kStaticSmemLimit;
    const size_t smem = simt_smem_bytes(t, hd);
    if ((err = opt_in(mha_simt_kernel<__nv_bfloat16>, smem, opted)) != cudaSuccess)
      return static_cast<int>(err);
    mha_simt_kernel<__nv_bfloat16><<<grid, kSimtThreads, smem, s>>>(a, 0);
  } else {
    static size_t opted = kStaticSmemLimit;
    const size_t smem = simt_smem_bytes(t, hd);
    if ((err = opt_in(mha_simt_kernel<float>, smem, opted)) != cudaSuccess)
      return static_cast<int>(err);
    mha_simt_kernel<float><<<grid, kSimtThreads, smem, s>>>(a, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tgi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
