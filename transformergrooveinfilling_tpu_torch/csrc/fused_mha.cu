// Fused multi-head attention for the serving path, sm_90a.
//
// Counterpart of the Pallas kernel transformergrooveinfilling_tpu/ops/
// attention.py::_mha_kernel: softmax(Q·Kᵀ/√hd, optional causal mask)·V over
// (batch, head, T, hd), T ≤ 64, any hd, float32 or bfloat16. Math as the TPU
// kernel does it:
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
// What bounds it on the H100: one (batch, head) is two (T × T × hd) products
// around a (T × T) softmax, 4·T·hd FLOP a query row against 4·hd values of
// Q, K, V and O: at T 32 about 32 FLOP a byte in f32 (64 in bf16), below the
// card's balance point in either type, so the floor is memory (at hd 512, B
// 512: 40 µs in f32, 20 µs in bf16); at batch 1 it is one block's latency.
//
// Design (attn_stream_sm90.cuh): one block per (batch, head), a warp for
// every 16 query rows (T 32: two warps), the scores in registers for the
// whole head while the head's columns stream through a four-stage cp.async
// ring, 128 bytes of each row a stage (Q and K, then V two chunks a stage;
// every chunk of a head of 128 in flight at once), each warp's output chunk
// staged in shared memory and stored 16 bytes a lane: 41 KB of shared memory
// a block in bf16 and 45 KB in f32 at T 32, whatever hd is, so several
// blocks share an SM at every width and hd has no limit but int32 indexing.
// More stages do not help a wide head: a block's 64 threads keep the same
// bytes in flight whatever the ring's depth. So where the (batch, head)s are
// fewer than two an SM (B 1 serving), a head's columns are split over a
// thread-block cluster of up to 8 blocks on 8 SMs, which add their partial
// scores through distributed shared memory in rank order (staged in a spent
// stage of the ring) and each store their columns; at B 512 a block a head.
// Every product runs on the tensor cores: bf16 as mma.sync m16n8k16, f32 in
// split TF32 (m16n8k8), P rounded to the input dtype before P·V. The first
// designs kept the whole head in shared memory (167 KB a block in f32 at hd
// 512, one block an SM; bf16 one warp a block) and ran 2.2× slower than SDPA
// at hd 512 (PERF.md §6).
//
// Plain C entry points, bound from Python with ctypes
// (ops/attention.py); the launch returns cudaGetLastError().

#include "attn_stream_sm90.cuh"

namespace {

constexpr int kMaxT = 16 * attn::kMaxKt;
constexpr int kStages = 4;  // the ring's
constexpr size_t kStaticSmemLimit = 48 * 1024;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3];  // batch, head, token strides (elements)
  int heads, t, hd, causal, copy;
  int ranks;  // the blocks of a (batch, head): a cluster that splits its columns
  float scale;
};

// block (batch·head)·ranks + rank; rank takes ⌈n / ranks⌉ of the head's n
// chunks from chunk rank·⌈n / ranks⌉ (the last ranks fewer, past n none)
template <class E, int KT, int S>
__global__ void __launch_bounds__(32 * KT) mha_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = blockIdx.x % a.ranks;
  const long long head = blockIdx.x / a.ranks, bi = head / a.heads, hi = head % a.heads;
  const attn::Rows<E> q{static_cast<const E*>(a.q) + bi * a.qs[0] + hi * a.qs[1], a.qs[2]};
  const attn::Rows<E> k{static_cast<const E*>(a.k) + bi * a.ks[0] + hi * a.ks[1], a.ks[2]};
  const attn::Rows<E> v{static_cast<const E*>(a.v) + bi * a.vs[0] + hi * a.vs[1], a.vs[2]};
  const long long row = static_cast<long long>(a.heads) * a.hd;  // (B, T, H, hd)
  const attn::Out<E> out(static_cast<E*>(a.o) + bi * a.t * row + hi * a.hd, row, a.t, a.hd);
  const attn::Share sh(a.hd, attn::fwd_cw<E>(), rank, a.ranks);
  attn::forward<E, KT, S>(smem, q, k, v, out, a.t, sh.per, sh.c_begin, sh.c_end, a.scale,
                          a.causal != 0, -1e9f, a.copy, attn::NoDrop{},
                          attn::Split{rank, a.ranks});
}

// the opt-in above 48 KB is per kernel (T past 32); raise it once, to the
// kernel's fixed size
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, bool& done) {
  if (smem <= kStaticSmemLimit || done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) done = true;
  return err;
}

template <class E, int KT, int S>
int launch(Args a, int b, cudaStream_t stream) {
  static bool opted = false;
  constexpr size_t smem = attn::forward_smem<E, KT, S>();
  const cudaError_t err = opt_in(mha_kernel<E, KT, S>, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long heads = static_cast<long long>(b) * a.heads;
  constexpr int CW = attn::fwd_cw<E>();
  a.ranks = attn::ranks_for(heads, (a.hd + CW - 1) / CW);
  return static_cast<int>(
      attn::launch_clustered(mha_kernel<E, KT, S>, heads, a.ranks, 32 * KT, smem, stream, a));
}

template <class E, int S>
int launch_by_t(const Args& a, int b, cudaStream_t stream) {
  switch ((a.t + 15) / 16) {
    case 1: return launch<E, 1, S>(a, b, stream);
    case 2: return launch<E, 2, S>(a, b, stream);
    case 3: return launch<E, 3, S>(a, b, stream);
    default: return launch<E, 4, S>(a, b, stream);
  }
}

}  // namespace

extern "C" {

// q, k, v: (b, heads, t, hd) views with unit stride on hd and the given
// batch, head and token strides (elements); o: a contiguous (b, t, heads, hd)
// buffer; all of one dtype (is_bf16 = 0: float32, 1: bfloat16). copy: the
// bytes of each cp.async (16, 8 or 4: every stride, hd and base pointer a
// multiple of it), or 2 in bf16 (element loads). Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does not
// take); 0 is success.
int tgi_fused_mha(const void* q, const void* k, const void* v, void* o, long long qsb,
                  long long qsh, long long qst, long long ksb, long long ksh, long long kst,
                  long long vsb, long long vsh, long long vst, int b, int heads, int t, int hd,
                  int causal, int is_bf16, int copy, float scale, void* stream) {
  const int esize = is_bf16 ? 2 : 4;
  if (b < 1 || heads < 1 || t < 1 || t > kMaxT || hd < 1 ||
      static_cast<long long>(b) * heads > 0x7fffffffLL ||
      !(copy == 16 || copy == 8 || copy == 4 || (copy == 2 && is_bf16)) ||
      (static_cast<long long>(hd) * esize) % copy)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, {qsb, qsh, qst}, {ksb, ksh, kst}, {vsb, vsh, vst},
               heads, t, hd, causal, copy, 1, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_by_t<__nv_bfloat16, kStages>(a, b, s)
                 : launch_by_t<float, kStages>(a, b, s);
}

const char* tgi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
