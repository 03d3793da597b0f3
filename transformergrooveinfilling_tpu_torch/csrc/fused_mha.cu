// Fused multi-head attention for the serving path, sm_90a.
//
// Counterpart of the Pallas kernel transformergrooveinfilling_tpu/ops/
// attention.py::_mha_kernel: softmax(Q·Kᵀ/√hd, optional causal mask)·V over
// (batch, head, T, hd), T ≤ 2,048, any hd, float32 or bfloat16. Math as the TPU
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
// Past T 64 (loops longer than 4 bars at sixteenths) a warp's 16 × T scores
// outgrow its registers, and the long route takes over, a (batch, head) split
// by its query rows over blocks. The rule (ops/attention.py::route states it
// too): where hd ≤ 128 and TMA can read the views (hd·element size, every
// stride and every base pointer a multiple of 16 bytes, no stride 0: copy ==
// 16), the flash form of attn_flash_sm90.cuh, on TMA and wgmma (work items of
// 128 query rows, 64 where B·H·⌈T/64⌉ items fill no more than one wave; at
// most one persistent block an SM). Every other long shape takes the scores
// form (attn_stream_sm90.cuh): each block's (rows × T) f32 scores lie in
// shared memory (64 rows a block up to T 256, 32 up to 512, 16 past it: 66 KB
// of scores at T 256, 512 and 1,024) while the head's columns stream through a
// cp.async ring in 64-byte chunks: scores key tile by key tile, the softmax
// row by row, then the output chunk by chunk, a fresh accumulator a key tile.
// Past T 256 the work grows as T²·hd against 4·T·hd bytes, and from about T
// 600 in bf16 it is bound by the tensor cores' operations, not by memory. The
// rule is decided before the launch; a refused encode or launch returns its
// error.
//
// Plain C entry points, bound from Python with ctypes
// (ops/attention.py); the launch returns cudaGetLastError().

#include "attn_flash_sm90.cuh"
#include "attn_stream_sm90.cuh"

namespace {

constexpr int kShortT = 16 * attn::kMaxKt;  // the short route's: a block per (batch, head)
// The longest sequence, the long route's (a (batch, head) split by query
// rows, the scores in shared memory): 16 query rows a block past T 512, 16 ×
// (T + 4) f32 scores, 131 KB at T 2,048, 162 KB with the ring, of the 232 KB
// a block may take. The TPU kernel holds a (batch, head)'s (T, T) f32 scores
// in VMEM beside its (T, hd) q, k, v and o blocks, double-buffered: at T
// 2,048 the scores alone are 16 MB, v5e's whole scoped VMEM, so it cannot
// compile there, and this ceiling lies above the TPU kernel's.
constexpr int kMaxT = attn::kLongMaxT;
constexpr int kStages = 4;  // the short route's ring
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

// The long route (T past 64): block (batch·head)·n_qb + qb takes query rows
// 16·QW·qb .. of its (batch, head), all T keys
template <class E, int QW>
__global__ void __launch_bounds__(32 * attn::kLongWarps) mha_long_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int QR = 16 * QW;
  const int n_qb = (a.t + QR - 1) / QR, qb = blockIdx.x % n_qb;
  const long long head = blockIdx.x / n_qb, bi = head / a.heads, hi = head % a.heads;
  const attn::Rows<E> q{static_cast<const E*>(a.q) + bi * a.qs[0] + hi * a.qs[1], a.qs[2]};
  const attn::Rows<E> k{static_cast<const E*>(a.k) + bi * a.ks[0] + hi * a.ks[1], a.ks[2]};
  const attn::Rows<E> v{static_cast<const E*>(a.v) + bi * a.vs[0] + hi * a.vs[1], a.vs[2]};
  const long long row = static_cast<long long>(a.heads) * a.hd;  // (B, T, H, hd)
  const attn::Out<E> out(static_cast<E*>(a.o) + bi * a.t * row + hi * a.hd, row, a.t, a.hd);
  attn::long_forward<E, QW>(smem, q, k, v, out, a.t, a.hd, QR * qb, a.scale, a.causal != 0,
                            -1e9f, a.copy, attn::NoDrop{});
}

// the opt-in above 48 KB is per kernel; raise it to the largest size asked
// of it so far
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, size_t& opted) {
  if (smem <= kStaticSmemLimit || smem <= opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) opted = smem;
  return err;
}

// a long-route kernel, `rows` query rows a block, `smem` bytes of it
template <typename Kernel>
int launch_blocks(Kernel kernel, size_t& opted, size_t smem, int rows, const Args& a, int b,
                cudaStream_t stream) {
  const cudaError_t err = opt_in(kernel, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(b) * a.heads * ((a.t + rows - 1) / rows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), 32 * attn::kLongWarps, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class E, int QW>
int launch_long(const Args& a, int b, cudaStream_t stream) {
  static size_t opted = 0;
  return launch_blocks(mha_long_kernel<E, QW>, opted, attn::LongFwd<E, QW>::smem(a.t), 16 * QW, a,
                     b, stream);
}

// the card's SMs (once)
inline int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// The flash form (attn_flash_sm90.cuh): 4-D tensor maps of q, k, v and the
// (B, T, H, hd) output, encoded each call (so a CUDA graph captures the
// launch with its maps), and a block per kRows query rows of a (batch, head)
template <class E, int WG>
int launch_flash(const Args& a, int b, cudaStream_t stream) {
  using C = flash::Cfg<E, WG>;
  auto kernel = flash::flash_kernel<E, WG>;
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  if (const int err = sm90::bind_context()) return err;
  flash::Maps maps;
  const long long row = static_cast<long long>(a.heads) * a.hd;  // (B, T, H, hd)
  int err = flash::make_map<E>(&maps.q, a.q, a.hd, a.t, a.heads, b, a.qs[2], a.qs[1], a.qs[0],
                               C::kRows);
  if (!err) err = flash::make_map<E>(&maps.k, a.k, a.hd, a.t, a.heads, b, a.ks[2], a.ks[1],
                                     a.ks[0], C::kKeys);
  if (!err) err = flash::make_map<E>(&maps.v, a.v, a.hd, a.t, a.heads, b, a.vs[2], a.vs[1],
                                     a.vs[0], C::kKeys);
  if (!err) err = flash::make_map<E>(&maps.o, a.o, a.hd, a.t, a.heads, b, row, a.hd, a.t * row,
                                     64);
  if (err) return err;
  const int n_qb = (a.t + C::kRows - 1) / C::kRows;
  const long long items = static_cast<long long>(b) * a.heads * n_qb;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const flash::Params p{a.t, a.heads, a.hd, n_qb, static_cast<int>(items), a.causal, a.scale,
                        -1e9f};
  const long long blocks = items > sm_count() ? sm_count() : items;  // persistent
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, stream>>>(maps, p);
  return static_cast<int>(cudaGetLastError());
}

// the flash form's rule (ops/attention.py::route): hd ≤ 128, TMA's 16-byte
// alignment (copy 16: hd·element size, every stride and base pointer), no stride 0
bool flash_form(const Args& a) {
  if (a.hd > flash::kHd || a.copy != 16) return false;
  const long long* strides[3] = {a.qs, a.ks, a.vs};
  for (int j = 0; j < 3; ++j)
    for (int i = 0; i < 3; ++i)
      if (strides[j][i] == 0) return false;
  return true;
}

// blocks of 128 query rows, 64 where those fill no more than one wave
inline int flash_wg(const Args& a, int b) {
  return static_cast<long long>(b) * a.heads * ((a.t + 63) / 64) <= sm_count() ? 1 : 2;
}

template <class E, int KT, int S>
int launch(Args a, int b, cudaStream_t stream) {
  static size_t opted = 0;
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
  if (a.t > kShortT && flash_form(a)) {
    return flash_wg(a, b) == 2 ? launch_flash<E, 2>(a, b, stream)
                               : launch_flash<E, 1>(a, b, stream);
  }
  if (a.t > kShortT) switch (attn::long_qw(a.t)) {
      case 4: return launch_long<E, 4>(a, b, stream);
      case 2: return launch_long<E, 2>(a, b, stream);
      default: return launch_long<E, 1>(a, b, stream);
    }
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
