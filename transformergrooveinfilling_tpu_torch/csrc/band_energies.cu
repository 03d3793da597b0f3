// Framing + Hann window + real FFT + |X| + log-frequency band projection for
// the MSO front end, sm_90a.
//
// Counterpart of the Pallas kernel transformergrooveinfilling_tpu/ops/
// mso_pallas.py::_band_energy_kernel (under band_energies_pallas): windowed
// frames of n_fft = 1024 samples → |DFT| over bins 0 .. 511 (Nyquist dropped,
// as the TPU kernel drops it) → projection onto 16 filterbank columns
// (512, 16). Neither the frames nor the (frames, 512) magnitude reach device
// memory.
//
// What bounds it on the H100: the waveform read once (4 bytes a sample) and
// an FFT's operations (about 44,000 a frame with the magnitude and the
// projection) at the f32 rate of the CUDA cores; the two are close, 0.014 and
// 0.018 ms for a chunk of 64 loops at 120 bpm. The TPU kernel's dense DFT
// products (4·1024·512 FLOP a frame, 50× an FFT) are not carried over.
//
// Design:
// - Framing in the kernel. Frame f of item i reads samples
//   f·hop − pad + n (n < 1024) of row i, reflected about 0 and about L − 1
//   (the reflect padding of ops/mso.py::_reflect_pad, by index), times the
//   window tensor passed in, so each windowed sample is the same f32 product
//   as the plain version's. The frames entry of the wrapper calls the same
//   kernel with hop = 1024, pad = 0 and no window.
// - One warp a frame, several warps a block, each warp walking frames with a
//   grid stride; a block loads the twiddles and the filterbank into shared
//   memory once. One request's 418 frames make 105 blocks, a chunk's 26,752
//   fill 3 blocks on each SM, with no split of the work and no second kernel.
// - The 1024-point real transform is a 512-point complex FFT of
//   z[m] = x[2m] + i·x[2m+1] in three radix-8 Stockham passes (two
//   butterflies a lane, held in registers, exchanged through the warp's own
//   4.3 KB of shared memory, padded by one slot in 16 against bank
//   conflicts), then the split X[k] = E[k] + W^k·O[k]. The twiddles
//   W^m = exp(−2πi·m/1024), m < 1024, are built on the host in f64 and cast
//   once (ops/band_energies.py::twiddle_table).
// - Lane l takes bins l + 32·i: |X|, then 16 band partial sums against
//   filterbank rows padded to 20 floats (conflict-free float4 loads), each
//   group of 4 bands over only the chunks of 32 bins where the filterbank
//   has weight for it (found by each block from the filterbank itself); the
//   16 partials are summed over the warp by halving exchanges, so lane pair
//   (2b, 2b + 1) ends with band b. f32 throughout, no TF32, no tensor cores,
//   no atomics: every sum has a fixed order and reruns are bit-identical.
// - The next frame's samples are loaded into registers while the current one
//   is transformed, and the window stays in registers.
//
// Plain C entry points, bound from Python with ctypes
// (ops/band_energies.py); the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kNfft = 1024;
constexpr int kHalf = kNfft / 2;    // complex points of the FFT, bins kept
constexpr int kBands = 16;
constexpr int kFbStride = 20;       // padded filterbank row, floats
constexpr int kWarps = 4;           // frames in flight a block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 3;
constexpr int kBufSlots = kHalf + kHalf / 16;  // float2 slots a warp
constexpr size_t kSmemBytes =
    sizeof(float) * kHalf * kFbStride + sizeof(float2) * kNfft +
    sizeof(float2) * kBufSlots * kWarps;
constexpr float kSqrtHalf = 0.70710678118654752f;

// the padded slot of complex point m: one spare slot after every 16
__device__ __forceinline__ int slot(int m) { return m + (m >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// (−i)·a
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }

// in-place 4-point DFT, natural order
__device__ __forceinline__ void dft4(float2& x0, float2& x1, float2& x2, float2& x3) {
  const float2 s0 = cadd(x0, x2), d0 = csub(x0, x2);
  const float2 s1 = cadd(x1, x3), d1 = mul_mi(csub(x1, x3));
  x0 = cadd(s0, s1);
  x2 = csub(s0, s1);
  x1 = cadd(d0, d1);
  x3 = csub(d0, d1);
}

// in-place 8-point DFT, natural order: X[k] = Σ_r v[r]·exp(−2πi·rk/8)
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  float2 a0 = v[0], a1 = v[2], a2 = v[4], a3 = v[6];
  float2 b0 = v[1], b1 = v[3], b2 = v[5], b3 = v[7];
  dft4(a0, a1, a2, a3);
  dft4(b0, b1, b2, b3);
  // W8^1, W8^2 = −i, W8^3 applied to the odd half
  b1 = make_float2((b1.x + b1.y) * kSqrtHalf, (b1.y - b1.x) * kSqrtHalf);
  b2 = mul_mi(b2);
  b3 = make_float2((b3.y - b3.x) * kSqrtHalf, -(b3.x + b3.y) * kSqrtHalf);
  v[0] = cadd(a0, b0);
  v[4] = csub(a0, b0);
  v[1] = cadd(a1, b1);
  v[5] = csub(a1, b1);
  v[2] = cadd(a2, b2);
  v[6] = csub(a2, b2);
  v[3] = cadd(a3, b3);
  v[7] = csub(a3, b3);
}

// One radix-8 Stockham pass over the warp's 512 points (Ns = 1, 8, 64):
// butterfly j reads points j + 64·r, twiddles them by
// exp(−2πi·(j mod Ns)·r / (8·Ns)), and writes its outputs to
// (j / Ns)·8·Ns + (j mod Ns) + r·Ns. The output ends in natural order.
template <int Ns>
__device__ __forceinline__ void radix8_pass(float2* buf, const float2* tw, int lane) {
  float2 v[2][8];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int j = lane + 32 * b;
#pragma unroll
    for (int r = 0; r < 8; ++r) v[b][r] = buf[slot(j + 64 * r)];
    if (Ns > 1) {
      const int k = j % Ns;
#pragma unroll
      for (int r = 1; r < 8; ++r) v[b][r] = cmul(v[b][r], tw[k * r * (kNfft / (8 * Ns))]);
    }
    dft8(v[b]);
  }
  __syncwarp();
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int j = lane + 32 * b;
    const int base = (j / Ns) * 8 * Ns + (j % Ns);
#pragma unroll
    for (int r = 0; r < 8; ++r) buf[slot(base + r * Ns)] = v[b][r];
  }
  __syncwarp();
}

// one halving of the warp's band partials: lanes whose bit `Offset` is set
// keep bands [Half, 2·Half) of the current set, the others [0, Half); each
// adds its partner's copy of the half it keeps (a + b == b + a, so both
// lanes of a pair hold the same sum)
template <int Half, int Offset>
__device__ __forceinline__ void halve(float (&acc)[kBands], int lane) {
  const bool upper = lane & Offset;
#pragma unroll
  for (int b = 0; b < Half; ++b) {
    const float give = upper ? acc[b] : acc[b + Half];
    const float keep = upper ? acc[b + Half] : acc[b];
    acc[b] = keep + __shfl_xor_sync(0xffffffffu, give, Offset);
  }
}

// the 32 samples of frame g that lane `lane` holds (n = lane + 32·i); frames
// inside the waveform load straight, the edge frames reflect each index
__device__ __forceinline__ void load_frame(float (&xs)[kNfft / 32], const float* __restrict__ y,
                                           int g, int length, int frames_per_item, int hop,
                                           int pad, int lane) {
  const int item = g / frames_per_item;
  const int start = (g - item * frames_per_item) * hop - pad;
  const float* row = y + static_cast<size_t>(item) * length;
  if (start >= 0 && start + kNfft <= length) {
#pragma unroll
    for (int i = 0; i < kNfft / 32; ++i) xs[i] = __ldg(row + start + lane + 32 * i);
  } else {
#pragma unroll
    for (int i = 0; i < kNfft / 32; ++i) {
      int s = start + lane + 32 * i;
      if (s < 0) s = -s;                        // reflect about 0
      if (s >= length) s = 2 * (length - 1) - s;  // ... and about L − 1
      xs[i] = __ldg(row + s);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    band_energies_kernel(const float* __restrict__ y,
                         const float* __restrict__ window,
                         const float* __restrict__ fb,
                         const float2* __restrict__ twiddles,
                         float* __restrict__ out, int n_frames, int length,
                         int frames_per_item, int hop, int pad) {
  extern __shared__ float4 smem4[];
  float* fbs = reinterpret_cast<float*>(smem4);                // (512, 20)
  float2* tw = reinterpret_cast<float2*>(fbs + kHalf * kFbStride);  // (1024)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float2* buf = tw + kNfft + warp * kBufSlots;
  float* bufr = reinterpret_cast<float*>(buf);

  // the tables, as float4s, every load of a thread issued before its stores
  {
    constexpr int kFb4 = kHalf * kBands / 4 / kThreads, kTw4 = kNfft / 2 / kThreads;
    float4 f[kFb4], w[kTw4];
#pragma unroll
    for (int r = 0; r < kFb4; ++r)
      f[r] = __ldg(reinterpret_cast<const float4*>(fb) + threadIdx.x + r * kThreads);
#pragma unroll
    for (int r = 0; r < kTw4; ++r)
      w[r] = __ldg(reinterpret_cast<const float4*>(twiddles) + threadIdx.x + r * kThreads);
#pragma unroll
    for (int r = 0; r < kFb4; ++r) {
      const int i = threadIdx.x + r * kThreads;  // row i / 4, bands 4·(i % 4) ..
      reinterpret_cast<float4*>(fbs + (i >> 2) * kFbStride)[i & 3] = f[r];
    }
#pragma unroll
    for (int r = 0; r < kTw4; ++r)
      reinterpret_cast<float4*>(tw)[threadIdx.x + r * kThreads] = w[r];
  }
  // which chunks of 32 bins each group of 4 bands has weight in: the
  // projection walks only [chunk_lo, chunk_hi] of each group (all 16 chunks
  // for a dense filterbank; the triangular one touches 22 of 64)
  __shared__ int live[kBands / 4][kHalf / 32];
  __shared__ int chunk_lo[kBands / 4], chunk_hi[kBands / 4];
  __syncthreads();
  if (threadIdx.x < kBands / 4 * (kHalf / 32)) {
    const int q = threadIdx.x / (kHalf / 32), i = threadIdx.x % (kHalf / 32);
    bool any = false;
    for (int k = 32 * i; k < 32 * i + 32; ++k)
      for (int b = 4 * q; b < 4 * q + 4; ++b) any |= fbs[k * kFbStride + b] != 0.f;
    live[q][i] = any;
  }
  __syncthreads();
  if (threadIdx.x < kBands / 4) {
    int lo = kHalf / 32, hi = -1;
    for (int i = 0; i < kHalf / 32; ++i)
      if (live[threadIdx.x][i]) lo = min(lo, i), hi = i;
    chunk_lo[threadIdx.x] = lo;
    chunk_hi[threadIdx.x] = hi;
  }
  __syncthreads();

  // the window, in registers for every frame (ones without a window: exact)
  float wr[kNfft / 32];
#pragma unroll
  for (int i = 0; i < kNfft / 32; ++i) wr[i] = window ? __ldg(window + lane + 32 * i) : 1.f;

  // each warp walks frames with a grid stride; the next frame's samples are
  // loaded into registers while the current one is transformed
  const int stride = gridDim.x * kWarps;
  int g = blockIdx.x * kWarps + warp;
  float xs[kNfft / 32];
  if (g < n_frames) load_frame(xs, y, g, length, frames_per_item, hop, pad, lane);
  for (; g < n_frames; g += stride) {
    // the windowed frame, sample n into the real or imaginary part of
    // complex point n / 2
#pragma unroll
    for (int i = 0; i < kNfft / 32; ++i) {
      const int n = lane + 32 * i;
      bufr[2 * slot(n >> 1) + (n & 1)] = xs[i] * wr[i];
    }
    if (g + stride < n_frames)
      load_frame(xs, y, g + stride, length, frames_per_item, hop, pad, lane);
    __syncwarp();
    radix8_pass<1>(buf, tw, lane);
    radix8_pass<8>(buf, tw, lane);
    radix8_pass<64>(buf, tw, lane);

    // split: X[k] = E[k] + W^k·O[k] with E = (Z[k] + conj Z[512−k]) / 2,
    // O = −i·(Z[k] − conj Z[512−k]) / 2; |X[k]| back into the warp's buffer
    float mag[kHalf / 32];
#pragma unroll
    for (int i = 0; i < kHalf / 32; ++i) {
      const int k = lane + 32 * i;
      const float2 a = buf[slot(k)];
      const float2 c = buf[slot((kHalf - k) & (kHalf - 1))];  // conj: (c.x, −c.y)
      const float2 e = make_float2((a.x + c.x) * 0.5f, (a.y - c.y) * 0.5f);
      const float2 o = make_float2((a.y + c.y) * 0.5f, -(a.x - c.x) * 0.5f);
      const float2 xk = cadd(e, cmul(tw[k], o));
      mag[i] = sqrtf(xk.x * xk.x + xk.y * xk.y);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kHalf / 32; ++i) bufr[lane + 32 * i] = mag[i];
    __syncwarp();
    // the 16 band partials of this lane's bins, each group of 4 bands over
    // its live chunks in order
    float acc[kBands];
#pragma unroll
    for (int b = 0; b < kBands; ++b) acc[b] = 0.f;
#pragma unroll
    for (int q = 0; q < kBands / 4; ++q) {
      for (int i = chunk_lo[q]; i <= chunk_hi[q]; ++i) {
        const int k = lane + 32 * i;
        const float m = bufr[k];
        const float4 w = reinterpret_cast<const float4*>(fbs + k * kFbStride)[q];
        acc[4 * q + 0] = fmaf(m, w.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(m, w.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(m, w.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(m, w.w, acc[4 * q + 3]);
      }
    }
    // sum the 16 partials over the warp: at each halving a lane keeps the
    // half of the bands that its bit selects and adds its partner's copy
    halve<8, 16>(acc, lane);
    halve<4, 8>(acc, lane);
    halve<2, 4>(acc, lane);
    halve<1, 2>(acc, lane);
    const float band = acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 1);
    if ((lane & 1) == 0) out[static_cast<size_t>(g) * kBands + (lane >> 1)] = band;
    __syncwarp();  // buf is rewritten by the next frame
  }
}

}  // namespace

extern "C" {

// y: (items, length) float32 samples; window: (1024,) float32 or null (no
// window); fb: (512, 16) filterbank rows and twiddles: (1024,) complex
// float32, both 16-byte aligned;
// out: (items · frames_per_item, 16). Frame f of item i covers samples
// f·hop − pad .. f·hop − pad + 1023, reflected at both ends (pad < length).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take); 0 is success.
int tgi_band_energies(const void* y, const void* window, const void* fb,
                      const void* twiddles, void* out, int items, int length,
                      int frames_per_item, int hop, int pad, void* stream) {
  if (items < 1 || frames_per_item < 1 || hop < 1 || pad < 0 || pad >= length ||
      static_cast<long long>(items) * frames_per_item > 0x7fffffffLL ||
      static_cast<long long>(frames_per_item - 1) * hop - pad + kNfft > length + pad)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;  // per process; a racing call only sets it again
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        band_energies_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_frames = items * frames_per_item;
  const int wanted = (n_frames + kWarps - 1) / kWarps;
  const int blocks = wanted < sms * kBlocksPerSm ? wanted : sms * kBlocksPerSm;
  band_energies_kernel<<<blocks, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(window),
      static_cast<const float*>(fb), static_cast<const float2*>(twiddles),
      static_cast<float*>(out), n_frames, length, frames_per_item, hop, pad);
  return static_cast<int>(cudaGetLastError());
}

const char* tgi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
