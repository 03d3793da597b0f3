// Fused |DFT| + log-frequency band projection for the MSO front end, sm_90a.
//
// Counterpart of the Pallas kernel transformergrooveinfilling_tpu/ops/
// mso_pallas.py::_band_energy_kernel (under band_energies_pallas): windowed
// frames (n, n_fft) against a real/imaginary DFT basis (n_fft, n_bins), the
// magnitude sqrt(re² + im²), and its projection onto n_bands = 16 filterbank
// rows (n_bins, 16). The (n, n_bins) magnitude never reaches device memory.
//
// What it costs: the function itself needs little, frames read once and an
// FFT's O(n_fft·log n_fft) operations per frame, so its bound is the memory
// rate. This first version does not get near it: like the TPU kernel it
// forms the DFT as two dense products, 4·n·n_fft·n_bins FLOP (about 1,000
// per byte of frames at n_fft 1024 and 512 bins), and CUDA-core FMAs limit
// it. The design is a shared-memory-tiled SIMT product in plain f32 (TF32
// would lose the digits that the DFT's 1,024 nearly cancelling terms need):
// a block owns 64 frames, walks the bins in tiles of 64, and for each tile
// accumulates re and im side by side (4×4 per thread, one pass over the
// frames), takes the magnitude, stages it in shared memory and adds its
// projection to 4 band sums per thread. The sums run over the bin tiles in
// order, in registers: no float atomics, so reruns are bit-identical.
//
// With few frames (one request is 418) that grid would be 7 blocks on 132
// SMs, so the bin tiles can be split over gridDim.y; each split writes its
// partial band sums to scratch (split, n, 16) and a second kernel adds the
// partials in split order (one call of the entry point then launches two
// kernels).
//
// The ragged last row block is guarded (rows ≥ n load zeros and store
// nothing); nothing is padded on the host.
//
// Plain C entry points, bound from Python with ctypes
// (ops/band_energies.py); the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;     // frames per block
constexpr int kBN = 64;     // bins per tile
constexpr int kBK = 16;     // samples per step of the contraction
constexpr int kBands = 16;  // filterbank rows
constexpr int kAPad = 4;    // keeps rows of As 16-byte aligned, spreads banks

__global__ void __launch_bounds__(kThreads)
    band_energies_kernel(const float* __restrict__ frames,
                         const float* __restrict__ cosb,
                         const float* __restrict__ sinb,
                         const float* __restrict__ fb, float* __restrict__ out,
                         int n, int n_fft, int n_bins, int tiles_per_block) {
  __shared__ __align__(16) float As[kBK][kBM + kAPad];  // frames, transposed
  __shared__ __align__(16) float Cs[kBK][kBN];
  __shared__ __align__(16) float Ss[kBK][kBN];
  __shared__ float Mag[kBM][kBN + 1];
  __shared__ __align__(16) float Fb[kBN][kBands];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // bins tx*4 .. tx*4+3 of the tile
  const int ty = tid / 16;  // frames ty*4 .. ty*4+3 of the block
  const int row0 = blockIdx.x * kBM;

  // loads: one float4 of frames (4 samples of one frame) and one float4 of
  // each basis (4 bins of one sample) per thread and step
  const int a_row = tid / 4;
  const int a_k = (tid % 4) * 4;
  const bool a_live = row0 + a_row < n;
  const float* a_src = frames + static_cast<size_t>(row0 + a_row) * n_fft + a_k;
  const int b_k = tid / 16;
  const int b_n = (tid % 16) * 4;

  // projection: 4 bands of one frame per thread
  const int p_row = tid / 4;
  const int p_band = (tid % 4) * 4;
  float band[4] = {0.f, 0.f, 0.f, 0.f};

  const int tile_begin = blockIdx.y * tiles_per_block;
  for (int tile = tile_begin; tile < tile_begin + tiles_per_block; ++tile) {
    const int n0 = tile * kBN;
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int k0 = 0; k0 < n_fft; k0 += kBK) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a_live) a = __ldg(reinterpret_cast<const float4*>(a_src + k0));
      const size_t b_off = static_cast<size_t>(k0 + b_k) * n_bins + n0 + b_n;
      const float4 c = __ldg(reinterpret_cast<const float4*>(cosb + b_off));
      const float4 s = __ldg(reinterpret_cast<const float4*>(sinb + b_off));
      As[a_k + 0][a_row] = a.x;
      As[a_k + 1][a_row] = a.y;
      As[a_k + 2][a_row] = a.z;
      As[a_k + 3][a_row] = a.w;
      *reinterpret_cast<float4*>(&Cs[b_k][b_n]) = c;
      *reinterpret_cast<float4*>(&Ss[b_k][b_n]) = s;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 cv = *reinterpret_cast<const float4*>(&Cs[k][tx * 4]);
        const float4 sv = *reinterpret_cast<const float4*>(&Ss[k][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(ar[i], cr[j], re[i][j]);
            im[i][j] = fmaf(ar[i], sr[j], im[i][j]);
          }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Mag[ty * 4 + i][tx * 4 + j] =
            sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
    reinterpret_cast<float4*>(&Fb[0][0])[tid] = __ldg(
        reinterpret_cast<const float4*>(fb + static_cast<size_t>(n0) * kBands) +
        tid);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBN; ++k) {
      const float m = Mag[p_row][k];
      const float4 f = *reinterpret_cast<const float4*>(&Fb[k][p_band]);
      band[0] = fmaf(m, f.x, band[0]);
      band[1] = fmaf(m, f.y, band[1]);
      band[2] = fmaf(m, f.z, band[2]);
      band[3] = fmaf(m, f.w, band[3]);
    }
    __syncthreads();
  }

  if (row0 + p_row < n) {
    float* dst = out + (static_cast<size_t>(blockIdx.y) * n + row0 + p_row) * kBands + p_band;
    *reinterpret_cast<float4*>(dst) =
        make_float4(band[0], band[1], band[2], band[3]);
  }
}

// out[i] = partial[0][i] + partial[1][i] + ... in split order
__global__ void __launch_bounds__(kThreads)
    band_reduce_kernel(const float* __restrict__ partial,
                       float* __restrict__ out, int total, int split) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  float acc = partial[i];
  for (int s = 1; s < split; ++s)
    acc += partial[static_cast<size_t>(s) * total + i];
  out[i] = acc;
}

}  // namespace

extern "C" {

// frames (n, n_fft), cosb and sinb (n_fft, n_bins), fb (n_bins, 16), out
// (n, 16): contiguous float32 device buffers, 16-byte aligned. split > 1
// spreads the bin tiles over that many blocks per row block and needs
// scratch (split, n, 16). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape the kernel does not take); 0 is success.
int tgi_band_energies(const void* frames, const void* cosb, const void* sinb,
                      const void* fb, void* out, void* scratch, int n,
                      int n_fft, int n_bins, int n_bands, int split,
                      void* stream) {
  if (n < 1 || n_bands != kBands || n_fft % kBK != 0 || n_bins % kBN != 0 ||
      split < 1 || (n_bins / kBN) % split != 0 || (split > 1 && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBM - 1) / kBM, split);
  float* dst = static_cast<float*>(split > 1 ? scratch : out);
  band_energies_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(frames), static_cast<const float*>(cosb),
      static_cast<const float*>(sinb), static_cast<const float*>(fb), dst, n,
      n_fft, n_bins, (n_bins / kBN) / split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  const int total = n * kBands;
  band_reduce_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(scratch), static_cast<float*>(out), total,
      split);
  return static_cast<int>(cudaGetLastError());
}

const char* tgi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
