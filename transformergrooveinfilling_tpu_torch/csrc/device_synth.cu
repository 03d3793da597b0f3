// Drum-loop synthesis from per-cell events, sm_90a.
//
// Counterpart of the Pallas kernel transformergrooveinfilling_tpu/ops/
// device_synth.py::_synth_kernel (under _synth_pallas): for each item,
//   out[onset_e + d] += gain_e * table[row_e][d],  d < lengths[row_e],
// over the item's n_events cells in cell order (step major, voice minor — the
// host mixer's order), cells with gain 0 skipped.
//
// The TPU kernel keeps one item's whole waveform in fast memory and walks the
// events serially. A waveform is about 0.7 MB and an SM has 227 KB of shared
// memory, so here the kernel is output-stationary instead: a block owns one
// tile of 1,024 output samples of one item, reads the item's events once,
// keeps (in order) those that overlap its tile in shared memory, and each
// thread sums 4 samples over that list in registers. Every output sample is
// written once by one thread: no atomics, so reruns are bit-identical, and
// table reads are coalesced (neighbouring threads, neighbouring samples).
//
// What bounds it: memory. The waveforms are written once (n_items · length
// floats, 47 MB for 64 loops at 120 bpm) and the 2.2 MB table stays in L2;
// the adds are two operations per (event, sample) pair.
//
// Rounding: the product and the sum are rounded separately (__fmul_rn,
// __fadd_rn), as the host mixer's ``buf += vel * s`` does; a fused
// multiply-add would differ in the last bit.
//
// Samples that would run past ``length`` are cut by the bounds check (the TPU
// kernel over-allocates and slices).
//
// Plain C entry points, bound from Python with ctypes
// (ops/device_synth.py); the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;

__global__ void __launch_bounds__(kThreads)
    synth_kernel(const int* __restrict__ onset, const int* __restrict__ row,
                 const float* __restrict__ gain, const float* __restrict__ table,
                 const int* __restrict__ lengths, float* __restrict__ out,
                 int n_events, int s_max, int length) {
  extern __shared__ int smem[];  // 4 arrays of n_events: the tile's events
  int* s_onset = smem;
  int* s_row = smem + n_events;
  int* s_len = smem + 2 * n_events;
  float* s_gain = reinterpret_cast<float*>(smem + 3 * n_events);
  __shared__ int warp_count[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const size_t item = blockIdx.y;
  const int tile0 = blockIdx.x * kTile;
  const int tile1 = min(tile0 + kTile, length);

  // ordered compaction of the events that overlap [tile0, tile1)
  int count = 0;  // the same in every thread
  for (int base = 0; base < n_events; base += kThreads) {
    const int e = base + tid;
    bool keep = false;
    int on = 0, r = 0, len = 0;
    float g = 0.f;
    if (e < n_events) {
      g = gain[item * n_events + e];
      if (g != 0.f) {
        on = onset[item * n_events + e];
        r = row[item * n_events + e];
        len = lengths[r];
        keep = on < tile1 && on + len > tile0;
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_count[warp] = __popc(mask);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_count[w];
      total += warp_count[w];
    }
    if (keep) {
      const int pos = count + before + __popc(mask & ((1u << lane) - 1u));
      s_onset[pos] = on;
      s_row[pos] = r;
      s_len[pos] = len;
      s_gain[pos] = g;
    }
    count += total;
    __syncthreads();
  }

  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;
  for (int c = 0; c < count; ++c) {
    const int on = s_onset[c];
    const int len = s_len[c];
    const float g = s_gain[c];
    const float* sample = table + static_cast<size_t>(s_row[c]) * s_max;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int d = tile0 + tid + i * kThreads - on;
      if (static_cast<unsigned>(d) < static_cast<unsigned>(len))
        acc[i] = __fadd_rn(acc[i], __fmul_rn(g, __ldg(sample + d)));
    }
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int j = tile0 + tid + i * kThreads;
    if (j < length) out[item * length + j] = acc[i];
  }
}

}  // namespace

extern "C" {

// onset, row (int32) and gain (float32): (n_items, n_events); table
// (n_rows, s_max) float32; lengths (n_rows,) int32, each ≤ s_max; out
// (n_items, length) float32; all contiguous device buffers. Every onset lies
// in [0, length) and every row in [0, n_rows). Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a shape the kernel does not
// take); 0 is success.
int tgi_device_synth(const void* onset, const void* row, const void* gain,
                     const void* table, const void* lengths, void* out,
                     int n_items, int n_events, int s_max, int length,
                     void* stream) {
  const size_t smem = 4 * static_cast<size_t>(n_events) * sizeof(int);
  if (n_items < 1 || n_items > 65535 || n_events < 1 || smem > 48 * 1024 ||
      s_max < 1 || length < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((length + kTile - 1) / kTile, n_items);
  synth_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(onset), static_cast<const int*>(row),
      static_cast<const float*>(gain), static_cast<const float*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(out), n_events,
      s_max, length);
  return static_cast<int>(cudaGetLastError());
}

const char* tgi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
