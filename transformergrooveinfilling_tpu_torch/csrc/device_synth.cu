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
// tile of 256·P output samples of one item (thread t the samples t, t + 256,
// ...), keeps in shared memory, in order, the events that overlap its tile,
// and each thread sums its P samples over that list in registers. Every
// output sample is written once by one thread: no atomics, so reruns are
// bit-identical, and table reads are coalesced (neighbouring threads,
// neighbouring samples).
//
// What bounds it: memory. The waveforms are written once (n_items · length
// floats, 47 MB for 64 loops at 120 bpm); the 2.2 MB table stays in L2, but
// every (event, sample) pair reads one table value from there (105 M pairs,
// 420 MB of L2 reads, for 64 loops at 120 bpm), which no tiling shares: two
// events of a tile read disjoint stretches of the table. The design keeps
// those reads in flight and pays the per-block prologue rarely:
//
//   * P (2 to 16) is chosen by the wrapper from the item count and the SM
//     count (ops/device_synth.py::samples_per_thread): at one item the tiles
//     (512 samples) are small enough that the grid covers the card; at a
//     chunk of 64 or 256 items a block owns 4,096 samples, so its prologue
//     (reading the item's 288 events and keeping those that overlap) is paid
//     once per 16 KB of output instead of once per 4 KB.
//   * The prologue reads the events 4 at a time (16-byte loads where the
//     arrays allow), takes `lengths` from a copy in shared memory made once
//     per block, and keeps the overlapping events by one block-wide scan per
//     1,024 events (two barriers).
//   * The sum walks the kept events 8 at a time (4 where a thread owns 8 or
//     16 samples, whose loads are in flight together already): the table
//     loads of all of them are issued before any of their adds, and the adds
//     then run in cell order.
//
// Rounding: the product and the sum are rounded separately (__fmul_rn,
// __fadd_rn), as the host mixer's ``buf += vel * s`` does; a fused
// multiply-add would differ in the last bit. Samples that would run past
// ``length`` are cut by the bounds check (the TPU kernel over-allocates and
// slices).
//
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 10; PERF.md §6)
// one loop at 120 bpm takes 4.3 µs of device time (bound 0.9: latency of two
// dependent L2 trips and three barriers), 64 loops 65 µs and 256 loops 215 µs
// (bound 14.8 and 57: the L2 reads of the table, above).
//
// Plain C entry points, bound from Python with ctypes (ops/device_synth.py);
// the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScan = 4 * kThreads;  // events one scan of the prologue keeps or drops
constexpr size_t kMaxSmem = 48 * 1024;

// kept events whose table loads are issued together: 8 where a thread owns
// few samples, 4 where P loads an event are in flight already
__host__ __device__ constexpr int batch(int per_thread) { return per_thread <= 4 ? 8 : 4; }

template <int P>
__global__ void __launch_bounds__(kThreads)
    synth_kernel(const int* __restrict__ onset, const int* __restrict__ row,
                 const float* __restrict__ gain, const float* __restrict__ table,
                 const int* __restrict__ lengths, float* __restrict__ out,
                 int n_events, int n_rows, int s_max, int length) {
  extern __shared__ int smem[];  // lengths (n_rows), then the tile's events (4 × n_events)
  int* s_lengths = smem;
  int* s_onset = smem + n_rows;
  int* s_len = s_onset + n_events;
  int* s_row = s_len + n_events;
  float* s_gain = reinterpret_cast<float*>(s_row + n_events);
  __shared__ int warp_total[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t item = blockIdx.y;
  const int tile0 = blockIdx.x * (kThreads * P);
  const int tile1 = min(tile0 + kThreads * P, length);
  const int* item_onset = onset + item * n_events;
  const int* item_row = row + item * n_events;
  const float* item_gain = gain + item * n_events;
  const bool vector = n_events % 4 == 0 &&
                      ((reinterpret_cast<uintptr_t>(item_onset) |
                        reinterpret_cast<uintptr_t>(item_row) |
                        reinterpret_cast<uintptr_t>(item_gain)) & 15) == 0;

  for (int r = tid; r < n_rows; r += kThreads) s_lengths[r] = __ldg(lengths + r);

  // ordered compaction of the events that overlap [tile0, tile1): thread t
  // holds events 4t .. 4t + 3 of each scan
  int count = 0;  // the same in every thread
  for (int base = 0; base < n_events; base += kScan) {
    const int e0 = base + 4 * tid;
    int on[4] = {0, 0, 0, 0}, rw[4] = {0, 0, 0, 0};
    float g[4] = {0.f, 0.f, 0.f, 0.f};
    if (vector) {
      if (e0 < n_events) {
        const int4 o = __ldg(reinterpret_cast<const int4*>(item_onset + e0));
        const int4 w = __ldg(reinterpret_cast<const int4*>(item_row + e0));
        const float4 v = __ldg(reinterpret_cast<const float4*>(item_gain + e0));
        on[0] = o.x; on[1] = o.y; on[2] = o.z; on[3] = o.w;
        rw[0] = w.x; rw[1] = w.y; rw[2] = w.z; rw[3] = w.w;
        g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (e0 + k < n_events) {
          on[k] = __ldg(item_onset + e0 + k);
          rw[k] = __ldg(item_row + e0 + k);
          g[k] = __ldg(item_gain + e0 + k);
        }
    }
    __syncthreads();  // s_lengths written; warp_total of the last scan read
    int len[4], kept = 0, n = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      len[k] = e0 + k < n_events && g[k] != 0.f ? s_lengths[rw[k]] : 0;
      if (len[k] > 0 && on[k] < tile1 && on[k] + len[k] > tile0) {
        kept |= 1 << k;
        ++n;
      }
    }
    int before = n;  // inclusive scan over the warp's lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, before, off);
      if (lane >= off) before += t;
    }
    if (lane == 31) warp_total[warp] = before;
    before -= n;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_total[w];
      total += warp_total[w];
    }
    int pos = count + before;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (kept >> k & 1) {
        s_onset[pos] = on[k];
        s_len[pos] = len[k];
        s_row[pos] = rw[k];
        s_gain[pos] = g[k];
        ++pos;
      }
    count += total;
  }
  __syncthreads();

  float acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = 0.f;
  constexpr int kBatch = batch(P);
  const int j0 = tile0 + tid;
  for (int c0 = 0; c0 < count; c0 += kBatch) {
    int on[kBatch], len[kBatch];
    float g[kBatch];
    const float* src[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool live = c0 + u < count;
      on[u] = live ? s_onset[c0 + u] : 0;
      len[u] = live ? s_len[c0 + u] : 0;  // 0: no sample is in range
      g[u] = live ? s_gain[c0 + u] : 0.f;
      src[u] = table + static_cast<size_t>(live ? s_row[c0 + u] : 0) * s_max;
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int j = j0 + i * kThreads;
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int d = j - on[u];
        v[u] = static_cast<unsigned>(d) < static_cast<unsigned>(len[u]) ? __ldg(src[u] + d) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int d = j - on[u];
        if (static_cast<unsigned>(d) < static_cast<unsigned>(len[u]))
          acc[i] = __fadd_rn(acc[i], __fmul_rn(g[u], v[u]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = j0 + i * kThreads;
    if (j < length) out[item * length + j] = acc[i];
  }
}

struct SynthArgs {
  const void *onset, *row, *gain, *table, *lengths;
  void* out;
  int n_items, n_events, n_rows, s_max, length;
};

template <int P>
int launch(const SynthArgs& a, size_t smem, cudaStream_t stream) {
  const dim3 grid((a.length + kThreads * P - 1) / (kThreads * P), a.n_items);
  synth_kernel<P><<<grid, kThreads, smem, stream>>>(
      static_cast<const int*>(a.onset), static_cast<const int*>(a.row),
      static_cast<const float*>(a.gain), static_cast<const float*>(a.table),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.out), a.n_events, a.n_rows,
      a.s_max, a.length);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// onset, row (int32) and gain (float32): (n_items, n_events); table
// (n_rows, s_max) float32; lengths (n_rows,) int32, each ≤ s_max; out
// (n_items, length) float32; all contiguous device buffers. Every onset lies
// in [0, length) and every row in [0, n_rows). per_thread (2, 4, 8 or 16)
// sets the tile: 256·per_thread samples a block. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a shape the kernel does not
// take); 0 is success.
int tgi_device_synth(const void* onset, const void* row, const void* gain,
                     const void* table, const void* lengths, void* out,
                     int n_items, int n_events, int n_rows, int s_max, int length,
                     int per_thread, void* stream) {
  const size_t smem = (static_cast<size_t>(n_rows) + 4 * static_cast<size_t>(n_events)) *
                      sizeof(int);
  if (n_items < 1 || n_items > 65535 || n_events < 1 || n_rows < 1 || smem > kMaxSmem ||
      s_max < 1 || length < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const SynthArgs a{onset, row, gain, table, lengths, out, n_items, n_events, n_rows, s_max,
                    length};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (per_thread) {
    case 2: return launch<2>(a, smem, s);
    case 4: return launch<4>(a, smem, s);
    case 8: return launch<8>(a, smem, s);
    case 16: return launch<16>(a, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* tgi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
