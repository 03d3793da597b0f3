// The wide route of the whole-layer chains (layer_sm90.cu) on Hopper
// (sm_90a), in bf16 or f32: the launches that take a layer past d 256, the
// width up to which a 64 × 256 tile spans a row and the LayerNorm runs in a
// product's epilogue (layer_sm90.cu's sm90_res_ln, sm90_ln_bwd), up to d 8,192.
//
// Part of the replacement of the Pallas TPU kernels transformergrooveinfilling_tpu/
// ops/fused_layer.py::encoder_layer_train and ops/fused_decoder_layer.py::
// decoder_layer_train (their _fwd_call and _bwd_call), which keep a whole row
// in VMEM at any d their gate admits. Each LayerNorm-epilogue launch becomes
// two (ops/layer_sm90.py::WIDE; 16 launches an encoder layer, 26 a decoder
// layer):
//
//   sm90_res_sum   s = resid + drop(A·Wᵀ + b), written rounded (a residual of
//                  the backward) and in f32, over the product's 64 × 64 or
//                  128 × 128 tiles (EpiHidden's bias and dropout words)
//   sm90_ln_y      a row pass: the statistics from the f32 s, round(LN(s))
//   sm90_grad_sum  v = dH·W + da in f32 (the gradient at a LayerNorm's output)
//   sm90_ln_grad   a row pass: the LayerNorm's backward from v, the stored
//                  input and its statistics; da (f32) and round(drop(da))
//
// What bounds them on the H100: the products as layer_sm90.cu's (operations),
// the row passes bytes: a row pass reads the f32 row (and, backward, the
// stored input) and writes its outputs once, 2 × 4 bytes a value more through
// device memory than the fused epilogue. A fused epilogue over two consumer
// warpgroups of 64 × 256, the row statistics exchanged through shared memory,
// would save that round trip; it is later work.
//
// Built apart from layer_sm90.cu, so that nvcc compiles the two in parallel.
// Plain C entry points, bound from Python with ctypes (ops/layer_sm90.py);
// `f32` picks the activations' dtype, and each returns cudaGetLastError()
// after its launch.

#include "rows_sm90.cuh"

namespace {

// The wide route's residual sum, d > kLnTile: s = resid + drop(A·Wᵀ + bias)
// at `site`, a_out = round(s) and s_out = s in f32 for the row pass (ln_y).
// The bias and the lane quad's dropout words come from EpiHidden's load();
// the element is dropped as EpiResLn drops it (v / keep).
template <class T>
struct EpiResSum : NoExtra {
  static constexpr bool kPromote = true;  // f32: see the note at the entry points
  EpiHidden<T> words;  // its bias (b1), rows, width (ff), thresh, site and seed
  T* a_out;
  float* s_out;
  const T* resid;
  using Aux = typename EpiHidden<T>::Aux;
  template <int G>
  __device__ __forceinline__ void load(int problem, int split, int row, int col,
                                       Aux (&aux)[G][2]) const {
    words.load(problem, split, row, col, aux);
  }
  __device__ __forceinline__ void store(int, int, int row, int col, const float (&v)[4],
                                        const Aux& a) const {
    const int d = words.ff, thresh = words.thresh;
    if (row >= words.rows) return;
    const float keep = thresh / 256.f;
    const int shift = 16 * (threadIdx.x & 1);  // byte 2(q % 2) of a word, then the next
    const float b[4] = {a.b.x, a.b.y, a.b.z, a.b.w};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = col + 8 * p;
      if (c >= d) continue;
      const size_t at = static_cast<size_t>(row) * d + c;
      const float2 r = unpack(load_pair(resid + at));
      const uint32_t w = p ? a.hi : a.lo;
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        o[e] = v[2 * p + e] + b[2 * p + e];
        if (thresh < 256) o[e] = drop_by(o[e], (w >> (shift + 8 * e)) & 0xFFu, thresh, keep);
        o[e] += e ? r.y : r.x;
      }
      store2(a_out + at, o[0], o[1]);
      *reinterpret_cast<float2*>(s_out + at) = make_float2(o[0], o[1]);
    }
  }
};

// The wide route's row pass of res_ln: y = round(LN(s)·g + beta), the
// statistics from the f32 s (rows × d) that sm90_res_sum wrote.
template <class T, int C, int G>
__global__ void __launch_bounds__(kThreads)
    ln_y_rows(const float* __restrict__ s, const float* __restrict__ g,
              const float* __restrict__ beta, T* __restrict__ y, int rows, int d) {
  int c0[C];
  const int r = row_lanes<C, G>(rows, c0);
  if (r < 0) return;
  const size_t base = static_cast<size_t>(r) * d;
  float a[C][8];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) a[c][i] = 0.f;
    if (c0[c] < d) load8(s + base + c0[c], a[c]);
  }
  float mu, rstd;
  row_stats<C, G>(a, d, mu, rstd);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c0[c] >= d) continue;
    float out[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[i] = affine(zhat(a[c][i], mu, rstd), g[c0[c] + i], beta[c0[c] + i]);
    store8(y + base + c0[c], out);
  }
}

// The wide route's row pass of ln_bwd: from v = dH·W + da (f32, rows × d,
// sm90_grad_sum) and the LayerNorm's stored input a_ln with its row
// statistics at stats[r·stats_ld], the backward da (f32) and dp =
// round(drop(da)) at `site`.
template <class T, int C, int G>
__global__ void __launch_bounds__(kThreads)
    ln_grad_rows(const float* __restrict__ v, const float* __restrict__ g,
                 const T* __restrict__ a_ln, const float* __restrict__ stats, int stats_ld,
                 const int* __restrict__ seed, float* __restrict__ da, T* __restrict__ dp,
                 int rows, int d, int thresh, int site) {
  int c0[C];
  const int r = row_lanes<C, G>(rows, c0);
  if (r < 0) return;
  const size_t base = static_cast<size_t>(r) * d;
  const float mu = stats[static_cast<size_t>(r) * stats_ld];
  const float rstd = stats[static_cast<size_t>(r) * stats_ld + 1];
  float a[C][8], dz[C][8], df[C][8];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) a[c][i] = dz[c][i] = 0.f;
    if (c0[c] >= d) continue;
    load8(a_ln + base + c0[c], a[c]);
    load8(v + base + c0[c], dz[c]);
#pragma unroll
    for (int i = 0; i < 8; ++i) dz[c][i] *= g[c0[c] + i];
  }
  row_backward<C, G>(dz, df, a, c0, d, mu, rstd, static_cast<uint32_t>(*seed), site, r, thresh);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c0[c] >= d) continue;
    store8(da + base + c0[c], dz[c]);
    store8(dp + base + c0[c], df[c]);
  }
}

}  // namespace

extern "C" {

// The two products reduce over d or ff (ff ≤ 1,024 in f32). In f32 each stage's
// sums are promoted (gemm_sm90.cuh's kPromote; a bf16 launch ignores it):
// unpromoted, the tensor cores' truncating accumulation took a sum over 1,024
// terms to 1.05e-5 of its largest value on an H100, past the chains' 1e-5.

// s = resid + drop(A·Wᵀ + bias) at `site` (W (n × k)): a_out = round(s),
// s_out = s in f32
int tgi_sm90_res_sum(void* a, void* w, void* bias, void* resid, void* seed, void* a_out,
                     void* s_out, int rows, int n, int k, int thresh, int site, int config,
                     int f32, void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    const Operand A{a, rows}, B{w, n};
    const EpiResSum<T> epi{{},
                           EpiHidden<T>{{}, nullptr, as<const float>(bias), as<const int>(seed),
                                        rows, n, thresh, site},
                           as<T>(a_out), as<float>(s_out), as<const T>(resid)};
    return run<0b011, false, false, 2, T>(config, &A, &B, 1, k, k, 1, 0, epi,
                                          static_cast<cudaStream_t>(stream));
  });
}

// y = round(LN(s)·g + beta) over the rows of the f32 s (rows × d)
int tgi_sm90_ln_y(void* s, void* g, void* beta, void* y, int rows, int d, int f32,
                  void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    return by_chunks(d, [&](auto chunks) {
      using S = decltype(chunks);
      ln_y_rows<T, S::kC, S::kG>
          <<<(rows + S::kRows - 1) / S::kRows, kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(as<const float>(s), as<const float>(g),
                                                 as<const float>(beta), as<T>(y), rows, d);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// v = A·W + resid in f32 (W (k × n), resid f32 (rows × n))
int tgi_sm90_grad_sum(void* a, void* w, void* resid, void* v, int rows, int n, int k, int config,
                      int f32, void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    const Operand A{a, rows}, B{w, n};
    const EpiRound<float, true> epi{{}, as<float>(v), as<const float>(resid), rows, n};
    return run<0b011, false, true, 2, T>(config, &A, &B, 1, k, k, 1, 0, epi,
                                         static_cast<cudaStream_t>(stream));
  });
}

// the LayerNorm backward of a_ln (row stats at stats[r·stats_ld]) with gain g
// from v (f32, rows × d): da (f32) and dp = round(drop(da)) at `site`
int tgi_sm90_ln_grad(void* v, void* g, void* a_ln, void* stats, void* seed, void* da, void* dp,
                     int rows, int d, int stats_ld, int thresh, int site, int f32,
                     void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    return by_chunks(d, [&](auto chunks) {
      using S = decltype(chunks);
      ln_grad_rows<T, S::kC, S::kG>
          <<<(rows + S::kRows - 1) / S::kRows, kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
              as<const float>(v), as<const float>(g), as<const T>(a_ln), as<const float>(stats),
              stats_ld, as<const int>(seed), as<float>(da), as<T>(dp), rows, d, thresh, site);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

const char* tgi_sm90_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
