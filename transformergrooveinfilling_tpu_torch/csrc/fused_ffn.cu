// Fused feed-forward block for training, forward and backward, sm_90a, bf16
// or f32.
//
// Replaces the Pallas TPU kernels of transformergrooveinfilling_tpu/ops/
// fused_ffn.py under ffn_train: the forward in both its layouts (_fwd_call →
// _fwd_kernel, weights resident in VMEM; _fwd_call_tiled → _fwd_kernel_tiled,
// weights streamed as ff tiles) and the backward (_bwd_call → _bwd_kernel):
//
//   h = round(drop(relu(x·W1ᵀ + b1)));  out = h·W2ᵀ + b2
//   g = dy·W2;  dh = round(where(h > 0, g / keep, 0));  dx = dh·W1
//   dW1 = dhᵀ·x;  dW2 = dyᵀ·h;  db1 = Σ dh;  db2 = Σ dy
//
// h, rounded to the storage dtype before the second product, is the only
// intermediate that reaches device memory and the backward's only residual:
// h > 0 says both that the mask kept the unit and that the ReLU was active.
//
// What bounds it on the H100: operations, 4·rows·d·ff FLOP for the forward,
// as much for the row backward and again for the weight gradients, against
// rows·(2d + ff) + 2·d·ff values moved (2.1 GFLOP and 7 MB at rows 1,024, d
// 256, ff 2048 in bf16). Only the tensor cores come near that bound (989
// TFLOP/s in bf16, 15× the CUDA cores' f32 rate; f32 products in split TF32,
// three TF32 products each, 495 / 3), so each dtype runs five products on one
// wgmma core (gemm_sm90.cuh: TMA into a ring of stages, one or two consumer
// warpgroups, f32 accumulators in registers, persistent blocks; f32 operands
// split into TF32 hi/lo planes a stage at a time), each with its own
// epilogue on the accumulator fragment:
//   ffn_fwd_h        x·W1ᵀ (K-major A and B) → + b1, ReLU, mask, ÷ keep,
//                    round: h. One dropout draw per (row, 16 columns) a
//                    thread holds, bit for bit dropout_mask's.
//   ffn_fwd_out      h·W2ᵀ → + b2, round: out.
//   ffn_bwd_dh       dy·W2 (W2 read MN-major) → h > 0 ? g / keep : 0,
//                    round: dh.
//   ffn_bwd_dx       dh·W1 (MN-major B) → round: dx.
//   ffn_bwd_weights  dhᵀ·x and dyᵀ·h in one launch (both operands MN-major,
//                    the reduction over rows), cut into row splits of whole
//                    64-row chunks when the tiles alone do not fill the card;
//                    f32 partials (dW1 | dW2 | db1 | db2 per split), the
//                    biases as column sums in a fixed order by blocks of
//                    their own; reduce_splits adds the splits in order. No float
//                    atomics: two runs with one seed agree bit for bit.
// A launch takes 64 × 64 tiles (one consumer warpgroup, several blocks an
// SM) where 128 × 128 ones would leave SMs idle, and otherwise 128 × 128, or
// in bf16 128 × 256 for dh·W1 and for weight gradients whose tiles fill the
// card (their epilogues read nothing but the accumulator; those that read a
// bias or h spill at 128 × 256): ops/fused_ffn.py::tile_configs, by
// measurement. gemm_sm90.cuh builds no 128 × 256 tile for f32 (its plane
// sets would not fit), so each f32 product is built for 64 × 64 and 128 × 128.
// The tensor cores truncate as they accumulate: h·W2ᵀ and dh·W1 reduce over
// ff (4,096 at GrooveXL's width), so their f32 launches sum each stage's
// products apart and add them to the accumulator rounded (kPromote), as the
// weight gradients do over the rows.
// The TPU kernel fuses the two forward products to keep h in VMEM; here h
// must reach device memory anyway as the backward's residual, and the fusion
// would cost an on-chip (rows, d) f32 accumulator. The ragged edges are TMA's
// zero fill; the epilogues mask their stores. Row strides must be multiples
// of 16 bytes (TMA): d and ff multiples of 8 in bf16, of 4 in f32; rows is
// free. On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, phase 17),
// device time per launch at rows 4,096 × d 1024 × ff 4096 in bf16:
// ffn_fwd_h 0.086 ms, ffn_fwd_out 0.060, ffn_bwd_dh 0.092, ffn_bwd_dx 0.049,
// ffn_bwd_weights 0.143 (38-71 % of the tensor cores' bound).
//
// Dropout is the layer kernels' 8-bit rule and stream (layer_common.cuh), site
// 2, counted by (row, column) of the (rows, ff) hidden: the mask does not
// depend on the tiling, and ops/fused_ffn.py::ffn_reference draws the same.
//
// Weights and their gradients are in nn.Linear's (out, in) layout: W1 (ff, d),
// W2 (d, ff). Biases and the gradients of weights and biases are f32. Plain C
// entry points, bound from Python with ctypes (ops/fused_ffn.py); each returns
// cudaGetLastError() after its launch.

#include "epilogues_sm90.cuh"

namespace {

constexpr int kSiteFfn = 2;

// The tile shapes (gemm_sm90.cuh's run() configs) a product is built for:
// bf16 those given, f32 64 × 64 and 128 × 128.
template <class T>
constexpr unsigned shapes(unsigned bf16_shapes) {
  return sizeof(T) == 4 ? 0b011u : bf16_shapes;
}

}  // namespace

extern "C" {

// rows × d inputs, ff hidden units; thresh the 8-bit keep threshold (256: no
// dropout); config the tile shape (gemm_sm90.cuh's run; one the product is
// not built for returns cudaErrorInvalidValue and launches nothing); f32
// picks the activations' and weights' dtype, f32 (split TF32) or bf16. All
// pointers are device pointers of contiguous tensors, 16-byte aligned; the
// biases are f32 and the seed int32.

int tgi_ffn_fwd_h(void* x, void* w1, void* b1, void* seed, void* h, int rows, int d, int ff,
                  int thresh, int config, int f32, void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    const Operand a{x, rows}, b{w1, ff};
    const EpiHidden<T> epi{{}, as<T>(h), as<const float>(b1), as<const int>(seed), rows, ff,
                           thresh, kSiteFfn};
    return run<shapes<T>(0b011), false, false, 2, T>(config, &a, &b, 1, d, d, 1, 0, epi,
                                                     static_cast<cudaStream_t>(stream));
  });
}

int tgi_ffn_fwd_out(void* h, void* w2, void* b2, void* out, int rows, int d, int ff, int config,
                    int f32, void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    const Operand a{h, rows}, b{w2, d};
    const EpiOut<T, true> epi{{}, as<T>(out), as<const float>(b2), rows, d};
    return run<shapes<T>(0b011), false, false, 2, T>(config, &a, &b, 1, ff, ff, 1, 0, epi,
                                                     static_cast<cudaStream_t>(stream));
  });
}

int tgi_ffn_bwd_dh(void* dy, void* w2, void* h, void* dh, int rows, int d, int ff, int thresh,
                   int config, int f32, void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    const Operand a{dy, rows}, b{w2, ff};
    const EpiDh<T> epi{{}, as<T>(dh), as<const T>(h), rows, ff, thresh};
    return run<shapes<T>(0b011), false, true, 2, T>(config, &a, &b, 1, d, d, 1, 0, epi,
                                                    static_cast<cudaStream_t>(stream));
  });
}

int tgi_ffn_bwd_dx(void* dh, void* w1, void* dx, int rows, int d, int ff, int config, int f32,
                   void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    const Operand a{dh, rows}, b{w1, d};
    const EpiRound<T, true> epi{{}, as<T>(dx), nullptr, rows, d};
    return run<shapes<T>(0b101), false, true, 2, T>(config, &a, &b, 1, ff, ff, 1, 0, epi,
                                                    static_cast<cudaStream_t>(stream));
  });
}

// part: `splits` × (2·d·ff + ff + d) f32 (dW1 | dW2 | db1 | db2 each), the
// rows cut into splits of rows_per_split (a multiple of 64 when splits > 1)
int tgi_ffn_bwd_wgrad(void* dy, void* x, void* h, void* dh, void* part, int rows, int d, int ff,
                      int splits, int rows_per_split, int config, int f32, void* stream) {
  return by_type(f32, [&](auto type) {
    using T = typename decltype(type)::type;
    const Operand a[2] = {{dh, ff}, {dy, d}}, b[2] = {{x, d}, {h, ff}};
    EpiWgrad<T> epi{};  // dW1 = dhᵀ·x, dW2 = dyᵀ·h; db1 = Σ dh, db2 = Σ dy
    epi.part = as<float>(part);
    epi.m[0] = ff, epi.n[0] = d, epi.m[1] = d, epi.n[1] = ff;
    epi.seg[0].x = dh, epi.seg[0].width = ff;
    epi.seg[1].x = dy, epi.seg[1].width = d;
    const int bias_blocks = wgrad_layout(epi, 2, 2);
    return run<shapes<T>(0b110), true, true, 2, T>(config, a, b, 2, rows, rows_per_split, splits,
                                                   bias_blocks, epi,
                                                   static_cast<cudaStream_t>(stream));
  });
}

// out[i] = Σ_s part[s][i] in split order, for i < total
int tgi_ffn_reduce(void* part, void* out, int total, int splits, void* stream) {
  reduce_splits<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(part),
                                                       static_cast<float*>(out), total, splits);
  return static_cast<int>(cudaGetLastError());
}

const char* tgi_ffn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
