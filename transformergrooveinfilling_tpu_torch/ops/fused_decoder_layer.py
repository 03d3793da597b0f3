"""Whole-decoder-layer training kernel: wrappers, plain twin and the Hopper gate.

Replaces the Pallas TPU kernel ``transformergrooveinfilling_tpu/ops/
fused_decoder_layer.py::decoder_layer_train`` (forward ``_fwd_call`` →
``_fwd_kernel``, backward ``_bwd_call`` → ``_bwd_kernel``): the whole post-LN
decoder layer

    qkv = y·Wqkv + b;  per head P = softmax(causal(Q·Kᵀ/√hd)); A = drop(P)·V
    a1 = y + drop(A·Wo + bo);   y1 = LN1(a1)
    qc = y1·Wq + bq;  kv = mem·Wkv + bkv;  per head Pc = softmax(Qc·Kcᵀ/√hd)
    B = drop(Pc)·Vc;  a2 = y1 + drop(B·Wo2 + bo2);  y2 = LN2(a2)
    h  = drop(relu(y2·W1 + b1));  a3 = y2 + drop(h·W2 + b2);  y3 = LN3(a3)

with six dropout sites, and its backward, which returns ``dx``, ``dmem`` (the
cross-attention's gradient into the encoder memory) and 20 parameter
gradients. The memory rows of a sequence are the target's (source and
target lengths must be equal). Two routes, by the storage dtype, on the
encoder layer's designs (``ops/fused_layer.py``):

- bf16: a chain of launches of ``csrc/layer_sm90.cu`` (``ops/layer_sm90.py``)
  with every product on the tensor cores (``wgmma`` + TMA) and the
  elementwise work in the products' epilogues (:func:`forward_sm90`,
  :func:`backward_sm90`): nine launches forward, twelve backward, the seven
  weight gradients and 13 bias and LayerNorm-parameter sums in one grouped
  launch with a fixed-order reduce of its row splits. ``SM90_KERNELS``
  counts each launch.
- f32: ``csrc/fused_decoder_layer.cu``'s CUDA-core kernels (``KERNELS``): a
  forward kernel and a row-backward kernel with one block per sequence, and a
  weight-gradient kernel that sums dYᵀ·X over all rows in a fixed order.

No float atomics on either route: two runs with one seed agree bit for bit.

What bounds it on the H100: about 1.6 MFLOP of products per row forward and
twice that backward at d 256 / ff 512: operations, not memory, on the tensor
cores in bf16 (989 TFLOP/s) and on the CUDA cores in f32 (67 TFLOP/s). The
probabilities, both attention outputs and every mask are recomputed in the
backward (masks from the Philox stream of ``ops/fused_layer.py::
dropout_mask``), and the autograd Function saves exactly what the TPU kernel
stores: y, mem, qkv, a1, qc, kv, a2, h_drop, a3.

On a CPU tensor :func:`decoder_layer_train` runs the twin
:func:`decoder_layer_reference`; on a CUDA tensor it launches the kernels or
raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, layer_sm90
from .dropout import quantized_threshold
from .fused_layer import (
    KERNEL_DTYPES, MAX_SMEM_BYTES, MAX_T, _ln, bwd_weights_smem_bytes,
    dropout_mask, fwd_smem_bytes, supports_fused_layer,
)

# dropout sites, in the order the layer reaches them
SITE_SELF, SITE_PROJ1, SITE_CROSS, SITE_PROJ2, SITE_FFN, SITE_OUT = range(6)
# (y, mem, 20 parameters) in the JAX argument order; weights in nn.Linear's
# (out, in) layout
ARG_NAMES = ("y", "mem", "wqkv", "bqkv", "wo", "bo", "wq", "bq", "wkv", "bkv", "wo2", "bo2",
             "g1", "b1", "w1", "b1f", "w2", "b2f", "g2", "b2", "g3", "b3")
WEIGHT_NAMES = ("wqkv", "wo", "wq", "wkv", "wo2", "w1", "w2")
RESIDUAL_NAMES = ("qkv", "a1", "qc", "kv", "a2", "h", "a3")


# ---------------------------------------------------------------- twin

def decoder_layer_reference(y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2,
                            g1, b1, w1, b1f, w2, b2f, g2, b2, g3, b3, seed, rate: float,
                            n_heads: int, seq_len: int, return_residuals: bool = False,
                            relu_flips=None):
    """The kernels' math in plain PyTorch; its gradient is autograd's.

    ``y``, ``mem``: (rows, d), rows = batch·seq_len, sequence-major; weights
    in nn.Linear's (out, in) layout and the compute dtype (``y.dtype``),
    biases and LN parameters f32. Rounding points as the TPU kernel's: qkv,
    qc, kv, both P (after dropout), both attention outputs, y1, y2 and h are
    rounded to the compute dtype; residual sums and LayerNorms are f32; every
    product accumulates in f32. A masked (future) score gets probability
    exactly 0. With ``return_residuals`` returns ``(y3, qkv, a1, qc, kv, a2,
    h, a3)``. ``relu_flips``: as ``encoder_layer_reference``'s.
    """
    cd = y.dtype
    m, d = y.shape
    bsz, hd = m // seq_len, d // n_heads
    thresh = quantized_threshold(rate)
    keep = thresh / 256.0
    f32 = torch.float32

    def site(v, s):
        if thresh >= 256:
            return v
        mask = dropout_mask(seed, s, v.shape, rate)
        return torch.where(mask, v / keep, torch.zeros((), dtype=v.dtype, device=v.device))

    def heads(t, parts):
        """(rows, parts·d) → ``parts`` tensors (B, H, T, hd)."""
        return t.view(bsz, seq_len, parts, n_heads, hd).permute(2, 0, 3, 1, 4)

    def attend(q, k, v, causal, s):
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        if causal:
            above = torch.ones(seq_len, seq_len, dtype=torch.bool, device=q.device).triu(1)
            scores = scores.masked_fill(above, float("-inf"))
        p = site(torch.softmax(scores, dim=-1).reshape(bsz * n_heads, seq_len, seq_len), s)
        p = p.reshape(bsz, n_heads, seq_len, seq_len).to(cd)
        out = torch.matmul(p.float(), v.float())  # (B, H, T, hd)
        return out.transpose(1, 2).reshape(m, d).to(cd)

    qkv = (y.float() @ wqkv.float().t() + bqkv).to(cd)
    attn = attend(*heads(qkv, 3), True, SITE_SELF)
    a1 = y.to(f32) + site(attn.float() @ wo.float().t() + bo, SITE_PROJ1)
    y1 = _ln(a1, g1, b1).to(cd)

    qc = (y1.float() @ wq.float().t() + bq).to(cd)
    kv = (mem.float() @ wkv.float().t() + bkv).to(cd)
    catt = attend(heads(qc, 1)[0], *heads(kv, 2), False, SITE_CROSS)
    a2 = y1.to(f32) + site(catt.float() @ wo2.float().t() + bo2, SITE_PROJ2)
    y2 = _ln(a2, g2, b2).to(cd)

    hpre = y2.float() @ w1.float().t() + b1f
    if relu_flips is None:
        hpre = torch.relu(hpre)
    else:
        hpre = hpre * ((hpre > 0) ^ relu_flips)
    hid = site(hpre, SITE_FFN).to(cd)
    a3 = y2.to(f32) + site(hid.float() @ w2.float().t() + b2f, SITE_OUT)
    y3 = _ln(a3, g3, b3).to(cd)
    if return_residuals:
        return y3, qkv, a1.to(cd), qc, kv, a2.to(cd), hid, a3.to(cd)
    return y3


# ---------------------------------------------------------------- gate

def bwd_rows_smem_bytes(t: int, d: int, ff: int) -> int:
    """Row-backward block: the carried gradient, a rounded row gradient, a
    normalised activation or dattn, dhpre then qc | kv then qkv (and their
    gradients), P and dS, and the three LayerNorms' statistics, in f32."""
    return 4 * (t * (3 * d + max(3 * d, ff)) + 2 * t * t + 8 * t)


def supports_fused_decoder_layer(d_model: int, n_heads: int, dim_feedforward: int,
                                 seq_len: int, dtype=torch.float32) -> bool:
    """Whether the kernels take this layer, by route.

    bf16 (``csrc/layer_sm90.cu``): the encoder layer's bf16 gate
    (``supports_fused_layer``: d a multiple of 8 up to the LayerNorm
    epilogues' 256, ff a multiple of 8, hd a multiple of 8 and T ≤ 32 for
    the attention's blocks); the cross-attention's blocks are the
    self-attention's.

    f32 (``csrc/fused_decoder_layer.cu``): the gate is the kernels' own, as
    ``supports_fused_layer``'s: one block holds one sequence (T ≤ 32 rows),
    every block's shared memory fits the 232,448 bytes a block may have, the
    products read 4 columns at a time (d and ff multiples of 4). The decoder
    layer needs no more shared memory than the encoder layer although it
    carries more: the forward's qc (d) and kv (2d) share the space qkv (3d)
    had, and the row backward runs in three stages (FFN, cross-attention,
    self-attention) that reuse one set of buffers, handing one (T, d) gradient
    on. The flagship (T 32, d 256, ff 512) needs 168 KB forward and 205 KB in
    the row backward. The TPU gate's 128-lane widths, ≤ 5 heads and ff ≤ 1024
    do not apply.
    """
    if dtype == torch.bfloat16:
        return supports_fused_layer(d_model, n_heads, dim_feedforward, seq_len, dtype)
    if dtype not in KERNEL_DTYPES or n_heads < 1 or d_model % n_heads:
        return False
    if not (1 <= seq_len <= MAX_T and d_model % 4 == 0 and dim_feedforward % 4 == 0):
        return False
    return max(fwd_smem_bytes(seq_len, d_model, dim_feedforward),
               bwd_rows_smem_bytes(seq_len, d_model, dim_feedforward),
               bwd_weights_smem_bytes(seq_len, d_model, n_heads)) <= MAX_SMEM_BYTES


# ---------------------------------------------------------------- kernels

@functools.cache
def _kernels():
    lib = _build.load_library("fused_decoder_layer")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tgi_dec_fwd, lib.tgi_dec_bwd_rows, lib.tgi_dec_bwd_weights):
        # the pointer array and its length; nseq, T, d, H, ff, thresh, is_bf16; the stream
        fn.argtypes = [ctypes.POINTER(p), i] + [i] * 7 + [p]
        fn.restype = i
    lib.tgi_dec_error_string.argtypes = [i]
    lib.tgi_dec_error_string.restype = ctypes.c_char_p
    return lib


class _Kernel(_build.CountedKernel):
    """One kernel of ``csrc/fused_decoder_layer.cu``; its entry point reads
    its pointers from one array and checks their number."""

    @staticmethod
    def pointers(tensors) -> list:
        return [(ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors]), len(tensors)]


# f32 route: the three CUDA-core kernels of csrc/fused_decoder_layer.cu
KERNELS = {name: _Kernel(_kernels, entry, "tgi_dec_error_string")
           for name, entry in (("fused_decoder_layer_fwd", "tgi_dec_fwd"),
                               ("fused_decoder_layer_bwd_rows", "tgi_dec_bwd_rows"),
                               ("fused_decoder_layer_bwd_weights", "tgi_dec_bwd_weights"))}
# bf16 route: the chain's launches of csrc/layer_sm90.cu, in launch order, by
# launch type (ops/layer_sm90.py)
SM90_LAUNCHES = {"qkv": "bias", "self_attn_fwd": "attn_fwd", "proj_ln1": "res_ln",
                 "qc": "bias", "kv": "bias", "cross_attn_fwd": "attn_fwd",
                 "proj2_ln2": "res_ln", "ffn_hidden": "hidden", "ffn_out_ln3": "res_ln",
                 "ln_rows": "ln_rows", "dh": "dh", "dy2_ln2": "ln_bwd", "dcross": "round",
                 "cross_attn_bwd": "attn_bwd", "dy1_ln1": "ln_bwd", "dmem": "round",
                 "dattn": "round", "self_attn_bwd": "attn_bwd", "dx": "round",
                 "wgrad": "wgrad", "reduce": "reduce"}
SM90_KERNELS = layer_sm90.counted_kernels("fused_decoder_layer_sm90", SM90_LAUNCHES)


def route_kernels(dtype) -> dict:
    """The counted kernels a layer call launches in ``dtype``: each once per
    forward (the first nine) or backward (the rest)."""
    return SM90_KERNELS if dtype == torch.bfloat16 else KERNELS


def _check(args: dict, seed, n_heads: int, seq_len: int) -> None:
    """Raise ``ValueError`` on what the kernels do not take."""
    y = args["y"]
    tensors = [*args.values(), seed]
    if any(t.device != y.device for t in tensors) or y.device.type != "cuda":
        raise ValueError("fused_decoder_layer kernels need every tensor on one CUDA "
                         f"device; got {sorted({str(t.device) for t in tensors})}")
    for name, t in args.items():
        want = y.dtype if name in WEIGHT_NAMES + ("y", "mem") else torch.float32
        if t.dtype != want:
            raise ValueError("fused_decoder_layer kernels take mem and the weights in y's "
                             f"dtype and float32 biases and LayerNorm parameters; {name} is "
                             f"{t.dtype}")
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError("fused_decoder_layer kernels take a one-element int32 seed")
    m, d = y.shape
    ff = args["w1"].shape[0]
    if not supports_fused_decoder_layer(d, n_heads, ff, seq_len, y.dtype) or m % seq_len:
        raise ValueError(
            f"fused_decoder_layer kernels do not take d={d}, heads={n_heads}, ff={ff}, "
            f"T={seq_len}, rows={m}, {y.dtype} (supports_fused_decoder_layer)")
    vec = {n: (d,) for n in ("bo", "bq", "bo2", "g1", "b1", "b2f", "g2", "b2", "g3", "b3")}
    want = {"y": (m, d), "mem": (m, d), "wqkv": (3 * d, d), "bqkv": (3 * d,), "wo": (d, d),
            "wq": (d, d), "wkv": (2 * d, d), "bkv": (2 * d,), "wo2": (d, d), "w1": (ff, d),
            "b1f": (ff,), "w2": (d, ff), **vec}
    got = {n: tuple(t.shape) for n, t in args.items()}
    if got != want:
        wrong = {n: (got[n], want[n]) for n in got if got[n] != want[n]}
        raise ValueError(f"fused_decoder_layer shapes (got, expected): {wrong}; the memory "
                         "must have the target's rows (equal source and target lengths)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_decoder_layer kernels take contiguous tensors")
    if y.dtype == torch.bfloat16 and any(args[n].data_ptr() % 16
                                         for n in WEIGHT_NAMES + ("y", "mem")):
        raise ValueError("fused_decoder_layer's bf16 kernels take y, mem and the weights "
                         "16-byte aligned (TMA)")


def forward_sm90(y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2, g1, b1, w1, b1f,
                 w2, b2f, g2, b2, g3, b3, seed, rate: float, n_heads: int, seq_len: int):
    """The bf16 route's forward as its chain of launches (``SM90_KERNELS``):
    ``(y3, qkv, a1, qc, kv, a2, h, a3)``. On CPU tensors each launch runs its
    plain version (any dtype)."""
    k = {name.removeprefix("fused_decoder_layer_sm90_"): f for name, f in SM90_KERNELS.items()}
    L = layer_sm90
    d = y.shape[1]
    qkv = L.bias_product(k["qkv"], y, wqkv, bqkv)
    attn = L.attention_forward(k["self_attn_fwd"], qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:],
                               seed, SITE_SELF, rate, n_heads, seq_len, causal=True)
    a1, y1 = L.residual_ln_product(k["proj_ln1"], attn, wo, bo, y, g1, b1, seed, SITE_PROJ1,
                                   rate)
    qc = L.bias_product(k["qc"], y1, wq, bq)
    kv = L.bias_product(k["kv"], mem, wkv, bkv)
    catt = L.attention_forward(k["cross_attn_fwd"], qc, kv[:, :d], kv[:, d:], seed, SITE_CROSS,
                               rate, n_heads, seq_len, causal=False)
    a2, y2 = L.residual_ln_product(k["proj2_ln2"], catt, wo2, bo2, y1, g2, b2, seed,
                                   SITE_PROJ2, rate)
    h = L.hidden_product(k["ffn_hidden"], y2, w1, b1f, seed, SITE_FFN, rate)
    a3, y3 = L.residual_ln_product(k["ffn_out_ln3"], h, w2, b2f, y2, g3, b3, seed, SITE_OUT,
                                   rate)
    return y3, qkv, a1, qc, kv, a2, h, a3


def backward_sm90(dy, y, mem, qkv, a1, qc, kv, a2, h, a3, wqkv, wo, wq, wkv, wo2, w1, w2,
                  g1, b1, g2, b2, g3, seed, rate: float, n_heads: int, seq_len: int):
    """The bf16 route's backward as its chain of launches (``SM90_KERNELS``),
    :func:`layer_backward`'s outputs. On CPU tensors each launch runs its
    plain version (any dtype)."""
    k = {name.removeprefix("fused_decoder_layer_sm90_"): f for name, f in SM90_KERNELS.items()}
    L = layer_sm90
    m, d = y.shape
    ff = w1.shape[0]
    (y1, y2, _), stats, da3, df = L.ln_rows(
        k["ln_rows"], [(a1, g1, b1, True), (a2, g2, b2, True), (a3, g3, None, False)], dy, seed,
        SITE_OUT, rate)
    dh = L.dh_product(k["dh"], df, w2, h, rate)
    da2, dy2, dproj2 = L.ln_backward_product(k["dy2_ln2"], dh, w1, da3, g2, a2, stats[:, 2:4],
                                             seed, SITE_PROJ2, rate)
    dcatt = L.round_product(k["dcross"], dproj2, wo2)
    dqc, dkv, catt = y.new_empty((m, d)), y.new_empty((m, 2 * d)), y.new_empty((m, d))
    L.attention_backward(k["cross_attn_bwd"], qc, kv[:, :d], kv[:, d:], dcatt, dqc, dkv[:, :d],
                         dkv[:, d:], catt, seed, SITE_CROSS, rate, n_heads, seq_len,
                         causal=False)
    da1, dy1, dproj = L.ln_backward_product(k["dy1_ln1"], dqc, wq, da2, g1, a1, stats[:, 0:2],
                                            seed, SITE_PROJ1, rate)
    dmem = L.round_product(k["dmem"], dkv, wkv)
    dattn = L.round_product(k["dattn"], dproj, wo)
    dqkv, attn = y.new_empty((m, 3 * d)), y.new_empty((m, d))
    L.attention_backward(k["self_attn_bwd"], qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:],
                         dattn, dqkv[:, :d], dqkv[:, d:2 * d], dqkv[:, 2 * d:], attn, seed,
                         SITE_SELF, rate, n_heads, seq_len, causal=True)
    dx = L.round_product(k["dx"], dqkv, wqkv, da1)
    grads = L.weight_gradients(
        k["wgrad"], k["reduce"],
        [(dqkv, y), (dproj, attn), (dqc, y1), (dkv, mem), (dproj2, catt), (dh, y2), (df, h)],
        [(dqkv, None, None), (dproj, None, None), (dqc, None, None), (dkv, None, None),
         (dproj2, None, None), (dy1, a1, stats[:, 0:2]), (dy1, None, None), (dh, None, None),
         (df, None, None), (dy2, a2, stats[:, 2:4]), (dy2, None, None),
         (dy, a3, stats[:, 4:6]), (dy, None, None)])
    dwqkv, dwo, dwq, dwkv, dwo2, dw1, dw2, vec = grads.split(
        [3 * d * d, d * d, d * d, 2 * d * d, d * d, ff * d, d * ff, 15 * d + ff])
    (dbqkv, dbo, dbq, dbkv, dbo2, dg1, db1, db1f, db2f, dg2, db2, dg3, db3) = vec.split(
        [3 * d, d, d, 2 * d, d, d, d, ff, d, d, d, d, d])
    return (dx, dmem, dwqkv.view(3 * d, d), dbqkv, dwo.view(d, d), dbo, dwq.view(d, d), dbq,
            dwkv.view(2 * d, d), dbkv, dwo2.view(d, d), dbo2, dg1, db1, dw1.view(ff, d), db1f,
            dw2.view(d, ff), db2f, dg2, db2, dg3, db3)


def _shape(m, d, n_heads, ff, seq_len, rate, dtype):
    return (m // seq_len, seq_len, d, n_heads, ff, quantized_threshold(rate),
            int(dtype == torch.bfloat16))


def layer_forward(y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2, g1, b1, w1, b1f,
                  w2, b2f, g2, b2, g3, b3, seed, rate: float, n_heads: int, seq_len: int):
    """Launch the forward: ``(y3, qkv, a1, qc, kv, a2, h, a3)``. bf16: the
    chain of :func:`forward_sm90`; f32: one CUDA-core kernel."""
    inputs = (y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2, g1, b1, w1, b1f, w2,
              b2f, g2, b2, g3, b3)
    _check(dict(zip(ARG_NAMES, inputs)), seed, n_heads, seq_len)
    if y.dtype == torch.bfloat16:
        return forward_sm90(*inputs, seed, rate, n_heads, seq_len)
    m, d = y.shape
    ff = w1.shape[0]
    out, a1, qc, a2, a3 = (torch.empty_like(y) for _ in range(5))
    qkv, kv, h = y.new_empty((m, 3 * d)), y.new_empty((m, 2 * d)), y.new_empty((m, ff))
    KERNELS["fused_decoder_layer_fwd"].launch(
        (*inputs, seed, out, qkv, a1, qc, kv, a2, h, a3),
        _shape(m, d, n_heads, ff, seq_len, rate, y.dtype), y.device)
    return out, qkv, a1, qc, kv, a2, h, a3


def layer_backward(dy, y, mem, qkv, a1, qc, kv, a2, h, a3, wqkv, wo, wq, wkv, wo2, w1, w2,
                   g1, b1, g2, b2, g3, seed, rate: float, n_heads: int, seq_len: int):
    """Launch the backward: ``(dx, dmem, dwqkv, dbqkv, dwo, dbo, dwq, dbq,
    dwkv, dbkv, dwo2, dbo2, dg1, db1, dw1, db1f, dw2, db2f, dg2, db2, dg3,
    db3)``, weight gradients in f32. bf16: the chain of
    :func:`backward_sm90`; f32: the row-backward and weight-gradient
    kernels."""
    m, d = y.shape
    ff = w1.shape[0]
    dy = dy.contiguous()
    if dy.dtype != y.dtype or dy.shape != y.shape or dy.device != y.device:
        raise ValueError(f"fused_decoder_layer backward: dy {dy.dtype} {tuple(dy.shape)} "
                         f"does not match y {y.dtype} {tuple(y.shape)}")
    if y.dtype == torch.bfloat16:
        return backward_sm90(dy, y, mem, qkv, a1, qc, kv, a2, h, a3, wqkv, wo, wq, wkv, wo2,
                             w1, w2, g1, b1, g2, b2, g3, seed, rate, n_heads, seq_len)
    shape = _shape(m, d, n_heads, ff, seq_len, rate, y.dtype)
    dx, dmem = torch.empty_like(y), torch.empty_like(y)
    f32 = dict(device=y.device, dtype=torch.float32)
    # row-wise gradients, f32: df | dhpre | dproj2 | dqc | dkv | dproj | dqkv |
    # dy·zh3 | dy2·zh2 | dy2 | dy1·zh1 | dy1 | (mean, rstd) of LN1 and LN2
    scratch = torch.empty((m, 14 * d + ff + 4), **f32)
    KERNELS["fused_decoder_layer_bwd_rows"].launch(
        (dy, qkv, a1, qc, kv, a2, h, a3, wqkv, wo, wq, wkv, wo2, w1, w2, g1, g2, g3, seed,
         dx, dmem, scratch), shape, y.device)
    dwqkv, dwkv = torch.empty((3 * d, d), **f32), torch.empty((2 * d, d), **f32)
    dwo, dwq, dwo2 = (torch.empty((d, d), **f32) for _ in range(3))
    dw1, dw2 = torch.empty((ff, d), **f32), torch.empty((d, ff), **f32)
    # dbqkv | dbo | dbq | dbkv | dbo2 | dg1 | db1 | db1f | db2f | dg2 | db2 | dg3 | db3
    vec = torch.empty(15 * d + ff, **f32)
    KERNELS["fused_decoder_layer_bwd_weights"].launch(
        (dy, y, mem, qkv, a1, qc, kv, a2, h, g1, b1, g2, b2, seed, scratch,
         dwqkv, dwo, dwq, dwkv, dwo2, dw1, dw2, vec), shape, y.device)
    (dbqkv, dbo, dbq, dbkv, dbo2, dg1, db1, db1f, db2f, dg2, db2, dg3, db3) = vec.split(
        [3 * d, d, d, 2 * d, d, d, d, ff, d, d, d, d, d])
    return (dx, dmem, dwqkv, dbqkv, dwo, dbo, dwq, dbq, dwkv, dbkv, dwo2, dbo2, dg1, db1,
            dw1, db1f, dw2, db2f, dg2, db2, dg3, db3)


class _DecoderLayerTrain(torch.autograd.Function):
    """The kernels under autograd, differentiable in both activations (y and
    mem): saves y, mem, qkv, a1, qc, kv, a2, h_drop and a3 (and the weights
    and seed), as the TPU kernel's ``_layer_fwd`` does."""

    @staticmethod
    def forward(ctx, y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2, g1, b1, w1, b1f,
                w2, b2f, g2, b2, g3, b3, seed, rate, n_heads, seq_len):
        out, *residuals = layer_forward(
            y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2, g1, b1, w1, b1f, w2, b2f,
            g2, b2, g3, b3, seed, rate, n_heads, seq_len)
        ctx.save_for_backward(y, mem, *residuals, wqkv, wo, wq, wkv, wo2, w1, w2,
                              g1, b1, g2, b2, g3, seed)
        ctx.static = (rate, n_heads, seq_len)
        return out

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        weights = saved[9:16]
        grads = list(layer_backward(dy, *saved, *ctx.static))
        # weight grads rounded to the weights' dtype, as _layer_bwd does:
        # dwqkv, dwo, dwq, dwkv, dwo2 at 2, 4, 6, 8, 10; dw1, dw2 at 14, 16
        for i, w in zip((2, 4, 6, 8, 10, 14, 16), weights):
            grads[i] = grads[i].to(w.dtype)
        return (*grads, None, None, None, None)


def decoder_layer_train(y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2, g1, b1,
                        w1, b1f, w2, b2f, g2, b2, g3, b3, seed, rate: float, n_heads: int,
                        seq_len: int):
    """Fused post-LN decoder layer for training, the JAX signature.

    ``y``, ``mem``: (rows, d) target and encoder-memory activations, rows =
    batch·seq_len in the same sequence-major order; weights (3d, d), (d, d),
    (d, d), (2d, d), (d, d), (ff, d), (d, ff) in nn.Linear's (out, in) layout
    (the JAX function takes their transposes) and the compute dtype; biases
    and LN parameters f32; ``seed`` a one-element int32 tensor (one per step
    and layer). CPU tensors run :func:`decoder_layer_reference`; CUDA tensors
    the kernels, or it raises.
    """
    tensors = (y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2, g1, b1, w1, b1f, w2,
               b2f, g2, b2, g3, b3, seed)
    if all(t.device.type == "cpu" for t in tensors):
        return decoder_layer_reference(*tensors, rate, n_heads, seq_len)
    return _DecoderLayerTrain.apply(*tensors, rate, n_heads, seq_len)
