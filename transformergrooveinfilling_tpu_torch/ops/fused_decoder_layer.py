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
target lengths must be equal). One chain of launches of ``csrc/layer_sm90.cu``
(``ops/layer_sm90.py``) in both storage dtypes, on the encoder layer's design
(``ops/fused_layer.py``): every product on the tensor cores (``wgmma`` + TMA;
f32 in split TF32) and the elementwise work in the products' epilogues
(:func:`forward_sm90`, :func:`backward_sm90`): nine launches forward, twelve
backward, the seven weight gradients and 13 bias and LayerNorm-parameter sums
in one grouped launch with a fixed-order reduce of its row splits.
``SM90_KERNELS`` (bf16) and ``SM90_F32_KERNELS`` (f32) count each launch.
Past d 256 (``layer_sm90.LN_TILE``) the chain takes its wide route, 26
launches (twelve forward) where the three residual LayerNorms and the two
LayerNorm backwards in products' epilogues become a product and a row pass
each (``SM90_WIDE_KERNELS``, ``SM90_WIDE_F32_KERNELS``, ``route_kernels(dtype,
d)``). No float atomics: two runs with one seed agree bit for bit.

What bounds it on the H100: about 1.6 MFLOP of products per row forward and
twice that backward at d 256 / ff 512: operations, not memory, on the tensor
cores (989 TFLOP/s in bf16, 165 in split-TF32 f32). The
probabilities, both attention outputs and every mask are recomputed in the
backward (masks from the Philox stream of ``ops/fused_layer.py::
dropout_mask``), and the autograd Function saves exactly what the TPU kernel
stores: y, mem, qkv, a1, qc, kv, a2, h_drop, a3.

On a CPU tensor :func:`decoder_layer_train` runs the twin
:func:`decoder_layer_reference`; on a CUDA tensor it launches the kernels or
raises.

The chain is two operators, ``tgi::decoder_layer_fwd`` (``(y3, qkv, a1, qc,
kv, a2, h, a3)``) and ``tgi::decoder_layer_bwd`` (dx, dmem and the 20
parameter gradients flat), bound for autograd by :class:`DecoderLayerTrain`;
under ``torch.func.vmap`` their vmap rules launch each trial's chain on its
slices and seed (``ops/per_trial.py``; a memory without a trial axis is every
trial's), and on CPU tensors their bodies run each launch's plain version.
Outside ``torch.func`` the wrapper takes :class:`_DecoderLayerTrain`, which
launches the chain directly, as it did before the operators.
"""

from __future__ import annotations

import math

import torch

from . import layer_sm90, per_trial
from .dropout import quantized_threshold
from .fused_layer import _ln, _on_cpu, dropout_mask, supports_fused_layer

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

def supports_fused_decoder_layer(d_model: int, n_heads: int, dim_feedforward: int,
                                 seq_len: int, dtype=torch.float32) -> bool:
    """Whether the chain of ``csrc/layer_sm90.cu`` takes this decoder layer
    in ``dtype``: the encoder layer's gate (``supports_fused_layer``: d a
    multiple of 8 up to 8,192, heads of any width, ff a multiple of 8, T ≤
    256, in bf16 heads a multiple of 8 wide, in f32 ff ≤ ``F32_MAX_FF``,
    measured on this chain too); the cross-attention's blocks, and the
    causal self-attention's, are the encoder's self-attention's at every T. In f32 it admits every width of ``configs/*.yaml``
    up to ff 1,024 and refuses what that gate refuses (d or ff a multiple of
    4 but not of 8), which the f32 CUDA-core kernels before it took by shared
    memory alone. It admits every width of the JAX decoder's gate (the
    encoder's, ``transformergrooveinfilling_tpu/ops/fused_decoder_layer.py``)
    up to d 8,192. The TPU gate's 128-lane widths, ≤ 5 heads and ff ≤ 1024 do
    not apply.
    """
    return supports_fused_layer(d_model, n_heads, dim_feedforward, seq_len, dtype)


# ---------------------------------------------------------------- kernels

# the chain's launches of csrc/layer_sm90.cu, in launch order, by launch type
# (ops/layer_sm90.py); each dtype counts its own
SM90_LAUNCHES = {"qkv": "bias", "self_attn_fwd": "attn_fwd", "proj_ln1": "res_ln",
                 "qc": "bias", "kv": "bias", "cross_attn_fwd": "attn_fwd",
                 "proj2_ln2": "res_ln", "ffn_hidden": "hidden", "ffn_out_ln3": "res_ln",
                 "ln_rows": "ln_rows", "dh": "dh", "dy2_ln2": "ln_bwd", "dcross": "round",
                 "cross_attn_bwd": "attn_bwd", "dy1_ln1": "ln_bwd", "dmem": "round",
                 "dattn": "round", "self_attn_bwd": "attn_bwd", "dx": "round",
                 "wgrad": "wgrad", "reduce": "reduce"}
_ROUTES = layer_sm90.routes("fused_decoder_layer_sm90", SM90_LAUNCHES)
SM90_KERNELS = _ROUTES[torch.bfloat16, False]
SM90_F32_KERNELS = _ROUTES[torch.float32, False]
# the wide route (d past layer_sm90.LN_TILE): each LayerNorm-epilogue launch as
# a product (_sum) and a row pass (_rows), the others shared with the route above
# (the same counters)
SM90_WIDE_LAUNCHES = layer_sm90.wide_launches(SM90_LAUNCHES)
SM90_WIDE_KERNELS = _ROUTES[torch.bfloat16, True]
SM90_WIDE_F32_KERNELS = _ROUTES[torch.float32, True]


def route_kernels(dtype, d: int | None = None) -> dict:
    """The counted kernels a layer call launches in ``dtype`` (bf16 or f32)
    at width ``d`` (None: up to ``layer_sm90.LN_TILE``), in launch order, each
    once per call: 21, the first nine forward; past d 256 the wide route's
    26, the first twelve forward."""
    return layer_sm90.route(_ROUTES, dtype, d)


def _launches(dtype, d: int) -> dict:
    """``route_kernels(dtype, d)`` keyed by the launch's name in
    ``SM90_LAUNCHES`` (a split launch as its (product, row pass) pair)."""
    return layer_sm90.by_launch(SM90_LAUNCHES, route_kernels(dtype, d), layer_sm90.is_wide(d))


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
    if any(args[n].data_ptr() % 16 for n in WEIGHT_NAMES + ("y", "mem")):
        raise ValueError("fused_decoder_layer kernels take y, mem and the weights 16-byte "
                         "aligned (TMA)")


def forward_sm90(y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2, g1, b1, w1, b1f,
                 w2, b2f, g2, b2, g3, b3, seed, rate: float, n_heads: int, seq_len: int):
    """The forward as its chain of launches (``route_kernels(y.dtype, d)``):
    ``(y3, qkv, a1, qc, kv, a2, h, a3)``. On CPU tensors each launch runs its
    plain version."""
    L = layer_sm90
    d = y.shape[1]
    k = _launches(y.dtype, d)
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
    """The backward as its chain of launches (``route_kernels(y.dtype, d)``),
    :func:`layer_backward`'s outputs. On CPU tensors each launch runs its
    plain version."""
    dx, dmem, grads = _backward_flat(dy, y, mem, qkv, a1, qc, kv, a2, h, a3, wqkv, wo, wq, wkv,
                                     wo2, w1, w2, g1, b1, g2, b2, g3, seed, rate, n_heads,
                                     seq_len)
    return dx, dmem, *split_grads(grads, y.shape[1], w1.shape[0])


def _backward_flat(dy, y, mem, qkv, a1, qc, kv, a2, h, a3, wqkv, wo, wq, wkv, wo2, w1, w2,
                   g1, b1, g2, b2, g3, seed, rate: float, n_heads: int, seq_len: int):
    """:func:`backward_sm90` with the parameter gradients as the one flat f32
    tensor the weight-gradient launch writes (:func:`split_grads`)."""
    L = layer_sm90
    m, d = y.shape
    k = _launches(y.dtype, d)
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
    return dx, dmem, grads


def split_grads(grads, d: int, ff: int):
    """The backward's flat f32 parameter gradients → the 20 gradients in the
    JAX argument order (``dwqkv, dbqkv, dwo, dbo, dwq, dbq, dwkv, dbkv, dwo2,
    dbo2, dg1, db1, dw1, db1f, dw2, db2f, dg2, db2, dg3, db3``), views."""
    dwqkv, dwo, dwq, dwkv, dwo2, dw1, dw2, vec = grads.split(
        [3 * d * d, d * d, d * d, 2 * d * d, d * d, ff * d, d * ff, 15 * d + ff])
    (dbqkv, dbo, dbq, dbkv, dbo2, dg1, db1, db1f, db2f, dg2, db2, dg3, db3) = vec.split(
        [3 * d, d, d, 2 * d, d, d, d, ff, d, d, d, d, d])
    return (dwqkv.view(3 * d, d), dbqkv, dwo.view(d, d), dbo, dwq.view(d, d), dbq,
            dwkv.view(2 * d, d), dbkv, dwo2.view(d, d), dbo2, dg1, db1, dw1.view(ff, d), db1f,
            dw2.view(d, ff), db2f, dg2, db2, dg3, db3)



def layer_forward(y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2, g1, b1, w1, b1f,
                  w2, b2f, g2, b2, g3, b3, seed, rate: float, n_heads: int, seq_len: int):
    """Launch the forward, the chain of :func:`forward_sm90`: ``(y3, qkv, a1,
    qc, kv, a2, h, a3)``."""
    inputs = (y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2, g1, b1, w1, b1f, w2,
              b2f, g2, b2, g3, b3)
    _check(dict(zip(ARG_NAMES, inputs)), seed, n_heads, seq_len)
    return forward_sm90(*inputs, seed, rate, n_heads, seq_len)


def layer_backward(dy, y, mem, qkv, a1, qc, kv, a2, h, a3, wqkv, wo, wq, wkv, wo2, w1, w2,
                   g1, b1, g2, b2, g3, seed, rate: float, n_heads: int, seq_len: int):
    """Launch the backward, the chain of :func:`backward_sm90`: ``(dx, dmem,
    dwqkv, dbqkv, dwo, dbo, dwq, dbq, dwkv, dbkv, dwo2, dbo2, dg1, db1, dw1,
    db1f, dw2, db2f, dg2, db2, dg3, db3)``, weight gradients in f32."""
    dx, dmem, grads = _launch_backward(dy, y, mem, qkv, a1, qc, kv, a2, h, a3, wqkv, wo, wq, wkv,
                                       wo2, w1, w2, g1, b1, g2, b2, g3, seed, rate, n_heads,
                                       seq_len)
    return dx, dmem, *split_grads(grads, y.shape[1], w1.shape[0])


def _launch_backward(dy, y, *saved):
    """:func:`layer_backward` with the parameter gradients flat."""
    dy = dy.contiguous()
    if dy.dtype != y.dtype or dy.shape != y.shape or dy.device != y.device:
        raise ValueError(f"fused_decoder_layer backward: dy {dy.dtype} {tuple(dy.shape)} "
                         f"does not match y {y.dtype} {tuple(y.shape)}")
    return _backward_flat(dy, y, *saved)


_T = torch.Tensor


def _layer_fwd(y: _T, mem: _T, wqkv: _T, bqkv: _T, wo: _T, bo: _T, wq: _T, bq: _T, wkv: _T,
               bkv: _T, wo2: _T, bo2: _T, g1: _T, b1: _T, w1: _T, b1f: _T, w2: _T, b2f: _T,
               g2: _T, b2: _T, g3: _T, b3: _T, seed: _T, rate: float, n_heads: int,
               seq_len: int) -> tuple[_T, _T, _T, _T, _T, _T, _T, _T]:
    """The forward as an operator, ``(y3, qkv, a1, qc, kv, a2, h, a3)``: the
    chain of :func:`layer_forward` (or its ``ValueError``); on CPU tensors
    each launch's plain version."""
    args = (y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2, g1, b1, w1, b1f, w2, b2f,
            g2, b2, g3, b3, seed)
    if _on_cpu(args):
        return per_trial.apart(forward_sm90(*args, rate, n_heads, seq_len), args)
    return layer_forward(*args, rate, n_heads, seq_len)


layer_fwd_op = torch.library.custom_op("tgi::decoder_layer_fwd", _layer_fwd,
                                       mutates_args=())


@layer_fwd_op.register_fake
def _layer_fwd_fake(y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2, g1, b1, w1, b1f, w2,
                    b2f, g2, b2, g3, b3, seed, rate, n_heads, seq_len):
    m, d = y.shape
    like = torch.empty_like
    return (like(y), y.new_empty((m, 3 * d)), like(y), like(y), y.new_empty((m, 2 * d)),
            like(y), y.new_empty((m, w1.shape[0])), like(y))


def _layer_bwd(dy: _T, y: _T, mem: _T, qkv: _T, a1: _T, qc: _T, kv: _T, a2: _T, h: _T, a3: _T,
               wqkv: _T, wo: _T, wq: _T, wkv: _T, wo2: _T, w1: _T, w2: _T, g1: _T, b1: _T,
               g2: _T, b2: _T, g3: _T, seed: _T, rate: float, n_heads: int,
               seq_len: int) -> tuple[_T, _T, _T]:
    """The backward as an operator, ``(dx, dmem, grads)``: ``grads`` the 20
    parameter gradients flat in f32 (:func:`split_grads`); the chain of
    :func:`layer_backward`, on CPU tensors each launch's plain version."""
    args = (dy, y, mem, qkv, a1, qc, kv, a2, h, a3, wqkv, wo, wq, wkv, wo2, w1, w2, g1, b1, g2,
            b2, g3, seed)
    if _on_cpu(args):
        return per_trial.apart(_backward_flat(*args, rate, n_heads, seq_len), args)
    return _launch_backward(*args, rate, n_heads, seq_len)


layer_bwd_op = torch.library.custom_op("tgi::decoder_layer_bwd", _layer_bwd,
                                       mutates_args=())


@layer_bwd_op.register_fake
def _layer_bwd_fake(dy, y, mem, qkv, a1, qc, kv, a2, h, a3, wqkv, wo, wq, wkv, wo2, w1, w2, g1,
                    b1, g2, b2, g3, seed, rate, n_heads, seq_len):
    d, ff = y.shape[1], w1.shape[0]
    return (torch.empty_like(y), torch.empty_like(mem),
            y.new_empty((9 * d * d + 2 * d * ff + 15 * d + ff,), dtype=torch.float32))


layer_fwd_op.register_vmap(per_trial.rule(layer_fwd_op))
layer_bwd_op.register_vmap(per_trial.rule(layer_bwd_op))


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


class DecoderLayerTrain(torch.autograd.Function):
    """The two operators under autograd, for ``torch.func``: saves what
    :class:`_DecoderLayerTrain` saves, the residuals travelling as the
    forward's outputs. Under ``torch.func.vmap`` both run once per trial
    (``ops/per_trial.py``); a memory without a trial axis is every trial's."""

    generate_vmap_rule = True

    @staticmethod
    def forward(*args):
        return layer_fwd_op(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        args = dict(zip(ARG_NAMES, inputs))
        residuals = output[1:]
        ctx.save_for_backward(args["y"], args["mem"], *residuals,
                              *(args[n] for n in WEIGHT_NAMES),
                              *(args[n] for n in ("g1", "b1", "g2", "b2", "g3")), inputs[22])
        ctx.mark_non_differentiable(*residuals)
        ctx.static = inputs[23:]

    @staticmethod
    def backward(ctx, dy, *_residuals):
        saved = ctx.saved_tensors
        with torch.no_grad():  # torch.func.grad records the backward otherwise
            dx, dmem, grads = layer_bwd_op(dy, *saved, *ctx.static)
        y, weights = saved[0], saved[9:16]
        out = list(split_grads(grads, y.shape[-1], weights[5].shape[-2]))
        # weight grads rounded to the weights' dtype, as _layer_bwd does:
        # dwqkv, dwo, dwq, dwkv, dwo2 at 0, 2, 4, 6, 8; dw1, dw2 at 12, 14
        for i, w in zip((0, 2, 4, 6, 8, 12, 14), weights):
            out[i] = out[i].to(w.dtype)
        return (dx, dmem, *out, None, None, None, None)


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
    the kernels through :class:`_DecoderLayerTrain`, or it raises. Under a
    ``torch.func`` transform tensors on either device go through
    :class:`DecoderLayerTrain` (on CPU tensors its operators' plain bodies), and
    under ``vmap`` each trial launches the chain with its own slices and seed.
    """
    tensors = (y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2, g1, b1, w1, b1f, w2,
               b2f, g2, b2, g3, b3, seed)
    if per_trial.transformed():
        per_trial.check_devices("fused_decoder_layer", tensors)
        return DecoderLayerTrain.apply(*tensors, float(rate), int(n_heads), int(seq_len))[0]
    if _on_cpu(tensors):
        return decoder_layer_reference(*tensors, rate, n_heads, seq_len)
    return _DecoderLayerTrain.apply(*tensors, rate, n_heads, seq_len)
