"""Whole-encoder-layer training kernel: wrappers, plain twin and dropout masks.

Replaces the Pallas TPU kernel ``transformergrooveinfilling_tpu/ops/
fused_layer.py::encoder_layer_train`` (forward ``_fwd_call`` → ``_fwd_kernel``,
backward ``_bwd_call`` → ``_bwd_kernel``): the whole post-LN encoder layer

    qkv = x·Wqkv + b;  per head P = softmax(QKᵀ/√hd), A = drop(P)·V
    y1 = LN1(x + drop(A·Wo + bo));  h = drop(relu(y1·W1 + b1))
    y2 = LN2(y1 + drop(h·W2 + b2))

with four dropout sites, and its backward, as a chain of launches of
``csrc/layer_sm90.cu`` (``ops/layer_sm90.py``) in both storage dtypes, bf16
and f32, with every product on the tensor cores (``wgmma`` + TMA) and the
layer's elementwise work in the products' epilogues: forward qkv, the
attention per (sequence, head), Wo with the residual and LN1, W1 with ReLU
and the mask, W2 with the residual and LN2 (:func:`forward_sm90`); backward
the LayerNorm rows (LN2's backward, y1 again), dh, dh·W1 with LN1's backward,
dattn, the attention's backward, dx, and all weight and LayerNorm-parameter
gradients in one grouped launch with a fixed-order reduce of its row splits
(:func:`backward_sm90`). bf16 products run as they are; f32 products run in
split TF32 (3xTF32: each operand split into a TF32 high part and a TF32
remainder, three tensor-core products summed in f32), within about 2⁻²² of
an f32 product, where one TF32 product would miss the f32 bars. Each dtype
counts its own launches: ``SM90_KERNELS`` (bf16), ``SM90_F32_KERNELS``
(f32), ``route_kernels(dtype)`` picks. Past d 256 (``layer_sm90.LN_TILE``)
the chain takes its wide route, 16 launches where the LayerNorm epilogues'
three launches become a product and a row pass each (``SM90_WIDE_KERNELS``,
``SM90_WIDE_F32_KERNELS``, ``route_kernels(dtype, d)``). No float atomics,
so two runs with one seed agree bit for bit.

What bounds it on the H100: about 1.05 MFLOP of products per row forward and
2.1 MFLOP backward at the flagship width (d 256, ff 512) — operations, not
memory: on the tensor cores 17 µs forward at 16,384 rows in bf16 (989
TFLOP/s) and 104 µs in f32 (165 TFLOP/s, a third of TF32's 495). The chain
keeps what the TPU kernel keeps out of device memory out of it: the probabilities
and every mask are recomputed (masks from a counter-based Philox4x32-10
stream keyed by the seed and counted by (site, row, column)), and the
autograd Function saves exactly x, qkv, a1, h_drop and a2.

``dropout_mask`` is the kernels' mask generator in plain PyTorch, so the
kernel and :func:`encoder_layer_reference` draw the same masks. On a CPU
tensor :func:`encoder_layer_train` runs the twin; on a CUDA tensor it
launches the kernels or raises.

The chain is two operators, ``tgi::encoder_layer_fwd`` (``(y, qkv, a1, h,
a2)``) and ``tgi::encoder_layer_bwd`` (dx and the 12 parameter gradients
flat), bound for autograd by :class:`EncoderLayerTrain`; under
``torch.func.vmap`` their vmap rules launch each trial's chain on its slices
and seed (``ops/per_trial.py``), and on CPU tensors their bodies run each
launch's plain version. Outside ``torch.func`` the wrapper takes
:class:`_EncoderLayerTrain`, which launches the chain directly, as it did
before the operators.
"""

from __future__ import annotations

import math

import torch

from . import layer_sm90, per_trial
from .dropout import quantized_threshold

LN_EPS = 1e-5
MAX_T = layer_sm90.MAX_T  # the attention launches' longest sequence (256)
# shared memory one block may take on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# dropout sites: attention probabilities, then the three elementwise sites
SITE_ATTN, SITE_PROJ, SITE_FFN, SITE_OUT = 0, 1, 2, 3
# kink_flips: how close to 0, relative to max|h|, a hidden unit must be for
# the kernel and the twin to disagree on its ReLU (f32: summation order and
# the split product's ~2⁻²² of each term;
# bf16: an input of the product rounded to a neighbouring value, up to 4.4e-4
# on an H100 at the flagship width), and the share of units that may. The
# H100 showed 0-1 flips per call in f32 and 1-2 in 8.4M units in bf16.
KINK_BAND = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
KINK_SHARE = 1e-5
# ... and of a whole bf16 layer of the wide route (d 512) against its twin,
# each flip within KINK_BAND: an H100 read up to 1.57e-4 of the units at the
# decoder (B 32, 4 heads, ff 1,024) and 5.3e-5 at the encoder, an input of W1
# rounded to the neighbouring bf16 value upstream, where the tensor cores sum
# in another order than the twin (the hidden product alone holds KINK_SHARE)
WIDE_KINK_SHARE = 3e-4
# ... and past d 1,024, where more rounded values of a row reach W1's input
# and each pre-activation sums more of them: an H100 read 4.4e-4 of the units
# (29 of 65,536) at the bf16 decoder at d 2,048 (2 heads, ff 1,024, B 2, rate
# 0.30), each flip within KINK_BAND (8.7e-4 of max|h|)
WIDEST_KINK_SHARE = 1e-3


def wide_kink_share(d: int) -> float:
    """The share of a whole bf16 layer's hidden units of width ``d`` (the
    wide route) that may flip against its twin: ``WIDE_KINK_SHARE`` up to d
    1,024, ``WIDEST_KINK_SHARE`` past it."""
    return WIDEST_KINK_SHARE if d > 1024 else WIDE_KINK_SHARE

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------- masks

def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of the 64-bit product of uint32 ``a`` (held in
    int64) and the constant ``m``, from 16-bit halves: int64 cannot hold the
    unsigned product itself."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    mid = a_hi * m_lo + a_lo * m_hi  # < 2^33
    low = a_lo * m_lo + ((mid & 0xFFFF) << 16)  # < 2^33
    hi = a_hi * m_hi + (mid >> 16) + (low >> 32)
    return hi & _U32, low & _U32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 over int64 tensors holding uint32 values (broadcast)."""
    for i in range(10):
        if i:
            k0 = (k0 + _W0) & _U32
            k1 = (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bytes(seed, site: int, shape) -> torch.Tensor:
    """One random byte per element of ``shape`` (uint8 values in int64),
    as the kernels draw them. The last axis is the column, the others
    flatten into the row; element (row, col) takes byte ``col % 16`` of
    Philox4x32-10 at counter (col // 16, row, site, 0) under key (seed, 0).
    ``seed`` is an int or a one-element integer tensor (it sets the device)."""
    seed = torch.as_tensor(seed)
    dev = seed.device
    rows = math.prod(shape[:-1])
    cols = shape[-1]
    k0 = seed.reshape(()).to(torch.int64) & _U32
    c0 = torch.arange((cols + 15) // 16, device=dev, dtype=torch.int64)[None, :]
    c1 = torch.arange(rows, device=dev, dtype=torch.int64)[:, None]
    zero = torch.zeros((), device=dev, dtype=torch.int64)
    words = philox4x32(c0, c1, zero + site, zero, k0, zero)
    shifts = torch.arange(0, 32, 8, device=dev, dtype=torch.int64)
    words = torch.broadcast_tensors(*words)
    b = torch.stack(words, -1)[..., None] >> shifts  # (rows, groups, 4, 4)
    b = (b & 0xFF).reshape(rows, -1)[:, :cols]
    return b.reshape(shape)


def dropout_mask(seed, site: int, shape, rate: float) -> torch.Tensor:
    """Keep mask of one site: the byte is below ``quantized_threshold``."""
    return dropout_bytes(seed, site, shape) < quantized_threshold(rate)


# ---------------------------------------------------------------- twin

def _ln(a: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 LayerNorm with the one-pass variance clamped at 0 (JAX
    ``_ln_stats``)."""
    mu = a.mean(-1, keepdim=True)
    var = torch.clamp((a * a).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (a - mu) * torch.rsqrt(var + LN_EPS) * g + b


def encoder_layer_reference(x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f,
                            g2, b2, seed, rate: float, n_heads: int,
                            seq_len: int, return_residuals: bool = False,
                            relu_flips=None):
    """The kernels' math in plain PyTorch; its gradient is autograd's.

    ``x``: (rows, d), rows = batch·seq_len, sequence-major; weights in
    nn.Linear's (out, in) layout and the compute dtype (``x.dtype``), biases
    and LN parameters f32. Rounding points as the TPU kernel's: qkv, P
    (after dropout), the attention output, y1 and h are rounded to the
    compute dtype; residual sums and LayerNorms are f32; every product
    accumulates in f32. With ``return_residuals`` returns
    ``(y, qkv, a1, h, a2)``.

    ``relu_flips`` (rows, ff) bool, optional, for checks against the
    kernels: the FFN hidden units at which the twin takes the other side of
    the ReLU's kink than its own ``hpre > 0``, from :func:`kink_flips`.
    """
    cd = x.dtype
    m, d = x.shape
    bsz, hd = m // seq_len, d // n_heads
    thresh = quantized_threshold(rate)
    keep = thresh / 256.0
    drop = thresh < 256
    f32 = torch.float32

    def site(v, s):
        if not drop:
            return v
        mask = dropout_mask(seed, s, v.shape, rate)
        return torch.where(mask, v / keep, torch.zeros((), dtype=v.dtype, device=v.device))

    qkv = (x.float() @ wqkv.float().t() + bqkv).to(cd)
    q, k, v = qkv.view(bsz, seq_len, 3, n_heads, hd).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    p = torch.softmax(s, dim=-1)
    p = site(p.reshape(bsz * n_heads, seq_len, seq_len), SITE_ATTN)
    p = p.reshape(bsz, n_heads, seq_len, seq_len).to(cd)
    attn = torch.matmul(p.float(), v.float())  # (B, H, T, hd)
    attn = attn.transpose(1, 2).reshape(m, d).to(cd)
    proj = site(attn.float() @ wo.float().t() + bo, SITE_PROJ)
    a1 = x.to(f32) + proj
    y1 = _ln(a1, g1, b1).to(cd)
    hpre = y1.float() @ w1.float().t() + b1f
    if relu_flips is None:
        hpre = torch.relu(hpre)
    else:
        hpre = hpre * ((hpre > 0) ^ relu_flips)
    hid = site(hpre, SITE_FFN).to(cd)
    f = site(hid.float() @ w2.float().t() + b2f, SITE_OUT)
    a2 = y1.to(f32) + f
    y = _ln(a2, g2, b2).to(cd)
    if return_residuals:
        return y, qkv, a1.to(cd), hid, a2.to(cd)
    return y


def kink_flips(twin_h: torch.Tensor, kernel_h: torch.Tensor, share: float = KINK_SHARE):
    """The FFN hidden units at which the kernel and the twin, run on the same
    inputs and masks, fall on opposite sides of the ReLU's kink: ``(flips,
    stats)``, ``flips`` for ``encoder_layer_reference(relu_flips=...)``.

    A unit within rounding of 0 lands on either side depending on the order
    of its sum, and the gradient through it is then all or nothing. ``twin_h``
    and ``kernel_h`` are the two ``h_drop`` (rows, ff). Raises ``ValueError``
    unless every flipped unit is within ``KINK_BAND`` · max|h| of 0 and
    flips are at most ``share`` of the units (plus 4; ``KINK_SHARE`` for one
    launch, a whole layer's more, ``WIDE_KINK_SHARE``): a kernel that zeroes
    units it should keep, or keeps units it should zero, fails here.
    """
    th, kh = twin_h.float(), kernel_h.float()
    flips = (th > 0) != (kh > 0)
    scale = float(th.abs().max())
    n = int(flips.sum())
    largest = float(torch.maximum(th, kh)[flips].max()) / scale if n else 0.0
    stats = {"flips": n, "units": flips.numel(), "largest_rel": largest}
    if largest > KINK_BAND[twin_h.dtype] or n > share * flips.numel() + 4:
        raise ValueError(f"kernel and twin ReLU decisions differ beyond rounding: {stats}, "
                         f"band {KINK_BAND[twin_h.dtype]}, share {share}")
    return flips, stats


# ---------------------------------------------------------------- gate

# The widest ff the f32 chain takes. Its LayerNorm-epilogue products (W2 with
# the last LayerNorm; dh·W1 with an LN's backward) sum over ff in 64 × 256
# tiles that cannot promote their sums, so their drift grows with ff. On an
# NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phases 8 and 14: d 256, B 32,
# each launch against its plain version, the worst of 8 seeded inputs), the
# worst launch of the encoder / decoder chain reads 5.0e-6 / 5.6e-6 of its
# largest value at ff 1,024, 1.04e-5 / 1.01e-5 at 2,048, 1.9e-5 / 2.0e-5 at
# 4,096 and 4.0e-5 / 4.1e-5 at 8,192, against the chain's 1e-5 bar. Wider f32
# layers take the unfused path (a forced switch raises).
F32_MAX_FF = 1024


def supports_fused_layer(d_model: int, n_heads: int, dim_feedforward: int,
                         seq_len: int, dtype=torch.float32) -> bool:
    """Whether the chain of ``csrc/layer_sm90.cu`` takes this layer in
    ``dtype``.

    Both dtypes: d a multiple of 8 up to 8,192 (``layer_sm90.MAX_D``: the
    LayerNorm epilogues' tile spans a row up to 256; past it the wide route's
    row passes hold a row in a warp up to 1,024 and in a block of 256 threads
    up to 8,192, 32 values of it a thread; TMA's 16-byte row strides; the row
    passes read 8 columns a lane), ff a multiple of 8 (the column sums read 8
    at a time), d divisible by the heads, and T ≤ 256 (a loop of 16 bars at
    sixteenths; the attention launches take a (sequence, head) in one block
    up to T 32, scores in registers, and past it split by query rows over
    blocks whose scores lie in shared memory, ``layer_sm90.MAX_T``); the
    caller's rows are whole sequences, a multiple of T (the chain raises
    otherwise). That covers every T of the JAX gate (32, 64, 128 and 256:
    the lengths whose sequences tile its 128- or 256-row blocks) and the
    lengths between. Heads of any width: the
    attention streams a head's columns through shared memory
    (``csrc/attn_stream_sm90.cuh``), so its blocks do not grow with hd. bf16
    also needs heads of a width hd that is a multiple of 8 (its attention
    loads 16-byte rows by cp.async and zero-fills hd to the mma's k of 16);
    the f32 attention copies rows in chunks as narrow as one value and
    zero-fills hd to the TF32 mma's k of 8, so it takes any hd. Rows and the
    head count are otherwise free: the products' ragged edges are TMA's zero
    fill. This admits every (d, heads, ff) of the JAX gate
    (``transformergrooveinfilling_tpu/ops/fused_layer.py::
    supports_fused_layer``: d and ff multiples of 128, ≤ 5 heads of a width
    that is a multiple of 128 or 64 in pairs, ff ≤ 1,024) up to d 8,192; past
    it (ROADMAP) the layer takes the unfused path.

    f32 also needs ff ≤ ``F32_MAX_FF`` (1,024: the widest measured ff whose
    unpromoted sums hold the chain's 1e-5 bar on the card). In f32 this
    admits every width of ``configs/*.yaml`` at T 32 but the lm config's ff
    2,048: d 32 with 16 heads (hd 2) and ff 512, d 32 / 4 heads / ff 16, d 64
    / 16 / 256, d 256 / 16 / 64 and d 256 / 2 / 512. The f32 CUDA-core
    kernels this chain replaced took, by shared memory alone, d or ff a
    multiple of 4 but not of 8, which this gate refuses. Under auto those
    widths take the unfused path; a forced ``fused_layer=True`` raises
    ``ValueError``.

    The TPU gate's 128-lane widths, ≤ 5 heads and ff ≤ 1024 (scoped VMEM) do
    not apply.
    """
    if dtype not in KERNEL_DTYPES or n_heads < 1 or d_model % n_heads or not 1 <= seq_len <= MAX_T:
        return False
    if dtype == torch.bfloat16 and (d_model // n_heads) % 8:
        return False
    if dtype == torch.float32 and dim_feedforward > F32_MAX_FF:
        return False
    return (8 <= d_model <= layer_sm90.MAX_D and d_model % 8 == 0
            and dim_feedforward >= 8 and dim_feedforward % 8 == 0)


# ---------------------------------------------------------------- kernels

# the chain's launches of csrc/layer_sm90.cu, in launch order, by launch type
# (ops/layer_sm90.py); each dtype counts its own
SM90_LAUNCHES = {"qkv": "bias", "attn_fwd": "attn_fwd", "proj_ln1": "res_ln",
                 "ffn_hidden": "hidden", "ffn_out_ln2": "res_ln", "ln_rows": "ln_rows",
                 "dh": "dh", "dy1_ln1": "ln_bwd", "dattn": "round", "attn_bwd": "attn_bwd",
                 "dx": "round", "wgrad": "wgrad", "reduce": "reduce"}
_ROUTES = layer_sm90.routes("fused_layer_sm90", SM90_LAUNCHES)
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
    once per call: 13, the first five forward; past d 256 the wide route's
    16, the first seven forward."""
    return layer_sm90.route(_ROUTES, dtype, d)


def _launches(dtype, d: int) -> dict:
    """``route_kernels(dtype, d)`` keyed by the launch's name in
    ``SM90_LAUNCHES`` (a split launch as its (product, row pass) pair)."""
    return layer_sm90.by_launch(SM90_LAUNCHES, route_kernels(dtype, d), layer_sm90.is_wide(d))


def _check(x, weights, vectors, seed, n_heads: int, seq_len: int) -> None:
    """Raise ``ValueError`` on what the kernels do not take."""
    tensors = [x, *weights, *vectors, seed]
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("fused_layer kernels need every tensor on one CUDA "
                         f"device; got {sorted({str(t.device) for t in tensors})}")
    if any(w.dtype != x.dtype for w in weights) or any(v.dtype != torch.float32
                                                      for v in vectors):
        raise ValueError("fused_layer kernels take weights in x's dtype and "
                         "float32 biases and LayerNorm parameters")
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError("fused_layer kernels take a one-element int32 seed")
    m, d = x.shape
    ff = weights[2].shape[0]
    if not supports_fused_layer(d, n_heads, ff, seq_len, x.dtype) or m % seq_len:
        raise ValueError(
            f"fused_layer kernels do not take d={d}, heads={n_heads}, ff={ff}, "
            f"T={seq_len}, rows={m}, {x.dtype} (supports_fused_layer)")
    want = [(3 * d, d), (d, d), (ff, d), (d, ff)]
    if [tuple(w.shape) for w in weights] != want:
        raise ValueError(f"fused_layer weight shapes {[tuple(w.shape) for w in weights]}, "
                         f"expected {want}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_layer kernels take contiguous tensors")
    if any(t.data_ptr() % 16 for t in (x, *weights)):
        raise ValueError("fused_layer kernels take x and the weights 16-byte aligned (TMA)")


def forward_sm90(x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2, seed,
                 rate: float, n_heads: int, seq_len: int):
    """The forward as its chain of launches (``route_kernels(x.dtype, d)``):
    ``(y, qkv, a1, h, a2)``. On CPU tensors each launch runs its plain
    version."""
    d = x.shape[1]
    k = _launches(x.dtype, d)
    qkv = layer_sm90.bias_product(k["qkv"], x, wqkv, bqkv)
    attn = layer_sm90.attention_forward(k["attn_fwd"], qkv[:, :d], qkv[:, d:2 * d],
                                        qkv[:, 2 * d:], seed, SITE_ATTN, rate, n_heads, seq_len,
                                        causal=False)
    a1, y1 = layer_sm90.residual_ln_product(k["proj_ln1"], attn, wo, bo, x, g1, b1, seed,
                                            SITE_PROJ, rate)
    h = layer_sm90.hidden_product(k["ffn_hidden"], y1, w1, b1f, seed, SITE_FFN, rate)
    a2, y = layer_sm90.residual_ln_product(k["ffn_out_ln2"], h, w2, b2f, y1, g2, b2, seed,
                                           SITE_OUT, rate)
    return y, qkv, a1, h, a2


def backward_sm90(dy, x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed,
                  rate: float, n_heads: int, seq_len: int):
    """The backward as its chain of launches (``route_kernels(x.dtype, d)``),
    :func:`layer_backward`'s outputs. On CPU tensors each launch runs its
    plain version."""
    dx, grads = _backward_flat(dy, x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed, rate,
                               n_heads, seq_len)
    return dx, *split_grads(grads, x.shape[1], w1.shape[0])


def _backward_flat(dy, x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed,
                   rate: float, n_heads: int, seq_len: int):
    """:func:`backward_sm90` with the parameter gradients as the one flat f32
    tensor the weight-gradient launch writes (:func:`split_grads`)."""
    m, d = x.shape
    k = _launches(x.dtype, d)
    ff = w1.shape[0]
    (y1, _), stats, da2, df = layer_sm90.ln_rows(
        k["ln_rows"], [(a1, g1, b1, True), (a2, g2, None, False)], dy, seed, SITE_OUT, rate)
    dh = layer_sm90.dh_product(k["dh"], df, w2, h, rate)
    da1, dy1, dproj = layer_sm90.ln_backward_product(
        k["dy1_ln1"], dh, w1, da2, g1, a1, stats[:, 0:2], seed, SITE_PROJ, rate)
    dattn = layer_sm90.round_product(k["dattn"], dproj, wo)
    dqkv, attn = x.new_empty((m, 3 * d)), x.new_empty((m, d))
    layer_sm90.attention_backward(k["attn_bwd"], qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:],
                                  dattn, dqkv[:, :d], dqkv[:, d:2 * d], dqkv[:, 2 * d:], attn,
                                  seed, SITE_ATTN, rate, n_heads, seq_len, causal=False)
    dx = layer_sm90.round_product(k["dx"], dqkv, wqkv, da1)
    grads = layer_sm90.weight_gradients(
        k["wgrad"], k["reduce"],
        [(dqkv, x), (dproj, attn), (dh, y1), (df, h)],
        [(dqkv, None, None), (dproj, None, None), (dy1, a1, stats[:, 0:2]), (dy1, None, None),
         (dh, None, None), (df, None, None), (dy, a2, stats[:, 2:4]), (dy, None, None)])
    return dx, grads


def split_grads(grads, d: int, ff: int):
    """The backward's flat f32 parameter gradients → ``(dwqkv, dbqkv, dwo,
    dbo, dg1, db1, dw1, db1f, dw2, db2f, dg2, db2)`` views."""
    dwqkv, dwo, dw1, dw2, vec = grads.split([3 * d * d, d * d, ff * d, d * ff, 9 * d + ff])
    dbqkv, dbo, dg1, db1, db1f, db2f, dg2, db2 = vec.split([3 * d, d, d, d, ff, d, d, d])
    return (dwqkv.view(3 * d, d), dbqkv, dwo.view(d, d), dbo, dg1, db1, dw1.view(ff, d),
            db1f, dw2.view(d, ff), db2f, dg2, db2)


def layer_forward(x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2,
                  seed, rate: float, n_heads: int, seq_len: int):
    """Launch the forward, the chain of :func:`forward_sm90`: ``(y, qkv, a1,
    h, a2)``."""
    _check(x, (wqkv, wo, w1, w2), (bqkv, bo, g1, b1, b1f, b2f, g2, b2), seed, n_heads, seq_len)
    return forward_sm90(x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2, seed, rate,
                        n_heads, seq_len)


def layer_backward(dy, x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed,
                   rate: float, n_heads: int, seq_len: int):
    """Launch the backward, the chain of :func:`backward_sm90`: ``(dx, dwqkv,
    dbqkv, dwo, dbo, dg1, db1, dw1, db1f, dw2, db2f, dg2, db2)``, weight
    gradients in f32."""
    dx, grads = _launch_backward(dy, x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed, rate,
                                 n_heads, seq_len)
    return dx, *split_grads(grads, x.shape[1], w1.shape[0])


def _launch_backward(dy, x, *saved):
    """:func:`layer_backward` with the parameter gradients flat."""
    dy = dy.contiguous()
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"fused_layer backward: dy {dy.dtype} {tuple(dy.shape)} "
                         f"does not match x {x.dtype} {tuple(x.shape)}")
    return _backward_flat(dy, x, *saved)


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _layer_fwd(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor, wo: torch.Tensor,
               bo: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor, w1: torch.Tensor,
               b1f: torch.Tensor, w2: torch.Tensor, b2f: torch.Tensor, g2: torch.Tensor,
               b2: torch.Tensor, seed: torch.Tensor, rate: float, n_heads: int,
               seq_len: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The forward as an operator, ``(y, qkv, a1, h, a2)``: the chain of
    :func:`layer_forward` (or its ``ValueError``); on CPU tensors each
    launch's plain version."""
    args = (x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2, seed)
    if _on_cpu(args):
        return per_trial.apart(forward_sm90(*args, rate, n_heads, seq_len), args)
    return layer_forward(*args, rate, n_heads, seq_len)


layer_fwd_op = torch.library.custom_op("tgi::encoder_layer_fwd", _layer_fwd,
                                       mutates_args=())


@layer_fwd_op.register_fake
def _layer_fwd_fake(x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2, seed, rate,
                    n_heads, seq_len):
    m, d = x.shape
    return (torch.empty_like(x), x.new_empty((m, 3 * d)), torch.empty_like(x),
            x.new_empty((m, w1.shape[0])), torch.empty_like(x))


def _layer_bwd(dy: torch.Tensor, x: torch.Tensor, qkv: torch.Tensor, a1: torch.Tensor,
               h: torch.Tensor, a2: torch.Tensor, wqkv: torch.Tensor, wo: torch.Tensor,
               w1: torch.Tensor, w2: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
               g2: torch.Tensor, seed: torch.Tensor, rate: float, n_heads: int,
               seq_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward as an operator, ``(dx, grads)``: ``grads`` the 12
    parameter gradients flat in f32 (:func:`split_grads`); the chain of
    :func:`layer_backward`, on CPU tensors each launch's plain version."""
    args = (dy, x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed)
    if _on_cpu(args):
        return per_trial.apart(_backward_flat(*args, rate, n_heads, seq_len), args)
    return _launch_backward(*args, rate, n_heads, seq_len)


layer_bwd_op = torch.library.custom_op("tgi::encoder_layer_bwd", _layer_bwd,
                                       mutates_args=())


@layer_bwd_op.register_fake
def _layer_bwd_fake(dy, x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed, rate, n_heads,
                    seq_len):
    d, ff = x.shape[1], w1.shape[0]
    return torch.empty_like(x), x.new_empty((4 * d * d + 2 * d * ff + 9 * d + ff,),
                                            dtype=torch.float32)


layer_fwd_op.register_vmap(per_trial.rule(layer_fwd_op))
layer_bwd_op.register_vmap(per_trial.rule(layer_bwd_op))


class _EncoderLayerTrain(torch.autograd.Function):
    """The kernels under autograd: saves x, qkv, a1, h_drop and a2 (and the
    weights and seed), as the TPU kernel's ``_layer_fwd`` does."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2,
                seed, rate, n_heads, seq_len):
        y, qkv, a1, h, a2 = layer_forward(
            x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2, seed,
            rate, n_heads, seq_len)
        ctx.save_for_backward(x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed)
        ctx.static = (rate, n_heads, seq_len)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed = ctx.saved_tensors
        (dx, dwqkv, dbqkv, dwo, dbo, dg1, db1, dw1, db1f, dw2, db2f, dg2,
         db2) = layer_backward(dy, x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1,
                               g2, seed, *ctx.static)
        # weight grads rounded to the weights' dtype, as _layer_bwd does
        return (dx, dwqkv.to(wqkv.dtype), dbqkv, dwo.to(wo.dtype), dbo, dg1, db1,
                dw1.to(w1.dtype), db1f, dw2.to(w2.dtype), db2f, dg2, db2,
                None, None, None, None)


class EncoderLayerTrain(torch.autograd.Function):
    """The two operators under autograd, for ``torch.func``: saves what
    :class:`_EncoderLayerTrain` saves, the residuals travelling as the
    forward's outputs. Under ``torch.func.vmap`` both run once per trial
    (``ops/per_trial.py``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2, seed, rate, n_heads,
                seq_len):
        return layer_fwd_op(x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2, seed, rate,
                            n_heads, seq_len)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, wqkv, _bqkv, wo, _bo, g1, b1, w1, _b1f, w2, _b2f, g2, _b2, seed = inputs[:14]
        _y, qkv, a1, h, a2 = output
        ctx.save_for_backward(x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed)
        ctx.mark_non_differentiable(qkv, a1, h, a2)
        ctx.static = inputs[14:]

    @staticmethod
    def backward(ctx, dy, *_residuals):
        saved = ctx.saved_tensors
        with torch.no_grad():  # torch.func.grad records the backward otherwise
            dx, grads = layer_bwd_op(dy, *saved, *ctx.static)
        x, wqkv, wo, w1, w2 = saved[0], *saved[5:9]
        (dwqkv, dbqkv, dwo, dbo, dg1, db1, dw1, db1f, dw2, db2f, dg2,
         db2) = split_grads(grads, x.shape[-1], w1.shape[-2])
        # weight grads rounded to the weights' dtype, as _layer_bwd does
        return (dx, dwqkv.to(wqkv.dtype), dbqkv, dwo.to(wo.dtype), dbo, dg1, db1,
                dw1.to(w1.dtype), db1f, dw2.to(w2.dtype), db2f, dg2, db2,
                None, None, None, None)


def encoder_layer_train(x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2,
                        b2, seed, rate: float, n_heads: int, seq_len: int):
    """Fused post-LN encoder layer for training, the JAX signature.

    ``x``: (rows, d), rows = batch·seq_len in sequence-major order; weights
    (3d, d), (d, d), (ff, d), (d, ff) in nn.Linear's (out, in) layout (the
    JAX function takes their transposes) and the compute dtype; biases and
    LN parameters f32; ``seed`` a one-element int32 tensor (one per step and
    layer). CPU tensors run :func:`encoder_layer_reference`; CUDA tensors
    the kernels through :class:`_EncoderLayerTrain`, or it raises. Under a
    ``torch.func`` transform tensors on either device go through
    :class:`EncoderLayerTrain` (on CPU tensors its operators' plain bodies), and
    under ``vmap`` each trial launches the chain with its own slices and seed.
    """
    tensors = (x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2, seed)
    if per_trial.transformed():
        per_trial.check_devices("fused_layer", tensors)
        return EncoderLayerTrain.apply(*tensors, float(rate), int(n_heads), int(seq_len))[0]
    if _on_cpu(tensors):
        return encoder_layer_reference(*tensors, rate, n_heads, seq_len)
    return _EncoderLayerTrain.apply(*tensors, rate, n_heads, seq_len)
