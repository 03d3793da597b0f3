"""Whole-encoder-layer training kernel: wrappers, plain twin and dropout masks.

Replaces the Pallas TPU kernel ``transformergrooveinfilling_tpu/ops/
fused_layer.py::encoder_layer_train`` (forward ``_fwd_call`` → ``_fwd_kernel``,
backward ``_bwd_call`` → ``_bwd_kernel``): the whole post-LN encoder layer

    qkv = x·Wqkv + b;  per head P = softmax(QKᵀ/√hd), A = drop(P)·V
    y1 = LN1(x + drop(A·Wo + bo));  h = drop(relu(y1·W1 + b1))
    y2 = LN2(y1 + drop(h·W2 + b2))

with four dropout sites, and its backward. Two routes, by the storage dtype:

- bf16: a chain of launches of ``csrc/layer_sm90.cu`` (``ops/layer_sm90.py``)
  with every product on the tensor cores (``wgmma`` + TMA) and the layer's
  elementwise work in the products' epilogues: forward qkv, the attention
  per (sequence, head), Wo with the residual and LN1, W1 with ReLU and the
  mask, W2 with the residual and LN2 (:func:`forward_sm90`); backward the
  LayerNorm rows (LN2's backward, y1 again), dh, dh·W1 with LN1's backward,
  dattn, the attention's backward, dx, and all weight and LayerNorm-parameter
  gradients in one grouped launch with a fixed-order reduce of its row splits
  (:func:`backward_sm90`). ``SM90_KERNELS`` counts each launch.
- f32: ``csrc/fused_layer.cu``'s CUDA-core kernels: a forward kernel and a
  row-backward kernel with one block per sequence, and a weight-gradient
  kernel that sums dYᵀ·X over all rows in a fixed order (``KERNELS``). The
  tensor cores' f32 mode is TF32, which would miss the f32 bars.

No float atomics on either route, so two runs with one seed agree bit for bit.

What bounds it on the H100: about 1.05 MFLOP of products per row forward and
2.1 MFLOP backward at the flagship width (d 256, ff 512) — operations, not
memory: on the tensor cores (989 TFLOP/s in bf16) 17 µs forward at 16,384
rows, on the CUDA cores (67 TFLOP/s in f32) 15 times that. Both routes keep
what the TPU kernel keeps out of device memory out of it: the probabilities
and every mask are recomputed (masks from a counter-based Philox4x32-10
stream keyed by the seed and counted by (site, row, column)), and the
autograd Function saves exactly x, qkv, a1, h_drop and a2.

``dropout_mask`` is the kernels' mask generator in plain PyTorch, so the
kernel and :func:`encoder_layer_reference` draw the same masks. On a CPU
tensor :func:`encoder_layer_train` runs the twin; on a CUDA tensor it
launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, layer_sm90
from .dropout import quantized_threshold

LN_EPS = 1e-5
MAX_T = 32
# shared memory one block may take on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
WGRAD_TILE = 64  # the weight-gradient kernel's (k, n) tile
# dropout sites: attention probabilities, then the three elementwise sites
SITE_ATTN, SITE_PROJ, SITE_FFN, SITE_OUT = 0, 1, 2, 3
# kink_flips: how close to 0, relative to max|h|, a hidden unit must be for
# the kernel and the twin to disagree on its ReLU (f32: summation order only;
# bf16: an input of the product rounded to a neighbouring value, up to 4.4e-4
# on an H100 at the flagship width), and the share of units that may. The
# H100 showed 0-1 flips per call in f32 and 1-2 in 8.4M units in bf16.
KINK_BAND = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
KINK_SHARE = 1e-5

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


def kink_flips(twin_h: torch.Tensor, kernel_h: torch.Tensor):
    """The FFN hidden units at which the kernel and the twin, run on the same
    inputs and masks, fall on opposite sides of the ReLU's kink: ``(flips,
    stats)``, ``flips`` for ``encoder_layer_reference(relu_flips=...)``.

    A unit within rounding of 0 lands on either side depending on the order
    of its sum, and the gradient through it is then all or nothing. ``twin_h``
    and ``kernel_h`` are the two ``h_drop`` (rows, ff). Raises ``ValueError``
    unless every flipped unit is within ``KINK_BAND`` · max|h| of 0 and
    flips are at most ``KINK_SHARE`` of the units (plus 4): a kernel that
    zeroes units it should keep, or keeps units it should zero, fails here.
    """
    th, kh = twin_h.float(), kernel_h.float()
    flips = (th > 0) != (kh > 0)
    scale = float(th.abs().max())
    n = int(flips.sum())
    largest = float(torch.maximum(th, kh)[flips].max()) / scale if n else 0.0
    stats = {"flips": n, "units": flips.numel(), "largest_rel": largest}
    if largest > KINK_BAND[twin_h.dtype] or n > KINK_SHARE * flips.numel() + 4:
        raise ValueError(f"kernel and twin ReLU decisions differ beyond rounding: {stats}, "
                         f"band {KINK_BAND[twin_h.dtype]}, share {KINK_SHARE}")
    return flips, stats


# ---------------------------------------------------------------- gate

def fwd_smem_bytes(t: int, d: int, ff: int) -> int:
    """Forward block: x/y1, qkv then h, attention output then a2, one head's
    (T, T) scores, in f32."""
    return 4 * (t * (2 * d + max(3 * d, ff)) + t * t)


def bwd_rows_smem_bytes(t: int, d: int, ff: int) -> int:
    """Row-backward block: da2/da1, dfb/dprojb, zh1/dattn, dhpre then qkv
    then dqkv, P and dS, and per-row statistics, in f32."""
    return 4 * (t * (3 * d + max(3 * d, ff)) + 2 * t * t + 4 * t)


def bwd_weights_smem_bytes(t: int, d: int, n_heads: int) -> int:
    """Weight-gradient block: one (T, 64) chunk of each operand, and for
    dWo the attention recompute of one head (Q, K, P)."""
    hd = d // n_heads
    return 4 * (2 * t * WGRAD_TILE + 2 * t * hd + t * t)


def supports_fused_layer(d_model: int, n_heads: int, dim_feedforward: int,
                         seq_len: int, dtype=torch.float32) -> bool:
    """Whether the kernels take this layer, by route.

    bf16 (``csrc/layer_sm90.cu``): d a multiple of 8 up to 256 (the
    LayerNorm epilogues' tile spans a row; TMA's 16-byte strides), ff a
    multiple of 8, d divisible by the heads into heads of a width hd that is
    a multiple of 8 (the attention loads 16-byte rows by cp.async and
    zero-fills hd to the mma's k of 16), and T ≤ 32 (the attention keeps a
    (sequence, head) in one block of 32 padded rows on the tensor cores).
    Rows and the head count are otherwise free: the products' ragged edges
    are TMA's zero fill.

    f32 (``csrc/fused_layer.cu``): one block holds one sequence (T ≤ 32 rows:
    the row loops keep T accumulators per thread in registers), every block's
    shared memory fits the 232,448 bytes a block may have, and the products
    read 4 columns at a time (d and ff multiples of 4). The flagship (T 32, d
    256, ff 512) needs 168 KB forward and 205 KB in the row backward.

    The TPU gate's 128-lane widths, ≤ 5 heads and ff ≤ 1024 (scoped VMEM) do
    not apply.
    """
    if dtype not in KERNEL_DTYPES or n_heads < 1 or d_model % n_heads or not 1 <= seq_len <= MAX_T:
        return False
    if dtype == torch.bfloat16:
        return (8 <= d_model <= layer_sm90.LN_TILE and d_model % 8 == 0
                and (d_model // n_heads) % 8 == 0
                and dim_feedforward >= 8 and dim_feedforward % 8 == 0)
    if not (d_model % 4 == 0 and dim_feedforward % 4 == 0):
        return False
    return max(fwd_smem_bytes(seq_len, d_model, dim_feedforward),
               bwd_rows_smem_bytes(seq_len, d_model, dim_feedforward),
               bwd_weights_smem_bytes(seq_len, d_model, n_heads)) <= MAX_SMEM_BYTES


# ---------------------------------------------------------------- kernels

@functools.cache
def _kernels():
    lib = _build.load_library("fused_layer")
    p, i = ctypes.c_void_p, ctypes.c_int
    # shape ints: nseq, T, d, H, ff, thresh, is_bf16; then the stream
    shape = [i] * 7 + [p]
    lib.tgi_layer_fwd.argtypes = [p] * 19 + shape
    lib.tgi_layer_bwd_rows.argtypes = [p] * 16 + shape
    lib.tgi_layer_bwd_weights.argtypes = [p] * 14 + shape
    for fn in (lib.tgi_layer_fwd, lib.tgi_layer_bwd_rows, lib.tgi_layer_bwd_weights):
        fn.restype = i
    lib.tgi_layer_error_string.argtypes = [i]
    lib.tgi_layer_error_string.restype = ctypes.c_char_p
    return lib


# f32 route: the three CUDA-core kernels of csrc/fused_layer.cu
KERNELS = {name: _build.CountedKernel(_kernels, entry, "tgi_layer_error_string")
           for name, entry in (("fused_layer_fwd", "tgi_layer_fwd"),
                               ("fused_layer_bwd_rows", "tgi_layer_bwd_rows"),
                               ("fused_layer_bwd_weights", "tgi_layer_bwd_weights"))}
# bf16 route: the chain's launches of csrc/layer_sm90.cu, in launch order, by
# launch type (ops/layer_sm90.py)
SM90_LAUNCHES = {"qkv": "bias", "attn_fwd": "attn_fwd", "proj_ln1": "res_ln",
                 "ffn_hidden": "hidden", "ffn_out_ln2": "res_ln", "ln_rows": "ln_rows",
                 "dh": "dh", "dy1_ln1": "ln_bwd", "dattn": "round", "attn_bwd": "attn_bwd",
                 "dx": "round", "wgrad": "wgrad", "reduce": "reduce"}
SM90_KERNELS = layer_sm90.counted_kernels("fused_layer_sm90", SM90_LAUNCHES)


def route_kernels(dtype) -> dict:
    """The counted kernels a layer call launches in ``dtype``: each once per
    forward (the first five) or backward (the rest)."""
    return SM90_KERNELS if dtype == torch.bfloat16 else KERNELS


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
    if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (x, *weights)):
        raise ValueError("fused_layer's bf16 kernels take x and the weights 16-byte aligned "
                         "(TMA)")


def forward_sm90(x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2, seed,
                 rate: float, n_heads: int, seq_len: int):
    """The bf16 route's forward as its chain of launches (``SM90_KERNELS``):
    ``(y, qkv, a1, h, a2)``. On CPU tensors each launch runs its plain
    version (any dtype)."""
    k = SM90_KERNELS
    d = x.shape[1]
    qkv = layer_sm90.bias_product(k["fused_layer_sm90_qkv"], x, wqkv, bqkv)
    attn = layer_sm90.attention_forward(k["fused_layer_sm90_attn_fwd"], qkv[:, :d],
                                        qkv[:, d:2 * d], qkv[:, 2 * d:], seed, SITE_ATTN, rate,
                                        n_heads, seq_len, causal=False)
    a1, y1 = layer_sm90.residual_ln_product(k["fused_layer_sm90_proj_ln1"], attn, wo, bo, x, g1,
                                            b1, seed, SITE_PROJ, rate)
    h = layer_sm90.hidden_product(k["fused_layer_sm90_ffn_hidden"], y1, w1, b1f, seed,
                                  SITE_FFN, rate)
    a2, y = layer_sm90.residual_ln_product(k["fused_layer_sm90_ffn_out_ln2"], h, w2, b2f, y1,
                                           g2, b2, seed, SITE_OUT, rate)
    return y, qkv, a1, h, a2


def backward_sm90(dy, x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed,
                  rate: float, n_heads: int, seq_len: int):
    """The bf16 route's backward as its chain of launches (``SM90_KERNELS``),
    :func:`layer_backward`'s outputs. On CPU tensors each launch runs its
    plain version (any dtype)."""
    k = SM90_KERNELS
    m, d = x.shape
    ff = w1.shape[0]
    (y1, _), stats, da2, df = layer_sm90.ln_rows(
        k["fused_layer_sm90_ln_rows"], [(a1, g1, b1, True), (a2, g2, None, False)], dy, seed,
        SITE_OUT, rate)
    dh = layer_sm90.dh_product(k["fused_layer_sm90_dh"], df, w2, h, rate)
    da1, dy1, dproj = layer_sm90.ln_backward_product(
        k["fused_layer_sm90_dy1_ln1"], dh, w1, da2, g1, a1, stats[:, 0:2], seed, SITE_PROJ, rate)
    dattn = layer_sm90.round_product(k["fused_layer_sm90_dattn"], dproj, wo)
    dqkv, attn = x.new_empty((m, 3 * d)), x.new_empty((m, d))
    layer_sm90.attention_backward(k["fused_layer_sm90_attn_bwd"], qkv[:, :d], qkv[:, d:2 * d],
                                  qkv[:, 2 * d:], dattn, dqkv[:, :d], dqkv[:, d:2 * d],
                                  dqkv[:, 2 * d:], attn, seed, SITE_ATTN, rate, n_heads,
                                  seq_len, causal=False)
    dx = layer_sm90.round_product(k["fused_layer_sm90_dx"], dqkv, wqkv, da1)
    grads = layer_sm90.weight_gradients(
        k["fused_layer_sm90_wgrad"], k["fused_layer_sm90_reduce"],
        [(dqkv, x), (dproj, attn), (dh, y1), (df, h)],
        [(dqkv, None, None), (dproj, None, None), (dy1, a1, stats[:, 0:2]), (dy1, None, None),
         (dh, None, None), (df, None, None), (dy, a2, stats[:, 2:4]), (dy, None, None)])
    dwqkv, dwo, dw1, dw2, vec = grads.split([3 * d * d, d * d, ff * d, d * ff, 9 * d + ff])
    dbqkv, dbo, dg1, db1, db1f, db2f, dg2, db2 = vec.split([3 * d, d, d, d, ff, d, d, d])
    return (dx, dwqkv.view(3 * d, d), dbqkv, dwo.view(d, d), dbo, dg1, db1, dw1.view(ff, d),
            db1f, dw2.view(d, ff), db2f, dg2, db2)


def layer_forward(x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2,
                  seed, rate: float, n_heads: int, seq_len: int):
    """Launch the forward: ``(y, qkv, a1, h, a2)``. bf16: the chain of
    :func:`forward_sm90`; f32: one CUDA-core kernel."""
    weights, vectors = (wqkv, wo, w1, w2), (bqkv, bo, g1, b1, b1f, b2f, g2, b2)
    _check(x, weights, vectors, seed, n_heads, seq_len)
    if x.dtype == torch.bfloat16:
        return forward_sm90(x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2, seed,
                            rate, n_heads, seq_len)
    m, d = x.shape
    ff = w1.shape[0]
    y, a1, a2 = (torch.empty_like(x) for _ in range(3))
    qkv = x.new_empty((m, 3 * d))
    h = x.new_empty((m, ff))
    KERNELS["fused_layer_fwd"].launch(
        (x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2, seed, y, qkv, a1, h, a2),
        _shape(m, d, n_heads, ff, seq_len, rate, x.dtype), x.device)
    return y, qkv, a1, h, a2


def _shape(m, d, n_heads, ff, seq_len, rate, dtype):
    return (m // seq_len, seq_len, d, n_heads, ff, quantized_threshold(rate),
            int(dtype == torch.bfloat16))


def layer_backward(dy, x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed,
                   rate: float, n_heads: int, seq_len: int):
    """Launch the backward: ``(dx, dwqkv, dbqkv, dwo, dbo, dg1, db1, dw1,
    db1f, dw2, db2f, dg2, db2)``, weight gradients in f32. bf16: the chain of
    :func:`backward_sm90`; f32: the row-backward and weight-gradient
    kernels."""
    m, d = x.shape
    ff = w1.shape[0]
    dy = dy.contiguous()
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"fused_layer backward: dy {dy.dtype} {tuple(dy.shape)} "
                         f"does not match x {x.dtype} {tuple(x.shape)}")
    if x.dtype == torch.bfloat16:
        return backward_sm90(dy, x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed,
                             rate, n_heads, seq_len)
    shape = _shape(m, d, n_heads, ff, seq_len, rate, x.dtype)
    dx = torch.empty_like(x)
    # row-wise gradients, f32: df | dhpre | dproj | dqkv | dy1·zh1 | dy1 |
    # dy·zh2 | (mean, rstd) of LN1
    scratch = torch.empty((m, 8 * d + ff + 2), device=x.device, dtype=torch.float32)
    KERNELS["fused_layer_bwd_rows"].launch(
        (dy, x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed, dx, scratch),
        shape, x.device)
    f32 = dict(device=x.device, dtype=torch.float32)
    dwqkv, dwo = torch.empty((3 * d, d), **f32), torch.empty((d, d), **f32)
    dw1, dw2 = torch.empty((ff, d), **f32), torch.empty((d, ff), **f32)
    # dbqkv | dbo | dg1 | db1 | db1f | db2f | dg2 | db2
    vec = torch.empty(9 * d + ff, **f32)
    KERNELS["fused_layer_bwd_weights"].launch(
        (dy, x, qkv, a1, h, g1, b1, seed, scratch, dwqkv, dwo, dw1, dw2, vec),
        shape, x.device)
    dbqkv, dbo, dg1, db1, db1f, db2f, dg2, db2 = vec.split(
        [3 * d, d, d, d, ff, d, d, d])
    return dx, dwqkv, dbqkv, dwo, dbo, dg1, db1, dw1, db1f, dw2, db2f, dg2, db2


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


def encoder_layer_train(x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2,
                        b2, seed, rate: float, n_heads: int, seq_len: int):
    """Fused post-LN encoder layer for training, the JAX signature.

    ``x``: (rows, d), rows = batch·seq_len in sequence-major order; weights
    (3d, d), (d, d), (ff, d), (d, ff) in nn.Linear's (out, in) layout (the
    JAX function takes their transposes) and the compute dtype; biases and
    LN parameters f32; ``seed`` a one-element int32 tensor (one per step and
    layer). CPU tensors run :func:`encoder_layer_reference`; CUDA tensors
    the kernels, or it raises.
    """
    tensors = (x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2, seed)
    if all(t.device.type == "cpu" for t in tensors):
        return encoder_layer_reference(*tensors, rate, n_heads, seq_len)
    return _EncoderLayerTrain.apply(*tensors, rate, n_heads, seq_len)
