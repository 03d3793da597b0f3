"""Fused dropout + residual add + LayerNorm for training: wrapper, plain
version and dropout words.

Replaces the Pallas TPU kernels of ``transformergrooveinfilling_tpu/ops/
fused_ln.py`` under ``dropout_add_layernorm`` (forward ``_run_fwd`` →
``_fwd_kernel``, backward ``_run_bwd`` → ``_bwd_kernel``):

    a = x + dropout(y);  out = (a − mean(a))·rsqrt(var(a) + 1e-5)·scale + bias

in f32 with the two-pass variance, and its backward, which draws the mask
again from the seed instead of loading a stored one: the mask never reaches
device memory in either direction. The kernels are ``csrc/fused_ln.cu``: a
forward kernel (one warp per row) and a backward kernel that writes dx, dy and
one partial of (dscale | dbias) per block; the partials are summed here, as the
JAX code sums its per-block partials outside its Pallas call. No float
atomics, so two runs with one seed agree bit for bit.

What bounds it on the H100: bytes (3 values an element forward, 5 backward,
against some 20 f32 operations). The design moves each value once, 4 elements a
lane, and draws one Philox call per 4 elements. On an NVIDIA H100 80GB HBM3 at
700 W (chip_smoke.py, phase 17; PERF.md), bf16: the forward kernel 14 µs and
the backward 36 µs of device time at rows 16,384 × d 256 (53 % and 35 % of the
bytes bound), 3.5 and 4.8 µs at rows 1,024; a call is 27-95 µs on the stream,
most of it this wrapper's host work.

Dropout here is the TPU kernel's exact-rate rule, not the layers' 8-bit one:
an element is kept when its 32-bit word is at least ``int(rate·2³²)`` and
rescaled by ``1/(1 − rate)``. :func:`dropout_words` is the kernels' word stream
in plain PyTorch, so the kernel and :func:`dropout_add_layernorm_reference`
draw the same mask. On CPU tensors :func:`dropout_add_layernorm` runs the plain
forward and the backward's formulas in plain PyTorch; on CUDA tensors it
launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .fused_layer import KERNEL_DTYPES, LN_EPS, MAX_SMEM_BYTES, _U32, philox4x32

SITE_LN = 4  # the word stream's site, apart from the layer kernels' 0-3
WARPS = 8  # rows a block of the kernels works on at a time


# ---------------------------------------------------------------- masks

def dropout_words(seed, site: int, shape) -> torch.Tensor:
    """One random 32-bit word per element of ``shape`` (uint32 values in
    int64), as the kernels draw them. The last axis is the column, the others
    flatten into the row; element (row, col) takes word ``col % 4`` of
    Philox4x32-10 at counter (col // 4, row, site, 0) under key (seed, 0).
    ``seed`` is an int or a one-element integer tensor (it sets the device)."""
    seed = torch.as_tensor(seed)
    dev = seed.device
    rows = math.prod(shape[:-1])
    cols = shape[-1]
    k0 = seed.reshape(()).to(torch.int64) & _U32
    c0 = torch.arange((cols + 3) // 4, device=dev, dtype=torch.int64)[None, :]
    c1 = torch.arange(rows, device=dev, dtype=torch.int64)[:, None]
    zero = torch.zeros((), device=dev, dtype=torch.int64)
    words = torch.broadcast_tensors(*philox4x32(c0, c1, zero + site, zero, k0, zero))
    return torch.stack(words, -1).reshape(rows, -1)[:, :cols].reshape(shape)


def keep_threshold(rate: float) -> int:
    """A word at or above this keeps its element (``fused_ln.py::_keep_mask``)."""
    return int(rate * float(2**32))


def keep_scale(seed, shape, rate: float) -> torch.Tensor:
    """What dropout multiplies y by, f32: ``1/(1 − rate)`` where the mask
    keeps, 0 elsewhere."""
    keep = dropout_words(seed, SITE_LN, shape) >= keep_threshold(rate)
    return keep.to(torch.float32) * torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32,
                                                 device=keep.device)


# ---------------------------------------------------------------- plain version

def _stats(x, y, seed, rate: float):
    """f32 ``a − mean``, ``1/sqrt(var + eps)`` (two-pass variance) and the
    dropout factor (None at rate 0)."""
    scale = keep_scale(seed, y.shape, rate) if rate > 0.0 else None
    yf = y.float() if scale is None else y.float() * scale
    a = x.float() + yf
    cen = a - a.mean(-1, keepdim=True)
    rstd = torch.rsqrt((cen * cen).mean(-1, keepdim=True) + LN_EPS)
    return cen, rstd, scale


def dropout_add_layernorm_reference(x, y, scale, bias, seed, rate: float):
    """The kernels' math in plain PyTorch; its gradient is autograd's. ``x``,
    ``y``: (..., d) in one dtype; ``scale``, ``bias``: (d,) f32; the result is
    in ``x.dtype``."""
    cen, rstd, _ = _stats(x, y, seed, rate)
    return (cen * rstd * scale + bias).to(x.dtype)


def backward_formulas(g, x, y, scale, seed, rate: float):
    """The backward kernel's formulas in plain PyTorch: ``(dx, dy, dscale,
    dbias)`` from the output gradient ``g``, with the mask drawn again from
    ``seed``."""
    cen, rstd, ks = _stats(x, y, seed, rate)
    zhat = cen * rstd
    gf = g.float()
    gs = gf * scale
    m1 = gs.mean(-1, keepdim=True)
    m2 = (gs * zhat).mean(-1, keepdim=True)
    da = rstd * (gs - m1 - zhat * m2)
    dy = da if ks is None else da * ks
    d = x.shape[-1]
    return (da.to(x.dtype), dy.to(y.dtype), (gf * zhat).reshape(-1, d).sum(0),
            gf.reshape(-1, d).sum(0))


# ---------------------------------------------------------------- gate

def bwd_smem_bytes(d: int) -> int:
    """Backward block: a, Σ g·zhat and Σ g, one f32 row of each per warp (the
    forward block holds a alone)."""
    return 4 * 3 * WARPS * d


def supports_fused_ln(d_model: int, dtype=torch.float32) -> bool:
    """Whether ``csrc/fused_ln.cu`` takes this width: f32 or bf16 storage,
    columns read 4 at a time (d a multiple of 4), and the backward block's
    three f32 rows per warp inside the 232,448 bytes of shared memory a block
    may have on Hopper (d ≤ 2,420). The TPU kernel's blocks of 256 rows are
    not carried over: any row count is taken, without padding."""
    return (dtype in KERNEL_DTYPES and d_model >= 4 and d_model % 4 == 0
            and bwd_smem_bytes(d_model) <= MAX_SMEM_BYTES)


def rows_per_warp(rows: int) -> int:
    """Rows each warp of the backward kernel takes one after the other: about
    256 blocks at any size, so that few partials are written."""
    return max(1, min(8, rows // (WARPS * 256)))


# ---------------------------------------------------------------- kernels

@functools.cache
def _kernels():
    lib = _build.load_library("fused_ln")
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.tgi_ln_fwd.argtypes = [p] * 6 + [i, i, u, f, i, i, p]
    lib.tgi_ln_bwd.argtypes = [p] * 8 + [i, i, u, f, i, i, i, p]
    lib.tgi_ln_fwd.restype = lib.tgi_ln_bwd.restype = i
    lib.tgi_ln_error_string.argtypes = [i]
    lib.tgi_ln_error_string.restype = ctypes.c_char_p
    return lib


KERNELS = {"fused_ln_fwd": _build.CountedKernel(_kernels, "tgi_ln_fwd", "tgi_ln_error_string"),
           "fused_ln_bwd": _build.CountedKernel(_kernels, "tgi_ln_bwd", "tgi_ln_error_string")}


def _check(rows, vectors, seed) -> None:
    """Raise ``ValueError`` on what the kernels do not take: ``rows`` are the
    (..., d) tensors (x, y and in the backward the output gradient),
    ``vectors`` the (d,) parameters."""
    x = rows[0]
    tensors = [*rows, *vectors, seed]
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("fused_ln kernels need every tensor on one CUDA device; got "
                         f"{sorted({str(t.device) for t in tensors})}")
    d = x.shape[-1]
    if any(t.shape != x.shape or t.dtype != x.dtype for t in rows):
        raise ValueError("fused_ln kernels take x, y and the output gradient in one shape and "
                         f"dtype; got {[(tuple(t.shape), t.dtype) for t in rows]}")
    if not supports_fused_ln(d, x.dtype) or x.numel() == 0:
        raise ValueError(f"fused_ln kernels do not take d={d}, {x.dtype}, "
                         f"{x.numel() // max(d, 1)} rows (supports_fused_ln)")
    if any(v.dtype != torch.float32 or v.shape != (d,) for v in vectors):
        raise ValueError("fused_ln kernels take float32 scale and bias of shape (d,)")
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError("fused_ln kernels take a one-element int32 seed")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_ln kernels take contiguous tensors")


def _scalars(x, rate: float):
    d = x.shape[-1]
    return (x.numel() // d, d, keep_threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0))


def ln_forward(x, y, scale, bias, seed, rate: float):
    """Launch the forward kernel."""
    _check((x, y), (scale, bias), seed)
    out = torch.empty_like(x)
    KERNELS["fused_ln_fwd"].launch((x, y, scale, bias, seed, out),
                                   (*_scalars(x, rate), int(x.dtype == torch.bfloat16)), x.device)
    return out


def ln_backward(g, x, y, scale, seed, rate: float):
    """Launch the backward kernel and sum its partials: ``(dx, dy, dscale,
    dbias)``."""
    g = g.contiguous()
    _check((x, y, g), (scale,), seed)
    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    rpw = rows_per_warp(rows)
    blocks = -(-rows // (WARPS * rpw))
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    partials = torch.empty((blocks, 2, d), device=x.device, dtype=torch.float32)
    KERNELS["fused_ln_bwd"].launch((x, y, scale, seed, g, dx, dy, partials),
                                   (*_scalars(x, rate), rpw, int(x.dtype == torch.bfloat16)),
                                   x.device)
    dscale, dbias = partials.sum(0)
    return dx, dy, dscale, dbias


class _DropoutAddLayerNorm(torch.autograd.Function):
    """Saves x, y, scale and the seed, as the TPU kernel's ``_fwd`` does; the
    backward draws the mask again."""

    @staticmethod
    def forward(ctx, x, y, scale, bias, seed, rate):
        if x.device.type == "cpu":
            out = dropout_add_layernorm_reference(x, y, scale, bias, seed, rate)
        else:
            out = ln_forward(x, y, scale, bias, seed, rate)
        ctx.save_for_backward(x, y, scale, seed)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, scale, seed = ctx.saved_tensors
        run = backward_formulas if x.device.type == "cpu" else ln_backward
        dx, dy, dscale, dbias = run(g, x, y, scale, seed, ctx.rate)
        return dx, dy, dscale, dbias, None, None


def dropout_add_layernorm(x, y, scale, bias, seed, rate: float):
    """``LN(x + dropout(y; rate))·scale + bias``, the JAX signature.

    ``x``, ``y``: (..., d) residual input and branch output, f32 or bf16;
    ``scale``, ``bias``: (d,) f32; ``seed`` a one-element int32 tensor (one per
    step and site); ``rate`` in [0, 1). CPU tensors run the plain version (its
    backward the kernel's formulas in plain PyTorch); CUDA tensors the kernels,
    or it raises.
    """
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    tensors = (x, y, scale, bias, seed)
    if not all(t.device.type == "cpu" for t in tensors):
        _check((x, y), (scale, bias), seed)
    return _DropoutAddLayerNorm.apply(*tensors, float(rate))
