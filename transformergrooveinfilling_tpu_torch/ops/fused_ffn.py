"""Fused feed-forward block for training: wrappers, plain version and gate.

Replaces the Pallas TPU kernels of ``transformergrooveinfilling_tpu/ops/
fused_ffn.py`` under ``ffn_train``: the forward in both its layouts
(``_fwd_call`` → ``_fwd_kernel`` with the weights resident in VMEM,
``_fwd_call_tiled`` → ``_fwd_kernel_tiled`` with the weights streamed as ff
tiles) and the backward (``_bwd_call`` → ``_bwd_kernel``):

    h = round(drop(relu(x·W1ᵀ + b1)));  out = h·W2ᵀ + b2
    g = dy·W2;  dh = round(where(h > 0, g / keep, 0));  dx = dh·W1
    dW1 = dhᵀ·x;  dW2 = dyᵀ·h;  db1 = Σ dh;  db2 = Σ dy

``h``, rounded to the compute dtype before the second product, is the only
intermediate that reaches device memory and the only activation the backward
keeps besides ``x``: ``h > 0`` says both that the mask kept the unit and that
the ReLU was active. The kernels are ``csrc/fused_ffn.cu``: a forward kernel
and a row-backward kernel with one block per 32 rows, and a weight-gradient
kernel whose blocks each sum a range of rows in order into a partial, the
partials then added in a fixed order (no float atomics, so two runs with one
seed agree bit for bit).

One forward design stands in for both TPU layouts: "resident" against "tiled"
is a question of 16 MB of VMEM, and no FFN weight pair fits the 227 KB of
shared memory a Hopper block may have, so the forward streams ff tiles at every
width, as the tiled TPU kernel does, with an f32 accumulator of ``out`` on chip
until the end.

What bounds it on the H100: operations (forward 4·rows·d·ff FLOP, each backward
kernel as much again, against rows·(2d + ff) + 2·d·ff values moved). The
products run as f32 FMAs on CUDA cores in 4×4 register tiles fed from shared
memory; tensor cores (``wgmma``) are later work. On an NVIDIA H100 80GB HBM3 at
700 W (chip_smoke.py, phase 17; PERF.md), bf16: forward 0.47 ms and backward
0.52 ms at rows 1,024 × d 256 × ff 2048 (32 blocks on 132 SMs), 1.45 and 2.36
at rows 16,384, 3.77 and 5.50 at rows 4,096 × d 1024 × ff 4096, which is 27-51 %
of the f32 peak per kernel; cuBLAS does the forward's two products in 0.07,
0.20 and 0.16 ms.

Dropout is the layer kernels' 8-bit rule and counter-based stream
(``ops/fused_layer.py::dropout_mask``, site ``SITE_FFN``, counted by row and
column of the hidden), not the TPU kernel's per-tile seeds: the mask does not
depend on the tiling, and :func:`ffn_reference` draws the same one. On CPU
tensors :func:`ffn_train` runs the plain forward and the backward's formulas in
plain PyTorch; on CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .dropout import quantized_keep_rate, quantized_threshold
from .fused_layer import KERNEL_DTYPES, MAX_SMEM_BYTES, SITE_FFN, dropout_mask

ROW_TILE = 32  # rows a block of the forward and row-backward kernels
COL_TILE = 128  # hidden units (then output columns) a tile
K_CHUNK = 32  # reduction chunk staged through shared memory
WGRAD_TILE = 64  # the weight-gradient kernel's tile
# weight-gradient blocks per SM aimed at when the rows are split
WGRAD_BLOCKS_PER_SM = 8


# ---------------------------------------------------------------- plain version

def ffn_reference(x, w1, b1, w2, b2, seed, rate: float, return_hidden: bool = False,
                  relu_flips=None):
    """The kernels' math in plain PyTorch; its gradient is autograd's.

    ``x``: (rows, d); ``w1`` (ff, d) and ``w2`` (d, ff) in nn.Linear's
    (out, in) layout and ``x.dtype``; ``b1``, ``b2`` f32. Both products
    accumulate in f32; ``h`` is rounded to ``x.dtype`` after the dropout and
    before the second product, ``out`` at the end. With ``return_hidden``
    returns ``(out, h)``.

    ``relu_flips`` (rows, ff) bool, optional, for checks against the kernels:
    the hidden units at which this takes the other side of the ReLU's kink than
    its own ``hpre > 0`` (``ops/fused_layer.py::kink_flips``).
    """
    cd = x.dtype
    hpre = x.float() @ w1.float().t() + b1
    if relu_flips is None:
        hpre = torch.relu(hpre)
    else:
        hpre = hpre * ((hpre > 0) ^ relu_flips)
    if quantized_threshold(rate) < 256:
        mask = dropout_mask(seed, SITE_FFN, hpre.shape, rate)
        hpre = torch.where(mask, hpre / quantized_keep_rate(rate),
                           torch.zeros((), dtype=hpre.dtype, device=hpre.device))
    h = hpre.to(cd)
    out = (h.float() @ w2.float().t() + b2).to(cd)
    return (out, h) if return_hidden else out


def backward_formulas(dy, x, h, w1, w2, rate: float):
    """The backward kernels' formulas in plain PyTorch, from the residuals the
    Function keeps: ``(dx, dw1, db1, dw2, db2)``, weight and bias gradients in
    f32. ``dh`` is rounded to ``h.dtype`` before ``dx``, ``dw1`` and ``db1``."""
    dyf, hf = dy.float(), h.float()
    g = dyf @ w2.float()
    dh = torch.where(hf > 0, g / quantized_keep_rate(rate),
                     torch.zeros((), dtype=g.dtype, device=g.device)).to(h.dtype).float()
    return ((dh @ w1.float()).to(x.dtype), dh.t() @ x.float(), dh.sum(0),
            dyf.t() @ hf, dyf.sum(0))


# ---------------------------------------------------------------- gate

def rows_smem_bytes(d: int) -> int:
    """Forward and row-backward block: the f32 accumulator of 32 rows, one
    (32, 128) tile of h or dh, and the staging buffers of the weights and of
    x or dy."""
    ldk = K_CHUNK + 4
    return 4 * (ROW_TILE * d + ROW_TILE * COL_TILE + COL_TILE * ldk + ROW_TILE * ldk)


def supports_fused_ffn(d_model: int, dim_feedforward: int, dtype=torch.float32) -> bool:
    """Whether ``csrc/fused_ffn.cu`` takes this block.

    The Hopper gate is the kernels' own: f32 or bf16 storage; every row of a
    weight read 4 values at a time (d and ff multiples of 4); and the block's
    shared memory, 128·d + 39,424 bytes whatever the dtype (the accumulator is
    f32, and x streams through in chunks instead of staying on chip), inside
    the 232,448 bytes a block may have: d ≤ 1,508. ff is not bounded: it is
    walked in tiles of 128. d 256 takes 72,192 bytes (three blocks an SM),
    d 1024 170,496 (one). The TPU gate's rows % 8, d and ff multiples of 128
    and the 4 MB of resident weights do not apply.
    """
    return (dtype in KERNEL_DTYPES and d_model >= 4 and dim_feedforward >= 4
            and d_model % 4 == 0 and dim_feedforward % 4 == 0
            and rows_smem_bytes(d_model) <= MAX_SMEM_BYTES)


def weight_splits(rows: int, d: int, ff: int, n_sms: int) -> int:
    """Into how many ranges the weight-gradient kernel cuts the rows: enough
    for about ``WGRAD_BLOCKS_PER_SM`` blocks an SM, at least 128 rows each."""
    tiles = -(-ff // WGRAD_TILE) * -(-d // WGRAD_TILE)
    blocks = 2 * tiles + -(-(ff + d) // 64)
    return max(1, min(WGRAD_BLOCKS_PER_SM * n_sms // blocks, -(-rows // 128)))


# ---------------------------------------------------------------- kernels

@functools.cache
def _kernels():
    lib = _build.load_library("fused_ffn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tgi_ffn_fwd.argtypes = [p] * 8 + [i] * 5 + [p]
    lib.tgi_ffn_bwd_rows.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.tgi_ffn_bwd_weights.argtypes = [p] * 6 + [i] * 5 + [p]
    for fn in (lib.tgi_ffn_fwd, lib.tgi_ffn_bwd_rows, lib.tgi_ffn_bwd_weights):
        fn.restype = i
    lib.tgi_ffn_error_string.argtypes = [i]
    lib.tgi_ffn_error_string.restype = ctypes.c_char_p
    return lib


KERNELS = {name: _build.CountedKernel(_kernels, entry, "tgi_ffn_error_string")
           for name, entry in (("fused_ffn_fwd", "tgi_ffn_fwd"),
                               ("fused_ffn_bwd_rows", "tgi_ffn_bwd_rows"),
                               ("fused_ffn_bwd_weights", "tgi_ffn_bwd_weights"))}


def _check(rows, w1, w2, vectors, seed=None) -> None:
    """Raise ``ValueError`` on what the kernels do not take: ``rows`` maps a
    name to a (rows, ·) tensor and its width, ``vectors`` the f32 biases."""
    x = next(iter(rows.values()))[0]
    tensors = [t for t, _ in rows.values()] + [w1, w2, *vectors] + ([seed] if seed is not None
                                                                   else [])
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("fused_ffn kernels need every tensor on one CUDA device; got "
                         f"{sorted({str(t.device) for t in tensors})}")
    ff, d = w1.shape if w1.dim() == 2 else (0, 0)
    if not supports_fused_ffn(d, ff, x.dtype) or x.shape[0] < 1:
        raise ValueError(f"fused_ffn kernels do not take d={d}, ff={ff}, {x.dtype}, "
                         f"{x.shape[0]} rows (supports_fused_ffn)")
    if tuple(w2.shape) != (d, ff) or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError(f"fused_ffn kernels take w1 (ff, d) and w2 (d, ff) in x's dtype; got "
                         f"{tuple(w1.shape)} {w1.dtype}, {tuple(w2.shape)} {w2.dtype}")
    widths = {"d": d, "ff": ff}
    for name, (t, width) in rows.items():
        if tuple(t.shape) != (x.shape[0], widths[width]) or t.dtype != x.dtype:
            raise ValueError(f"fused_ffn kernels take {name} of shape ({x.shape[0]}, {width}) "
                             f"in {x.dtype}; got {tuple(t.shape)} {t.dtype}")
    if any(v.dtype != torch.float32 for v in vectors):
        raise ValueError("fused_ffn kernels take float32 biases")
    if seed is not None and (seed.dtype != torch.int32 or seed.numel() != 1):
        raise ValueError("fused_ffn kernels take a one-element int32 seed")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_ffn kernels take contiguous tensors")


def ffn_forward(x, w1, b1, w2, b2, seed, rate: float):
    """Launch the forward kernel: ``(out, h)``."""
    _check({"x": (x, "d")}, w1, w2, (b1, b2), seed)
    rows, d = x.shape
    ff = w1.shape[0]
    if b1.shape != (ff,) or b2.shape != (d,):
        raise ValueError(f"fused_ffn biases {tuple(b1.shape)}, {tuple(b2.shape)}, expected "
                         f"({ff},), ({d},)")
    out, h = torch.empty_like(x), x.new_empty((rows, ff))
    KERNELS["fused_ffn_fwd"].launch(
        (x, w1, b1, w2, b2, seed, out, h),
        (rows, d, ff, quantized_threshold(rate), int(x.dtype == torch.bfloat16)), x.device)
    return out, h


def ffn_backward(dy, x, h, w1, w2, rate: float):
    """Launch the row-backward and weight-gradient kernels: ``(dx, dw1, db1,
    dw2, db2)``, weight and bias gradients in f32."""
    dy = dy.contiguous()
    _check({"x": (x, "d"), "dy": (dy, "d"), "h": (h, "ff")}, w1, w2, ())
    rows, d = x.shape
    ff = w1.shape[0]
    is_bf16 = int(x.dtype == torch.bfloat16)
    dx, dh = torch.empty_like(x), torch.empty_like(h)  # dh: scratch for the weight kernel
    KERNELS["fused_ffn_bwd_rows"].launch(
        (dy, h, w1, w2, dx, dh), (rows, d, ff, quantized_threshold(rate), is_bf16), x.device)
    splits = weight_splits(rows, d, ff,
                           torch.cuda.get_device_properties(x.device).multi_processor_count)
    total = 2 * d * ff + ff + d
    grads = torch.empty(total, device=x.device, dtype=torch.float32)
    part = (torch.empty((splits, total), device=x.device, dtype=torch.float32)
            if splits > 1 else grads)
    KERNELS["fused_ffn_bwd_weights"].launch(
        (dy, x, h, dh, part, grads), (rows, d, ff, splits, is_bf16), x.device)
    dw1, dw2, db1, db2 = grads.split([d * ff, d * ff, ff, d])
    return dx, dw1.view(ff, d), db1, dw2.view(d, ff), db2


class _FfnTrain(torch.autograd.Function):
    """Saves x, h, w1 and w2 only, as the TPU kernel's ``_ffn_fwd`` does."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seed, rate):
        if x.device.type == "cpu":
            out, h = ffn_reference(x, w1, b1, w2, b2, seed, rate, return_hidden=True)
        else:
            out, h = ffn_forward(x, w1, b1, w2, b2, seed, rate)
        ctx.save_for_backward(x, h, w1, w2)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, dy):
        x, h, w1, w2 = ctx.saved_tensors
        run = backward_formulas if x.device.type == "cpu" else ffn_backward
        dx, dw1, db1, dw2, db2 = run(dy, x, h, w1, w2, ctx.rate)
        # weight grads rounded to the weights' dtype, as _ffn_bwd does
        return dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2, None, None


def ffn_train(x, w1, b1, w2, b2, seed, rate: float):
    """Fused FFN for the training path: ``drop(relu(x·W1ᵀ + b1))·W2ᵀ + b2``.

    ``x``: (rows, d) in the compute dtype (f32 or bf16); ``w1`` (ff, d) and
    ``w2`` (d, ff) in nn.Linear's (out, in) layout (the JAX function takes
    their transposes) and the compute dtype; ``b1``, ``b2`` f32; ``seed`` a
    one-element int32 tensor (one per step and layer); ``rate`` the dropout
    rate on the hidden (the 8-bit rule of ``ops/dropout.py``). CPU tensors run
    the plain version (its backward the kernels' formulas in plain PyTorch);
    CUDA tensors the kernels, or it raises.
    """
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    tensors = (x, w1, b1, w2, b2, seed)
    if not all(t.device.type == "cpu" for t in tensors):
        _check({"x": (x, "d")}, w1, w2, (b1, b2), seed)
    return _FfnTrain.apply(*tensors, float(rate))
