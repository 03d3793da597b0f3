"""Fused dropout + residual add + LayerNorm for training: wrapper, plain
version and dropout words.

Replaces the Pallas TPU kernels of ``transformergrooveinfilling_tpu/ops/
fused_ln.py`` under ``dropout_add_layernorm`` (forward ``_run_fwd`` →
``_fwd_kernel``, backward ``_run_bwd`` → ``_bwd_kernel``):

    a = x + dropout(y);  out = (a − mean(a))·rsqrt(var(a) + 1e-5)·scale + bias

in f32 with the two-pass variance, and its backward, which draws the mask
again from the seed instead of loading a stored one: the mask never reaches
device memory in either direction. The kernels are ``csrc/fused_ln.cu``, one
launch each way. A warp holds its rows in registers (each lane whole 16-byte
chunks: 8 bf16 or 4 f32 values; 8 bytes where a bf16 width is no multiple of
8), loads several rows before their reductions, and takes an equal share of
the rows of a grid that is one wave (:func:`ln_grid`). The backward writes dx
and dy and sums dscale and dbias in the same launch: each block adds its
warps' sums in warp order into one partial, and a tree of integer tickets
(:func:`ticket_tree`: the last of 16 blocks to finish adds their partials,
the last of 16 such nodes theirs) gives the root the totals, all in a fixed
order, with no float atomics; two runs with one seed agree bit for bit. The
tickets are a buffer per (device, stream) that this module caches and the
kernel leaves at zero after every launch; two backward calls on two streams
at once each take their own, so they cannot corrupt each other's sums.

What bounds it on the H100: bytes (3 values an element forward, 5 backward,
against some 20 f32 operations). On an NVIDIA H100 80GB HBM3 at 700 W
(``chip_smoke.py`` phase 17; PERF.md §6), bf16: the forward 12.1 µs and the
backward 22.2 µs of device time at rows 16,384 × d 256 (62 % and 56 % of the
bytes bound), 13.5 and 26.5 µs at rows 4,096 × d 1,024; at rows 1,024 3.5 and
11.9 µs, set by latency. ``F.layer_norm(x + F.dropout(y))`` takes 38.3 µs and
its autograd backward 72.0 µs at rows 16,384.

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
import threading

import torch

from . import _build
from .fused_layer import KERNEL_DTYPES, LN_EPS, _U32, philox4x32

SITE_LN = 4  # the word stream's site, apart from the layer kernels' 0-3
WARPS = 8  # warps a forward block has


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


# ---------------------------------------------------------------- gate and grid

MAX_CHUNKS = 8  # csrc/fused_ln.cu::kMaxChunks: a lane's chunks of a row, at most
FAN_IN = 16  # csrc/fused_ln.cu::kFan: partials a node of the backward's tree adds


def chunk_width(d: int, dtype) -> int:
    """Columns a lane loads with one instruction: 16 bytes (8 bf16, 4 f32), or
    8 bytes (4 bf16) where a bf16 width is a multiple of 4 but not of 8."""
    return 8 if dtype == torch.bfloat16 and d % 8 == 0 else 4


def lane_values(d: int, dtype) -> int:
    """f32 values of one row a lane holds in registers: its chunks (l, l + 32,
    ...) rounded up to a power of 2, as the kernels' template instances are."""
    per_lane = -(-(d // chunk_width(d, dtype)) // 32)
    return chunk_width(d, dtype) * (1 << (per_lane - 1).bit_length())


def supports_fused_ln(d_model: int, dtype=torch.float32) -> bool:
    """Whether ``csrc/fused_ln.cu`` takes this width: f32 or bf16 storage, d a
    multiple of 4 (a lane's chunk is 4 or 8 columns; a bf16 width that is no
    multiple of 8 takes 8-byte chunks), and at most 8 chunks a lane, since a
    lane holds its chunks of a row in registers: d ≤ 2,048 in bf16 (16-byte
    chunks of 8), else d ≤ 1,024 (chunks of 4): beyond that a backward row
    would not fit a thread's registers without spilling. Every width of the repo's configs is inside (16-512 in the sweeps, 256,
    1,024; 72 in the card tests). The TPU kernel's blocks of 256 rows are not
    carried over: any row count is taken, without padding."""
    return (dtype in KERNEL_DTYPES and d_model >= 4 and d_model % 4 == 0
            and d_model <= 32 * MAX_CHUNKS * chunk_width(d_model, dtype))


def bwd_warps(d: int, dtype) -> int:
    """Warps of a backward block, one block an SM (``fused_ln.cu::bwd_warps``):
    24 while a lane holds at most 16 values of a row, 16 up to 32, else 8, so
    that the launch bounds leave each thread the registers its row needs."""
    values = lane_values(d, dtype)
    return 24 if values <= 16 else 16 if values <= 32 else 8


def ln_grid(rows: int, d: int, dtype, sms: int, backward: bool) -> int:
    """Blocks of a launch, one wave: the forward 2 blocks of 8 warps an SM, the
    backward one block of ``bwd_warps`` an SM (its partials feed the tree of
    tickets, then 2 levels deep), or a warp a row where the rows are fewer.
    Each warp takes an equal, contiguous share of the rows."""
    warps = bwd_warps(d, dtype) if backward else WARPS
    return max(1, min(-(-rows // warps), sms if backward else 2 * sms))


def ticket_tree(blocks: int) -> list[int]:
    """Nodes of each level of the backward's tree above the blocks: 16 blocks
    a node, 16 nodes a node of the next level, up to the root (none for one
    block, which writes dscale and dbias itself). Each node has a ticket and,
    but the root, a partial."""
    levels = []
    while (levels[-1] if levels else blocks) > 1:
        levels.append(-(-(levels[-1] if levels else blocks) // FAN_IN))
    return levels


def bwd_smem_bytes(d: int, dtype) -> int:
    """Backward block: each warp's Σ g·zhat and Σ g over its lanes' padded
    chunks, f32 (the forward uses no shared memory)."""
    return 4 * 2 * bwd_warps(d, dtype) * 32 * lane_values(d, dtype)


# ---------------------------------------------------------------- kernels

@functools.cache
def _kernels():
    lib = _build.load_library("fused_ln")
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.tgi_ln_fwd.argtypes = SIGNATURES["tgi_ln_fwd"] + [p]
    lib.tgi_ln_bwd.argtypes = SIGNATURES["tgi_ln_bwd"] + [p]
    lib.tgi_ln_fwd.restype = lib.tgi_ln_bwd.restype = i
    lib.tgi_ln_error_string.argtypes = [i]
    lib.tgi_ln_error_string.restype = ctypes.c_char_p
    return lib


# each entry point's arguments before the stream, as ctypes declares them
SIGNATURES = {
    "tgi_ln_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_uint, ctypes.c_float]
    + [ctypes.c_int] * 3,
    "tgi_ln_bwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_uint, ctypes.c_float]
    + [ctypes.c_int] * 3,
}
KERNELS = {"fused_ln_fwd": _build.CountedKernel(_kernels, "tgi_ln_fwd", "tgi_ln_error_string"),
           "fused_ln_bwd": _build.CountedKernel(_kernels, "tgi_ln_bwd", "tgi_ln_error_string")}

TICKETS = 1024  # counters a ticket buffer holds: the nodes of a tree of up to 15,000 blocks
_tickets: dict = {}
_tickets_lock = threading.Lock()


def _ticket_buffer(device) -> torch.Tensor:
    """The backward's ticket counters for ``device``'s current stream, zeroed
    once (the kernel leaves them zero after every launch). One buffer a
    stream: two backward launches on one stream run one after the other, and
    two streams never share a counter, so launches on two streams at once
    cannot take each other's tickets."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    with _tickets_lock:
        buf = _tickets.get(key)
        if buf is None:
            buf = _tickets[key] = torch.zeros(TICKETS, dtype=torch.int32, device=device)
        return buf




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
    align = chunk_width(d, x.dtype) * x.element_size()
    if any(t.data_ptr() % align for t in rows) or any(v.data_ptr() % 16 for v in vectors):
        raise ValueError(f"fused_ln kernels take rows aligned to {align} bytes and scale and "
                         "bias to 16")


def _scalars(x, rate: float):
    d = x.shape[-1]
    return (x.numel() // d, d, keep_threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0),
            int(x.dtype == torch.bfloat16))


def ln_forward(x, y, scale, bias, seed, rate: float):
    """Launch the forward kernel."""
    _check((x, y), (scale, bias), seed)
    out = torch.empty_like(x)
    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    blocks = ln_grid(rows, d, x.dtype, _build.sm_count(x.device), False)
    KERNELS["fused_ln_fwd"].launch((x, y, scale, bias, seed, out),
                                   (*_scalars(x, rate), blocks), x.device)
    return out


def ln_backward(g, x, y, scale, seed, rate: float):
    """Launch the backward kernel, one launch in all: ``(dx, dy, dscale,
    dbias)``, dscale and dbias summed inside it."""
    g = g.contiguous()
    _check((x, y, g), (scale,), seed)
    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    blocks = ln_grid(rows, d, x.dtype, _build.sm_count(x.device), True)
    tree = ticket_tree(blocks)
    if sum(tree) > TICKETS:
        raise ValueError(f"fused_ln backward: {blocks} blocks need {sum(tree)} tickets")
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    dparams = torch.empty((2, d), device=x.device, dtype=torch.float32)
    partials = torch.empty((max(1, blocks + sum(tree[:-1])), 2, d), device=x.device,
                           dtype=torch.float32)
    KERNELS["fused_ln_bwd"].launch(
        (x, y, scale, seed, g, dx, dy, dparams, partials, _ticket_buffer(x.device)),
        (*_scalars(x, rate), blocks), x.device)
    return dx, dy, dparams[0], dparams[1]


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
