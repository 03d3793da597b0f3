"""Fused multi-head attention: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``transformergrooveinfilling_tpu/ops/
attention.py::fused_mha`` (kernel body ``_mha_kernel``), which every encoder
and decoder layer of the serving model runs. The kernel is
``csrc/fused_mha.cu``.

Layout: q, k and v are ``(B, H, T, hd)`` views with unit stride on hd and any
batch, head and token strides, so the slices of the model's packed qkv and kv
projections pass without a copy. The result is a ``(B, H, T, hd)`` view of a
``(B, T, H, hd)`` buffer, so ``out.transpose(1, 2).reshape(B, T, H·hd)`` is a
view too.

What bounds it on the H100: at the serving shapes (T 32; flagship H 2, hd 128)
one (batch·head) is two 32×32×128 products around a 32×32 softmax — about
0.5 MFLOP against 48 KB of Q/K/V read and 16 KB written in f32 — below the
card's balance point, so the floor is memory: 20 µs at batch 512 in f32,
10 µs in bf16; at batch 1 one block's latency. The kernel launches one block
per (batch·head), a warp for every 16 query rows, and keeps the scores in
registers while the head's columns stream through a ring of shared memory
(``csrc/attn_stream_sm90.cuh``), each warp's output staged there and stored
16 bytes a lane, so a block's shared memory (:func:`kernel_smem_bytes`: 41 KB
in bf16, 45 KB in f32 at T 32) does not grow with hd and hd has no limit but
int32 indexing. Where the (batch, head)s are fewer than two an SM (B 1
serving), a head's columns are split over a thread-block cluster of up to 8
blocks that add their partial scores in rank order. Every product runs on
the tensor cores: bf16 as ``mma.sync`` m16n8k16, f32 in split TF32 (three
TF32 products of each operand's high part and remainder, within ~2⁻²² of
each f32 term), P rounded to V's dtype as :func:`mha_reference` rounds it.
Rows arrive by ``cp.async`` in copies of 16, 8 or 4 bytes, the widest that
the strides, hd and pointers allow (:func:`copy_bytes`), or bf16 rows that
allow none by element loads. Its times on an NVIDIA H100 are in PERF.md §6
(``chip_smoke.py`` phase 3), beside those of the two designs before it (the
whole head in shared memory: at hd 512 one block an SM in f32, one warp a
block in bf16, 2.2× slower than SDPA).

Past ``SHORT_T`` (64: loops longer than 4 bars at sixteenths), up to
``MAX_T`` (2,048), a warp's 16 × T scores outgrow its registers and the
kernel's long route takes over, a (batch, head) split by its query rows over
blocks. :func:`route` states the rule that picks its form, and the kernel
follows it: at heads up to ``FLASH_HD`` (128, the flagship's) whose views TMA
can read (hd·element size, every stride and every base pointer a multiple of
16 bytes, no stride 0), the flash form (``csrc/attn_flash_sm90.cuh``): work
items of query rows (:func:`flash_rows`: 128, or 64 where items of 64 fill no
more than one wave of the SMs) in consumer warpgroups of 64, at most one
persistent block an SM walking the items, one producer thread loading each
item's Q and its key tiles' K and V by TMA into a ring under mbarriers, S =
Q·Kᵀ and O += P̃·V on ``wgmma`` (f32 in split TF32, the producer warpgroup's
other warps splitting Q, K and V), each row's running max and sum in
registers, O / Σ at the end, stored by TMA. Every
other long shape takes the scores form: each block's (rows, T) f32 scores lie
in shared memory (:func:`long_rows` rows a block) while the head's columns
stream through a ``cp.async`` ring in 64-byte chunks (scores key tile by key
tile, the softmax row by row, then the output chunk by chunk, a fresh
accumulator every 64 keys), so shared memory does not grow with hd. A rerun
is bit for bit in both.

On a CPU tensor the wrapper runs ``mha_reference`` (into the same output
layout); on a CUDA tensor it launches the kernel or raises — it never gives
way to the plain version. Every launch adds one to ``KERNEL.launches``, and
one to ``FORM_LAUNCHES`` under the form :func:`route` names.

The same function is the operator ``torch.ops.tgi.fused_mha(q, k, v,
causal)`` (``torch.library.custom_op``), registered when this module is
imported: its CUDA implementation is the kernel's launch above, its CPU
implementation ``mha_reference`` into the same layout, and its fake
implementation gives the ``(B, T, H, hd)`` buffer's strides, so a traced
``out.transpose(1, 2).reshape(B, T, H·hd)`` stays a view. Only a traced
forward calls the operator (``export.py``'s artifacts: the model's attention
takes it while ``torch.compiler.is_exporting()``); eager forwards call
:func:`fused_mha` itself and pay no dispatcher. An exported program therefore
holds this kernel, not the plain attention (where JAX's artifacts take the
plain path: a Mosaic custom call would pin them to one TPU toolchain, while
the operator here is the kernel built from ``csrc/`` at first use); loading
such a program needs this module imported, and nothing of the model.

The operator also has a ``vmap`` rule, the second call site: a batched
sweep's ranking forward (``train/vmap_sweep.py::stacked_eval_loss``) runs the
model under ``torch.func.vmap`` over K trials' stacked weights, and there the
model's attention calls the operator too (its input is a batched tensor, which
a ctypes launch cannot read). The kernel does not depend on the weights, so
the rule folds the trial axis into the batch axis, ``(K, B, H, T, hd) → (K·B,
H, T, hd)``, and launches once for all K trials: a view when the trial stride
is B times the batch stride, as it is for the slices of a vmapped packed
projection, else a contiguous copy; an operand without a trial axis is
expanded. The result is the ``(K, B, H, T, hd)`` view of the folded output.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from . import _build

# The short route's longest sequence: a block holds a (batch·head)'s T query
# rows, a warp for every 16, and each warp its 16 × T scores in registers
# (four warps and 16 × 64 scores at most)
SHORT_T = 64
# The longest sequence, the long route's (a (batch·head) split by its query
# rows over blocks of four warps, their f32 scores in shared memory: 64 rows
# a block up to T 256, 32 up to 512, 16 past it, 162 KB a block at T 2,048).
# A loop of L bars at sixteenths is T 16·L: 2 bars T 32 (the grid's), 8 bars
# T 128, 64 bars T 1,024. The TPU kernel holds a (batch·head)'s (T, T) f32
# scores in VMEM beside its double-buffered (T, hd) blocks of q, k, v and o:
# at T 2,048 the scores alone are 16 MB, v5e's whole scoped VMEM, so this
# ceiling lies above the TPU kernel's.
MAX_T = 2048
STAGES = 4  # the short route's ring of shared-memory stages: three chunks in flight
STAGE_ROW_BYTES = 128  # a stage's columns of each row
LONG_STAGES = 3  # the long route's ring
LONG_CHUNK_BYTES = 64  # the long route's score chunks; its output chunks are twice that
LONG_KEYS = 64  # the long route's key tiles
LONG_WARPS = 4
# heads up to FLASH_HD take the long route's flash form where TMA can read
# the views (FLASH_ALIGN: hd·element size, every stride and base pointer)
FLASH_HD = 128
FLASH_ALIGN = 16
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False) -> torch.Tensor:
    """The kernel's math in plain PyTorch, over ``(B, H, T, hd)``.

    Scores in f32 scaled by ``1/√hd``, ``-1e9`` above the diagonal when
    ``causal``, an f32 softmax, probabilities rounded to ``v.dtype``, then
    ``p·v`` accumulated in f32 and cast to ``q.dtype`` — the TPU kernel's
    ``preferred_element_type=f32`` products.
    """
    t, hd = q.shape[-2], q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    if causal:
        above = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, -1e9)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def long_rows(t: int) -> int:
    """The query rows a block of the long route takes at sequence length
    ``t`` (past ``SHORT_T``)."""
    return 64 if t <= 256 else 32 if t <= 512 else 16


def flash_rows(b: int, h: int, t: int, sms: int) -> int:
    """The query rows a work item of the flash form takes, both dtypes: 64 (one
    consumer warpgroup a block) where B·H·⌈T/64⌉ such items fill no more than
    one wave of the card's ``sms`` SMs (B 1 serving), else 128 (two)."""
    return 64 if b * h * -(-t // 64) <= sms else 128


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The form of the kernel that takes these ``(B, H, T, hd)`` views, by the
    rule ``csrc/fused_mha.cu`` follows: ``"short"`` up to ``SHORT_T``; past it
    ``"flash"`` where hd ≤ ``FLASH_HD``, hd·element size, every (batch, head,
    token) stride and every base pointer are multiples of ``FLASH_ALIGN``
    bytes and no stride is 0 (what TMA reads), else ``"scores"``."""
    strides = _strides(q, k, v)
    return _form(q.shape[-2], q.shape[-1], _copy(q, k, v, strides), strides)


def _form(t: int, hd: int, copy: int, strides: tuple) -> str:
    """:func:`route` from T, hd, the copy bytes and the views' strides."""
    if t <= SHORT_T:
        return "short"
    if hd <= FLASH_HD and copy == FLASH_ALIGN and 0 not in strides:
        return "flash"
    return "scores"


def flash_smem_bytes(dtype, rows: int) -> int:
    """Dynamic shared memory of one block of the flash form at ``rows`` query
    rows, each row ``FLASH_HD`` values wide whatever hd is. Key tiles of 64
    keys at 64 rows; at 128 rows bf16 128, f32 32. bf16: the Q tile (two
    buffers at 128 rows) and a 2-stage ring of K and V tiles; f32: Q and a K
    tile each with its lo plane beside, the raw V tile and its two transposed
    planes, one stage. Then the mbarriers (Q full and empty a buffer; K full
    and empty, V full and empty a stage; f32 four more) and 1,024 bytes to
    align the base for the 128-byte swizzle."""
    f32 = dtype.itemsize == 4
    keys = 64 if rows == 64 else 32 if f32 else 128
    qbufs = 2 if rows == 128 and not f32 else 1
    stages = 1 if f32 else 2
    q = rows * FLASH_HD * dtype.itemsize * (2 if f32 else 1)
    tile = keys * FLASH_HD * dtype.itemsize
    stage = (2 * tile if f32 else tile) + tile
    bars = 2 * qbufs + 4 * stages + (4 if f32 else 0)
    return qbufs * q + stages * stage + (2 * tile if f32 else 0) + 8 * bars + 1024


def kernel_smem_bytes(t: int, dtype=torch.float32, hd: int | None = None,
                      rows: int | None = None) -> int:
    """Dynamic shared memory of one block, whatever hd is (bf16 stage rows
    padded by 8 values, f32 rows by 4). Up to ``SHORT_T``: the ring of
    ``STAGES`` stages, each the 128 bytes of two tiles of T rows rounded up
    to 16 (Q and K, then two chunks of V); a warp's 16-row output staging
    tile of the same rows for every 16 rows of T; in f32 also the (T, T + 4)
    probabilities, T rounded up to 16 (the partial scores a cluster adds are
    staged in a spent stage). Past it, at heads up to ``FLASH_HD`` (``hd``
    given), the flash form (:func:`flash_smem_bytes` at ``rows``, by default
    128); at wider heads the scores
    form: ``LONG_STAGES`` stages, each the larger of a 64-byte chunk of the
    block's query rows and a key tile's, or a 128-byte chunk of a key tile's
    V; the four warps' staging tiles of their share of the 128 bytes; the
    (rows, T + 4) f32 scores, T rounded up to ``LONG_KEYS``."""
    size = dtype.itemsize
    pad = 8 if size == 2 else 4
    if t > SHORT_T and hd is not None and hd <= FLASH_HD:
        return flash_smem_bytes(dtype, rows or 128)
    if t <= SHORT_T:
        rows = -(-t // 16) * 16
        cols = STAGE_ROW_BYTES // size + pad
        ring = (STAGES * 2 + 1) * rows * cols * size
        return ring if size == 2 else ring + 4 * rows * (rows + 4)
    qr = long_rows(t)
    cw = LONG_CHUNK_BYTES // size
    stage = max((qr + LONG_KEYS) * (cw + pad), LONG_KEYS * (2 * cw + pad)) * size
    staging = LONG_WARPS * 16 * (2 * cw * qr // (16 * LONG_WARPS) + pad) * size
    scores = 4 * qr * (LONG_KEYS * -(-t // LONG_KEYS) + 4)
    return LONG_STAGES * stage + staging + scores


def check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` on a dtype, shape or layout that
    ``csrc/fused_mha.cu`` does not take (the device is checked by
    :func:`fused_mha`)."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"fused_mha kernel takes float32 or bfloat16 q, k, v of one dtype; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or not (q.shape == k.shape == v.shape):
        raise ValueError(
            f"fused_mha kernel takes q, k, v of one (B, H, T, hd) shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, hd = q.shape
    blocks = b * h * (1 if t <= SHORT_T else -(-t // long_rows(t)))
    if b * h == 0 or blocks >= 2 ** 31 or not (1 <= t <= MAX_T) or not (1 <= hd < 2 ** 31):
        raise ValueError(
            f"fused_mha kernel takes B·H ≥ 1 and hd ≥ 1 (blocks below 2**31), T ≤ {MAX_T} "
            f"(its ceiling); got shape {tuple(q.shape)}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError(
            f"fused_mha kernel takes q, k, v with unit stride on hd; got strides "
            f"{q.stride()}, {k.stride()}, {v.stride()}")


def copy_bytes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """The bytes of each ``cp.async`` copy of the kernel's rows: 16, 8 or 4,
    the widest that every (batch, head, token) stride, hd and base pointer
    of q, k and v are multiples of (the slices of a packed projection take
    16 when hd is a multiple of 8 in bf16, of 4 in f32); 2 for bf16 rows that
    allow none, read element by element."""
    return _copy(q, k, v, _strides(q, k, v))


def _strides(q, k, v) -> tuple:
    """The (batch, head, token) strides of q, k and v, the kernel's arguments."""
    return (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])


def _copy(q, k, v, strides: tuple) -> int:
    """:func:`copy_bytes` given the views' strides."""
    size = q.element_size()
    g = math.gcd(*strides, q.shape[-1]) * size
    ptrs = q.data_ptr() | k.data_ptr() | v.data_ptr()
    return next((c for c in (16, 8, 4) if g % c == 0 and ptrs % c == 0), size)


@functools.cache
def _library():
    lib = _build.load_library("fused_mha")
    lib.tgi_fused_mha.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9 + [
        ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    lib.tgi_fused_mha.restype = ctypes.c_int
    lib.tgi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tgi_cuda_error_string.restype = ctypes.c_char_p
    return lib


KERNEL = _build.CountedKernel(_library, "tgi_fused_mha", "tgi_cuda_error_string")
# the launches by the form that took them (route()); reset by whoever reads them
FORM_LAUNCHES = {"short": 0, "flash": 0, "scores": 0}
_form_lock = threading.Lock()


def _output(q: torch.Tensor) -> torch.Tensor:
    """An empty ``(B, H, T, hd)`` view of a ``(B, T, H, hd)`` buffer."""
    b, h, t, hd = q.shape
    return torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device).transpose(1, 2)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
    """softmax(QKᵀ/√hd + optional causal mask)·V over ``(B, H, T, hd)`` views
    (unit stride on hd); the result is a ``(B, H, T, hd)`` view of a
    ``(B, T, H, hd)`` buffer.

    CUDA tensors go through the hand-written kernel; CPU tensors through
    :func:`mha_reference`.
    """
    if q.device.type == k.device.type == v.device.type == "cpu":
        return _output(q).copy_(mha_reference(q, k, v, causal))
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(
            f"fused_mha kernel needs q, k, v on one CUDA device; got "
            f"{q.device}, {k.device}, {v.device}")
    check_kernel_args(q, k, v)
    b, h, t, hd = q.shape
    out = _output(q)
    strides = _strides(q, k, v)
    copy = _copy(q, k, v, strides)
    KERNEL.launch((q, k, v, out),
                  (*strides, b, h, t, hd, int(causal), int(q.dtype == torch.bfloat16), copy,
                   1.0 / math.sqrt(hd)), q.device)
    form = _form(t, hd, copy, strides)
    with _form_lock:
        FORM_LAUNCHES[form] += 1
    return out


@torch.library.custom_op("tgi::fused_mha", mutates_args=())
def fused_mha_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> torch.Tensor:
    """:func:`fused_mha` as an operator, for traced programs: on the card
    the kernel's launch (counted in ``KERNEL.launches``), on the CPU its
    plain version in the same layout, on any other device a ``ValueError``."""
    return fused_mha(q, k, v, causal)


@fused_mha_op.register_fake
def _fused_mha_fake(q, k, v, causal):
    b, h, t, hd = q.shape
    return q.new_empty((b, t, h, hd)).transpose(1, 2)


@fused_mha_op.register_vmap
def _fused_mha_vmap(info, in_dims, q, k, v, causal):
    """K trials in one launch: the trial axis of q, k and v moved to the
    front and folded into the batch axis (see the module docstring)."""
    n = info.batch_size
    q, k, v = (x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
               for x, dim in zip((q, k, v), in_dims))
    b = q.shape[1]
    out = fused_mha_op(*(x.reshape(n * b, *x.shape[2:]) for x in (q, k, v)), causal)
    return out.unflatten(0, (n, b)), 0
