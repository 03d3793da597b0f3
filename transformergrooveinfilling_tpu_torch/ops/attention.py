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
per (batch·head, 16 query rows), so batch 1 × 2 heads is 4 blocks. bf16 with
hd % 16 == 0 and 16-byte aligned rows runs both products on the tensor cores
(``mma.sync`` m16n8k16, f32 accumulators, P rounded to bf16 as
:func:`mha_reference` rounds it); f32, and bf16 at other head widths or
alignments, run register-tiled f32 FMAs on the CUDA cores (no TF32). On an
NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase 3, PERF.md §6) a
call takes 7.6 µs of device time at batch 1 in f32, 57.9 µs at batch 512 in
f32 and 17.3 µs in bf16, against SDPA's 10.4, 88.0 and 26.5 µs on the same
views; the first version (one block per batch·head, two shared-memory loads
an FMA) took 19.3, 94.9 and 85.3 µs.

On a CPU tensor the wrapper runs ``mha_reference`` (into the same output
layout); on a CUDA tensor it launches the kernel or raises — it never gives
way to the plain version. Every launch adds one to ``KERNEL.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

MAX_T = 64
MAX_HEAD_DIM = 256
ROWS_PER_BLOCK = 16  # query rows of one block
# shared memory one block may take on Hopper (227 KB), opt-in above 48 KB
MAX_SMEM_BYTES = 232448
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


def kernel_smem_bytes(t: int, hd: int, tensor_cores: bool = False) -> int:
    """Dynamic shared memory of one block. Tensor-core path: Q (16 rows), K
    and V (T rounded up to 16) in bf16, rows padded by 8 values. CUDA-core
    path: Q (16 rows), K (T), V (T rounded up to 4) in f32, rows of hd rounded
    up to 8 plus 4, and the (16, T rounded up to 4) scores."""
    if tensor_cores:
        return 2 * (ROWS_PER_BLOCK + 2 * (-(-t // 16) * 16)) * (hd + 8)
    ld, tp = -(-hd // 8) * 8 + 4, -(-t // 4) * 4
    return 4 * ((ROWS_PER_BLOCK + t + tp) * ld + ROWS_PER_BLOCK * tp)


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
    if b * h == 0 or b * h >= 2 ** 31 or not (1 <= t <= MAX_T) \
            or not (1 <= hd <= MAX_HEAD_DIM):
        raise ValueError(
            f"fused_mha kernel takes B·H ≥ 1 (below 2**31), T ≤ {MAX_T}, hd ≤ {MAX_HEAD_DIM}; "
            f"got shape {tuple(q.shape)}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError(
            f"fused_mha kernel takes q, k, v with unit stride on hd; got strides "
            f"{q.stride()}, {k.stride()}, {v.stride()}")


def _layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The kernel's layout arguments: the nine (batch, head, token) strides,
    whether it takes its tensor-core path (bf16, hd a multiple of 16, every
    stride a multiple of 8 and every base pointer 16-byte aligned: the slices
    of a packed projection are, when hd is a multiple of 8), and whether its
    f32 path reads rows as float4s (hd and strides multiples of 4, aligned)."""
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    aligned = (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0
    g, hd = math.gcd(*strides), q.shape[-1]
    tensor_cores = q.dtype == torch.bfloat16 and hd % 16 == 0 and aligned and g % 8 == 0
    vec4 = q.dtype == torch.float32 and hd % 4 == 0 and aligned and g % 4 == 0
    return strides, tensor_cores, vec4


def uses_tensor_cores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel takes its tensor-core path for these inputs (any
    other layout or dtype takes its CUDA-core path)."""
    return _layout(q, k, v)[1]


@functools.cache
def _library():
    lib = _build.load_library("fused_mha")
    lib.tgi_fused_mha.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9 + [
        ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    lib.tgi_fused_mha.restype = ctypes.c_int
    lib.tgi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tgi_cuda_error_string.restype = ctypes.c_char_p
    return lib


KERNEL = _build.CountedKernel(_library, "tgi_fused_mha", "tgi_cuda_error_string")


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
    strides, tensor_cores, vec4 = _layout(q, k, v)
    KERNEL.launch((q, k, v, out),
                  (*strides, b, h, t, hd, int(causal), int(q.dtype == torch.bfloat16),
                   int(tensor_cores), int(vec4), 1.0 / math.sqrt(hd)), q.device)
    return out
