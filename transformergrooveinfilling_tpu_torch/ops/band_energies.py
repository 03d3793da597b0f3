"""Fused |DFT| + band projection: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``transformergrooveinfilling_tpu/ops/
mso_pallas.py::band_energies_pallas`` (kernel body ``_band_energy_kernel``),
the hot loop of the MSO front end: Hann-windowed frames ``(N, n_fft)`` →
``re = x·cos``, ``im = x·(−sin)`` over bins ``0 .. n_fft/2 − 1`` → magnitude →
``· filterbankᵀ`` → band energies ``(N, 16)``. The kernel is
``csrc/band_energies.cu``; the ``(N, 512)`` magnitude never reaches device
memory.

The Nyquist bin is dropped, as the TPU kernel drops it (the log-frequency
filterbank's support ends below it, so it carries almost no band energy); that
changes the result against an rFFT that keeps it, so the kernel and
:func:`band_energies_plain` both use ``fb_t[:n_fft // 2]``. The TPU kernel's
128-frame blocks and its padding of the 16 bands to 128 lanes are layout
choices and are not carried over: the kernel takes 64 frames a block, guards
the ragged tail itself and pads nothing.

What bounds it on the H100: the function needs its frames read once
(``4·N·n_fft`` bytes, 110 MB for 64 loops at 120 bpm, N = 26,752) and an FFT's
operations (about 44,000 a frame with the magnitude and the projection, 1.2
GFLOP), so its bound is the memory rate: 0.033 ms at N = 26,752 and 0.0005 ms
at N = 418 (one request). This first version is nowhere near it. Like the TPU
kernel it forms the DFT as two dense products, ``4·N·n_fft·(n_fft/2)`` FLOP
(56.5 GFLOP at N = 26,752, 0.84 ms at the f32 peak of the CUDA cores). All
products are plain f32 FMAs: the DFT sums 1,024 nearly cancelling terms, which
TF32's 10 mantissa bits visibly degrade, so the plain version here and the
``"conv"`` route of ``ops/mso.py`` keep TF32 off as well. Measured on an
NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``, PERF.md): 2.04 ms at
N = 26,752 (1.6 % of the bound; 41 % of what its own dense products allow) and
0.080 ms at N = 418 (0.7 % of the bound). ``torch.fft.rfft`` of the same
frames plus one matmul takes 0.260 ms and 0.053 ms: cuFFT's O(n log n) beats
the O(n²) DFT products by 8× at a chunk. The kernel stays the CUDA default of
``mso_batch`` all the same (``method="fft"`` selects cuFFT); a faster design
is queued in ROADMAP.md.

Below :data:`SPLIT_BELOW_BLOCKS` row blocks one call launches two kernels: the
bin tiles of a row block are split over 8 blocks that write partial band sums,
and a second kernel adds them in order. On the same card one request's 418
frames take 0.080 ms split and 0.594 ms as 7 unsplit blocks. A call adds one
to ``band_energies.launches`` either way.

On a CPU tensor the wrapper runs :func:`band_energies_plain`; on a CUDA tensor
it launches the kernel or raises — it never gives way to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch

from . import _build

N_BANDS = 16   # the kernel's filterbank width
BIN_TILE = 64  # bins per tile of the kernel; n_fft // 2 is a multiple
ROW_BLOCK = 64  # frames per block of the kernel
# below this many row blocks the bin tiles are split over more blocks, so that
# a single request (7 row blocks) still covers a good part of the card's 132 SMs
SPLIT_BELOW_BLOCKS = 66

_count_lock = threading.Lock()


@functools.lru_cache(maxsize=4)
def _dft_basis_numpy(n_fft: int):
    """Real/imag DFT basis as ``(n_fft, n_fft // 2)`` float32 matrices (f64
    angles, one cast), Nyquist bin dropped."""
    k = np.arange(n_fft // 2)
    n = np.arange(n_fft)
    angle = 2.0 * math.pi * np.outer(n, k) / n_fft
    return np.cos(angle).astype(np.float32), (-np.sin(angle)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def dft_basis(n_fft: int, device: torch.device):
    """The basis as two tensors resident on ``device``."""
    cos_b, sin_b = _dft_basis_numpy(n_fft)
    return torch.from_numpy(cos_b).to(device), torch.from_numpy(sin_b).to(device)


def band_energies_plain(frames: torch.Tensor, fb_t: torch.Tensor) -> torch.Tensor:
    """The kernel's math in plain PyTorch: two f32 products against the DFT
    basis, the magnitude, the projection onto ``fb_t[:n_fft // 2]``. On a CUDA
    tensor the products must not run in TF32 (``torch.backends.cuda.matmul
    .allow_tf32`` False, PyTorch's default)."""
    n_fft = frames.shape[-1]
    cos_b, sin_b = dft_basis(n_fft, frames.device)
    x = frames.to(torch.float32)
    re, im = x @ cos_b, x @ sin_b
    mag = torch.sqrt(re * re + im * im)
    return mag @ fb_t[: n_fft // 2].to(torch.float32)


def check_kernel_args(frames: torch.Tensor, fb_t: torch.Tensor) -> None:
    """Raise ``ValueError`` on a dtype, shape or layout that
    ``csrc/band_energies.cu`` does not take."""
    if frames.dtype != torch.float32 or fb_t.dtype != torch.float32:
        raise ValueError(f"band_energies kernel takes float32 frames and filterbank; got "
                         f"{frames.dtype}, {fb_t.dtype}")
    if frames.dim() != 2 or fb_t.dim() != 2:
        raise ValueError(f"band_energies kernel takes frames (N, n_fft) and fb_t "
                         f"(n_fft // 2 + 1, {N_BANDS}); got {tuple(frames.shape)}, "
                         f"{tuple(fb_t.shape)}")
    n, n_fft = frames.shape
    n_bins = n_fft // 2
    if n < 1 or n_fft % (2 * BIN_TILE) != 0 or fb_t.shape[1] != N_BANDS \
            or fb_t.shape[0] < n_bins:
        raise ValueError(f"band_energies kernel takes N ≥ 1, n_fft a multiple of "
                         f"{2 * BIN_TILE}, fb_t with ≥ n_fft // 2 rows and {N_BANDS} columns; "
                         f"got frames {tuple(frames.shape)}, fb_t {tuple(fb_t.shape)}")
    if not frames.is_contiguous() or frames.data_ptr() % 16 != 0:
        raise ValueError("band_energies kernel takes contiguous, 16-byte aligned frames")


@functools.cache
def _kernel():
    lib = _build.load_library("band_energies")
    fn = lib.tgi_band_energies
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tgi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tgi_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.tgi_cuda_error_string


def bin_split(n: int, n_fft: int) -> int:
    """How many blocks share one row block's bin tiles at ``n`` frames."""
    if -(-n // ROW_BLOCK) >= SPLIT_BELOW_BLOCKS:
        return 1
    return n_fft // 2 // BIN_TILE


def band_energies(frames: torch.Tensor, fb_t: torch.Tensor) -> torch.Tensor:
    """Windowed frames ``(N, n_fft)`` × filterbankᵀ ``(n_fft // 2 + 1, 16)`` →
    band energies ``(N, 16)``; fused |DFT| + projection, Nyquist bin dropped.

    CUDA tensors go through the hand-written kernel; CPU tensors through
    :func:`band_energies_plain`. Each call that reaches the kernel adds one to
    ``band_energies.launches`` (two kernels when the bin tiles are split). No gradient: the result is a model input.
    """
    if frames.device.type == fb_t.device.type == "cpu":
        return band_energies_plain(frames, fb_t)
    if frames.device != fb_t.device or frames.device.type != "cuda":
        raise ValueError(f"band_energies kernel needs frames and fb_t on one CUDA device; got "
                         f"{frames.device}, {fb_t.device}")
    check_kernel_args(frames, fb_t)
    launch, error_string = _kernel()
    n, n_fft = frames.shape
    n_bins = n_fft // 2
    cos_b, sin_b = dft_basis(n_fft, frames.device)
    fb = fb_t[:n_bins].contiguous()
    split = bin_split(n, n_fft)
    out = torch.empty((n, N_BANDS), dtype=torch.float32, device=frames.device)
    scratch = (torch.empty((split, n, N_BANDS), dtype=torch.float32, device=frames.device)
               if split > 1 else None)
    with torch.cuda.device(frames.device):
        rc = launch(frames.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), fb.data_ptr(),
                    out.data_ptr(), scratch.data_ptr() if split > 1 else None,
                    n, n_fft, n_bins, N_BANDS, split,
                    torch.cuda.current_stream(frames.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"band_energies kernel launch failed at frames {tuple(frames.shape)}: "
                           f"{error_string(rc).decode()} (cudaError {rc})")
    with _count_lock:
        band_energies.launches += 1
    return out


band_energies.launches = 0
