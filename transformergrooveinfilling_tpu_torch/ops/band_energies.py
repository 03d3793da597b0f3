"""Framing + |DFT| + band projection: the CUDA kernel's wrappers and their plain version.

Replaces the Pallas TPU kernel ``transformergrooveinfilling_tpu/ops/
mso_pallas.py::band_energies_pallas`` (kernel body ``_band_energy_kernel``),
the hot loop of the MSO front end: Hann-windowed frames ``(N, n_fft)`` →
``re = x·cos``, ``im = x·(−sin)`` over bins ``0 .. n_fft/2 − 1`` → magnitude →
``· filterbankᵀ`` → band energies ``(N, 16)``. The kernel is
``csrc/band_energies.cu``. Two entry points launch it:

- :func:`band_energies_from_audio` takes the waveform ``(M, L)`` and frames it
  inside the kernel (reflect padding by index, the window passed in), so the
  2.3×-overlapping frames are never materialised. ``ops/mso.py``'s
  ``"fused"`` method calls it.
- :func:`band_energies` takes frames ``(N, n_fft)``, the JAX kernel's
  signature, and runs the same kernel with hop = n_fft, no padding and no
  window.

The Nyquist bin is dropped, as the TPU kernel drops it (the log-frequency
filterbank's support ends below it, so it carries almost no band energy); that
changes the result against an rFFT that keeps it, so the kernel and
:func:`band_energies_plain` both use ``fb_t[:n_fft // 2]``. The kernel takes
n_fft = 1024 (the MSO's) only.

What bounds it on the H100: the waveform read once (4 bytes a sample; 47 MB
for a chunk of 64 loops at 120 bpm, 0.014 ms at 3.35 TB/s) and an FFT's
operations (about 44,000 a frame with the magnitude and the projection; 1.2
GFLOP at N = 26,752 frames, 0.018 ms at the f32 peak of the CUDA cores), so the
bound is ≈ 0.018 ms, operations; one request's 418 frames are latency. The
kernel does a 512-point complex FFT per frame in registers and shared memory
(one warp a frame, three radix-8 passes, the real split, f32 throughout; TF32
is ruled out by the digits the transform needs), then |X| and the 16 band sums
in a fixed order. On an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``
phase 10, PERF.md §6) it takes 0.097 ms of device time for a chunk of 64
loops (18 % of the bound) and 0.0077 ms for one request, against 0.386 and
0.030 ms for the library route from the same waveform (framing,
``torch.fft.rfft``, abs, one matmul). The first version formed the DFT as two
dense products like the TPU kernel (56.5 GFLOP at N = 26,752) and took 2.04
and 0.078 ms there.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises — it never gives way to the plain version. Every launch
adds one to ``KERNEL.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build

N_FFT = 1024   # the kernel's transform length
N_BANDS = 16   # the kernel's filterbank width


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


@functools.lru_cache(maxsize=4)
def twiddle_table(n_fft: int) -> np.ndarray:
    """The kernel's twiddles ``exp(−2πi·m/n_fft)``, ``m < n_fft``, as
    ``(n_fft, 2)`` float32 (real, imaginary): f64 angles, one cast."""
    angle = -2.0 * math.pi * np.arange(n_fft) / n_fft
    table = np.stack([np.cos(angle), np.sin(angle)], axis=1).astype(np.float32)
    table.setflags(write=False)
    return table


@functools.lru_cache(maxsize=8)
def _twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(twiddle_table(n_fft))).to(device)


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


def n_frames(length: int, hop: int, n_fft: int) -> int:
    """Frames of a waveform of ``length`` samples, centre-padded by
    ``n_fft // 2`` on both sides."""
    return 1 + (length + 2 * (n_fft // 2) - n_fft) // hop


def band_energies_from_audio_plain(y: torch.Tensor, fb_t: torch.Tensor, window: torch.Tensor,
                                   hop: int, n_fft: int) -> torch.Tensor:
    """:func:`band_energies_from_audio` in plain PyTorch: the centre-padded
    (reflect), windowed frames materialised (``ops/mso.py::_windowed_frames``
    at ``win_length == n_fft``), then :func:`band_energies_plain`;
    ``(M, F, 16)``."""
    from .mso import _reflect_pad

    frames = _reflect_pad(y, n_fft // 2).unfold(-1, n_fft, hop) * window
    m, f = frames.shape[0], frames.shape[1]
    return band_energies_plain(frames.reshape(m * f, n_fft), fb_t).reshape(m, f, -1)


def check_audio_args(y: torch.Tensor, fb_t: torch.Tensor, window: torch.Tensor,
                     hop: int, n_fft: int) -> None:
    """Raise ``ValueError`` on a waveform, filterbank, window or framing that
    the kernel does not take (the device is checked by the wrapper)."""
    if any(t.dtype != torch.float32 for t in (y, fb_t, window)):
        raise ValueError(f"band_energies kernel takes float32 samples, filterbank and window; "
                         f"got {y.dtype}, {fb_t.dtype}, {window.dtype}")
    if n_fft != N_FFT or window.shape != (N_FFT,) or not window.is_contiguous():
        raise ValueError(f"band_energies kernel takes n_fft {N_FFT} and a contiguous ({N_FFT},) "
                         f"window; got n_fft {n_fft}, window {tuple(window.shape)}")
    if y.dim() != 2 or not y.is_contiguous() or y.shape[0] < 1:
        raise ValueError(f"band_energies kernel takes contiguous samples (M ≥ 1, L); got "
                         f"{tuple(y.shape)}")
    if y.shape[1] <= n_fft // 2 or not 1 <= hop:
        raise ValueError(f"band_energies kernel reflects n_fft // 2 = {n_fft // 2} samples at "
                         f"each end and needs L > {n_fft // 2} and hop ≥ 1; got L {y.shape[1]}, "
                         f"hop {hop}")
    if y.shape[0] * n_frames(y.shape[1], hop, n_fft) >= 2 ** 31 or y.shape[1] >= 2 ** 31:
        raise ValueError(f"band_energies kernel takes fewer than 2**31 frames and samples a row; "
                         f"got {tuple(y.shape)}")
    if fb_t.dim() != 2 or fb_t.shape[1] != N_BANDS or fb_t.shape[0] < n_fft // 2:
        raise ValueError(f"band_energies kernel takes fb_t with ≥ n_fft // 2 rows and "
                         f"{N_BANDS} columns; got {tuple(fb_t.shape)}")
    _check_filterbank_layout(fb_t)


def _check_filterbank_layout(fb_t: torch.Tensor) -> None:
    if not fb_t.is_contiguous() or fb_t.data_ptr() % 16:
        raise ValueError("band_energies kernel takes a contiguous, 16-byte aligned fb_t")


def check_kernel_args(frames: torch.Tensor, fb_t: torch.Tensor) -> None:
    """Raise ``ValueError`` on frames or a filterbank that the frames entry
    does not take."""
    if frames.dtype != torch.float32 or fb_t.dtype != torch.float32:
        raise ValueError(f"band_energies kernel takes float32 frames and filterbank; got "
                         f"{frames.dtype}, {fb_t.dtype}")
    if frames.dim() != 2 or fb_t.dim() != 2:
        raise ValueError(f"band_energies kernel takes frames (N, n_fft) and fb_t "
                         f"(n_fft // 2 + 1, {N_BANDS}); got {tuple(frames.shape)}, "
                         f"{tuple(fb_t.shape)}")
    n, n_fft = frames.shape
    if n < 1 or n_fft != N_FFT or fb_t.shape[1] != N_BANDS or fb_t.shape[0] < n_fft // 2:
        raise ValueError(f"band_energies kernel takes N ≥ 1 frames of n_fft {N_FFT} and fb_t "
                         f"with ≥ n_fft // 2 rows and {N_BANDS} columns; got frames "
                         f"{tuple(frames.shape)}, fb_t {tuple(fb_t.shape)}")
    _check_filterbank_layout(fb_t)
    if not frames.is_contiguous() or n * n_fft >= 2 ** 31:
        raise ValueError(f"band_energies kernel takes contiguous frames of fewer than 2**31 "
                         f"samples; got {tuple(frames.shape)}")


@functools.cache
def _library():
    lib = _build.load_library("band_energies")
    lib.tgi_band_energies.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.tgi_band_energies.restype = ctypes.c_int
    lib.tgi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tgi_cuda_error_string.restype = ctypes.c_char_p
    return lib


KERNEL = _build.CountedKernel(_library, "tgi_band_energies", "tgi_cuda_error_string")


def _launch(y, window, fb_t, items, length, frames_per_item, hop, pad) -> torch.Tensor:
    out = torch.empty((items * frames_per_item, N_BANDS), dtype=torch.float32, device=y.device)
    KERNEL.launch((y, window, fb_t, _twiddles(N_FFT, y.device), out),
                  (items, length, frames_per_item, hop, pad), y.device)
    return out


def band_energies_from_audio(y: torch.Tensor, fb_t: torch.Tensor, window: torch.Tensor,
                             hop: int, n_fft: int) -> torch.Tensor:
    """Waveforms ``(M, L)`` → band energies ``(M, F, 16)`` of their centre-padded
    (reflect), windowed frames, ``F = 1 + L // hop``; Nyquist bin dropped.

    CUDA tensors go through the kernel, framing included; CPU tensors through
    :func:`band_energies_from_audio_plain`. No gradient: the result is a
    model input."""
    if y.device.type == fb_t.device.type == window.device.type == "cpu":
        return band_energies_from_audio_plain(y, fb_t, window, hop, n_fft)
    if not (y.device == fb_t.device == window.device) or y.device.type != "cuda":
        raise ValueError(f"band_energies kernel needs samples, fb_t and window on one CUDA "
                         f"device; got {y.device}, {fb_t.device}, {window.device}")
    check_audio_args(y, fb_t, window, hop, n_fft)
    m, length = y.shape
    f = n_frames(length, hop, n_fft)
    return _launch(y, window, fb_t, m, length, f, hop, n_fft // 2).view(m, f, N_BANDS)


def band_energies(frames: torch.Tensor, fb_t: torch.Tensor) -> torch.Tensor:
    """Windowed frames ``(N, n_fft)`` × filterbankᵀ ``(n_fft // 2 + 1, 16)`` →
    band energies ``(N, 16)``; |DFT| + projection, Nyquist bin dropped.

    CUDA tensors go through the kernel (hop = n_fft, no padding, no window);
    CPU tensors through :func:`band_energies_plain`. No gradient."""
    if frames.device.type == fb_t.device.type == "cpu":
        return band_energies_plain(frames, fb_t)
    if frames.device != fb_t.device or frames.device.type != "cuda":
        raise ValueError(f"band_energies kernel needs frames and fb_t on one CUDA device; got "
                         f"{frames.device}, {fb_t.device}")
    check_kernel_args(frames, fb_t)
    n, n_fft = frames.shape
    return _launch(frames, None, fb_t, 1, n * n_fft, n, n_fft, 0)
