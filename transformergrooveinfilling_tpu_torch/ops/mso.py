"""MSO — Multiband Synthesized Onsets — the audio models' input, as the JAX
package's ``ops/mso.py``.

A ``(T=32, 16)`` matrix of onset strengths in 16 log-spaced frequency bands,
aligned to the 16th-note grid (sr 44100, n_fft 1024, win 1024, hop 441 = 10 ms,
centres log-spaced over 9 octaves from 40 Hz, mean filter 22):

    frames → Hann window → |DFT|
    → triangular log-frequency filterbank
    → log compression → spectral flux against a moving-average adaptive
      threshold (a plain f32 cumulative sum over ``mean_filter_size`` frames)
    → max-pool onto the T-step grid (per-item tempo)

Which method computes the band energies (:func:`mso_batch`):

- ``"fused"`` (alias ``"pallas"``, ``use_pallas=True``): the peak-normalised
  waveform through ``ops/band_energies.py::band_energies_from_audio`` — the
  hand-written CUDA kernel on a CUDA tensor, which frames, windows and
  transforms inside the kernel (no frame tensor is materialised); the plain
  version (framed, two dense DFT products) on a CPU tensor. The default on a
  CUDA tensor. Needs ``win_length == n_fft``.
- ``"fft"``: ``torch.fft.rfft`` over the frames (cuFFT on the card). The
  default on a CPU tensor.
- ``"conv"``: framing + DFT as one strided ``conv1d``.

The JAX package picks ``"conv"`` on a TPU because an rFFT is poor there; that
is no fact about an H100, where all three are timed side by side
(``chip_smoke.py`` phase 11, PERF.md §5): grids → MSO for 512 loops at 120 bpm
on an NVIDIA H100 80GB HBM3 at 700 W runs at 36,000–110,400 loops/s by
``"fused"``, 23,600–78,900 by ``"fft"`` and 20,300–24,100 by ``"conv"``
(chunks of 64 to 256; the kernel route at least as fast at every chunk size).
``"fft"`` keeps the Nyquist bin, ``"fused"`` drops it (as the TPU kernel
does); the filterbank has almost no weight there.

Precision: the DFT sums 1,024 nearly cancelling terms, so no route may run in
TF32. ``"conv"`` switches cuDNN's TF32 off for its call; the plain products of
``"fused"`` need ``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's
default), and the kernel's FFT is plain f32 arithmetic.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import require_device


@dataclasses.dataclass(frozen=True)
class MSOParams:
    sr: int = 44100
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 441
    n_bins_per_octave: int = 16
    n_octaves: int = 9
    f_min: float = 40.0
    mean_filter_size: int = 22
    n_bands: int = 16  # output width == embedding_size_src
    # band-energy compression law before the flux:
    # "log1p" — log1p(10·E);
    # "db"    — librosa-style power-dB (10·log10(E²/peak), top_db 80)
    compression: str = "log1p"


def hann_window(n: int, device=None) -> torch.Tensor:
    """Periodic Hann window, in f32 as the JAX package computes it."""
    return 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(n, dtype=torch.float32,
                                                            device=device) / n)


@functools.lru_cache(maxsize=8)
def _window(n: int, device: torch.device) -> torch.Tensor:
    """:func:`hann_window` resident on ``device``."""
    return hann_window(n, device)


@functools.lru_cache(maxsize=8)
def log_frequency_filterbank(params: MSOParams) -> np.ndarray:
    """``(n_bands, n_fft//2+1)`` triangular filters, centres log-spaced over
    ``[f_min, f_min·2^n_octaves]`` (numpy, read-only, cached)."""
    n_bins = params.n_fft // 2 + 1
    fft_freqs = np.linspace(0, params.sr / 2, n_bins)
    centers_log = np.linspace(np.log2(params.f_min), np.log2(params.f_min) + params.n_octaves,
                              params.n_bands)
    centers = 2.0 ** centers_log
    # triangular edges at neighbouring centres (extended at the extremes)
    edges = np.concatenate(
        [[centers[0] / 2 ** (params.n_octaves / params.n_bands)], centers,
         [min(centers[-1] * 2 ** (params.n_octaves / params.n_bands), params.sr / 2)]])
    fb = np.zeros((params.n_bands, n_bins), dtype=np.float32)
    for b in range(params.n_bands):
        lo, c, hi = edges[b], edges[b + 1], edges[b + 2]
        up = (fft_freqs - lo) / max(c - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - c, 1e-9)
        fb[b] = np.clip(np.minimum(up, down), 0, None)
    # normalise each filter to unit area so band energies are comparable
    fb /= np.maximum(fb.sum(axis=1, keepdims=True), 1e-9)
    fb.setflags(write=False)
    return fb


@functools.lru_cache(maxsize=8)
def _filterbank(params: MSOParams, device: torch.device):
    """The filterbank ``(n_bands, K)`` and its contiguous transpose on ``device``."""
    fb = torch.from_numpy(np.array(log_frequency_filterbank(params))).to(device)
    return fb, fb.T.contiguous()


def _reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis (any rank) by ``pad`` on both sides."""
    left = y[..., 1:pad + 1].flip(-1)
    right = y[..., -pad - 1:-1].flip(-1)
    return torch.cat([left, y, right], dim=-1)


def _windowed_frames(y: torch.Tensor, params: MSOParams) -> torch.Tensor:
    """Centre-padded, Hann-windowed frames ``(..., F, n_fft)``."""
    y = _reflect_pad(y, params.n_fft // 2)
    frames = y.unfold(-1, params.win_length, params.hop_length)
    frames = frames * hann_window(params.win_length, y.device)
    if params.win_length < params.n_fft:
        frames = F.pad(frames, (0, params.n_fft - params.win_length))
    return frames


def stft_magnitude(y: torch.Tensor, params: MSOParams) -> torch.Tensor:
    """Centre-padded magnitude STFT: ``(..., L)`` → ``(..., F, n_fft//2+1)``."""
    return torch.fft.rfft(_windowed_frames(y, params), dim=-1).abs().to(torch.float32)


@functools.lru_cache(maxsize=8)
def _conv_kernel(params: MSOParams, device: torch.device) -> torch.Tensor:
    n_bins = params.n_fft // 2 + 1
    k = np.arange(n_bins)
    n = np.arange(params.n_fft)
    ang = 2.0 * np.pi * np.outer(n, k) / params.n_fft
    win = np.asarray(0.5 - 0.5 * np.cos(2 * np.pi * n / params.win_length), np.float32)[:, None]
    kern = np.concatenate([np.cos(ang) * win, -np.sin(ang) * win], axis=1).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(kern.T)[:, None, :]).to(device)  # (2K, 1, n_fft)


def stft_magnitude_conv(y: torch.Tensor, params: MSOParams) -> torch.Tensor:
    """Magnitude STFT as one strided convolution: the Hann window and the
    real/imaginary DFT bases folded into a ``(2·(n_fft/2+1), 1, n_fft)``
    kernel, stride ``hop_length``, so no frame tensor is materialised. Full
    f32: cuDNN's TF32 is switched off for the call."""
    if params.win_length != params.n_fft:
        raise ValueError("the conv method folds the window into the DFT kernel and needs "
                         "win_length == n_fft")
    lead = y.shape[:-1]
    y = _reflect_pad(y.reshape(-1, y.shape[-1]), params.n_fft // 2)
    n_bins = params.n_fft // 2 + 1
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out = F.conv1d(y[:, None, :], _conv_kernel(params, y.device),
                       stride=params.hop_length)  # (M, 2K, F)
    re, im = out[:, :n_bins, :], out[:, n_bins:, :]
    mag = torch.sqrt(re * re + im * im).transpose(-1, -2).to(torch.float32)  # (M, F, K)
    return mag.reshape(lead + mag.shape[1:])


def _flux_from_bands(bands: torch.Tensor, params: MSOParams) -> torch.Tensor:
    """Band-energy compression + moving-average adaptive-threshold flux."""
    if params.compression == "db":
        # librosa power_to_db: per-item peak-referenced log-power, floored
        # 80 dB below the peak
        ref = torch.square(bands).clamp_min(1e-10)
        peak = ref.amax(dim=(-2, -1), keepdim=True)
        s = (10.0 * torch.log10(ref / peak)).clamp_min(-80.0)
    elif params.compression == "log1p":
        s = torch.log1p(10.0 * bands)
    else:
        raise ValueError(f"unknown MSO compression {params.compression!r}; "
                         "expected 'log1p' or 'db'")
    # centred moving average over mean_filter_size frames: a plain f32
    # cumulative sum over the edge-padded frames, differenced
    k = params.mean_filter_size
    head = s[..., :1, :].expand(s.shape[:-2] + (k // 2, s.shape[-1]))
    tail = s[..., -1:, :].expand(s.shape[:-2] + (k - 1 - k // 2, s.shape[-1]))
    c = torch.cumsum(torch.cat([head, s, tail], dim=-2), dim=-2)
    c = torch.cat([torch.zeros_like(c[..., :1, :]), c], dim=-2)
    local_mean = (c[..., k:, :] - c[..., :-k, :]) / k
    return (s - local_mean).clamp_min(0.0)


def grid_pool(flux: torch.Tensor, steps_per_sec: torch.Tensor, n_steps: int,
              params: MSOParams) -> torch.Tensor:
    """Max-pool frame-level onset strengths onto the nearest grid step:
    ``(..., F, B)`` → ``(..., n_steps, B)``; ``steps_per_sec`` broadcasts over
    batch dims (tempo-dependent). The step of a frame is
    ``round(frame_time · steps_per_sec)`` in f32, half to even."""
    n_frames = flux.shape[-2]
    frame_times = torch.arange(n_frames, dtype=torch.float32, device=flux.device) * (
        params.hop_length / params.sr)
    sps = torch.as_tensor(steps_per_sec, dtype=torch.float32, device=flux.device)
    step_of_frame = torch.round(frame_times * sps[..., None]).to(torch.int64)  # (..., F)
    step_of_frame = step_of_frame.expand(flux.shape[:-1])
    # frames past the grid fall into one extra row, cut off below; the flux
    # is ≥ 0, so a maximum against the zeros equals a masked maximum
    index = step_of_frame.clamp(0, n_steps)[..., None].expand(flux.shape)
    out = torch.zeros(flux.shape[:-2] + (n_steps + 1, flux.shape[-1]), dtype=flux.dtype,
                      device=flux.device)
    out.scatter_reduce_(-2, index, flux, "amax", include_self=True)
    return out[..., :n_steps, :]


def resolve_method(method: str | None, use_pallas: bool | None, device: torch.device) -> str:
    """``mso_batch``'s method: ``"pallas"`` and ``use_pallas=True`` are
    aliases of ``"fused"``; ``use_pallas=False`` means ``"fft"``; None picks
    ``"fused"`` for a CUDA tensor and ``"fft"`` for a CPU tensor."""
    if method is None:
        if use_pallas is True:
            method = "fused"
        elif use_pallas is False:
            method = "fft"
        else:
            method = "fused" if device.type == "cuda" else "fft"
    if method == "pallas":
        method = "fused"
    if method not in ("fused", "fft", "conv"):
        raise ValueError(f"unknown MSO method {method!r}; expected 'fused', 'fft' or 'conv'")
    return method


@torch.no_grad()
def mso_batch(y: torch.Tensor, steps_per_sec, n_steps: int, params: MSOParams,
              use_pallas: bool | None = None, method: str | None = None) -> torch.Tensor:
    """Batched waveforms ``(M, L)`` (+ per-item grid rate) → ``(M, T, 16)``,
    on ``y``'s device; see the module docstring for ``method``."""
    method = resolve_method(method, use_pallas, y.device)
    peak = y.abs().amax(dim=-1, keepdim=True)
    y = y / peak.clamp_min(1e-9)
    fb, fb_t = _filterbank(params, y.device)
    if method == "fused":
        from .band_energies import band_energies_from_audio

        if params.win_length != params.n_fft:
            raise ValueError("the fused method frames inside the kernel and needs "
                             "win_length == n_fft")
        bands = band_energies_from_audio(y, fb_t, _window(params.n_fft, y.device),
                                         params.hop_length, params.n_fft)
    elif method == "conv":
        bands = stft_magnitude_conv(y, params) @ fb_t
    else:
        bands = stft_magnitude(y, params) @ fb_t
    flux = _flux_from_bands(bands, params)
    return grid_pool(flux, steps_per_sec, n_steps, params)


def mso_from_audio(y, n_steps: int = 32, qpm: float = 120.0, params: MSOParams = MSOParams(),
                   device="cuda") -> np.ndarray:
    """Single waveform → ``(n_steps, n_bands)`` numpy, computed on ``device``."""
    device = require_device(device, "mso_from_audio")
    sps = torch.tensor([(qpm / 60.0) * 4.0], dtype=torch.float32, device=device)
    wave = torch.as_tensor(np.asarray(y, np.float32), device=device)[None]
    return mso_batch(wave, sps, n_steps, params)[0].cpu().numpy()


def mso_waveform_length(n_steps: int, min_sps: float, params: MSOParams) -> int:
    """Shortest waveform whose MSO equals the ring-out-padded render's.

    The grid pool only reads frames whose rounded step index is < ``n_steps``
    (last frame time ≈ (n_steps-0.5)/sps), and the adaptive-threshold flux
    looks ``mean_filter_size/2`` frames ahead; everything past that margin
    would be mixed and transformed for nothing.
    """
    grid_frames = int(np.ceil((n_steps - 0.5) / min_sps * params.sr / params.hop_length))
    n_frames = grid_frames + params.mean_filter_size + 2
    return (n_frames - 1) * params.hop_length + 1


def mso_batch_from_hvo(hvos: np.ndarray, soundfonts, qpms, params: MSOParams = MSOParams(),
                       chunk_size: int | None = None, device_synth: bool | None = None,
                       device="cuda", method: str | None = None) -> np.ndarray:
    """Synthesize + MSO for a stacked HVO batch ``(M, T, 3V)`` → numpy
    ``(M, T, n_bands)``. Two routes:

    - ``device_synth`` (default on a CUDA ``device``): the whole front end
      runs on the device (``ops/device_synth.py``) — only grids go in.
    - host route (default on ``device="cpu"``): the numpy mixer renders each
      chunk on the host, and the DSP runs on ``device``.

    ``chunk_size`` (default ``ops.device_synth.DEFAULT_CHUNK``) bounds the
    memory of one call. ``device="cuda"`` without CUDA raises. Only the
    procedural kit is ported: a soundfont other than None raises
    ``NotPortedError``.
    """
    from .device_synth import DEFAULT_CHUNK, mso_batch_from_hvo_device

    device = require_device(device, "mso_batch_from_hvo")
    chunk_size = chunk_size or DEFAULT_CHUNK
    if device_synth is None:
        device_synth = device.type == "cuda"
    if device_synth:
        return mso_batch_from_hvo_device(hvos, soundfonts, qpms, params=params,
                                         chunk_size=chunk_size, device=device, method=method)
    from ..audio.synth import synthesize_hvo_batch

    hvos = np.asarray(hvos, np.float32)
    m, t = hvos.shape[0], hvos.shape[1]
    if m == 0:
        return np.zeros((0, t, params.n_bands), np.float32)
    qpms = np.asarray(qpms, np.float64)
    sfs = list(soundfonts) if soundfonts is not None else [None] * m
    # one fixed waveform length for the whole corpus
    fixed_length = mso_waveform_length(t, float((qpms.min() / 60.0) * 4.0), params)
    pending = []
    for start in range(0, m, chunk_size):
        end = min(start + chunk_size, m)
        waves = synthesize_hvo_batch(hvos[start:end], qpms[start:end], sfs[start:end],
                                     sr=params.sr, fixed_length=fixed_length)
        sps = ((qpms[start:end] / 60.0) * 4.0).astype(np.float32)
        # queued on the device while the host mixes the next chunk
        pending.append(mso_batch(torch.from_numpy(waves).to(device),
                                 torch.from_numpy(sps).to(device), t, params, method=method))
    return torch.cat(pending).cpu().numpy()
