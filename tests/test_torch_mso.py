"""The port's MSO DSP (``ops/mso.py``, ``ops/band_energies.py``) against the
JAX package's on the same arrays, and against the independent numpy oracle
(``tests/mso_oracle.py``) as ``tests/test_mso_oracle.py`` holds the JAX code.

Bars. The JAX tests hold the device route to the host route at
``atol 2e-5·max|ref|, rtol 1e-3``; the port's stages agree with the JAX stages
far inside that on the CPU (both f32, pocketfft against XLA's FFT, sums in
another order), so each test states the tighter bar that held."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mso_oracle import (
    band_project_loop, flux_mean_threshold_loop, grid_pool_loop, stft_mag_loop,
)
from transformergrooveinfilling_tpu.data.synthetic import synthetic_gmd_sequences
from transformergrooveinfilling_tpu.ops import mso as J
from transformergrooveinfilling_tpu.ops.mso_pallas import (
    band_energies_pallas, band_energies_reference,
)
from transformergrooveinfilling_tpu_torch.audio.synth import synthesize_hvo_batch
from transformergrooveinfilling_tpu_torch.ops import band_energies as BE
from transformergrooveinfilling_tpu_torch.ops import mso as M

P, JP = M.MSOParams(), J.MSOParams()
TEMPOS = (60.0, 97.0, 120.0, 150.0, 200.0)


@pytest.fixture(scope="module")
def renders():
    """Three kit renders at three tempos, peak-normalised, ``(3, 60000)``."""
    hvo = np.stack([s.hvo for s in synthetic_gmd_sequences(3, seed=9)]).astype(np.float32)
    y = synthesize_hvo_batch(hvo, [120.0, 90.0, 150.0], [None] * 3, fixed_length=60000)
    return (y / np.abs(y).max(axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def noise():
    return np.random.default_rng(5).standard_normal((2, 30000)).astype(np.float32)


def close(got, want, rel, rtol=0.0):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * np.abs(want).max(), rtol=rtol)


# ------------------------------------------------------------ exact parts

def test_params_filterbank_and_window_equal_jax():
    assert {f: getattr(P, f) for f in P.__dataclass_fields__} == \
        {f: getattr(JP, f) for f in JP.__dataclass_fields__}
    fb = M.log_frequency_filterbank(P)
    assert fb.shape == (16, 513) and fb.dtype == np.float32
    np.testing.assert_array_equal(fb, J.log_frequency_filterbank(JP))
    # the window: f32 cosines from two libraries
    np.testing.assert_allclose(M.hann_window(1024).numpy(), np.asarray(J.hann_window(1024)),
                               atol=2e-7)


@pytest.mark.parametrize("qpm", [60.0, 61.5, 90.0, 120.0, 133.3, 200.0])
def test_waveform_length_equals_jax(qpm):
    for n_steps in (16, 32):
        assert M.mso_waveform_length(n_steps, qpm / 15.0, P) == \
            J.mso_waveform_length(n_steps, qpm / 15.0, JP)
    assert M.mso_waveform_length(32, 8.0, P) == 183898  # 120 bpm: 418 frames


# ------------------------------------------------------------ stages

@pytest.mark.parametrize("source", ["noise", "renders"])
def test_stft_magnitude_matches_jax(source, noise, renders):
    y = noise if source == "noise" else renders
    got = M.stft_magnitude(torch.from_numpy(y), P)
    want = J.stft_magnitude(jnp.asarray(y), JP)
    assert got.shape == want.shape and got.dtype == torch.float32
    close(got, want, 2e-6)  # two f32 FFTs


@pytest.mark.parametrize("source", ["noise", "renders"])
def test_stft_magnitude_conv_matches_jax_and_fft(source, noise, renders):
    y = noise if source == "noise" else renders
    got = M.stft_magnitude_conv(torch.from_numpy(y), P)
    close(got, J.stft_magnitude_conv(jnp.asarray(y), JP), 2e-6)  # f32 sums of 1024 terms
    close(got, M.stft_magnitude(torch.from_numpy(y), P), 5e-6)
    # leading dims are kept
    assert M.stft_magnitude_conv(torch.from_numpy(y)[None], P).shape == (1,) + got.shape


@pytest.mark.parametrize("compression", ["log1p", "db"])
def test_flux_from_bands_matches_jax(rng, compression):
    bands = (rng.random((3, 120, 16)) ** 3 * 40).astype(np.float32)
    p, jp = M.MSOParams(compression=compression), J.MSOParams(compression=compression)
    got = M._flux_from_bands(torch.from_numpy(bands), p)
    want = J._flux_from_bands(jnp.asarray(bands), jp)
    # the moving average is a difference of f32 running sums: the error
    # scales with the running sum (here up to ~1e3 for log1p, ~1e4 dB), not
    # with the flux; sequential sums on both sides keep it near one rounding
    level = np.log1p(10 * bands) if compression == "log1p" else np.full_like(bands, 80.0)
    running = np.cumsum(level, axis=1).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=8 * np.finfo(np.float32).eps * running / 22 + 1e-6)
    np.testing.assert_array_equal(
        M._flux_from_bands(torch.from_numpy(bands[0]), p).numpy(), got[0].numpy())  # any rank
    with pytest.raises(ValueError, match="compression"):
        M._flux_from_bands(torch.from_numpy(bands), M.MSOParams(compression="sqrt"))


def test_grid_pool_matches_jax_exactly(rng):
    flux = rng.random((len(TEMPOS), 418, 16)).astype(np.float32)
    sps = np.asarray(TEMPOS, np.float32) / 15.0
    got = M.grid_pool(torch.from_numpy(flux), torch.from_numpy(sps), 32, P)
    want = J.grid_pool(jnp.asarray(flux), jnp.asarray(sps), 32, JP)
    assert got.shape == (len(TEMPOS), 32, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grid_step_ties_between_60_and_200_bpm():
    """``frame_time · sps`` lands exactly on a half step for 59 of the integer
    tempos 60–200 (f · qpm = 1500·n + 750, e.g. frame 5 at 150 bpm), and in
    f32 some of those products fall just off the half. Both packages form the
    product in f32 with one multiply and round half to even, so the port's
    step of every frame equals JAX's at every tempo; where f32 leaves the
    exact-arithmetic step is pinned."""
    from fractions import Fraction

    frames = 900
    ramp = np.broadcast_to(np.arange(1, frames + 1, dtype=np.float32)[:, None], (frames, 1))
    ties, off_exact = [], []
    for qpm in range(60, 201):
        sps = np.asarray([qpm / 15.0], np.float32)
        got = M.grid_pool(torch.from_numpy(ramp.copy())[None], torch.from_numpy(sps), 32, P)
        want = J.grid_pool(jnp.asarray(ramp)[None], jnp.asarray(sps), 32, JP)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{qpm} bpm")
        exact = [Fraction(f * qpm, 1500) for f in range(frames)]
        if any(x % 1 == Fraction(1, 2) and x < 32 for x in exact):
            ties.append(qpm)
        # the pooled ramp names the last frame of each step: compare with the
        # exact-arithmetic assignment (Python rounds Fractions half to even)
        last = {}
        for f, x in enumerate(exact):
            if round(x) < 32:
                last[round(x)] = f + 1
        if [last.get(s, 0) for s in range(32)] != got[0, :, 0].tolist():
            off_exact.append(qpm)
    assert len(ties) == 59 and {75, 90, 150, 175} <= set(ties) and 120 not in ties
    assert off_exact == [63, 70, 75, 125, 126, 150]


# ------------------------------------------------------------ band energies

def test_band_energies_plain_matches_pallas_interpret_and_rfft(rng):
    fb_t = M.log_frequency_filterbank(P).T.copy()
    frames = rng.standard_normal((200, P.n_fft)).astype(np.float32)
    got = BE.band_energies(torch.from_numpy(frames), torch.from_numpy(fb_t))  # CPU: plain
    assert got.shape == (200, 16) and got.dtype == torch.float32
    pallas = band_energies_pallas(jnp.asarray(frames), jnp.asarray(fb_t), interpret=True)
    # the same two products, magnitude and projection, Nyquist dropped in both
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-5, atol=2e-5)
    # against the rFFT, which keeps the Nyquist bin: the JAX test's own bar
    ref = band_energies_reference(jnp.asarray(frames), jnp.asarray(fb_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    before = BE.KERNEL.launches
    BE.band_energies(torch.from_numpy(frames), torch.from_numpy(fb_t))
    assert BE.KERNEL.launches == before  # the plain version is no launch


def test_band_energies_basis_and_split():
    cos_b, sin_b = BE.dft_basis(1024, torch.device("cpu"))
    assert cos_b.shape == sin_b.shape == (1024, 512)  # Nyquist dropped
    from transformergrooveinfilling_tpu.ops.mso_pallas import _dft_basis

    np.testing.assert_array_equal(cos_b.numpy(), _dft_basis(1024)[0])
    np.testing.assert_array_equal(sin_b.numpy(), _dft_basis(1024)[1])
    # the kernel's FFT twiddles exp(-2πi·m/1024): f64 angles, one cast to f32
    tw = BE.twiddle_table(1024)
    assert tw.shape == (1024, 2) and tw.dtype == np.float32
    w = np.exp(-2j * np.pi * np.arange(1024, dtype=np.float64) / 1024)
    np.testing.assert_array_equal(tw[:, 0], w.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], w.imag.astype(np.float32))
    # and the split step's twiddles are the DFT basis's first row of bins
    np.testing.assert_array_equal(tw[:512, 0], _dft_basis(1024)[0][1])
    np.testing.assert_array_equal(tw[:512, 1], _dft_basis(1024)[1][1])


def test_band_energies_kernel_argument_checks():
    frames, fb_t = torch.zeros(4, 1024), torch.zeros(513, 16)
    BE.check_kernel_args(frames, fb_t)
    for bad_frames, bad_fb in ((frames.double(), fb_t), (frames[:, :1000], fb_t),
                               (frames, fb_t[:, :8]), (frames, fb_t[:100]),
                               (frames[None], fb_t), (frames.T.contiguous().T, fb_t)):
        with pytest.raises(ValueError):
            BE.check_kernel_args(bad_frames, bad_fb)


@pytest.mark.parametrize("qpm", [90.0, 120.0, 150.0])
def test_band_energies_from_audio_plain_matches_pallas_on_jax_frames(renders, qpm):
    """The waveform entry's plain path (framing by ``_reflect_pad`` + unfold
    on the CPU) against the JAX kernel in interpret mode on frames the JAX
    package cut itself, at the length of one request at three tempos."""
    length = M.mso_waveform_length(32, qpm / 15.0, P)
    y = np.resize(renders[1], (2, length)).astype(np.float32)
    y[1] = y[1, ::-1]
    fb_t = M.log_frequency_filterbank(P).T.copy()
    got = BE.band_energies_from_audio(torch.from_numpy(y), torch.from_numpy(fb_t),
                                      M.hann_window(P.n_fft), P.hop_length, P.n_fft)
    n = BE.n_frames(length, P.hop_length, P.n_fft)
    assert got.shape == (2, n, 16) and n == 1 + length // P.hop_length
    frames = J._windowed_frames(jnp.asarray(y), JP)
    assert frames.shape == (2, n, P.n_fft)
    want = band_energies_pallas(frames.reshape(-1, P.n_fft), jnp.asarray(fb_t), interpret=True)
    close(got.reshape(-1, 16), want, 1e-5, rtol=1e-4)
    # the plain version of the frames entry on the port's own frames: the same
    # products on the same values
    frames_port = M._windowed_frames(torch.from_numpy(y), P).reshape(-1, P.n_fft)
    assert torch.equal(got.reshape(-1, 16), BE.band_energies(frames_port, torch.from_numpy(fb_t)))


def test_band_energies_from_audio_argument_checks():
    y, fb_t, win = torch.zeros(2, 5000), torch.zeros(513, 16), torch.zeros(1024)
    BE.check_audio_args(y, fb_t, win, 441, 1024)
    for bad in ((y.double(), fb_t, win, 441, 1024), (y, fb_t, win[:1000], 441, 1024),
                (y, fb_t, win, 441, 2048), (y[:, :512].contiguous(), fb_t, win, 441, 1024),
                (y.T.contiguous().T, fb_t, win, 441, 1024), (y, fb_t[:, :8], win, 441, 1024),
                (y, fb_t[:500], win, 441, 1024), (y[0], fb_t, win, 441, 1024),
                (y, fb_t, win, 0, 1024)):
        with pytest.raises(ValueError):
            BE.check_audio_args(*bad)


# ------------------------------------------------------------ mso_batch

@pytest.mark.parametrize("method", ["fft", "conv", "fused"])
@pytest.mark.parametrize("source", ["noise", "renders"])
def test_mso_batch_matches_jax(method, source, noise, renders):
    y = noise if source == "noise" else renders
    sps = np.asarray([8.0, 6.0, 10.0][: len(y)], np.float32)
    got = M.mso_batch(torch.from_numpy(y), torch.from_numpy(sps), 32, P, method=method)
    want = J.mso_batch(jnp.asarray(y), jnp.asarray(sps), 32, JP,
                       method="pallas" if method == "fused" else method)
    assert got.shape == (len(y), 32, 16)
    close(got, want, 1e-5, rtol=1e-4)  # the JAX tests' bar is 2e-5 and 1e-3
    # the methods agree with one another at that bar too (Nyquist bin or not)
    close(got, M.mso_batch(torch.from_numpy(y), torch.from_numpy(sps), 32, P, method="fft"),
          2e-5, rtol=1e-3)


def test_mso_batch_method_resolution(noise):
    dev, cuda = torch.device("cpu"), torch.device("cuda")
    assert M.resolve_method(None, None, dev) == "fft"
    assert M.resolve_method(None, None, cuda) == "fused"  # the kernel, not cuFFT
    assert M.resolve_method(None, True, dev) == M.resolve_method("pallas", None, dev) == "fused"
    assert M.resolve_method(None, False, cuda) == "fft"
    assert M.resolve_method("conv", True, cuda) == "conv"
    with pytest.raises(ValueError, match="method"):
        M.resolve_method("dct", None, dev)
    y, sps = torch.from_numpy(noise), torch.tensor([8.0, 8.0])
    a = M.mso_batch(y, sps, 32, P)
    assert torch.equal(a, M.mso_batch(y, sps, 32, P, use_pallas=False))
    assert torch.equal(M.mso_batch(y, sps, 32, P, use_pallas=True),
                       M.mso_batch(y, sps, 32, P, method="pallas"))


def test_mso_from_audio_matches_jax_and_defaults_to_cuda(renders, monkeypatch):
    got = M.mso_from_audio(renders[0], 32, 120.0, device="cpu")
    want = J.mso_from_audio(renders[0], 32, 120.0)
    assert got.shape == (32, 16)
    close(got, want, 1e-5, rtol=1e-4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.mso_from_audio(renders[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.mso_batch_from_hvo(np.zeros((1, 32, 27), np.float32), None, [120.0])


# ------------------------------------------------------------ the numpy oracle

def test_stft_matches_loop_oracle(renders):
    ours = M.stft_magnitude(torch.from_numpy(renders[:1]), P)[0].numpy()
    oracle = stft_mag_loop(renders[0], P.n_fft, P.win_length, P.hop_length)
    assert ours.shape == oracle.shape
    np.testing.assert_allclose(ours, oracle, atol=2e-4 * oracle.max())


def test_band_projection_and_flux_match_loop_oracle(renders):
    fb = M.log_frequency_filterbank(P)
    mag = stft_mag_loop(renders[0], P.n_fft, P.win_length, P.hop_length)
    bands = band_project_loop(mag, fb)
    ours = (torch.from_numpy(mag) @ torch.from_numpy(fb.copy()).T).numpy()
    np.testing.assert_allclose(ours, bands, atol=1e-5 * bands.max())
    flux = M._flux_from_bands(torch.from_numpy(bands), P).numpy()
    oracle = flux_mean_threshold_loop(bands, P.mean_filter_size)
    # a difference of f32 running sums against an f64 window mean: bounded by
    # the running sum's rounding (tests/test_mso_oracle.py has the derivation)
    c_max = float(np.abs(np.cumsum(np.log1p(10.0 * bands), axis=0)).max())
    tol = 96 * np.finfo(np.float32).eps * c_max / P.mean_filter_size + 1e-6
    np.testing.assert_allclose(flux, oracle, atol=tol)


@pytest.mark.parametrize("qpm", [90.0, 120.0, 150.0])
def test_grid_pool_matches_loop_oracle(renders, qpm):
    fb = M.log_frequency_filterbank(P)
    bands = band_project_loop(stft_mag_loop(renders[0], P.n_fft, P.win_length, P.hop_length), fb)
    flux = flux_mean_threshold_loop(bands, P.mean_filter_size)
    sps = qpm / 15.0
    ours = M.grid_pool(torch.from_numpy(flux)[None], torch.tensor([sps]), 32, P)[0].numpy()
    oracle = grid_pool_loop(flux, sps, 32, P.sr, P.hop_length)
    # 150 bpm ties at frames 5, 15, 25, ...: the oracle's f64 products and the
    # port's f32 products round these the same way within this render
    np.testing.assert_allclose(ours, oracle, atol=1e-6)


@pytest.mark.parametrize("method", ["fft", "conv", "fused"])
def test_end_to_end_matches_composed_oracle(renders, method):
    """mso_batch == the four loop stages composed (the shipped formula)."""
    fb = M.log_frequency_filterbank(P)
    mag = stft_mag_loop(renders[0], P.n_fft, P.win_length, P.hop_length)
    flux = flux_mean_threshold_loop(band_project_loop(mag, fb), P.mean_filter_size)
    oracle = grid_pool_loop(flux, 8.0, 32, P.sr, P.hop_length)
    ours = M.mso_batch(torch.from_numpy(renders[:1]), torch.tensor([8.0]), 32, P,
                       method=method)[0].numpy()
    np.testing.assert_allclose(ours, oracle, atol=3e-4 * oracle.max())
