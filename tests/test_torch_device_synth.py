"""The port's drum synthesis against the JAX package's: the procedural kit,
the packed table, event extraction, the plain synthesizer against the Pallas
kernel (interpret mode), the XLA scan and both host mixers, the whole front
end (grids → MSO) by both routes, the kernel's tile chooser and its C entry
point against its ctypes declaration."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transformergrooveinfilling_tpu.audio import drumkit as jax_drumkit
from transformergrooveinfilling_tpu.audio.synth import (
    synthesize_hvo_batch as jax_synthesize_hvo_batch,
    velocity_gain as jax_velocity_gain,
)
from transformergrooveinfilling_tpu.data.synthetic import synthetic_gmd_sequences
from transformergrooveinfilling_tpu.ops import device_synth as JD
from transformergrooveinfilling_tpu.ops import mso as JM
from transformergrooveinfilling_tpu_torch import NotPortedError
from transformergrooveinfilling_tpu_torch.audio import drumkit, synth
from transformergrooveinfilling_tpu_torch.ops import device_synth as D
from transformergrooveinfilling_tpu_torch.ops import mso as M

SR = 44100
QPMS = np.array([120.0, 90.0, 150.0, 60.0, 200.0, 133.3, 77.0, 120.0])


def corpus(n=8, seed=7):
    return np.stack([s.hvo for s in synthetic_gmd_sequences(n, seed=seed)]).astype(np.float32)


@pytest.fixture(scope="module")
def tables():
    return D.pack_tables([None], SR, device="cpu"), JD.pack_tables([None], SR)


def zeros(n):
    return torch.zeros(n, dtype=torch.int32)


def test_default_kit_equals_jax_bit_for_bit():
    ours, theirs = drumkit.default_kit(SR), jax_drumkit.default_kit(SR)
    assert len(ours) == len(theirs) == 9
    for a, b in zip(ours, theirs):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    flat, lut = drumkit.kit_layers(ours)
    jflat, jlut = jax_drumkit.kit_layers(theirs)
    np.testing.assert_array_equal(lut, jlut)
    assert len(flat) == len(jflat) == 9
    kit = drumkit.DrumKit(ours, ours[:2], np.zeros((9, 128)))
    assert drumkit.kit_layers(kit)[0] == list(ours[:2]) and kit[3] is ours[3]


def test_velocity_gain_and_tempo_helpers_equal_jax():
    v = np.arange(128)
    np.testing.assert_array_equal(synth.velocity_gain(v), jax_velocity_gain(v))
    assert synth.steps_per_second(120.0) == 8.0
    with pytest.raises(NotPortedError, match="SoundFont"):
        synth._sample_table("kit.sf2", SR)
    with pytest.raises(NotPortedError, match="SoundFont"):
        D.pack_tables(["kit.sf2"], SR, device="cpu")


def test_pack_tables_contents(tables):
    (table, base, luts, sf_index, lengths), (jtable, jbase, jluts, jindex) = tables
    kit = drumkit.default_kit(SR)
    assert base == jbase == {None: 0} and sf_index == jindex == {None: 0}
    # rows as long as the longest sample (the crash), not rounded up to 128
    assert table.shape == (9, max(len(s) for s in kit)) and table.dtype == torch.float32
    assert lengths.tolist() == [len(s) for s in kit] and lengths.dtype == torch.int32
    for row, s in zip(table.numpy(), kit):
        np.testing.assert_array_equal(row[: len(s)], s)
        assert not row[len(s):].any()
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable)[:, : table.shape[1]])
    np.testing.assert_array_equal(luts.numpy(), np.asarray(jluts))
    again = D.pack_tables([None], SR, device="cpu")
    assert again[0] is table and again[4] is lengths  # cached per (kits, sr, device)
    short = D.pack_tables([None], SR, s_max=1000, device="cpu")
    assert short[0].shape == (9, 1000) and short[4].max() == 1000


def test_pack_tables_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.pack_tables([None], SR)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.mso_batch_from_hvo_device(corpus(1), None, [120.0])


@pytest.mark.parametrize("with_luts", [True, False])
def test_extract_events_equals_jax(tables, with_luts):
    """Onsets (f32, truncated), rows and gains are the integers and floats the
    JAX device route computes, at eight tempos."""
    (_, _, luts, _, _), (_, _, jluts, _) = tables
    hvos = corpus()
    sps = (QPMS / 15.0).astype(np.float32)
    length = M.mso_waveform_length(32, float(sps.min()), M.MSOParams())
    base = np.array([0, 0, 9, 0, 0, 9, 0, 0], np.int32) * (0 if with_luts else 1)
    got = D._extract_events(torch.from_numpy(hvos), torch.from_numpy(sps),
                            torch.from_numpy(base), length, float(SR),
                            luts if with_luts else None, zeros(8) if with_luts else None)
    want = JD._extract_events(jnp.asarray(hvos), jnp.asarray(sps), jnp.asarray(base), length,
                              float(SR), jluts if with_luts else None,
                              jnp.zeros(8, jnp.int32) if with_luts else None)
    for g, w, dtype in zip(got, want, (torch.int32, torch.int32, torch.float32)):
        assert g.dtype == dtype and g.shape == (8, 288)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[2].numpy() > 0).sum() == (hvos[..., :9] > 0).sum()


def test_extract_events_clips_to_the_waveform(tables):
    hvo = np.zeros((1, 32, 27), np.float32)
    hvo[0, 31, 0] = hvo[0, 31, 9] = 1.0
    hvo[0, 0, 1], hvo[0, 0, 10], hvo[0, 0, 19] = 1.0, 0.5, -0.4  # before time 0
    onset, row, gain = D._extract_events(torch.from_numpy(hvo), torch.tensor([8.0]), zeros(1),
                                         1000, float(SR))
    assert onset[0, 31 * 9] == 999 and onset[0, 1] == 0
    assert row[0, 1] == 1 and gain[0, 31 * 9] == 1.0
    assert gain[0, 1] == np.float32(64 / 127) ** 2  # round(63.5) = 64: half to even


def random_events(rng, m=4, t=32, v=9, length=2000):
    """tests/test_device_synth.py's random events over an 18-row table."""
    h = (rng.random((m, t, v)) < 0.25).astype(np.float32)
    hvo = np.concatenate([h, h * rng.random((m, t, v)), (rng.random((m, t, v)) - 0.5) * h],
                         axis=2).astype(np.float32)
    table = rng.standard_normal((18, 256)).astype(np.float32)
    sps = np.full((m,), 8.0, np.float32)
    sfb = np.array([0, 9, 0, 9], np.int32)
    onset, row, vel = JD._extract_events(jnp.asarray(hvo), jnp.asarray(sps), jnp.asarray(sfb),
                                         length, 44100.0)
    return onset % (length - 1), row, vel, table


def test_plain_synth_matches_pallas_interpret_and_scan(rng):
    length = 2000
    onset, row, vel, table = random_events(rng, length=length)
    y_scan = np.asarray(JD._synth_scan(onset, row, vel, jnp.asarray(table), length))
    y_pallas = np.asarray(JD._synth_pallas(onset, row, vel, jnp.asarray(table), length,
                                           interpret=True))
    args = [torch.from_numpy(np.array(a)) for a in (onset, row, vel)]
    lengths = torch.full((18,), 256, dtype=torch.int32)
    before = D.KERNEL.launches
    got = D.synth_events(*args, torch.from_numpy(table), lengths, length).numpy()  # CPU: plain
    assert D.KERNEL.launches == before and got.shape == (4, length)
    # the JAX tests' bar between scan and kernel; XLA may fuse the multiply-add
    np.testing.assert_allclose(got, y_scan, atol=1e-5)
    np.testing.assert_allclose(got, y_pallas, atol=1e-5)
    # event order matters to the last bit only: a float64 sum is within rounding
    exact = np.zeros((4, length + 256))
    for i in range(4):
        for e in range(288):
            o = int(onset[i, e])
            exact[i, o:o + 256] += float(vel[i, e]) * table[int(row[i, e])].astype(np.float64)
    np.testing.assert_allclose(got, exact[:, :length], atol=1e-5)


def test_synth_events_refuses_mixed_devices_and_bad_arguments():
    onset = torch.zeros((1, 4), dtype=torch.int32)
    gain = torch.zeros((1, 4))
    table, lengths = torch.zeros((2, 8)), torch.full((2,), 8, dtype=torch.int32)
    assert D.synth_events(onset, onset, gain, table, lengths, 16).shape == (1, 16)
    meta = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        D.synth_events(onset, onset, gain, meta, lengths, 16)


@pytest.mark.parametrize("m", [1, 3, 6, 40, 64, 65, 256, 65535])
@pytest.mark.parametrize("qpm", [60.0, 120.0, 200.0])
def test_tiles_cover_the_waveform_and_the_grid_the_card(m, qpm):
    """The kernel's tile (THREADS · p samples) covers ``length`` with no empty
    block; one loop's grid still covers the 132 SMs of an H100; a chunk of 64
    or 256 takes the largest tile (4,096 samples)."""
    sms = 132
    length = M.mso_waveform_length(32, qpm / 15.0, M.MSOParams())
    p = D.samples_per_thread(m, length, sms)
    assert p in D.PER_THREAD
    tile = D.THREADS * p
    tiles = -(-length // tile)
    assert tiles * tile >= length > (tiles - 1) * tile
    assert m * tiles >= sms  # at M 1 too
    if p != D.PER_THREAD[0]:
        assert m * tiles >= 4 * sms  # a larger tile only where the grid keeps 4 blocks an SM
    if p != D.PER_THREAD[-1]:
        assert m * -(-length // (2 * tile)) < 4 * sms  # ... and the largest such
    if m >= 64:
        assert p == D.PER_THREAD[-1]


def test_shared_memory_and_entry_point():
    """A block's shared memory (lengths and its kept events, 4.6 KB at 288
    cells and 9 rows) and the C entry point of csrc/device_synth.cu against
    its ctypes declaration, the stream last."""
    assert D.smem_bytes(9, 288) == 4 * (9 + 4 * 288) <= D.MAX_SMEM
    assert D.smem_bytes(16, 3068) <= D.MAX_SMEM < D.smem_bytes(16, 3069)
    src = (Path(D.__file__).parents[1] / "csrc" / "device_synth.cu").read_text()
    (params,) = re.findall(r"^int tgi_device_synth\(([^)]*)\)", src, re.MULTILINE)
    params = [" ".join(p.split()) for p in params.split(",")]
    assert params[-1] == "void* stream"
    kinds = {ctypes.c_void_p: ("const void*", "void*"), ctypes.c_int: ("int",)}
    assert len(params) - 1 == len(D.SIGNATURE)
    for p, t in zip(params[:-1], D.SIGNATURE):
        assert p.rsplit(" ", 1)[0] in kinds[t], p


def test_device_synth_matches_both_host_mixers(tables):
    """tests/test_device_synth.py's bar, atol 1e-6, at 120 bpm where the f32
    and f64 onsets agree; the port's host mixer equals JAX's exactly."""
    (table, _, luts, _, lengths), _ = tables
    hvos, qpms, length = corpus(), np.full((8,), 120.0), 40000
    host = synth.synthesize_hvo_batch(hvos, qpms, [None] * 8, fixed_length=length)
    jax_host = jax_synthesize_hvo_batch(hvos, qpms, [None] * 8, fixed_length=length)
    np.testing.assert_allclose(host, jax_host, atol=1e-7)  # JAX's may be its C++ mixer
    dev = D.synthesize_on_device(torch.from_numpy(hvos), torch.full((8,), 8.0), table, zeros(8),
                                 length, luts=luts, sf_k=zeros(8), lengths=lengths).numpy()
    # the host normalises per item against clipping; mirror it
    peak = np.max(np.abs(dev), axis=-1, keepdims=True, initial=1e-9)
    dev = np.divide(dev, peak, where=peak > 1.0, out=dev.copy())
    np.testing.assert_allclose(host, dev, atol=1e-6)
    np.testing.assert_allclose(jax_host, dev, atol=1e-6)
    # without lengths the rows count as S_max long: the same waveform
    full = D.synthesize_on_device(torch.from_numpy(hvos[:2]), torch.full((2,), 8.0), table,
                                  zeros(2), length).numpy()
    np.testing.assert_array_equal(
        full, D.synthesize_on_device(torch.from_numpy(hvos[:2]), torch.full((2,), 8.0), table,
                                     zeros(2), length, lengths=lengths).numpy())


def test_host_synth_single_grid_and_lengths():
    hvo = np.zeros((32, 27), np.float32)
    hvo[4, 0], hvo[4, 9] = 1.0, 0.8
    y = synth.synthesize_hvo(hvo, qpm=120.0)
    onset = int(0.5 * SR)
    assert y.dtype == np.float32 and not y[: onset - 10].any()
    assert np.abs(y[onset:onset + 1000]).max() > 0.1
    out = synth.synthesize_hvo_batch(np.stack([hvo, hvo]), [120.0, 90.0], [None, None],
                                     fixed_length=SR * 3)
    assert out.shape == (2, SR * 3)


def test_front_end_device_route_matches_host_route_and_jax():
    """8 synthetic loops at 8 tempos through grids → MSO: the port's device
    route (plain versions on the CPU) against its host route and against both
    JAX routes, at the JAX tests' bar (atol 2e-5·max, rtol 1e-3)."""
    hvos = corpus()
    dev = M.mso_batch_from_hvo(hvos, [None] * 8, QPMS, device="cpu", device_synth=True)
    host = M.mso_batch_from_hvo(hvos, [None] * 8, QPMS, device="cpu")  # CPU default: host
    jax_dev = JM.mso_batch_from_hvo(hvos, [None] * 8, QPMS, device_synth=True)
    jax_host = JM.mso_batch_from_hvo(hvos, [None] * 8, QPMS, device_synth=False)
    assert dev.shape == host.shape == (8, 32, 16) and dev.dtype == np.float32
    scale = np.abs(jax_host).max() + 1e-9
    for a, b in ((dev, host), (dev, jax_dev), (host, jax_host), (dev, jax_host)):
        np.testing.assert_allclose(a, b, atol=2e-5 * scale, rtol=1e-3)
    # like for like the port is much closer: same events, same DSP
    np.testing.assert_allclose(dev, jax_dev, atol=5e-6 * scale)
    np.testing.assert_allclose(host, jax_host, atol=5e-6 * scale)
    # chunking is invisible, and the fused method (plain here) agrees
    chunked = M.mso_batch_from_hvo(hvos, None, QPMS, device="cpu", device_synth=True,
                                   chunk_size=3)
    np.testing.assert_array_equal(chunked, dev)
    fused = M.mso_batch_from_hvo(hvos[:2], None, QPMS[:2], device="cpu", device_synth=True,
                                 method="fused")
    np.testing.assert_allclose(fused, M.mso_batch_from_hvo(
        hvos[:2], None, QPMS[:2], device="cpu", device_synth=True), atol=2e-5 * scale, rtol=1e-3)
    assert M.mso_batch_from_hvo(hvos[:0], None, [], device="cpu").shape == (0, 32, 16)
