"""The port's SoundFont reader, host mixer and kit tables against the JAX
package's, on the CPU: ``write_minimal_sf2`` bytes and ``parse_sf2``; every
generator case of ``tests/test_native_audio.py`` rendered by
``kit_from_sf2`` bit for bit, except the two repairs — the tremolo, which
equals the JAX kit at the negated depth, and the swept filter, held to a
direct-form-I reference exactly and to the JAX package's within a stated bar;
the native library against the JAX binding and its numpy versions against
the native ones, with and without a compiler; the ``SF2Error`` contract;
synthesis, packed tables, datasets and the device route's MSO with kits; WAV
files; and the packed-table cache (ROADMAP §C10)."""

import os
import random
import wave

import numpy as np
import pytest

from kit_fixtures import SR, SWEPT, generator_fixtures, three_kits, tremolo_fixture

from transformergrooveinfilling_tpu.audio import native_binding as JN
from transformergrooveinfilling_tpu.audio import sf2 as J
from transformergrooveinfilling_tpu.audio import synth as JSynth
from transformergrooveinfilling_tpu.data import datasets as JData
from transformergrooveinfilling_tpu.data import experiments as JExp
from transformergrooveinfilling_tpu.data.synthetic import synthetic_gmd_sequences
from transformergrooveinfilling_tpu.ops import device_synth as JD
from transformergrooveinfilling_tpu.ops import mso as JM
from transformergrooveinfilling_tpu_torch.audio import native_binding as N
from transformergrooveinfilling_tpu_torch.audio import sf2 as P
from transformergrooveinfilling_tpu_torch.audio import synth as Synth
from transformergrooveinfilling_tpu_torch.audio.drumkit import default_kit
from transformergrooveinfilling_tpu_torch.data import datasets as Data
from transformergrooveinfilling_tpu_torch.data import synthetic as Syn
from transformergrooveinfilling_tpu_torch.hvo.mapping import VOICE_TO_MIDI_NOTE as KEYS
from transformergrooveinfilling_tpu_torch.ops import device_synth as D
from transformergrooveinfilling_tpu_torch.ops import mso as M

FIXTURES = generator_fixtures()
EXACT = [name for name in FIXTURES if name not in SWEPT]
# the swept filters against the JAX package's: both update the coefficients
# every 64 samples, but the JAX package carries scipy's transposed-direct-form
# state across a change of coefficients and the port the direct-form-I
# history (the section's last inputs and outputs), so the two filters differ
# where the cutoff moves: 1.2e-2 of a 0.9 kit peak on these fixtures
SWEPT_BAR = 2e-2
C9_BAR = dict(rel=2e-5, rtol=1e-3)  # the device route's MSO bar (ROADMAP §C9)


def write(tmp_path, name, module=P, **kwargs):
    path = str(tmp_path / f"{name}.sf2")
    module.write_minimal_sf2(path, sr=SR, **kwargs)
    return path


def same_kit(a, b):
    assert len(a.samples) == len(b.samples) and len(a) == len(b) == 9
    np.testing.assert_array_equal(a.lut, b.lut)
    for x, y in zip(a.samples, b.samples):
        assert x.dtype == np.float32 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def kit_dir(tmp_path_factory):
    """The procedural kit exported, the layered kit (both equal to the JAX
    package's bit for bit) and the looped generator case."""
    d = tmp_path_factory.mktemp("kits")
    paths = three_kits(str(d / "three"))[:2]
    paths.append(write(d, "loop", **FIXTURES["loop"]))
    return paths


# ---------------------------------------------------------------- the file


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_write_minimal_sf2_bytes_and_parse_equal_jax(name, tmp_path):
    ours = write(tmp_path, name + "_port", **FIXTURES[name])
    theirs = write(tmp_path, name + "_jax", module=J, **FIXTURES[name])
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    got, want = P.parse_sf2(ours), J.parse_sf2(ours)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["smpl"], want["smpl"])
    for key in want:
        if key != "smpl":
            assert got[key] == want[key], key
    with pytest.raises(ValueError, match="exactly one"):
        P.write_minimal_sf2(str(tmp_path / "x.sf2"))


def test_procedural_kit_exported_renders_as_in_jax(tmp_path):
    kit = default_kit(SR)
    path = write(tmp_path, "procedural", samples={k: kit[v] for v, k in enumerate(KEYS)})
    got = P.kit_from_sf2(path, SR)
    same_kit(got, J.kit_from_sf2(path, SR))
    for v in range(9):  # 16-bit round trip, kit-wide normalisation to 0.9
        np.testing.assert_allclose(got[v][: len(kit[v]) - 1], kit[v][: len(kit[v]) - 1],
                                   atol=1e-3)


# ---------------------------------------------------------------- kits


@pytest.mark.parametrize("name", EXACT)
def test_kit_from_sf2_equals_jax_bit_for_bit(name, tmp_path):
    path = write(tmp_path, name, **FIXTURES[name])
    same_kit(P.kit_from_sf2(path, SR), J.kit_from_sf2(path, SR))


def test_tremolo_equals_jax_at_the_negated_depth(tmp_path):
    """ROADMAP §C3: the gain is 10^(+val·depth/200) (SF2 generator 13,
    fluidsynth). The JAX package inverts the sign, so the port's kit at +60
    cB equals the JAX kit at -60, bit for bit, and differs from it at +60."""
    ours = P.kit_from_sf2(write(tmp_path, "trem", **tremolo_fixture(60)), SR)
    same_kit(ours, J.kit_from_sf2(write(tmp_path, "trem_neg", **tremolo_fixture(-60)), SR))
    assert not np.array_equal(ours[0], J.kit_from_sf2(str(tmp_path / "trem.sf2"), SR)[0])
    # the LFO's first quarter period (t < 25 ms) raises the gain: +3 dB there
    got, flat = np.abs(ours[0]), np.abs(ours[1])
    w, at = int(0.001 * SR), int(0.025 * SR)
    np.testing.assert_allclose(got[at - w:at + w].max() / flat[at - w:at + w].max(),
                               10 ** (60 / 200.0), rtol=0.03)


@pytest.mark.parametrize("name", SWEPT)
def test_swept_filter_is_the_direct_form_i_recurrence(name, tmp_path):
    """The swept filter is the direct-form-I biquad with new coefficients
    every 64 samples and the last two inputs and outputs carried: equal to
    scipy's ``lfilter`` started each block from that history
    (``lfiltic``), within f32 rounding; the kit within :data:`SWEPT_BAR` of
    the kit peak of the JAX package's."""
    from scipy.signal import lfilter, lfiltic

    rng = np.random.default_rng(3)
    x = rng.standard_normal(5000).astype(np.float32)
    offset = 4800 * np.linspace(1.0, 0.0, len(x))
    got = P._apply_lowpass_swept(x, 6000, 100, offset, SR)
    xs, want = x.astype(np.float64), np.empty(len(x))
    for s in range(0, len(x), 64):
        b0, b1, b2, a1, a2 = P.lowpass_coeffs(6000 + offset[s], 100, SR)
        zi = lfiltic([b0, b1, b2], [1.0, a1, a2], y=want[max(s - 2, 0):s][::-1],
                     x=xs[max(s - 2, 0):s][::-1])
        want[s:s + 64] = lfilter([b0, b1, b2], [1.0, a1, a2], xs[s:s + 64], zi=zi)[0]
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())

    path = write(tmp_path, name, **FIXTURES[name])
    ours, theirs = P.kit_from_sf2(path, SR), J.kit_from_sf2(path, SR)
    np.testing.assert_array_equal(ours.lut, theirs.lut)
    for a, b in zip(ours.samples, theirs.samples):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=SWEPT_BAR * 0.9)


def test_kit_from_sf2_is_cached_per_path_and_rate(tmp_path):
    path = write(tmp_path, "att", **FIXTURES["attenuation"])
    assert P.kit_from_sf2(path, SR) is P.kit_from_sf2(path, SR)
    assert len(P.kit_from_sf2(path, 22050)[0]) < len(P.kit_from_sf2(path, SR)[0])


# ---------------------------------------------------------------- the native library


def test_native_functions_equal_the_jax_binding(rng):
    table = default_kit(SR)
    voices = rng.integers(-1, 10, 60).astype(np.int32)
    onsets = rng.integers(-5, 44100, 60).astype(np.int64)
    vels = rng.random(60).astype(np.float32)
    got, want = np.zeros(44100, np.float32), np.zeros(44100, np.float32)
    N.mix_events_native(got, table, voices, onsets, vels)  # rows and onsets out of range skip
    JN.mix_events_native(want, table, voices, onsets, vels)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 0

    bufs, jbufs = np.zeros((3, 20000), np.float32), np.zeros((3, 20000), np.float32)
    offsets = np.array([0, 20, 20, 60])
    ok_voices, ok_onsets = np.clip(voices, 0, 8), np.clip(onsets, 0, 19999)
    N.mix_batch_native(bufs, table, ok_voices, ok_onsets, vels, offsets, n_threads=3)
    JN.mix_batch_native(jbufs, table, ok_voices, ok_onsets, vels, offsets, n_threads=1)
    np.testing.assert_array_equal(bufs, jbufs)
    with pytest.raises(ValueError, match="parallel"):
        N.mix_batch_native(bufs, table, ok_voices[:5], ok_onsets, vels, offsets)

    x = rng.standard_normal(4096).astype(np.float32)
    for ratio in (0.37, 1.0, 1.4983, 2.0, 3.3):
        np.testing.assert_array_equal(N.resample_linear(x, ratio), JN.resample_linear(x, ratio))
    np.testing.assert_array_equal(N.resample_linear(x, 0.5, out_len=100),
                                  JN.resample_linear(x, 0.5, out_len=100))
    coeffs = P.lowpass_coeffs(8000, 150, SR)
    np.testing.assert_array_equal(N.biquad(x, *coeffs), JN.biquad(x, *coeffs))


def test_numpy_versions_equal_the_native_ones(rng):
    x = rng.standard_normal(3000).astype(np.float32)
    coeffs = P.lowpass_coeffs(5000, 300, SR)
    whole = N.biquad(x, *coeffs)
    np.testing.assert_array_equal(N.biquad_numpy(x, *coeffs), whole)
    # block by block with the state carried equals one pass, either way
    for fn in (N.biquad, N.biquad_numpy):
        state = np.zeros(4)
        parts = [fn(x[s:s + 700], *coeffs, state=state) for s in range(0, len(x), 700)]
        np.testing.assert_array_equal(np.concatenate(parts), whole)
    for ratio in (0.37, 1.0, 1.4983, 2.0):
        np.testing.assert_array_equal(N.resample_linear_numpy(x, ratio),
                                      N.resample_linear(x, ratio))
    assert len(N.resample_linear_numpy(x[:1], 1.0)) == 0
    table = default_kit(SR)
    voices, onsets = rng.integers(0, 9, 40), rng.integers(0, 30000, 40)
    vels = rng.random(40).astype(np.float32)
    got, want = np.zeros(30000, np.float32), np.zeros(30000, np.float32)
    Synth._mix_events_numpy(got, table, voices, onsets, vels)
    N.mix_events_native(want, table, voices, onsets, vels)
    np.testing.assert_array_equal(got, want)


def test_without_a_compiler_the_numpy_versions_give_the_same_kits(tmp_path, monkeypatch,
                                                                 capsys, kit_dir):
    grids = _grids(3, np.random.default_rng(5))
    sfs = [kit_dir[1], kit_dir[2], None]
    with_native = Synth.synthesize_hvo_batch(grids, [90.0, 120.0, 150.0], sfs, sr=SR)
    path = write(tmp_path, "sweep", **FIXTURES["mod_envelope_sweep"])
    native_kit = P.kit_from_sf2.__wrapped__(path, SR)
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "_warned", False)
    monkeypatch.setattr(N, "library_path", lambda: tmp_path / "none" / "libsf2synth.so")
    monkeypatch.setattr(N.shutil, "which", lambda name: None)
    assert not N.native_available() and not N.native_available()
    assert capsys.readouterr().err.count("g++ not found") == 1
    same_kit(P.kit_from_sf2.__wrapped__(path, SR), native_kit)
    np.testing.assert_array_equal(
        Synth.synthesize_hvo_batch(grids, [90.0, 120.0, 150.0], sfs, sr=SR), with_native)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        N.get_lib()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "sf2synth.cpp"
    broken.write_text(N.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "SOURCE", broken)
    monkeypatch.setattr(N, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        N.native_available()
    assert not list((tmp_path / "build").rglob("*.so"))  # nothing half-written is left


def test_the_library_builds_under_build_from_the_ports_own_source():
    N.get_lib()
    path = N.library_path()
    assert path.exists() and path.parent.parent == N.BUILD_ROOT
    assert N.BUILD_ROOT.parts[-2:] == ("build", "native")
    assert N.SOURCE.parts[-4:] == ("transformergrooveinfilling_tpu_torch", "audio", "native",
                                   "sf2synth.cpp")


# ---------------------------------------------------------------- malformed files


def _valid_blob(tmp_path):
    kit = default_kit(SR)
    path = write(tmp_path, "base", samples={k: kit[v][:2000] for v, k in enumerate(KEYS)})
    with open(path, "rb") as f:
        return f.read()


def test_truncated_files_raise_sf2error_or_parse(tmp_path):
    blob = _valid_blob(tmp_path)
    for frac in (0.0, 0.01, 0.1, 0.3, 0.5, 0.7, 0.9, 0.97, 0.999):
        path = tmp_path / f"trunc_{frac}.sf2"
        path.write_bytes(blob[: int(len(blob) * frac)])
        try:
            P.kit_from_sf2(str(path), SR)
        except P.SF2Error:
            pass
    with pytest.raises(P.SF2Error, match="not a SoundFont"):
        P.kit_from_sf2(str(tmp_path / "trunc_0.0.sf2"), SR)
    with pytest.raises(P.SF2Error, match="malformed SoundFont"):  # numpy's ValueError, named
        P.kit_from_sf2(str(tmp_path / "trunc_0.01.sf2"), SR)
    with pytest.raises(FileNotFoundError):
        P.kit_from_sf2(str(tmp_path / "missing.sf2"), SR)


def test_byte_fuzz_raises_value_errors_only(tmp_path):
    blob = bytearray(_valid_blob(tmp_path))
    rng = np.random.default_rng(11)
    for trial in range(40):
        mutated = bytearray(blob)
        for _ in range(rng.integers(1, 12)):
            mutated[rng.integers(0, len(mutated))] = rng.integers(0, 256)
        path = tmp_path / f"fuzz_{trial}.sf2"
        path.write_bytes(bytes(mutated))
        try:
            P.kit_from_sf2(str(path), SR)
        except P.SF2Error:  # a ValueError, as the JAX package's contract asks
            pass


def test_inconsistent_tables_raise_sf2error(tmp_path, monkeypatch):
    real = P.parse_sf2(write(tmp_path, "ok", **FIXTURES["attenuation"]))
    monkeypatch.setattr(P, "parse_sf2", lambda path: {**real, "shdr": []})
    with pytest.raises(P.SF2Error, match="malformed SoundFont"):
        P.kit_from_sf2(str(tmp_path / "corrupt.sf2"), SR)
    assert issubclass(P.SF2Error, ValueError)


# ---------------------------------------------------------------- synthesis with kits


def _grids(m, rng, t=32):
    h = (rng.random((m, t, 9)) < 0.25).astype(np.float32)
    return np.concatenate([h, h * rng.random(h.shape), h * (rng.random(h.shape) - 0.5)],
                          -1).astype(np.float32)


def test_synthesize_hvo_batch_and_list_with_kits_equal_jax(kit_dir, rng):
    grids = _grids(6, rng)
    qpms = np.array([90.0, 120.0, 150.0, 100.0, 133.0, 77.0])
    sfs = [kit_dir[0], kit_dir[1], kit_dir[2], None, kit_dir[1], kit_dir[0]]
    got = Synth.synthesize_hvo_batch(grids, qpms, sfs, sr=SR)
    np.testing.assert_array_equal(got, JSynth.synthesize_hvo_batch(grids, qpms, sfs, sr=SR))
    listed = Synth.synthesize_hvo_list(grids, qpms, sfs, sr=SR)
    for y, w, g, q, sf in zip(listed, JSynth.synthesize_hvo_list(grids, qpms, sfs, sr=SR),
                              grids, qpms, sfs):
        np.testing.assert_array_equal(y, w)
        np.testing.assert_array_equal(y, Synth.synthesize_hvo(g, qpm=float(q), sf_path=sf))
    seq, jseq = Syn.synthetic_gmd_sequences(1, seed=3)[0], synthetic_gmd_sequences(1, seed=3)[0]
    np.testing.assert_array_equal(seq.synthesize(sf_path=kit_dir[1]),
                                  jseq.synthesize(sf_path=kit_dir[1]))
    with pytest.raises(FileNotFoundError):
        Synth.synthesize_hvo(grids[0], sf_path=str(kit_dir[0]) + ".missing")


def test_hvo_sequence_save_audio_and_mso_with_a_kit(kit_dir, tmp_path):
    seq, jseq = Syn.synthetic_gmd_sequences(1, seed=4)[0], synthetic_gmd_sequences(1, seed=4)[0]
    y = seq.save_audio(str(tmp_path / "a.wav"), sf_path=kit_dir[2])
    np.testing.assert_array_equal(y, jseq.synthesize(sf_path=kit_dir[2]))
    back, sr = Synth.read_wav(str(tmp_path / "a.wav"))
    assert sr == SR and np.abs(back - np.clip(y, -1, 1)).max() <= 1 / 32767 + 1e-7
    got = seq.mso(sf_path=kit_dir[2], device="cpu")
    want = M.mso_from_audio(y, n_steps=32, qpm=seq.tempos[0].qpm, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_read_wav_round_trip_equals_jax(tmp_path, rng):
    y = (rng.random(5000).astype(np.float32) * 2.4 - 1.2)
    Synth.write_wav(str(tmp_path / "p.wav"), y, sr=22050)
    got, sr = Synth.read_wav(str(tmp_path / "p.wav"))
    want, jsr = JSynth.read_wav(str(tmp_path / "p.wav"))
    assert sr == jsr == 22050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.clip(y, -1, 1), atol=1 / 32767 + 1e-7)
    with wave.open(str(tmp_path / "p.wav")) as w:
        assert (w.getnchannels(), w.getsampwidth()) == (1, 2)


# ---------------------------------------------------------------- kit tables


def test_pack_tables_equal_jax_up_to_padding(kit_dir):
    sfs = [kit_dir[1], None, kit_dir[0], kit_dir[2]]
    table, base, luts, sf_index, lengths = D.pack_tables(sfs, SR, device="cpu")
    jtable, jbase, jluts, jindex = JD.pack_tables(sfs, SR)
    jtable, jluts = np.asarray(jtable), np.asarray(jluts)
    assert base.keys() == jbase.keys() == sf_index.keys() == set(sfs)
    flat = {sf: P.kit_from_sf2(sf, SR).samples if sf else list(default_kit(SR)) for sf in sfs}
    s_max = max(len(s) for samples in flat.values() for s in samples)
    assert table.shape == (sum(map(len, flat.values())), s_max)  # no 128-lane rounding
    assert jtable.shape[1] == -(-s_max // 128) * 128
    for sf in sfs:
        np.testing.assert_array_equal(luts[sf_index[sf]].numpy(), jluts[jindex[sf]])
        for i, s in enumerate(flat[sf]):
            row = base[sf] + i
            assert lengths[row] == len(s)
            np.testing.assert_array_equal(table[row].numpy(), jtable[jbase[sf] + i, :s_max])
            assert not table[row, len(s):].any()
    assert [sf for sf, _ in sorted(base.items(), key=lambda kv: kv[1])] == \
        [None] + sorted(sf for sf in sfs if sf)  # the fixed order of §C10


def test_pack_tables_cache_one_entry_for_shuffled_kit_lists(kit_dir, monkeypatch):
    """ROADMAP §C10: the cache is keyed on the set of kits, so 100 front-end
    calls, each listing the kits in another order, pack one table; their MSOs
    equal those of one call."""
    monkeypatch.setattr(D, "_table_cache", {})
    grids = np.zeros((4, 32, 27), np.float32)
    for i, (step, voice) in enumerate(((0, 0), (4, 1), (8, 2), (12, 8))):
        grids[i, step, voice], grids[i, step, 9 + voice] = 1.0, 0.3 + 0.2 * i
    qpms = np.array([120.0, 100.0, 90.0, 140.0])
    kits = [None, *kit_dir]
    items = [kits[i % 4] for i in range(4)]
    want = D.mso_batch_from_hvo_device(grids, items, qpms, device="cpu")
    shuffler = random.Random(0)
    for _ in range(100):
        order = shuffler.sample(range(4), 4)
        got = D.mso_batch_from_hvo_device(grids[order], [items[i] for i in order], qpms[order],
                                          device="cpu")
        np.testing.assert_array_equal(got, want[order])
    assert len(D._table_cache) == 1


def test_device_route_mso_with_kits_within_the_c9_bar_of_jax(kit_dir, rng):
    grids = _grids(5, rng)
    qpms = np.array([120.0, 96.0, 150.0, 110.0, 88.0])
    sfs = [kit_dir[0], kit_dir[1], kit_dir[2], kit_dir[1], None]
    got = M.mso_batch_from_hvo(grids, sfs, qpms, device="cpu", device_synth=True)
    want = np.asarray(JM.mso_batch_from_hvo(grids, sfs, qpms, device_synth=True))
    assert got.shape == want.shape == (5, 32, 16)
    np.testing.assert_allclose(got, want, atol=C9_BAR["rel"] * np.abs(want).max(),
                               rtol=C9_BAR["rtol"])
    # the velocity layers pick other rows: the layered kit is not one row a voice
    layered = P.kit_from_sf2(kit_dir[1], SR)
    assert len(set(layered.lut[0].tolist())) == 3


def test_random_dataset_with_a_kit_directory_matches_jax(kit_dir, tmp_path):
    """``sf_path`` a directory of kits: each item draws its kit (``soundfonts``
    equal to the JAX package's), and the MSO inputs are within the datasets'
    bar (tests/test_torch_data.py)."""
    kits = tmp_path / "kits"
    kits.mkdir()
    for path in kit_dir:
        (kits / os.path.basename(path)).write_bytes(open(path, "rb").read())
    params = JExp.params_for("InfillingRandom")
    params.update(split="train", seed=7, max_aug_items=2, sf_path=str(kits), max_n_sf=2)
    got = Data.GrooveMidiDatasetInfillingRandom(
        data=Syn.synthetic_gmd_sequences(4, seed=9), save_dataset_path=str(tmp_path / "p"),
        device="cpu", **params)
    want = JData.GrooveMidiDatasetInfillingRandom(
        data=synthetic_gmd_sequences(4, seed=9), save_dataset_path=str(tmp_path / "j"), **params)
    assert got.soundfonts == want.soundfonts and len(set(got.soundfonts)) > 1
    np.testing.assert_array_equal(got.processed_outputs, want.processed_outputs)
    np.testing.assert_allclose(got.processed_inputs, want.processed_inputs,
                               atol=1e-5 * np.abs(want.processed_inputs).max(), rtol=1e-4)
