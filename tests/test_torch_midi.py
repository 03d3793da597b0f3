"""The port's MIDI module against the JAX package's, on the CPU:
``parse_midi`` and ``midi_to_hvo_sequences`` on seeded Standard MIDI Files
(tempo and meter changes, SMPTE division, running status), ``hvo_to_midi``
byte for byte, the malformed-input contract (``ValueError`` only, in the
JAX package's cases, a truncation sweep and a bounded byte fuzz), and a
GMD-style archive through ``gmd_to_processed_tree`` and each package's
``process_dataset --source``: trees and datasets that cross both ways."""

import csv
import json
import os
import pickle
import struct
import sys

import numpy as np
import pytest

from kit_fixtures import three_kits

from transformergrooveinfilling_tpu.data import datasets as JD
from transformergrooveinfilling_tpu.data import midi as J
from transformergrooveinfilling_tpu.data import subsetter as JSub
from transformergrooveinfilling_tpu.data.synthetic import synthetic_gmd_sequences
from transformergrooveinfilling_tpu.hvo import sequence as JSeq
from transformergrooveinfilling_tpu_torch import data as port_data
from transformergrooveinfilling_tpu_torch.data import datasets as D
from transformergrooveinfilling_tpu_torch.data import midi as P
from transformergrooveinfilling_tpu_torch.data import subsetter as Sub
from transformergrooveinfilling_tpu_torch.data import synthetic as Syn
from transformergrooveinfilling_tpu_torch.hvo import sequence as Seq
from transformergrooveinfilling_tpu_torch.utils import serialization

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPS = 120  # ticks per 16th at division 480


def smf(events, division=480):
    """A one-track SMF from absolute-tick ``(tick, payload)`` events."""
    track, prev = b"", 0
    for tick, payload in sorted(events, key=lambda e: e[0]):
        track += P._varlen(tick - prev) + payload
        prev = tick
    track += P._varlen(0) + b"\xff\x2f\x00"
    return (b"MThd" + struct.pack(">IHHH", 6, 0, 1, division)
            + b"MTrk" + struct.pack(">I", len(track)) + track)


def tempo(us):
    return b"\xff\x51\x03" + int(us).to_bytes(3, "big")


def tsig(num, den_pow):
    return bytes([0xFF, 0x58, 0x04, num, den_pow, 24, 8])


def kick(vel=100):
    return bytes([0x99, 36, vel])


def seeded_smf(seed: int) -> bytes:
    """Random drum notes (mapped and unmapped, note-offs as note-on 0),
    running status inside a run of note-ons, a controller, a program change,
    a sysex and up to two tempo or meter changes."""
    rng = np.random.default_rng(seed)
    events = [(0, tempo(rng.integers(300000, 700000))), (0, tsig(4, 2))]
    t, n_steps = 0, int(rng.integers(16, 96))
    for step in range(n_steps):
        if rng.random() < 0.5:
            continue
        tick = step * TPS + int(rng.integers(-50, 50))
        tick = max(tick, 0)
        notes = rng.choice([36, 38, 40, 42, 44, 46, 49, 51, 1, 70], size=int(rng.integers(1, 4)))
        # one status byte, then running status for the other notes
        payload = bytes([0x99, int(notes[0]), int(rng.integers(1, 128))])
        for n in notes[1:]:
            payload += bytes([0x00, int(n), int(rng.integers(0, 128))])
        events.append((tick, payload))
        t = max(t, tick)
    events += [(int(rng.integers(0, t + 1)), bytes([0xB9, 7, 100])),
               (0, bytes([0xC9, 3])), (0, b"\xf0\x03\x7e\x7f\xf7")]
    for _ in range(int(rng.integers(0, 3))):
        at = int(rng.integers(1, max(t, 2))) // TPS * TPS
        events.append((at, tempo(rng.integers(300000, 700000)) if rng.random() < 0.5
                       else tsig(int(rng.integers(2, 8)), int(rng.integers(2, 4)))))
    return smf(events)


def hvo_smf(seed: int) -> bytes:
    return J.hvo_to_midi(synthetic_gmd_sequences(1, seed=seed)[0])


CASES = {
    "loop": lambda: hvo_smf(5),
    "tempo_change": lambda: smf([(0, tempo(500000)), (0, tsig(4, 2))]
                                + [(s * TPS, kick()) for s in range(0, 32, 4)]
                                + [(32 * TPS, tempo(400000))]
                                + [((32 + s) * TPS, kick()) for s in range(0, 32, 4)]),
    "meter_change": lambda: smf([(0, tempo(500000)), (0, tsig(4, 2))]
                                + [(s * TPS, kick()) for s in range(0, 32, 8)]
                                + [(32 * TPS, tsig(3, 2))]
                                + [((32 + s) * TPS, kick()) for s in range(0, 24, 8)]),
    "redundant_tempo": lambda: smf([(0, tsig(4, 2)), (40 * TPS, tempo(500000))]
                                   + [(s * TPS, kick()) for s in range(0, 64, 4)]),
    "smpte": lambda: smf([(0, tempo(500000)), (0, tsig(4, 2))]
                         + [(s * 125, kick()) for s in range(0, 32, 4)],
                         division=((256 - 25) << 8) | 40),
    "smpte_tempo_change": lambda: smf([(0, tempo(500000)), (0, tsig(4, 2))]
                                      + [(s * 125, kick()) for s in range(0, 32, 4)]
                                      + [(32 * 125, tempo(250000))]
                                      + [(32 * 125 + s * 63, kick()) for s in range(0, 32, 4)],
                                      division=((256 - 29) << 8) | 80),
    "thirty_second_meter": lambda: smf([(0, tsig(7, 5)), (0, kick())]),
    **{f"seeded_{seed}": (lambda seed=seed: seeded_smf(seed)) for seed in range(8)},
}


def same_sequences(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert type(a) is Seq.HVOSequence
        assert a.hvo.dtype == b.hvo.dtype
        np.testing.assert_array_equal(a.hvo, b.hvo)
        assert [vars(t) for t in a.time_signatures] == [vars(t) for t in b.time_signatures]
        assert [vars(t) for t in a.tempos] == [vars(t) for t in b.tempos]
        assert vars(a.metadata) == vars(b.metadata)


@pytest.mark.parametrize("name", sorted(CASES))
def test_parse_and_grid_equal_jax(name):
    blob = CASES[name]()
    got = P.parse_midi(blob)
    assert got == J.parse_midi(blob)
    meta = Seq.Metadata(drummer="d", loop_id="x", bpm=99.0)
    same_sequences(P.midi_to_hvo_sequences(blob, metadata=meta),
                   J.midi_to_hvo_sequences(blob, metadata=JSeq.Metadata(**vars(meta))))
    same_sequences(P.midi_to_hvo_sequences(blob, drop_empty=False, bars_per_loop=1),
                   J.midi_to_hvo_sequences(blob, drop_empty=False, bars_per_loop=1))
    if name == "smpte":
        assert got["division"] is None and got["smpte"] == (25.0, 40)


@pytest.mark.parametrize("seed", range(6))
def test_hvo_to_midi_equals_jax_byte_for_byte(seed, tmp_path):
    port, jax = Syn.synthetic_gmd_sequences(2, seed=seed), synthetic_gmd_sequences(2, seed=seed)
    for p, j in ((port[0], jax[0]), (port[1], jax[1])):
        assert P.hvo_to_midi(p) == J.hvo_to_midi(j)
    long_p, long_j = port[0].copy(), jax[0].copy()  # 64 steps, negative offsets kept
    long_p.hvo = np.concatenate([port[0].hvo, port[1].hvo])
    long_j.hvo = np.concatenate([jax[0].hvo, jax[1].hvo])
    long_p.time_signatures = [Seq.TimeSignature(numerator=3, denominator=8)]
    long_j.time_signatures = [JSeq.TimeSignature(numerator=3, denominator=8)]
    path = str(tmp_path / "a.mid")
    blob = P.hvo_to_midi(long_p, path, division=96)
    assert blob == J.hvo_to_midi(long_j, division=96) == open(path, "rb").read()
    back = P.midi_to_hvo_sequences(P.hvo_to_midi(port[0]))
    np.testing.assert_array_equal(back[0].hits, port[0].hits)


MALFORMED = [
    (lambda b: b[:10], "truncated MIDI header"),
    (lambda b: b"XXXX" + b[4:], "not a Standard MIDI File"),
    (lambda b: b[:20], "MTrk"),
    (lambda b: b[:40], "truncated"),
    (lambda b: b[:12] + b"\x00\x00" + b[14:], "division of 0"),
    (lambda b: b[:12] + bytes([256 - 25, 0]) + b[14:], "0 ticks/frame"),
    (lambda b: b[:4] + b"\x00\x00\x00\x05" + b[8:], "MThd length"),
    (lambda b: b + b"MTrk", None),  # trailing bytes past the declared tracks: parses
]


@pytest.mark.parametrize("case", range(len(MALFORMED)))
def test_malformed_input_raises_value_error_as_in_jax(case):
    mutate, match = MALFORMED[case]
    bad = mutate(CASES["tempo_change"]())
    if match is None:
        assert P.parse_midi(bad) == J.parse_midi(bad)
        return
    with pytest.raises(ValueError, match=match):
        P.parse_midi(bad)
    with pytest.raises(ValueError, match=match):
        J.parse_midi(bad)


@pytest.mark.parametrize("blob, match", [
    (b"MThd\x00\x00\x00\x06\x00\x00\x00\x01\x01\xe0MTrk\x00\x00\x00\x06"
     b"\xff\xff\xff\xff\xff\x00", "varint"),
    (b"MThd\x00\x00\x00\x06\x00\x00\x00\x01\x01\xe0MTrk\x00\x00\x00\x03\x00\x24\x40",
     "running status"),
    (b"MThd\x00\x00\x00\x06\x00\x00\x00\x01\x01\xe0MTrk\x00\x00\x00\x04\x00\xff\x51\x03",
     "truncated"),
    (b"MThd\x00\x00\x00\x06\x00\x00\x00\x01\x01\xe0MTrk\x00\x00\x00\x07"
     b"\x00\xff\x51\x03\x00\x00\x00", "0 µs/quarter"),
    (b"MThd\x00\x00\x00\x06\x00\x00\x00\x01\x01\xe0MTrk\x00\x00\x00\x08"
     b"\x00\xff\x58\x04\x00\x02\x18\x08", "time signature"),
    (b"MThd\x00\x00\x00\x06\x00\x00\x00\x01\x01\xe0MTrk\x00\x00\x00\x02\x00\xf4",
     "unhandled MIDI status"),
])
def test_named_malformed_events(blob, match):
    with pytest.raises(ValueError, match=match):
        P.parse_midi(blob)
    with pytest.raises(ValueError, match=match):
        J.parse_midi(blob)


def outcome(parse, blob):
    try:
        return parse(blob)
    except ValueError as e:  # the only failure allowed
        return ("ValueError", str(e))


def test_truncation_sweep_and_byte_fuzz_match_jax():
    """Every prefix of a seeded file, then 600 seeded corruptions of 1-6
    bytes: each parses to JAX's dict or raises JAX's ValueError, never
    another exception."""
    good = seeded_smf(3)
    for cut in range(len(good)):
        assert outcome(P.parse_midi, good[:cut]) == outcome(J.parse_midi, good[:cut]), cut
    rng = np.random.default_rng(0)
    for trial in range(600):
        bad = bytearray(good)
        for _ in range(int(rng.integers(1, 7))):
            bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        assert outcome(P.parse_midi, bytes(bad)) == outcome(J.parse_midi, bytes(bad)), trial


# ---------------------------------------------------------------- GMD archives


def write_archive(root, n=10, seed=9):
    """A GMD-style archive of synthetic loops written by the JAX package's
    ``hvo_to_midi`` (the same bytes as the port's), with a row whose bpm is
    empty, a corrupt file and a missing one."""
    os.makedirs(root / "d" / "s")
    rows = []
    for i, seq in enumerate(synthetic_gmd_sequences(n, seed=seed)):
        rel = f"d/s/{i}.mid"
        J.hvo_to_midi(seq, str(root / rel))
        rows.append({"drummer": "d", "session": "s", "id": str(i),
                     "style": seq.metadata.style_primary + ("/alt" if i % 3 == 0 else ""),
                     "bpm": "" if i == 1 else seq.metadata.bpm, "beat_type": "beat",
                     "time_signature": "4-4", "midi_filename": rel, "audio_filename": "",
                     "duration": "", "split": ("train", "test", "validation")[i % 3]})
    (root / "d" / "s" / "corrupt.mid").write_bytes((root / "d" / "s" / "0.mid").read_bytes()[:37])
    rows.append({**rows[0], "id": "corrupt", "midi_filename": "d/s/corrupt.mid"})
    rows.append({**rows[0], "id": "missing", "midi_filename": "d/s/missing.mid"})
    with open(root / "info.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def test_gmd_trees_equal_jax_and_cross_both_ways(tmp_path):
    write_archive(tmp_path / "gmd")
    counts = P.gmd_to_processed_tree(str(tmp_path / "gmd"), str(tmp_path / "port"))
    assert counts == J.gmd_to_processed_tree(str(tmp_path / "gmd"), str(tmp_path / "jax"))
    assert counts == {"train": 4, "test": 3, "validation": 3}
    for split in counts:
        sub = f"GrooveMIDI_processed_{split}"
        for name in ("metadata.csv",):
            assert (tmp_path / "port" / sub / name).read_bytes() == \
                (tmp_path / "jax" / sub / name).read_bytes()
        port_file = str(tmp_path / "port" / sub / "hvo_sequence_data.obj")
        jax_file = str(tmp_path / "jax" / sub / "hvo_sequence_data.obj")
        with open(port_file, "rb") as f:  # the JAX package reads the port's tree
            by_jax = pickle.load(f)
        assert all(type(s) is JSeq.HVOSequence for s in by_jax)
        with open(jax_file, "rb") as f:
            jax_seqs = pickle.load(f)
        same_sequences(serialization.load_pickle(jax_file), jax_seqs)
        same_sequences(serialization.load_pickle(port_file), by_jax)
        # and each package's subsetter reads the other's tree
        _, theirs = JSub.GrooveMidiSubsetter(pickle_source_path=str(tmp_path / "port"),
                                             subset=sub).create_subsets()
        _, ours = Sub.GrooveMidiSubsetter(pickle_source_path=str(tmp_path / "jax"),
                                          subset=sub).create_subsets()
        same_sequences(ours[0], theirs[0])
    assert port_data.gmd_to_processed_tree is P.gmd_to_processed_tree


def test_process_dataset_from_a_midi_tree_equals_jax(tmp_path, monkeypatch):
    """Both ``process_dataset --source <tree>`` command lines on the tree of a
    MIDI archive: the symbolic experiment's pickles equal, and the audio
    experiment with ``--params-json`` naming a directory of two ``.sf2``
    kits draws the same kits and gives MSO inputs within the datasets' bar."""
    write_archive(tmp_path / "gmd", n=12, seed=21)
    tree = str(tmp_path / "tree")
    P.gmd_to_processed_tree(str(tmp_path / "gmd"), tree)
    *kits, looped = three_kits(str(tmp_path / "kits"))
    # the looped kit's filter sweep differs from the JAX package's by design
    # (tests/test_torch_sf2.py holds it); the two kits left equal it bit for bit
    os.remove(looped)
    params = tmp_path / "params.json"
    params.write_text(json.dumps({"InfillingRandom": {"sf_path": str(tmp_path / "kits"),
                                                      "max_aug_items": 2}}))
    sys.path.insert(0, REPO)
    try:
        import process_dataset as jax_cli
    finally:
        sys.path.remove(REPO)
    from transformergrooveinfilling_tpu_torch import process_dataset as port_cli

    argv = ["--experiments", "InfillingClosedHH_Symbolic", "InfillingRandom", "--splits",
            "train", "--source", tree, "--params-json", str(params)]
    for name, run in (("jax", lambda: jax_cli.main(argv)),
                      ("port", lambda: port_cli.main(argv + ["--device", "cpu"]))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        run()
    for exp, version in (("InfillingClosedHH_Symbolic", "0.1.1"), ("InfillingRandom", "0.0.0")):
        rel = os.path.join("datasets", exp, version, "train")
        got = D.load_processed_dataset(str(tmp_path / "port" / rel), exp)
        want = JD.load_processed_dataset(str(tmp_path / "jax" / rel), exp)
        assert len(got) == len(want) > 0
        np.testing.assert_array_equal(got.processed_outputs, want.processed_outputs)
        assert got.hvo_index == want.hvo_index
        if exp == "InfillingRandom":
            assert got.soundfonts == want.soundfonts and set(got.soundfonts) <= set(kits)
            np.testing.assert_allclose(got.processed_inputs, want.processed_inputs,
                                       atol=1e-5 * np.abs(want.processed_inputs).max(),
                                       rtol=1e-4)
        else:
            np.testing.assert_array_equal(got.processed_inputs, want.processed_inputs)
