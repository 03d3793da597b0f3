"""The port's data layer against the JAX package's, on the CPU: the HVO
sequence record, the samplers, the synthetic corpus, the subsetter,
``params_for``, the reference-era pickle shims, the five experiments'
datasets built from the same corpus and seed (masks, plans, indices and
outputs bit for bit; MSO inputs within atol 1e-5·max and rtol 1e-4, the
port's MSO bar), dataset directories read across the packages both ways,
and, in a subprocess, that loading a JAX-written directory leaves jax out of
``sys.modules``."""

import copy
import json
import os
import pickle
import random
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from transformergrooveinfilling_tpu.data import datasets as JD
from transformergrooveinfilling_tpu.data import experiments as JE
from transformergrooveinfilling_tpu.data import legacy_pickle as JL
from transformergrooveinfilling_tpu.data import samplers as JSamp
from transformergrooveinfilling_tpu.data import subsetter as JSub
from transformergrooveinfilling_tpu.data import synthetic as JSyn
from transformergrooveinfilling_tpu.hvo import sequence as JSeq
from transformergrooveinfilling_tpu_torch.data import datasets as D
from transformergrooveinfilling_tpu_torch.data import experiments as E
from transformergrooveinfilling_tpu_torch.data import legacy_pickle as L
from transformergrooveinfilling_tpu_torch.data import samplers as Samp
from transformergrooveinfilling_tpu_torch.data import subsetter as Sub
from transformergrooveinfilling_tpu_torch.data import synthetic as Syn
from transformergrooveinfilling_tpu_torch.hvo import sequence as Seq
from transformergrooveinfilling_tpu_torch.utils import serialization

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSO_BAR = dict(rel=1e-5, rtol=1e-4)  # tests/test_torch_mso.py's bar
EXACT_KEYS = ("processed_outputs", "hvo_index", "hvo_seq_index", "voices_reduced",
              "soundfonts", "unused_items")
SEQ_KEYS = ("hvo_sequences", "hvo_sequences_inputs", "hvo_sequences_outputs")


def mso_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=MSO_BAR["rel"] * np.abs(want).max(),
                               rtol=MSO_BAR["rtol"])


def same_record(a, b):
    """Two packages' HVOSequence records: equal grids and field values."""
    assert np.array_equal(a.hvo, b.hvo) and a.hvo.dtype == b.hvo.dtype
    assert [vars(t) for t in a.time_signatures] == [vars(t) for t in b.time_signatures]
    assert [vars(t) for t in a.tempos] == [vars(t) for t in b.tempos]
    assert vars(a.metadata) == vars(b.metadata) and a.drum_mapping == b.drum_mapping


def build(module, exp, seqs, tmp_path, seed=7, **kw):
    params = module_params(exp)
    params.update(split="train", seed=seed, save_dataset_path=str(tmp_path), **kw)
    return module.dataset_class_for_experiment(exp)(data=seqs, **params)


def module_params(exp):
    params = JE.params_for(exp)
    params["max_aug_items"] = 3
    return params


# ---------------------------------------------------------------- the record


def test_hvo_sequence_methods_match_jax():
    port = Syn.synthetic_gmd_sequences(3, seed=11)
    jax = JSyn.synthetic_gmd_sequences(3, seed=11)
    for p, j in zip(port, jax):
        same_record(p, j)
        np.testing.assert_array_equal(p.get_active_voices(), j.get_active_voices())
        for name in ("hvo", "h", "v", "o"):
            np.testing.assert_array_equal(p.get(name), j.get(name))
        for got, want in zip(p.reset_voices([0, 2]), j.reset_voices([0, 2])):
            same_record(got, want)
        for got, want in zip(p.remove_random_events(rng=np.random.default_rng(4)),
                             j.remove_random_events(rng=np.random.default_rng(4))):
            same_record(got, want)
        same_record(p.copy().pad_to_length(40), j.copy().pad_to_length(40))
        same_record(Seq.empty_like(p), JSeq.empty_like(j))
        assert p.is_silent() == j.is_silent() and not p.copy_empty().hvo.any()
    clone = copy.deepcopy(port[0])
    clone.hvo[0, 0] = 5.0
    assert port[0].hvo[0, 0] != 5.0  # a deep copy


def test_hvo_sequence_audio_matches_jax_and_defaults_to_cuda(monkeypatch):
    """At 125 bpm frame 162 falls on step 13.5. The JAX package's MSO of a
    batch forms ``frame · (hop/sr) · sps`` left to right in f32, as the port
    does; for a batch of one, XLA folds ``(hop/sr) · sps`` first, and a tie
    frame can round to the other step. So the port's single-loop MSO is held
    to the JAX package's batched one, and the JAX package's own single-loop
    MSO differs from that only on steps that hold a tie frame."""
    from transformergrooveinfilling_tpu.ops import mso as JM

    p, j = Syn.synthetic_gmd_sequences(1, seed=12)[0], JSyn.synthetic_gmd_sequences(1, seed=12)[0]
    assert p.tempos[0].qpm == 125.0
    y, y_jax = p.synthesize(), j.synthesize()
    assert y.shape == y_jax.shape and y.dtype == np.float32
    np.testing.assert_allclose(y, y_jax, atol=1e-4 * np.abs(y_jax).max())
    got = p.mso(device="cpu")
    batched = np.asarray(JM.mso_batch(np.stack([y_jax, y_jax]), np.full(2, 125 / 15, np.float32),
                                      32, JM.MSOParams()))
    mso_close(got, batched[0])
    from fractions import Fraction

    tie_steps = {int(Fraction(f * 125, 1500) + Fraction(1, 2)) - d for f in range(600)
                 if Fraction(f * 125, 1500) % 1 == Fraction(1, 2) for d in (0, 1)}
    single = j.mso()
    off = {int(s) for s in np.nonzero(np.abs(single - batched[0]).max(axis=1) > 1e-4)[0]}
    assert off <= tie_steps, off - tie_steps
    assert p.to_html_plot() == j.to_html_plot()  # eval/media.py's piano roll
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p.mso()


# ---------------------------------------------------------------- samplers, corpus


def test_samplers_draw_as_jax():
    for k in (None, 5):
        args = dict(voice_idx=[0, 1, 2, 4], min_n_voices_to_remove=1,
                    max_n_voices_to_remove=3, prob=[1, 2, 3], k=k)
        assert (Samp.get_voice_combinations(rng=random.Random(3), **args)
                == JSamp.get_voice_combinations(rng=random.Random(3), **args))
    params = {"voice_idx": [0, 1, 2], "min_n_voices_to_remove": 1,
              "max_n_voices_to_remove": 2, "prob": [1, 1], "k": 4}
    for sfs in ([None], ["a.sf2", "b.sf2", "c.sf2"]):
        for max_n_sf in (None, 2):
            rng_p, rng_j = random.Random(9), random.Random(9)
            for _ in range(3):  # the same stream, draw after draw
                assert (Samp.get_sf_v_combinations(params, 5, max_n_sf, sfs, rng=rng_p)
                        == JSamp.get_sf_v_combinations(params, 5, max_n_sf, sfs, rng=rng_j))
    seq_p, seq_j = Syn.synthetic_gmd_sequences(4, seed=3), JSyn.synthetic_gmd_sequences(4, seed=3)
    for p, j in zip(seq_p, seq_j):
        sparse = dict(params, voice_idx=[0, 1, 5, 6], min_n_voices_to_remove=2,
                      max_n_voices_to_remove=3, prob=[1, 1])
        assert Samp.get_voice_idx_for_item(p, sparse) == JSamp.get_voice_idx_for_item(j, sparse)
    assert Samp.get_voice_combinations(voice_idx=[1], min_n_voices_to_remove=2) == []
    for spec in (None, "kit.sf2", ["x.sf2", None], "no/such/dir"):
        assert Samp.get_sf_list(spec) == JSamp.get_sf_list(spec)


def test_synthetic_corpus_and_experiments_match_jax():
    for n, seed in ((23, 0), (5, 100)):
        for p, j in zip(Syn.synthetic_gmd_sequences(n, seed=seed),
                        JSyn.synthetic_gmd_sequences(n, seed=seed), strict=True):
            same_record(p, j)
    assert E.EXPERIMENTS == JE.EXPERIMENTS and E.TESTING_MASTER_IDS == JE.TESTING_MASTER_IDS
    for exp in E.EXPERIMENTS:
        for testing in (False, True):
            assert E.params_for(exp, testing) == JE.params_for(exp, testing)
    params = E.params_for("InfillingRandom")
    params["max_aug_items"] = 0
    assert E.params_for("InfillingRandom")["max_aug_items"] == 10  # a deep copy


def test_subsetter_matches_jax(tmp_path):
    port, jax = Syn.synthetic_gmd_sequences(30, seed=1), JSyn.synthetic_gmd_sequences(30, seed=1)
    filters = [{"style_primary": ["funk", "rock"]}, {"master_id": JE.TESTING_MASTER_IDS},
               {"beat_type": "beat", "time_signature": ["4-4"], "bpm": None}, None]
    tags, subsets = Sub.GrooveMidiSubsetter(
        sequences=port, list_of_filter_dicts_for_subsets=filters).create_subsets()
    jtags, jsubsets = JSub.GrooveMidiSubsetter(
        sequences=jax, list_of_filter_dicts_for_subsets=filters).create_subsets()
    assert tags == jtags and [len(s) for s in subsets] == [len(s) for s in jsubsets]
    for s, js in zip(subsets, jsubsets):
        for p, j in zip(s, js):
            same_record(p, j)
    with pytest.raises(ValueError, match="unknown subset filter"):
        Sub.GrooveMidiSubsetter(sequences=port,
                                list_of_filter_dicts_for_subsets=[{"style": "x"}]).create_subsets()
    # a corpus pickle the JAX package wrote, read from disk as the port's records
    tree = tmp_path / "GrooveMIDI_processed_train"
    tree.mkdir()
    with open(tree / "hvo_sequence_data.obj", "wb") as f:
        pickle.dump(jax[:4], f)
    _t, (loaded,) = Sub.GrooveMidiSubsetter(pickle_source_path=str(tmp_path),
                                            subset=tree.name).create_subsets()
    assert all(type(s) is Seq.HVOSequence for s in loaded)
    for p, j in zip(loaded, jax):
        same_record(p, j)
    with pytest.raises(FileNotFoundError):
        Sub.GrooveMidiSubsetter(pickle_source_path=str(tmp_path), subset="none").create_subsets()


# ---------------------------------------------------------------- reference-era pickles


def _forge_reference_modules(mangled: bool):
    """Fake ``hvo_sequence`` modules shaped like the reference's (as
    tests/test_legacy_pickle.py forges them); ``mangled``: state behind
    name-mangled private attributes, as the real library keeps it."""
    pkg, sub = types.ModuleType("hvo_sequence"), types.ModuleType("hvo_sequence.hvo_seq")

    def attrs(obj, prefix, **kw):
        for k, v in kw.items():
            setattr(obj, f"_{prefix}__{k}" if mangled else k, v)

    class Metadata:
        def __init__(self, **kw):
            attrs(self, "Metadata", **kw)

    class Time_Signature:
        def __init__(self):
            attrs(self, "Time_Signature", time_step=0, numerator=3, denominator=4)

    class Tempo:
        def __init__(self, qpm):
            attrs(self, "Tempo", time_step=0, qpm=qpm)

    class HVO_Sequence:
        def __init__(self, hvo, style, bpm):
            attrs(self, "HVO_Sequence", hvo=hvo, time_signatures=[Time_Signature()],
                  tempos=[Tempo(bpm)],
                  metadata=Metadata(drummer="d1", session="s1", master_id="d1/s1/0",
                                    style_primary=style, style_secondary="",
                                    beat_type="beat", loop_id="0", bpm=bpm))

    for cls in (Metadata, Time_Signature, Tempo, HVO_Sequence):
        cls.__module__ = "hvo_sequence.hvo_seq"
        cls.__qualname__ = cls.__name__
        setattr(sub, cls.__name__, cls)
        setattr(pkg, cls.__name__, cls)
    return pkg, sub, HVO_Sequence


@pytest.mark.parametrize("mangled", [False, True])
def test_legacy_load_matches_jax_on_forged_reference_pickles(mangled, rng, monkeypatch):
    pkg, sub, HVO_Sequence = _forge_reference_modules(mangled)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "hvo_sequence", pkg)
        m.setitem(sys.modules, "hvo_sequence.hvo_seq", sub)
        processed = {
            "processed_inputs": torch.from_numpy(rng.random((3, 32, 16)).astype(np.float32)),
            "processed_outputs": torch.from_numpy(rng.random((3, 32, 27)).astype(np.float32)),
            "hvo_sequences": [HVO_Sequence(rng.random((32, 27)), "latin", 101.0)],
            "hvo_sequences_inputs": [HVO_Sequence(rng.random((32, 27)), "funk", 90.0)],
            "voices_reduced": [[2]], "unused_items": [],
        }
        blob = pickle.dumps(processed)
    with pytest.raises(Exception):
        pickle.loads(blob)  # the forged modules are gone
    got = D._normalize_legacy_processed(L.legacy_load(blob))
    want = JD._normalize_legacy_processed(JL.legacy_load(blob))
    assert got.keys() == want.keys()
    for key in ("processed_inputs", "processed_outputs"):
        assert got[key].dtype == np.float32 and np.array_equal(got[key], want[key])
    for key in ("hvo_sequences", "hvo_sequences_inputs"):
        assert type(got[key][0]) is Seq.HVOSequence
        same_record(got[key][0], want[key][0])
    assert str(got["hvo_sequences"][0].time_signatures[0]) == "3-4"
    assert got["voices_reduced"] == [[2]]
    # an object with no HVO state converts to the default record in both
    blank = pickle.dumps(types.SimpleNamespace())
    same_record(L.to_native(L.legacy_load(blank)), JL.to_native(JL.legacy_load(blank)))


def test_pickles_name_the_jax_classes_and_refuse_other_jax_names(tmp_path):
    seq = Syn.synthetic_gmd_sequences(1, seed=2)[0]
    path = str(tmp_path / "s.pickle")
    serialization.save_to_pickle({"s": [seq], "a": np.arange(3)}, path)
    raw = open(path, "rb").read()
    assert b"transformergrooveinfilling_tpu.hvo.sequence" in raw
    assert b"transformergrooveinfilling_tpu_torch" not in raw
    jax_side = pickle.loads(raw)  # this process has the JAX package
    assert type(jax_side["s"][0]) is JSeq.HVOSequence
    same_record(jax_side["s"][0], seq)
    back = serialization.load_pickle(path)
    assert type(back["s"][0]) is Seq.HVOSequence and np.array_equal(back["a"], np.arange(3))
    from transformergrooveinfilling_tpu.data.datasets import GrooveMidiDatasetInfilling
    from transformergrooveinfilling_tpu.models.transformer import GrooveTransformerConfig

    # the datasets and evaluators cross too (evaluator pickles hold them)
    assert L.legacy_load(pickle.dumps(GrooveMidiDatasetInfilling)) is D.GrooveMidiDatasetInfilling
    with pytest.raises(pickle.UnpicklingError, match="would import jax"):
        L.legacy_load(pickle.dumps(GrooveTransformerConfig))


# ---------------------------------------------------------------- datasets


@pytest.mark.parametrize("exp", E.EXPERIMENTS)
def test_dataset_matches_jax(exp, tmp_path):
    """The same 10-loop corpus (one silent loop, one with no hi-hat, so that
    items go unused) and seed through both packages' dataset class."""
    port, jax = Syn.synthetic_gmd_sequences(10, seed=5), JSyn.synthetic_gmd_sequences(10, seed=5)
    for seqs in (port, jax):
        seqs[3].hvo[:] = 0.0
        seqs[4].hvo[:, [2, 11, 20]] = 0.0
    got = build(D, exp, port, tmp_path / "port", device="cpu")
    want = build(JD, exp, jax, tmp_path / "jax")
    assert type(got).__name__ == type(want).__name__ and len(got) == len(want) > 0
    for key in EXACT_KEYS:
        if hasattr(want, key):
            g, w = getattr(got, key), getattr(want, key)
            assert type(g) is type(w), key
            assert np.array_equal(g, w) if isinstance(w, np.ndarray) else g == w, key
    for key in SEQ_KEYS:
        assert len(getattr(got, key)) == len(getattr(want, key))
        for p, j in zip(getattr(got, key), getattr(want, key)):
            assert type(p) is Seq.HVOSequence
            same_record(p, j)
    assert got.processed_inputs.dtype == np.float32
    if "Symbolic" in exp:
        assert np.array_equal(got.processed_inputs, want.processed_inputs)
    else:
        mso_close(got.processed_inputs, want.processed_inputs)
    assert got.get_params().keys() == want.get_params().keys()
    assert got.save_dataset_path.endswith(os.path.join(got.__version__, "train"))
    for idx in (0, len(got) - 1):
        same_record(got.get_hvo_sequence(idx), want.get_hvo_sequence(idx))
        assert np.array_equal(got[idx][1], want[idx][1]) and got[idx][2] == idx


@pytest.mark.parametrize("exp", ["InfillingClosedHH_Symbolic", "InfillingRandom"])
def test_dataset_directories_load_in_either_package(exp, tmp_path):
    port, jax = Syn.synthetic_gmd_sequences(6, seed=8), JSyn.synthetic_gmd_sequences(6, seed=8)
    by_port = build(D, exp, port, tmp_path / "port", device="cpu")
    by_jax = build(JD, exp, jax, tmp_path / "jax")
    for writer, loader, cls in ((by_jax, D, Seq.HVOSequence), (by_port, JD, JSeq.HVOSequence)):
        loaded = loader.load_processed_dataset(writer.save_dataset_path, exp)
        assert type(loaded).__name__ == type(writer).__name__
        assert loaded.dataset_name == writer.dataset_name
        for key in ("processed_inputs", "processed_outputs") + EXACT_KEYS:
            if hasattr(writer, key):
                a, b = getattr(loaded, key), getattr(writer, key)
                assert np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b, key
        for key in SEQ_KEYS:
            for a, b in zip(getattr(loaded, key), getattr(writer, key), strict=True):
                assert type(a) is cls
                same_record(a, b)
        assert loaded.get_params().keys() == writer.get_params().keys()


def test_dataset_builds_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs = Syn.synthetic_gmd_sequences(2, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.GrooveMidiDatasetInfillingRandom(data=seqs, save=False)


def test_process_dataset_cli_matches_jax(tmp_path, monkeypatch):
    """Both packages' ``process_dataset`` command lines, ``--testing`` on 8
    synthetic loops a split, write the same directories: every split's
    pickles equal in all but the MSO inputs and the timestamp."""
    sys.path.insert(0, REPO)
    try:
        import process_dataset as jax_cli
    finally:
        sys.path.remove(REPO)
    from transformergrooveinfilling_tpu_torch import process_dataset as port_cli

    argv = ["--experiments", "InfillingKicksAndSnares", "InfillingClosedHH_Symbolic",
            "--testing", "--n-synthetic", "8", "--splits", "train", "validation"]
    for name, run in (("jax", lambda: jax_cli.main(argv)),
                      ("port", lambda: port_cli.main(argv + ["--device", "cpu"]))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        run()
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(names) == 8 and names == sorted(
        os.path.relpath(os.path.join(d, f), tmp_path / "port")
        for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    for name in names:
        want = JL.legacy_load(str(tmp_path / "jax" / name))
        got = serialization.load_pickle(str(tmp_path / "port" / name))
        assert got.keys() == want.keys()
        for key, value in want.items():
            if key == "timestamp":
                continue
            if key == "processed_inputs" and "Symbolic" not in name:
                mso_close(got[key], value)
            elif key in SEQ_KEYS:
                for a, b in zip(got[key], value, strict=True):
                    same_record(a, b)
            elif isinstance(value, np.ndarray):
                assert np.array_equal(got[key], value), (name, key)
            else:
                assert got[key] == value, (name, key)


def test_loading_a_jax_written_dataset_keeps_jax_out(tmp_path):
    """A fresh interpreter imports the port's command lines and data modules
    and loads a dataset directory the JAX package wrote: neither jax nor the
    JAX package gets imported."""
    jax_ds = build(JD, "InfillingRandom", JSyn.synthetic_gmd_sequences(3, seed=4), tmp_path)
    script = (
        "import sys, json\n"
        "import transformergrooveinfilling_tpu_torch.process_dataset\n"
        "import transformergrooveinfilling_tpu_torch.train.__main__\n"
        "from transformergrooveinfilling_tpu_torch.data import (datasets, experiments, "
        "legacy_pickle, pipeline, samplers, subsetter, synthetic)\n"
        f"ds = datasets.load_processed_dataset({jax_ds.save_dataset_path!r}, 'InfillingRandom')\n"
        "print(json.dumps({'n': len(ds), 'cls': type(ds.hvo_sequences[0]).__module__,\n"
        "  'leaked': sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "                   or m.split('.')[0] == 'transformergrooveinfilling_tpu')}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, check=True,
                         capture_output=True, text=True).stdout
    result = json.loads(out.strip().splitlines()[-1])
    assert result == {"n": len(jax_ds), "cls": "transformergrooveinfilling_tpu_torch.hvo.sequence",
                      "leaked": []}
