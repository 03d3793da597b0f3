"""The port's ``eval/evaluator.py`` against the JAX package's on the CPU, on
``test_evaluator.py``'s fixture (``synthetic_gmd_sequences(40, seed=13)``, a
symbolic dataset): subsets, tags, the GT and processed arrays, templates and
sample locations equal; ``set_pred`` with a perfect model and with a seeded
model whose flax parameters ``models/torch_compat.py`` carries over (hits
may differ only where JAX's sigmoid lies within 1e-4 of 0.5, velocities and
offsets within 1e-5, the families to match); the media helpers; ``log_eval``'s
keys and its deferred media pass; evaluator pickles across the packages both
ways, symbolic and a small ``InfillingRandom`` audio evaluator (16 loops, MSO
inputs within atol 1e-5·max); ``synthesize_hvo_list``."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu.audio import synth as JSynth
from transformergrooveinfilling_tpu.data import datasets as JD
from transformergrooveinfilling_tpu.data import synthetic as JSyn
from transformergrooveinfilling_tpu.eval import evaluator as JE
from transformergrooveinfilling_tpu.models import build_model as jax_build_model
from transformergrooveinfilling_tpu.models import predict as jax_predict
from transformergrooveinfilling_tpu.models.transformer import (
    GrooveTransformerConfig as JaxConfig,
)
from transformergrooveinfilling_tpu.utils import logging as jax_xlog
from transformergrooveinfilling_tpu_torch.audio import synth as Synth
from transformergrooveinfilling_tpu_torch.data import datasets as D
from transformergrooveinfilling_tpu_torch.data import synthetic as Syn
from transformergrooveinfilling_tpu_torch.eval import evaluator as E
from transformergrooveinfilling_tpu_torch.hvo import N_VOICES, VOICE_NAMES
from transformergrooveinfilling_tpu_torch.models import GrooveTransformerConfig
from transformergrooveinfilling_tpu_torch.models.torch_compat import state_dict_from_flax_params
from transformergrooveinfilling_tpu_torch.train import create_train_state
from transformergrooveinfilling_tpu_torch.train.driver import ModelBundle
from transformergrooveinfilling_tpu_torch.utils import logging as xlog

CLOSED_HH = {"voice_idx": [2], "min_n_voices_to_remove": 1, "max_n_voices_to_remove": 1,
             "prob": [1], "k": 5}
ARCH = dict(d_model=16, n_heads=2, dim_feedforward=32, num_encoder_layers=2,
            embedding_size_src=27)


class PerfectModel:
    def __init__(self, gt):
        self.gt = np.asarray(gt)

    def predict(self, inputs, use_thres=True, thres=0.5):
        return [self.gt[..., :9], self.gt[..., 9:18], self.gt[..., 18:27]]


def _build(pkg_ds, pkg_ev, syn, tmp, **extra):
    seqs = syn.synthetic_gmd_sequences(40, seed=13)
    ds = pkg_ds.GrooveMidiDatasetInfillingSymbolic(
        data=seqs, dataset_name="EvalDS", split="test", save_dataset_path=str(tmp),
        voices_params=CLOSED_HH, max_aug_items=2, seed=3, save=False, **extra)
    return pkg_ev.InfillingEvaluator(
        _identifier="Test_Set", n_samples_to_use=64,
        n_samples_to_synthesize_visualize_per_subset=2, dataset=ds, sequences=seqs,
        horizontal=True, **extra)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(port evaluator, JAX evaluator) on the same corpus and seeds."""
    tmp = tmp_path_factory.mktemp("ds")
    return (_build(D, E, Syn, tmp, device="cpu"), _build(JD, JE, JSyn, tmp))


def _same_state(port, jax_ev):
    assert port._gt_tags == jax_ev._gt_tags and len(port._gt_tags) > 1
    assert port._gt_hvos_array_tags == jax_ev._gt_hvos_array_tags
    assert port.audio_sample_locations == jax_ev.audio_sample_locations
    assert port.hvo_index == jax_ev.hvo_index and port.unused_items == jax_ev.unused_items
    for name in ("_gt_hvos_array", "_gmd_gt_hvos_array", "processed_gt"):
        np.testing.assert_array_equal(getattr(port, name), getattr(jax_ev, name), err_msg=name)
    assert [len(s) for s in port._gt_subsets] == [len(s) for s in jax_ev._gt_subsets]
    for a, b in zip(port._prediction_hvo_seq_templates, jax_ev._prediction_hvo_seq_templates):
        assert a.metadata.to_dict() == b.metadata.to_dict() and not a.hvo.any()


def test_evaluator_state_matches_jax(pair):
    port, jax_ev = pair
    _same_state(port, jax_ev)
    np.testing.assert_array_equal(port.processed_inputs, jax_ev.processed_inputs)
    assert port.gt_SubSet_Evaluator.tags == jax_ev.gt_SubSet_Evaluator.tags


def test_perfect_prediction_families_match_jax(pair):
    port, jax_ev = pair
    for ev in pair:
        ev.set_pred(PerfectModel(ev._gt_hvos_array))
    got = {**port.get_hits_accuracies(), **port.get_velocity_errors(),
           **port.get_micro_timing_errors()}
    want = {**jax_ev.get_hits_accuracies(), **jax_ev.get_velocity_errors(),
            **jax_ev.get_micro_timing_errors()}
    assert got == want and got["Test_Set_Hits_Accuracy_mean"] == 1.0
    assert port.get_rhythmic_distances() == jax_ev.get_rhythmic_distances()
    assert port._prediction_tags == jax_ev._prediction_tags
    assert port._subset_hvo_array_index == jax_ev._subset_hvo_array_index
    for key, comps in port.hvo_comp_dict.items():
        for a, b in zip(comps, jax_ev.hvo_comp_dict[key]):
            np.testing.assert_array_equal(a.hvo, b.hvo)


def test_seeded_model_families_match_jax_by_the_hit_rule(pair):
    port, jax_ev = pair
    jax_cfg, cfg = JaxConfig(dropout=0.0, **ARCH), GrooveTransformerConfig(dropout=0.0, **ARCH)
    jax_model = jax_build_model(jax_cfg)
    params = jax_model.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 27)),
                            deterministic=True)["params"]
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.3 * rng.standard_normal(a.shape).astype(np.float32), params)
    state = create_train_state(cfg, "sgd", 0.05, 0, "cpu")
    state.model.load_state_dict(state_dict_from_flax_params(params, cfg), strict=True)
    bundle = ModelBundle(model=state.model, config=cfg, state=state, device=torch.device("cpu"))

    class JaxModel:
        def predict(self, inputs, use_thres=True, thres=0.5):
            return [np.asarray(a) for a in jax_predict(jax_model, params, jnp.asarray(inputs),
                                                       use_thres=use_thres, thres=thres)]

    port.set_pred(bundle)
    jax_ev.set_pred(JaxModel())
    got, want = port._prediction_hvos_array, jax_ev._prediction_hvos_array
    sig = JaxModel().predict(jax_ev.processed_inputs, use_thres=False)[0]
    near = np.abs(sig - 0.5) < 1e-4
    assert np.array_equal(got[..., :9][~near], want[..., :9][~near])
    assert 0.05 < want[..., :9].mean() < 0.95  # the threshold does decide
    np.testing.assert_allclose(got[..., 9:], want[..., 9:], atol=1e-5)
    flips = (got[..., :9] != want[..., :9]).sum(axis=(0, 1)) / (got.shape[0] * got.shape[1])
    g, w = port.get_hits_accuracies(), jax_ev.get_hits_accuracies()
    for i, name in enumerate(VOICE_NAMES):
        key = f"Test_Set_Hits_Accuracy_{name}"
        assert abs(g[key] - w[key]) <= flips[i] + 1e-6, key
    for mine, theirs in ((port.get_velocity_errors(), jax_ev.get_velocity_errors()),
                         (port.get_micro_timing_errors(), jax_ev.get_micro_timing_errors())):
        assert list(mine) == list(theirs)
        np.testing.assert_allclose(list(mine.values()), list(theirs.values()), atol=1e-5)


def test_media_helpers_match_jax(pair):
    port, jax_ev = pair
    for ev in pair:
        ev.set_pred(PerfectModel(ev._gt_hvos_array))
    key = next(k for k in port.audio_sample_locations if port.hvo_comp_dict.get(k))
    p_sub, j_sub = port.prediction_SubSet_Evaluator, jax_ev.prediction_SubSet_Evaluator
    merged = p_sub.add_removed_part_to_hvo(p_sub.subsets[key][0].copy(), key, 0)
    want = j_sub.add_removed_part_to_hvo(j_sub.subsets[key][0].copy(), key, 0)
    np.testing.assert_array_equal(merged.hvo, want.hvo)
    comp = port.hvo_comp_dict[key][0]
    rows, cols = np.nonzero(comp.hvo[:, :N_VOICES])
    np.testing.assert_array_equal(merged.hvo[rows, cols + N_VOICES], comp.hvo[rows, cols + N_VOICES])
    for heat in (True, False):  # analyze_heatmap and the horizontal flag
        p_sub.analyze_heatmap = j_sub.analyze_heatmap = heat
        for horizontal in (True, False):
            p_sub.horizontal = j_sub.horizontal = horizontal
            got = p_sub.get_logging_dict(global_features_html=False, audio_files=False)
            want = j_sub.get_logging_dict(global_features_html=False, audio_files=False)
            assert got.keys() == want.keys() and ("velocity_heatmaps" in got) == heat
            if heat:
                norm = [v.split('name="tabs-')[0] for v in (got["velocity_heatmaps"],
                                                             want["velocity_heatmaps"])]
                assert norm[0] == norm[1]
                assert ("t31" in got["velocity_heatmaps"]) == (not horizontal)
    audio = p_sub.get_audios(use_specific_samples_at=port.audio_sample_locations)
    want_audio = j_sub.get_audios(use_specific_samples_at=jax_ev.audio_sample_locations)
    assert [c for c, _ in audio] == [c for c, _ in want_audio] and audio
    for (_, a), (_, b) in zip(audio, want_audio):
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())
    for sizes, budget in (([5, 3, 2], 100), ([80, 10, 10], 20), ([1000, 1, 1, 1], 10),
                          ([5, 5, 5, 5], 2), ([2, 100], 50), ([0, 7, 3], 4)):
        assert E.proportional_budget(sizes, budget) == JE.proportional_budget(sizes, budget)
    assert E.style_filters() == JE.style_filters()


def test_sf2_audio_stays_empty_and_a_mixer_fault_raises(pair, monkeypatch, tmp_path):
    """The media pass's audio through a SoundFont kit equals the JAX
    package's. Unlike the JAX package, which catches every exception there
    and leaves the audio empty, a missing kit and a fault of the mixer raise
    (ROADMAP §C6)."""
    port, jax_ev = pair
    kit = _kit(tmp_path)
    for ev in pair:
        ev.set_pred(PerfectModel(ev._gt_hvos_array))
    sub, j_sub = port.prediction_SubSet_Evaluator, jax_ev.prediction_SubSet_Evaluator
    for s in (sub, j_sub):
        s.sf_dict = {k: [kit] * len(v) for k, v in s.hvo_comp_dict.items()}
    quiet = dict(global_features_html=False, piano_roll_html=False, velocity_heatmap_html=False)
    got = sub.get_logging_dict(**quiet)["captions_audios"]
    want = j_sub.get_logging_dict(**quiet)["captions_audios"]
    assert [c for c, _ in got] == [c for c, _ in want] and got
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    sub.sf_dict = {k: [str(tmp_path / "missing.sf2")] * len(v)
                   for k, v in sub.hvo_comp_dict.items()}
    with pytest.raises(FileNotFoundError):
        sub.get_logging_dict(**quiet)

    def broken(*a, **k):
        raise ValueError("mixer fault")

    monkeypatch.setattr(Synth, "synthesize_hvo_list", broken)
    sub.sf_dict = {}
    with pytest.raises(ValueError, match="mixer fault"):
        sub.get_logging_dict(**quiet)


def _kit(tmp_path):
    """A kit whose kick has two velocity layers and whose snare is
    attenuated; the other voices are the procedural kit's."""
    from transformergrooveinfilling_tpu_torch.audio.sf2 import write_minimal_sf2

    t = np.arange(4000) / 44100
    path = str(tmp_path / "kit.sf2")
    write_minimal_sf2(path, {36: [{"sample": 0.9 * np.sin(2 * np.pi * 80 * t), "vel_hi": 70},
                                  {"sample": 0.9 * np.sin(2 * np.pi * 55 * t), "vel_lo": 71}],
                             38: [{"sample": 0.6 * np.sin(2 * np.pi * 300 * t),
                                   "atten_cb": 60}]})
    return path


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_log_eval_keys_match_jax_and_a_deferred_pass_keeps_its_epoch(pair, tmp_path,
                                                                     monkeypatch):
    monkeypatch.setenv("WANDB_MODE", "offline")
    monkeypatch.chdir(tmp_path)
    keys, csvs = [], []
    for ev, log in ((pair[0], xlog), (pair[1], jax_xlog)):
        log.init(config={}, project="eval_keys", run_dir=str(tmp_path / log.__name__))
        run_dir, run_id = log.run.dir, log.run.id
        deferred = []
        module = E if log is xlog else JE
        module.log_eval(ev, PerfectModel(ev._gt_hvos_array), log_media=True, epoch=7,
                        dump=log is xlog, defer=deferred.append)
        zero = np.zeros_like(ev._gt_hvos_array)
        ev.set_pred(PerfectModel(zero))  # a later epoch replaces the predictions
        deferred[0]()
        log.finish()
        records = _records(run_dir)
        keys.append([sorted(r) for r in records])
        with open(os.path.join(run_dir, f"stats_{run_id}_Epoch_7.csv")) as f:
            csvs.append(f.read())
        stats = [r for r in records if "Test_Set_stats" in r]
        assert len(stats) == 1 and stats[0]["epoch"] == 7
        assert any("epoch_7" in f for f in os.listdir(os.path.join(run_dir, "media")))
    assert keys[0] == keys[1]
    assert csvs[0] == csvs[1]
    (dump,) = os.listdir(tmp_path / "evaluator")
    assert dump.endswith("_Epoch_7.Eval")
    loaded = JE.init_evaluator(str(tmp_path / "evaluator" / dump))
    assert type(loaded) is JE.InfillingEvaluator and loaded._identifier == "Test_Set"


def test_symbolic_pickles_cross_both_ways(pair, tmp_path, monkeypatch):
    port, jax_ev = pair
    from_port = JE.init_evaluator(port.save_as_pickle(str(tmp_path / "port")))
    jax_pickle = jax_ev.save_as_pickle(str(tmp_path / "jax"))
    from_jax = E.init_evaluator(jax_pickle, device="cpu")
    assert type(from_port) is JE.InfillingEvaluator
    assert type(from_port.dataset) is JD.GrooveMidiDatasetInfillingSymbolic
    assert type(from_jax) is E.InfillingEvaluator
    assert type(from_jax.dataset) is D.GrooveMidiDatasetInfillingSymbolic
    assert from_jax.device == torch.device("cpu") and from_jax.dataset._device == from_jax.device
    _same_state(from_jax, jax_ev)
    _same_state(port, from_port)
    for ev in (from_port, from_jax):
        ev.set_pred(PerfectModel(ev._gt_hvos_array))
        assert ev.get_hits_accuracies()["Test_Set_Hits_Accuracy_mean"] == 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.init_evaluator(jax_pickle)  # the card is the default


def _audio_evaluator(pkg_ds, pkg_ev, syn, tmp, **extra):
    seqs = syn.synthetic_gmd_sequences(16, seed=5)
    ds = pkg_ds.GrooveMidiDatasetInfillingRandom(
        data=seqs, dataset_name="InfillingRandom", split="validation",
        save_dataset_path=str(tmp), max_aug_items=2, seed=8, save=False, **extra)
    return pkg_ev.InfillingEvaluator(
        _identifier="Validation_Set", n_samples_to_use=1024,
        n_samples_to_synthesize_visualize_per_subset=2, dataset=ds, sequences=seqs,
        horizontal=False, **extra)


def test_audio_evaluator_matches_jax_and_pickles_cross(tmp_path):
    port = _audio_evaluator(D, E, Syn, tmp_path, device="cpu")
    jax_ev = _audio_evaluator(JD, JE, JSyn, tmp_path)
    assert isinstance(jax_ev.processed_inputs, np.ndarray)
    _same_state(port, jax_ev)
    assert port.soundfonts == jax_ev.soundfonts == [None] * len(port.soundfonts)
    want = jax_ev.processed_inputs
    np.testing.assert_allclose(port.processed_inputs, want, atol=1e-5 * np.abs(want).max(),
                               rtol=1e-4)
    from_port = JE.init_evaluator(port.save_as_pickle(str(tmp_path / "port")))
    from_jax = E.init_evaluator(jax_ev.save_as_pickle(str(tmp_path / "jax")), device="cpu")
    assert type(from_port.dataset) is JD.GrooveMidiDatasetInfillingRandom
    assert type(from_jax.dataset) is D.GrooveMidiDatasetInfillingRandom
    np.testing.assert_array_equal(from_port.processed_inputs, port.processed_inputs)
    np.testing.assert_array_equal(from_jax.processed_inputs, want)
    _same_state(from_jax, jax_ev)
    # the loaded dataset computes again, on the device init_evaluator gave it
    again = from_jax.dataset.process_dataset(from_jax._gmd_gt_hvo_sequences[:2])
    assert again["processed_inputs"].shape[1:] == (32, 16)
    # and through a SoundFont kit, as the JAX package's loaded dataset does
    kit = _kit(tmp_path)
    from_port.dataset.process_dataset(from_port._gmd_gt_hvo_sequences[:2])  # again's draws
    from_jax.dataset.sfs_list = from_port.dataset.sfs_list = [kit]
    with_kit = from_jax.dataset.process_dataset(from_jax._gmd_gt_hvo_sequences[:2])
    jax_kit = from_port.dataset.process_dataset(from_port._gmd_gt_hvo_sequences[:2])
    assert with_kit["soundfonts"] == jax_kit["soundfonts"] == [kit] * len(jax_kit["soundfonts"])
    want_kit = np.asarray(jax_kit["processed_inputs"])
    np.testing.assert_allclose(with_kit["processed_inputs"], want_kit,
                               atol=1e-5 * np.abs(want_kit).max(), rtol=1e-4)
    assert not np.allclose(with_kit["processed_inputs"], again["processed_inputs"])


@pytest.mark.parametrize("qpms", [[90.0, 120.0, 151.0], [100.0]])
def test_synthesize_hvo_list_matches_jax(rng, qpms, tmp_path):
    m = 3
    h = (rng.random((m, 32, 9)) < 0.3).astype(np.float32)
    grids = np.concatenate([h, h * rng.random(h.shape), h * (rng.random(h.shape) - 0.5)], -1)
    got = Synth.synthesize_hvo_list(grids, np.asarray(qpms), [None] * m)
    want = JSynth.synthesize_hvo_list(grids, np.asarray(qpms), [None] * m)
    assert [len(y) for y in got] == [len(y) for y in want]
    for y, w, g, q in zip(got, want, grids, np.broadcast_to(qpms, (m,))):
        assert y.dtype == np.float32
        np.testing.assert_allclose(y, w, atol=1e-4 * np.abs(w).max())
        np.testing.assert_array_equal(y, Synth.synthesize_hvo(g, qpm=float(q)))
    assert Synth.synthesize_hvo_list(np.zeros((0, 32, 27)), [], []) == []
    kits = [_kit(tmp_path), None, _kit(tmp_path)][:m]
    for y, w in zip(Synth.synthesize_hvo_list(grids, np.asarray(qpms), kits),
                    JSynth.synthesize_hvo_list(grids, np.asarray(qpms), kits)):
        np.testing.assert_array_equal(y, w)
