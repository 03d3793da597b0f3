"""The port's ``run_training`` and what it runs on, against the JAX package on
the CPU: the loss curve and ``metrics.jsonl`` of a 5-epoch run, the watch
histograms, the schedule, the logging run directory and the serialization
helpers; and in the port alone, interrupt + resume bit for bit and the
graceful stops (``tests/test_train.py``'s cases)."""

import json
import os
import signal

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu.models import build_model as jax_build_model
from transformergrooveinfilling_tpu.models.transformer import (
    GrooveTransformerConfig as JaxConfig,
)
from transformergrooveinfilling_tpu.parallel.mesh import make_mesh
from transformergrooveinfilling_tpu.train import checkpoint as jax_ckpt
from transformergrooveinfilling_tpu.train import driver as jax_driver
from transformergrooveinfilling_tpu.train import loop as jax_loop
from transformergrooveinfilling_tpu.train.config import HyperParams as JaxHyperParams
from transformergrooveinfilling_tpu.train.schedule import eval_log_freq as jax_eval_log_freq
from transformergrooveinfilling_tpu.utils import logging as jax_xlog
from transformergrooveinfilling_tpu.utils import serialization as jax_serialization
from transformergrooveinfilling_tpu_torch.models import GrooveTransformerConfig
from transformergrooveinfilling_tpu_torch.models import torch_compat
from transformergrooveinfilling_tpu_torch.train import (
    HyperParams, ModelBundle, checkpoint as ckpt, create_train_state, derive_model_config,
    eval_log_freq, initialize_model, make_watch_fn, run_training,
)
from transformergrooveinfilling_tpu_torch.hvo import VOICE_NAMES
from transformergrooveinfilling_tpu_torch.train.driver import make_eval_metric_fn
from transformergrooveinfilling_tpu_torch.train.driver import _GracefulStop
from transformergrooveinfilling_tpu_torch.utils import logging as xlog
from transformergrooveinfilling_tpu_torch.utils import serialization

HP = {"experiment": "InfillingClosedHH_Symbolic", "encoder_only": 1,
      "optimizer_algorithm": "sgd", "d_model": 32, "n_heads": 2, "dropout": 0.1,
      "num_encoder_decoder_layers": 1, "hit_loss_penalty": 0.5, "batch_size": 8,
      "dim_feedforward": 64, "learning_rate": 0.05, "epochs": 4}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class _Data:
    def __init__(self, rng, n):
        h = (rng.random((n, 32, 9)) < 0.3).astype(np.float32)
        self.processed_outputs = np.concatenate(
            [h, h * rng.uniform(0.4, 1.0, h.shape), h * rng.uniform(-0.25, 0.25, h.shape)],
            axis=-1).astype(np.float32)
        self.processed_inputs = self.processed_outputs.copy()
        self.processed_inputs[:, :, [2, 11, 20]] = 0


def _lines(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------- against JAX


def test_loss_curve_and_metrics_file_match_jax(tmp_path, rng):
    """f32, dropout 0, SGD, one full-batch step an epoch (the shuffle cannot
    matter), 5 epochs from the same weights: the loss curve within rtol
    2e-4, and every line of ``metrics.jsonl`` with the JAX run's keys (the
    watch lines' histogram keys, flax paths, included); the last
    checkpoints hold the same parameters within 1e-4."""
    spec = dict(HP, dropout=0.0, batch_size=16, epochs=5, learning_rate=0.5)
    data = _Data(rng, 16)
    jax_cfg = JaxConfig(d_model=32, n_heads=2, dim_feedforward=64, dropout=0.0,
                        num_encoder_layers=1, embedding_size_src=27)
    model = jax_build_model(jax_cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 27)), deterministic=True)["params"]
    tx = optax.sgd(spec["learning_rate"])
    jax_bundle = jax_driver.ModelBundle(
        model=model, config=jax_cfg, tx=tx,
        state=jax_loop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt_state=tx.init(params)))
    port_cfg = GrooveTransformerConfig(d_model=32, n_heads=2, dim_feedforward=64, dropout=0.0,
                                       num_encoder_layers=1, embedding_size_src=27)
    state = create_train_state(port_cfg, "sgd", spec["learning_rate"], 0, "cpu")
    state.model.load_state_dict(torch_compat.state_dict_from_flax_params(
        jax.tree.map(np.asarray, params), port_cfg))
    bundle = ModelBundle(model=state.model, config=port_cfg, state=state,
                         device=torch.device("cpu"), learning_rate=spec["learning_rate"])

    jax_xlog.init(run_dir=str(tmp_path / "jax_runs"))
    jax_dir = jax_xlog.run.dir
    jax_driver.run_training(JaxHyperParams.from_dict(spec), data, {}, bundle=jax_bundle,
                            plan=make_mesh(n_data=1), ckpt_dir=str(tmp_path / "jax_ck"),
                            watch_log_freq=2, log_media=False)
    jax_xlog.finish()
    xlog.init(run_dir=str(tmp_path / "port_runs"))
    port_dir = xlog.run.dir
    run_training(HyperParams.from_dict(spec), data, {}, bundle=bundle,
                 ckpt_dir=str(tmp_path / "port_ck"), watch_log_freq=2, log_media=False)
    xlog.finish()

    want, got = _lines(jax_dir), _lines(port_dir)
    assert len(got) == len(want) == 5
    assert [sorted(line) for line in got] == [sorted(line) for line in want]
    assert sum("gradients/encoder_layer_0/self_attn/qkv/kernel" in line for line in got) == 2
    np.testing.assert_allclose([line["loss"] for line in got], [line["loss"] for line in want],
                               rtol=2e-4)
    assert want[-1]["loss"] < want[0]["loss"]
    assert os.path.exists(os.path.join(port_dir, "curves.svg"))
    saved = {name: sorted(f.split("_Epoch_")[1] for f in os.listdir(tmp_path / name))
             for name in ("port_ck", "jax_ck")}
    assert saved["port_ck"] == saved["jax_ck"] == [f"{e}.ckpt" for e in range(5)]
    port_path, port_epoch = ckpt.find_latest(str(tmp_path / "port_ck"))
    jax_path, jax_epoch = jax_ckpt.find_latest(str(tmp_path / "jax_ck"))
    assert port_epoch == jax_epoch == 4
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=1e-4),
                 ckpt.load_checkpoint(port_path)[0], jax_ckpt.load_checkpoint(jax_path)[0])


def test_watch_histograms_match_jax(rng):
    """Same weights, dropout 0, one batch: the same keys in the same order;
    each tensor's counts equal to the JAX package's but for values on a bin
    edge (the cumulative counts differ by at most one at any edge), its
    edges equal within rounding."""
    jax_cfg = JaxConfig(d_model=32, n_heads=2, dim_feedforward=64, dropout=0.0,
                        num_encoder_layers=1, num_decoder_layers=1, embedding_size_src=27)
    port_cfg = GrooveTransformerConfig(d_model=32, n_heads=2, dim_feedforward=64, dropout=0.0,
                                       num_encoder_layers=1, num_decoder_layers=1,
                                       embedding_size_src=27)
    model = jax_build_model(jax_cfg)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 27)), jnp.zeros((1, 32, 27)),
                        deterministic=True)["params"]
    data = _Data(rng, 12)
    want = jax_loop.make_watch_fn(model, 0.5, 8, encoder_only=False)(
        params, jnp.asarray(data.processed_inputs), jnp.asarray(data.processed_outputs),
        jax.random.PRNGKey(0))
    state = create_train_state(port_cfg, "sgd", 0.1, 0, "cpu")
    state.model.load_state_dict(torch_compat.state_dict_from_flax_params(
        jax.tree.map(np.asarray, params), port_cfg))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    got = make_watch_fn(0.5, 8, encoder_only=False)(
        state.model, torch.from_numpy(data.processed_inputs),
        torch.from_numpy(data.processed_outputs), torch.Generator())
    assert list(got) == list(want)
    assert "gradients/decoder_layer_0/cross_attn/kv/kernel" in got
    for name, (counts, edges) in got.items():
        want_counts, want_edges = (np.asarray(a) for a in want[name])
        assert counts.shape == (64,) and counts.sum() == want_counts.sum(), name
        assert np.abs(np.cumsum(counts) - np.cumsum(want_counts)).max() <= 1, name
        np.testing.assert_allclose(edges, want_edges, rtol=1e-5, atol=1e-7, err_msg=name)
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
    assert all(p.grad is None for p in state.model.parameters())


def _evaluator_pair(tmp, seed):
    """A symbolic evaluator of each package (port, JAX) on the same corpus."""
    from transformergrooveinfilling_tpu.data import datasets as JD, synthetic as JSyn
    from transformergrooveinfilling_tpu.eval import evaluator as JE
    from transformergrooveinfilling_tpu_torch.data import datasets as D, synthetic as Syn
    from transformergrooveinfilling_tpu_torch.eval import evaluator as E

    out = []
    for ds_mod, ev_mod, syn, extra in ((D, E, Syn, {"device": "cpu"}), (JD, JE, JSyn, {})):
        seqs = syn.synthetic_gmd_sequences(24, seed=seed)
        ds = ds_mod.GrooveMidiDatasetInfillingSymbolic(
            data=seqs, dataset_name="EvalDS", split="test", save_dataset_path=str(tmp),
            voices_params={"voice_idx": [2], "min_n_voices_to_remove": 1,
                           "max_n_voices_to_remove": 1, "prob": [1], "k": 5},
            max_aug_items=2, seed=seed, save=False, **extra)
        out.append(ev_mod.InfillingEvaluator(
            _identifier="Test_Set", n_samples_to_use=64,
            n_samples_to_synthesize_visualize_per_subset=1, dataset=ds, sequences=seqs,
            **extra))
    return out


def _jax_bundle_and_port_bundle(seed, lr, layers=2):
    jax_cfg = JaxConfig(d_model=32, n_heads=2, dim_feedforward=64, dropout=0.0,
                        num_encoder_layers=layers, embedding_size_src=27)
    model = jax_build_model(jax_cfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 27)),
                        deterministic=True)["params"]
    tx = optax.sgd(lr)
    jax_bundle = jax_driver.ModelBundle(
        model=model, config=jax_cfg, tx=tx,
        state=jax_loop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt_state=tx.init(params)))
    port_cfg = GrooveTransformerConfig(d_model=32, n_heads=2, dim_feedforward=64, dropout=0.0,
                                       num_encoder_layers=layers, embedding_size_src=27)
    state = create_train_state(port_cfg, "sgd", lr, 0, "cpu")
    state.model.load_state_dict(torch_compat.state_dict_from_flax_params(
        jax.tree.map(np.asarray, params), port_cfg))
    bundle = ModelBundle(model=state.model, config=port_cfg, state=state,
                         device=torch.device("cpu"), learning_rate=lr)
    return jax_bundle, bundle, model


def test_run_training_with_evaluators_matches_jax(tmp_path, rng, monkeypatch):
    """2 layers at d 32, f32, dropout 0, full-batch SGD, 12 epochs in blocks
    of 10 from the same weights, on the same data and evaluators (a train and
    a validation set): block 1 holds media epochs (``log_eval``, media on the
    worker), block 2 is scalar-only (families from the eval pass). The same
    record key sets; held-out losses within rtol 2e-4; each hit-accuracy
    family within the share of cells whose sigmoid under the JAX run's saved
    weights lies within 1e-4 of 0.5, the MSE families within rtol 2e-4; the
    stats CSV and media of both packages."""
    from transformergrooveinfilling_tpu.models import predict as jax_predict

    monkeypatch.setenv("WANDB_MODE", "offline")
    spec = dict(HP, dropout=0.0, batch_size=16, epochs=12, learning_rate=0.1)
    data = _Data(rng, 16)
    jax_bundle, bundle, jax_model = _jax_bundle_and_port_bundle(0, spec["learning_rate"])
    sets = {"train": _evaluator_pair(tmp_path, 31), "validation": _evaluator_pair(tmp_path, 32)}
    runs = {}
    for name, log, train, kw in (
            ("jax", jax_xlog, jax_driver.run_training,
             {"bundle": jax_bundle, "plan": make_mesh(n_data=1)}),
            ("port", xlog, run_training, {"bundle": bundle})):
        log.init(run_dir=str(tmp_path / f"{name}_runs"))
        runs[name] = log.run.dir
        evaluators = {k: pair[name == "jax"] for k, pair in sets.items()}
        hp = (JaxHyperParams if name == "jax" else HyperParams).from_dict(spec)
        train(hp, data, evaluators, ckpt_dir=str(tmp_path / f"{name}_ck"), epoch_block=10,
              watch_log_freq=None, dump_eval=False, media_async=True, **kw)
        log.finish()
    want, got = _lines(runs["jax"]), _lines(runs["port"])
    assert sorted(sorted(line) for line in got) == sorted(sorted(line) for line in want)
    # the media records come from the worker thread, in either order
    scalars = list(zip([line for line in got if "loss" in line],
                       [line for line in want if "loss" in line]))
    assert [g["epoch"] for g, _ in scalars] == [w["epoch"] for _, w in scalars] == [9, 11]
    for g, w in scalars:
        for key in w:
            if key.startswith(("train_", "validation_")):
                np.testing.assert_allclose(g[key], w[key], rtol=2e-4, atol=1e-7, err_msg=key)

    def families(lines, epoch):
        return {k: v for line in lines if line.get("epoch") == epoch for k, v in line.items()
                if "_Set_" in k and not k.endswith("_stats")}

    for epoch in (9, 11):
        (ck,) = [f for f in os.listdir(tmp_path / "jax_ck") if f.endswith(f"_Epoch_{epoch}.ckpt")]
        params = jax_ckpt.load_checkpoint(str(tmp_path / "jax_ck" / ck))[0]
        g, w = families(got, epoch), families(want, epoch)
        assert g.keys() == w.keys() and len(g) == 2 * 30
        for set_name, (_port_ev, jax_ev) in sets.items():
            sig = np.asarray(jax_predict(jax_model, params, jnp.asarray(jax_ev.processed_inputs),
                                         use_thres=False)[0])
            near = (np.abs(sig - 0.5) < 1e-4).mean(axis=(0, 1))
            prefix = f"{set_name.capitalize()}_Set_"
            for i, voice in enumerate(VOICE_NAMES):
                key = f"{prefix}Hits_Accuracy_{voice}"
                assert abs(g[key] - w[key]) <= near[i] + 1e-6, (epoch, key)
            for key in w:
                if key.startswith(prefix) and "_MSE_" in key:
                    np.testing.assert_allclose(g[key], w[key], rtol=2e-4, atol=1e-7,
                                               err_msg=key)
    for run_dir in runs.values():
        files = os.listdir(run_dir)
        assert sum(f.startswith("stats_") and f.endswith("_Epoch_9.csv") for f in files) == 1
        assert any("epoch_9" in f for f in os.listdir(os.path.join(run_dir, "media")))


def test_make_eval_metric_fn_matches_jax(rng):
    """The port's ``make_eval_metric_fn`` against JAX's ``make_eval_metric_fn``
    (its ``_predict_metric_stacks``) on the same weights and inputs: hit
    accuracies within the share of cells whose JAX sigmoid lies within 1e-4
    of 0.5, the MSE stacks within 1e-5."""
    from transformergrooveinfilling_tpu.models import predict as jax_predict

    jax_bundle, bundle, jax_model = _jax_bundle_and_port_bundle(5, 0.1)
    x = (rng.random((40, 32, 27)) < 0.3).astype(np.float32)
    gt = _Data(rng, 40).processed_outputs
    params = jax_bundle.state.params
    want = [np.asarray(a) for a in jax_driver.make_eval_metric_fn(jax_model)(
        params, jnp.asarray(x), jnp.asarray(gt))]
    bundle.model.train()
    got = [a.numpy() for a in make_eval_metric_fn(bundle.model)(torch.from_numpy(x),
                                                                torch.from_numpy(gt))]
    assert bundle.model.training  # put back in the mode it was in
    sig = np.asarray(jax_predict(jax_model, params, jnp.asarray(x), use_thres=False)[0])
    near = (np.abs(sig - 0.5) < 1e-4).mean(axis=(0, 1))
    assert np.all(np.abs(got[0] - want[0]) <= near + 1e-6)
    np.testing.assert_allclose(got[1:], want[1:], atol=1e-5)


def test_media_worker_holds_a_failed_pass_and_prints_it_at_flush(capsys):
    from transformergrooveinfilling_tpu_torch.train.driver import _MediaWorker

    done = []

    def broken():
        raise ValueError("no disk")

    worker = _MediaWorker()
    worker.submit(broken)
    worker.submit(lambda: done.append(1))
    worker.close()
    out = capsys.readouterr().out
    assert done == [1] and not worker._thread.is_alive()
    assert "media worker: a deferred media pass failed" in out
    assert "ValueError: no disk" in out and "in broken" in out


def test_eval_log_freq_matches_jax():
    for total in (1, 2, 5, 9, 10, 11, 19, 20, 21, 57, 100, 500, 3000):
        for only_final in (False, True):
            for steps in ((1, 1, 10, 20), (2, 3, 7, 13)):
                got = eval_log_freq(total, 10, *steps, only_final=only_final)
                want = jax_eval_log_freq(total, 10, *steps, only_final=only_final)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)


def test_logging_run_directory_matches_jax(tmp_path):
    """The same calls through both packages' logging modules leave the same
    files: metrics.jsonl (but its timestamps), media, config.json, curves."""
    dirs = {}
    for name, mod in (("jax", jax_xlog), ("port", xlog)):
        run = mod.init(config={"lr": 0.1, "layers": 2}, run_dir=str(tmp_path / name))
        mod.config.update({"extra": "x"})
        for ep in range(3):
            mod.log({"loss": 1.0 / (ep + 1), "validation_loss": 2.0 / (ep + 1),
                     "hit_accuracy": 0.5, "epoch": ep}, commit=False)
            mod.log({"epoch": ep, "scalar": np.float32(0.25)}, commit=True)
        mod.log({"hist": mod.Histogram(np.array([1, 2]), np.array([0.0, 0.5, 1.0])),
                 "page": mod.Html("<b>x</b>"), "pages": [mod.Html("a"), mod.Html("b")],
                 "wav": mod.Audio(np.linspace(-1, 1, 200), caption="loop.wav",
                                  sample_rate=8000),
                 "nested": {"a": 1}}, commit=True)
        mod.log_record({"worker": 1})
        mod.finish()
        dirs[name] = run.dir
    files = {name: sorted(os.path.relpath(os.path.join(r, f), d)
                          for r, _, fs in os.walk(d) for f in fs)
             for name, d in dirs.items()}
    assert files["port"] == files["jax"]
    for rel in files["port"]:
        with open(os.path.join(dirs["port"], rel), "rb") as a, \
                open(os.path.join(dirs["jax"], rel), "rb") as b:
            got, want = a.read(), b.read()
        if rel == "metrics.jsonl":
            got, want = ([{k: v for k, v in json.loads(line).items() if k != "_timestamp"}
                          for line in blob.splitlines()] for blob in (got, want))
        assert got == want, rel


def test_logging_stays_local_unless_wandb_is_asked_for(tmp_path, monkeypatch):
    """An importable wandb (a machine may have it and no network) is used
    only with WANDB_MODE=online; otherwise runs are local and ``log``
    without a run does nothing."""
    import sys
    import types

    calls = []
    fake = types.ModuleType("wandb")
    fake.log = fake.init = fake.finish = lambda *a, **k: calls.append(a)
    fake.config = {}
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.delenv("WANDB_MODE", raising=False)
    monkeypatch.setattr(xlog, "_real_wandb", None)
    xlog.log({"loss": 1.0})  # no run: nothing happens
    run = xlog.init(run_dir=str(tmp_path))
    xlog.log({"loss": 1.0})
    xlog.finish()
    assert not calls and os.path.exists(os.path.join(run.dir, "metrics.jsonl"))
    monkeypatch.setenv("WANDB_MODE", "online")
    xlog.log({"loss": 2.0})
    assert calls == [({"loss": 2.0},)]


def test_serialization_helpers_match_jax(tmp_path):
    params = {"dataset_name": "ds", "n": np.int64(3), "x": np.float32(0.5),
              "a": np.arange(3)}
    assert (json.dumps(params, cls=serialization.NpEncoder)
            == json.dumps(params, cls=jax_serialization.NpEncoder))
    got = serialization.save_parameters_to_json(params, str(tmp_path / "port"))
    want = jax_serialization.save_parameters_to_json(params, str(tmp_path / "jax"))
    with open(got) as a, open(want) as b:
        assert a.read() == b.read()
    serialization.save_to_pickle({"k": [1, 2]}, str(tmp_path / "p" / "x.pickle"))
    assert jax_serialization.load_pickle(str(tmp_path / "p" / "x.pickle")) == {"k": [1, 2]}


# ---------------------------------------------------------------- the port alone


def _model_params(hp: dict, algorithm: str) -> dict:
    return {"model": {"d_model": hp["d_model"], "n_heads": hp["n_heads"],
                      "dim_feedforward": hp["dim_feedforward"], "dropout": hp["dropout"],
                      "num_encoder_layers": hp["num_encoder_decoder_layers"],
                      "embedding_size_src": 27, "optimizer": algorithm},
            "training": {"learning_rate": hp["learning_rate"], "batch_size": hp["batch_size"],
                         "seed": 0}}


class _StopAfterTwoReads(_GracefulStop):
    def __init__(self):
        super().__init__()
        self._reads = 0

    @property
    def requested(self):
        self._reads += 1
        return self._reads >= 2

    @requested.setter
    def requested(self, value):
        pass


@pytest.mark.parametrize("algorithm", ["sgd", "adam"])
def test_resume_is_bit_exact(tmp_path, rng, algorithm):
    """tests/test_train.py:593 in the port: 4 epochs uninterrupted against 2,
    a stop, a fresh ``initialize_model(load_model=...)`` and the other 2, at
    dropout 0.1 with a shuffle: the parameters and the last epoch's metrics
    equal bit for bit (each block's generator comes from the seed and its
    first epoch alone)."""
    spec = dict(HP, optimizer_algorithm=algorithm,
                learning_rate=0.05 if algorithm == "sgd" else 3e-3)
    hp = HyperParams.from_dict(spec)
    data = _Data(rng, 20)
    runs = {}
    for name, kw in (("full", {}), ("stopped", {"_stopper": _StopAfterTwoReads()})):
        xlog.init(run_dir=str(tmp_path / "runs"))
        runs[name] = (run_training(hp, data, device="cpu", ckpt_dir=str(tmp_path / name),
                                   only_final_eval=True, **kw), _lines(xlog.run.dir))
        xlog.finish()
    assert [line["epoch"] for line in runs["stopped"][1]] == [0, 1]
    bundle, _opt, initial = initialize_model(
        {**_model_params(spec, algorithm), "load_model": {"dir": str(tmp_path / "stopped")}},
        "cpu")
    assert initial == 2 and bundle.config == derive_model_config(hp, device="cpu")
    xlog.init(run_dir=str(tmp_path / "runs"))
    resumed = run_training(hp, data, bundle=bundle, initial_epoch=initial,
                           ckpt_dir=str(tmp_path / "resumed"), only_final_eval=True)
    resumed_lines = _lines(xlog.run.dir)
    xlog.finish()
    full, full_lines = runs["full"]
    for (name, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert [line["epoch"] for line in resumed_lines] == [2, 3]
    for key in ("loss", "grad_norm", "hit_accuracy", "bce_hits", "mse_velocities"):
        assert resumed_lines[-1][key] == full_lines[-1][key], key
    assert ckpt.find_latest(str(tmp_path / "resumed"))[1] == 3


@pytest.mark.parametrize("how", ["sigterm", "max_wall_s"])
def test_graceful_stop(tmp_path, rng, how):
    """tests/test_train.py:534 and :573: a SIGTERM during the second block,
    or a wall budget of 0 s, finishes that block, saves an unscheduled
    checkpoint (only_final_eval schedules epoch 49 alone), restores the
    signal handler and returns; the checkpoint resumes at the next epoch."""
    data = _Data(rng, 16)
    calls = []

    def augment(generator, inputs, outputs):
        calls.append(1)
        if how == "sigterm" and len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return inputs, outputs

    handler = signal.getsignal(signal.SIGTERM)
    run_training(HyperParams.from_dict(dict(HP, epochs=50)), data, {}, device="cpu",
                 epoch_block=1 if how == "sigterm" else 2, only_final_eval=True,
                 on_device_augment=augment, ckpt_dir=str(tmp_path / "ck"),
                 max_wall_s=0.0 if how == "max_wall_s" else None)
    assert signal.getsignal(signal.SIGTERM) == handler
    assert len(calls) == 2  # two epochs ran, then the run stopped
    path, latest = ckpt.find_latest(str(tmp_path / "ck"))
    assert latest == 1
    cfg = derive_model_config(HyperParams.from_dict(HP), device="cpu")
    assert ckpt.restore({"dir": str(tmp_path / "ck")}, cfg)[2] == 2


@pytest.mark.parametrize("kwargs, item", [
    pytest.param({"plan": "mesh"}, "A10", id="kwargs1-A10")])
def test_unported_arguments_raise_naming_their_roadmap_item(rng, tmp_path, kwargs, item):
    """``plan=`` (ROADMAP A10) trains: a one-rank mesh plan
    (``parallel.make_mesh``, a group of one rank in this process) trains bit
    for bit as no plan does, over epochs of a partial final batch."""
    from transformergrooveinfilling_tpu_torch.parallel import make_mesh

    data = _Data(rng, 12)
    hp = HyperParams.from_dict(dict(HP, epochs=2))
    plain = run_training(hp, data, device="cpu", ckpt_dir=str(tmp_path / "a"))
    plan = make_mesh(device="cpu")
    assert (plan.n_data, plan.n_model, plan.backend) == (1, 1, "gloo")
    meshed = run_training(hp, data, device="cpu", ckpt_dir=str(tmp_path / "b"), **{
        "plan": plan} if kwargs["plan"] == "mesh" else kwargs)
    for (k, a), (_, b) in zip(plain.model.state_dict().items(),
                              meshed.model.state_dict().items()):
        assert torch.equal(a, b), (item, k)


def test_run_training_exports_legacy_and_defaults_to_cuda(tmp_path, rng, monkeypatch):
    run_training(HyperParams.from_dict(dict(HP, epochs=2)), _Data(rng, 8), device="cpu",
                 export_legacy=True, ckpt_dir=str(tmp_path))
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 4 and sum(n.endswith(".Model") for n in names) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training(HyperParams.from_dict(HP), _Data(rng, 8))
