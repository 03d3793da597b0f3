"""The port's command lines against the JAX package's root ``train.py`` and
``process_dataset.py``, on the CPU: both training CLIs resume the same
``.ckpt`` on the same processed symbolic dataset (f32, dropout 0, one
full-batch SGD step an epoch) and log the same ``metrics.jsonl`` keys with
losses within rtol 2e-4; the flags and defaults; ``--streaming host`` and
``fused``; ``--n_model_shards`` and ``--pp_stages`` over two processes; and
evaluation: ``process_evaluator`` builds pickles that the JAX package's
``init_evaluator`` reads, ``train`` with the evaluator flags logs both sets,
``evaluate`` gives the metrics of the JAX package's ``evaluate.py`` on the
same ``.ckpt``, and all three command lines run where ``import pandas``,
``import tqdm``, ``import yaml`` and ``import jax`` fail, as on the machine
with the card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from transformergrooveinfilling_tpu_torch import evaluate as port_evaluate
from transformergrooveinfilling_tpu_torch import process_dataset as port_process
from transformergrooveinfilling_tpu_torch import process_evaluator as port_process_evaluator
from transformergrooveinfilling_tpu_torch.hvo import VOICE_NAMES
from transformergrooveinfilling_tpu_torch.train import __main__ as port_train
from transformergrooveinfilling_tpu_torch.train import checkpoint as ckpt
from transformergrooveinfilling_tpu_torch.train import (
    HyperParams, create_train_state, derive_model_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = ["--wandb", "False", "--eval_train", "False", "--eval_validation", "False",
         "--dump_eval", "False"]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def jax_cli():
    sys.path.insert(0, REPO)
    try:
        import process_dataset
        import process_evaluator
        import train
    finally:
        sys.path.remove(REPO)
    return train, process_dataset, process_evaluator


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    # both command lines set WANDB_MODE; monkeypatch puts it back
    monkeypatch.setenv("WANDB_MODE", "offline")


def _dataset(root, experiment, n_loops):
    """``--testing`` datasets of ``experiment`` (``n_loops`` synthetic
    loops, the train split) built by the port's command line under
    ``root``, and a paths file for them → (paths file, experiment name)."""
    cwd = os.getcwd()
    os.makedirs(root, exist_ok=True)
    os.chdir(root)
    try:
        port_process.main(["--experiments", experiment, "--testing", "--n-synthetic",
                           str(n_loops), "--splits", "train", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    name = experiment + "_testing"
    version = {"InfillingRandom": "0.0.0", "InfillingClosedHH_Symbolic": "0.1.1"}[experiment]
    train_dir = os.path.join(root, "datasets", name, version, "train")
    paths = os.path.join(root, "paths.yaml")
    with open(paths, "w") as f:
        f.write(f"{name}:\n  datasets:\n    train: {train_dir}\n"
                f"  evaluators:\n    train: {os.path.join(root, 'evaluator.pickle')}\n")
    return paths, name, train_dir


def _config(path, **hp):
    with open(path, "w") as f:
        f.write("".join(f"{k}: {v}\n" for k, v in hp.items()))
    return path


def _metrics(root):
    (run_dir,) = [os.path.join(d, sub) for d, subs, _ in os.walk(os.path.join(root, "runs"))
                  for sub in subs if os.path.exists(os.path.join(d, sub, "metrics.jsonl"))]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_training_cli_matches_jax_from_the_same_checkpoint(tmp_path, jax_cli, monkeypatch):
    paths, name, train_dir = _dataset(str(tmp_path / "data"), "InfillingClosedHH_Symbolic", 12)
    from transformergrooveinfilling_tpu_torch.data import load_processed_dataset

    n = len(load_processed_dataset(train_dir, name))
    spec = dict(experiment=name, encoder_only=1, optimizer_algorithm="sgd", d_model=32,
                n_heads=2, dropout=0.0, num_encoder_decoder_layers=1, hit_loss_penalty=0.5,
                batch_size=n, dim_feedforward=64, learning_rate=0.5, epochs=4)
    config = _config(str(tmp_path / "cfg.yaml"), **spec)
    model_cfg = derive_model_config(HyperParams.from_dict(dict(spec, bf16=False)), device="cpu")
    ckpt.save_checkpoint(str(tmp_path / "start"), "start", 0,
                         create_train_state(model_cfg, "sgd", 0.5, 3, "cpu"), 1.0, model_cfg)
    argv = ["--config", config, "--paths", paths, "--bf16", "0", "--fast_prng", "0",
            "--load_model", str(tmp_path / "start")] + QUIET
    runs = {"jax": (jax_cli[0].main, []), "port": (port_train.main, CPU)}
    lines = {}
    for name_, (main, device) in runs.items():
        root = tmp_path / name_
        root.mkdir()
        monkeypatch.chdir(root)
        main(argv + device + ["--ckpt_dir", str(root / "ck")])
        lines[name_] = _metrics(str(root))
        assert ckpt.find_latest(str(root / "ck"))[1] == 3
    assert [r["epoch"] for r in lines["port"]] == [r["epoch"] for r in lines["jax"]] == [1, 2, 3]
    for got, want in zip(lines["port"], lines["jax"], strict=True):
        assert got.keys() == want.keys()
    np.testing.assert_allclose([r["loss"] for r in lines["port"]],
                               [r["loss"] for r in lines["jax"]], rtol=2e-4)


def test_flags_and_defaults_are_root_train_pys(jax_cli, capsys):
    port, jax = vars(port_train.parse_args([])), vars(jax_cli[0].parse_args([]))
    assert port.pop("device") == "cuda" and port == jax
    with pytest.raises(SystemExit):
        port_train.parse_args(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "--fast_prng" in text and "has no effect" in text and "Philox" in text
    args = port_train.parse_args(["--experiment", "X", "--testing", "True", "--load_model", "d"])
    assert port_train.hyperparameters_from_args(args) == jax_cli[0].hyperparameters_from_args(args)


@pytest.mark.parametrize("flags, names", [
    pytest.param(["--n_model_shards", "2"], "jax", id="flags0-A10"),
    pytest.param(["--pp_stages", "2"], "torchrun", id="flags1-A10")])
def test_unported_flags_raise(tmp_path, flags, names):
    """The flags of ROADMAP A10 train, as root ``train.py``'s do: the
    command line once per process of a 2-rank group (named with the JAX
    package's variables, or torchrun's), the layers split over both ranks
    (``--n_model_shards 2``) or pipelined over them (``--pp_stages 2``, 2
    layers, 4 microbatches); rank 0 writes the checkpoint of the one-device
    layout, which restores in one process."""
    from torch_parallel_group import launch

    paths, name, _ = _dataset(str(tmp_path), "InfillingClosedHH_Symbolic", 4)
    ck = tmp_path / "ck"
    argv = [sys.executable, "-m", "transformergrooveinfilling_tpu_torch.train",
            "--experiment", name, "--paths", paths, "--epochs", "1", "--d_model", "16",
            "--n_heads", "2", "--dim_feedforward", "16", "--num_encoder_decoder_layers", "2",
            "--ckpt_dir", str(ck)] + QUIET + CPU + flags
    outs = launch(2, lambda r: argv, str(tmp_path), timeout=200, names=names)
    assert [rc for rc, _, _ in outs] == [0, 0], outs[0][2][-3000:] + outs[1][2][-3000:]
    (path,) = [os.path.join(ck, f) for f in os.listdir(ck) if f.endswith(".ckpt")]
    cfg = derive_model_config(HyperParams.from_dict(dict(
        experiment=name, d_model=16, n_heads=2, dim_feedforward=16,
        num_encoder_decoder_layers=2, bf16=False)), device="cpu")
    params, _opt, epoch = ckpt.restore({"dir": str(ck)}, cfg)
    assert epoch == 1 and params["encoder_layer_1"]["self_attn"]["qkv"]["kernel"].shape == (16, 48)


def test_missing_evaluator_is_skipped_and_cuda_is_the_default(tmp_path, monkeypatch, capsys):
    paths, name, _ = _dataset(str(tmp_path), "InfillingClosedHH_Symbolic", 4)
    monkeypatch.chdir(tmp_path)
    argv = ["--experiment", name, "--paths", paths, "--epochs", "1", "--d_model", "16",
            "--n_heads", "2", "--dim_feedforward", "16", "--num_encoder_decoder_layers", "1",
            "--wandb", "False", "--eval_validation", "False", "--dump_eval", "False"]
    port_train.main(argv + ["--device", "cpu", "--ckpt_dir", str(tmp_path / "ck")])
    assert (f"[train] evaluator pickle missing, skipping train: "
            f"{tmp_path / 'evaluator.pickle'}") in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_train.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_process.main(["--experiments", "InfillingRandom", "--testing", "--n-synthetic", "2",
                           "--splits", "train"])


@pytest.fixture(scope="module")
def random_dataset(tmp_path_factory):
    return _dataset(str(tmp_path_factory.mktemp("random")), "InfillingRandom", 8)


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_streaming_cli_trains(mode, random_dataset, tmp_path, monkeypatch, capsys):
    """``--streaming host`` (fresh generations every block, half the corpus
    each) and ``fused`` (64 of the 8 loops × 10 augmentations, re-rendered
    every block) train the Random experiment on the CPU."""
    paths, name, _ = random_dataset
    monkeypatch.chdir(tmp_path)
    extra = (["--regen_cadence", "1", "--regen_partial", "2", "--aug_per_item", "4",
              "--epochs", "3"] if mode == "host" else ["--epochs", "1"])
    port_train.main(["--experiment", name, "--paths", paths, "--d_model", "16", "--n_heads", "2",
                     "--dim_feedforward", "16", "--num_encoder_decoder_layers", "1",
                     "--batch_size", "16", "--streaming", mode, "--ckpt_dir",
                     str(tmp_path / "ck")] + extra + QUIET + CPU)
    out = capsys.readouterr().out
    assert f"streaming({mode})" in out
    lines = _metrics(str(tmp_path))
    assert len(lines) == (3 if mode == "host" else 1)
    assert all(np.isfinite(r["loss"]) for r in lines)
    if mode == "fused":
        assert "trimming 80 -> 64 items" in out


def test_fused_streaming_trains_on_root_train_pys_items(random_dataset, jax_cli):
    """The fused mode's corpus is root ``train.py``'s: the loops repeated by
    the fan-out and trimmed to a multiple of 64."""
    from transformergrooveinfilling_tpu.data import load_processed_dataset as jax_load
    from transformergrooveinfilling_tpu_torch.data import load_processed_dataset

    _paths, name, train_dir = random_dataset
    args = port_train.parse_args(["--streaming", "fused", "--aug_per_item", "9", "--device", "cpu"])
    _s, augment, port_ds = port_train._setup_streaming(args, load_processed_dataset(train_dir, name))
    _s, jax_augment, jax_ds = jax_cli[0]._setup_streaming(args, jax_load(train_dir, name))
    assert augment is not None and jax_augment is not None
    assert port_ds.processed_inputs.shape == (64, 32, 27)
    assert np.array_equal(port_ds.processed_inputs, jax_ds.processed_inputs)
    args.streaming = "host"
    with pytest.raises(SystemExit, match="streaming"):
        symbolic = type("D", (), {})()
        port_train._setup_streaming(args, symbolic)


EVAL_EXPERIMENT = "InfillingClosedHH_Symbolic"
EVAL_SPLITS = ("train", "validation")


def _evaluators_built(root: str, n_loops: int = 24):
    """The ``--testing`` datasets of the symbolic experiment for both splits
    and their evaluators, each built by the port's command line under
    ``root`` on the CPU → (paths file, experiment name, {split: pickle})."""
    cwd = os.getcwd()
    os.makedirs(root, exist_ok=True)
    os.chdir(root)
    try:
        port_process.main(["--experiments", EVAL_EXPERIMENT, "--testing", "--n-synthetic",
                           str(n_loops), "--splits", *EVAL_SPLITS, "--device", "cpu"])
        name = EVAL_EXPERIMENT + "_testing"
        data = os.path.join(root, "datasets", name, "0.1.1")
        pickles = {s: os.path.join(root, "datasets", "preprocessed_evaluators",
                                   "InfillingEvaluator_0.3.2", f"{name}_{s}_0.1.1_evaluator.pickle")
                   for s in EVAL_SPLITS}
        paths = os.path.join(root, "paths.yaml")
        with open(paths, "w") as f:
            f.write(f"{name}:\n  datasets:\n"
                    + "".join(f"    {s}: {os.path.join(data, s)}\n" for s in EVAL_SPLITS)
                    + "  evaluators:\n" + "".join(f"    {s}: {p}\n" for s, p in pickles.items()))
        port_process_evaluator.main(["--experiments", EVAL_EXPERIMENT, "--testing", "--splits",
                                     *EVAL_SPLITS, "--paths", paths, "--device", "cpu"])
    finally:
        os.chdir(cwd)
    return paths, name, pickles


@pytest.fixture(scope="module")
def evaluators_built(tmp_path_factory):
    return _evaluators_built(str(tmp_path_factory.mktemp("evaluators")))


def test_process_evaluator_pickles_load_in_jax(evaluators_built, jax_cli, tmp_path, monkeypatch):
    """The port's pickles load through the JAX package's ``init_evaluator``
    as its own classes, with root ``process_evaluator.py``'s subsets, tags
    and sample locations; the port's draws are seeded, so a second build is
    equal."""
    from transformergrooveinfilling_tpu.eval.evaluator import InfillingEvaluator, init_evaluator

    paths, name, pickles = evaluators_built
    monkeypatch.chdir(tmp_path)
    for split, path in pickles.items():
        ev = init_evaluator(path)
        assert type(ev) is InfillingEvaluator and ev._identifier == f"{split.capitalize()}_Set"
        ds_path = os.path.join(os.path.dirname(paths), "datasets", name, "0.1.1", split)
        root_ev = init_evaluator(jax_cli[2].build_evaluator(
            EVAL_EXPERIMENT, split, ds_path, n_samples_to_use=10, n_samples_to_synthesize=5,
            n_synthetic=24))
        assert ev._gt_tags == root_ev._gt_tags and ev._gt_hvos_array_tags == root_ev._gt_hvos_array_tags
        assert ev.audio_sample_locations == root_ev.audio_sample_locations
        np.testing.assert_array_equal(ev._gmd_gt_hvos_array, root_ev._gmd_gt_hvos_array)
        again = port_process_evaluator.build_evaluator(
            EVAL_EXPERIMENT, split, ds_path, n_samples_to_use=10, n_samples_to_synthesize=5,
            n_synthetic=24, device="cpu")
        np.testing.assert_array_equal(init_evaluator(again).processed_gt, ev.processed_gt)
        assert ev.processed_inputs.shape[-1] == 27 and len(ev.processed_gt) > 0


def test_train_cli_evaluates_both_sets(evaluators_built, tmp_path, monkeypatch):
    """``--eval_train True --eval_validation True``: every block logs both
    sets' held-out losses and metric families; the media epochs write the
    stats CSV, and ``--dump_eval`` (on by default) the evaluators."""
    paths, name, _ = evaluators_built
    monkeypatch.chdir(tmp_path)
    port_train.main(["--experiment", name, "--paths", paths, "--epochs", "2", "--d_model", "16",
                     "--n_heads", "2", "--dim_feedforward", "16",
                     "--num_encoder_decoder_layers", "1", "--wandb", "False",
                     "--eval_train", "True", "--eval_validation", "True",
                     "--ckpt_dir", str(tmp_path / "ck")] + CPU)
    lines = _metrics(str(tmp_path))
    for epoch in (0, 1):
        keys = set().union(*(r for r in lines if r.get("epoch") == epoch))
        for split in EVAL_SPLITS:
            assert {f"{split}_loss", f"{split}_hit_accuracy",
                    f"{split.capitalize()}_Set_Hits_Accuracy_mean",
                    f"{split.capitalize()}_Set_Velocity_MSE_KICK",
                    f"{split.capitalize()}_Set_Micro_Timing_MSE_mean",
                    f"{split.capitalize()}_Set_stats"} <= keys, (epoch, split)
    (run_dir,) = {os.path.dirname(p) for p in _glob(tmp_path, "metrics.jsonl")}
    assert {f for f in os.listdir(run_dir) if f.startswith("stats_")} == {
        f"stats_{os.path.basename(run_dir)}_Epoch_{e}.csv" for e in (0, 1)}
    assert len(os.listdir(tmp_path / "evaluator")) == 4  # 2 sets x 2 media epochs


def _glob(root, filename):
    return [os.path.join(d, filename) for d, _subs, files in os.walk(root) if filename in files]


def test_evaluate_cli_matches_jax_on_the_same_ckpt(evaluators_built, jax_cli, tmp_path,
                                                   monkeypatch, capsys):
    """The port's ``evaluate`` and the JAX package's on one ``.ckpt`` (written
    by the JAX package) and one evaluator pickle: the same record keys, hit
    accuracies within the share of cells whose JAX sigmoid lies within 1e-4
    of 0.5, the MSE families within 1e-5, the same stats CSV columns;
    ``--all_epochs`` scores every saved epoch into one run; ``--artifact`` of
    the same weights exported scores the families of ``--ckpt`` within 1e-6."""
    import jax
    import jax.numpy as jnp

    from transformergrooveinfilling_tpu import evaluate as jax_evaluate
    from transformergrooveinfilling_tpu.eval.evaluator import init_evaluator
    from transformergrooveinfilling_tpu.models import build_model, predict
    from transformergrooveinfilling_tpu.models.transformer import GrooveTransformerConfig
    from transformergrooveinfilling_tpu.train.checkpoint import save_checkpoint
    from transformergrooveinfilling_tpu.train.loop import create_train_state as jax_state
    from transformergrooveinfilling_tpu.train.loop import make_optimizer

    _paths, _name, pickles = evaluators_built
    monkeypatch.chdir(tmp_path)
    config = GrooveTransformerConfig(d_model=16, n_heads=2, dim_feedforward=16,
                                     num_encoder_layers=1, embedding_size_src=27)
    model = build_model(config)
    state = jax_state(model, config, make_optimizer("sgd", 0.1), jax.random.PRNGKey(2))
    save_checkpoint(str(tmp_path / "ck"), "evalrun", 3, state, 1.25, config=config)
    argv = ["--ckpt", str(tmp_path / "ck"), "--evaluator", pickles["validation"],
            "--media", "1", "--dump", "0"]
    records, printed = {}, {}
    for name, main, extra in (("jax", jax_evaluate.main, []), ("port", port_evaluate.main, CPU)):
        assert main(argv + ["--run_dir", str(tmp_path / name)] + extra) == 0
        printed[name] = [line for line in capsys.readouterr().out.splitlines()
                         if "mean hit accuracy" in line]
        (metrics,) = _glob(tmp_path / name, "metrics.jsonl")
        with open(metrics) as f:
            records[name] = [json.loads(line) for line in f]
        (csv_file,) = [os.path.join(os.path.dirname(metrics), f)
                       for f in os.listdir(os.path.dirname(metrics)) if f.startswith("stats_")]
        with open(csv_file) as f:
            records[name + "_csv_header"] = f.readline()
    assert "Validation_Set: mean hit accuracy" in printed["port"][0]
    assert "checkpoint epoch 3, train loss 1.2500" in printed["port"][0]
    assert records["port_csv_header"] == records["jax_csv_header"]
    got, want = records["port"], records["jax"]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    ev = init_evaluator(pickles["validation"])
    sig = np.asarray(predict(model, state.params, jnp.asarray(ev.processed_inputs),
                             use_thres=False)[0])
    near = (np.abs(sig - 0.5) < 1e-4).mean(axis=(0, 1))
    g, w = got[0], want[0]
    for key in w:
        if "_Hits_Accuracy_" in key and not key.endswith("_mean"):
            voice = key.rsplit("_Hits_Accuracy_", 1)[1]
            assert abs(g[key] - w[key]) <= near[list(VOICE_NAMES).index(voice)] + 1e-6, key
        elif "_MSE_" in key:
            np.testing.assert_allclose(g[key], w[key], atol=1e-5, err_msg=key)
    # --all_epochs: one run holding every saved epoch
    save_checkpoint(str(tmp_path / "ck"), "evalrun", 5, state, 1.0, config=config)
    assert port_evaluate.main(["--ckpt", str(tmp_path / "ck"), "--all_epochs", "--evaluator",
                               pickles["validation"], "--run_dir", str(tmp_path / "curve")]
                              + CPU) == 0
    out = capsys.readouterr().out
    assert "checkpoint epoch 3" in out and "checkpoint epoch 5" in out
    (curve,) = _glob(tmp_path / "curve", "metrics.jsonl")
    with open(curve) as f:
        assert {json.loads(line).get("epoch") for line in f} >= {3, 5}
    # --artifact: the same weights exported score the families of --ckpt
    from transformergrooveinfilling_tpu_torch import export as port_export

    art = str(tmp_path / "ck.tgix")
    assert port_export.main(["--checkpoint", str(tmp_path / "ck" /
                                                 "transformer_run_evalrun_Epoch_3.ckpt"),
                             "--out", art, "--batch_sizes", "1,32", "--platforms", "cpu"]) == 0
    assert port_evaluate.main(["--artifact", art, "--evaluator", pickles["validation"],
                               "--media", "0", "--run_dir", str(tmp_path / "art")] + CPU) == 0
    assert "Validation_Set: mean hit accuracy" in capsys.readouterr().out
    (metrics,) = _glob(tmp_path / "art", "metrics.jsonl")
    with open(metrics) as f:
        (art_record,) = [json.loads(line) for line in f]
    ckpt_record = got[0]
    families = [k for k in ckpt_record if "_Hits_Accuracy_" in k or "_MSE_" in k]
    assert families and set(families) <= set(art_record)
    for key in families:
        np.testing.assert_allclose(art_record[key], ckpt_record[key], atol=1e-6, err_msg=key)
    with pytest.raises(SystemExit):  # --all_epochs applies to --ckpt directories only
        port_evaluate.main(["--artifact", art, "--all_epochs", "--evaluator",
                            pickles["validation"]] + CPU)


# a None in sys.modules makes ``import name`` raise ImportError, as an
# absent package does
BLOCKED_IMPORTS = """
import sys
for name in ("pandas", "tqdm", "yaml", "jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None
import runpy
module, sys.argv = sys.argv[1], [sys.argv[1]] + sys.argv[2:]
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def test_eval_command_lines_run_without_pandas_tqdm_yaml_or_jax(tmp_path):
    """As on the machine with the card: ``process_dataset`` →
    ``process_evaluator`` → ``train`` (both evaluator flags on; two media
    epochs rendered on the worker, audio included) → ``evaluate`` with media,
    each a process in which those packages cannot be imported."""
    def run(module, *args):
        proc = subprocess.run(
            [sys.executable, "-c", BLOCKED_IMPORTS, f"transformergrooveinfilling_tpu_torch.{module}",
             *args], cwd=tmp_path, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"})
        assert proc.returncode == 0, proc.stderr[-4000:]
        return proc.stdout

    run("process_dataset", "--experiments", EVAL_EXPERIMENT, "--testing", "--splits",
        *EVAL_SPLITS, *CPU)
    name = EVAL_EXPERIMENT + "_testing"
    data = tmp_path / "datasets" / name / "0.1.1"
    evals = tmp_path / "datasets" / "preprocessed_evaluators" / "InfillingEvaluator_0.3.2"
    paths = tmp_path / "paths.yaml"
    paths.write_text(f"{name}:\n  datasets:\n"
                     + "".join(f"    {s}: {data / s}\n" for s in EVAL_SPLITS) + "  evaluators:\n"
                     + "".join(f"    {s}: {evals / f'{name}_{s}_0.1.1_evaluator.pickle'}\n"
                               for s in EVAL_SPLITS))
    run("process_evaluator", "--experiments", EVAL_EXPERIMENT, "--testing", "--paths",
        str(paths), "--splits", *EVAL_SPLITS, *CPU)
    out = run("train", "--experiment", name, "--paths", str(paths), "--epochs", "2",
              "--d_model", "16", "--n_heads", "2", "--dim_feedforward", "16",
              "--num_encoder_decoder_layers", "1", "--wandb", "False", "--dump_eval", "False",
              "--ckpt_dir", str(tmp_path / "ck"), *CPU)
    assert "media worker" not in out
    (metrics,) = _glob(tmp_path / "runs", "metrics.jsonl")
    run_dir = os.path.dirname(metrics)
    assert len([f for f in os.listdir(run_dir) if f.startswith("stats_")]) == 2
    assert any(f.endswith(".wav") for f in os.listdir(os.path.join(run_dir, "media")))
    out = run("evaluate", "--ckpt", str(tmp_path / "ck"), "--evaluator",
              str(evals / f"{name}_validation_0.1.1_evaluator.pickle"), "--run_dir",
              str(tmp_path / "offline"), *CPU)
    assert "Validation_Set: mean hit accuracy" in out
