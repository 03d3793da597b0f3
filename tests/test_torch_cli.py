"""The port's command lines against the JAX package's root ``train.py`` and
``process_dataset.py``, on the CPU: both training CLIs resume the same
``.ckpt`` on the same processed symbolic dataset (f32, dropout 0, one
full-batch SGD step an epoch) and log the same ``metrics.jsonl`` keys with
losses within rtol 2e-4; the flags and defaults; ``--streaming host`` and
``fused``; and the flags that raise ``NotPortedError`` (ROADMAP A5, A10)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from transformergrooveinfilling_tpu_torch import NotPortedError
from transformergrooveinfilling_tpu_torch import process_dataset as port_process
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
        import train
    finally:
        sys.path.remove(REPO)
    return train, process_dataset


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


@pytest.mark.parametrize("flags, match", [
    (["--n_model_shards", "2"], "A10"), (["--pp_stages", "2"], "A10"),
    (["--eval_train", "True"], "A5.*--eval_train False")])
def test_unported_flags_raise(tmp_path, monkeypatch, flags, match):
    paths, name, _ = _dataset(str(tmp_path), "InfillingClosedHH_Symbolic", 4)
    (tmp_path / "evaluator.pickle").write_bytes(b"")
    monkeypatch.chdir(tmp_path)
    argv = ["--experiment", name, "--paths", paths, "--epochs", "1", "--d_model", "16",
            "--n_heads", "2", "--dim_feedforward", "16", "--num_encoder_decoder_layers", "1"]
    with pytest.raises(NotPortedError, match=match):
        port_train.main(argv + QUIET + CPU + flags)


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
