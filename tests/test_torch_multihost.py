"""Multi-process training of the port, case for case with
``tests/test_multihost.py``: ``run_training(plan=global_mesh(...))`` in real
process groups (one rank a process, gloo on the CPU, the group named with the
JAX package's variables or torchrun's), on the JAX worker's recipe (32
synthetic loops with the closed hats masked, d 16, SGD 0.1, batch 8, 3
epochs). Each case holds an n-rank run to the 1-rank run, or the ranks to
each other, as the JAX tests do; ``tests/test_torch_parallel.py`` holds the
one-rank step to the JAX package."""

import os
import sys

import numpy as np
import pytest

from torch_parallel_group import launch, run_group

HP = {"experiment": "InfillingClosedHH_Symbolic", "encoder_only": 1,
      "optimizer_algorithm": "sgd", "d_model": 16, "n_heads": 2, "dropout": 0.0,
      "num_encoder_decoder_layers": 1, "hit_loss_penalty": 0.5, "batch_size": 8,
      "dim_feedforward": 16, "learning_rate": 0.1, "epochs": 3, "bf16": False}
WIDE = dict(HP, d_model=256, dim_feedforward=512)  # a width the layer chain's gate admits


def _job(job_id, root, hp=HP, n_model=1, **extra):
    return {"id": job_id, "kind": "run_training", "hp": hp,
            "plan": {"kind": "mesh", "n_model": n_model},
            "ckpt_dir": str(root / job_id), **extra}


def _ckpts(path) -> list:
    return sorted(f for f in os.listdir(path) if f.endswith(".ckpt"))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("multihost")


@pytest.fixture(scope="module")
def two(root):
    """One group of 2 ranks runs the dp, dp-with-the-layer-chain, streaming,
    fused augmentation and dp×tp cases, one after another."""
    jobs = [_job("dp", root), _job("shard", root, dict(WIDE, fused_layer=1)),
            _job("shard_plain", root, dict(WIDE, fused_layer=0)),
            _job("stream", root, streaming=True), _job("fused", root, fused=True),
            _job("tp", root, n_model=2)]
    for job in jobs:
        os.makedirs(job["ckpt_dir"])
    ranks, _ = run_group(2, jobs, root, "two", timeout=300)
    return [dict(r["jobs"], jax_loaded=r["jax_loaded"]) for r in ranks]


def test_two_rank_group_leaves_jax_out(two):
    """Both ranks imported the port's parallel package and trained as a
    group without jax in ``sys.modules``."""
    assert [r["jax_loaded"] for r in two] == [False, False]


def test_two_process_training_matches_single_process(root, two):
    (one,), _ = run_group(1, [_job("one", root)], root, "one", timeout=200)
    np.testing.assert_allclose(two[0]["dp"]["loss"], one["jobs"]["one"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(two[1]["dp"]["loss"], two[0]["dp"]["loss"], rtol=1e-6)
    assert len(_ckpts(root / "dp")) == 1  # one writer


def test_two_process_dp_shard_matches_plain(two):
    """The layer chain (its plain version on the CPU) on each rank's rows
    trains to the loss of the unfused layers on the same two ranks."""
    assert two[0]["shard"]["fused_layer"] and not two[0]["shard_plain"]["fused_layer"]
    np.testing.assert_allclose(two[0]["shard"]["loss"], two[0]["shard_plain"]["loss"],
                               rtol=2e-4)
    np.testing.assert_allclose(two[1]["shard"]["loss"], two[0]["shard"]["loss"], rtol=1e-6)


def test_four_process_group_matches_two(root, two):
    ranks, _ = run_group(4, [_job("four", root)], root, "four", timeout=300)
    np.testing.assert_allclose(ranks[0]["jobs"]["four"]["loss"], two[0]["dp"]["loss"],
                               rtol=1e-5)
    for r in ranks[1:]:
        np.testing.assert_allclose(r["jobs"]["four"]["loss"], ranks[0]["jobs"]["four"]["loss"],
                                   rtol=1e-6)
    assert len(_ckpts(root / "four")) == 1


def test_two_process_streaming_augmentation(root, two):
    """Each rank streams its own corpus shard; the generations are gathered
    into the global array: the ranks end equal and the model learns."""
    losses = [r["stream"]["loss"] for r in two]
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    assert losses[0] < 3.0
    assert len(_ckpts(root / "stream")) == 1


def test_two_process_fused_augmentation(two):
    losses = [r["fused"]["loss"] for r in two]
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    assert losses[0] < 3.0


def test_multihost_tensor_parallel_and_checkpoint_resume(root, two):
    """dp×tp (2 ranks → data 1 × model 2) trains to the dp loss, its
    checkpoint is gathered and written once in the one-device layout, and a
    second group resumes from it for 2 more epochs."""
    np.testing.assert_allclose(two[0]["tp"]["loss"], two[0]["dp"]["loss"], rtol=1e-4)
    assert len(_ckpts(root / "tp")) == 1
    job = _job("tp", root, dict(HP, epochs=5), n_model=2, resume=True)
    ranks, _ = run_group(2, [job], root, "tp_resume", timeout=200)
    resumed = [r["jobs"]["tp"] for r in ranks]
    assert all(r["initial_epoch"] == 3 for r in resumed)
    np.testing.assert_allclose(resumed[0]["loss"], resumed[1]["loss"], rtol=1e-6)
    assert np.isfinite(resumed[0]["loss"]) and resumed[0]["loss"] < two[0]["tp"]["loss"]
    assert len(_ckpts(root / "tp")) == 2


def test_two_process_cli_training(tmp_path):
    """The command line once per process with the JAX package's names: the
    evaluators (left at their defaults) are disabled with a note on rank 0
    only, and rank 0 writes the checkpoints."""
    from test_torch_cli import _dataset

    paths, name, _ = _dataset(str(tmp_path / "data"), "InfillingClosedHH_Symbolic", 4)
    ck = tmp_path / "ck"
    argv = [sys.executable, "-m", "transformergrooveinfilling_tpu_torch.train", "--experiment",
            name, "--paths", paths, "--epochs", "2", "--batch_size", "8", "--d_model", "16",
            "--n_heads", "2", "--dim_feedforward", "16", "--num_encoder_decoder_layers", "1",
            "--dropout", "0.1", "--hit_loss_penalty", "0.5", "--wandb", "False",
            "--dump_eval", "False", "--ckpt_dir", str(ck), "--device", "cpu"]
    outs = launch(2, lambda r: argv, str(tmp_path), timeout=200)
    assert [rc for rc, _, _ in outs] == [0, 0], outs[0][2][-3000:] + outs[1][2][-3000:]
    assert "in-training evaluators disabled" in outs[0][1]
    assert "in-training evaluators disabled" not in outs[1][1]
    assert _ckpts(ck)
