"""The port's sweep command line (``python -m
transformergrooveinfilling_tpu_torch.sweep``) with ``--device cpu``: the
trial draws of root ``sweep.py`` on every ``configs/*_sweep*.yaml``, both
modes on a tiny processed symbolic dataset, root's fallbacks (a maximize
metric, an optimizer the batched step has no rule for), Adam groups, failed
trials, the switches a batched group refuses (a kernel switch where the
trials' rates differ), a forced ``fused_layer`` group, ``remat`` given and
auto in a group (one vmapped program under remat, root's rule) and the groups
that train through the regular step."""

import glob
import os
import random
import sys

import pytest
import torch
import yaml

from transformergrooveinfilling_tpu_torch import process_dataset as port_process
from transformergrooveinfilling_tpu_torch import sweep as port_sweep
from transformergrooveinfilling_tpu_torch.data import load_processed_dataset
from transformergrooveinfilling_tpu_torch.models import build_model
from transformergrooveinfilling_tpu_torch.train import HyperParams, vmap_sweep
from transformergrooveinfilling_tpu_torch.train.config import derive_model_config, resolve_remat
from transformergrooveinfilling_tpu_torch.utils import yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEPS = sorted(glob.glob(os.path.join(REPO, "configs", "*_sweep*.yaml")))
EXPERIMENT = "InfillingClosedHH_Symbolic_testing"
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def root_sweep():
    sys.path.insert(0, REPO)
    try:
        import sweep
    finally:
        sys.path.remove(REPO)
    return sweep


@pytest.mark.parametrize("path", SWEEPS, ids=os.path.basename)
def test_draws_are_root_sweep_pys(root_sweep, path):
    """The port reads the YAML with its own reader and draws what root
    ``sweep.py`` draws from pyyaml's reading, for seeds 0-20."""
    with open(path) as f:
        spec = yaml.safe_load(f)
    assert yaml_subset.load_file(path) == spec
    for seed in range(21):
        want_rng, got_rng = random.Random(seed), random.Random(seed)
        for _ in range(3):
            assert (port_sweep.sample_config(spec, got_rng)
                    == root_sweep.sample_config(spec, want_rng))


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """A 12-loop ``--testing`` symbolic dataset built by the port's
    ``process_dataset`` and a paths file naming it."""
    root = tmp_path_factory.mktemp("sweep_data")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        port_process.main(["--experiments", "InfillingClosedHH_Symbolic", "--testing",
                           "--n-synthetic", "12", "--splits", "train", *CPU])
    finally:
        os.chdir(cwd)
    path = root / "paths.yaml"
    path.write_text(f"{EXPERIMENT}:\n  datasets:\n    train: "
                    f"{root / 'datasets' / EXPERIMENT / '0.1.1' / 'train'}\n")
    return str(path)


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    # runs/ and checkpoints/ go to the working directory, as root's
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WANDB_MODE", "offline")


def sweep_file(tmp_path, name="sweep.yaml", metric=None, **parameters):
    """A small sweep over the tiny dataset: d 16 or 32, 2 layers, 2 epochs."""
    spec = {"method": "random", "metric": metric or {"goal": "minimize", "name": "loss"},
            "project": EXPERIMENT, "parameters": {
                "batch_size": {"value": 4}, "d_model": {"values": [16, 32]},
                "dim_feedforward": {"value": 32},
                "dropout": {"distribution": "uniform", "min": 0.1, "max": 0.3},
                "optimizer_algorithm": {"value": "sgd"},
                "learning_rate": {"distribution": "uniform", "min": 0, "max": 0.1},
                "n_heads": {"value": 2}, "num_encoder_decoder_layers": {"value": 2},
                "epochs": {"value": 2}, "encoder_only": {"value": 1},
                "experiment": {"value": EXPERIMENT},
                "hit_loss_penalty": {"distribution": "uniform", "min": 0, "max": 1},
                **parameters}}
    path = tmp_path / name
    path.write_text(yaml.safe_dump(spec, default_flow_style=None))
    return str(path)


def run(capsys, *argv):
    rc = port_sweep.main([*argv, *CPU])
    return rc, capsys.readouterr().out


def test_batched_groups_two_architectures(tmp_path, paths, capsys):
    spec = yaml_subset.load_file(sweep_file(tmp_path))
    seed = next(s for s in range(100) if len({
        port_sweep.sample_config(spec, rng)["d_model"]
        for rng in [random.Random(s)] for _ in range(2)}) == 2)
    rc, out = run(capsys, "--sweep", sweep_file(tmp_path), "--count", "2", "--seed",
                  str(seed), "--batched", "--paths", paths)
    assert rc == 0
    assert "batched sweep: 2 trials in 2 architecture group(s)" in out
    assert "1 trial(s) of d16/ff32/2L bs4 x 2 epochs" in out
    assert "1 trial(s) of d32/ff32/2L bs4 x 2 epochs" in out
    assert out.count("  loss ") == 2  # both trials ranked


def test_batched_group_of_three_with_adam(tmp_path, paths, capsys):
    path = sweep_file(tmp_path, d_model={"value": 16},
                      optimizer_algorithm={"value": "adam"},
                      learning_rate={"distribution": "uniform", "min": 0, "max": 0.003})
    rc, out = run(capsys, "--sweep", path, "--count", "3", "--batched", "--paths", paths)
    assert rc == 0
    assert "3 trials in 1 architecture group(s)" in out
    assert "can't batch" not in out  # adam batches
    assert out.count("  loss ") == 3


def test_sequential_runs_the_train_command_line(tmp_path, paths, capsys):
    rc, out = run(capsys, "--sweep", sweep_file(tmp_path), "--count", "1", "--paths", paths,
                  "--epochs", "1")
    assert rc == 0
    assert "best loss = " in out
    assert "trial failed" not in out


def test_batched_falls_back_sequential_for_maximize_metric(tmp_path, paths, capsys):
    path = sweep_file(tmp_path, metric={"name": "loss", "goal": "maximize"})
    rc, out = run(capsys, "--sweep", path, "--count", "1", "--batched", "--paths", paths)
    assert rc == 0
    assert "falling back to sequential" in out
    assert "best loss = " in out


def test_batched_falls_back_sequential_for_unknown_optimizer(tmp_path, paths, capsys,
                                                            monkeypatch):
    """As root's test: the batchable menu is sgd and adam, so an optimizer
    beyond it goes to a stubbed sequential runner and is still ranked."""
    monkeypatch.setattr(port_sweep, "run_trial_sequential",
                        lambda hp, project, metric, args: 0.5)
    path = sweep_file(tmp_path, optimizer_algorithm={"value": "rmsprop"})
    rc, out = run(capsys, "--sweep", path, "--count", "1", "--batched", "--paths", paths)
    assert rc == 0
    assert "can't batch" in out and "sequentially" in out
    assert "loss 0.5000" in out


def test_failed_trial_is_reported_and_left_out(tmp_path, paths, capsys):
    path = sweep_file(tmp_path, experiment={"value": "NotInThePathsFile"})
    rc, out = run(capsys, "--sweep", path, "--count", "1", "--paths", paths)
    assert rc == 1
    assert "trial failed: KeyError: 'NotInThePathsFile'" in out
    assert "no successful trials" in out


@pytest.mark.parametrize("switch", ["fused_layer", "fused_ffn", "fused_dropout_ln"])
def test_forced_switch_in_a_batched_group_raises(tmp_path, paths, capsys, switch):
    """A vmapped group of 5 whose dropout rates differ (the sweep samples
    them): rates that differ ride the vmap as data, which a kernel switch
    does not take, so a forced kernel switch raises."""
    path = sweep_file(tmp_path, d_model={"value": 16}, **{switch: {"value": 1}})
    with pytest.raises(ValueError, match=switch):
        run(capsys, "--sweep", path, "--count", "5", "--batched", "--paths", paths)


def remat_programs(monkeypatch) -> list:
    """The configs of the vmapped programs a sweep runs, and a count of the
    layers rematerialised under ``torch.func`` (appended as ``"layer"``)."""
    from transformergrooveinfilling_tpu_torch.models import transformer

    seen = []
    real_sweep, real_remat = vmap_sweep.batched_sweep, transformer._remat_transformed
    monkeypatch.setattr(vmap_sweep, "batched_sweep",
                        lambda model, config, *a, **kw: seen.append(config)
                        or real_sweep(model, config, *a, **kw))
    monkeypatch.setattr(transformer, "_remat_transformed",
                        lambda *a: seen.append("layer") or real_remat(*a))
    return seen


def test_forced_remat_trains_a_batched_group(tmp_path, paths, capsys, monkeypatch):
    """``remat: 1`` in a sweep file whose dropout rates differ (they ride the
    vmap as data, into the recompute): one vmapped group of 5 trains under
    remat, every layer through the recompute that runs under ``torch.func``,
    and every trial is ranked."""
    seen = remat_programs(monkeypatch)
    path = sweep_file(tmp_path, d_model={"value": 16}, remat={"value": 1})
    rc, out = run(capsys, "--sweep", path, "--count", "5", "--batched", "--paths", paths)
    assert rc == 0
    assert "5 trials in 1 architecture group(s)" in out
    assert "one vmapped program under remat (policy None; given)" in out
    assert "through the regular step" not in out and "trial failed" not in out
    assert out.count("  loss ") == 5
    programs = [c for c in seen if c != "layer"]
    assert len(programs) == 1 and programs[0].remat
    assert seen.count("layer") > 0


def test_forced_fused_layer_trains_a_batched_group(tmp_path, paths, capsys, monkeypatch):
    """``fused_layer: 1`` with the architecture and the dropout rate pinned:
    one vmapped group of 5 trains through the whole-layer path (on the CPU
    its twin, under vmap) and every trial is ranked."""
    from transformergrooveinfilling_tpu_torch.models import transformer

    called = []
    real = transformer.encoder_layer_train
    monkeypatch.setattr(transformer, "encoder_layer_train",
                        lambda *a: called.append(a[0].shape) or real(*a))
    path = sweep_file(tmp_path, d_model={"value": 16}, dropout={"value": 0.2},
                      fused_layer={"value": 1})
    rc, out = run(capsys, "--sweep", path, "--count", "5", "--batched", "--paths", paths)
    assert rc == 0
    assert "5 trials in 1 architecture group(s)" in out
    assert "through the regular step" not in out and "trial failed" not in out
    assert out.count("  loss ") == 5
    assert called and all(shape == (4 * 32, 16) for shape in called)


def one_trial_bytes(hp) -> int:
    """The least device memory that holds one f32 trial of ``hp`` without
    remat by the auto-remat estimate (found by bisection)."""
    lo, hi = 1, 1 << 40
    while lo < hi:
        mid = (lo + hi) // 2
        needs = resolve_remat(None, d_model=hp.d_model, n_heads=hp.n_heads,
                              dim_feedforward=hp.dim_feedforward,
                              n_layers=hp.num_encoder_decoder_layers,
                              optimizer=hp.optimizer_algorithm, batch_size=hp.batch_size,
                              compute_dtype=torch.float32, hbm_bytes=mid)
        lo, hi = (mid + 1, hi) if needs else (lo, mid)
    return lo


def test_auto_remat_trains_a_batched_group_as_one_program(tmp_path, paths, capsys,
                                                         monkeypatch):
    """Root ``sweep.py``'s rule: with ``TGI_HBM_BYTES`` room for 2 stacked
    trials and not 3, auto remat engages for the group of 3, which trains as
    one vmapped program under remat, and every trial is ranked; with room for
    none it also trains as one program under remat. With room for 3 the same
    group trains without remat. ``fused_layer: 0`` keeps the regular step off
    #2's chain (auto takes it on the CPU at batch 4), so that a group of 3
    gains from vmap (``sweep.py::batches``)."""
    path = sweep_file(tmp_path, d_model={"value": 16}, fused_layer={"value": 0})
    hp = HyperParams.from_dict({k: v.get("value", 0.1) for k, v in
                                yaml_subset.load_file(path)["parameters"].items()})
    per = one_trial_bytes(hp)
    for room, remat in ((per * 2.5, True), (1, True), (per * 3.5, False)):
        seen = remat_programs(monkeypatch)
        monkeypatch.setenv("TGI_HBM_BYTES", str(int(room)))
        rc, out = run(capsys, "--sweep", path, "--count", "3", "--batched", "--paths", paths)
        assert rc == 0, room
        assert "3 trials in 1 architecture group(s)" in out
        assert ("one vmapped program under remat (policy None; auto, 3 stacked trials)"
                in out) is remat
        assert "through the regular step" not in out and "trial failed" not in out
        assert out.count("  loss ") == 3
        programs = [c for c in seen if c != "layer"]
        assert len(programs) == 1 and programs[0].remat is remat, room
        assert (seen.count("layer") > 0) is remat
        monkeypatch.undo()
        monkeypatch.chdir(tmp_path)


def _no_vmap(*args, **kwargs):
    raise AssertionError("a vmapped program ran")


def test_group_of_one_trains_through_the_regular_step(tmp_path, paths, capsys, monkeypatch):
    """A group of one trial (every draw of the repository's sweep YAMLs)
    takes no vmap: it trains through ``make_epoch_fn`` from the initial
    weights a vmapped trial 0 of its group would get, and is ranked on the
    same full-set loss; at learning rate 0 that is ``stacked_eval_loss`` of
    ``init_stacked_params``."""
    monkeypatch.setattr(vmap_sweep, "batched_sweep", _no_vmap)
    path = sweep_file(tmp_path, d_model={"value": 16}, learning_rate={"value": 0.0},
                      hit_loss_penalty={"value": 0.5})
    rc, out = run(capsys, "--sweep", path, "--count", "1", "--seed", "3", "--batched",
                  "--paths", paths)
    assert rc == 0
    assert "1 trial(s) one at a time through the regular step (one trial needs no vmap)" in out
    trial = port_sweep.sample_config(yaml_subset.load_file(path), random.Random(3))
    config = derive_model_config(HyperParams.from_dict(trial), device="cpu")
    model = build_model(config, "cpu")
    data = load_processed_dataset(yaml_subset.load_file(paths)[EXPERIMENT]["datasets"]["train"],
                                  exp=EXPERIMENT)
    init = vmap_sweep.init_stacked_params(model, config, 1, torch.Generator().manual_seed(3),
                                          "cpu")
    want = vmap_sweep.stacked_eval_loss(model, init, data.processed_inputs,
                                        data.processed_outputs, [0.5], device="cpu")
    assert f"  loss {float(want[0]):.4f}  lr 0.0000" in out
