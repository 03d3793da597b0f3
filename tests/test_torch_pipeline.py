"""The port's pipeline parallelism (``parallel/pipeline.py``) against the JAX
package, case for case with ``tests/test_pipeline.py``: the port's stages are
processes of gloo groups on the CPU (``tests/torch_parallel_worker.py``; a
group of 4 ranks and one of 8), the JAX model runs here, both from the same
flax weights and numpy inputs. Bars: the forward 3e-5, one SGD step 5e-5 on
the weights (ROADMAP)."""

import dataclasses
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from transformergrooveinfilling_tpu.models import build_model as jax_build_model
from transformergrooveinfilling_tpu.models.losses import calculate_loss as jax_loss
from transformergrooveinfilling_tpu.models.transformer import (
    GrooveTransformerConfig as JaxConfig,
)
from transformergrooveinfilling_tpu.train import loop as jax_loop
from transformergrooveinfilling_tpu_torch.parallel.pipeline import (
    check_pipeline_batch, merge_encoder_params, split_encoder_params,
)
from torch_parallel_group import flax_arrays, run_group, unflatten

CFG = dict(d_model=16, n_heads=2, dim_feedforward=24, dropout=0.2, num_encoder_layers=8,
           max_len=32, embedding_size_src=16, embedding_size_tgt=27)
CFG0 = dict(CFG, dropout=0.0)
FWD_BAR, PARAM_BAR = 3e-5, 5e-5
HP = {"experiment": "InfillingClosedHH_Symbolic", "optimizer_algorithm": "sgd", "d_model": 16,
      "n_heads": 2, "dropout": 0.1, "num_encoder_decoder_layers": 2, "hit_loss_penalty": 0.5,
      "batch_size": 16, "dim_feedforward": 24, "learning_rate": 0.05, "epochs": 3}


def _pipe(s, d=None, m=1, micro=4):
    return {"kind": "pipe", "n_stages": s, "n_data": d, "n_model": m, "n_micro": micro}


def _fwd(job_id, plan, cfg=CFG):
    return {"id": job_id, "kind": "forward", "cfg": cfg, "params": "p", "x": "x", "plan": plan}


def _train(job_id, plan, cfg=CFG0, steps=1, x="x1", y="y1"):
    return {"id": job_id, "kind": "train", "cfg": cfg, "params": "p", "x": x, "y": y,
            "plan": plan, "penalty": 0.5, "lr": 0.05, "steps": steps}


def _targets(seed, n=16):
    h = (np.random.default_rng(seed).random((n, 32, 9)) < 0.3).astype(np.float32)
    return np.concatenate([h, h * 0.6, h * 0.1], 2).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    x = np.random.default_rng(0).standard_normal((16, 32, 16)).astype(np.float32)
    params = jax.tree.map(np.asarray, jax_build_model(JaxConfig(**CFG)).init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    rng = np.random.default_rng(7)
    data = {**flax_arrays(params, "p"), "x": x,
            "x1": np.random.default_rng(1).standard_normal((16, 32, 16)).astype(np.float32),
            "y1": _targets(2), "y4": _targets(4),
            "x20": rng.standard_normal((20, 32, 16)).astype(np.float32)}
    h = (rng.random((20, 32, 9)) < 0.3).astype(np.float32)
    data["y20"] = np.concatenate([h, h * 0.6, h * 0.1], 2).astype(np.float32)
    return params, data


@pytest.fixture(scope="module")
def four(setup, tmp_path_factory):
    """A group of 4 ranks: (4 stages, 1 data), (2, 2), the epoch, the training driver."""
    tmp = tmp_path_factory.mktemp("pipe4")
    jobs = [_fwd("fwd_4x1", _pipe(4, 1)),
            _train("step_2x2", _pipe(2, 2)),
            _fwd("fwd_remat", _pipe(2, 2), dict(CFG0, remat=True)),
            _fwd("fwd_plain", _pipe(2, 2), CFG0),
            _train("step_remat", _pipe(2, 2), dict(CFG0, remat=True), x="x", y="y1"),
            {"id": "epoch", "kind": "epoch", "cfg": CFG0, "params": "p", "x": "x20", "y": "y20",
             "plan": _pipe(2, 2, micro=4), "penalty": 0.5, "lr": 0.05, "batch": 8},
            {"id": "driver", "kind": "run_training", "hp": dict(HP, encoder_only=1),
             "plan": _pipe(2), "ckpt_dir": str(tmp / "ck"), "epoch_block": 2},
            {"id": "encdec", "kind": "run_training", "hp": dict(HP, encoder_only=0, epochs=1),
             "plan": _pipe(2), "ckpt_dir": str(tmp / "ck_encdec"), "expect_error": True}]
    ranks, arrays = run_group(4, jobs, tmp, "pipe4", setup[1], timeout=300)
    return ranks, arrays, tmp


@pytest.fixture(scope="module")
def eight(setup, tmp_path_factory):
    """A group of 8 ranks: (4, 2), (2, 4), dp×pp×tp (2, 2, 2)."""
    jobs = [_fwd("fwd_4x2", _pipe(4, 2)), _fwd("fwd_2x4", _pipe(2, 4)),
            _train("learn", _pipe(2, 4), CFG, steps=8, x="x", y="y4"),
            _fwd("fwd_tp", _pipe(2, 2, 2)), _train("step_tp", _pipe(2, 2, 2))]
    return run_group(8, jobs, tmp_path_factory.mktemp("pipe8"), "pipe8", setup[1], timeout=300)


def _plain_forward(params, x, cfg=CFG):
    return [np.asarray(o) for o in jax_build_model(JaxConfig(**cfg)).apply(
        {"params": params}, jnp.asarray(x), deterministic=True)]


def _direct_step(params, x, y):
    model = jax_build_model(JaxConfig(**CFG0))

    def loss(p):
        return jax_loss(model.apply({"params": p}, jnp.asarray(x), deterministic=True),
                        jnp.asarray(y), 0.5).total_loss

    tx = optax.sgd(0.05)
    grads = jax.grad(loss)(params)
    new = optax.apply_updates(params, tx.update(grads, tx.init(params), params)[0])
    return float(loss(params)), jax.tree.map(np.asarray, new)


def _close(got: dict, want: dict, atol: float):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=atol), got, want)


def test_split_merge_roundtrip(setup):
    params = setup[0]
    rest, stacked = split_encoder_params(params, CFG["num_encoder_layers"])
    assert jax.tree.leaves(stacked)[0].shape[0] == CFG["num_encoder_layers"]
    merged = merge_encoder_params(rest, stacked, CFG["num_encoder_layers"])
    jax.tree.map(np.testing.assert_array_equal, merged, params)


@pytest.mark.parametrize("n_stages,n_data", [(4, 1), (4, 2), (2, 4)])
def test_forward_matches_plain_model(setup, four, eight, n_stages, n_data):
    ref = _plain_forward(setup[0], setup[1]["x"])
    arrays = four[1] if n_data == 1 else eight[1]
    for i, r in enumerate(ref):
        np.testing.assert_allclose(arrays[f"fwd_{n_stages}x{n_data}/out{i}"], r, atol=FWD_BAR)


def test_train_step_matches_direct_grad(setup, four):
    """One SGD step of the pipelined stack (2 stages × 2 data ranks) equals
    the direct gradient of the plain JAX model (dropout off)."""
    loss, want = _direct_step(setup[0], setup[1]["x1"], setup[1]["y1"])
    ranks, arrays, _ = four
    np.testing.assert_allclose(ranks[0]["jobs"]["step_2x2"]["losses"][0], loss, rtol=1e-5)
    _close(unflatten(arrays, "step_2x2/params"), want, PARAM_BAR)


def test_train_step_with_dropout_learns(setup, eight):
    """dp×pp with dropout on: the loss falls over 8 steps and every layer of
    every stage moves."""
    ranks, arrays = eight
    losses = ranks[0]["jobs"]["learn"]["losses"]
    assert losses[-1] < losses[0]
    _, before = split_encoder_params(setup[0], CFG["num_encoder_layers"])
    _, after = split_encoder_params(unflatten(arrays, "learn/params"), CFG["num_encoder_layers"])
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
        moved = np.abs(a - b).reshape(a.shape[0], -1)
        assert (moved.max(axis=1) > 0).all(), "some layer never updated"


def test_pipeline_honors_remat(setup, four):
    ranks, arrays, _ = four
    for i in range(3):
        np.testing.assert_allclose(arrays[f"fwd_remat/out{i}"], arrays[f"fwd_plain/out{i}"],
                                   rtol=1e-5, atol=1e-6)
    assert np.isfinite(ranks[0]["jobs"]["step_remat"]["losses"][0])
    moved = jax.tree.map(lambda a, b: not np.allclose(a, b),
                         unflatten(arrays, "step_remat/params"), setup[0])
    assert any(jax.tree.leaves(moved))


def test_forward_tp_inside_stages_matches_plain_model(setup, eight):
    """dp×pp×tp (2×2×2 over 8 ranks): the stages' layers split over "model"
    (a rank holds half the heads' q, k, v rows) and the forward equals the
    plain model."""
    ranks, arrays = eight
    for rank in ranks:
        assert rank["jobs"]["fwd_tp"]["qkv_rows"] == 3 * CFG["d_model"] // 2
    for i, r in enumerate(_plain_forward(setup[0], setup[1]["x"])):
        np.testing.assert_allclose(arrays[f"fwd_tp/out{i}"], r, atol=FWD_BAR)


def test_train_step_tp_inside_stages_matches_direct_grad(setup, eight):
    loss, want = _direct_step(setup[0], setup[1]["x1"], setup[1]["y1"])
    ranks, arrays = eight
    np.testing.assert_allclose(ranks[0]["jobs"]["step_tp"]["losses"][0], loss, rtol=1e-5)
    _close(unflatten(arrays, "step_tp/params"), want, PARAM_BAR)


def test_epoch_fn_with_pipeline_step_matches_plain(setup, four):
    """make_epoch_fn(step_fn=make_pipeline_step(...)) over 20 rows in
    batches of 8 (a partial batch) equals the JAX package's plain epoch."""
    params, data = setup
    model = jax_build_model(JaxConfig(**CFG0))
    tx = optax.sgd(0.05)
    state = jax_loop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=tx.init(params))
    epoch = jax_loop.make_epoch_fn(model, tx, 0.5, 8, 20, donate=False, shuffle=False)
    s, m = epoch(state, jnp.asarray(data["x20"]), jnp.asarray(data["y20"]),
                 jax.random.PRNGKey(3))
    ranks, arrays, _ = four
    np.testing.assert_allclose(ranks[0]["jobs"]["epoch"]["loss"], float(m["loss"]), rtol=1e-5)
    _close(unflatten(arrays, "epoch/params"), jax.tree.map(np.asarray, s.params), PARAM_BAR)


def test_run_training_with_pipeline_plan(four):
    """The training driver trains under a pipeline plan (blocks of 2 epochs and a
    trailing block of 1), writes checkpoints, and keeps the unsplit
    parameter tree."""
    ranks, _, tmp = four
    got = ranks[0]["jobs"]["driver"]
    assert np.isfinite(got["loss"]) and "encoder_layer_0" in got["param_tree"]
    assert any((tmp / "ck").rglob("*.ckpt")), "no checkpoint written"


def test_run_training_pipeline_refuses_encdec(four):
    for rank in four[0]:
        err = rank["jobs"]["encdec"]["error"]
        assert err[0] == "NotImplementedError" and "encoder-only" in err[1]


def test_check_pipeline_batch_errors():
    plan = types.SimpleNamespace(n_stages=2, n_data=2, n_micro=4)
    check_pipeline_batch(plan, batch_size=16, n_layers=8)  # valid
    with pytest.raises(ValueError, match="not divisible by\n?.*--pp_stages"):
        check_pipeline_batch(plan, batch_size=16, n_layers=7)
    with pytest.raises(ValueError, match="n_micro"):
        check_pipeline_batch(plan, batch_size=10, n_layers=8)
    with pytest.raises(ValueError, match="data axis"):
        check_pipeline_batch(plan, batch_size=4, n_layers=8)
