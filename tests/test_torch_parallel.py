"""The port's mesh, partition rules and data-parallel (× tensor-parallel)
training against the JAX package, case for case with
``tests/test_parallel.py``: the port's ranks are processes of one gloo group
on the CPU (``tests/torch_parallel_worker.py``), the JAX functions run here
on the 8 virtual CPU devices, and both start from the same flax weights and
numpy inputs. The bars: 3-step SGD 5e-5 on the weights (ROADMAP), metrics
1e-4 relative."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu.models import build_model as jax_build_model
from transformergrooveinfilling_tpu.models.transformer import (
    GrooveTransformerConfig as JaxConfig,
)
from transformergrooveinfilling_tpu.parallel.mesh import (
    param_partition_specs as jax_partition_specs,
)
from transformergrooveinfilling_tpu.train import loop as jax_loop
from transformergrooveinfilling_tpu_torch.models import GrooveTransformerConfig, build_model
from transformergrooveinfilling_tpu_torch.parallel import (
    global_mesh, initialize_from_env, is_main_process, local_batch_slice,
    param_partition_specs,
)
from transformergrooveinfilling_tpu_torch.train.config import resolve_fused_layer
from torch_parallel_group import flax_arrays, run_group, unflatten

CFG = dict(d_model=32, n_heads=4, dim_feedforward=16, dropout=0.0, num_encoder_layers=2,
           embedding_size_src=16)
FUSED = dict(d_model=256, n_heads=2, dim_feedforward=512, dropout=0.0, num_encoder_layers=1,
             embedding_size_src=16)
FUSED_DEC = dict(FUSED, num_decoder_layers=1, embedding_size_tgt=27)
RANKS = 4
PARAM_BAR = 5e-5


def _data(rng, n=32):
    x = rng.standard_normal((n, 32, 16)).astype(np.float32)
    h = (rng.random((n, 32, 9)) < 0.3).astype(np.float32)
    return x, np.concatenate([h, h * 0.7, h * 0.1], 2).astype(np.float32)


def _init(cfg: dict, key: int = 0):
    params = jax_build_model(JaxConfig(**cfg)).init(
        jax.random.PRNGKey(key), jnp.zeros((1, 32, 16)), deterministic=True)["params"]
    return jax.tree.map(np.asarray, params)


def _jax_epoch(cfg: dict, params, x, y, batch, encoder_only=True):
    model = jax_build_model(JaxConfig(**cfg))
    tx = jax_loop.make_optimizer("sgd", 0.05)
    state = jax_loop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=tx.init(params))
    epoch = jax_loop.make_epoch_fn(model, tx, 0.5, batch, x.shape[0], donate=False,
                                   shuffle=False, encoder_only=encoder_only)
    s, m = epoch(state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(9))
    return jax.tree.map(np.asarray, s.params), {k: float(v) for k, v in m.items()}


def _epoch_job(job_id, cfg, params, plan, batch, x="x", y="y", encoder_only=True):
    return {"id": job_id, "kind": "epoch", "cfg": cfg, "params": params, "x": x, "y": y,
            "plan": plan, "penalty": 0.5, "lr": 0.05, "batch": batch,
            "encoder_only": encoder_only}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """One group of 4 ranks runs every case's port side."""
    rng = np.random.default_rng(0)
    x, y = _data(rng)
    x30, y30 = _data(rng, 30)
    x64, y64 = _data(rng, 64)
    inputs = {"small": _init(CFG), "fused": _init(FUSED), "fused_dec": _init(FUSED_DEC)}
    data = {"x": x, "y": y, "x30": x30, "y30": y30, "x64": x64, "y64": y64}
    for name, p in inputs.items():
        data.update(flax_arrays(p, name))
    jobs = [{"id": "helpers", "kind": "helpers", "n_model": 2},
            _epoch_job("dp", CFG, "small", {"kind": "mesh"}, 8),
            _epoch_job("dp_tp", CFG, "small", {"kind": "mesh", "n_model": 2}, 8),
            _epoch_job("dp30", CFG, "small", {"kind": "mesh"}, 8, "x30", "y30"),
            _epoch_job("fused", dict(FUSED, fused_layer=True), "fused", {"kind": "mesh"},
                       32, "x64", "y64"),
            _epoch_job("fused_dec", dict(FUSED_DEC, fused_layer=True,
                                         fused_decoder_layer=True),
                       "fused_dec", {"kind": "mesh"}, 32, "x64", "y64", encoder_only=False)]
    ranks, arrays = run_group(RANKS, jobs, tmp_path_factory.mktemp("parallel"), "parallel",
                              data, timeout=300)
    return {"ranks": ranks, "arrays": arrays, "inputs": inputs, "data": data}


def _assert_params(got: dict, want: dict, atol: float, rtol: float = 0.0):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_params(got[k], want[k], atol, rtol)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_mesh_shapes(group):
    for r, rank in enumerate(group["ranks"]):
        h = rank["jobs"]["helpers"]
        assert (h["n_data"], h["n_model"]) == (2, 2)
        assert (h["data_rank"], h["model_rank"]) == divmod(r, 2)  # "model" innermost
        assert h["backend"] == "gloo" and h["transport"] == "device"
        assert h["main"] == (r == 0) and h["slice"] == [8 * r, 8 * r + 8]
        assert not rank["jax_loaded"]


def test_partition_specs_rules():
    """The JAX rule table on the port's flax paths, leaf for leaf."""
    model = build_model(GrooveTransformerConfig(**CFG), "cpu")
    specs = param_partition_specs(model)
    want = jax.tree.map(tuple, jax_partition_specs(_init(CFG)),
                        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert specs == want
    l0 = specs["encoder_layer_0"]
    assert l0["self_attn"]["qkv"]["kernel"] == (None, "model")
    assert l0["self_attn"]["out"]["kernel"] == ("model", None)
    assert l0["linear1"]["kernel"] == (None, "model")
    assert l0["linear2"]["kernel"] == ("model", None)
    assert specs["encoder_norm"]["scale"] == ()
    assert specs["input"]["embed"]["kernel"] == ()


@pytest.mark.parametrize("n_model", [1, 2])
def test_sharded_training_matches_single_device(group, n_model):
    """dp(×tp) over the group's ranks equals one device of the JAX package."""
    d = group["data"]
    want_p, want_m = _jax_epoch(CFG, group["inputs"]["small"], d["x"], d["y"], 8)
    job = "dp" if n_model == 1 else "dp_tp"
    got = group["ranks"][0]["jobs"][job]
    assert abs(got["loss"] - want_m["loss"]) < 1e-4
    _assert_params(unflatten(group["arrays"], f"{job}/params"), want_p, PARAM_BAR)
    for rank in group["ranks"][1:]:
        assert rank["jobs"][job] == got


def test_dp_shard_step_matches_single_device(group):
    """The per-rank step with a padded final batch (30 rows, batch 8: the
    last batch's zero-weight rows land on real ranks): every metric and the
    weights of the single-device epoch."""
    d = group["data"]
    want_p, want_m = _jax_epoch(CFG, group["inputs"]["small"], d["x30"], d["y30"], 8)
    got = group["ranks"][0]["jobs"]["dp30"]
    assert set(got) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got[k], want_m[k], rtol=1e-4, err_msg=k)
    _assert_params(unflatten(group["arrays"], "dp30/params"), want_p, PARAM_BAR)


def test_dp_shard_fused_layer_matches_unfused_single_device(group):
    """fused_layer over the data axis: each rank runs the layer chain's plain
    version on its rows (the kernel on the card), against the JAX package's
    unfused single-device epoch (the JAX test's bars)."""
    d = group["data"]
    want_p, want_m = _jax_epoch(FUSED, group["inputs"]["fused"], d["x64"], d["y64"], 32)
    got = group["ranks"][0]["jobs"]["fused"]
    np.testing.assert_allclose(got["loss"], want_m["loss"], rtol=2e-4)
    _assert_params(unflatten(group["arrays"], "fused/params"), want_p, 5e-4, 5e-3)


def test_dp_shard_fused_decoder_layer_matches_unfused_single_device(group):
    d = group["data"]
    want_p, want_m = _jax_epoch(FUSED_DEC, group["inputs"]["fused_dec"], d["x64"], d["y64"], 32,
                                encoder_only=False)
    got = group["ranks"][0]["jobs"]["fused_dec"]
    np.testing.assert_allclose(got["loss"], want_m["loss"], rtol=2e-4)
    _assert_params(unflatten(group["arrays"], "fused_dec/params"), want_p, 5e-4, 5e-3)


def test_resolve_fused_layer_dp_topology():
    """Auto keeps the chain on for one device and for a dp-only plan whose
    batch divides the data axis (a rank's share within the measured batch),
    off on any other topology; a given switch wins."""
    bf16 = torch.bfloat16
    assert resolve_fused_layer(None, 256, 2, 512, n_devices=1, compute_dtype=bf16,
                               batch_size=32)
    assert resolve_fused_layer(None, 256, 2, 512, n_devices=8, compute_dtype=bf16,
                               batch_size=64, dp_shard_ok=True)
    assert not resolve_fused_layer(None, 256, 2, 512, n_devices=8, compute_dtype=bf16,
                                   batch_size=64)
    assert not resolve_fused_layer(None, 256, 2, 512, n_devices=2, compute_dtype=bf16,
                                   batch_size=2048, dp_shard_ok=True)
    assert resolve_fused_layer(True, 256, 2, 512, n_devices=8)
    assert not resolve_fused_layer(False, 256, 2, 512, n_devices=1, batch_size=32)


def test_data_sharding_spec(group):
    """``data_sharding``'s spec and a rank's rows of the data axis."""
    for rank in group["ranks"]:
        h = rank["jobs"]["helpers"]
        assert h["data_spec"] == ["data", None, None]
        assert h["rows_of_10"] == ([0, 5] if h["data_rank"] == 0 else [5, 10])


def test_multihost_helpers_single_process():
    assert initialize_from_env(device="cpu") is False  # no group named: a no-op
    assert is_main_process()
    plan = global_mesh(n_model=1, device="cpu")
    assert plan.n_data * plan.n_model == 1
    assert local_batch_slice(32) == slice(0, 32)


def test_no_rank_imports_jax(group):
    """Importing the port's parallel package and running a group leaves jax
    out of every rank."""
    assert [r["jax_loaded"] for r in group["ranks"]] == [False] * RANKS
