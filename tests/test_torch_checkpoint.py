"""The port's checkpoints against the JAX package on the CPU: the msgpack
codec byte for byte against ``flax.serialization``, the YAML reader against
``yaml.safe_load``, the config's JSON form, files written by either package
loaded by the other (both families, SGD and Adam), and the port's
counterparts of ``tests/test_train.py``'s checkpoint cases."""

import dataclasses
import glob
import json
import os
import shutil

import ml_dtypes
import numpy as np
import optax
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import serialization

from transformergrooveinfilling_tpu.models import build_model as jax_build_model
from transformergrooveinfilling_tpu.models.transformer import (
    GrooveTransformerConfig as JaxConfig,
)
from transformergrooveinfilling_tpu.train import checkpoint as jax_ckpt
from transformergrooveinfilling_tpu.train import config as jax_config
from transformergrooveinfilling_tpu.train import driver as jax_driver
from transformergrooveinfilling_tpu.train import loop as jax_loop
from transformergrooveinfilling_tpu_torch.models import GrooveTransformerConfig, build_model
from transformergrooveinfilling_tpu_torch.models import torch_compat
from transformergrooveinfilling_tpu_torch.train import (
    checkpoint as ckpt, create_train_state, initialize_model, load_hyperparameters, load_paths,
    make_train_step,
)
from transformergrooveinfilling_tpu_torch.utils import msgpack, yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(d_model=32, n_heads=2, dim_feedforward=64, num_encoder_layers=1,
            embedding_size_src=27)
FAMILIES = {"encoder_only": 0, "encoder_decoder": 1}
PENALTY = 0.73


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _configs(n_dec: int = 0, **kw):
    return (JaxConfig(dropout=0.0, num_decoder_layers=n_dec, **ARCH, **kw),
            GrooveTransformerConfig(dropout=0.0, num_decoder_layers=n_dec, **ARCH, **kw))


def _jax_params(cfg, seed=0):
    args = [jnp.zeros((1, 32, 27))] + ([jnp.zeros((1, 32, 27))] if cfg.num_decoder_layers else [])
    return jax_build_model(cfg).init(jax.random.PRNGKey(seed), *args,
                                     deterministic=True)["params"]


def _jax_forward(cfg, params, x):
    args = (x,) if cfg.num_decoder_layers == 0 else (x, None)
    return [np.asarray(a) for a in jax_build_model(cfg).apply({"params": params}, *args,
                                                            deterministic=True)]


def _port_forward(cfg, state_dict, x):
    model = build_model(cfg, "cpu")
    model.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        return [a.numpy() for a in model(torch.from_numpy(x))]


def _hvo(rng, n):
    h = (rng.random((n, 32, 9)) < 0.3).astype(np.float32)
    return np.concatenate([h, h * rng.random(h.shape), h * (rng.random(h.shape) - 0.5)],
                          axis=-1).astype(np.float32)


# ---------------------------------------------------------------- msgpack


def _payload_tree(rng):
    """A checkpoint payload as the JAX package writes it: Adam's state, f32
    parameters, an int32 count, the meta block."""
    cfg, _ = _configs()
    params = jax.tree.map(np.asarray, _jax_params(cfg))
    tx = optax.adam(1e-3)
    return {"state": jax_ckpt._payload_from(params, tx.init(params)),
            "meta": {"epoch": 3, "loss": 0.25, "run_id": "r" * 40,
                     "config": json.dumps(jax_ckpt._config_dict(cfg))}}


def _leaf_tree(rng):
    return {"f32": rng.standard_normal((3, 5)).astype(np.float32),
            "i32": np.arange(7, dtype=np.int32), "i32_0d": np.array(5, np.int32),
            "bf16": rng.standard_normal((4, 2)).astype(ml_dtypes.bfloat16),
            "scalars": {"f32": np.float32(1.5), "f64": np.float64(2.25), "i64": np.int64(-3),
                        "bool": np.bool_(True)},
            "python": {"ints": [0, 127, 128, -32, -33, -129, 70000, -70000, 2 ** 40, -2 ** 40],
                       "float": -0.5, "none": None, "flags": [True, False],
                       "str": "s" * 40, "long": "x" * 300, "bytes": b"\x01" * 300,
                       "complex": 1.5 - 2j, "many": {str(i): i for i in range(20)},
                       "empty": {}}}


def _words(a):
    """bf16 leaves of either form (a torch tensor, an ml_dtypes array) as
    their int16 words; other leaves as they are."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    if getattr(a, "dtype", None) == ml_dtypes.bfloat16:
        return a.view(np.int16)
    return a


@pytest.mark.parametrize("make", [_payload_tree, _leaf_tree], ids=["payload", "leaves"])
def test_msgpack_bytes_equal_flax_and_round_trip(rng, make):
    tree = make(rng)
    want = serialization.msgpack_serialize(tree)
    assert msgpack.serialize(tree) == want
    flat_want = jax.tree_util.tree_leaves_with_path(jax.tree.map(_words, tree))
    for got in (msgpack.restore(want), serialization.msgpack_restore(msgpack.serialize(tree))):
        flat_got = jax.tree_util.tree_leaves_with_path(jax.tree.map(_words, got))
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (path, a), (_, b) in zip(flat_got, flat_want):
            assert type(a) is type(b), path
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def test_msgpack_bf16_tensor_is_written_as_jax_writes_bf16(rng):
    t = torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32)).bfloat16()
    want = serialization.msgpack_serialize({"w": jnp.asarray(t.float().numpy(), jnp.bfloat16)})
    assert msgpack.serialize({"w": t}) == want
    assert torch.equal(msgpack.restore(want)["w"], t)


def test_msgpack_reads_and_writes_flax_chunked_arrays(rng, monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"big": rng.standard_normal((10, 7)).astype(np.float32),
            "small": np.ones(3, np.float32), "nested": {"big": np.arange(40, dtype=np.int32)}}
    written = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in written
    assert msgpack.serialize(tree) == written
    back = msgpack.restore(written)
    for key in ("big", "small"):
        np.testing.assert_array_equal(back[key], tree[key])
    np.testing.assert_array_equal(back["nested"]["big"], tree["nested"]["big"])


def test_msgpack_refuses_what_flax_does_not_write():
    with pytest.raises(TypeError):
        msgpack.serialize({"x": object()})
    with pytest.raises(ValueError, match="ext type 9"):
        msgpack.restore(bytes([0xD4, 9, 0]))
    with pytest.raises(ValueError, match="truncated"):
        msgpack.restore(serialization.msgpack_serialize({"a": "abc"})[:-1])


# ---------------------------------------------------------------- YAML


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_yaml_reader_equals_safe_load(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    got = yaml_subset.load_file(path)
    assert got == want and json.dumps(got) == json.dumps(want)


@pytest.mark.parametrize("text", [
    "a: 1.\nb: .5\nc: -.5\nd: 1e-3\ne: 1.0e-3\nf: +5\ng: .inf\nh: -.Inf\ni: .nan",
    "a: 'it''s'\nb: \"x\\ty\"\nc: yes\nd: Off\ne: ~\nf:\ng: Null",
    "a: {}\nb: []\nc: [1, [2, 3], {d: e}]\nf: {g: , h: i}\nj: [1, 2,]",
    "a: x # comment\nb: x#y\n# c: 3\nd:\n  e:\n    f: 1\n  g: 'h # not a comment'",
    "1: 2\nkey with spaces: value with spaces\n'quoted key': -x"])
def test_yaml_reader_equals_safe_load_inside_the_subset(text):
    got, want = yaml_subset.safe_load(text), yaml.safe_load(text)
    assert repr(got) == repr(want)


@pytest.mark.parametrize("text, line", [
    ("a: 0x1F", 1), ("a: 1\nb: 007", 2), ("a: 1_000", 1), ("a: 2001-12-14", 1),
    ("a: &x 1", 1), ("a: *x", 1), ("a: |\n  x", 1), ("- 1", 1), ("a: !!str 1", 1),
    ("---\na: 1", 1), ("a: b: c", 1), ("a: 1:30", 1), ("a: 'x", 1), ("a: 1\n  b: 2", 2),
    ("a:\n    b: 1\n  c: 2", 3), ("a: [1, 2", 1)])
def test_yaml_reader_raises_outside_the_subset_naming_the_line(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        yaml_subset.safe_load(text)


def test_hyperparameter_and_path_loaders_equal_the_jax_package(monkeypatch):
    path = os.path.join(REPO, "configs", "InfillingRandom_training.yaml")
    assert load_hyperparameters(path).to_dict() == jax_config.load_hyperparameters(path).to_dict()
    paths = os.path.join(REPO, "configs", "paths.yaml")
    assert load_paths(paths) == jax_config.load_paths(paths)


# ---------------------------------------------------------------- config JSON


def test_config_json_crosses_packages():
    jax_cfg = JaxConfig(d_model=64, n_heads=4, dim_feedforward=128, num_decoder_layers=2,
                        compute_dtype=jnp.bfloat16, use_pallas_attention=True, remat=True,
                        remat_policy="dots", fused_layer=True)
    port_cfg = ckpt.config_from_json_dict(json.loads(json.dumps(jax_ckpt._config_dict(jax_cfg))))
    assert port_cfg.compute_dtype == torch.bfloat16 and port_cfg.use_fused_attention
    assert ckpt._config_dict(port_cfg) == jax_ckpt._config_dict(jax_cfg)
    assert list(ckpt._config_dict(port_cfg)) == list(jax_ckpt._config_dict(jax_cfg))
    back = jax_ckpt.config_from_json_dict(json.loads(json.dumps(ckpt._config_dict(port_cfg))))
    assert back == dataclasses.replace(jax_cfg, compute_dtype=np.dtype("bfloat16").type)
    with pytest.raises(TypeError):
        ckpt.config_from_json_dict({"d_model": 8, "no_such_field": 1})


# ---------------------------------------------------------------- cross-package files


def _port_sgd_state(port_cfg, params, lr=0.05, algorithm="sgd"):
    state = create_train_state(port_cfg, algorithm, lr, 0, "cpu")
    state.model.load_state_dict(torch_compat.state_dict_from_flax_params(params, port_cfg),
                                strict=True)
    return state


@pytest.mark.parametrize("family", FAMILIES)
def test_a_jax_ckpt_serves_in_the_port_and_a_port_ckpt_in_jax(tmp_path, rng, family):
    """The same weights and config written by either package give the same
    file, byte for byte; each package's file loads in the other with the
    forward within 1e-6 of the writer's."""
    jax_cfg, port_cfg = _configs(FAMILIES[family])
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                          .astype(np.float32), _jax_params(jax_cfg, 1))
    tx = optax.sgd(0.05)
    jax_state = jax_loop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                    opt_state=tx.init(params))
    jax_path = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), "x", 4, jax_state, 0.5, jax_cfg)
    port_path = ckpt.save_checkpoint(str(tmp_path / "port"), "x", 4,
                                     _port_sgd_state(port_cfg, params), 0.5, port_cfg)
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()

    x = rng.standard_normal((3, 32, 27)).astype(np.float32)
    want = _jax_forward(jax_cfg, params, jnp.asarray(x))
    sd, cfg, epoch, loss = ckpt.load_params_and_config(str(tmp_path / "jax"))
    assert (cfg, epoch, loss) == (port_cfg, 4, 0.5)
    for got, w in zip(_port_forward(cfg, sd, x), want):
        np.testing.assert_allclose(got, w, atol=1e-6)
    jparams, jcfg, jepoch, _ = jax_ckpt.load_params_and_config(str(tmp_path / "port"))
    assert jcfg == jax_cfg and jepoch == 4
    assert jax_ckpt.load_checkpoint_config(port_path) == jax_cfg
    restored, opt_state, initial = jax_ckpt.restore({"dir": str(tmp_path / "port")}, jax_cfg)
    assert initial == 5 and opt_state == {"0": {}, "1": {}}
    for got, w in zip(_jax_forward(jcfg, jparams, jnp.asarray(x)), want):
        np.testing.assert_allclose(got, w, atol=1e-6)


def _init_params(n_dec, lr=1e-2):
    return {"model": {**{k: v for k, v in ARCH.items()}, "num_decoder_layers": n_dec,
                      "dropout": 0.0, "optimizer": "adam", "max_len": 32,
                      "embedding_size_tgt": 27},
            "training": {"learning_rate": lr, "batch_size": 8, "seed": 0}}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adam_resumes_across_packages(tmp_path, rng, writer, family):
    """3 Adam steps in the writer, its file restored by the other package's
    ``initialize_model(load_model=...)``: the restored parameters and
    moments equal the writer's; 3 more steps in both: the parameters agree
    within the 3-step bar (5e-5), so optax's count and torch's per-parameter
    step took the same bias correction. The key rows of each attention's
    input bias are held to 6 steps of the rate instead: softmax is invariant
    to them, so their gradient is 0 but for rounding, and Adam divides that
    noise by its own size (an update of ±lr either way in either package)."""
    n_dec = FAMILIES[family]
    jax_cfg, port_cfg = _configs(n_dec)
    enc_only = n_dec == 0
    tx = optax.adam(1e-2)
    jax_step = jax.jit(jax_loop.make_train_step(jax_build_model(jax_cfg), tx, PENALTY,
                                                encoder_only=enc_only))
    port_step = make_train_step(PENALTY, encoder_only=enc_only)
    batches = [(rng.standard_normal((8, 32, 27)).astype(np.float32), _hvo(rng, 8))
               for _ in range(6)]
    w = np.ones(8, np.float32)
    params = jax.tree.map(np.asarray, _jax_params(jax_cfg, 2))
    jax_state = jax_loop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                    opt_state=tx.init(params))
    port_state = _port_sgd_state(port_cfg, params, 1e-2, "adam")
    gen = torch.Generator()

    def jax_steps(state, bs):
        for x, y in bs:
            state, _ = jax_step(state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                                jax.random.PRNGKey(0))
        return state

    def port_steps(state, bs):
        for x, y in bs:
            port_step(state, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w), gen)

    load = {"location": "local", "dir": str(tmp_path)}
    if writer == "jax":
        jax_state = jax_steps(jax_state, batches[:3])
        jax_ckpt.save_checkpoint(str(tmp_path), "a", 2, jax_state, 1.0, jax_cfg)
        bundle, _opt, initial = initialize_model({**_init_params(n_dec), "load_model": load},
                                                 "cpu")
        port_state = bundle.state
    else:
        port_steps(port_state, batches[:3])
        ckpt.save_checkpoint(str(tmp_path), "a", 2, port_state, 1.0, port_cfg)
        bundle, _tx, initial = jax_driver.initialize_model({**_init_params(n_dec),
                                                           "load_model": load})
        jax_state = bundle.state
    assert initial == 3
    restored = torch_compat.optax_state_from_optimizer(port_state.optimizer, port_state.model,
                                                       port_cfg)
    want_opt = serialization.to_state_dict(jax.tree.map(np.asarray, jax_state.opt_state))
    jax.tree.map(np.testing.assert_array_equal, restored, want_opt)
    jax.tree.map(np.testing.assert_array_equal,
                 torch_compat.flax_params_from_state_dict(port_state.model.state_dict(), port_cfg),
                 jax.tree.map(np.asarray, jax_state.params))
    jax_state = jax_steps(jax_state, batches[3:])
    port_steps(port_state, batches[3:])
    assert all(float(s["step"]) == 6 for s in port_state.optimizer.state.values())
    assert int(jax_state.opt_state[0].count) == 6
    want = torch_compat.state_dict_from_flax_params(jax.tree.map(np.asarray, jax_state.params),
                                                    port_cfg)
    d = port_cfg.d_model
    for name, p in port_state.model.state_dict().items():
        got, w = p.numpy(), want[name].numpy()
        if name.endswith("in_proj_bias"):
            np.testing.assert_allclose(got[d:2 * d], w[d:2 * d], atol=6 * 1e-2, err_msg=name)
            got, w = np.delete(got, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(got, w, atol=5e-5, err_msg=name)


def test_initialize_model_refuses_another_optimizers_state(tmp_path):
    _jax_cfg, port_cfg = _configs()
    ckpt.save_checkpoint(str(tmp_path), "a", 0, create_train_state(port_cfg, "sgd", 0.1, 0, "cpu"),
                         1.0, port_cfg)
    with pytest.raises(ValueError, match="optimizer"):
        initialize_model({**_init_params(0), "load_model": {"dir": str(tmp_path)}}, "cpu")
    with pytest.raises(ValueError, match="architecture"):
        ckpt.restore({"dir": str(tmp_path)}, dataclasses.replace(port_cfg, d_model=64))


# ---------------------------------------------------------------- tests/test_train.py's cases


CFG = GrooveTransformerConfig(d_model=16, n_heads=2, dim_feedforward=16, dropout=0.1,
                              num_encoder_layers=1, embedding_size_src=27)


def _state(seed=3, algorithm="sgd"):
    return create_train_state(CFG, algorithm, 0.05, seed, "cpu")


def _params_equal(params, model):
    want = torch_compat.flax_params_from_state_dict(model.state_dict(), model.config)
    jax.tree.map(np.testing.assert_array_equal, params, want)


def test_checkpoint_round_trip(tmp_path):
    """tests/test_train.py:92: save, load, find the newest, restore → epoch + 1."""
    state = _state()
    path = ckpt.save_checkpoint(str(tmp_path), "runX", 7, state, 1.23, CFG)
    params, opt_state, epoch, loss = ckpt.load_checkpoint(path)
    assert epoch == 7 and abs(loss - 1.23) < 1e-9 and opt_state == {"0": {}, "1": {}}
    _params_equal(params, state.model)
    assert ckpt.find_latest(str(tmp_path)) == (path, 7)
    restored, _opt, initial = ckpt.restore({"location": "local", "dir": str(tmp_path)}, CFG)
    assert initial == 8
    _params_equal(restored, state.model)


def test_legacy_model_restore(tmp_path):
    """tests/test_train.py:159: initialize_model resumes from a reference
    .Model directory (parameters only; the in-repo demo file, epoch 799)."""
    demo = os.path.join(REPO, "demo", "transformer_run_demo_Epoch_799.Model")
    shutil.copy(demo, tmp_path)
    params = {"model": {"d_model": 32, "n_heads": 4, "dim_feedforward": 512, "dropout": 0.1,
                        "num_encoder_layers": 6, "embedding_size_src": 27, "optimizer": "adam"},
              "training": {"learning_rate": 0.094, "batch_size": 32},
              "load_model": {"location": "local", "dir": str(tmp_path),
                             "file_pattern": "transformer_run_{}_Epoch_{}.Model"}}
    bundle, opt, initial_epoch = initialize_model(params, "cpu")
    assert initial_epoch == 800 and not opt.state  # a .Model carries no optimizer state
    sd, _epoch, _loss = torch_compat.load_legacy_checkpoint(demo, bundle.config)
    for name, p in bundle.model.state_dict().items():
        assert torch.equal(p, sd[name]), name


def test_restore_prefers_native_over_legacy(tmp_path):
    """tests/test_train.py:479: a .ckpt and a .Model of one epoch; the native
    file, which carries the optimizer state, wins."""
    state = _state(2, "adam")
    ckpt.save_checkpoint(str(tmp_path), "dual", 5, state, 1.0, CFG)
    ckpt.export_legacy(str(tmp_path), "dual", 5,
                       torch_compat.flax_params_from_state_dict(state.model.state_dict(), CFG),
                       CFG, 1.0)
    _params, opt_state, initial = ckpt.restore(
        {"location": "local", "dir": str(tmp_path), "epoch": 5}, CFG)
    assert initial == 6 and set(opt_state["0"]) == {"count", "mu", "nu"}


def test_flush_async_saves_reraises_write_failure(tmp_path):
    """tests/test_train.py:468."""
    not_a_dir = tmp_path / "blocker"
    not_a_dir.write_text("")
    ckpt.save_checkpoint_async(str(not_a_dir), "bad", 0, _state(1), 1.0, CFG)
    with pytest.raises(FileExistsError):
        ckpt.flush_async_saves()


def test_crash_mid_write_never_corrupts_resume(tmp_path):
    """tests/test_train.py:653: a truncated temporary file of a later epoch
    is invisible; the last whole checkpoint still loads; a fresh save of that
    epoch replaces the leftover."""
    state = _state(1)
    good = ckpt.save_checkpoint(str(tmp_path), "crash", 3, state, 2.5, CFG)
    with open(good, "rb") as f:
        blob = f.read()
    with open(os.path.join(tmp_path, ckpt.CKPT_PATTERN.format("crash", 7) + ".tmp"), "wb") as f:
        f.write(blob[: len(blob) // 3])
    path, latest = ckpt.find_latest(str(tmp_path))
    assert latest == 3 and ckpt.load_checkpoint(path)[2:] == (3, 2.5)
    ckpt.save_checkpoint(str(tmp_path), "crash", 7, state, 1.5, CFG)
    path, latest = ckpt.find_latest(str(tmp_path))
    assert latest == 7 and ckpt.load_checkpoint(path)[2:] == (7, 1.5)


def test_snapshot_saves_backpressure_releases(tmp_path):
    """tests/test_train.py:738: six back-to-back snapshot saves, past the
    3-slot bound, all land; each holds the state as it was at its snapshot,
    not as the following updates left it."""
    state = _state(6, "adam")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 32, 27)).astype(np.float32))
    y = torch.zeros(4, 32, 27)
    step = make_train_step(PENALTY)
    want = []
    for ep in range(6):
        snap = ckpt.snapshot_state_on_device(state)
        want.append(torch_compat.flax_params_from_state_dict(state.model.state_dict(), CFG))
        ckpt.save_snapshot_async(str(tmp_path), "bp", ep, snap, 0.1, CFG, legacy=ep == 5)
        step(state, x, y, None, torch.Generator().manual_seed(ep))
    ckpt.flush_async_saves()
    assert sorted(os.listdir(tmp_path)) == sorted(
        [ckpt.CKPT_PATTERN.format("bp", ep) for ep in range(6)]
        + ["transformer_run_bp_Epoch_5.Model"])
    for ep in range(6):
        params, opt_state, _, _ = ckpt.load_checkpoint(
            os.path.join(tmp_path, ckpt.CKPT_PATTERN.format("bp", ep)))
        jax.tree.map(np.testing.assert_array_equal, params, want[ep])
        assert int(opt_state["0"]["count"]) == ep
