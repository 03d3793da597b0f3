"""The port's training slice against the JAX package on the CPU: parameter
init, dropout, the loss, the optimizers, the train step and the epoch (with
and without the fused layer, whose JAX side runs its Pallas kernel in
interpret mode at dropout 0), the configuration, and the reference contract
``initialize_model`` + ``train_loop``."""

import dataclasses
import glob
import math
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu.models import build_model as jax_build_model
from transformergrooveinfilling_tpu.models.losses import calculate_loss as jax_calculate_loss
from transformergrooveinfilling_tpu.models.transformer import (
    GrooveTransformerConfig as JaxConfig,
)
from transformergrooveinfilling_tpu.train import config as jax_config
from transformergrooveinfilling_tpu.train import loop as jax_loop
from transformergrooveinfilling_tpu.train.driver import _LOSS_KEYS
from transformergrooveinfilling_tpu_torch.models import (
    GrooveTransformerConfig, build_model, calculate_loss,
)
from transformergrooveinfilling_tpu_torch.models.torch_compat import (
    state_dict_from_flax_params,
)
from transformergrooveinfilling_tpu_torch.ops.dropout import (
    bernoulli_dropout, fast_dropout, quantized_keep_rate,
)
from transformergrooveinfilling_tpu_torch.train import (
    HyperParams, TrainState, create_train_state, derive_model_config, initialize_model,
    load_hyperparameters, make_epoch_fn, make_optimizer, make_train_step, train_loop,
)
from transformergrooveinfilling_tpu_torch.train import config as port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = dict(d_model=256, n_heads=2, dim_feedforward=512, num_encoder_layers=6,
                embedding_size_src=16)
LR, PENALTY = 0.089, 0.73  # configs/InfillingRandom_training.yaml


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small eager ops on all cores stall when test workers share the host's
    cores; two threads each keep this module's runtime near its solo time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def hvo_targets(rng, n, voices=9, t=32):
    h = (rng.random((n, t, voices)) < 0.3).astype(np.float32)
    return np.concatenate([h, h * rng.random(h.shape), h * (rng.random(h.shape) - 0.5)],
                          axis=-1).astype(np.float32)


# ---------------------------------------------------------------- init


def test_init_matches_flax_init_at_the_flagship_width():
    """Zero biases, unit LN scales, and every weight a truncated lecun_normal
    like flax's: std within 3 % of the JAX tensor's, cut at 2σ."""
    cfg = JaxConfig(dropout=0.0, **FLAGSHIP)
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 16)),
                                       deterministic=True)["params"]
    want = state_dict_from_flax_params(jax.tree.map(np.asarray, params),
                                       GrooveTransformerConfig(**FLAGSHIP))
    got = build_model(GrooveTransformerConfig(**FLAGSHIP), "cpu").state_dict()
    assert got.keys() == want.keys()
    for name, w in got.items():
        if name.endswith("bias"):
            assert torch.count_nonzero(w) == 0, name
        elif w.dim() == 1:  # LayerNorm scale
            assert torch.equal(w, torch.ones_like(w)), name
        else:
            fan_in = w.shape[1]
            sigma = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert float(w.abs().max()) <= 2 * sigma, name
            assert abs(float(w.std()) / float(want[name].std()) - 1) < 0.03, name
            assert abs(float(w.std()) * math.sqrt(fan_in) - 1) < 0.03, name


def test_init_is_seeded_and_device_free():
    cfg = GrooveTransformerConfig(num_encoder_layers=1)
    a = build_model(cfg, "cpu", torch.Generator().manual_seed(4)).state_dict()
    b = build_model(cfg, "cpu", torch.Generator().manual_seed(4)).state_dict()
    c = build_model(cfg, "cpu", torch.Generator().manual_seed(5)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["OutputLayer.Linear.weight"], c["OutputLayer.Linear.weight"])
    state = torch.random.get_rng_state()
    build_model(cfg, "cpu")
    assert torch.equal(state, torch.random.get_rng_state())  # the global RNG is untouched


# ---------------------------------------------------------------- dropout


@pytest.fixture
def x(rng):
    return torch.from_numpy(rng.standard_normal((64, 32, 48)).astype(np.float32))


def test_fast_dropout_deterministic_per_generator(x):
    a = fast_dropout(x, torch.Generator().manual_seed(7), 0.3)
    b = fast_dropout(x, torch.Generator().manual_seed(7), 0.3)
    c = fast_dropout(x, torch.Generator().manual_seed(8), 0.3)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.47, 0.75])
def test_fast_dropout_keep_rate_matches_quantized(x, rate):
    kept = float((fast_dropout(x, torch.Generator().manual_seed(1), rate) != 0).float().mean())
    # 64*32*48 ≈ 98k Bernoulli draws: 4 sigma ≈ 0.006
    assert abs(kept - quantized_keep_rate(rate)) < 0.008


def test_fast_dropout_unbiased(x):
    y = fast_dropout(x, torch.Generator().manual_seed(2), 0.3)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / quantized_keep_rate(0.3), rtol=1e-6, atol=0)
    g = torch.Generator().manual_seed(3)
    ones = torch.ones(4096)
    mean = torch.stack([fast_dropout(ones, g, 0.3) for _ in range(64)]).mean()
    assert abs(float(mean) - 1.0) < 4 * math.sqrt(0.3 / 0.7 / (4096 * 64))


def test_fast_dropout_backward_is_the_mask(x):
    x = x.clone().requires_grad_(True)
    y = fast_dropout(x, torch.Generator().manual_seed(3), 0.4)
    y.sum().backward()
    torch.testing.assert_close(x.grad, (y != 0).float() / quantized_keep_rate(0.4))


def test_dropout_rate_zero_identity_and_validation(x):
    g = torch.Generator()
    assert fast_dropout(x, g, 0.0) is x
    assert fast_dropout(x, g, 1e-4) is x  # below one quantisation step
    assert bernoulli_dropout(x, g, 0.0) is x
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError):
            fast_dropout(x, g, bad)
        with pytest.raises(ValueError):
            bernoulli_dropout(x, g, bad)


def test_bernoulli_dropout_exact_rate(x):
    y = bernoulli_dropout(x, torch.Generator().manual_seed(1), 0.3)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.008
    torch.testing.assert_close(y[kept], x[kept] / 0.7)


# ---------------------------------------------------------------- loss


@pytest.mark.parametrize("weights", [None, [1, 1, 0, 1], [0, 0, 0, 0]])
def test_loss_matches_jax(rng, weights):
    """Predictions near the targets, as a trained model gives them (the loss
    is then O(1), so f32 summation order stays far below the bar)."""
    target = hvo_targets(rng, 4)
    noise = [0.3 * rng.standard_normal((4, 32, 9)).astype(np.float32) for _ in range(3)]
    pred = [(2 * target[..., :9] - 1) * 3 + noise[0],
            np.clip(target[..., 9:18] + noise[1] * 0.3, 0, 1),
            np.clip(target[..., 18:] + noise[2] * 0.3, -0.5, 0.5)]
    w = None if weights is None else np.asarray(weights, np.float32)
    want = jax_calculate_loss([jnp.asarray(p) for p in pred], jnp.asarray(target), PENALTY,
                              None if w is None else jnp.asarray(w))
    got = calculate_loss([torch.from_numpy(p) for p in pred], torch.from_numpy(target),
                         PENALTY, None if w is None else torch.from_numpy(w))
    assert got._fields == want._fields
    for name, g, v in zip(got._fields, got, want):
        np.testing.assert_allclose(float(g), float(v), atol=1e-6, err_msg=name)
    if weights is not None and not any(weights):
        assert float(got.total_loss) == 0.0 and float(got.hit_perplexity) == 1.0


# ---------------------------------------------------------------- optimizers


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((8, 4), (4,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in p0] for _ in range(3)]
    tx = optax.adam(1e-2)
    params = [jnp.asarray(p) for p in p0]
    opt_state = tx.init(params)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = make_optimizer("adam", 1e-2, tparams)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(a) for a in g], opt_state, params)
        params = optax.apply_updates(params, updates)
        for p, a in zip(tparams, g):
            p.grad = torch.from_numpy(a)
        opt.step()
    for p, q in zip(tparams, params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), atol=1e-6)
    with pytest.raises(ValueError):
        make_optimizer("rmsprop", 0.1, tparams)


# ---------------------------------------------------------------- step and epoch


def _both(fused: bool):
    """JAX and port models at the flagship width, 2 layers, dropout 0, f32,
    on the same weights."""
    arch = dict(FLAGSHIP, num_encoder_layers=2)
    jax_cfg = JaxConfig(dropout=0.0, fused_layer=fused, **arch)
    model = jax_build_model(jax_cfg)
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 16)),
                        deterministic=True)["params"]
    port_cfg = GrooveTransformerConfig(dropout=0.0, fused_layer=fused, **arch)
    port = build_model(port_cfg, "cpu")
    port.load_state_dict(state_dict_from_flax_params(jax.tree.map(np.asarray, params),
                                                     port_cfg), strict=True)
    tx = optax.sgd(LR)
    jax_state = jax_loop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                    opt_state=tx.init(params))
    state = TrainState(step=0, model=port, optimizer=make_optimizer("sgd", LR, port.parameters()))
    return model, tx, jax_state, port_cfg, state


def _assert_params_close(state, jax_state, port_cfg):
    want = state_dict_from_flax_params(jax.tree.map(np.asarray, jax_state.params), port_cfg)
    for name, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=5e-5, err_msg=name)


@pytest.mark.parametrize("fused", [True, False])
def test_train_step_matches_jax(rng, fused):
    model, tx, jax_state, port_cfg, state = _both(fused)
    jax_step = jax.jit(jax_loop.make_train_step(model, tx, PENALTY))
    step = make_train_step(PENALTY)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        x = rng.standard_normal((8, 32, 16)).astype(np.float32)
        y = hvo_targets(rng, 8)
        w = np.ones(8, np.float32)
        jax_state, want = jax_step(jax_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                                   jax.random.PRNGKey(i))
        got = step(state, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w), gen)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    assert state.step == 3
    _assert_params_close(state, jax_state, port_cfg)


@pytest.mark.parametrize("fused", [True, False])
def test_epoch_with_a_partial_batch_matches_jax(rng, fused):
    model, tx, jax_state, port_cfg, state = _both(fused)
    inputs = rng.standard_normal((20, 32, 16)).astype(np.float32)
    outputs = hvo_targets(rng, 20)
    jax_epoch = jax_loop.make_epoch_fn(model, tx, PENALTY, 8, 20, donate=False, shuffle=False)
    jax_state, want = jax_epoch(jax_state, jnp.asarray(inputs), jnp.asarray(outputs),
                                jax.random.PRNGKey(0))
    epoch = make_epoch_fn(PENALTY, 8, 20, shuffle=False)
    got = epoch(state, torch.from_numpy(inputs), torch.from_numpy(outputs),
                torch.Generator().manual_seed(0))
    assert got.keys() == want.keys() and state.step == 3
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-4, err_msg=k)
    _assert_params_close(state, jax_state, port_cfg)


def test_groovexl_width_sgd_0p05_matches_jax():
    """GrooveXL's width (scripts/bench_groovexl_ffn.py: d 1024, 8 heads, ff
    4096; 2 layers, batch 4, f32, dropout 0) at that script's SGD rate of 0.05
    and hit penalty 0.73, on its kind of data: 3 steps in both packages from
    the same flax weights. Equal curves say that a loss which climbs at this
    rate is the rate's, not the port's."""
    rng = np.random.default_rng(1)
    arch = dict(d_model=1024, n_heads=8, dim_feedforward=4096, num_encoder_layers=2,
                embedding_size_src=16)
    model = jax_build_model(JaxConfig(dropout=0.0, **arch))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 16)),
                        deterministic=True)["params"]
    port_cfg = GrooveTransformerConfig(dropout=0.0, **arch)
    port = build_model(port_cfg, "cpu")
    port.load_state_dict(state_dict_from_flax_params(jax.tree.map(np.asarray, params),
                                                     port_cfg), strict=True)
    tx = optax.sgd(0.05)
    jax_state = jax_loop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                    opt_state=tx.init(params))
    state = TrainState(step=0, model=port, optimizer=make_optimizer("sgd", 0.05,
                                                                    port.parameters()))
    jax_step = jax.jit(jax_loop.make_train_step(model, tx, 0.73))
    step = make_train_step(0.73)
    x = rng.standard_normal((4, 32, 16)).astype(np.float32)
    hits = (rng.random((4, 32, 9)) < 0.3).astype(np.float32)
    y = np.concatenate([hits, hits * 0.5, hits * 0.1], 2)
    w = np.ones(4, np.float32)
    losses = []
    for i in range(3):
        jax_state, want = jax_step(jax_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                                   jax.random.PRNGKey(i))
        got = step(state, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
                   torch.Generator().manual_seed(i))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=2e-4,
                                   err_msg=f"step {i}")
        losses.append(float(want["loss"]))
    assert state.step == 3 and all(np.isfinite(losses))
    _assert_params_close(state, jax_state, port_cfg)


# ---------------------------------------------------------------- augment


def _jax_mask_draws(key, m):
    """The thresholds and uniforms ``random_mask_on_device`` draws from
    ``key`` for ``m`` items (one key per item, split into two)."""
    thres, u = [], []
    for k in jax.random.split(key, m):
        k_thres, k_events = jax.random.split(k)
        thres.append(np.array(jax.random.uniform(k_thres, (), minval=0.4, maxval=0.6)))
        u.append(np.array(jax.random.uniform(k_events, (32, 9))))
    return torch.from_numpy(np.stack(thres))[:, None, None], torch.from_numpy(np.stack(u))


@pytest.mark.parametrize("per_epoch", [True, False])
def test_epoch_with_symbolic_augment_matches_jax(rng, per_epoch):
    """The augment hook sits where the JAX epoch has it: with the JAX key's
    own draws fed to the port's select, one epoch (per-epoch hook) or one
    single-epoch block (per-block hook) trains on the same masked grids and
    ends at the same metrics and weights."""
    from transformergrooveinfilling_tpu.data.device_pipeline import (
        make_on_device_augment as jax_make_augment,
    )
    from transformergrooveinfilling_tpu_torch.hvo.ops import _remove_events

    arch = dict(d_model=32, n_heads=2, dim_feedforward=64, num_encoder_layers=2,
                embedding_size_src=27)
    jax_cfg = JaxConfig(dropout=0.0, **arch)
    model = jax_build_model(jax_cfg)
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 27)),
                        deterministic=True)["params"]
    port_cfg = GrooveTransformerConfig(dropout=0.0, **arch)
    port = build_model(port_cfg, "cpu")
    port.load_state_dict(state_dict_from_flax_params(jax.tree.map(np.asarray, params), port_cfg),
                         strict=True)
    tx = optax.sgd(LR)
    jax_state = jax_loop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                    opt_state=tx.init(params))
    state = TrainState(step=0, model=port, optimizer=make_optimizer("sgd", LR, port.parameters()))
    base = hvo_targets(rng, 20)
    key = jax.random.PRNGKey(5)
    jax_epoch = jax_loop.make_epoch_fn(model, tx, PENALTY, 8, 20, donate=False, shuffle=False,
                                       augment=jax_make_augment(mode="symbolic"),
                                       augment_per_epoch=per_epoch)
    jax_state, want = jax_epoch(jax_state, jnp.asarray(base), jnp.asarray(base), key)
    thres, u = _jax_mask_draws(jax.random.split(key)[0], 20)  # aug_key, key = split(key)
    seen = []

    def augment(generator, base_in, base_out):
        assert base_in is base_out or torch.equal(base_in, base_out)
        seen.append(generator)
        return _remove_events(base_in, thres, u)

    gen = torch.Generator().manual_seed(0)
    epoch = make_epoch_fn(PENALTY, 8, 20, shuffle=False, augment=augment,
                          augment_per_epoch=per_epoch)
    tbase = torch.from_numpy(base)
    got = epoch(state, tbase, tbase, gen)
    assert seen == [gen] and state.step == 3
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-4, err_msg=k)
    _assert_params_close(state, jax_state, port_cfg)


def test_augment_is_called_per_epoch_or_per_block(rng):
    from transformergrooveinfilling_tpu_torch.data import make_on_device_augment

    cfg = GrooveTransformerConfig(d_model=16, n_heads=2, dim_feedforward=32, dropout=0.0,
                                  num_encoder_layers=1, embedding_size_src=27)
    state = create_train_state(cfg, "sgd", 0.05, device="cpu")
    base = torch.from_numpy(hvo_targets(rng, 12))
    inner = make_on_device_augment(mode="symbolic")
    calls = []

    def augment(generator, a, b):
        out = inner(generator, a, b)
        assert torch.equal(out[0] + out[1], a)  # kept + removed = the clean grids
        calls.append(out[1])
        return out

    gen = torch.Generator().manual_seed(3)
    make_epoch_fn(PENALTY, 4, 12, n_epochs=3, augment=augment)(state, base, base, gen)
    assert len(calls) == 3 and state.step == 9
    assert not torch.equal(calls[0], calls[1])  # a fresh masking every epoch
    calls.clear()
    make_epoch_fn(PENALTY, 4, 12, n_epochs=3, augment=augment,
                  augment_per_epoch=False)(state, base, base, gen)
    assert len(calls) == 1 and state.step == 18  # once per block of 3 epochs
    calls.clear()
    make_epoch_fn(PENALTY, 4, 12, augment=augment,
                  augment_per_epoch=False)(state, base, base, gen)
    assert len(calls) == 1  # also when the block is a single epoch
    calls.clear()
    make_epoch_fn(PENALTY, 4, 12)(state, base, base, gen)
    assert not calls


def test_audio_augment_inputs_are_the_mso_of_the_kept_grids_and_loss_falls(rng, tmp_path):
    from transformergrooveinfilling_tpu.data.synthetic import synthetic_gmd_sequences
    from transformergrooveinfilling_tpu_torch.data import (
        make_on_device_augment, random_mask_on_device,
    )
    from transformergrooveinfilling_tpu_torch.ops.mso import mso_batch_from_hvo

    base = torch.from_numpy(np.stack(
        [s.hvo for s in synthetic_gmd_sequences(12, seed=2)]).astype(np.float32))
    qpms = np.linspace(150.0, 200.0, 12)
    augment = make_on_device_augment(qpms=qpms, mode="audio", chunk=5)  # 5 + 5 + 2
    inputs, outputs = augment(torch.Generator().manual_seed(7), base, base)
    kept, removed = random_mask_on_device(torch.Generator().manual_seed(7), base)
    assert inputs.shape == (12, 32, 16) and torch.equal(outputs, removed)
    want = mso_batch_from_hvo(kept.numpy(), None, qpms, device="cpu", device_synth=True)
    np.testing.assert_allclose(inputs.numpy(), want, atol=1e-6)  # the same code, other chunks
    # with SoundFont kits: each item renders through the kit drawn for it
    from transformergrooveinfilling_tpu_torch.audio.sf2 import write_minimal_sf2

    t = np.arange(3000) / 44100
    kit = str(tmp_path / "kit.sf2")
    write_minimal_sf2(kit, {36: [{"sample": np.sin(2 * np.pi * 60 * t), "vel_hi": 60},
                                 {"sample": np.sin(2 * np.pi * 45 * t), "vel_lo": 61}]})
    kits = [kit, None]
    with_kits = make_on_device_augment(qpms=qpms, mode="audio", chunk=5, soundfonts=kits)
    k_inputs, _ = with_kits(torch.Generator().manual_seed(7), base, base)
    drawn = [kits[i] for i in np.random.default_rng(0).integers(0, 2, 12)]  # seed=0's draw
    want = mso_batch_from_hvo(kept.numpy(), drawn, qpms, device="cpu", device_synth=True)
    np.testing.assert_allclose(k_inputs.numpy(), want, atol=1e-6)
    assert kit in drawn and np.abs(k_inputs.numpy() - inputs.numpy()).max() > 1e-3

    cfg = GrooveTransformerConfig(d_model=32, n_heads=2, dim_feedforward=64, dropout=0.0,
                                  num_encoder_layers=2, embedding_size_src=16)
    state = create_train_state(cfg, "sgd", 0.05, device="cpu")
    epoch = make_epoch_fn(PENALTY, 4, 12, augment=augment)
    gen = torch.Generator().manual_seed(0)
    losses = [float(epoch(state, base, base, gen)["loss"]) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < 0.9 * losses[0], losses


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*_training.yaml"))))
def test_config_matches_jax(path, monkeypatch):
    """HyperParams and derive_model_config field for field. The switches are
    mapped: the JAX package resolves them for the TPU, the port for one
    card (fused_layer by the Hopper gate, no fused FFN yet). Every YAML in
    the repo is encoder-only; the test below covers ``encoder_only: 0``."""
    monkeypatch.setenv("TGI_HBM_BYTES", str(16 * 1024**3))
    want_hp = jax_config.load_hyperparameters(path)
    got_hp = load_hyperparameters(path)
    assert got_hp.to_dict() == want_hp.to_dict()
    assert got_hp.extra == want_hp.extra
    want = jax_config.derive_model_config(want_hp, compute_dtype=jnp.float32)
    got = derive_model_config(got_hp, compute_dtype=torch.float32, device="cpu")
    switches = {"compute_dtype", "use_pallas_attention", "use_fused_attention", "fused_layer",
                "fused_ffn", "fused_decoder_layer"}
    for field in dataclasses.fields(got):
        if field.name not in switches:
            assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert got.compute_dtype == torch.float32 and not got.fused_ffn
    assert got.fused_layer == (port_config.supports_fused_layer(
        got.d_model, got.n_heads, got.dim_feedforward, 32, torch.float32)
        and got_hp.batch_size <= port_config.LAYER_KERNEL_MAX_BATCH[torch.float32])
    assert got.encoder_only and not got.fused_decoder_layer  # every YAML here is encoder-only


def test_config_of_an_encoder_decoder_yaml_matches_jax(monkeypatch):
    """``encoder_only: 0`` over the flagship YAML's hyperparameters:
    ``fused_decoder_layer`` by the decoder kernels' own gate, every other
    field as the JAX package's ``derive_model_config``."""
    monkeypatch.setenv("TGI_HBM_BYTES", str(16 * 1024**3))
    path = os.path.join(REPO, "configs", "InfillingRandom_training.yaml")
    want_hp = jax_config.load_hyperparameters(path)
    want_hp.encoder_only = 0
    hp = HyperParams.from_dict({**want_hp.to_dict(), "encoder_only": 0})
    want = jax_config.derive_model_config(want_hp, compute_dtype=jnp.float32)
    got = derive_model_config(hp, compute_dtype=torch.float32, device="cpu")
    switches = {"compute_dtype", "use_pallas_attention", "use_fused_attention", "fused_layer",
                "fused_ffn", "fused_decoder_layer"}
    for field in dataclasses.fields(got):
        if field.name not in switches:
            assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert got.num_decoder_layers == got.num_encoder_layers == 6 and not got.encoder_only
    assert got.fused_decoder_layer == port_config.supports_fused_decoder_layer(
        got.d_model, got.n_heads, got.dim_feedforward, 32, torch.float32) is True
    assert got.fused_layer is True and not got.fused_ffn
    # forced values are kept; several devices switch the auto policy off
    assert port_config.resolve_fused_decoder_layer(False, 256, 2, 512) is False
    assert port_config.resolve_fused_decoder_layer(True, 30, 2, 64) is True
    assert port_config.resolve_fused_decoder_layer(None, 256, 2, 512, n_devices=4) is False
    assert port_config.resolve_fused_decoder_layer(None, 30, 2, 64) is False
    hp.encoder_only = 1
    assert derive_model_config(hp, torch.float32, device="cpu").fused_decoder_layer is False


def test_config_resolution(monkeypatch):
    assert port_config.resolve_compute_dtype(None, "cpu") == torch.float32
    with monkeypatch.context() as m:  # the policy for a card, decided without one
        m.setattr(torch.cuda, "is_available", lambda: True)
        assert port_config.resolve_compute_dtype(None, "cuda") == torch.bfloat16
        assert port_config.resolve_compute_dtype(None) == torch.bfloat16
        assert port_config.resolve_compute_dtype(False, "cuda") == torch.float32
    assert port_config.resolve_fused_layer(None, 256, 2, 512, batch_size=32) is True
    assert port_config.resolve_fused_layer(None, 256, 2, 512, n_devices=4, batch_size=32) is False
    assert port_config.resolve_fused_layer(True, 30, 2, 64) is True  # forced, kept
    assert port_config.resolve_fused_ffn(None, 2048, 256, device="cpu") is False
    assert port_config.resolve_fused_ffn(True, 2048, 256, device="cpu") is True
    kw = dict(d_model=1024, n_heads=16, dim_feedforward=4096, n_layers=12, batch_size=128,
              hbm_bytes=16 * 1024**3, n_data_shards=1)
    for dtype in (torch.bfloat16, torch.float32):
        jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        for batch in (128, 4096):
            assert port_config.resolve_remat(None, **dict(kw, batch_size=batch),
                                             compute_dtype=dtype) == \
                jax_config.resolve_remat(None, **dict(kw, batch_size=batch), compute_dtype=jdtype)


@pytest.mark.parametrize("resolve", ["resolve_fused_layer", "resolve_fused_decoder_layer"])
def test_layer_resolvers_turn_auto_on_only_at_a_measured_batch(resolve):
    """Auto is gated by measurement, as the JAX package's, per dtype: the
    whole-layer chains beat the unfused path by more than the spread between
    turns at batch 32 and at 512, the two batches measured on the card, in
    bf16 and in f32 (split TF32; paired turns, PERF.md §5), so auto is on at
    <= 512 in both, off above and off when no batch is given; a forced value
    is kept at any batch; the JAX positional signature (switch, d_model,
    n_heads, dim_feedforward, n_devices) is still accepted. Past d 256 auto
    follows ``LAYER_KERNEL_MAX_D`` and the measured head width and ff."""
    r = getattr(port_config, resolve)
    assert port_config.LAYER_KERNEL_MAX_BATCH == {torch.bfloat16: 512, torch.float32: 512}
    bf16 = {"compute_dtype": torch.bfloat16}
    assert r(None, 256, 2, 512, batch_size=32, **bf16) is True
    assert r(None, 256, 2, 512, batch_size=16, **bf16) is True
    assert r(None, 256, 2, 512, batch_size=512, **bf16) is True
    assert r(None, 256, 2, 512, batch_size=513, **bf16) is False
    assert r(None, 256, 2, 512, batch_size=1024, **bf16) is False
    assert r(None, 256, 2, 512, **bf16) is False
    assert r(None, 256, 2, 512, batch_size=32) is True  # f32
    assert r(None, 256, 2, 512, batch_size=16) is True
    assert r(None, 256, 2, 512, batch_size=512) is True
    assert r(None, 256, 2, 512, batch_size=513) is False
    assert r(None, 256, 2, 512) is False
    assert r(None, 256, 2, 512, 1) is False
    assert r(True, 256, 2, 512, batch_size=1024) is True
    assert r(True, 256, 2, 512, 1) is True
    assert r(False, 256, 2, 512, batch_size=32) is False
    assert r(None, 30, 2, 64, batch_size=32) is False  # the gate still decides
    assert r(None, 30, 2, 64, batch_size=32, **bf16) is False
    # past d 256 the wide route, measured at d 512 with heads of 128 and ff
    # 1,024: on in bf16 up to d 512 at that head width and ff up to 1,024,
    # off in f32 (its worst pair did not clear the spread); forced, it is kept
    assert port_config.LAYER_KERNEL_MAX_D == {torch.bfloat16: 512, torch.float32: 256}
    assert (port_config.LAYER_KERNEL_WIDE_HEAD_DIM, port_config.LAYER_KERNEL_WIDE_MAX_FF) == \
        (128, 1024)
    assert r(None, 512, 4, 1024, batch_size=32, **bf16) is True
    assert r(None, 512, 4, 512, batch_size=512, **bf16) is True
    assert r(None, 384, 3, 768, batch_size=32, **bf16) is True
    assert r(None, 512, 1, 512, batch_size=512, **bf16) is False  # one head of 512
    assert r(None, 512, 8, 1024, batch_size=32, **bf16) is False  # heads of 64
    assert r(None, 512, 4, 2048, batch_size=32, **bf16) is False  # ff past 1,024
    assert r(True, 512, 1, 512, batch_size=512, **bf16) is True
    assert r(None, 520, 4, 1024, batch_size=32, **bf16) is False
    assert r(None, 1024, 8, 4096, batch_size=128, **bf16) is False  # GrooveXL
    assert r(True, 1024, 8, 4096, batch_size=128, **bf16) is True
    assert r(None, 512, 4, 1024, batch_size=32) is False  # f32
    assert r(True, 512, 4, 1024, batch_size=32) is True
    hp = HyperParams(d_model=256, n_heads=2, dim_feedforward=512, num_encoder_decoder_layers=2,
                     encoder_only=0)
    for dtype, batch, on in ((torch.float32, 32, True), (torch.float32, 512, True),
                             (torch.float32, 1024, False), (torch.bfloat16, 512, True),
                             (torch.bfloat16, 1024, False)):
        hp.batch_size = batch
        cfg = derive_model_config(hp, compute_dtype=dtype, device="cpu")
        assert cfg.fused_layer is on and cfg.fused_decoder_layer is on, (dtype, batch)


@pytest.mark.parametrize("resolve", ["resolve_fused_layer", "resolve_fused_decoder_layer"])
def test_layer_resolvers_turn_auto_on_only_at_a_measured_length(resolve):
    """Past T 32 the chains' attention takes its long route, whose paired
    turns were taken at one point, T 128 (8-bar loops), batch 32, the
    flagship width, in both dtypes and families, each beyond its spread
    (PERF.md §5): auto is on there only, off at every other length past 32,
    at a larger batch and at other widths, where a forced switch is kept up
    to the gate's 256; up to T 32 the other rules decide."""
    r = getattr(port_config, resolve)
    assert (port_config.LAYER_KERNEL_LONG_T, port_config.LAYER_KERNEL_LONG_MAX_BATCH,
            port_config.LAYER_KERNEL_LONG_WIDTH) == (128, 32, (256, 2, 512))
    for dtype in (torch.bfloat16, torch.float32):
        for t, on in ((16, True), (32, True), (33, False), (64, False), (127, False),
                      (128, True), (129, False), (256, False)):
            assert r(None, 256, 2, 512, compute_dtype=dtype, seq_len=t, batch_size=32) is on, t
        assert r(None, 256, 2, 512, compute_dtype=dtype, seq_len=128, batch_size=8) is True
        for t in (64, 128, 256):
            assert r(True, 256, 2, 512, compute_dtype=dtype, seq_len=t, batch_size=512) is True
        for batch in (33, 512, 1024, None):
            assert r(None, 256, 2, 512, compute_dtype=dtype, seq_len=128,
                     batch_size=batch) is False, batch
        for d, heads, ff in ((512, 4, 1024), (128, 2, 256), (256, 4, 512), (256, 2, 1024)):
            assert r(None, d, heads, ff, compute_dtype=dtype, seq_len=128,
                     batch_size=32) is False, (d, heads, ff)
            assert r(None, d, heads, ff, compute_dtype=dtype, seq_len=32,
                     batch_size=32) is (d <= 256 or dtype == torch.bfloat16), (d, heads, ff)
        # a data rank's share of a dp-only plan is the batch that counts
        assert r(None, 256, 2, 512, 4, dtype, 128, batch_size=128, dp_shard_ok=True) is True
        assert r(None, 256, 2, 512, 4, dtype, 128, batch_size=256, dp_shard_ok=True) is False
    params = {"model": {**FLAGSHIP, "dropout": 0.1, "max_len": 256,
                        "num_decoder_layers": 2 if "decoder" in resolve else 0},
              "training": {"batch_size": 32}, "load_model": None}
    cfg = initialize_model(params, "cpu")[0].config
    assert not cfg.fused_layer and not cfg.fused_decoder_layer  # T 256: not measured
    params["model"]["max_len"] = 128
    cfg = initialize_model(params, "cpu")[0].config
    assert cfg.fused_layer and cfg.fused_decoder_layer == ("decoder" in resolve)


@pytest.mark.parametrize("decoder", [False, True])
def test_f32_layer_gate_and_auto_stop_at_the_measured_ff(decoder):
    """The f32 chains' LayerNorm-epilogue products cannot promote their sums
    over ff: on the card they hold the 1e-5 bar at ff 1,024 and not at 2,048
    (ROADMAP §C11). So in f32 the gate, and auto with it, stops at
    ``F32_MAX_FF`` = 1,024, bf16 does not, and a forced switch above the cap
    raises in the model."""
    from transformergrooveinfilling_tpu_torch.ops import fused_layer
    from transformergrooveinfilling_tpu_torch.ops.fused_decoder_layer import (
        supports_fused_decoder_layer,
    )

    assert fused_layer.F32_MAX_FF == 1024
    gate = supports_fused_decoder_layer if decoder else fused_layer.supports_fused_layer
    resolve = (port_config.resolve_fused_decoder_layer if decoder
               else port_config.resolve_fused_layer)
    f32, bf16 = torch.float32, torch.bfloat16
    assert gate(256, 2, 1024, 32, f32) and gate(256, 2, 1024, 32, bf16)
    for ff in (1032, 2048, 4096, 8192):
        assert not gate(256, 2, ff, 32, f32) and gate(256, 2, ff, 32, bf16)
    assert resolve(None, 256, 2, 1024, batch_size=32, compute_dtype=f32) is True
    assert resolve(None, 256, 2, 2048, batch_size=32, compute_dtype=f32) is False
    assert resolve(None, 256, 2, 2048, batch_size=32, compute_dtype=bf16) is True
    assert resolve(True, 256, 2, 2048, batch_size=32, compute_dtype=f32) is True  # kept
    hp = HyperParams(d_model=32, n_heads=4, dim_feedforward=2048, num_encoder_decoder_layers=1,
                     encoder_only=0 if decoder else 1, batch_size=32)
    cfg = derive_model_config(hp, compute_dtype=f32, device="cpu")
    assert not cfg.fused_layer and not cfg.fused_decoder_layer
    switch = "fused_decoder_layer" if decoder else "fused_layer"
    forced = dataclasses.replace(cfg, dim_feedforward=1032, num_decoder_layers=int(decoder),
                                 **{switch: True})
    model = build_model(forced, "cpu").train()
    with pytest.raises(ValueError, match=f"{switch}=True, but the fused"):
        model(torch.zeros(2, 32, 16), generator=torch.Generator().manual_seed(0))


def test_initialize_model_resolves_the_layer_switches_unlike_the_reference():
    """The reference's ``initialize_model`` passes only ``fused_ffn`` and
    ``remat`` and leaves ``fused_layer`` and ``fused_decoder_layer`` off; the
    port resolves both by the training batch (``train/driver.py``), so that a
    caller of the reference contract gets the kernels where they are faster."""
    from transformergrooveinfilling_tpu.train import driver as jax_driver

    model = {"d_model": 32, "n_heads": 2, "dim_feedforward": 64, "dropout": 0.1,
             "num_encoder_layers": 1, "num_decoder_layers": 1}
    jax_bundle = jax_driver.initialize_model({"model": model, "training": {"batch_size": 16}})[0]
    assert not jax_bundle.config.fused_layer and not jax_bundle.config.fused_decoder_layer
    for batch, on in ((16, True), (32, True), (512, True), (1024, False)):  # f32 on the CPU
        cfg = initialize_model({"model": model, "training": {"batch_size": batch}}, "cpu")[0].config
        assert cfg.fused_layer is on and cfg.fused_decoder_layer is on, batch
    forced = dict(model, fused_layer=True, fused_decoder_layer=True)
    cfg = initialize_model({"model": forced, "training": {"batch_size": 1024}}, "cpu")[0].config
    assert cfg.fused_layer and cfg.fused_decoder_layer
    cfg = initialize_model({"model": model}, "cpu")[0].config  # the reference's default batch, 16
    assert cfg.fused_layer and cfg.fused_decoder_layer


def test_device_hbm_bytes(monkeypatch):
    monkeypatch.setenv("TGI_HBM_BYTES", "2e9")
    assert port_config.device_hbm_bytes("cpu") == 2_000_000_000
    monkeypatch.setenv("TGI_HBM_BYTES", "nonsense")
    with pytest.warns(UserWarning):
        assert port_config.device_hbm_bytes("cpu") == 16 * 1024**3


# ---------------------------------------------------------------- contract


class _Data:
    def __init__(self, inputs, outputs):
        self.processed_inputs, self.processed_outputs = inputs, outputs


def _grids(rng, n):
    """synthetic.py-style symbolic infilling: hats on an eighth-note pattern,
    kicks on beats, snare backbeats; the input is the grid with the hats
    removed."""
    y = np.zeros((n, 32, 27), np.float32)
    y[:, ::4, 2] = rng.random((n, 8)) < 0.92
    y[:, ::8, 0] = rng.random((n, 4)) < 0.8
    y[:, 8::16, 1] = 1
    y[:, :, 9:18] = y[:, :, :9] * rng.uniform(0.4, 1.0, (n, 32, 9))
    y[:, :, 18:] = y[:, :, :9] * rng.uniform(-0.25, 0.25, (n, 32, 9))
    x = y.copy()
    x[:, :, [2, 11, 20]] = 0
    return x, y


def test_initialize_model_and_train_loop(rng, tmp_path):
    params = {"model": {"d_model": 32, "n_heads": 2, "dim_feedforward": 64, "dropout": 0.1,
                        "num_encoder_layers": 2, "embedding_size_src": 27,
                        "optimizer": "sgd"},
              "training": {"learning_rate": 0.05, "batch_size": 16, "seed": 0},
              "load_model": None}
    bundle, opt, epoch0 = initialize_model(params, "cpu")
    assert epoch0 == 0 and opt is bundle.state.optimizer and bundle.config.fused_layer
    x, y = _grids(rng, 72)
    vx, vy = _grids(rng, 16)
    losses = []
    for ep in range(6):
        m = train_loop(_Data(x, y), bundle, epoch=ep, hit_loss_penalty=PENALTY,
                       batch_size=16, test_inputs=vx, test_gt=vy,
                       validation_inputs=vx, validation_gt=vy)
        losses.append(m["loss"])
    want_keys = {"grad_norm", "loss", "hit_accuracy", "hit_perplexity", "bce_hits",
                 "mse_velocities", "mse_offsets"}
    want_keys |= {f"{s}_{k}" for s in ("test", "validation") for k in _LOSS_KEYS}
    assert set(m) == want_keys and all(np.isfinite(v) for v in m.values())
    assert losses[-1] < 0.8 * losses[0], losses
    assert bundle.state.step == 6 * 5
    h, v, o = bundle.predict(vx)
    assert h.shape == (16, 32, 9) and set(np.unique(h)) <= {0.0, 1.0}
    # save=True writes the epoch's checkpoint; load_model resumes from it
    m = train_loop(_Data(x, y), bundle, epoch=6, hit_loss_penalty=PENALTY, batch_size=16,
                   save=True, ckpt_dir=str(tmp_path), run_id="t")
    assert os.listdir(tmp_path) == ["transformer_run_t_Epoch_6.ckpt"]
    resumed, _opt, epoch = initialize_model(
        dict(params, load_model={"location": "local", "dir": str(tmp_path)}), "cpu")
    assert epoch == 7
    for name, p in bundle.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], p), name


def test_initialize_model_at_max_len_128_trains_like_jax():
    """8-bar loops: ``initialize_model`` at ``max_len`` 128 (fused_layer given:
    its twin on the CPU, the chains past T 32 on the card) and the JAX
    package's at the same weights train 3 SGD steps on a ``max_seq_len`` 128
    synthetic dataset (the audio experiment's MSO inputs) to within 5e-5 of
    each other; the served answer of the trained weights at T 128 (the port's
    ``InfillServer``, #1 on the card) matches the JAX bundle's ``predict``."""
    from transformergrooveinfilling_tpu.train.driver import initialize_model as jax_initialize
    from transformergrooveinfilling_tpu_torch.data.datasets import (
        GrooveMidiDatasetInfillingRandom,
    )
    from transformergrooveinfilling_tpu_torch.data.synthetic import synthetic_gmd_sequences
    from transformergrooveinfilling_tpu_torch.serve import InfillServer

    t, batch = 128, 4
    ds = GrooveMidiDatasetInfillingRandom(data=synthetic_gmd_sequences(12, seed=0, t=t),
                                          max_seq_len=t, seed=0, device="cpu", save=False,
                                          max_aug_items=1)
    assert ds.processed_inputs.shape == (12, t, 16) and ds.processed_outputs.shape == (12, t, 27)
    params = {"model": {**{k: v for k, v in FLAGSHIP.items() if k != "num_encoder_layers"},
                        "num_encoder_layers": 2, "dropout": 0.0, "max_len": t,
                        "optimizer": "sgd", "fused_layer": True},
              "training": {"learning_rate": LR, "batch_size": batch, "seed": 0},
              "load_model": None}
    jax_bundle, _, _ = jax_initialize(params)
    bundle, _, _ = initialize_model(params, "cpu")
    assert bundle.config.max_len == jax_bundle.config.max_len == t and bundle.config.fused_layer
    bundle.model.load_state_dict(state_dict_from_flax_params(
        jax.tree.map(np.asarray, jax_bundle.state.params), bundle.config), strict=True)
    jax_step = jax.jit(jax_loop.make_train_step(jax_bundle.model, jax_bundle.tx, PENALTY))
    step, gen = make_train_step(PENALTY), torch.Generator().manual_seed(0)
    jax_state, w = jax_bundle.state, np.ones(batch, np.float32)
    for i in range(3):
        x, y = (a[batch * i:batch * (i + 1)] for a in (ds.processed_inputs, ds.processed_outputs))
        jax_state, want = jax_step(jax_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                                   jax.random.PRNGKey(i))
        got = step(bundle.state, torch.from_numpy(x), torch.from_numpy(y),
                   torch.from_numpy(w), gen)
        for k in got:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    _assert_params_close(bundle.state, jax_state, bundle.config)
    jax_bundle.state = jax_state
    srv = InfillServer(bundle.model.state_dict(), bundle.config, batch_sizes=(1, 8),
                       device="cpu")
    x = ds.processed_inputs[:3]
    got, want = srv.infill(x), np.concatenate(jax_bundle.predict(x), axis=-1)
    assert got.shape == (3, t, 27)
    np.testing.assert_allclose(got[..., 9:], want[..., 9:], atol=1e-5)
    assert np.mean(got[..., :9] == want[..., :9]) > 0.999


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """No training entry point or helper carries on on the CPU unless asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("TGI_HBM_BYTES", raising=False)
    params = {"model": {"d_model": 32, "n_heads": 2, "dim_feedforward": 64, "dropout": 0.1,
                        "num_encoder_layers": 1}, "training": {}}
    cfg = GrooveTransformerConfig(num_encoder_layers=1)
    kw = dict(d_model=32, n_heads=2, dim_feedforward=64, n_layers=1, batch_size=8)
    for call in (lambda: initialize_model(params),
                 lambda: create_train_state(cfg, "sgd", 0.1),
                 lambda: derive_model_config(HyperParams()),
                 lambda: port_config.resolve_compute_dtype(None),
                 lambda: port_config.device_hbm_bytes(),
                 lambda: port_config.resolve_remat(None, **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asked for the CPU, each runs there
    assert initialize_model(params, "cpu")[0].device.type == "cpu"
    assert create_train_state(cfg, "sgd", 0.1, device="cpu").step == 0
    assert derive_model_config(HyperParams(), device="cpu").compute_dtype == torch.float32
    assert port_config.resolve_remat(None, **kw, device="cpu") is False


def test_unported_training_switches_raise(rng):
    """The switches that used to refuse (remat, fused_ffn, fused_dropout_ln)
    now run a training forward and backward; a forced switch whose kernel does
    not take the shape raises ``ValueError`` and never gives way quietly."""
    base = GrooveTransformerConfig(num_encoder_layers=1, dropout=0.3)
    x = torch.from_numpy(rng.standard_normal((2, 32, 16)).astype(np.float32))
    for switch in (dict(remat=True), dict(fused_ffn=True), dict(fused_dropout_ln=True),
                   dict(remat=True, fused_ffn=True, fused_dropout_ln=True)):
        model = build_model(dataclasses.replace(base, **switch), "cpu").train()
        out = model(x, torch.Generator())
        sum(o.sum() for o in out).backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in model.parameters()), switch
    for switch, match in ((dict(fused_ffn=True, dim_feedforward=18), "fused_ffn=True"),
                          (dict(fused_ffn=True, compute_dtype=torch.float16), "fused_ffn=True"),
                          (dict(fused_dropout_ln=True, d_model=34, n_heads=2),
                           "fused_dropout_ln=True")):
        model = build_model(dataclasses.replace(base, **switch), "cpu").train()
        with pytest.raises(ValueError, match=match):
            model(x, torch.Generator())
    # fused_dropout_ln at rate 0 is the plain path, as in the JAX package
    model = build_model(dataclasses.replace(base, dropout=0.0, fused_dropout_ln=True), "cpu")
    model.train()(x, torch.Generator())
    with pytest.raises(ValueError, match="Generator"):
        model(x)


def test_chip_smoke_flagship_hyperparameters_equal_the_yaml():
    import chip_smoke

    hp = HyperParams.from_dict(chip_smoke.FLAGSHIP_HP)
    want = load_hyperparameters(os.path.join(REPO, "configs", "InfillingRandom_training.yaml"))
    assert hp.to_dict() == want.to_dict()
