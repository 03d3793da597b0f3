"""The port's encoder-decoder family against the JAX package on the CPU, on
shared weights and inputs: the eval forward (with and without a target, plain
and through the attention kernel's plain version with its causal mask), a few
SGD steps with teacher forcing (the fused layers' JAX side runs its Pallas
kernels in interpret mode at dropout 0), the held-out loss, the state-dict key
map both ways, the initialisation, serving, and the reference contract
``initialize_model`` + ``train_loop(encoder_only=0)``."""

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu.models import build_model as jax_build_model
from transformergrooveinfilling_tpu.models import predict as jax_predict
from transformergrooveinfilling_tpu.models import torch_compat as jax_torch_compat
from transformergrooveinfilling_tpu.models.transformer import (
    GrooveTransformerConfig as JaxConfig,
)
from transformergrooveinfilling_tpu.train import loop as jax_loop
from transformergrooveinfilling_tpu_torch.models import (
    GrooveTransformer, GrooveTransformerConfig, GrooveTransformerEncoder, build_model, predict,
)
from transformergrooveinfilling_tpu_torch.models.torch_compat import (
    STORED_PE_KEYS, load_legacy_checkpoint, state_dict_from_flax_params,
)
from transformergrooveinfilling_tpu_torch.ops import attention
from transformergrooveinfilling_tpu_torch.serve import InfillServer
from transformergrooveinfilling_tpu_torch.train import (
    TrainState, initialize_model, make_epoch_fn, make_eval_loss_fn, make_optimizer,
    make_train_step, train_loop,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(d_model=32, n_heads=4, dim_feedforward=64, num_encoder_layers=2,
             num_decoder_layers=2, embedding_size_src=16)
# the smallest width the JAX kernels' gate takes (128 lanes; 128-row tiles: B 4 × T 32)
KERNEL_WIDTH = dict(d_model=128, n_heads=2, dim_feedforward=128, num_encoder_layers=1,
                    num_decoder_layers=1, embedding_size_src=16)
LR, PENALTY = 0.089, 0.73  # scripts/bench_encdec.py


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small eager ops on all cores stall when test workers share the host's
    cores; two threads each keep this module's runtime near its solo time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def configs(arch=SMALL, **kw):
    """The same architecture as a JAX config and as the port's config."""
    return (JaxConfig(dropout=0.0, **arch, **kw), GrooveTransformerConfig(dropout=0.0, **arch, **kw))


def jax_params(cfg, seed=0, perturb=0.1):
    """Flax init, then every leaf (zero biases and unit LN scales included)
    perturbed, so a mis-mapped bias or LN parameter cannot hide."""
    shape = (1, cfg.max_len)
    params = jax_build_model(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros(shape + (cfg.embedding_size_src,)),
        jnp.zeros(shape + (cfg.embedding_size_tgt,)), deterministic=True)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + perturb * rng.standard_normal(a.shape).astype(np.float32),
        params)


def port_model(port_cfg, params):
    model = build_model(port_cfg, "cpu")
    model.load_state_dict(state_dict_from_flax_params(params, port_cfg), strict=True)
    return model


def hvo_targets(rng, n, voices=9, t=32):
    h = (rng.random((n, t, voices)) < 0.3).astype(np.float32)
    return np.concatenate([h, h * rng.random(h.shape), h * (rng.random(h.shape) - 0.5)],
                          axis=-1).astype(np.float32)


# ---------------------------------------------------------------- the model


def test_build_model_returns_either_family_and_defaults_to_cuda(monkeypatch):
    enc = build_model(GrooveTransformerConfig(num_encoder_layers=1), "cpu")
    dec = build_model(GrooveTransformerConfig(num_encoder_layers=1, num_decoder_layers=6), "cpu")
    assert type(enc) is GrooveTransformerEncoder and type(dec) is GrooveTransformer
    assert not dec.training and len(dec.Decoder["Decoder"]["layers"]) == 6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (enc.config, dec.config):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(cfg)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_tgt", [True, False])
def test_forward_matches_jax(rng, with_tgt, use_kernel):
    """Eval forward at f32. ``use_kernel``: the JAX model runs its Pallas
    attention in interpret mode (causal mask in the kernel), the port
    ``fused_mha``'s plain version ``mha_reference(causal=True)``."""
    jax_cfg, port_cfg = configs()
    jax_cfg = dataclasses.replace(jax_cfg, use_pallas_attention=use_kernel)
    port_cfg = dataclasses.replace(port_cfg, use_fused_attention=use_kernel)
    params = jax_params(jax_cfg)
    x = rng.standard_normal((3, 32, 16)).astype(np.float32)
    tgt = hvo_targets(rng, 3) if with_tgt else None
    args = (jnp.asarray(x),) + ((jnp.asarray(tgt),) if with_tgt else ())
    want = jax_build_model(jax_cfg).apply({"params": params}, *args, deterministic=True)
    model = port_model(port_cfg, params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(tgt) if with_tgt else None)
    for name, w, g in zip(("h_logits", "v", "o"), want, got):
        assert g.shape == (3, 32, 9), name
        # f32 forward bar of the JAX package's own serving tests
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5, err_msg=name)


def test_no_target_is_a_zero_target_and_the_decoder_is_causal(rng):
    _, port_cfg = configs()
    model = port_model(port_cfg, jax_params(configs()[0], seed=3))
    x = torch.from_numpy(rng.standard_normal((2, 32, 16)).astype(np.float32))
    tgt = torch.from_numpy(hvo_targets(rng, 2))
    with torch.inference_mode():
        none, zeros, base = model(x), model(x, torch.zeros(2, 32, 27)), model(x, tgt)
        later = tgt.clone()
        later[:, 20] += 1.0  # target row 20 feeds decoder row 21 (shifted right)
        moved = (model(x, later)[0] - base[0]).abs().amax(-1)
    for a, b in zip(none, zeros):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(moved[:, :21].max()) == 0 and float(moved[:, 21:].min()) > 0


def test_predict_matches_jax(rng):
    jax_cfg, port_cfg = configs()
    params = jax_params(jax_cfg, seed=2)
    x = rng.standard_normal((4, 32, 16)).astype(np.float32)
    want = jax_predict(jax_build_model(jax_cfg), params, jnp.asarray(x))
    got = predict(port_model(port_cfg, params), torch.from_numpy(x))
    logits = np.asarray(jax_build_model(jax_cfg).apply(
        {"params": params}, jnp.asarray(x), deterministic=True)[0])
    sure = np.abs(1 / (1 + np.exp(-logits)) - 0.5) > 1e-4
    assert sure.mean() > 0.99
    np.testing.assert_array_equal(got[0].numpy()[sure], np.asarray(want[0])[sure])
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5)


def test_bf16_compute_matches_jax_bf16(rng):
    jax_cfg, port_cfg = configs()
    jax_cfg = dataclasses.replace(jax_cfg, compute_dtype=jnp.bfloat16)
    port_cfg = dataclasses.replace(port_cfg, compute_dtype=torch.bfloat16)
    params = jax_params(jax_cfg, seed=3)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    tgt = hvo_targets(rng, 2)
    want = jax_build_model(jax_cfg).apply({"params": params}, jnp.asarray(x), jnp.asarray(tgt),
                                          deterministic=True)
    with torch.inference_mode():
        got = port_model(port_cfg, params)(torch.from_numpy(x), torch.from_numpy(tgt))
    for name, w, g in zip(("h_logits", "v", "o"), want, got):
        assert g.dtype == torch.float32, name  # heads run in f32
        # four 2-layer bf16 stacks (8-bit mantissas) whose products may round
        # in another order: a few bf16 ulps of the O(1) activations
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=8e-2, err_msg=name)


def test_serving_attention_is_18_kernel_calls_a_forward(rng, monkeypatch):
    """With ``use_fused_attention`` every layer's attention goes through
    ``fused_mha``: 6 encoder, 6 causal decoder self-, 6 decoder cross-."""
    cfg = GrooveTransformerConfig(d_model=32, n_heads=2, dim_feedforward=64,
                                  num_encoder_layers=6, num_decoder_layers=6,
                                  use_fused_attention=True)
    calls = []
    real = attention.fused_mha

    def counting(q, k, v, causal=False):
        calls.append(causal)
        return real(q, k, v, causal)

    monkeypatch.setattr(attention, "fused_mha", counting)
    from transformergrooveinfilling_tpu_torch.models import transformer

    monkeypatch.setattr(transformer, "fused_mha", counting)
    model = build_model(cfg, "cpu")
    with torch.inference_mode():
        model(torch.from_numpy(rng.standard_normal((2, 32, 16)).astype(np.float32)))
    assert calls == [False] * 6 + [True, False] * 6


# ---------------------------------------------------------------- weights


def test_state_dict_round_trip_both_ways():
    """The port's key map equals the JAX package's ``params_to_state_dict``
    (the cross-attention's q and packed kv as ``multihead_attn.in_proj`` rows
    [q; k; v]) and ``state_dict_to_params`` inverts it, within 1e-6."""
    jax_cfg, port_cfg = configs()
    params = jax_params(jax_cfg, seed=5)
    want = {k: v for k, v in jax_torch_compat.params_to_state_dict(params, jax_cfg).items()
            if k not in STORED_PE_KEYS}
    sd = state_dict_from_flax_params(params, port_cfg)
    assert sd.keys() == want.keys()
    assert build_model(port_cfg, "cpu").state_dict().keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    d = port_cfg.d_model
    ca = params["decoder_layer_1"]["cross_attn"]
    packed = sd["Decoder.Decoder.layers.1.multihead_attn.in_proj_weight"].numpy()
    assert packed.shape == (3 * d, d)
    np.testing.assert_array_equal(packed[:d], ca["q"]["kernel"].T)
    np.testing.assert_array_equal(packed[d:], ca["kv"]["kernel"].T)
    back = jax_torch_compat.state_dict_to_params({k: v.numpy() for k, v in sd.items()}, jax_cfg)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_back)
    for path, leaf in flat_want:
        np.testing.assert_allclose(np.asarray(flat_back[path]), leaf, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_legacy_checkpoint_of_the_family_loads_strictly(tmp_path, rng):
    """A ``.Model`` file as the JAX package writes the family's state dict
    (both stored PE buffers included) loads into the port's model."""
    jax_cfg, port_cfg = configs()
    params = jax_params(jax_cfg, seed=6)
    sd = jax_torch_compat.params_to_state_dict(params, jax_cfg)
    path = str(tmp_path / "transformer_run_x_Epoch_3.Model")
    torch.save({"epoch": 3, "loss": 0.5, "optimizer_state_dict": {},
                "model_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
               path)
    loaded, epoch, loss = load_legacy_checkpoint(path, port_cfg)
    assert (epoch, loss) == (3, 0.5) and not set(STORED_PE_KEYS) & set(loaded)
    model = build_model(port_cfg, "cpu")
    model.load_state_dict(loaded, strict=True)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    want = jax_build_model(jax_cfg).apply({"params": params}, jnp.asarray(x), deterministic=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5)
    with pytest.raises(ValueError, match="encoder-decoder"):
        load_legacy_checkpoint(path, dataclasses.replace(port_cfg, num_decoder_layers=0))
    demo = os.path.join(REPO, "demo", "transformer_run_demo_Epoch_799.Model")
    with pytest.raises(ValueError, match="encoder-only"):
        load_legacy_checkpoint(demo, port_cfg)


def test_init_matches_flax_init_for_the_decoder():
    """Zero biases, unit LN scales (norm3 too), and every weight, the packed
    cross projection included, a truncated lecun_normal at fan_in d."""
    arch = dict(d_model=128, n_heads=2, dim_feedforward=256, num_encoder_layers=1,
                num_decoder_layers=2, embedding_size_src=16)
    params = jax_build_model(JaxConfig(**arch)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 16)), jnp.zeros((1, 32, 27)),
        deterministic=True)["params"]
    cfg = GrooveTransformerConfig(**arch)
    want = state_dict_from_flax_params(jax.tree.map(np.asarray, params), cfg)
    got = build_model(cfg, "cpu").state_dict()
    assert got.keys() == want.keys()
    seen = set()
    for name, w in got.items():
        if not name.startswith(("Decoder.", "InputLayerDecoder.")):
            continue
        seen.add(name.split(".")[-2] if "layers" in name else name)
        if name.endswith("bias"):
            assert torch.count_nonzero(w) == 0, name
        elif w.dim() == 1:  # LayerNorm scale
            assert torch.equal(w, torch.ones_like(w)), name
        else:
            fan_in = w.shape[1]
            sigma = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert float(w.abs().max()) <= 2 * sigma, name
            tol = 0.03 if w.numel() >= 128 * 128 else 0.06  # (128, 27): fewer draws
            assert abs(float(w.std()) / float(want[name].std()) - 1) < tol, name
    assert {"multihead_attn", "norm3"} <= seen
    a = build_model(cfg, "cpu", torch.Generator().manual_seed(4)).state_dict()
    b = build_model(cfg, "cpu", torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------- training


def _both(arch, fused: bool):
    """JAX and port encoder-decoder models, dropout 0, f32, on the same
    weights, each with an SGD state."""
    kw = dict(fused_layer=fused, fused_decoder_layer=fused)
    jax_cfg, port_cfg = configs(arch, **kw)
    model = jax_build_model(jax_cfg)
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 16)), jnp.zeros((1, 32, 27)),
                        deterministic=True)["params"]
    port = port_model(port_cfg, jax.tree.map(np.asarray, params))
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
    """3 SGD steps with teacher forcing. ``fused``: both JAX layer kernels in
    interpret mode against the port's twins (4 × 32 rows: one JAX tile)."""
    model, tx, jax_state, port_cfg, state = _both(KERNEL_WIDTH if fused else SMALL, fused)
    jax_step = jax.jit(jax_loop.make_train_step(model, tx, PENALTY, encoder_only=False))
    step = make_train_step(PENALTY, encoder_only=False)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        x = rng.standard_normal((4, 32, 16)).astype(np.float32)
        y = hvo_targets(rng, 4)
        w = np.ones(4, np.float32)
        jax_state, want = jax_step(jax_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                                   jax.random.PRNGKey(i))
        got = step(state, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w), gen)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    assert state.step == 3
    _assert_params_close(state, jax_state, port_cfg)
    # the decoder's memory gradient reached the encoder: its weights moved
    enc = "Encoder.Encoder.layers.0.linear1.weight"
    fresh = _both(KERNEL_WIDTH if fused else SMALL, fused)[4].model.state_dict()[enc]
    assert float((state.model.state_dict()[enc] - fresh).abs().max()) > 1e-6


def test_encoder_only_step_over_the_family_decodes_zeros_as_jax_does(rng):
    """``encoder_only=True`` over an encoder-decoder model passes no target in
    either package: the decoder reads zeros, and the step still trains."""
    model, tx, jax_state, port_cfg, state = _both(SMALL, False)
    x = rng.standard_normal((4, 32, 16)).astype(np.float32)
    y = hvo_targets(rng, 4)
    jax_state, want = jax.jit(jax_loop.make_train_step(model, tx, PENALTY))(
        jax_state, jnp.asarray(x), jnp.asarray(y), jnp.ones(4), jax.random.PRNGKey(0))
    got = make_train_step(PENALTY)(state, torch.from_numpy(x), torch.from_numpy(y), None,
                                   torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=2e-4)
    _assert_params_close(state, jax_state, port_cfg)


def test_epoch_with_a_partial_batch_and_eval_loss_match_jax(rng):
    model, tx, jax_state, port_cfg, state = _both(SMALL, False)
    inputs = rng.standard_normal((20, 32, 16)).astype(np.float32)
    outputs = hvo_targets(rng, 20)
    jax_epoch = jax_loop.make_epoch_fn(model, tx, PENALTY, 8, 20, donate=False, shuffle=False,
                                       encoder_only=False)
    jax_state, want = jax_epoch(jax_state, jnp.asarray(inputs), jnp.asarray(outputs),
                                jax.random.PRNGKey(0))
    epoch = make_epoch_fn(PENALTY, 8, 20, shuffle=False, encoder_only=False)
    got = epoch(state, torch.from_numpy(inputs), torch.from_numpy(outputs),
                torch.Generator().manual_seed(0))
    assert got.keys() == want.keys() and state.step == 3
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-4, err_msg=k)
    _assert_params_close(state, jax_state, port_cfg)

    want_eval = jax_loop.make_eval_loss_fn(model, PENALTY, encoder_only=False)(
        jax_state.params, jnp.asarray(inputs), jnp.asarray(outputs))
    got_eval = make_eval_loss_fn(PENALTY, encoder_only=False)(
        state.model, torch.from_numpy(inputs), torch.from_numpy(outputs))
    assert got_eval.keys() == want_eval.keys()
    for k in got_eval:
        np.testing.assert_allclose(float(got_eval[k]), float(want_eval[k]), rtol=2e-4, err_msg=k)
    # teacher forcing matters: without the target the held-out loss differs
    blind = make_eval_loss_fn(PENALTY)(state.model, torch.from_numpy(inputs),
                                       torch.from_numpy(outputs))
    assert abs(float(blind["loss"]) - float(got_eval["loss"])) > 1e-4


def test_fused_training_draws_one_seed_per_layer_and_is_seeded(rng):
    """At dropout 0.30 the fused path (the twins on the CPU) is deterministic
    per generator seed, differs between seeds, and moves every parameter."""
    cfg = GrooveTransformerConfig(d_model=32, n_heads=2, dim_feedforward=64, dropout=0.3,
                                  num_encoder_layers=2, num_decoder_layers=2,
                                  fused_layer=True, fused_decoder_layer=True)
    x = torch.from_numpy(rng.standard_normal((4, 32, 16)).astype(np.float32))
    y = torch.from_numpy(hvo_targets(rng, 4))
    outs = []
    for seed in (0, 0, 1):
        model = build_model(cfg, "cpu").train()
        out = model(x, y, torch.Generator().manual_seed(seed))
        outs.append(out[0].detach())
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    sum(o.sum() for o in out).backward()
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0 for p in model.parameters())


def test_unported_switches_raise_in_decoder_layers_too(rng):
    """The switches that used to refuse now run in decoder layers too (the
    encoder layer here takes its whole-layer path); a forced switch whose
    kernel does not take the shape raises ``ValueError``."""
    base = GrooveTransformerConfig(num_encoder_layers=1, num_decoder_layers=1, dropout=0.3,
                                   fused_layer=True)
    x = torch.from_numpy(rng.standard_normal((2, 32, 16)).astype(np.float32))
    for switch in (dict(fused_ffn=True), dict(fused_dropout_ln=True), dict(remat=True),
                   dict(fused_ffn=True, fused_dropout_ln=True, remat=True)):
        model = build_model(dataclasses.replace(base, **switch), "cpu").train()
        out = model(x, None, torch.Generator())
        sum(o.sum() for o in out).backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in model.parameters()), switch
    for switch, match in ((dict(fused_ffn=True, dim_feedforward=18), "fused_ffn=True"),
                          (dict(fused_dropout_ln=True, d_model=34, n_heads=2),
                           "fused_dropout_ln=True")):
        model = build_model(dataclasses.replace(base, fused_layer=False, **switch), "cpu").train()
        with pytest.raises(ValueError, match=match):
            model(x, None, torch.Generator())
    with pytest.raises(ValueError, match="Generator"):
        build_model(base, "cpu").train()(x)


# ---------------------------------------------------------------- contract


class _Data:
    def __init__(self, inputs, outputs):
        self.processed_inputs, self.processed_outputs = inputs, outputs


def _grids(rng, n):
    """Symbolic infilling: hats on an eighth-note pattern, kicks on beats,
    snare backbeats; the input is the grid with the hats removed."""
    y = np.zeros((n, 32, 27), np.float32)
    y[:, ::4, 2] = rng.random((n, 8)) < 0.92
    y[:, ::8, 0] = rng.random((n, 4)) < 0.8
    y[:, 8::16, 1] = 1
    y[:, :, 9:18] = y[:, :, :9] * rng.uniform(0.4, 1.0, (n, 32, 9))
    y[:, :, 18:] = y[:, :, :9] * rng.uniform(-0.25, 0.25, (n, 32, 9))
    x = y.copy()
    x[:, :, [2, 11, 20]] = 0
    return x, y


def test_initialize_model_and_train_loop_encoder_decoder(rng):
    params = {"model": {"d_model": 32, "n_heads": 2, "dim_feedforward": 64, "dropout": 0.1,
                        "num_encoder_layers": 2, "num_decoder_layers": 2,
                        "embedding_size_src": 27, "optimizer": "sgd"},
              "training": {"learning_rate": 0.05, "batch_size": 16, "seed": 0},
              "load_model": None}
    bundle, opt, epoch0 = initialize_model(params, "cpu")
    assert epoch0 == 0 and type(bundle.model) is GrooveTransformer
    assert bundle.config.fused_layer and bundle.config.fused_decoder_layer
    off = initialize_model({**params, "model": {**params["model"],
                                                "fused_decoder_layer": False}}, "cpu")[0]
    assert off.config.fused_layer and not off.config.fused_decoder_layer
    x, y = _grids(rng, 72)
    vx, vy = _grids(rng, 16)
    losses = []
    for ep in range(6):
        m = train_loop(_Data(x, y), bundle, encoder_only=0, epoch=ep, hit_loss_penalty=PENALTY,
                       batch_size=16, validation_inputs=vx, validation_gt=vy)
        losses.append(m["loss"])
    assert all(np.isfinite(v) for v in m.values()) and "validation_loss" in m
    assert losses[-1] < 0.8 * losses[0], losses
    assert bundle.state.step == 6 * 5
    h, v, o = bundle.predict(vx)
    assert h.shape == (16, 32, 9) and set(np.unique(h)) <= {0.0, 1.0}


# ---------------------------------------------------------------- serving


def test_infill_server_over_an_encoder_decoder_config_equals_jax_predict(rng):
    jax_cfg, port_cfg = configs()
    params = jax_params(jax_cfg, seed=7)
    server = InfillServer(state_dict_from_flax_params(params, port_cfg), port_cfg,
                          batch_sizes=(1, 4), device="cpu")
    assert type(server.model) is GrooveTransformer
    x = rng.standard_normal((6, 32, 16)).astype(np.float32)  # two chunks of bucket 4
    got = server.infill(x)
    h, v, o = jax_predict(jax_build_model(jax_cfg), params, jnp.asarray(x))
    logits = np.asarray(jax_build_model(jax_cfg).apply(
        {"params": params}, jnp.asarray(x), deterministic=True)[0])
    sure = np.abs(1 / (1 + np.exp(-logits)) - 0.5) > 1e-4
    assert got.shape == (6, 32, 27)
    np.testing.assert_array_equal(got[..., :9][sure], np.asarray(h)[sure])
    np.testing.assert_allclose(got[..., 9:18], np.asarray(v), atol=3e-5)
    np.testing.assert_allclose(got[..., 18:], np.asarray(o), atol=3e-5)
    # an audio-width encoder-decoder server answers hvo_input through the front end
    grid = hvo_targets(rng, 1)[0]
    out = server.infill_from_hvo(grid, qpm=100.0)
    assert out.shape == (32, 27) and np.isfinite(out).all()
    np.testing.assert_array_equal(out, server.infill(server._front_end(grid[None], 100.0))[0])


def test_importing_the_family_leaves_jax_out():
    code = (
        "import sys\n"
        "import torch\n"
        "from transformergrooveinfilling_tpu_torch.models import build_model, "
        "GrooveTransformerConfig\n"
        "import transformergrooveinfilling_tpu_torch.ops.fused_decoder_layer\n"
        "import transformergrooveinfilling_tpu_torch.train\n"
        "import transformergrooveinfilling_tpu_torch.serve\n"
        "m = build_model(GrooveTransformerConfig(num_encoder_layers=1, num_decoder_layers=1), "
        "'cpu')\n"
        "m(torch.zeros(1, 32, 16))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'triton', "
        "'transformergrooveinfilling_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
