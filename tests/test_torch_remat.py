"""Slice 5 of the port as a whole, on the CPU: training with ``fused_ffn``
against the JAX model with the same switch (its Pallas kernel in interpret
mode, dropout 0), in both model families; layer rematerialisation against the
un-rematerialised step at dropout > 0; the switches' configuration."""

import dataclasses
import os

import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu.models import build_model as jax_build_model
from transformergrooveinfilling_tpu.models.transformer import (
    GrooveTransformerConfig as JaxConfig,
)
from transformergrooveinfilling_tpu.train import config as jax_config
from transformergrooveinfilling_tpu.train import loop as jax_loop
from transformergrooveinfilling_tpu_torch.models import (
    GrooveTransformerConfig, build_model, calculate_loss, transformer,
)
from transformergrooveinfilling_tpu_torch.models.torch_compat import (
    state_dict_from_flax_params,
)
from transformergrooveinfilling_tpu_torch.train import (
    HyperParams, TrainState, derive_model_config, initialize_model, load_hyperparameters,
    make_optimizer, make_train_step, train_loop,
)
from transformergrooveinfilling_tpu_torch.train import config as port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, PENALTY = 0.07, 0.46  # configs/InfillingRandomLow_lm_training.yaml
# the JAX fused FFN asks for d and ff in multiples of 128
ARCH = dict(d_model=128, n_heads=2, dim_feedforward=256, embedding_size_src=16)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def hvo_targets(rng, n):
    h = (rng.random((n, 32, 9)) < 0.3).astype(np.float32)
    return np.concatenate([h, h * rng.random(h.shape), h * (rng.random(h.shape) - 0.5)],
                          axis=-1).astype(np.float32)


# ---------------------------------------------------------------- against JAX


@pytest.mark.parametrize("n_enc, n_dec", [(2, 0), (1, 1)], ids=["encoder_only", "encoder_decoder"])
def test_three_sgd_steps_with_fused_ffn_match_jax(rng, n_enc, n_dec):
    """Both packages run their fused FFN (JAX: the Pallas kernel in interpret
    mode; the port: its plain version and the Function's backward formulas)
    on the same weights and batches: metrics and weights after 3 SGD steps."""
    arch = dict(ARCH, num_encoder_layers=n_enc, num_decoder_layers=n_dec)
    model = jax_build_model(JaxConfig(dropout=0.0, fused_ffn=True, **arch))
    init = [jnp.zeros((1, 32, 16))] + ([jnp.zeros((1, 32, 27))] if n_dec else [])
    params = model.init(jax.random.PRNGKey(1), *init, deterministic=True)["params"]
    cfg = GrooveTransformerConfig(dropout=0.0, fused_ffn=True, **arch)
    port = build_model(cfg, "cpu")
    port.load_state_dict(state_dict_from_flax_params(jax.tree.map(np.asarray, params), cfg),
                         strict=True)
    tx = optax.sgd(LR)
    jax_state = jax_loop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                    opt_state=tx.init(params))
    state = TrainState(step=0, model=port, optimizer=make_optimizer("sgd", LR, port.parameters()))
    jax_step = jax.jit(jax_loop.make_train_step(model, tx, PENALTY, encoder_only=not n_dec))
    step = make_train_step(PENALTY, encoder_only=not n_dec)
    gen = torch.Generator().manual_seed(0)
    calls = []
    real = transformer.ffn_train
    transformer.ffn_train = lambda *a: calls.append(1) or real(*a)
    try:
        for i in range(3):
            x = rng.standard_normal((8, 32, 16)).astype(np.float32)
            y = hvo_targets(rng, 8)
            jax_state, want = jax_step(jax_state, jnp.asarray(x), jnp.asarray(y),
                                       jnp.ones(8), jax.random.PRNGKey(i))
            got = step(state, torch.from_numpy(x), torch.from_numpy(y), None, gen)
            for k in got:
                np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-4, atol=1e-6,
                                           err_msg=f"step {i} {k}")
    finally:
        transformer.ffn_train = real
    assert len(calls) == 3 * (n_enc + n_dec)  # every layer's FFN took the fused path
    want = state_dict_from_flax_params(jax.tree.map(np.asarray, jax_state.params), cfg)
    for name, p in port.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=5e-5, err_msg=name)


# ---------------------------------------------------------------- remat


def step_grads(cfg, seed=3):
    """Gradients of one training step at ``cfg``, the generator's next draw
    after it, and how often each layer's forward ran."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 32, 16)).astype(np.float32))
    y = torch.from_numpy(hvo_targets(rng, 4))
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(1)).train()
    runs = []
    hooks = [m.register_forward_pre_hook(lambda *_: runs.append(1)) for m in model.modules()
             if isinstance(m, (transformer.EncoderLayer, transformer.DecoderLayer))]
    gen = torch.Generator().manual_seed(seed)
    pred = model(x, generator=gen) if cfg.encoder_only else model(x, y, gen)
    calculate_loss(pred, y, PENALTY).total_loss.backward()
    for h in hooks:
        h.remove()
    after = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
    return {k: p.grad.clone() for k, p in model.named_parameters()}, after, len(runs)


SWITCHES = {"unfused": {}, "fused_ffn": dict(fused_ffn=True),
            "fused_dropout_ln": dict(fused_dropout_ln=True),
            "all_three": dict(fused_ffn=True, fused_dropout_ln=True),
            "fused_layers": dict(fused_layer=True, fused_decoder_layer=True)}


@pytest.mark.parametrize("policy", [None, "nothing", "dots"])
@pytest.mark.parametrize("switches", list(SWITCHES))
@pytest.mark.parametrize("n_dec", [0, 1], ids=["encoder_only", "encoder_decoder"])
def test_remat_gradients_equal_the_plain_steps(n_dec, switches, policy):
    """At dropout 0.3 a recompute that drew new masks would give other
    gradients without any error: here they are equal bit for bit, the
    generator ends where it would have, and every layer's forward ran twice."""
    kw = dict(SWITCHES[switches])
    if not n_dec:
        kw.pop("fused_decoder_layer", None)
    cfg = GrooveTransformerConfig(d_model=32, n_heads=4, dim_feedforward=64, dropout=0.3,
                                  num_encoder_layers=2, num_decoder_layers=n_dec, **kw)
    plain, after, runs = step_grads(cfg)
    remat, after_r, runs_r = step_grads(dataclasses.replace(cfg, remat=True, remat_policy=policy))
    assert runs == 2 + n_dec and runs_r == 2 * runs
    assert after == after_r
    for name in plain:
        assert torch.equal(plain[name], remat[name]), name


def test_a_recompute_without_the_replay_would_differ():
    """The check above can fail: a plain ``checkpoint`` around the layer leaves
    the generator where the forward put it, the recompute draws other masks,
    and the gradients move without any error."""
    from torch.utils.checkpoint import checkpoint

    cfg = GrooveTransformerConfig(d_model=32, n_heads=4, dim_feedforward=64, dropout=0.3,
                                  num_encoder_layers=2, remat=True)
    plain, _, _ = step_grads(dataclasses.replace(cfg, remat=False))
    real = transformer._remat
    transformer._remat = lambda config, generator, layer, *tensors: checkpoint(
        lambda *a: layer(*a, generator), *tensors, use_reentrant=False)
    try:
        naive, _, _ = step_grads(cfg)
    finally:
        transformer._remat = real
    assert any(not torch.equal(plain[k], naive[k]) for k in plain)


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_keeps_the_dense_products():
    """``"dots"`` recomputes everything but the dense products: fewer mm and
    addmm calls in a step than with ``None``, more than without remat."""
    counts = {}
    for name, kw in (("off", {}), ("all", dict(remat=True)),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        cfg = GrooveTransformerConfig(d_model=32, n_heads=4, dim_feedforward=64, dropout=0.3,
                                      num_encoder_layers=2, **kw)
        with _CountProducts() as mode:
            step_grads(cfg)
        counts[name] = mode.n
    assert counts["off"] <= counts["dots"] < counts["all"], counts


def test_unknown_remat_policy_raises_and_eval_ignores_remat(rng):
    cfg = GrooveTransformerConfig(num_encoder_layers=1, dropout=0.3, remat=True,
                                  remat_policy="everything")
    x = torch.from_numpy(rng.standard_normal((2, 32, 16)).astype(np.float32))
    model = build_model(cfg, "cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        model.train()(x, torch.Generator())
    plain = build_model(dataclasses.replace(cfg, remat=False), "cpu")
    for a, b in zip(model.eval()(x), plain(x)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- switches


@pytest.mark.parametrize("n_dec", [0, 2])
def test_state_dict_is_the_same_with_every_switch_on(n_dec):
    """No switch changes a parameter's name, shape or initial value, so
    checkpoints carry across (JAX tests/test_fused_ffn.py says so for its
    parameter tree)."""
    base = GrooveTransformerConfig(d_model=32, n_heads=4, dim_feedforward=64,
                                   num_encoder_layers=2, num_decoder_layers=n_dec)
    on = dataclasses.replace(base, fused_ffn=True, fused_dropout_ln=True, remat=True,
                             remat_policy="dots")
    a, b = build_model(base, "cpu").state_dict(), build_model(on, "cpu").state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_fused_dropout_ln_draws_its_own_mask_per_site(rng):
    """With the switch on, a training forward at rate > 0 goes through
    ``dropout_add_layernorm`` twice a layer (three times in a decoder layer),
    each site with its own seed; at rate 0 it stays on the plain path."""
    x = torch.from_numpy(rng.standard_normal((2, 32, 16)).astype(np.float32))
    seeds = []
    real = transformer.dropout_add_layernorm
    transformer.dropout_add_layernorm = lambda *a: seeds.append(int(a[4])) or real(*a)
    try:
        for n_dec, rate, want in ((0, 0.3, 2), (1, 0.3, 5), (1, 0.0, 0)):
            cfg = GrooveTransformerConfig(d_model=32, n_heads=4, dim_feedforward=64, dropout=rate,
                                          num_encoder_layers=1, num_decoder_layers=n_dec,
                                          fused_dropout_ln=True)
            seeds.clear()
            model = build_model(cfg, "cpu").train()
            out = model(x, generator=torch.Generator().manual_seed(0))
            assert len(seeds) == len(set(seeds)) == want
            assert all(torch.isfinite(o).all() for o in out)
    finally:
        transformer.dropout_add_layernorm = real


def test_resolve_fused_ffn_auto_boundary(monkeypatch):
    """Auto is off everywhere, on the CPU and on a card, at every width, dtype,
    batch and remat setting: no setting measured on the card has shown the
    FFN kernels faster than ``fused_ffn=False`` by more than the spread
    between turns (PERF.md §5), in bf16, nor in f32 on the split-TF32
    launches (the lm config at batch 32 and 512 and GrooveXL under remat:
    worst pairs -5.8 %, -16.5 %, +4.1 % against spreads of 24.1 %, 12.7 %,
    9.9 %; the JAX package turns it on on a TPU at ff >= 2048 while the
    weights fit its resident kernel). A forced value is kept, also where the
    Hopper gate would reject the width (the model raises then). The
    signature is the JAX package's."""
    r = port_config.resolve_fused_ffn
    assert r(None, 4096, 1024, torch.bfloat16, "cpu") is False
    assert r(True, 64, 30, torch.float32, "cpu") is True
    assert r(False, 4096, 1024, torch.bfloat16, "cpu") is False
    with monkeypatch.context() as m:  # the policy for a card, decided without one
        m.setattr(torch.cuda, "is_available", lambda: True)
        # the f32 cells measured (lm config, GrooveXL) first
        for ff, d in ((2048, 256), (4096, 1024), (512, 256), (4096, 2048), (4100, 1024)):
            for dtype in (torch.float32, torch.bfloat16, None):
                assert r(None, ff, d, dtype) is False, (ff, d, dtype)
        assert r(True, 4096, 1024, torch.bfloat16) is True
        assert r(True, 4096, 1024, torch.float32) is True
        assert r(True, 4100, 1024, torch.bfloat16) is True  # the model's gate raises
        assert r(False, 2048, 256, torch.bfloat16) is False
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            r(None, 4096, 1024, torch.bfloat16)
    assert jax_config.resolve_fused_ffn(True, 64, 32) is True  # the same signature


def test_lm_config_resolves_to_the_fused_ffn_and_not_the_fused_layer(monkeypatch):
    """configs/InfillingRandomLow_lm_training.yaml on a card: the bf16
    whole-layer gate now admits ff 2048 (the chains of csrc/layer_sm90.cu),
    so auto takes the whole-layer kernels at the YAML's batch of 32 and at
    512, the batches where they were measured faster, and not at 1,024; the
    FFN kernels are taken when the config asks for them, and auto leaves them
    off at 32, 512 and 1,024, with and without remat; GrooveXL at batch 128
    on 80 GB needs no remat by the estimate. On the CPU (f32) the f32 chain's
    gate stops at ff 1,024 (``F32_MAX_FF``: its unpromoted sums drift past
    the chain's bar at 2,048 on the card, ROADMAP §C11), so auto takes the
    unfused path there."""
    hp = load_hyperparameters(os.path.join(REPO, "configs",
                                           "InfillingRandomLow_lm_training.yaml"))
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setenv("TGI_HBM_BYTES", str(80 * 1024**3))
        cfg = derive_model_config(hp, device="cuda")
        assert not cfg.fused_ffn and cfg.fused_layer and not cfg.remat
        assert (cfg.d_model, cfg.dim_feedforward, cfg.num_encoder_layers) == (256, 2048, 8)
        for batch in (512, 1024):
            for remat in (True, None):
                hp.batch_size, hp.remat = batch, remat
                got = derive_model_config(hp, device="cuda")
                assert not got.fused_ffn and got.fused_layer is (batch <= 512), (batch, remat)
        hp.fused_ffn, hp.batch_size = True, 32
        cfg = derive_model_config(hp, device="cuda")
        assert cfg.fused_ffn and cfg.fused_layer
        assert port_config.resolve_remat(
            None, d_model=1024, n_heads=8, dim_feedforward=4096, n_layers=12, batch_size=128,
            compute_dtype=torch.bfloat16, device="cuda") is False
    hp.fused_ffn = None
    cpu = derive_model_config(hp, device="cpu")
    # f32 on the CPU at batch 32: ff 2048 is past the f32 chain's cap, so auto
    # leaves the whole-layer path off though f32 auto is on up to batch 512
    assert not cpu.fused_ffn and not cpu.fused_layer


def test_chip_smoke_lm_hyperparameters_equal_the_yaml():
    import chip_smoke

    hp = HyperParams.from_dict(chip_smoke.LM_HP)
    want = load_hyperparameters(os.path.join(REPO, "configs",
                                             "InfillingRandomLow_lm_training.yaml"))
    assert hp.to_dict() == want.to_dict()


class _Data:
    def __init__(self, rng, n):
        self.processed_inputs = rng.standard_normal((n, 32, 16)).astype(np.float32)
        self.processed_outputs = hvo_targets(rng, n)


@pytest.mark.parametrize("n_dec", [0, 1], ids=["encoder_only", "encoder_decoder"])
def test_train_loop_with_all_three_switches(rng, n_dec):
    """``initialize_model`` + ``train_loop`` with fused_ffn, fused_dropout_ln
    and remat together, on the CPU through the plain versions: the loss is
    finite and falls."""
    params = {"model": dict(d_model=32, n_heads=4, dim_feedforward=64, dropout=0.1,
                            num_encoder_layers=2, num_decoder_layers=n_dec, fused_ffn=True,
                            fused_dropout_ln=True, remat=True, remat_policy="dots",
                            fused_layer=False, fused_decoder_layer=False),
              "training": {"learning_rate": 0.05, "batch_size": 8}}
    bundle, _, _ = initialize_model(params, "cpu")
    cfg = bundle.config
    assert cfg.fused_ffn and cfg.fused_dropout_ln and cfg.remat and cfg.remat_policy == "dots"
    data = _Data(rng, 32)
    losses = [train_loop(dataset=data, groove_transformer=bundle, epoch=e, batch_size=8,
                         encoder_only=int(not n_dec), hit_loss_penalty=PENALTY)["loss"]
              for e in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
