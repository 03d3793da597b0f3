"""Batched sweeps on the port (``train/vmap_sweep.py``) against the JAX
package's ``train/vmap_sweep.py``, on the CPU at d 32, 2 heads, ff 64, 2
layers (2 + 2 for the encoder-decoder), K = 3 trials: ``adam_update``; the
whole sweep from JAX's ``init_stacked_params`` (carried across by
``utils/param_layout.py``), SGD and Adam, both families; ``stacked_eval_loss``
through the vmap rule of ``tgi::fused_mha``; that rule alone; per-trial
dropout rates as data; the kernel switches and ``remat`` a batched group
trains through (remat alone: ``tests/test_torch_vmap_remat.py``); and that
the new modules import no JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu.models import build_model as jax_build_model
from transformergrooveinfilling_tpu.models.transformer import (
    GrooveTransformerConfig as JaxConfig,
)
from transformergrooveinfilling_tpu.train import vmap_sweep as jax_sweep
from transformergrooveinfilling_tpu_torch.models import GrooveTransformerConfig, build_model
from transformergrooveinfilling_tpu_torch.ops import attention
from transformergrooveinfilling_tpu_torch.ops.dropout import (
    fast_dropout_as_data, quantized_keep_rate,
)
from transformergrooveinfilling_tpu_torch.train import vmap_sweep
from transformergrooveinfilling_tpu_torch.utils.param_layout import (
    stacked_flax_params_from_state_dict, stacked_state_dict_from_flax_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 3
ARCH = dict(d_model=32, n_heads=2, dim_feedforward=64, num_encoder_layers=2,
            embedding_size_src=27)
FAMILIES = {"encoder_only": 0, "encoder_decoder": 2}
SGD_BAR = 5e-5  # the 3-step SGD bar
FORWARD_BAR = 2e-5  # the f32 forward bar


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def grids(seed: int, n: int):
    """Seeded HVO targets and their inputs (three voices masked)."""
    rng = np.random.default_rng(seed)
    h = (rng.random((n, 32, 9)) < 0.3).astype(np.float32)
    y = np.concatenate([h, h * rng.random(h.shape), h * (rng.random(h.shape) - 0.5)],
                       axis=-1).astype(np.float32)
    x = y.copy()
    x[:, :, [2, 11, 20]] = 0
    return x, y


def configs(n_dec: int, **switches):
    arch = dict(ARCH, num_decoder_layers=n_dec, dropout=0.0)
    return JaxConfig(**arch), GrooveTransformerConfig(**arch, **switches)


def leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def test_adam_update_matches_jax():
    """Five steps of the data-lr adam rule under vmap, per-trial lrs, on seeded
    trees: the port's against JAX's, atol 1e-6."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (3,)}
    params = {k: rng.standard_normal((K, *s)).astype(np.float32) for k, s in shapes.items()}
    lrs = np.asarray([0.07, 0.0, 1e-3], np.float32)
    j_params = jax.tree.map(jnp.asarray, params)
    j_opt = (jax.tree.map(jnp.zeros_like, j_params), jax.tree.map(jnp.zeros_like, j_params),
             jnp.zeros((K,), jnp.float32))
    p_params = {k: torch.from_numpy(v) for k, v in params.items()}
    p_opt = vmap_sweep.init_stacked_opt(p_params, "adam")
    j_step = jax.vmap(jax_sweep.adam_update)
    p_step = torch.func.vmap(vmap_sweep.adam_update)
    for _ in range(5):
        grads = {k: rng.standard_normal((K, *s)).astype(np.float32) for k, s in shapes.items()}
        j_params, j_opt = j_step(j_params, j_opt, jax.tree.map(jnp.asarray, grads),
                                 jnp.asarray(lrs))
        p_params, p_opt = p_step(p_params, p_opt,
                                 {k: torch.from_numpy(v) for k, v in grads.items()},
                                 torch.from_numpy(lrs))
        for k in shapes:
            np.testing.assert_allclose(p_params[k].numpy(), np.asarray(j_params[k]),
                                       atol=1e-6, rtol=0)
    np.testing.assert_array_equal(p_opt[2].numpy(), np.full(K, 5.0, np.float32))


def key_bias_rows(path, d: int):
    """The entries of a qkv or kv bias that add to the keys: softmax is blind
    to them, so their gradient is 0 in exact arithmetic and what each package
    computes there is rounding noise."""
    names = [getattr(p, "key", None) for p in path]
    if names[-1] != "bias" or names[-2] not in ("qkv", "kv"):
        return None
    return slice(d, 2 * d) if names[-2] == "qkv" else slice(0, d)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("family", FAMILIES)
def test_sweep_matches_jax(family, optimizer):
    """JAX's ``init_stacked_params`` carried into the port, then 3 epochs of
    both packages' ``make_batched_sweep_fn`` at rate 0 with ``n_samples ==
    batch_size`` (the shuffle cannot matter) and lrs that include 0: final
    parameters and last-batch losses within 5e-5, the lr-0 trial's weights bit
    for bit its initial ones.

    Adam normalises each gradient by its own size, so on the key-bias entries,
    whose gradient is rounding noise (:func:`key_bias_rows`), each package
    takes steps of up to lr in the noise's direction: there the two are held
    to stay within 3 steps of lr of their initial value, and every other entry
    to the bar."""
    n_dec = FAMILIES[family]
    jax_cfg, cfg = configs(n_dec)
    model = jax_build_model(jax_cfg)
    stacked = jax.tree.map(np.asarray, jax_sweep.init_stacked_params(
        model, jax_cfg, K, jax.random.PRNGKey(0)))
    x, y = grids(0, 8)
    lrs = np.asarray([0.0, 0.05, 0.1] if optimizer == "sgd" else [0.0, 1e-3, 3e-3], np.float32)
    pens = np.asarray([0.5, 0.3, 1.0], np.float32)
    rates = np.zeros(K, np.float32)
    fn = jax_sweep.make_batched_sweep_fn(model, 8, 8, 3, encoder_only=not n_dec,
                                         config=jax_cfg, rates_as_data=False,
                                         optimizer=optimizer)
    j_params, j_losses = fn(stacked, jax_sweep.init_stacked_opt(stacked, optimizer),
                            jnp.asarray(lrs), jnp.asarray(pens), jnp.asarray(rates),
                            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))

    init = stacked_state_dict_from_flax_params(stacked, cfg)
    port = build_model(cfg, "cpu")
    assert sorted(init) == sorted(port.state_dict())
    p_fn = vmap_sweep.make_batched_sweep_fn(port, 8, 8, 3, encoder_only=not n_dec,
                                            config=cfg, rates_as_data=False,
                                            optimizer=optimizer)
    p_params, p_losses = p_fn(init, vmap_sweep.init_stacked_opt(init, optimizer),
                              torch.from_numpy(lrs), torch.from_numpy(pens),
                              torch.from_numpy(rates), torch.from_numpy(x),
                              torch.from_numpy(y), torch.Generator().manual_seed(1))

    np.testing.assert_allclose(p_losses.numpy(), np.asarray(j_losses), atol=SGD_BAR, rtol=0)
    got = leaves(stacked_flax_params_from_state_dict(p_params, cfg))
    want, first = leaves(jax.tree.map(np.asarray, j_params)), leaves(stacked)
    assert got.keys() == want.keys()
    for path, a in got.items():
        b, a0 = want[path], first[path]
        rows = key_bias_rows(path, cfg.d_model) if optimizer == "adam" else None
        if rows is None:
            np.testing.assert_allclose(a, b, atol=SGD_BAR, rtol=0, err_msg=str(path))
        else:
            rest = np.ones(a.shape[-1], bool)
            rest[rows] = False
            np.testing.assert_allclose(a[..., rest], b[..., rest], atol=SGD_BAR, rtol=0)
            for moved in (a, b):
                bound = 3 * lrs[:, None] * 1.001 + 1e-7
                assert (np.abs(moved[..., rows] - a0[..., rows]) <= bound).all(), path
        np.testing.assert_array_equal(a[0], a0[0], err_msg=f"lr 0 trial moved: {path}")


@pytest.mark.parametrize("family", FAMILIES)
def test_stacked_eval_loss_matches_jax_through_the_vmap_rule(family, monkeypatch):
    """``stacked_eval_loss`` with ``use_fused_attention=True`` against JAX's
    within the forward bar: every attention of the vmapped forward reaches
    ``tgi::fused_mha`` once for all K trials, folded to (K·N, H, T, hd), and
    gives what ``use_fused_attention=False`` gives."""
    n_dec = FAMILIES[family]
    jax_cfg, cfg = configs(n_dec, use_fused_attention=True)
    _, plain_cfg = configs(n_dec)
    model = jax_build_model(jax_cfg)
    stacked = jax.tree.map(np.asarray, jax_sweep.init_stacked_params(
        model, jax_cfg, K, jax.random.PRNGKey(2)))
    n = 6
    x, y = grids(1, n)
    pens = np.asarray([0.3, 0.6, 1.0], np.float32)
    want = np.asarray(jax_sweep.stacked_eval_loss(model, stacked, x, y, pens,
                                                  encoder_only=not n_dec))
    params = stacked_state_dict_from_flax_params(stacked, cfg)
    folded = []
    real = attention.fused_mha

    def counted(q, k, v, causal=False):
        folded.append((tuple(q.shape), causal))
        return real(q, k, v, causal)

    monkeypatch.setattr(attention, "fused_mha", counted)
    got = vmap_sweep.stacked_eval_loss(build_model(cfg, "cpu"), params, x, y, pens,
                                       encoder_only=not n_dec, device="cpu")
    monkeypatch.undo()
    layers = ARCH["num_encoder_layers"] + 2 * n_dec
    assert folded == ([((K * n, 2, 32, 16), False)] * ARCH["num_encoder_layers"]
                      + [((K * n, 2, 32, 16), c) for _ in range(n_dec) for c in (True, False)])
    assert len(folded) == layers
    np.testing.assert_allclose(got.numpy(), want, atol=FORWARD_BAR, rtol=0)
    plain = vmap_sweep.stacked_eval_loss(build_model(plain_cfg, "cpu"), params, x, y, pens,
                                         encoder_only=not n_dec, device="cpu")
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("form", ["packed_qkv", "trial_axis_last", "shared_kv"])
@pytest.mark.parametrize("causal", [False, True])
def test_vmap_rule_alone_matches_the_plain_version_per_trial(form, causal):
    """``tgi::fused_mha`` under ``torch.func.vmap`` against ``mha_reference``
    trial by trial: the slices of a vmapped packed projection (the fold is a
    view), a trial axis that is not the first (the fold copies), and k, v
    without a trial axis (expanded)."""
    rng = np.random.default_rng(5)
    b, h, t, hd = 4, 2, 32, 8

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    if form == "packed_qkv":
        packed = normal(K, b, t, 3 * h * hd)

        def attend(p):
            q, k, v = p.view(b, t, 3, h, hd).permute(2, 0, 3, 1, 4)
            return attention.fused_mha_op(q, k, v, causal)

        got = torch.func.vmap(attend)(packed)
        want = [attention.mha_reference(*packed[i].view(b, t, 3, h, hd).permute(2, 0, 3, 1, 4),
                                        causal=causal) for i in range(K)]
    elif form == "trial_axis_last":
        q, k, v = normal(b, h, t, hd, K), normal(b, h, t, hd, K), normal(b, h, t, hd, K)
        got = torch.func.vmap(lambda *a: attention.fused_mha_op(*a, causal),
                              in_dims=4)(q, k, v)
        want = [attention.mha_reference(q[..., i], k[..., i], v[..., i], causal)
                for i in range(K)]
    else:
        q, k, v = normal(K, b, h, t, hd), normal(b, h, t, hd), normal(b, h, t, hd)
        got = torch.func.vmap(lambda a: attention.fused_mha_op(a, k, v, causal))(q)
        want = [attention.mha_reference(q[i], k, v, causal) for i in range(K)]
    assert got.shape == (K, b, h, t, hd)
    for i in range(K):
        np.testing.assert_allclose(got[i].numpy(), want[i].numpy(), atol=1e-6, rtol=0)


RATES = [0.0, 0.2, 0.5]


def test_rates_as_data_keep_the_quantized_rate():
    """Each trial's 8-bit mask keeps ``quantized_keep_rate(r)`` of a large
    tensor within 5σ; rate 0 keeps every element exactly."""
    n = 1 << 20
    ones = torch.ones(n)
    gen = torch.Generator().manual_seed(0)
    out = torch.func.vmap(lambda r: fast_dropout_as_data(ones, gen, r),
                          randomness="different")(torch.tensor(RATES))
    for r, row in zip(RATES, out):
        keep = quantized_keep_rate(r)
        kept = row != 0
        sigma = (keep * (1 - keep) / n) ** 0.5
        assert abs(float(kept.float().mean()) - keep) <= 5 * sigma + 1e-12
        np.testing.assert_array_equal(row[kept].numpy(), np.float32(1 / keep))


def sweep_run(lrs, rates, n: int = 10, batch: int = 4, epochs: int = 2, family="encoder_only"):
    _, cfg = configs(FAMILIES[family])
    x, y = grids(2, n)
    return vmap_sweep.batched_sweep(build_model(cfg, "cpu"), cfg, x, y, lrs,
                                    [0.5] * len(lrs), epochs=epochs, batch_size=batch,
                                    seed=4, rates=rates, device="cpu")


@pytest.mark.parametrize("family", FAMILIES)
def test_non_uniform_rates(family):
    """Rates [0, 0.2, 0.5] with one lr, ``n_samples`` not a multiple of the
    batch: the same seed gives the same run, the trials diverge, the rate-0
    trial equals the same trial of a uniform-rate-0 run and the same trial
    run alone (within 1e-6)."""
    lrs = [0.05] * K
    params, losses = sweep_run(lrs, RATES, family=family)
    again, losses_again = sweep_run(lrs, RATES, family=family)
    for key in params:
        np.testing.assert_array_equal(params[key].numpy(), again[key].numpy())
    np.testing.assert_array_equal(losses.numpy(), losses_again.numpy())
    assert len(set(np.round(losses.numpy(), 6))) == K
    w = params["OutputLayer.Linear.weight"]
    assert not torch.allclose(w[1], w[2]) and not torch.allclose(w[0], w[1])
    uniform, uniform_losses = sweep_run(lrs, [0.0] * K, family=family)
    alone, alone_losses = sweep_run(lrs[:1], RATES[:1], family=family)
    for key in params:
        np.testing.assert_allclose(params[key][0].numpy(), uniform[key][0].numpy(), atol=1e-6)
        np.testing.assert_allclose(params[key][0].numpy(), alone[key][0].numpy(), atol=1e-6)
    np.testing.assert_allclose(losses[0].item(), uniform_losses[0].item(), atol=1e-6)
    np.testing.assert_allclose(losses[0].item(), alone_losses[0].item(), atol=1e-6)


@pytest.mark.parametrize("switch", ["fused_layer", "fused_decoder_layer", "fused_ffn",
                                    "fused_dropout_ln", "remat"])
def test_forced_switches_train(switch, monkeypatch):
    """A kernel switch given on trains a group of the encoder-decoder family
    at rate 0.3 through its kernel's path (on the CPU the twin or the
    operators' plain bodies), and ``remat`` given on through the recompute
    that runs under ``torch.func`` (``models/transformer.py::_LayerRemat``):
    finite losses, distinct trials, and the path's entry called."""
    from transformergrooveinfilling_tpu_torch.models import transformer

    wrapper = {"fused_layer": "encoder_layer_train", "fused_decoder_layer": "decoder_layer_train",
               "fused_ffn": "ffn_train", "fused_dropout_ln": "dropout_add_layernorm",
               "remat": "_remat_transformed"}[switch]
    called = []
    real = getattr(transformer, wrapper)
    monkeypatch.setattr(transformer, wrapper, lambda *a: called.append(1) or real(*a))
    _, cfg = configs(2, **{switch: True})
    cfg = dataclasses.replace(cfg, dropout=0.3)
    x, y = grids(0, 4)
    params, losses = vmap_sweep.batched_sweep(build_model(cfg, "cpu"), cfg, x, y, [0.1, 0.2],
                                              [0.5, 0.5], epochs=1, batch_size=4, device="cpu")
    assert called and torch.isfinite(losses).all() and losses[0] != losses[1]
    assert not torch.equal(params["OutputLayer.Linear.weight"][0],
                           params["OutputLayer.Linear.weight"][1])


@pytest.mark.parametrize("switch", ["fused_layer", "fused_ffn"])
def test_forced_switch_with_rates_that_differ_raises(switch):
    """Rates that differ ride the vmap as data, which the kernels do not
    take: a forced switch raises, naming itself."""
    _, cfg = configs(0, **{switch: True})
    x, y = grids(0, 4)
    with pytest.raises(ValueError, match=switch):
        vmap_sweep.batched_sweep(build_model(cfg, "cpu"), cfg, x, y, [0.1, 0.2], [0.5, 0.5],
                                 rates=[0.1, 0.2], epochs=1, batch_size=4, device="cpu")


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import transformergrooveinfilling_tpu_torch.sweep\n"
        "import transformergrooveinfilling_tpu_torch.train.vmap_sweep\n"
        "import transformergrooveinfilling_tpu_torch.utils.param_layout\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'transformergrooveinfilling_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
