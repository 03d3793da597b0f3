"""The training kernels #2-#5 in a batched sweep, on the CPU: each kernel's
autograd Function (its forward and backward operators, whose bodies are the
plain versions on CPU tensors) under ``torch.func.vmap(grad_and_value(...))``
against unbatched calls with each trial's seed; the operators' vmap rules
calling the body once per trial; the masks at rate 0.3; and ``batched_sweep``
with each switch forced against the JAX package's ``batched_sweep`` with the
same switch forced (JAX runs #2-#4 in interpret mode at rate 0, its CPU gate,
and #5 on its unfused path, which is all it takes off a TPU). Sizes: d 128,
2 heads, ff 256, T 32, B 4, K 3, 2 layers (2 + 2 for the encoder-decoder)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vmap_sweep import SGD_BAR, grids, key_bias_rows, leaves
from torch_vmap_cases import KERNELS, assert_equal, calls, trials, unbatched, vmapped
from transformergrooveinfilling_tpu.models import build_model as jax_build_model
from transformergrooveinfilling_tpu.models.transformer import (
    GrooveTransformerConfig as JaxConfig,
)
from transformergrooveinfilling_tpu.train import vmap_sweep as jax_sweep
from transformergrooveinfilling_tpu_torch.models import GrooveTransformerConfig, build_model
from transformergrooveinfilling_tpu_torch.ops import (
    fused_decoder_layer as fdl, fused_ffn as ffn, fused_layer as fl, fused_ln as ln,
)
from transformergrooveinfilling_tpu_torch.ops.dropout import quantized_keep_rate
from transformergrooveinfilling_tpu_torch.train import vmap_sweep
from transformergrooveinfilling_tpu_torch.utils.param_layout import (
    stacked_flax_params_from_state_dict, stacked_state_dict_from_flax_params,
)

K, D, H, FF, T, B = 3, 128, 2, 256, 32, 4
ROWS = B * T
RATE = 0.3
BAR = 1e-6  # vmapped against unbatched (the plain bodies run the same sums)
ARCH = dict(d_model=D, n_heads=H, dim_feedforward=FF, num_encoder_layers=2,
            embedding_size_src=27)
# each kernel's plain bodies, forward and backward, in the module whose
# globals its operators read them from
BODIES = {"fused_layer": (fl, "forward_sm90", "_backward_flat"),
          "fused_decoder_layer": (fdl, "forward_sm90", "_backward_flat"),
          "fused_ffn": (ffn, "ffn_reference", "backward_formulas"),
          "fused_dropout_ln": (ln, "dropout_add_layernorm_reference", "backward_formulas")}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def counted_bodies(monkeypatch, kernel: str) -> dict:
    """Count the calls of ``kernel``'s two plain bodies."""
    module, fwd, bwd = BODIES[kernel]
    counts = {"forward": 0, "backward": 0}
    for key, name in (("forward", fwd), ("backward", bwd)):
        real = getattr(module, name)

        def counted(*a, _real=real, _key=key, **kw):
            counts[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    return counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", KERNELS)
def test_vmap_equals_unbatched_calls(monkeypatch, kernel, dtype):
    """``vmap(grad_and_value(...), randomness="different")`` over K trials at
    rate 0.3 through the kernel's Function: the output and every gradient
    within 1e-6 of K unbatched calls with each trial's seed, each operator's
    body called once per trial (the vmap rule's K launches on the card)."""
    call = calls(RATE, H, T)[kernel]
    args, dys, seeds = trials(kernel, K, 11, dtype, "cpu", d=D, ff=FF, rows=ROWS)
    want = unbatched(call, args, dys, seeds)
    counts = counted_bodies(monkeypatch, kernel)
    grads, outs = vmapped(call, args, dys, seeds)
    assert counts == {"forward": K, "backward": K}
    assert len(grads) == len(args[0])
    assert_equal(grads, outs, want, atol=BAR)


@pytest.mark.parametrize("kernel", ["fused_layer", "fused_decoder_layer"])
def test_vmap_equals_unbatched_calls_in_the_wide_route(monkeypatch, kernel):
    """At d 512 (4 heads, ff 1,024: the chains' wide route on the card) the
    layers' vmap rule still runs each trial's chain once: K unbatched calls'
    outputs and gradients within ``BAR``, each operator's body once a trial,
    f32, rate 0.3, B 2 × T 32 a trial."""
    call = calls(RATE, 4, T)[kernel]
    args, dys, seeds = trials(kernel, 2, 12, torch.float32, "cpu", d=512, ff=1024, rows=2 * T)
    want = unbatched(call, args, dys, seeds)
    counts = counted_bodies(monkeypatch, kernel)
    grads, outs = vmapped(call, args, dys, seeds)
    assert counts == {"forward": 2, "backward": 2}
    assert_equal(grads, outs, want, atol=BAR)


@pytest.mark.parametrize("kernel", ["fused_layer", "fused_decoder_layer"])
def test_vmap_equals_unbatched_calls_at_one_head_of_1024(monkeypatch, kernel):
    """At d 1,024 with one head of 1,024 (ff 1,024: the attention streams the
    head on the card) the layers' vmap rule runs each trial's chain once: K
    unbatched calls' outputs and gradients within ``BAR``, each operator's
    body once a trial, f32, rate 0.3, B 2 × T 32 a trial."""
    call = calls(RATE, 1, T)[kernel]
    args, dys, seeds = trials(kernel, 2, 13, torch.float32, "cpu", d=1024, ff=1024, rows=2 * T)
    want = unbatched(call, args, dys, seeds)
    counts = counted_bodies(monkeypatch, kernel)
    grads, outs = vmapped(call, args, dys, seeds)
    assert counts == {"forward": 2, "backward": 2}
    assert_equal(grads, outs, want, atol=BAR)


@pytest.mark.parametrize("kernel, twin", [("fused_layer", fl.encoder_layer_reference),
                                           ("fused_decoder_layer", fdl.decoder_layer_reference)])
def test_layer_functions_under_vmap_match_autograd_through_the_twin(kernel, twin):
    """The layer Functions under ``vmap(grad_and_value(...))`` (their
    operators' bodies: each chain launch's plain version) against autograd
    through the twin trial by trial, f32, rate 0.3: the output equal, every
    gradient within 1e-5 of its largest value (the backward chain sums in
    another order)."""
    args, dys, seeds = trials(kernel, K, 14, torch.float32, "cpu", d=D, ff=FF, rows=ROWS)
    grads, outs = vmapped(calls(RATE, H, T)[kernel], args, dys, seeds)
    want = unbatched(lambda *a: twin(*a, RATE, H, T), args, dys, seeds)
    for i, (want_grads, want_out) in enumerate(want):
        torch.testing.assert_close(outs[i], want_out, atol=0, rtol=0)
        for j, (g, w) in enumerate(zip(grads, want_grads)):
            torch.testing.assert_close(g[i], w, atol=1e-5 * float(w.abs().max()), rtol=0,
                                       msg=f"gradient {j} of trial {i}")


def test_decoder_memory_without_a_trial_axis():
    """A memory all trials share (``in_dims`` None) reaches every trial's
    call as it is, and its gradient is each trial's own."""
    kernel = "fused_decoder_layer"
    call = calls(RATE, H, T)[kernel]
    args, dys, seeds = trials(kernel, K, 12, torch.float32, "cpu", d=D, ff=FF, rows=ROWS)
    dims = [0, None] + [0] * (len(args[0]) - 2)
    grads, outs = vmapped(call, args, dys, seeds, dims)
    assert grads[1].shape == (K, ROWS, D)
    assert_equal(grads, outs, unbatched(call, args, dys, seeds, dims), atol=BAR)


def drawn(kernel: str, seed: int, rate: float = RATE):
    """K trials of one kernel on the same tensors, each drawing its seed
    inside the vmap from one generator (as ``_layer_seed`` does under
    ``randomness="different"``): each trial's hidden (#2-#4; for #5 the
    gradient at y, 0 where y was dropped) and output."""
    args, dys, _ = trials(kernel, 1, 13, torch.float32, "cpu", d=D, ff=FF, rows=ROWS)
    args, dy = args[0], dys[0]
    gen = torch.Generator().manual_seed(seed)

    def one(_):
        s = torch.randint(0, 2**31 - 1, (1,), generator=gen, dtype=torch.int32)
        if kernel == "fused_layer":
            out = fl.EncoderLayerTrain.apply(*args, s, rate, H, T)
            return out[3], out[0]
        if kernel == "fused_decoder_layer":
            out = fdl.DecoderLayerTrain.apply(*args, s, rate, H, T)
            return out[6], out[0]
        if kernel == "fused_ffn":
            out, h = ffn.FfnTrain.apply(*args, s, rate)
            return h, out
        x, y, scale, bias = args
        dy_at_y, out = torch.func.grad_and_value(
            lambda v: (ln.dropout_add_layernorm(x, v, scale, bias, s, rate) * dy).sum(),
        )(y)
        return dy_at_y, out

    return torch.func.vmap(one, randomness="different")(torch.arange(K))


@pytest.mark.parametrize("kernel", KERNELS)
def test_rate_030_trials_keep_the_rate_draw_their_own_masks_and_rerun_bit_for_bit(kernel):
    """At rate 0.3, K trials on the same tensors: each keeps the kernel's
    rate (#2-#4: the 8-bit rule's ``quantized_keep_rate`` of the hidden
    units that are live at rate 0, within 5σ, and 1e-2 more in the layers,
    where the upstream sites move which units the ReLU passes; #5: the exact
    rate of y's elements within 5σ), no two trials draw the same mask, and a
    rerun from the same generator seed is bit for bit."""
    hidden, out = drawn(kernel, 5)
    again_hidden, again_out = drawn(kernel, 5)
    assert torch.equal(hidden, again_hidden) and torch.equal(out, again_out)
    masks = hidden != 0
    assert all(not torch.equal(masks[i], masks[j]) for i in range(K) for j in range(i))
    if kernel == "fused_dropout_ln":
        keep, live, slack = 1.0 - RATE, masks[0].numel(), 0.0
    else:
        keep = quantized_keep_rate(RATE)
        live = int((drawn(kernel, 5, 0.0)[0][0] != 0).sum())
        slack = 0.0 if kernel == "fused_ffn" else 1e-2
    sigma = (keep * (1 - keep) / live) ** 0.5
    for i in range(K):
        share = int(masks[i].sum()) / live
        assert abs(share - keep) <= 5 * sigma + slack, (i, share, keep)


# the switches, the families each runs in, and the optimizers
FORCED = [(s, fam) for s in KERNELS
          for fam in (("encoder_decoder",) if s == "fused_decoder_layer"
                      else ("encoder_only", "encoder_decoder"))]


def configs(n_dec: int, switch: str, rate: float = 0.0):
    arch = dict(ARCH, num_decoder_layers=n_dec, dropout=rate)
    return JaxConfig(**arch, **{switch: True}), GrooveTransformerConfig(**arch, **{switch: True})


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("switch, family", FORCED)
def test_batched_sweep_with_a_forced_switch_matches_jax(monkeypatch, switch, family, optimizer):
    """JAX's ``init_stacked_params`` carried into the port, then 3 steps (3
    epochs of one batch of 4) of both packages' ``make_batched_sweep_fn`` at
    rate 0 with the switch forced in both configs, the port's step through
    the switch's operators and their vmap rules (#5 takes rate 0 unfused in
    both packages): final parameters and
    last-batch losses within 5e-5; under Adam, the entries whose gradient is
    rounding noise (the key biases, and at most 1e-3 of a leaf's others)
    within 3 steps of lr of their start instead
    (``test_torch_vmap_sweep.py::test_sweep_matches_jax``)."""
    n_dec = 2 if family == "encoder_decoder" else 0
    jax_cfg, cfg = configs(n_dec, switch)
    model = jax_build_model(jax_cfg)
    stacked = jax.tree.map(np.asarray, jax_sweep.init_stacked_params(
        model, jax_cfg, K, jax.random.PRNGKey(0)))
    x, y = grids(0, B)
    lrs = np.asarray([0.02, 0.05, 0.1] if optimizer == "sgd" else [1e-3, 2e-3, 3e-3], np.float32)
    pens = np.asarray([0.5, 0.3, 1.0], np.float32)
    rates = np.zeros(K, np.float32)
    fn = jax_sweep.make_batched_sweep_fn(model, B, B, 3, encoder_only=not n_dec, config=jax_cfg,
                                         rates_as_data=False, optimizer=optimizer)
    j_params, j_losses = fn(stacked, jax_sweep.init_stacked_opt(stacked, optimizer),
                            jnp.asarray(lrs), jnp.asarray(pens), jnp.asarray(rates),
                            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))

    init = stacked_state_dict_from_flax_params(stacked, cfg)
    counts = counted_bodies(monkeypatch, switch)
    port = build_model(cfg, "cpu")
    p_fn = vmap_sweep.make_batched_sweep_fn(port, B, B, 3, encoder_only=not n_dec, config=cfg,
                                            rates_as_data=False, optimizer=optimizer)
    p_params, p_losses = p_fn(init, vmap_sweep.init_stacked_opt(init, optimizer),
                              torch.from_numpy(lrs), torch.from_numpy(pens),
                              torch.from_numpy(rates), torch.from_numpy(x), torch.from_numpy(y),
                              torch.Generator().manual_seed(1))
    fused = switch != "fused_dropout_ln"
    assert (counts["forward"] > 0 and counts["backward"] > 0) == fused, counts

    np.testing.assert_allclose(p_losses.numpy(), np.asarray(j_losses), atol=SGD_BAR, rtol=0)
    got = leaves(stacked_flax_params_from_state_dict(p_params, cfg))
    want, first = leaves(jax.tree.map(np.asarray, j_params)), leaves(stacked)
    assert got.keys() == want.keys()
    for path, a in got.items():
        b, a0 = want[path], first[path]
        if optimizer == "sgd":
            np.testing.assert_allclose(a, b, atol=SGD_BAR, rtol=0, err_msg=str(path))
            continue
        noise = np.zeros(a.shape, bool)
        rows = key_bias_rows(path, D)
        if rows is not None:
            noise[..., rows] = True
        # beyond the key biases, an entry whose gradient is rounding noise in
        # some step (|g| near Adam's eps, 1e-8: d 128 has a few, d 32 none)
        # takes a step of up to lr in the noise's direction too: at most 1e-3
        # of a leaf's entries (and 2) may, each within 3 steps of lr of its start
        off = (np.abs(a - b) > SGD_BAR) & ~noise
        assert off.sum() <= 1e-3 * off.size + 2, (path, int(off.sum()))
        noise |= off
        np.testing.assert_allclose(a[~noise], b[~noise], atol=SGD_BAR, rtol=0)
        bound = np.broadcast_to((3 * lrs * 1.001 + 1e-7).reshape((K,) + (1,) * (a.ndim - 1)),
                                a.shape)
        for moved in (a, b):
            assert (np.abs(moved - a0)[noise] <= bound[noise]).all(), path


@pytest.mark.parametrize("switch", KERNELS)
def test_batched_sweep_with_a_forced_switch_at_rate_030_reruns_bit_for_bit(switch):
    """``batched_sweep`` at rate 0.3 (uniform: the kernels take the config's
    rate) with the switch forced, 2 epochs of 2 batches: the same seed gives
    the same parameters and losses bit for bit, the trials' losses differ
    and are finite."""
    n_dec = 2 if switch == "fused_decoder_layer" else 0
    _, cfg = configs(n_dec, switch, RATE)
    x, y = grids(3, 2 * B)

    def run():
        return vmap_sweep.batched_sweep(build_model(cfg, "cpu"), cfg, x, y, [0.05] * K,
                                        [0.5] * K, epochs=2, batch_size=B, seed=6,
                                        device="cpu")

    (params, losses), (again, losses_again) = run(), run()
    for key in params:
        assert torch.equal(params[key], again[key]), key
    assert torch.equal(losses, losses_again)
    assert torch.isfinite(losses).all() and len(set(losses.tolist())) == K
