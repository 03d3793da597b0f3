"""The whole-layer chains (ops/layer_sm90.py, composed by ops/fused_layer.py and
ops/fused_decoder_layer.py), bf16 and f32, on the CPU, where every launch runs
its plain version: the chained forward and backward against the JAX
package's Pallas kernels in interpret mode (f32, rate 0; the f32 chain also
at tighter bars) and against autograd through the port's twins (rate 0.30,
two layers stacked), the attention's launches against autograd with the
site-0 mask and causal rows, the LayerNorm launches against autograd, the
fixed-order split reduce, the split-TF32 arithmetic of the f32 products, and
the gates.

Tolerances: in f32 the chain and the twin do the same arithmetic in another
order (the backward by hand, the twin by autograd), so 1e-5 of the largest
value; against the JAX kernels the JAX package's own bars (2e-4 forward,
rtol 5e-3 / atol 5e-4 on the grads). In bf16 the chain rounds where the
kernels round (dS, dq/dk/dv, dattn, the row gradients that feed a product),
autograd does not: 2e-2 of the largest value, the bar chip_smoke.py holds
the kernels to."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu.ops.fused_decoder_layer import (
    decoder_layer_train as jax_decoder_layer_train,
)
from transformergrooveinfilling_tpu.ops.fused_layer import (
    encoder_layer_train as jax_encoder_layer_train,
)
from transformergrooveinfilling_tpu.ops.fused_layer import (
    supports_fused_layer as jax_supports_fused_layer,
)
from transformergrooveinfilling_tpu_torch.ops import fused_decoder_layer as fdl
from transformergrooveinfilling_tpu_torch.ops import fused_layer as fl
from transformergrooveinfilling_tpu_torch.ops import layer_sm90 as L

ENC_WEIGHTS = (0, 2, 6, 8)  # wqkv, wo, w1, w2 among the 12 encoder parameters
DEC_WEIGHTS = [fdl.ARG_NAMES.index(n) for n in fdl.WEIGHT_NAMES]


def _rng_normal(rng):
    def n(*shape, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(shape)).astype(np.float32)
    return n


def encoder_inputs(d, ff, rows, seed=0):
    """x, the 12 encoder parameters (JAX (in, out) layout) and dy, f32 numpy."""
    n = _rng_normal(np.random.default_rng(seed))
    params = [n(d, 3 * d, scale=d ** -0.5), n(3 * d, scale=0.1), n(d, d, scale=d ** -0.5),
              n(d, scale=0.1), n(d, scale=0.1, offset=1.0), n(d, scale=0.1),
              n(d, ff, scale=d ** -0.5), n(ff, scale=0.1), n(ff, d, scale=ff ** -0.5),
              n(d, scale=0.1), n(d, scale=0.1, offset=1.0), n(d, scale=0.1)]
    return n(rows, d), params, n(rows, d)


def decoder_inputs(d, ff, rows, seed=0):
    """y, mem and the 20 decoder parameters in ``fdl.ARG_NAMES`` order (JAX
    layout), and dy, f32 numpy."""
    n = _rng_normal(np.random.default_rng(seed))

    def w(inp, out):
        return n(inp, out, scale=inp ** -0.5)

    def vec(width):
        return n(width, scale=0.1)

    def gain():
        return n(d, scale=0.1, offset=1.0)

    args = [n(rows, d), n(rows, d), w(d, 3 * d), vec(3 * d), w(d, d), vec(d), w(d, d), vec(d),
            w(d, 2 * d), vec(2 * d), w(d, d), vec(d), gain(), vec(d), w(d, ff), vec(ff),
            w(ff, d), vec(d), gain(), vec(d), gain(), vec(d)]
    return args, n(rows, d)


def to_port(arrays, weights, dtype=torch.float32):
    """numpy (JAX layout) → torch in the port's (out, in) layout; the
    activations and weights in ``dtype``, vectors f32."""
    out = []
    for i, a in enumerate(arrays):
        t = torch.from_numpy(np.ascontiguousarray(a.T) if i in weights else a)
        out.append(t.to(dtype) if t.dim() == 2 else t)
    return out


def encoder_chain(args, dy, seed, rate, h, t):
    """The forward and backward chains of the activations' dtype on CPU
    tensors."""
    res = fl.forward_sm90(*args, seed, rate, h, t)
    x, wqkv, _, wo, _, g1, b1, w1, _, w2, _, g2, _ = args
    _, qkv, a1, hid, a2 = res
    return res, fl.backward_sm90(dy, x, qkv, a1, hid, a2, wqkv, wo, w1, w2, g1, b1, g2, seed,
                                 rate, h, t)


def decoder_chain(args, dy, seed, rate, h, t):
    res = fdl.forward_sm90(*args, seed, rate, h, t)
    a = dict(zip(fdl.ARG_NAMES, args))
    back = (a["y"], a["mem"], *res[1:], *(a[k] for k in fdl.WEIGHT_NAMES), a["g1"], a["b1"],
            a["g2"], a["b2"], a["g3"], seed)
    return res, fdl.backward_sm90(dy, *back, rate, h, t)


def _rel(got, want) -> float:
    want = want.detach().float()
    return float((got.detach().float() - want).abs().max()) / max(1e-30,
                                                                 float(want.abs().max()))


@pytest.mark.parametrize("d, h, ff", [(256, 2, 512), (128, 2, 256), (512, 1, 512)])
def test_encoder_chain_matches_jax_kernel_forward_and_grads(d, h, ff):
    """The chained plain forward and backward at f32 against JAX
    encoder_layer_train in interpret mode (jax.vjp), B 4 × T 32 rows; at d
    512 (one head of 512) the wide route's composition."""
    t, b = 32, 4
    x, params, dy = encoder_inputs(d, ff, b * t)
    seed = np.zeros((1,), np.int32)

    def jax_layer(x, *p):
        return jax_encoder_layer_train(x, *p, jnp.asarray(seed), 0.0, h, t, True)

    y_jax, vjp = jax.vjp(jax_layer, jnp.asarray(x), *map(jnp.asarray, params))
    grads_jax = vjp(jnp.asarray(dy))
    args = to_port([x] + params, [i + 1 for i in ENC_WEIGHTS])
    res, grads = encoder_chain(args, torch.from_numpy(dy), torch.from_numpy(seed), 0.0, h, t)
    np.testing.assert_allclose(res[0].numpy(), np.asarray(y_jax), rtol=2e-4, atol=2e-4)
    names = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dg1", "db1", "dw1", "db1f", "dw2", "db2f",
             "dg2", "db2")
    for i, (name, g, want) in enumerate(zip(names, grads, grads_jax)):
        g = g.numpy().T if i - 1 in ENC_WEIGHTS else g.numpy()
        np.testing.assert_allclose(g, np.asarray(want), rtol=5e-3, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("d, h, ff", [pytest.param(128, 2, 128, id="2"),
                                      pytest.param(128, 1, 128, id="1"), (512, 4, 1024)])
def test_decoder_chain_matches_jax_kernel_forward_and_grads(d, h, ff):
    """The decoder's chained plain forward and backward at f32 against JAX
    decoder_layer_train in interpret mode: y3, dx, dmem and 20 grads, d 128,
    ff 128, B 4 × T 32 (the smallest shape the JAX gate takes), and the wide
    route's composition at d 512, 4 heads, ff 1,024."""
    t, b = 32, 4
    args, dy = decoder_inputs(d, ff, b * t)
    seed = np.zeros((1,), np.int32)

    def jax_layer(*a):
        return jax_decoder_layer_train(*a, jnp.asarray(seed), 0.0, h, t, True)

    y_jax, vjp = jax.vjp(jax_layer, *map(jnp.asarray, args))
    grads_jax = vjp(jnp.asarray(dy))
    res, grads = decoder_chain(to_port(args, DEC_WEIGHTS), torch.from_numpy(dy),
                               torch.from_numpy(seed), 0.0, h, t)
    np.testing.assert_allclose(res[0].numpy(), np.asarray(y_jax), rtol=2e-4, atol=2e-4)
    for i, (name, g, want) in enumerate(zip(("dx", "dmem") + fdl.ARG_NAMES[2:], grads,
                                            grads_jax)):
        g = g.numpy().T if i in DEC_WEIGHTS else g.numpy()
        np.testing.assert_allclose(g, np.asarray(want), rtol=5e-3, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("which, d, h, ff, atol", [
    ("encoder", 128, 2, 256, 3e-5), ("encoder", 256, 2, 512, 1e-4),
    ("decoder", 128, 2, 128, 3e-5), ("decoder", 256, 2, 512, 1e-4)])
def test_f32_chain_matches_jax_kernel_at_f32_bars(which, d, h, ff, atol):
    """The f32 chain (its counted launches, ``route_kernels(torch.float32)``)
    composed of per-launch plain versions, forward and backward, against the
    JAX kernel in interpret mode (rate 0, B 4 × T 32 rows), every output and
    gradient to an absolute bar alone: 3e-5 at d 128, the narrowest width the
    JAX gate takes (head pairs of 64 lanes), and 1e-4 at the flagship's d 256.
    Both sides sum in f32 in different orders; the largest gap on these
    inputs is 1.4e-5 at d 128 and 1.9e-5 at d 256 (the weight gradients, sums
    over 128 rows of products up to ~10)."""
    t, b = 32, 4
    seed = np.zeros((1,), np.int32)
    if which == "encoder":
        x, params, dy = encoder_inputs(d, ff, b * t, seed=5)
        arrays, weights, jax_fn = [x] + params, [i + 1 for i in ENC_WEIGHTS], jax_encoder_layer_train
        chain = encoder_chain
    else:
        arrays, dy = decoder_inputs(d, ff, b * t, seed=5)
        weights, jax_fn, chain = DEC_WEIGHTS, jax_decoder_layer_train, decoder_chain

    def jax_layer(*a):
        return jax_fn(*a, jnp.asarray(seed), 0.0, h, t, True)

    y_jax, vjp = jax.vjp(jax_layer, *map(jnp.asarray, arrays))
    grads_jax = vjp(jnp.asarray(dy))
    mod = fl if which == "encoder" else fdl
    before = {k: f.launches for k, f in mod.route_kernels(torch.float32).items()}
    res, grads = chain(to_port(arrays, weights), torch.from_numpy(dy), torch.from_numpy(seed),
                       0.0, h, t)
    assert {k: f.launches for k, f in mod.route_kernels(torch.float32).items()} == before
    np.testing.assert_allclose(res[0].numpy(), np.asarray(y_jax), rtol=0, atol=atol)
    for i, (g, want) in enumerate(zip(grads, grads_jax)):
        g = g.numpy().T if i in weights else g.numpy()
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=atol, err_msg=str(i))


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d, t", [(128, 8), (256, 32)])
def test_two_encoder_layers_match_autograd_through_the_twin(d, t, dtype, tol):
    """Two encoder layers stacked at rate 0.30: the chains' forward and
    backward (the second layer's dx is the first's dy) against autograd
    through two calls of encoder_layer_reference, every residual and grad."""
    h, ff, b = 2, 2 * d, 3
    layers = [encoder_inputs(d, ff, b * t, seed=s) for s in (1, 2)]
    x = torch.from_numpy(layers[0][0]).to(dtype)
    dy = torch.from_numpy(layers[0][2]).to(dtype)
    params = [to_port(p, ENC_WEIGHTS, dtype) for _, p, _ in layers]
    seeds = [torch.tensor([s], dtype=torch.int32) for s in (11, 12)]

    leaves = [[a.clone().requires_grad_(True) for a in p] for p in params]
    x_leaf = x.clone().requires_grad_(True)
    want_res, inp = [], x_leaf
    for p, s in zip(leaves, seeds):
        want_res.append(fl.encoder_layer_reference(inp, *p, s, 0.3, h, t,
                                                   return_residuals=True))
        inp = want_res[-1][0]
    inp.backward(dy)

    got_res, inp = [], x
    for p, s in zip(params, seeds):
        got_res.append(fl.forward_sm90(inp, *p, s, 0.3, h, t))
        inp = got_res[-1][0]
    grad = dy
    for i in (1, 0):
        layer_in = x if i == 0 else got_res[0][0]
        wqkv, _, wo, _, g1, b1, w1, _, w2, _, g2, _ = params[i]
        _, qkv, a1, hid, a2 = got_res[i]
        grads = fl.backward_sm90(grad, layer_in, qkv, a1, hid, a2, wqkv, wo, w1, w2, g1, b1, g2,
                                 seeds[i], 0.3, h, t)
        for name, g, leaf in zip(("wqkv", "bqkv", "wo", "bo", "g1", "b1", "w1", "b1f", "w2",
                                  "b2f", "g2", "b2"), grads[1:], leaves[i]):
            assert _rel(g, leaf.grad) <= tol, f"layer {i} d{name}"
        grad = grads[0]
    assert _rel(grad, x_leaf.grad) <= tol, "dx"
    for got, want in zip(got_res, want_res):
        for name, g, w in zip(("y", "qkv", "a1", "h", "a2"), got, want):
            assert _rel(g, w) <= (0 if dtype == torch.float32 else tol), name


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d, t", [(128, 8), (256, 32)])
def test_decoder_chain_matches_autograd_through_the_twin(d, t, dtype, tol):
    """The decoder's chains at rate 0.30 against autograd through
    decoder_layer_reference: y3, the seven residuals, dx, dmem, 20 grads."""
    h, ff = 2, 2 * d
    args, dy = decoder_inputs(d, ff, 3 * t, seed=4)
    args = to_port(args, DEC_WEIGHTS, dtype)
    dy = torch.from_numpy(dy).to(dtype)
    seed = torch.tensor([21], dtype=torch.int32)
    leaves = [a.clone().requires_grad_(True) for a in args]
    want = fdl.decoder_layer_reference(*leaves, seed, 0.3, h, t, return_residuals=True)
    want[0].backward(dy)
    res, grads = decoder_chain(args, dy, seed, 0.3, h, t)
    for name, g, w in zip(("y",) + fdl.RESIDUAL_NAMES, res, want):
        assert _rel(g, w) <= (0 if dtype == torch.float32 else tol), name
    for name, g, leaf in zip(("x",) + fdl.ARG_NAMES[1:], grads, leaves):
        assert _rel(g, leaf.grad) <= tol, f"d{name}"


def _attention_reference(q, k, v, seed, rate, n_heads, t, causal):
    """Softmax attention with the site-0 mask, autograd's gradient."""
    rows, d = q.shape
    b, hd = rows // t, d // n_heads

    def heads(x):
        return x.reshape(b, t, n_heads, hd).permute(0, 2, 1, 3)

    s = heads(q) @ heads(k).transpose(-1, -2) / hd ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), float("-inf"))
    p = torch.softmax(s, -1)
    keep = fl.dropout_mask(seed, fl.SITE_ATTN, (b * n_heads * t, t), rate).reshape(p.shape)
    p = torch.where(keep, p / (L.quantized_threshold(rate) / 256.0), torch.zeros(()))
    return (p @ heads(v)).transpose(1, 2).reshape(rows, d)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t, n_heads, hd", [(32, 2, 128), (8, 4, 16), (8, 4, 8), (128, 2, 64),
                                            (256, 1, 128)])
def test_attention_launches_match_autograd(t, n_heads, hd, causal):
    """attention_forward and attention_backward (f32, rate 0.30, on strided
    views of a packed qkv) against autograd through softmax attention with
    the same site-0 mask; causal rows give the future keys nothing."""
    rng = np.random.default_rng(5)
    d, rows = n_heads * hd, 3 * t
    qkv = torch.from_numpy(rng.standard_normal((rows, 3 * d)).astype(np.float32))
    da = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    seed = torch.tensor([9], dtype=torch.int32)
    q, k, v = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
    out = L.attention_forward(None, q, k, v, seed, fl.SITE_ATTN, 0.3, n_heads, t, causal)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = _attention_reference(*leaves, seed, 0.3, n_heads, t, causal)
    want.backward(da)
    torch.testing.assert_close(out, want.detach(), rtol=1e-5, atol=1e-5)
    dqkv, again = torch.zeros_like(qkv), torch.zeros_like(da)
    L.attention_backward(None, q, k, v, da, dqkv[:, :d], dqkv[:, d:2 * d], dqkv[:, 2 * d:],
                         again, seed, fl.SITE_ATTN, 0.3, n_heads, t, causal)
    assert torch.equal(again, out)
    for got, leaf in zip((dqkv[:, :d], dqkv[:, d:2 * d], dqkv[:, 2 * d:]), leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=1e-5, atol=1e-5)
    if causal:  # a sequence's first query sees only its first key: its dS and dq are 0
        first = torch.arange(0, rows, t)
        assert float(dqkv[first, :d].abs().max()) <= 1e-6


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("t", [128, 256])
def test_attention_masks_past_t_32(t, rate):
    """The attention site's mask in 8- and 16-bar loops (the kernels' long
    route on the card draws a row's 16 columns a lane): with one head, hd =
    T and V the identity, the output is drop(P) itself, nonzero exactly
    where ``dropout_mask`` keeps; the backward's output again shows the same
    mask; the kept share is the quantized keep rate within 4σ; a rerun with
    the seed is bit for bit, another seed another mask."""
    nseq = 3
    rng = np.random.default_rng(t)
    q, k, da = (torch.from_numpy(0.1 * rng.standard_normal((nseq * t, t)).astype(np.float32))
                for _ in range(3))
    v = torch.eye(t).repeat(nseq, 1)

    def mask(seed):
        s = torch.tensor([seed], dtype=torch.int32)
        out = L.attention_forward(None, q, k, v, s, fl.SITE_ATTN, rate, 1, t, False)
        grads = [torch.zeros_like(q) for _ in range(4)]
        L.attention_backward(None, q, k, v, da, *grads, s, fl.SITE_ATTN, rate, 1, t, False)
        assert torch.equal(grads[3], out)
        return out != 0

    keep = fl.dropout_mask(torch.tensor([7], dtype=torch.int32), fl.SITE_ATTN, (nseq * t, t),
                           rate)
    got = mask(7)
    assert torch.equal(got, keep) and torch.equal(mask(7), got)
    assert not torch.equal(mask(8), got)
    p = L.quantized_threshold(rate) / 256.0
    assert abs(float(got.float().mean()) - p) <= 4 * np.sqrt(p * (1 - p) / got.numel())


def _layernorm(a, g, b):
    return torch.nn.functional.layer_norm(a, a.shape[-1:], g, b, eps=L.LN_EPS)


def test_layernorm_launches_match_autograd():
    """residual_ln_product, ln_rows and ln_backward_product (f32, rate 0)
    against torch's layer_norm and its autograd: the forward value, the
    statistics, and each LayerNorm's input gradient with the residual path."""
    rng = np.random.default_rng(6)
    rows, k, d = 40, 48, 64

    def n(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(shape)).astype(np.float32))

    a, w, bias, resid = n(rows, k), n(d, k, scale=k ** -0.5), n(d, scale=0.1), n(rows, d)
    g, beta, dy = n(d, scale=0.1, offset=1.0), n(d, scale=0.1), n(rows, d)
    seed = torch.tensor([1], dtype=torch.int32)
    s, y = L.residual_ln_product(None, a, w, bias, resid, g, beta, seed, 1, 0.0)
    pre = resid + a @ w.t() + bias
    torch.testing.assert_close(s, pre, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(y, _layernorm(pre, g, beta), rtol=1e-5, atol=1e-5)
    leaf = pre.clone().requires_grad_(True)
    _layernorm(leaf, g, beta).backward(dy)
    (y_again,), stats, da, df = L.ln_rows(None, [(pre, g, beta, True)], dy, seed, 3, 0.0)
    torch.testing.assert_close(y_again, y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(stats[:, 0], pre.mean(-1), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(da, leaf.grad, rtol=1e-4, atol=1e-5)
    assert torch.equal(df, da)  # rate 0: the mask keeps everything
    # v = A·W + resid is the gradient at the LayerNorm's output
    dh, w1 = n(rows, k), n(k, d, scale=k ** -0.5)
    da_next, v, dp = L.ln_backward_product(None, dh, w1, dy, g, pre, stats, seed, 1, 0.0)
    torch.testing.assert_close(v, dh @ w1 + dy, rtol=1e-6, atol=1e-6)
    leaf = pre.clone().requires_grad_(True)
    _layernorm(leaf, g, beta).backward(v)
    torch.testing.assert_close(da_next, leaf.grad, rtol=1e-4, atol=1e-5)
    assert torch.equal(dp, da_next)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [264, 512, 1024, 2048])
def test_wide_route_plain_versions_compose_to_the_definitions(d, dtype):
    """Past ``LN_TILE`` each LayerNorm-epilogue launch is two: the plain
    versions of the product and the row pass, composed as the wrappers
    compose them, are the one-launch definitions bit for bit
    (``residual_sum_reference`` then ``ln_y_reference`` is
    ``residual_ln_reference``; ``grad_sum_reference`` then
    ``ln_grad_reference`` is ``ln_backward_reference``), at rate 0.3 with
    the sites' masks, and the wrappers on CPU tensors route by d through the
    pair of counted kernels and launch nothing."""
    rng = np.random.default_rng(d)
    rows, k = 48, 72

    def n(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(shape)).astype(np.float32))

    a, w, resid = n(rows, k).to(dtype), n(d, k, scale=k ** -0.5).to(dtype), n(rows, d).to(dtype)
    bias, g, beta = n(d, scale=0.1), n(d, scale=0.1, offset=1.0), n(d, scale=0.1)
    seed = torch.tensor([7], dtype=torch.int32)
    pairs = L.by_launch(fl.SM90_LAUNCHES, fl.route_kernels(dtype, d), L.is_wide(d))
    before = {name: f.launches for name, f in fl.route_kernels(dtype, d).items()}
    want = L.residual_ln_reference(a, w, bias, resid, g, beta, seed, 1, 0.3)
    a_out, s = L.residual_sum_reference(a, w, bias, resid, seed, 1, 0.3)
    assert s.dtype == torch.float32 and torch.equal(a_out, want[0])
    assert torch.equal(L.ln_y_reference(s, g, beta, dtype), want[1])
    got = L.residual_ln_product(pairs["proj_ln1"], a, w, bias, resid, g, beta, seed, 1, 0.3)
    assert all(torch.equal(u, v) for u, v in zip(got, want))

    dh, w1, da = n(rows, k).to(dtype), n(k, d, scale=k ** -0.5).to(dtype), n(rows, d)
    stats = torch.cat(L._stats(want[0].float()), 1)
    want = L.ln_backward_reference(dh, w1, da, g, want[0], stats, seed, 1, 0.3)
    v = L.grad_sum_reference(dh, w1, da)
    assert torch.equal(v, want[1])
    assert all(torch.equal(u, t) for u, t in zip(
        L.ln_grad_reference(v, g, got[0], stats, seed, 1, 0.3), (want[0], want[2])))
    got = L.ln_backward_product(pairs["dy1_ln1"], dh, w1, da, g, got[0], stats, seed, 1, 0.3)
    assert all(torch.equal(u, t) for u, t in zip(got, want))
    assert {name: f.launches for name, f in fl.route_kernels(dtype, d).items()} == before
    with pytest.raises(ValueError, match="wide route"):  # one kernel where d takes two
        L.residual_ln_product(fl.SM90_KERNELS["fused_layer_sm90_proj_ln1"], a, w, bias, resid,
                              g, beta, seed, 1, 0.3)


@pytest.mark.parametrize("mod, n, n_fwd", [(fl, 16, 7), (fdl, 26, 12)])
def test_wide_route_kernels(mod, n, n_fwd):
    """Past d 256 a chain launches its wide route: each ``res_ln`` / ``ln_bwd``
    launch of the narrow route as ``_sum`` (the product) and ``_rows`` (the
    row pass) in its place, 16 launches an encoder layer and 26 a decoder
    layer, the launches both routes make counted by the same counters; up to
    d 256 and without a d, the narrow route (``is_wide``)."""
    for dtype, narrow, wide in ((torch.bfloat16, mod.SM90_KERNELS, mod.SM90_WIDE_KERNELS),
                                (torch.float32, mod.SM90_F32_KERNELS, mod.SM90_WIDE_F32_KERNELS)):
        assert mod.route_kernels(dtype) is narrow and mod.route_kernels(dtype, 256) is narrow
        assert mod.route_kernels(dtype, 264) is wide and mod.route_kernels(dtype, 1024) is wide
        assert len(wide) == n == len(mod.SM90_WIDE_LAUNCHES)
        prefix = f"{mod.__name__.split('.')[-1]}_sm90{'_f32' if dtype == torch.float32 else ''}_"
        assert list(wide) == [prefix + k for k in mod.SM90_WIDE_LAUNCHES]
        for name, kind in mod.SM90_LAUNCHES.items():
            if kind in L.WIDE:
                assert prefix + name not in wide
                for part, wide_kind in zip(("_sum", "_rows"), L.WIDE[kind]):
                    assert wide[prefix + name + part].entry == L.ENTRIES[wide_kind]
                    assert mod.SM90_WIDE_LAUNCHES[name + part] == wide_kind
            else:
                assert wide[prefix + name] is narrow[prefix + name]
        split = list(L.by_launch(mod.SM90_LAUNCHES, wide, True).items())
        assert [k for k, _ in split] == list(mod.SM90_LAUNCHES)
        assert sum(2 if isinstance(v, tuple) else 1 for _, v in split) == n
        assert L.by_launch(mod.SM90_LAUNCHES, narrow, False) == dict(
            zip(mod.SM90_LAUNCHES, narrow.values()))
    assert not L.is_wide(None) and not L.is_wide(256) and L.is_wide(264)
    forward = list(mod.SM90_WIDE_LAUNCHES)[:n_fwd]
    assert forward[-1].endswith("_rows") and mod.SM90_WIDE_LAUNCHES[forward[-1]] == "ln_y"


def test_tf32_round_is_to_nearest_ties_away():
    """``tf32_round`` is ``cvt.rna.tf32.f32``: 10 mantissa bits kept, the low
    13 bits of the pattern cleared, to nearest, a tie away from zero, for
    either sign; within half a TF32 unit (2⁻¹¹ of the value's binade)."""
    ulp = 2.0 ** -23  # of f32 at 1
    one = torch.tensor([1 + 0x0FFF * ulp, 1 + 0x1000 * ulp, 1 + 0x2FFF * ulp, 1 + 0x3000 * ulp],
                       dtype=torch.float32)
    want = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -10, 1 + 2 * 2.0 ** -10])
    assert torch.equal(L.tf32_round(one), want)
    assert torch.equal(L.tf32_round(-one), -want)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(4096).astype(np.float32)
                         * np.float32(10.0) ** np.arange(-4, 4).repeat(512).astype(np.float32))
    r = L.tf32_round(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    binade = 2.0 ** torch.floor(torch.log2(x.abs()))
    assert bool(((r - x).abs() <= 2.0 ** -11 * binade).all())


def test_split_reconstructs_each_input_to_2_pow_minus_22():
    """hi + lo, both TF32 values, is within 2⁻²² of each f32 input: hi is
    within 2⁻¹¹ of x, and lo, x − hi rounded to TF32, within 2⁻¹¹ of x − hi."""
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(8192).astype(np.float32)
                         * np.float32(3.0) ** np.arange(-8, 8).repeat(512).astype(np.float32))
    hi, lo = L.split_tf32(x)
    assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert float(err.max()) > 0  # the split is not exact: the remainder is rounded too


@pytest.mark.parametrize("k", [16, 128, 512, 2048])
def test_split_tf32_matmul_within_its_bound(k):
    """The f32 products' arithmetic, A_lo·B_hi + A_hi·B_lo + A_hi·B_hi of the
    operands' TF32 splits (exact TF32 products summed in f64 here), against
    the f64 product: each term a·b misses by at most lo_a·lo_b + hi_a·e_b +
    e_a·hi_b ≤ 3.01·2⁻²²·|a||b| (e = x − hi − lo), so elementwise |error| ≤
    3.01·2⁻²²·(|A|·|B|); the terms' errors have random signs, so the largest
    error stays below 1e-6·√K·max|a|·max|b|, and a hundredth of what one TF32
    product (hi·hi alone) misses by."""
    rng = np.random.default_rng(13 + k)
    a = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    err = (L.split_tf32_matmul(a, b) - exact).abs()
    assert bool((err <= 3.01 * 2.0 ** -22 * (a.double().abs() @ b.double().abs())
                 + 1e-12).all())
    scale = float(a.abs().max()) * float(b.abs().max())
    assert float(err.max()) <= 1e-6 * k ** 0.5 * scale
    one = (L.tf32_round(a).double() @ L.tf32_round(b).double() - exact).abs()
    assert float(err.max()) * 100 < float(one.max())


@pytest.mark.parametrize("splits", [2, 3, 5])
def test_split_reduce_equals_the_one_split_sum(splits):
    """weight_gradients_reference in row splits, added in split order,
    against one split: each dYᵀ·X and each column sum (f32 sums in another
    grouping: 1e-5 of the largest value); the reduce adds in the given order."""
    rng = np.random.default_rng(7)
    rows = 200

    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    problems = [(n(rows, 24), n(rows, 16)), (n(rows, 8), n(rows, 40))]
    stats = torch.stack([n(rows).mul(0.1), n(rows).abs().add(0.5)], 1)
    segments = [(n(rows, 24), None, None), (n(rows, 16), n(rows, 16), stats)]
    one = L.weight_gradients_reference(problems, segments)
    many = L.weight_gradients_reference(problems, segments, splits=splits)
    assert one.shape == many.shape == (24 * 16 + 8 * 40 + 24 + 16,)
    torch.testing.assert_close(many, one, rtol=1e-5, atol=1e-5 * float(one.abs().max()))
    direct = torch.cat([(dy.t() @ x).reshape(-1) for dy, x in problems]
                       + [segments[0][0].sum(0),
                          (segments[1][0] * (segments[1][1] - stats[:, :1]) * stats[:, 1:]).sum(0)])
    torch.testing.assert_close(one, direct, rtol=1e-5, atol=1e-5)
    part = n(4, 10)
    assert torch.equal(L.reduce_reference(part), ((part[0] + part[1]) + part[2]) + part[3])


def test_weight_gradient_splits():
    """The flagship's four weight gradients (32 tiles of 128 × 128) at batch
    32 and 512 on 132 SMs: 4 splits of whole 64-row stages, none empty."""
    shapes = [(768, 256), (256, 256), (512, 256), (256, 512)]
    assert L.wgrad_splits(1024, shapes, 132) == (4, 256)
    assert L.wgrad_splits(16384, shapes, 132) == (4, 4096)
    for rows in (1, 63, 64, 100, 1000, 5000):
        splits, per = L.wgrad_splits(rows, shapes, 132)
        assert per % 64 == 0 and (splits - 1) * per < rows <= splits * per
    assert L.wgrad_splits(64 * 1024, [(4096, 4096)] * 2, 132) == (1, 64 * 1024)


def test_bf16_gate_boundaries():
    """bf16: d a multiple of 8 up to 8,192 (past 256 the wide route, past
    1,024 its row passes a block a row), ff a multiple of 8, heads dividing d
    into widths that are multiples of 8 (any width: the attention streams the
    head), T up to 32 (GrooveXL's d 1024 / ff 4,096 is in the bf16 gate, not
    in the f32 one)."""
    bf16 = torch.bfloat16
    for gate in (fl.supports_fused_layer, fdl.supports_fused_decoder_layer):
        assert gate(256, 2, 512, 32, bf16)  # the flagship
        assert gate(256, 2, 2048, 32, bf16)  # InfillingRandomLow_lm's width
        assert gate(8, 1, 8, 1, bf16)
        assert gate(32, 4, 512, 32, bf16)  # the demo width
        assert gate(264, 3, 512, 32, bf16)  # past the LayerNorm epilogue's tile: the wide route
        assert gate(1024, 4, 4096, 32, bf16)  # GrooveXL
        assert gate(512, 1, 512, 32, bf16)  # hd 512
        assert gate(1032, 3, 512, 32, bf16)  # past d 1,024: the row passes a block a row
        assert gate(1024, 1, 1024, 32, bf16)  # hd 1,024: the attention streams the head
        assert gate(8192, 2, 1024, 32, bf16)  # the row passes' widest row
        assert not gate(8200, 1, 1024, 32, bf16)  # beyond the row passes' 8,192
        assert not gate(252, 2, 512, 32, bf16)  # d not a multiple of 8
        assert not gate(256, 2, 516, 32, bf16)  # ff not a multiple of 8
        assert gate(256, 2, 512, 33, bf16)  # past T 32: the attention's long route
        assert gate(256, 2, 512, 256, bf16)  # a 16-bar loop
        assert not gate(256, 2, 512, 257, bf16)  # T beyond layer_sm90.MAX_T
        assert not gate(256, 3, 512, 32, bf16)  # d not divisible by the heads
        assert not gate(32, 8, 512, 32, bf16)  # hd 4: below the attention's 16-byte rows
        assert not gate(96, 8, 512, 32, bf16)  # hd 12
        assert gate(96, 4, 512, 32, bf16)  # hd 24, zero-filled to 32 in the attention
        assert not gate(256, 2, 512, 0, bf16)
        assert gate(256, 2, 512, 32) and not gate(1024, 4, 4096, 32)  # f32
        assert gate(1024, 2, 1024, 32) and gate(1024, 1, 1024, 32)  # f32, hd 512 and 1,024


def test_gates_admit_every_width_of_the_jax_gate_up_to_d_4096():
    """Every (d, heads, ff) the JAX package's gate admits at rows 256 and T
    32, 64, 128 and 256 (2- to 16-bar loops: every T whose sequences tile its
    256-row block) with d up to 4,096 (multiples of 128), 1 to 5 heads and
    ff 128 to 1,024 (its ceiling), the port's encoder and decoder gates admit
    in bf16 and in f32: the chains run every layer the JAX kernels run there.
    Past T 256 the JAX gate admits none at rows 256, and the port's gates
    none at any rows."""
    for t in (32, 64, 128, 256):
        admitted = [(d, h, ff) for d in range(128, 4097, 128) for h in range(1, 6)
                    for ff in range(128, 1025, 128)
                    if jax_supports_fused_layer(d, h, ff, 256, t)]
        assert (1024, 1, 1024) in admitted and (2048, 2, 1024) in admitted
        assert (1280, 5, 1024) in admitted and len(admitted) > 500
        for gate in (fl.supports_fused_layer, fdl.supports_fused_decoder_layer):
            for dtype in (torch.bfloat16, torch.float32):
                refused = [w for w in admitted if not gate(*w, t, dtype)]
                assert not refused, (gate.__name__, dtype, t, refused[:5])
    assert not jax_supports_fused_layer(256, 2, 512, 512, 512)
    for gate in (fl.supports_fused_layer, fdl.supports_fused_decoder_layer):
        assert not gate(256, 2, 512, L.MAX_T + 1) and gate(256, 2, 512, L.MAX_T)


CONFIG_WIDTHS = {(32, 16, 512), (32, 4, 16), (64, 16, 256), (256, 16, 64), (256, 2, 512),
                 (256, 2, 2048)}


def test_f32_gate_admits_every_config_width():
    """The f32 chain's gate admits, at T 32, every (d, heads, ff) of
    configs/*.yaml up to ff 1,024, hd 2 and 4 among them (the f32 attention
    takes any head width), and these are all the widths the configs hold; the
    lm config's ff 2,048 is past ``F32_MAX_FF`` (its unpromoted sums drift
    past the chain's 1e-5 bar on the card, ROADMAP §C11) and takes the
    unfused path in f32. It refuses d or ff a multiple of 4 but not of 8,
    which the CUDA-core kernels before it took by shared memory alone, and
    takes the d past the LayerNorm tile's 256 that they took (to ~352) by
    the wide route, and every d up to the row passes' 8,192 past them."""
    from transformergrooveinfilling_tpu_torch.utils import yaml_subset

    found = set()
    for path in sorted((Path(__file__).parents[1] / "configs").glob("*.yaml")):
        cfg = yaml_subset.load_file(str(path))
        if isinstance(cfg.get("d_model"), int):
            found.add((cfg["d_model"], cfg["n_heads"], cfg["dim_feedforward"]))
    assert found == CONFIG_WIDTHS
    for gate in (fl.supports_fused_layer, fdl.supports_fused_decoder_layer):
        for d, h, ff in sorted(CONFIG_WIDTHS):
            assert gate(d, h, ff, 32, torch.float32) == (ff <= fl.F32_MAX_FF), (d, h, ff)
        for d, h, ff in ((36, 4, 64), (252, 2, 512), (32, 4, 20), (256, 2, 516)):
            assert not gate(d, h, ff, 32, torch.float32), (d, h, ff)
        for d, h, ff in ((264, 2, 512), (352, 4, 512), (1024, 1, 1024), (2048, 2, 1024),
                         (8192, 1, 1024)):
            assert gate(d, h, ff, 32, torch.float32), (d, h, ff)
        assert not gate(8200, 1, 1024, 32, torch.float32)
    assert not fl.supports_fused_layer(32, 16, 512, 32, torch.bfloat16)  # hd 2 in bf16


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_run_the_plain_versions_and_launch_nothing(dtype):
    """On CPU tensors each launch of either dtype's chain runs its plain
    version and no counter moves; each dtype has its own 13 + 21 counted
    launches, under names of its own."""
    d, ff, t = 64, 128, 8
    x, params, dy = encoder_inputs(d, ff, 2 * t)
    args = to_port([x] + params, [i + 1 for i in ENC_WEIGHTS], dtype)
    every = {**fl.SM90_KERNELS, **fdl.SM90_KERNELS, **fl.SM90_F32_KERNELS,
             **fdl.SM90_F32_KERNELS}
    before = {name: f.launches for name, f in every.items()}
    encoder_chain(args, torch.from_numpy(dy).to(dtype), torch.tensor([2], dtype=torch.int32),
                  0.3, 2, t)
    dargs, ddy = decoder_inputs(d, ff, 2 * t)
    decoder_chain(to_port(dargs, DEC_WEIGHTS, dtype), torch.from_numpy(ddy).to(dtype),
                  torch.tensor([2], dtype=torch.int32), 0.3, 2, t)
    assert {name: f.launches for name, f in every.items()} == before
    assert len(every) == 2 * (13 + 21)
    for mod, n in ((fl, 13), (fdl, 21)):
        route = mod.route_kernels(dtype)
        assert route is (mod.SM90_KERNELS if dtype == torch.bfloat16 else mod.SM90_F32_KERNELS)
        assert len(route) == n and list(route) == [
            f"{mod.__name__.split('.')[-1]}_sm90{'_f32' if dtype == torch.float32 else ''}_{k}"
            for k in mod.SM90_LAUNCHES]


def test_entry_points_declare_every_argument():
    """Each C entry point of csrc/layer_sm90.cu, csrc/layer_wide_sm90.cu (the
    wide route's, ``WIDE_ENTRIES``) and csrc/layer_attn_sm90.cu (the
    attention's, ``ATTN_ENTRIES``) takes what SIGNATURES declares for
    ctypes, and the stream last: a missing argument would shift every later
    one (the card rejects too few; too many it would read as garbage)."""
    csrc = Path(L.__file__).parents[1] / "csrc"
    found, wide = {}, set()
    for source in ("layer_sm90", L.WIDE_SOURCE, L.ATTN_SOURCE):
        src = (csrc / f"{source}.cu").read_text()
        for name, params in re.findall(r"^int (tgi_sm90_\w+)\(([^)]*)\)", src, re.MULTILINE):
            params = [p.strip() for p in params.split(",")]
            assert params[-1] == "void* stream", name
            found[name] = params[:-1]
            assert L.source_of(name) == source, name
            if source == L.WIDE_SOURCE:
                wide.add(name)
        assert f"const char* {L.ERROR_STRINGS[source]}(int code)" in src
    assert set(found) == set(L.SIGNATURES) == set(L.ENTRIES.values())
    assert wide == set(L.WIDE_ENTRIES)
    for name, params in found.items():
        want = ["int" if t is ctypes.c_int else "long long" if t is ctypes.c_longlong else "ptr"
                for t in L.SIGNATURES[name]]
        got = ["int" if p.startswith("int ") else "long long" if p.startswith("long long")
               else "ptr" for p in params]
        assert got == want, name


def _views(rows, d, dtype, packing, offset=0, pad=0):
    """The chains' attention views as meta tensors: the slices of a packed
    qkv (``"qkv"``), or q and the slices of a packed kv (``"kv"``); storage
    ``offset`` elements in, rows ``pad`` elements longer than packed."""
    def buf(width):
        base = torch.empty(rows * (width + pad) + offset, dtype=dtype, device="meta")
        return base[offset:].as_strided((rows, width), (width + pad, 1))

    if packing == "qkv":
        qkv = buf(3 * d)
        return qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
    kv = buf(2 * d)
    return buf(d), kv[:, :d], kv[:, d:]


@pytest.mark.parametrize("packing", ["qkv", "kv"])
@pytest.mark.parametrize("d, h", [(256, 2), (512, 4), (256, 4), (32, 4)])
def test_attention_route_sends_the_configs_bf16_views_to_the_registers_form(d, h, packing):
    """Past T 32 the configs' bf16 views (the flagship's d 256 / 2 heads of
    128, the sweeps' 512 / 4, 256 / 4 and 32 / 4: heads of 128, 64 and 8),
    self- and cross-attention, take the registers form at every T of the JAX
    gate (64, 128, 256) and at T 33; up to T 32 the short route."""
    for t in (33, 64, 128, 200, 256):
        assert L.attention_route(*_views(4 * t, d, torch.bfloat16, packing), t, h) == "registers"
    for t in (8, 32):
        assert L.attention_route(*_views(4 * t, d, torch.bfloat16, packing), t, h) == "short"


@pytest.mark.parametrize("case", ["f32", "hd256", "misaligned", "row_stride"])
def test_attention_route_keeps_the_scores_form_for_the_rest(case):
    """f32, a head past REGISTERS_HD, and views TMA cannot read (a base 2
    bytes off a 16-byte multiple, a row stride that is not one) are the
    scores form's by the rule. (In bf16 the kernels take only views whose
    bases and row strides are 16-byte multiples, so on the card such views
    raise at launch in either form.)"""
    t = 128
    if case == "f32":
        views, h = _views(4 * t, 256, torch.float32, "qkv"), 2
    elif case == "hd256":
        views, h = _views(4 * t, 256, torch.bfloat16, "qkv"), 1
    elif case == "misaligned":
        views, h = _views(4 * t, 256, torch.bfloat16, "qkv", offset=1), 2
        assert views[0].data_ptr() % 16 == 2
    else:
        views, h = _views(4 * t, 256, torch.bfloat16, "kv", pad=4), 2
        assert views[1].stride(0) * 2 % 16 == 8
    assert L.attention_route(*views, t, h) == "scores"


def test_attention_scratch_allocates_nothing_for_the_registers_form():
    """The registers form's backward is one launch with no device-memory
    scratch; the scores form's keeps drop(P) and dS of every (sequence,
    head): 2 · sequences · H · T · ⌈T / 8⌉ · 8 values."""
    t, h = 128, 2
    q = torch.zeros(4 * t, 256, dtype=torch.bfloat16)
    assert L.attention_scratch(q, h, t) is None
    assert L.attention_scratch(q, h, t, "registers") is None
    assert L.attention_scratch(q, h, 32) is None  # the short route
    # the scores form: f32, a head of 256, or the form named
    for scratch, heads in ((L.attention_scratch(q.float(), h, t), h),
                           (L.attention_scratch(q, 1, t), 1),
                           (L.attention_scratch(q, h, t, "scores"), h)):
        assert scratch.numel() == 2 * 4 * heads * t * t
    assert L.attention_scratch(torch.zeros(3 * 196, 256), 1, 196).numel() == 2 * 3 * 196 * 200


def test_registers_form_shared_memory_fits_a_block():
    """The registers form's shared memory (``registers_smem_bytes``, the
    layout of csrc/attn_regs_sm90.cuh) stays within the 232,448 bytes a
    block may take at every T past 32 and head up to 128: at T 256 and hd
    128 the forward takes 149,576 bytes and the backward 232,024; at T 128
    two forward blocks fit an SM."""
    limit = 232448
    for t in range(33, L.MAX_T + 1):
        for hd in range(8, L.REGISTERS_HD + 1, 8):
            assert L.registers_smem_bytes(t, hd, False) <= limit
            assert L.registers_smem_bytes(t, hd, True) <= limit
    box = 64 * 128
    red = 2 * 64 * 4  # each warpgroup's 64 rows, f32
    assert L.registers_smem_bytes(256, 128, False) == 18 * box + 8 * 9 + 2 * red + 1024 == 149576
    assert L.registers_smem_bytes(256, 128, True) == 28 * box + 8 * 11 + 3 * red + 1024 == 232024
    assert 2 * L.registers_smem_bytes(128, 128, False) <= 228 * 1024


def test_registers_form_rule_mirrors_the_source():
    """The Python rule's bounds are csrc/attn_regs_sm90.cuh's (kMaxT, kMaxHd),
    and csrc/layer_attn_sm90.cu takes the form where ``regs_form`` says so,
    for both entry points."""
    csrc = Path(L.__file__).parents[1] / "csrc"
    header = (csrc / "attn_regs_sm90.cuh").read_text()
    found = re.search(r"constexpr int kMaxT = (\d+), kMaxHd = (\d+);", header)
    assert (int(found.group(1)), int(found.group(2))) == (L.MAX_T, L.REGISTERS_HD)
    src = (csrc / f"{L.ATTN_SOURCE}.cu").read_text()
    assert "return sizeof(E) == 2 && a.T > kAttnRows && a.T <= regs::kMaxT && " \
           "a.hd <= regs::kMaxHd;" in src
    assert src.count("if (regs_form(a)) return launch_regs_by<") == 2
    assert L.SHORT_T == 32 and "constexpr int kAttnRows = 32;" in src
