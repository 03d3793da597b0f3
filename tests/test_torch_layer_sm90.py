"""The bf16 whole-layer chains (ops/layer_sm90.py, composed by ops/fused_layer.py
and ops/fused_decoder_layer.py) on the CPU, where every launch runs its plain
version: the chained forward and backward against the JAX package's Pallas
kernels in interpret mode (f32, rate 0) and against autograd through the
port's twins (rate 0.30, two layers stacked), the attention's launches
against autograd with the site-0 mask and causal rows, the LayerNorm
launches against autograd, the fixed-order split reduce, and the bf16 gates.

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
    """The bf16 route's forward and backward chains on CPU tensors."""
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


@pytest.mark.parametrize("d, h, ff", [(256, 2, 512), (128, 2, 256)])
def test_encoder_chain_matches_jax_kernel_forward_and_grads(d, h, ff):
    """The chained plain forward and backward at f32 against JAX
    encoder_layer_train in interpret mode (jax.vjp), B 4 × T 32 rows."""
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


@pytest.mark.parametrize("h", [2, 1])
def test_decoder_chain_matches_jax_kernel_forward_and_grads(h):
    """The decoder's chained plain forward and backward at f32 against JAX
    decoder_layer_train in interpret mode: y3, dx, dmem and 20 grads, d 128,
    ff 128, B 4 × T 32 (the smallest shape the JAX gate takes)."""
    d, ff, t, b = 128, 128, 32, 4
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
@pytest.mark.parametrize("t, n_heads, hd", [(32, 2, 128), (8, 4, 16), (8, 4, 8)])
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
    """bf16: d a multiple of 8 up to 256, ff a multiple of 8, heads dividing
    d into widths that are multiples of 8, T up to 32; f32 keeps the
    shared-memory gate (GrooveXL's d 1024 stays out of both)."""
    bf16 = torch.bfloat16
    for gate in (fl.supports_fused_layer, fdl.supports_fused_decoder_layer):
        assert gate(256, 2, 512, 32, bf16)  # the flagship
        assert gate(256, 2, 2048, 32, bf16)  # InfillingRandomLow_lm's width
        assert gate(8, 1, 8, 1, bf16)
        assert gate(32, 4, 512, 32, bf16)  # the demo width
        assert not gate(264, 2, 512, 32, bf16)  # beyond the LayerNorm epilogue's tile
        assert not gate(1024, 4, 4096, 32, bf16)
        assert not gate(252, 2, 512, 32, bf16)  # d not a multiple of 8
        assert not gate(256, 2, 516, 32, bf16)  # ff not a multiple of 8
        assert not gate(256, 2, 512, 33, bf16)  # T beyond one warp's softmax row
        assert not gate(256, 3, 512, 32, bf16)  # d not divisible by the heads
        assert not gate(32, 8, 512, 32, bf16)  # hd 4: below the attention's 16-byte rows
        assert not gate(96, 8, 512, 32, bf16)  # hd 12
        assert gate(96, 4, 512, 32, bf16)  # hd 24, zero-filled to 32 in the attention
        assert not gate(256, 2, 512, 0, bf16)
        assert gate(256, 2, 512, 32) and not gate(1024, 4, 4096, 32)  # f32


def test_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    d, ff, t = 64, 128, 8
    x, params, dy = encoder_inputs(d, ff, 2 * t)
    args = to_port([x] + params, [i + 1 for i in ENC_WEIGHTS], torch.bfloat16)
    before = {name: f.launches for name, f in {**fl.SM90_KERNELS, **fdl.SM90_KERNELS}.items()}
    encoder_chain(args, torch.from_numpy(dy).to(torch.bfloat16),
                  torch.tensor([2], dtype=torch.int32), 0.3, 2, t)
    dargs, ddy = decoder_inputs(d, ff, 2 * t)
    decoder_chain(to_port(dargs, DEC_WEIGHTS, torch.bfloat16), torch.from_numpy(ddy).to(
        torch.bfloat16), torch.tensor([2], dtype=torch.int32), 0.3, 2, t)
    after = {name: f.launches for name, f in {**fl.SM90_KERNELS, **fdl.SM90_KERNELS}.items()}
    assert after == before
    assert len(fl.SM90_KERNELS) == 13 and len(fdl.SM90_KERNELS) == 21
    assert fl.route_kernels(torch.bfloat16) is fl.SM90_KERNELS
    assert fdl.route_kernels(torch.float32) is fdl.KERNELS


def test_entry_points_declare_every_argument():
    """Each C entry point of csrc/layer_sm90.cu takes what SIGNATURES declares
    for ctypes, and the stream last: a missing argument would shift every
    later one (the card rejects too few; too many it would read as garbage)."""
    src = (Path(L.__file__).parents[1] / "csrc" / "layer_sm90.cu").read_text()
    found = {}
    for name, params in re.findall(r"^int (tgi_sm90_\w+)\(([^)]*)\)", src, re.MULTILINE):
        params = [p.strip() for p in params.split(",")]
        assert params[-1] == "void* stream", name
        found[name] = params[:-1]
    assert set(found) == set(L.SIGNATURES) == set(L.ENTRIES.values())
    for name, params in found.items():
        want = ["int" if t is ctypes.c_int else "long long" if t is ctypes.c_longlong else "ptr"
                for t in L.SIGNATURES[name]]
        got = ["int" if p.startswith("int ") else "long long" if p.startswith("long long")
               else "ptr" for p in params]
        assert got == want, name
