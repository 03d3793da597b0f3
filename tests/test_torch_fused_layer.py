"""The port's whole-encoder-layer kernel wrapper (ops/fused_layer.py) on the CPU,
where it runs its plain twin, against the JAX package's Pallas kernel in
interpret mode (rate 0), and against the port's own unfused layer fed the
same dropout masks (rate 0.30). Also the kernels' counter-based mask
generator and the Hopper shape gate of the layer chains."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu.ops import fused_layer as jax_fused_layer
from transformergrooveinfilling_tpu.ops.fused_layer import (
    encoder_layer_train as jax_encoder_layer_train,
)
from transformergrooveinfilling_tpu_torch.models import transformer
from transformergrooveinfilling_tpu_torch.models.transformer import (
    EncoderLayer, GrooveTransformerConfig,
)
from transformergrooveinfilling_tpu_torch.ops import fused_layer as fl
from transformergrooveinfilling_tpu_torch.ops.dropout import quantized_threshold

PARAM_NAMES = ("wqkv", "bqkv", "wo", "bo", "g1", "b1", "w1", "b1f", "w2", "b2f", "g2", "b2")


def layer_inputs(d, ff, rows, seed=0):
    """x and the 12 layer parameters (JAX layout), f32 numpy, from a seed."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(shape)).astype(np.float32)

    x = n(rows, d)
    params = [n(d, 3 * d, scale=d ** -0.5), n(3 * d, scale=0.1),
              n(d, d, scale=d ** -0.5), n(d, scale=0.1),
              n(d, scale=0.1, offset=1.0), n(d, scale=0.1),
              n(d, ff, scale=d ** -0.5), n(ff, scale=0.1),
              n(ff, d, scale=ff ** -0.5), n(d, scale=0.1),
              n(d, scale=0.1, offset=1.0), n(d, scale=0.1)]
    return x, params, n(rows, d)


WEIGHTS = (0, 2, 6, 8)  # wqkv, wo, w1, w2 among PARAM_NAMES


def port_layout(params):
    """JAX (in, out) weights → the port's nn.Linear (out, in) layout."""
    return [np.ascontiguousarray(p.T) if i in WEIGHTS else p for i, p in enumerate(params)]


def kink_sided(layer, reference, h_at, leaves, seed, n_heads, t, jax_h):
    """``layer`` (the wrapper, which runs its twin on CPU tensors), or where
    the JAX kernel's ReLU decisions (from its hidden ``jax_h``) differ from
    the twin's, the twin taking the JAX kernel's side at those units. A unit
    within rounding of 0 lands on either side of the kink by the order of its
    sum (at d 2,048 one unit's input is 0.0 in the twin), and the gradient
    through it is then all or nothing; ``fl.kink_flips`` raises unless every
    such unit is within ``KINK_BAND`` of max|h| (f32: 1e-5) and they are at
    most ``KINK_SHARE`` of the units plus 4, as ``chip_smoke.py`` holds the
    card's chains to the twin."""
    with torch.no_grad():
        own_h = reference(*[a.detach() for a in leaves], torch.from_numpy(seed), 0.0, n_heads,
                          t, return_residuals=True)[h_at]
    flips, _ = fl.kink_flips(own_h, torch.from_numpy(np.array(jax_h)))
    if not flips.any():
        return layer
    return lambda *a: reference(*a, relu_flips=flips)


def _t(*cases):
    """(d, h, ff, T) cases, those at T 32 under their former (d, h, ff) ids."""
    return [pytest.param(*c, id="-".join(map(str, c[:3]))) if c[3] == 32 else c for c in cases]


@pytest.mark.parametrize("d, h, ff, t", _t((256, 2, 512, 32), (128, 2, 256, 32),
                                           (512, 4, 1024, 32), (512, 1, 512, 32),
                                           (1024, 1, 1024, 32), (2048, 2, 1024, 32),
                                           (128, 2, 256, 64), (128, 2, 256, 128),
                                           (128, 2, 256, 256), (128, 1, 256, 64),
                                           (128, 1, 256, 128), (128, 1, 256, 256)))
def test_rate0_matches_jax_kernel_forward_and_grads(d, h, ff, t):
    """y, dx and all 12 parameter grads at f32 against JAX encoder_layer_train
    in interpret mode (jax.vjp), 256 rows (B 8 × T 32); hd 128 and hd 64, and
    past d 256 (the chain's wide route on the card) hd 128, 512 and 1,024,
    and d 2,048 (the row passes a block a row on the card); and the longer
    loops the JAX gate takes, T 64, 128 and 256 (B 4, 2, 1: 4- to 16-bar
    loops; the attention's long route on the card) at d 128, two heads of 64
    and one of 128."""
    b = 256 // t
    x, params, dy = layer_inputs(d, ff, b * t)
    seed = np.zeros((1,), np.int32)

    def jax_layer(x, *p):
        return jax_encoder_layer_train(x, *p, jnp.asarray(seed), 0.0, h, t, True)

    y_jax, vjp = jax.vjp(jax_layer, jnp.asarray(x), *map(jnp.asarray, params))
    grads_jax = vjp(jnp.asarray(dy))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in [x] + port_layout(params)]
    layer = kink_sided(fl.encoder_layer_train, fl.encoder_layer_reference, 3, leaves, seed, h, t,
                       jax_fused_layer._fwd_call(jnp.asarray(x), *map(jnp.asarray, params),
                                                 jnp.asarray(seed), rate=0.0, n_heads=h,
                                                 seq_len=t, interpret=True)[3])
    y = layer(*leaves, torch.from_numpy(seed), 0.0, h, t)
    y.backward(torch.from_numpy(dy))
    # the JAX package's own bars (tests/test_fused_layer.py)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax), rtol=2e-4, atol=2e-4)
    grads = [leaves[0].grad.numpy()] + port_layout([leaf.grad.numpy() for leaf in leaves[1:]])
    for name, g_port, g in zip(("dx",) + PARAM_NAMES, grads, grads_jax):
        np.testing.assert_allclose(g_port, np.asarray(g), rtol=5e-3, atol=5e-4, err_msg=name)


def _same_mask_dropout(seed, rate):
    """A stand-in for the model's dropout sites that draws the fused layer's
    masks: the unfused layer calls its sites in the kernel's site order
    (attention probabilities, projection, FFN hidden, FFN output)."""
    calls = []

    def drop(x, generator, r, fast=True):
        site = len(calls)
        calls.append(tuple(x.shape))
        shape = x.shape if site else (x.shape[0] * x.shape[1],) + tuple(x.shape[2:])
        keep = fl.dropout_mask(seed, site, shape, rate).reshape(x.shape)
        return torch.where(keep, x / (quantized_threshold(rate) / 256.0), torch.zeros(()))

    return drop, calls


def test_rate030_sites_match_the_unfused_layer(monkeypatch):
    """At rate 0.30 the fused layer (the twin, through the model's dispatch)
    equals the port's unfused layer when both draw the same masks: the four
    sites sit where the TPU kernel puts them."""
    cfg = GrooveTransformerConfig(d_model=64, n_heads=2, dim_feedforward=128,
                                  dropout=0.3, num_encoder_layers=1)
    rng = np.random.default_rng(3)
    fused = EncoderLayer(dataclasses.replace(cfg, fused_layer=True)).train()
    transformer.init_parameters(fused, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in fused.parameters():
            p.add_(0.1 * torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    plain = EncoderLayer(cfg).train()
    plain.load_state_dict(fused.state_dict())
    x = torch.from_numpy(rng.standard_normal((3, 32, 64)).astype(np.float32))

    y_fused = fused(x, torch.Generator().manual_seed(5))
    seed = torch.randint(0, 2**31 - 1, (1,), generator=torch.Generator().manual_seed(5),
                         dtype=torch.int32)
    drop, calls = _same_mask_dropout(seed, 0.3)
    monkeypatch.setattr(transformer, "drop_site", drop)
    y_plain = plain(x, torch.Generator().manual_seed(5))
    assert calls == [(3, 2, 32, 32), (3, 32, 64), (3, 32, 128), (3, 32, 64)]
    torch.testing.assert_close(y_fused, y_plain, atol=1e-5, rtol=1e-5)
    assert (y_fused != 0).all()
    w = torch.from_numpy(rng.standard_normal(y_fused.shape).astype(np.float32))
    (y_fused * w).sum().backward()
    (y_plain * w).sum().backward()
    for (name, pf), pp in zip(fused.named_parameters(), plain.parameters()):
        torch.testing.assert_close(pf.grad, pp.grad, atol=1e-5, rtol=1e-4, msg=name)


def test_philox_known_answers():
    """Philox4x32-10 on int64 halves against Random123's published vectors."""
    zero = torch.zeros((), dtype=torch.int64)
    got = [int(w) for w in fl.philox4x32(zero, zero, zero, zero, zero, zero)]
    assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    ones = torch.full((), 0xFFFFFFFF, dtype=torch.int64)
    got = [int(w) for w in fl.philox4x32(ones, ones, ones, ones, ones, ones)]
    assert got == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.75])
def test_mask_keep_share_and_determinism(rate):
    shape = (96, 32, 48)
    mask = fl.dropout_mask(torch.tensor([11], dtype=torch.int32), 2, shape, rate)
    n = mask.numel()
    p = quantized_threshold(rate) / 256.0
    assert abs(float(mask.float().mean()) - p) <= 4 * np.sqrt(p * (1 - p) / n)
    again = fl.dropout_mask(11, 2, shape, rate)
    assert torch.equal(mask, again)
    for other in (fl.dropout_mask(12, 2, shape, rate), fl.dropout_mask(11, 3, shape, rate)):
        assert not torch.equal(mask, other)
    # a mask does not depend on how rows are grouped: (rows, cols) is (rows, cols)
    flat = fl.dropout_mask(11, 2, (96 * 32, 48), rate)
    assert torch.equal(flat.reshape(shape), mask)


def test_bytes_are_uniform():
    b = fl.dropout_bytes(5, 0, (4096, 64))
    counts = torch.bincount(b.flatten(), minlength=256).float()
    assert b.min() >= 0 and b.max() <= 255
    expected = b.numel() / 256
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 400  # 255 degrees of freedom: mean 255, sd 22.6


def test_gate():
    for dtype in (torch.float32, torch.bfloat16):
        assert fl.supports_fused_layer(256, 2, 512, 32, dtype)  # the flagship
        assert fl.supports_fused_layer(32, 4, 512, 32, dtype)  # the demo width
    assert fl.supports_fused_layer(32, 16, 512, 32)  # hd 2: the f32 attention takes any width
    assert fl.supports_fused_layer(256, 2, 512, 33)  # past T 32: the attention's long route
    assert fl.supports_fused_layer(256, 2, 512, 256)  # a 16-bar loop
    assert not fl.supports_fused_layer(256, 2, 512, 257)  # T past layer_sm90.MAX_T
    assert not fl.supports_fused_layer(256, 2, 512, 32, torch.float16)
    assert not fl.supports_fused_layer(256, 3, 512, 32)  # d not divisible by H
    assert fl.supports_fused_layer(1032, 3, 1024, 32)  # past d 1,024: a block a row
    assert fl.supports_fused_layer(1024, 1, 1024, 32, torch.bfloat16)  # hd 1,024: streamed
    assert fl.supports_fused_layer(8192, 1, 1024, 32)  # the row passes' widest row
    assert not fl.supports_fused_layer(8200, 1, 1024, 32, torch.bfloat16)  # past MAX_D
    assert fl.supports_fused_layer(1024, 4, 4096, 32, torch.bfloat16)  # GrooveXL, forced bf16
    assert not fl.supports_fused_layer(1024, 4, 4096, 32)  # f32: ff past F32_MAX_FF
    assert not fl.supports_fused_layer(30, 2, 64, 32)  # d not a multiple of 8


def test_forced_fused_layer_the_gate_rejects_raises():
    cfg = GrooveTransformerConfig(d_model=30, n_heads=2, dim_feedforward=64,
                                  dropout=0.0, num_encoder_layers=1, fused_layer=True)
    layer = EncoderLayer(cfg).train()
    with pytest.raises(ValueError, match="supports_fused_layer"):
        layer(torch.zeros(1, 32, 30), torch.Generator())


def test_cpu_tensors_run_the_twin():
    x, params, _ = layer_inputs(32, 64, 64, seed=1)
    args = ([torch.from_numpy(a) for a in [x] + port_layout(params)]
            + [torch.tensor([3], dtype=torch.int32)])
    every = {**fl.SM90_KERNELS, **fl.SM90_F32_KERNELS}
    before = {k: f.launches for k, f in every.items()}
    y = fl.encoder_layer_train(*args, 0.3, 2, 32)
    torch.testing.assert_close(y, fl.encoder_layer_reference(*args, 0.3, 2, 32), rtol=0, atol=0)
    assert {k: f.launches for k, f in every.items()} == before


def _twin_h(seed=2, rate=0.0):
    x, params, _ = layer_inputs(32, 64, 64, seed=seed)
    args = ([torch.from_numpy(a) for a in [x] + port_layout(params)]
            + [torch.tensor([3], dtype=torch.int32)])
    return args, fl.encoder_layer_reference(*args, rate, 2, 32, return_residuals=True)[3]


def test_kink_flips_takes_only_units_at_the_kink():
    """kink_flips passes sign disagreements within rounding of 0, and the
    twin given them takes the other side there and its own side elsewhere."""
    args, h = _twin_h()
    flips, stats = fl.kink_flips(h, h)
    assert stats["flips"] == 0 and not flips.any()
    kernel_h = h.clone()
    r, c = (h > 0).nonzero()[0]
    kernel_h[r, c] = 0.0  # a positive unit the "kernel" put just below the kink
    tiny = h.clone()
    tiny[r, c] = 1e-7 * float(h.max())
    flips, stats = fl.kink_flips(tiny, kernel_h)
    assert stats["flips"] == 1 and bool(flips[r, c])
    none = torch.zeros_like(flips)
    y0 = fl.encoder_layer_reference(*args, 0.0, 2, 32, return_residuals=True, relu_flips=none)
    assert torch.equal(y0[3], h)
    y1 = fl.encoder_layer_reference(*args, 0.0, 2, 32, return_residuals=True, relu_flips=flips)
    assert y1[3][r, c] == 0 and torch.equal(y1[3][~flips], h[~flips])


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_kink_flips_fails_a_kernel_that_zeroes_units(rate):
    """A kernel that zeroes hidden units away from the kink (a bounds bug in
    one tile, or a stray FFN dropout) is refused, however few."""
    _, h = _twin_h(rate=rate)
    tile = h.clone()
    tile[:8, :16] = 0.0
    with pytest.raises(ValueError, match="beyond rounding"):
        fl.kink_flips(h, tile)
    stray = torch.where(fl.dropout_mask(9, fl.SITE_FFN, h.shape, 0.3), h, torch.zeros(()))
    with pytest.raises(ValueError, match="beyond rounding"):
        fl.kink_flips(h, stray)
    # many disagreements, each within rounding of 0, are refused too
    idx = (h > 0).nonzero()[:10]
    near = h.clone()
    near[idx[:, 0], idx[:, 1]] = 1e-7 * float(h.max())
    zeroed = near.clone()
    zeroed[idx[:, 0], idx[:, 1]] = 0.0
    with pytest.raises(ValueError, match="beyond rounding"):
        fl.kink_flips(near, zeroed)
    assert fl.kink_flips(near, near)[1]["flips"] == 0
