"""The port's fused FFN wrapper (ops/fused_ffn.py) on the CPU, where it runs
its plain version, against the JAX package's Pallas kernels in interpret mode
(rate 0; the resident and the K/F-tiled layout), its dropout mask, the
Function's hand-written backward against autograd, the Hopper gate of both
dtypes, the tile shapes and row splits, and the C entry points against their
ctypes declarations."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu.ops.fused_ffn import (
    ffn_train as jax_ffn_train, fits_resident,
)
from transformergrooveinfilling_tpu_torch.ops import fused_ffn as ffn
from transformergrooveinfilling_tpu_torch.ops.dropout import quantized_keep_rate
from transformergrooveinfilling_tpu_torch.ops.fused_layer import SITE_FFN, dropout_mask

NAMES = ("x", "w1", "b1", "w2", "b2")
# rows, d, ff, weight scale: the shapes of tests/test_fused_ffn.py. The second
# one's 8 MB of f32 weights pass the JAX package's 4 MB limit, so its forward
# is the K/F-tiled kernel
RESIDENT = (64, 128, 256, 0.1)
TILED = (64, 1024, 1024, 0.03)


def operands(rows, d, ff, scale, seed=0):
    """x, w1 (d, ff), b1, w2 (ff, d), b2 in the JAX layout, f32 numpy."""
    rng = np.random.default_rng(seed)
    n = lambda *s, k=1.0: (k * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return [n(rows, d), n(d, ff, k=scale), n(ff, k=0.1), n(ff, d, k=scale), n(d, k=0.1)]


def port_args(ops, dtype=torch.float32):
    """The port's layout: weights (out, in), in ``dtype``; biases f32."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in ops)
    return [x.to(dtype), w1.t().contiguous().to(dtype), b1, w2.t().contiguous().to(dtype), b2]


SEED = torch.tensor([7], dtype=torch.int32)


@pytest.mark.parametrize("shape, atol", [(RESIDENT, 1e-5), (TILED, 2e-4)],
                         ids=["resident", "tiled"])
def test_forward_rate0_matches_jax_kernel(shape, atol):
    ops = operands(*shape)
    assert fits_resident(shape[1], shape[2], 4) == (shape is RESIDENT)
    want = jax_ffn_train(*[jnp.asarray(a) for a in ops], jnp.zeros((1,), jnp.int32), 0.0, True)
    for fn in (ffn.ffn_reference, ffn.ffn_train):
        got = fn(*port_args(ops), SEED, 0.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=atol, atol=atol)


@pytest.mark.parametrize("shape, atol", [(RESIDENT, 2e-4), (TILED, 3e-3)],
                         ids=["resident", "tiled"])
def test_grads_rate0_match_jax_kernel(shape, atol):
    """All five gradients of sum(out²): the plain version under autograd and
    the Function's formulas against jax.grad through the JAX custom VJP."""
    ops = operands(*shape)
    seed = jnp.zeros((1,), jnp.int32)
    want = jax.grad(lambda a: (jax_ffn_train(*a, seed, 0.0, True) ** 2).sum())(
        [jnp.asarray(a) for a in ops])
    want = [np.asarray(g) for g in want]
    want[1], want[3] = want[1].T, want[3].T  # to the port's (out, in) layout
    for fn in (ffn.ffn_reference, ffn.ffn_train):
        leaves = [a.requires_grad_(True) for a in port_args(ops)]
        (fn(*leaves, SEED, 0.0) ** 2).sum().backward()
        for name, leaf, w in zip(NAMES, leaves, want):
            np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=atol, atol=atol,
                                       err_msg=f"{fn.__name__} d{name}")


@pytest.mark.parametrize("rate", [0.0, 0.16, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_function_backward_formulas_match_autograd(rate, dtype):
    """The Function keeps (x, h, w1, w2) only and computes dx, dW1, db1, dW2,
    db2 by the kernels' formulas; autograd of the plain version keeps
    everything. f32 to rounding; bf16 to 2e-2 of the largest gradient (dh and
    the weight gradients are rounded to bf16 by the formulas alone)."""
    ops = operands(*RESIDENT, seed=3)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(ops[0].shape).astype(np.float32))
    grads = []
    for fn in (ffn.ffn_reference, ffn.ffn_train):
        leaves = [a.requires_grad_(True) for a in port_args(ops, dtype)]
        fn(*leaves, SEED, rate).backward(g.to(dtype))
        grads.append([leaf.grad for leaf in leaves])
    for name, a, b in zip(NAMES, *grads):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        bar = 1e-5 if dtype == torch.float32 else 2e-2
        assert float((a.float() - b.float()).abs().max()) <= bar * float(a.abs().max()), name


def test_function_saves_only_x_h_and_the_weights():
    leaves = [a.requires_grad_(True) for a in port_args(operands(*RESIDENT))]
    out = ffn.ffn_train(*leaves, SEED, 0.16)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(64, 128), (64, 256), (256, 128), (128, 256)]


@pytest.mark.parametrize("rate", [0.16, 0.3, 0.47])
def test_mask_keep_rate_is_the_quantised_one_and_unbiased(rate):
    """h > 0 recovers mask and ReLU: with positive pre-activations every kept
    unit is positive. Keep rate within 4 sigma of round(keep·256)/256, kept
    values rescaled by exactly that, so the mean stays 1."""
    rows, d, ff = 256, 8, 512
    x = torch.ones(rows, d)
    w1 = torch.full((ff, d), 1.0 / d)
    args = [x, w1, torch.zeros(ff), torch.eye(d, ff), torch.zeros(d)]
    _, h = ffn.ffn_reference(*args, SEED, rate, return_hidden=True)
    keep = quantized_keep_rate(rate)
    mask = dropout_mask(SEED, SITE_FFN, (rows, ff), rate)
    assert torch.equal(h > 0, mask)
    assert abs(float(mask.float().mean()) - keep) < 4 * np.sqrt(keep * (1 - keep) / mask.numel())
    torch.testing.assert_close(h[mask], torch.full_like(h[mask], 1.0 / keep))
    assert abs(float(h.mean()) - 1.0) < 4 * np.sqrt((1 - keep) / keep / mask.numel())


def test_mask_is_deterministic_per_seed_and_shared_with_the_backward():
    ops = operands(*RESIDENT, seed=5)
    outs = []
    for s in (7, 7, 8):
        leaves = [a.requires_grad_(True) for a in port_args(ops)]
        seed = torch.tensor([s], dtype=torch.int32)
        out = ffn.ffn_train(*leaves, seed, 0.3)
        out.sum().backward()
        outs.append((out.detach(), leaves[0].grad))
        # the backward's mask is the forward's: dx vanishes through dropped units
        _, h = ffn.ffn_reference(*port_args(ops), seed, 0.3, return_hidden=True)
        g = torch.ones_like(out) @ leaves[3].detach()
        dh = torch.where(h > 0, g / quantized_keep_rate(0.3), torch.zeros(()))
        torch.testing.assert_close(leaves[0].grad, dh @ leaves[1].detach(), rtol=1e-5, atol=1e-5)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][0], outs[2][0])


def test_hidden_is_rounded_before_the_second_product():
    """In bf16 the second product reads h as stored (rounded after dropout)."""
    args = port_args(operands(*RESIDENT, seed=6), torch.bfloat16)
    out, h = ffn.ffn_reference(*args, SEED, 0.16, return_hidden=True)
    assert h.dtype == out.dtype == torch.bfloat16
    want = (h.float() @ args[3].float().t() + args[4]).to(torch.bfloat16)
    assert torch.equal(out, want)


def test_relu_flips_take_the_other_side_of_the_kink():
    args = port_args(operands(*RESIDENT, seed=8))
    _, h = ffn.ffn_reference(*args, SEED, 0.0, return_hidden=True)
    flips = torch.zeros_like(h, dtype=torch.bool)
    flips[0, 0] = True
    _, h2 = ffn.ffn_reference(*args, SEED, 0.0, return_hidden=True, relu_flips=flips)
    assert (h[0, 0] > 0) != (h2[0, 0] > 0) and torch.equal(h.flatten()[1:], h2.flatten()[1:])


@pytest.mark.parametrize("d, ff, dtype, ok", [
    (256, 2048, torch.float32, True), (256, 2048, torch.bfloat16, True),
    (1024, 4096, torch.float32, True), (1024, 4096, torch.bfloat16, True),
    (72, 200, torch.float32, True),  # no multiples of 128 are asked for
    (256, 2050, torch.float32, False), (254, 2048, torch.float32, False),
    (1512, 4096, torch.bfloat16, True),  # no (rows, d) tile is kept on chip
    (256, 2048, torch.float16, False),
    (1512, 4096, torch.float32, True),  # nor in f32: d has no cap
    (1020, 4096, torch.float32, True), (1020, 4096, torch.bfloat16, False),  # TMA: d % 8
    (256, 2052, torch.bfloat16, False), (8, 8, torch.bfloat16, True)])
def test_gate(d, ff, dtype, ok):
    assert ffn.supports_fused_ffn(d, ff, dtype) is ok


@pytest.mark.parametrize("d, ff, ok", [
    (4, 4, True), (36, 100, True), (1020, 4100, True), (8192, 32768, True),
    (2, 4, False), (4, 2, False), (6, 8, False), (8, 6, False), (1022, 4096, False),
    (1024, 4098, False), (0, 0, False)])
def test_f32_gate_takes_16_byte_rows_at_any_width(d, ff, ok):
    """The f32 route's products read every operand through TMA, whose row
    strides are whole 16 bytes: d and ff multiples of 4, and nothing else, no
    cap on d (no (rows, d) accumulator on chip). bf16 asks multiples of 8."""
    assert ffn.supports_fused_ffn(d, ff, torch.float32) is ok
    assert ffn.supports_fused_ffn(d, ff, torch.bfloat16) is (ok and d % 8 == 0 and ff % 8 == 0)


SHAPES = ((1024, 256, 2048), (16384, 256, 2048), (4096, 1024, 4096))  # chip_smoke.FFN_SHAPES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wgrad_splits_cover_the_rows_in_whole_chunks(dtype):
    """Splits of whole 64-row chunks (one bf16 stage, two f32 stages) that
    cover the rows, none empty, where the tiles of dW1 and dW2 are fewer than
    the SMs, at every tile shape the dtype's weight launch is built for and
    at the one tile_configs picks."""
    for rows, d, ff in SHAPES + ((100, 72, 200), (100, 36, 100)):
        picked = ffn.tile_configs(rows, d, ff, 132, dtype)[4]
        for config in (picked, *ffn.PRODUCT_TILES[dtype][4]):
            splits, per = ffn.wgrad_splits(rows, d, ff, 132, config)
            assert per % ffn.K_STAGE == 0 and (splits - 1) * per < rows <= splits * per
            assert splits == 1 or per >= ffn.WGRAD_MIN_STAGES * ffn.K_STAGE
            tm, tn = ffn.TILES[config]
            tiles = -(-ff // tm) * -(-d // tn) + -(-d // tm) * -(-ff // tn)
            assert splits == 1 or splits * tiles <= 132  # split only to fill the card
    assert ffn.wgrad_splits(4096, 1024, 4096, 132) == (1, 4096)  # 256 tiles of 128 × 256
    assert ffn.wgrad_splits(16384, 256, 2048, 132) == (2, 8192)  # 64 of 128 × 128
    assert ffn.wgrad_splits(1024, 256, 2048, 132) == (2, 512)
    assert ffn.wgrad_splits(100, 72, 200, 132) == (1, 128)
    assert ffn.wgrad_splits(16384, 256, 2048, 132, 2) == (4, 4096)  # 32 of 128 × 256


def test_tile_configs_follow_the_measured_choice():
    """64 × 64 where 128 × 128 tiles leave SMs idle; 128 × 256 for dh·W1 and
    for weight gradients whose tiles fill the card; 128 × 128 otherwise."""
    assert ffn.tile_configs(1024, 256, 2048, 132) == (1, 0, 1, 0, 1)
    assert ffn.tile_configs(16384, 256, 2048, 132) == (1, 1, 1, 2, 1)
    assert ffn.tile_configs(4096, 1024, 4096, 132) == (1, 1, 1, 2, 2)
    assert ffn.tile_configs(100, 72, 200, 132) == (0, 0, 0, 0, 1)
    assert ffn.TILES == {0: (64, 64), 1: (128, 128), 2: (128, 256)}


def test_f32_tile_configs_follow_the_measured_choice():
    """f32 has no 128 × 256 tile: the bf16 choice with 128 × 128 in its
    place (dh·W1 and the weight gradients)."""
    f32 = torch.float32
    assert ffn.tile_configs(1024, 256, 2048, 132, f32) == (1, 0, 1, 0, 1)
    assert ffn.tile_configs(16384, 256, 2048, 132, f32) == (1, 1, 1, 1, 1)
    assert ffn.tile_configs(4096, 1024, 4096, 132, f32) == (1, 1, 1, 1, 1)
    assert ffn.tile_configs(100, 72, 200, 132, f32) == (0, 0, 0, 0, 1)
    assert ffn.wgrad_splits(16384, 256, 2048, 132, 1) == (2, 8192)


@pytest.mark.parametrize("rows", [1, 100, 1024, 4096, 16384, 65536])
@pytest.mark.parametrize("d, ff", [(8, 8), (72, 200), (256, 2048), (1024, 4096), (4096, 16384)])
def test_tile_configs_pick_only_the_shapes_that_are_built(rows, d, ff):
    """csrc/fused_ffn.cu builds each product for its two shapes of
    ``PRODUCT_TILES`` for each dtype only (another config launches nothing;
    f32 never 128 × 256, gemm_sm90.cuh's static_assert), so every pick of
    ``tile_configs`` must be one of them, on this card's 132 SMs and others."""
    assert set(ffn.PRODUCT_TILES) == {torch.bfloat16, torch.float32}
    for dtype, built in ffn.PRODUCT_TILES.items():
        assert all(set(shapes) <= set(ffn.TILES) and len(set(shapes)) == 2 for shapes in built)
        assert dtype == torch.bfloat16 or not any(2 in shapes for shapes in built)
        for sms in (78, 114, 132):
            picked = ffn.tile_configs(rows, d, ff, sms, dtype)
            assert len(picked) == len(built)
            assert all(c in shapes for c, shapes in zip(picked, built)), (picked, sms, dtype)


def test_entry_points_declare_every_argument():
    """Each C entry point of csrc/fused_ffn.cu takes what SIGNATURES declares
    for ctypes, and the stream last (a missing argument would shift every
    later one); each counter launches one of them, both dtypes every one."""
    src = (Path(ffn.__file__).parents[1] / "csrc" / "fused_ffn.cu").read_text()
    kinds = {ctypes.c_void_p: "void*", ctypes.c_int: "int"}
    found = {}
    for name, params in re.findall(r"^int (tgi_ffn_\w+)\(([^)]*)\)", src, re.MULTILINE):
        params = [" ".join(p.split()) for p in params.split(",")]
        assert params[-1] == "void* stream", name
        found[name] = [p.rsplit(" ", 1)[0] for p in params[:-1]]
    assert set(found) == set(ffn.SIGNATURES)
    for kernels in (ffn.BF16_KERNELS, ffn.F32_KERNELS):
        assert {k.entry for k in kernels.values()} == set(ffn.SIGNATURES)
    for name, params in found.items():
        assert params == [kinds[t] for t in ffn.SIGNATURES[name]], name
        # the five products take the dtype flag last
        assert name == "tgi_ffn_reduce" or re.search(rf"{name}\([^)]*int f32, void\* stream\)",
                                                     " ".join(src.split()))
    assert ffn.route_kernels(torch.float32)["fwd_h"] is ffn.KERNELS["fused_ffn_fwd_h_f32"]
    assert ffn.route_kernels(torch.bfloat16)["reduce"] is ffn.KERNELS["fused_ffn_reduce"]


def test_cuda_tensors_never_take_the_plain_version():
    """A wrapper given a tensor that is not on the CPU launches or raises."""
    args = port_args(operands(*RESIDENT))
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="CUDA device"):
        ffn.ffn_train(*meta, SEED.to("meta"), 0.1)
    with pytest.raises(ValueError, match="rate"):
        ffn.ffn_train(*args, SEED, 1.0)
    assert all(k.launches == 0 for k in ffn.KERNELS.values())
