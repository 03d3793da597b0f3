"""The port's fused dropout + add + LayerNorm wrapper (ops/fused_ln.py) on the
CPU, where it runs its plain version, against the JAX package's Pallas kernel
under its interpreter and its plain reference (rate 0), its exact-rate word
mask, the Function's hand-written backward against autograd, and the gate."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu.ops.fused_ln import (
    dropout_add_layernorm as jax_dropout_add_layernorm,
    dropout_add_layernorm_reference as jax_reference,
)
from transformergrooveinfilling_tpu_torch.ops import fused_ln as ln

D = 256
SEED = torch.tensor([11], dtype=torch.int32)


def data(n=256, d=D, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return [f(rng.standard_normal((n, d))), f(rng.standard_normal((n, d))),
            f(rng.standard_normal(d) * 0.1 + 1.0), f(rng.standard_normal(d) * 0.1)]


def tensors(arrays, dtype=torch.float32):
    x, y, scale, bias = (torch.from_numpy(a) for a in arrays)
    return [x.to(dtype), y.to(dtype), scale, bias]


def test_forward_rate0_matches_jax_kernel_and_reference():
    arrays = data()
    j = [jnp.asarray(a) for a in arrays]
    kernel = jax_dropout_add_layernorm(*j, jnp.int32(0), 0.0, True)
    ref = jax_reference(*j, jax.random.PRNGKey(0), 0.0)
    for fn in (ln.dropout_add_layernorm_reference, ln.dropout_add_layernorm):
        got = fn(*tensors(arrays), SEED, 0.0).numpy()
        np.testing.assert_allclose(got, np.asarray(kernel), atol=2e-5)
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5)


def test_grads_rate0_match_jax_kernel_and_reference():
    """dx, dy, dscale, dbias of sum(sin(out)), the JAX test's loss and bar."""
    arrays = data(n=128)
    j = [jnp.asarray(a) for a in arrays]
    wants = [
        jax.grad(lambda *a: jnp.sum(jnp.sin(jax_dropout_add_layernorm(
            *a, jnp.int32(0), 0.0, True))), argnums=(0, 1, 2, 3))(*j),
        jax.grad(lambda *a: jnp.sum(jnp.sin(jax_reference(
            *a, jax.random.PRNGKey(0), 0.0))), argnums=(0, 1, 2, 3))(*j)]
    for fn in (ln.dropout_add_layernorm_reference, ln.dropout_add_layernorm):
        leaves = [t.requires_grad_(True) for t in tensors(arrays)]
        torch.sin(fn(*leaves, SEED, 0.0)).sum().backward()
        for want in wants:
            for name, leaf, w in zip(("dx", "dy", "dscale", "dbias"), leaves, want):
                np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=5e-4,
                                           err_msg=f"{fn.__name__} {name}")


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_function_backward_formulas_match_autograd(rate, dtype):
    arrays = data(n=64, seed=2)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((64, D)).astype(np.float32))
    grads = []
    for fn in (ln.dropout_add_layernorm_reference, ln.dropout_add_layernorm):
        leaves = [t.requires_grad_(True) for t in tensors(arrays, dtype)]
        fn(*leaves, SEED, rate).backward(g.to(dtype))
        grads.append([leaf.grad for leaf in leaves])
    for name, a, b in zip(("dx", "dy", "dscale", "dbias"), *grads):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        bar = 1e-5 if dtype == torch.float32 else 2e-2
        assert float((a.float() - b.float()).abs().max()) <= bar * float(a.abs().max()), name


@pytest.mark.parametrize("rate", [0.1, 0.16, 0.4])
def test_mask_keep_rate_is_exact_and_unbiased(rate):
    """The keep rate is 1 − rate itself, not an 8-bit step of it: 0.16 keeps
    0.84, where the byte rule would keep 215/256 = 0.8398."""
    shape = (1024, D)
    keep = ln.dropout_words(SEED, ln.SITE_LN, shape) >= ln.keep_threshold(rate)
    n = keep.numel()
    assert abs(float(keep.float().mean()) - (1 - rate)) < 4 * np.sqrt(rate * (1 - rate) / n)
    scale = ln.keep_scale(SEED, shape, rate)
    assert torch.equal(scale > 0, keep)
    torch.testing.assert_close(scale[keep], torch.full_like(scale[keep], 1 / (1 - rate)))
    assert abs(float(scale.mean()) - 1.0) < 4 * np.sqrt(rate / (1 - rate) / n)


def test_words_are_the_four_of_one_philox_call_and_fill_32_bits():
    from transformergrooveinfilling_tpu_torch.ops.fused_layer import philox4x32

    w = ln.dropout_words(5, 2, (3, 10))
    z = torch.zeros((), dtype=torch.int64)
    for row, col in ((0, 0), (1, 5), (2, 9)):
        call = philox4x32(z + col // 4, z + row, z + 2, z, z + 5, z)
        assert int(w[row, col]) == int(call[col % 4])
    big = ln.dropout_words(5, 2, (64, 64))
    assert int(big.min()) >= 0 and int(big.max()) < 2**32 and int(big.max()) > 2**31
    # leading axes flatten into the row
    assert torch.equal(ln.dropout_words(5, 2, (2, 3, 8)).reshape(6, 8),
                       ln.dropout_words(5, 2, (6, 8)))


def test_mask_is_deterministic_per_seed_and_the_backward_draws_it_again():
    arrays = data(n=32, seed=4)
    runs = []
    for s in (1, 1, 2):
        seed = torch.tensor([s], dtype=torch.int32)
        leaves = [t.requires_grad_(True) for t in tensors(arrays)]
        out = ln.dropout_add_layernorm(*leaves, seed, 0.4)
        out.sum().backward()
        runs.append((out.detach(), leaves[1].grad))
        # dy = dx · keep / (1 − rate): zero exactly where the forward dropped
        torch.testing.assert_close(leaves[1].grad,
                                   leaves[0].grad * ln.keep_scale(seed, (32, D), 0.4))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][0], runs[2][0])


def test_variance_is_two_pass():
    """A common offset of a thousand spreads: the two-pass variance keeps the
    spread that E[a²] − E[a]² loses in f32."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy((100.0 + 0.1 * rng.standard_normal((4, D))).astype(np.float32))
    out = ln.dropout_add_layernorm_reference(x, torch.zeros_like(x), torch.ones(D),
                                             torch.zeros(D), SEED, 0.0)
    want = torch.nn.functional.layer_norm(x.double(), (D,), eps=1e-5).float()
    torch.testing.assert_close(out, want, atol=2e-3, rtol=0)
    mu = x.mean(-1, keepdim=True)
    one_pass = (x - mu) * torch.rsqrt(torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu,
                                                  min=0.0) + 1e-5)
    assert float((one_pass - want).abs().max()) > 2e-2


def test_leading_axes_and_dtype():
    arrays = data(n=64, seed=7)
    x, y, scale, bias = tensors(arrays, torch.bfloat16)
    flat = ln.dropout_add_layernorm(x, y, scale, bias, SEED, 0.1)
    cube = ln.dropout_add_layernorm(x.view(2, 32, D), y.view(2, 32, D), scale, bias, SEED, 0.1)
    assert cube.shape == (2, 32, D) and cube.dtype == torch.bfloat16
    assert torch.equal(cube.reshape(64, D), flat)


@pytest.mark.parametrize("d, dtype, ok", [
    (256, torch.float32, True), (1024, torch.bfloat16, True), (72, torch.float32, True),
    (2420, torch.float32, True), (2424, torch.float32, False), (258, torch.float32, False),
    (256, torch.float16, False)])
def test_gate(d, dtype, ok):
    assert ln.supports_fused_ln(d, dtype) is ok


def test_rows_per_warp_keeps_about_256_blocks():
    assert [ln.rows_per_warp(r) for r in (1, 1024, 4096, 16384, 10**6)] == [1, 1, 2, 8, 8]


def test_cuda_tensors_never_take_the_plain_version():
    args = tensors(data(n=8))
    with pytest.raises(ValueError, match="CUDA device"):
        ln.dropout_add_layernorm(*[a.to("meta") for a in args], SEED.to("meta"), 0.1)
    with pytest.raises(ValueError, match="rate"):
        ln.dropout_add_layernorm(*args, SEED, -0.1)
    assert all(k.launches == 0 for k in ln.KERNELS.values())
