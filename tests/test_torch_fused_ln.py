"""The port's fused dropout + add + LayerNorm wrapper (ops/fused_ln.py) on the
CPU, where it runs its plain version, against the JAX package's Pallas kernel
under its interpreter and its plain reference (rate 0), its exact-rate word
mask, the Function's hand-written backward against autograd, the gate, the
grid and lane layout choosers, and each C entry point against its ctypes
declaration."""

import ctypes
import re
from pathlib import Path

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
from transformergrooveinfilling_tpu_torch.ops.fused_layer import MAX_SMEM_BYTES

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
    (2420, torch.float32, False), (2424, torch.float32, False), (258, torch.float32, False),
    (256, torch.float16, False), (2048, torch.float32, False), (2048, torch.bfloat16, True),
    (2056, torch.bfloat16, False), (1024, torch.float32, True), (1028, torch.float32, False),
    (1020, torch.bfloat16, True), (1028, torch.bfloat16, False), (72, torch.bfloat16, True),
    (20, torch.bfloat16, True), (16, torch.float32, True), (4, torch.bfloat16, True),
    (0, torch.float32, False)])
def test_gate(d, dtype, ok):
    """d a multiple of 4, at most 8 chunks a lane: up to 2,048 in bf16 with
    chunks of 8, else up to 1,024; a bf16 width that is no multiple of 8 (20,
    1,020) takes the 8-byte chunks, not a refusal."""
    assert ln.supports_fused_ln(d, dtype) is ok


@pytest.mark.parametrize("d, dtype, width, values", [
    (256, torch.bfloat16, 8, 8), (1024, torch.bfloat16, 8, 32), (256, torch.float32, 4, 8),
    (1024, torch.float32, 4, 32), (72, torch.float32, 4, 4), (72, torch.bfloat16, 8, 8),
    (20, torch.bfloat16, 4, 4), (512, torch.bfloat16, 8, 16), (2048, torch.bfloat16, 8, 64),
    (1020, torch.bfloat16, 4, 32)])
def test_lane_layout_mirrors_the_kernels_instances(d, dtype, width, values):
    """A lane's chunk and its values of a row (chunks rounded up to a power of
    2, as csrc/fused_ln.cu's NC, at most 8), which size the backward's shared
    memory."""
    assert ln.chunk_width(d, dtype) == width and ln.lane_values(d, dtype) == values
    per_lane = values // width  # chunks a lane, a power of 2
    assert per_lane & (per_lane - 1) == 0 and per_lane <= ln.MAX_CHUNKS
    assert (per_lane // 2) * width * 32 < d <= values * 32
    assert ln.bwd_smem_bytes(d, dtype) == 4 * 2 * ln.bwd_warps(d, dtype) * 32 * values
    assert ln.bwd_smem_bytes(d, dtype) <= MAX_SMEM_BYTES


@pytest.mark.parametrize("rows", [1, 7, 8, 9, 1024, 2112, 4096, 16384, 10**6])
@pytest.mark.parametrize("d, dtype, bwd_warps", [(256, torch.bfloat16, 24),
                                                 (1024, torch.bfloat16, 16),
                                                 (2048, torch.bfloat16, 8),
                                                 (72, torch.float32, 24)])
def test_grid_is_one_wave_that_gives_every_warp_rows(rows, d, dtype, bwd_warps):
    """One wave: the forward 2 blocks of 8 warps an SM, the backward one block
    an SM of 24 warps (rows of up to 16 values a lane), 16 (up to 32) or 8;
    no warp without a row where the rows are fewer than the warps."""
    sms = 132
    assert ln.bwd_warps(d, dtype) == bwd_warps
    for backward, per_block, cap in ((False, ln.WARPS, 2 * sms), (True, bwd_warps, sms)):
        blocks = ln.ln_grid(rows, d, dtype, sms, backward)
        warps = blocks * per_block
        assert 1 <= blocks <= cap
        assert blocks == cap or warps >= rows > warps - per_block
        # the kernels' equal, contiguous shares: every row once, within one row
        shares = [(w + 1) * rows // warps - w * rows // warps for w in range(warps)]
        assert sum(shares) == rows and max(shares) - min(shares) <= 1


@pytest.mark.parametrize("blocks", [1, 2, 16, 17, 64, 132, 256, 257, 264, 4096])
def test_ticket_tree_adds_every_partial_up_to_one_root(blocks):
    tree = ln.ticket_tree(blocks)
    assert (tree == []) == (blocks == 1)
    below = blocks
    for nodes in tree:
        assert nodes == -(-below // ln.FAN_IN)  # each node takes 16 below it, the last the rest
        below = nodes
    assert below == 1 and sum(tree) <= ln.TICKETS
    assert ln.ticket_tree(132) == [9, 1]  # an H100's one block an SM: 2 levels


def test_entry_points_declare_every_argument():
    """Each C entry point of csrc/fused_ln.cu takes what SIGNATURES declares
    for ctypes, and the stream last: a missing argument would shift every
    later one."""
    src = (Path(ln.__file__).parents[1] / "csrc" / "fused_ln.cu").read_text()
    kinds = {ctypes.c_void_p: "void*", ctypes.c_int: "int", ctypes.c_uint: "unsigned int",
             ctypes.c_float: "float"}
    found = {}
    for name, params in re.findall(r"^int (tgi_ln_\w+)\(([^)]*)\)", src, re.MULTILINE):
        params = [" ".join(p.split()) for p in params.split(",")]
        assert params[-1] == "void* stream", name
        found[name] = [p.rsplit(" ", 1)[0] for p in params[:-1]]
    assert set(found) == set(ln.SIGNATURES) == {k.entry for k in ln.KERNELS.values()}
    for name, params in found.items():
        assert params == [kinds[t] for t in ln.SIGNATURES[name]], name


def test_cuda_tensors_never_take_the_plain_version():
    args = tensors(data(n=8))
    with pytest.raises(ValueError, match="CUDA device"):
        ln.dropout_add_layernorm(*[a.to("meta") for a in args], SEED.to("meta"), 0.1)
    with pytest.raises(ValueError, match="rate"):
        ln.dropout_add_layernorm(*args, SEED, -0.1)
    assert all(k.launches == 0 for k in ln.KERNELS.values())
