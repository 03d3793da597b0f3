"""The port's whole-decoder-layer kernel wrapper (ops/fused_decoder_layer.py) on
the CPU, where it runs its plain twin: against the JAX package's Pallas kernel
in interpret mode (rate 0), against the port's own unfused decoder layer fed
the same dropout masks (rate 0.30), the autograd Function's bookkeeping with
the launchers replaced by the twin, and the Hopper shape gate."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu.ops import fused_decoder_layer as jax_fused_decoder_layer
from transformergrooveinfilling_tpu.ops.fused_decoder_layer import (
    decoder_layer_train as jax_decoder_layer_train,
)
from transformergrooveinfilling_tpu_torch.models import transformer
from transformergrooveinfilling_tpu_torch.models.transformer import (
    DecoderLayer, GrooveTransformerConfig,
)
from transformergrooveinfilling_tpu_torch.ops import fused_decoder_layer as fdl
from transformergrooveinfilling_tpu_torch.ops import fused_layer as fl
from transformergrooveinfilling_tpu_torch.ops.dropout import quantized_threshold
from test_torch_fused_layer import kink_sided

WEIGHTS = [fdl.ARG_NAMES.index(n) for n in fdl.WEIGHT_NAMES]


def layer_inputs(d, ff, rows, seed=0):
    """y, mem and the 20 layer parameters in ``fdl.ARG_NAMES`` order with the
    weights in the JAX (in, out) layout, f32 numpy, from a seed; and dy."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(shape)).astype(np.float32)

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


def port_layout(args):
    """JAX (in, out) weights → the port's nn.Linear (out, in) layout."""
    return [np.ascontiguousarray(a.T) if i in WEIGHTS else a for i, a in enumerate(args)]


def port_tensors(d=32, ff=64, rows=64, seed=1):
    args, dy = layer_inputs(d, ff, rows, seed)
    return [torch.from_numpy(a) for a in port_layout(args)], torch.from_numpy(dy)


SEED = torch.tensor([3], dtype=torch.int32)


def _t(*cases):
    """(d, h, ff, b, T) cases, those at T 32 under their former ids."""
    return [c if c[4] != 32 else pytest.param(*c, id=str(c[1])) if c[0] == 128
            else pytest.param(*c, id="-".join(map(str, c[:4]))) for c in cases]


@pytest.mark.parametrize("d, h, ff, b, t", _t((128, 2, 128, 4, 32), (128, 1, 128, 4, 32),
                                              (512, 4, 1024, 8, 32), (512, 1, 512, 8, 32),
                                              (1024, 1, 1024, 8, 32), (2048, 2, 1024, 8, 32),
                                              (128, 2, 128, 2, 64), (128, 2, 128, 1, 128),
                                              (128, 2, 128, 1, 256), (128, 1, 128, 2, 64),
                                              (128, 1, 128, 1, 128), (128, 1, 128, 1, 256)))
def test_rate0_matches_jax_kernel_forward_and_grads(d, h, ff, b, t):
    """y3, dx, dmem and all 20 parameter grads at f32 against JAX
    decoder_layer_train in interpret mode (jax.vjp), at the smallest shape the
    JAX gate takes: d 128 (2 heads of 64, lane-packed there, and 1 head of
    128), ff 128, B 4 × T 32 rows; and past d 256 (the chain's wide route on
    the card) d 512 with 4 heads / ff 1,024 and 1 head of 512 / ff 512, d
    1,024 with one head of 1,024 and d 2,048 with 2 (the row passes a block a
    row on the card), ff 1,024, B 8 × T 32; and the longer loops the JAX gate
    takes at d 128, T 64, 128 and 256 (the attention's long route on the
    card: causal self-attention and cross-attention over T 256)."""
    args, dy = layer_inputs(d, ff, b * t)
    seed = np.zeros((1,), np.int32)

    def jax_layer(*a):
        return jax_decoder_layer_train(*a, jnp.asarray(seed), 0.0, h, t, True)

    y_jax, vjp = jax.vjp(jax_layer, *map(jnp.asarray, args))
    grads_jax = vjp(jnp.asarray(dy))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in port_layout(args)]
    layer = kink_sided(fdl.decoder_layer_train, fdl.decoder_layer_reference, 6, leaves, seed, h,
                       t, jax_fused_decoder_layer._fwd_call(
                           *map(jnp.asarray, args), jnp.asarray(seed), rate=0.0, n_heads=h,
                           seq_len=t, interpret=True)[6])
    y = layer(*leaves, torch.from_numpy(seed), 0.0, h, t)
    y.backward(torch.from_numpy(dy))
    # the JAX package's own bars (tests/test_fused_decoder_layer.py)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax), rtol=2e-4, atol=2e-4)
    grads = port_layout([leaf.grad.numpy() for leaf in leaves])
    assert len(grads) == len(grads_jax) == 22
    for name, g_port, g in zip(("dx", "dmem") + fdl.ARG_NAMES[2:], grads, grads_jax):
        np.testing.assert_allclose(g_port, np.asarray(g), rtol=5e-3, atol=5e-4, err_msg=name)


def _same_mask_dropout(seed, rate):
    """A stand-in for the model's dropout sites that draws the fused decoder
    layer's masks: the unfused layer reaches its sites in the kernel's site
    order (self probabilities, projection, cross probabilities, projection,
    FFN hidden, FFN output)."""
    calls = []

    def drop(x, generator, r, fast=True):
        site = len(calls)
        calls.append(tuple(x.shape))
        keep = fl.dropout_mask(seed, site, tuple(x.shape), rate)
        return torch.where(keep, x / (quantized_threshold(rate) / 256.0), torch.zeros(()))

    return drop, calls


def _layers(rng, **cfg_kw):
    cfg = GrooveTransformerConfig(d_model=64, n_heads=2, dim_feedforward=128,
                                  num_encoder_layers=1, num_decoder_layers=1, **cfg_kw)
    fused = DecoderLayer(dataclasses.replace(cfg, fused_decoder_layer=True)).train()
    transformer.init_parameters(fused, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in fused.parameters():
            p.add_(0.1 * torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    plain = DecoderLayer(cfg).train()
    plain.load_state_dict(fused.state_dict())
    return fused, plain


def test_rate030_sites_match_the_unfused_layer(monkeypatch, rng):
    """At rate 0.30 the fused decoder layer (the twin, through the model's
    dispatch) equals the port's unfused layer when both draw the same masks:
    the six sites sit where the TPU kernel puts them, and the causal mask
    gives the same probabilities as the unfused path's -1e9."""
    fused, plain = _layers(rng, dropout=0.3)
    x, mem = (torch.from_numpy(rng.standard_normal((3, 32, 64)).astype(np.float32))
              .requires_grad_(True) for _ in range(2))
    xp, memp = (a.detach().clone().requires_grad_(True) for a in (x, mem))

    y_fused = fused(x, mem, torch.Generator().manual_seed(5))
    seed = torch.randint(0, 2**31 - 1, (1,), generator=torch.Generator().manual_seed(5),
                         dtype=torch.int32)
    drop, calls = _same_mask_dropout(seed, 0.3)
    monkeypatch.setattr(transformer, "drop_site", drop)
    y_plain = plain(xp, memp, torch.Generator().manual_seed(5))
    assert calls == [(3, 2, 32, 32), (3, 32, 64), (3, 2, 32, 32), (3, 32, 64), (3, 32, 128),
                     (3, 32, 64)]
    torch.testing.assert_close(y_fused, y_plain, atol=1e-5, rtol=1e-5)
    assert (y_fused != 0).all()
    w = torch.from_numpy(rng.standard_normal(y_fused.shape).astype(np.float32))
    (y_fused * w).sum().backward()
    (y_plain * w).sum().backward()
    for (name, pf), pp in zip(fused.named_parameters(), plain.parameters()):
        torch.testing.assert_close(pf.grad, pp.grad, atol=1e-5, rtol=1e-4, msg=name)
    torch.testing.assert_close(x.grad, xp.grad, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(mem.grad, memp.grad, atol=1e-5, rtol=1e-4)
    assert float(mem.grad.abs().max()) > 0


def test_causal_self_attention_and_full_cross_attention():
    """Row i of the output depends on target rows ≤ i only, and on every
    memory row."""
    args, _ = port_tensors()
    base = fdl.decoder_layer_reference(*args, SEED, 0.0, 2, 32)
    later = [a.clone() for a in args]
    later[0][20] += 1.0  # target row 20 of the first sequence
    moved = (fdl.decoder_layer_reference(*later, SEED, 0.0, 2, 32) - base).abs().amax(-1)
    assert float(moved[:20].max()) == 0 and float(moved[20:32].min()) > 0
    assert float(moved[32:].max()) == 0  # the second sequence is untouched
    later = [a.clone() for a in args]
    later[1][31] += 1.0  # the last memory row of the first sequence
    moved = (fdl.decoder_layer_reference(*later, SEED, 0.0, 2, 32) - base).abs().amax(-1)
    assert float(moved[:32].min()) > 0 and float(moved[32:].max()) == 0


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_is_seeded_and_keeps_the_quantized_rate(rate):
    args, _ = port_tensors()
    a = fdl.decoder_layer_reference(*args, SEED, rate, 2, 32, return_residuals=True)
    b = fdl.decoder_layer_reference(*args, SEED, rate, 2, 32, return_residuals=True)
    c = fdl.decoder_layer_reference(*args, SEED + 1, rate, 2, 32, return_residuals=True)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0])
    # the FFN hidden: a kept unit is positive with probability ~1/2, so the
    # share of non-zero units is keep/2 to within sampling error
    keep = quantized_threshold(rate) / 256.0
    h = a[6]
    assert abs(float((h != 0).float().mean()) - keep / 2) < 4 * np.sqrt(0.25 / h.numel()) + 0.02
    # the six sites draw six different masks
    masks = [fl.dropout_mask(SEED, s, (64, 32), rate) for s in range(6)]
    assert all(not torch.equal(masks[i], masks[j]) for i in range(6) for j in range(i))
    assert (fdl.SITE_SELF, fdl.SITE_PROJ1, fdl.SITE_CROSS, fdl.SITE_PROJ2, fdl.SITE_FFN,
            fdl.SITE_OUT) == tuple(range(6))


def twin_launchers(monkeypatch):
    """Replace the two launchers with the twin (and autograd through it), so
    the autograd Function's bookkeeping runs on the CPU."""
    stash = []

    def forward(*a):
        stash.append(a)
        with torch.no_grad():
            return fdl.decoder_layer_reference(*a, return_residuals=True)

    def backward(dy, y, mem, qkv, a1, qc, kv, a2, h, a3, wqkv, wo, wq, wkv, wo2, w1, w2,
                 g1, b1, g2, b2, g3, seed, rate, n_heads, seq_len):
        inputs = stash.pop()
        by_name = dict(zip(fdl.ARG_NAMES, inputs))
        given = dict(y=y, mem=mem, wqkv=wqkv, wo=wo, wq=wq, wkv=wkv, wo2=wo2, w1=w1, w2=w2,
                     g1=g1, b1=b1, g2=g2, b2=b2, g3=g3)
        for name, t in given.items():  # the saved tensors come back in the right places
            assert t is by_name[name] or torch.equal(t, by_name[name]), name
        want = fdl.decoder_layer_reference(*inputs[:22], seed, rate, n_heads, seq_len,
                                           return_residuals=True)
        for name, got, ref in zip(fdl.RESIDUAL_NAMES, (qkv, a1, qc, kv, a2, h, a3), want[1:]):
            assert torch.equal(got, ref), name
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs[:22]]
        with torch.enable_grad():  # a Function's backward runs without grad mode
            out = fdl.decoder_layer_reference(*leaves, seed, rate, n_heads, seq_len)
        out.backward(dy)
        return tuple(leaf.grad.float() for leaf in leaves)

    monkeypatch.setattr(fdl, "layer_forward", forward)
    monkeypatch.setattr(fdl, "layer_backward", backward)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_backward_equals_autograd_through_the_twin(monkeypatch, dtype):
    """``_DecoderLayerTrain`` saves and hands back its 22 tensors in the
    launchers' order and returns 22 gradients (two of them activations', dx
    and dmem) in the inputs' order, weight gradients in the weights' dtype."""
    twin_launchers(monkeypatch)
    args, dy = port_tensors(seed=4)
    args = [a.to(dtype) if i in WEIGHTS + [0, 1] else a for i, a in enumerate(args)]
    dy = dy.to(dtype)
    leaves = [a.clone().requires_grad_(True) for a in args]
    y = fdl._DecoderLayerTrain.apply(*leaves, SEED, 0.3, 2, 32)
    y.backward(dy)
    ref_leaves = [a.clone().requires_grad_(True) for a in args]
    want = fdl.decoder_layer_reference(*ref_leaves, SEED, 0.3, 2, 32)
    want.backward(dy)
    assert torch.equal(y, want)
    for name, leaf, ref in zip(fdl.ARG_NAMES, leaves, ref_leaves):
        assert leaf.grad.dtype == leaf.dtype and leaf.grad.shape == leaf.shape, name
        torch.testing.assert_close(leaf.grad, ref.grad, rtol=0, atol=0, msg=name)
    assert float(leaves[1].grad.float().abs().max()) > 0  # dmem


def test_gate():
    for dtype in (torch.float32, torch.bfloat16):
        assert fdl.supports_fused_decoder_layer(256, 2, 512, 32, dtype)  # the flagship
        assert fdl.supports_fused_decoder_layer(32, 4, 512, 32, dtype)  # the demo width
    # the decoder's chain takes what the encoder's takes, in both dtypes
    for dtype in (torch.float32, torch.bfloat16):
        for d, h, ff in ((8, 1, 8), (32, 16, 512), (96, 4, 64), (252, 2, 512), (256, 16, 2048),
                         (264, 2, 512), (512, 4, 1024), (512, 1, 512), (1024, 1, 1024),
                         (1032, 3, 1024)):
            assert fdl.supports_fused_decoder_layer(d, h, ff, 32, dtype) \
                == fl.supports_fused_layer(d, h, ff, 32, dtype)
    assert fdl.supports_fused_decoder_layer(256, 2, 512, 33)  # past T 32: the long route
    assert fdl.supports_fused_decoder_layer(256, 2, 512, 256)  # a 16-bar loop
    assert not fdl.supports_fused_decoder_layer(256, 2, 512, 257)  # T past layer_sm90.MAX_T
    assert not fdl.supports_fused_decoder_layer(256, 2, 512, 32, torch.float16)
    assert not fdl.supports_fused_decoder_layer(256, 3, 512, 32)  # d not divisible by H
    assert not fdl.supports_fused_decoder_layer(1024, 4, 4096, 32)  # f32: ff past F32_MAX_FF
    assert fdl.supports_fused_decoder_layer(1024, 4, 4096, 32, torch.bfloat16)  # the wide route
    assert fdl.supports_fused_decoder_layer(1032, 3, 1024, 32, torch.bfloat16)  # d > 1,024
    assert fdl.supports_fused_decoder_layer(1024, 1, 1024, 32)  # hd 1,024: streamed
    assert not fdl.supports_fused_decoder_layer(8200, 1, 1024, 32)  # past the row passes' 8,192
    assert not fdl.supports_fused_decoder_layer(30, 2, 64, 32)  # d not a multiple of 8


def test_forced_fused_decoder_layer_the_gate_rejects_raises():
    cfg = GrooveTransformerConfig(d_model=30, n_heads=2, dim_feedforward=64, dropout=0.0,
                                  num_decoder_layers=1, fused_decoder_layer=True)
    layer = DecoderLayer(cfg).train()
    with pytest.raises(ValueError, match="supports_fused_decoder_layer"):
        layer(torch.zeros(1, 32, 30), torch.zeros(1, 32, 30), torch.Generator())
    ok = DecoderLayer(dataclasses.replace(cfg, d_model=32)).train()
    with pytest.raises(ValueError, match="memory"):  # source and target lengths differ
        ok(torch.zeros(1, 32, 32), torch.zeros(1, 16, 32), torch.Generator())


def test_cpu_tensors_run_the_twin_and_the_launchers_refuse_them():
    args, _ = port_tensors()
    every = {**fdl.SM90_KERNELS, **fdl.SM90_F32_KERNELS}
    before = {k: f.launches for k, f in every.items()}
    y = fdl.decoder_layer_train(*args, SEED, 0.3, 2, 32)
    torch.testing.assert_close(y, fdl.decoder_layer_reference(*args, SEED, 0.3, 2, 32),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="one CUDA device"):
        fdl.layer_forward(*args, SEED, 0.3, 2, 32)
    assert {k: f.launches for k, f in every.items()} == before
    assert fdl.route_kernels(torch.float32) is fdl.SM90_F32_KERNELS
    assert set(fdl.SM90_F32_KERNELS) == {f"fused_decoder_layer_sm90_f32_{k}"
                                         for k in fdl.SM90_LAUNCHES}


def test_relu_flips_take_the_other_side_at_the_given_units_only():
    args, _ = port_tensors(seed=2)
    h = fdl.decoder_layer_reference(*args, SEED, 0.0, 2, 32, return_residuals=True)[6]
    flips = torch.zeros_like(h, dtype=torch.bool)
    r, c = (h > 0).nonzero()[0]
    flips[r, c] = True
    got = fdl.decoder_layer_reference(*args, SEED, 0.0, 2, 32, return_residuals=True,
                                      relu_flips=flips)[6]
    assert got[r, c] == 0 and torch.equal(got[~flips], h[~flips])


def test_kernel_source_hash_covers_its_headers(tmp_path, monkeypatch):
    """The layer chains' sources (the wide route's and the attention's too)
    include the row passes, the product core and the shared headers: an edit
    to a header must rebuild every kernel that uses it, so the build's hash
    reads every included file."""
    from transformergrooveinfilling_tpu_torch.ops import _build

    for source in ("layer_sm90", "layer_wide_sm90"):
        files = [f.name for f in _build.source_files(_build.CSRC / f"{source}.cu")]
        assert files == [f"{source}.cu", "rows_sm90.cuh", "epilogues_sm90.cuh",
                         "gemm_sm90.cuh", "layer_common.cuh"]
    # the attention's: its registers form's header, on the flash form's PTX
    # helpers, and the streamed forms'
    assert [f.name for f in _build.source_files(_build.CSRC / "layer_attn_sm90.cu")] == [
        "layer_attn_sm90.cu", "attn_regs_sm90.cuh", "attn_stream_sm90.cuh", "rows_sm90.cuh",
        "attn_flash_sm90.cuh", "layer_common.cuh", "epilogues_sm90.cuh", "gemm_sm90.cuh"]
    files = [f.name for f in _build.source_files(_build.CSRC / "fused_ln.cu")]
    assert files == ["fused_ln.cu", "layer_common.cuh"]
    # #1: the flash form's header (on the product core's PTX helpers) and the
    # streamed forms'
    assert [f.name for f in _build.source_files(_build.CSRC / "fused_mha.cu")] == [
        "fused_mha.cu", "attn_flash_sm90.cuh", "attn_stream_sm90.cuh", "gemm_sm90.cuh"]
    # a nested include is followed, each file once
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n#include "c.cuh"\n#include <math.h>\n')
    (tmp_path / "b.cuh").write_text('  #  include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text("// leaf\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [f.name for f in _build.source_files(tmp_path / "a.cu")] == ["a.cu", "b.cuh", "c.cuh"]
