"""The port's CUDA kernels, serving and training paths on an NVIDIA GPU.

Every test here is marked ``cuda`` and skips without a card. The file imports
torch and the port only (no JAX), so it also runs on a machine without JAX,
where the repository's conftest (which imports JAX) is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from kit_fixtures import three_kits

from transformergrooveinfilling_tpu_torch.models import GrooveTransformerConfig, build_model
from transformergrooveinfilling_tpu_torch.data import make_on_device_augment
from transformergrooveinfilling_tpu_torch.ops import attention, band_energies, device_synth
from transformergrooveinfilling_tpu_torch.ops import fused_decoder_layer, fused_ffn, fused_layer
from transformergrooveinfilling_tpu_torch.ops import fused_ln, layer_sm90, mso
from transformergrooveinfilling_tpu_torch.serve import InfillServer
from transformergrooveinfilling_tpu_torch.train import (
    create_train_state, make_epoch_fn, make_train_step,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _assert_mha_close(got, want, dtype, tol):
    """#1 against its plain version. f32: summation order only, ``tol``.
    bf16: p and the output rounded to 8 bits, rtol ``tol`` and an atol of
    ``tol`` · min(1, max|ref|): long sequences average more values, so their
    outputs shrink (about √(e/T), 0.05 at T 1,024), and a bare ``tol`` would
    be half a typical value."""
    top = float(want.float().abs().max())
    torch.testing.assert_close(
        got.float(), want.float(),
        atol=tol if dtype == torch.float32 else tol * min(1.0, top),
        rtol=0 if dtype == torch.float32 else tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(8, 2, 32, 128), (8, 4, 32, 8), (2, 2, 64, 256),
                                   (3, 1, 17, 5), (8, 1, 32, 512), (4, 1, 32, 384),
                                   (4, 1, 32, 1024), (2, 1, 64, 2056), (3, 2, 40, 100),
                                   (4, 2, 128, 128), (2, 2, 256, 128), (1, 2, 1024, 128),
                                   (3, 2, 96, 40), (2, 1, 400, 64), (2, 1, 520, 24),
                                   (1, 1, 2048, 72), (2, 1, 130, 1024), (1, 1, 300, 256),
                                   (1, 1, 1100, 160), (3, 2, 65, 128), (2, 2, 1000, 64),
                                   (1, 2, 2048, 128), (200, 2, 128, 128)])
def test_kernel_matches_plain_version(cuda, rng, shape, dtype, tol, causal):
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    before = attention.KERNEL.launches
    got = attention.fused_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert attention.KERNEL.launches == before + 1
    want = attention.mha_reference(q, k, v, causal=causal)
    _assert_mha_close(got, want, dtype, tol)


@pytest.mark.cuda
def test_kernel_refuses_a_cpu_tensor_mix(cuda):
    q = torch.zeros(1, 2, 32, 16, device=cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        attention.fused_mha(q, q.cpu(), q)


@pytest.mark.cuda
def test_kernel_refuses_a_block_past_the_shared_memory_limit(cuda, rng):
    """No block is past the limit any more: f32 at T 64 and hd 512, which a
    block holding the whole head could not fit (301 KB), streams the head
    through 98 KB of shared memory (``kernel_smem_bytes``, the same at any
    hd) and matches the plain version, as bf16 does."""
    assert attention.kernel_smem_bytes(64) == 100352
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (torch.from_numpy(rng.standard_normal((1, 1, 64, 512)).astype(np.float32))
                   .to(cuda, dtype) for _ in range(3))
        out = attention.fused_mha(q, k, v)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), attention.mha_reference(q, k, v).float(),
                                   atol=tol, rtol=0 if dtype == torch.float32 else tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_vmap_rule_folds_the_trials_into_one_launch(cuda, rng, dtype, tol):
    """``tgi::fused_mha`` under ``torch.func.vmap`` over 8 trials' packed qkv
    projections (a batched sweep's ranking forward): one launch at the folded
    (8·64, 2, 32, 128), each trial equal to ``mha_reference``."""
    k_trials, b, t, h, hd = 8, 64, 32, 2, 128
    packed = torch.from_numpy(rng.standard_normal((k_trials, b, t, 3 * h * hd))
                              .astype(np.float32)).to(cuda, dtype)

    def split(p):
        return p.view(b, t, 3, h, hd).permute(2, 0, 3, 1, 4)

    before = attention.KERNEL.launches
    got = torch.func.vmap(lambda p: attention.fused_mha_op(*split(p), False))(packed)
    torch.cuda.synchronize()
    assert attention.KERNEL.launches == before + 1
    assert got.shape == (k_trials, b, h, t, hd)
    for i in range(k_trials):
        want = attention.mha_reference(*(x.contiguous() for x in split(packed[i])))
        torch.testing.assert_close(got[i].float(), want.float(), atol=tol,
                                   rtol=0 if dtype == torch.float32 else tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("form", ["self", "cross"])
@pytest.mark.parametrize("b, t, h, hd", [(1, 32, 2, 128), (64, 32, 2, 128), (3, 17, 4, 16),
                                         (2, 128, 2, 128), (1, 256, 2, 128),
                                         (2, 64, 1, 256), (5, 32, 4, 8), (16, 32, 1, 512),
                                         (16, 32, 1, 768), (8, 32, 1, 1024), (2, 64, 1, 1024),
                                         (2, 65, 2, 128), (3, 1000, 2, 64), (1, 2048, 2, 128),
                                         (300, 128, 2, 128)])
def test_kernel_reads_packed_projections(cuda, rng, b, t, h, hd, form, dtype, tol, causal):
    """The slices of the model's packed qkv (self) or of q and a packed kv
    (cross) without a copy, against the plain version on contiguous copies;
    the output a (B, H, T, hd) view of a (B, T, H, hd) buffer; a rerun bit
    for bit. Every width here arrives by 16-byte copies (hd 8 zero-filled to
    the mma's 16), the head streamed through shared memory (hd 128 to
    1,024); past T 64 at heads up to 128 the flash form reads them by TMA
    (64 query rows an item at B 1, 128 at B 300)."""
    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, dtype)

    if form == "self":
        q, k, v = n(b, t, 3, h, hd).permute(2, 0, 3, 1, 4)
    else:
        q = n(b, t, h, hd).transpose(1, 2)
        k, v = n(b, t, 2, h, hd).permute(2, 0, 3, 1, 4)
    assert attention.copy_bytes(q, k, v) == 16
    assert attention.route(q, k, v) == (
        "short" if t <= attention.SHORT_T else "flash" if hd <= attention.FLASH_HD else "scores")
    before = attention.KERNEL.launches
    got = attention.fused_mha(q, k, v, causal=causal)
    again = attention.fused_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert attention.KERNEL.launches == before + 2
    assert got.shape == (b, h, t, hd) and got.transpose(1, 2).is_contiguous()
    assert torch.equal(got, again)
    want = attention.mha_reference(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    _assert_mha_close(got, want, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype, tol, case", [(torch.float32, 1e-5, "hd5"),
                                              (torch.bfloat16, 2e-2, "misaligned")])
def test_long_views_tma_cannot_read_take_the_scores_form(cuda, rng, dtype, tol, case, causal):
    """At heads up to 128 past T 64, views TMA cannot read (f32 hd 5: rows of
    20 bytes; bf16 slices whose base lies 2 bytes off 16-byte alignment) take
    the scores form by the rule, match the plain version and rerun bit for
    bit, one launch a call."""
    if case == "hd5":
        q, k, v = (torch.from_numpy(rng.standard_normal((3, 2, 200, 5)).astype(np.float32))
                   .to(cuda, dtype) for _ in range(3))
    else:
        t, h, hd = 130, 2, 64
        flat = torch.from_numpy(rng.standard_normal(2 * t * 3 * h * hd + 1).astype(np.float32))
        q, k, v = flat.to(cuda, dtype)[1:].view(2, t, 3, h, hd).permute(2, 0, 3, 1, 4)
        assert q.data_ptr() % 16 == 2
    assert attention.route(q, k, v) == "scores"
    before = attention.KERNEL.launches
    got = attention.fused_mha(q, k, v, causal=causal)
    again = attention.fused_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert attention.KERNEL.launches == before + 2 and torch.equal(got, again)
    want = attention.mha_reference(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    _assert_mha_close(got, want, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [False, True])
def test_attention_module_makes_no_copies_around_the_kernel(cuda, rng, kv):
    """SelfAttention's kernel path in f32 runs the projections, the kernel and
    the out-projection: no permute, contiguous or output copy."""
    from torch.profiler import ProfilerActivity, profile

    from transformergrooveinfilling_tpu_torch.models.transformer import SelfAttention

    attn = SelfAttention(256, 2, torch.float32, True, device=cuda)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.from_numpy(0.05 * rng.standard_normal(p.shape).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((4, 32, 256)).astype(np.float32)).to(cuda)
    memory = x.flip(1) if kv else None
    attn(x, kv=memory)
    torch.cuda.synchronize()
    before = attention.KERNEL.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        out = attn(x, kv=memory)
        torch.cuda.synchronize()
    assert attention.KERNEL.launches == before + 1
    ops = {e.key for e in prof.key_averages()}
    assert not ops & {"aten::copy_", "aten::clone", "aten::contiguous"}, sorted(ops)
    plain = SelfAttention(256, 2, torch.float32, False, device=cuda)
    plain.load_state_dict(attn.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(out, plain(x, kv=memory), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_server_runs_every_layer_through_the_kernel(cuda, rng):
    cfg = GrooveTransformerConfig(d_model=64, n_heads=4, dim_feedforward=128,
                                  num_encoder_layers=2)
    sd = build_model(cfg, "cpu", torch.Generator().manual_seed(0)).state_dict()
    fused = InfillServer(sd, cfg, batch_sizes=(1, 4), device=cuda)
    plain = InfillServer(sd, cfg, batch_sizes=(1, 4), device=cuda, use_kernel=False)
    x = rng.standard_normal((6, 32, 16)).astype(np.float32)
    before = attention.KERNEL.launches
    got = fused.infill(x)  # 6 → two chunks of bucket 4
    assert attention.KERNEL.launches - before == 2 * cfg.num_encoder_layers
    np.testing.assert_allclose(got[..., 9:], plain.infill(x)[..., 9:], atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["contiguous", "packed_qkv"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_operator_launches_the_kernel(cuda, rng, dtype, tol, causal, form):
    """``tgi::fused_mha`` on the card is the kernel's launch: one a call,
    the ``(B, T, H, hd)`` output layout, within phase 3's bars of
    ``mha_reference`` on the same views."""
    b, h, t, hd = 8, 2, 32, 128
    shape = (b, h, t, hd) if form == "contiguous" else (b, t, 3, h, hd)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, dtype)
    q, k, v = (x, x.clone(), x.clone()) if form == "contiguous" else x.permute(2, 0, 3, 1, 4)
    before = attention.KERNEL.launches
    got = torch.ops.tgi.fused_mha(q, k, v, causal)
    torch.cuda.synchronize()
    assert attention.KERNEL.launches == before + 1
    assert got.stride() == attention.fused_mha(q, k, v, causal).stride()
    want = attention.mha_reference(q, k, v, causal)
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=0 if dtype == torch.float32 else tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n_dec", [0, 2])
def test_artifact_on_the_card_runs_the_kernel_like_the_server(cuda, rng, tmp_path, n_dec):
    """A port artifact, traced on the CPU and loaded on the card, answers as
    ``InfillServer`` on the card does (1e-5), its programs launching #1 once
    an attention a chunk; ``from_exported`` serves it with the kernel."""
    from transformergrooveinfilling_tpu_torch import export

    cfg = GrooveTransformerConfig(d_model=64, n_heads=4, dim_feedforward=128,
                                  num_encoder_layers=2, num_decoder_layers=n_dec)
    sd = build_model(cfg, "cpu", torch.Generator().manual_seed(0)).state_dict()
    path = export.export_infill(sd, cfg, str(tmp_path / "m.tgix"), batch_sizes=(1, 4))
    loaded = export.load_infill(path, device=cuda)
    server = InfillServer(sd, cfg, batch_sizes=(1, 4), device=cuda)
    x = rng.standard_normal((6, 32, 16)).astype(np.float32)
    before = attention.KERNEL.launches
    got = loaded.predict(x)  # 6 → two chunks of bucket 4
    assert attention.KERNEL.launches - before == 2 * (2 + 2 * n_dec)
    np.testing.assert_allclose(got, server.infill(x), atol=1e-5, rtol=0)
    served = InfillServer.from_exported(path, device=cuda)
    assert served.config.use_fused_attention and served.batch_sizes == [1, 4]
    np.testing.assert_allclose(served.infill(x), got, atol=1e-5, rtol=0)


def _layer_inputs(cuda, rng, t, d, ff, nseq, dtype):
    def n(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(shape))
                                .astype(np.float32)).to(cuda)

    # weights in nn.Linear's (out, in) layout
    args = [n(nseq * t, d).to(dtype), n(3 * d, d, scale=d ** -0.5).to(dtype), n(3 * d, scale=0.1),
            n(d, d, scale=d ** -0.5).to(dtype), n(d, scale=0.1), n(d, scale=0.1, offset=1.0),
            n(d, scale=0.1), n(ff, d, scale=d ** -0.5).to(dtype), n(ff, scale=0.1),
            n(d, ff, scale=ff ** -0.5).to(dtype), n(d, scale=0.1), n(d, scale=0.1, offset=1.0),
            n(d, scale=0.1)]
    return args, n(nseq * t, d).to(dtype)


def _long_kink_share(dtype, t):
    """The share of a whole bf16 layer's hidden units that may flip against
    its twin past T 32: each attention output sums more rounded products
    there, and the H100 read up to 5.7e-5 of the units at T 128 and 256
    (the decoder, B 4 and 2), each within ``KINK_BAND``; 1e-4, the bar
    chip_smoke.py holds every whole bf16 layer to (``LAYER_KINK_SHARE``).
    Up to T 32 and in f32, ``kink_flips``' own."""
    return (1e-4,) if dtype == torch.bfloat16 and t > 32 else ()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t, d, h, ff, nseq", [(32, 256, 2, 512, 8), (32, 128, 2, 256, 4),
                                               (17, 64, 4, 96, 3), (32, 32, 4, 512, 2),
                                               (128, 256, 2, 512, 4), (256, 128, 2, 256, 2),
                                               (100, 64, 4, 96, 3)])
def test_layer_kernels_match_the_twin(cuda, rng, t, d, h, ff, nseq, dtype, rate):
    """Forward, row backward and weight gradients against
    encoder_layer_reference (same masks; the kernel's side of the ReLU only
    at units within rounding of 0, kink_flips); f32: summation order and the
    split TF32 products, bf16: the backward's rounding points differ from
    autograd's. Each launch of the dtype's chain of csrc/layer_sm90.cu once,
    the other dtype's none."""
    args, dy = _layer_inputs(cuda, rng, t, d, ff, nseq, dtype)
    seed = torch.tensor([99], dtype=torch.int32, device=cuda)
    every = {**fused_layer.SM90_F32_KERNELS, **fused_layer.SM90_KERNELS}
    before = {k: f.launches for k, f in every.items()}
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    y = fused_layer.encoder_layer_train(*leaves, seed, rate, h, t)
    y.backward(dy)
    torch.cuda.synchronize()
    route = fused_layer.route_kernels(dtype)
    assert {k: f.launches - before[k] for k, f in every.items()} == {
        k: int(k in route) for k in every}
    res = fused_layer.layer_forward(*args, seed, rate, h, t)
    with torch.no_grad():
        own = fused_layer.encoder_layer_reference(*args, seed, rate, h, t, return_residuals=True)
    flips, _ = fused_layer.kink_flips(own[3], res[3], *_long_kink_share(dtype, t))
    ref_leaves = [a.detach().clone().requires_grad_(True) for a in args]
    want = fused_layer.encoder_layer_reference(*ref_leaves, seed, rate, h, t,
                                               return_residuals=True, relu_flips=flips)
    want[0].backward(dy)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, ref in [(y.detach(), want[0])] + list(zip(res[1:], want[1:])):
        ref = ref.detach().float()
        assert float((got.float() - ref).abs().max()) <= tol * max(1.0, float(ref.abs().max()))
    for leaf, ref in zip(leaves, ref_leaves):
        assert leaf.grad.dtype == leaf.dtype
        scale = float(ref.grad.float().abs().max())
        assert float((leaf.grad.float() - ref.grad.float()).abs().max()) <= tol * scale


def _wide_flips(own_h, kernel_h, d):
    """A whole layer of the wide route against its twin: each ReLU decision
    that differs within KINK_BAND of 0, and at most KINK_SHARE (f32) or
    ``wide_kink_share(d)`` (bf16) of the units, plus 4."""
    share = (fused_layer.KINK_SHARE if own_h.dtype == torch.float32
             else fused_layer.wide_kink_share(d))
    return fused_layer.kink_flips(own_h, kernel_h, share)[0]


def _wide_layer_against_twin(cuda, rng, decoder, dtype, rate, d, h, ff, nseq):
    """The chains' wide route at d, h, ff: forward, row backward and weight
    gradients through the layer's autograd Function against autograd through
    the twin (same masks; the kernel's side of the ReLU at the units
    ``_wide_flips`` admits), the bars of the layer tests above; each launch of
    the dtype's wide route once, nothing else."""
    t = 32
    mod = fused_decoder_layer if decoder else fused_layer
    args, dy = (_decoder_inputs if decoder else _layer_inputs)(cuda, rng, t, d, ff, nseq, dtype)
    seed = torch.tensor([99], dtype=torch.int32, device=cuda)
    every = {**mod.SM90_KERNELS, **mod.SM90_F32_KERNELS, **mod.SM90_WIDE_KERNELS,
             **mod.SM90_WIDE_F32_KERNELS}
    before = {k: f.launches for k, f in every.items()}
    train = mod.decoder_layer_train if decoder else mod.encoder_layer_train
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    y = train(*leaves, seed, rate, h, t)
    y.backward(dy)
    torch.cuda.synchronize()
    route = mod.route_kernels(dtype, d)
    assert {k: f.launches - before[k] for k, f in every.items()} == {
        k: int(k in route) for k in every}
    reference = mod.decoder_layer_reference if decoder else mod.encoder_layer_reference
    res = mod.layer_forward(*args, seed, rate, h, t)
    with torch.no_grad():
        own = reference(*args, seed, rate, h, t, return_residuals=True)
    h_at = 6 if decoder else 3
    flips = _wide_flips(own[h_at], res[h_at], d)
    ref_leaves = [a.detach().clone().requires_grad_(True) for a in args]
    want = reference(*ref_leaves, seed, rate, h, t, return_residuals=True, relu_flips=flips)
    want[0].backward(dy)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, ref in [(y.detach(), want[0])] + list(zip(res[1:], want[1:])):
        ref = ref.detach().float()
        assert float((got.float() - ref).abs().max()) <= tol * max(1.0, float(ref.abs().max()))
    for leaf, ref in zip(leaves, ref_leaves):
        assert leaf.grad.dtype == leaf.dtype
        scale = float(ref.grad.float().abs().max())
        assert float((leaf.grad.float() - ref.grad.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decoder", [False, True])
def test_wide_layers_match_the_twin(cuda, rng, decoder, dtype, rate):
    """d 512, 4 heads, ff 1,024, the chains' wide route, against the twin
    (``_wide_layer_against_twin``)."""
    _wide_layer_against_twin(cuda, rng, decoder, dtype, rate, 512, 4, 1024, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decoder", [False, True])
@pytest.mark.parametrize("d, h", [(1024, 1), (2048, 2)])
def test_widest_layers_match_the_twin(cuda, rng, d, h, decoder, dtype):
    """d 1,024 with one head of 1,024 (the attention streams the head) and d
    2,048 with two (the row passes a block a row), ff 1,024, rate 0.3: the
    layers against the twin (``_wide_layer_against_twin``)."""
    _wide_layer_against_twin(cuda, rng, decoder, dtype, 0.3, d, h, 1024, 2)


@pytest.mark.cuda
def test_layer_kernels_are_deterministic(cuda, rng):
    args, dy = _layer_inputs(cuda, rng, 32, 256, 512, 16, torch.float32)
    seed = torch.tensor([5], dtype=torch.int32, device=cuda)
    outs = []
    for _ in range(2):
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        y = fused_layer.encoder_layer_train(*leaves, seed, 0.3, 2, 32)
        y.backward(dy)
        outs.append([y.detach()] + [leaf.grad for leaf in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.cuda
def test_layer_kernels_refuse_a_cpu_tensor_mix_and_unsupported_shapes(cuda, rng):
    args, _ = _layer_inputs(cuda, rng, 32, 64, 128, 2, torch.float32)
    seed = torch.tensor([1], dtype=torch.int32, device=cuda)
    mixed = list(args)
    mixed[3] = mixed[3].cpu()
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_layer.encoder_layer_train(*mixed, seed, 0.3, 2, 32)
    with pytest.raises(ValueError, match="supports_fused_layer"):
        fused_layer.encoder_layer_train(*args, seed, 0.3, 2, 512)  # T past layer_sm90.MAX_T


@pytest.mark.cuda
def test_forced_fused_layer_the_gate_rejects_raises(cuda):
    cfg = GrooveTransformerConfig(d_model=30, n_heads=2, dim_feedforward=64, dropout=0.1,
                                  num_encoder_layers=1, fused_layer=True)
    model = build_model(cfg, cuda).train()
    with pytest.raises(ValueError, match="supports_fused_layer"):
        model(torch.zeros(2, 32, 16, device=cuda), torch.Generator(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_steps_run_every_layer_through_the_kernels(cuda, rng, dtype):
    cfg = GrooveTransformerConfig(d_model=64, n_heads=2, dim_feedforward=128, dropout=0.3,
                                  num_encoder_layers=2, fused_layer=True, compute_dtype=dtype)
    state = create_train_state(cfg, "sgd", 0.05, seed=0, device=cuda)
    step = make_train_step(0.73)
    x = torch.from_numpy(rng.standard_normal((8, 32, 16)).astype(np.float32)).to(cuda)
    y = torch.from_numpy((rng.random((8, 32, 27)) < 0.3).astype(np.float32)).to(cuda)
    route = fused_layer.route_kernels(dtype)
    before = {k: f.launches for k, f in route.items()}
    gen = torch.Generator(cuda).manual_seed(0)
    losses = [float(step(state, x, y, None, gen)["loss"]) for _ in range(5)]
    assert {k: f.launches - before[k] for k, f in route.items()} == {k: 5 * 2 for k in route}
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# ---------------------------------------------------------------- decoder layer


def _decoder_inputs(cuda, rng, t, d, ff, nseq, dtype):
    """y, mem and the 20 parameters in ``ARG_NAMES`` order (weights in
    nn.Linear's (out, in) layout), and dy."""
    def n(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(shape))
                                .astype(np.float32)).to(cuda)

    def w(out, inp):
        return n(out, inp, scale=inp ** -0.5).to(dtype)

    m = nseq * t
    args = [n(m, d).to(dtype), n(m, d).to(dtype), w(3 * d, d), n(3 * d, scale=0.1), w(d, d),
            n(d, scale=0.1), w(d, d), n(d, scale=0.1), w(2 * d, d), n(2 * d, scale=0.1),
            w(d, d), n(d, scale=0.1), n(d, scale=0.1, offset=1.0), n(d, scale=0.1), w(ff, d),
            n(ff, scale=0.1), w(d, ff), n(d, scale=0.1), n(d, scale=0.1, offset=1.0),
            n(d, scale=0.1), n(d, scale=0.1, offset=1.0), n(d, scale=0.1)]
    return args, n(m, d).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t, d, h, ff, nseq", [(32, 256, 2, 512, 8), (32, 128, 2, 256, 4),
                                               (17, 64, 4, 96, 3), (32, 32, 4, 512, 2),
                                               (128, 256, 2, 512, 4), (256, 128, 2, 256, 2)])
def test_decoder_layer_kernels_match_the_twin(cuda, rng, t, d, h, ff, nseq, dtype, rate):
    """Forward, row backward and weight gradients against
    decoder_layer_reference (same masks; the kernel's side of the ReLU only
    at units within rounding of 0, kink_flips): y3, the 7 residuals, dx, dmem
    and the 20 parameter grads; bars as the encoder layer's."""
    dl = fused_decoder_layer
    args, dy = _decoder_inputs(cuda, rng, t, d, ff, nseq, dtype)
    seed = torch.tensor([99], dtype=torch.int32, device=cuda)
    every = {**dl.SM90_F32_KERNELS, **dl.SM90_KERNELS}
    before = {k: f.launches for k, f in every.items()}
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    y = dl.decoder_layer_train(*leaves, seed, rate, h, t)
    y.backward(dy)
    torch.cuda.synchronize()
    route = dl.route_kernels(dtype)
    assert {k: f.launches - before[k] for k, f in every.items()} == {
        k: int(k in route) for k in every}
    res = dl.layer_forward(*args, seed, rate, h, t)
    with torch.no_grad():
        own = dl.decoder_layer_reference(*args, seed, rate, h, t, return_residuals=True)
    flips, _ = fused_layer.kink_flips(own[6], res[6], *_long_kink_share(dtype, t))
    ref_leaves = [a.detach().clone().requires_grad_(True) for a in args]
    want = dl.decoder_layer_reference(*ref_leaves, seed, rate, h, t, return_residuals=True,
                                      relu_flips=flips)
    want[0].backward(dy)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, ref in [(y.detach(), want[0])] + list(zip(res[1:], want[1:])):
        ref = ref.detach().float()
        assert float((got.float() - ref).abs().max()) <= tol * max(1.0, float(ref.abs().max()))
    for name, leaf, ref in zip(dl.ARG_NAMES, leaves, ref_leaves):
        assert leaf.grad.dtype == leaf.dtype, name
        scale = float(ref.grad.float().abs().max())
        assert float((leaf.grad.float() - ref.grad.float()).abs().max()) <= tol * scale, name


@pytest.mark.cuda
def test_decoder_layer_kernels_are_deterministic_and_refuse_what_they_do_not_take(cuda, rng):
    dl = fused_decoder_layer
    args, dy = _decoder_inputs(cuda, rng, 32, 256, 512, 16, torch.float32)
    seed = torch.tensor([5], dtype=torch.int32, device=cuda)
    outs = []
    for _ in range(2):
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        y = dl.decoder_layer_train(*leaves, seed, 0.3, 2, 32)
        y.backward(dy)
        outs.append([y.detach()] + [leaf.grad for leaf in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    mixed = list(args)
    mixed[4] = mixed[4].cpu()
    with pytest.raises(ValueError, match="one CUDA device"):
        dl.decoder_layer_train(*mixed, seed, 0.3, 2, 32)
    with pytest.raises(ValueError, match="supports_fused_decoder_layer"):
        dl.decoder_layer_train(*args, seed, 0.3, 2, 512)  # T past layer_sm90.MAX_T
    short = list(args)
    short[1] = short[1][:256].contiguous()  # a memory of another length
    with pytest.raises(ValueError, match="equal source and target lengths"):
        dl.decoder_layer_train(*short, seed, 0.3, 2, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_decoder_train_steps_run_every_layer_through_the_kernels(cuda, rng, dtype):
    cfg = GrooveTransformerConfig(d_model=64, n_heads=2, dim_feedforward=128, dropout=0.3,
                                  num_encoder_layers=2, num_decoder_layers=3, fused_layer=True,
                                  fused_decoder_layer=True, compute_dtype=dtype)
    state = create_train_state(cfg, "sgd", 0.05, seed=0, device=cuda)
    step = make_train_step(0.73, encoder_only=False)
    x = torch.from_numpy(rng.standard_normal((8, 32, 16)).astype(np.float32)).to(cuda)
    y = torch.from_numpy((rng.random((8, 32, 27)) < 0.3).astype(np.float32)).to(cuda)
    enc, dec = fused_layer.route_kernels(dtype), fused_decoder_layer.route_kernels(dtype)
    kernels = {**enc, **dec}
    before = {k: f.launches for k, f in kernels.items()}
    gen = torch.Generator(cuda).manual_seed(0)
    losses = [float(step(state, x, y, None, gen)["loss"]) for _ in range(5)]
    assert {k: f.launches - before[k] for k, f in kernels.items()} == {
        **{k: 5 * 2 for k in enc}, **{k: 5 * 3 for k in dec}}
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.cuda
def test_encoder_decoder_server_runs_18_attentions_through_the_kernel(cuda, rng):
    cfg = GrooveTransformerConfig(d_model=64, n_heads=4, dim_feedforward=128,
                                  num_encoder_layers=6, num_decoder_layers=6)
    sd = build_model(cfg, "cpu").state_dict()
    fused = InfillServer(sd, cfg, batch_sizes=(1, 4), device=cuda)
    plain = InfillServer(sd, cfg, batch_sizes=(1, 4), device=cuda, use_kernel=False)
    x = rng.standard_normal((6, 32, 16)).astype(np.float32)
    before = attention.KERNEL.launches
    got = fused.infill(x)  # 6 → two chunks of bucket 4
    assert attention.KERNEL.launches - before == 2 * 18
    np.testing.assert_allclose(got[..., 9:], plain.infill(x)[..., 9:], atol=1e-4)


# ---------------------------------------------------------------- layer chains


def _sm90_record(cuda, rng, decoder, t, d, h, ff, nseq, rate, seed=7, dtype=torch.bfloat16):
    """One layer call in ``dtype`` (forward and backward through the layer
    module's chain) with every launch recorded."""
    make = _decoder_inputs if decoder else _layer_inputs
    mod = fused_decoder_layer if decoder else fused_layer
    args, dy = make(cuda, rng, t, d, ff, nseq, dtype)
    seed = torch.tensor([seed], dtype=torch.int32, device=cuda)
    with layer_sm90.recording() as record:
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        y = (mod.decoder_layer_train if decoder else mod.encoder_layer_train)(
            *leaves, seed, rate, h, t)
        y.backward(dy)
        torch.cuda.synchronize()
    return mod, record, [y.detach()] + [leaf.grad for leaf in leaves]


# each launch against its plain version, · max|ref|. bf16: rounding of the
# outputs, f32 sums in another order. f32: the split TF32 products (~2⁻²² of
# each term) and the tensor cores' truncating accumulation, which the 64 × 256
# LayerNorm tiles cannot promote: ff/8 · 3 truncated adds, up to ~2.3e-5 of a
# sum over ff 2048 and typically half of that (chip_smoke.py holds every ff the
# f32 gate admits, up to F32_MAX_FF, to 1e-5)
CHAIN_BARS = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("decoder", [False, True])
@pytest.mark.parametrize("t, d, h, ff, nseq", [(32, 256, 2, 512, 16), (17, 64, 4, 96, 3),
                                               (32, 256, 2, 2048, 4), (8, 32, 4, 64, 5),
                                               (32, 512, 4, 1024, 16), (32, 512, 1, 512, 8),
                                               (17, 1024, 2, 1024, 3), (32, 1024, 1, 1024, 8),
                                               (32, 2048, 2, 1024, 4), (32, 1280, 5, 1024, 4),
                                               (128, 256, 2, 512, 4), (256, 256, 2, 512, 2),
                                               (48, 64, 4, 96, 3), (200, 512, 4, 1024, 2)])
def test_sm90_launches_match_their_plain_versions(cuda, rng, decoder, t, d, h, ff, nseq, dtype):
    """Every launch of a layer call against its plain version on the same
    inputs, each output within its dtype's bar of its largest value
    (``CHAIN_BARS``), every launch of the dtype's chain once: 13 an encoder
    layer, 21 a decoder layer; past d 256 the wide route's 16 and 26 (the
    LayerNorm epilogues' launches as a product and a row pass each, the
    row passes a warp a row in chunks of 256 columns up to d 1,024 and a
    block a row past it, the attention streaming heads of 512 and 1,024).
    An f32 layer past
    ``F32_MAX_FF`` is refused (ROADMAP §C11: phases 8 and 14 of chip_smoke.py
    hold the chain there)."""
    if dtype == torch.float32 and ff > fused_layer.F32_MAX_FF:
        with pytest.raises(ValueError, match="do not take"):
            _sm90_record(cuda, rng, decoder, t, d, h, ff, nseq, 0.3, dtype=dtype)
        return
    mod, record, _ = _sm90_record(cuda, rng, decoder, t, d, h, ff, nseq, 0.3, dtype=dtype)
    route = mod.route_kernels(dtype, d)
    names = {id(k): n for n, k in route.items()}
    assert len(record) == (21 if decoder else 13) + (d > layer_sm90.LN_TILE) * (5 if decoder else 3)
    assert sorted(names[id(launch.kernel)] for launch in record) == sorted(route)
    for launch in record:
        want = launch.reference(*launch.args, **launch.kwargs)
        want = want if isinstance(want, tuple) else (want,)
        assert len(want) == len(launch.outputs)
        for got, ref in zip(launch.outputs, want):
            ref = ref.float()
            err = float((got.float() - ref).abs().max())
            assert err <= CHAIN_BARS[dtype] * float(ref.abs().max()), names[id(launch.kernel)]


@pytest.mark.cuda
@pytest.mark.parametrize("decoder", [False, True])
@pytest.mark.parametrize("d, h, ff", [(32, 16, 512), (32, 4, 16), (64, 16, 256), (256, 16, 64)])
def test_f32_chain_takes_the_config_widths(cuda, rng, decoder, d, h, ff):
    """The f32 chain at the narrow widths of configs/*.yaml (heads of 2, 8, 4
    and 16): every launch against its plain version (1e-5 of each output's
    largest value)."""
    mod, record, _ = _sm90_record(cuda, rng, decoder, 32, d, h, ff, 6, 0.3, dtype=torch.float32)
    assert len(record) == (21 if decoder else 13)
    for launch in record:
        want = launch.reference(*launch.args, **launch.kwargs)
        want = want if isinstance(want, tuple) else (want,)
        for got, ref in zip(launch.outputs, want):
            err = float((got - ref).abs().max())
            assert err <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("decoder", [False, True])
def test_sm90_layers_rerun_bit_identical(cuda, rng, decoder, dtype):
    """No float atomics: two layer calls with one seed agree bit for bit
    (forward output and every gradient), also with several row splits."""
    first = _sm90_record(cuda, np.random.default_rng(3), decoder, 32, 256, 2, 512, 64, 0.3,
                         dtype=dtype)[2]
    again = _sm90_record(cuda, np.random.default_rng(3), decoder, 32, 256, 2, 512, 64, 0.3,
                         dtype=dtype)[2]
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def _attention_kernels(dtype):
    """The encoder chain's attention launches in ``dtype``: (forward, backward)."""
    route = fused_layer.route_kernels(dtype)
    return tuple(next(k for n, k in route.items() if n.endswith(s))
                 for s in ("attn_fwd", "attn_bwd"))


@pytest.mark.cuda
def test_kernel_raises_past_its_t_ceiling(cuda):
    q = torch.zeros(1, 1, attention.MAX_T + 1, 16, device=cuda)
    with pytest.raises(ValueError, match=f"T ≤ {attention.MAX_T}"):
        attention.fused_mha(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("t, dtype", [(128, torch.float32), (256, torch.float32),
                                      (64, torch.bfloat16), (128, torch.bfloat16)])
def test_long_attention_masks_are_the_plain_versions_bit_for_bit(cuda, rng, t, dtype):
    """Past T 32 the attention launches draw a row's mask 16 columns a lane
    (the registers form: a quad's lanes share each draw's keep bits). With
    one head, hd = T and V the identity, the output is round(drop(P))
    itself, nonzero exactly where the mask keeps: the forward's and the
    backward's output again show the plain version's mask bit for bit, and
    the backward's output equals the forward's; a rerun is bit for bit. f32
    takes the scores form, bf16 (hd = T ≤ 128) the registers form."""
    nseq = 3

    def n(*shape):
        return torch.from_numpy(0.1 * rng.standard_normal(shape).astype(np.float32)).to(cuda,
                                                                                       dtype)

    q, k, da = n(nseq * t, t), n(nseq * t, t), n(nseq * t, t)
    v = torch.eye(t, device=cuda, dtype=dtype).repeat(nseq, 1)
    seed = torch.tensor([11], dtype=torch.int32, device=cuda)
    fwd, bwd = _attention_kernels(dtype)
    keep = fused_layer.dropout_mask(seed, fused_layer.SITE_ATTN, (nseq * t, t), 0.3)
    layer_sm90.reset_form_launches()
    out = layer_sm90.attention_forward(fwd, q, k, v, seed, fused_layer.SITE_ATTN, 0.3, 1, t,
                                       False)
    grads = [torch.empty_like(q) for _ in range(4)]
    layer_sm90.attention_backward(bwd, q, k, v, da, *grads, seed, fused_layer.SITE_ATTN, 0.3, 1,
                                  t, False)
    again = layer_sm90.attention_forward(fwd, q, k, v, seed, fused_layer.SITE_ATTN, 0.3, 1, t,
                                         False)
    torch.cuda.synchronize()
    form = "registers" if dtype == torch.bfloat16 else "scores"
    assert layer_sm90.form_launches() == {"attn_fwd": {form: 2}, "attn_bwd": {form: 1}}
    assert torch.equal(out != 0, keep)
    assert torch.equal(grads[3], out) and torch.equal(again, out)


def _packed_attention_views(cuda, rng, nseq, t, d, dtype, packing):
    """q, k, v and da as the chains pass them (``packing`` "qkv": the
    slices of a packed qkv, the self-attention's; "kv": q its own buffer, k
    and v the slices of a packed kv, the cross-attention's), and the
    backward's outputs of the same layout (dq, dk, dv views and out)."""
    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, dtype)

    if packing == "qkv":
        qkv = n(nseq * t, 3 * d)
        views = (qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:])
        grad = torch.empty_like(qkv)
        grads = (grad[:, :d], grad[:, d:2 * d], grad[:, 2 * d:])
    else:
        q, kv = n(nseq * t, d), n(nseq * t, 2 * d)
        views = (q, kv[:, :d], kv[:, d:])
        dkv = torch.empty_like(kv)
        grads = (torch.empty_like(q), dkv[:, :d], dkv[:, d:])
    return views, n(nseq * t, d), grads


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t, h, hd, nseq, packing", [
    (128, 2, 128, 4, "qkv"), (256, 2, 128, 2, "qkv"), (48, 4, 16, 3, "qkv"),
    (200, 1, 512, 2, "qkv"),
    # the registers form (bf16, hd ≤ 128): T 33 to 256, hd 64 and 128, fewer
    # blocks than SMs and more (70 · 2 · 1 and 40 · 2 · 2, 40 · 2 · 4), the
    # cross-attention's packed kv
    (33, 2, 64, 3, "qkv"), (64, 2, 128, 70, "qkv"), (128, 2, 64, 40, "kv"),
    (200, 4, 64, 3, "kv"), (256, 2, 128, 40, "qkv"), (256, 2, 64, 3, "kv")])
def test_long_attention_launches_match_their_plain_versions(cuda, rng, t, h, hd, nseq, packing,
                                                            dtype, causal):
    """The attention launches past T 32 on the slices of a packed qkv (or
    q and a packed kv), at rate 0.3: forward and backward (dq, dk, dv and
    the output again) within the chain's bars of their plain versions, a
    rerun bit for bit, the output again the forward's, and each launch in
    the form ``attention_route`` names (bf16 heads up to 128: registers)."""
    d = h * hd
    (q, k, v), da, (dq, dk, dv) = _packed_attention_views(cuda, rng, nseq, t, d, dtype, packing)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    fwd, bwd = _attention_kernels(dtype)
    args = (seed, fused_layer.SITE_ATTN, 0.3, h, t, causal)
    form = layer_sm90.attention_route(q, k, v, t, h)
    assert form == ("registers" if dtype == torch.bfloat16 and hd <= 128 else "scores")
    runs = []
    layer_sm90.reset_form_launches()
    for _ in range(2):
        out = layer_sm90.attention_forward(fwd, q, k, v, *args)
        again = torch.empty_like(da)
        layer_sm90.attention_backward(bwd, q, k, v, da, dq, dk, dv, again, *args)
        torch.cuda.synchronize()
        runs.append((out, dq.clone(), dk.clone(), dv.clone(), again))
    assert layer_sm90.form_launches() == {"attn_fwd": {form: 2}, "attn_bwd": {form: 2}}
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    out, dq, dk, dv, again = runs[0]
    assert torch.equal(again, out)
    want = layer_sm90.attention_backward_reference(q, k, v, da, *args)
    got = (dq, dk, dv, out)
    for name, g, ref in zip(("dq", "dk", "dv", "out"), got, want):
        ref = ref.float()
        err = float((g.float() - ref).abs().max())
        assert err <= CHAIN_BARS[dtype] * float(ref.abs().max()), (name, err)
    ref = layer_sm90.attention_forward_reference(q, k, v, *args).float()
    assert float((out.float() - ref).abs().max()) <= CHAIN_BARS[dtype] * float(ref.abs().max())


@pytest.mark.cuda
def test_sm90_launches_refuse_what_they_do_not_take(cuda, rng):
    args, _ = _layer_inputs(cuda, rng, 32, 64, 128, 2, torch.bfloat16)
    seed = torch.tensor([1], dtype=torch.int32, device=cuda)
    k = fused_layer.SM90_KERNELS["fused_layer_sm90_qkv"]
    x, wqkv, bqkv = args[0], args[1], args[2]
    with pytest.raises(ValueError, match="one CUDA device"):
        layer_sm90.bias_product(k, x, wqkv.cpu(), bqkv)
    with pytest.raises(ValueError, match="of one dtype"):
        layer_sm90.bias_product(k, x.float(), wqkv, bqkv)
    with pytest.raises(ValueError, match="contiguous activations"):
        layer_sm90.bias_product(k, x[:, :60], wqkv[:, :60], bqkv)  # rows not a multiple of 8
    rows = torch.zeros(64, 8200, device=cuda)  # d beyond the row passes' 8,192
    with pytest.raises(ValueError, match="up to 8192"):
        layer_sm90.ln_y_rows(fused_layer.SM90_WIDE_KERNELS["fused_layer_sm90_proj_ln1_rows"],
                             rows, rows[0], rows[0], torch.bfloat16)
    wide, _ = _layer_inputs(cuda, rng, 32, 512, 128, 2, torch.bfloat16)
    x2, w2 = wide[0], wide[3]
    with pytest.raises(ValueError, match="wide route"):  # one kernel where d 512 takes two
        layer_sm90.residual_ln_product(k, x2, w2, wide[4], x2, wide[5], wide[6], seed, 1, 0.3)
    with pytest.raises(ValueError, match="supports_fused_layer"):
        fused_layer.encoder_layer_train(*args, seed, 0.3, 2, 512)  # T past layer_sm90.MAX_T
    mixed = list(args)
    mixed[3] = mixed[3].cpu()
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_layer.encoder_layer_train(*mixed, seed, 0.3, 2, 32)
    attn = fused_layer.SM90_KERNELS["fused_layer_sm90_attn_fwd"]
    packed = torch.zeros(64, 48, dtype=torch.bfloat16, device=cuda)
    q = packed[:, :32]
    with pytest.raises(ValueError, match="multiple of 8"):  # hd 4
        layer_sm90.attention_forward(attn, q, q, q, seed, 0, 0.3, 8, 32, False)
    with pytest.raises(ValueError, match="16-byte aligned"):  # starts 8 bytes into a row
        layer_sm90.attention_forward(attn, packed[:, 4:36], q, q, seed, 0, 0.3, 2, 32, False)


# ---------------------------------------------------------------- audio front end


def _grids(rng, m, density=0.3):
    h = (rng.random((m, 32, 9)) < density).astype(np.float32)
    return np.concatenate([h, h * rng.random(h.shape), h * (rng.random(h.shape) - 0.5)],
                          axis=-1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 417, 418, 26752, 140544])
def test_band_energies_kernel_matches_plain_version(cuda, rng, n):
    """The frames entry at ragged frame counts (one frame; one short of, and
    exactly, one request; a chunk of 64; a chunk of 256 at 90 bpm): an FFT
    against the plain version's dense f32 products, sums of 1,024 terms in
    another order: 1e-4 of the largest band energy."""
    frames = torch.from_numpy(rng.standard_normal((n, 1024)).astype(np.float32)).to(cuda)
    fb_t = mso._filterbank(mso.MSOParams(), frames.device)[1]
    before = band_energies.KERNEL.launches
    got = band_energies.band_energies(frames, fb_t)
    again = band_energies.band_energies(frames, fb_t)
    torch.cuda.synchronize()
    assert band_energies.KERNEL.launches == before + 2
    assert got.shape == (n, 16) and torch.equal(got, again)  # no atomics: bit-identical
    want = band_energies.band_energies_plain(frames, fb_t)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    # against the rFFT, which keeps the Nyquist bin
    fft = torch.fft.rfft(frames).abs() @ fb_t
    torch.testing.assert_close(got, fft, rtol=2e-4, atol=2e-4 * float(fft.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("qpm", [90.0, 120.0, 150.0])
@pytest.mark.parametrize("m", [1, 3, 64])
def test_band_energies_from_audio_matches_plain_version(cuda, rng, m, qpm):
    """The waveform entry (framing, reflection and window inside the kernel)
    against the plain version (frames materialised, dense f32 products) at the
    front end's lengths; reruns bit-identical."""
    params = mso.MSOParams()
    length = mso.mso_waveform_length(32, qpm / 15.0, params) + m  # ragged lengths
    y = torch.from_numpy(rng.standard_normal((m, length)).astype(np.float32)).to(cuda)
    fb_t = mso._filterbank(params, cuda)[1]
    window = mso.hann_window(params.n_fft, cuda)
    before = band_energies.KERNEL.launches
    got = band_energies.band_energies_from_audio(y, fb_t, window, params.hop_length, params.n_fft)
    again = band_energies.band_energies_from_audio(y, fb_t, window, params.hop_length,
                                                   params.n_fft)
    torch.cuda.synchronize()
    assert band_energies.KERNEL.launches == before + 2
    assert torch.equal(got, again)
    want = band_energies.band_energies_from_audio_plain(y, fb_t, window, params.hop_length,
                                                        params.n_fft)
    assert got.shape == want.shape == (m, 1 + length // params.hop_length, 16)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_band_energies_kernel_refuses_what_it_does_not_take(cuda):
    frames = torch.zeros(8, 1024, device=cuda)
    fb_t = torch.zeros(513, 16, device=cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        band_energies.band_energies(frames, fb_t.cpu())
    with pytest.raises(ValueError, match="float32"):
        band_energies.band_energies(frames.double(), fb_t)
    with pytest.raises(ValueError, match="n_fft"):
        band_energies.band_energies(frames[:, :1000].contiguous(), fb_t)


@pytest.mark.cuda
@pytest.mark.parametrize("qpm", [60.0, 97.0, 120.0, 150.0, 200.0])
@pytest.mark.parametrize("m", [1, 3, 64, 65, 256])
def test_synth_kernel_equals_plain_version_bit_for_bit(cuda, rng, m, qpm):
    params = mso.MSOParams()
    table, _, luts, _, lengths = device_synth.pack_tables([None], params.sr, device=cuda)
    hvos = torch.from_numpy(_grids(rng, m)).to(cuda)
    sps = torch.full((m,), qpm / 15.0, device=cuda)
    zeros = torch.zeros(m, dtype=torch.int32, device=cuda)
    length = mso.mso_waveform_length(32, qpm / 15.0, params)
    onset, row, gain = device_synth._extract_events(hvos, sps, zeros, length, 44100.0, luts,
                                                    zeros)
    before = device_synth.KERNEL.launches
    got = device_synth.synth_events(onset, row, gain, table, lengths, length)
    torch.cuda.synchronize()
    assert device_synth.KERNEL.launches == before + 1 and got.shape == (m, length)
    assert torch.equal(got, device_synth.synth_events_plain(onset, row, gain, table, length))
    # and the plain version on the CPU: the same sums in the same order
    cpu = device_synth.synth_events_plain(onset.cpu(), row.cpu(), gain.cpu(), table.cpu(),
                                          length)
    assert torch.equal(got.cpu(), cpu)
    with pytest.raises(ValueError, match="one CUDA device"):
        device_synth.synth_events(onset.cpu(), row, gain, table, lengths, length)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 65, 256])
def test_synth_kernel_at_a_length_that_is_no_multiple_of_its_tile(cuda, rng, m):
    """The last tile of every item is ragged: 2 samples past a multiple of
    the largest tile (and so of every tile), events clipped to the waveform."""
    table, _, luts, _, lengths = device_synth.pack_tables([None], 44100, device=cuda)
    length = 22 * device_synth.THREADS * device_synth.PER_THREAD[-1] + 2
    p = device_synth.samples_per_thread(
        m, length, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert length % (device_synth.THREADS * p) == 2
    hvos = torch.from_numpy(_grids(rng, m)).to(cuda)
    sps = torch.full((m,), 8.0, device=cuda)
    zeros = torch.zeros(m, dtype=torch.int32, device=cuda)
    onset, row, gain = device_synth._extract_events(hvos, sps, zeros, length, 44100.0, luts,
                                                    zeros)
    got = device_synth.synth_events(onset, row, gain, table, lengths, length)
    torch.cuda.synchronize()
    assert got.shape == (m, length) and bool(got.ne(0).any())
    assert torch.equal(got, device_synth.synth_events_plain(onset, row, gain, table, length))


@pytest.fixture(scope="module")
def kits(tmp_path_factory):
    """``chip_smoke.py`` phase 23's three SoundFont kits (45 rows packed)."""
    return three_kits(str(tmp_path_factory.mktemp("kits")))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 64, 256])
def test_synth_kernel_on_the_three_kit_table_equals_plain_version_bit_for_bit(cuda, rng, kits,
                                                                              m):
    """Rows picked through the kits' velocity-layer LUTs, several kits in one
    table, rows of other lengths than the procedural kit's."""
    params = mso.MSOParams()
    table, base, luts, sf_index, lengths = device_synth.pack_tables(kits, params.sr, device=cuda)
    assert table.shape[0] == 45 and len(set(lengths.tolist())) > 9
    item_kits = [kits[i] for i in rng.integers(0, 3, m)]
    sf_base = torch.tensor([base[k] for k in item_kits], dtype=torch.int32, device=cuda)
    sf_k = torch.tensor([sf_index[k] for k in item_kits], dtype=torch.int32, device=cuda)
    length = mso.mso_waveform_length(32, 8.0, params)
    onset, row, gain = device_synth._extract_events(
        torch.from_numpy(_grids(rng, m)).to(cuda), torch.full((m,), 8.0, device=cuda), sf_base,
        length, 44100.0, luts, sf_k)
    before = device_synth.KERNEL.launches
    got = device_synth.synth_events(onset, row, gain, table, lengths, length)
    torch.cuda.synchronize()
    assert device_synth.KERNEL.launches == before + 1
    assert torch.equal(got, device_synth.synth_events_plain(onset, row, gain, table, length))
    assert bool(got.ne(0).any())


@pytest.mark.cuda
def test_front_end_and_server_with_kits_match_the_plain_route(cuda, rng, kits):
    hvos = _grids(rng, 20)
    qpms = np.linspace(80.0, 160.0, 20)
    item_kits = [kits[i % 3] for i in range(20)]
    got = mso.mso_batch_from_hvo(hvos, item_kits, qpms, device=cuda)
    plain = mso.mso_batch_from_hvo(hvos, item_kits, qpms, device="cpu", device_synth=True,
                                   method="fused")
    np.testing.assert_allclose(got, plain, atol=2e-5 * float(np.abs(plain).max()), rtol=1e-3)
    cfg = GrooveTransformerConfig(d_model=64, n_heads=4, dim_feedforward=128,
                                  num_encoder_layers=2)
    sd = build_model(cfg, "cpu", torch.Generator().manual_seed(0)).state_dict()
    card = InfillServer(sd, cfg, batch_sizes=(1, 4), device=cuda)
    cpu = InfillServer(sd, cfg, batch_sizes=(1, 4), device="cpu")
    answer = card.infill_from_hvo(hvos[:3], qpm=97.0, sf_path=kits[1])
    mso_cpu = mso.mso_batch_from_hvo(hvos[:3], [kits[1]] * 3, np.full(3, 97.0), device="cpu",
                                     device_synth=True, method="fused")
    np.testing.assert_allclose(answer[..., 9:], cpu.infill(mso_cpu)[..., 9:], atol=1e-4)


@pytest.mark.cuda
def test_front_end_on_the_card_matches_the_plain_and_host_routes(cuda, rng):
    hvos = _grids(rng, 70)
    qpms = np.linspace(60.0, 200.0, 70)
    counts = (device_synth.KERNEL.launches, band_energies.KERNEL.launches)
    got = mso.mso_batch_from_hvo(hvos, None, qpms, device=cuda, chunk_size=64)  # 64 + 6
    assert (device_synth.KERNEL.launches - counts[0],
            band_energies.KERNEL.launches - counts[1]) == (2, 2)
    scale = float(np.abs(got).max())
    plain = mso.mso_batch_from_hvo(hvos, None, qpms, device="cpu", device_synth=True,
                                   method="fused")
    host = mso.mso_batch_from_hvo(hvos, None, qpms, device="cpu")
    np.testing.assert_allclose(got, plain, atol=2e-5 * scale, rtol=1e-3)
    # the host mixer's onsets are f64, the device route's f32: hold the loops
    # whose onsets all agree to the same bar, the others (a sample shifted by
    # one position; 2.6 % of the scale measured on an H100) to 5e-2 of the scale
    length = mso.mso_waveform_length(32, qpms.min() / 15.0, mso.MSOParams())
    cells = np.arange(32)[None, :, None] + hvos[:, :, 18:]
    sps = qpms[:, None, None] / 15.0
    f64 = np.clip(cells / sps * 44100, 0, length - 1).astype(np.int64)
    f32 = np.clip(cells.astype(np.float32) / sps.astype(np.float32) * np.float32(44100),
                  0, length - 1).astype(np.int64)
    same = ((f64 == f32) | (hvos[:, :, :9] <= 0)).all(axis=(1, 2))
    assert same.sum() >= 35
    np.testing.assert_allclose(got[same], host[same], atol=2e-5 * scale, rtol=1e-3)
    np.testing.assert_allclose(got, host, atol=5e-2 * scale)
    for method in ("fft", "conv"):
        other = mso.mso_batch_from_hvo(hvos[:8], None, qpms[:8], device=cuda, method=method)
        np.testing.assert_allclose(got[:8], other, atol=2e-5 * scale, rtol=1e-3)


@pytest.mark.cuda
def test_audio_server_answers_hvo_input_through_every_kernel(cuda, rng):
    cfg = GrooveTransformerConfig(d_model=64, n_heads=4, dim_feedforward=128,
                                  num_encoder_layers=2)
    sd = build_model(cfg, "cpu", torch.Generator().manual_seed(0)).state_dict()
    card = InfillServer(sd, cfg, batch_sizes=(1, 4), device=cuda)
    cpu = InfillServer(sd, cfg, batch_sizes=(1, 4), device="cpu")
    assert device_synth.KERNEL.launches > 0  # the front end was warmed at start-up
    grids = _grids(rng, 3)
    counts = (device_synth.KERNEL.launches, band_energies.KERNEL.launches,
              attention.KERNEL.launches)
    got = card.infill_from_hvo(grids, qpm=97.0)
    assert (device_synth.KERNEL.launches - counts[0],
            band_energies.KERNEL.launches - counts[1],
            attention.KERNEL.launches - counts[2]) == (1, 1, cfg.num_encoder_layers)
    # the plain versions on the CPU, by the same (f32-onset) device route; the
    # CPU server's own route is the host mixer, whose f64 onsets may differ
    mso_cpu = mso.mso_batch_from_hvo(grids, None, np.full(3, 97.0), device="cpu",
                                     device_synth=True, method="fused")
    np.testing.assert_allclose(got[..., 9:], cpu.infill(mso_cpu)[..., 9:], atol=1e-4)


@pytest.mark.cuda
def test_audio_augmented_training_runs_every_kernel(cuda, rng):
    cfg = GrooveTransformerConfig(d_model=64, n_heads=2, dim_feedforward=128, dropout=0.3,
                                  num_encoder_layers=2, fused_layer=True)
    state = create_train_state(cfg, "sgd", 0.05, seed=0, device=cuda)
    base = torch.from_numpy(_grids(rng, 24)).to(cuda)
    augment = make_on_device_augment(qpms=np.linspace(90.0, 150.0, 24), mode="audio", chunk=16)
    epoch = make_epoch_fn(0.73, 8, 24, augment=augment)
    counts = (device_synth.KERNEL.launches, band_energies.KERNEL.launches)
    route = fused_layer.route_kernels(cfg.compute_dtype)
    before = {k: f.launches for k, f in route.items()}
    gen = torch.Generator(cuda).manual_seed(0)
    losses = [float(epoch(state, base, base, gen)["loss"]) for _ in range(4)]
    assert (device_synth.KERNEL.launches - counts[0],
            band_energies.KERNEL.launches - counts[1]) == (8, 8)  # 2 chunks × 4 epochs
    # each launch of the layer chain once a layer and step: 4 epochs × 3 steps × 2 layers
    assert {k: f.launches - before[k] for k, f in route.items()} == {k: 4 * 3 * 2 for k in route}
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def _ffn_args(cuda, rng, rows, d, ff, dtype):
    n = lambda *s, k=1.0: torch.from_numpy(  # noqa: E731
        (k * rng.standard_normal(s)).astype(np.float32)).to(cuda)
    return [n(rows, d).to(dtype), n(ff, d, k=d ** -0.5).to(dtype), n(ff, k=0.1),
            n(d, ff, k=ff ** -0.5).to(dtype), n(d, k=0.1)], n(rows, d).to(dtype)


def _ffn_launches(rows, d, ff, dtype, calls):
    """Launches of ``calls`` forward + backward passes, per kernel: each dtype
    runs two products forward, two in the row backward, one weight-gradient
    launch and the reduce of its row splits, on its own counters."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    config = fused_ffn.tile_configs(rows, d, ff, sms, dtype)[4]
    splits = fused_ffn.wgrad_splits(rows, d, ff, sms, config)[0]
    suffix = "" if dtype == torch.bfloat16 else "_f32"
    per = {k: 0 for k in fused_ffn.KERNELS}
    for name, _entry in fused_ffn.LAUNCHES:
        per[f"fused_ffn_{name}{suffix}"] = int(splits > 1) if name == "reduce" else 1
    return {k: calls * v for k, v in per.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, d, ff", [(1024, 256, 2048), (256, 1024, 4096), (100, 72, 200),
                                         (16384, 256, 2048), (4096, 1024, 4096)])
def test_ffn_kernels_match_the_plain_version(cuda, rng, rows, d, ff, dtype, rate):
    """out, h, dx and the four parameter gradients through the autograd
    Function, with the same mask; ragged rows and widths that are no multiples
    of the tiles; two runs bit-identical; the launches of each route (a bf16
    call never reaches the f32 kernels), at chip_smoke.py's FFN_SHAPES too."""
    args, dy = _ffn_args(cuda, rng, rows, d, ff, dtype)
    seed = torch.tensor([99], dtype=torch.int32, device=cuda)
    before = {k: f.launches for k, f in fused_ffn.KERNELS.items()}
    runs = []
    for _ in range(2):
        leaves = [a.clone().requires_grad_(True) for a in args]
        out = fused_ffn.ffn_train(*leaves, seed, rate)
        out.backward(dy)
        runs.append([out.detach(), *[leaf.grad for leaf in leaves]])
    torch.cuda.synchronize()
    assert {k: f.launches - before[k] for k, f in fused_ffn.KERNELS.items()} == \
        _ffn_launches(rows, d, ff, dtype, 2)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    h = fused_ffn.ffn_forward(*args, seed, rate)[1]
    with torch.no_grad():
        own_h = fused_ffn.ffn_reference(*args, seed, rate, return_hidden=True)[1]
    flips, _ = fused_layer.kink_flips(own_h, h)
    leaves = [a.clone().requires_grad_(True) for a in args]
    want = fused_ffn.ffn_reference(*leaves, seed, rate, relu_flips=flips)
    want.backward(dy)
    for got, ref in zip(runs[0], [want.detach(), *[leaf.grad for leaf in leaves]]):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        rel = 1e-4 if dtype == torch.float32 else 2e-2
        assert float((got.float() - ref.float()).abs().max()) <= rel * max(
            1.0, float(ref.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.16])
@pytest.mark.parametrize("rows, d, ff", [(1024, 256, 2048), (4096, 1024, 4096), (100, 36, 100)])
def test_ffn_f32_launches_match_the_reference_and_backward_formulas(cuda, rng, rows, d, ff, rate):
    """The f32 route's five products in split TF32 (and the reduce) at the lm
    config's and GrooveXL's shapes and at widths of 4 mod 8: out and h against
    ffn_reference with the kernel's side of each ReLU kink, the gradients
    against backward_formulas from the kernel's h, within 1e-4 (abs for out
    and h, of max|grad| for the gradients); two runs bit for bit; only the
    f32 counters move."""
    args, dy = _ffn_args(cuda, rng, rows, d, ff, torch.float32)
    x, w1, _, w2, _ = args
    seed = torch.tensor([31], dtype=torch.int32, device=cuda)
    before = {k: f.launches for k, f in fused_ffn.KERNELS.items()}
    runs = []
    for _ in range(2):
        out, h = fused_ffn.ffn_forward(*args, seed, rate)
        runs.append((out, h, *fused_ffn.ffn_backward(dy, x, h, w1, w2, rate)))
    torch.cuda.synchronize()
    assert {k: f.launches - before[k] for k, f in fused_ffn.KERNELS.items()} == \
        _ffn_launches(rows, d, ff, torch.float32, 2)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    out, h, *grads = runs[0]
    with torch.no_grad():
        own_h = fused_ffn.ffn_reference(*args, seed, rate, return_hidden=True)[1]
        flips, _ = fused_layer.kink_flips(own_h, h)
        want_out, want_h = fused_ffn.ffn_reference(*args, seed, rate, return_hidden=True,
                                                   relu_flips=flips)
        want = fused_ffn.backward_formulas(dy, x, h, w1, w2, rate)
    assert float((out - want_out).abs().max()) <= 1e-4
    assert float((h - want_h).abs().max()) <= 1e-4
    for got, ref in zip(grads, want):
        assert got.dtype == ref.dtype == torch.float32 and got.shape == ref.shape
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_ffn_bf16_kernels_launch_from_a_thread_that_made_no_cuda_call(cuda, rng):
    """The tensor maps are encoded by a driver call, which needs the thread's
    context bound; autograd runs a backward on a worker thread of its own,
    where no runtime call may have bound it yet."""
    import threading

    args, dy = _ffn_args(cuda, rng, 256, 128, 512, torch.bfloat16)
    seed = torch.tensor([4], dtype=torch.int32, device=cuda)
    out, h = fused_ffn.ffn_forward(*args, seed, 0.1)
    got = {}
    worker = threading.Thread(target=lambda: got.update(
        grads=fused_ffn.ffn_backward(dy, args[0], h, args[1], args[3], 0.1)))
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    want = fused_ffn.ffn_backward(dy, args[0], h, args[1], args[3], 0.1)
    assert all(torch.equal(a, b) for a, b in zip(got["grads"], want))


@pytest.mark.cuda
def test_ffn_bf16_route_refuses_widths_that_are_no_multiple_of_8(cuda, rng):
    """TMA's 16-byte strides: a bf16 call at d 36 raises ValueError and
    launches nothing (the f32 route takes d 36)."""
    args, _ = _ffn_args(cuda, rng, 64, 36, 128, torch.bfloat16)
    seed = torch.tensor([1], dtype=torch.int32, device=cuda)
    before = {k: f.launches for k, f in fused_ffn.KERNELS.items()}
    with pytest.raises(ValueError, match="supports_fused_ffn"):
        fused_ffn.ffn_train(*args, seed, 0.1)
    with pytest.raises(ValueError, match="supports_fused_ffn"):
        fused_ffn.ffn_forward(*args, seed, 0.1)
    torch.cuda.synchronize()
    assert {k: f.launches for k, f in fused_ffn.KERNELS.items()} == before
    f32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    fused_ffn.ffn_forward(*f32, seed, 0.1)
    assert fused_ffn.KERNELS["fused_ffn_fwd_h_f32"].launches == before["fused_ffn_fwd_h_f32"] + 1
    assert fused_ffn.KERNELS["fused_ffn_fwd_out_f32"].launches == \
        before["fused_ffn_fwd_out_f32"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1024, 256), (4, 32, 1024), (100, 72), (1, 256), (7, 256),
                                   (4096, 1024), (64, 20)])
def test_ln_kernels_match_the_plain_version(cuda, rng, shape, dtype, rate):
    n = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda)
    d = shape[-1]
    args = [n(*shape).to(dtype), n(*shape).to(dtype), 1 + 0.1 * n(d), 0.1 * n(d)]
    g = n(*shape).to(dtype)
    seed = torch.tensor([5], dtype=torch.int32, device=cuda)
    before = {k: f.launches for k, f in fused_ln.KERNELS.items()}
    runs = []
    for fn in (fused_ln.dropout_add_layernorm, fused_ln.dropout_add_layernorm,
               fused_ln.dropout_add_layernorm_reference):
        leaves = [a.clone().requires_grad_(True) for a in args]
        out = fn(*leaves, seed, rate)
        out.backward(g)
        runs.append([out.detach(), *[leaf.grad for leaf in leaves]])
    torch.cuda.synchronize()
    assert all(f.launches == before[k] + 2 for k, f in fused_ln.KERNELS.items())
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    for got, ref in zip(runs[0], runs[2]):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        rel = 1e-4 if dtype == torch.float32 else 2e-2
        assert float((got.float() - ref.float()).abs().max()) <= rel * max(
            1.0, float(ref.float().abs().max()))


def _graph_kernels(graph: torch.cuda.CUDAGraph) -> list:
    """The names of the kernel nodes of a captured graph (``keep_graph``),
    read through the driver: every launch the capture saw, none lost."""
    import ctypes

    drv = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert drv.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert drv.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            names.append(f"node type {kind.value}")
            continue
        params = (ctypes.c_void_p * 16)()  # CUDA_KERNEL_NODE_PARAMS: the function first
        name = ctypes.c_char_p()
        found = (drv.cuGraphKernelNodeGetParams(ctypes.c_void_p(node), params) == 0
                 and params[0] and hasattr(drv, "cuFuncGetName")
                 and drv.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params[0])) == 0)
        names.append(name.value.decode() if found else "kernel (name not readable)")
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("rows, d", [(7, 256), (16384, 256), (4096, 1024)])
def test_ln_backward_is_one_launch_and_reruns_bit_identical(cuda, rng, rows, d):
    """One kernel launch a backward, dscale and dbias included (no second
    launch sums the partials): a captured backward holds one kernel node,
    `ln_bwd`. Back-to-back launches and the graph's replays equal the first
    bit for bit, so the last blocks left the tickets at zero; a launch on
    another stream takes its own tickets and gives the same result."""
    n = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda)
    x, y, g = (n(rows, d).bfloat16() for _ in range(3))
    scale, seed = 1 + 0.1 * n(d), torch.tensor([3], dtype=torch.int32, device=cuda)
    first = fused_ln.ln_backward(g, x, y, scale, seed, 0.16)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        runs = [fused_ln.ln_backward(g, x, y, scale, seed, 0.16)]  # side's tickets made here
    torch.cuda.synchronize()
    before = fused_ln.KERNELS["fused_ln_bwd"].launches
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side, capture_error_mode="relaxed"):
        captured = fused_ln.ln_backward(g, x, y, scale, seed, 0.16)
    assert fused_ln.KERNELS["fused_ln_bwd"].launches == before + 1
    names = _graph_kernels(graph)
    assert len(names) == 1 and ("ln_bwd" in names[0] or "not readable" in names[0]), names
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        runs.append([t.clone() for t in captured])
    runs += [fused_ln.ln_backward(g, x, y, scale, seed, 0.16) for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs:
        assert all(torch.equal(a, b) for a, b in zip(first, run))
    assert all(int(t.abs().max()) == 0 for t in fused_ln._tickets.values())


@pytest.mark.cuda
def test_ffn_and_ln_kernels_refuse_what_they_do_not_take(cuda, rng):
    args, _ = _ffn_args(cuda, rng, 64, 64, 128, torch.float32)
    seed = torch.tensor([1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_ffn.ffn_train(args[0].cpu(), *args[1:], seed, 0.1)
    with pytest.raises(ValueError, match="x's dtype"):
        fused_ffn.ffn_train(args[0], args[1].bfloat16(), *args[2:], seed, 0.1)
    with pytest.raises(ValueError, match="supports_fused_ffn"):
        fused_ffn.ffn_train(args[0][:, :62].contiguous(), args[1][:, :62].contiguous(), args[2],
                            args[3][:62].contiguous(), args[4][:62].contiguous(), seed, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_ffn.ffn_train(args[0], args[3].t(), *args[2:], seed, 0.1)
    x = args[0]
    scale, bias = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_ln.dropout_add_layernorm(x, x.cpu(), scale, bias, seed, 0.1)
    with pytest.raises(ValueError, match="float32 scale"):
        fused_ln.dropout_add_layernorm(x, x, scale.bfloat16(), bias, seed, 0.1)
    with pytest.raises(ValueError, match="int32 seed"):
        fused_ln.dropout_add_layernorm(x, x, scale, bias, seed.long(), 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("n_dec", [0, 1])
def test_wide_ffn_train_steps_run_the_ffn_and_ln_kernels_and_remat_replays(cuda, rng, n_dec):
    """Two steps at d 256 / ff 2048 with fused_ffn and fused_dropout_ln: the
    launch counts per layer, and under remat the forward kernels twice and the
    same weights after the steps."""
    cfg = GrooveTransformerConfig(d_model=256, n_heads=2, dim_feedforward=2048, dropout=0.16,
                                  num_encoder_layers=2, num_decoder_layers=n_dec,
                                  compute_dtype=torch.bfloat16, fused_ffn=True,
                                  fused_dropout_ln=True)
    x = torch.from_numpy(rng.standard_normal((64, 32, 16)).astype(np.float32)).to(cuda)
    h = (rng.random((64, 32, 9)) < 0.3).astype(np.float32)
    y = torch.from_numpy(np.concatenate([h, h * 0.5, h * 0.1], 2)).to(cuda)
    kernels = {**fused_ffn.KERNELS, **fused_ln.KERNELS}
    weights = []
    for remat in (False, True):
        state = create_train_state(
            dataclasses.replace(cfg, remat=remat), "sgd", 0.05, 0, cuda)
        before = {k: f.launches for k, f in kernels.items()}
        epoch = make_epoch_fn(0.46, 32, 64, shuffle=False, encoder_only=not n_dec)
        metrics = epoch(state, x, y, torch.Generator(cuda).manual_seed(0))
        torch.cuda.synchronize()
        assert all(np.isfinite(float(v)) for v in metrics.values())
        ffn_sites, ln_sites = 2 + n_dec, 2 * 2 + 3 * n_dec
        want = {k: v * ffn_sites for k, v in _ffn_launches(32 * 32, 256, 2048, torch.bfloat16,
                                                           1).items()}
        want.update({k: want[k] * (1 + remat) for k in ("fused_ffn_fwd_h", "fused_ffn_fwd_out")})
        want.update({"fused_ln_fwd": ln_sites * (1 + remat), "fused_ln_bwd": ln_sites})
        assert {k: f.launches - before[k] for k, f in kernels.items()} == \
            {k: 2 * v for k, v in want.items()}
        weights.append([p.detach().clone() for p in state.model.parameters()])
    for a, b in zip(*weights):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * max(1.0, float(a.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["sgd", "adam"])
def test_snapshot_is_a_clone_the_next_step_does_not_change(cuda, rng, algorithm, tmp_path):
    """A save snapshot is a device copy enqueued before the next update:
    the step that follows rewrites the live parameters (and Adam's moments)
    in place, and the file still holds the state at the snapshot."""
    from transformergrooveinfilling_tpu_torch.models import torch_compat
    from transformergrooveinfilling_tpu_torch.train import checkpoint as ckpt

    cfg = GrooveTransformerConfig(d_model=256, n_heads=2, dim_feedforward=512, dropout=0.3,
                                  num_encoder_layers=2, compute_dtype=torch.bfloat16,
                                  fused_layer=True)
    state = create_train_state(cfg, algorithm, 0.05 if algorithm == "sgd" else 1e-3, 0, cuda)
    step = make_train_step(0.73)
    x = torch.from_numpy(rng.standard_normal((32, 32, 16)).astype(np.float32)).to(cuda)
    h = (rng.random((32, 32, 9)) < 0.3).astype(np.float32)
    y = torch.from_numpy(np.concatenate([h, h * 0.5, h * 0.1], 2)).to(cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    step(state, x, y, None, gen)
    want = torch_compat.optax_state_from_optimizer(state.optimizer, state.model, cfg)
    want_params = torch_compat.flax_params_from_state_dict(state.model.state_dict(), cfg)
    snap = ckpt.snapshot_state_on_device(state)
    step(state, x, y, None, gen)  # enqueued behind the copy, before the save reads it
    ckpt.save_snapshot_async(str(tmp_path), "snap", 1, snap, 0.5, cfg)
    ckpt.flush_async_saves()
    params, opt_state, epoch, _loss = ckpt.load_checkpoint(
        str(tmp_path / ckpt.CKPT_PATTERN.format("snap", 1)))
    now = torch_compat.flax_params_from_state_dict(state.model.state_dict(), cfg)
    assert epoch == 1
    assert not np.array_equal(now["output"]["proj"]["kernel"], params["output"]["proj"]["kernel"])
    for a, b in zip(_leaves(params), _leaves(want_params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(opt_state), _leaves(want)):
        np.testing.assert_array_equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [np.asarray(tree)]


@pytest.mark.cuda
def test_save_and_restore_round_trip_on_the_card_in_bf16(cuda, rng, tmp_path):
    """A bf16 run's checkpoint holds f32 parameters and a bfloat16 config;
    ``initialize_model(load_model=...)`` on the card restores the weights bit
    for bit and the run goes on through the bf16 layer chain."""
    from transformergrooveinfilling_tpu_torch.train import (
        checkpoint as ckpt, initialize_model, train_loop,
    )

    params = {"model": {"d_model": 256, "n_heads": 2, "dim_feedforward": 512, "dropout": 0.3,
                        "num_encoder_layers": 2, "embedding_size_src": 16, "optimizer": "adam"},
              "training": {"learning_rate": 1e-3, "batch_size": 32, "seed": 0}}
    bundle, _opt, epoch = initialize_model(params, cuda)
    assert bundle.config.compute_dtype == torch.bfloat16 and bundle.config.fused_layer

    class Data:
        processed_inputs = rng.standard_normal((64, 32, 16)).astype(np.float32)
        processed_outputs = (rng.random((64, 32, 27)) < 0.3).astype(np.float32)

    train_loop(Data, bundle, epoch=0, batch_size=32, save=True, ckpt_dir=str(tmp_path),
               run_id="bf16")
    assert ckpt.load_checkpoint_config(
        str(tmp_path / ckpt.CKPT_PATTERN.format("bf16", 0))).compute_dtype == torch.bfloat16
    resumed, _opt, epoch = initialize_model(dict(params, load_model={"dir": str(tmp_path)}),
                                            cuda)
    assert epoch == 1
    for (name, a), b in zip(bundle.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert b.device.type == "cuda" and torch.equal(a, b), name
    for p, q in zip(bundle.model.parameters(), resumed.model.parameters()):
        s, t = bundle.state.optimizer.state[p], resumed.state.optimizer.state[q]
        assert float(s["step"]) == float(t["step"]) == 2
        assert torch.equal(s["exp_avg"], t["exp_avg"]) and torch.equal(s["exp_avg_sq"],
                                                                       t["exp_avg_sq"])
    before = sum(k.launches for k in fused_layer.SM90_KERNELS.values())
    m = train_loop(Data, resumed, epoch=1, batch_size=32)
    torch.cuda.synchronize()
    assert np.isfinite(m["loss"])
    assert sum(k.launches for k in fused_layer.SM90_KERNELS.values()) > before


@pytest.mark.cuda
def test_streaming_producer_launches_on_its_own_stream(cuda, monkeypatch):
    """In audio mode the producer thread renders through kernels #6 and #7 on
    a stream of its own (each launch takes its calling thread's current
    stream), and its generation agrees with the route it runs, the device
    route, run on the CPU by the kernels' plain versions (phase 11's bar).
    The host route (numpy mixer, f64 onsets) is not that route: at these
    tempos one kick's onset falls a sample apart (126,004.98 samples, item 18
    at 126 qpm) and moves 13 values of step 24-25 by up to 0.078, in the JAX
    package's two routes alike (tests/test_torch_streaming.py)."""
    import functools
    import threading

    from transformergrooveinfilling_tpu_torch.data import synthetic
    from transformergrooveinfilling_tpu_torch.data.pipeline import StreamingAugmenter
    from transformergrooveinfilling_tpu_torch.ops import _build

    base = np.stack([s.hvo for s in synthetic.synthetic_gmd_sequences(16, seed=3)])
    qpms = np.linspace(90.0, 150.0, 16)
    seen = []
    launch = _build.CountedKernel.launch

    def spy(self, tensors, scalars, device):
        seen.append((threading.current_thread() is threading.main_thread(),
                     torch.cuda.current_stream(device).cuda_stream, self.entry))
        return launch(self, tensors, scalars, device)

    monkeypatch.setattr(_build.CountedKernel, "launch", spy)
    kw = dict(qpms=qpms, aug_per_item=2, mode="audio", seed=4)
    with StreamingAugmenter(base, device=cuda, **kw) as st:
        _sl, got_in, got_out = st.next_epoch_delta()
    # the device route's plain versions on the CPU (the CPU's default is the host route)
    monkeypatch.setattr(mso, "mso_batch_from_hvo",
                        functools.partial(mso.mso_batch_from_hvo, device_synth=True))
    with StreamingAugmenter(base, device="cpu", **kw) as st:
        _sl, want_in, want_out = st.next_epoch_delta()
    producer = {(stream, entry) for main, stream, entry in seen if not main}
    assert {entry for _s, entry in producer} == {"tgi_device_synth", "tgi_band_energies"}
    assert torch.cuda.default_stream(cuda).cuda_stream not in {s for s, _e in producer}
    assert np.array_equal(got_out, want_out)
    np.testing.assert_allclose(got_in, want_in, atol=2e-5 * np.abs(want_in).max(), rtol=1e-3)


RANK_ON_THE_CARD = """
import json, sys
import torch
from transformergrooveinfilling_tpu_torch.models import GrooveTransformerConfig, build_model
from transformergrooveinfilling_tpu_torch.parallel import (
    initialize_from_env, make_mesh, shard_params)
from transformergrooveinfilling_tpu_torch.parallel.multihost import context

assert initialize_from_env("cuda")
plan = make_mesh(n_model=2, device="cuda")
cfg = GrooveTransformerConfig(d_model=256, n_heads=2, dim_feedforward=512, dropout=0.0,
                              num_encoder_layers=2, use_fused_attention=True)
ref = build_model(cfg, plan.device, torch.Generator().manual_seed(1))
model = build_model(cfg, plan.device, torch.Generator().manual_seed(1))
shard_params(model, plan)
x = torch.randn(8, 32, 16, generator=torch.Generator().manual_seed(2)).to(plan.device)
with torch.no_grad():
    err = max(float((a - b).abs().max()) for a, b in zip(model(x), ref(x)))
print(json.dumps({"backend": plan.backend, "transport": plan.transport,
                  "device": str(plan.device), "ranks_on_node": context().ranks_on_node,
                  "err": err, "jax": "jax" in sys.modules}))
"""


@pytest.mark.cuda
def test_two_rank_group_on_the_card_follows_the_backend_rule(cuda, tmp_path):
    """Two ranks on the host's cards: NCCL where each has a card of its
    own, gloo with host-staged tensors where they share one; either way the
    tensor-parallel forward (#1 on one head a rank) equals one process's."""
    import json
    import sys

    from torch_parallel_group import launch

    outs = launch(2, lambda r: [sys.executable, "-c", RANK_ON_THE_CARD], str(tmp_path),
                  timeout=300)
    assert [rc for rc, _, _ in outs] == [0, 0], outs[0][2][-3000:] + outs[1][2][-3000:]
    ranks = [json.loads(o.strip().splitlines()[-1]) for _, o, _ in outs]
    shared = torch.cuda.device_count() < 2
    for r, rank in enumerate(ranks):
        assert rank["ranks_on_node"] == 2 and not rank["jax"]
        assert (rank["backend"], rank["transport"]) == (
            ("gloo", "host") if shared else ("nccl", "device"))
        assert rank["device"] == f"cuda:{0 if shared else r}"
        assert rank["err"] <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel, d, ff", [
    pytest.param(k, 64, 128, id=k)
    for k in ("fused_layer", "fused_decoder_layer", "fused_ffn", "fused_dropout_ln")] + [
    pytest.param(k, 512, 1024, id=f"{k}-512") for k in ("fused_layer", "fused_decoder_layer")])
def test_training_kernels_under_vmap_equal_unbatched_launches(cuda, kernel, d, ff, dtype):
    """Kernels #2-#5 through their operators' vmap rules, under
    ``vmap(grad_and_value(...), randomness="different")`` over 3 trials at
    rate 0.3: outputs and every gradient bit for bit those of 3 unbatched
    calls with each trial's seed, and 3 times a call's launches of each
    kernel (at d 512 the layers' wide route)."""
    from torch_vmap_cases import assert_equal, calls, trials, unbatched, vmapped

    counters = {"fused_layer": fused_layer.route_kernels(dtype, d),
                "fused_decoder_layer": fused_decoder_layer.route_kernels(dtype, d),
                "fused_ffn": fused_ffn.BF16_KERNELS if dtype == torch.bfloat16
                else fused_ffn.F32_KERNELS,
                "fused_dropout_ln": fused_ln.KERNELS}[kernel]
    call = calls(0.3, 2, 32)[kernel]
    args, dys, seeds = trials(kernel, 3, 19, dtype, cuda, d=d, ff=ff, rows=64)
    before = {n: f.launches for n, f in counters.items()}
    want = unbatched(call, args, dys, seeds)
    torch.cuda.synchronize()
    mid = {n: f.launches for n, f in counters.items()}
    grads, outs = vmapped(call, args, dys, seeds)
    torch.cuda.synchronize()
    for n, f in counters.items():  # the reduce of a row split launches where there are several
        assert f.launches - mid[n] == mid[n] - before[n], n
    assert sum(mid.values()) - sum(before.values()) >= 3 * 2
    assert_equal(grads, outs, want)


@pytest.mark.cuda
def test_flagship_group_with_fused_layer_under_remat_equals_the_group_without(cuda, rng):
    """A K 3 group at the flagship width (d 256, 2 heads, ff 512, 6 layers,
    bf16, rate 0.3) with ``fused_layer`` forced, 2 steps of batch 32 through
    ``make_batched_sweep_fn`` with ``remat=1`` and without: stacked
    parameters and losses bit for bit, and #2's forward launches twice a
    layer and trial under remat (the recompute), its backward launches once."""
    from transformergrooveinfilling_tpu_torch.train import vmap_sweep

    k, b, steps = 3, 32, 2
    cfg = GrooveTransformerConfig(d_model=256, n_heads=2, dim_feedforward=512, dropout=0.3,
                                  num_encoder_layers=6, embedding_size_src=16,
                                  compute_dtype=torch.bfloat16, fused_layer=True)
    x = torch.from_numpy(rng.standard_normal((steps * b, 32, 16)).astype(np.float32)).to(cuda)
    h = (rng.random((steps * b, 32, 9)) < 0.3).astype(np.float32)
    y = torch.from_numpy(np.concatenate([h, h * rng.random(h.shape),
                                         h * (rng.random(h.shape) - 0.5)], -1)).to(cuda)
    init = None
    runs = {}
    for remat in (False, True):
        config = dataclasses.replace(cfg, remat=remat)
        model = build_model(config, cuda)
        if init is None:
            init = vmap_sweep.init_stacked_params(model, config, k, torch.Generator().manual_seed(0),
                                                  cuda)
        fn = vmap_sweep.make_batched_sweep_fn(model, b, steps * b, 1, config=config,
                                              rates_as_data=False)
        on = dict(dtype=torch.float32, device=cuda)
        before = {n: f.launches for n, f in fused_layer.SM90_KERNELS.items()}
        params, losses = fn(init, (), torch.tensor([0.05, 0.089, 0.1], **on),
                            torch.tensor([0.73, 0.5, 0.9], **on), torch.tensor([0.3] * k, **on),
                            x, y, torch.Generator(cuda).manual_seed(1))
        torch.cuda.synchronize()
        runs[remat] = (params, losses, {n: f.launches - before[n]
                                        for n, f in fused_layer.SM90_KERNELS.items()})
    (p0, l0, n0), (p1, l1, n1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name
    forward = list(fused_layer.SM90_KERNELS)[:5]
    assert all(c == k * 6 * steps for c in n0.values()), n0
    assert n1 == {n: c * (2 if n in forward else 1) for n, c in n0.items()}, n1
