"""The port's CUDA kernels, serving and training paths on an NVIDIA GPU.

Every test here is marked ``cuda`` and skips without a card. The file imports
torch and the port only (no JAX), so it also runs on a machine without JAX,
where the repository's conftest (which imports JAX) is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from transformergrooveinfilling_tpu_torch.models import GrooveTransformerConfig, build_model
from transformergrooveinfilling_tpu_torch.ops import attention, fused_layer
from transformergrooveinfilling_tpu_torch.serve import InfillServer
from transformergrooveinfilling_tpu_torch.train import create_train_state, make_train_step


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused_mha kernel has no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(8, 2, 32, 128), (8, 4, 32, 8), (2, 2, 64, 256),
                                   (3, 1, 17, 5)])
def test_kernel_matches_plain_version(cuda, rng, shape, dtype, tol, causal):
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    before = attention.fused_mha.launches
    got = attention.fused_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert attention.fused_mha.launches == before + 1
    want = attention.mha_reference(q, k, v, causal=causal)
    # f32: summation order only; bf16: p and the output rounded to 8 bits
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=0 if dtype == torch.float32 else tol)


@pytest.mark.cuda
def test_kernel_refuses_a_cpu_tensor_mix(cuda):
    q = torch.zeros(1, 2, 32, 16, device=cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        attention.fused_mha(q, q.cpu(), q)


@pytest.mark.cuda
def test_server_runs_every_layer_through_the_kernel(cuda, rng):
    cfg = GrooveTransformerConfig(d_model=64, n_heads=4, dim_feedforward=128,
                                  num_encoder_layers=2)
    torch.manual_seed(0)
    sd = build_model(cfg, "cpu").state_dict()
    fused = InfillServer(sd, cfg, batch_sizes=(1, 4), device=cuda)
    plain = InfillServer(sd, cfg, batch_sizes=(1, 4), device=cuda, use_kernel=False)
    x = rng.standard_normal((6, 32, 16)).astype(np.float32)
    before = attention.fused_mha.launches
    got = fused.infill(x)  # 6 → two chunks of bucket 4
    assert attention.fused_mha.launches - before == 2 * cfg.num_encoder_layers
    np.testing.assert_allclose(got[..., 9:], plain.infill(x)[..., 9:], atol=1e-4)


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


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t, d, h, ff, nseq", [(32, 256, 2, 512, 8), (32, 128, 2, 256, 4),
                                               (17, 64, 4, 96, 3), (32, 32, 4, 512, 2)])
def test_layer_kernels_match_the_twin(cuda, rng, t, d, h, ff, nseq, dtype, rate):
    """Forward, row backward and weight gradients against
    encoder_layer_reference (same masks; the kernel's side of the ReLU only
    at units within rounding of 0, kink_flips); f32: summation order only,
    bf16: the backward's rounding points differ from autograd's."""
    args, dy = _layer_inputs(cuda, rng, t, d, ff, nseq, dtype)
    seed = torch.tensor([99], dtype=torch.int32, device=cuda)
    before = {k: f.launches for k, f in fused_layer.KERNELS.items()}
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    y = fused_layer.encoder_layer_train(*leaves, seed, rate, h, t)
    y.backward(dy)
    torch.cuda.synchronize()
    assert {k: f.launches - before[k] for k, f in fused_layer.KERNELS.items()} == {
        k: 1 for k in fused_layer.KERNELS}
    res = fused_layer.layer_forward(*args, seed, rate, h, t)
    with torch.no_grad():
        own = fused_layer.encoder_layer_reference(*args, seed, rate, h, t, return_residuals=True)
    flips, _ = fused_layer.kink_flips(own[3], res[3])
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
        fused_layer.encoder_layer_train(*args, seed, 0.3, 2, 64)  # T beyond one block


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
    before = {k: f.launches for k, f in fused_layer.KERNELS.items()}
    gen = torch.Generator(cuda).manual_seed(0)
    losses = [float(step(state, x, y, None, gen)["loss"]) for _ in range(5)]
    assert {k: f.launches - before[k] for k, f in fused_layer.KERNELS.items()} == {
        k: 5 * 2 for k in fused_layer.KERNELS}
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
