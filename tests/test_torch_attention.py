"""Port's fused attention: the plain version against the JAX Pallas kernel
(interpret mode), the wrapper's CPU dispatch and argument checks, and the
kernel build's failure paths. The kernel itself is tested on the card by
tests/test_torch_cuda.py."""

import stat

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transformergrooveinfilling_tpu.ops.attention import fused_mha as jax_fused_mha
from transformergrooveinfilling_tpu_torch.ops import _build
from transformergrooveinfilling_tpu_torch.ops import attention as port


def _qkv(rng, shape, dtype=np.float32):
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 4, 32, 16), (1, 2, 32, 128)])
def test_mha_reference_matches_jax_fused_mha(rng, shape, causal):
    q, k, v = _qkv(rng, shape)
    want = jax_fused_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         interpret=True, causal=causal)
    got = port.mha_reference(*map(torch.from_numpy, (q, k, v)), causal=causal)
    # f32 on both sides; the bar is the JAX package's own kernel bar
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_bf16_matches_jax_fused_mha(rng, causal):
    q, k, v = _qkv(rng, (2, 4, 32, 16))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_fused_mha(jq, jk, jv, interpret=True, causal=causal)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = port.mha_reference(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    # both round p and the output to bf16 (8 bits): one output ulp at |o| ≤ 2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=1e-2)


def test_causal_row_zero_attends_only_itself(rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, (1, 1, 8, 4)))
    out = port.mha_reference(q, k, v, causal=True)
    torch.testing.assert_close(out[0, 0, 0], v[0, 0, 0])


def test_fused_mha_on_cpu_runs_the_plain_version_and_launches_nothing(rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, (2, 4, 32, 8)))
    before = port.KERNEL.launches
    for causal in (False, True):
        torch.testing.assert_close(port.fused_mha(q, k, v, causal=causal),
                                   port.mha_reference(q, k, v, causal=causal),
                                   rtol=0, atol=0)
    assert port.KERNEL.launches == before


def _packed(rng, b, t, h, hd, form):
    """The model's projections as numpy: a packed qkv ``(B, T, 3, H, hd)``
    (self-attention) or q ``(B, T, H, hd)`` and a packed kv ``(B, T, 2, H,
    hd)`` (cross-attention); returns the torch ``(B, H, T, hd)`` views the
    model passes and the contiguous numpy arrays of the same values."""
    if form == "self":
        qkv = rng.standard_normal((b, t, 3, h, hd)).astype(np.float32)
        views = torch.from_numpy(qkv).permute(2, 0, 3, 1, 4)
        return list(views), [a.transpose(0, 2, 1, 3).copy() for a in qkv.transpose(2, 0, 1, 3, 4)]
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    kv = rng.standard_normal((b, t, 2, h, hd)).astype(np.float32)
    k, v = torch.from_numpy(kv).permute(2, 0, 3, 1, 4)
    arrays = [q.transpose(0, 2, 1, 3)] + [a.transpose(0, 2, 1, 3)
                                           for a in kv.transpose(2, 0, 1, 3, 4)]
    return [torch.from_numpy(q).transpose(1, 2), k, v], [a.copy() for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["self", "cross"])
def test_strided_views_match_jax_fused_mha(rng, form, dtype, causal):
    """The slices of the packed projections go in without a copy, and the
    result is a (B, H, T, hd) view of a (B, T, H, hd) buffer."""
    b, t, h, hd = 2, 32, 4, 16
    views, arrays = _packed(rng, b, t, h, hd, form)
    assert not any(x.is_contiguous() for x in views)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = port.fused_mha(*(x.to(tdt) if tdt != torch.float32 else x for x in views),
                         causal=causal)
    assert got.shape == (b, h, t, hd) and got.dtype == tdt
    assert got.transpose(1, 2).is_contiguous()  # stored as (B, T, H, hd)
    assert got.transpose(1, 2).reshape(b, t, h * hd).data_ptr() == got.data_ptr()
    want = jax_fused_mha(*(jnp.asarray(a, jdt) for a in arrays), interpret=True, causal=causal)
    # the bars of the contiguous tests above
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-5 if dtype == "float32" else 1e-2)


def test_tensor_core_path_selection(rng):
    """bf16, hd a multiple of 16 and 16-byte aligned rows take the tensor
    cores; anything else the CUDA-core path of the same kernel."""
    views, _ = _packed(rng, 2, 32, 2, 128, "self")
    packed = [x.to(torch.bfloat16) for x in views]
    assert port.uses_tensor_cores(*packed)  # slices of (B, T, 3, H, 128)
    assert not port.uses_tensor_cores(*views)  # f32
    demo = [torch.zeros(2, 4, 32, 8, dtype=torch.bfloat16)] * 3
    assert not port.uses_tensor_cores(*demo)  # hd 8
    base = torch.zeros(2 * 2 * 32 * 16 + 1, dtype=torch.bfloat16)
    shifted = base[1:].view(2, 2, 32, 16)  # rows 2 bytes off 16-byte alignment
    assert port.uses_tensor_cores(*[base[:-1].view(2, 2, 32, 16)] * 3)
    assert not port.uses_tensor_cores(shifted, shifted, shifted)


def test_fused_mha_refuses_a_non_cuda_device_mix():
    q = torch.zeros(1, 2, 32, 16)
    k = torch.zeros(1, 2, 32, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        port.fused_mha(q, k, k)
    with pytest.raises(ValueError, match="CUDA device"):
        port.fused_mha(k, k, k)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("make, match", [
    (lambda: [_meta((1, 2, 32, 16), torch.float16)] * 3, "float32 or bfloat16"),
    (lambda: [_meta((1, 2, 32, 16)), _meta((1, 2, 32, 16), torch.bfloat16),
              _meta((1, 2, 32, 16))], "one dtype"),
    (lambda: [_meta((1, 2, 32, 16)), _meta((1, 2, 32, 8)), _meta((1, 2, 32, 16))],
     "shape"),
    (lambda: [_meta((2, 32, 16))] * 3, "shape"),
    (lambda: [_meta((1, 2, 65, 16))] * 3, "T ≤ 64"),
    (lambda: [_meta((1, 2, 32, 257))] * 3, "hd ≤ 256"),
    (lambda: [_meta((0, 2, 32, 16))] * 3, "B·H ≥ 1"),
    (lambda: [_meta((1, 2, 16, 32)).transpose(2, 3)] * 3, "unit stride on hd"),
])
def test_check_kernel_args_rejects(make, match):
    with pytest.raises(ValueError, match=match):
        port.check_kernel_args(*make())


def test_kernel_args_accept_the_serving_shapes():
    for shape in ((1, 2, 32, 128), (512, 2, 32, 128), (32, 4, 32, 8),
                  (4, 1, 64, 256)):
        for dtype in port.KERNEL_DTYPES:
            port.check_kernel_args(*[_meta(shape, dtype)] * 3)


def test_kernel_smem_bytes():
    # CUDA-core path, T 32, hd 256, f32: Q (16 rows), K (32), V (32) in rows of
    # 260 floats and the 16 × 32 scores ≈ 85 KB — above the 48 KB default, so
    # the kernel opts in to the larger carve-out
    assert port.kernel_smem_bytes(32, 256) == 4 * ((16 + 32 + 32) * 260 + 16 * 32) == 85248
    # ragged T and hd: T 17 → V and the scores padded to 20 keys; hd 5 → rows of 12
    assert port.kernel_smem_bytes(17, 5) == 4 * ((16 + 17 + 20) * 12 + 16 * 20)
    # tensor-core path: bf16 Q (16 rows), K and V (T rounded up to 16), rows of hd + 8
    assert port.kernel_smem_bytes(32, 128, tensor_cores=True) == 2 * (16 + 64) * 136 == 21760
    assert port.kernel_smem_bytes(17, 16, tensor_cores=True) == 2 * (16 + 64) * 24
    # the largest shape the kernel takes fits one block on both paths
    assert port.kernel_smem_bytes(64, 256) <= port.MAX_SMEM_BYTES
    assert port.kernel_smem_bytes(64, 256, tensor_cores=True) <= port.MAX_SMEM_BYTES


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_failure_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'fused_mha.cu(1): error: fake' >&2\nexit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)exit 2.*error: fake"):
        _build._build("fused_mha")
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").rglob("*"))


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    # a fake nvcc that "compiles" by writing its output file
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "build_info", {})
    first = _build._build("fused_mha")
    assert first.read_text() == "built\n" and first.parent.parent == tmp_path / "build"
    assert _build.build_info["fused_mha"]["seconds"] > 0
    assert _build._build("fused_mha") == first
    assert _build.build_info["fused_mha"]["log"] == "(cached)"
