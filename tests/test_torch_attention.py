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


def _t_ids(*ts):
    """Sequence lengths, T 32 under no id of its own (the cases before T varied)."""
    return [pytest.param(t, id="") if t == 32 else pytest.param(t, id=f"T{t}") for t in ts]


@pytest.mark.parametrize("t", _t_ids(32, 48, 96, 128, 256, 1024))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["self", "cross"])
def test_strided_views_match_jax_fused_mha(rng, form, dtype, causal, t):
    """The slices of the packed projections go in without a copy, and the
    result is a (B, H, T, hd) view of a (B, T, H, hd) buffer; at the grid's
    T 32 and at loops of 3 to 64 bars (T 48 to 1,024: the kernel's long
    route on the card past T 64)."""
    b, h, hd = 2, 4, 16
    views, arrays = _packed(rng, b, t, h, hd, form)
    assert not any(x.is_contiguous() for x in views)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = port.fused_mha(*(x.to(tdt) if tdt != torch.float32 else x for x in views),
                         causal=causal)
    assert got.shape == (b, h, t, hd) and got.dtype == tdt
    assert got.transpose(1, 2).is_contiguous()  # stored as (B, T, H, hd)
    assert got.transpose(1, 2).reshape(b, t, h * hd).data_ptr() == got.data_ptr()
    want = jax_fused_mha(*(jnp.asarray(a, jdt) for a in arrays), interpret=True, causal=causal)
    # f32: 1e-5 (both sides f32 on the CPU; the worst case reads 6e-7); bf16:
    # the contiguous test's bar above
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mha_at_hd_512_matches_jax_fused_mha(rng, dtype, causal):
    """A d 512 model with one head: ``fused_mha`` at hd 512 on the slices of
    a packed qkv, against the JAX kernel in interpret mode, which takes any
    hd."""
    b, t, h, hd = 2, 32, 1, 512
    views, arrays = _packed(rng, b, t, h, hd, "self")
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = port.fused_mha(*(x.to(tdt) for x in views), causal=causal)
    assert got.shape == (b, h, t, hd) and got.dtype == tdt
    want = jax_fused_mha(*(jnp.asarray(a, jdt) for a in arrays), interpret=True, causal=causal)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [768, 1024])
def test_fused_mha_past_hd_512_matches_jax_fused_mha(rng, hd, dtype, causal):
    """Heads past 512 (a d 1,024 model with one head: hd 1,024), which the
    kernel streams through shared memory: ``fused_mha`` on the slices of a
    packed qkv against the JAX kernel in interpret mode, at the bars above."""
    b, t, h = 2, 32, 1
    views, arrays = _packed(rng, b, t, h, hd, "self")
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = port.fused_mha(*(x.to(tdt) for x in views), causal=causal)
    assert got.shape == (b, h, t, hd) and got.dtype == tdt
    want = jax_fused_mha(*(jnp.asarray(a, jdt) for a in arrays), interpret=True, causal=causal)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-5 if dtype == "float32" else 1e-2)


def test_tensor_core_path_selection(rng):
    """Every layout takes the tensor cores (bf16 ``mma.sync``, f32 in split
    TF32); what the layout picks is how the rows arrive: ``cp.async`` copies
    of 16 bytes where every stride, hd and base pointer allow them (the slices
    of a packed projection at hd a multiple of 8 in bf16, of 4 in f32), else
    of 8 or 4, and bf16 rows that allow none element by element."""
    views, _ = _packed(rng, 2, 32, 2, 128, "self")
    packed = [x.to(torch.bfloat16) for x in views]
    assert port.copy_bytes(*packed) == 16  # slices of (B, T, 3, H, 128)
    assert port.copy_bytes(*views) == 16  # f32
    demo = [torch.zeros(2, 4, 32, 8, dtype=torch.bfloat16)] * 3
    assert port.copy_bytes(*demo) == 16  # hd 8: zero-filled to the mma's 16
    assert port.copy_bytes(*[torch.zeros(3, 1, 17, 5)] * 3) == 4  # f32 hd 5
    assert port.copy_bytes(*[torch.zeros(3, 1, 17, 6)] * 3) == 8  # f32 hd 6
    assert port.copy_bytes(*[torch.zeros(3, 1, 17, 5, dtype=torch.bfloat16)] * 3) == 2
    base = torch.zeros(2 * 2 * 32 * 16 + 1, dtype=torch.bfloat16)
    shifted = base[1:].view(2, 2, 32, 16)  # rows 2 bytes off 16-byte alignment
    assert port.copy_bytes(*[base[:-1].view(2, 2, 32, 16)] * 3) == 16
    assert port.copy_bytes(shifted, shifted, shifted) == 2


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
    (lambda: [_meta((1, 2, 2049, 16))] * 3, "T ≤ 2048 \\(its ceiling\\)"),
    (lambda: [_meta((1, 2, 32, 0))] * 3, "hd ≥ 1"),
    (lambda: [_meta((0, 2, 32, 16))] * 3, "B·H ≥ 1"),
    (lambda: [_meta((1, 2, 16, 32)).transpose(2, 3)] * 3, "unit stride on hd"),
])
def test_check_kernel_args_rejects(make, match):
    with pytest.raises(ValueError, match=match):
        port.check_kernel_args(*make())


def test_kernel_args_accept_the_serving_shapes():
    for shape in ((1, 2, 32, 128), (512, 2, 32, 128), (32, 4, 32, 8),
                  (4, 1, 64, 256), (512, 1, 32, 512), (32, 1, 32, 1024), (2, 1, 64, 8192),
                  (1, 2, 128, 128), (512, 2, 128, 128), (512, 2, 1024, 128),
                  (1, 1, 2048, 1024)):
        for dtype in port.KERNEL_DTYPES:
            port.check_kernel_args(*[_meta(shape, dtype)] * 3)


def test_kernel_smem_bytes():
    # the ring: 4 stages of Q and K (then two chunks of V), T rows rounded up
    # to 16 each, 128 bytes of each row a stage: bf16 rows of 64 + 8 values,
    # f32 rows of 32 + 4; the warps' output staging tiles (16 such rows a
    # warp, a warp every 16 rows of T); in f32 the (T, T + 4) probabilities
    assert port.kernel_smem_bytes(32, torch.bfloat16) == (4 * 2 + 1) * 32 * 72 * 2 == 41472
    assert port.kernel_smem_bytes(32) == (4 * 2 + 1) * 32 * 36 * 4 + 4 * 32 * 36 == 46080
    # ragged T: 17 rows take two 16-row tiles
    assert port.kernel_smem_bytes(17) == port.kernel_smem_bytes(32)
    assert port.kernel_smem_bytes(16, torch.bfloat16) == (4 * 2 + 1) * 16 * 72 * 2
    # the largest block, T 64 in f32, is 98 KB, below the 227 KB a block may
    # take, and no size depends on hd
    assert port.kernel_smem_bytes(64) == (4 * 2 + 1) * 64 * 36 * 4 + 4 * 64 * 68 == 100352
    # past T 64, the long route: 3 stages, each the larger of (rows + 64 keys)
    # rows of a 64-byte chunk and 64 key rows of a 128-byte chunk; the four
    # warps' staging tiles of their share of 128 bytes; the (rows, T + 4) f32
    # scores, T rounded up to 64 keys. 64 rows a block up to T 256, 32 up to
    # 512, 16 past it: the same in both dtypes
    for dtype in port.KERNEL_DTYPES:
        assert port.kernel_smem_bytes(128, dtype) == 3 * 128 * 80 + 4 * 16 * 144 + 4 * 64 * 132
        assert port.kernel_smem_bytes(100, dtype) == port.kernel_smem_bytes(128, dtype)
        assert port.kernel_smem_bytes(256, dtype) == 106496
        assert port.kernel_smem_bytes(512, dtype) == 3 * 64 * 144 + 4 * 16 * 80 + 4 * 32 * 516
        assert port.kernel_smem_bytes(1024, dtype) == 3 * 64 * 144 + 4 * 16 * 48 + 4 * 16 * 1028
        # the ceiling's block, 162 KB, within the 227 KB a block may take
        assert port.kernel_smem_bytes(port.MAX_T, dtype) == 162048 <= 232448
        assert port.kernel_smem_bytes(256, dtype, hd=256) == 106496  # past FLASH_HD
    # heads up to FLASH_HD past T 64: the flash form, the same at every T and
    # hd, each row FLASH_HD values wide. 128 rows: bf16 two Q buffers of 128
    # rows × 256 bytes and 2 stages of K and V tiles of 128 keys; f32 Q with
    # its lo plane, a K tile of 32 keys with its lo plane, the V tile and its
    # two transposed planes. 64 rows (one wave at B 1): bf16 one Q buffer and 2
    # stages of 64-key tiles; f32 the same layout with 64-key tiles. Then the
    # mbarriers and 1,024 bytes of alignment; every block within 227 KB.
    for t in (65, 128, 1024, port.MAX_T):
        assert port.kernel_smem_bytes(t, torch.bfloat16, hd=128) == (
            2 * 128 * 256 + 2 * 2 * 128 * 256 + 8 * 12 + 1024) == 197728
        assert port.kernel_smem_bytes(t, hd=8) == (
            2 * 128 * 512 + 2 * 32 * 512 + 32 * 512 + 2 * 32 * 512 + 8 * 10 + 1024) == 214096
        assert port.kernel_smem_bytes(t, torch.bfloat16, hd=64, rows=64) == (
            64 * 256 + 2 * 2 * 64 * 256 + 8 * 10 + 1024) == 83024
        assert port.kernel_smem_bytes(t, hd=128, rows=64) == (
            2 * 64 * 512 + 2 * 64 * 512 + 64 * 512 + 2 * 64 * 512 + 8 * 10 + 1024) == 230480
    assert max(port.flash_smem_bytes(dtype, rows) for dtype in port.KERNEL_DTYPES
               for rows in (64, 128)) <= 232448
    assert port.kernel_smem_bytes(32, hd=128) == port.kernel_smem_bytes(32)  # the short route


def _meta_packed(b, t, h, hd, dtype, form, offset=0):
    """The model's projections as meta tensors: the (B, H, T, hd) slices of a
    packed qkv (``"self"``) or q and the slices of a packed kv (``"cross"``),
    their storage ``offset`` elements in."""
    def buf(*shape):
        n = int(np.prod(shape))
        return torch.empty(n + offset, dtype=dtype, device="meta")[offset:].view(*shape)

    if form == "self":
        return list(buf(b, t, 3, h, hd).permute(2, 0, 3, 1, 4))
    k, v = buf(b, t, 2, h, hd).permute(2, 0, 3, 1, 4)
    return [buf(b, t, h, hd).transpose(1, 2), k, v]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["self", "cross"])
@pytest.mark.parametrize("hd", [128, 64, 8])
def test_route_rule_sends_the_models_long_views_to_the_flash_form(hd, form, dtype):
    """Past T 64 the slices of the model's packed projections at heads up to
    FLASH_HD take the flash form (TMA reads them: hd·size, every stride and
    base 16-byte multiples); up to T 64 the short route."""
    for t in (65, 128, 1024, port.MAX_T):
        assert port.route(*_meta_packed(2, t, 2, hd, dtype, form)) == "flash"
    assert port.route(*_meta_packed(2, 64, 2, hd, dtype, form)) == "short"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["hd5", "hd1", "misaligned", "hd256", "stride0"])
def test_route_rule_sends_what_tma_cannot_read_to_the_scores_form(case, dtype):
    """hd 5 and hd 1 (rows no 16-byte multiple), a base 2 bytes off 16-byte
    alignment, a head past FLASH_HD and an expanded (stride 0) batch take the
    scores form, which takes any shape."""
    t = 128
    if case == "hd5":
        views = _meta_packed(2, t, 2, 5, dtype, "self")
    elif case == "hd1":
        views = [_meta((2, 16, t, 1), dtype)] * 3  # the sweep's d 16 / 16 heads
    elif case == "misaligned":
        views = _meta_packed(2, t, 2, 64, dtype, "self", offset=1)
        assert views[0].data_ptr() % 16 == dtype.itemsize
    elif case == "hd256":
        views = _meta_packed(2, t, 1, 256, dtype, "self")
    else:
        views = [_meta((1, 2, t, 64), dtype).expand(3, 2, t, 64)] * 3
    assert port.route(*views) == "scores"


def test_flash_rows_fill_one_wave_before_they_grow():
    # 64 rows where B·H·⌈T/64⌉ items fit in one wave of 132 SMs, else 128
    assert port.flash_rows(1, 2, 128, 132) == 64  # B 1 serving: 4 items
    assert port.flash_rows(1, 2, 2048, 132) == 64  # 64 items
    assert port.flash_rows(33, 2, 128, 132) == 64  # 132 items: one wave
    assert port.flash_rows(34, 2, 128, 132) == 128
    assert port.flash_rows(512, 2, 1024, 132) == 128


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
