"""The launches of the bf16 whole-layer chains on Hopper: wrappers and plain versions.

``csrc/layer_sm90.cu`` holds the launches from which ``ops/fused_layer.py``
and ``ops/fused_decoder_layer.py`` build the encoder and decoder layers'
forward and backward in bf16 (their f32 route stays the CUDA-core kernels of
``csrc/fused_layer.cu`` and ``csrc/fused_decoder_layer.cu``). Every dense
product runs on the ``wgmma`` core of ``csrc/gemm_sm90.cuh`` with the layer's
elementwise work in its epilogue; the attention runs one block per (sequence,
head); the weight gradients of a layer are one grouped launch whose row
splits a reduce adds in a fixed order (no float atomics: two runs with one
seed agree bit for bit). See the source's note for what bounds each launch.

Each wrapper here is one launch: it takes the ``_build.CountedKernel`` to
launch through (so that each layer counts its own launches), runs the
launch's plain PyTorch version (the ``*_reference`` beside it, any device)
when every tensor lies on the CPU, and on CUDA tensors launches the kernel
or raises. Inside :func:`recording` each launch is also kept with its
arguments, outputs and plain version, for a check on the card. The plain
versions repeat the kernels' arithmetic: f32 sums, rounding to the activations' dtype where the
kernels round, the dropout masks of ``ops/fused_layer.py::dropout_mask``
counted by (site, global row, column) for the elementwise sites and by
((sequence·H + head)·T + i, j) for the attention's.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math

import torch

from . import _build
from .dropout import quantized_threshold

LN_EPS = 1e-5
LN_TILE = 256  # the LayerNorm epilogues' tile: one tile spans a row, d ≤ 256
MAX_T = 32  # the attention's block: two warps of 16 query rows, 32 padded keys
WGRAD_TILE = 128  # the weight gradients' (m, n) tile
K_STAGE = 64  # rows a stage of the weight gradients; a split is whole stages
WGRAD_MIN_STAGES = 4  # stages a row split walks at least
MAX_PROBLEMS = 8
MAX_SEGMENTS = 16
MAX_LN = 3


# ---------------------------------------------------------------- kernels

_P, _I = ctypes.c_void_p, ctypes.c_int
# each entry point's arguments before the stream (csrc/layer_sm90.cu)
SIGNATURES = {
    "tgi_sm90_bias": [_P] * 4 + [_I] * 4,
    "tgi_sm90_hidden": [_P] * 5 + [_I] * 6,
    "tgi_sm90_res_ln": [_P] * 9 + [_I] * 5,
    "tgi_sm90_dh": [_P] * 4 + [_I] * 5,
    "tgi_sm90_ln_bwd": [_P] * 10 + [_I] * 6,
    "tgi_sm90_round": [_P] * 4 + [_I] * 4,
    "tgi_sm90_ln_rows": [ctypes.POINTER(_P)] + [_I] * 5,
    "tgi_sm90_attn_fwd": [_P] * 5 + [_I] * 10,
    "tgi_sm90_attn_bwd": [_P] * 9 + [_I] * 13,
    "tgi_sm90_wgrad": [ctypes.POINTER(_P), ctypes.POINTER(_I)] + [_I] * 5 + [_P],
    "tgi_sm90_reduce": [_P, _P, ctypes.c_longlong, _I],
}


@functools.cache
def _library():
    lib = _build.load_library("layer_sm90")
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args + [_P]  # the stream last
        fn.restype = _I
    lib.tgi_sm90_error_string.argtypes = [_I]
    lib.tgi_sm90_error_string.restype = ctypes.c_char_p
    return lib


# the entry point of each launch type
ENTRIES = {"bias": "tgi_sm90_bias", "hidden": "tgi_sm90_hidden", "res_ln": "tgi_sm90_res_ln",
           "dh": "tgi_sm90_dh", "ln_bwd": "tgi_sm90_ln_bwd", "round": "tgi_sm90_round",
           "ln_rows": "tgi_sm90_ln_rows", "attn_fwd": "tgi_sm90_attn_fwd",
           "attn_bwd": "tgi_sm90_attn_bwd", "wgrad": "tgi_sm90_wgrad",
           "reduce": "tgi_sm90_reduce"}


def counted_kernels(prefix: str, launches: dict) -> dict:
    """``{prefix_name: CountedKernel}`` for ``launches`` = ``{name: launch
    type}`` (a key of ``ENTRIES``): one counter per launch of a layer."""
    return {f"{prefix}_{name}": _build.CountedKernel(_library, ENTRIES[kind],
                                                     "tgi_sm90_error_string")
            for name, kind in launches.items()}


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(t: torch.Tensor) -> int:
    return _sm_count(t.device.index if t.device.index is not None
                     else torch.cuda.current_device())


def product_config(rows: int, n: int, n_sms: int) -> int:
    """The tile shape of a row product (``gemm_sm90.cuh``'s ``run``): 64 × 64
    where 128 × 128 tiles would give fewer than half the SMs one, else
    128 × 128 (``ops/fused_ffn.py::tile_configs``' rule)."""
    return 0 if -(-rows // 128) * -(-n // 128) < n_sms // 2 else 1


def wgrad_splits(rows: int, shapes, n_sms: int) -> tuple[int, int]:
    """``(splits, rows_per_split)`` of a weight-gradient launch of the (m, n)
    ``shapes``: its 128 × 128 tiles take one block each; when they are fewer
    than the SMs, the rows are cut into splits of whole ``K_STAGE``-row stages
    (at least ``WGRAD_MIN_STAGES``), every split non-empty."""
    tiles = sum(-(-m // WGRAD_TILE) * -(-n // WGRAD_TILE) for m, n in shapes)
    stages = -(-rows // K_STAGE)
    splits = max(1, min(n_sms // tiles, stages // WGRAD_MIN_STAGES))
    per = -(-stages // splits) * K_STAGE
    return -(-rows // per), per


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU; raises unless they all lie on
    one CUDA device otherwise."""
    devices = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1:
        raise ValueError("layer_sm90 launches need every tensor on one CUDA device; got "
                         f"{sorted(str(d) for d in devices)}")
    return False


def _check(bf16=(), f32=(), views=()) -> None:
    """Raise ``ValueError`` on what the kernels do not take: ``bf16`` and
    ``f32`` are contiguous tensors of those dtypes, ``views`` bf16 matrices
    whose rows may be strided (columns contiguous); every bf16 tensor 16-byte
    aligned (TMA, cp.async) and its rows a multiple of 8 values apart."""
    for t in bf16:
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16 \
                or t.shape[-1] % 8:
            raise ValueError("layer_sm90 takes contiguous bf16 activations and weights, "
                             f"16-byte aligned, rows a multiple of 8; got {t.dtype} "
                             f"{tuple(t.shape)} stride {t.stride()}")
    for t in views:
        if t.dtype != torch.bfloat16 or t.dim() != 2 or t.stride(1) != 1 \
                or t.data_ptr() % 16 or t.stride(0) % 8:
            raise ValueError("layer_sm90's attention takes bf16 (rows, width) views with "
                             "contiguous columns, 16-byte aligned, rows a multiple of 8 "
                             f"values apart; got {t.dtype} {tuple(t.shape)} "
                             f"stride {t.stride()}")
    for t in f32:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"layer_sm90 takes contiguous f32 vectors and residual "
                             f"gradients; got {t.dtype} {tuple(t.shape)}")


def _site(v: torch.Tensor, seed, site: int, rate: float) -> torch.Tensor:
    """Plain dropout at an elementwise site of a (rows, cols) f32 ``v``."""
    thresh = quantized_threshold(rate)
    if thresh >= 256:
        return v
    from .fused_layer import dropout_mask

    mask = dropout_mask(seed, site, v.shape, rate)
    return torch.where(mask, v / (thresh / 256.0), torch.zeros((), dtype=v.dtype,
                                                                 device=v.device))


def _stats(a: torch.Tensor):
    """(mean, rstd) of each row of f32 ``a``, the one-pass variance clamped at
    0 (``layer_common.cuh::ln_stats``)."""
    mu = a.mean(-1, keepdim=True)
    var = torch.clamp((a * a).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return mu, torch.rsqrt(var + LN_EPS)


def _ln_backward(v, g, zh, rstd):
    """da = rstd·(dz − mean(dz) − ẑ·mean(dz·ẑ)), dz = v·g, per row."""
    dz = v * g
    return rstd * (dz - dz.mean(-1, keepdim=True) - zh * (dz * zh).mean(-1, keepdim=True))


# ---------------------------------------------------------------- recording

@dataclasses.dataclass
class Launch:
    """One launch made inside :func:`recording`: its counted kernel, its plain
    version and the arguments that reproduce its outputs, and ``replay``,
    which launches it again on the same inputs."""
    kernel: object
    reference: object
    args: tuple
    kwargs: dict
    outputs: tuple
    replay: object


_recorded: list | None = None


@contextlib.contextmanager
def recording():
    """Keep every launch made inside (CUDA tensors only) in the yielded list."""
    global _recorded
    saved, _recorded = _recorded, []
    try:
        yield _recorded
    finally:
        _recorded = saved


def _done(kernel, reference, args, outputs, replay, **kwargs):
    if _recorded is not None:
        _recorded.append(Launch(kernel, reference, args, kwargs,
                                outputs if isinstance(outputs, tuple) else (outputs,), replay))
    return outputs


# ---------------------------------------------------------------- products

def bias_reference(a, w, bias):
    return (a.float() @ w.float().t() + bias).to(a.dtype)


def bias_product(kernel, a, w, bias):
    """``round(a·wᵀ + bias)``: ``a`` (rows, k), ``w`` (n, k)."""
    if _on_cpu(a, w, bias):
        return bias_reference(a, w, bias)
    _check((a, w), (bias,))
    (rows, k), n = a.shape, w.shape[0]
    out = a.new_empty((rows, n))
    kernel.launch((a, w, bias, out), (rows, n, k, product_config(rows, n, _sms(a))), a.device)
    return _done(kernel, bias_reference, (a, w, bias), out,
                 lambda: bias_product(kernel, a, w, bias))


def hidden_reference(a, w, bias, seed, site: int, rate: float):
    return _site(torch.relu(a.float() @ w.float().t() + bias), seed, site, rate).to(a.dtype)


def hidden_product(kernel, a, w, bias, seed, site: int, rate: float):
    """``round(drop(relu(a·wᵀ + bias)))`` at dropout site ``site``."""
    if _on_cpu(a, w, bias, seed):
        return hidden_reference(a, w, bias, seed, site, rate)
    _check((a, w), (bias,))
    (rows, k), n = a.shape, w.shape[0]
    h = a.new_empty((rows, n))
    kernel.launch((a, w, bias, seed, h),
                  (rows, n, k, quantized_threshold(rate), site, product_config(rows, n, _sms(a))),
                  a.device)
    return _done(kernel, hidden_reference, (a, w, bias, seed, site, rate), h,
                 lambda: hidden_product(kernel, a, w, bias, seed, site, rate))


def residual_ln_reference(a, w, bias, resid, g, beta, seed, site: int, rate: float):
    s = resid.float() + _site(a.float() @ w.float().t() + bias, seed, site, rate)
    mu, rstd = _stats(s)
    return s.to(a.dtype), ((s - mu) * rstd * g + beta).to(a.dtype)


def residual_ln_product(kernel, a, w, bias, resid, g, beta, seed, site: int, rate: float):
    """``s = resid + drop(a·wᵀ + bias)`` at ``site``, then ``(round(s),
    round(LN(s)·g + beta))``, the statistics from the f32 ``s``. The width d
    (``w``'s rows) is at most ``LN_TILE``: one tile spans a row."""
    args = (a, w, bias, resid, g, beta, seed, site, rate)
    if _on_cpu(a, w, bias, resid, g, beta, seed):
        return residual_ln_reference(*args)
    _check((a, w, resid), (bias, g, beta))
    (rows, k), d = a.shape, w.shape[0]
    if d > LN_TILE:
        raise ValueError(f"layer_sm90's LayerNorm epilogue takes d ≤ {LN_TILE}; got {d}")
    a_out, y = a.new_empty((rows, d)), a.new_empty((rows, d))
    kernel.launch((a, w, bias, resid, g, beta, seed, a_out, y),
                  (rows, d, k, quantized_threshold(rate), site), a.device)
    return _done(kernel, residual_ln_reference, args, (a_out, y),
                 lambda: residual_ln_product(kernel, *args))


def dh_reference(df, w2, h, rate: float):
    g = (df.float() @ w2.float()) / (quantized_threshold(rate) / 256.0)
    return torch.where(h.float() > 0, g, torch.zeros((), device=g.device)).to(df.dtype)


def dh_product(kernel, df, w2, h, rate: float):
    """``round(h > 0 ? (df·w2)/keep : 0)``: the FFN hidden's gradient, ``w2``
    (d, ff), the ReLU's side and the mask recovered from ``h > 0``."""
    if _on_cpu(df, w2, h):
        return dh_reference(df, w2, h, rate)
    _check((df, w2, h))
    (rows, k), n = df.shape, w2.shape[1]
    dh = h.new_empty((rows, n))
    kernel.launch((df, w2, h, dh),
                  (rows, n, k, quantized_threshold(rate), product_config(rows, n, _sms(df))),
                  df.device)
    return _done(kernel, dh_reference, (df, w2, h, rate), dh,
                 lambda: dh_product(kernel, df, w2, h, rate))


def ln_backward_reference(a, w, resid, g, a_ln, stats, seed, site: int, rate: float):
    v = a.float() @ w.float() + resid
    mu, rstd = stats[:, 0:1], stats[:, 1:2]
    da = _ln_backward(v, g, (a_ln.float() - mu) * rstd, rstd)
    return da, v, _site(da, seed, site, rate).to(a.dtype)


def ln_backward_product(kernel, a, w, resid, g, a_ln, stats, seed, site: int, rate: float):
    """``v = a·w + resid``, the gradient at a LayerNorm's output, and the
    LayerNorm's backward from its stored input ``a_ln`` and that row's
    ``stats`` (a (rows, 2) f32 view: mean, rstd): ``(da, v, round(drop(da)))``,
    ``da`` and ``v`` in f32, the last at dropout site ``site``."""
    args = (a, w, resid, g, a_ln, stats, seed, site, rate)
    if _on_cpu(a, w, resid, g, a_ln, stats, seed):
        return ln_backward_reference(*args)
    _check((a, w, a_ln), (resid, g))
    if stats.dtype != torch.float32 or stats.stride(1) != 1:
        raise ValueError("layer_sm90 takes LayerNorm statistics as an f32 (rows, 2) view")
    (rows, k), d = a.shape, w.shape[1]
    if d > LN_TILE:
        raise ValueError(f"layer_sm90's LayerNorm epilogue takes d ≤ {LN_TILE}; got {d}")
    da, v = resid.new_empty((rows, d)), resid.new_empty((rows, d))
    dp = a.new_empty((rows, d))
    kernel.launch((a, w, resid, g, a_ln, stats, seed, da, v, dp),
                  (rows, d, k, stats.stride(0), quantized_threshold(rate), site), a.device)
    return _done(kernel, ln_backward_reference, args, (da, v, dp),
                 lambda: ln_backward_product(kernel, *args))


def round_reference(a, w, resid=None):
    out = a.float() @ w.float()
    return (out if resid is None else out + resid).to(a.dtype)


def round_product(kernel, a, w, resid=None):
    """``round(a·w + resid)``: ``w`` (k, n) in nn.Linear's (out, in) layout,
    so the product runs against the weight's transpose; ``resid`` an f32
    (rows, n) or None."""
    if _on_cpu(a, w, resid):
        return round_reference(a, w, resid)
    _check((a, w), () if resid is None else (resid,))
    (rows, k), n = a.shape, w.shape[1]
    out = a.new_empty((rows, n))
    kernel.launch((a, w, resid, out), (rows, n, k, product_config(rows, n, _sms(a))), a.device)
    return _done(kernel, round_reference, (a, w, resid), out,
                 lambda: round_product(kernel, a, w, resid))


# ---------------------------------------------------------------- LayerNorm rows

def ln_rows_reference(lns, dy, seed, site: int, rate: float):
    stats, ys = [], []
    for a, g, b, want in lns:
        af = a.float()
        mu, rstd = _stats(af)
        stats += [mu, rstd]
        zh = (af - mu) * rstd
        ys.append((zh * g + b).to(a.dtype) if want else None)
    da = _ln_backward(dy.float(), lns[-1][1], zh, rstd)
    return ys, torch.cat(stats, 1), da, _site(da, seed, site, rate).to(dy.dtype)


def ln_rows(kernel, lns, dy, seed, site: int, rate: float):
    """The backward's row pass over up to ``MAX_LN`` LayerNorms ``lns`` =
    ``[(a, g, b, want_y), ...]`` in the layer's order, ``a`` their stored
    inputs: ``(ys, stats, da, df)``. ``stats`` (rows, 2·len(lns)) f32 holds
    each one's (mean, rstd); ``ys[k]`` = round(LN(a)·g + b) where ``want_y``,
    else None; ``da`` (f32) is the last one's input gradient from ``dy`` and
    ``df`` = round(drop(da)) at ``site``."""
    if _on_cpu(*[t for a, g, b, _ in lns for t in (a, g, b)], dy, seed):
        return ln_rows_reference(lns, dy, seed, site, rate)
    _check([a for a, *_ in lns] + [dy], [t for _, g, b, _ in lns for t in (g, b)
                                          if t is not None])
    rows, d = dy.shape
    if not 1 <= len(lns) <= MAX_LN or d > LN_TILE:
        raise ValueError(f"layer_sm90's row pass takes 1 to {MAX_LN} LayerNorms of d ≤ "
                         f"{LN_TILE}; got {len(lns)} of {d}")
    ys = [dy.new_empty((rows, d)) if want else None for *_, want in lns]
    stats = torch.empty((rows, 2 * len(lns)), device=dy.device, dtype=torch.float32)
    da = torch.empty((rows, d), device=dy.device, dtype=torch.float32)
    df = dy.new_empty((rows, d))
    ptrs = []
    for (a, g, b, _), y in zip(lns, ys):
        ptrs += [a.data_ptr(), g.data_ptr(), None if b is None else b.data_ptr(),
                 None if y is None else y.data_ptr()]
    ptrs += [stats.data_ptr(), dy.data_ptr(), da.data_ptr(), df.data_ptr(), seed.data_ptr()]
    kernel.launch((), ((ctypes.c_void_p * len(ptrs))(*ptrs), len(lns), rows, d,
                       quantized_threshold(rate), site), dy.device)
    outputs = (*[y for y in ys if y is not None], stats, da, df)

    def reference(*args):
        r_ys, r_stats, r_da, r_df = ln_rows_reference(*args)
        return (*[y for y in r_ys if y is not None], r_stats, r_da, r_df)

    _done(kernel, reference, (lns, dy, seed, site, rate), outputs,
          lambda: ln_rows(kernel, lns, dy, seed, site, rate))
    return ys, stats, da, df


# ---------------------------------------------------------------- attention

def _heads(t, bsz, seq_len, n_heads):
    """(rows, d) → (B, H, T, hd), f32."""
    return t.float().reshape(bsz, seq_len, n_heads, -1).permute(0, 2, 1, 3)


def _probs(q, k, seq_len, causal):
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        above = torch.ones(seq_len, seq_len, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    return torch.softmax(s, dim=-1)


def _attn_site(p, seed, site, rate):
    """Dropout of (B, H, T, T) probabilities, row (seq·H + head)·T + i."""
    bsz, n_heads, t, _ = p.shape
    return _site(p.reshape(bsz * n_heads * t, t), seed, site, rate).reshape(p.shape)


def _attn_shape(q, rate, n_heads, seq_len, site, causal):
    rows, d = q.shape
    return (rows // seq_len, seq_len, n_heads, d // n_heads, quantized_threshold(rate), site,
            int(causal))


def _check_attention(q, k, v, seq_len, n_heads, *more):
    _check(views=(q, k, v, *more))
    rows, d = q.shape
    if k.stride(0) != v.stride(0) or not 1 <= seq_len <= MAX_T or rows % seq_len:
        raise ValueError(f"layer_sm90's attention takes T ≤ {MAX_T} and k, v of one row "
                         f"stride; got T {seq_len}, rows {rows}")
    if n_heads < 1 or d % n_heads or (d // n_heads) % 8:
        raise ValueError("layer_sm90's attention takes heads of a width that is a multiple "
                         f"of 8; got d {d}, {n_heads} heads")


def attention_forward_reference(q, k, v, seed, site: int, rate: float, n_heads: int,
                                seq_len: int, causal: bool):
    rows, d = q.shape
    bsz = rows // seq_len
    p = _probs(_heads(q, bsz, seq_len, n_heads), _heads(k, bsz, seq_len, n_heads), seq_len,
               causal)
    p = _attn_site(p, seed, site, rate).to(q.dtype).float()
    out = torch.matmul(p, _heads(v, bsz, seq_len, n_heads))
    return out.transpose(1, 2).reshape(rows, d).to(q.dtype)


def attention_forward(kernel, q, k, v, seed, site: int, rate: float, n_heads: int,
                      seq_len: int, causal: bool):
    """``round(round(drop(softmax(QKᵀ/√hd)))·V)`` per (sequence, head):
    ``q``, ``k``, ``v`` (rows, d) (views of packed projections), heads side by
    side in the columns, rows sequence-major; causal masks the future keys."""
    args = (q, k, v, seed, site, rate, n_heads, seq_len, causal)
    if _on_cpu(q, k, v, seed):
        return attention_forward_reference(*args)
    _check_attention(q, k, v, seq_len, n_heads)
    rows, d = q.shape
    out = q.new_empty((rows, d))
    nseq, t, h, hd, thresh, site_, causal_ = _attn_shape(q, rate, n_heads, seq_len, site,
                                                         causal)
    kernel.launch((q, k, v, out, seed), (q.stride(0), k.stride(0), d, nseq, t, h, hd, thresh,
                                         site_, causal_), q.device)
    return _done(kernel, attention_forward_reference, args, out,
                 lambda: attention_forward(kernel, *args))


def attention_backward_reference(q, k, v, da, seed, site: int, rate: float, n_heads: int,
                                 seq_len: int, causal: bool):
    """``(dq, dk, dv, out)`` of :func:`attention_backward`, as new tensors."""
    rows, d = q.shape
    bsz, cd = rows // seq_len, q.dtype
    qh, kh, vh = (_heads(t, bsz, seq_len, n_heads) for t in (q, k, v))
    dah = _heads(da, bsz, seq_len, n_heads)
    p = _probs(qh, kh, seq_len, causal)
    pd = _attn_site(p, seed, site, rate).to(cd).float()
    dp = _attn_site(torch.matmul(dah, vh.transpose(-1, -2)), seed, site, rate)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))
          * (1.0 / math.sqrt(qh.shape[-1]))).to(cd).float()

    def back(t):  # (B, H, T, hd) → (rows, d)
        return t.transpose(1, 2).reshape(rows, d).to(cd)

    return (back(torch.matmul(ds, kh)), back(torch.matmul(ds.transpose(-1, -2), qh)),
            back(torch.matmul(pd.transpose(-1, -2), dah)), back(torch.matmul(pd, vh)))


def attention_backward(kernel, q, k, v, da, dq, dk, dv, out, seed, site: int, rate: float,
                       n_heads: int, seq_len: int, causal: bool) -> None:
    """The attention's backward from ``da`` (rows, d) = d(its output),
    written into the views ``dq``, ``dk``, ``dv`` (each rounded, as dS is),
    and the attention output again into ``out`` (for the output
    projection's weight gradient)."""
    args = (q, k, v, da, seed, site, rate, n_heads, seq_len, causal)
    if _on_cpu(q, k, v, da, dq, dk, dv, out, seed):
        for dst, src in zip((dq, dk, dv, out), attention_backward_reference(*args)):
            dst.copy_(src)
        return
    _check_attention(q, k, v, seq_len, n_heads, da, dq, dk, dv, out)
    if dk.stride(0) != dv.stride(0):
        raise ValueError("layer_sm90's attention writes dk and dv of one row stride")
    rows, d = q.shape
    nseq, t, h, hd, thresh, site_, causal_ = _attn_shape(q, rate, n_heads, seq_len, site,
                                                         causal)
    kernel.launch((q, k, v, da, dq, dk, dv, out, seed),
                  (q.stride(0), k.stride(0), da.stride(0), dq.stride(0), dk.stride(0),
                   out.stride(0), nseq, t, h, hd, thresh, site_, causal_), q.device)
    _done(kernel, attention_backward_reference, args, (dq, dk, dv, out),
          lambda: attention_backward(kernel, q, k, v, da, dq, dk, dv, out, seed, site, rate,
                                     n_heads, seq_len, causal))


# ---------------------------------------------------------------- weight gradients

def _segment_sums(rows_slice, segments):
    sums = []
    for x, z, stats in segments:
        xs = x[rows_slice].float()
        if z is not None:
            st = stats[rows_slice]
            xs = xs * ((z[rows_slice].float() - st[:, 0:1]) * st[:, 1:2])
        sums.append(xs.sum(0))
    return sums


def weight_partials_reference(problems, segments, splits: int = 1, rows_per_split=None):
    """Per row split, each ``(dy, x)`` problem's dyᵀ·x and each segment's
    column sums in f32, flattened in order: ``(splits, total)``."""
    rows = (problems[0][0] if problems else segments[0][0]).shape[0]
    per = rows_per_split or -(-rows // splits)
    parts = []
    for s in range(splits):
        sl = slice(s * per, min(rows, (s + 1) * per))
        flat = [(dy[sl].float().t() @ x[sl].float()).reshape(-1) for dy, x in problems]
        parts.append(torch.cat(flat + _segment_sums(sl, segments)))
    return torch.stack(parts)


def reduce_reference(part: torch.Tensor) -> torch.Tensor:
    """Σ over the first axis, in its order."""
    out = part[0].clone()
    for p in part[1:]:
        out += p
    return out


def weight_gradients_reference(problems, segments, splits: int = 1, rows_per_split=None):
    """The plain version of :func:`weight_gradients`: the splits' partials
    added in split order."""
    return reduce_reference(weight_partials_reference(problems, segments, splits,
                                                      rows_per_split))


def weight_partials(kernel, problems, segments):
    """The weight-gradient launch: ``(part, splits, rows_per_split)``, part
    the (splits, total) f32 partials of :func:`weight_partials_reference`."""
    if not 1 <= len(problems) <= MAX_PROBLEMS or len(segments) > MAX_SEGMENTS:
        raise ValueError(f"layer_sm90's weight gradients take 1 to {MAX_PROBLEMS} products "
                         f"and {MAX_SEGMENTS} column sums; got {len(problems)}, {len(segments)}")
    _check([t for pr in problems for t in pr] + [z for _, z, _ in segments if z is not None])
    rows = problems[0][0].shape[0]
    ptrs, ints, total = [], [], 0
    for dy, x in problems:
        if dy.shape[0] != rows or x.shape[0] != rows:
            raise ValueError("layer_sm90's weight gradients take operands of one row count")
        ptrs += [dy.data_ptr(), x.data_ptr()]
        ints += [dy.shape[1], x.shape[1]]
        total += dy.shape[1] * x.shape[1]
    for x, z, stats in segments:
        if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous() \
                or x.shape[1] % 8 or (stats is not None and stats.stride(1) != 1):
            raise ValueError("layer_sm90's column sums take contiguous bf16 or f32 rows, a "
                             "multiple of 8 wide, and f32 (rows, 2) statistics")
        ptrs += [x.data_ptr(), None if z is None else z.data_ptr(),
                 None if stats is None else stats.data_ptr()]
        ints += [x.shape[1], int(x.dtype == torch.float32),
                 0 if stats is None else stats.stride(0)]
        total += x.shape[1]
    splits, per = wgrad_splits(rows, [(dy.shape[1], x.shape[1]) for dy, x in problems],
                               _sms(problems[0][0]))
    part = torch.empty((splits, total), device=problems[0][0].device, dtype=torch.float32)
    kernel.launch((), ((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
                       len(problems), len(segments), rows, splits, per, part.data_ptr()),
                  part.device)
    _done(kernel, weight_partials_reference, (problems, segments, splits, per), part,
          lambda: weight_partials(kernel, problems, segments))
    return part


def reduce_splits(kernel, part):
    """The reduce launch: Σ over ``part``'s first axis in its order."""
    out = torch.empty(part.shape[1], device=part.device, dtype=torch.float32)
    kernel.launch((part, out), (part.shape[1], part.shape[0]), part.device)
    return _done(kernel, reduce_reference, (part,), out, lambda: reduce_splits(kernel, part))


def weight_gradients(kernel, reduce_kernel, problems, segments):
    """Every weight gradient of a layer and its bias and LayerNorm-parameter
    sums in one launch, and the reduce of its row splits: a flat f32 vector of
    each ``(dy, x)`` problem's dyᵀ·x ((m, n) for dy (rows, m), x (rows, n)),
    then each ``(x, z, stats)`` segment's Σ_rows x·ẑ (ẑ = (z − mean)·rstd
    with ``stats`` a (rows, 2) f32 view, or 1 where z is None)."""
    tensors = [t for pr in problems for t in pr] + [t for sg in segments for t in sg]
    if _on_cpu(*tensors):
        return weight_gradients_reference(problems, segments)
    return reduce_splits(reduce_kernel, weight_partials(kernel, problems, segments))
