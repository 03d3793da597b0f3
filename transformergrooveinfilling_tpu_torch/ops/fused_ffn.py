"""Fused feed-forward block for training: wrappers, plain version and gate.

Replaces the Pallas TPU kernels of ``transformergrooveinfilling_tpu/ops/
fused_ffn.py`` under ``ffn_train``: the forward in both its layouts
(``_fwd_call`` → ``_fwd_kernel`` with the weights resident in VMEM,
``_fwd_call_tiled`` → ``_fwd_kernel_tiled`` with the weights streamed as ff
tiles) and the backward (``_bwd_call`` → ``_bwd_kernel``):

    h = round(drop(relu(x·W1ᵀ + b1)));  out = h·W2ᵀ + b2
    g = dy·W2;  dh = round(where(h > 0, g / keep, 0));  dx = dh·W1
    dW1 = dhᵀ·x;  dW2 = dyᵀ·h;  db1 = Σ dh;  db2 = Σ dy

``h``, rounded to the compute dtype before the second product, is the only
intermediate that reaches device memory and the only activation the backward
keeps besides ``x``: ``h > 0`` says both that the mask kept the unit and that
the ReLU was active.

What bounds it on the H100: operations, 4·rows·d·ff FLOP a forward, as much
for the row backward and again for the weight gradients; only the tensor
cores come near that bound. So both dtypes (``csrc/fused_ffn.cu`` on the
``wgmma`` + TMA core of ``csrc/gemm_sm90.cuh``; f32 in split TF32, three TF32
products a product) run five products, each a
launch with its own epilogue: ``x·W1ᵀ`` → h (bias, ReLU, the mask, ÷ keep),
``h·W2ᵀ`` → out, ``dy·W2`` → dh, ``dh·W1`` → dx, and ``dhᵀ·x`` with ``dyᵀ·h``
and the bias sums in one launch whose row splits (:func:`wgrad_splits`) a
reduce adds in a fixed order (no float atomics: two runs with one seed agree
bit for bit). The TPU kernel fuses the two forward products to keep h in
VMEM; h reaches device memory anyway as the residual, and the fusion would
cost an on-chip f32 accumulator of the output, so the forward is two
launches. Tiles are 128 × 128, 64 × 64 where those would leave SMs idle, or
in bf16 128 × 256 where an epilogue reads nothing but the accumulator
(:func:`tile_configs`, by measurement; ``gemm_sm90.cuh`` builds no f32 tile
of 128 × 256). The f32 launches that reduce over ff (h·W2ᵀ, dh·W1) sum each
stage's products apart before they join the accumulator, as the weight
gradients do: the tensor cores truncate as they accumulate.

On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, phase 17; PERF.md §6),
bf16, each launch's device time: at rows 16,384 × d 256 × ff 2048 the
forward's products 0.088 and 0.046 ms, the backward's 0.101, 0.040 and 0.153
(and 0.005 of reduce); at GrooveXL's 4,096 × 1024 × 4096 0.086 and 0.060,
then 0.092, 0.049 and 0.143: 26-71 % of the tensor cores' bound. A call
takes 0.72-1.00 of the stream time of ``F.linear``·relu·``F.dropout``·
``F.linear`` forward and 0.25-0.61 of its autograd backward there (two
runs). f32: at rows 16,384 0.291 and 0.253 ms forward, 0.331, 0.284, 0.659
and 0.005 backward; at GrooveXL 0.490 and 0.482, then 0.550, 0.534 and
1.208: forward 38-43 % and backward 33-36 % of the split-TF32 bound (495 / 3
TFLOP/s); a call 0.57-0.95 of the library composition's stream time forward
(TF32 off) and 0.25-0.80 backward, at rows 1,024 too (two runs).

Dropout is the layer kernels' 8-bit rule and counter-based stream
(``ops/fused_layer.py::dropout_mask``, site ``SITE_FFN``, counted by row and
column of the hidden), not the TPU kernel's per-tile seeds: the mask does not
depend on the tiling, and :func:`ffn_reference` draws the same one. On CPU
tensors :func:`ffn_train` runs the plain forward and the backward's formulas in
plain PyTorch; on CUDA tensors it launches the kernels or raises.

Each direction is an operator, ``tgi::ffn_fwd`` (``(out, h)``) and
``tgi::ffn_bwd`` (dx and the weight and bias gradients flat), bound for
autograd by :class:`FfnTrain`; under ``torch.func.vmap`` their vmap rules
launch once per trial on its slices and seed (``ops/per_trial.py``).
Outside ``torch.func`` the wrapper takes :class:`_FfnTrain`, which launches
the kernels directly, as it did before the operators.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, per_trial
from .dropout import quantized_keep_rate, quantized_threshold
from .fused_layer import SITE_FFN, dropout_mask

# the tile shapes a product may take, (rows of C, columns of C) by
# csrc/fused_ffn.cu's `config`; a row split of the weight gradients is whole
# 64-row chunks (one bf16 stage, two f32 stages)
TILES = {0: (64, 64), 1: (128, 128), 2: (128, 256)}
# the two shapes csrc/fused_ffn.cu builds for each product, by dtype, in
# launch order (x·W1ᵀ, h·W2ᵀ, dy·W2, dh·W1, the weight gradients): those
# tile_configs picks. f32 has no 128 × 256 (its planes would not fit)
PRODUCT_TILES = {torch.bfloat16: ((0, 1), (0, 1), (0, 1), (0, 2), (1, 2)),
                 torch.float32: ((0, 1),) * 5}
K_STAGE = 64
WGRAD_MIN_STAGES = 4  # chunks a row split walks at least


# ---------------------------------------------------------------- plain version

def ffn_reference(x, w1, b1, w2, b2, seed, rate: float, return_hidden: bool = False,
                  relu_flips=None):
    """The kernels' math in plain PyTorch; its gradient is autograd's.

    ``x``: (rows, d); ``w1`` (ff, d) and ``w2`` (d, ff) in nn.Linear's
    (out, in) layout and ``x.dtype``; ``b1``, ``b2`` f32. Both products
    accumulate in f32; ``h`` is rounded to ``x.dtype`` after the dropout and
    before the second product, ``out`` at the end. With ``return_hidden``
    returns ``(out, h)``.

    ``relu_flips`` (rows, ff) bool, optional, for checks against the kernels:
    the hidden units at which this takes the other side of the ReLU's kink than
    its own ``hpre > 0`` (``ops/fused_layer.py::kink_flips``).
    """
    cd = x.dtype
    hpre = x.float() @ w1.float().t() + b1
    if relu_flips is None:
        hpre = torch.relu(hpre)
    else:
        hpre = hpre * ((hpre > 0) ^ relu_flips)
    if quantized_threshold(rate) < 256:
        mask = dropout_mask(seed, SITE_FFN, hpre.shape, rate)
        hpre = torch.where(mask, hpre / quantized_keep_rate(rate),
                           torch.zeros((), dtype=hpre.dtype, device=hpre.device))
    h = hpre.to(cd)
    out = (h.float() @ w2.float().t() + b2).to(cd)
    return (out, h) if return_hidden else out


def backward_formulas(dy, x, h, w1, w2, rate: float):
    """The backward kernels' formulas in plain PyTorch, from the residuals the
    Function keeps: ``(dx, dw1, db1, dw2, db2)``, weight and bias gradients in
    f32. ``dh`` is rounded to ``h.dtype`` before ``dx``, ``dw1`` and ``db1``."""
    dyf, hf = dy.float(), h.float()
    g = dyf @ w2.float()
    dh = torch.where(hf > 0, g / quantized_keep_rate(rate),
                     torch.zeros((), dtype=g.dtype, device=g.device)).to(h.dtype).float()
    return ((dh @ w1.float()).to(x.dtype), dh.t() @ x.float(), dh.sum(0),
            dyf.t() @ hf, dyf.sum(0))


# ---------------------------------------------------------------- gate

def supports_fused_ffn(d_model: int, dim_feedforward: int, dtype=torch.float32) -> bool:
    """Whether ``csrc/fused_ffn.cu`` takes this block in ``dtype``.

    Both dtypes run the same five products on the tensor cores, whose
    operands TMA reads with row strides of whole 16 bytes: d and ff
    multiples of 8 in bf16, of 4 in f32. Nothing else is asked: rows, d and
    ff are free, the tiles' ragged edges being TMA's zero fill, and no
    (rows, d) tile is kept on chip, so d has no cap. The TPU gate's rows % 8,
    d and ff multiples of 128 and the 4 MB of resident weights do not apply.
    """
    width = {torch.bfloat16: 8, torch.float32: 4}.get(dtype)
    return (width is not None and d_model >= width and dim_feedforward >= width
            and d_model % width == 0 and dim_feedforward % width == 0)


def tile_configs(rows: int, d: int, ff: int, n_sms: int,
                 dtype=torch.bfloat16) -> tuple[int, ...]:
    """The tile shape (a key of ``TILES``, one of ``PRODUCT_TILES[dtype]``)
    of each of the five products, in launch order: x·W1ᵀ, h·W2ᵀ, dy·W2,
    dh·W1, the weight gradients. By measurement (chip_smoke.py phase 17, all
    shapes at rows 1,024 / 16,384 and GrooveXL; PERF.md §6), bf16: 64 × 64
    where 128 × 128 tiles would give fewer than half the SMs one (rows 1,024:
    h·W2ᵀ 10.6 against 16.5 µs); 128 × 256 for dh·W1 (49.6 against 62.4 µs
    at GrooveXL) and for the weight gradients where those tiles alone fill
    the card (146.1 against 177.8); 128 × 128 otherwise, the epilogues that
    read a bias or h spilling at 128 × 256. f32 takes the same choice with
    128 × 128 in place of 128 × 256."""
    def small(n):
        return -(-rows // 128) * -(-n // 128) < n_sms // 2

    hidden, out = (0 if small(ff) else 1), (0 if small(d) else 1)
    if dtype == torch.float32:
        return hidden, out, hidden, out, 1
    wide = -(-ff // 128) * -(-d // 256) + -(-d // 128) * -(-ff // 256) >= n_sms
    return hidden, out, hidden, (0 if small(d) else 2), (2 if wide else 1)


def wgrad_splits(rows: int, d: int, ff: int, n_sms: int,
                 config: int | None = None) -> tuple[int, int]:
    """``(splits, rows_per_split)`` of the weight-gradient launch with tiles
    ``TILES[config]`` (by default those of :func:`tile_configs` in bf16).
    Its tiles of dW1 and dW2 take one block each; when they are fewer than
    the SMs, the rows are cut into splits of whole ``K_STAGE``-row chunks (at
    least ``WGRAD_MIN_STAGES``), every split non-empty."""
    if config is None:
        config = tile_configs(rows, d, ff, n_sms)[4]
    tm, tn = TILES[config]
    tiles = -(-ff // tm) * -(-d // tn) + -(-d // tm) * -(-ff // tn)
    stages = -(-rows // K_STAGE)
    splits = max(1, min(n_sms // tiles, stages // WGRAD_MIN_STAGES))
    per = -(-stages // splits) * K_STAGE
    return -(-rows // per), per


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------- kernels

# each C entry point's arguments before the stream: the five products end in
# the dtype flag (f32)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "tgi_ffn_fwd_h": [_P] * 5 + [_I] * 6, "tgi_ffn_fwd_out": [_P] * 4 + [_I] * 5,
    "tgi_ffn_bwd_dh": [_P] * 4 + [_I] * 6, "tgi_ffn_bwd_dx": [_P] * 3 + [_I] * 5,
    "tgi_ffn_bwd_wgrad": [_P] * 5 + [_I] * 7, "tgi_ffn_reduce": [_P] * 2 + [_I] * 2,
}


@functools.cache
def _kernels():
    lib = _build.load_library("fused_ffn")
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args + [_P]  # the stream last
        fn.restype = _I
    lib.tgi_ffn_error_string.argtypes = [_I]
    lib.tgi_ffn_error_string.restype = ctypes.c_char_p
    return lib


# One counter a launch type and dtype: two products forward, two in the row
# backward, one launch for both weight gradients and the biases, and the
# reduce of its row splits (when there are several). The f32 counters
# (names ending in _f32) launch the same entry points with f32 set.
LAUNCHES = (("fwd_h", "tgi_ffn_fwd_h"), ("fwd_out", "tgi_ffn_fwd_out"),
            ("bwd_dh", "tgi_ffn_bwd_dh"), ("bwd_dx", "tgi_ffn_bwd_dx"),
            ("bwd_weights", "tgi_ffn_bwd_wgrad"), ("reduce", "tgi_ffn_reduce"))
BF16_KERNELS, F32_KERNELS = (
    {f"fused_ffn_{name}{suffix}": _build.CountedKernel(_kernels, entry, "tgi_ffn_error_string")
     for name, entry in LAUNCHES} for suffix in ("", "_f32"))
KERNELS = {**BF16_KERNELS, **F32_KERNELS}


def route_kernels(dtype) -> dict:
    """The counters of ``dtype``'s launches, by launch type: ``{"fwd_h":
    kernel, ...}``."""
    kernels = BF16_KERNELS if dtype == torch.bfloat16 else F32_KERNELS
    return {name: kernels[f"fused_ffn_{name}" + ("" if dtype == torch.bfloat16 else "_f32")]
            for name, _ in LAUNCHES}


def _check(rows, w1, w2, vectors, seed=None) -> None:
    """Raise ``ValueError`` on what the kernels do not take: ``rows`` maps a
    name to a (rows, ·) tensor and its width, ``vectors`` the f32 biases."""
    x = next(iter(rows.values()))[0]
    tensors = [t for t, _ in rows.values()] + [w1, w2, *vectors] + ([seed] if seed is not None
                                                                   else [])
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("fused_ffn kernels need every tensor on one CUDA device; got "
                         f"{sorted({str(t.device) for t in tensors})}")
    ff, d = w1.shape if w1.dim() == 2 else (0, 0)
    if not supports_fused_ffn(d, ff, x.dtype) or x.shape[0] < 1:
        raise ValueError(f"fused_ffn kernels do not take d={d}, ff={ff}, {x.dtype}, "
                         f"{x.shape[0]} rows (supports_fused_ffn)")
    if tuple(w2.shape) != (d, ff) or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError(f"fused_ffn kernels take w1 (ff, d) and w2 (d, ff) in x's dtype; got "
                         f"{tuple(w1.shape)} {w1.dtype}, {tuple(w2.shape)} {w2.dtype}")
    widths = {"d": d, "ff": ff}
    for name, (t, width) in rows.items():
        if tuple(t.shape) != (x.shape[0], widths[width]) or t.dtype != x.dtype:
            raise ValueError(f"fused_ffn kernels take {name} of shape ({x.shape[0]}, {width}) "
                             f"in {x.dtype}; got {tuple(t.shape)} {t.dtype}")
    if any(v.dtype != torch.float32 for v in vectors):
        raise ValueError("fused_ffn kernels take float32 biases")
    if seed is not None and (seed.dtype != torch.int32 or seed.numel() != 1):
        raise ValueError("fused_ffn kernels take a one-element int32 seed")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_ffn kernels take contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused_ffn kernels take tensors 16-byte aligned (TMA)")


def ffn_forward(x, w1, b1, w2, b2, seed, rate: float):
    """Launch the forward: ``(out, h)``, two products on the tensor cores."""
    _check({"x": (x, "d")}, w1, w2, (b1, b2), seed)
    rows, d = x.shape
    ff = w1.shape[0]
    if b1.shape != (ff,) or b2.shape != (d,):
        raise ValueError(f"fused_ffn biases {tuple(b1.shape)}, {tuple(b2.shape)}, expected "
                         f"({ff},), ({d},)")
    out, h = torch.empty_like(x), x.new_empty((rows, ff))
    thresh, f32 = quantized_threshold(rate), int(x.dtype == torch.float32)
    tiles = tile_configs(rows, d, ff, _sm_count(x.device.index or 0), x.dtype)
    k = route_kernels(x.dtype)
    k["fwd_h"].launch((x, w1, b1, seed, h), (rows, d, ff, thresh, tiles[0], f32), x.device)
    k["fwd_out"].launch((h, w2, b2, out), (rows, d, ff, tiles[1], f32), x.device)
    return out, h


def ffn_backward(dy, x, h, w1, w2, rate: float):
    """Launch the backward: ``(dx, dw1, db1, dw2, db2)``, weight and bias
    gradients in f32: two row products, then one launch for the weight and
    bias gradients (and the reduce of its row splits)."""
    dy = dy.contiguous()
    _check({"x": (x, "d"), "dy": (dy, "d"), "h": (h, "ff")}, w1, w2, ())
    return _launch_backward_split(dy, x, h, w1, w2, rate)


def _launch_backward_split(dy, x, h, w1, w2, rate: float):
    """:func:`_launch_backward` with the gradients split as
    :func:`ffn_backward` returns them."""
    dx, grads = _launch_backward(dy, x, h, w1, w2, rate)
    return dx, *split_grads(grads, x.shape[1], w1.shape[0])


def _launch_backward(dy, x, h, w1, w2, rate: float):
    """:func:`ffn_backward` without its checks, for the backward of a
    forward that checked x, h and the weights, and with the weight and bias
    gradients as one flat f32 tensor, ``dw1, dw2, db1, db2`` in that order."""
    rows, d = x.shape
    ff = w1.shape[0]
    thresh, f32 = quantized_threshold(rate), int(x.dtype == torch.float32)
    sms = _sm_count(x.device.index or 0)
    dx, dh = torch.empty_like(x), torch.empty_like(h)  # dh: read by the weight gradients
    total = 2 * d * ff + ff + d
    grads = torch.empty(total, device=x.device, dtype=torch.float32)
    tiles = tile_configs(rows, d, ff, sms, x.dtype)
    k = route_kernels(x.dtype)
    k["bwd_dh"].launch((dy, w2, h, dh), (rows, d, ff, thresh, tiles[2], f32), x.device)
    k["bwd_dx"].launch((dh, w1, dx), (rows, d, ff, tiles[3], f32), x.device)
    splits, per = wgrad_splits(rows, d, ff, sms, tiles[4])
    part = (torch.empty((splits, total), device=x.device, dtype=torch.float32)
            if splits > 1 else grads)
    k["bwd_weights"].launch((dy, x, h, dh, part), (rows, d, ff, splits, per, tiles[4], f32),
                            x.device)
    if splits > 1:
        k["reduce"].launch((part, grads), (total, splits), x.device)
    return dx, grads


def split_grads(grads, d: int, ff: int):
    """The backward's flat f32 gradients → ``(dw1, db1, dw2, db2)`` views."""
    dw1, dw2, db1, db2 = grads.split([d * ff, d * ff, ff, d])
    return dw1.view(ff, d), db1, dw2.view(d, ff), db2


def _ffn_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor, seed: torch.Tensor,
             rate: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as an operator, ``(out, h)``: on CPU tensors
    :func:`ffn_reference`, else the launches of :func:`ffn_forward` (or its
    ``ValueError``)."""
    args = (x, w1, b1, w2, b2, seed)
    if all(t.device.type == "cpu" for t in args):
        return per_trial.apart(ffn_reference(*args, rate, return_hidden=True), args)
    return ffn_forward(*args, rate)


ffn_fwd_op = torch.library.custom_op("tgi::ffn_fwd", _ffn_fwd, mutates_args=())


@ffn_fwd_op.register_fake
def _ffn_fwd_fake(x, w1, b1, w2, b2, seed, rate):
    return torch.empty_like(x), x.new_empty((x.shape[0], w1.shape[0]))


def _ffn_bwd(dy: torch.Tensor, x: torch.Tensor, h: torch.Tensor, w1: torch.Tensor,
             w2: torch.Tensor, rate: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward as an operator, ``(dx, grads)``: ``grads`` the flat f32
    weight and bias gradients (:func:`split_grads`); on CPU tensors
    :func:`backward_formulas`, else the launches of :func:`ffn_backward`
    (whose checks of x, h and the weights the forward made)."""
    args = (dy, x, h, w1, w2)
    if all(t.device.type == "cpu" for t in args):
        dx, dw1, db1, dw2, db2 = backward_formulas(*args, rate)
        return per_trial.apart(
            (dx, torch.cat([dw1.reshape(-1), dw2.reshape(-1), db1, db2])), args)
    dy = dy.contiguous()
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device or dy.data_ptr() % 16:
        raise ValueError(f"fused_ffn backward takes dy like x; got {tuple(dy.shape)} {dy.dtype}")
    return _launch_backward(dy, x, h, w1, w2, rate)


ffn_bwd_op = torch.library.custom_op("tgi::ffn_bwd", _ffn_bwd, mutates_args=())


@ffn_bwd_op.register_fake
def _ffn_bwd_fake(dy, x, h, w1, w2, rate):
    ff, d = w1.shape
    return torch.empty_like(x), x.new_empty((2 * d * ff + ff + d,), dtype=torch.float32)


ffn_fwd_op.register_vmap(per_trial.rule(ffn_fwd_op))
ffn_bwd_op.register_vmap(per_trial.rule(ffn_bwd_op))


class _FfnTrain(torch.autograd.Function):
    """Saves x, h, w1 and w2 only, as the TPU kernel's ``_ffn_fwd`` does."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seed, rate):
        if x.device.type == "cpu":
            out, h = ffn_reference(x, w1, b1, w2, b2, seed, rate, return_hidden=True)
        else:
            out, h = ffn_forward(x, w1, b1, w2, b2, seed, rate)
        ctx.save_for_backward(x, h, w1, w2)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, dy):
        x, h, w1, w2 = ctx.saved_tensors
        if x.device.type == "cpu":
            run = backward_formulas
        else:
            dy = dy.contiguous()
            if dy.dtype != x.dtype or dy.shape != x.shape or dy.data_ptr() % 16:
                raise ValueError(f"fused_ffn backward takes dy like x; got {tuple(dy.shape)} "
                                 f"{dy.dtype}")
            run = _launch_backward_split
        dx, dw1, db1, dw2, db2 = run(dy, x, h, w1, w2, ctx.rate)
        # weight grads rounded to the weights' dtype, as _ffn_bwd does
        return dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2, None, None


class FfnTrain(torch.autograd.Function):
    """The two operators under autograd, for ``torch.func``: saves what
    :class:`_FfnTrain` saves, h travelling as the forward's second output.
    Under ``torch.func.vmap`` both run once per trial (``ops/per_trial.py``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w1, b1, w2, b2, seed, rate):
        return ffn_fwd_op(x, w1, b1, w2, b2, seed, rate)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w1, _b1, w2, _b2, _seed, rate = inputs
        ctx.save_for_backward(x, output[1], w1, w2)
        ctx.mark_non_differentiable(output[1])
        ctx.rate = rate

    @staticmethod
    def backward(ctx, dy, _dh):
        x, h, w1, w2 = ctx.saved_tensors
        with torch.no_grad():  # torch.func.grad records the backward otherwise
            dx, grads = ffn_bwd_op(dy, x, h, w1, w2, ctx.rate)
        dw1, db1, dw2, db2 = split_grads(grads, x.shape[-1], w1.shape[-2])
        # weight grads rounded to the weights' dtype, as _ffn_bwd does
        return dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2, None, None


def ffn_train(x, w1, b1, w2, b2, seed, rate: float):
    """Fused FFN for the training path: ``drop(relu(x·W1ᵀ + b1))·W2ᵀ + b2``.

    ``x``: (rows, d) in the compute dtype (f32 or bf16); ``w1`` (ff, d) and
    ``w2`` (d, ff) in nn.Linear's (out, in) layout (the JAX function takes
    their transposes) and the compute dtype; ``b1``, ``b2`` f32; ``seed`` a
    one-element int32 tensor (one per step and layer); ``rate`` the dropout
    rate on the hidden (the 8-bit rule of ``ops/dropout.py``). CPU tensors run
    the plain version (its backward the kernels' formulas in plain PyTorch);
    CUDA tensors the kernels, or it raises. Under ``torch.func.vmap`` each
    trial launches with its own slices and seed.
    """
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    tensors = (x, w1, b1, w2, b2, seed)
    if per_trial.transformed():
        per_trial.check_devices("fused_ffn", tensors)
        return FfnTrain.apply(*tensors, float(rate))[0]
    if not all(t.device.type == "cpu" for t in tensors) and x.device.type == "cpu":
        _check({"x": (x, "d")}, w1, w2, (b1, b2), seed)  # a mix: raises
    return _FfnTrain.apply(*tensors, float(rate))
