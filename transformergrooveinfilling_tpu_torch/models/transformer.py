"""Groove infilling transformer (``torch.nn``), both families, serving and training.

Counterpart of ``transformergrooveinfilling_tpu/models/transformer.py``:
Linear(src→d_model) embedding → ReLU → sinusoidal PE → dropout, N post-LN
encoder layers (packed-QKV self-attention, ReLU FFN), a final LayerNorm, and
Linear(d_model→3V) split into hit logits / velocity (sigmoid) / offset
(tanh·0.5). With ``num_decoder_layers > 0`` the encoder's normalised output is
the memory of a teacher-forced decoder: the target grid, shifted right behind
a zero start row, goes through its own input layer and N post-LN decoder layers
(causal self-attention, cross-attention over the memory, FFN), a final
LayerNorm and the same output head. Without a target (serving) the decoder
reads zeros, as the JAX model does.

Submodules carry the reference checkpoint's names
(``InputLayerEncoder.Linear``, ``Encoder.Encoder.layers.{i}.self_attn.
in_proj_weight``, ``...out_proj``, ``linear1``, ``linear2``, ``norm1``,
``norm2``, ``Encoder.Encoder.norm``, ``OutputLayer.Linear``; for the decoder
``InputLayerDecoder.Linear``, ``Decoder.Decoder.layers.{i}.{self_attn,
multihead_attn, linear1, linear2, norm1, norm2, norm3}``,
``Decoder.Decoder.norm``), so a legacy ``.Model`` state dict loads with
``load_state_dict(strict=True)`` once its stored PE buffers are dropped
(``models/torch_compat.py``).

Numerics follow the JAX model, including where it differs from torch's
``nn.TransformerEncoder``: the final LayerNorm uses flax's default eps 1e-6
(the per-layer ones torch's 1e-5), and ``compute_dtype=bfloat16`` runs every
projection as a bf16 product (weights cast at the op, storage stays f32)
while the LayerNorms, the final norm and the output head run in f32.
Parameters start as flax's do (:func:`init_parameters`).

``eval()`` mode is the JAX deterministic path: no dropout, and the training
switches (``fused_layer``, ``fused_ffn``, ``fused_dropout_ln``, ``remat``)
change nothing. ``train()`` mode is the JAX ``deterministic=False`` path:
``forward(src, generator)`` draws every dropout site from ``generator``
(``fast_dropout`` picks the 8-bit or the exact-rate rule), and
``fused_layer`` runs each encoder layer through ``ops/fused_layer.py`` and
``fused_decoder_layer`` each decoder layer through
``ops/fused_decoder_layer.py`` (the CUDA kernels on a CUDA tensor). On the
unfused path of either layer, ``fused_ffn`` runs the feed-forward block through
``ops/fused_ffn.py`` and ``fused_dropout_ln`` (at rate > 0) every
``LN(x + dropout(y))`` site through ``ops/fused_ln.py``, each with one seed
drawn from ``generator``; a forced switch whose kernel does not take the shape
raises ``ValueError``. ``remat`` runs each layer under
``torch.utils.checkpoint`` and replays ``generator`` in the recompute, so the
backward sees the masks of the forward; inside a ``torch.func`` transform,
where checkpoint's saved-tensor hooks raise, each layer runs through
:class:`_LayerRemat` instead, which replays it under ``torch.func.vjp``. No
switch changes a parameter's name or shape.

``forward(..., dropout_rate=r)`` overrides the config's rate at every dropout
site of a training forward with the 0-d tensor ``r`` (``ops/dropout.py::
fast_dropout_as_data``), as a traced rate does in the JAX model: what a
batched sweep (``train/vmap_sweep.py``) vmaps over, a rate per trial. The
kernel switches take the config's rate only and raise with a per-call one.
Under ``torch.func.vmap`` an inference forward's attention goes through the
operator ``tgi::fused_mha`` and its vmap rule (``ops/attention.py``), and a
training forward with a kernel switch on goes through that kernel's
operators, whose vmap rules launch once per trial with the trial's own seed
(``ops/per_trial.py``); nothing on that path reads a batched tensor's data.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch._C._functorch import is_batchedtensor
from torch.func import functional_call
from torch.utils import checkpoint as torch_checkpoint

from .. import require_device
from ..ops.attention import fused_mha, fused_mha_op, mha_reference
from ..ops.dropout import dropout as drop_site
from ..ops.fused_decoder_layer import decoder_layer_train, supports_fused_decoder_layer
from ..ops.fused_ffn import ffn_train, supports_fused_ffn
from ..ops.fused_layer import encoder_layer_train, supports_fused_layer
from ..ops.fused_ln import dropout_add_layernorm, supports_fused_ln
from ..ops.per_trial import transformed


@dataclasses.dataclass(frozen=True)
class GrooveTransformerConfig:
    """Hyperparameters, field for field the JAX package's config."""

    d_model: int = 32
    n_heads: int = 4
    dim_feedforward: int = 16
    dropout: float = 0.1
    num_encoder_layers: int = 6
    num_decoder_layers: int = 0  # 0 => encoder-only
    max_len: int = 32
    embedding_size_src: int = 16  # 16 = MSO bands; 27 for the symbolic experiment
    embedding_size_tgt: int = 27  # HVO width (9 voices × h/v/o)
    compute_dtype: torch.dtype = torch.float32
    # every layer's attention (encoder, decoder self and cross) through the
    # CUDA kernel (ops/attention.py::fused_mha; the JAX field is
    # use_pallas_attention)
    use_fused_attention: bool = False
    # training-path switches of the JAX config, acting in train() mode only:
    # fused_layer (encoder layers) and fused_decoder_layer (decoder layers)
    # take the whole layer; on a layer's unfused path fused_ffn takes the
    # feed-forward block and fused_dropout_ln (at rate > 0) each
    # LN(x + dropout(y)) site; remat recomputes each layer in the backward
    # (remat_policy None/"nothing": everything, "dots": all but the dense
    # products); eval() mode ignores them all
    remat: bool = False
    remat_policy: Optional[str] = None
    fused_dropout_ln: bool = False
    fast_dropout: bool = True
    fused_ffn: bool = False
    fused_layer: bool = False
    fused_decoder_layer: bool = False

    @property
    def encoder_only(self) -> bool:
        return self.num_decoder_layers == 0

    @property
    def n_voices(self) -> int:
        return self.embedding_size_tgt // 3


def sinusoidal_positional_encoding(max_len: int, d_model: int,
                                   device=None) -> torch.Tensor:
    """Standard sinusoidal PE, shape ``(1, max_len, d_model)``, float32.

    Computed on the host in f64 and cast to f32, as the JAX package does, so
    the buffer is identical on every device and to the JAX model's.
    """
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64)
        * (-math.log(10000.0) / d_model)
    )
    angles = position * div_term
    pe = np.zeros((max_len, d_model), np.float64)
    pe[:, 0::2] = np.sin(angles)
    pe[:, 1::2] = np.cos(angles[:, : d_model // 2])
    return torch.from_numpy(pe[None].astype(np.float32)).to(device)


def _linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """``x·Wᵀ + b`` in ``dtype`` (flax ``Dense(dtype=...)``: cast at the op).
    Inside a ``"dots"`` remat under ``torch.func`` (:class:`_DenseProducts`)
    the forward keeps the product and the recompute takes it back."""
    x, weight, bias = x.to(dtype), weight.to(dtype), bias.to(dtype)
    products = getattr(_dense_products, "active", None)
    if products is not None:
        return products(x, weight, bias)
    return F.linear(x, weight, bias)


def _new_linear(in_features: int, out_features: int, device) -> nn.Linear:
    """An ``nn.Linear`` whose parameters are left for :func:`init_parameters`
    (no draw from torch's global RNG)."""
    if device is None:
        device = torch.get_default_device()
    return nn.utils.skip_init(nn.Linear, in_features, out_features, device=device)


def _add_layer_norm(x: torch.Tensor, y: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """``LN(x + y)`` in f32, cast back to ``x.dtype`` (the JAX
    ``DropAddLayerNorm`` on its deterministic path)."""
    a = (x + y).float()
    return F.layer_norm(a, norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(x.dtype)


def _drop_add_layer_norm(x: torch.Tensor, y: torch.Tensor, norm: nn.LayerNorm,
                         rate: float, fast: bool, generator,
                         fused: bool = False) -> torch.Tensor:
    """``LN(x + dropout(y))`` on the training path, as the JAX
    ``DropAddLayerNorm``: f32 with the one-pass variance clamped at 0, or,
    with ``fused`` at rate > 0, ``ops/fused_ln.py`` (the exact-rate mask drawn
    inside from one seed, the two-pass variance)."""
    if fused and rate > 0.0:
        if not supports_fused_ln(x.shape[-1], x.dtype):
            raise ValueError(
                f"fused_dropout_ln=True, but the fused dropout+LayerNorm does not take "
                f"d_model={x.shape[-1]}, {x.dtype} (ops/fused_ln.py::supports_fused_ln)")
        return dropout_add_layernorm(
            x.contiguous(), y.contiguous(), norm.weight.float(), norm.bias.float(),
            _layer_seed(generator, x.device), float(rate))
    a = (x + drop_site(y, generator, rate, fast)).float()
    mu = a.mean(-1, keepdim=True)
    var = torch.clamp((a * a).mean(-1, keepdim=True) - mu * mu, min=0.0)
    zhat = (a - mu) * torch.rsqrt(var + norm.eps)
    return (zhat * norm.weight + norm.bias).to(x.dtype)


LECUN_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at ±2


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: a normal of variance 1/fan_in, cut at ±2 of its
    own scale (std √(1/fan_in) ÷ 0.8796…), drawn on the CPU from
    ``generator`` by the inverse CDF and copied to ``w``'s device."""
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0), -2.0, 2.0)
    std = math.sqrt(1.0 / fan_in) / LECUN_TRUNC_STD
    with torch.no_grad():
        w.copy_((z * std).to(torch.float32))


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter as the JAX package's ``model.init`` does:
    linear weights (``in_proj_weight`` included, fan_in = its input width)
    truncated-normal ``lecun_normal``, biases 0, LayerNorm scales 1 and
    biases 0. Draws come from the CPU ``generator`` in ``named_parameters``
    order, so the weights do not depend on the device."""
    norms = {id(m.weight) for m in model.modules() if isinstance(m, nn.LayerNorm)}
    with torch.no_grad():
        for _, p in model.named_parameters():
            if id(p) in norms:
                p.fill_(1.0)
            elif p.dim() == 2:
                _lecun_normal_(p, p.shape[1], generator)
            else:
                p.zero_()
    return model


class InputLayer(nn.Module):
    """Linear embed → ReLU → +PE → dropout (reference ``InputLayerEncoder``)."""

    def __init__(self, embedding_size_src: int, d_model: int, max_len: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.Linear = _new_linear(embedding_size_src, d_model, device)
        self.register_buffer(
            "pe", sinusoidal_positional_encoding(max_len, d_model, device),
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(_linear(x, self.Linear.weight, self.Linear.bias, self.dtype))
        return x + self.pe[:, : x.shape[-2]].to(x.dtype)


def attention_train(q, k, v, rate: float, fast: bool, generator,
                    causal: bool = False, tp=None) -> torch.Tensor:
    """Attention with dropout on the probabilities (the JAX unfused training
    path): f32 scores (``-1e9`` above the diagonal when ``causal``) and
    softmax, probabilities rounded to ``v.dtype``, then dropped and multiplied
    by V with f32 accumulation. ``tp``: the heads are one rank's part of a
    tensor-parallel layer (``parallel/tensor.py``), whose whole mask is
    drawn."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool, device=s.device).triu(1), -1e9)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    p = (drop_site(p, generator, rate, fast) if tp is None
         else tp.drop(p, generator, rate, fast, dim=1))
    return torch.matmul(p.float(), v.float()).to(q.dtype)


class SelfAttention(nn.Module):
    """Packed-QKV multi-head attention (torch ``nn.MultiheadAttention``
    parameter names: ``in_proj_weight`` rows ``[q; k; v]``, ``out_proj``).
    ``causal`` masks future positions (the decoder's teacher-forced
    self-attention). ``forward(x, kv=memory)`` is cross-attention: the first
    d rows of ``in_proj_weight`` project the queries from ``x``, the other 2d
    the keys and values from ``memory`` (the JAX module's ``q`` and packed
    ``kv`` projections).

    ``tp`` (set by ``parallel/tensor.py::shard_model``, None otherwise):
    the module holds one rank's heads of a tensor-parallel layer, and its
    output is the sum over the "model" group, the ``out_proj`` bias added
    once."""

    tp = None

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype,
                 use_fused: bool, device=None, causal: bool = False):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} not divisible by n_heads={n_heads}")
        self.n_heads = n_heads
        self.dtype = dtype
        self.causal = causal
        self.attend = fused_mha if use_fused else mha_reference
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * d_model, d_model, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model, device=device))
        self.out_proj = _new_linear(d_model, d_model, device)

    def forward(self, x: torch.Tensor, dropout=None, kv=None) -> torch.Tensor:
        """``dropout``: ``(rate, fast, generator)`` on the training path, where
        the probabilities are dropped and the plain attention runs (the JAX
        kernel path is deterministic only)."""
        tp = self.tp
        if tp is not None:
            x = tp.enter(x)
            kv = None if kv is None else tp.enter(kv)
        b, t, _ = x.shape
        h = self.n_heads
        w = self.in_proj_weight.shape[0] // 3  # h·hd: d_model, or this rank's heads
        # (B, H, T, hd) views of the packed projections, no copies: the
        # kernel reads them through their strides and writes its output as
        # (B, T, H, hd), so the transpose back below is a view as well
        if kv is None:
            qkv = _linear(x, self.in_proj_weight, self.in_proj_bias, self.dtype)
            q, k, v = qkv.view(b, t, 3, h, w // h).permute(2, 0, 3, 1, 4)
        else:
            q = _linear(x, self.in_proj_weight[:w], self.in_proj_bias[:w], self.dtype)
            q = q.view(b, t, h, w // h).transpose(1, 2)
            k_v = _linear(kv, self.in_proj_weight[w:], self.in_proj_bias[w:], self.dtype)
            k, v = k_v.view(b, kv.shape[1], 2, h, w // h).permute(2, 0, 3, 1, 4)
        if dropout is not None:
            out = attention_train(q, k, v, *dropout, causal=self.causal, tp=tp)
        elif self.attend is fused_mha and (torch.compiler.is_exporting()
                                           or is_batchedtensor(q)):
            # a traced forward (export.py) holds the kernel as one operator;
            # under vmap the operator's rule folds the trials into one launch
            out = fused_mha_op(q, k, v, self.causal)
        else:
            out = self.attend(q, k, v, self.causal)
        out = out.transpose(1, 2).reshape(b, t, w)
        if tp is None:
            return _linear(out, self.out_proj.weight, self.out_proj.bias, self.dtype)
        y = tp.reduce(F.linear(out.to(self.dtype), self.out_proj.weight.to(self.dtype)))
        return y + self.out_proj.bias.to(self.dtype)


def _ffn(layer: nn.Module, x: torch.Tensor, dropout=None) -> torch.Tensor:
    """``W2·Drop(relu(W1·x))`` of an encoder or decoder layer; ``dropout``:
    ``(rate, fast, generator)`` on the training path, where ``fused_ffn`` sends
    the whole block through ``ops/fused_ffn.py`` (JAX ``_ffn_block``): one
    seed per step and layer, weights cast to the compute dtype, biases f32.

    In a tensor-parallel layer (``layer.tp``, ``parallel/tensor.py``) the
    block runs on this rank's hidden units and its output is summed over the
    "model" group, the ``linear2`` bias added once; the fused FFN then takes
    the layer's seed plus the rank, so that the ranks' masks differ."""
    cfg = layer.config
    tp = layer.tp
    if tp is not None:
        x = tp.enter(x)
    b2 = layer.linear2.bias
    if dropout is not None and cfg.fused_ffn:
        rate, _, generator = dropout
        b, t, d = x.shape
        ff_width = layer.linear1.weight.shape[0]
        cd, f32 = layer.dtype, torch.float32
        if not supports_fused_ffn(d, ff_width, cd):
            raise ValueError(
                f"fused_ffn=True, but the fused FFN does not take d_model={d}, "
                f"dim_feedforward={ff_width}, {cd} "
                "(ops/fused_ffn.py::supports_fused_ffn)")
        seed = _layer_seed(generator, x.device)
        out = ffn_train(
            x.reshape(b * t, d).to(cd),
            layer.linear1.weight.to(cd), layer.linear1.bias.to(f32),
            layer.linear2.weight.to(cd), (b2 if tp is None else torch.zeros_like(b2)).to(f32),
            seed if tp is None else seed + tp.rank, float(rate)).reshape(b, t, d)
        return out if tp is None else tp.reduce(out) + b2.to(out.dtype)
    ff = torch.relu(_linear(x, layer.linear1.weight, layer.linear1.bias, layer.dtype))
    if dropout is not None:
        rate, fast, generator = dropout
        ff = (drop_site(ff, generator, rate, fast) if tp is None
              else tp.drop(ff, generator, rate, fast, dim=-1))
    if tp is None:
        return _linear(ff, layer.linear2.weight, b2, layer.dtype)
    return tp.reduce(F.linear(ff.to(layer.dtype), layer.linear2.weight.to(layer.dtype))) \
        + b2.to(layer.dtype)


# the training switches whose kernels take the config's dropout rate, a float
KERNEL_SWITCHES = ("fused_layer", "fused_decoder_layer", "fused_ffn", "fused_dropout_ln")
REMAT_POLICIES = (None, "nothing", "dots")
# what "dots" keeps from the forward: the dense products' outputs (JAX's
# dots_with_no_batch_dims_saveable: not the attention's batched products)
_DOT_OPS = ("mm", "addmm")


def _remat(config: "GrooveTransformerConfig", generator, layer, *tensors) -> torch.Tensor:
    """``layer(*tensors, generator)`` under ``torch.utils.checkpoint`` (JAX
    ``_remat_wrap``): the layer's activations are dropped after the forward and
    recomputed in the backward. checkpoint restores the global generators
    only, and the dropout sites draw from ``generator``: so the recompute runs
    from the state ``generator`` had before the forward, and puts the current
    state back afterwards. The fused kernels then get the same seeds and draw
    the same masks again."""
    before = generator.get_state()
    first = True

    def run(*args):
        nonlocal first
        if first:
            first = False
            return layer(*args, generator)
        now = generator.get_state()
        generator.set_state(before)
        try:
            return layer(*args, generator)
        finally:
            generator.set_state(now)

    kwargs = {}
    if config.remat_policy == "dots":
        ops = [getattr(torch.ops.aten, name).default for name in _DOT_OPS]
        kwargs["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, ops)
    return torch_checkpoint.checkpoint(run, *tensors, use_reentrant=False, **kwargs)


# the products a "dots" forward keeps, or a recompute takes back, on this thread
_dense_products = threading.local()


class _DenseProducts:
    """The dense products of one layer call under ``"dots"``: in the forward
    each runs and its output is kept; in the recompute (``kept`` given) the
    outputs are taken back in the same order, each through
    :class:`_KeptLinear`, so that its backward still runs."""

    def __init__(self, kept=None):
        self.replay = kept is not None
        self.kept = list(kept) if self.replay else []

    def __call__(self, x, weight, bias):
        if self.replay:
            return _KeptLinear.apply(self.kept.pop(0), x, weight, bias)
        out = F.linear(x, weight, bias)
        self.kept.append(out)
        return out


class _KeptLinear(torch.autograd.Function):
    """``F.linear(x, weight, bias)`` whose output was kept by the forward: it
    returns the kept tensor and differentiates as autograd differentiates
    ``F.linear`` of a (..., in) input (``addmm`` over the flattened rows:
    ``dx = dy·W``, ``dW = dyᵀ·x``, ``db = Σ dy``, the same products in the same
    layouts), so the gradients are those of the recompute bit for bit."""

    generate_vmap_rule = True

    @staticmethod
    def forward(kept, x, weight, bias):
        return kept.view_as(kept)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _kept, x, weight, _bias = inputs
        ctx.save_for_backward(x, weight)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1])
        dx = dy2.mm(weight).reshape(x.shape)
        dw = dy2.t().mm(x.reshape(-1, x.shape[-1]))
        return None, dx, dw, dy2.sum(0)


@contextlib.contextmanager
def _replaying(generator, state):
    """Run the block with ``generator`` at ``state`` (the one it had before
    the layer's forward) and put its current state back afterwards. A state
    taken or set inside a ``torch.func`` transform is a wrapped tensor that
    ``set_state`` refuses, so both happen with the transforms switched off."""
    with torch._C._DisableFuncTorch():
        now = generator.get_state()
        generator.set_state(state)
    try:
        yield
    finally:
        with torch._C._DisableFuncTorch():
            generator.set_state(now)


class _RematCall:
    """What :class:`_LayerRemat` needs beside its tensors: the layer, the
    generator and its state before the forward, the names of the layer's
    parameters, and how the tensors split into inputs, parameters and the
    per-trial rate."""

    def __init__(self, layer, generator, n_inputs: int, has_rate: bool, dots: bool):
        self.layer, self.generator = layer, generator
        self.names = [name for name, _ in layer.named_parameters()]
        self.n_inputs, self.has_rate, self.dots = n_inputs, has_rate, dots
        with torch._C._DisableFuncTorch():
            self.state = generator.get_state()

    def split(self, tensors):
        """``(inputs, parameters, rate)`` of :class:`_LayerRemat`'s tensors."""
        n, p = self.n_inputs, len(self.names)
        return tensors[:n], tensors[n:n + p], tensors[n + p] if self.has_rate else None

    def run(self, inputs, params, rate, products=None):
        """The layer's training forward on ``inputs`` with ``params``, its
        :func:`_linear` calls through ``products`` when given."""
        kwargs = {} if rate is None else {"dropout_rate": rate}
        _dense_products.active = products
        try:
            return functional_call(self.layer, dict(zip(self.names, params)),
                                   (*inputs, self.generator), kwargs)
        finally:
            _dense_products.active = None


class _LayerRemat(torch.autograd.Function):
    """One layer rematerialised inside a ``torch.func`` transform, where
    ``torch.utils.checkpoint`` raises (its saved-tensor hooks): the forward
    runs the layer without keeping its activations, and saves the layer's
    inputs and parameters (and, under ``"dots"``, the dense products'
    outputs, returned beside ``y``); the backward puts the generator back to
    its state before the forward, replays the layer under ``torch.func.vjp``
    from the saved tensors (the same dropout draws, so the fused kernels get
    the same seeds), puts the generator's later state back, and returns the
    cotangents. Under ``vmap`` both run on the stacked trials (the generated
    rule), so a trial's gradients are those of the step without remat."""

    generate_vmap_rule = True

    @staticmethod
    def forward(call, *tensors):
        products = _DenseProducts() if call.dots else None
        with torch.no_grad():
            y = call.run(*call.split(tensors), products)
        return (y, *(products.kept if products else ()))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.call = inputs[0]
        ctx.save_for_backward(*inputs[1:], *output[1:])
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, dy, *kept_grads):
        call = ctx.call
        saved = ctx.saved_tensors
        n = len(saved) - len(kept_grads)
        inputs, params, rate = call.split(saved[:n])

        def layer(inputs, params):
            products = _DenseProducts(saved[n:]) if call.dots else None
            return call.run(inputs, params, rate, products)

        with _replaying(call.generator, call.state):
            _y, vjp = torch.func.vjp(layer, tuple(inputs), tuple(params))
        # no graph of the gradients (the Function has no double backward), and
        # the replay's activations freed as its backward consumes them: under
        # torch.func.grad the engine runs a backward with grad mode on, which
        # would otherwise keep every layer's replay alive until the step ends
        d_inputs, d_params = vjp(dy, retain_graph=False, create_graph=False)
        return (None, *d_inputs, *d_params, *((None,) if call.has_rate else ()))


def _remat_transformed(config: "GrooveTransformerConfig", generator, layer, dropout_rate,
                       *tensors) -> torch.Tensor:
    """``layer(*tensors, generator)`` rematerialised under a ``torch.func``
    transform (:class:`_LayerRemat`): the route of a batched sweep's step."""
    call = _RematCall(layer, generator, len(tensors), dropout_rate is not None,
                      config.remat_policy == "dots")
    params = [p for _, p in layer.named_parameters()]
    rate = () if dropout_rate is None else (dropout_rate,)
    return _LayerRemat.apply(call, *tensors, *params, *rate)[0]


def _rate(config: "GrooveTransformerConfig", dropout_rate):
    """The rate of a training forward's dropout sites: the per-call tensor
    when one is given, else the config's."""
    return config.dropout if dropout_rate is None else dropout_rate


def _layer_seed(generator, device) -> torch.Tensor:
    """One int32 seed for a fused layer's dropout stream (per step and layer)."""
    return torch.randint(0, 2**31 - 1, (1,), generator=generator, device=device,
                         dtype=torch.int32)


class EncoderLayer(nn.Module):
    """Post-LN encoder layer, torch 1.10 ``TransformerEncoderLayer``:
    ``x = LN(x + Drop(SA(x))); x = LN(x + Drop(W2·Drop(relu(W1·x))))``.
    ``tp``: as :class:`SelfAttention`'s."""

    tp = None

    def __init__(self, config: GrooveTransformerConfig, device=None):
        super().__init__()
        cfg = self.config = config
        self.dtype = cfg.compute_dtype
        self.self_attn = SelfAttention(cfg.d_model, cfg.n_heads, cfg.compute_dtype,
                                       cfg.use_fused_attention, device)
        self.linear1 = _new_linear(cfg.d_model, cfg.dim_feedforward, device)
        self.linear2 = _new_linear(cfg.dim_feedforward, cfg.d_model, device)
        self.norm1 = nn.LayerNorm(cfg.d_model, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(cfg.d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, generator=None, dropout_rate=None) -> torch.Tensor:
        if not self.training:
            x = _add_layer_norm(x, self.self_attn(x), self.norm1)
            return _add_layer_norm(x, _ffn(self, x), self.norm2)
        cfg = self.config
        if cfg.fused_layer:
            return self._fused(x, generator)
        drop = (_rate(cfg, dropout_rate), cfg.fast_dropout, generator)
        fused_ln = cfg.fused_dropout_ln
        x = _drop_add_layer_norm(x, self.self_attn(x, dropout=drop), self.norm1, *drop, fused_ln)
        return _drop_add_layer_norm(x, _ffn(self, x, drop), self.norm2, *drop, fused_ln)

    def _fused(self, x: torch.Tensor, generator) -> torch.Tensor:
        """The whole layer through ``ops/fused_layer.py`` (JAX
        ``EncoderLayer``'s fused dispatch), one seed per step and layer."""
        cfg = self.config
        b, t, d = x.shape
        cd = self.dtype
        if self.tp is not None:
            raise NotImplementedError("fused_layer on a tensor-parallel layer: the "
                                      "whole-layer kernels take an unsplit layer")
        if not supports_fused_layer(d, cfg.n_heads, cfg.dim_feedforward, t, cd):
            raise ValueError(
                f"fused_layer=True, but the fused layer does not take d_model={d}, "
                f"n_heads={cfg.n_heads}, dim_feedforward={cfg.dim_feedforward}, "
                f"T={t}, {cd} (ops/fused_layer.py::supports_fused_layer)")
        seed = _layer_seed(generator, x.device)
        sa, f32 = self.self_attn, torch.float32
        y = encoder_layer_train(
            x.reshape(b * t, d).to(cd),
            sa.in_proj_weight.to(cd), sa.in_proj_bias.to(f32),
            sa.out_proj.weight.to(cd), sa.out_proj.bias.to(f32),
            self.norm1.weight.to(f32), self.norm1.bias.to(f32),
            self.linear1.weight.to(cd), self.linear1.bias.to(f32),
            self.linear2.weight.to(cd), self.linear2.bias.to(f32),
            self.norm2.weight.to(f32), self.norm2.bias.to(f32),
            seed, float(cfg.dropout), cfg.n_heads, t)
        return y.reshape(b, t, d).to(x.dtype)


class DecoderLayer(nn.Module):
    """Post-LN decoder layer, torch 1.10 ``TransformerDecoderLayer``:
    ``y = LN(y + Drop(SA_causal(y))); y = LN(y + Drop(CA(y, memory)));
    y = LN(y + Drop(W2·Drop(relu(W1·y))))``. ``tp``: as :class:`SelfAttention`'s."""

    tp = None

    def __init__(self, config: GrooveTransformerConfig, device=None):
        super().__init__()
        cfg = self.config = config
        self.dtype = cfg.compute_dtype
        self.self_attn = SelfAttention(cfg.d_model, cfg.n_heads, cfg.compute_dtype,
                                       cfg.use_fused_attention, device, causal=True)
        self.multihead_attn = SelfAttention(cfg.d_model, cfg.n_heads, cfg.compute_dtype,
                                            cfg.use_fused_attention, device)
        self.linear1 = _new_linear(cfg.d_model, cfg.dim_feedforward, device)
        self.linear2 = _new_linear(cfg.dim_feedforward, cfg.d_model, device)
        self.norm1 = nn.LayerNorm(cfg.d_model, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(cfg.d_model, eps=1e-5, device=device)
        self.norm3 = nn.LayerNorm(cfg.d_model, eps=1e-5, device=device)

    def forward(self, y: torch.Tensor, memory: torch.Tensor, generator=None,
                dropout_rate=None) -> torch.Tensor:
        if not self.training:
            y = _add_layer_norm(y, self.self_attn(y), self.norm1)
            y = _add_layer_norm(y, self.multihead_attn(y, kv=memory), self.norm2)
            return _add_layer_norm(y, _ffn(self, y), self.norm3)
        cfg = self.config
        if cfg.fused_decoder_layer:
            return self._fused(y, memory, generator)
        drop = (_rate(cfg, dropout_rate), cfg.fast_dropout, generator)
        fused_ln = cfg.fused_dropout_ln
        y = _drop_add_layer_norm(y, self.self_attn(y, dropout=drop), self.norm1, *drop, fused_ln)
        ca = self.multihead_attn(y, dropout=drop, kv=memory)
        y = _drop_add_layer_norm(y, ca, self.norm2, *drop, fused_ln)
        return _drop_add_layer_norm(y, _ffn(self, y, drop), self.norm3, *drop, fused_ln)

    def _fused(self, y: torch.Tensor, memory: torch.Tensor, generator) -> torch.Tensor:
        """The whole layer through ``ops/fused_decoder_layer.py`` (JAX
        ``DecoderLayer``'s fused dispatch), one seed per step and layer."""
        cfg = self.config
        b, t, d = y.shape
        cd = self.dtype
        if self.tp is not None:
            raise NotImplementedError("fused_decoder_layer on a tensor-parallel layer: the "
                                      "whole-layer kernels take an unsplit layer")
        if memory.shape != y.shape or not supports_fused_decoder_layer(
                d, cfg.n_heads, cfg.dim_feedforward, t, cd):
            raise ValueError(
                f"fused_decoder_layer=True, but the fused decoder layer does not take "
                f"d_model={d}, n_heads={cfg.n_heads}, dim_feedforward={cfg.dim_feedforward}, "
                f"T={t}, memory {tuple(memory.shape)}, {cd} "
                "(ops/fused_decoder_layer.py::supports_fused_decoder_layer; the memory "
                "must have the target's shape)")
        seed = _layer_seed(generator, y.device)
        sa, ca, f32 = self.self_attn, self.multihead_attn, torch.float32
        out = decoder_layer_train(
            y.reshape(b * t, d).to(cd), memory.reshape(b * t, d).to(cd),
            sa.in_proj_weight.to(cd), sa.in_proj_bias.to(f32),
            sa.out_proj.weight.to(cd), sa.out_proj.bias.to(f32),
            ca.in_proj_weight[:d].to(cd), ca.in_proj_bias[:d].to(f32),
            ca.in_proj_weight[d:].to(cd), ca.in_proj_bias[d:].to(f32),
            ca.out_proj.weight.to(cd), ca.out_proj.bias.to(f32),
            self.norm1.weight.to(f32), self.norm1.bias.to(f32),
            self.linear1.weight.to(cd), self.linear1.bias.to(f32),
            self.linear2.weight.to(cd), self.linear2.bias.to(f32),
            self.norm2.weight.to(f32), self.norm2.bias.to(f32),
            self.norm3.weight.to(f32), self.norm3.bias.to(f32),
            seed, float(cfg.dropout), cfg.n_heads, t)
        return out.reshape(b, t, d).to(y.dtype)


class OutputLayer(nn.Module):
    """Linear d_model→3V (f32), split into (hit logits, velocity, offset)."""

    def __init__(self, d_model: int, embedding_size_tgt: int, device=None):
        super().__init__()
        self.Linear = _new_linear(d_model, embedding_size_tgt, device)

    def forward(self, x: torch.Tensor):
        return self.heads(self.Linear(x))

    @staticmethod
    def heads(y: torch.Tensor):
        """The projection's ``3V`` columns → (hit logits, velocity, offset)."""
        n = y.shape[-1] // 3
        return y[..., :n], torch.sigmoid(y[..., n : 2 * n]), torch.tanh(y[..., 2 * n :]) * 0.5


class GrooveTransformerEncoder(nn.Module):
    """Encoder-only groove transformer: ``(B, T, E_src)`` → ``(h_logits, v, o)``."""

    def __init__(self, config: GrooveTransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        self.InputLayerEncoder = InputLayer(
            cfg.embedding_size_src, cfg.d_model, cfg.max_len, cfg.compute_dtype,
            device)
        layers = nn.ModuleList(EncoderLayer(cfg, device)
                               for _ in range(cfg.num_encoder_layers))
        # the reference's key prefix: Encoder.Encoder.{layers.i, norm}
        self.Encoder = nn.ModuleDict({"Encoder": nn.ModuleDict({
            "layers": layers,
            "norm": nn.LayerNorm(cfg.d_model, eps=1e-6, device=device)})})
        self._build_decoder(device)
        self.OutputLayer = OutputLayer(cfg.d_model, cfg.embedding_size_tgt, device)
        init_parameters(self, generator if generator is not None
                        else torch.Generator().manual_seed(0))

    def _build_decoder(self, device) -> None:
        """Nothing here; :class:`GrooveTransformer` adds its decoder."""

    def _embed(self, input_layer: InputLayer, x: torch.Tensor, generator,
               dropout_rate) -> torch.Tensor:
        x = input_layer(x.to(self.config.compute_dtype))
        if self.training:
            x = drop_site(x, generator, _rate(self.config, dropout_rate),
                          self.config.fast_dropout)
        return x

    def _encode(self, src: torch.Tensor, generator, dropout_rate) -> torch.Tensor:
        """The encoder stack's f32 normalised output; checks what a training
        forward needs."""
        if self.training and generator is None:
            raise ValueError("a training forward needs a torch.Generator "
                             "for its dropout draws")
        if self.training and dropout_rate is not None:
            forced = [s for s in KERNEL_SWITCHES if getattr(self.config, s)]
            if forced:
                raise ValueError(f"{', '.join(forced)}: the kernels take the config's "
                                 "dropout rate, not a per-call dropout_rate")
        stack = self.Encoder["Encoder"]
        x = self._embed(self.InputLayerEncoder, src, generator, dropout_rate)
        for layer in stack["layers"]:
            x = self._run_layer(layer, generator, dropout_rate, x)
        return _final_norm(x, stack["norm"])

    def _run_layer(self, layer, generator, dropout_rate, *tensors) -> torch.Tensor:
        """One encoder or decoder layer, rematerialised in ``train()`` mode
        when the config says so: under ``torch.utils.checkpoint`` by
        :func:`_remat`, inside a ``torch.func`` transform (a batched sweep's
        step) by :func:`_remat_transformed`."""
        remat = self.training and self.config.remat
        if remat and self.config.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy: {self.config.remat_policy!r}")
        if remat and transformed():
            return _remat_transformed(self.config, generator, layer, dropout_rate, *tensors)
        if dropout_rate is not None:
            layer = functools.partial(layer, dropout_rate=dropout_rate)
        if remat:
            return _remat(self.config, generator, layer, *tensors)
        return layer(*tensors, generator)

    def forward(self, src: torch.Tensor, generator: Optional[torch.Generator] = None,
                dropout_rate: Optional[torch.Tensor] = None):
        """``generator`` (on ``src``'s device) feeds every dropout site in
        ``train()`` mode; ``eval()`` mode needs none. ``dropout_rate``: a 0-d
        tensor that replaces the config's rate at every site (module
        docstring)."""
        return self.OutputLayer(self._encode(src, generator, dropout_rate))  # heads in f32


class GrooveTransformer(GrooveTransformerEncoder):
    """Encoder-decoder groove transformer (``num_decoder_layers > 0``):
    ``(B, T, E_src)`` and an optional target ``(B, T, E_tgt)`` →
    ``(h_logits, v, o)``. The decoder is teacher-forced over the target
    shifted right behind a zero start row."""

    def _build_decoder(self, device) -> None:
        cfg = self.config
        self.InputLayerDecoder = InputLayer(
            cfg.embedding_size_tgt, cfg.d_model, cfg.max_len, cfg.compute_dtype, device)
        layers = nn.ModuleList(DecoderLayer(cfg, device)
                               for _ in range(cfg.num_decoder_layers))
        # the reference's key prefix: Decoder.Decoder.{layers.i, norm}
        self.Decoder = nn.ModuleDict({"Decoder": nn.ModuleDict({
            "layers": layers,
            "norm": nn.LayerNorm(cfg.d_model, eps=1e-6, device=device)})})

    def forward(self, src: torch.Tensor, tgt: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                dropout_rate: Optional[torch.Tensor] = None):
        """``tgt=None`` (serving) decodes over zeros. ``generator`` and
        ``dropout_rate`` as the encoder-only model's."""
        cfg = self.config
        memory = self._encode(src, generator, dropout_rate).to(cfg.compute_dtype)
        if tgt is None:
            tgt = src.new_zeros(src.shape[:-1] + (cfg.embedding_size_tgt,))
        # shift right with a zero "start" row (teacher forcing)
        tgt_in = torch.cat([torch.zeros_like(tgt[..., :1, :]), tgt[..., :-1, :]], dim=-2)
        stack = self.Decoder["Decoder"]
        y = self._embed(self.InputLayerDecoder, tgt_in, generator, dropout_rate)
        for layer in stack["layers"]:
            y = self._run_layer(layer, generator, dropout_rate, y, memory)
        return self.OutputLayer(_final_norm(y, stack["norm"]))  # heads in f32


def _final_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """A stack's last LayerNorm (flax's eps 1e-6), in f32."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


def build_model(config: GrooveTransformerConfig, device="cuda",
                generator: Optional[torch.Generator] = None) -> GrooveTransformerEncoder:
    """The model of ``config``'s family (:class:`GrooveTransformer` when
    ``num_decoder_layers > 0``) on ``device`` (``"cuda"`` without CUDA
    raises), in eval mode, initialised as :func:`init_parameters` says from
    ``generator`` (a CPU generator; seed 0 when none is given). Load weights
    with ``load_state_dict``."""
    device = require_device(device, "build_model")
    cls = GrooveTransformerEncoder if config.encoder_only else GrooveTransformer
    return cls(config, device, generator).eval()


def predict(model: GrooveTransformerEncoder, inputs: torch.Tensor,
            use_thres: bool = True, thres: float = 0.5):
    """Deterministic inference: hits thresholded at ``thres`` after a sigmoid;
    velocity and offset through their head activations. Returns
    ``[h, v, o]``, each ``(B, T, V)``."""
    with torch.inference_mode():
        h_logits, v, o = model(inputs)
        h = torch.sigmoid(h_logits)
        if use_thres:
            h = (h > thres).to(h_logits.dtype)
    return [h, v, o]
