"""Seeded trials of the four training kernels' autograd Functions (#2-#5), and
``torch.func.vmap(grad_and_value(...))`` over them beside unbatched calls.

Imports torch, numpy and the port only, so that the card tests
(``test_torch_cuda.py``, run with ``--noconftest`` where there is no JAX) and
the CPU tests (``test_torch_vmap_kernels.py``) share it.
"""

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from transformergrooveinfilling_tpu_torch.ops import (
    fused_decoder_layer as fdl, fused_ffn as ffn, fused_layer as fl, fused_ln as ln,
)

KERNELS = ("fused_layer", "fused_decoder_layer", "fused_ffn", "fused_dropout_ln")


def calls(rate: float, n_heads: int, seq_len: int) -> dict:
    """Each kernel's call through its autograd Function over the operators:
    ``(*tensors, seed) -> output``. The layers' Functions are called
    directly, since ``encoder_layer_train`` and ``decoder_layer_train`` take
    the twin for CPU tensors outside a ``torch.func`` transform (and
    ``unbatched`` calls them there)."""
    return {
        "fused_layer": lambda *a: fl.EncoderLayerTrain.apply(*a, rate, n_heads, seq_len)[0],
        "fused_decoder_layer": lambda *a: fdl.DecoderLayerTrain.apply(
            *a, rate, n_heads, seq_len)[0],
        "fused_ffn": lambda *a: ffn.ffn_train(*a, rate),
        "fused_dropout_ln": lambda *a: ln.dropout_add_layernorm(*a, rate)}


def trial(kernel: str, rng, dtype, device, d: int, ff: int, rows: int) -> tuple:
    """One trial's tensors (without the seed) and its output gradient: the
    activations and weights in ``dtype``, biases and LayerNorm parameters
    f32."""
    def n(*shape, scale=1.0, offset=0.0, dt=torch.float32):
        a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(device, dt)

    def w(out, inp):
        return n(out, inp, scale=inp ** -0.5, dt=dtype)

    def vec(width):
        return n(width, scale=0.1)

    def gain():
        return n(d, scale=0.1, offset=1.0)

    x = n(rows, d, dt=dtype)
    if kernel == "fused_layer":
        args = [x, w(3 * d, d), vec(3 * d), w(d, d), vec(d), gain(), vec(d), w(ff, d), vec(ff),
                w(d, ff), vec(d), gain(), vec(d)]
    elif kernel == "fused_decoder_layer":
        args = [x, n(rows, d, dt=dtype), w(3 * d, d), vec(3 * d), w(d, d), vec(d), w(d, d),
                vec(d), w(2 * d, d), vec(2 * d), w(d, d), vec(d), gain(), vec(d), w(ff, d),
                vec(ff), w(d, ff), vec(d), gain(), vec(d), gain(), vec(d)]
    elif kernel == "fused_ffn":
        args = [x, w(ff, d), vec(ff), w(d, ff), vec(d)]
    else:
        args = [x, n(rows, d, dt=dtype), gain(), vec(d)]
    return args, n(rows, d, dt=dtype)


def trials(kernel: str, k: int, seed: int, dtype, device, d: int, ff: int, rows: int):
    """``k`` trials of :func:`trial` from one numpy generator, and their
    seeds ``(k, 1)`` int32."""
    rng = np.random.default_rng(seed)
    made = [trial(kernel, rng, dtype, device, d, ff, rows) for _ in range(k)]
    seeds = torch.from_numpy(rng.integers(0, 2**31 - 1, (k, 1)).astype(np.int32)).to(device)
    return [a for a, _ in made], [g for _, g in made], seeds


def loss_of(call):
    """``Σ output·g``: its gradient at the output is ``g`` exactly."""
    def loss(*a):
        *tensors, seed, g = a
        out = call(*tensors, seed)
        return (out.float() * g.float()).sum(), out
    return loss


def vmapped(call, args, dys, seeds, in_dims=None):
    """``vmap(grad_and_value(...), randomness="different")`` over the
    trials: ``(gradients of every floating tensor, outputs)``. ``in_dims``
    (one per tensor, 0 or None) says which tensors have a trial axis; a
    tensor without one is the first trial's, shared."""
    k = len(args)
    in_dims = in_dims or [0] * len(args[0])
    stacked = [torch.stack([a[j] for a in args]) if dim == 0 else args[0][j]
               for j, dim in enumerate(in_dims)]
    diff = tuple(j for j, a in enumerate(args[0]) if a.is_floating_point())
    fn = vmap(grad_and_value(loss_of(call), argnums=diff, has_aux=True),
              in_dims=(*in_dims, 0, 0), randomness="different")
    grads, (_value, out) = fn(*stacked, seeds, torch.stack(dys))
    assert out.shape[0] == k
    return grads, out


def unbatched(call, args, dys, seeds, in_dims=None):
    """The same K trials called one at a time with each trial's seed:
    ``[(gradients, output)]``; a tensor without a trial axis is the first
    trial's in every call."""
    in_dims = in_dims or [0] * len(args[0])
    diff = [j for j, a in enumerate(args[0]) if a.is_floating_point()]
    out = []
    for i, a in enumerate(args):
        a = [a[j] if dim == 0 else args[0][j] for j, dim in enumerate(in_dims)]
        leaves = [t.clone().requires_grad_(True) if j in diff else t for j, t in enumerate(a)]
        value, y = loss_of(call)(*leaves, seeds[i].clone(), dys[i])  # 16-byte aligned
        grads = torch.autograd.grad(value, [leaves[j] for j in diff])
        out.append((list(grads), y.detach()))
    return out


def assert_equal(grads, outs, want, atol=0.0):
    """Each trial's output and gradients against the unbatched call's, to
    ``atol`` (0: bit for bit)."""
    for i, (want_grads, want_out) in enumerate(want):
        torch.testing.assert_close(outs[i], want_out, atol=atol, rtol=0)
        assert len(grads) == len(want_grads)
        for j, (g, w) in enumerate(zip(grads, want_grads)):
            torch.testing.assert_close(g[i], w, atol=atol, rtol=0,
                                       msg=f"gradient {j} of trial {i}")
