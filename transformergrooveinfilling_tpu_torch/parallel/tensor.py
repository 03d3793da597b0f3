"""Tensor parallelism: the layers' wide dimensions split over the mesh's
"model" axis (the JAX package gets the same from GSPMD and the partition
rules of ``mesh.py``; here it is written out).

Each rank of a "model" group holds, in every encoder and decoder layer:

- the packed in-projections (``in_proj_weight``/``bias``, self- and
  cross-attention) split by heads: its heads' rows of q, of k and of v
  (column-parallel), so it attends over its own heads only;
- ``out_proj.weight`` split by input columns (row-parallel), its bias whole;
- ``linear1`` split by output rows (column-parallel), ``linear2.weight`` by
  input columns (row-parallel), ``linear2.bias`` whole.

LayerNorms, the embeddings and the output head stay whole on every rank. A
sublayer's input enters through :func:`copy_to_model` (identity forward,
all-reduce of the gradient backward) and a row-parallel product leaves
through :func:`reduce_from_model` (all-reduce forward, identity backward),
its bias added once, after the sum. The all-reduce runs in float32 whatever
the compute dtype. A dropout site inside the split (attention probabilities
over this rank's heads, the FFN's hidden units) draws the whole layer's mask
from the generator and keeps this rank's part (:meth:`TensorParallel.drop`),
so every rank of a group draws the same numbers and the masks are those of
the unsplit layer.

The attention kernel (``ops/attention.py::fused_mha``, #1) runs in the eval
forward on the local heads (the flagship at "model" 2: one head of width 128
a rank). Training runs the layers unfused, as the JAX package's GSPMD path
does; the whole-layer kernels (#2, #3) refuse a split layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.dropout import dropout as drop_site
from .comm import Comm

# state-dict key suffix of a layer → (dimension split, packed chunks)
SHARD_RULES = {
    "self_attn.in_proj_weight": (0, 3),
    "self_attn.in_proj_bias": (0, 3),
    "self_attn.out_proj.weight": (1, 1),
    "multihead_attn.in_proj_weight": (0, 3),
    "multihead_attn.in_proj_bias": (0, 3),
    "multihead_attn.out_proj.weight": (1, 1),
    "linear1.weight": (0, 1),
    "linear1.bias": (0, 1),
    "linear2.weight": (1, 1),
}


def shard_rule(name: str) -> Optional[tuple]:
    """``(dim, chunks)`` of a state-dict key split over "model", or None
    (whole on every rank)."""
    if ".layers." not in name:
        return None
    return SHARD_RULES.get(name.split(".layers.", 1)[1].split(".", 1)[1])


def take_shard(t: torch.Tensor, dim: int, chunks: int, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank`` of ``n``'s part of ``t``: the same block of each of its
    ``chunks`` packed parts along ``dim``."""
    parts = [c.narrow(dim, rank * (c.shape[dim] // n), c.shape[dim] // n)
             for c in t.chunk(chunks, dim)]
    return torch.cat(parts, dim).contiguous()


def join_shards(shards: list, dim: int, chunks: int) -> torch.Tensor:
    """Inverse of :func:`take_shard` over every rank's part, in rank order."""
    split = [s.chunk(chunks, dim) for s in shards]
    return torch.cat([torch.cat([s[c] for s in split], dim) for c in range(chunks)], dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.to(torch.float32, copy=True)
        ctx.comm.all_reduce(g)
        return g.to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, comm):
        s = y.to(torch.float32, copy=True)
        comm.all_reduce(s)
        return s.to(y.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``comm`` backward."""
    return _CopyToModel.apply(x, comm)


def reduce_from_model(y: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Sum over ``comm`` forward (in float32); identity backward."""
    return _ReduceFromModel.apply(y, comm)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place in its "model" group, held by every split layer."""

    comm: Comm
    rank: int
    size: int

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_model(x, self.comm)

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        return reduce_from_model(y, self.comm)

    def drop(self, y: torch.Tensor, generator, rate, fast: bool, dim: int) -> torch.Tensor:
        """Dropout on this rank's part of a tensor split ``size`` ways along
        ``dim``: the whole tensor's mask drawn from ``generator``, this
        rank's block of it applied."""
        if not isinstance(rate, torch.Tensor) and rate == 0.0:
            return y
        dim = dim % y.dim()
        shape = list(y.shape)
        shape[dim] *= self.size
        mask = drop_site(torch.ones(shape, dtype=y.dtype, device=y.device), generator, rate,
                         fast)
        return y * mask.narrow(dim, self.rank * y.shape[dim], y.shape[dim])


def _layers(model):
    layers = list(model.Encoder["Encoder"]["layers"])
    if hasattr(model, "Decoder"):
        layers += list(model.Decoder["Decoder"]["layers"])
    return layers


def shard_model(model: torch.nn.Module, plan, optimizer=None) -> torch.nn.Module:
    """Split ``model``'s layers over ``plan``'s "model" axis in place (module
    docstring): each split parameter keeps its identity and takes this
    rank's part (Adam's ``exp_avg``/``exp_avg_sq`` in ``optimizer``, where
    present, likewise). Raises ``ValueError`` unless the axis divides
    ``n_heads`` and ``dim_feedforward``."""
    cfg = model.config
    n, rank = plan.n_model, plan.model_rank
    if cfg.n_heads % n or cfg.dim_feedforward % n:
        raise ValueError(f"tensor parallelism over {n} ranks needs n_heads ({cfg.n_heads}) "
                         f"and dim_feedforward ({cfg.dim_feedforward}) divisible by {n}")
    if getattr(model, "_tp", None) is not None:
        raise ValueError("the model is split already")
    tp = TensorParallel(plan.model, rank, n)
    state = optimizer.state if optimizer is not None else {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            rule = shard_rule(name)
            if rule is None:
                continue
            p.data = take_shard(p.data, *rule, rank, n)
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state.get(p, {}):
                    state[p][key] = take_shard(state[p][key], *rule, rank, n)
    for layer in _layers(model):
        layer.tp = tp
        for attn in (getattr(layer, "self_attn", None), getattr(layer, "multihead_attn", None)):
            if attn is not None:
                attn.tp = tp
                attn.n_heads = cfg.n_heads // n
    model._tp = tp
    return model


def gather_full(model: torch.nn.Module, tensors: dict) -> dict:
    """``{state-dict key: this rank's part}`` → the whole tensors, gathered
    over the "model" group (a collective of the group's ranks)."""
    tp = getattr(model, "_tp", None)
    if tp is None:
        return tensors
    out = {}
    for name, t in tensors.items():
        rule = shard_rule(name)
        out[name] = t if rule is None else join_shards(tp.comm.all_gather(t.detach()), *rule)
    return out


def grad_norm(model: torch.nn.Module) -> torch.Tensor:
    """The L2 norm of the whole model's gradient from a split model's
    parts: the split parameters' squares summed over the "model" group, the
    whole ones counted once (a collective of the group's ranks)."""
    tp = model._tp
    split, whole = [], []
    for name, p in model.named_parameters():
        (split if shard_rule(name) is not None else whole).append(p.grad)
    sq = torch.stack([torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g))) ** 2
                      for g in (split, whole)])
    sq[0] = tp.comm.all_reduce(sq[:1].clone())[0]
    return sq.sum().sqrt()
