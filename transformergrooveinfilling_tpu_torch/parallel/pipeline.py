"""Pipeline parallelism, as the JAX package's ``parallel/pipeline.py``.

A GPipe schedule over a ``("data", "pipe"[, "model"])`` mesh, one rank per
stage: with S stages and M microbatches (default 2·S), stage s holds layers
``[s·L/S, (s+1)·L/S)`` and runs them on each of its data rank's M
microbatches in turn, receiving each from stage s-1 and sending it on to
stage s+1 (point-to-point, through the plan's transport, ``comm.py``). The
last stage concatenates the microbatches and applies the final norm and the
output projection; the projection is broadcast over the pipe group, so the
heads, the loss and the metrics run replicated on every stage, as the JAX
package runs them outside its pipelined region. The input layer runs on
stage 0.

The backward goes in reverse: the gradient of the broadcast projection is
taken by the last stage, which runs ``torch.autograd.backward`` through its
stage and sends each microbatch's input gradient back; every earlier stage
receives them in microbatch order and runs ``torch.autograd.backward(out,
grad)`` for each. This is the backward of :class:`_PipelineOutput`, so the
pipelined forward plugs into the plain train step
(``train/loop.py::make_train_step(forward_fn=...)``) as the JAX package's
does, and the data-parallel gradient all-reduce of that step covers the
stages too: every rank keeps the whole model, a stage's gradient is zero
outside its layers, and the all-reduce over the data and pipe axes gives
every rank the whole gradient.

Each rank of data rank r takes, of every microbatch m of a global batch of
B = M·mb rows, the rows ``m·mb + [r·mb/D, (r+1)·mb/D)`` (the JAX package's
("data"-sharded microbatch) layout). Dropout draws from one generator per
(data rank, global layer, microbatch) folded from the step's generator, as
the JAX package folds its key (held to the port's dropout rules, not bit
for bit). With ``n_model`` > 1 the stage's layers are tensor-parallel
(``tensor.py``). Deterministic, the pipelined forward equals the plain
model's.

The stage layers are the model's own ``EncoderLayer``s with their switches:
the attention kernel (#1) in the eval forward, the fused FFN (#4) and the
fused dropout+LayerNorm (#5) when the config turns them on, remat. The
encoder-decoder family is not pipelined (``train/driver.py`` refuses it, as
the JAX training driver does).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .comm import Comm
from .mesh import _device_mesh, _flat_group, _groups
from .multihost import ensure_group


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """A ("data", "pipe", "model") mesh and the pipeline split: this rank's
    coordinates, its pipe neighbours (global ranks), the backend, transport
    and device, and the :class:`~.comm.Comm` of each axis (``reduce``: every
    axis but "model", for the gradient all-reduce)."""

    mesh: object
    n_data: int
    n_stages: int
    n_model: int
    n_micro: int
    data_rank: int
    stage: int
    model_rank: int
    backend: str
    transport: str
    device: torch.device
    data: Comm
    pipe: Comm
    model: Comm
    reduce: Comm
    prev_rank: Optional[int]
    next_rank: Optional[int]
    last_rank: int

    @property
    def size(self) -> int:
        return self.n_data * self.n_stages * self.n_model

    def local_rows(self, batch: int) -> torch.Tensor:
        """This rank's rows of a global batch, microbatch after microbatch
        (module docstring)."""
        mb = batch // self.n_micro
        per = mb // self.n_data
        return torch.tensor([m * mb + self.data_rank * per + i
                             for m in range(self.n_micro) for i in range(per)])


def make_pipeline_mesh(n_stages: int, n_data: Optional[int] = None,
                       n_micro: Optional[int] = None, n_model: int = 1,
                       device="cuda") -> PipelinePlan:
    """A ("data", "pipe", "model") mesh over the group's ranks (a group of
    one rank is started when none runs): "model" innermost, "pipe" next,
    "data" outermost. ``n_data`` defaults to the rank count // (``n_stages``
    · ``n_model``); the mesh must use every rank. ``n_model`` > 1 splits
    each stage's layers over "model" (dp×pp×tp)."""
    import torch.distributed as dist

    ctx = ensure_group(device)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // (n_stages * n_model)
    if n_data < 1:
        raise ValueError(f"need at least {n_stages * n_model} ranks for {n_stages} stages "
                         f"x {n_model} model shards, have {world}")
    shape = (n_data, n_stages, n_model)
    mesh, grid = _device_mesh(ctx.device, ctx.backend, shape, ("data", "pipe", "model"))
    comms = _groups(mesh, ("data", "pipe", "model"))
    d, s, m = (int(c) for c in np.argwhere(grid == dist.get_rank())[0])
    return PipelinePlan(
        mesh=mesh, n_data=n_data, n_stages=n_stages, n_model=n_model,
        n_micro=n_micro or 2 * n_stages, data_rank=d, stage=s, model_rank=m,
        backend=ctx.backend, transport=ctx.transport, device=ctx.device,
        data=comms["data"], pipe=comms["pipe"], model=comms["model"],
        reduce=_flat_group(grid, 2, ctx.transport),
        prev_rank=int(grid[d, s - 1, m]) if s > 0 else None,
        next_rank=int(grid[d, s + 1, m]) if s < n_stages - 1 else None,
        last_rank=int(grid[d, n_stages - 1, m]))


def split_encoder_params(params: dict, n_layers: int):
    """``(rest, stacked)`` of a flax parameter tree: the per-layer subtrees
    stacked on a leading ``(L, ...)`` axis, and the rest (input embed, final
    norm, output head)."""
    layers = [params[f"encoder_layer_{i}"] for i in range(n_layers)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack([np.asarray(t) for t in trees])

    rest = {k: v for k, v in params.items() if not k.startswith("encoder_layer_")}
    return rest, stack(layers)


def merge_encoder_params(rest: dict, stacked, n_layers: int) -> dict:
    """Inverse of :func:`split_encoder_params`."""
    def take(tree, i):
        return {k: take(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]

    params = dict(rest)
    for i in range(n_layers):
        params[f"encoder_layer_{i}"] = take(stacked, i)
    return params


def _stage_layers(model, plan: PipelinePlan):
    layers = list(model.Encoder["Encoder"]["layers"])
    per = len(layers) // plan.n_stages
    return layers[plan.stage * per:(plan.stage + 1) * per], plan.stage * per


@dataclasses.dataclass
class _Stage:
    """One step's stage graph: each microbatch's received input (a leaf that
    takes its gradient) and output, and on the last stage the projection."""

    plan: PipelinePlan
    ins: list
    outs: list
    proj: Optional[torch.Tensor]

    def backward(self, grad: torch.Tensor) -> None:
        plan = self.plan
        if plan.next_rank is None:
            torch.autograd.backward(self.proj, grad)
            grads = [h.grad for h in self.ins] if plan.prev_rank is not None else []
        else:
            grads = []
            for h_in, out in zip(self.ins, self.outs):
                g = plan.pipe.recv(torch.empty_like(out), plan.next_rank)
                torch.autograd.backward(out, g)
                if plan.prev_rank is not None:
                    plan.pipe.send(h_in.grad, plan.prev_rank)
        for g in grads:
            plan.pipe.send(g, plan.prev_rank)


class _PipelineOutput(torch.autograd.Function):
    """The broadcast projection, whose backward runs the stage's reverse
    schedule (:meth:`_Stage.backward`)."""

    @staticmethod
    def forward(ctx, anchor, proj, stage):
        ctx.stage = stage
        return proj.view_as(proj)

    @staticmethod
    def backward(ctx, grad):
        ctx.stage.backward(grad)
        return None, None, None


def _pipelined(model, x_local: torch.Tensor, plan: PipelinePlan, generator) -> torch.Tensor:
    """This rank's rows through the pipeline → the output projection
    ``(B_local, T, 3V)`` on every stage; in ``train()`` mode with gradients
    on, differentiable through :class:`_PipelineOutput`."""
    from ..models.transformer import _final_norm
    from ..train.loop import advance_generator, fold_generator

    cfg = model.config
    training = model.training
    grad = training and torch.is_grad_enabled()
    m_count = plan.n_micro
    mb = x_local.shape[0] // m_count
    t = x_local.shape[1]
    layers, first = _stage_layers(model, plan)

    def gen(layer: int, m: int):
        return fold_generator(generator, layer, m) if training else None

    ins, outs = [], []
    for m in range(m_count):
        if plan.prev_rank is None:
            h = model._embed(model.InputLayerEncoder, x_local[m * mb:(m + 1) * mb], gen(-1, m),
                             None)
        else:
            h = plan.pipe.recv(torch.empty((mb, t, cfg.d_model), dtype=cfg.compute_dtype,
                                           device=x_local.device), plan.prev_rank)
            h.requires_grad_(grad)
        ins.append(h)
        for i, layer in enumerate(layers):
            h = model._run_layer(layer, gen(first + i, m), None, h)
        if plan.next_rank is not None:
            plan.pipe.send(h.detach(), plan.next_rank)
        outs.append(h)
    if training:
        advance_generator(generator)
    proj = None
    if plan.next_rank is None:
        norm = model.Encoder["Encoder"]["norm"]
        proj = model.OutputLayer.Linear(_final_norm(torch.cat(outs), norm))
        shared = proj.detach().clone()
    else:
        shared = torch.empty((x_local.shape[0], t, cfg.embedding_size_tgt),
                             dtype=torch.float32, device=x_local.device)
    plan.pipe.broadcast(shared, plan.last_rank)
    if not grad:
        return shared
    anchor = torch.zeros((), device=x_local.device, requires_grad=True)
    return _PipelineOutput.apply(anchor, shared, _Stage(plan, ins, outs, proj))


def pipeline_forward(model, x: torch.Tensor, plan: PipelinePlan, *,
                     deterministic: bool = True, generator=None):
    """Encoder-only forward with the encoder stack pipelined over "pipe":
    ``x`` is the global ``(B, T, E_src)`` batch, ``B`` divisible by
    ``n_micro · n_data``; returns the usual ``(h_logits, v, o)`` heads of the
    whole batch on every rank (the data ranks' rows summed into place, so
    with ``n_data`` > 1 they carry no gradient). ``deterministic=False``
    runs the model in ``train()`` mode with dropout from ``generator``.
    Deterministic, it equals the plain model's forward."""
    rows = plan.local_rows(x.shape[0])
    was_training = model.training
    model.train(not deterministic)
    try:
        with torch.set_grad_enabled(not deterministic and torch.is_grad_enabled()):
            proj = _pipelined(model, x[rows.to(x.device)], plan, generator)
    finally:
        model.train(was_training)
    if plan.n_data > 1:
        full = torch.zeros((x.shape[0],) + proj.shape[1:], dtype=proj.dtype, device=x.device)
        full[rows.to(x.device)] = proj.detach()
        proj = plan.data.all_reduce(full)
    return model.OutputLayer.heads(proj)


def make_pipeline_step(plan: PipelinePlan, hit_loss_penalty: float) -> callable:
    """The train step of ``train/loop.py::make_train_step`` with the encoder
    stack pipelined: ``step(state, x, y, w, generator) -> metrics`` on the
    whole model in ``state`` (every rank keeps it), with the plain step's
    metric keys and sample-weight semantics (it is the data-parallel step
    with the pipelined forward injected). What ``run_training(plan=)`` runs
    under a :class:`PipelinePlan` (``train --pp_stages N``)."""
    from ..train.loop import make_train_step

    def forward(model, x, y, generator):
        return model.OutputLayer.heads(_pipelined(model, x, plan, generator))

    return make_train_step(hit_loss_penalty, forward_fn=forward, plan=plan)


def check_pipeline_batch(plan: PipelinePlan, batch_size: int, n_layers: int) -> None:
    """The static pipeline constraints, checked early so that a bad command
    line fails with a clear message."""
    if n_layers % plan.n_stages:
        raise ValueError(
            f"num_encoder_layers {n_layers} not divisible by "
            f"--pp_stages {plan.n_stages}")
    if batch_size % plan.n_micro:
        raise ValueError(
            f"batch_size {batch_size} not divisible by n_micro "
            f"{plan.n_micro} (set --pp_micro to a divisor)")
    mb = batch_size // plan.n_micro
    if mb % plan.n_data:
        raise ValueError(
            f"microbatch {mb} (batch_size {batch_size} / n_micro "
            f"{plan.n_micro}) not divisible by the data axis {plan.n_data}")


def make_pipeline_train_step(plan: PipelinePlan, hit_loss_penalty: float = 1.0) -> callable:
    """One optimizer step with the encoder stack pipelined: ``step(state, x,
    y, generator) -> {"loss", "hit_accuracy"}`` on the whole model, updated in
    place, so checkpoints keep the unsplit layout."""
    step = make_pipeline_step(plan, hit_loss_penalty)

    def train_step(state, x, y, generator):
        check_pipeline_batch(plan, x.shape[0], state.model.config.num_encoder_layers)
        m = step(state, x, y, None, generator)
        return {"loss": m["loss"], "hit_accuracy": m["hit_accuracy"]}

    return train_step
