"""Training loop, as the JAX package's ``train/loop.py``.

One step: the forward in ``train()`` mode (dropout from an explicit
``torch.Generator``), the penalty-masked 3-term loss, backward and the
optimizer update; seven metrics come back as device tensors. One epoch: the
dataset stays resident on the device, the shuffle is ``torch.randperm`` on the
device, and a partial final batch is padded with index 0 and weight 0, so
every step has the same shape (the reference's ``drop_last=False``). Metric
means are weighted by the live-sample count and stay on the device until the
caller fetches them, once per epoch: a per-step ``.item()`` would stall the
host on the device every step.

With a plan (``parallel/mesh.py::MeshPlan`` or
``parallel/pipeline.py::PipelinePlan``) every rank draws the same shuffle
from the same generator and trains on its rows of each global batch
(:func:`_make_dp_shard_step`), so an n-rank run on a resident corpus trains
on the global batches of one process.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable

import numpy as np
import torch

from .. import require_device
from ..models.losses import calculate_loss

METRIC_KEYS = ("grad_norm", "loss", "hit_accuracy", "hit_perplexity", "bce_hits",
               "mse_velocities", "mse_offsets")
EVAL_KEYS = ("loss", "hit_accuracy", "bce_hits", "mse_velocities", "mse_offsets")


@dataclasses.dataclass
class TrainState:
    """Step count, model (the parameters) and optimizer (its state)."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def make_optimizer(algorithm: str, learning_rate: float, params) -> torch.optim.Optimizer:
    """The reference's optimizer menu: sgd (momentum 0) or adam with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    if algorithm == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=0.0)
    if algorithm == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(f"unknown optimizer_algorithm: {algorithm}")


def create_train_state(config, algorithm: str, learning_rate: float, seed: int = 0,
                       device="cuda") -> TrainState:
    """A freshly initialised model (from a CPU generator seeded ``seed``, so
    the weights are the same on every device) and its optimizer, on ``device``
    (``"cuda"`` without CUDA raises)."""
    from ..models import build_model

    device = require_device(device, "create_train_state")
    model = build_model(config, device, torch.Generator().manual_seed(int(seed)))
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(algorithm, learning_rate, model.parameters()))


def fold_generator(generator: torch.Generator, *keys) -> torch.Generator:
    """A new generator on ``generator``'s device, seeded from its current
    state and ``keys`` (the JAX ``fold_in``); reads the state on the host,
    so it waits for nothing on the device."""
    h = hashlib.blake2b(generator.get_state().numpy().tobytes(), digest_size=8)
    h.update(repr(keys).encode())
    return torch.Generator(generator.device).manual_seed(
        int.from_bytes(h.digest(), "little") >> 1)


def advance_generator(generator: torch.Generator) -> None:
    """Move ``generator`` on by one draw, so that the next fold differs."""
    torch.empty(1, device=generator.device).uniform_(generator=generator)


def _forward(model, x, y, generator, encoder_only: bool, forward_fn):
    if forward_fn is not None:
        return forward_fn(model, x, y, generator)
    return model(x, generator=generator) if encoder_only else model(x, y, generator)


def make_train_step(hit_loss_penalty: float, encoder_only: bool = True,
                    forward_fn: Callable | None = None, plan=None) -> Callable:
    """``step(state, x, y, w, generator) -> metrics``: one update in place.
    ``w`` are the ``(B,)`` sample weights (or None); ``generator`` feeds the
    dropout sites. ``grad_norm`` is the global L2 norm of the gradients.
    ``encoder_only=False`` trains the encoder-decoder family with teacher
    forcing: the target grid also feeds the decoder (shifted inside the
    model).

    ``forward_fn``: optional ``(model, x, y, generator) -> preds`` in place of
    the model's own forward (the pipeline-parallel step injects its pipelined
    forward here: one copy of the loss, backward, update and metrics).

    ``plan``: a mesh plan (``parallel/``); the step is then
    :func:`_make_dp_shard_step`'s, each rank on its rows of ``x``."""
    if plan is not None:
        return _make_dp_shard_step(hit_loss_penalty, plan, encoder_only, forward_fn)

    def step(state: TrainState, x, y, w, generator) -> dict:
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        pred = _forward(model, x, y, generator, encoder_only, forward_fn)
        out = calculate_loss(pred, y, hit_loss_penalty, sample_weights=w)
        out.total_loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        opt.step()
        state.step += 1
        return {"grad_norm": grad_norm.detach(), "loss": out.total_loss.detach(),
                "hit_accuracy": out.hit_accuracy, "hit_perplexity": out.hit_perplexity.detach(),
                "bce_hits": out.bce_hits.detach(), "mse_velocities": out.mse_velocities.detach(),
                "mse_offsets": out.mse_offsets.detach()}

    return step


_COMBINED = ("loss", "hit_accuracy", "bce_hits", "mse_velocities", "mse_offsets")


def _make_dp_shard_step(hit_loss_penalty: float, plan, encoder_only: bool = True,
                        forward_fn: Callable | None = None) -> Callable:
    """The data-parallel train step (the JAX ``shard_map`` step): each rank
    runs the model on its rows of the global batch (``plan.local_rows``),
    its own kernels on its own rows (#2's chain with ``fused_layer``, #3's
    with ``fused_decoder_layer``).

    Numerics, as the JAX step's: a rank's loss is normalised by its live
    rows; the global loss is ``Σ loss_r·wsum_r / max(Σ wsum_r, 1)``, and
    each rank backpropagates its term of that sum, so the summed gradient
    equals the single-device gradient (a rank of zero-weight padding rows
    adds 0). The gradients are summed by an explicit bucketed all-reduce
    after the backward, one flat float32 buffer over the plan's ``reduce``
    axes, rather than DDP: the sum is weighted by the live rows, a
    tensor-parallel rank's shards must stay out of it, a pipeline stage
    contributes zeros outside its layers, and where ranks share a card the
    buffer goes through the plan's host-staged transport. The metrics are
    combined the same way over "data", ``hit_perplexity`` is rebuilt as
    ``exp`` of the global bce, and ``grad_norm`` is the summed gradient's
    norm. Dropout: with one data rank the step's generator itself (so a
    one-rank plan trains bit for bit as no plan); with more, a generator
    folded from it and the data rank, per step. The batch size needs no
    divisibility (the weighting is exact for unequal shares), only one row
    per rank at least."""

    def step(state: TrainState, x, y, w, generator) -> dict:
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        if w is None:
            w = torch.ones(x.shape[0], device=x.device)
        rows = plan.local_rows(x.shape[0])
        if isinstance(rows, torch.Tensor):
            rows = rows.to(x.device)
        x_r, y_r, w_r = x[rows], y[rows], w[rows]
        if plan.n_data > 1:
            gen = fold_generator(generator, "data", plan.data_rank)
            advance_generator(generator)
        else:
            gen = generator
        pred = _forward(model, x_r, y_r, gen, encoder_only, forward_fn)
        out = calculate_loss(pred, y_r, hit_loss_penalty, sample_weights=w_r)
        share = w_r.sum() / torch.clamp(w.sum(), min=1.0)
        (out.total_loss * share).backward()
        params = list(model.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = plan.reduce.all_reduce(torch.cat([g.reshape(-1).float() for g in grads]))
        at = 0
        for p, g in zip(params, grads):
            p.grad = flat[at:at + g.numel()].view_as(p).to(p.dtype)
            at += g.numel()
        if getattr(model, "_tp", None) is None:
            grad_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm([p.grad for p in params])))
        else:
            from ..parallel.tensor import grad_norm as split_grad_norm

            grad_norm = split_grad_norm(model)
        combined = plan.data.all_reduce(
            torch.stack([getattr(out, "total_loss" if k == "loss" else k).detach().float()
                         for k in _COMBINED]) * share.detach())
        opt.step()
        state.step += 1
        metrics = dict(zip(_COMBINED, combined))
        return {"grad_norm": grad_norm.detach(), "loss": metrics["loss"],
                "hit_accuracy": metrics["hit_accuracy"],
                "hit_perplexity": torch.exp(metrics["bce_hits"]),
                "bce_hits": metrics["bce_hits"], "mse_velocities": metrics["mse_velocities"],
                "mse_offsets": metrics["mse_offsets"]}

    return step


def make_epoch_fn(hit_loss_penalty: float, batch_size: int, n_samples: int,
                  n_epochs: int = 1, shuffle: bool = True, augment: Callable | None = None,
                  augment_per_epoch: bool = True, encoder_only: bool = True,
                  plan=None, dp_shard: bool = False, step_fn: Callable | None = None) -> Callable:
    """``epoch(state, inputs, outputs, generator) -> metrics``: ``n_epochs``
    epochs over the resident ``inputs``/``outputs`` (device tensors), in
    ``ceil(N/B)`` steps each; returns the last epoch's live-sample-weighted
    metric means, as 0-d device tensors. ``shuffle=False`` takes the samples
    in order (parity tests). ``encoder_only`` as :func:`make_train_step`'s.

    ``augment``: optional ``(generator, inputs, outputs) -> (inputs, outputs)``
    run on the device inside the epoch function
    (``data/device_pipeline.py::make_on_device_augment``): callers pass the
    clean base grids as inputs and outputs, and every epoch (or, with
    ``augment_per_epoch=False``, every call: a block of ``n_epochs``, also
    when that is 1) trains on a fresh masking/render. Its draws come from
    ``generator``, before the epoch's shuffle.

    ``plan``: a mesh plan; every rank draws the same shuffle and trains on
    its rows of each global batch (:func:`_make_dp_shard_step`). The JAX
    package picks between its GSPMD step and its ``shard_map`` step with
    ``dp_shard``; both compute what the port's one per-rank step computes,
    so ``dp_shard`` is accepted and changes nothing. ``step_fn``: optional
    ``(state, x, y, w, generator) -> metrics`` in place of the train step
    (the pipeline's, ``parallel/pipeline.py::make_pipeline_step``)."""
    if step_fn is None:
        step_fn = make_train_step(hit_loss_penalty, encoder_only, plan=plan)
    n_batches = -(-n_samples // batch_size)
    padded = n_batches * batch_size

    def one_epoch(state, inputs, outputs, generator):
        if augment is not None and augment_per_epoch:
            inputs, outputs = augment(generator, inputs, outputs)
        dev = inputs.device
        perm = (torch.randperm(n_samples, generator=generator, device=dev) if shuffle
                else torch.arange(n_samples, device=dev))
        idx = torch.cat([perm, perm.new_zeros(padded - n_samples)]).view(n_batches, batch_size)
        weights = (torch.arange(padded, device=dev) < n_samples).float().view(
            n_batches, batch_size)
        sums = torch.zeros(len(METRIC_KEYS), device=dev)
        for i in range(n_batches):
            m = step_fn(state, inputs.index_select(0, idx[i]),
                        outputs.index_select(0, idx[i]), weights[i], generator)
            sums += torch.stack([m[k] for k in METRIC_KEYS]) * weights[i].sum()
        return dict(zip(METRIC_KEYS, sums / n_samples))

    def epoch(state, inputs, outputs, generator):
        if augment is not None and not augment_per_epoch:
            inputs, outputs = augment(generator, inputs, outputs)
        for _ in range(n_epochs):
            metrics = one_epoch(state, inputs, outputs, generator)
        return metrics

    return epoch


def make_watch_fn(hit_loss_penalty: float, batch_size: int, encoder_only: bool = True,
                  bins: int = 64, augment: Callable | None = None) -> Callable:
    """The reference's ``wandb.watch``: per-tensor histograms of the
    parameters and of the gradients from one batch. Returns
    ``watch(model, inputs, outputs, generator) -> {key: (counts, edges)}``
    with wandb.watch's keys, ``parameters/<path>`` and ``gradients/<path>``,
    ``<path>`` the flax path (``encoder_layer_0/self_attn/qkv/kernel``) in
    the JAX package's order, so the logs of the two packages line up. The
    batch is the first ``batch_size`` items (after ``augment`` on a window
    rounded up to 64 items, as the JAX package's), one train-mode forward and
    backward that leaves the parameters, their ``.grad`` and the optimizer
    alone. The histograms are ``torch.histc`` on the device over each
    tensor's [min, max] (widened by 0.5 each way when they are equal, as
    ``jnp.histogram`` does): the ranges come to the host in one transfer, the
    stacked counts in another."""
    window = batch_size if augment is None else -(-batch_size // 64) * 64

    def watch(model, inputs, outputs, generator) -> dict:
        from ..models.torch_compat import flax_layout

        x, y = inputs[:window], outputs[:window]
        if augment is not None:
            x, y = augment(generator, x, y)
        x, y = x[:batch_size], y[:batch_size]
        named = dict(model.named_parameters())
        was_training = model.training
        model.train()
        try:
            pred = model(x, generator=generator) if encoder_only else model(x, y, generator)
            loss = calculate_loss(pred, y, hit_loss_penalty).total_loss
            grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        finally:
            model.train(was_training)
        layout = sorted(flax_layout(model.config))
        names, leaves = [], []
        for prefix, source in (("parameters", named), ("gradients", grads)):
            for path, key, _transposed, rows in layout:
                names.append(prefix + "/" + "/".join(path))
                t = source[key].detach()
                leaves.append((t if rows is None else t[rows]).float().reshape(-1))
        with torch.no_grad():
            ranges = torch.stack([torch.stack(torch.aminmax(t)) for t in leaves]).cpu().numpy()
            lo, hi = ranges[:, 0].astype(np.float64), ranges[:, 1].astype(np.float64)
            same = lo == hi
            lo[same] -= 0.5
            hi[same] += 0.5
            counts = torch.stack([torch.histc(t, bins, float(a), float(b))
                                  for t, a, b in zip(leaves, lo, hi)]).cpu().numpy()
        return {name: (counts[i].astype(np.int64),
                       np.linspace(lo[i], hi[i], bins + 1, dtype=np.float32))
                for i, name in enumerate(names)}

    return watch


def make_eval_loss_fn(hit_loss_penalty: float, encoder_only: bool = True) -> Callable:
    """``eval_loss(model, x, y) -> metrics``: the deterministic held-out loss
    (eval mode, no dropout, no gradients), as 0-d device tensors; teacher
    forced on ``y`` when ``encoder_only`` is false."""

    def eval_loss(model, x, y) -> dict:
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                pred = model(x) if encoder_only else model(x, y)
                out = calculate_loss(pred, y, hit_loss_penalty)
        finally:
            model.train(was_training)
        return {k: getattr(out, "total_loss" if k == "loss" else k) for k in EVAL_KEYS}

    return eval_loss


def fetch(metrics: dict) -> dict:
    """Device metric tensors → host floats, in one transfer."""
    values = torch.stack([torch.as_tensor(v, dtype=torch.float32) for v in metrics.values()])
    return dict(zip(metrics, values.cpu().tolist()))


def train_epoch(epoch_fn, state, inputs, outputs, generator):
    """Run one epoch function; returns (state, host-side float metrics)."""
    return state, fetch(epoch_fn(state, inputs, outputs, generator))
