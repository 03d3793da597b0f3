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
"""

from __future__ import annotations

import dataclasses
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


def make_train_step(hit_loss_penalty: float, encoder_only: bool = True) -> Callable:
    """``step(state, x, y, w, generator) -> metrics``: one update in place.
    ``w`` are the ``(B,)`` sample weights (or None); ``generator`` feeds the
    dropout sites. ``grad_norm`` is the global L2 norm of the gradients.
    ``encoder_only=False`` trains the encoder-decoder family with teacher
    forcing: the target grid also feeds the decoder (shifted inside the
    model)."""

    def step(state: TrainState, x, y, w, generator) -> dict:
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        pred = model(x, generator=generator) if encoder_only else model(x, y, generator)
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


def make_epoch_fn(hit_loss_penalty: float, batch_size: int, n_samples: int,
                  n_epochs: int = 1, shuffle: bool = True, augment: Callable | None = None,
                  augment_per_epoch: bool = True, encoder_only: bool = True) -> Callable:
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
    ``generator``, before the epoch's shuffle."""
    step_fn = make_train_step(hit_loss_penalty, encoder_only)
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
