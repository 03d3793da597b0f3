"""Batched hyperparameter sweeps: K trials in one vmapped program, as the JAX
package's ``train/vmap_sweep.py``.

K models of one architecture train at once under ``torch.func.vmap`` over
their stacked parameters (``torch.func.stack_module_state``): each trial has
its own learning rate, hit-loss penalty and dropout rate, and every trial sees
the same shuffled batches. A step is one ``vmap(grad_and_value(loss),
randomness="different")`` over ``torch.func.functional_call`` of one template
model, so the K trials' products run as batched products and their dropout
sites draw K different masks from one generator. Per-trial dropout rates ride
the vmap as data (``forward(..., dropout_rate=r)``,
``ops/dropout.py::fast_dropout_as_data``); rates that are all equal stay
static, and the model keeps its configured dropout path.

The JAX package's step vmaps its Pallas kernels with it, and so does this
one. The ranking forward (:func:`stacked_eval_loss`) reaches kernel #1 as
``tgi::fused_mha``, whose vmap rule folds the K trials into one launch
(``ops/attention.py``). The training forward runs the plain attention with
dropout, as every training forward of the port does, unless a training
kernel is switched on: ``fused_layer`` (#2), ``fused_decoder_layer`` (#3),
``fused_ffn`` (#4) and ``fused_dropout_ln`` (#5) reach the card through
operators (``tgi::encoder_layer_fwd``/``_bwd``, ``tgi::decoder_layer_fwd``/
``_bwd``, ``tgi::ffn_fwd``/``_bwd``, ``tgi::ln_fwd``/``_bwd``) bound by
autograd Functions with ``setup_context``, whose vmap rules launch once per
trial on that trial's slices and seed (``ops/per_trial.py``): K launches of
each kernel a call, trial t's outputs and gradients bit for bit those of an
unbatched call with trial t's seed. Under ``randomness="different"`` each
trial draws its own seed for each kernel call. These switches take the
config's rate: with rates that differ they raise
(``models/transformer.py``).

``remat`` (given as 1, or resolved on by the sweep's auto rule) trains the
group as the same one program. ``torch.utils.checkpoint`` raises under
``torch.func.grad`` ("torch.func.{grad, vjp, jacrev, hessian} don't yet
support saved tensor hooks"), so inside a transform each layer runs through
``models/transformer.py::_LayerRemat``, an autograd Function with
``setup_context`` and a generated vmap rule: its forward keeps only the
layer's inputs and parameters (and, under ``remat_policy="dots"``, the dense
products' outputs, one per trial), and its backward sets the dropout
generator back to its state before the forward, replays the layer under
``torch.func.vjp`` on the stacked trials and puts the generator's later state
back. The replay draws the same masks and seeds, so a kernel switch's forward
launches again per trial with the same seed, and a trial's gradients are
those of the group without remat bit for bit, as ``nn.remat`` under
``jax.vmap`` gives the JAX sweep. An unknown ``remat_policy`` raises
``ValueError`` (:func:`check_batchable`).

Optimizers: sgd and adam. The learning rate enters the update as data: sgd
directly, adam through :func:`adam_update`, the bias-corrected moments of
``optax.adam`` (and ``torch.optim.Adam``) written out, with ``(mu, nu, count)``
stacked on the trial axis like the parameters.

Stacked parameters are ``{state-dict key: (K, ...) f32 tensor}``;
``utils/param_layout.py::stacked_state_dict_from_flax_params`` carries the JAX
package's stacked trees across. Generators take the JAX keys' place, and each
entry point takes ``device=`` (``"cuda"`` without CUDA raises).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, stack_module_state, vmap

from .. import require_device
from ..models import build_model
from ..models.losses import calculate_loss
from ..models.transformer import REMAT_POLICIES


def check_batchable(config) -> None:
    """Raise ``ValueError`` when ``config`` turns on ``remat`` with a
    ``remat_policy`` the model does not know (the JAX package's
    ``_remat_wrap`` raises there too)."""
    if config.remat and config.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy: {config.remat_policy!r} "
                         f"(one of {REMAT_POLICIES})")


def trial_seeds(generator: torch.Generator, n_trials: int) -> list:
    """The initialisation seeds of ``n_trials`` trials, drawn from
    ``generator`` (a CPU generator): trial k's is the k-th draw."""
    return torch.randint(0, 2**62, (n_trials,), generator=generator).tolist()


def init_stacked_params(model, config, n_trials: int, generator: torch.Generator,
                        device="cuda") -> dict:
    """K independent initialisations of ``model``'s family at ``config``,
    stacked on a leading trial axis. Trial k is initialised from the k-th
    seed of :func:`trial_seeds`, so it does not depend on K."""
    device = require_device(device, "init_stacked_params")
    models = [type(model)(config, device, torch.Generator().manual_seed(s))
              for s in trial_seeds(generator, n_trials)]
    params, _buffers = stack_module_state(models)
    return {k: v.detach() for k, v in params.items()}


def adam_update(params: dict, opt, grads: dict, lr, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """One bias-corrected adam step with the learning rate as data:
    ``optax.adam``'s ``scale_by_adam`` (eps_root 0) then ``scale(-lr)``.
    ``opt = (mu, nu, count)``."""
    mu, nu, count = opt
    count = count + 1
    mu = {k: b1 * m + (1 - b1) * grads[k] for k, m in mu.items()}
    nu = {k: b2 * v + (1 - b2) * (grads[k] * grads[k]) for k, v in nu.items()}
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    params = {k: p - lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
              for k, p in params.items()}
    return params, (mu, nu, count)


def init_stacked_opt(stacked_params: dict, optimizer: str):
    """Stacked per-trial optimizer state: ``()`` for sgd, zeroed ``(mu, nu,
    count)`` shaped like the stacked parameters for adam."""
    if optimizer == "sgd":
        return ()
    first = next(iter(stacked_params.values()))

    def zeros():
        return {k: torch.zeros_like(v) for k, v in stacked_params.items()}

    return zeros(), zeros(), torch.zeros(first.shape[0], device=first.device)


def _on(values, device) -> torch.Tensor:
    """Arrays, lists or tensors → an f32 tensor on ``device``."""
    return torch.as_tensor(values, dtype=torch.float32, device=device)


def _split(generator: torch.Generator, n: int) -> list:
    """``n`` generators on ``generator``'s device, seeded from its draws."""
    dev = generator.device
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=dev).tolist()
    return [torch.Generator(dev).manual_seed(s) for s in seeds]


def make_batched_sweep_fn(model, batch_size: int, n_samples: int, n_epochs: int,
                          encoder_only: bool = True, config=None, rates_as_data: bool = True,
                          optimizer: str = "sgd"):
    """``(stacked_params, stacked_opt, lrs, penalties, rates, inputs, outputs,
    generator) -> (stacked_params, last-batch losses)``: ``n_epochs`` epochs of
    K trials over the resident ``inputs``/``outputs`` (tensors on ``model``'s
    device; ``lrs``, ``penalties``, ``rates`` ``(K,)`` tensors there).

    Each epoch takes the layout of ``train/loop.py::make_epoch_fn``: a
    permutation, the last batch padded with index 0 at weight 0. The
    permutations and the dropout draws come from two generators split from
    ``generator``, as the JAX sweep splits its permutation key from its dropout
    key: the batch order does not depend on K, and a rate-0 trial's trajectory
    does not depend on the group it runs in. With ``rates_as_data`` every
    dropout site drops at its trial's rate; without, at the model's configured
    rate and path. ``config`` (default ``model.config``) is checked by
    :func:`check_batchable`."""
    if optimizer not in ("sgd", "adam"):
        raise ValueError(f"unknown optimizer_algorithm: {optimizer}")
    check_batchable(model.config if config is None else config)
    n_batches = -(-n_samples // batch_size)
    padded = n_batches * batch_size

    def loss_fn(params, penalty, rate, x, y, w, generator):
        kwargs = {"generator": generator}
        if rates_as_data:
            kwargs["dropout_rate"] = rate
        pred = functional_call(model, params, (x,) if encoder_only else (x, y), kwargs)
        return calculate_loss(pred, y, penalty, sample_weights=w).total_loss

    def trial_step(params, opt, lr, penalty, rate, x, y, w, generator):
        grads, loss = grad_and_value(loss_fn)(params, penalty, rate, x, y, w, generator)
        if optimizer == "adam":
            params, opt = adam_update(params, opt, grads, lr)
        else:
            params = {k: p - lr * grads[k] for k, p in params.items()}
        return params, opt, loss

    step = vmap(trial_step, in_dims=(0, 0, 0, 0, 0, None, None, None, None),
                randomness="different")

    def sweep(stacked_params, stacked_opt, lrs, penalties, rates, inputs, outputs, generator):
        dev = inputs.device
        perm_generator, dropout_generator = _split(generator, 2)
        weights = (torch.arange(padded, device=dev) < n_samples).float().view(
            n_batches, batch_size)
        was_training = model.training
        model.train()
        try:
            for _ in range(n_epochs):
                perm = torch.randperm(n_samples, generator=perm_generator, device=dev)
                idx = torch.cat([perm, perm.new_zeros(padded - n_samples)]).view(
                    n_batches, batch_size)
                for i in range(n_batches):
                    stacked_params, stacked_opt, losses = step(
                        stacked_params, stacked_opt, lrs, penalties, rates,
                        inputs.index_select(0, idx[i]), outputs.index_select(0, idx[i]),
                        weights[i], dropout_generator)
        finally:
            model.train(was_training)
        return stacked_params, losses

    return sweep


def batched_sweep(model, config, inputs, outputs, lrs, penalties, epochs: int,
                  batch_size: int, seed: int = 0, rates=None, optimizer: str = "sgd",
                  device="cuda"):
    """K sgd/adam trials in one program → ``(stacked_params, last-batch
    losses)``. ``rates``: per-trial dropout rates (default: the config's for
    every trial). Uniform rates stay static: the model is rebuilt at that
    rate and keeps its configured dropout path (``fast_dropout=False``
    included); only rates that differ ride the vmap as data."""
    device = require_device(device, "batched_sweep")
    lrs, penalties = _on(lrs, device), _on(penalties, device)
    if lrs.shape != penalties.shape:
        raise ValueError(f"{lrs.shape[0]} learning rates, {penalties.shape[0]} penalties")
    rates_np = (np.full(lrs.shape, config.dropout, np.float32) if rates is None
                else np.asarray(rates, np.float32))
    if rates_np.shape != lrs.shape:
        raise ValueError(f"{lrs.shape[0]} learning rates, {rates_np.shape[0]} dropout rates")
    uniform = bool(np.all(rates_np == rates_np[0]))
    if uniform and float(rates_np[0]) != config.dropout:
        config = dataclasses.replace(config, dropout=float(rates_np[0]))
        model = build_model(config, device)
    stacked = init_stacked_params(model, config, lrs.shape[0],
                                  torch.Generator().manual_seed(seed), device)
    x, y = _on(inputs, device), _on(outputs, device)
    fn = make_batched_sweep_fn(model, batch_size, x.shape[0], epochs,
                               encoder_only=config.encoder_only, config=config,
                               rates_as_data=not uniform, optimizer=optimizer)
    return fn(stacked, init_stacked_opt(stacked, optimizer), lrs, penalties,
              _on(rates_np, device), x, y,
              torch.Generator(device).manual_seed(seed + 1))


def stacked_eval_loss(model, stacked_params: dict, inputs, outputs, penalties,
                      encoder_only: bool = True, device="cuda") -> torch.Tensor:
    """Deterministic full-set loss per trial, ``(K,)``: one vmapped eval
    forward over the K stacked parameter sets, without gradients. This is the
    number a batched sweep ranks on: the last training batch's loss depends on
    which samples landed in it. On a CUDA device with ``use_fused_attention``
    the forward runs kernel #1 once per attention for all K trials."""
    device = require_device(device, "stacked_eval_loss")
    x, y, penalties = _on(inputs, device), _on(outputs, device), _on(penalties, device)

    def one(params, penalty):
        pred = functional_call(model, params, (x,) if encoder_only else (x, y))
        return calculate_loss(pred, y, penalty).total_loss

    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return vmap(one)(stacked_params, penalties)
    finally:
        model.train(was_training)
