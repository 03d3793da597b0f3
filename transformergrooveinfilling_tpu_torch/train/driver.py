"""The reference's training contract, as the JAX package's ``train/driver.py``:
``initialize_model`` (with ``load_model`` resuming from a checkpoint) +
``train_loop`` (with ``save``), over :class:`ModelBundle`, for both model
families (``num_decoder_layers`` in the model parameters,
``train_loop(encoder_only=0)`` for teacher forcing), and the production loop
``run_training`` on one device: epoch blocks, the on-device augment,
scheduled saves (snapshot on the device, written by the save worker), a
reference ``.Model`` beside each, wandb.watch histograms, a wall-clock
budget and SIGTERM/SIGINT stops, and each block's metrics, epoch time and
throughput logged through ``utils/logging.py``.

The dropout and shuffle generator of an epoch block is seeded from ``(seed +
1, the block's first epoch)``, never from the previous block's draws, so a
run stopped and resumed from its checkpoint trains exactly as the
uninterrupted run does.

Not ported yet, each raising ``NotPortedError``: ``run_training``'s
evaluators (ROADMAP A5), ``streamer`` and ``regen_cadence`` (A4), a ``plan``
(multi-device, A10) and ``TGI_PROFILE`` traces.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Any

import numpy as np
import torch

from .. import NotPortedError, require_device
from ..models import predict as model_predict
from ..models import torch_compat
from ..models.transformer import GrooveTransformerConfig
from ..utils import logging as xlog
from . import checkpoint as ckpt
from .config import (
    HyperParams, derive_model_config, resolve_compute_dtype, resolve_fused_decoder_layer,
    resolve_fused_ffn, resolve_fused_layer, resolve_remat,
)
from .loop import (
    TrainState, create_train_state, fetch, make_epoch_fn, make_eval_loss_fn, make_watch_fn,
)
from .schedule import eval_log_freq


@dataclasses.dataclass
class ModelBundle:
    """Model + optimizer + state on one device, with the reference's predict
    contract."""

    model: torch.nn.Module
    config: GrooveTransformerConfig
    state: TrainState
    device: torch.device
    optimizer_algorithm: str = "sgd"
    learning_rate: float = 0.05

    def predict(self, inputs, use_thres: bool = True, thres: float = 0.5):
        """Batched deterministic inference → ``[h, v, o]`` numpy arrays,
        fetched in one transfer."""
        x = torch.as_tensor(np.asarray(inputs, np.float32), device=self.device)
        was_training = self.model.training
        self.model.eval()
        try:
            out = model_predict(self.model, x, use_thres=use_thres, thres=thres)
        finally:
            self.model.train(was_training)
        return list(torch.stack(out).cpu().numpy())


def initialize_model(params: dict, device="cuda") -> tuple[ModelBundle, Any, int]:
    """Reference ``initialize_model`` contract: ``params = {"model": {...},
    "training": {...}, "load_model": None | ...}`` → (bundle, optimizer,
    initial_epoch), on ``device`` (``"cuda"`` without CUDA raises; the CPU
    only when asked for). ``num_decoder_layers`` > 0 builds the
    encoder-decoder family. ``load_model`` (``checkpoint.restore``'s dict)
    restores the parameters and the optimizer state from a native checkpoint
    (a ``.Model`` holds the parameters only) and returns its epoch + 1.
    ``bf16``, ``fused_ffn`` and ``remat`` in ``params["model"]`` are resolved
    for that device (``train/config.py``; None or absent = auto);
    ``fused_dropout_ln`` (off unless given) and ``remat_policy`` are taken as
    they are.

    Unlike the reference, ``fused_layer`` and ``fused_decoder_layer`` are
    resolved here too: the JAX ``initialize_model`` passes only ``fused_ffn``
    and ``remat`` and leaves both at their default, off, but on the card the
    whole-layer kernels are why the port exists, so auto turns them on at the
    batch sizes where they were measured faster (<= 512,
    ``resolve_fused_layer``). Every kernel switch is resolved by
    ``params["training"]["batch_size"]`` (default 16)."""
    m = params["model"]
    t = params.get("training", {})
    device = require_device(device, "initialize_model")
    compute_dtype = resolve_compute_dtype(m.get("bf16"), device)
    n_dec = m.get("num_decoder_layers", 0)
    batch = t.get("batch_size", 16)
    gate = (m["d_model"], m["n_heads"], m["dim_feedforward"], 1, compute_dtype,
            m.get("max_len", 32))
    remat = resolve_remat(
        m.get("remat"), d_model=m["d_model"], n_heads=m["n_heads"],
        dim_feedforward=m["dim_feedforward"], n_layers=m["num_encoder_layers"],
        n_decoder_layers=n_dec, optimizer=m.get("optimizer", "sgd"), batch_size=batch,
        max_len=m.get("max_len", 32), compute_dtype=compute_dtype, device=device)
    config = GrooveTransformerConfig(
        fused_ffn=resolve_fused_ffn(m.get("fused_ffn"), m["dim_feedforward"], m["d_model"],
                                    compute_dtype, device),
        fused_dropout_ln=bool(m.get("fused_dropout_ln", False)),
        fused_layer=resolve_fused_layer(m.get("fused_layer"), *gate, batch_size=batch),
        fused_decoder_layer=(resolve_fused_decoder_layer(m.get("fused_decoder_layer"), *gate,
                                                         batch_size=batch)
                             if n_dec > 0 else False),
        remat=remat,
        remat_policy=m.get("remat_policy"),
        d_model=m["d_model"],
        n_heads=m["n_heads"],
        dim_feedforward=m["dim_feedforward"],
        dropout=m["dropout"],
        num_encoder_layers=m["num_encoder_layers"],
        num_decoder_layers=n_dec,
        max_len=m.get("max_len", 32),
        embedding_size_src=m.get("embedding_size_src", 16),
        embedding_size_tgt=m.get("embedding_size_tgt", 27),
        compute_dtype=compute_dtype,
    )
    algorithm = m.get("optimizer", "sgd")
    lr = t.get("learning_rate", 0.05)
    state = create_train_state(config, algorithm, lr, int(t.get("seed", 0)), device)
    initial_epoch = 0
    if params.get("load_model"):
        restored, opt_state, initial_epoch = ckpt.restore(params["load_model"], config)
        state.model.load_state_dict(torch_compat.state_dict_from_flax_params(restored, config),
                                    strict=True)
        if opt_state is not None:
            try:
                torch_compat.load_optax_state(state.optimizer, state.model, config, opt_state)
            except ValueError as e:
                raise ValueError(
                    f"checkpoint optimizer state does not match optimizer={algorithm!r}: it "
                    "was saved by a different optimizer; set params['model']['optimizer'] "
                    "to the one used at save time") from e
    bundle = ModelBundle(model=state.model, config=config, state=state, device=device,
                         optimizer_algorithm=algorithm, learning_rate=lr)
    return bundle, state.optimizer, initial_epoch


def _device_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def train_loop(dataloader=None, groove_transformer: ModelBundle | None = None,
               encoder_only: int = 1, opt=None, epoch: int = 0,
               loss_fn=None, bce_fn=None, mse_fn=None, device=None,
               test_inputs=None, test_gt=None,
               validation_inputs=None, validation_gt=None,
               hit_loss_penalty: float = 1.0, save: bool = False,
               *, dataset=None, batch_size: int = 16, ckpt_dir: str = "checkpoints",
               run_id: str = "local", seed: int | None = None) -> dict:
    """Reference ``train_loop`` contract: one epoch of training, then the
    held-out losses (``test_*``, ``validation_*``). ``encoder_only=0`` trains
    the encoder-decoder family with teacher forcing. ``dataloader`` is the
    dataset object itself (``processed_inputs``/``processed_outputs``), or
    pass ``dataset=``; ``loss_fn``/``bce_fn``/``mse_fn``/``device``/``opt``
    are accepted for the signature and ignored (the bundle holds the
    optimizer and the device). The shuffle and dropout draws come from a
    generator seeded with ``seed``, else ``epoch``. The metrics are logged
    (``utils/logging.py``, uncommitted, as the JAX package does); ``save``
    writes ``ckpt_dir/transformer_run_{run_id}_Epoch_{epoch}.ckpt``."""
    bundle = groove_transformer
    data = dataset if dataset is not None else dataloader
    if bundle is None or data is None:
        raise ValueError("train_loop needs groove_transformer and a dataset")
    dev = bundle.device
    inputs = _device_tensor(data.processed_inputs, dev)
    outputs = _device_tensor(data.processed_outputs, dev)
    epoch_fn = make_epoch_fn(hit_loss_penalty, batch_size, int(inputs.shape[0]),
                             encoder_only=bool(encoder_only))
    eval_loss_fn = make_eval_loss_fn(hit_loss_penalty, bool(encoder_only))
    generator = torch.Generator(dev).manual_seed(epoch if seed is None else seed)
    metrics = epoch_fn(bundle.state, inputs, outputs, generator)
    for name, (hx, hy) in (("test", (test_inputs, test_gt)),
                           ("validation", (validation_inputs, validation_gt))):
        if hx is not None and hy is not None:
            held = eval_loss_fn(bundle.model, _device_tensor(hx, dev), _device_tensor(hy, dev))
            metrics.update({f"{name}_{k}": v for k, v in held.items()})
    metrics = fetch(metrics)
    xlog.log(metrics, commit=False)
    if save:
        ckpt.save_checkpoint(ckpt_dir, run_id, epoch, bundle.state, metrics["loss"],
                             bundle.config)
    return metrics


class _GracefulStop:
    """Preemption-safe stop: SIGTERM/SIGINT finish the current epoch block,
    checkpoint, and return cleanly. A second SIGINT raises
    ``KeyboardInterrupt``. The previous handlers come back on exit. Off the
    main thread no handler can be installed; ``request()`` sets the flag."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def request(self):
        self.requested = True

    def _handle(self, signum, frame):
        if self.requested and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self.requested = True
        print("graceful stop: signal received; finishing the current epoch block, then "
              "checkpointing", flush=True)

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc):
        for sig, handler in self._prev.items():
            signal.signal(sig, handler)
        return False


def block_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of the epoch block that starts at ``epoch``: seeded
    from ``(seed + 1, epoch)`` alone, so a resumed run draws what the
    uninterrupted run drew. ``epoch`` >= 2**31 is the watch events' domain."""
    return torch.Generator(device).manual_seed(((seed + 1) << 32) | int(epoch))


def run_training(hp: HyperParams, dataset, evaluators: dict | None = None, *,
                 bundle: ModelBundle | None = None, initial_epoch: int = 0, plan=None,
                 only_final_eval: bool = False, dump_eval: bool = False,
                 ckpt_dir: str = "checkpoints", export_legacy: bool = False, seed: int = 0,
                 log_media: bool = True, epoch_block: int = 1, streamer=None,
                 regen_cadence: int | str = 1, on_device_augment=None,
                 augment_per_epoch: bool = True, watch_log_freq: int | None = 1000,
                 max_wall_s: float | None = None, media_async: bool = True,
                 device="cuda", _stopper: _GracefulStop | None = None) -> ModelBundle:
    """The JAX package's production loop, on one device (``device``, or the
    bundle's; ``"cuda"`` without CUDA raises).

    ``epoch_block`` epochs run per call of the epoch function; logging, the
    stop check and saves happen per block. ``on_device_augment`` (from
    ``data/device_pipeline.py::make_on_device_augment``) runs inside every
    epoch, or once a block with ``augment_per_epoch=False``; pass the clean
    grids as the dataset's ``processed_inputs``/``processed_outputs``. A
    checkpoint is saved after every block that holds an epoch of the
    reference schedule (``eval_log_freq``; ``only_final_eval``: the last
    epoch only) and at a stop, by a device snapshot written on the save
    worker, with a ``.Model`` beside it when ``export_legacy`` (encoder-only models).
    ``watch_log_freq``: parameter and gradient histograms every that many
    steps (None: never). ``max_wall_s``: stop after the first block that
    crosses the wall-clock budget; SIGTERM/SIGINT stop the same way. Every
    block logs its metrics, ``epoch_time_s`` and ``seqs_per_sec``; saves are
    flushed before the function returns. ``_stopper``: a test hook.

    ``log_media``, ``dump_eval`` and ``media_async`` act on the evaluators'
    passes only. Not ported yet, each raising ``NotPortedError``:
    ``evaluators`` (ROADMAP A5), ``streamer`` and ``regen_cadence`` other than 1
    (A4), a ``plan`` (A10), ``TGI_PROFILE`` with a run active."""
    if evaluators:
        raise NotPortedError("run_training(evaluators=...): held-out losses and metric "
                             "families come from the evaluators, which are not ported yet "
                             "(ROADMAP A5)")
    if streamer is not None or regen_cadence != 1:
        raise NotPortedError("run_training(streamer=, regen_cadence=): host-streamed "
                             "augmentation is not ported yet (ROADMAP A4); use "
                             "on_device_augment")
    if plan is not None:
        raise NotPortedError("run_training(plan=...): meshes and multi-device training are "
                             "not ported yet (ROADMAP A10); the port trains on one device")
    run = xlog.run
    if os.environ.get("TGI_PROFILE") and run is not None:
        raise NotPortedError("TGI_PROFILE: device traces of a run are not ported yet "
                             "(ROADMAP A3)")
    if bundle is None:
        device = require_device(device, "run_training")
        config = derive_model_config(hp, device=device)
        state = create_train_state(config, hp.optimizer_algorithm, hp.learning_rate, seed,
                                   device)
        bundle = ModelBundle(model=state.model, config=config, state=state, device=device,
                             optimizer_algorithm=hp.optimizer_algorithm,
                             learning_rate=hp.learning_rate)
    dev = bundle.device
    inputs = _device_tensor(dataset.processed_inputs, dev)
    outputs = _device_tensor(dataset.processed_outputs, dev)
    n = int(inputs.shape[0])
    if n == 0:
        raise ValueError("dataset is empty")
    encoder_only = bundle.config.encoder_only
    epoch_block = max(1, min(epoch_block, hp.epochs - initial_epoch or 1))

    def epoch_fn_of(block: int):
        return make_epoch_fn(hp.hit_loss_penalty, hp.batch_size, n, n_epochs=block,
                             augment=on_device_augment, augment_per_epoch=augment_per_epoch,
                             encoder_only=encoder_only)

    epoch_fn = epoch_fn_of(epoch_block)
    save_partial, save_all = eval_log_freq(
        total_epochs=hp.epochs, initial_epochs_lim=10, initial_step_partial=1,
        initial_step_all=1, secondary_step_partial=10, secondary_step_all=20,
        only_final=only_final_eval)
    scheduled = set(int(e) for e in save_partial) | set(int(e) for e in save_all)
    run_id = run.id if run is not None else time.strftime("%H%M%S")
    steps_per_epoch = -(-n // hp.batch_size)
    steps_done = initial_epoch * steps_per_epoch
    watch_events = steps_done // watch_log_freq if watch_log_freq else 0
    watch_fn = None
    stopper = _stopper or _GracefulStop()
    run_start = time.time()
    try:
        with stopper:
            ep = initial_epoch
            while ep < hp.epochs:
                block = min(epoch_block, hp.epochs - ep)
                run_fn = epoch_fn if block == epoch_block else epoch_fn_of(block)
                t0 = time.time()
                metrics = fetch(run_fn(bundle.state, inputs, outputs,
                                       block_generator(seed, ep, dev)))
                ep += block  # one past the last epoch trained
                dt = time.time() - t0
                metrics["epoch_time_s"] = dt / block
                metrics["seqs_per_sec"] = n * block / dt if dt > 0 else 0.0
                stop_now = stopper.requested or (
                    max_wall_s is not None and time.time() - run_start > max_wall_s)
                if stop_now:
                    metrics["graceful_stop"] = 1.0
                last_ep = ep - 1
                xlog.log({**metrics, "epoch": last_ep}, commit=False)

                steps_done += block * steps_per_epoch
                if (not stop_now and watch_log_freq
                        and steps_done // watch_log_freq > watch_events):
                    watch_events = steps_done // watch_log_freq
                    if watch_fn is None:
                        watch_fn = make_watch_fn(hp.hit_loss_penalty, hp.batch_size,
                                                 encoder_only=encoder_only,
                                                 augment=on_device_augment)
                    hists = watch_fn(bundle.model, inputs, outputs,
                                     block_generator(seed, 2 ** 31 + watch_events, dev))
                    xlog.log({k: xlog.Histogram(c, e) for k, (c, e) in hists.items()},
                             commit=False)

                if stop_now or any(e in scheduled for e in range(ep - block, ep)):
                    ckpt.save_snapshot_async(
                        ckpt_dir, run_id, last_ep, ckpt.snapshot_state_on_device(bundle.state),
                        metrics["loss"], bundle.config,
                        legacy=bool(export_legacy and encoder_only))
                xlog.log({"epoch": last_ep}, commit=True)
                if stop_now:
                    print(f"graceful stop: checkpoint saved at epoch {last_ep} ({run_id}); "
                          f"resume with load_model location=local dir={ckpt_dir}", flush=True)
                    break
    finally:
        ckpt.flush_async_saves()
    return bundle
