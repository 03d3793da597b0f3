"""The reference's training contract, as the JAX package's ``train/driver.py``:
``initialize_model`` + ``train_loop``, over :class:`ModelBundle`, for both
model families (``num_decoder_layers`` in the model parameters,
``train_loop(encoder_only=0)`` for teacher forcing).

Not ported yet, each raising ``NotPortedError``: resuming from a checkpoint
(``load_model``), saving one (``train_loop(save=True)``). ``train_loop`` logs
nothing; it returns the epoch's metric dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import NotPortedError, require_device
from ..models import predict as model_predict
from ..models.transformer import GrooveTransformerConfig
from .config import (
    resolve_compute_dtype, resolve_fused_decoder_layer, resolve_fused_ffn, resolve_fused_layer,
    resolve_remat,
)
from .loop import TrainState, create_train_state, fetch, make_epoch_fn, make_eval_loss_fn


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
    encoder-decoder family. ``bf16``, ``fused_ffn`` and ``remat`` in
    ``params["model"]`` are resolved for that device (``train/config.py``;
    None or absent = auto); ``fused_dropout_ln`` (off unless given) and
    ``remat_policy`` are taken as they are.

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
    if params.get("load_model"):
        raise NotPortedError("load_model: restoring a checkpoint into the port is "
                             "not ported yet")
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
    bundle = ModelBundle(model=state.model, config=config, state=state, device=device,
                         optimizer_algorithm=algorithm, learning_rate=lr)
    return bundle, state.optimizer, 0


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
    generator seeded with ``seed``, else ``epoch``."""
    if save:
        raise NotPortedError("train_loop(save=True): checkpoints are not ported yet")
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
    return fetch(metrics)
