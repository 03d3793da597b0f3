"""Training configuration, as the JAX package's ``train/config.py``.

The reference's YAML surface (the hyperparameter keys of
``configs/*_training.yaml``) maps onto :class:`HyperParams`, and
:func:`derive_model_config` derives the model config from it
(``num_decoder_layers=0`` when encoder-only, ``embedding_size_src`` 16 for MSO
input vs 27 for the symbolic experiment, ``max_len=32``). The switches the JAX
package resolves for the TPU are resolved here for one CUDA card (or the CPU):
bf16 matmuls on CUDA; the whole-layer kernels (encoder and decoder) where
their Hopper gates admit the shape and the batch is one at which they were
measured faster; the fused FFN kernels nowhere yet (their gain has not
cleared the spread between turns); remat by the same memory estimate. Each
auto switch is on only where the card showed a gain (PERF.md §5).
The YAML files are read by ``utils/yaml_subset.py`` (the machine with the
card has no pyyaml), which gives what ``yaml.safe_load`` gives on them.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Optional

import torch

from .. import require_device
from ..models.transformer import GrooveTransformerConfig
from ..ops.fused_decoder_layer import supports_fused_decoder_layer
from ..ops.fused_layer import supports_fused_layer
from ..utils import yaml_subset

HVO_WIDTH = 27
MSO_BANDS = 16
MAX_LEN = 32


@dataclasses.dataclass
class HyperParams:
    """The reference's hyperparameter schema, field for field the JAX
    package's (``bf16``, ``fused_*``, ``remat*``: None = auto)."""

    experiment: str = ""
    encoder_only: int = 1
    optimizer_algorithm: str = "sgd"
    d_model: int = 64
    n_heads: int = 16
    dropout: float = 0.2
    num_encoder_decoder_layers: int = 7
    hit_loss_penalty: float = 1.0
    batch_size: int = 16
    dim_feedforward: int = 256
    learning_rate: float = 0.05
    epochs: int = 100
    load_model: Optional[Any] = None
    notes: Optional[str] = None
    bf16: Optional[bool] = None
    fused_ffn: Optional[bool] = None
    fused_layer: Optional[bool] = None
    fused_decoder_layer: Optional[bool] = None
    remat: Optional[bool] = None
    remat_policy: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "HyperParams":
        known = {f.name for f in dataclasses.fields(cls)}
        hp = cls(**{k: v for k, v in d.items() if k in known})
        hp.extra = {k: v for k, v in d.items() if k not in known}  # round-tripped
        return hp

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("notes", None)
        return d


def load_hyperparameters(config_path: str) -> HyperParams:
    """Load a reference-format training YAML."""
    return HyperParams.from_dict(yaml_subset.load_file(config_path))


def load_paths(paths_path: str) -> dict:
    """Load the experiment → dataset/evaluator path map (configs/paths.yaml)."""
    return yaml_subset.load_file(paths_path)


def embedding_size_src_for(experiment: str) -> int:
    """16 MSO bands for audio experiments; 27 (raw HVO) for symbolic ones."""
    return HVO_WIDTH if "Symbolic" in experiment else MSO_BANDS


def resolve_compute_dtype(bf16: Optional[bool], device="cuda") -> torch.dtype:
    """bf16 hyperparameter → matmul dtype. ``None`` = auto: bfloat16 on a
    CUDA device (as the JAX package picks it on its accelerator), float32 on
    the CPU. ``device="cuda"`` without CUDA raises."""
    device = require_device(device, "resolve_compute_dtype")
    if bf16 is None:
        bf16 = device.type == "cuda"
    return torch.bfloat16 if bf16 else torch.float32


def resolve_fused_ffn(fused_ffn: Optional[bool], dim_feedforward: int, d_model: int,
                      compute_dtype=None, device="cuda") -> bool:
    """fused_ffn hyperparameter → fused FFN kernel switch (the JAX package's
    signature, and ``device``). ``None`` = auto, gated by measurement as the
    JAX package's is: off, because no setting has shown the kernel path
    faster than ``fused_ffn=False`` by more than the spread between turns. A
    forced True is kept; the model raises if the kernels' Hopper gate
    (``ops/fused_ffn.py::supports_fused_ffn``) rejects the width.
    ``device="cuda"`` without CUDA raises.

    On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phases 18 and 19,
    bf16; PERF.md §5), seqs/s with the kernels over seqs/s with
    ``fused_ffn=False``, each pair of turns run back to back: GrooveXL (d
    1024, ff 4096, 12 layers, batch 128) under remat 0.92-1.33 (median 1.04,
    13 pairs in 7 runs, 6 of them below 1.035), without remat 0.93-1.12
    (median 1.03, 12 pairs in 6 runs), while one path's two turns in one run
    differ by 0.6-26 % (median 5.5 %). The lm config (d 256, ff 2048, 8
    layers) was slower in 9 of 14 turns at batch 32 and 5 of 14 at 512. The
    steps are host-bound (3,056 launches a GrooveXL step), so the device time
    the kernels save (178 to 31 ms a GrooveXL step) does not reach seqs/s by
    more than the host's noise. The f32 kernels lose to
    cuBLAS at every width measured."""
    if fused_ffn is not None:
        return bool(fused_ffn)
    require_device(device, "resolve_fused_ffn")
    return False


# The largest training batch at which each route's whole-layer kernels were
# measured faster than the unfused path by more than the spread between turns
# (PERF.md §5). bf16, the chains of csrc/layer_sm90.cu: faster at 32 and at 512,
# the two batches measured; above 512 nothing was measured. f32, the CUDA-core
# kernels of csrc/fused_layer.cu and csrc/fused_decoder_layer.cu: their design
# won at 32 and ran about 4x slower than the unfused path at 512, so 32
LAYER_KERNEL_MAX_BATCH = {torch.bfloat16: 512, torch.float32: 32}


def _measured_batch(batch_size: Optional[int], compute_dtype) -> bool:
    """Whether the kernels of ``compute_dtype``'s route were measured faster
    at ``batch_size`` (``LAYER_KERNEL_MAX_BATCH``); False when no batch is
    given."""
    limit = LAYER_KERNEL_MAX_BATCH.get(compute_dtype)
    return batch_size is not None and limit is not None and batch_size <= limit


def resolve_fused_layer(fused_layer: Optional[bool], d_model: int, n_heads: int,
                        dim_feedforward: int, n_devices: int = 1,
                        compute_dtype=torch.float32, seq_len: int = MAX_LEN, *,
                        batch_size: Optional[int] = None) -> bool:
    """fused_layer hyperparameter → whole-encoder-layer kernel switch (the
    JAX package's positional signature, then ``batch_size``). ``None`` = auto,
    gated by measurement as the JAX package's is: on for a single device
    where the kernels' Hopper gate (``ops/fused_layer.py::supports_fused_layer``)
    admits the shape and the training batch is one at which the route's
    kernels were measured faster, ``batch_size`` <= 512 in bf16 and <= 32 in
    f32 (``LAYER_KERNEL_MAX_BATCH``); off when the batch is larger or not
    given. A forced True is kept; the model raises if the gate rejects it.

    On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, phase 9; PERF.md §5),
    flagship width, bf16, the bf16 chain of csrc/layer_sm90.cu against
    ``fused_layer=False``, two turns each: 2,319-2,433 seqs/s against 819-925
    at batch 32 (one path's two turns up to 13 % apart), 33,591-45,043 against
    13,324-13,672 at batch 512 (up to 34 % apart); the worst pair of turns
    gains 2.5x at both. Phase 18 gives the same verdict at ff 2048
    (configs/InfillingRandomLow_lm_training.yaml): 2,174-2,298 against the
    unfused path's 721-799 at batch 32, 34,160-37,921 against 10,067-10,984
    at 512. The f32 route keeps the verdict of its CUDA-core design, measured
    with bf16 storage before the bf16 chains existed: 1,667-1,713 seqs/s
    against 855-938 at batch 32, 3,328-3,381 against 12,600-17,500 at 512."""
    if fused_layer is not None:
        return bool(fused_layer)
    return (n_devices == 1 and _measured_batch(batch_size, compute_dtype)
            and supports_fused_layer(d_model, n_heads, dim_feedforward, seq_len, compute_dtype))


def resolve_fused_decoder_layer(fused_decoder_layer: Optional[bool], d_model: int,
                                n_heads: int, dim_feedforward: int, n_devices: int = 1,
                                compute_dtype=torch.float32, seq_len: int = MAX_LEN, *,
                                batch_size: Optional[int] = None) -> bool:
    """fused_decoder_layer hyperparameter → whole-decoder-layer kernel switch
    (encoder-decoder models), by the rule of :func:`resolve_fused_layer`:
    ``None`` = auto, on for a single device where the decoder kernels' Hopper
    gate (``ops/fused_decoder_layer.py::supports_fused_decoder_layer``) admits
    the shape and ``batch_size`` is within the route's
    ``LAYER_KERNEL_MAX_BATCH`` (bf16 512, f32 32); off when the batch is
    larger or not given. A forced True is kept; the model raises if the gate
    rejects it.

    The 6 + 6 layer model at the flagship width on an NVIDIA H100 80GB HBM3
    at 700 W (chip_smoke.py, phase 15; PERF.md §5), bf16: 901-1,134 seqs/s on
    the kernel path against 370-386 with both fused switches off at batch 32;
    14,845-15,176 against 4,707-4,813 at batch 512."""
    if fused_decoder_layer is not None:
        return bool(fused_decoder_layer)
    return (n_devices == 1 and _measured_batch(batch_size, compute_dtype)
            and supports_fused_decoder_layer(d_model, n_heads, dim_feedforward, seq_len,
                                             compute_dtype))


def device_hbm_bytes(device="cuda") -> int:
    """Device memory for the auto-remat estimate: ``TGI_HBM_BYTES`` if set
    (a positive byte count; invalid values are ignored with a warning), the
    CUDA card's total memory, else 16 GiB (``device="cpu"``). ``device="cuda"``
    without CUDA raises."""
    device = require_device(device, "device_hbm_bytes")
    env = os.environ.get("TGI_HBM_BYTES")
    if env:
        try:
            override = int(float(env))
        except ValueError:
            override = 0
        if override > 0:
            return override
        warnings.warn(f"ignoring invalid TGI_HBM_BYTES={env!r} "
                      "(need a positive byte count)")
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return 16 * 1024**3


def resolve_remat(remat: Optional[bool], *, d_model: int, n_heads: int,
                  dim_feedforward: int, n_layers: int, batch_size: int,
                  n_decoder_layers: int = 0, optimizer: str = "sgd",
                  n_data_shards: int = 1, n_replicas: int = 1,
                  max_len: int = MAX_LEN, compute_dtype=None,
                  hbm_bytes: Optional[int] = None, device="cuda") -> bool:
    """remat hyperparameter → layer rematerialisation. ``None`` = auto, the
    JAX package's estimate: on only when the stored backward residuals
    (at the compute dtype, plus u8 masks) and params + grads + optimizer
    state (f32) would exceed 60 % of ``device``'s memory (``hbm_bytes`` if
    given; else ``device="cuda"`` without CUDA raises)."""
    if remat is not None:
        return bool(remat)
    per_device_batch = max(1, batch_size // max(1, n_data_shards))
    itemsize = (compute_dtype or torch.bfloat16).itemsize
    d, ff, t = d_model, dim_feedforward, max_len
    layer_cost = n_layers + 2 * n_decoder_layers
    act_per_layer_token = (itemsize * (7 * d + ff + n_heads * t)
                           + (2 * d + ff + n_heads * t))
    act_bytes = per_device_batch * t * layer_cost * act_per_layer_token
    param_count = layer_cost * (4 * d * d + 2 * d * ff + 9 * d)
    copies = 4 if optimizer == "adam" else 3
    static_bytes = copies * 4 * param_count
    act_bytes *= n_replicas
    static_bytes *= n_replicas
    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes(device)
    return act_bytes + static_bytes > 0.6 * hbm_bytes


def derive_model_config(hp: HyperParams, compute_dtype=None, n_devices: int = 1,
                        device="cuda") -> GrooveTransformerConfig:
    """The model config of a :class:`HyperParams`, switches resolved for
    ``device`` (``"cuda"`` without CUDA raises)."""
    device = require_device(device, "derive_model_config")
    if compute_dtype is None:
        compute_dtype = resolve_compute_dtype(hp.bf16, device)
    n_dec = 0 if hp.encoder_only else hp.num_encoder_decoder_layers
    remat = resolve_remat(hp.remat, d_model=hp.d_model, n_heads=hp.n_heads,
                          dim_feedforward=hp.dim_feedforward,
                          n_layers=hp.num_encoder_decoder_layers, n_decoder_layers=n_dec,
                          optimizer=hp.optimizer_algorithm, batch_size=hp.batch_size,
                          compute_dtype=compute_dtype, device=device)
    return GrooveTransformerConfig(
        fused_ffn=resolve_fused_ffn(hp.fused_ffn, hp.dim_feedforward, hp.d_model, compute_dtype,
                                    device),
        fused_layer=resolve_fused_layer(hp.fused_layer, hp.d_model, hp.n_heads,
                                        hp.dim_feedforward, n_devices, compute_dtype,
                                        batch_size=hp.batch_size),
        fused_decoder_layer=(
            resolve_fused_decoder_layer(hp.fused_decoder_layer, hp.d_model, hp.n_heads,
                                        hp.dim_feedforward, n_devices, compute_dtype,
                                        batch_size=hp.batch_size)
            if n_dec > 0 else False),
        remat=remat,
        remat_policy=hp.remat_policy,
        d_model=hp.d_model,
        n_heads=hp.n_heads,
        dim_feedforward=hp.dim_feedforward,
        dropout=hp.dropout,
        num_encoder_layers=hp.num_encoder_decoder_layers,
        num_decoder_layers=n_dec,
        max_len=MAX_LEN,
        embedding_size_src=embedding_size_src_for(hp.experiment),
        embedding_size_tgt=HVO_WIDTH,
        compute_dtype=compute_dtype,
    )
