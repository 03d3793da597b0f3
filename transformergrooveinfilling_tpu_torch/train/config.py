"""Training configuration, as the JAX package's ``train/config.py``.

The reference's YAML surface (the hyperparameter keys of
``configs/*_training.yaml``) maps onto :class:`HyperParams`, and
:func:`derive_model_config` derives the model config from it
(``num_decoder_layers=0`` when encoder-only, ``embedding_size_src`` 16 for MSO
input vs 27 for the symbolic experiment, ``max_len=32``). The switches the JAX
package resolves for the TPU are resolved here for one CUDA card (or the CPU):
bf16 matmuls on CUDA, the whole-layer kernels (encoder and decoder) where
their Hopper gates admit the shape, the fused FFN kernel at ff >= 2048 where
its gate does, and remat by the same memory estimate.
``yaml`` is imported only inside :func:`load_hyperparameters`.
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
from ..ops.fused_ffn import supports_fused_ffn
from ..ops.fused_layer import supports_fused_layer

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
    import yaml

    with open(config_path) as f:
        return HyperParams.from_dict(yaml.safe_load(f))


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
    signature, and ``device``). ``None`` = auto: on for training on a CUDA
    device at ff >= 2048 (the JAX package's threshold) where the kernels' own
    Hopper gate (``ops/fused_ffn.py::supports_fused_ffn``) admits the width at
    the compute dtype; off on the CPU. A forced True is kept; the model raises
    if the gate rejects it. ``device="cuda"`` without CUDA raises.

    The JAX package also asks that both weight matrices fit 4 MB of VMEM
    (``fits_resident``). That is not carried over: no weight pair fits a
    Hopper block's shared memory, the one kernel streams ff tiles at every
    width, and the gate bounds d_model (<= 1,508), not the weights' bytes.

    Auto-on is no measured gain yet. On an NVIDIA H100 80GB HBM3 at 700 W
    (chip_smoke.py, phases 18 and 19; PERF.md), bf16: at d 256 / ff 2048, 8
    layers, 654-867 seqs/s on the kernel path against 799-808 with
    ``fused_ffn=False`` at batch 32, where the host's eager launches set the
    step either way, and 11,481-11,555 against 12,583-15,808 at batch 512; at
    d 1024 / ff 4096, 12 layers, batch 128 under remat, 694-699 against
    1,040-1,105. The kernels run their products as f32 FMAs on CUDA cores;
    cuBLAS' tensor cores are faster at both widths. Pass False for speed until
    the kernels use ``wgmma``."""
    if fused_ffn is not None:
        return bool(fused_ffn)
    device = require_device(device, "resolve_fused_ffn")
    return (device.type == "cuda" and dim_feedforward >= 2048
            and supports_fused_ffn(d_model, dim_feedforward, compute_dtype or torch.bfloat16))


def resolve_fused_layer(fused_layer: Optional[bool], d_model: int, n_heads: int,
                        dim_feedforward: int, n_devices: int = 1,
                        compute_dtype=torch.float32, seq_len: int = MAX_LEN) -> bool:
    """fused_layer hyperparameter → whole-encoder-layer kernel switch.
    ``None`` = auto: on for a single device wherever the kernels' Hopper gate
    (``ops/fused_layer.py::supports_fused_layer``) admits the shape. A forced
    True is kept; the model raises if the gate rejects it.

    Auto-on is a measured gain at the flagship YAML's batch of 32 only. At
    batch 512 (bench.py's) the kernel path is 2.6-3.2x slower on an H100 than
    ``fused_layer=False``: its weight-gradient kernel walks every sequence in
    each of a few tile blocks (PERF.md, "Where the time goes"). Pass False
    for large-batch runs until that kernel is reworked
    (``resolve_fused_decoder_layer`` has the encoder-decoder model's numbers)."""
    if fused_layer is not None:
        return bool(fused_layer)
    return n_devices == 1 and supports_fused_layer(
        d_model, n_heads, dim_feedforward, seq_len, compute_dtype)


def resolve_fused_decoder_layer(fused_decoder_layer: Optional[bool], d_model: int,
                                n_heads: int, dim_feedforward: int, n_devices: int = 1,
                                compute_dtype=torch.float32, seq_len: int = MAX_LEN) -> bool:
    """fused_decoder_layer hyperparameter → whole-decoder-layer kernel switch
    (encoder-decoder models). ``None`` = auto: on for a single device wherever
    the decoder kernels' own Hopper gate
    (``ops/fused_decoder_layer.py::supports_fused_decoder_layer``) admits the
    shape. A forced True is kept; the model raises if the gate rejects it.

    As for the encoder layer, auto-on is a measured gain at the flagship
    YAML's batch of 32 only. The 6 + 6 layer model at the flagship width on an
    NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, phase 15, two runs;
    PERF.md): 698-700 seqs/s on the kernel path against 329-386 with both
    fused switches off at batch 32, and 1,517-1,530 against 3,766-6,757 at
    batch 512, where the two weight-gradient kernels are 191 ms of a 332 ms
    step. Pass False (for both switches) for large-batch runs until those
    kernels are reworked."""
    if fused_decoder_layer is not None:
        return bool(fused_decoder_layer)
    return n_devices == 1 and supports_fused_decoder_layer(
        d_model, n_heads, dim_feedforward, seq_len, compute_dtype)


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
    return GrooveTransformerConfig(
        fused_ffn=resolve_fused_ffn(hp.fused_ffn, hp.dim_feedforward, hp.d_model, compute_dtype,
                                    device),
        fused_layer=resolve_fused_layer(hp.fused_layer, hp.d_model, hp.n_heads,
                                        hp.dim_feedforward, n_devices, compute_dtype),
        fused_decoder_layer=(
            resolve_fused_decoder_layer(hp.fused_decoder_layer, hp.d_model, hp.n_heads,
                                        hp.dim_feedforward, n_devices, compute_dtype)
            if n_dec > 0 else False),
        remat=resolve_remat(hp.remat, d_model=hp.d_model, n_heads=hp.n_heads,
                            dim_feedforward=hp.dim_feedforward,
                            n_layers=hp.num_encoder_decoder_layers,
                            n_decoder_layers=n_dec, optimizer=hp.optimizer_algorithm,
                            batch_size=hp.batch_size, compute_dtype=compute_dtype,
                            device=device),
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
