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
from ..ops import layer_sm90
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
    more than the host's noise.

    f32 (``bf16: false``; the FFN's five products in split TF32), 3 pairs of
    turns back to back a run (PERF.md §5): the lm config, layers unfused, at
    batch 32 pairs 1.127, 0.942, 1.205 and 0.922, 1.065, 1.118 (two runs;
    one path's turns 24.1 % and 18.7 % apart), at batch 512 0.923, 0.920,
    0.835 and 0.995, 1.160, 1.139 (12.7 %, 16.4 %; the kernel path's step
    30.3 ms of device in 41.6 of host, the unfused one's 40.6 in 44.6);
    GrooveXL under remat in five runs 1.121, 1.041, 1.149 (9.9 %); 1.167,
    1.205, 1.211 (4.2 %); 1.194, 1.192, 0.967 (22.9 %); 1.594, 1.225, 1.199
    (31.4 %); 1.214, 1.183, 1.716 (41.0 %), its step 104-106 ms of device
    against 128. The worst pair clears the spread (ROADMAP §C1's rule) in one
    GrooveXL run of five and in no lm run, so f32 auto is off too, though each
    f32 call is faster than the library composition on the stream (forward
    0.57-0.95 of its time, backward 0.25-0.80; two runs, PERF.md §6)."""
    if fused_ffn is not None:
        return bool(fused_ffn)
    require_device(device, "resolve_fused_ffn")
    return False


# The largest training batch at which each dtype's whole-layer chains
# (csrc/layer_sm90.cu) were measured faster than the unfused path by more than
# the spread between turns (PERF.md §5): faster at 32 and at 512, the two
# batches measured, in bf16 and in f32 (split TF32); above 512 nothing was
# measured
LAYER_KERNEL_MAX_BATCH = {torch.bfloat16: 512, torch.float32: 512}
# The widest d at which auto turns each dtype's whole-layer chains on. Up to
# 256 the chains put the LayerNorm in their products' epilogues (the turns
# above); past it they take their wide route (16 launches an encoder layer, 26
# a decoder layer). Its paired turns were taken at one shape, d 512 with 4
# heads of 128 and ff 1,024 (chip_smoke.py phases 9 and 15: 3 pairs a batch,
# the chains against the unfused path, the decoder at 2 + 2 layers; NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md §5 names each run). In bf16 every run's
# worst pair gained beyond its turns' spread at batch 32 and 512 in both
# layers (the encoder: +149 % / +102 % against spreads of 32 % / 21 % in the
# first run, +106 % / +130 % against 37 % / 18 % in a later one), so bf16 auto reaches 512, the widest d measured (GrooveXL's 1,024
# stays unfused under auto). In f32 the encoder's worst pair at batch 32
# gained +44 % against a 47 % spread in that first run, so f32 auto stops at
# 256.
LAYER_KERNEL_MAX_D = {torch.bfloat16: 512, torch.float32: 256}
# ... and past d 256 only at the measured head width and ff: no turns were
# paired at other heads (one head of 512 or 1,024, 8 or 16 heads) or at ff
# 2,048, so auto leaves them unfused and a forced switch trains them
LAYER_KERNEL_WIDE_HEAD_DIM = 128
LAYER_KERNEL_WIDE_MAX_FF = 1024
# Where auto turns the chains on past T 32. Every turn above was taken at T 32
# (2-bar loops); past it the attention launches take their long route
# (csrc/attn_stream_sm90.cuh: a (sequence, head) split by query rows), whose
# paired turns were taken at one point only: T 128 (8-bar loops), batch 32,
# the flagship width d 256 / 2 heads / ff 512 (chip_smoke.py phases 9 and 15:
# 3 pairs a dtype, the chains against both switches off; NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md §5). There the flagship gained +113 % in bf16 at its
# worst pair against an 11 % spread between a path's turns (1,518-1,554
# seqs/s against 651-721), +140 % in f32 against 29 %; the 6 + 6 +137 %
# against 15 % in bf16, +134 % against 22 % in f32 (an earlier run: +93 % to
# +141 % against spreads of 24 to 55 %). No other length (33-127, 129-256),
# no batch past 32 rows a device and no other width was paired past T 32:
# auto leaves them unfused and a forced switch trains them.
LAYER_KERNEL_LONG_T = 128
LAYER_KERNEL_LONG_MAX_BATCH = 32
LAYER_KERNEL_LONG_WIDTH = (256, 2, 512)  # d, heads, ff


def _measured_batch(batch_size: Optional[int], compute_dtype) -> bool:
    """Whether the kernels of ``compute_dtype``'s route were measured faster
    at ``batch_size`` (``LAYER_KERNEL_MAX_BATCH``); False when no batch is
    given."""
    limit = LAYER_KERNEL_MAX_BATCH.get(compute_dtype)
    return batch_size is not None and limit is not None and batch_size <= limit


def _measured_width(d_model: int, n_heads: int, dim_feedforward: int, compute_dtype) -> bool:
    """Whether the chains of ``compute_dtype`` were measured faster at this
    width: d up to ``LAYER_KERNEL_MAX_D``, and past d 256 (the wide route)
    heads of ``LAYER_KERNEL_WIDE_HEAD_DIM`` and ff up to
    ``LAYER_KERNEL_WIDE_MAX_FF``."""
    if d_model > LAYER_KERNEL_MAX_D.get(compute_dtype, 0):
        return False
    return (not layer_sm90.is_wide(d_model)
            or (d_model == n_heads * LAYER_KERNEL_WIDE_HEAD_DIM
                and dim_feedforward <= LAYER_KERNEL_WIDE_MAX_FF))


def _measured_length(seq_len: int, batch_size: Optional[int], d_model: int, n_heads: int,
                     dim_feedforward: int) -> bool:
    """Whether the chains were measured faster at sequence length ``seq_len``
    with this batch (a device's) and width: any up to ``layer_sm90.SHORT_T``
    (the other rules decide there); past it only ``LAYER_KERNEL_LONG_T`` at
    batches up to ``LAYER_KERNEL_LONG_MAX_BATCH`` and the
    ``LAYER_KERNEL_LONG_WIDTH``, where the paired turns were taken."""
    if seq_len <= layer_sm90.SHORT_T:
        return True
    return (seq_len == LAYER_KERNEL_LONG_T and batch_size is not None
            and batch_size <= LAYER_KERNEL_LONG_MAX_BATCH
            and (d_model, n_heads, dim_feedforward) == LAYER_KERNEL_LONG_WIDTH)


def _topology_batch(n_devices: int, dp_shard_ok: bool,
                    batch_size: Optional[int]) -> Optional[int]:
    """The batch one device's kernels see: the whole batch on one device, a
    data rank's share on a dp-only plan whose batch divides its data axis
    (``dp_shard_ok``), None (no kernel) on any other topology."""
    if n_devices == 1:
        return batch_size
    if dp_shard_ok and batch_size is not None:
        return batch_size // n_devices
    return None


def resolve_fused_layer(fused_layer: Optional[bool], d_model: int, n_heads: int,
                        dim_feedforward: int, n_devices: int = 1,
                        compute_dtype=torch.float32, seq_len: int = MAX_LEN, *,
                        batch_size: Optional[int] = None, dp_shard_ok: bool = False) -> bool:
    """fused_layer hyperparameter → whole-encoder-layer kernel switch (the
    JAX package's positional signature, then ``batch_size`` and the JAX
    ``dp_shard_ok``). ``None`` = auto, gated by measurement as the JAX
    package's is: on where the kernels' Hopper gate
    (``ops/fused_layer.py::supports_fused_layer``) admits the shape and the
    batch one device sees is one at which the dtype's chain was measured
    faster, <= 512 in bf16 and in f32 (``LAYER_KERNEL_MAX_BATCH``), at a
    width where it was measured faster (``_measured_width``: d up to
    ``LAYER_KERNEL_MAX_D``, past 256 heads of 128 and ff up to 1,024) and a
    sequence length where it was (``_measured_length``: past T 32 only T 128
    at batch 32 or less and the flagship width); off when the
    batch is larger or not given, and at other widths and lengths (a forced
    True trains there). The topology, as the JAX package's: a
    single device, or a data-parallel-only plan whose batch divides the data
    axis (``dp_shard_ok``, from ``train/driver.py::plan_topology``; each rank
    runs the chain on ``batch_size / n_devices`` rows,
    ``train/loop.py::_make_dp_shard_step``); tensor- or pipeline-parallel
    plans keep it off. A forced True is kept; the model raises if the gate
    rejects it, and ``train/driver.py`` on a topology the chain cannot take.

    On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, phase 9; PERF.md §5),
    flagship width, bf16, the bf16 chain of csrc/layer_sm90.cu against
    ``fused_layer=False``, two turns each: 2,319-2,433 seqs/s against 819-925
    at batch 32 (one path's two turns up to 13 % apart), 33,591-45,043 against
    13,324-13,672 at batch 512 (up to 34 % apart); the worst pair of turns
    gains 2.5x at both. Phase 18 gives the same verdict at ff 2048
    (configs/InfillingRandomLow_lm_training.yaml): 2,174-2,298 against the
    unfused path's 721-799 at batch 32, 34,160-37,921 against 10,067-10,984
    at 512. f32 (``bf16: false``), the split-TF32 chain against
    ``fused_layer=False`` in 3 pairs of turns run back to back (chip_smoke.py
    phase 9, NVIDIA H100 80GB HBM3, 700.00 W): 2,938 / 3,430 / 3,206 seqs/s
    against 1,139 / 1,216 / 1,167 at batch 32 (pairs 2.58, 2.82, 2.75; one
    path's turns up to 16.7 % apart), 43,949 / 42,759 / 43,641 against
    19,999 / 14,806 / 21,018 at 512 (pairs 2.20, 2.89, 2.08; up to 42 %
    apart): the worst pair gains 158 % and 108 %, beyond the spread. A second
    run of the final code: worst pairs +123 % and +85 % against spreads of
    15.8 % and 30.7 %."""
    if fused_layer is not None:
        return bool(fused_layer)
    per_device = _topology_batch(n_devices, dp_shard_ok, batch_size)
    return (_measured_batch(per_device, compute_dtype)
            and _measured_width(d_model, n_heads, dim_feedforward, compute_dtype)
            and _measured_length(seq_len, per_device, d_model, n_heads, dim_feedforward)
            and supports_fused_layer(d_model, n_heads, dim_feedforward, seq_len, compute_dtype))


def resolve_fused_decoder_layer(fused_decoder_layer: Optional[bool], d_model: int,
                                n_heads: int, dim_feedforward: int, n_devices: int = 1,
                                compute_dtype=torch.float32, seq_len: int = MAX_LEN, *,
                                batch_size: Optional[int] = None,
                                dp_shard_ok: bool = False) -> bool:
    """fused_decoder_layer hyperparameter → whole-decoder-layer kernel switch
    (encoder-decoder models), by the rule of :func:`resolve_fused_layer`:
    ``None`` = auto, on for a single device or a dp-only plan
    (``dp_shard_ok``) where the decoder kernels' Hopper gate
    (``ops/fused_decoder_layer.py::supports_fused_decoder_layer``) admits
    the shape and the batch one device sees is within the dtype's
    ``LAYER_KERNEL_MAX_BATCH`` (512 in bf16 and in f32), at a width and a
    sequence length where it was measured faster (``_measured_width``,
    ``_measured_length``); off when the batch is larger or not given. A
    forced True is kept; the model raises if the gate rejects it.

    The 6 + 6 layer model at the flagship width on an NVIDIA H100 80GB HBM3
    at 700 W (chip_smoke.py, phase 15; PERF.md §5), bf16: 901-1,134 seqs/s on
    the kernel path against 370-386 with both fused switches off at batch 32;
    14,845-15,176 against 4,707-4,813 at batch 512. f32, both split-TF32
    chains against both switches off in 3 pairs of turns back to back (700.00
    W): 1,243 / 1,162 / 1,088 against 515 / 387 / 438 at batch 32 (pairs
    2.41, 3.00, 2.49; one path's turns up to 33 % apart), 16,067 / 17,388 /
    16,752 against 7,123 / 5,675 / 6,595 at 512 (pairs 2.26, 3.06, 2.54; up
    to 25.5 % apart): the worst pair gains 141 % and 126 % (a second run of
    the final code: +154 % and +174 %)."""
    if fused_decoder_layer is not None:
        return bool(fused_decoder_layer)
    per_device = _topology_batch(n_devices, dp_shard_ok, batch_size)
    return (_measured_batch(per_device, compute_dtype)
            and _measured_width(d_model, n_heads, dim_feedforward, compute_dtype)
            and _measured_length(seq_len, per_device, d_model, n_heads, dim_feedforward)
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
                        dp_shard_ok: bool = False, device="cuda") -> GrooveTransformerConfig:
    """The model config of a :class:`HyperParams`, switches resolved for
    ``device`` (``"cuda"`` without CUDA raises) and the topology
    (``n_devices``, ``dp_shard_ok``: :func:`resolve_fused_layer`). On a CUDA device the
    inference forwards (held-out losses, predict) run the attention kernel
    (``use_fused_attention``), faster than its plain version at every
    measured shape; the JAX package leaves its kernel off in training."""
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
                                        batch_size=hp.batch_size, dp_shard_ok=dp_shard_ok),
        fused_decoder_layer=(
            resolve_fused_decoder_layer(hp.fused_decoder_layer, hp.d_model, hp.n_heads,
                                        hp.dim_feedforward, n_devices, compute_dtype,
                                        batch_size=hp.batch_size, dp_shard_ok=dp_shard_ok)
            if n_dec > 0 else False),
        remat=remat,
        remat_policy=hp.remat_policy,
        use_fused_attention=device.type == "cuda",
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
