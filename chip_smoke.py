#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and audio front-end paths once
on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, each printing one JSON line (any failure raises; the exit code is
then non-zero):

1. device   the card (``nvidia-smi`` name and power limit), torch and CUDA
            versions; TF32 is switched off for matmuls and cuDNN.
2. build    ``csrc/fused_mha.cu``, ``csrc/fused_layer.cu``,
            ``csrc/fused_decoder_layer.cu``, ``csrc/layer_sm90.cu``,
            ``csrc/band_energies.cu``,
            ``csrc/device_synth.cu``, ``csrc/fused_ffn.cu`` and
            ``csrc/fused_ln.cu`` compiled from this checkout with nvcc,
            one process each, in parallel;
            ptxas' registers, spills, stack and static shared memory per
            entry, and each layer kernel's dynamic shared memory at the
            flagship shape.
3. kernel   ``fused_mha`` against ``mha_reference`` on the card, at the
            serving shapes (B 1/8/32/512 × flagship H 2 hd 128 and demo H 4
            hd 8, T 32, causal off/on; f32 at atol 1e-5, bf16 at atol and
            rtol 2e-2), contiguous and, at B 1 and 512, as the slices of a
            packed qkv and of q with a packed kv (no copies), one launch a
            call and the (B, T, H, hd) output layout; then timed, stream and
            device, beside its bound and
            ``torch.nn.functional.scaled_dot_product_attention`` on the same
            views (the library call for the same function; the port never
            calls it).
4. serve    ``InfillServer`` at the flagship width (configs/
            InfillingRandom_training.yaml: d 256, 2 heads, ff 512, 6 layers,
            16 in, 27 out; seeded random weights) on the card: the kernel's
            launch count over the direct requests is exactly 6 per forward
            chunk, and the answers match a ``use_kernel=False`` server on the
            same card and the plain path on the CPU; then again in bf16.
5. http     POST /infill, GET /healthz, a malformed body (400), and 8
            concurrent clients of a coalescing server against the direct path.
6. demo     the in-repo demo ``.Model`` (legacy: with the architecture
            flags) served through ``serve.main``, answering an
            ``hvo_input`` request like the CPU plain path.
7. latency  B = 1 p50/p99, in-process and over loopback HTTP, and rows/s
            with requests of one full bucket (32), kernel and plain attention
            in turns; where a B = 1 request's host and device time goes.
8. layer    the whole encoder layer, bf16 through the chain of
            ``layer_sm90.cu`` and f32 through ``fused_layer.cu``'s kernels,
            against ``encoder_layer_reference`` at the flagship shapes (d
            256, 2 heads, ff 512, T 32), B 32 and 512, dropout 0 and 0.30
            (the same Philox masks): y, the residuals, dx and the 12
            parameter grads (f32 1e-4, bf16 2e-2 · max; ReLU kinks by
            ``layer_flips``); two runs with one seed bit-identical; forward
            and backward timed against the twin (stream and device). bf16 at
            B 32 and 512: every launch of the chain recorded and held to its
            plain version on the same inputs (2e-2 · max each; the hidden
            product's ReLU decisions to ``kink_flips`` in full), each
            launch's device time and own bound, at B 32 its plain version's
            and (bias products, plain products) one library call's time; the
            layer's bound from its own inputs, weights and outputs; and
            ``nn.TransformerEncoderLayer`` with the same weights, forward and
            autograd backward, at B 32 in f32 too (the library call for the
            whole layer; the port never calls it).
9. train    ``initialize_model`` + ``train_loop`` with the flagship YAML's
            hyperparameters (written here: the card's machine has no pyyaml;
            a CPU test holds them to the file) on seeded synthetic loops:
            the loss falls, every step launches each bf16 launch of the
            layer chain once per layer and the f32 kernels never (launches
            per step by kernel); the same with ``fused_layer=False``; 3 f32
            steps at dropout 0 through the f32 kernels against the plain
            paths on the card and on the CPU;
            training throughput at batch 32 and 512 and where a step's
            device time goes; the trained weights served by ``InfillServer``.
10. front-end kernels  ``device_synth`` against its plain version bit for
            bit, and ``band_energies_from_audio`` (framing inside the kernel)
            against its plain version on kit renders (bar 1e-4 · max|ref|: an
            f32 FFT against dense f32 products), at M 1, 64 and 256 × 90/120/
            150 bpm and at the shapes phases 12 and 13 give them (1 loop at 90
            bpm, 6 at 120, 40 at 150; 256 loops at phase 13's own tempos);
            the frames entry ``band_energies`` at N 1, 417, 418, 26,752 and
            140,544; reruns bit-identical; each timed on the stream and the
            device beside its plain version, its bound and the library routes
            (framing + ``torch.fft.rfft`` + abs + matmul from the same
            waveform, ``torch.stft``, the ``"conv"`` method; one
            ``index_add_`` over prepared indices for the synthesizer, on the
            stream and the device), the synthesizer at M 1, 64 and 256 with
            its tile, grid, dynamic shared memory and each instance's
            registers.
11. front end  64 seeded loops at mixed tempos, grids → MSO on the card by
            the kernel route against the plain route on the card and the host
            route (numpy mixer + ``"fft"`` on the CPU), at atol 2e-5 · max,
            rtol 1e-3; each kernel launched once per chunk; loops/s by chunk
            size and method.
12. serve hvo_input  the flagship-width server answers partial grids with
            ``qpm`` 90/120/150 in process and over HTTP through kernels #6,
            #7 and #1 (launch counts), within 1e-4 of the plain path on the
            CPU; B = 1 latency of an ``hvo_input`` request beside an
            MSO-input request, and the front end / model split.
13. train with audio augment  the flagship config through ``make_epoch_fn``
            with ``make_on_device_augment(mode="audio")`` on 256 loops: every
            kernel launched the expected number of times, one augment call
            equal to the same call through the plain versions, the loss finite
            and falling, seqs/s beside the un-augmented epoch.
14. decoder layer  the whole decoder layer (bf16: the chain of
            ``layer_sm90.cu``; f32: ``fused_decoder_layer.cu``) against
            ``decoder_layer_reference`` at the flagship shapes, B 32 and 512,
            f32 and bf16, dropout 0 and 0.30: y3, the 7 residuals, dx, dmem
            and the 20 parameter grads (phase 8's bars); reruns bit-identical;
            forward and backward timed against the twin; in bf16 every launch
            held to its plain version and timed, the layer's own bound and
            ``nn.TransformerDecoderLayer``, as phase 8.
15. train encoder-decoder  the 6 + 6 layer model at the flagship width
            (scripts/bench_encdec.py's) through ``initialize_model`` +
            ``train_loop(encoder_only=0)``: every step launches each encoder
            and each decoder bf16 launch 6 times (launches per step by
            kernel), the loss falls; the same with both fused switches off; 3
            f32 steps at dropout 0 through the f32 kernels and
            ``make_epoch_fn(encoder_only=False)`` against the twin path and
            the unfused path; seqs/s at batch 32 and 512, kernel path and
            unfused path in turns; where a step's device time goes.
16. serve encoder-decoder  ``InfillServer`` over the same config: 18
            ``fused_mha`` launches per forward chunk (6 encoder, 6 causal
            decoder self-, 6 decoder cross-attentions), answers within 1e-4
            of the CPU plain path, one ``hvo_input`` request through kernels
            #6, #7 and #1, B = 1 latency beside the encoder-only server's.
17. ffn and ln kernels  the fused FFN kernels (``fused_ffn.cu``; bf16: the
            two forward products, the two row-backward products, the weight
            gradients and the reduce of their row splits on the tensor cores;
            f32: the CUDA-core forward, row backward and weight gradients)
            against ``ffn_reference`` and the fused dropout + add + LayerNorm
            kernels (``fused_ln.cu``: forward, backward) against
            ``dropout_add_layernorm_reference``, at rows 1,024 and 16,384 × d
            256 × ff 2048, rows 4,096 × d 1024 × ff 4096 and a ragged 100 × 72
            × 200, f32 and bf16, rate 0 and the config's (0.16 / 0.1) with the
            same masks (phase 8's bars); each mask's realised keep rate; reruns
            bit-identical; each call timed beside its plain version, the
            library composition (``F.linear``, relu, ``F.dropout``,
            ``F.linear``; ``F.layer_norm(x + F.dropout(y))``; autograd's
            backward; the LN's also on the device) and its bound, each
            kernel's device time per launch; an LN backward is one launch
            (dscale and dbias summed inside it); the LN kernels' registers,
            shared memory and grids.
18. train wide FFN  configs/InfillingRandomLow_lm_training.yaml (d 256, ff
            2048, 8 layers, dropout 0.16; written here, held to the file by a
            CPU test) through ``initialize_model`` + ``train_loop`` with
            ``fused_ffn`` given (auto leaves it off) and the unfused layers
            (``fused_layer`` given off; the bf16 gate admits ff 2048): every step
            launches each bf16 FFN kernel 8 times (the reduce too: the weight
            gradients split the rows in two), the loss falls; with
            ``fused_dropout_ln`` 16 + 16 LN launches a step, and a step's device
            launches with them (one ``ln_bwd`` a backward site); with ``remat`` 16
            launches of each FFN forward kernel a step, one step's gradients
            equal to the un-rematerialised step's, peak memory with and without at batch
            512; 3 f32 steps at dropout 0 against the plain-version path and
            ``fused_ffn=False``; a 1 + 1 layer encoder-decoder model at the
            same width (1 + 1 FFN and 2 + 3 LN launches a step); seqs/s at
            batch 32 and 512 with ``fused_ffn`` on and off, with the LN kernels,
            with remat with and without ``fused_ffn``, and with
            ``fused_layer`` given (the whole-layer chains), in turns; where a
            step's device time goes.
19. train GrooveXL  d 1024, 8 heads, ff 4096, 12 layers, dropout 0.1, batch
            128, bf16, remat on (scripts/bench_groovexl_ffn.py's; nothing cut
            but the number of steps) through ``make_epoch_fn``: 24 launches of
            each FFN forward kernel a step under remat (no reduce: the weight
            gradients' 256 tiles fill the card), the loss finite and falling,
            peak memory with and without remat, seqs/s with ``fused_ffn`` on
            (given: auto leaves it off) and off under remat and without, two
            epochs a turn, and their ratio in each turn.

20. save, resume, serve  ``run_training`` with the flagship YAML (read on
            the card by the port's YAML reader) on 512 seeded loops rendered by
            the audio augment inside every epoch (kernels #2's bf16 chain, #6,
            #7; launches counted), 4 epochs in blocks of 1, a snapshot save
            after each, watch histograms every 32 steps, ``metrics.jsonl``;
            2 epochs, a stop, a fresh ``initialize_model(load_model=...)`` and
            2 more, equal bit for bit to the uninterrupted run in parameters
            and the last block's metrics, and Adam 1 + 1 against 2 likewise;
            ``serve.main(["--ckpt", dir])`` with no architecture flags answers
            an MSO and an ``hvo_input`` request (#1 six times a forward, #6,
            #7) equal to a server on the in-memory weights, and the loaded
            weights served in f32 within 1e-4 of the CPU plain path; the
            ``.ckpt`` size, the seconds a save holds the training thread,
            synchronous against snapshot, the save worker's seconds and the
            restore's, at the flagship and at GrooveXL width (151 M
            parameters, freshly initialised), beside the card's name and
            power limit. Checkpoints go to a temporary directory.

Then one line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from transformergrooveinfilling_tpu_torch import serve
from transformergrooveinfilling_tpu_torch.models import (
    GrooveTransformerConfig, build_model, calculate_loss, predict, transformer,
)
from transformergrooveinfilling_tpu_torch.models.torch_compat import (
    load_legacy_checkpoint,
)
from transformergrooveinfilling_tpu_torch.ops import _build
from transformergrooveinfilling_tpu_torch.ops import attention
from transformergrooveinfilling_tpu_torch.ops.attention import (
    fused_mha, mha_reference,
)
from transformergrooveinfilling_tpu_torch.data import make_on_device_augment
from transformergrooveinfilling_tpu_torch.ops import band_energies as be
from transformergrooveinfilling_tpu_torch.ops import device_synth as ds
from transformergrooveinfilling_tpu_torch.ops import fused_decoder_layer as fdl
from transformergrooveinfilling_tpu_torch.ops import fused_ffn as ffn
from transformergrooveinfilling_tpu_torch.ops import fused_layer as fl
from transformergrooveinfilling_tpu_torch.ops import fused_ln as ln
from transformergrooveinfilling_tpu_torch.ops import layer_sm90
from transformergrooveinfilling_tpu_torch.ops import mso
from transformergrooveinfilling_tpu_torch.ops.dropout import (
    quantized_keep_rate, quantized_threshold,
)
from transformergrooveinfilling_tpu_torch.train import (
    HyperParams, checkpoint as ckpt, create_train_state, initialize_model, load_hyperparameters,
    make_epoch_fn, make_train_step, run_training, train_loop,
)
from transformergrooveinfilling_tpu_torch.models import torch_compat
from transformergrooveinfilling_tpu_torch.train.driver import _GracefulStop
from transformergrooveinfilling_tpu_torch.train.loop import fetch
from transformergrooveinfilling_tpu_torch.utils import logging as xlog
from transformergrooveinfilling_tpu_torch.train.config import (
    embedding_size_src_for, resolve_fused_ffn, resolve_remat,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = GrooveTransformerConfig(  # configs/InfillingRandom_training.yaml
    d_model=256, n_heads=2, dim_feedforward=512, dropout=0.30,
    num_encoder_layers=6, embedding_size_src=16)
DEMO_FLAGS = ["--d_model", "32", "--n_heads", "4", "--dim_feedforward", "512",
              "--num_encoder_layers", "6", "--embedding_size_src", "27"]
DEMO_MODEL = "demo/transformer_run_demo_Epoch_799.Model"
BUCKETS = (1, 8, 32)
KERNEL_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/fused_mha.cu"
TPU_KERNEL = "transformergrooveinfilling_tpu/ops/attention.py:25"
LAYER_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/fused_layer.cu"
LAYER_SM90_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/layer_sm90.cu"
LAYER_TPU_KERNELS = {  # the Pallas kernel bodies each CUDA kernel stands in for
    "fused_layer_fwd": "transformergrooveinfilling_tpu/ops/fused_layer.py:164",
    "fused_layer_bwd_rows": "transformergrooveinfilling_tpu/ops/fused_layer.py:236",
    "fused_layer_bwd_weights": "transformergrooveinfilling_tpu/ops/fused_layer.py:236",
}
# configs/InfillingRandom_training.yaml, written out (the card's machine has
# no pyyaml); tests/test_torch_train.py holds it to the file
FLAGSHIP_HP = {
    "experiment": "InfillingRandom", "batch_size": 32, "d_model": 256,
    "dim_feedforward": 512, "dropout": 0.30, "optimizer_algorithm": "sgd",
    "learning_rate": 0.089, "n_heads": 2, "num_encoder_decoder_layers": 6,
    "epochs": 500, "encoder_only": 1, "hit_loss_penalty": 0.73, "load_model": None,
}
# configs/InfillingRandomLow_lm_training.yaml, written out likewise;
# tests/test_torch_remat.py holds it to the file
LM_HP = {
    "experiment": "InfillingRandomLow", "batch_size": 32, "d_model": 256,
    "dim_feedforward": 2048, "dropout": 0.16, "optimizer_algorithm": "sgd",
    "learning_rate": 0.070, "n_heads": 2, "num_encoder_decoder_layers": 8,
    "epochs": 3000, "encoder_only": 1, "hit_loss_penalty": 0.46, "load_model": None,
}
LAYER_SHAPE = dict(d=256, h=2, ff=512, t=32)  # the flagship's encoder and decoder layers
# the encoder-decoder family at the width the JAX package benchmarks it at
# (scripts/bench_encdec.py): the flagship's hyperparameters with 6 + 6 layers
ENCDEC = dataclasses.replace(FLAGSHIP, num_decoder_layers=6)
ENCDEC_LAYERS = 6
BAND_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/band_energies.cu"
BAND_TPU_KERNEL = "transformergrooveinfilling_tpu/ops/mso_pallas.py:56"
SYNTH_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/device_synth.cu"
SYNTH_TPU_KERNEL = "transformergrooveinfilling_tpu/ops/device_synth.py:140"
DEC_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/fused_decoder_layer.cu"
DEC_TPU_KERNELS = {  # the Pallas kernel bodies each CUDA kernel stands in for
    "fused_decoder_layer_fwd": "transformergrooveinfilling_tpu/ops/fused_decoder_layer.py:160",
    "fused_decoder_layer_bwd_rows":
        "transformergrooveinfilling_tpu/ops/fused_decoder_layer.py:236",
    "fused_decoder_layer_bwd_weights":
        "transformergrooveinfilling_tpu/ops/fused_decoder_layer.py:236",
}
FFN_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/fused_ffn.cu"
FFN_TPU_KERNELS = {  # the Pallas kernel bodies each CUDA kernel stands in for
    **{k: "transformergrooveinfilling_tpu/ops/fused_ffn.py:138"  # and :63
       for k in ("fused_ffn_fwd_h", "fused_ffn_fwd_out", "fused_ffn_fwd_f32")},
    **{k: "transformergrooveinfilling_tpu/ops/fused_ffn.py:83"
       for k in ("fused_ffn_bwd_dh", "fused_ffn_bwd_dx", "fused_ffn_bwd_weights",
                 "fused_ffn_reduce", "fused_ffn_bwd_rows_f32", "fused_ffn_bwd_weights_f32")},
}
# what each FFN launch type is called in a profile (the bf16 products are one
# template, told apart by their epilogues; the f32 weight launch ends in the
# reduce)
FFN_DEVICE_NAMES = {
    "fused_ffn_fwd_h": ("EpiHidden",), "fused_ffn_fwd_out": ("EpiOut",),
    "fused_ffn_bwd_dh": ("EpiDh",), "fused_ffn_bwd_dx": ("EpiRound",),
    "fused_ffn_bwd_weights": ("EpiWgrad",), "fused_ffn_reduce": ("reduce_splits",),
    "fused_ffn_fwd_f32": ("ffn_fwd",), "fused_ffn_bwd_rows_f32": ("ffn_bwd_rows",),
    "fused_ffn_bwd_weights_f32": ("ffn_bwd_weights", "reduce_splits"),
}
LN_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/fused_ln.cu"
LN_TPU_KERNELS = {"fused_ln_fwd": "transformergrooveinfilling_tpu/ops/fused_ln.py:54",
                  "fused_ln_bwd": "transformergrooveinfilling_tpu/ops/fused_ln.py:68"}
KERNEL_NAMES = ["fused_mha", "fused_layer", "fused_decoder_layer", "layer_sm90",
                "band_energies", "device_synth", "fused_ffn", "fused_ln"]
# the wrappers, and the counts of launches of their kernels
BAND, BAND_AUDIO, SYNTH = be.band_energies, be.band_energies_from_audio, ds.synth_events
MHA, BAND_K, SYNTH_K = attention.KERNEL, be.KERNEL, ds.KERNEL
# NVIDIA's published peaks for one H100 SXM, dense, at its 700 W limit
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
THROUGHPUT_BATCHES = (32, 512)  # the YAML's batch and bench.py's
# 3 f32 steps, kernel path against the unfused plain path (cuBLAS), which
# cannot be given the kernel's side of a ReLU kink: one such unit in the first
# step moved a W1 row by 1.2e-4 on an H100, and the bar is about four times that
UNFUSED_BAR = 5e-4


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err(a, b) -> float:
    return float((torch.as_tensor(a).float() - torch.as_tensor(b).float()).abs().max())


def time_us(fn, n: int = 200) -> float:
    """Mean µs per call on the stream, by CUDA events over ``n`` calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1000.0 / n


def device_us(fn, n: int = 50) -> dict:
    """Device time per call from the profiler, by kernel (or copy) name:
    ``{name: [µs per call, launches per call]}``, device-side events only,
    without the profiler's own buffer requests. The profiler can lose the
    device events of some calls (on an H100 it kept 4 to 8 of 10 calls of a
    2 ms kernel, and 2 of 3 without the calls run inside it first), so read
    the launches per call beside the time. Only events that start inside the
    marked window are counted. The events are read as the profiler recorded
    them: ``prof.events()`` gives the same times, but building its list takes
    9 s for two training steps of the wide config (95,000 records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with record_function("chip_smoke_window"):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    window = next(e for e in events if e.name() == "chip_smoke_window")
    first, last = window.start_ns(), window.start_ns() + window.duration_ns()
    per_kernel: dict = {}
    for e in events:
        name = e.name()
        if (e.device_type() == DeviceType.CUDA and name != "Activity Buffer Request"
                and name != "chip_smoke_window" and first <= e.start_ns() <= last):
            # short names that keep a template's arguments (the FFN's products
            # differ in their epilogue, the last one)
            key = name.removeprefix("void ").replace("(anonymous namespace)::", "")[:80]
            us, count = per_kernel.get(key, (0.0, 0.0))
            per_kernel[key] = (us + e.duration_ns() / 1e3 / n, count + 1 / n)
    return per_kernel


def host_us(fn, n: int = 200) -> float:
    """Host-clock µs per call of ``fn`` followed by a device synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / n


def bound(n_bytes: float, flops: float, dtype: str) -> dict:
    """The least time the card could take: the larger of the bytes (each input
    read once, each output written once) over the memory rate and the
    operations over the peak rate for the inputs' type."""
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_flops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": int(n_bytes), "flops": int(flops)}


def mha_bound(b, h, t, hd, dtype) -> dict:
    size = 4 if dtype == "float32" else 2
    return bound(4 * b * h * t * hd * size, 4 * b * h * t * t * hd, dtype)


def attn_pairs(rows: int, t: int, causal: bool) -> int:
    """The (query, key) pairs an attention over ``rows`` rows in sequences of
    ``t`` computes: t a row, (t + 1) / 2 a row where it is causal (row i
    attends to keys 0..i)."""
    return rows * (t + 1) // 2 if causal else rows * t


def layer_bounds(b, dtype) -> dict:
    """Bounds of the three layer kernels at the flagship layer, batch ``b``."""
    d, ff, t = LAYER_SHAPE["d"], LAYER_SHAPE["ff"], LAYER_SHAPE["t"]
    m, s = b * t, 4 if dtype == "float32" else 2
    weights = (4 * d * d + 2 * d * ff)
    products = 2 * m * weights  # the four dense products, forward
    attn = b * t * t * d  # one (T, T, d) product over all heads per sequence
    scratch = m * (8 * d + ff + 2) * 4
    return {
        "fused_layer_fwd": bound(
            m * d * s + weights * s + (9 * d + ff) * 4 + 4  # x, weights, vectors, seed
            + (3 * m * d + 3 * m * d + m * ff) * s,  # y, a1, a2, qkv, h
            products + 4 * attn, dtype),
        "fused_layer_bwd_rows": bound(
            (4 * m * d + 3 * m * d + m * ff) * s + weights * s + 3 * d * 4 + 4
            + m * d * s + scratch,  # dx and the row-wise gradients
            products + 10 * attn, dtype),  # P again, dP, dV, dQ, dK
        "fused_layer_bwd_weights": bound(
            (3 * m * d + 3 * m * d + m * ff) * s + 2 * d * 4 + 4 + scratch
            + (weights + 9 * d + ff) * 4,  # f32 weight, bias and LN gradients
            products + 4 * attn, dtype),  # the attention output again, for dWo
    }


def decoder_layer_bounds(b, dtype) -> dict:
    """Bounds of the three decoder-layer kernels at the flagship layer, batch
    ``b``: seven dense products (8d² + 2·d·ff multiply-adds a row; the TPU
    kernel's cost estimate leaves the kv projection's 2d² out) and two
    attentions (the causal one over its T(T+1)/2 pairs)."""
    d, ff, t = LAYER_SHAPE["d"], LAYER_SHAPE["ff"], LAYER_SHAPE["t"]
    m, s = b * t, 4 if dtype == "float32" else 2
    weights = 8 * d * d + 2 * d * ff
    products = 2 * m * weights  # the seven dense products, forward
    # both attentions' (T, T, d) products over all heads, summed
    attn = (attn_pairs(m, t, False) + attn_pairs(m, t, True)) * d
    vectors = (15 * d + ff) * 4
    scratch = m * (14 * d + ff + 4) * 4
    return {
        "fused_decoder_layer_fwd": bound(
            2 * m * d * s + weights * s + vectors + 4  # y, mem, weights, vectors, seed
            + m * (10 * d + ff) * s,  # y3, a1, qc, a2, a3, qkv, kv, h
            products + 4 * attn, dtype),
        "fused_decoder_layer_bwd_rows": bound(
            m * (10 * d + ff) * s + weights * s + 3 * d * 4 + 4  # dy, 7 residuals, weights
            + 2 * m * d * s + scratch,  # dx, dmem and the row-wise gradients
            products + 10 * attn, dtype),  # per attention: P again, dP, dV, dQ, dK
        "fused_decoder_layer_bwd_weights": bound(
            m * (11 * d + ff) * s + 4 * d * 4 + 4 + scratch  # dy, y, mem, 6 residuals
            + (weights + 15 * d + ff) * 4,  # f32 weight, bias and LN gradients
            products + 4 * attn, dtype),  # both attention outputs again, for dWo and dWo2
    }


def layer_io_bounds(b: int, decoder: bool = False) -> dict:
    """The least time for a whole layer's forward and for its backward in
    bf16 at the flagship layer, batch ``b``, from the function's own inputs,
    weights and outputs alone (no residual, no design's scratch): the forward
    reads x (and the decoder's memory), the weights and vectors and writes y;
    the backward reads dy, x (and memory), the weights and the LayerNorm
    gains and writes dx (and dmem) and the f32 parameter gradients. Its
    operations: the dense products (forward once, backward twice) and per
    attention QKᵀ and PV forward, dP, dV, dQ and dK backward, the causal one
    over its T(T+1)/2 pairs only."""
    d, ff, t = LAYER_SHAPE["d"], LAYER_SHAPE["ff"], LAYER_SHAPE["t"]
    m = b * t
    if decoder:
        weights, vectors, acts = 8 * d * d + 2 * d * ff, 15 * d + ff, 2
        pairs = attn_pairs(m, t, True) + attn_pairs(m, t, False)
    else:
        weights, vectors, acts = 4 * d * d + 2 * d * ff, 9 * d + ff, 1
        pairs = attn_pairs(m, t, False)
    products = 2 * m * weights
    return {"fwd": bound(acts * m * d * 2 + weights * 2 + vectors * 4 + m * d * 2,
                         products + 4 * pairs * d, "bfloat16"),
            "bwd": bound(m * d * 2 + acts * m * d * 2 + weights * 2 + 3 * d * 4
                         + acts * m * d * 2 + (weights + vectors) * 4,
                         2 * products + 8 * pairs * d, "bfloat16")}


SM90_BAR = 2e-2  # each bf16 launch against its plain version: 2e-2 · max|ref|
# The share of a bf16 whole layer's hidden units (plus 4) that may fall on the
# other side of the ReLU's kink from its twin's (``layer_flips``)
LAYER_KINK_SHARE = 1e-4
KINK_SEEDS = 4  # further inputs and seeds a rate at which phases 8 and 14 read the flips


def layer_flips(twin_h, kernel_h):
    """The hidden units at which a whole layer's kernels and its twin fall on
    opposite sides of the ReLU's kink, for the twin's ``relu_flips``. f32:
    ``kink_flips`` (within ``KINK_BAND`` of 0, at most ``KINK_SHARE`` of the
    units). bf16: each within ``KINK_BAND`` of 0 as well, and at most
    ``LAYER_KINK_SHARE`` of the units (plus 4). ``KINK_SHARE`` itself is held
    where the kernel decides the side, the hidden product against its plain
    version on the same inputs (``sm90_launches``: 0–1 flips in 8.4M units),
    and not across the whole layer: there the tensor cores' f32 accumulation
    order, not cuBLAS's sequential one, rounds ~1.4e-4 of qkv's bf16 values to
    the neighbouring value, and the bf16 rounding of P carries each to ~15
    attention outputs, so inputs of W1 differ by one bf16 step (on an H100:
    101–173 flips in 8.4M units at the encoder at B 512, 248–380 at the
    decoder, 30 in 524,288 at the decoder at B 32, at most 5.7e-5 of the
    units, each within 1.8e-3 of max|h|)."""
    if twin_h.dtype == torch.float32:
        return fl.kink_flips(twin_h, kernel_h)
    th, kh = twin_h.float(), kernel_h.float()
    flips = (th > 0) != (kh > 0)
    n = int(flips.sum())
    largest = float(torch.maximum(th, kh)[flips].max()) / float(th.abs().max()) if n else 0.0
    stats = {"flips": n, "units": flips.numel(), "largest_rel": largest}
    check(largest <= fl.KINK_BAND[twin_h.dtype] and n <= LAYER_KINK_SHARE * flips.numel() + 4,
          f"kernel and twin ReLU decisions differ beyond rounding: {stats}, "
          f"band {fl.KINK_BAND[twin_h.dtype]}, share {LAYER_KINK_SHARE}")
    return flips, stats


def kink_survey(dev, decoder: bool) -> dict:
    """A bf16 whole layer's ReLU flips against its twin at ``KINK_SEEDS``
    further inputs and dropout seeds a rate, at B 32 and 512, rates 0 and
    0.3, forward only, each held by ``layer_flips``: per batch, the flips of
    each case, the largest share of the units and the largest flipped unit
    over max|h|. Its inputs come from a generator of its own, so the
    phases after it draw what they drew without it."""
    h_, t = LAYER_SHAPE["h"], LAYER_SHAPE["t"]
    rng = np.random.default_rng(90 + decoder)
    if decoder:
        mod, case, ref, at = fdl, decoder_case, fdl.decoder_layer_reference, 6
    else:
        mod, case, ref, at = fl, layer_case, fl.encoder_layer_reference, 3
    out = {}
    for b in (32, 512):
        readings = []
        for i in range(2 * KINK_SEEDS):
            rate = 0.3 * (i % 2)
            args, _ = case(dev, rng, b, torch.bfloat16)
            seed = torch.tensor([9001 + 97 * i + b], dtype=torch.int32, device=dev)
            res = mod.layer_forward(*args, seed, rate, h_, t)
            with torch.no_grad():
                own = ref(*args, seed, rate, h_, t, return_residuals=True)
            readings.append(layer_flips(own[at], res[at])[1])
        out[f"B{b}"] = {"flips": [r["flips"] for r in readings], "units": readings[0]["units"],
                        "largest_share": max(r["flips"] for r in readings) / readings[0]["units"],
                        "largest_rel": max(r["largest_rel"] for r in readings)}
    return out


def tensors_in(obj):
    """The tensors among a launch's arguments (lists and tuples walked)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from tensors_in(o)


def launch_bound(launch) -> dict:
    """A launch's own bound: each distinct input read once and each output
    written once (views of one packed buffer count what they cover), and its
    operations: the product's 2·rows·n·k, the attention's 4·d forward and
    12·d backward (P again, dP, dS·K, dSᵀ·Q, PᵀdA and the output again) for
    each (query, key) pair it computes (``attn_pairs``),
    the weight gradients' 2·rows·m·n each; row passes and the reduce are
    bytes."""
    seen = {}
    for t in [*tensors_in(launch.args), *tensors_in(launch.outputs)]:
        seen[(t.data_ptr(), tuple(t.shape), t.stride())] = t.numel() * t.element_size()
    ref, a = launch.reference, launch.args
    flops = 0
    if ref in (layer_sm90.bias_reference, layer_sm90.hidden_reference,
               layer_sm90.residual_ln_reference, layer_sm90.dh_reference,
               layer_sm90.round_reference, layer_sm90.ln_backward_reference):
        flops = 2 * a[0].shape[0] * a[1].shape[0] * a[1].shape[1]
    elif ref is layer_sm90.attention_forward_reference:
        flops = 4 * attn_pairs(a[0].shape[0], a[7], a[8]) * a[0].shape[1]
    elif ref is layer_sm90.attention_backward_reference:
        flops = 12 * attn_pairs(a[0].shape[0], a[8], a[9]) * a[0].shape[1]
    elif ref is layer_sm90.weight_partials_reference:
        flops = sum(2 * dy.shape[0] * dy.shape[1] * x.shape[1] for dy, x in a[0])
    return bound(sum(seen.values()), flops, "bfloat16")


def launch_library(launch):
    """One PyTorch call computing a launch's function, where there is one:
    F.linear for the bias products (the bias in bf16), a matmul for the
    products without a residual or epilogue."""
    a = launch.args
    if launch.reference is layer_sm90.bias_reference:
        bias = a[2].to(a[0].dtype)
        return lambda: F.linear(a[0], a[1], bias)
    if launch.reference is layer_sm90.round_reference and a[2] is None:
        return lambda: torch.matmul(a[0], a[1])
    return None


def launch_device_us(record, n: int) -> list:
    """Device µs per call of each recorded launch replayed ``n`` times, and
    the profiler's launches per call (it can lose events), from one profile
    with a marked window per launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for launch in record:
        launch.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, launch in enumerate(record):
            with record_function(f"chip_smoke_launch_{i}"):
                for _ in range(n):
                    launch.replay()
                torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    windows = {}  # the host's marked ranges (the device's copies of the marks are skipped)
    for e in events:
        if e.name().startswith("chip_smoke_launch_") and e.device_type() == DeviceType.CPU:
            windows[int(e.name().rsplit("_", 1)[1])] = (e.start_ns(), e.start_ns() + e.duration_ns())
    us, count = [0.0] * len(record), [0.0] * len(record)
    for e in events:
        if (e.device_type() != DeviceType.CUDA or e.name() == "Activity Buffer Request"
                or e.name().startswith("chip_smoke_launch_")):
            continue
        for i, (lo, hi) in windows.items():
            if lo <= e.start_ns() <= hi:
                us[i] += e.duration_ns() / 1e3 / n
                count[i] += 1 / n
                break
    return us, count


def sm90_launches(record, kernels: dict, plain: bool, n: int) -> dict:
    """Every bf16 launch of one layer call, as recorded on the card: its
    outputs held to its plain version on the same inputs (``SM90_BAR`` ·
    max|ref| each), its device time per launch (profiler, ``n`` replays),
    its own bound, and with ``plain`` the plain version's and the library
    call's stream time. Keyed by the counted kernel's name."""
    names = {id(k): name for name, k in kernels.items()}
    rows = {}
    for launch in record:
        name = names[id(launch.kernel)]
        want = launch.reference(*launch.args, **launch.kwargs)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for got, ref in zip(launch.outputs, want, strict=True):
            e, top = max_err(got, ref), float(ref.float().abs().max())
            check(e <= SM90_BAR * top, f"{name}: {e} > {SM90_BAR} * {top}")
            err = max(err, e)
        rows[name] = {"max_abs_err": err, **launch_bound(launch)}
        if launch.reference is layer_sm90.hidden_reference:  # band and share, in full
            rows[name]["relu_kink_flips"] = fl.kink_flips(want[0], launch.outputs[0])[1]
    us, count = launch_device_us(record, n)
    for launch, u, c in zip(record, us, count):
        name = names[id(launch.kernel)]
        rows[name].update(device_ms=u / 1000.0, device_launches_per_call=c)
        if plain:
            rows[name]["plain_ms"] = time_us(
                lambda: launch.reference(*launch.args, **launch.kwargs), 5) / 1000.0
            lib = launch_library(launch)
            rows[name]["library_ms"] = time_us(lib, 50) / 1000.0 if lib else None
    return rows


def library_layer(args, dy, b: int, decoder: bool) -> dict:
    """``nn.TransformerEncoderLayer`` / ``nn.TransformerDecoderLayer`` (post-LN,
    ReLU, batch_first, dropout 0.30, training mode, in the dtype of
    ``args``: bf16 and f32 both) with the layer's
    weights: forward, and its autograd backward, stream and device time. The
    port never calls it; it is the yardstick one PyTorch call gives."""
    h_, t = LAYER_SHAPE["h"], LAYER_SHAPE["t"]
    d, ff = LAYER_SHAPE["d"], LAYER_SHAPE["ff"]
    dev, dtype = args[0].device, args[0].dtype
    kw = dict(dropout=0.3, batch_first=True, device=dev, dtype=dtype)
    with torch.no_grad():
        if decoder:
            a = dict(zip(fdl.ARG_NAMES, args))
            lib = torch.nn.TransformerDecoderLayer(d, h_, ff, **kw)
            pairs = [(lib.self_attn.in_proj_weight, a["wqkv"]), (lib.self_attn.in_proj_bias, a["bqkv"]),
                     (lib.self_attn.out_proj.weight, a["wo"]), (lib.self_attn.out_proj.bias, a["bo"]),
                     (lib.multihead_attn.in_proj_weight, torch.cat([a["wq"], a["wkv"]])),
                     (lib.multihead_attn.in_proj_bias, torch.cat([a["bq"], a["bkv"]])),
                     (lib.multihead_attn.out_proj.weight, a["wo2"]),
                     (lib.multihead_attn.out_proj.bias, a["bo2"]),
                     (lib.norm1.weight, a["g1"]), (lib.norm1.bias, a["b1"]),
                     (lib.norm2.weight, a["g2"]), (lib.norm2.bias, a["b2"]),
                     (lib.norm3.weight, a["g3"]), (lib.norm3.bias, a["b3"]),
                     (lib.linear1.weight, a["w1"]), (lib.linear1.bias, a["b1f"]),
                     (lib.linear2.weight, a["w2"]), (lib.linear2.bias, a["b2f"])]
            inputs = [a["y"].view(b, t, d).detach().requires_grad_(True),
                      a["mem"].view(b, t, d).detach().requires_grad_(True)]
            mask = torch.nn.Transformer.generate_square_subsequent_mask(t, device=dev,
                                                                        dtype=dtype)

            def fwd():
                return lib(*inputs, tgt_mask=mask, tgt_is_causal=True)
        else:
            x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2 = args
            lib = torch.nn.TransformerEncoderLayer(d, h_, ff, **kw)
            pairs = [(lib.self_attn.in_proj_weight, wqkv), (lib.self_attn.in_proj_bias, bqkv),
                     (lib.self_attn.out_proj.weight, wo), (lib.self_attn.out_proj.bias, bo),
                     (lib.norm1.weight, g1), (lib.norm1.bias, b1), (lib.norm2.weight, g2),
                     (lib.norm2.bias, b2), (lib.linear1.weight, w1), (lib.linear1.bias, b1f),
                     (lib.linear2.weight, w2), (lib.linear2.bias, b2f)]
            inputs = [x.view(b, t, d).detach().requires_grad_(True)]

            def fwd():
                return lib(*inputs)
        for param, value in pairs:
            param.copy_(value)
    lib.train()
    out = fwd()
    leaves = [*lib.parameters(), *inputs]
    grad = dy.view(b, t, d)

    def bwd():
        return torch.autograd.grad(out, leaves, grad, retain_graph=True)

    n = 50 if b == 32 else 10
    f1, b1_, b2_, f2 = (time_us(fn, n) / 1000.0 for fn in (fwd, bwd, bwd, fwd))
    return {"fwd_ms": [f1, f2], "bwd_ms": [b1_, b2_],
            "fwd_device_ms": sum(us for us, _ in device_us(fwd, n=3).values()) / 1000.0,
            "bwd_device_ms": sum(us for us, _ in device_us(bwd, n=3).values()) / 1000.0}


def band_bound(n: int, n_fft: int = 1024, n_bands: int = 16) -> dict:
    """What the function needs of its inputs: frames and filterbank read once,
    band energies written once, and per frame a real FFT (2.5 · n_fft ·
    log2 n_fft operations), the magnitude (4 a bin) and the projection. The
    kernel's own algorithm, two dense DFT products, costs far more: its
    operations and their time at the f32 peak go beside the bound as
    ``dense_dft_flops`` and ``dense_dft_ms``, and are no bound."""
    bins = n_fft // 2
    fft = 2.5 * n_fft * np.log2(n_fft)
    dense = 4 * n * n_fft * bins + 2 * n * bins * n_bands
    return {**bound(4 * (n * n_fft + (bins + 1) * n_bands + n * n_bands),
                    n * (fft + 4 * bins + 2 * bins * n_bands), "float32"),
            "dense_dft_flops": int(dense),
            "dense_dft_ms": dense / PEAK_FLOPS["float32"] * 1e3}


def band_audio_bound(m: int, length: int, f: int, n_fft: int = 1024, n_bands: int = 16) -> dict:
    """What the waveform entry needs: the samples, window, filterbank and
    twiddles read once, band energies written once, and per frame a real FFT
    (2.5 · n_fft · log2 n_fft operations), the magnitude and the projection."""
    bins = n_fft // 2
    fft = 2.5 * n_fft * np.log2(n_fft)
    return bound(4 * (m * length + n_fft + bins * n_bands + 2 * n_fft + m * f * n_bands),
                 m * f * (fft + 4 * bins + 2 * bins * n_bands), "float32")


def synth_bound(onset, row, gain, table, lengths, length: int) -> dict:
    """What this run's events need: two operations per (live event, sample)
    pair that lands inside the waveform."""
    live = gain != 0
    span = (onset + lengths[row.long()]).clamp(max=length) - onset
    pairs = int(span[live].sum())
    m, e = onset.shape
    return bound(4 * (3 * m * e + table.numel() + lengths.numel() + m * length),
                 2 * pairs, "float32")


def hit_agreement(h, h_ref, sig_ref, margin=1e-4) -> bool:
    """Thresholded hits equal wherever the reference sigmoid is not within
    ``margin`` of 0.5."""
    sure = np.abs(sig_ref - 0.5) >= margin
    return bool(np.array_equal(h[sure], h_ref[sure]))


def post(port: int, payload=None, raw: bytes | None = None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/infill",
        data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_device() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build_all(KERNEL_NAMES)  # one nvcc each, together
    for name in KERNEL_NAMES:
        info = _build.build_info[name]
        ptxas = [line.strip() for line in info["log"].splitlines()
                 if "registers" in line or "spill" in line or "Compiling entry" in line]
        emit({"phase": "build", "kernel": name, "seconds": time.perf_counter() - t0,
              "nvcc_seconds": info["seconds"], "ptxas": ptxas})
    d, h, ff, t = LAYER_SHAPE["d"], LAYER_SHAPE["h"], LAYER_SHAPE["ff"], LAYER_SHAPE["t"]
    emit({"phase": "build", "kernel": "fused_layer", "dynamic_smem_bytes_at_flagship": {
        "layer_fwd": fl.fwd_smem_bytes(t, d, ff),
        "layer_bwd_rows": fl.bwd_rows_smem_bytes(t, d, ff),
        "layer_bwd_weights": fl.bwd_weights_smem_bytes(t, d, h)},
        "limit": fl.MAX_SMEM_BYTES})
    emit({"phase": "build", "kernel": "fused_decoder_layer",
          "dynamic_smem_bytes_at_flagship": {
              "dec_fwd": fl.fwd_smem_bytes(t, d, ff),
              "dec_bwd_rows": fdl.bwd_rows_smem_bytes(t, d, ff),
              "dec_bwd_weights": fl.bwd_weights_smem_bytes(t, d, h)},
          "limit": fl.MAX_SMEM_BYTES})
    emit({"phase": "build", "kernel": "fused_ffn, fused_ln", "dynamic_smem_bytes": {
        f"d {d}": {"ffn_fwd, ffn_bwd_rows (f32)": ffn.rows_smem_bytes(d), "ln_fwd": 0,
                   "ln_bwd": ln.bwd_smem_bytes(d, torch.bfloat16)} for d in (256, 1024)},
        "limit": fl.MAX_SMEM_BYTES})


def kernel_resources(name: str) -> dict:
    """ptxas' registers, spilled bytes and static shared memory of each entry
    of ``csrc/<name>.cu`` (one per template instance), from the build log."""
    out, entry = {}, None
    for line in _build.build_info[name]["log"].splitlines():
        found = re.search(r"Compiling entry function '_Z\w*?\d+([a-z_]+)I(\w+?)EEEv", line)
        if found:
            args = found.group(2)
            dtype = ["bf16"] if args.startswith("13__nv_bfloat16") else ["f32"] * (args[0] == "f")
            entry = f"{found.group(1)}<{', '.join(dtype + re.findall(r'Li(\d+)E', args + 'E'))}>"
            out[entry] = {}
        elif entry and "spill stores" in line:
            out[entry]["spill_bytes"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif entry and "registers" in line:
            out[entry]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def mha_inputs(dev, rng, b: int, h: int, hd: int, dtype, form: str, t: int = 32):
    """q, k, v of shape (b, h, t, hd) as the model passes them: contiguous, the
    slices of a packed qkv (b, t, 3, h, hd), or q (b, t, h, hd) with the
    slices of a packed kv (b, t, 2, h, hd)."""
    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    if form == "contiguous":
        return n(b, h, t, hd), n(b, h, t, hd), n(b, h, t, hd)
    if form == "packed_qkv":
        return tuple(n(b, t, 3, h, hd).permute(2, 0, 3, 1, 4))
    k, v = n(b, t, 2, h, hd).permute(2, 0, 3, 1, 4)
    return n(b, t, h, hd).transpose(1, 2), k, v


MHA_FORMS = ("contiguous", "packed_qkv", "packed_kv")
MHA_BARS = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 2e-2)}


def phase_kernel(dev, rng) -> dict:
    """``fused_mha`` against ``mha_reference`` (on contiguous copies) at the
    serving shapes, contiguous and as the slices of packed projections; then
    device times beside the bound and SDPA on the same views."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(b, h, hd, "contiguous") for h, hd in ((2, 128), (4, 8)) for b in (1, 8, 32, 512)]
    cases += [(b, 2, 128, form) for b in (1, 512) for form in MHA_FORMS[1:]]
    checks = 0
    for b, h, hd, form in cases:
        for dtype, (atol, rtol) in MHA_BARS.items():
            q, k, v = mha_inputs(dev, rng, b, h, hd, dtype, form)
            for causal in (False, True):
                before = MHA.launches
                got = fused_mha(q, k, v, causal=causal)
                torch.cuda.synchronize()
                want = mha_reference(q.contiguous(), k.contiguous(), v.contiguous(),
                                     causal=causal)
                err = max_err(got, want)
                worst[dtype] = max(worst[dtype], err)
                ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
                check(ok and got.dtype == dtype and got.shape == q.shape
                      and got.transpose(1, 2).is_contiguous() and MHA.launches == before + 1,
                      f"fused_mha != mha_reference at {(b, h, 32, hd)} {dtype} {form} "
                      f"causal={causal}: max abs err {err}")
                checks += 1
    timings = []
    for b, dtype in ((1, torch.float32), (8, torch.float32), (32, torch.float32),
                     (512, torch.float32), (1, torch.bfloat16), (512, torch.bfloat16)):
        forms = MHA_FORMS if b in (1, 512) else MHA_FORMS[:1]
        for form in forms:
            q, k, v = mha_inputs(dev, rng, b, 2, 128, dtype, form)
            kern = lambda: fused_mha(q, k, v)  # noqa: E731
            plain = lambda: mha_reference(q, k, v)  # noqa: E731
            # the library call that computes the same function; timed, never used
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
            check(torch.allclose(sdpa().float(), kern().float(),
                                 atol=2e-2 if dtype == torch.bfloat16 else 1e-5),
                  "scaled_dot_product_attention disagrees with fused_mha")
            k1, p1, l1, l2, p2, k2 = (time_us(f) for f in (kern, plain, sdpa, sdpa, plain, kern))
            before = MHA.launches
            dk, dp, dl = device_us(kern), device_us(plain), device_us(sdpa)
            launches_profiled = MHA.launches - before
            dtype_name = str(dtype).replace("torch.", "")
            bnd = mha_bound(b, 2, 32, 128, dtype_name)
            # per captured launch (the profiler may lose events)
            kernel_device = max(sum(us / c for us, c in dk.values()), 1e-9)
            timings.append({
                "shape": [b, 2, 32, 128], "dtype": dtype_name, "form": form,
                "tensor_cores": attention.uses_tensor_cores(q, k, v),
                "kernel_us": [k1, k2], "plain_us": [p1, p2], "sdpa_us": [l1, l2],
                "sdpa_device_us": sum(us for us, _ in dl.values()),
                **bnd, "kernel_device_us": kernel_device,
                "kernel_device_launches_per_call": sum(c for _, c in dk.values()),
                "wrapper_launches_in_profiled_calls": launches_profiled,
                "bound_share_of_device_time": bnd["bound_ms"] * 1e3 / kernel_device,
                "plain_device_us": sum(us for us, _ in dp.values()),
                "plain_kernels_us": {k: us for k, (us, _) in dp.items()}})
    emit({"phase": "kernel", "checks": checks,
          "max_abs_err": {"float32": worst[torch.float32], "bfloat16": worst[torch.bfloat16]},
          "bars": {"float32": {"atol": 1e-5}, "bfloat16": {"atol": 2e-2, "rtol": 2e-2}},
          "timings": timings})
    return {"max_abs_err": worst[torch.float32], "timings": timings}


def phase_serve(dev, rng, sd):
    srv = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev)
    plain = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev,
                               use_kernel=False)
    raw = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev,
                             use_kernel=False, use_thres=False)
    check(srv.config.use_fused_attention and not plain.config.use_fused_attention,
          "kernel / plain servers are not configured as asked")
    xs = {n: rng.standard_normal((n, 32, 16)).astype(np.float32) for n in (1, 6, 40)}
    chunks = {1: 1, 6: 1, 40: 2}  # buckets (1, 8, 32): 1 | 8 | 32 + 8

    MHA.launches = 0  # the main path's run starts here
    out = {n: srv.infill(x) for n, x in xs.items()}
    launches = MHA.launches  # ... and ends here
    check(launches == 6 * sum(chunks.values()),
          f"fused_mha launched {launches} times, expected 6 per forward chunk "
          f"({6 * sum(chunks.values())})")

    worst = 0.0
    for n, x in xs.items():
        y, yp, yr = out[n], plain.infill(x), raw.infill(x)
        check(y.shape == (n, 32, 27) and np.isfinite(y).all(), f"bad output at N={n}")
        check(set(np.unique(y[..., :9])) <= {0.0, 1.0}, "hits not thresholded")
        err = max_err(y[..., 9:], yp[..., 9:])
        worst = max(worst, err)
        check(err <= 1e-4, f"kernel vs plain server at N={n}: v/o differ by {err}")
        check(hit_agreement(y[..., :9], yp[..., :9], yr[..., :9]),
              f"kernel vs plain server at N={n}: hits differ away from the threshold")

    # the plain path on the CPU, the one the CPU tests hold against JAX
    cpu_model = build_model(FLAGSHIP, "cpu")
    cpu_model.load_state_dict(sd, strict=True)
    h_cpu, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(xs[6]))
    cpu_err = max(max_err(out[6][..., 9:18], v_cpu), max_err(out[6][..., 18:], o_cpu))
    check(cpu_err <= 1e-4, f"card vs CPU plain path: v/o differ by {cpu_err}")

    bf16_cfg = dataclasses.replace(FLAGSHIP, compute_dtype=torch.bfloat16)
    srv16 = serve.InfillServer(sd, bf16_cfg, batch_sizes=BUCKETS, device=dev)
    plain16 = serve.InfillServer(sd, bf16_cfg, batch_sizes=BUCKETS, device=dev,
                                 use_kernel=False)
    before = MHA.launches
    y16 = srv16.infill(xs[40])
    check(MHA.launches - before == 6 * chunks[40], "bf16 run missed the kernel")
    check(np.isfinite(y16).all(), "bf16 output not finite")
    err16_plain = max_err(y16[..., 9:], plain16.infill(xs[40])[..., 9:])
    check(err16_plain <= 2e-2, f"bf16 kernel vs plain server: v/o differ by {err16_plain}")
    emit({"phase": "serve", "config": "InfillingRandom flagship d256 h2 ff512 6L",
          "requests": sorted(xs), "chunks": sum(chunks.values()), "launches": launches,
          "max_abs_err_vs_plain_server": worst, "max_abs_err_vs_cpu_plain": cpu_err,
          "bf16": {"max_abs_dev_vs_f32": max_err(y16[..., 9:], out[40][..., 9:]),
                   "hit_flip_share_vs_f32": float((y16[..., :9] != out[40][..., :9]).mean()),
                   "max_abs_err_vs_bf16_plain_server": err16_plain}})
    return srv, plain, raw, launches


def phase_http(dev, rng, sd, srv, raw) -> None:
    httpd = srv.serve_http(port=0, block=False)
    coal = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev,
                              coalesce=True, coalesce_wait_ms=5.0)
    httpd_c = coal.serve_http(port=0, block=False)
    try:
        port = httpd.server_address[1]
        for n in (1, 3):
            x = rng.standard_normal((n, 32, 16)).astype(np.float32)
            code, payload = post(port, {"input": x.tolist()})
            check(code == 200, f"POST /infill answered {code}: {payload}")
            check(np.array_equal(np.asarray(payload["hvo"], np.float32), srv.infill(x)),
                  "HTTP answer differs from the direct path")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            body = r.read()
        health = json.loads(body)
        check(b"NaN" not in body and health["ok"] and health["count"] >= 2,
              f"bad /healthz: {body!r}")
        code, bad = post(port, raw=b"{not json")
        check(code == 400 and "error" in bad, f"malformed body answered {code}")

        xs = [rng.standard_normal((32, 16)).astype(np.float32) for _ in range(32)]
        got, errs = [None] * len(xs), []

        def client(ids):
            try:
                for i in ids:
                    c, p = post(httpd_c.server_address[1], {"input": xs[i].tolist()})
                    got[i] = (c, np.asarray(p.get("hvo"), np.float32))
            except Exception as e:  # reported below
                errs.append(e)

        threads = [threading.Thread(target=client, args=(range(j, 32, 8),))
                   for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check(not errs and not any(t.is_alive() for t in threads),
              f"coalesced clients failed: {errs}")
        worst = 0.0
        for x, (c, y) in zip(xs, got):
            check(c == 200, f"coalesced request answered {c}")
            want, sig = srv.infill(x), raw.infill(x)
            worst = max(worst, max_err(y[:, 9:], want[:, 9:]))
            check(hit_agreement(y[:, :9], want[:, :9], sig[:, :9]),
                  "coalesced hits differ from the direct path")
        # batch composition changes the products' shapes, hence f32 rounding
        check(worst <= 1e-5, f"coalesced v/o differ from the direct path by {worst}")
        emit({"phase": "http", "posts": 2, "healthz": health, "malformed": code,
              "coalesced_clients": 8, "coalesced_requests": len(xs),
              "coalesced_max_abs_err_vs_direct": worst})
    finally:
        for h in (httpd, httpd_c):
            h.shutdown()
            h.server_close()


def phase_demo(rng) -> None:
    before = MHA.launches
    httpd = serve.main(["--ckpt", DEMO_MODEL, "--port", "0"] + DEMO_FLAGS, block=False)
    try:
        grid = (rng.random((32, 27)) < 0.25).astype(np.float32)
        code, payload = post(httpd.server_address[1], {"hvo_input": grid.tolist()})
    finally:
        httpd.shutdown()
        httpd.server_close()
    check(code == 200, f"demo hvo_input answered {code}: {payload}")
    y = np.asarray(payload["hvo"], np.float32)
    check(y.shape == (32, 27) and np.isfinite(y).all(), "bad demo answer")
    cfg = GrooveTransformerConfig(d_model=32, n_heads=4, dim_feedforward=512,
                                  num_encoder_layers=6, embedding_size_src=27)
    sd, epoch, _loss = load_legacy_checkpoint(DEMO_MODEL, cfg)
    model = build_model(cfg, "cpu")
    model.load_state_dict(sd, strict=True)
    h, v, o = predict(model, torch.from_numpy(grid[None]))
    sig = predict(model, torch.from_numpy(grid[None]), use_thres=False)[0].numpy()[0]
    err = max(max_err(y[:, 9:18], v[0]), max_err(y[:, 18:], o[0]))
    check(err <= 1e-4, f"demo answer vs CPU plain path: v/o differ by {err}")
    check(hit_agreement(y[:, :9], h[0].numpy(), sig), "demo hits differ")
    launches = MHA.launches - before
    check(launches >= 6, "the demo server did not run the kernel")
    emit({"phase": "demo", "checkpoint": DEMO_MODEL, "epoch": epoch,
          "max_abs_err_vs_cpu_plain": err, "hits": int(y[:, :9].sum()),
          "launches_incl_warmup": launches})


def phase_latency(dev, srv, plain) -> dict:
    runs = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):  # in turns
        runs[which].append(serve.latency_benchmark(
            srv if which == "kernel" else plain, n_requests=300, batch=1))
    batch32 = {"kernel": [], "plain": []}  # one full bucket-32 chunk per request
    for which in ("kernel", "plain", "plain", "kernel"):
        batch32[which].append(serve.latency_benchmark(
            srv if which == "kernel" else plain, n_requests=200, batch=32))
    httpd = srv.serve_http(port=0, block=False)
    try:
        http = serve.latency_benchmark(
            srv, n_requests=300, batch=1,
            url=f"http://127.0.0.1:{httpd.server_address[1]}/infill")
    finally:
        httpd.shutdown()
        httpd.server_close()
    # where a B = 1 request's time goes
    x = np.zeros((1, 32, 16), np.float32)
    xd = torch.zeros((1, 32, 16), device=dev)
    request = host_us(lambda: srv.infill(x))
    forward = host_us(lambda: srv._forward(xd))
    plain_forward = host_us(lambda: plain._forward(xd))
    copies = host_us(lambda: torch.from_numpy(x).to(dev).cpu())
    per_kernel = device_us(lambda: srv.infill(x), n=50)
    device_total = sum(us for us, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "latency", "batch": 1, "in_process_kernel": runs["kernel"],
          "in_process_plain": runs["plain"], "http_kernel": http,
          "batch32_kernel": batch32["kernel"], "batch32_plain": batch32["plain"],
          "batch32_rows_per_s_kernel": [32e3 / r["mean_ms"] for r in batch32["kernel"]],
          "batch32_rows_per_s_plain": [32e3 / r["mean_ms"] for r in batch32["plain"]],
          "breakdown_us": {"request": request, "forward": forward,
                           "plain_forward": plain_forward, "copy_in_out": copies},
          "request_device_us": device_total,
          "device_launches_per_request": sum(c for _, c in per_kernel.values()),
          "device_busy_share": device_total / request,
          "top_device_kernels_us_launches": top})
    return {"in_process": runs["kernel"][0], "http": http}


def layer_case(dev, rng, b: int, dtype):
    """Flagship-shaped layer inputs from ``rng``: (args without the seed, dy)."""
    d, ff = LAYER_SHAPE["d"], LAYER_SHAPE["ff"]
    m = b * LAYER_SHAPE["t"]

    def n(*shape, scale=1.0, offset=0.0):
        a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    x = n(m, d).to(dtype)
    # nn.Linear's (out, in) layout
    wqkv, wo, w1, w2 = (n(3 * d, d, scale=d ** -0.5).to(dtype), n(d, d, scale=d ** -0.5).to(dtype),
                        n(ff, d, scale=d ** -0.5).to(dtype), n(d, ff, scale=ff ** -0.5).to(dtype))
    return [x, wqkv, n(3 * d, scale=0.1), wo, n(d, scale=0.1), n(d, scale=0.1, offset=1.0),
            n(d, scale=0.1), w1, n(ff, scale=0.1), w2, n(d, scale=0.1),
            n(d, scale=0.1, offset=1.0), n(d, scale=0.1)], n(m, d).to(dtype)


GRAD_NAMES = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dg1", "db1", "dw1", "db1f", "dw2",
              "db2f", "dg2", "db2")


def layer_backward_args(args, res, seed):
    x, wqkv, _, wo, _, g1, b1, w1, _, w2, _, g2, _ = args
    _, qkv, a1, h, a2 = res
    return (x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed)


def layer_device_times(kf, kb, pf, pb) -> dict:
    """Device time of a layer call's forward and backward on the kernels and
    on the twin (profiler), and the kernels' device µs by kernel name."""
    dev_f, dev_b = device_us(kf, n=3), device_us(kb, n=3)
    per_kernel, launched = {}, {}
    for part in (dev_f, dev_b):
        for k, (us, c) in part.items():
            per_kernel[k] = per_kernel.get(k, 0.0) + us
            launched[k] = launched.get(k, 0.0) + c
    return {"kernel_fwd_device_ms": sum(us for us, _ in dev_f.values()) / 1000.0,
            "kernel_bwd_device_ms": sum(us for us, _ in dev_b.values()) / 1000.0,
            "kernel_device_us": per_kernel, "kernel_device_launches": launched,
            "plain_fwd_device_us": sum(us for us, _ in device_us(pf, n=3).values()),
            "plain_bwd_device_us": sum(us for us, _ in device_us(pb, n=3).values())}


def phase_layer(dev, rng) -> dict:
    """The three layer kernels against ``encoder_layer_reference`` on the
    card. Bars: f32 atol 1e-4 on y and the residuals, and 1e-4 · max|grad|
    on each grad (sums taken in another order); bf16 2e-2 · max|ref| on
    everything (bf16 rounds P, attention, y1, h and the weight grads, and the
    kernel rounds its backward's intermediates where the TPU kernel does,
    autograd does not). The masks are equal (the same Philox bytes). A hidden
    unit within rounding of 0 may fall on either side of the ReLU's kink: the
    twin takes the kernel's side at such units only (``kink_flips``: within
    ``KINK_BAND`` of 0, and few), and its own everywhere else."""
    h_, t = LAYER_SHAPE["h"], LAYER_SHAPE["t"]
    checks, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b in (32, 512):
        for dtype in (torch.float32, torch.bfloat16):
            args, dy = layer_case(dev, rng, b, dtype)
            for rate in (0.0, 0.3):
                seed = torch.tensor([1234 + b], dtype=torch.int32, device=dev)
                res = fl.layer_forward(*args, seed, rate, h_, t)
                grads = fl.layer_backward(dy, *layer_backward_args(args, res, seed), rate, h_, t)
                res2 = fl.layer_forward(*args, seed, rate, h_, t)
                grads2 = fl.layer_backward(dy, *layer_backward_args(args, res2, seed), rate, h_, t)
                torch.cuda.synchronize()
                bitwise = all(torch.equal(u, v) for u, v in zip(res + grads, res2 + grads2))
                check(bitwise, f"two runs with one seed differ at B {b} {dtype} rate {rate}")
                with torch.no_grad():
                    own = fl.encoder_layer_reference(*args, seed, rate, h_, t,
                                                     return_residuals=True)
                flips, kink = layer_flips(own[3], res[3])
                leaves = [a.detach().clone().requires_grad_(True) for a in args]
                want = fl.encoder_layer_reference(*leaves, seed, rate, h_, t,
                                                  return_residuals=True, relu_flips=flips)
                want[0].backward(dy)
                errs = {}
                for name, g, w in zip(("y", "qkv", "a1", "h", "a2"), res, want):
                    w = w.detach().float()
                    bar = 1e-4 if dtype == torch.float32 else 2e-2 * float(w.abs().max())
                    errs[name] = max_err(g, w)
                    check(errs[name] <= bar, f"{name} at B {b} {dtype} rate {rate}: "
                                             f"{errs[name]} > {bar}")
                for name, g, leaf in zip(GRAD_NAMES, grads, leaves):
                    w = leaf.grad.float()
                    rel = 1e-4 if dtype == torch.float32 else 2e-2
                    errs[name] = max_err(g, w)
                    check(errs[name] <= rel * float(w.abs().max()),
                          f"{name} at B {b} {dtype} rate {rate}: {errs[name]} > "
                          f"{rel} * {float(w.abs().max())}")
                worst[dtype] = max(worst[dtype], *errs.values())
                checks.append({"B": b, "dtype": str(dtype)[6:], "rate": rate,
                               "max_abs_err": errs, "bitwise_repeat": bitwise,
                               "relu_kink_flips": kink})
    timings = []
    for b, dtype in ((32, torch.bfloat16), (512, torch.bfloat16), (32, torch.float32)):
        args, dy = layer_case(dev, rng, b, dtype)
        seed = torch.tensor([7], dtype=torch.int32, device=dev)
        res = fl.layer_forward(*args, seed, 0.3, h_, t)
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        y_ref = fl.encoder_layer_reference(*leaves, seed, 0.3, h_, t)
        n = 50 if b == 32 else 10  # calls per timing, after 10 warm-up calls
        kf = lambda: fl.layer_forward(*args, seed, 0.3, h_, t)  # noqa: E731

        def kb(fwd=res):
            return fl.layer_backward(dy, *layer_backward_args(args, fwd, seed), 0.3, h_, t)

        def pf():
            with torch.no_grad():
                fl.encoder_layer_reference(*args, seed, 0.3, h_, t)

        pb = lambda: torch.autograd.grad(y_ref, leaves, dy, retain_graph=True)  # noqa: E731
        row = {"B": b, "dtype": str(dtype)[6:], "rate": 0.3,
               "bounds": layer_bounds(b, str(dtype)[6:])}
        for key, k, p in (("fwd", kf, pf), ("bwd", kb, pb)):
            k1, p1, p2, k2 = (time_us(f, n) / 1000.0 for f in (k, p, p, k))
            row[f"{key}_kernel_ms"], row[f"{key}_plain_ms"] = [k1, k2], [p1, p2]
        row.update(layer_device_times(kf, kb, pf, pb))
        if dtype == torch.bfloat16:
            with layer_sm90.recording() as record:
                kb(kf())
            row["launches"] = sm90_launches(record, fl.SM90_KERNELS, plain=b == 32,
                                            n=20 if b == 32 else 5)
            row["io_bounds"] = layer_io_bounds(b)
        row["library"] = library_layer(args, dy, b, decoder=False)
        timings.append(row)
    emit({"phase": "layer", "shape": LAYER_SHAPE, "checks": checks,
          "bars": {"float32": "1e-4 abs (y, residuals); 1e-4 * max|grad| (grads)",
                   "bfloat16": "2e-2 * max|ref|"},
          "kink_survey": kink_survey(dev, decoder=False), "timings": timings})
    return {"max_abs_err": worst, "timings": timings}


def decoder_case(dev, rng, b: int, dtype):
    """Flagship-shaped decoder-layer inputs from ``rng``: (y, mem and the 20
    parameters in ``fdl.ARG_NAMES`` order, dy)."""
    d, ff = LAYER_SHAPE["d"], LAYER_SHAPE["ff"]
    m = b * LAYER_SHAPE["t"]

    def n(*shape, scale=1.0, offset=0.0):
        a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    def w(out, inp):  # nn.Linear's (out, in) layout
        return n(out, inp, scale=inp ** -0.5).to(dtype)

    def vec(width):
        return n(width, scale=0.1)

    def gain():
        return n(d, scale=0.1, offset=1.0)

    args = [n(m, d).to(dtype), n(m, d).to(dtype), w(3 * d, d), vec(3 * d), w(d, d), vec(d),
            w(d, d), vec(d), w(2 * d, d), vec(2 * d), w(d, d), vec(d), gain(), vec(d),
            w(ff, d), vec(ff), w(d, ff), vec(d), gain(), vec(d), gain(), vec(d)]
    return args, n(m, d).to(dtype)


DEC_GRAD_NAMES = tuple("d" + name for name in ("x",) + fdl.ARG_NAMES[1:])


def decoder_backward_args(args, res, seed):
    a = dict(zip(fdl.ARG_NAMES, args))
    return (a["y"], a["mem"], *res[1:], *(a[k] for k in fdl.WEIGHT_NAMES),
            a["g1"], a["b1"], a["g2"], a["b2"], a["g3"], seed)


def phase_decoder_layer(dev, rng) -> dict:
    """The three decoder-layer kernels against ``decoder_layer_reference`` on
    the card: y3, the seven residuals, dx, dmem and the 20 parameter grads.
    Bars, masks and ReLU kinks as ``phase_layer``'s."""
    h_, t = LAYER_SHAPE["h"], LAYER_SHAPE["t"]
    checks, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b in (32, 512):
        for dtype in (torch.float32, torch.bfloat16):
            args, dy = decoder_case(dev, rng, b, dtype)
            for rate in (0.0, 0.3):
                seed = torch.tensor([4321 + b], dtype=torch.int32, device=dev)
                res = fdl.layer_forward(*args, seed, rate, h_, t)
                grads = fdl.layer_backward(dy, *decoder_backward_args(args, res, seed),
                                           rate, h_, t)
                res2 = fdl.layer_forward(*args, seed, rate, h_, t)
                grads2 = fdl.layer_backward(dy, *decoder_backward_args(args, res2, seed),
                                            rate, h_, t)
                torch.cuda.synchronize()
                bitwise = all(torch.equal(u, v) for u, v in zip(res + grads, res2 + grads2))
                check(bitwise, f"decoder layer: two runs with one seed differ at B {b} "
                               f"{dtype} rate {rate}")
                with torch.no_grad():
                    own = fdl.decoder_layer_reference(*args, seed, rate, h_, t,
                                                      return_residuals=True)
                flips, kink = layer_flips(own[6], res[6])
                leaves = [a.detach().clone().requires_grad_(True) for a in args]
                want = fdl.decoder_layer_reference(*leaves, seed, rate, h_, t,
                                                   return_residuals=True, relu_flips=flips)
                want[0].backward(dy)
                errs = {}
                for name, g, w in zip(("y",) + fdl.RESIDUAL_NAMES, res, want):
                    w = w.detach().float()
                    bar = 1e-4 if dtype == torch.float32 else 2e-2 * float(w.abs().max())
                    errs[name] = max_err(g, w)
                    check(errs[name] <= bar, f"decoder {name} at B {b} {dtype} rate {rate}: "
                                             f"{errs[name]} > {bar}")
                for name, g, leaf in zip(DEC_GRAD_NAMES, grads, leaves):
                    w = leaf.grad.float()
                    rel = 1e-4 if dtype == torch.float32 else 2e-2
                    errs[name] = max_err(g, w)
                    check(errs[name] <= rel * float(w.abs().max()),
                          f"decoder {name} at B {b} {dtype} rate {rate}: {errs[name]} > "
                          f"{rel} * {float(w.abs().max())}")
                worst[dtype] = max(worst[dtype], *errs.values())
                checks.append({"B": b, "dtype": str(dtype)[6:], "rate": rate,
                               "max_abs_err": errs, "bitwise_repeat": bitwise,
                               "relu_kink_flips": kink})
    timings = []
    for b, dtype in ((32, torch.bfloat16), (512, torch.bfloat16), (32, torch.float32)):
        args, dy = decoder_case(dev, rng, b, dtype)
        seed = torch.tensor([7], dtype=torch.int32, device=dev)
        res = fdl.layer_forward(*args, seed, 0.3, h_, t)
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        y_ref = fdl.decoder_layer_reference(*leaves, seed, 0.3, h_, t)
        n = 30 if b == 32 else 5  # calls per timing, after 10 warm-up calls
        kf = lambda: fdl.layer_forward(*args, seed, 0.3, h_, t)  # noqa: E731

        def kb(fwd=res):
            return fdl.layer_backward(dy, *decoder_backward_args(args, fwd, seed), 0.3, h_, t)

        def pf():
            with torch.no_grad():
                fdl.decoder_layer_reference(*args, seed, 0.3, h_, t)

        pb = lambda: torch.autograd.grad(y_ref, leaves, dy, retain_graph=True)  # noqa: E731
        row = {"B": b, "dtype": str(dtype)[6:], "rate": 0.3,
               "bounds": decoder_layer_bounds(b, str(dtype)[6:])}
        for key, k, p in (("fwd", kf, pf), ("bwd", kb, pb)):
            k1, p1, p2, k2 = (time_us(f, n) / 1000.0 for f in (k, p, p, k))
            row[f"{key}_kernel_ms"], row[f"{key}_plain_ms"] = [k1, k2], [p1, p2]
        row.update(layer_device_times(kf, kb, pf, pb))
        if dtype == torch.bfloat16:
            with layer_sm90.recording() as record:
                kb(kf())
            row["launches"] = sm90_launches(record, fdl.SM90_KERNELS, plain=b == 32,
                                            n=20 if b == 32 else 5)
            row["io_bounds"] = layer_io_bounds(b, decoder=True)
        row["library"] = library_layer(args, dy, b, decoder=True)
        timings.append(row)
    emit({"phase": "decoder_layer", "shape": LAYER_SHAPE, "checks": checks,
          "bars": {"float32": "1e-4 abs (y, residuals); 1e-4 * max|grad| (grads)",
                   "bfloat16": "2e-2 * max|ref|"},
          "kink_survey": kink_survey(dev, decoder=True), "timings": timings})
    return {"max_abs_err": worst, "timings": timings}


def model_params(hp: dict, **model):
    """``initialize_model``'s params from a YAML's hyperparameters."""
    return {"model": {"d_model": hp["d_model"], "n_heads": hp["n_heads"],
                      "dim_feedforward": hp["dim_feedforward"], "dropout": hp["dropout"],
                      "num_encoder_layers": hp["num_encoder_decoder_layers"],
                      "embedding_size_src": embedding_size_src_for(hp["experiment"]),
                      "optimizer": hp["optimizer_algorithm"], **model},
            "training": {"learning_rate": hp["learning_rate"], "batch_size": hp["batch_size"],
                         "seed": 0},
            "load_model": hp["load_model"]}


flagship_params = functools.partial(model_params, FLAGSHIP_HP)
# the wide config's runs ask for the FFN kernels: auto leaves them off at its
# batches, where they were measured no faster (phase 18 checks it); and the
# unfused layers, in which the FFN kernels run (the whole-layer path, which the
# bf16 gate now admits at ff 2048, is timed beside them)
lm_params = functools.partial(model_params, LM_HP, fused_ffn=True, fused_layer=False,
                              fused_decoder_layer=False)


class Loops:
    """Seeded synthetic loops (bench.py's recipe): ``processed_inputs``
    (N, 32, 16) normal, ``processed_outputs`` HVO grids with 30 % hits."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.processed_inputs = rng.standard_normal((n, 32, 16)).astype(np.float32)
        h = (rng.random((n, 32, 9)) < 0.3).astype(np.float32)
        self.processed_outputs = np.concatenate(
            [h, h * rng.random(h.shape), h * (rng.random(h.shape) - 0.5)], axis=2
        ).astype(np.float32)


# encoder and decoder layer kernels: the bf16 chains' launches, the f32 kernels
SM90_LAYER_KERNELS = {**fl.SM90_KERNELS, **fdl.SM90_KERNELS}
F32_LAYER_KERNELS = {**fl.KERNELS, **fdl.KERNELS}
LAYER_KERNELS = {**SM90_LAYER_KERNELS, **F32_LAYER_KERNELS}


def launches(kernels) -> dict:
    return {name: f.launches for name, f in kernels.items()}


def reset_launches() -> None:
    for f in (*LAYER_KERNELS.values(), *ffn.KERNELS.values(), *ln.KERNELS.values()):
        f.launches = 0


def run_epochs(bundle, data, held, epochs: int, batch: int, encoder_only: int = 1,
               penalty: float = FLAGSHIP_HP["hit_loss_penalty"]) -> list:
    return [train_loop(dataset=data, groove_transformer=bundle, epoch=e, batch_size=batch,
                       encoder_only=encoder_only, hit_loss_penalty=penalty,
                       validation_inputs=held.processed_inputs,
                       validation_gt=held.processed_outputs) for e in range(epochs)]


def seqs_per_s(bundle, data, batch: int, encoder_only: int = 1) -> float:
    """One epoch through ``train_loop`` (it ends in the metrics' fetch)."""
    t0 = time.perf_counter()
    train_loop(dataset=data, groove_transformer=bundle, batch_size=batch,
               encoder_only=encoder_only, hit_loss_penalty=FLAGSHIP_HP["hit_loss_penalty"])
    return len(data.processed_inputs) / (time.perf_counter() - t0)


def step_breakdown(bundle, b: int, seed: int, encoder_only: int = 1, count=()) -> dict:
    """Where a step's host and device time goes: two steps on 2·b loops; with
    ``count``, the device launches a step of the kernels whose names hold each
    of those strings."""
    small = Loops(2 * b, seed)
    seqs_per_s(bundle, small, b, encoder_only)
    t0 = time.perf_counter()
    seqs_per_s(bundle, small, b, encoder_only)
    host = (time.perf_counter() - t0) / 2
    per_kernel = device_us(lambda: seqs_per_s(bundle, small, b, encoder_only), n=2)
    total = sum(us for us, _ in per_kernel.values()) / 2
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    return {"step_host_ms": host * 1e3, "step_device_ms": total / 1e3,
            "device_busy_share": total / 1e6 / host,
            "launches_per_step": sum(c for _, c in per_kernel.values()) / 2,
            "top_kernels_us_per_step": {k: us / 2 for k, (us, _) in top},
            **({"launches_per_step_of": {name: sum(c for k, (_, c) in per_kernel.items()
                                                   if name in k) / 2 for name in count}}
               if count else {})}


@contextlib.contextmanager
def fused_layers_as(role: str, kernel_h: list, kinks: list):
    """Stand-ins for the model's two fused layer functions, for comparing a
    few f32 steps of the kernel path with its twins. A hidden unit within
    rounding of 0 can fall on either side of the ReLU's kink, and one such
    unit moves a W1 row by lr·|grad| (on an H100: one unit of one layer in
    the first step, 1.2e-4). So as ``"kernel"`` every fused layer call also
    records the kernel's h_drop into ``kernel_h``; as ``"twin"`` the twin runs
    in place of the kernels and takes the kernel's side at the units where
    ``kink_flips`` finds the two within rounding of 0 (their number per call
    goes into ``kinks``), its own side everywhere else. Any other role leaves
    the model as it is."""
    # per module: the train function, kernel forward, twin, tensor arguments, h's place
    specs = ((fl, "encoder_layer_train", fl.layer_forward, fl.encoder_layer_reference, 14, 3),
             (fdl, "decoder_layer_train", fdl.layer_forward, fdl.decoder_layer_reference, 23, 6))
    replay = iter(kernel_h)

    def stand_in(mod, name, forward, reference, n_tensors, h_at):
        train = getattr(mod, name)

        def recording(*a):
            kernel_h.append(forward(*[t.detach() for t in a[:n_tensors]], *a[n_tensors:])[h_at])
            return train(*a)

        def replaying(*a):
            with torch.no_grad():
                own_h = reference(*[t.detach() for t in a[:n_tensors]], *a[n_tensors:],
                                  return_residuals=True)[h_at]
            flips, kink = fl.kink_flips(own_h, next(replay).to(own_h.device))
            kinks.append(kink["flips"])
            return reference(*a, relu_flips=flips)

        return {"kernel": recording, "twin": replaying}.get(role, train)

    saved = {name: getattr(transformer, name) for _, name, *_ in specs}
    for spec in specs:
        setattr(transformer, spec[1], stand_in(*spec))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(transformer, name, fn)


def phase_train(dev, rng) -> dict:
    # 1,024 loops for the epochs and the batch-32 rates, 2,048 (4 steps) at
    # batch 512; the twin, ~10x slower at batch 32, takes a quarter
    data, held, twin_data, big = Loops(1024, 1), Loops(256, 2), Loops(256, 1), Loops(2048, 1)
    batch, epochs = FLAGSHIP_HP["batch_size"], 3
    steps = epochs * (len(data.processed_inputs) // batch)
    bundle, _, _ = initialize_model(flagship_params(), dev)
    check(bundle.config.fused_layer and bundle.config.compute_dtype == torch.bfloat16,
          f"auto policy did not pick the kernel in bf16: {bundle.config}")
    reset_launches()  # the main path's run starts here
    MHA.launches = 0
    t0 = time.perf_counter()
    metrics = run_epochs(bundle, data, held, epochs, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches(fl.SM90_KERNELS)  # ... and ends here
    n_layers = FLAGSHIP_HP["num_encoder_decoder_layers"]
    check(all(c == steps * n_layers for c in counts.values())
          and not any(launches(F32_LAYER_KERNELS).values()),
          f"layer launches {counts}, expected {steps * n_layers} each ({steps} steps x "
          f"{n_layers} layers), and the f32 kernels {launches(F32_LAYER_KERNELS)}, expected 0")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(v) for m in metrics for v in m.values()), f"non-finite: {metrics}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    plain, _, _ = initialize_model(flagship_params(fused_layer=False), dev)
    before = launches(LAYER_KERNELS)
    plain_metrics = run_epochs(plain, data, held, epochs, batch)
    plain_losses = [m["loss"] for m in plain_metrics]
    check(launches(LAYER_KERNELS) == before, "fused_layer=False launched a layer kernel")
    check(all(np.isfinite(plain_losses)) and plain_losses[-1] < plain_losses[0],
          f"plain path loss did not fall: {plain_losses}")

    # 3 f32 steps at dropout 0: the kernel path against its twin on the card
    # and on the CPU. A hidden unit within rounding of 0 can fall on either
    # side of the ReLU's kink, and one such unit moves a W1 row by lr·|grad|
    # (on an H100: one unit of layer 1 in the first step, 1.2e-4). So the
    # kernel path records its h_drop for each layer and step, and the twins
    # take the kernel's side at the units where ``kink_flips`` finds the two
    # within rounding of 0, their own side everywhere else
    # (``fused_layers_as``). The unfused plain path on the card cannot; it is
    # held to UNFUSED_BAR.
    kernel_h, kinks = [], []
    x = torch.from_numpy(data.processed_inputs[:96]).to(dev)
    y = torch.from_numpy(data.processed_outputs[:96]).to(dev)
    three = {}
    reset_launches()  # the f32 route's path: its kernels launch here only
    for name, device, fused in (("kernel", dev, True), ("card_twin", dev, True),
                                ("cpu_twin", torch.device("cpu"), True),
                                ("card_unfused", dev, False)):
        b, _, _ = initialize_model(flagship_params(bf16=False, dropout=0.0, fused_layer=fused),
                                   device)
        step = make_train_step(FLAGSHIP_HP["hit_loss_penalty"])
        gen = torch.Generator(device).manual_seed(0)
        with fused_layers_as("twin" if name.endswith("twin") else name, kernel_h, kinks):
            for i in range(3):
                step(b.state, x[32 * i:32 * i + 32].to(device),
                     y[32 * i:32 * i + 32].to(device), None, gen)
        three[name] = {k: v.detach().cpu() for k, v in b.model.state_dict().items()}
    f32_counts = launches(fl.KERNELS)  # the forward twice a call: fused_layers_as records h
    check(f32_counts == {"fused_layer_fwd": 2 * 3 * n_layers, "fused_layer_bwd_rows": 3 * n_layers,
                         "fused_layer_bwd_weights": 3 * n_layers}
          and not any(launches(SM90_LAYER_KERNELS).values()),
          f"3 f32 steps launched {launches(LAYER_KERNELS)}")
    param_err = {other: max(max_err(three["kernel"][k], three[other][k]) for k in three["kernel"])
                 for other in ("card_twin", "cpu_twin", "card_unfused")}
    check(max(param_err["card_twin"], param_err["cpu_twin"]) <= 1e-4
          and param_err["card_unfused"] <= UNFUSED_BAR,
          f"3 f32 steps: params differ by {param_err} (kink flips per layer call: {kinks})")

    # throughput, kernel / twin / unfused in turns, at batch 32 and bench.py's 512
    throughput = {}
    for b in THROUGHPUT_BATCHES:
        runs = {"kernel": [], "twin": [], "unfused": []}
        models = {"kernel": initialize_model(flagship_params(), dev)[0],
                  "twin": initialize_model(flagship_params(), dev)[0],
                  "unfused": initialize_model(flagship_params(fused_layer=False), dev)[0]}
        for which in ("kernel", "twin", "unfused", "unfused", "twin", "kernel"):
            saved = transformer.encoder_layer_train
            if which == "twin":
                transformer.encoder_layer_train = fl.encoder_layer_reference
            corpus = twin_data if which == "twin" else data if b == batch else big
            try:
                seqs_per_s(models[which], corpus, b)  # warm-up epoch
                runs[which].append(seqs_per_s(models[which], corpus, b))
            finally:
                transformer.encoder_layer_train = saved
        throughput[b] = runs

    # where a step's device time goes (kernel path)
    breakdown = {b: step_breakdown(initialize_model(flagship_params(), dev)[0], b, 3)
                 for b in THROUGHPUT_BATCHES}

    # the trained weights served by the serving slice, against the CPU plain path
    sd = {k: v.detach().cpu() for k, v in bundle.model.state_dict().items()}
    srv = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev)
    xs = rng.standard_normal((6, 32, 16)).astype(np.float32)
    served = srv.infill(xs)
    cpu_model = build_model(FLAGSHIP, "cpu")
    cpu_model.load_state_dict(sd, strict=True)
    _, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(xs))
    serve_err = max(max_err(served[..., 9:18], v_cpu), max_err(served[..., 18:], o_cpu))
    check(serve_err <= 1e-4, f"trained weights served: v/o differ from the CPU by {serve_err}")
    emit({"phase": "train", "config": FLAGSHIP_HP,
          "data": "1024 seeded synthetic loops (2048 for the rates at batch 512)",
          "epochs": epochs, "steps": steps, "seconds": seconds, "launches": counts,
          "launches_per_step": {k: c / steps for k, c in counts.items()},
          "three_f32_steps_launches": f32_counts,
          "losses": losses, "last_metrics": metrics[-1], "plain_losses": plain_losses,
          "three_f32_steps_param_err": param_err,
          "three_f32_steps_kink_flips": kinks, "unfused_bar": UNFUSED_BAR,
          "seqs_per_s": throughput, "step_breakdown": breakdown,
          "served_max_abs_err_vs_cpu": serve_err})
    return {"launches": counts, "f32_launches": f32_counts, "seqs_per_s": throughput}


def augment_corpus():
    """The audio-augmented training phase's corpus: 256 seeded loops and their
    tempos."""
    return (Loops(256, 26).processed_outputs,
            np.random.default_rng(27).uniform(90.0, 150.0, 256))


@contextlib.contextmanager
def plain_front_end():
    """Route the front end through the kernels' plain versions, on whatever
    device the tensors are (the card included), for comparisons."""
    saved = (ds.synth_events, be.band_energies, be.band_energies_from_audio)
    ds.synth_events = lambda onset, row, gain, table, lengths, length: \
        ds.synth_events_plain(onset, row, gain, table, length)
    be.band_energies = be.band_energies_plain
    be.band_energies_from_audio = be.band_energies_from_audio_plain
    try:
        yield
    finally:
        ds.synth_events, be.band_energies, be.band_energies_from_audio = saved


def reset_front_end_launches() -> None:
    BAND_K.launches = SYNTH_K.launches = 0


def events_for(dev, grids: np.ndarray, qpm, params):
    """The synthesizer's inputs for ``grids`` at one tempo, or at one tempo per
    item (the waveform is then as long as the slowest needs, as the front end
    makes it): (onset, row, gain, table, lengths, length)."""
    table, _, luts, _, lengths = ds.pack_tables([None], params.sr, device=dev)
    m = grids.shape[0]
    zeros = torch.zeros(m, dtype=torch.int32, device=dev)
    qpms = np.broadcast_to(np.asarray(qpm, np.float64), (m,))
    sps = torch.from_numpy((qpms / 60.0 * 4.0).astype(np.float32)).to(dev)
    length = mso.mso_waveform_length(grids.shape[1], float(qpms.min() / 60.0 * 4.0), params)
    onset, row, gain = ds._extract_events(torch.from_numpy(grids).to(dev), sps, zeros, length,
                                          float(params.sr), luts, zeros)
    return onset, row, gain, table, lengths, length


def timed(kernel, plain, n_plain: int = 20) -> dict:
    """Stream ms in turns (kernel, plain, plain, kernel), the kernel's ms on
    the host clock over 20 queued calls and one synchronize, and the
    profiler's device ms. The profiler may report fewer launches than were
    made (``kernel_device_launches`` below 1 per call: it lost events), so the
    kernel's device time is the mean per captured launch, summed over the
    wrapper's kernels, each of which launches once per call."""
    k1, p1, p2, k2 = (time_us(kernel, 50), time_us(plain, n_plain), time_us(plain, n_plain),
                      time_us(kernel, 50))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        kernel()
    torch.cuda.synchronize()
    queued = (time.perf_counter() - t0) * 1e3 / 20
    dev_k, dev_p = device_us(kernel, 10), device_us(plain, 3)
    return {"kernel_ms": [k1 / 1e3, k2 / 1e3], "plain_ms": [p1 / 1e3, p2 / 1e3],
            "kernel_host_queued_ms": queued,
            "kernel_device_ms": sum(us / c for us, c in dev_k.values()) / 1e3,
            "kernel_device_launches": sum(c for _, c in dev_k.values()),
            "plain_device_ms": sum(us for us, _ in dev_p.values()) / 1e3,
            "plain_device_launches": sum(c for _, c in dev_p.values())}


def phase_front_end_kernels(dev, rng) -> dict:
    params = mso.MSOParams()
    _, fb_t = mso._filterbank(params, dev)
    loops = Loops(64, 21).processed_outputs
    hann = mso.hann_window(params.win_length, dev)

    # device_synth against its plain version, bit for bit: M 1 and 64 at three
    # tempos, then the shapes the serving and training phases give it
    aug_grids, aug_qpms = augment_corpus()
    serve_loops = Loops(40, 25).processed_outputs
    main_path = [(serve_loops[:1], 90.0), (serve_loops[:6], 120.0), (serve_loops, 150.0),
                 (aug_grids, aug_qpms)]
    cases = ([(grids[:m], qpm) for grids, m in ((loops, 1), (loops, 64), (aug_grids, 256))
              for qpm in (90.0, 120.0, 150.0)] + main_path)
    synth_checks, worst_synth = [], 0.0
    for grids, qpm in cases:
        m, tempo = len(grids), qpm if np.isscalar(qpm) else [qpm.min(), qpm.max()]
        onset, row, gain, table, lengths, length = events_for(dev, grids, qpm, params)
        got = SYNTH(onset, row, gain, table, lengths, length)
        again = SYNTH(onset, row, gain, table, lengths, length)
        torch.cuda.synchronize()
        want = ds.synth_events_plain(onset, row, gain, table, length)
        err = max_err(got, want)
        worst_synth = max(worst_synth, err)
        check(torch.equal(got, want), f"device_synth != plain version at M {m}, {tempo} bpm: "
                                      f"max abs err {err}")
        check(torch.equal(got, again), f"device_synth reruns differ at M {m}, {tempo} bpm")
        check(bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0.1,
              "device_synth rendered silence")
        synth_checks.append({"M": m, "qpm": tempo, "length": length, "max_abs_err": err,
                             "bitwise_equal": True, "bitwise_repeat": True,
                             "live_events": int((gain != 0).sum())})
        del got, again, want
    synth_timings = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, grids in ((1, loops), (64, loops), (256, aug_grids)):
        onset, row, gain, table, lengths, length = events_for(dev, grids[:m], 120.0, params)
        row_t = timed(lambda: SYNTH(onset, row, gain, table, lengths, length),
                      lambda: ds.synth_events_plain(onset, row, gain, table, length), 3)
        # the library yardstick: ONE index_add_ over indices and sources
        # prepared outside the timed call (the port never calls it)
        live = (gain != 0).nonzero()
        o, r = onset[live[:, 0], live[:, 1]].long(), row[live[:, 0], live[:, 1]].long()
        span = (o + lengths[r]).clamp(max=length) - o
        event = torch.repeat_interleave(torch.arange(len(span), device=dev), span)
        within = torch.arange(int(span.sum()), device=dev) - (span.cumsum(0) - span)[event]
        index = (live[:, 0] * length + o)[event] + within
        source = gain[live[:, 0], live[:, 1]][event] * table[r[event], within]
        flat = torch.zeros(m * length, device=dev)
        flat.index_add_(0, index, source)
        want = SYNTH(onset, row, gain, table, lengths, length)
        lib_err = max_err(flat.view(m, length), want)
        check(lib_err <= 1e-5, f"index_add_ yardstick differs from the kernel by {lib_err}")
        lib = [time_us(lambda: flat.index_add_(0, index, source), 10) / 1e3 for _ in range(2)]
        lib_device = device_us(lambda: flat.index_add_(0, index, source), 3)
        per_thread = ds.samples_per_thread(m, length, sms)
        bnd = synth_bound(onset, row, gain, table, lengths, length)
        # every tile the kernel is built for, launched directly: the chooser's
        # pick against the others
        out = torch.empty((m, length), device=dev)
        tiles = {}
        for p in ds.PER_THREAD:
            args = ((onset, row, gain, table, lengths, out),
                    (m, onset.shape[1], table.shape[0], table.shape[1], length, p), dev)
            per = device_us(lambda: SYNTH_K.launch(*args), 5)
            tiles[ds.THREADS * p] = sum(us / c for us, c in per.values()) / 1e3
            check(torch.equal(out, want), f"device_synth with tiles of {ds.THREADS * p} differs")
        synth_timings.append({
            "M": m, "qpm": 120.0, "length": length, **row_t, "index_add_ms": lib,
            "device_ms_by_tile": tiles,
            "index_add_device_ms": sum(us for us, _ in lib_device.values()) / 1e3,
            "index_add_elements": int(index.numel()), **bnd,
            "bound_share_of_device_time": bnd["bound_ms"] / max(row_t["kernel_device_ms"], 1e-12),
            "samples_per_thread": per_thread,
            "blocks": m * -(-length // (ds.THREADS * per_thread)),
            "dynamic_smem_bytes": ds.smem_bytes(table.shape[0], onset.shape[1])})
        del event, within, index, source, flat, out

    # band_energies: the waveform entry (the front end's) against its plain
    # version on kit renders, M 1 and 64 at three tempos and the shapes phases
    # 12 and 13 give it; one request and a chunk of 64 at 120 bpm timed
    band_checks, band_timings = [], []
    hop, n_fft, window = params.hop_length, params.n_fft, mso._window(params.n_fft, dev)
    for case, (grids, qpm) in enumerate(cases):
        m, tempo = len(grids), qpm if np.isscalar(qpm) else [qpm.min(), qpm.max()]
        onset, row, gain, table, lengths, length = events_for(dev, grids, qpm, params)
        waves = SYNTH(onset, row, gain, table, lengths, length)
        y = waves / waves.abs().amax(dim=-1, keepdim=True).clamp_min(1e-9)
        del waves
        got = BAND_AUDIO(y, fb_t, window, hop, n_fft)
        again = BAND_AUDIO(y, fb_t, window, hop, n_fft)
        torch.cuda.synchronize()
        want = be.band_energies_from_audio_plain(y, fb_t, window, hop, n_fft)
        err, scale = max_err(got, want), float(want.abs().max())
        f = be.n_frames(length, hop, n_fft)
        check(got.shape == (m, f, 16) and err <= 1e-4 * scale,
              f"band_energies_from_audio != plain version at M {m}, {tempo} bpm: "
              f"{err} > 1e-4 * {scale}")
        check(torch.equal(got, again), f"band_energies_from_audio reruns differ at M {m}")
        del again, want
        # the library route from the same waveform: framing, rfft (keeps the
        # Nyquist bin), abs, one matmul; timed, never used by the port
        library = lambda: torch.fft.rfft(mso._windowed_frames(y, params)).abs() @ fb_t  # noqa: E731
        lib_err = max_err(got, library())
        check(lib_err <= 2e-4 * scale, f"kernel vs rfft route at M {m}: {lib_err}")
        band_checks.append({"entry": "waveform", "M": m, "qpm": tempo, "N": m * f,
                            "max_abs_err": err, "max_ref": scale, "bitwise_repeat": True,
                            "max_abs_err_vs_rfft": lib_err})
        if not (case < 6 and qpm == 120.0):  # M 1 and 64 at 120 bpm
            del y, got
            continue
        stft = lambda: (torch.stft(  # noqa: E731
            y, n_fft, hop, params.win_length, window=hann, center=True, pad_mode="reflect",
            return_complex=True).abs().transpose(1, 2) @ fb_t)
        conv = lambda: mso.stft_magnitude_conv(y, params) @ fb_t  # noqa: E731
        check(max_err(library(), stft()) <= 2e-4 * scale
              and max_err(library(), conv()) <= 2e-4 * scale,
              f"library routes disagree at M {m}")
        row_t = timed(lambda: BAND_AUDIO(y, fb_t, window, hop, n_fft),
                      lambda: be.band_energies_from_audio_plain(y, fb_t, window, hop, n_fft))
        lib_device = device_us(library, 5)
        bnd = band_audio_bound(m, length, f)
        band_timings.append({
            "M": m, "N": m * f, "length": length, **row_t,
            "library_ms": [time_us(library, 20) / 1e3 for _ in range(2)],
            "library_device_ms": sum(us for us, _ in lib_device.values()) / 1e3,
            "library_device_launches": sum(c for _, c in lib_device.values()),
            "stft_matmul_ms": [time_us(stft, 20) / 1e3 for _ in range(2)],
            "conv_matmul_ms": [time_us(conv, 10) / 1e3 for _ in range(2)],
            "framing_ms": time_us(lambda: mso._windowed_frames(y, params), 20) / 1e3,
            **bnd,
            "bound_share_of_device_time": bnd["bound_ms"] / max(row_t["kernel_device_ms"], 1e-12),
            "frames_bytes_bound_ms": band_bound(m * f)["bound_ms"],
            "dense_dft_ms": band_bound(m * f)["dense_dft_ms"]})
        del y, got

    # the frames entry (the JAX kernel's signature; the same kernel with hop
    # n_fft, no padding, no window) at ragged N, on frames of phase 13's 256
    # loops rendered at 90 bpm (549 frames each); N 418 and 26,752 timed
    onset, row, gain, table, lengths, length = events_for(dev, aug_grids, 90.0, params)
    waves = SYNTH(onset, row, gain, table, lengths, length)
    waves = waves / waves.abs().amax(dim=-1, keepdim=True).clamp_min(1e-9)
    all_frames = mso._windowed_frames(waves, params).reshape(-1, n_fft)
    del waves
    frame_timings = []
    for n in (1, 417, 418, 26752, 140544):
        check(all_frames.shape[0] >= n, f"the render gives {all_frames.shape[0]} frames, not {n}")
        frames = all_frames[:n]
        got, again = BAND(frames, fb_t), BAND(frames, fb_t)
        torch.cuda.synchronize()
        want = be.band_energies_plain(frames, fb_t)
        err, scale = max_err(got, want), float(want.abs().max())
        check(got.shape == (n, 16) and err <= 1e-4 * scale,
              f"band_energies != plain version at N {n}: {err} > 1e-4 * {scale}")
        check(torch.equal(got, again), f"band_energies reruns differ at N {n}")
        fft = lambda: torch.fft.rfft(frames).abs() @ fb_t  # noqa: E731
        fft_err = max_err(got, fft())
        check(fft_err <= 2e-4 * scale, f"kernel vs rfft at N {n}: {fft_err}")
        band_checks.append({"entry": "frames", "N": n, "max_abs_err": err, "max_ref": scale,
                            "bitwise_repeat": True, "max_abs_err_vs_rfft": fft_err})
        if n in (418, 26752):
            row_t = timed(lambda: BAND(frames, fb_t), lambda: be.band_energies_plain(frames, fb_t))
            frame_timings.append({"N": n, **row_t,
                                  "rfft_matmul_ms": [time_us(fft, 20) / 1e3 for _ in range(2)],
                                  **band_bound(n)})
        del got, again, want
    del all_frames
    emit({"phase": "front_end_kernels",
          "bars": {"band_energies": "1e-4 * max|ref| (an f32 FFT against the plain version's "
                                    "dense f32 products)",
                   "device_synth": "bit for bit"},
          "device_synth": {"checks": synth_checks, "timings": synth_timings,
                           "resources": kernel_resources("device_synth")},
          "band_energies": {"checks": band_checks, "timings": band_timings,
                            "frames_entry_timings": frame_timings}})
    return {"synth_err": worst_synth,
            "band_err": max(c["max_abs_err"] for c in band_checks),
            "synth_timings": synth_timings, "band_timings": band_timings,
            "band_frame_timings": frame_timings}


def onsets_agree(grids: np.ndarray, qpms: np.ndarray, length: int, sr: int = 44100):
    """Per item: does every hit's onset, computed in f32 as the device route
    computes it, equal the host mixer's f64 onset? Where the f32 value crosses
    an integer the two routes place that sample one position apart."""
    v = grids.shape[2] // 3
    sps = (qpms / 60.0) * 4.0
    cells = np.arange(grids.shape[1])[None, :, None] + grids[:, :, 2 * v:]
    host = np.clip(cells / sps[:, None, None] * sr, 0, length - 1).astype(np.int64)
    sps32 = sps.astype(np.float32)[:, None, None]
    device = np.clip(cells.astype(np.float32) / sps32 * np.float32(sr), 0, length - 1).astype(
        np.int64)
    return ((host == device) | (grids[:, :, :v] <= 0)).all(axis=(1, 2))


def phase_front_end(dev, rng) -> None:
    grids = Loops(64, 22).processed_outputs
    qpms = np.random.default_rng(23).uniform(60.0, 200.0, 64)
    reset_front_end_launches()
    got = mso.mso_batch_from_hvo(grids, None, qpms, device=dev, chunk_size=64)
    counts = {"device_synth": SYNTH_K.launches, "band_energies": BAND_K.launches}
    check(counts == {"device_synth": 1, "band_energies": 1},
          f"one chunk of 64 launched {counts}, expected each kernel once")
    got32 = mso.mso_batch_from_hvo(grids, None, qpms, device=dev, chunk_size=32)
    check((SYNTH_K.launches, BAND_K.launches) == (3, 3),
          "two chunks of 32: one launch per chunk each")
    check(got.shape == (64, 32, 16) and np.isfinite(got).all() and got.min() >= 0
          and got.max() > 0.5, "bad MSO from the kernel route")
    with plain_front_end():
        plain = mso.mso_batch_from_hvo(grids, None, qpms, device=dev, method="fused")
    check((SYNTH_K.launches, BAND_K.launches) == (3, 3), "the plain route launched a kernel")
    host = mso.mso_batch_from_hvo(grids, None, qpms, device="cpu")  # numpy mixer + "fft"
    scale = float(np.abs(host).max())
    errs = {}
    for name, ref in (("plain_route_on_card", plain), ("chunks_of_32", got32)):
        errs[name] = max_err(got, ref)
        check(np.allclose(got, ref, atol=2e-5 * scale, rtol=1e-3),
              f"kernel route vs {name}: max abs err {errs[name]} at scale {scale}")
    # the host mixer computes onsets in f64, the device route in f32 (as the
    # JAX package's two routes do): a loop whose onsets all agree is held to
    # the same bar; one with a hit placed a sample apart (a hat or a cymbal
    # shifted by 23 µs changes its top bands; 2.6 % of the scale on an H100) to
    # 5e-2 of the scale
    length = mso.mso_waveform_length(32, float(qpms.min() / 15.0), mso.MSOParams())
    same = onsets_agree(grids, qpms, length)
    errs["host_route_on_cpu_same_onsets"] = max_err(got[same], host[same])
    errs["host_route_on_cpu_shifted_onsets"] = max_err(got[~same], host[~same]) if (
        ~same).any() else 0.0
    check(same.sum() >= 32 and np.allclose(got[same], host[same], atol=2e-5 * scale, rtol=1e-3),
          f"kernel route vs host route on {int(same.sum())} loops with equal onsets: max abs "
          f"err {errs['host_route_on_cpu_same_onsets']} at scale {scale}")
    check(errs["host_route_on_cpu_shifted_onsets"] <= 5e-2 * scale,
          f"kernel route vs host route on loops with a shifted onset: "
          f"{errs['host_route_on_cpu_shifted_onsets']} at scale {scale}")
    # loops per second through grids -> MSO, by chunk size and method, 120 bpm
    many = Loops(512, 24).processed_outputs
    tempo = np.full((512,), 120.0)
    rates = {}
    for method in ("fused", "fft", "conv"):
        for chunk in (64, 128, 256):
            run = lambda: mso.mso_batch_from_hvo(  # noqa: E731
                many, None, tempo, device=dev, chunk_size=chunk, method=method)
            rates[f"{method}_chunk{chunk}"] = [512e6 / host_us(run, 3) for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    mso.mso_batch_from_hvo(many, None, tempo, device=dev, chunk_size=64)
    peak64 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mso.mso_batch_from_hvo(many, None, tempo, device=dev, chunk_size=256)
    emit({"phase": "front_end", "loops": 64, "qpm_range": [float(qpms.min()), float(qpms.max())],
          "launches_per_chunk": counts, "max_mso": scale, "max_abs_err": errs,
          "loops_with_equal_onsets": int(same.sum()),
          "bar": "atol 2e-5 * max|host route|, rtol 1e-3; 5e-2 * max where an onset differs "
                 "by a sample between the f32 and f64 routes",
          "loops_per_s_512_loops_120bpm": rates,
          "peak_bytes_chunk64": peak64,
          "peak_bytes_chunk256": torch.cuda.max_memory_allocated()})


def phase_serve_hvo(dev, rng, sd, srv) -> dict:
    """``hvo_input`` + ``qpm`` to the flagship-width server: the synth + MSO
    front end and the model on the card."""
    loops = Loops(40, 25).processed_outputs
    requests = [(loops[0], 90.0), (loops[:6], 120.0), (loops, 150.0)]
    chunks = [1, 1, 2]  # model buckets (1, 8, 32): 1 | 8 | 32 + 8; front end: 1 chunk each
    MHA.launches = 0  # the main path's run starts here
    reset_front_end_launches()
    out = [srv.infill_from_hvo(g, qpm=q) for g, q in requests]
    counts = {"fused_mha": MHA.launches, "band_energies": BAND_K.launches,
              "device_synth": SYNTH_K.launches}  # ... and ends here
    check(counts == {"fused_mha": 6 * sum(chunks), "band_energies": 3, "device_synth": 3},
          f"hvo_input requests launched {counts}; expected 6 fused_mha per model chunk "
          f"({6 * sum(chunks)}) and the front-end kernels once per request")
    cpu_model = build_model(FLAGSHIP, "cpu")
    cpu_model.load_state_dict(sd, strict=True)
    worst = 0.0
    for (g, q), y in zip(requests, out):
        g3 = g[None] if g.ndim == 2 else g
        check(y.shape == g.shape and np.isfinite(y).all(), f"bad hvo_input answer at {q} bpm")
        # the plain versions on the CPU, front end and model
        x_cpu = mso.mso_batch_from_hvo(g3, None, np.full((len(g3),), q), device="cpu",
                                       device_synth=True, method="fused")
        h_cpu, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(x_cpu))
        sig = predict(cpu_model, torch.from_numpy(x_cpu), use_thres=False)[0].numpy()
        y3 = y[None] if y.ndim == 2 else y
        err = max(max_err(y3[..., 9:18], v_cpu), max_err(y3[..., 18:], o_cpu))
        worst = max(worst, err)
        check(err <= 1e-4, f"hvo_input at {q} bpm vs the CPU plain path: v/o differ by {err}")
        check(hit_agreement(y3[..., :9], h_cpu.numpy(), sig),
              f"hvo_input at {q} bpm: hits differ away from the threshold")
    httpd = srv.serve_http(port=0, block=False)
    try:
        port = httpd.server_address[1]
        for (g, q), y in zip(requests, out):
            code, payload = post(port, {"hvo_input": g.tolist(), "qpm": q})
            check(code == 200, f"POST hvo_input answered {code}: {payload}")
            check(np.array_equal(np.asarray(payload["hvo"], np.float32), y),
                  f"HTTP hvo_input answer at {q} bpm differs from the direct path")
        code, payload = post(port, {"hvo_input": loops[0].tolist(), "sf_path": "kit.sf2"})
        check(code == 501, f"sf_path answered {code}, expected 501 (not ported)")
        url = f"http://127.0.0.1:{port}/infill"
        http = serve.latency_benchmark(srv, n_requests=200, url=url, hvo_input=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
    runs = {"hvo_input": [], "mso_input": []}
    for which in ("hvo_input", "mso_input", "mso_input", "hvo_input"):  # in turns
        runs[which].append(serve.latency_benchmark(srv, n_requests=300,
                                                   hvo_input=which == "hvo_input"))
    # where a B = 1 hvo_input request's time goes
    g1 = loops[:1]
    x1 = srv._front_end(g1, 120.0)
    request = host_us(lambda: srv.infill_from_hvo(g1, qpm=120.0))
    front = host_us(lambda: srv._front_end(g1, 120.0))
    model = host_us(lambda: srv.infill(x1))
    per_kernel = device_us(lambda: srv.infill_from_hvo(g1, qpm=120.0), n=30)
    front_kernels = device_us(lambda: srv._front_end(g1, 120.0), n=30)
    device_total = sum(us for us, _ in per_kernel.values())
    emit({"phase": "serve_hvo_input", "config": "InfillingRandom flagship d256 h2 ff512 6L",
          "requests": [[1 if g.ndim == 2 else len(g), q] for g, q in requests],
          "launches": counts, "max_abs_err_vs_cpu_plain": worst})
    emit({"phase": "serve_hvo_input_latency", "batch": 1, "qpm": 120.0,
          "in_process": runs, "http_hvo_input": http})
    emit({"phase": "serve_hvo_input_split",
          "breakdown_us": {"request": request, "front_end": front, "model_request": model},
          "request_device_us": device_total,
          "front_end_device_us": sum(us for us, _ in front_kernels.values()),
          "device_launches_per_request": sum(c for _, c in per_kernel.values()),
          "front_end_launches_per_request": sum(c for _, c in front_kernels.values()),
          "device_busy_share": device_total / request,
          "top_front_end_kernels_us_launches": sorted(
              front_kernels.items(), key=lambda kv: -kv[1][0])[:8]})
    return {"launches": counts}


def phase_train_augment(dev, rng) -> dict:
    """The flagship config trained on MSO inputs rendered inside the epoch:
    random masking, synthesis and MSO on the card, every epoch anew."""
    batch, epochs = FLAGSHIP_HP["batch_size"], 3
    grids, qpms = augment_corpus()
    n = len(grids)
    base = torch.from_numpy(grids).to(dev)
    augment = make_on_device_augment(qpms=qpms, mode="audio")
    bundle, _, _ = initialize_model(flagship_params(), dev)
    epoch_fn = make_epoch_fn(FLAGSHIP_HP["hit_loss_penalty"], batch, n, augment=augment)
    gen = torch.Generator(dev).manual_seed(0)
    reset_launches()  # the main path's run starts here
    reset_front_end_launches()
    metrics = [fetch(epoch_fn(bundle.state, base, base, gen)) for _ in range(epochs)]
    counts = {**launches(fl.SM90_KERNELS), "band_energies": BAND_K.launches,
              "device_synth": SYNTH_K.launches}  # ... and ends here
    steps, n_layers = epochs * (n // batch), FLAGSHIP_HP["num_encoder_decoder_layers"]
    n_chunks = epochs * -(-n // ds.DEFAULT_CHUNK)
    want = {**{k: steps * n_layers for k in fl.SM90_KERNELS},
            "band_energies": n_chunks, "device_synth": n_chunks}
    check(counts == want, f"augmented training launched {counts}, expected {want}")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(v) for m in metrics for v in m.values()), f"non-finite: {metrics}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    # seqs/s with the front end inside the epoch, beside the same epoch on
    # inputs rendered once
    inputs, outputs = augment(torch.Generator(dev).manual_seed(1), base, base)
    before = (SYNTH_K.launches, BAND_K.launches)
    with plain_front_end():  # the same call, same draws, through the plain versions
        plain_inputs, plain_outputs = augment(torch.Generator(dev).manual_seed(1), base, base)
    check((SYNTH_K.launches, BAND_K.launches) == before, "the plain augment launched a kernel")
    augment_err, scale = max_err(inputs, plain_inputs), float(plain_inputs.abs().max())
    check(torch.equal(outputs, plain_outputs)
          and torch.allclose(inputs, plain_inputs, atol=2e-5 * scale, rtol=1e-3),
          f"augment through the kernels vs the plain versions: {augment_err} at scale {scale}")
    del plain_inputs, plain_outputs
    plain_fn = make_epoch_fn(FLAGSHIP_HP["hit_loss_penalty"], batch, n)

    def seqs(fn, x, y):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fetch(fn(bundle.state, x, y, gen))
        return n / (time.perf_counter() - t0)

    rates = {"augmented": [], "rendered_once": []}
    for which in ("augmented", "rendered_once", "rendered_once", "augmented"):
        if which == "augmented":
            rates[which].append(seqs(epoch_fn, base, base))
        else:
            rates[which].append(seqs(plain_fn, inputs, outputs))
    augment_ms = host_us(lambda: augment(gen, base, base), 5) / 1e3
    emit({"phase": "train_audio_augment", "config": FLAGSHIP_HP,
          "data": f"{n} seeded synthetic loops, 90-150 bpm", "epochs": epochs, "steps": steps,
          "launches": counts, "losses": losses, "last_metrics": metrics[-1],
          "augment_max_abs_err_vs_plain": augment_err, "augment_max": scale,
          "augment_bar": "atol 2e-5 * max, rtol 1e-3; targets equal",
          "seqs_per_s": rates, "augment_ms_per_epoch": augment_ms})
    return {"launches": counts}


def phase_train_encdec(dev, rng) -> dict:
    """The encoder-decoder family (6 + 6 layers at the flagship width) trained
    with teacher forcing through ``initialize_model`` +
    ``train_loop(encoder_only=0)``: every encoder and decoder layer's forward
    and backward through its kernels."""
    # 256 loops for the epochs and the batch-32 rates, 512 (one step) at batch 512
    data, held, big = Loops(256, 31), Loops(256, 32), Loops(512, 31)
    batch, epochs = FLAGSHIP_HP["batch_size"], 3
    steps = epochs * (len(data.processed_inputs) // batch)
    params = lambda **model: flagship_params(num_decoder_layers=ENCDEC_LAYERS, **model)  # noqa: E731
    unfused = dict(fused_layer=False, fused_decoder_layer=False)
    bundle, _, _ = initialize_model(params(), dev)
    cfg = bundle.config
    check(cfg.fused_layer and cfg.fused_decoder_layer and cfg.compute_dtype == torch.bfloat16
          and cfg.num_decoder_layers == ENCDEC_LAYERS and not cfg.encoder_only,
          f"auto policy did not pick both layer kernels in bf16: {cfg}")
    reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    metrics = run_epochs(bundle, data, held, epochs, batch, encoder_only=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches(SM90_LAYER_KERNELS)  # ... and ends here
    check(all(c == steps * ENCDEC_LAYERS for c in counts.values())
          and not any(launches(F32_LAYER_KERNELS).values()),
          f"layer launches {counts}, expected {steps * ENCDEC_LAYERS} each ({steps} steps x "
          f"{ENCDEC_LAYERS} encoder and {ENCDEC_LAYERS} decoder layers), and the f32 kernels "
          f"{launches(F32_LAYER_KERNELS)}, expected 0")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(v) for m in metrics for v in m.values()), f"non-finite: {metrics}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    plain, _, _ = initialize_model(params(**unfused), dev)
    before = launches(LAYER_KERNELS)
    plain_losses = [m["loss"] for m in run_epochs(plain, data, held, epochs, batch, 0)]
    check(launches(LAYER_KERNELS) == before, "the unfused path launched a layer kernel")
    check(all(np.isfinite(plain_losses)) and plain_losses[-1] < plain_losses[0],
          f"unfused path loss did not fall: {plain_losses}")

    # 3 f32 steps at dropout 0 through make_epoch_fn: the kernel path against
    # the twin path (the kernel's side of a ReLU kink, ``fused_layers_as``)
    # and the unfused path, on the card
    kernel_h, kinks, three = [], [], {}
    x = torch.from_numpy(data.processed_inputs[:96]).to(dev)
    y = torch.from_numpy(data.processed_outputs[:96]).to(dev)
    reset_launches()  # the f32 route's path: its kernels launch here only
    for name in ("kernel", "twin", "unfused"):
        b, _, _ = initialize_model(
            params(bf16=False, dropout=0.0, **(unfused if name == "unfused" else {})), dev)
        epoch_fn = make_epoch_fn(FLAGSHIP_HP["hit_loss_penalty"], 32, 96, shuffle=False,
                                 encoder_only=False)
        with fused_layers_as(name, kernel_h, kinks):
            epoch_fn(b.state, x, y, torch.Generator(dev).manual_seed(0))
        check(b.state.step == 3, f"{name}: {b.state.step} steps, expected 3")
        three[name] = {k: v.detach().cpu() for k, v in b.model.state_dict().items()}
    f32_counts = launches(F32_LAYER_KERNELS)  # the forwards twice a call (fused_layers_as)
    check(all(c == (2 if k.endswith("fwd") else 1) * 3 * ENCDEC_LAYERS
              for k, c in f32_counts.items())
          and not any(launches(SM90_LAYER_KERNELS).values()),
          f"3 f32 steps launched {launches(LAYER_KERNELS)}")
    param_err = {other: max(max_err(three["kernel"][k], three[other][k]) for k in three["kernel"])
                 for other in ("twin", "unfused")}
    check(param_err["twin"] <= 1e-4 and param_err["unfused"] <= UNFUSED_BAR,
          f"3 f32 steps: params differ by {param_err} (kink flips per layer call: {kinks})")

    # throughput, kernel path and unfused path in turns
    throughput = {}
    for b in THROUGHPUT_BATCHES:
        runs = {"kernel": [], "unfused": []}
        models = {"kernel": initialize_model(params(), dev)[0],
                  "unfused": initialize_model(params(**unfused), dev)[0]}
        corpus = data if b == batch else big
        for which in ("kernel", "unfused", "unfused", "kernel"):
            seqs_per_s(models[which], corpus, b, 0)  # warm-up epoch
            runs[which].append(seqs_per_s(models[which], corpus, b, 0))
        throughput[b] = runs

    # where a step's device time goes (kernel path)
    breakdown = {b: step_breakdown(initialize_model(params(), dev)[0], b, 33, 0)
                 for b in THROUGHPUT_BATCHES}
    emit({"phase": "train_encdec",
          "config": {**FLAGSHIP_HP, "encoder_only": 0, "num_decoder_layers": ENCDEC_LAYERS},
          "data": "256 seeded synthetic loops (512 for the rates at batch 512)",
          "epochs": epochs, "steps": steps,
          "seconds": seconds, "launches": counts,
          "launches_per_step": {k: c / steps for k, c in counts.items()},
          "three_f32_steps_launches": f32_counts, "losses": losses,
          "last_metrics": metrics[-1], "unfused_losses": plain_losses,
          "three_f32_steps_param_err": param_err, "three_f32_steps_kink_flips": kinks,
          "unfused_bar": UNFUSED_BAR, "seqs_per_s": throughput, "step_breakdown": breakdown})
    return {"launches": counts, "f32_launches": f32_counts, "seqs_per_s": throughput}


def phase_serve_encdec(dev, rng, enc_srv) -> dict:
    """``InfillServer`` over the encoder-decoder config: no target is passed,
    the decoder reads zeros, and every chunk's 6 encoder, 6 causal decoder
    self- and 6 decoder cross-attentions go through ``fused_mha``."""
    sd = build_model(ENCDEC, "cpu", torch.Generator().manual_seed(16)).state_dict()
    srv = serve.InfillServer(sd, ENCDEC, batch_sizes=BUCKETS, device=dev)
    xs = {n: rng.standard_normal((n, 32, 16)).astype(np.float32) for n in (1, 6, 40)}
    chunks = {1: 1, 6: 1, 40: 2}  # buckets (1, 8, 32): 1 | 8 | 32 + 8
    per_chunk = ENCDEC.num_encoder_layers + 2 * ENCDEC.num_decoder_layers
    MHA.launches = 0  # the main path's run starts here
    out = {n: srv.infill(x) for n, x in xs.items()}
    launches_mha = MHA.launches  # ... and ends here
    check(launches_mha == per_chunk * sum(chunks.values()),
          f"fused_mha launched {launches_mha} times, expected {per_chunk} per forward chunk "
          f"({per_chunk * sum(chunks.values())})")
    cpu_model = build_model(ENCDEC, "cpu")
    cpu_model.load_state_dict(sd, strict=True)

    def against_cpu(x_cpu, y, what):
        h_cpu, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(x_cpu))
        sig = predict(cpu_model, torch.from_numpy(x_cpu), use_thres=False)[0].numpy()
        check(y.shape == x_cpu.shape[:2] + (27,) and np.isfinite(y).all(), f"bad output, {what}")
        err = max(max_err(y[..., 9:18], v_cpu), max_err(y[..., 18:], o_cpu))
        check(err <= 1e-4, f"{what}: v/o differ from the CPU plain path by {err}")
        check(hit_agreement(y[..., :9], h_cpu.numpy(), sig),
              f"{what}: hits differ away from the threshold")
        return err

    worst = max(against_cpu(x, out[n], f"encoder-decoder server at N={n}")
                for n, x in xs.items())
    # one hvo_input request: the front end's kernels, then 18 attentions
    grid = Loops(1, 34).processed_outputs
    MHA.launches = 0
    reset_front_end_launches()
    y_hvo = srv.infill_from_hvo(grid[0], qpm=120.0)
    hvo_counts = {"fused_mha": MHA.launches, "band_energies": BAND_K.launches,
                  "device_synth": SYNTH_K.launches}
    check(hvo_counts == {"fused_mha": per_chunk, "band_energies": 1, "device_synth": 1},
          f"one hvo_input request launched {hvo_counts}")
    x_cpu = mso.mso_batch_from_hvo(grid, None, np.full((1,), 120.0), device="cpu",
                                   device_synth=True, method="fused")
    hvo_err = against_cpu(x_cpu, y_hvo[None], "encoder-decoder hvo_input")

    runs = {"encoder_decoder": [], "encoder_only": []}
    for which in ("encoder_decoder", "encoder_only", "encoder_only", "encoder_decoder"):
        runs[which].append(serve.latency_benchmark(
            srv if which == "encoder_decoder" else enc_srv, n_requests=200, batch=1))
    x1 = np.zeros((1, 32, 16), np.float32)
    request = host_us(lambda: srv.infill(x1))
    per_kernel = device_us(lambda: srv.infill(x1), n=30)
    device_total = sum(us for us, _ in per_kernel.values())
    emit({"phase": "serve_encdec", "config": "d256 h2 ff512, 6 + 6 layers, f32",
          "requests": sorted(xs), "chunks": sum(chunks.values()), "launches": launches_mha,
          "launches_per_chunk": per_chunk, "max_abs_err_vs_cpu_plain": worst,
          "hvo_input": {"launches": hvo_counts, "max_abs_err_vs_cpu_plain": hvo_err},
          "latency_b1_in_process": runs,
          "request_us": request, "request_device_us": device_total,
          "device_launches_per_request": sum(c for _, c in per_kernel.values()),
          "device_busy_share": device_total / request,
          "top_device_kernels_us_launches": sorted(
              per_kernel.items(), key=lambda kv: -kv[1][0])[:6]})
    return {"launches": launches_mha}


# ---------------------------------------------------------------- slice 5

# rows × d × ff and the config's dropout rate: configs/
# InfillingRandomLow_lm_training.yaml at batch 32 and 512, then GrooveXL
# (scripts/bench_groovexl_ffn.py) at batch 128
FFN_SHAPES = ((1024, 256, 2048, 0.16), (16384, 256, 2048, 0.16), (4096, 1024, 4096, 0.1))
# widths that are no multiples of the tiles, rows of no whole tile
RAGGED_FFN_SHAPE = (100, 72, 200, 0.16)
FFN_GRADS = ("dx", "dw1", "db1", "dw2", "db2")
LN_GRADS = ("dx", "dy", "dscale", "dbias")
NEW_KERNELS = {**ffn.KERNELS, **ln.KERNELS}
# "GrooveXL", scripts/bench_groovexl_ffn.py: the one shape with remat on. That
# script's SGD rate of 0.05 makes the loss climb on these loops, with the FFN
# kernels and with fused_ffn=False alike (8.6 → 20 → 36 in three steps on an
# H100); 0.003 lets it fall
# phase 20: epochs of the checkpointed flagship run, its loops, its watch cadence
CKPT_EPOCHS, CKPT_LOOPS, CKPT_WATCH_FREQ = 4, 512, 32
XL_HP = {
    "d_model": 1024, "n_heads": 8, "dim_feedforward": 4096, "dropout": 0.1,
    "num_encoder_layers": 12, "batch_size": 128, "remat": True, "learning_rate": 0.003,
    "hit_loss_penalty": 0.73, "optimizer": "sgd", "fused_ffn": True,  # auto leaves it off
}


def ffn_bounds(rows, d, ff, dtype) -> dict:
    """Bounds of each FFN launch type: a product of 2·rows·d·ff FLOP, its
    inputs read once and its outputs written once (storage dtype s; biases,
    seed, gradients and the weight partials f32)."""
    s = 4 if dtype == "float32" else 2
    flops = 2 * rows * d * ff
    total = 2 * d * ff + ff + d
    splits = (ffn.wgrad_splits(rows, d, ff, torch.cuda.get_device_properties(0)
                               .multi_processor_count)[0] if dtype == "bfloat16" else 1)
    act, hid, wts = rows * d * s, rows * ff * s, d * ff * s
    return {
        "fused_ffn_fwd_h": bound(act + wts + ff * 4 + 4 + hid, flops, dtype),  # x, W1, b1 → h
        "fused_ffn_fwd_out": bound(hid + wts + d * 4 + act, flops, dtype),  # h, W2, b2 → out
        "fused_ffn_bwd_dh": bound(act + wts + 2 * hid, flops, dtype),  # dy, W2, h → dh
        "fused_ffn_bwd_dx": bound(hid + wts + act, flops, dtype),  # dh, W1 → dx
        "fused_ffn_bwd_weights": bound(2 * act + 2 * hid + splits * total * 4,
                                       2 * flops + rows * (ff + d), dtype),
        "fused_ffn_reduce": bound((splits + 1) * total * 4, (splits - 1) * total, "float32"),
        "fused_ffn_fwd_f32": bound(2 * act + hid + 2 * wts + (ff + d) * 4 + 4, 2 * flops, dtype),
        "fused_ffn_bwd_rows_f32": bound(2 * act + 2 * hid + 2 * wts, 2 * flops, dtype),
        "fused_ffn_bwd_weights_f32": bound(2 * act + 2 * hid + total * 4,
                                           2 * flops + rows * (ff + d), dtype),
    }


def ffn_launches(rows, d, ff, dtype, sites: int, forward_passes: int = 1) -> dict:
    """FFN launches of ``sites`` forward and backward passes at ``rows``, each
    forward run ``forward_passes`` times (2 under remat): bf16 two forward
    products, two row-backward products, one weight launch and, when it splits
    the rows, one reduce; f32 its three kernels."""
    if dtype == torch.bfloat16:
        splits = ffn.wgrad_splits(rows, d, ff,
                                  torch.cuda.get_device_properties(0).multi_processor_count)[0]
        per = {"fused_ffn_fwd_h": forward_passes, "fused_ffn_fwd_out": forward_passes,
               "fused_ffn_bwd_dh": 1, "fused_ffn_bwd_dx": 1, "fused_ffn_bwd_weights": 1,
               "fused_ffn_reduce": int(splits > 1)}
    else:
        per = {"fused_ffn_fwd_f32": forward_passes, "fused_ffn_bwd_rows_f32": 1,
               "fused_ffn_bwd_weights_f32": 1}
    return {k: sites * per.get(k, 0) for k in ffn.KERNELS}


def ln_bounds(rows, d, dtype) -> dict:
    """Bounds of the two LN kernels: x, y (and g) read, out (or dx, dy)
    written; about 10 operations an element forward (mask, add, two-pass
    statistics, normalise, affine) and 25 backward."""
    s = 4 if dtype == "float32" else 2
    return {"fused_ln_fwd": bound(3 * rows * d * s + 2 * d * 4 + 4, 10 * rows * d, dtype),
            "fused_ln_bwd": bound(5 * rows * d * s + 3 * d * 4 + 4, 25 * rows * d, dtype)}


def time_ms(fn, n: int, warm: int = 2) -> float:
    """Mean ms per call on the stream over ``n`` calls after ``warm``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def normal(dev, rng, *shape, scale=1.0, offset=0.0) -> torch.Tensor:
    """f32 normal draws from ``rng``, on ``dev``."""
    a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a).to(dev)


def ffn_case(dev, rng, rows, d, ff, dtype):
    """(x, w1, b1, w2, b2) in the port's layout, then dy, y (a second
    (rows, d) input for the LN kernels) and LN's scale and bias, from ``rng``."""
    n = functools.partial(normal, dev, rng)
    return ([n(rows, d).to(dtype), n(ff, d, scale=d ** -0.5).to(dtype), n(ff, scale=0.1),
             n(d, ff, scale=ff ** -0.5).to(dtype), n(d, scale=0.1)],
            n(rows, d).to(dtype), n(rows, d).to(dtype), n(d, scale=0.1, offset=1.0),
            n(d, scale=0.1))


def held_to(errs, name, got, want, dtype, what) -> None:
    """Phase 8's bars: f32 within 1e-4 (``relative``: of max|want|, for
    gradients, whose sums run over thousands of rows), bf16 within 2e-2 of
    max|want|."""
    want = want.detach().float()
    top = float(want.abs().max())
    relative = name.startswith("d")
    bar = (1e-4 * (top if relative else 1.0)) if dtype == torch.float32 else 2e-2 * top
    errs[name] = max_err(got, want)
    check(errs[name] <= bar, f"{name} at {what}: {errs[name]} > {bar}")


def ffn_tile_shapes(dev, args, dy, seed, rate) -> dict:
    """Device µs per launch of each bf16 product with each of the two tile
    shapes it is built for (``ffn.PRODUCT_TILES``; the weight gradients with
    their row splits for it), launched directly with preallocated outputs,
    and the shapes the wrappers pick. Every shape's results are held to the
    wrappers' within 2e-2 of their maxima (phase 17 holds the wrappers to the
    plain version)."""
    x, w1, b1, w2, b2 = args
    (rows, d), ff = x.shape, w1.shape[0]
    want_out, want_h = ffn.ffn_forward(*args, seed, rate)
    want_dx, *want_grads = ffn.ffn_backward(dy, x, want_h, w1, w2, rate)
    want = {"h": want_h, "out": want_out, "dx": want_dx,
            "weights": torch.cat([g.flatten() for g in want_grads])}  # dW1 | db1 | dW2 | db2
    out, h, dh, dx = (torch.empty_like(t) for t in (x, want_h, want_h, x))
    thresh, k = quantized_threshold(rate), ffn.KERNELS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    total = 2 * d * ff + ff + d

    def launches_with(cfgs, part):
        splits, per = ffn.wgrad_splits(rows, d, ff, sms, cfgs[4])
        return lambda: (
            k["fused_ffn_fwd_h"].launch((x, w1, b1, seed, h), (rows, d, ff, thresh, cfgs[0]), dev),
            k["fused_ffn_fwd_out"].launch((h, w2, b2, out), (rows, d, ff, cfgs[1]), dev),
            k["fused_ffn_bwd_dh"].launch((dy, w2, h, dh), (rows, d, ff, thresh, cfgs[2]), dev),
            k["fused_ffn_bwd_dx"].launch((dh, w1, dx), (rows, d, ff, cfgs[3]), dev),
            k["fused_ffn_bwd_weights"].launch((dy, x, h, dh, part),
                                              (rows, d, ff, splits, per, cfgs[4]), dev))

    names = ("fused_ffn_fwd_h", "fused_ffn_fwd_out", "fused_ffn_bwd_dh", "fused_ffn_bwd_dx",
             "fused_ffn_bwd_weights")
    result = {name: {} for name in names}
    for i in range(2):
        cfgs = tuple(shapes[i] for shapes in ffn.PRODUCT_TILES)
        part = torch.empty((ffn.wgrad_splits(rows, d, ff, sms, cfgs[4])[0], total), device=dev)
        per = device_us(launches_with(cfgs, part), n=5)
        # the partials in the wrappers' order: dW1 | dW2 | db1 | db2 → dW1 | db1 | dW2 | db2
        dw1, dw2, db1, db2 = part.sum(0).split([d * ff, d * ff, ff, d])
        got = {"h": h, "out": out, "dx": dx, "weights": torch.cat([dw1, db1, dw2, db2])}
        for key, ref in want.items():
            err, top = max_err(got[key], ref.float()), float(ref.float().abs().max())
            check(err <= 2e-2 * top, f"{key} with tiles {cfgs} at rows {rows} d {d} ff {ff} "
                                     f"rate {rate}: {err} > 2e-2 * {top}")
        for name, cfg in zip(names, cfgs):
            result[name]["x".join(map(str, ffn.TILES[cfg]))] = sum(
                us / c for kn, (us, c) in per.items() if FFN_DEVICE_NAMES[name][0] in kn)
    result["picked"] = dict(zip(names, ffn.tile_configs(rows, d, ff, sms)))
    return result


def ln_grids(dev, rows: int, d: int) -> dict:
    """The LN kernels' grids at one bf16 shape: blocks, backward warps a block
    and the backward's tree of tickets."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bwd = ln.ln_grid(rows, d, torch.bfloat16, sms, True)
    return {"fwd_blocks": ln.ln_grid(rows, d, torch.bfloat16, sms, False), "bwd_blocks": bwd,
            "bwd_warps_a_block": ln.bwd_warps(d, torch.bfloat16),
            "bwd_ticket_tree": ln.ticket_tree(bwd)}


def phase_ffn_ln(dev, rng) -> dict:
    """The three FFN kernels against ``ffn_reference`` and the two LN kernels
    against ``dropout_add_layernorm_reference`` on the card, with the same
    masks, at the shapes phases 18 and 19 give them. A hidden unit within
    rounding of 0 may fall on either side of the ReLU's kink: the plain
    version takes the kernel's side at such units only (``kink_flips``)."""
    checks, worst = [], {"ffn": 0.0, "ln": 0.0}
    for rows, d, ff, cfg_rate in (*FFN_SHAPES, RAGGED_FFN_SHAPE):
        for dtype in (torch.float32, torch.bfloat16):
            args, dy, y, scale, bias = ffn_case(dev, rng, rows, d, ff, dtype)
            x, w1, _, w2, _ = args
            active = None
            for rate in (0.0, cfg_rate):
                what = f"rows {rows} d {d} ff {ff} {dtype} rate {rate}"
                seed = torch.tensor([1234 + rows], dtype=torch.int32, device=dev)
                runs = []
                for _ in range(2):
                    out, h = ffn.ffn_forward(*args, seed, rate)
                    runs.append((out, h, *ffn.ffn_backward(dy, x, h, w1, w2, rate)))
                torch.cuda.synchronize()
                bitwise = all(torch.equal(u, v) for u, v in zip(*runs))
                check(bitwise, f"two FFN runs with one seed differ at {what}")
                out, h, *grads = runs[0]
                with torch.no_grad():
                    own_h = ffn.ffn_reference(*args, seed, rate, return_hidden=True)[1]
                flips, kink = fl.kink_flips(own_h, h)
                leaves = [a.detach().clone().requires_grad_(True) for a in args]
                want_out, want_h = ffn.ffn_reference(*leaves, seed, rate, return_hidden=True,
                                                     relu_flips=flips)
                want_out.backward(dy)
                errs = {}
                held_to(errs, "out", out, want_out, dtype, what)
                held_to(errs, "h", h, want_h, dtype, what)
                for name, g, leaf in zip(FFN_GRADS, grads, leaves):
                    held_to(errs, name, g, leaf.grad, dtype, what)
                # the share of the ReLU's live units that the mask kept: within
                # 2e-3 of the quantised rate, or 5 standard deviations where
                # the units are too few for that (the ragged shape)
                live = int((h > 0).sum())
                active = live if rate == 0.0 else active
                kept, p_keep = live / active, quantized_keep_rate(rate)
                check(abs(kept - p_keep) < max(2e-3, 5 * (p_keep * (1 - p_keep) / active) ** 0.5),
                      f"FFN mask kept {kept} at {what}")
                if dtype == torch.float32:
                    worst["ffn"] = max(worst["ffn"], errs["out"], errs["h"], errs["dx"])
                checks.append({"kernel": "fused_ffn", "rows": rows, "d": d, "ff": ff,
                               "dtype": str(dtype)[6:], "rate": rate, "max_abs_err": errs,
                               "bitwise_repeat": bitwise, "relu_kink_flips": kink,
                               "kept_share": kept})
                del leaves, want_out, want_h, own_h, flips, runs

                runs = []
                for _ in range(2):
                    runs.append((ln.ln_forward(x, y, scale, bias, seed, rate),
                                 *ln.ln_backward(dy, x, y, scale, seed, rate)))
                torch.cuda.synchronize()
                bitwise = all(torch.equal(u, v) for u, v in zip(*runs))
                check(bitwise, f"two LN runs with one seed differ at {what}")
                out, *grads = runs[0]
                leaves = [a.detach().clone().requires_grad_(True) for a in (x, y, scale, bias)]
                want = ln.dropout_add_layernorm_reference(*leaves, seed, rate)
                want.backward(dy)
                errs = {}
                held_to(errs, "out", out, want, dtype, what)
                for name, g, leaf in zip(LN_GRADS, grads, leaves):
                    held_to(errs, name, g, leaf.grad, dtype, what)
                kept = float((grads[1] != 0).float().mean())  # dy is 0 where y was dropped
                n_el = rows * d
                check(abs(kept - (1 - rate)) < 5 * (rate * (1 - rate) / n_el) ** 0.5 + 1e-4,
                      f"LN mask kept {kept} at {what}")
                if dtype == torch.float32:
                    worst["ln"] = max(worst["ln"], errs["out"], errs["dx"], errs["dy"])
                checks.append({"kernel": "fused_ln", "rows": rows, "d": d,
                               "dtype": str(dtype)[6:], "rate": rate, "max_abs_err": errs,
                               "bitwise_repeat": bitwise, "kept_share": kept})
                del leaves, want, runs

    timings = []
    for rows, d, ff, rate in FFN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype)[6:]
            args, dy, y, scale, bias = ffn_case(dev, rng, rows, d, ff, dtype)
            x, w1, b1, w2, b2 = args
            seed = torch.tensor([7], dtype=torch.int32, device=dev)
            h = ffn.ffn_forward(*args, seed, rate)[1]
            n = 20 if rows * d * ff < 2 ** 31 else 5
            row = {"rows": rows, "d": d, "ff": ff, "dtype": name, "rate": rate,
                   "bounds": {**ffn_bounds(rows, d, ff, name), **ln_bounds(rows, d, name)}}

            # the FFN: kernels, plain version, library composition (cuBLAS
            # products, eager relu and dropout, autograd's backward)
            leaves = [a.detach().clone().requires_grad_(True) for a in args]
            ref_out = ffn.ffn_reference(*leaves, seed, rate)
            lib = [a.detach().clone().requires_grad_(True) for a in args]
            lib[2], lib[4] = (lib[i].detach().to(dtype).requires_grad_(True) for i in (2, 4))

            def lib_ffn(p=lib):
                hid = F.dropout(torch.relu(F.linear(p[0], p[1], p[2])), rate, training=True)
                return F.linear(hid, p[3], p[4])

            lib_out = lib_ffn()

            def plain_ffn():
                with torch.no_grad():
                    ffn.ffn_reference(*args, seed, rate)

            fns = {
                "ffn_fwd": (lambda: ffn.ffn_forward(*args, seed, rate), plain_ffn,
                            lambda: lib_ffn()),
                "ffn_bwd": (lambda: ffn.ffn_backward(dy, x, h, w1, w2, rate),
                            lambda: torch.autograd.grad(ref_out, leaves, dy, retain_graph=True),
                            lambda: torch.autograd.grad(lib_out, lib, dy, retain_graph=True)),
            }
            # LN: kernels, plain version, F.layer_norm(x + F.dropout(y))
            ln_leaves = [a.detach().clone().requires_grad_(True) for a in (x, y, scale, bias)]
            ln_ref = ln.dropout_add_layernorm_reference(*ln_leaves, seed, rate)
            ln_lib = [a.detach().clone().to(dtype).requires_grad_(True)
                      for a in (x, y, scale, bias)]

            def lib_ln(p=ln_lib):
                return F.layer_norm(p[0] + F.dropout(p[1], rate, training=True), (d,), p[2], p[3])

            ln_lib_out = lib_ln()

            def plain_ln():
                with torch.no_grad():
                    ln.dropout_add_layernorm_reference(x, y, scale, bias, seed, rate)

            fns["ln_fwd"] = (lambda: ln.ln_forward(x, y, scale, bias, seed, rate), plain_ln,
                             lambda: lib_ln())
            fns["ln_bwd"] = (
                lambda: ln.ln_backward(dy, x, y, scale, seed, rate),
                lambda: torch.autograd.grad(ln_ref, ln_leaves, dy, retain_graph=True),
                lambda: torch.autograd.grad(ln_lib_out, ln_lib, dy, retain_graph=True))
            for key, (k, p, lb) in fns.items():
                k1, p1, l1, l2, p2, k2 = (time_ms(f, m) for f, m in
                                          ((k, n), (p, 3), (lb, n), (lb, n), (p, 3), (k, n)))
                row[f"{key}_kernel_ms"], row[f"{key}_plain_ms"] = [k1, k2], [p1, p2]
                row[f"{key}_library_ms"] = [l1, l2]
            for key in ("ln_fwd", "ln_bwd"):
                lib_device = device_us(fns[key][2], 5)
                row[f"{key}_library_device_ms"] = sum(us for us, _ in lib_device.values()) / 1e3
                row[f"{key}_library_device_launches"] = sum(c for _, c in lib_device.values())
            # the LN backward is one launch, dscale and dbias summed inside it
            one = device_us(fns["ln_bwd"][0], 5)
            check(all("ln_bwd" in k for k in one) and sum(c for _, c in one.values()) <= 1.0 + 1e-9,
                  f"an LN backward launched {one}, not one ln_bwd")
            row["ln_bwd_device_launches_per_call"] = {k: c for k, (_, c) in one.items()}
            dev_k = device_us(lambda: [fns[key][0]() for key in fns], n=3)
            row["kernel_device_us"] = {k: us / c for k, (us, c) in dev_k.items()}
            row["kernel_device_launches"] = {k: c for k, (_, c) in dev_k.items()}
            for key in ("ffn_fwd", "ffn_bwd"):
                row[f"{key}_over_library"] = (float(np.mean(row[f"{key}_kernel_ms"]))
                                              / float(np.mean(row[f"{key}_library_ms"])))
            if dtype == torch.bfloat16:
                row["tile_shapes_device_us"] = ffn_tile_shapes(dev, args, dy, seed, rate)
            timings.append(row)
            del leaves, ref_out, lib, lib_out, ln_leaves, ln_ref, ln_lib, ln_lib_out, fns
    emit({"phase": "ffn_ln_kernels", "checks": checks,
          "bars": {"float32": "1e-4 abs (out, h); 1e-4 * max|grad| (grads)",
                   "bfloat16": "2e-2 * max|ref|",
                   "kept_share": "max(2e-3, 5 sigma) of the quantised keep rate, sigma "
                                 "from the ReLU's live units (5 sigma only at the ragged "
                                 "shape's ~10,000)"},
          "library": "F.linear, relu, F.dropout, F.linear and autograd's backward; "
                     "F.layer_norm(x + F.dropout(y)) and autograd's backward",
          "timings": timings,
          "ln_resources": {"ptxas": kernel_resources("fused_ln"),
                           "ln_bwd_dynamic_smem_bytes": {
                               f"d {d} {str(t)[6:]}": ln.bwd_smem_bytes(d, t)
                               for d in (72, 256, 1024) for t in (torch.float32, torch.bfloat16)},
                           "grids_bf16": {f"rows {rows} d {d}": ln_grids(dev, rows, d)
                                          for rows, d in ((1024, 256), (16384, 256),
                                                          (4096, 1024))}}})
    return {"max_abs_err": worst, "timings": timings}


@contextlib.contextmanager
def ffn_as(role: str, kernel_h: list, kinks: list):
    """A stand-in for the model's ``ffn_train``, as ``fused_layers_as`` is for
    the layer functions: as ``"kernel"`` every call also records the kernel's
    h; as ``"plain"`` the plain version runs in place of the kernels and takes
    the kernel's side of the ReLU's kink at the units ``kink_flips`` finds
    within rounding of 0. Any other role leaves the model as it is."""
    train, replay = transformer.ffn_train, iter(kernel_h)

    def recording(*a):
        kernel_h.append(ffn.ffn_forward(*[t.detach() for t in a[:6]], a[6])[1])
        return train(*a)

    def replaying(*a):
        with torch.no_grad():
            own_h = ffn.ffn_reference(*[t.detach() for t in a[:6]], a[6], return_hidden=True)[1]
        flips, kink = fl.kink_flips(own_h, next(replay).to(own_h.device))
        kinks.append(kink["flips"])
        return ffn.ffn_reference(*a, relu_flips=flips)

    transformer.ffn_train = {"kernel": recording, "plain": replaying}.get(role, train)
    try:
        yield
    finally:
        transformer.ffn_train = train


def reconfigure(bundle, **switches) -> None:
    """Flip training switches of a model in place (they change no parameter):
    a model takes up to seconds to initialise on the host (GrooveXL has 151 M
    parameters), so the variants of one comparison share one."""
    cfg = dataclasses.replace(bundle.config, **switches)
    for m in bundle.model.modules():
        if hasattr(m, "config"):
            m.config = cfg
    bundle.config = cfg


def phase_train_wide(dev, rng) -> dict:
    """The slice's main path: the InfillingRandomLow_lm config (d 256, ff 2048,
    8 layers, dropout 0.16, batch 32; nothing cut) through ``initialize_model``
    + ``train_loop``: the whole-layer gate rejects ff 2048, and the layers take
    their unfused path with the FFN kernels in it; then with the LN kernels,
    then rematerialised, then a 1 + 1 layer encoder-decoder model."""
    data, held = Loops(1024, 41), Loops(256, 42)
    batch, epochs, n_layers = LM_HP["batch_size"], 2, LM_HP["num_encoder_decoder_layers"]
    penalty = LM_HP["hit_loss_penalty"]
    per_epoch = len(data.processed_inputs) // batch
    steps = epochs * per_epoch
    bundle, _, _ = initialize_model(lm_params(), dev)
    cfg = bundle.config
    check(cfg.fused_ffn and not cfg.fused_layer and not cfg.remat and not cfg.fused_dropout_ln
          and cfg.compute_dtype == torch.bfloat16,
          f"the wide config did not take the FFN kernels alone in bf16: {cfg}")
    check(not resolve_fused_ffn(None, LM_HP["dim_feedforward"], LM_HP["d_model"], torch.bfloat16,
                                dev), "fused_ffn's auto is on at the lm config")
    reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    metrics = run_epochs(bundle, data, held, epochs, batch, penalty=penalty)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches(NEW_KERNELS)  # ... and ends here
    lm_rows, d, ff = batch * 32, LM_HP["d_model"], LM_HP["dim_feedforward"]
    want = {**ffn_launches(lm_rows, d, ff, torch.bfloat16, steps * n_layers),
            **{k: 0 for k in ln.KERNELS}}
    check(counts == want and not any(launches(LAYER_KERNELS).values()),
          f"wide-FFN training launched {counts}, expected {want} ({steps} steps x {n_layers} "
          f"layers), and the layer kernels {launches(LAYER_KERNELS)}")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(v) for m in metrics for v in m.values()), f"non-finite: {metrics}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    # the same with every LN(x + dropout(y)) site through the LN kernels: the
    # LN kernels' main path
    ln_bundle, _, _ = initialize_model(lm_params(fused_dropout_ln=True), dev)
    reset_launches()  # the LN kernels' main path starts here
    ln_losses = [m["loss"] for m in run_epochs(ln_bundle, data, held, 2, batch, penalty=penalty)]
    ln_counts = launches(NEW_KERNELS)  # ... and ends here
    want = {**ffn_launches(lm_rows, d, ff, torch.bfloat16, 2 * per_epoch * n_layers),
            **{k: 2 * per_epoch * 2 * n_layers for k in ln.KERNELS}}
    check(ln_counts == want, f"with fused_dropout_ln: launched {ln_counts}, expected {want}")
    check(all(np.isfinite(ln_losses)) and ln_losses[-1] < ln_losses[0],
          f"with fused_dropout_ln the loss did not fall: {ln_losses}")
    # a step's device launches: one ln_bwd a backward site and nothing else of
    # the LN's (dscale and dbias are summed inside it; the design before it
    # launched a sum of its partials as well)
    ln_step = step_breakdown(ln_bundle, batch, 48, count=("ln_fwd", "ln_bwd", "reduce"))
    sites = 2 * n_layers
    check(ln_step["launches_per_step_of"]["ln_fwd"] <= sites
          and ln_step["launches_per_step_of"]["ln_bwd"] <= sites,
          f"the LN path's step launched {ln_step['launches_per_step_of']}, more than "
          f"{sites} of each LN kernel")

    # rematerialised: every layer's forward runs again in the backward
    remat_bundle, _, _ = initialize_model(lm_params(remat=True), dev)
    reset_launches()
    remat_losses = [m["loss"] for m in
                    run_epochs(remat_bundle, data, held, 2, batch, penalty=penalty)]
    remat_counts = launches(ffn.KERNELS)
    want = ffn_launches(lm_rows, d, ff, torch.bfloat16, 2 * per_epoch * n_layers, 2)
    check(remat_counts == want, f"with remat: launched {remat_counts}, expected {want}")
    check(all(np.isfinite(remat_losses)) and remat_losses[-1] < remat_losses[0],
          f"with remat the loss did not fall: {remat_losses}")

    # one step's gradients with and without remat, at dropout 0.16: equal only
    # if the recompute replays the forward's masks
    x = torch.from_numpy(data.processed_inputs[:batch]).to(dev)
    y = torch.from_numpy(data.processed_outputs[:batch]).to(dev)
    grads = {}
    probe, _, _ = initialize_model(lm_params(), dev)
    probe.model.train()
    for name, switches in (("plain", {}), ("remat", dict(remat=True)),
                           ("remat_dots", dict(remat=True, remat_policy="dots")),
                           ("remat_ln", dict(remat=True, fused_dropout_ln=True)),
                           ("plain_ln", dict(fused_dropout_ln=True))):
        reconfigure(probe, remat=False, remat_policy=None, fused_dropout_ln=False)
        reconfigure(probe, **switches)
        probe.model.zero_grad(set_to_none=True)
        pred = probe.model(x, generator=torch.Generator(dev).manual_seed(5))
        calculate_loss(pred, y, penalty).total_loss.backward()
        grads[name] = [p.grad for p in probe.model.parameters()]
    remat_err = {}
    for name, other in (("remat", "plain"), ("remat_dots", "plain"), ("remat_ln", "plain_ln")):
        top = max(float(g.abs().max()) for g in grads[other])
        remat_err[name] = {
            "max_abs_err": max(max_err(a, g) for a, g in zip(grads[name], grads[other])),
            "max_abs_grad": top,
            "bitwise": all(torch.equal(a, g) for a, g in zip(grads[name], grads[other]))}
        check(remat_err[name]["max_abs_err"] <= 1e-6 * top,
              f"gradients with {name} differ from {other}: {remat_err[name]}")
    del grads, probe

    # peak memory of a step at batch 512, with and without remat
    big = Loops(1024, 43)
    peak = {}
    for name, b in (("plain", bundle), ("remat", remat_bundle)):
        seqs_per_s(b, big, 512)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        seqs_per_s(b, big, 512)
        peak[name] = {"peak_bytes": torch.cuda.max_memory_allocated(),
                      "over_resident_bytes": torch.cuda.max_memory_allocated() - base}
    check(peak["remat"]["over_resident_bytes"] < peak["plain"]["over_resident_bytes"],
          f"remat did not lower the step's peak memory: {peak}")

    # 3 f32 steps at dropout 0: the kernel path against the plain-version path
    # (the kernel's side of a ReLU kink, ``ffn_as``) and against fused_ffn=False
    kernel_h, kinks, three = [], [], {}
    x = torch.from_numpy(data.processed_inputs[:96]).to(dev)
    y = torch.from_numpy(data.processed_outputs[:96]).to(dev)
    reset_launches()  # the f32 route's path: its kernels launch here only
    for name in ("kernel", "plain", "unfused"):
        b, _, _ = initialize_model(
            lm_params(bf16=False, dropout=0.0, fused_ffn=name != "unfused"), dev)
        epoch_fn = make_epoch_fn(penalty, 32, 96, shuffle=False)
        with ffn_as(name, kernel_h, kinks):
            epoch_fn(b.state, x, y, torch.Generator(dev).manual_seed(0))
        check(b.state.step == 3, f"{name}: {b.state.step} steps, expected 3")
        three[name] = {k: v.detach().cpu() for k, v in b.model.state_dict().items()}
    f32_counts = launches(ffn.F32_KERNELS)  # the forward twice a call: ffn_as records h
    check(f32_counts == {k: v for k, v in ffn_launches(32 * 32, d, ff, torch.float32,
                                                       3 * n_layers, 2).items()
                         if k in ffn.F32_KERNELS}
          and not any(launches(ffn.BF16_KERNELS).values()),
          f"3 f32 steps launched {launches(ffn.KERNELS)}")
    param_err = {other: max(max_err(three["kernel"][k], three[other][k]) for k in three["kernel"])
                 for other in ("plain", "unfused")}
    check(param_err["plain"] <= 1e-4 and param_err["unfused"] <= UNFUSED_BAR,
          f"3 f32 steps: params differ by {param_err} (kink flips per FFN call: {kinks})")

    # a 1 + 1 layer encoder-decoder model at the same width, FFN and LN kernels
    # in both layers
    small = Loops(128, 44)
    encdec, _, _ = initialize_model(
        lm_params(num_encoder_layers=1, num_decoder_layers=1, fused_dropout_ln=True), dev)
    check(encdec.config.fused_ffn and not encdec.config.fused_layer
          and not encdec.config.fused_decoder_layer, f"1 + 1 model's switches: {encdec.config}")
    reset_launches()
    encdec_losses = [m["loss"] for m in
                     run_epochs(encdec, small, held, 3, batch, encoder_only=0, penalty=penalty)]
    encdec_counts = launches(NEW_KERNELS)
    encdec_steps = 3 * (128 // batch)
    want = {**ffn_launches(lm_rows, d, ff, torch.bfloat16, encdec_steps * 2),
            **{k: encdec_steps * 5 for k in ln.KERNELS}}
    check(encdec_counts == want, f"1 + 1 model launched {encdec_counts}, expected {want}")
    check(all(np.isfinite(encdec_losses)) and encdec_losses[-1] < encdec_losses[0],
          f"1 + 1 model's loss did not fall: {encdec_losses}")

    # throughput: fused_ffn on and off, then with the LN kernels, then with
    # remat on and off, in turns; 16 steps at batch 32, 4 at batch 512
    models = {"fused_ffn": bundle, "unfused": initialize_model(lm_params(fused_ffn=False), dev)[0],
              "fused_ffn_ln": ln_bundle, "fused_ffn_remat": remat_bundle,
              "unfused_remat": initialize_model(lm_params(fused_ffn=False, remat=True), dev)[0],
              "fused_layer": initialize_model(lm_params(fused_layer=True), dev)[0]}
    check(models["fused_layer"].config.fused_layer, "fused_layer=True was not kept")
    reset_launches()
    throughput, breakdown = {}, {}
    for b in THROUGHPUT_BATCHES:
        corpus, warm = Loops(512 if b == 32 else 2048, 45), Loops(2 * b, 46)
        runs = {k: [] for k in models}
        for which in [*models, *reversed(models)]:
            seqs_per_s(models[which], warm, b)
            runs[which].append(seqs_per_s(models[which], corpus, b))
        throughput[b] = runs
        breakdown[b] = step_breakdown(bundle, b, 47)
    layer_counts = launches(fl.SM90_KERNELS)
    check(len(set(layer_counts.values())) == 1 and min(layer_counts.values()) > 0,
          f"the forced whole-layer path launched {layer_counts}")
    emit({"phase": "train_wide_ffn", "config": LM_HP, "data": "1024 seeded synthetic loops",
          "epochs": epochs, "steps": steps, "seconds": seconds, "launches": counts,
          "losses": losses, "last_metrics": metrics[-1],
          "fused_dropout_ln": {"launches": ln_counts, "losses": ln_losses,
                               "step_breakdown_batch_32": ln_step},
          "remat": {"launches": remat_counts, "losses": remat_losses,
                    "one_step_gradients_vs_unrematerialised": remat_err,
                    "step_memory_batch_512": peak},
          "three_f32_steps_param_err": param_err, "three_f32_steps_kink_flips": kinks,
          "three_f32_steps_launches": f32_counts,
          "unfused_bar": UNFUSED_BAR,
          "encoder_decoder_1_plus_1": {"steps": encdec_steps, "launches": encdec_counts,
                                       "losses": encdec_losses},
          "seqs_per_s": throughput, "step_breakdown": breakdown,
          "fused_layer_launches_in_its_turns": layer_counts})
    return {"launches": counts, "ln_launches": ln_counts, "encdec_launches": encdec_counts,
            "f32_launches": f32_counts}


def phase_train_groovexl(dev, rng) -> dict:
    """GrooveXL (d 1024, 8 heads, ff 4096, 12 layers, dropout 0.1, batch 128,
    bf16, remat on; nothing cut but the number of steps) through
    ``initialize_model`` + ``make_epoch_fn``."""
    hp = XL_HP
    n_layers, batch = hp["num_encoder_layers"], hp["batch_size"]
    params = {"model": {k: hp[k] for k in ("d_model", "n_heads", "dim_feedforward", "dropout",
                                           "num_encoder_layers", "remat", "optimizer",
                                           "fused_ffn")},
              "training": {"learning_rate": hp["learning_rate"], "batch_size": batch, "seed": 0}}
    t0 = time.perf_counter()
    bundle, _, _ = initialize_model(params, dev)
    init_seconds = time.perf_counter() - t0
    cfg = bundle.config
    check(cfg.fused_ffn and cfg.remat and not cfg.fused_layer
          and cfg.compute_dtype == torch.bfloat16, f"GrooveXL's switches: {cfg}")
    auto_remat = resolve_remat(None, d_model=hp["d_model"], n_heads=hp["n_heads"],
                               dim_feedforward=hp["dim_feedforward"], n_layers=n_layers,
                               batch_size=batch, compute_dtype=torch.bfloat16, device=dev)
    n = 4 * batch  # scripts/bench_groovexl_ffn.py's corpus: 4 steps an epoch
    data = Loops(n, 51)
    x = torch.from_numpy(data.processed_inputs).to(dev)
    y = torch.from_numpy(data.processed_outputs).to(dev)
    epoch_fn = make_epoch_fn(hp["hit_loss_penalty"], batch, n)
    gen = torch.Generator(dev).manual_seed(0)
    one_step = make_epoch_fn(hp["hit_loss_penalty"], batch, batch)  # warm-ups, breakdown
    epochs, steps = 2, 2 * 4
    reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    metrics = [fetch(epoch_fn(bundle.state, x, y, gen)) for _ in range(epochs)]
    seconds = time.perf_counter() - t0
    counts = launches(NEW_KERNELS)  # ... and ends here
    xl_rows = batch * 32
    want = {**ffn_launches(xl_rows, hp["d_model"], hp["dim_feedforward"], torch.bfloat16,
                           steps * n_layers, 2),
            **{k: 0 for k in ln.KERNELS}}
    check(counts == want, f"GrooveXL launched {counts}, expected {want} ({steps} steps x "
                          f"{n_layers} layers, the forward twice under remat)")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(v) for m in metrics for v in m.values()), f"non-finite: {metrics}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    def epoch_rate(epochs: int = 2) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(epochs):
            fetch(epoch_fn(bundle.state, x, y, gen))
        return epochs * n / (time.perf_counter() - t0)

    def step_peak() -> dict:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fetch(epoch_fn(bundle.state, x, y, gen))
        return {"peak_bytes": torch.cuda.max_memory_allocated(),
                "over_resident_bytes": torch.cuda.max_memory_allocated() - base}

    peak = {"remat": step_peak()}
    reconfigure(bundle, remat=False)
    before = launches(ffn.KERNELS)
    peak["plain"] = step_peak()
    no_remat_counts = {k: v - before[k] for k, v in launches(ffn.KERNELS).items()}
    check(no_remat_counts == ffn_launches(xl_rows, hp["d_model"], hp["dim_feedforward"],
                                          torch.bfloat16, 4 * n_layers),
          f"GrooveXL without remat launched {no_remat_counts} in 4 steps")
    check(peak["remat"]["over_resident_bytes"] < peak["plain"]["over_resident_bytes"],
          f"remat did not lower GrooveXL's peak memory: {peak}")
    rates = {"fused_ffn_remat": [], "unfused_remat": [], "fused_ffn": [], "unfused": []}
    for which in [*rates, *reversed(rates)]:
        reconfigure(bundle, fused_ffn=which.startswith("fused_ffn"),
                    remat=which.endswith("remat"))
        fetch(one_step(bundle.state, x[:batch], y[:batch], gen))
        rates[which].append(epoch_rate())
    reconfigure(bundle, fused_ffn=True, remat=True)
    per_kernel = device_us(lambda: fetch(one_step(bundle.state, x[:batch], y[:batch], gen)), n=2)
    total = sum(us for us, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "train_groovexl", "config": hp, "auto_remat_on_this_card": auto_remat,
          "parameters": sum(p.numel() for p in bundle.model.parameters()),
          "initialize_model_seconds": init_seconds, "data": f"{n} seeded synthetic loops",
          "epochs": epochs, "steps": steps, "seconds": seconds, "launches": counts,
          "losses": losses, "last_metrics": metrics[-1], "step_memory": peak,
          "seqs_per_s": rates,
          # each turn's pair of paths ran back to back
          "fused_over_unfused": {
              "remat": [a / b for a, b in zip(rates["fused_ffn_remat"], rates["unfused_remat"])],
              "plain": [a / b for a, b in zip(rates["fused_ffn"], rates["unfused"])]},
          "step_breakdown": {"step_device_ms": total / 1e3,
                             "launches_per_step": sum(c for _, c in per_kernel.values()),
                             "top_kernels_us_per_step": {k: us for k, (us, _) in top}}})
    return {"launches": counts}


class StopAfterBlocks(_GracefulStop):
    """``run_training``'s ``_stopper`` hook: a stop requested at the end of
    block ``blocks`` (the loop reads ``requested`` once a block)."""

    def __init__(self, blocks: int):
        super().__init__()
        self._reads, self._blocks = 0, blocks

    @property
    def requested(self):
        self._reads += 1
        return self._reads >= self._blocks

    @requested.setter
    def requested(self, value):
        pass


def train_run(hp, data, dev, root, name, augment, bundle=None, initial_epoch=0, stopper=None):
    """``run_training`` logging into its own run directory under ``root`` →
    (bundle, metrics.jsonl's records, checkpoint directory)."""
    xlog.init(run_dir=os.path.join(root, "runs", name))
    run_dir, ckpt_dir = xlog.run.dir, os.path.join(root, name)
    try:
        bundle = run_training(hp, data, device=dev, bundle=bundle, initial_epoch=initial_epoch,
                              ckpt_dir=ckpt_dir, on_device_augment=augment,
                              watch_log_freq=CKPT_WATCH_FREQ, _stopper=stopper)
    finally:
        xlog.finish()
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return bundle, [json.loads(line) for line in f], ckpt_dir


def resumed_run(hp, data, dev, root, name, augment, stop_after: int) -> dict:
    """``hp.epochs`` epochs uninterrupted against ``stop_after`` blocks, a stop,
    a fresh ``initialize_model(load_model=...)`` and the rest: parameters and
    the last block's metrics must be equal bit for bit."""
    reset_launches()  # the main path's run starts here
    reset_front_end_launches()
    full, full_lines, _ = train_run(hp, data, dev, root, f"{name}_full", augment)
    counts = {**launches(fl.SM90_KERNELS), "band_energies": BAND_K.launches,
              "device_synth": SYNTH_K.launches}  # ... and ends here
    _, stopped_lines, stopped_dir = train_run(hp, data, dev, root, f"{name}_stopped", augment,
                                              stopper=StopAfterBlocks(stop_after))
    check([r["epoch"] for r in stopped_lines] == list(range(stop_after)),
          f"{name}: the stopped run logged epochs {[r['epoch'] for r in stopped_lines]}")
    spec = hp.to_dict()
    params = model_params({**FLAGSHIP_HP, **spec, "load_model": {"dir": stopped_dir}})
    bundle, _opt, initial = initialize_model(params, dev)
    check(initial == stop_after and bundle.config == full.config,
          f"{name}: resumed at epoch {initial} with {bundle.config}")
    resumed, resumed_lines, _ = train_run(hp, data, dev, root, f"{name}_resumed", augment,
                                          bundle=bundle, initial_epoch=initial)
    torch.cuda.synchronize()
    unequal = [k for (k, a), b in zip(full.model.state_dict().items(),
                                      resumed.model.state_dict().values())
               if not torch.equal(a, b)]
    check(not unequal, f"{name}: resumed parameters differ from the uninterrupted run's: "
                       f"{unequal[:4]}")
    keys = ("loss", "grad_norm", "hit_accuracy", "hit_perplexity", "bce_hits",
            "mse_velocities", "mse_offsets")
    differ = {k: (full_lines[-1][k], resumed_lines[-1][k]) for k in keys
              if full_lines[-1][k] != resumed_lines[-1][k]}
    check(not differ and full_lines[-1]["epoch"] == resumed_lines[-1]["epoch"],
          f"{name}: the last block's metrics differ: {differ}")
    return {"full": full, "last_metrics": {k: full_lines[-1][k] for k in keys},
            "losses": [r["loss"] for r in full_lines], "records": full_lines, "counts": counts}


def save_costs(state, config, root: str, name: str) -> dict:
    """What a save costs the training thread, synchronous (fetch, serialise,
    write on the caller) and by snapshot (a device copy and a queued job),
    the save worker's seconds, the file's size and the restore's seconds
    (read and parse the file, map it to the state dict, load that into a
    model on the card; the model is built before the clock starts)."""
    sync_dir, async_dir = os.path.join(root, f"{name}_sync"), os.path.join(root, f"{name}_async")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(sync_dir, name, 0, state, 1.0, config)
    sync_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save_snapshot_async(async_dir, name, 0, ckpt.snapshot_state_on_device(state), 1.0,
                             config)
    held_s = time.perf_counter() - t0
    ckpt.flush_async_saves()
    worker_s = time.perf_counter() - t0
    model = build_model(config, next(state.model.parameters()).device)
    ckpt._blob_cache.clear()  # a restore that parses the file
    t0 = time.perf_counter()
    params, opt_state, epoch = ckpt.restore({"dir": async_dir}, config)
    model.load_state_dict(torch_compat.state_dict_from_flax_params(params, config), strict=True)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    live = state.model.state_dict()
    check(epoch == 1 and all(torch.equal(model.state_dict()[k], v) for k, v in live.items()),
          f"{name}: the restored weights differ from the saved ones")
    with open(path, "rb") as a, open(os.path.join(async_dir, os.path.basename(path)), "rb") as b:
        check(a.read() == b.read(), f"{name}: the snapshot file differs from the sync file")
    return {"ckpt_bytes": os.path.getsize(path),
            "parameters": sum(v.numel() for v in live.values()),
            "sync_save_held_s": sync_s, "snapshot_save_held_s": held_s,
            "save_worker_s": worker_s, "restore_s": restore_s}


def phase_checkpoint(dev, rng, smi: str) -> dict:
    """20. save, resume, serve: ``run_training`` at the flagship width from
    the YAML (read on the card by the port's reader), 512 loops rendered by
    the audio augment inside every epoch, 4 epochs in blocks of 1, a save
    after each, watch histograms every 32 steps; 2 + 2 epochs with a stop and
    a resume equal to it bit for bit, and Adam 1 + 1 against 2; the newest
    ``.ckpt`` served by ``serve.main`` with no architecture flags; what a
    save and a restore cost at the flagship and at GrooveXL width."""
    import tempfile

    yaml_hp = load_hyperparameters(os.path.join(ROOT, "configs", "InfillingRandom_training.yaml"))
    check(yaml_hp.to_dict() == HyperParams.from_dict(FLAGSHIP_HP).to_dict(),
          "the YAML read on the card differs from FLAGSHIP_HP")
    hp = HyperParams.from_dict({**yaml_hp.to_dict(), "epochs": CKPT_EPOCHS})
    grids = Loops(CKPT_LOOPS, 28).processed_outputs
    qpms = np.random.default_rng(29).uniform(90.0, 150.0, CKPT_LOOPS)
    augment = make_on_device_augment(qpms=qpms, mode="audio")

    class Grids:
        processed_inputs = processed_outputs = grids

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        sgd = resumed_run(hp, Grids, dev, root, "sgd", augment, stop_after=2)
        counts = sgd["counts"]  # the uninterrupted run's
        steps = CKPT_EPOCHS * (CKPT_LOOPS // hp.batch_size)
        watches = steps // CKPT_WATCH_FREQ
        renders = CKPT_EPOCHS * -(-CKPT_LOOPS // ds.DEFAULT_CHUNK) + watches
        want = {**{k: (steps + watches) * hp.num_encoder_decoder_layers
                   for k in fl.SM90_KERNELS},
                "band_energies": renders, "device_synth": renders}
        check(counts == want, f"the checkpointed run launched {counts}, expected {want}")
        check(all(np.isfinite(v) for v in sgd["last_metrics"].values()),
              f"non-finite metrics: {sgd['last_metrics']}")
        check(sgd["losses"][-1] < sgd["losses"][0], f"loss did not fall: {sgd['losses']}")
        watch_lines = sum(any(k.startswith("gradients/") for k in r) for r in sgd["records"])
        check(watch_lines == watches, f"{watch_lines} records hold watch histograms, "
                                      f"expected {watches}")
        adam_hp = HyperParams.from_dict({**hp.to_dict(), "optimizer_algorithm": "adam",
                                         "learning_rate": 1e-3, "epochs": 2})
        adam = resumed_run(adam_hp, Grids, dev, root, "adam", augment, stop_after=1)

        # serve the newest .ckpt of the uninterrupted run: the file carries
        # the architecture (and the run's bf16), so no flags
        ckpt_dir = os.path.join(root, "sgd_full")
        trained = sgd["full"]
        sd_live = {k: v.detach().cpu() for k, v in trained.model.state_dict().items()}
        memory_srv = serve.InfillServer(sd_live, trained.config, batch_sizes=(1,), device=dev)
        x = rng.standard_normal((1, 32, 16)).astype(np.float32)
        grid = (rng.random((32, 27)) < 0.25).astype(np.float32)
        httpd = serve.main(["--ckpt", ckpt_dir, "--port", "0", "--batch-sizes", "1"],
                           block=False)
        try:
            MHA.launches = 0  # the serving path's run starts here
            reset_front_end_launches()
            code, mso_reply = post(httpd.server_address[1], {"input": x.tolist()})
            mso_launches = MHA.launches
            code2, hvo_reply = post(httpd.server_address[1],
                                    {"hvo_input": grid.tolist(), "qpm": 120})
            serve_counts = {"fused_mha": MHA.launches, "band_energies": BAND_K.launches,
                            "device_synth": SYNTH_K.launches}  # ... and ends here
        finally:
            httpd.shutdown()
            httpd.server_close()
        check(code == 200 and code2 == 200, f"the served .ckpt answered {code}, {code2}")
        check(mso_launches == 6 and serve_counts == {"fused_mha": 12, "band_energies": 1,
                                                     "device_synth": 1},
              f"serving the .ckpt launched {mso_launches} then {serve_counts}")
        mso_y = np.asarray(mso_reply["hvo"], np.float32)
        hvo_y = np.asarray(hvo_reply["hvo"], np.float32)
        check(np.array_equal(mso_y.reshape(1, 32, 27), memory_srv.infill(x))
              and np.array_equal(hvo_y, memory_srv.infill_from_hvo(grid, qpm=120)),
              "the served .ckpt answers unlike the in-memory model's server")
        # the serving bar on the loaded weights: an f32 server on the card
        # against the in-memory model's plain path on the CPU
        loaded, cfg, epoch, _loss = ckpt.load_params_and_config(ckpt_dir)
        check(epoch == CKPT_EPOCHS - 1 and cfg == trained.config,
              f"the newest .ckpt is epoch {epoch} with {cfg}")
        f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
        y32 = serve.InfillServer(loaded, f32, batch_sizes=(1,), device=dev).infill(x)[0]
        cpu_model = build_model(f32, "cpu")
        cpu_model.load_state_dict(sd_live, strict=True)
        _h, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(x))
        serve_err = max(max_err(y32[:, 9:18], v_cpu[0]), max_err(y32[:, 18:], o_cpu[0]))
        check(serve_err <= 1e-4, f"the loaded weights served in f32 vs the CPU plain path: "
                                 f"{serve_err}")

        costs = {"flagship": save_costs(trained.state, trained.config, root, "flagship")}
        xl_cfg = GrooveTransformerConfig(
            d_model=XL_HP["d_model"], n_heads=XL_HP["n_heads"],
            dim_feedforward=XL_HP["dim_feedforward"], dropout=XL_HP["dropout"],
            num_encoder_layers=XL_HP["num_encoder_layers"], compute_dtype=torch.bfloat16)
        xl_state = create_train_state(xl_cfg, "sgd", XL_HP["learning_rate"], 0, dev)
        costs["groovexl"] = save_costs(xl_state, xl_cfg, root, "groovexl")
        del xl_state
    torch.cuda.empty_cache()
    emit({"phase": "checkpoint", "card": smi, "config": hp.to_dict(),
          "data": f"{CKPT_LOOPS} seeded synthetic loops, 90-150 bpm, audio augment",
          "launches": counts, "losses": sgd["losses"], "last_metrics": sgd["last_metrics"],
          "resume": "bit for bit (SGD 2 + 2 against 4, Adam 1 + 1 against 2)",
          "adam_last_metrics": adam["last_metrics"], "serving_launches": serve_counts,
          "served_max_abs_err_f32_vs_cpu_plain": serve_err, "save_costs": costs})
    return {"launches": counts, "serving_launches": serve_counts, "save_costs": costs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    took = {}

    def timed_phase(fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        torch.cuda.synchronize()
        took[fn.__name__.removeprefix("phase_")] = time.perf_counter() - t0
        print(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        return result

    name, smi = timed_phase(phase_device)
    timed_phase(phase_build)
    kernel = timed_phase(phase_kernel, dev, rng)
    torch.manual_seed(0)  # seeded random flagship weights
    sd = build_model(FLAGSHIP, "cpu").state_dict()
    srv, plain, raw, launches_mha = timed_phase(phase_serve, dev, rng, sd)
    timed_phase(phase_http, dev, rng, sd, srv, raw)
    timed_phase(phase_demo, rng)
    timed_phase(phase_latency, dev, srv, plain)
    layer = timed_phase(phase_layer, dev, rng)
    train = timed_phase(phase_train, dev, rng)
    front = timed_phase(phase_front_end_kernels, dev, rng)
    timed_phase(phase_front_end, dev, rng)
    hvo = timed_phase(phase_serve_hvo, dev, rng, sd, srv)
    augmented = timed_phase(phase_train_augment, dev, rng)
    dec_layer = timed_phase(phase_decoder_layer, dev, rng)
    encdec = timed_phase(phase_train_encdec, dev, rng)
    served_encdec = timed_phase(phase_serve_encdec, dev, rng, srv)
    ffn_ln = timed_phase(phase_ffn_ln, dev, rng)
    wide = timed_phase(phase_train_wide, dev, rng)
    xl = timed_phase(phase_train_groovexl, dev, rng)
    saved = timed_phase(phase_checkpoint, dev, rng, smi)
    emit({"phase_seconds": took})
    def mha_row(b, dtype, form="contiguous"):
        return next(t for t in kernel["timings"]
                    if t["shape"] == [b, 2, 32, 128] and t["dtype"] == dtype and t["form"] == form)

    def mha_at(row):
        return {"ms": float(np.mean(row["kernel_us"])) / 1000.0,
                "device_ms": row["kernel_device_us"] / 1000.0,
                "plain_ms": float(np.mean(row["plain_us"])) / 1000.0,
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": float(np.mean(row["sdpa_us"])) / 1000.0,
                "library_device_ms": row["sdpa_device_us"] / 1000.0}

    b1 = mha_row(1, "float32")
    kernels = [{
        "name": "fused_mha", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches_mha,
        "launches_hvo_input_path": hvo["launches"]["fused_mha"],
        "launches_checkpoint_serving_path": saved["serving_launches"]["fused_mha"],
        "launches_encdec_serving_path": served_encdec["launches"],
        "max_abs_err": kernel["max_abs_err"], **mha_at(b1),
        **{f"B{b}_{dtype}_{form}": mha_at(mha_row(b, dtype, form))
           for b, dtype in ((1, "float32"), (512, "float32"), (512, "bfloat16"), (1, "bfloat16"))
           for form in MHA_FORMS if (b, dtype, form) != (1, "float32", "contiguous")},
        "at": "B 1, H 2, T 32, hd 128, float32, contiguous; ms: stream time; device_ms: the "
              "profiler's per launch; err over all f32 checks; library: "
              "scaled_dot_product_attention on the same views"}]

    def timing(phase_out, b, dtype):
        return next(t for t in phase_out["timings"] if t["B"] == b and t["dtype"] == dtype)

    # per layer: the phase, its module, its sources, the f32 kernels' bounds,
    # the main path's launches and the forward's launch count
    layers = (("encoder", layer, fl, LAYER_SOURCE, LAYER_TPU_KERNELS, layer_bounds, train, 5,
               {"launches_audio_augment_path": augmented["launches"],
                "launches_encdec_training_path": encdec["launches"],
                "launches_checkpoint_path": saved["launches"]}),
              ("decoder", dec_layer, fdl, DEC_SOURCE, DEC_TPU_KERNELS, decoder_layer_bounds,
               encdec, 9, {}))
    for which, out, mod, source, tpu, bounds_of, path, n_fwd, more in layers:
        f32_32, bounds32 = timing(out, 32, "float32"), bounds_of(32, "float32")
        fwd_key, bwd_key = list(tpu)[0], list(tpu)[1]
        for kname, k in mod.KERNELS.items():
            # mean per captured launch (the profiler may lose events)
            device_ms = sum(us / f32_32["kernel_device_launches"][name]
                            for name, us in f32_32["kernel_device_us"].items()
                            if k.entry.removeprefix("tgi_") in name) / 1000.0
            part = "fwd" if kname.endswith("fwd") else "bwd"
            library = f32_32["library"]
            kernels.append({
                "name": kname, "route": "cuda", "source": source, "replaces": tpu[kname],
                "launches": path["f32_launches"][kname],
                "max_abs_err": out["max_abs_err"][torch.float32], "ms": device_ms,
                "plain_ms": float(np.mean(f32_32[f"{part}_plain_ms"])),
                "bound_ms": bounds32[kname]["bound_ms"],
                "bound_by": bounds32[kname]["bound_by"],
                "library_ms": float(np.mean(library[f"{part}_ms"])),
                "library_device_ms": library[f"{part}_device_ms"],
                "at": f"the {which} layer's f32 route: B 32, T 32, d 256, 2 heads, ff 512, "
                      "float32, rate 0.30; launches: the 3 f32 training steps (the forward "
                      "twice a call there); ms: device time per call; plain_ms: the twin's "
                      "whole forward (fwd) or autograd backward (both backward kernels) on "
                      "the stream; library: nn.Transformer"
                      f"{which.title()}Layer in f32, its forward (fwd) or autograd backward "
                      "(both backward kernels), on the stream and as device time; err: the "
                      "largest over the f32 layer checks"})
        at32, at512 = timing(out, 32, "bfloat16"), timing(out, 512, "bfloat16")
        for i, kname in enumerate(mod.SM90_KERNELS):
            l32, l512 = at32["launches"][kname], at512["launches"][kname]
            kernels.append({
                "name": kname, "route": "cuda", "source": LAYER_SM90_SOURCE,
                "replaces": tpu[fwd_key if i < n_fwd else bwd_key],
                "launches": path["launches"][kname],
                **{key: counts[kname] for key, counts in more.items()},
                "max_abs_err": max(l32["max_abs_err"], l512["max_abs_err"]),
                "ms": l32["device_ms"], "plain_ms": l32["plain_ms"],
                "bound_ms": l32["bound_ms"], "bound_by": l32["bound_by"],
                "library_ms": l32["library_ms"],
                "B512": {"ms": l512["device_ms"], "bound_ms": l512["bound_ms"],
                         "bound_by": l512["bound_by"]},
                "layer_B32": {"fwd_device_ms": at32["kernel_fwd_device_ms"],
                              "bwd_device_ms": at32["kernel_bwd_device_ms"],
                              "io_bounds_ms": {k: v["bound_ms"]
                                               for k, v in at32["io_bounds"].items()},
                              "library_fwd_device_ms": at32["library"]["fwd_device_ms"],
                              "library_bwd_device_ms": at32["library"]["bwd_device_ms"]},
                "at": f"the {which} layer's bf16 chain: B 32 (B512: batch 512), T 32, d 256, "
                      "2 heads, ff 512, rate 0.30; ms: device time per launch (profiler); "
                      "plain_ms: its plain version on the stream; bound: this launch's own "
                      "bytes and operations; library: F.linear (bias products) or one matmul "
                      "(products without residual), else none; err: the largest over every "
                      "output at B 32 and 512, each held to 2e-2 of its largest value; "
                      "layer_B32: the whole layer, the bound from its own inputs, weights "
                      f"and outputs, the library call nn.Transformer{which.title()}Layer"})
    band1, band64 = front["band_timings"]
    frames418, frames26752 = front["band_frame_timings"]
    synth1, synth64, synth256 = front["synth_timings"]

    def synth_at(row):
        return {"ms": float(np.mean(row["kernel_ms"])), "device_ms": row["kernel_device_ms"],
                "plain_ms": float(np.mean(row["plain_ms"])), "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": float(np.mean(row["index_add_ms"])),
                "library_device_ms": row["index_add_device_ms"]}

    def band_at(row, library_key):
        return {"N": row["N"], "ms": float(np.mean(row["kernel_ms"])),
                "device_ms": row["kernel_device_ms"],
                "plain_ms": float(np.mean(row["plain_ms"])), "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": float(np.mean(row[library_key]))}

    kernels.append({
        "name": "band_energies", "route": "cuda", "source": BAND_SOURCE,
        "replaces": BAND_TPU_KERNEL, "launches": hvo["launches"]["band_energies"],
        "launches_audio_augment_path": augmented["launches"]["band_energies"],
        "launches_checkpoint_path": saved["launches"]["band_energies"],
        "max_abs_err": front["band_err"], **band_at(band1, "library_ms"),
        "library_device_ms": band1["library_device_ms"],
        "chunk_of_64": {**band_at(band64, "library_ms"),
                        "library_device_ms": band64["library_device_ms"]},
        "frames_entry": {"N 418": band_at(frames418, "rfft_matmul_ms"),
                         "N 26752": band_at(frames26752, "rfft_matmul_ms")},
        "at": f"one request at 120 bpm: M 1, {band1['length']} samples, N {band1['N']} "
              "frames x 1024, float32, through band_energies_from_audio; ms: stream time; "
              "device_ms: the profiler's per launch; library: _windowed_frames, "
              "torch.fft.rfft, abs, one matmul from the same waveform; bound: the waveform "
              "read once and an FFT's operations; err: the largest over every check, each "
              "held to 1e-4 of its largest band energy; frames_entry: "
              "band_energies(frames), library rfft of the "
              "same frames, bound: frames read once"})
    kernels.append({
        "name": "device_synth", "route": "cuda", "source": SYNTH_SOURCE,
        "replaces": SYNTH_TPU_KERNEL, "launches": hvo["launches"]["device_synth"],
        "launches_audio_augment_path": augmented["launches"]["device_synth"],
        "launches_checkpoint_path": saved["launches"]["device_synth"],
        "max_abs_err": front["synth_err"], **synth_at(synth1),
        "chunk_of_64": synth_at(synth64), "chunk_of_256": synth_at(synth256),
        "at": f"M 1 loop, 288 cells, length {synth1['length']} (120 bpm), float32; ms: stream "
              "time; device_ms: the profiler's per launch; library: one index_add_ over "
              "indices and sources prepared outside the timed call; chunk_of_256: the audio "
              "augment's chunk"})
    def ffn_row(rows, d, dtype):
        return next(t for t in ffn_ln["timings"]
                    if t["rows"] == rows and t["d"] == d and t["dtype"] == dtype)

    def device_ms(row, *entries):
        """Device ms per launch of the kernels whose names hold ``entries``."""
        return sum(us for k, us in row["kernel_device_us"].items()
                   if any(e in k for e in entries)) / 1000.0

    def at_shape(row, kname, entries, key):
        library_device = ({"library_device_ms": row[f"{key}_library_device_ms"]}
                          if key.startswith("ln_") else {})
        return {"ms": device_ms(row, *entries),
                "stream_ms_of_the_call": float(np.mean(row[f"{key}_kernel_ms"])),
                "plain_ms": float(np.mean(row[f"{key}_plain_ms"])),
                "bound_ms": row["bounds"][kname]["bound_ms"],
                "bound_by": row["bounds"][kname]["bound_by"],
                "library_ms": float(np.mean(row[f"{key}_library_ms"])), **library_device}

    names = {**{k: (FFN_DEVICE_NAMES[k], "ffn_") for k in ffn.KERNELS},
             "fused_ln_fwd": (("ln_fwd",), "ln_"), "fused_ln_bwd": (("ln_bwd",), "ln_")}
    for kname, (entries, prefix) in names.items():
        is_ffn, is_f32 = kname.startswith("fused_ffn"), kname.endswith("_f32")
        dtype = "float32" if is_f32 else "bfloat16"
        key = prefix + ("fwd" if "_fwd" in kname else "bwd")
        small = ffn_row(1024, 256, dtype)
        if not is_ffn:
            launches_main = wide["ln_launches"][kname]
        else:
            launches_main = (wide["f32_launches"] if is_f32 else wide["launches"])[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": FFN_SOURCE if is_ffn else LN_SOURCE,
            "replaces": (FFN_TPU_KERNELS if is_ffn else LN_TPU_KERNELS)[kname],
            "launches": launches_main,
            "launches_encdec_1_plus_1_path": wide["encdec_launches"][kname],
            "launches_groovexl_path": xl["launches"][kname],
            "max_abs_err": ffn_ln["max_abs_err"]["ffn" if is_ffn else "ln"],
            **at_shape(small, kname, entries, key),
            "rows_16384": at_shape(ffn_row(16384, 256, dtype), kname, entries, key),
            "groovexl": at_shape(ffn_row(4096, 1024, dtype), kname, entries, key),
            "at": f"rows 1,024 (batch 32), d 256, ff 2048, {dtype}, rate 0.16; rows_16384: "
                  "batch 512; groovexl: rows 4,096, d 1024, ff 4096, rate 0.1; ms: device "
                  "time per launch (the f32 weight kernel with its reduce); "
                  "stream_ms_of_the_call, plain_ms and library_ms are on the stream and "
                  "cover the whole forward or backward call the kernel is part of (the FFN's "
                  "plain version, ffn_reference or backward_formulas; the LN's the reference "
                  "and autograd); library: F.linear, relu, F.dropout, F.linear (FFN) or "
                  "F.layer_norm(x + F.dropout(y)) (LN), and autograd's backward; bound: this "
                  "launch's own bytes and operations; err: the largest of out, h, dx (FFN) or "
                  "out, dx, dy (LN) over the f32 checks; launches: phase 18's main run (bf16 "
                  "FFN kernels), its run with fused_dropout_ln (LN), its 3 f32 steps (f32 FFN "
                  "kernels, the forward twice a call there)"})
    emit({"kernels": kernels, "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
