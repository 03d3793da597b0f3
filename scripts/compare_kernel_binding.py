#!/usr/bin/env python
"""Seqs/s of the PyTorch port's unbatched training step with kernels #2-#5
bound to autograd in two ways, in one process on one NVIDIA GPU:

- ``eager``: one ``torch.autograd.Function`` a kernel, without
  ``setup_context``, whose forward and backward call the launches directly
  (the port's binding before the kernels had operators; written out here);
- ``operators``: the ``torch.autograd.Function`` with ``setup_context`` over
  the kernel's two ``tgi::`` operators (``EncoderLayerTrain``,
  ``DecoderLayerTrain``, ``FfnTrain``, ``DropoutAddLayerNorm``), what
  ``torch.func`` needs.

    python scripts/compare_kernel_binding.py [--pairs 10] [--steps 60] [--out PATH]

Each arm is put in place of the model's four kernel wrappers
(``models/transformer.py``), so both run the same launches on the same
tensors. Three configs at batch 32 on seeded random loops: the flagship
(configs/InfillingRandom_training.yaml, bf16, #2 by its auto), the 6 + 6
model at the flagship's width (#2 and #3 forced) and the lm config
(configs/InfillingRandomLow_lm_training.yaml) with ``fused_layer`` off and
``fused_ffn`` + ``fused_dropout_ln`` forced (#4 and #5). Per config, one
warm-up epoch in each arm, then ``2 * pairs`` timed epochs of ``steps``
steps on the host clock, in the order E O O E E O ...: pair i is epochs 2i
and 2i + 1, its ratio the operators' seconds over the eager arm's, and the
first arm alternates. The control: the seconds of each two adjacent epochs
of one arm (O O, E E, ...), the later over the earlier. Prints the
``nvidia-smi`` name and power limit and one JSON line a config, and writes
all of it as JSON to ``--out`` (default runs/compare_kernel_binding.json).
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from transformergrooveinfilling_tpu_torch.models import transformer  # noqa: E402
from transformergrooveinfilling_tpu_torch.ops import fused_decoder_layer as fdl  # noqa: E402
from transformergrooveinfilling_tpu_torch.ops import fused_ffn as ffn  # noqa: E402
from transformergrooveinfilling_tpu_torch.ops import fused_layer as fl  # noqa: E402
from transformergrooveinfilling_tpu_torch.ops import fused_ln as ln  # noqa: E402
from transformergrooveinfilling_tpu_torch.ops import per_trial  # noqa: E402
from transformergrooveinfilling_tpu_torch.train import (HyperParams,  # noqa: E402
                                                        create_train_state, make_epoch_fn)
from transformergrooveinfilling_tpu_torch.train.config import derive_model_config  # noqa: E402
from transformergrooveinfilling_tpu_torch.train.loop import fetch  # noqa: E402

FLAGSHIP = {"experiment": "InfillingRandom", "batch_size": 32, "d_model": 256,
            "dim_feedforward": 512, "dropout": 0.30, "optimizer_algorithm": "sgd",
            "learning_rate": 0.089, "n_heads": 2, "num_encoder_decoder_layers": 6,
            "epochs": 1, "encoder_only": 1, "hit_loss_penalty": 0.73}
CONFIGS = {
    "flagship": (FLAGSHIP, {}),
    "encdec_6_6": (dict(FLAGSHIP, encoder_only=0),
                   {"fused_layer": True, "fused_decoder_layer": True}),
    "lm_ffn_ln": (dict(FLAGSHIP, dim_feedforward=2048, num_encoder_decoder_layers=8,
                       dropout=0.16, learning_rate=0.07, hit_loss_penalty=0.46),
                  {"fused_layer": False, "fused_ffn": True, "fused_dropout_ln": True}),
}


class EagerLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2, seed, rate,
                n_heads, seq_len):
        y, qkv, a1, h, a2 = fl.layer_forward(x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f,
                                             g2, b2, seed, rate, n_heads, seq_len)
        ctx.save_for_backward(x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed)
        ctx.static = (rate, n_heads, seq_len)
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        grads = list(fl.layer_backward(dy, *saved, *ctx.static))
        for i, w in zip((1, 3, 7, 9), saved[5:9]):  # dwqkv, dwo, dw1, dw2
            grads[i] = grads[i].to(w.dtype)
        return (*grads, None, None, None, None)


class EagerDecoderLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2, bo2, g1, b1, w1, b1f,
                w2, b2f, g2, b2, g3, b3, seed, rate, n_heads, seq_len):
        out, *residuals = fdl.layer_forward(y, mem, wqkv, bqkv, wo, bo, wq, bq, wkv, bkv, wo2,
                                            bo2, g1, b1, w1, b1f, w2, b2f, g2, b2, g3, b3,
                                            seed, rate, n_heads, seq_len)
        ctx.save_for_backward(y, mem, *residuals, wqkv, wo, wq, wkv, wo2, w1, w2,
                              g1, b1, g2, b2, g3, seed)
        ctx.static = (rate, n_heads, seq_len)
        return out

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        grads = list(fdl.layer_backward(dy, *saved, *ctx.static))
        for i, w in zip((2, 4, 6, 8, 10, 14, 16), saved[9:16]):
            grads[i] = grads[i].to(w.dtype)
        return (*grads, None, None, None, None)


class EagerFfn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seed, rate):
        out, h = ffn.ffn_forward(x, w1, b1, w2, b2, seed, rate)
        ctx.save_for_backward(x, h, w1, w2)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, dy):
        x, h, w1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = ffn._launch_backward_split(dy.contiguous(), x, h, w1, w2,
                                                           ctx.rate)
        return dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2, None, None


class EagerLn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, scale, bias, seed, rate):
        ctx.save_for_backward(x, y, scale, seed)
        ctx.rate = rate
        return ln.ln_forward(x, y, scale, bias, seed, rate)

    @staticmethod
    def backward(ctx, g):
        return (*ln.ln_backward(g, *ctx.saved_tensors, ctx.rate), None, None)


def through(function, n_tensors: int, first_only: bool = True):
    """``function.apply`` after the device check of its first ``n_tensors``
    arguments, as the port's wrappers call it."""
    def call(*args):
        per_trial.check_devices(function.__name__, args[:n_tensors])
        out = function.apply(*args)
        return out[0] if first_only else out
    return call


ARMS = {
    "eager": {"encoder_layer_train": EagerLayer.apply,
              "decoder_layer_train": EagerDecoderLayer.apply,
              "ffn_train": EagerFfn.apply, "dropout_add_layernorm": EagerLn.apply},
    "operators": {"encoder_layer_train": through(fl.EncoderLayerTrain, 14),
                  "decoder_layer_train": through(fdl.DecoderLayerTrain, 23),
                  "ffn_train": through(ffn.FfnTrain, 6),
                  "dropout_add_layernorm": through(ln.DropoutAddLayerNorm, 5, False)},
}


def run(name: str, pairs: int, steps: int, dev) -> dict:
    hp_dict, switches = CONFIGS[name]
    hp = HyperParams.from_dict(hp_dict)
    config = dataclasses.replace(derive_model_config(hp, device=dev), **switches)
    rng = np.random.default_rng(0)
    n = hp.batch_size * steps
    x = torch.as_tensor(rng.standard_normal((n, 32, 16)).astype(np.float32), device=dev)
    h = (rng.random((n, 32, 9)) < 0.3).astype(np.float32)
    y = torch.as_tensor(np.concatenate([h, h * rng.random(h.shape),
                                        h * (rng.random(h.shape) - 0.5)], -1).astype(np.float32),
                        device=dev)
    state = create_train_state(config, "sgd", hp.learning_rate, device=dev)
    epoch = make_epoch_fn(hp.hit_loss_penalty, hp.batch_size, n,
                          encoder_only=bool(hp.encoder_only))
    kernels = {**fl.SM90_KERNELS, **fdl.SM90_KERNELS, **ffn.BF16_KERNELS, **ln.KERNELS}

    def timed(arm: str, seed: int) -> float:
        for attr, fn in ARMS[arm].items():
            setattr(transformer, attr, fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fetch(epoch(state, x, y, torch.Generator(dev).manual_seed(seed)))
        return time.perf_counter() - t0

    launches = {}
    for arm in ARMS:
        for f in kernels.values():
            f.launches = 0
        timed(arm, 1)  # warm-up
        launches[arm] = {k: f.launches for k, f in kernels.items() if f.launches}
    if launches["eager"] != launches["operators"] or not launches["eager"]:
        raise SystemExit(f"{name}: the arms launched {launches}")
    order = [arm for i in range(pairs)
             for arm in (("eager", "operators") if i % 2 == 0 else ("operators", "eager"))]
    seconds = [timed(arm, 2 + i) for i, arm in enumerate(order)]
    ratios = [seconds[2 * i + order[2 * i:2 * i + 2].index("operators")]
              / seconds[2 * i + order[2 * i:2 * i + 2].index("eager")] for i in range(pairs)]
    control = {arm: [seconds[i + 1] / seconds[i] for i in range(1, len(order) - 1, 2)
                     if order[i] == order[i + 1] == arm] for arm in ARMS}
    return {"config": name, "steps": steps, "seqs": n, "launches_an_epoch": launches["eager"],
            "order": order, "seconds": seconds,
            "seqs_per_s": {arm: [n / s for s, a in zip(seconds, order) if a == arm]
                           for arm in ARMS},
            "operators_over_eager": ratios, "median_ratio": float(np.median(ratios)),
            "control_later_over_earlier": control}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    parser.add_argument("--out", default=os.path.join("runs", "compare_kernel_binding.json"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernel_binding: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.strip(), "results": []}
    print(out["nvidia_smi"], flush=True)
    for name in args.configs:
        out["results"].append(run(name, args.pairs, args.steps, dev))
        r = out["results"][-1]
        print(json.dumps({k: r[k] for k in ("config", "median_ratio", "operators_over_eager",
                                            "control_later_over_earlier")}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
