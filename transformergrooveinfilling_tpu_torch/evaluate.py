"""Offline evaluation, as the JAX package's ``evaluate.py``: the in-training
``log_eval`` pass from saved artifacts, outside any run::

    python -m transformergrooveinfilling_tpu_torch.evaluate \\
        --ckpt checkpoints/<run-dir-or-file> \\
        --evaluator <evaluator.pickle> [--evaluator <another> ...] \\
        [--identifier Validation_Set ...] [--media 1] [--dump 0] [--epoch N] [--device cpu]

Per-voice metric families, media (audio, piano rolls, heatmaps), the
feature-stats CSV/HTML and the optional ``.Eval`` dump, from a checkpoint of
either package (``.ckpt``, or a reference ``.Model`` with the architecture
flags) or an ``export.py`` artifact (``--artifact``, either package's; served
through ``InfillServer.from_exported``, its own threshold applies), and
evaluator pickles of either package. The flags are the JAX command line's,
plus ``--device`` (default ``cuda``): where the model runs and the
evaluators' datasets compute.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re

import numpy as np


def _default_identifier(path: str) -> str:
    """Reference identifiers are ``{Split}_Set``."""
    name = os.path.basename(path).lower()
    for split in ("validation", "train", "test"):
        if split in name:
            return f"{split.capitalize()}_Set"
    stem = os.path.splitext(os.path.basename(path))[0]
    return stem or "Eval_Set"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m transformergrooveinfilling_tpu_torch.evaluate",
        description="Re-score a checkpoint with preprocessed evaluators (the in-training "
                    "log_eval pass, offline)")
    p.add_argument("--ckpt", help=".ckpt/.Model file, or a directory (newest epoch wins)")
    p.add_argument("--artifact",
                   help="evaluate an export.py artifact (.tgix) instead of a checkpoint; "
                        "the artifact's embedded threshold applies")
    p.add_argument("--evaluator", action="append", required=True,
                   help="preprocessed evaluator pickle (repeatable)")
    p.add_argument("--identifier", action="append", default=None,
                   help="identifier per evaluator, in order (default: {Split}_Set derived "
                        "from the filename)")
    p.add_argument("--media", default="1",
                   help="1 = render media + stats CSV (reference log_media)")
    p.add_argument("--dump", default="0", help="1 = dump the evaluator .Eval file")
    p.add_argument("--epoch", type=int, default=None,
                   help="with a --ckpt directory: select this epoch's checkpoint (default: "
                        "newest); also the epoch label in the logs")
    p.add_argument("--all_epochs", action="store_true",
                   help="with a --ckpt directory: re-score every saved epoch into one run; "
                        "media/dump are skipped per epoch")
    p.add_argument("--run_dir", default=None,
                   help="base dir for the metrics/media run (default runs/offline_eval)")
    p.add_argument("--device", default="cuda",
                   help="where to evaluate ('cuda' or 'cpu'); without CUDA 'cuda' raises")
    # legacy-.Model architecture flags (native checkpoints embed their config)
    p.add_argument("--d_model", type=int, default=32)
    p.add_argument("--n_heads", type=int, default=4)
    p.add_argument("--dim_feedforward", type=int, default=16)
    p.add_argument("--num_encoder_layers", type=int, default=6)
    p.add_argument("--embedding_size_src", type=int, default=16)
    args = p.parse_args(argv)

    idents = list(args.identifier or [])
    if idents and len(idents) != len(args.evaluator):
        p.error(f"--identifier given {len(idents)} times for {len(args.evaluator)} "
                "evaluators (must match, in order)")
    if bool(args.ckpt) == bool(args.artifact):
        p.error("exactly one of --ckpt / --artifact is required")
    if args.artifact and args.all_epochs:
        p.error("--all_epochs applies to --ckpt directories, not artifacts")

    # offline by default, as the command line's purpose and --run_dir say;
    # export WANDB_MODE=online to upload instead
    os.environ.setdefault("WANDB_MODE", "offline")

    from .models.transformer import GrooveTransformerConfig
    from .train import checkpoint as ckpt_mod

    if args.artifact:
        # the server's bucketing maps any evaluator size onto the artifact's
        # batch sizes, and its predict thresholds with the artifact's settings
        from .serve import InfillServer

        server = InfillServer.from_exported(args.artifact, device=args.device)
        epoch = 0 if args.epoch is None else args.epoch
        return _evaluate(args, _ArtifactModel(server), server.config, epoch, float("nan"),
                         args.artifact)

    legacy_config = GrooveTransformerConfig(
        d_model=args.d_model, n_heads=args.n_heads, dim_feedforward=args.dim_feedforward,
        num_encoder_layers=args.num_encoder_layers, embedding_size_src=args.embedding_size_src)
    if args.all_epochs:
        return _evaluate_all_epochs(args, legacy_config)

    path = args.ckpt
    if args.epoch is not None and os.path.isdir(path):
        matches = [f for f in sorted(os.listdir(path))
                   if f.endswith((f"_Epoch_{args.epoch}.ckpt", f"_Epoch_{args.epoch}.Model"))]
        if not matches:
            raise SystemExit(f"no epoch-{args.epoch} checkpoint under {path}")
        path = os.path.join(path, matches[-1])
    state_dict, config, ckpt_epoch, loss = ckpt_mod.load_params_and_config(
        path, legacy_config=legacy_config)
    epoch = args.epoch if args.epoch is not None else ckpt_epoch
    return _evaluate(args, _bundle_for(state_dict, config, args.device), config, epoch, loss,
                     path)


class _ArtifactModel:
    """The reference predict contract over an artifact's server: the hits
    come thresholded with the artifact's own settings (the arguments are the
    contract's, and unused)."""

    def __init__(self, server):
        self.server = server

    def predict(self, inputs, use_thres: bool = True, thres: float = 0.5):
        hvo = self.server.infill(np.asarray(inputs, np.float32))
        return list(np.split(hvo, 3, axis=2))


def _bundle_for(state_dict, config, device):
    import torch

    from .train.driver import ModelBundle
    from .train.loop import create_train_state

    # on the card the forwards run the attention kernel, whoever wrote the
    # checkpoint (as the training run's do, train/config.py)
    config = dataclasses.replace(config,
                                 use_fused_attention=torch.device(device).type == "cuda")
    # the optimizer is inert: evaluation never steps it
    state = create_train_state(config, "sgd", 0.05, 0, device)
    state.model.load_state_dict(state_dict, strict=True)
    return ModelBundle(model=state.model, config=config, state=state,
                       device=next(state.model.parameters()).device)


def _evaluate_all_epochs(args, legacy_config) -> int:
    """A learning curve from artifacts: one run, every saved epoch scored."""
    from .train import checkpoint as ckpt_mod
    from .utils import logging as xlog

    if not os.path.isdir(args.ckpt):
        raise SystemExit("--all_epochs needs --ckpt to be a directory")
    epochs = {}  # epoch -> filename (a native .ckpt wins over a legacy .Model)
    for f in sorted(os.listdir(args.ckpt)):
        m = re.search(r"_Epoch_(\d+)\.(ckpt|Model)$", f)
        if m and (int(m.group(1)) not in epochs or f.endswith(".ckpt")):
            epochs[int(m.group(1))] = f
    if not epochs:
        raise SystemExit(f"no checkpoints under {args.ckpt}")

    xlog.init(config={"checkpoint": args.ckpt, "all_epochs": sorted(epochs)},
              project="offline_eval", job_type="eval", run_dir=args.run_dir)
    args.media = "0"
    args.dump = "0"
    try:
        for epoch in sorted(epochs):
            path = os.path.join(args.ckpt, epochs[epoch])
            state_dict, config, _ep, loss = ckpt_mod.load_params_and_config(
                path, legacy_config=legacy_config)
            _evaluate(args, _bundle_for(state_dict, config, args.device), config, epoch, loss,
                      path)
    finally:
        xlog.finish()
    return 0


def _evaluate(args, bundle, config, epoch, loss, path) -> int:
    from .eval.evaluator import init_evaluator, log_eval
    from .hvo import ROLAND_REDUCED_MAPPING
    from .utils import logging as xlog

    idents = list(args.identifier or [])
    media = bool(args.media) and args.media not in ("0", "False")
    dump = bool(args.dump) and args.dump not in ("0", "False")
    loss_txt = "n/a" if not np.isfinite(loss) else f"{float(loss):.4f}"

    owns_run = xlog.run is None
    if owns_run:
        xlog.init(config={"checkpoint": path, "epoch": epoch}, project="offline_eval",
                  job_type="eval", run_dir=args.run_dir)
    try:
        for i, ev_path in enumerate(args.evaluator):
            ev = init_evaluator(ev_path, device=args.device)
            ev._identifier = idents[i] if idents else _default_identifier(ev_path)
            ev_dim = int(np.asarray(ev.processed_inputs).shape[-1])
            if ev_dim != config.embedding_size_src:
                raise SystemExit(
                    f"evaluator {ev_path} carries {ev_dim}-d inputs but the checkpoint's "
                    f"model takes embedding_size_src={config.embedding_size_src}: this "
                    "evaluator belongs to a different experiment modality (MSO audio = 16, "
                    "symbolic = 27)")
            log_eval(ev, bundle, log_media=media, epoch=epoch, dump=dump)
            acc = ev.get_hits_accuracies(ROLAND_REDUCED_MAPPING)
            # per-voice entries only: the family also carries a "..._mean" key
            vals = [v for k, v in acc.items() if np.isscalar(v) and not k.endswith("_mean")]
            print(f"{ev._identifier}: mean hit accuracy {float(np.mean(vals)):.4f} over "
                  f"{len(vals)} voice metrics (checkpoint epoch {epoch}, train loss "
                  f"{loss_txt})")
        if xlog.run is not None:  # None when the real wandb owns the run
            print(f"metrics + media written under {xlog.run.dir}")
    finally:
        if owns_run:
            xlog.finish()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
