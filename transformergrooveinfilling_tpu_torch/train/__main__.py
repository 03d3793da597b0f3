"""The training command line, as the repository's root ``train.py`` is for
the JAX package, on the port::

    python -m transformergrooveinfilling_tpu_torch.train \\
        --config configs/InfillingRandom_training.yaml --wandb False

The flags and their defaults are root ``train.py``'s, plus ``--device``
(default ``cuda``; ``cpu`` to run there). The reference's rules hold: a
``--config`` YAML overrides every hyperparameter flag (read by
``utils/yaml_subset.py``, as is ``--paths``), ``--testing`` forces one epoch,
and ``--load_model <dir>`` resumes from the newest ``.ckpt`` of either
package there, at its epoch + 1. ``--wandb`` defaults to True, which sets
``WANDB_MODE=online`` as the JAX package does: on a machine without network,
pass ``--wandb False``.

``--streaming`` as root ``train.py``'s ``_setup_streaming`` on one process:
``host`` trains on ``data/pipeline.py::StreamingAugmenter`` generations
rendered on the device by a producer thread, swapped every
``--regen_cadence`` blocks; ``fused`` re-renders every block inside the
epoch function (``data/device_pipeline.py::make_on_device_augment``). Like
root ``train.py``, ``fused`` repeats the corpus by the fan-out and trims it to
a multiple of 64 items. The 64 is the TPU synthesizer's chunk; the port's
augment takes any count, and the trim is kept so that both command lines
train on the same items.

``--eval_train``, ``--eval_test`` and ``--eval_validation`` load the
evaluator pickles that the paths file names for the experiment (built by
``python -m transformergrooveinfilling_tpu_torch.process_evaluator``, or by
root ``process_evaluator.py``), on ``--device``, and ``run_training``
evaluates every block on them; a pickle that does not exist is skipped with
a line on stderr, as in root ``train.py``.

Several processes, one rank each (``parallel/``): launched once per rank
with the JAX package's names (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) or torchrun's (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), the command line
starts the process group before any CUDA use
(``parallel/multihost.py::initialize_from_env``) and trains data-parallel
over the ranks, ``--n_model_shards N`` splitting each layer over N of them
(tensor parallelism) and ``--pp_stages S`` pipelining the encoder over S
(``--pp_micro`` microbatches, default 2·S), as root ``train.py`` builds its
plan. As root ``train.py`` does under several processes: ranks other than 0
log offline, the in-training evaluators are disabled (with a note), and each
rank's host streamer takes its equal shard of the corpus, seeded ``rank <<
20``. ``--fast_prng`` is accepted and changes nothing: it switches the JAX
package's dropout PRNG, and the port's masks are Philox streams.
"""

from __future__ import annotations

import argparse
import os
import pprint
import sys

import numpy as np

from ..utils import logging as xlog
from ..utils import yaml_subset
from .config import load_paths


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m transformergrooveinfilling_tpu_torch.train")
    parser.add_argument("--paths", help="paths file", default="configs/paths.yaml")
    parser.add_argument("--testing", help="testing mode", default=False)
    parser.add_argument("--wandb", help="log to wandb (WANDB_MODE=online)", default=True)
    parser.add_argument("--eval_train", help="evaluator train set", default=True)
    parser.add_argument("--eval_test", help="evaluator test set", default=False)
    parser.add_argument("--eval_validation", help="evaluator validation set", default=True)
    parser.add_argument("--only_final_eval", help="only final total evaluation", default=False)
    parser.add_argument("--dump_eval", help="dump evaluator file", default=True)
    parser.add_argument("--load_model", help="load model parameters", default=None)
    parser.add_argument("--notes", help="wandb run notes", default=None)
    parser.add_argument("--tags", help="wandb run tags", default=None)
    parser.add_argument("--n_model_shards", type=int, default=1,
                        help="tensor-parallel mesh axis size (ranks each layer is split over)")
    parser.add_argument("--pp_stages", type=int, default=1,
                        help="pipeline-parallel stages (GPipe over the encoder layers)")
    parser.add_argument("--pp_micro", type=int, default=None,
                        help="microbatches per global batch (pipeline parallelism only)")
    parser.add_argument("--export_legacy", default=False,
                        help="also write torch-format .Model checkpoints")
    parser.add_argument("--ckpt_dir", default="checkpoints")
    parser.add_argument("--epoch_block", type=int, default=1,
                        help="epochs per call of the epoch function")
    parser.add_argument("--watch_log_freq", type=int, default=1000,
                        help="gradient/parameter histograms every N steps (the "
                             "reference's wandb.watch log_freq); 0 disables")
    parser.add_argument("--media_async", type=int, default=1,
                        help="render eval media on a background worker (evaluators only)")
    parser.add_argument("--max_wall_s", type=float, default=None,
                        help="wall-clock budget: stop gracefully (checkpoint + clean exit) "
                             "after the first epoch block that crosses it; SIGTERM/SIGINT "
                             "trigger the same path")
    parser.add_argument("--bf16", type=int, default=None,
                        help="matmul compute dtype: 1=bfloat16, 0=float32, unset=auto "
                             "(bf16 on a CUDA device)")
    parser.add_argument("--remat_policy", default=None, choices=["dots", "nothing"],
                        help="selective remat when remat engages: 'dots' stores matmul "
                             "outputs and recomputes elementwise chains")
    parser.add_argument("--remat", type=int, default=None,
                        help="layer rematerialization: 1/0 force; absent = auto (on only "
                             "when the estimated backward residuals would not fit)")
    parser.add_argument("--fused_ffn", type=int, default=None,
                        help="fused FFN kernel: 1=on, 0=off, unset=auto (train/config.py)")
    parser.add_argument("--fused_layer", type=int, default=None,
                        help="whole-encoder-layer kernels: 1=on, 0=off, unset=auto "
                             "(train/config.py)")
    parser.add_argument("--fused_decoder_layer", type=int, default=None,
                        help="whole-decoder-layer kernels (encoder-decoder family): 1=on, "
                             "0=off, unset=auto (train/config.py)")
    parser.add_argument("--fast_prng", type=int, default=1,
                        help="accepted and has no effect: it switches the JAX package's "
                             "dropout PRNG to rbg, and the port's masks are Philox")
    parser.add_argument("--streaming", choices=["off", "host", "fused"], default="off",
                        help="fresh-augmentation training for the random-masking "
                             "experiments: host = StreamingAugmenter generations built on "
                             "a producer thread; fused = masking+synth+MSO inside the "
                             "epoch function")
    parser.add_argument("--regen_cadence", default="auto",
                        help="host streaming: swap a fresh generation every N epoch blocks "
                             "(int), or 'auto' to fit generation time inside the blocks it "
                             "serves")
    parser.add_argument("--regen_partial", type=int, default=1,
                        help="host streaming: regenerate only 1/k of the corpus per "
                             "generation (rolling refresh)")
    parser.add_argument("--aug_per_item", type=int, default=None,
                        help="streaming: fresh augmentations per corpus item (default: the "
                             "dataset pickle's max_aug_items)")
    parser.add_argument("--device", default="cuda",
                        help="where to train ('cuda' or 'cpu'); without CUDA 'cuda' raises")

    parser.add_argument("--config", default=None,
                        help="yaml config file. if given, the rest of the arguments are not "
                             "taken into account")
    parser.add_argument("--experiment", help="experiment id", default=None)
    parser.add_argument("--encoder_only", default=1, type=int)
    parser.add_argument("--optimizer_algorithm", default="sgd", type=str)
    parser.add_argument("--d_model", default=64, type=int)
    parser.add_argument("--n_heads", default=16, type=int)
    parser.add_argument("--dropout", default=0.2, type=float)
    parser.add_argument("--num_encoder_decoder_layers", default=7, type=int)
    parser.add_argument("--hit_loss_penalty", default=1, type=float)
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--dim_feedforward", default=256, type=int)
    parser.add_argument("--learning_rate", default=0.05, type=float)
    parser.add_argument("--epochs", default=100, type=int)
    return parser.parse_args(argv)


def _flag(value) -> bool:
    """The reference's string flags: anything but False and "False" is on."""
    return bool(value) and value != "False"


def hyperparameters_from_args(args) -> dict:
    # all-or-nothing: a config file overrides every CLI hyperparameter
    if args.config is not None:
        hp = yaml_subset.load_file(args.config)
    else:
        hp = dict(
            encoder_only=args.encoder_only,
            optimizer_algorithm=args.optimizer_algorithm,
            d_model=args.d_model,
            n_heads=args.n_heads,
            dropout=args.dropout,
            num_encoder_decoder_layers=args.num_encoder_decoder_layers,
            hit_loss_penalty=args.hit_loss_penalty,
            batch_size=args.batch_size,
            dim_feedforward=args.dim_feedforward,
            learning_rate=args.learning_rate,
            epochs=args.epochs,
            load_model=args.load_model,
        )
    # a checkpoint directory given as a string → the restore dict
    if isinstance(hp.get("load_model"), str):
        hp["load_model"] = {"location": "local", "dir": hp["load_model"]}
    elif args.load_model is not None and not hp.get("load_model"):
        # config-file mode: the flag still works when the YAML has no
        # load_model of its own
        hp["load_model"] = {"location": "local", "dir": args.load_model}
    if _flag(args.testing):
        hp["epochs"] = 1
    if args.experiment is not None:
        hp["experiment"] = args.experiment
    if "experiment" not in hp:
        raise SystemExit("experiment not specified: give --experiment or a --config with one")
    return hp


def main(argv=None):
    args = parse_args(argv)
    hp_dict = hyperparameters_from_args(args)
    pprint.pprint(hp_dict)
    paths = load_paths(args.paths)
    os.environ["WANDB_MODE"] = "online" if _flag(args.wandb) else "offline"
    # several processes: start the group from the environment before any CUDA
    # use (root train.py's order)
    from ..parallel.multihost import initialize_from_env, process_count, process_index

    if initialize_from_env(args.device) and process_count() > 1:
        if process_index() != 0:
            # one wandb run per job; every rank keeps its local run directory
            os.environ["WANDB_MODE"] = "offline"
        if any(_flag(f) for f in (args.eval_train, args.eval_test, args.eval_validation)):
            if process_index() == 0:
                print("multi-host run: in-training evaluators disabled (evaluate offline "
                      "from checkpoints: python -m "
                      "transformergrooveinfilling_tpu_torch.evaluate)")
            args.eval_train = args.eval_test = args.eval_validation = "False"
            args.dump_eval = "False"
    xlog.init(config=hp_dict, project=hp_dict["experiment"], job_type="train",
              notes=args.notes, tags=args.tags)
    try:
        return _run(args, hp_dict, paths)
    finally:
        # a failed run must not leave the logging singleton active
        xlog.finish()


def _plan(args):
    """The mesh plan of the flags and the group (root ``train.py``'s): a
    pipeline plan with ``--pp_stages`` > 1, else a ("data", "model") mesh
    with ``--n_model_shards``; None in one process without either."""
    from ..parallel.multihost import process_count

    if args.pp_stages > 1:
        from ..parallel.pipeline import make_pipeline_mesh

        return make_pipeline_mesh(args.pp_stages, n_micro=args.pp_micro,
                                  n_model=args.n_model_shards, device=args.device)
    if args.n_model_shards > 1 or process_count() > 1:
        from ..parallel.mesh import make_mesh

        return make_mesh(n_model=args.n_model_shards, device=args.device)
    return None


def _run(args, hp_dict, paths):
    from ..data import load_processed_dataset
    from ..eval.evaluator import init_evaluator
    from .config import HyperParams, embedding_size_src_for
    from .driver import initialize_model, run_training

    cfg = xlog.config  # the config round trip: sweeps override through here

    def switch(flag, key):
        return bool(flag) if flag is not None else cfg.get(key)

    params = {
        "model": {
            "experiment": cfg.experiment,
            "encoder_only": cfg.encoder_only,
            "optimizer": cfg.optimizer_algorithm,
            "d_model": cfg.d_model,
            "n_heads": cfg.n_heads,
            "dim_feedforward": cfg.dim_feedforward,
            "dropout": cfg.dropout,
            "num_encoder_layers": cfg.num_encoder_decoder_layers,
            "num_decoder_layers": 0 if cfg.encoder_only else cfg.num_encoder_decoder_layers,
            "max_len": 32,
            "embedding_size_src": embedding_size_src_for(cfg.experiment),
            "embedding_size_tgt": 27,
            # None = auto (train/config.py); a flag overrides the YAML
            "bf16": switch(args.bf16, "bf16"),
            "fused_ffn": switch(args.fused_ffn, "fused_ffn"),
            "fused_layer": switch(args.fused_layer, "fused_layer"),
            "fused_decoder_layer": switch(args.fused_decoder_layer, "fused_decoder_layer"),
            "remat": switch(args.remat, "remat"),
            "remat_policy": (args.remat_policy if args.remat_policy is not None
                             else cfg.get("remat_policy")),
        },
        "training": {
            "learning_rate": cfg.learning_rate,
            "batch_size": cfg.batch_size,
            "hit_loss_penalty": cfg.hit_loss_penalty,
        },
        "load_model": cfg.get("load_model"),
    }
    xlog.config.update(params["model"])

    plan = _plan(args)
    bundle, _opt, initial_epoch = initialize_model(params, device=args.device, plan=plan)
    xlog.watch(bundle.model)

    dataset_train = load_processed_dataset(paths[cfg.experiment]["datasets"]["train"],
                                           exp=cfg.experiment)

    evaluators = {}
    ev_paths = paths[cfg.experiment].get("evaluators") or {}
    for name, flag in (("train", args.eval_train), ("test", args.eval_test),
                       ("validation", args.eval_validation)):
        path = ev_paths.get(name) if _flag(flag) else None
        if path and os.path.exists(path):
            evaluators[name] = init_evaluator(path, device=args.device)
        elif path:
            print(f"[train] evaluator pickle missing, skipping {name}: {path}",
                  file=sys.stderr)

    hp = HyperParams.from_dict(dict(cfg))
    streamer, on_device_augment, dataset_for_training = _setup_streaming(
        args, dataset_train)
    try:
        run_training(
            hp, dataset_for_training, evaluators,
            bundle=bundle, initial_epoch=initial_epoch, plan=plan,
            only_final_eval=_flag(args.only_final_eval),
            dump_eval=_flag(args.dump_eval),
            ckpt_dir=args.ckpt_dir,
            export_legacy=_flag(args.export_legacy),
            epoch_block=args.epoch_block,
            streamer=streamer,
            regen_cadence=(int(args.regen_cadence) if str(args.regen_cadence) != "auto"
                           else "auto"),
            on_device_augment=on_device_augment,
            augment_per_epoch=False,  # fused mode: a fresh render per block
            max_wall_s=args.max_wall_s,
            media_async=bool(args.media_async),
            watch_log_freq=args.watch_log_freq or None,
            device=args.device,
        )
    finally:
        if streamer is not None:
            streamer.close()


def _setup_streaming(args, dataset_train):
    """``--streaming`` → (streamer, on_device_augment, dataset_for_training):
    fresh-augmentation training for the random-masking experiments (see the
    module docstring); under several processes each rank's host streamer
    takes its equal shard of the corpus."""
    if args.streaming == "off":
        return None, None, dataset_train

    from ..data.datasets import GrooveMidiDatasetInfillingRandom
    from ..ops.mso import MSOParams

    if not isinstance(dataset_train, GrooveMidiDatasetInfillingRandom):
        raise SystemExit(
            "--streaming regenerates random-event maskings and applies to the "
            "InfillingRandom / InfillingRandomLow experiments; the voice-combination "
            "experiments train on their pickled augmentations (run with --streaming off)")

    base_seqs = dataset_train.hvo_sequences
    base = np.stack([s.hvo for s in base_seqs]).astype(np.float32)
    qpms = np.asarray([s.tempos[0].qpm for s in base_seqs], np.float64)
    fanout = int(args.aug_per_item or dataset_train.max_aug_items)
    mso_params = MSOParams(**dataset_train.mso_params)
    sfs = dataset_train.sfs_list or [None]
    thres = tuple(getattr(dataset_train, "thres_range", (0.4, 0.6)))

    if args.streaming == "host":
        from ..data.pipeline import StreamingAugmenter
        from ..parallel.multihost import context, process_count, process_index

        n_proc, pid = process_count(), process_index()
        if n_proc > 1:
            per = len(base) // n_proc
            if per == 0:
                raise SystemExit(f"--streaming with {n_proc} processes needs a corpus of at "
                                 f"least {n_proc} loops (got {len(base)})")
            if per * n_proc != len(base) and pid == 0:
                print(f"streaming: trimming corpus {len(base)} -> {per * n_proc} loops "
                      f"({n_proc} equal process shards)")
            base = base[pid * per:(pid + 1) * per]
            qpms = qpms[pid * per:(pid + 1) * per]
        streamer = StreamingAugmenter(
            base, qpms=qpms, aug_per_item=fanout, mode="audio", thres_range=thres,
            soundfonts=sfs, mso_params=mso_params, partial=args.regen_partial,
            # distinct streams, spaced far apart: generation g of a streamer
            # draws from default_rng(seed + g)
            seed=pid * (1 << 20),
            device=context().device if context() is not None else args.device)
        print(f"streaming(host): {len(base)} loops x {fanout} fresh augmentations = "
              f"{streamer.n_samples} items/generation, partial=1/{args.regen_partial}, "
              f"cadence={args.regen_cadence}")
        # run_training sizes off streamer.n_samples and never reads the dataset
        return streamer, None, dataset_train

    from ..data.device_pipeline import make_on_device_augment

    grids = np.repeat(base, fanout, axis=0)
    qpms_r = np.repeat(qpms, fanout, axis=0)
    n = (len(grids) // 64) * 64  # as root train.py: see the module docstring
    if n == 0:
        raise SystemExit("--streaming fused needs >= 64 augmented items "
                         "(corpus x aug_per_item); use --streaming host")
    if n != len(grids):
        print(f"streaming(fused): trimming {len(grids)} -> {n} items (64-item chunks, "
              "as root train.py)")

    class _Grids:  # run_training reads the two arrays
        processed_inputs = processed_outputs = grids[:n]

    augment = make_on_device_augment(qpms=qpms_r[:n], mode="audio", thres_range=thres,
                                     soundfonts=sfs, mso_params=mso_params)
    print(f"streaming(fused): {n} items re-rendered on device per block")
    return None, augment, _Grids


if __name__ == "__main__":
    main()
