"""Walkthrough of the port's user surfaces, the counterpart of the
repository's root ``tutorial.py`` (which drives the JAX package)::

    python -m transformergrooveinfilling_tpu_torch.tutorial [--device cuda|cpu]

Eight steps, end to end, in a temporary directory that is removed at the end:

1. a dataset: the ``InfillingClosedHH`` experiment's testing subset (the
   synthetic corpus's first 24 train loops), its inputs the onset spectra of
   the loops' renders (on the card through the synthesizer and band-energy
   kernels), pickled and reloaded;
2. an evaluator over it, pickled and reloaded;
3. a model, a checkpoint saved and resumed, the repository's demo checkpoint
   directory resumed, and its reference-era ``.Model`` resumed on its own;
4. prediction over the evaluator and its metric families;
5. serving an infill through ``InfillServer``;
6. scale-out: the matmul dtype this device resolves to, and, in a group of
   at least 4 ranks, the pipelined forward over data 2 × pipe 2 (else how to
   start such a group);
7. an exported artifact (``export_infill``, ``load_infill``), its programs
   holding the attention kernel;
8. offline evaluation of the saved checkpoint (``evaluate``).

``--device`` (default ``cuda``) is where everything runs; ``cuda`` without
CUDA raises, as every entry point of the port does. Started once per rank
with torchrun's names (``torchrun --nproc-per-node 4 -m
transformergrooveinfilling_tpu_torch.tutorial``) or the JAX package's
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), every
rank walks through all steps, and step 6 runs the pipeline over the group.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_DIR = os.path.join(REPO, "demo")
DEMO_MODEL = "transformer_run_demo_Epoch_799.Model"
EXPERIMENT = "InfillingClosedHH"
TESTING_LOOPS = 24  # process_dataset --testing's synthetic fixture


def run(device: str, work: str) -> None:
    import torch

    from . import require_device
    from .data import load_processed_dataset, synthetic_gmd_sequences
    from .data.experiments import params_for
    from .eval.evaluator import InfillingEvaluator, init_evaluator
    from .hvo import ROLAND_REDUCED_MAPPING
    from .process_dataset import process_dataset
    from .train import checkpoint as ckpt
    from .train import initialize_model

    device = str(require_device(device, "tutorial"))
    print(f"working dir: {work}; device: {device}")

    # -- 1. dataset -----------------------------------------------------------
    print(f"\n[1] building the {EXPERIMENT} testing subset (audio inputs)...")
    params_ds = params_for(EXPERIMENT, testing=True)
    params_ds.update(split="train", seed=100,
                     save_dataset_path=os.path.join(work, "datasets", params_ds["dataset_name"]),
                     subset_info={"filters": {"beat_type": ["beat"],
                                              "time_signature": ["4-4"]}})
    corpus = synthetic_gmd_sequences(n=330, seed=100)[:TESTING_LOOPS]
    dataset = process_dataset(params_ds, EXPERIMENT, corpus, device=device)
    print(f"    {len(dataset)} (input, target, idx) items; input shape "
          f"{tuple(dataset[0][0].shape)}")
    reloaded = load_processed_dataset(dataset.save_dataset_path, exp=EXPERIMENT)
    print(f"    reloaded from its pickle: {len(reloaded)} items")

    # -- 2. evaluator ---------------------------------------------------------
    print("\n[2] building + pickling the evaluator...")
    evaluator = InfillingEvaluator(
        _identifier="Train_Set", n_samples_to_use=64,
        n_samples_to_synthesize_visualize_per_subset=2,
        dataset=reloaded, sequences=corpus, horizontal=True, device=device)
    ev_path = evaluator.save_as_pickle(os.path.join(work, "evaluators"))
    evaluator = init_evaluator(ev_path, device=device)
    print(f"    styles: {evaluator._gt_tags}")

    # -- 3. model + checkpoint resume -----------------------------------------
    print("\n[3] initializing the model (and saving/resuming a checkpoint)...")
    params = {
        "model": {"experiment": EXPERIMENT, "encoder_only": 1, "optimizer": "sgd",
                  "d_model": 32, "n_heads": 4, "dim_feedforward": 16, "dropout": 0.18,
                  "num_encoder_layers": 6, "num_decoder_layers": 0, "max_len": 32,
                  "embedding_size_src": 16, "embedding_size_tgt": 27, "bf16": False},
        "training": {"learning_rate": 0.094, "batch_size": 32, "hit_loss_penalty": 0.47},
        "load_model": None,
    }
    bundle, _opt, _epoch = initialize_model(params, device)
    ckpt_dir = os.path.join(work, "checkpoints")
    ckpt.save_checkpoint(ckpt_dir, "tutorial", 0, bundle.state, 9.9, bundle.config)
    params["load_model"] = {"location": "local", "dir": ckpt_dir}
    bundle, _opt, initial_epoch = initialize_model(params, device)
    print(f"    resumed at epoch {initial_epoch}")

    # the repository's demo: the retrained symbolic model (Adam, ff 512). Its
    # directory holds a native .ckpt, which a directory prefers; the params
    # must match the checkpoint's architecture, as the reference requires
    demo_model = dict(params["model"], experiment="InfillingClosedHH_Symbolic",
                      optimizer="adam", dim_feedforward=512, dropout=0.1,
                      embedding_size_src=27)
    demo_params = {"model": demo_model,
                   "training": dict(params["training"], learning_rate=3e-4),
                   "load_model": {"location": "local", "dir": DEMO_DIR}}
    _demo, _o, ep = initialize_model(demo_params, device)
    print(f"    in-repo demo checkpoint resumed at epoch {ep}")
    # its reference-era torch .Model loads the same way, alone in a directory
    legacy_dir = os.path.join(work, "legacy")
    os.makedirs(legacy_dir)
    shutil.copy(os.path.join(DEMO_DIR, DEMO_MODEL), legacy_dir)
    demo_params["load_model"] = {"location": "local", "dir": legacy_dir,
                                 "file_pattern": "transformer_run_{}_Epoch_{}.Model"}
    _legacy, _o, ep = initialize_model(demo_params, device)
    print(f"    reference .Model checkpoint resumed at epoch {ep}")

    # -- 4. prediction + metrics ----------------------------------------------
    print("\n[4] prediction + metric suite...")
    evaluator.set_pred(bundle)
    acc = evaluator.get_hits_accuracies(ROLAND_REDUCED_MAPPING)
    print(f"    mean hit accuracy (untrained): {acc['Train_Set_Hits_Accuracy_mean']:.3f}")

    # -- 5. serving -----------------------------------------------------------
    print("\n[5] low-latency serving...")
    from .serve import InfillServer

    server = InfillServer(bundle.model.state_dict(), bundle.config, batch_sizes=(1,),
                          device=device)
    x0 = np.asarray(dataset[0][0], np.float32)
    out = server.infill(x0)
    print(f"    infill output {out.shape}; p50 so far {server.stats.percentile(50):.2f} ms")

    # -- 6. scale-out ---------------------------------------------------------
    from .train.config import resolve_compute_dtype

    print(f"\n[6] scale-out: matmul dtype here by default = "
          f"{str(resolve_compute_dtype(None, device)).removeprefix('torch.')}")
    # pipeline parallelism for deep configs: a ("data", "pipe") mesh splits
    # the encoder stack across ranks (GPipe microbatch schedule,
    # parallel/pipeline.py); runs in a group of exactly 4 ranks
    from .parallel.multihost import process_count

    if process_count() == 4 and bundle.config.num_encoder_layers % 2 == 0:
        from .parallel import make_pipeline_mesh, pipeline_forward

        plan = make_pipeline_mesh(n_stages=2, n_data=2, n_micro=2, device=device)
        x4 = torch.as_tensor(np.repeat(x0[None], 4, axis=0), device=plan.device)
        h_, _v, _o = pipeline_forward(bundle.model, x4, plan)
        print(f"    pipelined forward over data=2 x pipe=2 ({plan.backend}, "
              f"{plan.transport} transport): {tuple(h_.shape)}")
    else:
        print(f"    (the pipelined forward runs in a group of 4 ranks, this run has "
              f"{process_count()}: start one with torchrun --nproc-per-node 4 -m "
              "transformergrooveinfilling_tpu_torch.tutorial, or with the JAX names "
              "JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID per rank)")

    # -- 7. deployment: serving artifacts -------------------------------------
    # a checkpoint's serving predict exports to one artifact: torch.export
    # programs per batch bucket with the attention kernel inside, the
    # parameters once beside them (export.py)
    from .export import export_infill, load_infill

    art = export_infill(bundle.model.state_dict(), bundle.config,
                        os.path.join(work, "tutorial.tgix"), batch_sizes=(1, 4))
    loaded = load_infill(art, device=device)
    pred = loaded.predict(x0)
    print(f"\n[7] exported artifact: {os.path.getsize(art) / 1e6:.1f} MB, buckets "
          f"{loaded.batch_sizes}, predict -> {pred.shape}, equal to the server's: "
          f"{bool(np.allclose(pred, out, atol=1e-5))}")

    # -- 8. offline evaluation ------------------------------------------------
    print("\n[8] offline evaluation of the saved checkpoint...")
    from . import evaluate as evaluate_cli

    evaluate_cli.main(["--ckpt", ckpt_dir, "--evaluator", ev_path, "--media", "0",
                       "--run_dir", os.path.join(work, "eval"), "--device", device])
    print("\ntutorial complete.")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    os.environ.setdefault("WANDB_MODE", "offline")
    from . import require_device
    from .parallel.multihost import initialize_from_env

    initialize_from_env(require_device(args.device, "tutorial"))
    with tempfile.TemporaryDirectory(prefix="tgi_tutorial_") as work:
        cwd = os.getcwd()
        os.chdir(work)  # the evaluator's dumps and logs land under the work dir
        try:
            run(args.device, work)
        finally:
            os.chdir(cwd)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
