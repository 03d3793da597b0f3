"""Offline evaluator preprocessing, as the repository's root
``process_evaluator.py`` does it for the JAX package, on the port::

    python -m transformergrooveinfilling_tpu_torch.process_evaluator \\
        --experiments InfillingRandom --splits train validation [--device cpu]

One :class:`~.eval.evaluator.InfillingEvaluator` per experiment × split: the
GT style subsets pushed through the experiment's dataset pipeline (for the
audio experiments: rendered and analysed on ``--device``, on the card kernels
#6 and #7), pickled under
``datasets/preprocessed_evaluators/InfillingEvaluator_<version>/`` where
``configs/paths.yaml`` expects it. The pickles name the JAX package's
classes, so either package's ``init_evaluator`` loads them.

The flags are root ``process_evaluator.py``'s, plus ``--device`` (default
``cuda``). Paths are read by ``utils/yaml_subset.py``. Unlike root's, the
dataset's masking draws are seeded (:data:`EVALUATOR_SEED` plus the split's
offset), so two builds of one split are equal, on the card and on the CPU
alike but for the float differences of the MSO inputs.
"""

from __future__ import annotations

import argparse
import os

from .data import dataset_class_for_experiment
from .data.experiments import EXPERIMENTS
from .eval.evaluator import InfillingEvaluator
from .process_dataset import _SPLIT_SEEDS, corpus_for_split
from .train.config import load_paths

# the evaluator's draws are its own: offset from the seeds the dataset's build used
EVALUATOR_SEED = 1000


def build_evaluator(exp: str, split: str, dataset_path: str, source: str | None = None,
                    n_samples_to_use: int = 1024, n_samples_to_synthesize: int = 20,
                    n_synthetic: int | None = None, device="cuda") -> str:
    """Build the ``split`` evaluator of ``exp`` from the processed dataset at
    ``dataset_path`` on ``device`` → the pickle's path."""
    dataset = dataset_class_for_experiment(exp)(
        load_dataset_path=dataset_path, seed=EVALUATOR_SEED + _SPLIT_SEEDS.get(split, 0),
        device=device)
    if source is None:
        # the corpus the dataset itself was built from (its subset_info): a
        # different GT corpus would score the model on loops training never saw
        source = dataset.subset_info.get("pickle_source_path") or "synthetic"
    sequences = corpus_for_split(source, split, n_synthetic)
    evaluator = InfillingEvaluator(
        pickle_source_path=dataset.subset_info["pickle_source_path"],
        set_subfolder=dataset.subset_info["subset"],
        hvo_pickle_filename=dataset.subset_info["hvo_pickle_filename"],
        max_hvo_shape=(32, 27),
        n_samples_to_use=n_samples_to_use,
        n_samples_to_synthesize_visualize_per_subset=n_samples_to_synthesize,
        _identifier=split.capitalize() + "_Set",
        disable_tqdm=False,
        analyze_heatmap=True,
        analyze_global_features=False,
        dataset=dataset,
        horizontal=exp not in ("InfillingRandom", "InfillingRandomLow"),
        device=device,
        sequences=sequences,
    )
    return evaluator.save_as_pickle(save_evaluator_path="datasets/preprocessed_evaluators")


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m transformergrooveinfilling_tpu_torch.process_evaluator")
    p.add_argument("--experiments", nargs="*", default=list(EXPERIMENTS))
    p.add_argument("--splits", nargs="*", default=["test", "train", "validation"])
    p.add_argument("--source", default=None,
                   help="GT corpus; default = the one the dataset was built from (its "
                        "recorded subset_info)")
    p.add_argument("--testing", action="store_true")
    p.add_argument("--n-synthetic", type=int, default=None)
    p.add_argument("--paths", default="configs/paths.yaml")
    p.add_argument("--device", default="cuda",
                   help="where the audio experiments render and analyse the GT loops "
                        "('cuda' or 'cpu')")
    args = p.parse_args(argv)

    paths = load_paths(args.paths)
    n_use = 10 if args.testing else 1024
    n_synth = 5 if args.testing else 20
    for exp in args.experiments:
        exp_key = exp + "_testing" if args.testing else exp
        if exp_key not in paths:
            print(f"skipping {exp_key}: not in {args.paths}")
            continue
        print(f"--- {exp_key} ---")
        for split in args.splits:
            ds_path = paths[exp_key]["datasets"].get(split)
            if not ds_path or not os.path.isdir(ds_path):
                print(f"  {split}: dataset pickle missing at {ds_path}, skip")
                continue
            out = build_evaluator(
                exp, split, ds_path, args.source, n_samples_to_use=n_use,
                n_samples_to_synthesize=n_synth,
                n_synthetic=args.n_synthetic or (24 if args.testing else None),
                device=args.device)
            print(f"  {split}: -> {out}")


if __name__ == "__main__":
    main()
