"""Offline dataset preprocessing, as the repository's root
``process_dataset.py`` does it for the JAX package, on the port.

Corpus → filtered subsets → per-experiment infilling dataset pickles under
``datasets/<name>/<version>/<split>/`` (the layout ``configs/paths.yaml``
points at)::

    python -m transformergrooveinfilling_tpu_torch.process_dataset \\
        --experiments InfillingRandom [--device cpu]

Corpus sources:

- ``--source synthetic`` (default): the seeded synthetic GMD-style corpus
  (``data/synthetic.py``), 330 / 110 / 110 loops for train / test /
  validation;
- ``--source <dir>``: a GrooveMIDI processed tree
  (``<dir>/GrooveMIDI_processed_<split>/hvo_sequence_data.obj``), pickles
  of either package or of the reference.

``--testing`` is the reference's tiny-fixture mode: restrict to 3 master_ids
(the synthetic corpus: its first 24 loops) and rename the dataset
``*_testing``. The flags are root ``process_dataset.py``'s, plus ``--device``
(default ``cuda``): where the audio experiments render and analyse their
inputs. Each split's seed is ``--seed`` plus a fixed offset per split, so a
build is the same in either package, and the pickles load in either.
"""

from __future__ import annotations

import argparse
import copy
import json
import os

from .data import GrooveMidiSubsetter, dataset_class_for_experiment, synthetic_gmd_sequences
from .data.experiments import EXPERIMENTS, TESTING_MASTER_IDS, params_for

_SPLIT_SEEDS = {"train": 100, "test": 200, "validation": 300}
_SPLIT_SIZES = {"train": 330, "test": 110, "validation": 110}


def corpus_for_split(source: str, split: str, n_synthetic: int | None = None):
    if source == "synthetic":
        return synthetic_gmd_sequences(n=n_synthetic or _SPLIT_SIZES[split],
                                       seed=_SPLIT_SEEDS[split])
    sub = GrooveMidiSubsetter(pickle_source_path=source, subset=f"GrooveMIDI_processed_{split}",
                              hvo_pickle_filename="hvo_sequence_data.obj")
    _tags, subsets = sub.create_subsets()
    return subsets[0]


def process_dataset(params: dict, exp: str, data, device="cuda"):
    """Subset by ``params["subset_info"]["filters"]``, then build the
    experiment's dataset class on ``device``."""
    filters = params.get("subset_info", {}).get("filters") or None
    _tags, subsets = GrooveMidiSubsetter(
        sequences=data, list_of_filter_dicts_for_subsets=[filters]).create_subsets()
    return dataset_class_for_experiment(exp)(data=subsets[0], device=device, **params)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--experiments", nargs="*", default=list(EXPERIMENTS))
    p.add_argument("--splits", nargs="*", default=["train", "test", "validation"])
    p.add_argument("--source", default="synthetic",
                   help="'synthetic' or a GrooveMIDI processed tree")
    p.add_argument("--testing", action="store_true", help="3-master_id tiny-fixture mode")
    p.add_argument("--n-synthetic", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--params-json", default=None,
                   help="optional dataset_parameters.json overriding built-ins")
    p.add_argument("--device", default="cuda",
                   help="where the audio experiments render and analyse their inputs "
                        "('cuda' or 'cpu')")
    args = p.parse_args(argv)

    overrides = {}
    if args.params_json and os.path.exists(args.params_json):
        with open(args.params_json) as f:
            overrides = json.load(f)

    for exp in args.experiments:
        params = params_for(exp, testing=args.testing)
        params.update(copy.deepcopy(overrides.get(exp, {})))
        if "thres_range" in params:
            params["thres_range"] = tuple(params["thres_range"])
        params["save_dataset_path"] = os.path.join("datasets", params["dataset_name"])
        print(f"--- {params['dataset_name']} ---")
        for split in args.splits:
            data = corpus_for_split(args.source, split, args.n_synthetic)
            params_exp = copy.deepcopy(params)
            params_exp["split"] = split
            # a fixed seed per split: str hash is salted per process
            params_exp["seed"] = args.seed + _SPLIT_SEEDS.get(split, 0)
            filters = {"beat_type": ["beat"], "time_signature": ["4-4"]}
            if args.testing:
                # the reference's testing mode adds the 3-master_id filter;
                # the synthetic corpus shrinks to a tiny fixture instead
                if args.source == "synthetic":
                    data = data[: (args.n_synthetic or 24)]
                else:
                    filters["master_id"] = TESTING_MASTER_IDS
            params_exp["subset_info"] = {
                "pickle_source_path": args.source,
                "subset": f"GrooveMIDI_processed_{split}",
                "metadata_csv_filename": "metadata.csv",
                "hvo_pickle_filename": "hvo_sequence_data.obj",
                "filters": filters,
            }
            ds = process_dataset(params_exp, exp=exp, data=data, device=args.device)
            print(f"  {split}: {len(ds)} items -> {ds.save_dataset_path}")


if __name__ == "__main__":
    main()
