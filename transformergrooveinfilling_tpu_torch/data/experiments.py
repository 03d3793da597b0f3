"""Per-experiment dataset-construction parameters, as the JAX package's
``data/experiments.py``.

The reference ships these in ``datasets/dataset_parameters.json`` inside its
data download. The values reconstruct each experiment's masking task from its
name and dataset class:

- InfillingClosedHH(_Symbolic): remove the closed hi-hat voice (index 2),
- InfillingKicksAndSnares: remove kick and/or snare (indices 0, 1),
- InfillingRandom(/Low): remove a random ~40-60% (Low: ~10-30%) of all events.
"""

from __future__ import annotations

import copy

EXPERIMENTS = (
    "InfillingClosedHH",
    "InfillingClosedHH_Symbolic",
    "InfillingKicksAndSnares",
    "InfillingRandom",
    "InfillingRandomLow",
)

_CLOSED_HH_VOICES = {
    "voice_idx": [2],
    "min_n_voices_to_remove": 1,
    "max_n_voices_to_remove": 1,
    "prob": [1],
    "k": 5,
}

_KICK_SNARE_VOICES = {
    "voice_idx": [0, 1],
    "min_n_voices_to_remove": 1,
    "max_n_voices_to_remove": 2,
    "prob": [1, 1],
    "k": 5,
}

EXPERIMENT_PARAMS = {
    "InfillingClosedHH": {
        "dataset_name": "InfillingClosedHH",
        "voices_params": _CLOSED_HH_VOICES,
        "max_aug_items": 10,
    },
    "InfillingClosedHH_Symbolic": {
        "dataset_name": "InfillingClosedHH_Symbolic",
        "voices_params": _CLOSED_HH_VOICES,
        "max_aug_items": 10,
    },
    "InfillingKicksAndSnares": {
        "dataset_name": "InfillingKicksAndSnares",
        "voices_params": _KICK_SNARE_VOICES,
        "max_aug_items": 10,
    },
    "InfillingRandom": {
        "dataset_name": "InfillingRandom",
        "thres_range": (0.4, 0.6),
        "max_aug_items": 10,
    },
    "InfillingRandomLow": {
        "dataset_name": "InfillingRandomLow",
        "thres_range": (0.1, 0.3),
        "max_aug_items": 10,
    },
}

TESTING_MASTER_IDS = [
    "drummer9/session1/8",
    "drummer9/session1/7",
    "drummer9/session1/12",
]


def params_for(experiment: str, testing: bool = False) -> dict:
    params = copy.deepcopy(EXPERIMENT_PARAMS[experiment])
    if testing:
        params["dataset_name"] = params["dataset_name"] + "_testing"
    return params
