"""Pickle/JSON helpers, as the JAX package's ``utils/serialization.py``."""

from __future__ import annotations

import json
import os
import pickle

import numpy as np


class NpEncoder(json.JSONEncoder):
    """JSON encoder accepting numpy scalars and arrays."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def save_to_pickle(obj, filename: str):
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(filename: str):
    with open(filename, "rb") as f:
        return pickle.load(f)


def save_parameters_to_json(params: dict, params_path: str):
    os.makedirs(params_path, exist_ok=True)
    out = os.path.join(params_path, params["dataset_name"] + "_params.json")
    with open(out, "w") as f:
        json.dump(params, f, cls=NpEncoder)
    return out
