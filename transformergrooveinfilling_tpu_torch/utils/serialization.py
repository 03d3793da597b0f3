"""Pickle/JSON helpers, as the JAX package's ``utils/serialization.py``, and
the one rule that lets a pickle cross between the packages.

Dataset pickles hold ``HVOSequence`` records, and a pickle names each record's
class by module path. The two packages' classes have the same fields, so
only that name decides which package's class a reader gets:

- :func:`save_to_pickle` writes the port's record classes
  (``hvo/sequence.py``) under the JAX package's path,
  ``transformergrooveinfilling_tpu.hvo.sequence``, so that the JAX package
  reads back its own classes. The standard pickler checks every class name by
  importing its module, and importing any module of the JAX package imports
  jax, which the machine with the card does not have. So the writer is a
  subclass of the pure-Python pickler (``pickle._Pickler``) whose
  ``save_global`` writes those names without importing them (the C pickler
  has no such hook); everything else it pickles as the standard pickler
  does, in the default protocol.
- :func:`load_pickle` maps that path back onto the port's classes without
  importing it, and refuses any other name of the JAX package rather than
  import jax. ``data/legacy_pickle.py`` adds the reference-era shims to the
  same reader.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

PORT_RECORDS = "transformergrooveinfilling_tpu_torch.hvo.sequence"
JAX_RECORDS = "transformergrooveinfilling_tpu.hvo.sequence"
JAX_PACKAGE = "transformergrooveinfilling_tpu"
RECORD_CLASSES = ("HVOSequence", "TimeSignature", "Tempo", "Metadata")


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


class JaxNamesPickler(pickle._Pickler):
    """Pickles as ``pickle.Pickler`` does, with the port's record classes
    written under the JAX package's module path (not imported)."""

    def save_global(self, obj, name=None):
        if (isinstance(obj, type) and obj.__module__ == PORT_RECORDS
                and obj.__qualname__ in RECORD_CLASSES):
            if self.proto >= 4:
                self.save(JAX_RECORDS)
                self.save(obj.__qualname__)
                self.write(pickle.STACK_GLOBAL)
            else:
                self.write(pickle.GLOBAL + f"{JAX_RECORDS}\n{obj.__qualname__}\n".encode())
            self.memoize(obj)
            return
        super().save_global(obj, name)


class JaxNamesUnpickler(pickle.Unpickler):
    """Reads the JAX package's record classes as the port's, and refuses
    every other name of the JAX package (importing it would import jax)."""

    def find_class(self, module, name):
        if module in (JAX_RECORDS, PORT_RECORDS) and name in RECORD_CLASSES:
            from ..hvo import sequence

            return getattr(sequence, name)
        if module == JAX_PACKAGE or module.startswith(JAX_PACKAGE + "."):
            raise pickle.UnpicklingError(
                f"{module}.{name}: a class of the JAX package that the port does not map; "
                "loading it would import jax")
        return super().find_class(module, name)


def save_to_pickle(obj, filename: str):
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "wb") as f:
        JaxNamesPickler(f, pickle.DEFAULT_PROTOCOL).dump(obj)


def load_pickle(filename: str):
    with open(filename, "rb") as f:
        return JaxNamesUnpickler(f).load()


def save_parameters_to_json(params: dict, params_path: str):
    os.makedirs(params_path, exist_ok=True)
    out = os.path.join(params_path, params["dataset_name"] + "_params.json")
    with open(out, "w") as f:
        json.dump(params, f, cls=NpEncoder)
    return out
