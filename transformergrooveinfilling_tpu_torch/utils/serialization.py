"""Pickle/JSON helpers, as the JAX package's ``utils/serialization.py``, and
the one rule that lets a pickle cross between the packages.

A pickle names each object's class by module path. Three families of the
port's classes have the JAX package's fields and state under the same
names (:data:`CROSSING`): the ``HVOSequence`` records that dataset pickles
hold, and the evaluators and the datasets that an evaluator pickle holds.
Only the module path decides which package's class a reader gets:

- :func:`save_to_pickle` writes those classes under the JAX package's path
  (``transformergrooveinfilling_tpu.hvo.sequence`` and so on), so that the
  JAX package reads back its own classes. The standard pickler checks every
  class name by importing its module, and importing any module of the JAX
  package imports jax, which the machine with the card does not have. So the
  writer is a subclass of the pure-Python pickler (``pickle._Pickler``) whose
  ``save_global`` writes those names without importing them (the C pickler
  has no such hook); everything else it pickles as the standard pickler
  does, in the default protocol.
- :func:`load_pickle` maps those paths back onto the port's classes without
  importing them, and refuses any other name of the JAX package rather than
  import jax. ``data/legacy_pickle.py`` adds the reference-era shims to the
  same reader.

State that only one package has stays out of the pickle: a dataset's
``_device`` (``data/datasets.py``) and an evaluator's ``device``
(``eval/evaluator.py``) are the loader's to set.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle

import numpy as np

PORT_PACKAGE = "transformergrooveinfilling_tpu_torch"
JAX_PACKAGE = "transformergrooveinfilling_tpu"
# module (relative to either package) -> the classes that cross under its path
CROSSING = {
    "hvo.sequence": ("HVOSequence", "TimeSignature", "Tempo", "Metadata"),
    "eval.evaluator": ("InfillingEvaluator", "HVOSeqSubsetInfillingEvaluator"),
    "data.datasets": ("GrooveMidiDatasetInfilling", "GrooveMidiDatasetInfillingSymbolic",
                      "GrooveMidiDatasetInfillingRandom"),
}


def _crossing(module: str, name: str) -> str | None:
    """The module of :data:`CROSSING` that ``module.name`` is, under either
    package's path, or None."""
    for package in (PORT_PACKAGE, JAX_PACKAGE):
        sub = module.removeprefix(package + ".")
        if sub != module and name in CROSSING.get(sub, ()):
            return sub
    return None


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
    """Pickles as ``pickle.Pickler`` does, with the port's classes of
    :data:`CROSSING` written under the JAX package's module path (not
    imported)."""

    def save_global(self, obj, name=None):
        sub = (_crossing(obj.__module__, obj.__qualname__)
               if isinstance(obj, type) and obj.__module__.startswith(PORT_PACKAGE + ".")
               else None)
        if sub is not None:
            module = f"{JAX_PACKAGE}.{sub}"
            if self.proto >= 4:
                self.save(module)
                self.save(obj.__qualname__)
                self.write(pickle.STACK_GLOBAL)
            else:
                self.write(pickle.GLOBAL + f"{module}\n{obj.__qualname__}\n".encode())
            self.memoize(obj)
            return
        super().save_global(obj, name)


class JaxNamesUnpickler(pickle.Unpickler):
    """Reads the JAX package's classes of :data:`CROSSING` as the port's,
    and refuses every other name of the JAX package (importing it would
    import jax)."""

    def find_class(self, module, name):
        sub = _crossing(module, name)
        if sub is not None:
            return getattr(importlib.import_module(f"{PORT_PACKAGE}.{sub}"), name)
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
