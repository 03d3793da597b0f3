"""Unpickling shims for reference-era artifacts, as the JAX package's
``data/legacy_pickle.py``, on the reader that also maps the JAX package's
record classes onto the port's.

The reference's dataset and evaluator pickles name classes from modules that
exist in neither package (``hvo_sequence.*``, ``dataset``, ``evaluator``).
:class:`_LegacyUnpickler` resolves those to tolerant stand-ins, and
:func:`to_native` converts them to :class:`HVOSequence`. It extends
``utils/serialization.py::JaxNamesUnpickler``, so a pickle the JAX package
wrote yields the port's classes and never imports jax. Torch tensors inside
legacy pickles resolve through torch and convert to numpy in ``to_native``.
"""

from __future__ import annotations

import io

import numpy as np

from ..hvo import HVOSequence
from ..hvo.sequence import Metadata, Tempo, TimeSignature
from ..utils.serialization import JaxNamesUnpickler


class _LegacyObject:
    """Absorbs any pickled state; attribute access mirrors the original."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _LegacyUnpickler(JaxNamesUnpickler):
    _SHIMS = {
        "HVO_Sequence": _LegacyObject,
        "Time_Signature": _LegacyObject,
        "Tempo": _LegacyObject,
        "Metadata": _LegacyObject,
    }

    def find_class(self, module, name):
        if name in self._SHIMS and (
            module.startswith("hvo_sequence") or module in ("dataset", "evaluator")
        ):
            return self._SHIMS[name]
        if module.startswith(("dataset", "evaluator", "GrooveEvaluator",
                              "BaseGrooveTransformers", "preprocessed_dataset")):
            return _LegacyObject
        # the JAX package's records map onto the port's; torch modules
        # resolve through torch, and tensors convert to numpy in to_native
        return super().find_class(module, name)


def legacy_load(path_or_bytes):
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return _LegacyUnpickler(io.BytesIO(path_or_bytes)).load()
    with open(path_or_bytes, "rb") as f:
        return _LegacyUnpickler(f).load()


def _to_numpy(x):
    if hasattr(x, "detach"):  # torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dget(d: dict, key, default=None):
    """Probe the plain, single-underscore, *and name-mangled* spellings of an
    attribute. The real hvo_sequence library stores state as ``self.__hvo``
    etc. behind @property accessors, so its pickles carry ``__dict__`` keys
    like ``_HVO_Sequence__hvo`` / ``_Metadata__style_primary`` — missing
    those silently converts every loaded corpus item to an all-zero default
    sequence."""
    for k in (key, "_" + key):
        if k in d:
            return d[k]
    suffix = "__" + key
    for k, v in d.items():
        if k.startswith("_") and k.endswith(suffix):
            return v
    return default


def to_native(obj) -> HVOSequence:
    """Convert a legacy HVO_Sequence-shaped object to :class:`HVOSequence`."""
    if isinstance(obj, HVOSequence):
        return obj
    d = getattr(obj, "__dict__", {})
    hvo_raw = _dget(d, "hvo")
    hvo = _to_numpy(hvo_raw) if hvo_raw is not None else np.zeros((32, 27))

    def _meta_get(key, default=""):
        meta = _dget(d, "metadata")
        if meta is None:
            return _dget(d, key, default)
        if isinstance(meta, dict):
            return _dget(meta, key, default)
        return _dget(getattr(meta, "__dict__", {}) or {}, key, default)

    metadata = Metadata(
        drummer=str(_meta_get("drummer")),
        session=str(_meta_get("session")),
        master_id=str(_meta_get("master_id")),
        style_primary=str(_meta_get("style_primary")),
        style_secondary=str(_meta_get("style_secondary")),
        beat_type=str(_meta_get("beat_type")),
        loop_id=str(_meta_get("loop_id")),
        bpm=float(_meta_get("bpm", 0.0) or 0.0),
    )

    ts_raw = _dget(d, "time_signatures") or [None]
    signatures = []
    for ts in ts_raw:
        td = getattr(ts, "__dict__", {}) if ts is not None else {}
        signatures.append(
            TimeSignature(
                time_step=int(_dget(td, "time_step", 0) or 0),
                numerator=int(_dget(td, "numerator", 4) or 4),
                denominator=int(_dget(td, "denominator", 4) or 4),
            )
        )

    tempo_raw = _dget(d, "tempos") or [None]
    tempos = []
    for tp in tempo_raw:
        td = getattr(tp, "__dict__", {}) if tp is not None else {}
        tempos.append(Tempo(qpm=float(_dget(td, "qpm", 120.0) or 120.0)))

    return HVOSequence(
        hvo=np.asarray(hvo, dtype=np.float64),
        time_signatures=signatures or [TimeSignature()],
        tempos=tempos or [Tempo()],
        metadata=metadata,
    )
