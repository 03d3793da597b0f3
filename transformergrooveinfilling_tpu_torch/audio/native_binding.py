"""ctypes binding of the host synthesizer core (``audio/native/sf2synth.cpp``),
as the JAX package's ``audio/native_binding.py``, with its numpy
counterparts.

The port carries its own copy of the C++ source and builds it with ``g++`` at
first use into ``build/native/sf2synth-<hash>/`` at the repository root (the
directory the CUDA kernels are built into; ``.gitignore`` lists it), keyed by
a hash of the source and the flags, so an edited source rebuilds. It never
writes next to the source and never loads the JAX package's library.

Where no ``g++`` is found, :func:`native_available` says so once on stderr
and returns False, and the callers (``audio/synth.py``, ``audio/sf2.py``) take
the numpy versions below, which give the same bits. A failed compile, or a
fault inside a call, raises: nothing falls back silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "sf2synth.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-pthread")

_lock = threading.Lock()
_lib = None
_warned = False

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def library_path() -> Path:
    """Where this source's library is built: the hash covers the source and
    the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"sf2synth-{digest}" / "libsf2synth.so"


def _build() -> Path:
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native mixer is built at first use")
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    # a per-process name renamed into place: a concurrent builder (test
    # workers, dataset children) never loads a half-written library
    tmp = lib_path.with_name(f"libsf2synth.{os.getpid()}.so.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if tmp.exists():
            tmp.unlink()
    return lib_path


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use (raises where it cannot be)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.tgi_mix_events.restype = None
            lib.tgi_mix_batch.restype = None
            lib.tgi_resample_linear.restype = ctypes.c_int64
            lib.tgi_biquad.restype = None
            _lib = lib
    return _lib


def native_available() -> bool:
    """True where the library is loaded, built, or can be built; False only
    where no ``g++`` is found (said once on stderr). A build that fails
    raises."""
    global _warned
    if _lib is not None or library_path().exists() or shutil.which("g++") is not None:
        get_lib()
        return True
    if not _warned:
        _warned = True
        print("audio: g++ not found; the host mixer, resampler and biquad run their numpy "
              "versions", file=sys.stderr)
    return False


def _sample_table_ptrs(table):
    n = len(table)
    arrs = [np.ascontiguousarray(s, dtype=np.float32) for s in table]
    ptrs = (_F32P * n)(*[a.ctypes.data_as(_F32P) for a in arrs])
    lens = np.asarray([len(a) for a in arrs], dtype=np.int64)
    return arrs, ptrs, lens


def mix_events_native(buf: np.ndarray, table, voices: np.ndarray, onsets: np.ndarray,
                      vels: np.ndarray) -> None:
    """Mix events into ``buf`` in place (``synth._mix_events_numpy``'s
    signature): ``buf[onset:] += vel · table[voice]``, event by event."""
    lib = get_lib()
    if buf.dtype != np.float32 or not buf.flags.c_contiguous:
        raise ValueError("buf must be C-contiguous float32")
    if not len(voices) == len(onsets) == len(vels):
        raise ValueError("event arrays must be parallel")
    arrs, ptrs, lens = _sample_table_ptrs(table)
    voices = np.ascontiguousarray(voices, np.int32)
    onsets = np.ascontiguousarray(onsets, np.int64)
    vels = np.ascontiguousarray(vels, np.float32)
    lib.tgi_mix_events(buf.ctypes.data_as(_F32P), ctypes.c_int64(buf.shape[0]), ptrs,
                       lens.ctypes.data_as(_I64P), ctypes.c_int64(len(table)),
                       voices.ctypes.data_as(_I32P), onsets.ctypes.data_as(_I64P),
                       vels.ctypes.data_as(_F32P), ctypes.c_int64(len(voices)))
    del arrs  # alive until after the call


def mix_batch_native(bufs: np.ndarray, table, voices: np.ndarray, onsets: np.ndarray,
                     vels: np.ndarray, event_offsets: np.ndarray, n_threads: int = 0) -> None:
    """Mix a whole batch in one call, in place.

    ``bufs``: ``(n_items, buf_len)`` C-contiguous float32. ``table``: the
    rows of every kit of the batch, concatenated (the caller offsets
    ``voices`` into it). ``event_offsets``: ``(n_items + 1,)`` bounds of each
    item's events in the flat arrays (grouped by item, in item order).
    ``n_threads`` 0: one thread per CPU (items are independent)."""
    lib = get_lib()
    if bufs.dtype != np.float32 or not bufs.flags.c_contiguous or bufs.ndim != 2:
        raise ValueError("bufs must be a C-contiguous (n_items, buf_len) float32 array")
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    voices = np.ascontiguousarray(voices, np.int32)
    onsets = np.ascontiguousarray(onsets, np.int64)
    vels = np.ascontiguousarray(vels, np.float32)
    event_offsets = np.ascontiguousarray(event_offsets, np.int64)
    if event_offsets.shape != (bufs.shape[0] + 1,) or not len(voices) == len(onsets) == len(
            vels) or event_offsets[-1] != len(voices):
        raise ValueError("event arrays must be parallel, with (n_items + 1,) offsets ending "
                         "at the event count")
    arrs, ptrs, lens = _sample_table_ptrs(table)
    lib.tgi_mix_batch(bufs.ctypes.data_as(_F32P), ctypes.c_int64(bufs.shape[0]),
                      ctypes.c_int64(bufs.shape[1]), ptrs, lens.ctypes.data_as(_I64P),
                      ctypes.c_int64(len(table)), voices.ctypes.data_as(_I32P),
                      onsets.ctypes.data_as(_I64P), vels.ctypes.data_as(_F32P),
                      event_offsets.ctypes.data_as(_I64P), ctypes.c_int32(n_threads))
    del arrs


def resample_linear(src: np.ndarray, ratio: float, out_len: int | None = None) -> np.ndarray:
    """Linear resampler; ``ratio`` = source samples per output sample."""
    lib = get_lib()
    src = np.ascontiguousarray(src, np.float32)
    if out_len is None:
        out_len = max(int((len(src) - 1) / ratio), 0)
    out = np.zeros(out_len, np.float32)
    n = lib.tgi_resample_linear(src.ctypes.data_as(_F32P), ctypes.c_int64(len(src)),
                                out.ctypes.data_as(_F32P), ctypes.c_int64(out_len),
                                ctypes.c_double(ratio))
    return out[:n]


def biquad(x: np.ndarray, b0: float, b1: float, b2: float, a1: float, a2: float,
           state: np.ndarray | None = None) -> np.ndarray:
    """One direct-form-I biquad pass (coefficients normalised by a0) → a new
    float32 array. ``state``: a float64 array ``(x[-1], x[-2], y[-1],
    y[-2])``, updated in place to the section's state after the last sample
    (None: a pass from rest)."""
    lib = get_lib()
    y = np.ascontiguousarray(x, np.float32).copy()
    st = np.zeros(4, np.float64) if state is None else state
    if st.dtype != np.float64 or st.shape != (4,) or not st.flags.c_contiguous:
        raise ValueError("state must be a contiguous (4,) float64 array")
    lib.tgi_biquad(y.ctypes.data_as(_F32P), ctypes.c_int64(len(y)), ctypes.c_double(b0),
                   ctypes.c_double(b1), ctypes.c_double(b2), ctypes.c_double(a1),
                   ctypes.c_double(a2), st.ctypes.data_as(_F64P))
    return y


# -- the numpy versions: the same operations in the same order ----------------


def biquad_numpy(x: np.ndarray, b0: float, b1: float, b2: float, a1: float, a2: float,
                 state: np.ndarray | None = None) -> np.ndarray:
    """:func:`biquad` without the library: the recurrence in Python floats
    (IEEE doubles, the C code's order), each output rounded to float32."""
    xs = np.asarray(x, np.float32).astype(np.float64).tolist()
    x1, x2, y1, y2 = (0.0, 0.0, 0.0, 0.0) if state is None else (float(v) for v in state)
    ys = []
    for x0 in xs:
        y0 = b0 * x0 + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        ys.append(y0)
        x2, x1 = x1, x0
        y2, y1 = y1, y0
    if state is not None:
        state[:] = (x1, x2, y1, y2)
    return np.asarray(ys, np.float64).astype(np.float32)


def resample_linear_numpy(src: np.ndarray, ratio: float,
                          out_len: int | None = None) -> np.ndarray:
    """:func:`resample_linear` without the library: positions summed one
    step at a time in f64 (``np.cumsum`` accumulates in order, as the C
    loop does), interpolated in f64, rounded to float32."""
    src = np.ascontiguousarray(src, np.float32)
    if out_len is None:
        out_len = max(int((len(src) - 1) / ratio), 0)
    if len(src) <= 1 or ratio <= 0.0:
        return np.zeros(0, np.float32)
    n = min(out_len, int((len(src) - 1) / ratio))
    pos = np.zeros(max(n, 0), np.float64)
    if n > 1:
        pos[1:] = np.cumsum(np.full(n - 1, ratio, np.float64))
    i0 = pos.astype(np.int64)
    frac = pos - i0
    lo, hi = src[i0].astype(np.float64), src[i0 + 1].astype(np.float64)
    return (lo * (1.0 - frac) + hi * frac).astype(np.float32)
