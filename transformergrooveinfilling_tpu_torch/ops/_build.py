"""Build the port's CUDA kernels at first use.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, which may
include headers of ``csrc/`` (``#include "x.cuh"``). ``nvcc`` compiles it for
Hopper (``sm_90a``) into a shared library under
``build/kernels/<name>-<hash>/`` at the repository root, keyed by a hash of the
source, every header it includes and the flags, so an unchanged kernel is built
once per checkout and an edited header rebuilds every kernel that uses it. The
library is loaded with ``ctypes``; the wrappers in this package declare each
entry point's ``argtypes``.

Nothing is built at import time, and nothing here falls back: a missing
``nvcc`` or a failed build raises with the compiler's own message.
:func:`build_all` runs one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libraries: dict[str, ctypes.CDLL] = {}
# per kernel: {"seconds": build time (0.0 when cached), "log": nvcc's output}
build_info: dict[str, dict] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else torch's own guess at the toolkit."""
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    nvcc = os.path.join(home, "bin", "nvcc") if home else None
    if nvcc is None or not os.path.isfile(nvcc):
        raise RuntimeError(
            f"nvcc not found (CUDA_HOME={home!r}); the CUDA kernels are "
            "compiled at first use and need the CUDA toolkit")
    return nvcc


def load_library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = _libraries[name] = ctypes.CDLL(str(_build(name)))
        return lib


class CountedKernel:
    """One C entry point of a kernel library and its launch count: one more
    per launch, and nowhere else. ``library`` returns the loaded library with
    its ``argtypes`` declared; ``error_string`` names its entry point that
    turns a ``cudaError`` into text."""

    _count_lock = threading.Lock()

    def __init__(self, library, entry: str, error_string: str):
        self.library, self.entry, self.error_string = library, entry, error_string
        self.launches = 0

    @staticmethod
    def pointers(tensors) -> list:
        """The entry point's leading arguments: one device pointer a tensor,
        a null pointer for None."""
        return [None if t is None else t.data_ptr() for t in tensors]

    def launch(self, tensors, scalars, device) -> None:
        """Call the entry point with the tensors' device pointers, then
        ``scalars``, then ``device``'s current stream; raise on a refused
        launch. The stream is read as a raw handle and the current device is
        switched only when it is another: both cost more host time than a
        kernel launch does."""
        lib = self.library()
        index = device.index if device.index is not None else torch.cuda.current_device()
        call = getattr(lib, self.entry)
        args = (*self.pointers(tensors), *scalars, torch._C._cuda_getCurrentRawStream(index))
        if torch.cuda.current_device() == index:
            rc = call(*args)
        else:
            with torch.cuda.device(index):
                rc = call(*args)
        if rc != 0:
            raise RuntimeError(f"{self.entry} launch failed: "
                               f"{getattr(lib, self.error_string)(rc).decode()} (cudaError {rc})")
        with self._count_lock:
            self.launches += 1


def sm_count(device) -> int:
    """Streaming multiprocessors of the CUDA ``device`` (cached per card)."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def build_all(names) -> None:
    """Build and load several kernels, one ``nvcc`` each, in parallel."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for future in [pool.submit(load_library, n) for n in names]:
            future.result()


def source_files(source: Path) -> list[Path]:
    """``source`` and the ``csrc`` headers it includes (``#include "..."``),
    transitively, each once, in the order first met."""
    files, todo = [], [source]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [CSRC / inc for inc in
                 re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.MULTILINE)]
    return files


def _build(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        b"".join(f.read_bytes() for f in source_files(source))
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{name}-{digest}"
    lib_path = out_dir / f"lib{name}.so"
    if lib_path.exists():
        build_info[name] = {"seconds": 0.0, "log": "(cached)"}
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.{os.getpid()}.so.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(source)],
        capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {source.name} (exit {proc.returncode}):\n"
            f"{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent builder sees all or none
    log = proc.stdout + proc.stderr
    (out_dir / "build.log").write_text(log)
    build_info[name] = {"seconds": seconds, "log": log}
    return lib_path
