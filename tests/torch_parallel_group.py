"""Start a process group of ``tests/torch_parallel_worker.py`` ranks on the
CPU (gloo), for the port's parallel tests, and collect what they wrote.

Each group has a wall-clock limit of its own, so that a hung collective
fails its test instead of the suite; the ranks run with one thread each.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
WORKER = os.path.join(TESTS_DIR, "torch_parallel_worker.py")
GROUP_NAMES = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
               "TGI_DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
               "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(n: int, rank: int, port: int, names: str = "jax") -> dict:
    """The environment of rank ``rank`` of ``n``, the group named with the
    JAX package's variables or torchrun's."""
    env = {k: v for k, v in os.environ.items() if k not in GROUP_NAMES}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    if names == "jax":
        env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES=str(n),
                   JAX_PROCESS_ID=str(rank))
    else:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(n),
                   RANK=str(rank), LOCAL_RANK=str(rank))
    return env


def launch(n: int, argv_of, cwd: str, timeout: float, names: str = "jax"):
    """Start ``n`` ranks (``argv_of(rank)``), wait for all within
    ``timeout`` seconds → ``[(returncode, stdout, stderr)]``; on the limit
    every rank is killed and AssertionError names it."""
    port = free_port()
    procs = [subprocess.Popen(argv_of(r), cwd=cwd, env=rank_env(n, r, port, names),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [p.communicate()[1][-1500:] for p in procs]
        raise AssertionError(f"process group of {n} hung past {timeout} s:\n"
                             + "\n---\n".join(tails))
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def run_group(n: int, jobs: list, tmp_path, tag: str, data: dict | None = None,
              timeout: float = 240, names: str = "jax"):
    """Run ``jobs`` on a group of ``n`` worker ranks → (per-rank result
    dicts, rank 0's arrays)."""
    spec = {"jobs": jobs}
    if data is not None:
        spec["data"] = str(tmp_path / f"{tag}_data.npz")
        np.savez(spec["data"], **data)
    spec_path = tmp_path / f"{tag}_spec.json"
    spec_path.write_text(json.dumps(spec))
    out = str(tmp_path / tag)
    results = launch(n, lambda r: [sys.executable, WORKER, str(spec_path), out], TESTS_DIR,
                     timeout, names)
    for rc, _o, e in results:
        assert rc == 0, f"a rank exited {rc}:\n{e[-3000:]}"
    ranks = [json.loads(open(f"{out}_{r}.json").read()) for r in range(n)]
    arrays = dict(np.load(out + ".npz"))
    return ranks, arrays


def flax_arrays(params: dict, prefix: str) -> dict:
    """A flax parameter tree → ``{prefix/path: array}`` for the worker."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(flax_arrays(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def unflatten(arrays: dict, prefix: str) -> dict:
    """Inverse of :func:`flax_arrays` for the keys under ``prefix``."""
    out: dict = {}
    for key, v in arrays.items():
        if key.startswith(prefix + "/"):
            node = out
            path = key[len(prefix) + 1:].split("/")
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v
    return out
