"""Multi-process execution, as the JAX package's ``parallel/multihost.py``.

A run of several processes is one ``torch.distributed`` group, one rank per
process. :func:`initialize_from_env` starts it from the environment, under
either family of names:

- the JAX package's: ``JAX_COORDINATOR_ADDRESS`` (``host:port``),
  ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``;
- torchrun's: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK`` (``TGI_DISTRIBUTED=1`` with none of the JAX names set asks
  for these, as it asks the JAX package for pod auto-detection).

The ranks meet at the coordinator's store, tell each other their host names
(so each knows how many ranks share its node), and the backend follows the
rule of ``comm.py::choose_backend``. Each rank binds
``cuda:{LOCAL_RANK % device_count}`` (the local rank counted from the host
names when torchrun's is not set). A group asked for on ``"cuda"`` without
CUDA raises; it never lands on the CPU.

The process group is process-wide state in ``torch.distributed``; this
module keeps beside it what the rendezvous learned (:func:`context`).
:func:`global_mesh` is the ``("data", "model")`` mesh over every rank,
:func:`is_main_process` gates what only one rank writes (checkpoints,
the run's logs), and :func:`local_batch_slice` is this rank's equal share of
a batch. In one process without a group every helper gives the one-process
answer.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from .. import require_device
from .comm import choose_backend, transport_for


@dataclasses.dataclass(frozen=True)
class GroupContext:
    """What the rendezvous learned: this rank's device, the backend and
    transport, and how the ranks sit on nodes."""

    device: torch.device
    backend: str
    transport: str
    local_rank: int
    ranks_on_node: int
    n_nodes: int


_context: Optional[GroupContext] = None


def _rendezvous_url() -> Optional[str]:
    """The ``torch.distributed.rendezvous`` URL of the environment, or None
    when it names no group."""
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = os.environ.get("JAX_NUM_PROCESSES")
    process_id = os.environ.get("JAX_PROCESS_ID")
    if coordinator is not None or num_processes is not None:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError(
                "JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID must be set "
                "together (the port has no pod auto-detection)")
        return f"tcp://{coordinator}?rank={int(process_id)}&world_size={int(num_processes)}"
    if "MASTER_ADDR" in os.environ or os.environ.get("TGI_DISTRIBUTED"):
        return "env://"
    return None


def _start(url: str, device: torch.device) -> GroupContext:
    """Rendezvous at ``url``, exchange host names, choose the backend, start
    the default group."""
    store, rank, world = next(dist.rendezvous(url))
    host = socket.gethostname()
    store.set(f"tgi/host/{rank}", host)
    hosts = [store.get(f"tgi/host/{r}").decode() for r in range(world)]
    mine = [r for r in range(world) if hosts[r] == host]
    local_rank = int(os.environ.get("LOCAL_RANK", mine.index(rank)))
    backend = choose_backend(device, len(mine))
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            **({"device_id": device} if backend == "nccl" else {}))
    return GroupContext(device=device, backend=backend, transport=transport_for(backend, device),
                        local_rank=local_rank, ranks_on_node=len(mine), n_nodes=len(set(hosts)))


def initialize_from_env(device="cuda") -> bool:
    """Start the process group from the environment (module docstring);
    a no-op returning False when the environment names no group (whatever
    runs in the process), True when the group it names is active.
    Idempotent: a second call keeps the running group. ``device``: where
    this rank computes (``"cuda"`` without CUDA raises)."""
    global _context
    device = require_device(device, "initialize_from_env")
    url = _rendezvous_url()
    if url is None:
        return False
    if _context is None:
        _context = _start(url, device)
    return True


def ensure_group(device="cuda") -> GroupContext:
    """The running group's context; in a process without one, a group of one
    rank on an in-process store (no network), so that a plan can be built
    in a single process as the JAX package builds a mesh over its local
    devices."""
    global _context
    if _context is None:
        device = require_device(device, "ensure_group")
        if dist.is_initialized():
            raise RuntimeError("a torch.distributed group is running that "
                               "initialize_from_env did not start")
        backend = choose_backend(device, 1)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                **({"device_id": device} if backend == "nccl" else {}))
        _context = GroupContext(device=device, backend=backend,
                                transport=transport_for(backend, device), local_rank=0,
                                ranks_on_node=1, n_nodes=1)
    elif require_device(device, "ensure_group").type != _context.device.type:
        raise ValueError(f"the process group computes on {_context.device}, not {device}")
    return _context


def context() -> Optional[GroupContext]:
    """The running group's :class:`GroupContext`, or None."""
    return _context


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def global_mesh(n_model: int = 1, device="cuda"):
    """("data", "model") mesh over every rank of the group."""
    from .mesh import make_mesh

    return make_mesh(n_model=n_model, device=device)


def local_batch_slice(global_batch: int) -> slice:
    """This process's slice of a batch split in equal shares over the
    processes (data parallelism over processes)."""
    n = process_count()
    per = global_batch // n
    i = process_index()
    return slice(i * per, (i + 1) * per)
