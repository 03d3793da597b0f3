"""The backend rule and the transport that every collective of the port goes
through.

The backend is chosen once, by one rule, when the process group starts
(:func:`choose_backend`): NCCL where every rank of a node has a CUDA device
of its own (the node's rank count <= ``torch.cuda.device_count()``); gloo on
the CPU, and gloo where ranks share a card, because NCCL refuses a
communicator in which two ranks sit on one device ("Duplicate GPU
detected").

Gloo moves CUDA tensors in ``all_reduce`` and ``broadcast`` only; a CUDA
tensor handed to its ``send`` kills the process (both measured on an NVIDIA
H100 80GB HBM3, torch 2.11: PERF.md §6). So the transport follows the
backend (:func:`transport_for`):

- ``"device"``: the collective runs on the tensor itself (NCCL on CUDA
  tensors, gloo on CPU tensors);
- ``"host"``: gloo with CUDA tensors; every collective copies the tensor into
  a pinned host buffer, runs there and copies the result back
  (:class:`Comm`'s one staging path), so that every operation, point to
  point included, works the same way where ranks share a card.

A :class:`Comm` is one process group and its transport; the plans of
``mesh.py`` and ``pipeline.py`` hold one for each axis they reduce over.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


def choose_backend(device: torch.device, ranks_on_node: int) -> str:
    """``"nccl"`` when ``device`` is CUDA and the node's ``ranks_on_node``
    ranks each have a card of their own, else ``"gloo"``."""
    if device.type == "cuda" and ranks_on_node <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def transport_for(backend: str, device: torch.device) -> str:
    """``"host"`` for gloo with CUDA tensors (staged through pinned host
    buffers), ``"device"`` otherwise."""
    return "host" if backend == "gloo" and device.type == "cuda" else "device"


@dataclasses.dataclass(frozen=True)
class Comm:
    """A process group (``None``: the default group) and its transport.
    Every method is a collective of the group's ranks (``send``/``recv``:
    of the pair), in place on ``tensor`` where it returns nothing."""

    group: object
    transport: str
    size: int

    def _staged(self, tensor: torch.Tensor, op, write_back: bool = True) -> None:
        if self.transport == "device":
            op(tensor)
            return
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        host.copy_(tensor)
        op(host)
        if write_back:
            tensor.copy_(host)

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum over the group, in place; returns ``tensor``."""
        if self.size > 1:
            self._staged(tensor, lambda t: dist.all_reduce(t, group=self.group))
        return tensor

    def broadcast(self, tensor: torch.Tensor, src: int) -> torch.Tensor:
        """``tensor`` of global rank ``src`` on every rank, in place."""
        if self.size > 1:
            self._staged(tensor, lambda t: dist.broadcast(t, src, group=self.group))
        return tensor

    def all_gather(self, tensor: torch.Tensor) -> list:
        """Every rank's ``tensor`` (same shape), in group order."""
        if self.size == 1:
            return [tensor]
        src = tensor.contiguous()
        if self.transport == "device":
            out = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(out, src, group=self.group)
            return out
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)
        out = [torch.empty_like(host) for _ in range(self.size)]
        dist.all_gather(out, host, group=self.group)
        return [o.to(tensor.device) for o in out]

    def send(self, tensor: torch.Tensor, dst: int) -> None:
        """``tensor`` to global rank ``dst``."""
        self._staged(tensor.contiguous(), lambda t: dist.send(t, dst), write_back=False)

    def recv(self, tensor: torch.Tensor, src: int) -> torch.Tensor:
        """Fill ``tensor`` from global rank ``src``; returns it."""
        self._staged(tensor, lambda t: dist.recv(t, src))
        return tensor
