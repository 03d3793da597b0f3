"""Mesh construction and the sharding rules, as the JAX package's
``parallel/mesh.py``.

A :class:`MeshPlan` lays the group's ranks out as a ``("data", "model")``
``torch.distributed.device_mesh.DeviceMesh``, "model" innermost as in the
JAX package. Batches are split over "data" (each rank trains on its rows
and the gradients are all-reduced, ``train/loop.py::_make_dp_shard_step``);
the transformer's wide dimensions are split over "model" (tensor
parallelism, ``tensor.py``).

The partition rules are the JAX package's table, on the flax paths that
``utils/param_layout.py`` maps to the state dict (specs are tuples: ``(None,
"model")`` splits a flax kernel's columns, ``("model", None)`` its rows,
``()`` replicates). One deliberate difference (ROADMAP §C6): the JAX package
splits the packed qkv columns in contiguous blocks and lets GSPMD move the
data, but a rank here attends over its own heads only, so the packed
projections are split by heads, each rank holding its heads' q, k and v
columns (:func:`shard_params`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch

from .comm import Comm
from .multihost import ensure_group


def _groups(mesh, dims) -> dict:
    """``{dim: Comm}`` for each mesh dimension."""
    import torch.distributed as dist

    from .multihost import context

    transport = context().transport
    out = {}
    for dim in dims:
        group = mesh.get_group(dim)
        out[dim] = Comm(group, transport, dist.get_world_size(group))
    return out


def _flat_group(ranks_grid: np.ndarray, keep_axis: int, transport: str) -> Comm:
    """The group of the ranks that share this rank's coordinate on
    ``keep_axis`` (all other axes flattened): made by every rank, for every
    coordinate, in the same order, as ``new_group`` requires."""
    import torch.distributed as dist

    me = dist.get_rank()
    mine = None
    grid = np.moveaxis(ranks_grid, keep_axis, -1)
    for k in range(grid.shape[-1]):
        ranks = sorted(int(r) for r in grid[..., k].reshape(-1))
        group = dist.new_group(ranks)
        if me in ranks:
            mine = Comm(group, transport, len(ranks))
    return mine


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A ``("data", "model")`` mesh over the group's ranks: ``mesh`` (the
    ``DeviceMesh``), this rank's coordinates, the backend and transport
    (``comm.py``), this rank's device, and the :class:`~.comm.Comm` of each
    axis (``data``: metrics; ``model``: the tensor-parallel all-reduces;
    ``reduce``: the gradient all-reduce, over every axis but "model")."""

    mesh: object
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    backend: str
    transport: str
    device: torch.device
    data: Comm
    model: Comm
    reduce: Comm

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    def local_rows(self, batch: int) -> slice:
        """This rank's rows of a global batch: the data axis's contiguous
        shares, the first ``batch % n_data`` ranks one row longer."""
        if batch < self.n_data:
            raise ValueError(f"batch {batch} is smaller than the data axis ({self.n_data})")
        bounds = np.linspace(0, batch, self.n_data + 1).round().astype(int)
        return slice(int(bounds[self.data_rank]), int(bounds[self.data_rank + 1]))


def _device_mesh(device: torch.device, backend: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh

    import torch.distributed as dist

    n = int(np.prod(shape))
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a {' x '.join(map(str, shape))} mesh needs {n} ranks, the group "
                         f"has {world}")
    device_type = "cuda" if backend == "nccl" else "cpu"
    grid = torch.arange(world).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=names), grid.numpy()


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device="cuda") -> MeshPlan:
    """A ("data", "model") mesh over the group's ranks (a group of one rank
    is started when none runs, ``multihost.py::ensure_group``). ``n_data``
    defaults to the rank count // ``n_model``; the mesh must use every rank."""
    ctx = ensure_group(device)
    import torch.distributed as dist

    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    mesh, grid = _device_mesh(ctx.device, ctx.backend, (n_data, n_model), ("data", "model"))
    comms = _groups(mesh, ("data", "model"))
    data_rank, model_rank = (int(c) for c in np.argwhere(grid == dist.get_rank())[0])
    return MeshPlan(mesh=mesh, n_data=n_data, n_model=n_model, data_rank=data_rank,
                    model_rank=model_rank, backend=ctx.backend, transport=ctx.transport,
                    device=ctx.device, data=comms["data"],
                    model=comms["model"], reduce=_flat_group(grid, 1, ctx.transport))


@dataclasses.dataclass(frozen=True)
class Placement:
    """What the JAX package's ``NamedSharding`` says, for the port: ``spec``
    names the mesh axis each tensor dimension is split over; calling it on a
    tensor gives this rank's part (its rows of the "data" axis for
    :func:`data_sharding`; the whole tensor for :func:`replicated`)."""

    plan: MeshPlan
    spec: tuple

    def __call__(self, tensor: torch.Tensor) -> torch.Tensor:
        if self.spec and self.spec[0] == "data":
            return tensor[self.plan.local_rows(tensor.shape[0])]
        return tensor


def data_sharding(plan: MeshPlan, ndim: int = 3) -> Placement:
    """Split the leading (batch) axis over "data"; trailing axes replicated."""
    return Placement(plan, ("data",) + (None,) * (ndim - 1))


def replicated(plan: MeshPlan) -> Placement:
    return Placement(plan, ())


# path-regex → spec rules for the groove transformer's flax parameter tree,
# matched against "/"-joined paths like "encoder_layer_0/self_attn/qkv/kernel"
_PARTITION_RULES = (
    (r".*self_attn/qkv/kernel", (None, "model")),
    (r".*self_attn/qkv/bias", ("model",)),
    (r".*(self_attn|cross_attn)/(q|kv)/kernel", (None, "model")),
    (r".*(self_attn|cross_attn)/(q|kv)/bias", ("model",)),
    (r".*self_attn/out/kernel", ("model", None)),
    (r".*cross_attn/out/kernel", ("model", None)),
    (r".*linear1/kernel", (None, "model")),
    (r".*linear1/bias", ("model",)),
    (r".*linear2/kernel", ("model", None)),
    # everything else (embeds, norms, output head, biases of row-split products)
    (r".*", ()),
)


def _spec_for_path(path: str) -> tuple:
    for pattern, spec in _PARTITION_RULES:
        if re.fullmatch(pattern, path):
            return spec
    return ()


def param_partition_specs(params) -> dict:
    """The spec tree matching a flax ``params`` tree (or, given a model, its
    flax tree: ``utils/param_layout.py``)."""
    if isinstance(params, torch.nn.Module):
        from ..utils.param_layout import flax_layout

        tree: dict = {}
        for path, *_ in flax_layout(params.config):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = _spec_for_path("/".join(path))
        return tree

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        return _spec_for_path("/".join(prefix))

    return walk(params, ())


def shard_params(model: torch.nn.Module, plan: MeshPlan, tensor_parallel: bool = True,
                 optimizer: Optional[torch.optim.Optimizer] = None):
    """Give this rank its part of ``model`` (in place): with
    ``tensor_parallel`` and a "model" axis over 1, every encoder and decoder
    layer's attention and FFN take their head-aligned and FFN shards
    (``tensor.py::shard_model``; Adam's moments in ``optimizer``, if any,
    are cut the same way); otherwise the model stays whole (replicated).
    Returns ``(model, specs)`` as the JAX function returns ``(params,
    specs)``."""
    if tensor_parallel and plan.n_model > 1:
        from .tensor import shard_model

        shard_model(model, plan, optimizer)
        return model, param_partition_specs(model)
    return model, _replicated_specs(model)


def _replicated_specs(model) -> dict:
    def walk(tree):
        return {k: walk(v) for k, v in tree.items()} if isinstance(tree, dict) else ()

    return walk(param_partition_specs(model))
