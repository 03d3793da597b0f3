"""Checkpoints, as the JAX package's ``train/checkpoint.py``: the same files.

A native checkpoint ``transformer_run_{run}_Epoch_{ep}.ckpt`` is flax msgpack
(``utils/msgpack.py``, byte for byte what ``flax.serialization`` writes) of
``{"state": {"params", "opt_state"}, "meta": {epoch, loss, run_id, config}}``:
the parameters as the flax tree in float32 (``models/torch_compat.py``'s
map), whatever the compute dtype; the optimizer state as the optax tree;
the model config as JSON under the JAX package's field names
(``use_pallas_attention``, ``compute_dtype`` as ``"float32"`` /
``"bfloat16"``). So a file either package writes loads in the other.
``restore`` takes ``load_model = {"location": "local" | "wandb", "dir": ...,
["file_pattern", "epoch", "run"]}``, newest epoch by default; a reference
``.Model`` in the directory is read too (parameters only).

Saves off the training thread: :func:`snapshot_state_on_device` copies the
parameters and optimizer state into one fresh device buffer on the training
stream and records a CUDA event after the copy; the next ``opt.step()``
rewrites the live parameters in place, never the copy.
:func:`save_snapshot_async` hands it to one save worker, which waits on that
event on a stream of its own, fetches the buffer, serialises and writes; at
most 3 snapshots are in flight (a fourth save blocks), so device copies
cannot pile up. :func:`flush_async_saves` waits for every queued save and
re-raises the first failure. Every write goes to a temporary file renamed
into place, so a crash mid-write never leaves a truncated newest checkpoint.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import re
import threading
from typing import Optional

import numpy as np
import torch

from ..models import torch_compat
from ..models.transformer import GrooveTransformerConfig
from ..utils import msgpack

CKPT_PATTERN = "transformer_run_{}_Epoch_{}.ckpt"

_async_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
_async_pending: list = []
_snapshot_slots = threading.BoundedSemaphore(3)
_copy_streams: dict = {}  # device index → the save worker's stream

# the port's config fields under their JAX names, and dtypes as numpy names
_JAX_FIELD = {"use_fused_attention": "use_pallas_attention"}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


# ------------------------------------------------------------------ payload


def _payload_from(config: GrooveTransformerConfig, params: dict, algorithm: str, count: int,
                  mu: dict, nu: dict) -> dict:
    """``{name: tensor}`` parameters and :func:`~torch_compat.optimizer_moments`
    → the checkpoint payload, the one place its form is written down."""
    return {"params": torch_compat.flax_params_from_state_dict(params, config),
            "opt_state": torch_compat.optax_state(algorithm, count, mu, nu, config)}


def fetch_state_to_host(state) -> dict:
    """A ``TrainState``'s parameters and optimizer state → the checkpoint
    payload, copied to the host on the calling thread."""
    model = state.model
    return _payload_from(model.config, model.state_dict(),
                         *torch_compat.optimizer_moments(state.optimizer, model))


@dataclasses.dataclass
class Snapshot:
    """Parameters (and Adam's moments) copied into one device buffer."""

    flat: torch.Tensor
    names: list
    shapes: list
    algorithm: str
    count: int
    config: GrooveTransformerConfig
    event: Optional[torch.cuda.Event]


def snapshot_state_on_device(state) -> Snapshot:
    """Copy ``state``'s parameters and optimizer state into one fresh f32
    device buffer, enqueued on the current stream with a CUDA event recorded
    after it. The copy is device work; the device→host fetch happens on the
    save worker (:func:`save_snapshot_async`), which never reads the live
    parameters."""
    model = state.model
    named = dict(model.named_parameters())
    algorithm, count, mu, nu = torch_compat.optimizer_moments(state.optimizer, model)
    tensors = [*named.values(), *mu.values(), *nu.values()]
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    event = None
    if flat.is_cuda:
        event = torch.cuda.Event()
        event.record()
    return Snapshot(flat=flat, names=list(named), shapes=[tuple(t.shape) for t in tensors],
                    algorithm=algorithm, count=count, config=model.config, event=event)


def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _copy_streams:
        _copy_streams[index] = torch.cuda.Stream(device)
    return _copy_streams[index]


def _payload_from_snapshot(snap: Snapshot) -> dict:
    """Fetch a snapshot to the host (after its event) → the payload."""
    if snap.event is not None:
        stream = _copy_stream(snap.flat.device)
        with torch.cuda.stream(stream):
            stream.wait_event(snap.event)
            host = snap.flat.cpu()
    else:
        host = snap.flat
    pieces, at = [], 0
    for shape in snap.shapes:
        n = int(np.prod(shape))
        pieces.append(host[at:at + n].view(shape))
        at += n
    k = len(snap.names)
    params, mu, nu = (dict(zip(snap.names, pieces[i * k:(i + 1) * k])) for i in range(3))
    return _payload_from(snap.config, params, snap.algorithm, snap.count, mu, nu)


# ------------------------------------------------------------------ writing


def _pool() -> concurrent.futures.ThreadPoolExecutor:
    global _async_pool
    if _async_pool is None:
        _async_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-save")
    return _async_pool


def save_payload_async(ckpt_dir: str, run_id: str, epoch: int, payload: dict, loss: float,
                       config: GrooveTransformerConfig):
    """Queue an already-fetched host payload (:func:`fetch_state_to_host`)
    for serialisation and the write on the save worker (one thread, so saves
    land in order). Call :func:`flush_async_saves` before reading checkpoints
    back: it re-raises any write failure."""
    fut = _pool().submit(_write_checkpoint, ckpt_dir, run_id, epoch, payload, loss, config)
    _async_pending.append(fut)
    return fut


def save_checkpoint_async(ckpt_dir: str, run_id: str, epoch: int, state, loss: float,
                          config: GrooveTransformerConfig):
    """Fetch ``state`` on the calling thread, serialise and write it on the
    save worker."""
    return save_payload_async(ckpt_dir, run_id, epoch, fetch_state_to_host(state), loss,
                              config)


def save_snapshot_async(ckpt_dir: str, run_id: str, epoch: int, snap: Snapshot, loss: float,
                        config: GrooveTransformerConfig, legacy: bool = False):
    """Queue a snapshot (:func:`snapshot_state_on_device`) for the fetch,
    serialisation and write on the save worker, and with ``legacy`` a
    ``.Model`` beside it. Each queued snapshot holds its device buffer until
    its fetch is done; past 3 in flight this call blocks (backpressure)."""
    _snapshot_slots.acquire()

    def fetch_and_write():
        try:
            payload = _payload_from_snapshot(snap)
            path = _write_checkpoint(ckpt_dir, run_id, epoch, payload, loss, config)
            if legacy:
                export_legacy(ckpt_dir, run_id, epoch, payload["params"], config, loss)
            return path
        finally:
            _snapshot_slots.release()

    try:
        fut = _pool().submit(fetch_and_write)
    except BaseException:
        _snapshot_slots.release()
        raise
    _async_pending.append(fut)
    return fut


def flush_async_saves() -> None:
    """Block until every queued save is written; re-raise the first worker
    exception (a checkpoint dropped in silence is lost data)."""
    global _async_pool
    if _async_pool is not None:
        _async_pool.shutdown(wait=True)
        _async_pool = None
    pending, _async_pending[:] = list(_async_pending), []
    for fut in pending:
        fut.result()


def save_checkpoint(ckpt_dir: str, run_id: str, epoch: int, state, loss: float,
                    config: GrooveTransformerConfig) -> str:
    """Fetch ``state`` and write its checkpoint on the calling thread → the
    file's path."""
    return _write_checkpoint(ckpt_dir, run_id, epoch, fetch_state_to_host(state), loss, config)


def _write_checkpoint(ckpt_dir: str, run_id: str, epoch: int, payload: dict, loss: float,
                      config: GrooveTransformerConfig) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, CKPT_PATTERN.format(run_id, epoch))
    tmp = path + ".tmp"  # renamed into place: never a truncated newest file
    with open(tmp, "wb") as f:
        f.write(msgpack.serialize(
            {"state": payload,
             "meta": {"epoch": int(epoch), "loss": float(loss), "run_id": run_id,
                      "config": json.dumps(_config_dict(config))}}))
    os.replace(tmp, path)
    _blob_cache.clear()  # never serve a parse of the file this replaced
    return path


def _config_dict(config: GrooveTransformerConfig) -> dict:
    """The config's JSON form under the JAX package's names, in its field
    order (``config_from_json_dict`` is the inverse, in either package)."""
    d = {_JAX_FIELD.get(f.name, f.name): getattr(config, f.name)
         for f in dataclasses.fields(config)}
    d["compute_dtype"] = _DTYPE_NAMES[config.compute_dtype]
    return d


# ------------------------------------------------------------------ reading


_blob_cache: dict = {}  # (path, mtime_ns, size) → parsed blob (one entry)


def _read_blob(path: str):
    """Parse a native checkpoint once per (path, mtime_ns, size): restoring
    reads the config and then the state from the same file."""
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    if _blob_cache.get("key") != key:
        with open(path, "rb") as f:
            blob = msgpack.restore(f.read())
        _blob_cache.clear()
        _blob_cache.update(key=key, blob=blob)
    return _blob_cache["blob"]


def _fresh(tree):
    if isinstance(tree, dict):
        return {k: _fresh(v) for k, v in tree.items()}
    return np.array(tree) if isinstance(tree, np.ndarray) else tree


def load_checkpoint(path: str):
    """→ ``(params, opt_state, epoch, loss)``: the flax parameter tree and
    the optax state tree as numpy, copied out of the parse cache."""
    blob = _read_blob(path)
    meta = blob["meta"]
    return (_fresh(blob["state"]["params"]), _fresh(blob["state"]["opt_state"]),
            int(meta["epoch"]), float(meta["loss"]))


def config_from_json_dict(d: dict) -> GrooveTransformerConfig:
    """The JSON form of a config (either package's) → the port's config.
    Like the JAX package's, an unknown field raises ``TypeError``."""
    d = {{v: k for k, v in _JAX_FIELD.items()}.get(k, k): v for k, v in d.items()}
    name = d.get("compute_dtype", "float32")
    dtypes = {v: k for k, v in _DTYPE_NAMES.items()}
    if name not in dtypes:
        raise ValueError(f"compute_dtype {name!r} has no torch counterpart here")
    d["compute_dtype"] = dtypes[name]
    return GrooveTransformerConfig(**d)


def load_checkpoint_config(path: str) -> GrooveTransformerConfig:
    """The model config embedded in a native checkpoint's metadata."""
    return config_from_json_dict(json.loads(_read_blob(path)["meta"]["config"]))


def load_params_and_config(path: str, legacy_config: Optional[GrooveTransformerConfig] = None):
    """One resolver for every inference entry point: ``path`` a directory
    (newest epoch wins, a legacy ``.Model`` as fallback), a native ``.ckpt``
    or a reference ``.Model`` (which needs ``legacy_config``: it carries no
    architecture) → ``(state_dict, config, epoch, loss)``."""
    if os.path.isdir(path):
        try:
            path, _epoch = find_latest(path)
        except (FileNotFoundError, ValueError, OSError) as e:
            raise SystemExit(f"no checkpoint found under {path}: {e}")
    if path.endswith(".Model"):
        if legacy_config is None:
            raise SystemExit(f"{path} is a legacy .Model file, which carries no model "
                             "config; pass the architecture flags explicitly")
        state_dict, epoch, loss = torch_compat.load_legacy_checkpoint(path, legacy_config)
        return state_dict, legacy_config, epoch, loss
    config = load_checkpoint_config(path)
    params, _opt, epoch, loss = load_checkpoint(path)
    return torch_compat.state_dict_from_flax_params(params, config), config, epoch, loss


def find_latest(ckpt_dir: str, file_pattern: str = CKPT_PATTERN):
    """Newest-epoch checkpoint in a directory → ``(path, epoch)``; legacy
    ``.Model`` files when no native one matches."""
    regex = re.compile(
        re.escape(file_pattern).replace(r"\{\}", "(.+?)", 1).replace(r"\{\}", r"(\d+)", 1)
        + "$")
    best = None
    for fname in os.listdir(ckpt_dir):
        m = regex.match(fname)
        if m and (best is None or int(m.group(2)) > best[0]):
            best = (int(m.group(2)), os.path.join(ckpt_dir, fname))
    if best is not None:
        return best[1], best[0]
    return torch_compat.find_latest_checkpoint(ckpt_dir)


_ARCH_FIELDS = ("d_model", "n_heads", "dim_feedforward", "num_encoder_layers",
                "num_decoder_layers", "max_len", "embedding_size_src", "embedding_size_tgt")


def restore(load_model: dict, config: GrooveTransformerConfig):
    """The reference's restore contract → ``(params, opt_state or None,
    initial_epoch)``, ``params`` the flax tree, ``initial_epoch`` the saved
    epoch + 1. ``location="local"`` reads a directory; ``"wandb"`` a
    pre-downloaded wandb run directory (``dir`` its root or ``files/``);
    fetching from the wandb service needs the network and raises. An
    explicit ``epoch`` prefers the native file over a ``.Model`` of the same
    epoch (a ``.Model`` has no optimizer state). A native file of another
    architecture raises ``ValueError``."""
    location = load_model.get("location", "local")
    if location == "wandb":
        run_dir = load_model.get("dir")
        candidates = [os.path.join(run_dir, "files"), run_dir] if run_dir else []
        ckpt_dir = next((d for d in candidates
                         if d and os.path.isdir(d)
                         and any(f.endswith((".ckpt", ".Model")) for f in os.listdir(d))),
                        None)
        if ckpt_dir is None:
            raise NotImplementedError(
                "wandb restore without a pre-downloaded run directory needs network "
                "access; download the run's files (wandb sync / the wandb API) and point "
                "load_model['dir'] at them, or use location='local'")
        load_model = dict(load_model, dir=ckpt_dir)
    elif location != "local":
        raise ValueError(f"unknown checkpoint location {location!r}; "
                         "expected 'local' or 'wandb'")
    ckpt_dir = load_model["dir"]
    pattern = load_model.get("file_pattern", CKPT_PATTERN)
    if load_model.get("epoch") is not None:
        run_filter = load_model.get("run")
        path = None
        for fname in sorted(os.listdir(ckpt_dir), key=lambda f: (not f.endswith(".ckpt"), f)):
            if (fname.endswith((".ckpt", ".Model"))
                    and f"Epoch_{load_model['epoch']}." in fname
                    and not (run_filter and str(run_filter) not in fname)):
                path = os.path.join(ckpt_dir, fname)
                break
        if path is None:
            raise FileNotFoundError(
                f"no checkpoint for epoch {load_model['epoch']} in {ckpt_dir}")
        epoch = int(load_model["epoch"])
    elif pattern.endswith(".ckpt"):
        path, epoch = find_latest(ckpt_dir, pattern)
    else:
        path, epoch = torch_compat.find_latest_checkpoint(ckpt_dir, pattern)

    if path.endswith(".Model"):
        state_dict, epoch, _loss = torch_compat.load_legacy_checkpoint(path, config)
        return torch_compat.flax_params_from_state_dict(state_dict, config), None, epoch + 1
    saved = load_checkpoint_config(path)
    mismatch = [f for f in _ARCH_FIELDS if getattr(saved, f) != getattr(config, f)]
    if mismatch:
        raise ValueError(
            f"checkpoint {path} was trained with a different architecture: "
            + ", ".join(f"{f}={getattr(saved, f)} (requested {getattr(config, f)})"
                        for f in mismatch)
            + "; fix the model params or use load_checkpoint_config()")
    params, opt_state, epoch, _loss = load_checkpoint(path)
    return params, opt_state, epoch + 1


def export_legacy(ckpt_dir: str, run_id: str, epoch: int, params,
                  config: GrooveTransformerConfig, loss: float) -> str:
    """Write a reference-readable ``.Model`` from a flax parameter tree
    beside the native checkpoints → its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"transformer_run_{run_id}_Epoch_{epoch}.Model")
    torch_compat.save_legacy_checkpoint(path, params, config, epoch, loss)
    return path
