"""Serving artifacts: the bucketed predict as ``torch.export`` programs.

Counterpart of ``transformergrooveinfilling_tpu/export.py``. An artifact is a
zip (stdlib ``zipfile``) holding

- ``meta.json``: the artifact version, the model config under the JAX
  package's names (``train/checkpoint.py::_config_dict``), the bucket list,
  the threshold settings, the platforms, ``jax_version`` (``null`` here) and
  ``torch_version``;
- ``params.msgpack``: the parameters once, as the flax tree in float32
  (``utils/msgpack.py``, byte for byte what ``flax.serialization`` writes, so
  the JAX package reads them), never baked into the programs;
- one ``bucket_<B>.pt2`` per batch bucket: ``torch.export.save`` of the
  predict (sigmoid, threshold, ``h | v | o``) traced on the CPU with the
  parameters as inputs. The model is held outside the traced module, so a
  program's ``state_dict`` is empty, and its example inputs are dropped
  before saving; its only constants are the positional tables.

A program holds every attention as the operator ``tgi::fused_mha``
(``ops/attention.py``): on the card it launches the hand-written kernel
``csrc/fused_mha.cu`` (TPU kernel #1), on the CPU its plain version. JAX's
artifacts take the plain attention instead, because a Mosaic custom call
would pin them to one TPU toolchain; the port's operator is built from
``csrc/`` at first use (``ops/_build.py``), so that reason does not carry
over, and a plain route would skip the kernel on the card unseen. Loading a
program imports ``ops/attention.py`` (which registers the operator) and
nothing of the model.

:func:`load_infill` runs a program on the device it is asked for
(``"cuda"`` by default): the CPU trace's device arguments are moved there
(``torch.export.passes.move_to_device_pass``). The device must be one of
the artifact's ``platforms``, else ``ValueError``; JAX routes a call to
another backend instead. An artifact the JAX package wrote holds
``bucket_<B>.jexp`` StableHLO, which the port does not run: it is read
through ``meta.json`` and ``params.msgpack`` alone, and the port's model is
rebuilt from the config (the kernel on the card) and served with the same
semantics, on any device. The JAX package cannot run the port's ``.pt2``
programs; it can read the parameters.

CLI: ``python -m transformergrooveinfilling_tpu_torch.export --checkpoint
<file-or-dir> --out model.tgix [--batch_sizes 1,8,32] [--platforms cpu,cuda]
[--use_thres 1] [--thres 0.5]``. Exporting needs no card.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import types
import warnings
import zipfile
from typing import Sequence

import numpy as np
import torch

from . import require_device
from .ops import attention  # noqa: F401  (registers tgi::fused_mha for the programs)
from .utils import msgpack, param_layout

ARTIFACT_VERSION = 1
_META = "meta.json"
_PARAMS = "params.msgpack"
PLATFORMS = ("cpu", "cuda")  # the devices a program may be moved to


def _predict_fn(model, use_thres: bool, thres: float):
    """``predict(params, x)``: the model's forward over ``params`` (a state
    dict), hits through a sigmoid (thresholded when ``use_thres``), then
    ``h | v | o`` along the last axis."""

    def predict(params, x):
        h_logits, v, o = torch.func.functional_call(model, params, (x,))
        h = torch.sigmoid(h_logits)
        if use_thres:
            h = (h > thres).to(torch.float32)
        return torch.cat([h, v, o], dim=-1)

    return predict


class _Predict(torch.nn.Module):
    """The module ``torch.export`` traces. ``predict`` closes over the model,
    which is therefore no registered submodule: its parameters are inputs of
    the program, not constants of it."""

    def __init__(self, predict):
        super().__init__()
        self.predict = predict

    def forward(self, params, x):
        return self.predict(params, x)


def _param_names(config) -> list:
    """The state dict's parameter keys in one fixed order: a program checks
    its inputs' structure, dict keys in order included."""
    return list(dict.fromkeys(key for _, key, _, _ in param_layout.flax_layout(config)))


def export_infill(params, config, path: str,
                  batch_sizes: Sequence[int] = (1, 8, 32),
                  use_thres: bool = True, thres: float = 0.5,
                  platforms: Sequence[str] = PLATFORMS) -> str:
    """Write the serving predict for ``config`` + ``params`` (the model's
    state dict, tensors on any device or arrays) to ``path``.

    ``batch_sizes`` are ``serve.InfillServer``'s buckets: at load time a
    request routes to the smallest bucket ≥ n and is padded. Traced on the
    CPU; ``platforms`` (of ``"cpu"``, ``"cuda"``) name the devices the
    programs may be loaded on. Returns ``path``.
    """
    from .models import build_model
    from .train.checkpoint import _config_dict

    unknown = sorted(set(platforms) - set(PLATFORMS))
    if unknown or not platforms:
        raise ValueError(f"platforms must be drawn from {list(PLATFORMS)}; got "
                         f"{list(platforms)}")
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive: {batch_sizes}")
    # the programs hold the attention kernel as tgi::fused_mha
    config = dataclasses.replace(config, use_fused_attention=True)
    model = build_model(config, "cpu")
    state = {k: torch.as_tensor(np.asarray(v.detach().float().cpu() if torch.is_tensor(v)
                                           else v, np.float32))
             for k, v in params.items()}
    model.load_state_dict(state, strict=True)
    inputs = {k: state[k] for k in _param_names(config)}
    program = _Predict(_predict_fn(model, use_thres, thres))

    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "config": _config_dict(config),
        "batch_sizes": batch_sizes,
        "use_thres": bool(use_thres),
        "thres": float(thres),
        "platforms": list(platforms),
        "jax_version": None,
        "torch_version": torch.__version__,
    }
    x_shape = (config.max_len, config.embedding_size_src)
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(_META, json.dumps(meta, indent=1))
        z.writestr(_PARAMS, msgpack.serialize(
            param_layout.flax_params_from_state_dict(state, config)))
        for b in batch_sizes:
            with torch.no_grad():
                ep = torch.export.export(program, (inputs, torch.zeros((b,) + x_shape)),
                                         strict=False)
            ep.example_inputs = None  # the parameters would ride along in each program
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            z.writestr(f"bucket_{b}.pt2", buf.getvalue())
    os.replace(tmp, path)  # atomic: never leave a half-written artifact
    return path


class ExportedInfill:
    """A loaded artifact: ``predict``/``__call__`` with the bucket, pad and
    chunk semantics and the input validation of ``serve.InfillServer.infill``,
    running the artifact's programs (or, for a JAX artifact, the rebuilt
    model) on ``device``."""

    def __init__(self, meta: dict, params: dict, buckets: dict, device: torch.device):
        self.meta = meta
        self.config_dict = meta["config"]
        self.batch_sizes = sorted(meta["batch_sizes"])
        self.params = params  # the state dict on ``device``
        self.device = device
        self._buckets = buckets  # b → callable(params, x)

    @property
    def max_len(self) -> int:
        return int(self.config_dict["max_len"])

    @property
    def embedding_size_src(self) -> int:
        return int(self.config_dict["embedding_size_src"])

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.batch_sizes[-1]

    def predict(self, inputs) -> np.ndarray:
        """``(N, T, E_src)`` (or single ``(T, E_src)``) → ``(N, T, 27)``: one
        host→device copy of the padded input, a program call per chunk, one
        device→host copy of the result."""
        x = np.asarray(inputs, np.float32)
        single = x.ndim == 2
        if single:
            x = x[None]
        expected = (self.max_len, self.embedding_size_src)
        if x.ndim != 3 or x.shape[1:] != expected:
            raise ValueError(
                f"input must be (T={expected[0]}, E={expected[1]}) or "
                f"(N, {expected[0]}, {expected[1]}); got "
                f"{np.asarray(inputs).shape}")
        n = x.shape[0]
        chunks = []  # (start, bucket)
        i = 0
        while i < n:
            b = self._bucket(n - i)
            chunks.append((i, b))
            i += b
        if i > n:  # only the last chunk is short: pad its tail with zeros
            x = np.concatenate([x, np.zeros((i - n,) + x.shape[1:], x.dtype)])
        with torch.inference_mode():
            xd = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)  # one copy in
            outs = [self._buckets[b](self.params, xd[s:s + b]) for s, b in chunks]
            out = outs[0] if len(outs) == 1 else torch.cat(outs)
            out = out.cpu().numpy()[:n]  # one copy out
        return out[0] if single else out

    __call__ = predict


def _program(data: bytes, device: torch.device):
    """A ``.pt2`` program, its device arguments moved to ``device``."""
    ep = torch.export.load(io.BytesIO(data))
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, device)
    return ep.module()


def load_infill(path: str, device="cuda") -> ExportedInfill:
    """Load an artifact written by :func:`export_infill` (or by the JAX
    package's) to run on ``device`` (``"cuda"`` without CUDA raises). A
    port artifact's programs load without the model code."""
    device = require_device(device, "load_infill")
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        if _META not in names:
            raise ValueError(f"{path}: not an infill export artifact "
                             "(no meta.json)")
        meta = json.loads(z.read(_META))
        version = meta.get("artifact_version")
        if version != ARTIFACT_VERSION:
            raise ValueError(
                f"{path}: artifact version {version} unsupported "
                f"(this build reads version {ARTIFACT_VERSION})")
        layout = types.SimpleNamespace(**meta["config"])
        state = param_layout.state_dict_from_flax_params(
            msgpack.restore(z.read(_PARAMS)), layout)
        params = {k: state[k].to(device) for k in _param_names(layout)}
        sizes = [int(b) for b in meta["batch_sizes"]]
        if all(f"bucket_{b}.pt2" in names for b in sizes):
            platforms = list(meta.get("platforms") or [])
            if device.type not in platforms:
                raise ValueError(
                    f"{path}: artifact exported for platforms {platforms}; "
                    f"it cannot run on {device.type!r}")
            if meta.get("torch_version") != torch.__version__:
                warnings.warn(
                    f"{path}: artifact was exported under torch "
                    f"{meta.get('torch_version')} but this runtime is "
                    f"{torch.__version__}; re-export if loading or running fails")
            buckets = {b: _program(z.read(f"bucket_{b}.pt2"), device) for b in sizes}
        elif all(f"bucket_{b}.jexp" in names for b in sizes):
            # the JAX package's StableHLO: rebuild the port's model instead
            from .models import build_model
            from .train.checkpoint import config_from_json_dict

            config = config_from_json_dict(meta["config"])
            model = build_model(dataclasses.replace(config, use_fused_attention=True), device)
            model.load_state_dict(state, strict=True)
            predict = _predict_fn(model, bool(meta["use_thres"]), float(meta["thres"]))
            buckets = dict.fromkeys(sizes, predict)
        else:
            raise ValueError(f"{path}: a program is missing for one of the buckets "
                             f"{sizes}")
    return ExportedInfill(meta, params, buckets, device)


def main(argv=None):
    """Export a native checkpoint to a serving artifact."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True,
                   help=".ckpt file, or a directory (newest epoch wins)")
    p.add_argument("--out", required=True, help="artifact path (.tgix)")
    p.add_argument("--batch_sizes", default="1,8,32",
                   help="comma-separated bucket sizes")
    p.add_argument("--platforms", default=",".join(PLATFORMS),
                   help="comma-separated devices the artifact may run on")
    p.add_argument("--use_thres", type=int, default=1)
    p.add_argument("--thres", type=float, default=0.5)
    args = p.parse_args(argv)

    from .models import torch_compat
    from .train.checkpoint import find_latest, load_checkpoint, load_checkpoint_config

    ckpt = args.checkpoint
    if os.path.isdir(ckpt):
        try:
            ckpt, _epoch = find_latest(ckpt)
        except FileNotFoundError as e:
            raise SystemExit(f"no checkpoint found under {ckpt}: {e}")
    if ckpt.endswith(".Model"):
        raise SystemExit(
            "legacy torch .Model checkpoints must be imported first: load "
            "them through train/checkpoint.py::restore (location='local') "
            "and re-save natively, or see MIGRATION.md")
    params, _opt, epoch, loss = load_checkpoint(ckpt)
    config = load_checkpoint_config(ckpt)
    out = export_infill(
        torch_compat.state_dict_from_flax_params(params, config), config, args.out,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
        use_thres=bool(args.use_thres), thres=args.thres,
        platforms=[s.strip() for s in args.platforms.split(",")])
    size_mb = os.path.getsize(out) / 1e6
    print(f"exported {ckpt} (epoch {epoch}, loss {loss:.4f}) -> {out} "
          f"({size_mb:.1f} MB, buckets {args.batch_sizes}, "
          f"platforms {args.platforms})")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
