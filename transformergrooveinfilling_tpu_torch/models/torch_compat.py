"""Weights and optimizer state carried between the port and the JAX package's
trees and files.

- :func:`flax_layout` (in ``utils/param_layout.py``, which needs no model
  code): one table of every parameter leaf, its flax path
  (``("encoder_layer_0", "self_attn", "qkv", "kernel")``), the state-dict key
  it lives in, whether the flax leaf is the transpose (``kernel`` is
  ``weight``ᵀ) and which rows of the key it holds (a decoder layer's
  cross-attention ``q`` is the first d rows of ``multihead_attn.in_proj_*``,
  its packed ``kv`` the other 2d).
- :func:`state_dict_from_flax_params` and its inverse
  :func:`flax_params_from_state_dict` (the JAX ``params_to_state_dict`` /
  ``state_dict_to_params`` pair, on this model's keys, and under those names
  too), both through that table.
- the optimizer state both ways: optax ``sgd`` is ``{"0": {}, "1": {}}``;
  ``adam`` is ``{"0": {"count", "mu", "nu"}, "1": {}}`` with ``mu``/``nu``
  parameter trees. ``torch.optim.Adam`` keeps per parameter ``step``,
  ``exp_avg`` (= mu, through the parameter map) and ``exp_avg_sq`` (= nu);
  optax's one ``count`` is every parameter's ``step`` (both count the updates
  taken, and both bias-correct by it after incrementing).
- :func:`load_legacy_checkpoint` / :func:`save_legacy_checkpoint`: the
  reference's ``.Model`` files (``{epoch, model_state_dict,
  optimizer_state_dict, loss}``), read with ``weights_only=True``; the stored
  PE buffers are dropped on load (the model recomputes them) and written on
  save, as the JAX package writes them.
- :func:`find_latest_checkpoint`: the newest-epoch ``.Model`` in a directory.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from ..utils.param_layout import (  # noqa: F401  (kept under this module's names)
    flax_layout, flax_params_from_state_dict, state_dict_from_flax_params,
)
from .transformer import GrooveTransformerConfig, sinusoidal_positional_encoding

STORED_PE_KEY = "InputLayerEncoder.PositionalEncoding.pe"
STORED_PE_KEYS = (STORED_PE_KEY, "InputLayerDecoder.PositionalEncoding.pe")


# the JAX module's names, same arguments
state_dict_to_params = flax_params_from_state_dict
params_to_state_dict = state_dict_from_flax_params


def _algorithm(optimizer) -> str:
    if isinstance(optimizer, torch.optim.Adam):
        return "adam"
    if isinstance(optimizer, torch.optim.SGD):
        return "sgd"
    raise ValueError(f"no optax counterpart for {type(optimizer).__name__}")


def optimizer_moments(optimizer, model) -> tuple:
    """``(algorithm, count, mu, nu)`` of ``optimizer`` over
    ``model.named_parameters()``: ``"sgd"`` or ``"adam"``, the updates taken,
    and Adam's ``{name: exp_avg}`` / ``{name: exp_avg_sq}`` (zeros before the
    first update; empty for SGD). The tensors are the live state."""
    algorithm = _algorithm(optimizer)
    if algorithm == "sgd":
        return algorithm, 0, {}, {}
    named = list(model.named_parameters())
    states = [optimizer.state.get(p, {}) for _, p in named]
    steps = {int(s["step"]) if "step" in s else 0 for s in states}
    if len(steps) != 1:
        raise ValueError(f"Adam parameters have taken different step counts {sorted(steps)}; "
                         "optax keeps one count")
    mu = {n: s.get("exp_avg", torch.zeros_like(p)) for (n, p), s in zip(named, states)}
    nu = {n: s.get("exp_avg_sq", torch.zeros_like(p)) for (n, p), s in zip(named, states)}
    return algorithm, steps.pop(), mu, nu


def optax_state(algorithm: str, count: int, mu: dict, nu: dict,
                config: GrooveTransformerConfig) -> dict:
    """:func:`optimizer_moments`' result → the optax state tree as
    ``flax.serialization.to_state_dict`` writes it."""
    if algorithm == "sgd":
        return {"0": {}, "1": {}}
    return {"0": {"count": np.array(count, dtype=np.int32),
                  "mu": flax_params_from_state_dict(mu, config),
                  "nu": flax_params_from_state_dict(nu, config)},
            "1": {}}


def optax_state_from_optimizer(optimizer, model, config: GrooveTransformerConfig) -> dict:
    """``optimizer``'s state (over ``model.parameters()``) → the optax state
    tree."""
    return optax_state(*optimizer_moments(optimizer, model), config)


def load_optax_state(optimizer, model, config: GrooveTransformerConfig, opt_state) -> None:
    """Put an optax state tree (:func:`optax_state_from_optimizer`'s form)
    into ``optimizer``. Raises ``ValueError`` when the tree is another
    optimizer's."""
    first = opt_state.get("0", {}) if isinstance(opt_state, dict) else None
    kind = ("sgd" if first == {} and opt_state.get("1") == {} else
            "adam" if isinstance(first, dict) and set(first) == {"count", "mu", "nu"} else None)
    if kind != _algorithm(optimizer):
        raise ValueError(f"the optimizer state is {kind or 'unknown'}'s, not "
                         f"{_algorithm(optimizer)}'s")
    if kind == "sgd":
        return
    step = float(np.asarray(first["count"]))
    mu = state_dict_from_flax_params(first["mu"], config)
    nu = state_dict_from_flax_params(first["nu"], config)
    names = [name for name, _ in model.named_parameters()]
    state = {i: {"step": torch.tensor(step, dtype=torch.float32), "exp_avg": mu[n],
                 "exp_avg_sq": nu[n]} for i, n in enumerate(names)}
    optimizer.load_state_dict({"state": state,
                               "param_groups": optimizer.state_dict()["param_groups"]})


def load_legacy_checkpoint(path: str, config: GrooveTransformerConfig):
    """Reference ``.Model`` file of either family → ``(state_dict, epoch,
    loss)``. Raises ``ValueError`` when the file's family (it has
    ``Decoder.*`` keys or not) is not ``config``'s."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.float() for k, v in ckpt["model_state_dict"].items()
          if k not in STORED_PE_KEYS}
    has_decoder = any(k.startswith("Decoder.") for k in sd)
    if has_decoder == config.encoder_only:
        raise ValueError(
            f"{path} holds an {'encoder-decoder' if has_decoder else 'encoder-only'} model, "
            f"but the config has num_decoder_layers={config.num_decoder_layers}")
    return sd, int(ckpt["epoch"]), float(ckpt["loss"])


def save_legacy_checkpoint(path: str, params, config: GrooveTransformerConfig, epoch: int,
                           loss: float) -> None:
    """Write a reference-format ``.Model`` file from a JAX ``params`` tree:
    the dict the JAX package's ``save_legacy_checkpoint`` writes (the state
    dict with its PE buffers, an empty optimizer state)."""
    sd = state_dict_from_flax_params(params, config)
    pe = sinusoidal_positional_encoding(config.max_len, config.d_model)
    stored = {STORED_PE_KEY: pe}
    if not config.encoder_only:
        stored["InputLayerDecoder.PositionalEncoding.pe"] = pe.clone()
    torch.save({"epoch": epoch, "model_state_dict": {**sd, **stored},
                "optimizer_state_dict": {"param_groups": []}, "loss": loss}, path)


def find_latest_checkpoint(model_dir: str, file_pattern: str = "transformer_run_{}_Epoch_{}.Model"):
    """Locate the newest-epoch ``.Model`` in a directory → ``(path, epoch)``.

    The pattern has ``{run}`` and ``{epoch}`` holes; the highest epoch wins.
    """
    regex = re.compile(
        re.escape(file_pattern).replace(r"\{\}", "(.+?)", 1).replace(r"\{\}", r"(\d+)", 1)
        + "$"
    )
    best = None
    for fname in os.listdir(model_dir):
        m = regex.match(fname)
        if m:
            epoch = int(m.group(2))
            if best is None or epoch > best[0]:
                best = (epoch, os.path.join(model_dir, fname))
    if best is None:
        raise FileNotFoundError(f"no checkpoint matching {file_pattern!r} in {model_dir}")
    return best[1], best[0]
