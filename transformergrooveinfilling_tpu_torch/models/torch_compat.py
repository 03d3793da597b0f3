"""Weights and optimizer state carried between the port and the JAX package's
trees and files.

- :func:`flax_layout`: one table of every parameter leaf, its flax path
  (``("encoder_layer_0", "self_attn", "qkv", "kernel")``), the state-dict key
  it lives in, whether the flax leaf is the transpose (``kernel`` is
  ``weight``ᵀ) and which rows of the key it holds (a decoder layer's
  cross-attention ``q`` is the first d rows of ``multihead_attn.in_proj_*``,
  its packed ``kv`` the other 2d).
- :func:`state_dict_from_flax_params` and its inverse
  :func:`flax_params_from_state_dict` (the JAX ``params_to_state_dict`` /
  ``state_dict_to_params`` pair, on this model's keys), both through that
  table.
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

from .transformer import GrooveTransformerConfig, sinusoidal_positional_encoding

STORED_PE_KEY = "InputLayerEncoder.PositionalEncoding.pe"
STORED_PE_KEYS = (STORED_PE_KEY, "InputLayerDecoder.PositionalEncoding.pe")


def flax_layout(config: GrooveTransformerConfig) -> list:
    """``[(flax path, state-dict key, transposed, rows or None), ...]`` for
    every parameter leaf of ``config``'s model, in state-dict order."""
    out = []

    def dense(key: str, path: tuple) -> None:
        out.append((path + ("kernel",), key + ".weight", True, None))
        out.append((path + ("bias",), key + ".bias", False, None))

    def norm(key: str, path: tuple) -> None:
        out.append((path + ("scale",), key + ".weight", False, None))
        out.append((path + ("bias",), key + ".bias", False, None))

    def layer(pre: str, path: tuple, norms, cross: bool) -> None:
        out.append((path + ("self_attn", "qkv", "kernel"), pre + "self_attn.in_proj_weight",
                    True, None))
        out.append((path + ("self_attn", "qkv", "bias"), pre + "self_attn.in_proj_bias",
                    False, None))
        dense(pre + "self_attn.out_proj", path + ("self_attn", "out"))
        if cross:
            d = config.d_model
            for name, rows in (("q", slice(0, d)), ("kv", slice(d, None))):
                out.append((path + ("cross_attn", name, "kernel"),
                            pre + "multihead_attn.in_proj_weight", True, rows))
            for name, rows in (("q", slice(0, d)), ("kv", slice(d, None))):
                out.append((path + ("cross_attn", name, "bias"),
                            pre + "multihead_attn.in_proj_bias", False, rows))
            dense(pre + "multihead_attn.out_proj", path + ("cross_attn", "out"))
        for name in ("linear1", "linear2"):
            dense(pre + name, path + (name,))
        for name in norms:
            norm(pre + name, path + (name,))

    dense("InputLayerEncoder.Linear", ("input", "embed"))
    for i in range(config.num_encoder_layers):
        layer(f"Encoder.Encoder.layers.{i}.", (f"encoder_layer_{i}",), ("norm1", "norm2"), False)
    norm("Encoder.Encoder.norm", ("encoder_norm",))
    if not config.encoder_only:
        dense("InputLayerDecoder.Linear", ("input_tgt", "embed"))
        for i in range(config.num_decoder_layers):
            layer(f"Decoder.Decoder.layers.{i}.", (f"decoder_layer_{i}",),
                  ("norm1", "norm2", "norm3"), True)
        norm("Decoder.Decoder.norm", ("decoder_norm",))
    dense("OutputLayer.Linear", ("output", "proj"))
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def state_dict_from_flax_params(params, config: GrooveTransformerConfig) -> dict:
    """JAX ``params`` tree (numpy arrays) → ``{name: float32 CPU tensor}`` for
    ``load_state_dict(strict=True)``."""
    parts: dict = {}
    for path, key, transposed, _rows in flax_layout(config):
        a = np.asarray(_get(params, path), dtype=np.float32)
        parts.setdefault(key, []).append(a.T if transposed else a)
    return {key: torch.from_numpy(np.array(p[0] if len(p) == 1 else np.concatenate(p),
                                           copy=True))
            for key, p in parts.items()}


def flax_params_from_state_dict(state_dict, config: GrooveTransformerConfig) -> dict:
    """This model's state dict (tensors on any device, or arrays) → the JAX
    ``params`` tree of float32 numpy arrays; stored PE buffers are ignored."""
    host = {}
    params: dict = {}
    for path, key, transposed, rows in flax_layout(config):
        if key not in host:
            v = state_dict[key]
            host[key] = (v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor)
                         else np.asarray(v, np.float32))
        a = host[key] if rows is None else host[key][rows]
        # a copy: on the CPU the state dict's tensors are the live parameters
        _set(params, path, np.array(a.T if transposed else a, dtype=np.float32, order="C"))
    return params


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
