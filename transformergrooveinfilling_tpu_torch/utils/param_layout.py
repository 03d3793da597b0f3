"""The map between the model's state dict and the JAX package's flax
parameter tree, on numpy and torch alone (no model code), so that a serving
artifact's parameters load without ``models/``. ``models/torch_compat.py``
carries these under the same names.

- :func:`flax_layout`: one table of every parameter leaf, its flax path
  (``("encoder_layer_0", "self_attn", "qkv", "kernel")``), the state-dict key
  it lives in, whether the flax leaf is the transpose (``kernel`` is
  ``weight``ᵀ) and which rows of the key it holds (a decoder layer's
  cross-attention ``q`` is the first d rows of ``multihead_attn.in_proj_*``,
  its packed ``kv`` the other 2d).
- :func:`state_dict_from_flax_params` and its inverse
  :func:`flax_params_from_state_dict`, both through that table.
- :func:`stacked_state_dict_from_flax_params` and
  :func:`stacked_flax_params_from_state_dict`: the same with a leading trial
  axis on every leaf, for the stacked weights of a batched sweep
  (``train/vmap_sweep.py``; the JAX ``init_stacked_params``' trees).

``config`` is any object with ``d_model``, ``num_encoder_layers`` and
``num_decoder_layers`` (a ``GrooveTransformerConfig``, or an artifact's
config read from its JSON).
"""

from __future__ import annotations

import numpy as np
import torch


def flax_layout(config) -> list:
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
    if config.num_decoder_layers:
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


def state_dict_from_flax_params(params, config) -> dict:
    """JAX ``params`` tree (numpy arrays) → ``{name: float32 CPU tensor}`` for
    ``load_state_dict(strict=True)``."""
    parts: dict = {}
    for path, key, transposed, _rows in flax_layout(config):
        a = np.asarray(_get(params, path), dtype=np.float32)
        parts.setdefault(key, []).append(a.T if transposed else a)
    return {key: torch.from_numpy(np.array(p[0] if len(p) == 1 else np.concatenate(p),
                                           copy=True))
            for key, p in parts.items()}


def flax_params_from_state_dict(state_dict, config) -> dict:
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


def _trial(tree, k: int):
    """Trial ``k`` of a tree of arrays stacked on a leading axis."""
    if isinstance(tree, dict):
        return {name: _trial(sub, k) for name, sub in tree.items()}
    return np.asarray(tree)[k]


def _n_trials(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.shape(tree)[0]


def stacked_state_dict_from_flax_params(params, config) -> dict:
    """Stacked JAX ``params`` (every leaf with a leading trial axis K) →
    ``{name: (K, ...) float32 CPU tensor}``, trial k being
    :func:`state_dict_from_flax_params` of trial k's tree."""
    per = [state_dict_from_flax_params(_trial(params, k), config)
           for k in range(_n_trials(params))]
    return {key: torch.stack([sd[key] for sd in per]) for key in per[0]}


def stacked_flax_params_from_state_dict(state_dict, config) -> dict:
    """Stacked state dict (``(K, ...)`` tensors on any device, or arrays) →
    the stacked JAX ``params`` tree of float32 numpy arrays."""
    n = len(next(iter(state_dict.values())))
    per = [flax_params_from_state_dict({key: v[k] for key, v in state_dict.items()}, config)
           for k in range(n)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {name: stack([t[name] for t in trees]) for name in trees[0]}
        return np.stack(trees)

    return stack(per)
