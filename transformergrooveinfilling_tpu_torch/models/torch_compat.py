"""Weights carried into the port.

- :func:`state_dict_from_flax_params`: a JAX-package parameter tree (numpy
  arrays) → this model's state dict; the inverse of the JAX
  ``torch_compat.state_dict_to_params`` (flax ``kernel`` transposed, the packed
  qkv keeping torch's ``[q; k; v]`` row order; a decoder layer's
  cross-attention ``q`` (d→d) and packed ``kv`` (d→2d) become the rows
  ``[q; k; v]`` of ``multihead_attn.in_proj_weight``).
- :func:`load_legacy_checkpoint`: a reference ``.Model`` file
  (``{epoch, model_state_dict, optimizer_state_dict, loss}``), read with
  ``weights_only=True``; its stored PE buffers are dropped, since the model
  recomputes them.
- :func:`find_latest_checkpoint`: the newest-epoch ``.Model`` in a directory.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from .transformer import GrooveTransformerConfig

STORED_PE_KEY = "InputLayerEncoder.PositionalEncoding.pe"
STORED_PE_KEYS = (STORED_PE_KEY, "InputLayerDecoder.PositionalEncoding.pe")


def _t(a, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    return torch.from_numpy(np.array(a.T if transpose else a, copy=True))


def state_dict_from_flax_params(params, config: GrooveTransformerConfig) -> dict:
    """JAX ``params`` tree → ``{name: float32 tensor}`` for
    ``load_state_dict(strict=True)``."""
    sd = {}

    def dense(key: str, p) -> None:
        sd[key + ".weight"], sd[key + ".bias"] = _t(p["kernel"], True), _t(p["bias"])

    def norm(key: str, p) -> None:
        sd[key + ".weight"], sd[key + ".bias"] = _t(p["scale"]), _t(p["bias"])

    def layer(pre: str, lp, norms) -> None:
        sd[pre + "self_attn.in_proj_weight"] = _t(lp["self_attn"]["qkv"]["kernel"], True)
        sd[pre + "self_attn.in_proj_bias"] = _t(lp["self_attn"]["qkv"]["bias"])
        dense(pre + "self_attn.out_proj", lp["self_attn"]["out"])
        for name in ("linear1", "linear2"):
            dense(pre + name, lp[name])
        for name in norms:
            norm(pre + name, lp[name])

    dense("InputLayerEncoder.Linear", params["input"]["embed"])
    for i in range(config.num_encoder_layers):
        layer(f"Encoder.Encoder.layers.{i}.", params[f"encoder_layer_{i}"], ("norm1", "norm2"))
    norm("Encoder.Encoder.norm", params["encoder_norm"])
    if not config.encoder_only:
        dense("InputLayerDecoder.Linear", params["input_tgt"]["embed"])
        for i in range(config.num_decoder_layers):
            lp = params[f"decoder_layer_{i}"]
            pre = f"Decoder.Decoder.layers.{i}."
            layer(pre, lp, ("norm1", "norm2", "norm3"))
            ca = lp["cross_attn"]
            sd[pre + "multihead_attn.in_proj_weight"] = torch.cat(
                [_t(ca["q"]["kernel"], True), _t(ca["kv"]["kernel"], True)])
            sd[pre + "multihead_attn.in_proj_bias"] = torch.cat(
                [_t(ca["q"]["bias"]), _t(ca["kv"]["bias"])])
            dense(pre + "multihead_attn.out_proj", ca["out"])
        norm("Decoder.Decoder.norm", params["decoder_norm"])
    dense("OutputLayer.Linear", params["output"]["proj"])
    return sd


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
