"""Scalar evaluation metrics, as the JAX package's ``eval/metrics.py``.

The reference's per-epoch scalars: hit accuracy, velocity MSE and
micro-timing MSE per voice of the 9-voice mapping, over the stacked
``(N, T, 3V)`` prediction and ground-truth arrays, merged into one flat
``{set}_{Family}_{voice}`` dict (``_mean`` per family).

Placement follows the arrays. Tensors reduce on their own device
(:func:`_metric_stack_torch`, the twin of the JAX ``_metric_stack_jit``) and
come back in one transfer of the three ``(V,)`` stacks; numpy arrays reduce
in numpy and never touch a device: the evaluator's predictions are host
arrays, and shipping them to the card to reduce a few MB costs more than the
reduction.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hvo.mapping import VOICE_NAMES


def _metric_stack_torch(pred: torch.Tensor, gt: torch.Tensor):
    """(hits accuracy, velocity MSE, offset MSE) per voice, each ``(V,)``,
    on the tensors' device."""
    n = gt.shape[-1] // 3
    p_h, g_h = pred[..., :n], gt[..., :n]
    p_v, g_v = pred[..., n:2 * n], gt[..., n:2 * n]
    p_o, g_o = pred[..., 2 * n:], gt[..., 2 * n:]
    acc = (p_h == g_h).to(torch.float32).mean(dim=(0, 1))
    mse_v = torch.square(p_v - g_v).mean(dim=(0, 1))
    mse_o = torch.square(p_o - g_o).mean(dim=(0, 1))
    return acc, mse_v, mse_o


def _metric_stack_np(pred: np.ndarray, gt: np.ndarray):
    """Numpy twin of :func:`_metric_stack_torch` (same math, same dtypes)."""
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    n = gt.shape[-1] // 3
    acc = np.mean((pred[..., :n] == gt[..., :n]).astype(np.float32), axis=(0, 1))
    mse_v = np.mean(np.square(pred[..., n:2 * n] - gt[..., n:2 * n]), axis=(0, 1))
    mse_o = np.mean(np.square(pred[..., 2 * n:] - gt[..., 2 * n:]), axis=(0, 1))
    return acc, mse_v, mse_o


def _metric_stack(pred, gt):
    """Route by residency: tensors reduce in place and come back in one
    transfer of the three stacks; host arrays never touch a device. Returns
    three host numpy ``(V,)`` arrays either way."""
    if isinstance(pred, torch.Tensor) or isinstance(gt, torch.Tensor):
        device = pred.device if isinstance(pred, torch.Tensor) else gt.device
        stacks = torch.stack(_metric_stack_torch(
            torch.as_tensor(pred, device=device), torch.as_tensor(gt, device=device)))
        return tuple(stacks.cpu().numpy())
    return _metric_stack_np(pred, gt)


def hits_accuracy_per_voice(pred, gt) -> np.ndarray:
    return np.asarray(_metric_stack(pred, gt)[0])


def velocity_mse_per_voice(pred, gt) -> np.ndarray:
    return np.asarray(_metric_stack(pred, gt)[1])


def offset_mse_per_voice(pred, gt) -> np.ndarray:
    return np.asarray(_metric_stack(pred, gt)[2])


def format_families(identifier: str, acc, mse_v, mse_o, voice_names=None) -> dict:
    """Per-voice metric stacks → the reference's flat ``{key: float}`` naming
    (``{set}_{Family}_{voice}`` + ``_mean``). Shared by :func:`metrics_dict`
    and the driver's per-block eval pass, so both log the same keys."""
    voice_names = list(voice_names) if voice_names else list(VOICE_NAMES)
    out = {}
    for fam, arr in (("Hits_Accuracy", np.asarray(acc)),
                     ("Velocity_MSE", np.asarray(mse_v)),
                     ("Micro_Timing_MSE", np.asarray(mse_o))):
        for name, val in zip(voice_names, arr):
            out[f"{identifier}_{fam}_{name}"] = float(val)
        out[f"{identifier}_{fam}_mean"] = float(arr.mean())
    return out


def metrics_dict(pred, gt, identifier: str, drum_mapping=None) -> dict:
    """All three metric families as one flat ``{key: float}`` dict."""
    acc, mse_v, mse_o = _metric_stack(pred, gt)
    return format_families(identifier, acc, mse_v, mse_o, voice_names=drum_mapping)


def rhythmic_distances(pred, gt, identifier: str = "") -> dict:
    """Prediction↔GT rhythmic distance summary: per-pair hamming distance on
    hits, L2 on velocities, L2 on offsets; mean and std across the set."""
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    n = gt.shape[-1] // 3
    hamming = np.abs((pred[..., :n] > 0.5) ^ (gt[..., :n] > 0.5)).sum(axis=(1, 2))
    vel_l2 = np.sqrt(np.square(pred[..., n:2 * n] - gt[..., n:2 * n]).sum(axis=(1, 2)))
    off_l2 = np.sqrt(np.square(pred[..., 2 * n:] - gt[..., 2 * n:]).sum(axis=(1, 2)))
    prefix = f"{identifier}_" if identifier else ""
    return {
        f"{prefix}Rhythmic_Distance_Hamming_mean": float(hamming.mean()),
        f"{prefix}Rhythmic_Distance_Hamming_std": float(hamming.std()),
        f"{prefix}Rhythmic_Distance_Velocity_L2_mean": float(vel_l2.mean()),
        f"{prefix}Rhythmic_Distance_Velocity_L2_std": float(vel_l2.std()),
        f"{prefix}Rhythmic_Distance_Offset_L2_mean": float(off_l2.mean()),
        f"{prefix}Rhythmic_Distance_Offset_L2_std": float(off_l2.std()),
    }
