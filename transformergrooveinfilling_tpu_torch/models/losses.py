"""Three-headed infilling loss, as the JAX package's ``models/losses.py``.

BCE-with-logits on hits plus MSE on the velocity and offset heads, each
elementwise term scaled by a hit-loss-penalty matrix that is 1 at
ground-truth hit cells and ``hit_loss_penalty`` elsewhere. Each term sums over
the voices and takes the (sample-weighted) mean over batch × time; the
denominator is the number of live (b, t) rows, guarded at 1. Also returns the
hit accuracy and perplexity diagnostics.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class LossOutputs(NamedTuple):
    total_loss: torch.Tensor
    hit_accuracy: torch.Tensor
    hit_perplexity: torch.Tensor
    bce_hits: torch.Tensor
    mse_velocities: torch.Tensor
    mse_offsets: torch.Tensor


def calculate_loss(prediction, target: torch.Tensor, hit_loss_penalty: float,
                   sample_weights: Optional[torch.Tensor] = None) -> LossOutputs:
    """The infilling training loss.

    ``prediction``: ``(h_logits, v, o)``, each ``(B, T, V)``; ``target``:
    the HVO grid ``(B, T, 3V)``; ``sample_weights``: optional ``(B,)`` 0/1
    weights, so padded rows of a partial final batch drop out of every mean.
    """
    pred_h, pred_v, pred_o = prediction
    n = target.shape[-1] // 3
    y_h, y_v, y_o = target[..., :n], target[..., n:2 * n], target[..., 2 * n:]
    f32 = torch.float32
    penalty = torch.where(y_h == 1, 1.0, hit_loss_penalty).to(f32)
    if sample_weights is None:
        w_rows = torch.ones(target.shape[:-1], dtype=f32, device=target.device)
    else:
        w_rows = sample_weights.to(f32)[..., None].expand(target.shape[:-1])
    denom = torch.clamp(w_rows.sum(), min=1.0)  # number of live (b, t) rows
    penalty = penalty * w_rows[..., None]

    def row_mean(cellwise):  # sum over voices, weighted mean over (B, T)
        return cellwise.sum() / denom

    bce = F.binary_cross_entropy_with_logits(pred_h.to(f32), y_h, reduction="none")
    bce_hits = row_mean(bce * penalty)
    mse_velocities = row_mean(torch.square(pred_v.to(f32) - y_v) * penalty)
    mse_offsets = row_mean(torch.square(pred_o.to(f32) - y_o) * penalty)
    total_loss = bce_hits + mse_velocities + mse_offsets

    h_pred = (torch.sigmoid(pred_h) > 0.5).to(f32)
    correct = (h_pred == y_h).to(f32) * w_rows[..., None]
    hit_accuracy = correct.sum() / (denom * n)
    return LossOutputs(total_loss=total_loss, hit_accuracy=hit_accuracy,
                       hit_perplexity=torch.exp(bce_hits), bce_hits=bce_hits,
                       mse_velocities=mse_velocities, mse_offsets=mse_offsets)
