"""HVO grid operations on tensors, as the JAX package's ``hvo/ops.py``.

Pure functions over fixed-shape tensors ``(..., T, 3V)`` that broadcast over
leading batch dimensions: masking is elementwise selects, and randomness comes
from an explicit ``torch.Generator``. The random draw is split from the select
(:func:`_remove_events`), so a test can give both packages the same numbers.
"""

from __future__ import annotations

import torch

from .mapping import N_VOICES


def split_hvo(hvo: torch.Tensor, n_voices: int = N_VOICES):
    """Split ``(..., T, 3V)`` into hits/velocities/offsets ``(..., T, V)`` views."""
    return (hvo[..., :n_voices], hvo[..., n_voices:2 * n_voices], hvo[..., 2 * n_voices:])


def combine_hvo(h: torch.Tensor, v: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Concatenate hits/velocities/offsets back into a ``(..., T, 3V)`` grid."""
    return torch.cat([h, v, o], dim=-1)


def voice_mask_from_indices(voice_idx, n_voices: int = N_VOICES, device=None) -> torch.Tensor:
    """Boolean ``(V,)`` mask with True at the given voice indices; an index
    out of range raises (a typo would otherwise train against empty targets)."""
    idx = [int(v) for v in voice_idx]
    if any(not 0 <= v < n_voices for v in idx):
        raise ValueError(f"voice indices {idx} out of range for {n_voices} voices")
    mask = torch.zeros(n_voices, dtype=torch.bool, device=device)
    if idx:
        mask[idx] = True
    return mask


def channel_mask(voice_mask: torch.Tensor) -> torch.Tensor:
    """Expand a ``(V,)`` voice mask to the ``(3V,)`` HVO channel layout: hit
    channel = voice index, velocity = +V, offset = +2V."""
    return torch.cat([voice_mask, voice_mask, voice_mask], dim=-1)


def reset_voices(hvo: torch.Tensor, voice_mask: torch.Tensor):
    """Split a groove into (input, target) by removing whole voices: the
    input keeps every voice not in the mask, the target only the removed
    ones. ``voice_mask``: ``(V,)`` bool, True = remove. Returns ``(kept,
    removed)``."""
    cmask = channel_mask(voice_mask)
    zero = torch.zeros((), dtype=hvo.dtype, device=hvo.device)
    return torch.where(cmask, zero, hvo), torch.where(cmask, hvo, zero)


def _remove_events(hvo: torch.Tensor, thres: torch.Tensor, u: torch.Tensor):
    """The select of :func:`remove_random_events`: an active hit cell whose
    ``u`` ``(..., T, V)`` lies below ``thres`` (broadcast against it) moves,
    with its velocity and offset, to the target grid."""
    n_voices = hvo.shape[-1] // 3
    remove = (u < thres) & (hvo[..., :n_voices] > 0)
    remove3 = torch.cat([remove, remove, remove], dim=-1)
    zero = torch.zeros((), dtype=hvo.dtype, device=hvo.device)
    return torch.where(remove3, zero, hvo), torch.where(remove3, hvo, zero)


def remove_random_events_batch(hvo: torch.Tensor, generator: torch.Generator,
                               thres_range=(0.4, 0.6)):
    """Split grooves ``(M, T, 3V)`` into (input, target) by removing a random
    subset of events: per item one removal threshold drawn uniformly from
    ``thres_range``, then every event removed independently with that
    probability. Returns ``(kept, removed)``; draws on ``hvo``'s device."""
    n_voices = hvo.shape[-1] // 3
    lo, hi = thres_range
    thres = lo + (hi - lo) * torch.rand((hvo.shape[0], 1, 1), generator=generator,
                                        device=hvo.device)
    u = torch.rand(hvo.shape[:-1] + (n_voices,), generator=generator, device=hvo.device)
    return _remove_events(hvo, thres, u)


def remove_random_events(hvo: torch.Tensor, generator: torch.Generator,
                         thres_range=(0.4, 0.6)):
    """:func:`remove_random_events_batch` for one groove ``(T, 3V)``."""
    kept, removed = remove_random_events_batch(hvo[None], generator, thres_range)
    return kept[0], removed[0]


def reset_voices_batch(hvo: torch.Tensor, voice_masks: torch.Tensor):
    """:func:`reset_voices` over ``(M, T, 3V)`` with one ``(V,)`` mask per item."""
    cmask = channel_mask(voice_masks)[:, None, :]
    zero = torch.zeros((), dtype=hvo.dtype, device=hvo.device)
    return torch.where(cmask, zero, hvo), torch.where(cmask, hvo, zero)


def get_active_voices(hvo: torch.Tensor) -> torch.Tensor:
    """Boolean ``(..., V)`` mask of voices with at least one hit."""
    n_voices = hvo.shape[-1] // 3
    return (hvo[..., :n_voices] > 0).any(dim=-2)


def pad_to_length(hvo: torch.Tensor, max_len: int) -> torch.Tensor:
    """Zero-pad (or truncate) the time axis to exactly ``max_len`` rows."""
    t = hvo.shape[-2]
    if t < max_len:
        hvo = torch.nn.functional.pad(hvo, (0, 0, 0, max_len - t))
    return hvo[..., :max_len, :]


def is_silent(hvo: torch.Tensor) -> torch.Tensor:
    """True if the grid holds no information at all."""
    return ~(hvo != 0).any(dim=-1).any(dim=-1)
