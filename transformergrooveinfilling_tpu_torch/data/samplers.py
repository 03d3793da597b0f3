"""Voice-combination and soundfont augmentation samplers, as the JAX
package's ``data/samplers.py``.

They run on the host while a dataset is built (metadata-scale work); the
masking they plan runs vectorized afterwards. Sampling keeps the reference's
semantics, weighted ``choices`` with replacement (duplicates possible), drawn
from an explicit ``random.Random`` in the JAX package's order, so a build from
a seed plans the same items in either package.
"""

from __future__ import annotations

import itertools
import os
import random as _random
from copy import deepcopy

import numpy as np


def get_sf_list(sf_path):
    """Expand a soundfont spec (single .sf2 / directory / list / None) to a list.

    The reference's missing-slash join is fixed (``os.path.join`` per
    entry). ``None`` maps to the built-in procedural kit.
    """
    if sf_path is None:
        return [None]
    if isinstance(sf_path, (list, tuple)):
        return list(sf_path)
    if str(sf_path).endswith(".sf2"):
        return [sf_path]
    if os.path.isdir(sf_path):
        return sorted(
            os.path.join(sf_path, sf)
            for sf in os.listdir(sf_path)
            if sf.endswith(".sf2")
        )
    return [sf_path]


def get_voice_idx_for_item(hvo_seq, voices_params: dict):
    """Drop voices absent from the item from the removal candidates;
    returns (voice_idx, updated_params).

    As in the JAX package, ``prob`` is truncated to the number of combination
    sizes actually available (the reference truncates it to
    ``len(voice_idx)`` and then fails its own sampler's length check on a
    sparse item)."""
    active = set(np.asarray(hvo_seq.get_active_voices()).tolist())
    voice_idx = [v for v in voices_params["voice_idx"] if v in active]
    params = deepcopy(voices_params)
    params["voice_idx"] = voice_idx
    min_n = params.get("min_n_voices_to_remove", 1)
    max_n = min(params.get("max_n_voices_to_remove", 3), len(voice_idx))
    params["prob"] = params["prob"][: max(0, max_n - min_n + 1)]
    return voice_idx, params


def get_voice_combinations(
    voice_idx=(0, 1, 2, 3, 4),
    min_n_voices_to_remove: int = 1,
    max_n_voices_to_remove: int = 3,
    prob=(1, 1, 1),
    k: int | None = 5,
    rng: _random.Random | None = None,
    **_ignored,
):
    """k weighted samples (with replacement) from all removal combinations of
    size min..max; k=None returns every combination."""
    rng = rng or _random
    voice_idx = list(voice_idx)
    max_n = min(max_n_voices_to_remove, len(voice_idx))
    if max_n < min_n_voices_to_remove:
        # too few active voices to form any removal set: no combinations
        # (the dataset marks such items unused) — the reference asserts and
        # aborts the whole build here instead
        return []
    sizes = range(min_n_voices_to_remove, max_n + 1)
    prob = list(prob)
    if len(prob) != len(sizes):
        raise ValueError(
            "prob list must match range(min_n_voices_to_remove, max_n_voices_to_remove)")

    combos, weights = [], []
    for i, n in enumerate(sizes):
        new = list(itertools.combinations(voice_idx, n))
        combos.extend(new)
        weights.extend([prob[i]] * len(new))

    if k is None:
        return combos
    return rng.choices(combos, weights=weights, k=k)


def get_sf_v_combinations(
    voices_parameters: dict,
    max_aug_items: int,
    max_n_sf: int | None,
    sfs_list,
    rng: _random.Random | None = None,
):
    """Product of sampled soundfonts × voice combos, capped at ``max_aug_items``."""
    rng = rng or _random
    if len(voices_parameters["voice_idx"]) == 1:
        v_comb = [tuple(voices_parameters["voice_idx"])]
    else:
        v_comb = get_voice_combinations(rng=rng, **voices_parameters)

    sfs = rng.choices(sfs_list, k=max_n_sf) if max_n_sf is not None else list(sfs_list)

    sf_v_comb = list(itertools.product(sfs, v_comb))
    if len(sf_v_comb) > max_aug_items:
        sf_v_comb = rng.choices(sf_v_comb, k=max_aug_items)
    return sf_v_comb
