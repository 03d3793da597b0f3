"""Evaluation and checkpoint-epoch scheduling, as the JAX package's
``train/schedule.py``: the reference's ``eval_log_freq``, dense during the
first ``initial_epochs_lim`` epochs, sparser afterwards, always including the
final epoch; ``only_final`` collapses to the last epoch (sweeps).

The reference returns ``(partial, all)`` but its training script unpacks them
swapped; this returns ``(partial, all)`` and the driver unpacks them in that
order, as the JAX package does.
"""

from __future__ import annotations

import numpy as np


def eval_log_freq(
    total_epochs: int,
    initial_epochs_lim: int = 10,
    initial_step_partial: int = 1,
    initial_step_all: int = 1,
    secondary_step_partial: int = 10,
    secondary_step_all: int = 20,
    only_final: bool = False,
):
    """Return ``(epoch_save_partial, epoch_save_all)`` epoch-index arrays."""
    if only_final:
        return np.asarray([total_epochs - 1]), np.asarray([], dtype=int)

    if initial_epochs_lim >= total_epochs:
        partial = np.arange(total_epochs, step=initial_step_partial)
        full = np.arange(total_epochs, step=initial_step_all)
        # the final epoch is always evaluated/saved, in this branch too
        # (the reference omits it here when a step > 1 is used)
        if total_epochs - 1 not in partial:
            partial = np.append(partial, total_epochs - 1)
        if total_epochs - 1 not in full:
            full = np.append(full, total_epochs - 1)
        return partial, full

    partial = np.concatenate(
        [
            np.arange(initial_epochs_lim, step=initial_step_partial),
            np.arange(initial_epochs_lim, total_epochs, secondary_step_partial),
        ]
    )
    full = np.concatenate(
        [
            np.arange(initial_epochs_lim, step=initial_step_all),
            np.arange(initial_epochs_lim, total_epochs, secondary_step_all),
        ]
    )
    if total_epochs - 1 not in partial:
        partial = np.append(partial, total_epochs - 1)
    if total_epochs - 1 not in full:
        full = np.append(full, total_epochs - 1)
    return partial, full
