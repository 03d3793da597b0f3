"""Training: the reference's contract (``initialize_model`` + ``train_loop``),
the production loop (``run_training``), checkpoints, the loop (step, epoch,
held-out loss, watch histograms), the schedule and the configuration."""

from . import checkpoint
from .config import (
    HyperParams, derive_model_config, embedding_size_src_for, load_hyperparameters,
    load_paths,
)
from .driver import ModelBundle, initialize_model, run_training, train_loop
from .loop import (
    TrainState, create_train_state, make_epoch_fn, make_eval_loss_fn, make_optimizer,
    make_train_step, make_watch_fn, train_epoch,
)
from .schedule import eval_log_freq

__all__ = [
    "checkpoint",
    "HyperParams", "derive_model_config", "embedding_size_src_for", "load_hyperparameters",
    "load_paths",
    "ModelBundle", "initialize_model", "run_training", "train_loop",
    "TrainState", "create_train_state", "make_epoch_fn", "make_eval_loss_fn",
    "make_optimizer", "make_train_step", "make_watch_fn", "train_epoch",
    "eval_log_freq",
]
