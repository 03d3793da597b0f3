"""Training: the reference's contract (``initialize_model`` + ``train_loop``),
the loop (step, epoch, held-out loss) and the configuration."""

from .config import (
    HyperParams, derive_model_config, embedding_size_src_for, load_hyperparameters,
)
from .driver import ModelBundle, initialize_model, train_loop
from .loop import (
    TrainState, create_train_state, make_epoch_fn, make_eval_loss_fn, make_optimizer,
    make_train_step, train_epoch,
)

__all__ = [
    "HyperParams", "derive_model_config", "embedding_size_src_for", "load_hyperparameters",
    "ModelBundle", "initialize_model", "train_loop",
    "TrainState", "create_train_state", "make_epoch_fn", "make_eval_loss_fn",
    "make_optimizer", "make_train_step", "train_epoch",
]
