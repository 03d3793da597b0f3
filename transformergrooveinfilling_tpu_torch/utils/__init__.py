"""Shared utilities: experiment logging (wandb-compatible), serialization,
the flax msgpack codec and the configs' YAML reader, each on the standard
library and numpy."""

from . import logging
from .serialization import NpEncoder, load_pickle, save_to_pickle

__all__ = ["logging", "NpEncoder", "save_to_pickle", "load_pickle"]
