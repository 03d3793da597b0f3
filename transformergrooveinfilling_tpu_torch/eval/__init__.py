"""Evaluation: the metric families, style-subset evaluators, rhythm
features, media, as the JAX package's ``eval/``."""

from .metrics import (
    hits_accuracy_per_voice,
    velocity_mse_per_voice,
    offset_mse_per_voice,
    metrics_dict,
)
from .evaluator import (
    InfillingEvaluator,
    HVOSeqSubsetInfillingEvaluator,
    init_evaluator,
    log_eval,
)

__all__ = [
    "hits_accuracy_per_voice",
    "velocity_mse_per_voice",
    "offset_mse_per_voice",
    "metrics_dict",
    "InfillingEvaluator",
    "HVOSeqSubsetInfillingEvaluator",
    "init_evaluator",
    "log_eval",
]
