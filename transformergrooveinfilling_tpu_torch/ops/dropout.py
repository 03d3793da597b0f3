"""Dropout on the training path, as the JAX package's ``ops/dropout.py``.

``fast_dropout`` draws one random byte per element and keeps the element when
the byte is below an 8-bit threshold; kept values are rescaled by the
*quantised* keep rate, so the estimator stays exactly unbiased. With
``fast=False`` a site keeps each element with the exact probability
``1 - rate`` (torch's own uniform draws). Both take an explicit
``torch.Generator`` on the tensor's device and never the global RNG.

There is no kernel here: the JAX package has none either, and the fused
encoder layer (``ops/fused_layer.py``) draws its own masks.
"""

from __future__ import annotations

import torch


def quantized_threshold(rate: float) -> int:
    """8-bit keep threshold: a byte below it keeps the element."""
    return round((1.0 - rate) * 256)


def quantized_keep_rate(rate: float) -> float:
    """The effective keep probability after 8-bit threshold quantisation."""
    return quantized_threshold(rate) / 256.0


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")


def fast_dropout(x: torch.Tensor, generator: torch.Generator,
                 rate: float) -> torch.Tensor:
    """Dropout with an 8-bit mask (one random byte per element from
    ``generator``). Identity when the quantised keep rate is 1; unbiased:
    E[out] == x for every ``rate``."""
    _check_rate(rate)
    thresh = quantized_threshold(rate)
    if thresh >= 256:
        return x
    bits = torch.randint(0, 256, x.shape, generator=generator,
                         dtype=torch.uint8, device=x.device)
    keep = bits < thresh
    return torch.where(keep, x / (thresh / 256.0), torch.zeros((), dtype=x.dtype,
                                                               device=x.device))


def bernoulli_dropout(x: torch.Tensor, generator: torch.Generator,
                      rate: float) -> torch.Tensor:
    """Dropout at the exact rate (the JAX ``fast_dropout=False`` path)."""
    _check_rate(rate)
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def dropout(x: torch.Tensor, generator: torch.Generator, rate: float,
            fast: bool = True) -> torch.Tensor:
    """One dropout site: :func:`fast_dropout` or :func:`bernoulli_dropout`."""
    return (fast_dropout if fast else bernoulli_dropout)(x, generator, rate)
