"""Dropout on the training path, as the JAX package's ``ops/dropout.py``.

``fast_dropout`` draws one random byte per element and keeps the element when
the byte is below an 8-bit threshold; kept values are rescaled by the
*quantised* keep rate, so the estimator stays exactly unbiased. With
``fast=False`` a site keeps each element with the exact probability
``1 - rate`` (torch's own uniform draws). Both take an explicit
``torch.Generator`` on the tensor's device and never the global RNG.

:func:`fast_dropout_as_data` is the 8-bit rule with the rate as a 0-d tensor
(the JAX ``fast_dropout`` given a traced rate): under ``torch.func.vmap`` each
trial of a batched sweep (``train/vmap_sweep.py``) drops at its own rate in one
program. :func:`dropout` sends a tensor rate there.

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


def fast_dropout_as_data(x: torch.Tensor, generator: torch.Generator,
                         rate: torch.Tensor) -> torch.Tensor:
    """:func:`fast_dropout` with ``rate`` a 0-d tensor: the threshold
    ``round((1 - rate)·256)`` (half to even, as :func:`quantized_threshold`)
    and the scale ``threshold / 256`` ride the computation as data, with no
    branch on the rate's value. At rate 0 the threshold is 256 and every byte
    keeps its element; the bytes are drawn at every rate."""
    thresh = torch.round((1.0 - rate) * 256.0)
    bits = torch.randint(0, 256, x.shape, generator=generator, dtype=torch.uint8,
                         device=x.device)
    keep = bits.to(torch.int32) < thresh.to(torch.int32)
    return torch.where(keep, x / (thresh / 256.0).to(x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def bernoulli_dropout(x: torch.Tensor, generator: torch.Generator,
                      rate: float) -> torch.Tensor:
    """Dropout at the exact rate (the JAX ``fast_dropout=False`` path)."""
    _check_rate(rate)
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def dropout(x: torch.Tensor, generator: torch.Generator, rate,
            fast: bool = True) -> torch.Tensor:
    """One dropout site: :func:`fast_dropout` or :func:`bernoulli_dropout`;
    a tensor ``rate`` always takes :func:`fast_dropout_as_data` (as a traced
    rate takes the JAX package's 8-bit path whatever ``fast`` says)."""
    if isinstance(rate, torch.Tensor):
        return fast_dropout_as_data(x, generator, rate)
    return (fast_dropout if fast else bernoulli_dropout)(x, generator, rate)
