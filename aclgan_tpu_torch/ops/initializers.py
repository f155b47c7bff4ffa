"""Weight initializers (`aclgan_tpu/ops/initializers.py`, reference utils.py:274-294).

Weights are torch layout: conv (out, in, kh, kw), dense (out, in); fan_in is
the product of every dim but the first, the same number as the flax layout's
product of every dim but the last, and fan_out is out times the receptive
field. Every draw comes from the caller's `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch

Initializer = Callable[[Sequence[int], torch.Generator], torch.Tensor]
INIT_TYPES = ("gaussian", "kaiming", "xavier", "orthogonal", "default")


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    receptive = math.prod(shape[2:])
    return math.prod(shape[1:]), shape[0] * receptive


def _normal(std_of: Callable[[int, int], float]) -> Initializer:
    def init(shape, gen):
        return std_of(*_fans(shape)) * torch.randn(tuple(shape), generator=gen)
    return init


def _orthogonal(shape: Sequence[int], gen: torch.Generator) -> torch.Tensor:
    """`orthogonal_(gain=sqrt(2))`: the (out, fan_in) rows orthonormal (the
    columns when out > fan_in), times the gain."""
    rows, cols = shape[0], math.prod(shape[1:])
    flat = torch.randn(rows, cols, generator=gen)
    if rows < cols:
        flat = flat.T
    q, r = torch.linalg.qr(flat)
    q = q * torch.sign(torch.diagonal(r))  # the unique Q with a positive R diagonal
    if rows < cols:
        q = q.T
    return math.sqrt(2.0) * q.reshape(tuple(shape)).contiguous()


def _default(shape: Sequence[int], gen: torch.Generator) -> torch.Tensor:
    """torch's default Conv/Linear weight init, kaiming_uniform(a=sqrt(5)):
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(_fans(shape)[0])
    return (2.0 * torch.rand(tuple(shape), generator=gen) - 1.0) * bound


def make_initializer(init_type: str) -> Initializer:
    """gaussian N(0, 0.02) (discriminators), kaiming (the shipped generators),
    xavier, orthogonal or default."""
    if init_type == "gaussian":
        return _normal(lambda fan_in, fan_out: 0.02)
    if init_type == "kaiming":
        # kaiming_normal_(a=0, mode='fan_in'): std = sqrt(2 / fan_in)
        return _normal(lambda fan_in, fan_out: math.sqrt(2.0 / fan_in))
    if init_type == "xavier":
        # xavier_normal_(gain=sqrt(2)): std = gain * sqrt(2 / (fan_in + fan_out))
        return _normal(lambda fan_in, fan_out: math.sqrt(2.0) * math.sqrt(
            2.0 / (fan_in + fan_out)))
    if init_type == "orthogonal":
        return _orthogonal
    if init_type == "default":
        return _default
    raise ValueError(f"Unsupported initialization: {init_type!r} (one of {INIT_TYPES})")
