"""Weight initializers (`aclgan_tpu/ops/initializers.py`, reference utils.py:274-294).

Weights are torch layout: conv (out, in, kh, kw), dense (out, in); fan_in is
the product of every dim but the first, the same number as the flax layout's
product of every dim but the last. Every draw comes from the caller's
`torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Initializer = Callable[[Sequence[int], torch.Generator], torch.Tensor]


def _fan_in(shape: Sequence[int]) -> int:
    return math.prod(shape[1:])


def make_initializer(init_type: str) -> Initializer:
    """gaussian N(0, 0.02) (discriminators) or kaiming (generators)."""
    if init_type == "gaussian":
        return lambda shape, gen: 0.02 * torch.randn(tuple(shape), generator=gen)
    if init_type == "kaiming":
        # kaiming_normal_(a=0, mode='fan_in'): std = sqrt(2 / fan_in)
        return lambda shape, gen: (math.sqrt(2.0 / _fan_in(shape))
                                   * torch.randn(tuple(shape), generator=gen))
    raise ValueError(f"Unsupported initialization: {init_type!r} "
                     "(the port has gaussian and kaiming)")
