"""Spectral normalization, one power-iteration step per train-mode forward
(`aclgan_tpu/ops/spectral.py`, reference SpectralNorm, networks.py:542-600).

The weight is divided by its leading singular value sigma = u . (W v), with W
the weight viewed as (out, -1). In train mode each forward first runs one
power-iteration step on u and v without a gradient (the reference updates
`u.data` / `v.data`), so the gradient flows through W alone; in eval mode u
and v stay as they are.

The parameters sit in a child `module`, as the reference wraps the conv, so
the state-dict keys are the reference's: `module.weight_bar`, `module.bias`,
`module.weight_u`, `module.weight_v` (u and v are buffers here). torch views
a conv weight as (out, in*kh*kw) where flax's `SpectralConv` views its kernel
as (out, kh*kw*in): the two v vectors are permutations of each other
(`utils/jax_weights.py` converts).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from aclgan_tpu_torch.ops.initializers import make_initializer


def _l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)  # networks.py:538-539


class _SpectralWeights(nn.Module):
    """weight_bar (f32, torch layout), bias, and the power-iteration u / v."""

    def __init__(self, shape, init_type: str, gen: Optional[torch.Generator]):
        super().__init__()
        self.weight_bar = nn.Parameter(make_initializer(init_type)(shape, gen))
        self.bias = nn.Parameter(torch.zeros(shape[0]))
        rows, cols = shape[0], self.weight_bar[0].numel()
        self.register_buffer("weight_u", _l2normalize(torch.randn(rows, generator=gen)))
        self.register_buffer("weight_v", _l2normalize(torch.randn(cols, generator=gen)))

    def normalized(self) -> torch.Tensor:
        """weight_bar / sigma; in train mode u and v advance one step first."""
        w2d = self.weight_bar.reshape(self.weight_bar.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        if self.training:
            with torch.no_grad():
                v = _l2normalize(w2d.T @ u)
                u = _l2normalize(w2d @ v)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        sigma = u @ (w2d @ v)
        return self.weight_bar / sigma


class SpectralConv2d(nn.Module):
    """VALID conv with a spectrally normalized weight, computed in `dtype`."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, stride: int = 1,
                 init_type: str = "kaiming", dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.module = _SpectralWeights((out_dim, in_dim, kernel_size, kernel_size),
                                       init_type, gen)
        self.stride = stride
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        return F.conv2d(x.to(d), self.module.normalized().to(d),
                        self.module.bias.to(d), self.stride)


class SpectralLinear(nn.Module):
    """Dense layer with a spectrally normalized (out, in) weight, in `dtype`."""

    def __init__(self, in_dim: int, out_dim: int, init_type: str = "kaiming",
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.module = _SpectralWeights((out_dim, in_dim), init_type, gen)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        return F.linear(x.to(d), self.module.normalized().to(d), self.module.bias.to(d))
