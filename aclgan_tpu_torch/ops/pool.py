"""Pooling / resize ops, NCHW (`aclgan_tpu/ops/pool.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False) between the
    discriminator's scales (networks.py:33), in float32, cast back."""
    return F.avg_pool2d(x.float(), 3, 2, 1, count_include_pad=False).to(x.dtype)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2) in the decoder (networks.py:256)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H, W in float32, keeping dims: (N,C,H,W) -> (N,C,1,1)."""
    return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)


class UpsampleNearest2x(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_nearest_2x(x)


class GlobalAvgPool(nn.Module):
    """nn.AdaptiveAvgPool2d(1) of the style encoder (networks.py:222)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return global_avg_pool(x)
