"""Pooling / resize ops, NCHW (`aclgan_tpu/ops/pool.py`).

With a mesh that splits H (`parallel/spatial.py`), `avg_pool_3x3_s2` takes
one halo row a side from the neighbouring ranks and `global_avg_pool`
all-reduces its sums over the spatial group; the upsample stays local.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aclgan_tpu_torch.parallel.halo import check_halo, halo_rows
from aclgan_tpu_torch.parallel.mesh import all_reduce_sum
from aclgan_tpu_torch.parallel.spatial import sharded


def avg_pool_3x3_s2(x: torch.Tensor, mesh=None, layer: str = "") -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False) between the
    discriminator's scales (networks.py:33), in float32, cast back. Under an
    H-sharding mesh the pad rows, and so the smaller divisor, are only at the
    image's global top and bottom."""
    if not sharded(mesh):
        return F.avg_pool2d(x.float(), 3, 2, 1, count_include_pad=False).to(x.dtype)
    h, r = x.shape[2], mesh.spatial_rank
    check_halo(h, mesh.n_spatial, 3, 2, 1, "zero", layer)
    # a window reads one row above the shard and none below it
    xe = halo_rows(x.float(), 1, 0, mesh, "zero")
    total = F.avg_pool2d(xe, 3, 2, (0, 1), divisor_override=1)
    real = torch.ones(h + 1, device=x.device)  # rows that are not padding
    if r == 0:  # the image's top pad row; `real[0] = 0.0` would copy from the host
        real[:1].fill_(0.0)
    real = real.view(1, 1, h + 1, 1).expand(1, 1, h + 1, x.shape[3])
    count = F.avg_pool2d(real, 3, 2, (0, 1), divisor_override=1)
    return (total / count).to(x.dtype)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2) in the decoder (networks.py:256)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def global_avg_pool(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean over H, W in float32, keeping dims: (N,C,H,W) -> (N,C,1,1). Under
    an H-sharding mesh, the all-reduced sum over the global H*W."""
    if not sharded(mesh):
        return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
    total = all_reduce_sum(x.float().sum(dim=(2, 3), keepdim=True), mesh.spatial_group)
    return (total / (x.shape[2] * mesh.n_spatial * x.shape[3])).to(x.dtype)


class UpsampleNearest2x(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_nearest_2x(x)


class GlobalAvgPool(nn.Module):
    """nn.AdaptiveAvgPool2d(1) of the style encoder (networks.py:222)."""

    mesh = None  # set by ACLGAN

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return global_avg_pool(x, self.mesh)
