"""Normalization ops with reference-exact semantics, NCHW (`aclgan_tpu/ops/norms.py`).

- instance_norm — nn.InstanceNorm2d(affine=False, eps=1e-5): per-(sample,
  channel) stats over H,W, biased variance.
- adaptive_instance_norm — AdaptiveInstanceNorm2d: instance norm, then a
  per-(sample, channel) `scale * xhat + shift` with scale/shift passed in.
- sample_layer_norm — the reference's custom LayerNorm: per-sample stats over
  all of (C,H,W), Bessel-corrected std, divide by `(std + eps)`, per-channel
  affine.
- BatchNorm — torch nn.BatchNorm2d/1d with default args, as the JAX
  `TorchBatchNorm`: momentum 0.1 in the torch convention, the biased batch
  variance to normalize and the Bessel-corrected one in `running_var`, the
  running stats in eval mode.

Stats are float32 whatever the input dtype; the result is cast back to the
input dtype. These are the plain versions: on a CUDA tensor the model's
IN/AdaIN layers run the fused kernel in `ops/kernels/instance_norm.py`.

Under a mesh that splits H (`parallel/spatial.py`), `sample_layer_norm`
all-reduces each sample's sums over the spatial group, and bn's training
statistics cover every rank of the grid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aclgan_tpu_torch.parallel.mesh import all_reduce_sum
from aclgan_tpu_torch.parallel.spatial import sharded


def _normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=(2, 3), keepdim=True)
    return xc * torch.rsqrt(var + eps)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(N, C) normalization over spatial dims. x: (N, C, H, W)."""
    return _normalize(x, eps).to(x.dtype)


def adaptive_instance_norm(x: torch.Tensor, scale: torch.Tensor,
                           shift: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm + per-(sample, channel) affine; scale/shift: (N, C)."""
    s = scale.float()[:, :, None, None]
    b = shift.float()[:, :, None, None]
    return (_normalize(x, eps) * s + b).to(x.dtype)


def sample_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      eps: float = 1e-5, mesh=None) -> torch.Tensor:
    """The reference's custom LayerNorm. x: (N, C, H, W); gamma/beta: (C,).
    Under an H-sharding mesh, each sample's (sum, sum of squares) over this
    rank's (C, H, W) is all-reduced over the spatial group, and the std is
    Bessel-corrected over the global count."""
    x32 = x.float()
    if sharded(mesh):
        n = x32[0].numel() * mesh.n_spatial
        sums = all_reduce_sum(torch.stack([x32.sum((1, 2, 3)), (x32 * x32).sum((1, 2, 3))]),
                              mesh.spatial_group)
        mean = (sums[0] / n).view(-1, 1, 1, 1)
        var = torch.clamp((sums[1] - n * mean.flatten() ** 2) / (n - 1), min=0.0)
        std = torch.sqrt(var).view(-1, 1, 1, 1)
    else:
        mean = x32.mean(dim=(1, 2, 3), keepdim=True)
        std = x32.std(dim=(1, 2, 3), keepdim=True)  # Bessel-corrected, as torch.std
    out = (x32 - mean) / (std + eps)
    out = out * gamma.float()[None, :, None, None] + beta.float()[None, :, None, None]
    return out.to(x.dtype)


class BatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d's parameters, buffers and state-dict keys (`weight`,
    `bias`, `running_mean`, `running_var`, `num_batches_tracked`), so that a
    reference `.pt` loads as it is, computed in float32 on (N, C, H, W) or
    (N, C) input of any float dtype and cast back. Stats are over every
    non-channel axis.

    With `mesh` set (a `parallel.mesh.DataMesh` or a
    `parallel.spatial.SpatialMesh`), training-mode statistics are those of
    the global batch (every rank of the grid), as GSPMD gives the JAX step:
    one f32 all-reduce of each channel's (count, sum, sum of squares), whose
    backward all-reduces the two gradient sums."""

    mesh = None

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"BatchNorm takes (N, C) or (N, C, H, W), got {tuple(x.shape)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if self.training:
            self.num_batches_tracked.add_(1)
            if self.mesh is not None:
                return self._global_batch_norm(x)
        return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                            self.bias, self.training, self.momentum, self.eps).to(x.dtype)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        axes = [0] + list(range(2, x.dim()))
        count = torch.full((x.shape[1],), x32.numel() / x.shape[1], device=x.device)
        stats = all_reduce_sum(torch.stack([count, x32.sum(axes), (x32 * x32).sum(axes)]),
                               self.mesh.world_group)
        n = stats[0]
        mean = stats[1] / n
        var = torch.clamp(stats[2] / n - mean * mean, min=0.0)  # biased
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * n / (n - 1))  # Bessel
        shape = [1, -1] + [1] * (x.dim() - 2)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (x32 - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)

