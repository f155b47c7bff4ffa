"""Multi-scale PatchGAN discriminator, NCHW (`aclgan_tpu/models/discriminator.py`,
reference MsImageDis, networks.py:21-57).

`num_scales` independent conv stacks; the input is average-pooled (3x3/s2/p1,
padding left out of the divisor) between scales. Returns the list of
per-scale logit maps; the loss heads are in `aclgan_tpu_torch.losses`.
Submodules follow the reference, so `state_dict()` keys are the names
`aclgan_tpu.utils.torch_import.map_discriminator_state_dict` maps
(`cnns.{s}.{layer}.conv.weight`, final 1x1 `cnns.{s}.{n_layer}.weight`; under
sn `cnns.{s}.{layer}.conv.module.{weight_bar,bias,weight_u,weight_v}`, under bn
`cnns.{s}.{layer}.norm.{weight,bias,running_mean,running_var,...}`). The first
block of each scale has no norm and the final 1x1 is a bare conv, whatever
`norm` says (networks.py:40,46). Under a mesh that splits H, the pool
between scales takes its halo rows from the neighbouring ranks.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from aclgan_tpu_torch.config import DisConfig
from aclgan_tpu_torch.ops.blocks import Conv2d, ConvBlock
from aclgan_tpu_torch.ops.pool import avg_pool_3x3_s2


def _scale_net(cfg: DisConfig, input_dim: int, init_type: str, dtype: torch.dtype,
               gen: Optional[torch.Generator]) -> nn.Sequential:
    """One scale: 4x4 s2 conv (no norm) -> (n_layer-1) dim-doubling 4x4 s2 convs
    -> 1x1 conv to one logit map (_make_net, networks.py:38-47)."""
    common = dict(activ=cfg.activ, pad_type=cfg.pad_type, init_type=init_type,
                  dtype=dtype, gen=gen)
    dim = cfg.dim
    layers: List[nn.Module] = [ConvBlock(input_dim, dim, 4, 2, 1, norm="none", **common)]
    for _ in range(cfg.n_layer - 1):
        layers.append(ConvBlock(dim, dim * 2, 4, 2, 1, norm=cfg.norm, **common))
        dim *= 2
    layers.append(Conv2d(dim, 1, 1, 1, init_type, dtype, gen))
    return nn.Sequential(*layers)


class MsDiscriminator(nn.Module):
    """num_scales PatchGAN stacks over a downsampling pyramid (networks.py:49-57).

    Gaussian N(0, 0.02) init, as the trainer builds every discriminator.
    `norm` may be none, in, ln, bn or sn. In train mode (the default) bn's
    running stats and sn's u / v advance on every forward, as the reference's
    do inside both the D and the G update. `mesh` and `layer` are set by
    `ACLGAN`, as on a ConvBlock."""

    mesh = None
    layer = ""

    def __init__(self, cfg: DisConfig, input_dim: int, init_type: str = "gaussian",
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cnns = nn.ModuleList(
            [_scale_net(cfg, input_dim, init_type, dtype, gen)
             for _ in range(cfg.num_scales)])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outputs = []
        for i, net in enumerate(self.cnns):
            outputs.append(net(x))
            if i + 1 < len(self.cnns):
                x = avg_pool_3x3_s2(x, self.mesh, f"{self.layer}.pool{i}")
        return outputs
