"""VGG16 features and the perceptual loss (`aclgan_tpu/models/vgg.py`), NCHW.

The reference's hand-rolled Vgg16 up to relu5_3 (networks.py:423-472: no
pool after conv4_3), `vgg_preprocess` (utils.py:250-260: RGB -> BGR,
[-1, 1] -> [0, 255], Caffe means subtracted) and `compute_vgg_loss`
(trainer.py:172-177: the MSE of the instance-normed relu5_3 features). The
instance norm is `ops/kernels/instance_norm.fused_instance_norm`: K1 on a
CUDA tensor, and K2 in the backward when the features need a gradient.

As in the JAX package, the trainer loads the network when `vgg_w > 0` and its
step adds no VGG term (the reference's `gen_update` never calls
`compute_vgg_loss`). Weights load from a file holding a torch state dict
with `conv1_1.weight` ... `conv5_3.bias` keys; with no file, a deterministic
init from a seed (the reference's downloader is broken as shipped; there are
no pretrained weights here).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from aclgan_tpu_torch.ops.kernels.instance_norm import fused_instance_norm

_LAYERS = [
    ("conv1_1", 64), ("conv1_2", 64), "pool",
    ("conv2_1", 128), ("conv2_2", 128), "pool",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "pool",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
]  # networks.py:444-471: no pool after conv4_3; relu5_3 returned
_CAFFE_MEAN_BGR = (103.939, 116.779, 123.680)


class Vgg16(nn.Module):
    """3x3 convs (padding 1) + relu up to relu5_3, with three 2x2 max pools:
    (N, 3, H, W) Caffe-preprocessed BGR -> (N, 512, H/8, W/8). Weights are
    float32; each conv computes in `dtype`."""

    def __init__(self, dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        in_dim = 3
        for layer in _LAYERS:
            if layer == "pool":
                continue
            name, feat = layer
            conv = nn.Conv2d(in_dim, feat, 3, padding=1)
            with torch.no_grad():  # lecun normal, zero bias (flax's defaults)
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                                  / math.sqrt(in_dim * 9))
                conv.bias.zero_()
            setattr(self, name, conv)
            in_dim = feat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        x = x.to(d)
        for layer in _LAYERS:
            if layer == "pool":
                x = F.max_pool2d(x, 2, 2)
                continue
            conv = getattr(self, layer[0])
            x = F.relu(F.conv2d(x, conv.weight.to(d), conv.bias.to(d), padding=1))
        return x


def vgg_preprocess(batch: torch.Tensor) -> torch.Tensor:
    """[-1, 1] RGB NCHW -> Caffe BGR in [0, 255] minus the ImageNet means."""
    bgr = batch.flip(1)
    bgr = (bgr + 1.0) * 255.0 * 0.5
    mean = torch.tensor(_CAFFE_MEAN_BGR, dtype=bgr.dtype, device=bgr.device)
    return bgr - mean.view(1, 3, 1, 1)


def compute_vgg_loss(vgg: Vgg16, img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE between the instance-normed relu5_3 features of two NCHW [-1, 1]
    batches, in float32."""
    img_fea = vgg(vgg_preprocess(img)).contiguous()
    target_fea = vgg(vgg_preprocess(target)).contiguous()
    diff = fused_instance_norm(img_fea) - fused_instance_norm(target_fea)
    return torch.mean(torch.square(diff.float()))


def load_vgg16(weights_path: Optional[str] = None, dtype: torch.dtype = torch.float32,
               device: Union[str, torch.device] = "cuda", seed: int = 0) -> Vgg16:
    """A frozen `Vgg16` in eval mode on `device`: the torch state dict at
    `weights_path`, else the seeded init."""
    vgg = Vgg16(dtype, seed)
    if weights_path:
        vgg.load_state_dict(torch.load(weights_path, map_location="cpu", weights_only=True))
    vgg.requires_grad_(False)
    return vgg.to(device).eval()
