"""AdaIN generator: style encoder + content encoder + AdaIN decoder + MLP, NCHW.

Port of `aclgan_tpu/models/generator.py` (reference AdaINGen, networks.py:
112-264). Submodule layout follows the reference, so `state_dict()` keys are
the reference names `aclgan_tpu.utils.torch_import` maps
(`enc_content.model.3.model.0.model.1.conv.weight`, ...). The MLP's AdaIN
vector is sliced and passed down the decoder call, in the reference's
traversal order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from aclgan_tpu_torch.config import GenConfig
from aclgan_tpu_torch.ops.blocks import MLP, Conv2d, ConvBlock, ResBlocks
from aclgan_tpu_torch.ops.pool import GlobalAvgPool, UpsampleNearest2x


def content_dim(cfg: GenConfig) -> int:
    """Channels at the content bottleneck."""
    return cfg.dim * (2 ** cfg.n_downsample)


def num_adain_params(cfg: GenConfig) -> int:
    """2 params (scale, shift) per channel, 2 AdaIN convs per resblock."""
    return 2 * content_dim(cfg) * 2 * cfg.n_res


class StyleEncoder(nn.Module):
    """7x7 s1 -> 2 downsamples (dim doubling) -> extra downsamples -> GAP -> 1x1."""

    def __init__(self, input_dim: int, dim: int, style_dim: int, n_downsample: int = 4,
                 activ: str = "relu", pad_type: str = "reflect",
                 init_type: str = "kaiming", dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        common = dict(norm="none", activ=activ, pad_type=pad_type, init_type=init_type,
                      dtype=dtype, gen=gen)
        layers: List[nn.Module] = [ConvBlock(input_dim, dim, 7, 1, 3, **common)]
        for _ in range(2):
            layers.append(ConvBlock(dim, dim * 2, 4, 2, 1, **common))
            dim *= 2
        for _ in range(n_downsample - 2):
            layers.append(ConvBlock(dim, dim, 4, 2, 1, **common))
        layers += [GlobalAvgPool(), Conv2d(dim, style_dim, 1, 1, init_type, dtype, gen)]
        self.model = nn.Sequential(*layers)
        self.style_dim = style_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x).reshape(x.shape[0], self.style_dim)


class ContentEncoder(nn.Module):
    """7x7 s1 -> n_downsample x (4x4 s2, dim doubling) -> ResBlocks('in')."""

    def __init__(self, input_dim: int, dim: int, n_downsample: int = 2, n_res: int = 4,
                 activ: str = "relu", pad_type: str = "reflect",
                 init_type: str = "kaiming", dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        common = dict(norm="in", activ=activ, pad_type=pad_type, init_type=init_type,
                      dtype=dtype, gen=gen)
        layers: List[nn.Module] = [ConvBlock(input_dim, dim, 7, 1, 3, **common)]
        for _ in range(n_downsample):
            layers.append(ConvBlock(dim, dim * 2, 4, 2, 1, **common))
            dim *= 2
        layers.append(ResBlocks(n_res, dim, "in", activ, pad_type, init_type, dtype, gen))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def _slice_adain(adain_vec: torch.Tensor, dim: int, n_res: int):
    """Slice the MLP output into per-resblock ((scale, shift), (scale, shift)).

    Reference assign_adain_params order: per AdaIN layer the first `dim`
    entries are the shift ("mean" -> bias), the next `dim` the scale.
    """
    out: List[Tuple] = []
    offset = 0
    for _ in range(n_res):
        convs = []
        for _ in range(2):
            shift = adain_vec[:, offset:offset + dim]
            scale = adain_vec[:, offset + dim:offset + 2 * dim]
            convs.append((scale, shift))
            offset += 2 * dim
        out.append(tuple(convs))
    return out


class Decoder(nn.Module):
    """ResBlocks('adain') -> n_upsample x (nearest 2x + 5x5 'ln' conv) -> 7x7 tanh."""

    def __init__(self, dim: int, output_dim: int, n_upsample: int = 2, n_res: int = 4,
                 activ: str = "relu", pad_type: str = "reflect",
                 init_type: str = "kaiming", dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = dim
        self.n_res = n_res
        common = dict(pad_type=pad_type, init_type=init_type, dtype=dtype, gen=gen)
        layers: List[nn.Module] = [ResBlocks(n_res, dim, "adain", activ, **common)]
        for _ in range(n_upsample):
            layers += [UpsampleNearest2x(),
                       ConvBlock(dim, dim // 2, 5, 1, 2, norm="ln", activ=activ, **common)]
            dim //= 2
        layers.append(ConvBlock(dim, output_dim, 7, 1, 3, norm="none", activ="tanh",
                                **common))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, adain_vec: torch.Tensor) -> torch.Tensor:
        x = self.model[0](x, _slice_adain(adain_vec, self.dim, self.n_res))
        for layer in self.model[1:]:
            x = layer(x)
        return x


class AdaINGenerator(nn.Module):
    """The full generator with encode/decode entry points (networks.py:112-152)."""

    def __init__(self, cfg: GenConfig, input_dim: int = 3, init_type: str = "kaiming",
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        c = cfg
        common = dict(activ=c.activ, pad_type=c.pad_type, init_type=init_type,
                      dtype=dtype, gen=gen)
        self.enc_style = StyleEncoder(input_dim, c.dim, c.style_dim, 4, **common)
        self.enc_content = ContentEncoder(input_dim, c.dim, c.n_downsample, c.n_res,
                                          **common)
        self.dec = Decoder(content_dim(c), c.output_dim, c.n_downsample, c.n_res,
                           **common)
        self.mlp = MLP(c.style_dim, num_adain_params(c), c.mlp_dim, 3, "none", c.activ,
                       init_type, dtype, gen)

    def encode(self, images: torch.Tensor):
        """images (N,C,H,W) -> (content (N,Cc,h,w), style (N, style_dim))."""
        return self.enc_content(images), self.enc_style(images)

    def encode_content(self, images: torch.Tensor) -> torch.Tensor:
        return self.enc_content(images)

    def encode_style(self, images: torch.Tensor) -> torch.Tensor:
        return self.enc_style(images)

    def decode(self, content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        """MLP(style) -> AdaIN params -> decoder."""
        return self.dec(content, self.mlp(style))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """Self-reconstruction."""
        content, style = self.encode(images)
        return self.decode(content, style)
