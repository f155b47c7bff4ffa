"""Core building blocks, NCHW (`aclgan_tpu/ops/blocks.py`).

Module and attribute names follow the reference networks.py, so a block's
`state_dict` keys are the reference's (`conv.weight`, `norm.gamma`, ...).
Params are float32; each conv/dense casts its input and params to the
compute dtype, as flax's `dtype=` does. AdaIN parameters are call arguments
threaded down from the style MLP.

Every `norm='in'` / `norm='adain'` ConvBlock goes through
`fused_instance_norm`: the CUDA kernel on the card, its plain version on the
CPU. The JAX package's TPU-only conv layouts (polyphase heads, packed 7x7,
collapsed-tap upsample) are not ported: the decoder upsamples, then convs.

A ConvBlock's `mesh`, when `ACLGAN` sets one that splits H
(`parallel/spatial.py`), makes it take its pad rows from the neighbouring
ranks (`parallel/halo.py`) and its IN / AdaIN / LN statistics over the
spatial group; with no mesh the block runs as on one device.

- ConvBlock    <- Conv2dBlock   (networks.py:312-371): pad -> conv -> norm -> act
- LinearBlock  <- LinearBlock   (networks.py:373-418): dense -> norm -> act
- ResBlock(s)  <- ResBlock(s)   (networks.py:269-278, 297-310)
- MLP          <- MLP           (networks.py:280-292)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aclgan_tpu_torch.ops.activations import ACTIVATIONS, apply_activation
from aclgan_tpu_torch.ops.initializers import make_initializer
from aclgan_tpu_torch.ops.kernels.instance_norm import fused_instance_norm
from aclgan_tpu_torch.ops.norms import BatchNorm, sample_layer_norm
from aclgan_tpu_torch.ops.pad import PAD_MODES, pad2d
from aclgan_tpu_torch.ops.spectral import SpectralConv2d, SpectralLinear
from aclgan_tpu_torch.parallel.halo import halo_pad
from aclgan_tpu_torch.parallel.spatial import sharded

AdainParams = Tuple[torch.Tensor, torch.Tensor]  # (scale, shift), each (N, C)


class Conv2d(nn.Module):
    """VALID conv with f32 (out, in, kh, kw) weight and bias, computed in `dtype`."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, stride: int = 1,
                 init_type: str = "kaiming", dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        shape = (out_dim, in_dim, kernel_size, kernel_size)
        self.weight = nn.Parameter(make_initializer(init_type)(shape, gen))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.stride = stride
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        return F.conv2d(x.to(d), self.weight.to(d), self.bias.to(d), self.stride)


class Linear(nn.Module):
    """Dense layer with f32 (out, in) weight and bias, computed in `dtype`."""

    def __init__(self, in_dim: int, out_dim: int, init_type: str = "kaiming",
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(make_initializer(init_type)((out_dim, in_dim), gen))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class LayerNorm(nn.Module):
    """The reference's custom LayerNorm: gamma ~ U(0, 1), beta = 0."""

    def __init__(self, num_features: int, gen: Optional[torch.Generator] = None,
                 eps: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.rand(num_features, generator=gen))
        self.beta = nn.Parameter(torch.zeros(num_features))
        self.eps = eps

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        return sample_layer_norm(x, self.gamma, self.beta, self.eps, mesh)


def _check_activation(activ: str) -> None:
    if activ not in ACTIVATIONS:
        raise ValueError(f"Unsupported activation: {activ!r}")


class ConvBlock(nn.Module):
    """pad -> conv(VALID) -> norm (none / in / ln / adain / bn / sn) ->
    activation. 'sn' wraps the conv (`SpectralConv2d`) and adds no norm
    layer, as the reference's Conv2dBlock does. `mesh` and `layer` (its name
    in the network, for the halo's errors) are set by `ACLGAN`."""

    mesh = None
    layer = ""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, stride: int,
                 padding: int = 0, norm: str = "none", activ: str = "relu",
                 pad_type: str = "zero", init_type: str = "kaiming",
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        if pad_type not in PAD_MODES:
            raise ValueError(f"Unsupported padding type: {pad_type!r}")
        if norm not in ("none", "in", "ln", "adain", "bn", "sn"):
            raise ValueError(f"Unsupported normalization: {norm!r}")
        _check_activation(activ)
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.pad_type = pad_type
        self.norm_type = norm
        self.activ = activ
        conv_cls = SpectralConv2d if norm == "sn" else Conv2d
        self.conv = conv_cls(in_dim, out_dim, kernel_size, stride, init_type, dtype, gen)
        if norm == "ln":
            self.norm = LayerNorm(out_dim, gen)
        elif norm == "bn":
            self.norm = BatchNorm(out_dim)
        if activ == "prelu":
            self.activation = nn.PReLU()  # weight (1,) = 0.25, as the reference

    def _prelu_alpha(self) -> Optional[torch.Tensor]:
        return self.activation.weight if self.activ == "prelu" else None

    def forward(self, x: torch.Tensor, adain: Optional[AdainParams] = None) -> torch.Tensor:
        if sharded(self.mesh):
            x = self.conv(halo_pad(x, self.kernel_size, self.stride, self.padding,
                                   self.pad_type, self.mesh, self.layer))
        else:
            x = self.conv(pad2d(x, self.padding, self.pad_type))
        if self.norm_type in ("in", "adain"):
            scale = shift = None
            if self.norm_type == "adain":
                if adain is None:
                    raise ValueError("AdaIN ConvBlock called without adain params")
                scale, shift = adain
            # the kernel reads NCHW-contiguous rows; a channels-last conv
            # output is copied, a contiguous one passes as it is
            return fused_instance_norm(x.contiguous(), scale, shift, activ=self.activ,
                                       prelu_alpha=self._prelu_alpha(), mesh=self.mesh)
        if self.norm_type == "ln":
            x = self.norm(x, self.mesh)
        elif self.norm_type == "bn":
            x = self.norm(x)
        return apply_activation(x, self.activ, self._prelu_alpha())


class LinearBlock(nn.Module):
    """dense -> norm (none / bn / in / ln / sn) -> activation
    (`aclgan_tpu/ops/blocks.py:205-251`). On (N, F): 'in' normalizes each
    sample over F (biased var, eps inside the sqrt, no affine); 'ln' is the
    custom LayerNorm's 2-D form (Bessel-corrected std, divide by std + eps,
    per-feature affine); 'sn' wraps the dense."""

    def __init__(self, in_dim: int, out_dim: int, norm: str = "none",
                 activ: str = "relu", init_type: str = "kaiming",
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        if norm not in ("none", "bn", "in", "ln", "sn"):
            raise ValueError(f"Unsupported normalization: {norm!r}")
        _check_activation(activ)
        self.norm_type = norm
        self.activ = activ
        fc_cls = SpectralLinear if norm == "sn" else Linear
        self.fc = fc_cls(in_dim, out_dim, init_type, dtype, gen)
        if norm == "ln":
            self.norm = LayerNorm(out_dim, gen)
        elif norm == "bn":
            self.norm = BatchNorm(out_dim)
        if activ == "prelu":
            self.activation = nn.PReLU()

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_type == "bn":
            return self.norm(x)
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        if self.norm_type == "in":
            var = (x32 - mean).square().mean(dim=-1, keepdim=True)
            return ((x32 - mean) / torch.sqrt(var + 1e-5)).to(x.dtype)
        std = x32.std(dim=-1, keepdim=True)  # Bessel-corrected
        out = (x32 - mean) / (std + self.norm.eps)
        return (out * self.norm.gamma.float() + self.norm.beta.float()).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc(x)
        if self.norm_type in ("bn", "in", "ln"):
            x = self._norm(x)
        alpha = self.activation.weight if self.activ == "prelu" else None
        return apply_activation(x, self.activ, alpha)


class ResBlock(nn.Module):
    """Two 3x3 s1 ConvBlocks (second activation 'none') + identity."""

    def __init__(self, dim: int, norm: str = "in", activ: str = "relu",
                 pad_type: str = "zero", init_type: str = "kaiming",
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        common = dict(kernel_size=3, stride=1, padding=1, norm=norm, pad_type=pad_type,
                      init_type=init_type, dtype=dtype, gen=gen)
        self.model = nn.Sequential(ConvBlock(dim, dim, activ=activ, **common),
                                   ConvBlock(dim, dim, activ="none", **common))

    def forward(self, x: torch.Tensor,
                adain: Optional[Tuple[AdainParams, AdainParams]] = None) -> torch.Tensor:
        a0, a1 = adain if adain is not None else (None, None)
        y = self.model[0](x, a0)
        return self.model[1](y, a1) + x


class ResBlocks(nn.Module):
    """Stack of ResBlocks."""

    def __init__(self, num_blocks: int, dim: int, norm: str = "in", activ: str = "relu",
                 pad_type: str = "zero", init_type: str = "kaiming",
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.model = nn.Sequential(*[
            ResBlock(dim, norm, activ, pad_type, init_type, dtype, gen)
            for _ in range(num_blocks)])

    def forward(self, x: torch.Tensor,
                adain: Optional[Sequence[Tuple[AdainParams, AdainParams]]] = None
                ) -> torch.Tensor:
        for i, block in enumerate(self.model):
            x = block(x, adain[i] if adain is not None else None)
        return x


class MLP(nn.Module):
    """Style MLP producing AdaIN parameters: in -> dim -> ... -> out, the
    last block without norm or activation."""

    def __init__(self, in_dim: int, out_dim: int, dim: int = 256, n_blk: int = 3,
                 norm: str = "none", activ: str = "relu", init_type: str = "kaiming",
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        common = dict(init_type=init_type, dtype=dtype, gen=gen)
        blocks = [LinearBlock(in_dim, dim, norm, activ, **common)]
        blocks += [LinearBlock(dim, dim, norm, activ, **common) for _ in range(n_blk - 2)]
        blocks.append(LinearBlock(dim, out_dim, "none", "none", **common))
        self.model = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.reshape(x.shape[0], -1))
