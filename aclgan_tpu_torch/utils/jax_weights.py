"""Carry JAX generator and discriminator weights into the port.

The inverses of `aclgan_tpu/utils/torch_import.py::map_generator_state_dict`
and `map_discriminator_state_dict`: a flax `AdaINGenerator` or
`MsDiscriminator` param tree (nested dict of numpy arrays) becomes a state
dict with the reference's key names, which the port's modules'
`load_state_dict` takes.

Weight layout: conv (kh,kw,in,out) -> (out,in,kh,kw); dense (in,out) -> (out,in).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(a: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))  # a copy: jax arrays are read-only


def _conv_block(sd: Dict[str, torch.Tensor], prefix: str, blk: Dict[str, Any]) -> None:
    """One flax ConvBlock (conv, optional LayerNorm and PReLU) into `sd`."""
    sd[f"{prefix}.conv.weight"] = _conv_weight(blk["Conv_0"]["kernel"])
    sd[f"{prefix}.conv.bias"] = _tensor(blk["Conv_0"]["bias"])
    if "ln_gamma" in blk:
        sd[f"{prefix}.norm.gamma"] = _tensor(blk["ln_gamma"])
        sd[f"{prefix}.norm.beta"] = _tensor(blk["ln_beta"])
    if "prelu_alpha" in blk:
        sd[f"{prefix}.activation.weight"] = _tensor(blk["prelu_alpha"]).reshape(1)


def _conv_weight(kernel: Any) -> torch.Tensor:
    return _tensor(np.transpose(kernel, (3, 2, 0, 1)))  # (kh,kw,in,out) -> (out,in,kh,kw)


def generator_state_dict(params: Dict[str, Any], gen_cfg) -> Dict[str, torch.Tensor]:
    """flax AdaINGenerator params -> reference-named torch state dict."""
    sd: Dict[str, torch.Tensor] = {}

    def res_blocks(torch_prefix: str, tree: Dict[str, Any]) -> None:
        for i in range(gen_cfg.n_res):
            for j in range(2):
                _conv_block(sd, f"{torch_prefix}.model.{i}.model.{j}",
                           tree[f"ResBlock_{i}"][f"ConvBlock_{j}"])

    se = params["enc_style"]
    for i in range(5):
        _conv_block(sd, f"enc_style.model.{i}", se[f"ConvBlock_{i}"])
    sd["enc_style.model.6.weight"] = _conv_weight(se["Conv_0"]["kernel"])
    sd["enc_style.model.6.bias"] = _tensor(se["Conv_0"]["bias"])

    ce = params["enc_content"]
    n_down = gen_cfg.n_downsample
    for i in range(n_down + 1):
        _conv_block(sd, f"enc_content.model.{i}", ce[f"ConvBlock_{i}"])
    res_blocks(f"enc_content.model.{n_down + 1}", ce["ResBlocks_0"])

    de = params["dec"]
    res_blocks("dec.model.0", de["ResBlocks_0"])
    for k in range(n_down):
        _conv_block(sd, f"dec.model.{2 + 2 * k}", de[f"ConvBlock_{k}"])
    _conv_block(sd, f"dec.model.{2 * n_down + 1}", de[f"ConvBlock_{n_down}"])

    for i in range(3):
        blk = params["mlp"][f"LinearBlock_{i}"]
        sd[f"mlp.model.{i}.fc.weight"] = _tensor(np.asarray(blk["Dense_0"]["kernel"]).T)
        sd[f"mlp.model.{i}.fc.bias"] = _tensor(blk["Dense_0"]["bias"])
        if "prelu_alpha" in blk:
            sd[f"mlp.model.{i}.activation.weight"] = _tensor(blk["prelu_alpha"]).reshape(1)
    return sd


def discriminator_state_dict(params: Dict[str, Any], dis_cfg) -> Dict[str, torch.Tensor]:
    """flax MsDiscriminator params (norm none, in or ln) -> reference-named
    torch state dict of the port's `MsDiscriminator`."""
    if dis_cfg.norm not in ("none", "in", "ln"):
        raise NotImplementedError(f"discriminator norm {dis_cfg.norm!r} is not ported")
    sd: Dict[str, torch.Tensor] = {}
    for s in range(dis_cfg.num_scales):
        scale = params[f"scale_{s}"]
        for layer in range(dis_cfg.n_layer):
            _conv_block(sd, f"cnns.{s}.{layer}", scale[f"ConvBlock_{layer}"])
        pre = f"cnns.{s}.{dis_cfg.n_layer}"
        sd[f"{pre}.weight"] = _conv_weight(scale["Conv_0"]["kernel"])
        sd[f"{pre}.bias"] = _tensor(scale["Conv_0"]["bias"])
    return sd
