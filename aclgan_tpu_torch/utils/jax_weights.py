"""Carry weights between the JAX package's flax trees and the port's state dicts.

`generator_state_dict` / `discriminator_state_dict` are the inverses of
`aclgan_tpu/utils/torch_import.py::map_generator_state_dict` /
`map_discriminator_state_dict` (plus `map_discriminator_spectral` and
`map_discriminator_stats`): a flax `AdaINGenerator` or `MsDiscriminator` tree
(nested dict of arrays) becomes a state dict with the reference's key names,
which the port's modules' `load_state_dict` takes. `generator_params` /
`discriminator_params` / `discriminator_collections` go the other way, so a
port model can be written as a JAX-layout snapshot set without JAX.

Both directions walk one table of (flax path, torch key, layout) leaves:
- conv: (kh, kw, in, out) <-> (out, in, kh, kw); dense: (in, out) <-> (out, in);
- scalar: () <-> (1,) (PReLU); vec: as is;
- sn_v: the power-iteration v, flattened (kh, kw, in) by flax and (in, kh, kw)
  by torch, for the discriminator's 4x4 convs.
Leaves marked optional (LayerNorm, PReLU) are carried where the source has them.
bn's `num_batches_tracked` has no flax counterpart; `nn.BatchNorm2d` fills it
with 0 when a state dict lacks it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

Leaf = Tuple[Tuple[str, ...], str, str, bool]  # flax path, torch key, layout, optional
_DIS_KERNEL = 4  # the discriminator's k x k convs, the only ones sn wraps


def _tensor(a: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))  # a copy: jax arrays are read-only


def _to_torch(a: Any, layout: str) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if layout == "conv":
        a = np.transpose(a, (3, 2, 0, 1))
    elif layout == "dense":
        a = a.T
    elif layout == "scalar":
        a = a.reshape(1)
    elif layout == "sn_v":
        k = _DIS_KERNEL
        a = a.reshape(k, k, -1).transpose(2, 0, 1).ravel()
    return _tensor(np.ascontiguousarray(a))


def _to_flax(t: torch.Tensor, layout: str) -> torch.Tensor:
    t = t.detach().cpu()
    if layout == "conv":
        t = t.permute(2, 3, 1, 0)
    elif layout == "dense":
        t = t.T
    elif layout == "scalar":
        t = t.reshape(())
    elif layout == "sn_v":
        k = _DIS_KERNEL
        t = t.reshape(-1, k, k).permute(1, 2, 0).reshape(-1)
    return t.contiguous().clone()


def _conv_block(flax: Tuple[str, ...], torch_prefix: str, conv: str = "Conv_0",
                torch_conv: str = "conv", weight: str = "weight") -> Iterator[Leaf]:
    """A flax ConvBlock: its conv, and an optional LayerNorm and PReLU."""
    yield flax + (conv, "kernel"), f"{torch_prefix}.{torch_conv}.{weight}", "conv", False
    yield flax + (conv, "bias"), f"{torch_prefix}.{torch_conv}.bias", "vec", False
    yield flax + ("ln_gamma",), f"{torch_prefix}.norm.gamma", "vec", True
    yield flax + ("ln_beta",), f"{torch_prefix}.norm.beta", "vec", True
    yield flax + ("prelu_alpha",), f"{torch_prefix}.activation.weight", "scalar", True


def _generator_leaves(gen_cfg) -> Iterator[Leaf]:
    def res_blocks(flax, torch_prefix):
        for i in range(gen_cfg.n_res):
            for j in range(2):
                yield from _conv_block(flax + ("ResBlocks_0", f"ResBlock_{i}",
                                               f"ConvBlock_{j}"),
                                       f"{torch_prefix}.model.{i}.model.{j}")

    for i in range(5):
        yield from _conv_block(("enc_style", f"ConvBlock_{i}"), f"enc_style.model.{i}")
    yield ("enc_style", "Conv_0", "kernel"), "enc_style.model.6.weight", "conv", False
    yield ("enc_style", "Conv_0", "bias"), "enc_style.model.6.bias", "vec", False
    n_down = gen_cfg.n_downsample
    for i in range(n_down + 1):
        yield from _conv_block(("enc_content", f"ConvBlock_{i}"), f"enc_content.model.{i}")
    yield from res_blocks(("enc_content",), f"enc_content.model.{n_down + 1}")
    yield from res_blocks(("dec",), "dec.model.0")
    for k in range(n_down):
        yield from _conv_block(("dec", f"ConvBlock_{k}"), f"dec.model.{2 + 2 * k}")
    yield from _conv_block(("dec", f"ConvBlock_{n_down}"), f"dec.model.{2 * n_down + 1}")
    for i in range(3):
        flax, pre = ("mlp", f"LinearBlock_{i}"), f"mlp.model.{i}"
        yield flax + ("Dense_0", "kernel"), f"{pre}.fc.weight", "dense", False
        yield flax + ("Dense_0", "bias"), f"{pre}.fc.bias", "vec", False
        yield flax + ("prelu_alpha",), f"{pre}.activation.weight", "scalar", True


def _discriminator_leaves(dis_cfg) -> Iterator[Leaf]:
    """The params of each scale: a plain first block, n_layer - 1 blocks of
    `dis_cfg.norm`, and the bare final 1x1."""
    sn, bn = dis_cfg.norm == "sn", dis_cfg.norm == "bn"
    for s in range(dis_cfg.num_scales):
        for layer in range(dis_cfg.n_layer):
            flax, pre = (f"scale_{s}", f"ConvBlock_{layer}"), f"cnns.{s}.{layer}"
            if sn and layer > 0:
                yield from _conv_block(flax, pre, "SpectralConv_0", "conv.module", "weight_bar")
            else:
                yield from _conv_block(flax, pre)
            if bn and layer > 0:
                yield flax + ("TorchBatchNorm_0", "scale"), f"{pre}.norm.weight", "vec", False
                yield flax + ("TorchBatchNorm_0", "bias"), f"{pre}.norm.bias", "vec", False
        pre = f"cnns.{s}.{dis_cfg.n_layer}"
        yield (f"scale_{s}", "Conv_0", "kernel"), f"{pre}.weight", "conv", False
        yield (f"scale_{s}", "Conv_0", "bias"), f"{pre}.bias", "vec", False


def _collection_leaves(dis_cfg) -> Iterator[Tuple[str, Leaf]]:
    """(collection, leaf) of the sn u / v or the bn running stats."""
    for s in range(dis_cfg.num_scales):
        for layer in range(1, dis_cfg.n_layer):
            flax, pre = (f"scale_{s}", f"ConvBlock_{layer}"), f"cnns.{s}.{layer}"
            if dis_cfg.norm == "sn":
                mod = flax + ("SpectralConv_0",)
                yield "spectral", (mod + ("u",), f"{pre}.conv.module.weight_u", "vec", False)
                yield "spectral", (mod + ("v",), f"{pre}.conv.module.weight_v", "sn_v", False)
            elif dis_cfg.norm == "bn":
                mod = flax + ("TorchBatchNorm_0",)
                yield "batch_stats", (mod + ("mean",), f"{pre}.norm.running_mean", "vec",
                                      False)
                yield "batch_stats", (mod + ("var",), f"{pre}.norm.running_var", "vec", False)


def _get(tree: Dict[str, Any], path: Tuple[str, ...]) -> Any:
    for p in path:
        tree = tree[p]
    return tree


def _has(tree: Dict[str, Any], path: Tuple[str, ...]) -> bool:
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            return False
        tree = tree[p]
    return True


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _to_state_dict(tree: Dict[str, Any], leaves, sd: Dict[str, torch.Tensor]) -> None:
    for path, key, layout, optional in leaves:
        if optional and not _has(tree, path):
            continue
        sd[key] = _to_torch(_get(tree, path), layout)


def _to_tree(sd: Dict[str, torch.Tensor], leaves) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, key, layout, optional in leaves:
        if optional and key not in sd:
            continue
        _set(tree, path, _to_flax(sd[key], layout))
    return tree


def generator_state_dict(params: Dict[str, Any], gen_cfg) -> Dict[str, torch.Tensor]:
    """flax AdaINGenerator params -> reference-named torch state dict."""
    sd: Dict[str, torch.Tensor] = {}
    _to_state_dict(params, _generator_leaves(gen_cfg), sd)
    return sd


def discriminator_state_dict(params: Dict[str, Any], dis_cfg, spectral=None,
                             stats=None) -> Dict[str, torch.Tensor]:
    """flax MsDiscriminator params (any norm) -> the reference-named state dict
    of the port's `MsDiscriminator`; with `spectral` (sn) or `stats` (bn), its
    u / v or running stats too. Without them the dict holds the parameters
    only, the shape of an optimizer moment."""
    sd: Dict[str, torch.Tensor] = {}
    _to_state_dict(params, _discriminator_leaves(dis_cfg), sd)
    trees = {"spectral": spectral, "batch_stats": stats}
    for collection, leaf in _collection_leaves(dis_cfg):
        if trees[collection] is not None:
            _to_state_dict(trees[collection], [leaf], sd)
    return sd


def generator_params(sd: Dict[str, torch.Tensor], gen_cfg) -> Dict[str, Any]:
    """A port generator's state dict (or a moment of it) -> the flax param
    tree, as CPU tensors in the dtype given."""
    return _to_tree(sd, _generator_leaves(gen_cfg))


def discriminator_params(sd: Dict[str, torch.Tensor], dis_cfg) -> Dict[str, Any]:
    """A port discriminator's state dict (or a moment of it) -> flax params."""
    return _to_tree(sd, _discriminator_leaves(dis_cfg))


def discriminator_collections(sd: Dict[str, torch.Tensor], dis_cfg
                              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A port discriminator's state dict -> its flax (spectral, batch_stats)
    collections; each {} where the norm has none, as the JAX `init_state`
    keeps them."""
    out: Dict[str, Dict[str, Any]] = {"spectral": {}, "batch_stats": {}}
    for collection, (path, key, layout, _) in _collection_leaves(dis_cfg):
        _set(out[collection], path, _to_flax(sd[key], layout))
    return out["spectral"], out["batch_stats"]
