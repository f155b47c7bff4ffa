"""ACL-GAN model holder: the two generators and the translation path.

Port of the inference part of `aclgan_tpu/trainer.py` (`to_model_range`,
`ACLGAN`, `_split_img_mask`, `translate`). Optimizers, discriminators and the
train steps wait for the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from aclgan_tpu_torch import losses
from aclgan_tpu_torch.config import Config
from aclgan_tpu_torch.models.generator import AdaINGenerator

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device to run on; a CUDA device must exist (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def compute_dtype(cfg: Config) -> torch.dtype:
    name = cfg.tpu.compute_dtype
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype {name!r} not supported ({sorted(_DTYPES)})")
    return _DTYPES[name]


def to_model_range(x: torch.Tensor) -> torch.Tensor:
    """uint8 images -> float32 in [-1, 1]; float inputs pass through."""
    if x.is_floating_point():
        return x
    return x.float() * (2.0 / 255.0) - 1.0


class ACLGAN:
    """Holds `gen_AB` / `gen_BA` (both built on input_dim_a channels) with
    float32 params, computing in `cfg.tpu.compute_dtype`."""

    def __init__(self, cfg: Config, device: Union[str, torch.device] = "cuda",
                 seed: Optional[int] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg)
        self.use_focus = cfg.use_focus
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)

        def make():
            return AdaINGenerator(cfg.gen, cfg.data.input_dim_a, cfg.init, self.dtype,
                                  gen).to(self.device)

        self.gen_AB = make()
        self.gen_BA = make()

    def _split_img_mask(self, dec_out: torch.Tensor):
        """(N, C, H, W) decoder output -> (rgb, mask or None)."""
        if self.use_focus:
            return dec_out[:, :3], dec_out[:, 3:4]
        return dec_out, None

    @torch.no_grad()
    def translate(self, x: torch.Tensor, style: torch.Tensor, a2b: bool = True,
                  eval_blend: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Translate NHWC images (uint8 or [-1,1] float) with style codes (N, style_dim).

        Returns NHWC (image, mask or None) in the compute dtype. The JAX
        version runs the full encoder and drops the style; the content
        encoder alone gives the same content code.
        """
        gen = self.gen_AB if a2b else self.gen_BA
        x = to_model_range(x.to(self.device)).permute(0, 3, 1, 2).contiguous()
        x = x.to(self.dtype)
        content = gen.encode_content(x)
        dec = gen.decode(content, style.to(self.device, self.dtype))
        img, mask = self._split_img_mask(dec)
        if mask is not None:
            blend = losses.focus_translation_eval if eval_blend else losses.focus_translation
            img = blend(img, x.to(img.dtype), mask)
            mask = mask.permute(0, 2, 3, 1)
        return img.permute(0, 2, 3, 1), mask
