"""Serving API: a generator checkpoint behind a uint8-in / uint8-out Translator.

Port of `aclgan_tpu/serving.py::prep_image` and `Translator`. Requests are
uint8 HWC images; batches are padded to a fixed size; styles are explicit,
drawn from a seeded `torch.Generator`, or encoded from a style image.

    tr = Translator("configs/male2female.yaml", "gen_00350000.pt")
    outs = tr(list_of_uint8_images)            # list of HxWx3 uint8

`BucketedTranslator` and `AsyncTranslator` are not ported yet.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from aclgan_tpu_torch.config import Config, load_config
from aclgan_tpu_torch.data.transforms import normalize_batch, resize_shortest
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils.checkpoint import load_generators


def prep_image(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 HWC -> square (size, size): shortest-side resize + center crop."""
    arr = np.asarray(img)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected HxWx3 RGB image, got shape {arr.shape}")
    arr = arr.astype(np.uint8, copy=False)
    if arr.shape[:2] != (size, size):
        from PIL import Image

        arr = np.asarray(resize_shortest(Image.fromarray(arr), size), np.uint8)
    h, w = arr.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return arr[top:top + size, left:left + size]


class Translator:
    def __init__(
        self,
        config: Union[str, Config],
        checkpoint: str,
        a2b: bool = True,
        batch_size: int = 32,   # requests are padded to this batch
        size: Optional[int] = None,
        seed: int = 0,
        devices: int = 1,
        device: Union[str, torch.device] = "cuda",
    ):
        if devices != 1:
            raise NotImplementedError("multi-device serving is not ported yet")
        cfg = load_config(config) if isinstance(config, str) else config
        self.cfg = cfg
        self.a2b = a2b
        self.batch_size = batch_size
        size_a, size_b = cfg.data.resolved_sizes()
        self.size = size or (size_a if a2b else size_b) or 256
        stride = 2 ** cfg.gen.n_downsample
        if self.size % stride:
            raise ValueError(f"size {self.size} must be a multiple of the "
                             f"generator stride {stride} (2**n_downsample)")
        self.model = ACLGAN(cfg, device=device)
        load_generators(checkpoint, self.model)
        self.device = self.model.device
        self._rng = torch.Generator().manual_seed(seed)
        self._rng_lock = threading.Lock()

    def encode_style(self, style_image: np.ndarray) -> np.ndarray:
        """Style code (1, style_dim) from a reference image."""
        x = torch.from_numpy(normalize_batch(prep_image(style_image, self.size)[None]))
        x = x.to(self.device).permute(0, 3, 1, 2).contiguous().to(self.model.dtype)
        gen = self.model.gen_AB if self.a2b else self.model.gen_BA
        with torch.inference_mode():
            return gen.encode_style(x).float().cpu().numpy()

    def random_style(self, n: int = 1) -> np.ndarray:
        """Draw n style codes from the serving RNG stream (thread-safe)."""
        with self._rng_lock:
            return torch.randn((n, self.cfg.gen.style_dim), generator=self._rng).numpy()

    def __call__(self, images: Sequence[np.ndarray], styles: Optional[np.ndarray] = None,
                 return_masks: bool = False):
        """Translate a list of uint8 HWC images, one style per image (random
        if None). Batches are padded to `batch_size`."""
        n = len(images)
        if n == 0:
            return ([], None) if return_masks else []
        prepped = np.stack([prep_image(im, self.size) for im in images])
        styles = self._resolve_styles(styles, n)
        outs, masks = self._run_batches(prepped, styles)
        if return_masks:
            return outs, (masks if masks else None)
        return outs

    def _resolve_styles(self, styles, n: int) -> np.ndarray:
        if styles is None:
            styles = self.random_style(n)
        styles = np.asarray(styles, np.float32)
        if styles.ndim == 1:
            styles = np.broadcast_to(styles[None], (n, styles.shape[0]))
        return styles

    def _translate(self, x: torch.Tensor, z: torch.Tensor):
        img, mask = self.model.translate(x, z, a2b=self.a2b)
        img_u8 = torch.clamp((img.float() + 1.0) * 127.5, 0, 255).to(torch.uint8)
        return img_u8, mask

    def _run_batches(self, prepped: np.ndarray, styles: np.ndarray):
        outs: List[np.ndarray] = []
        masks: List[np.ndarray] = []
        bs = self.batch_size
        for start in range(0, prepped.shape[0], bs):
            chunk = prepped[start:start + bs]
            zc = styles[start:start + bs]
            keep = chunk.shape[0]
            if keep < bs:  # fixed batch shape: pad the tail batch
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bs - keep, 0)])
                zc = np.concatenate([zc, np.repeat(zc[-1:], bs - keep, 0)])
            # uint8 goes to the device; translate normalizes it there
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            z = torch.from_numpy(np.ascontiguousarray(zc)).to(self.device)
            with torch.inference_mode():
                img_u8, mask = self._translate(x, z)
            outs.extend(list(img_u8[:keep].cpu().numpy()))
            if mask is not None:
                masks.extend(list(mask[:keep].float().cpu().numpy()))
        return outs, masks
