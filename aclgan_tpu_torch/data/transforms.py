"""Image transforms matching the reference's torchvision pipeline
(`aclgan_tpu/data/transforms.py`).

Train: RandomHorizontalFlip -> Resize(shortest side) -> RandomCrop(h, w), on
a PIL image, to (H, W, 3) uint8; test loaders crop to new_size. The rng is
drawn in the JAX package's order (flip, then top, then left), so both
packages cut the same crops. PIL is imported only where an image is decoded,
flipped or resized, since the GPU host has no Pillow; already-square images
of the served size never reach it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class TransformSpec:
    new_size: Optional[int]    # resize shortest side to this (None = no resize)
    crop_h: Optional[int]      # random-crop target (None = no crop)
    crop_w: Optional[int]
    flip: bool                 # random horizontal flip (train only)


def resize_shortest(img, new_size: Optional[int]):
    """torchvision Resize(int) on a PIL image: shortest side -> new_size,
    bilinear, the long side truncated (int(), not round()). None skips."""
    if new_size is None:
        return img
    w, h = img.size
    if w <= h:
        ow = new_size
        oh = max(1, int(new_size * h / w))
    else:
        oh = new_size
        ow = max(1, int(new_size * w / h))
    if (ow, oh) == (w, h):
        return img
    from PIL import Image

    return img.resize((ow, oh), Image.BILINEAR)


def flip_left_right(img):
    from PIL import Image

    return img.transpose(Image.FLIP_LEFT_RIGHT)


def apply_transform(img, spec: TransformSpec, rng: np.random.Generator) -> np.ndarray:
    """PIL image -> (H, W, 3) uint8 after flip/resize/crop."""
    if spec.flip and rng.random() < 0.5:
        img = flip_left_right(img)
    if spec.new_size is not None:
        img = resize_shortest(img, spec.new_size)
    arr = np.asarray(img, dtype=np.uint8)
    if spec.crop_h is not None:
        h, w = arr.shape[:2]
        th, tw = spec.crop_h, spec.crop_w
        if h < th or w < tw:  # torchvision RandomCrop would raise; pad-to-fit instead
            pad_h, pad_w = max(0, th - h), max(0, tw - w)
            arr = np.pad(arr, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect")
            h, w = arr.shape[:2]
        top = int(rng.integers(0, h - th + 1))
        left = int(rng.integers(0, w - tw + 1))
        arr = arr[top:top + th, left:left + tw]
    return arr


def normalize_batch(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 NHWC -> float32 in [-1, 1] (ToTensor + Normalize(.5,.5))."""
    return batch_u8.astype(np.float32) * (2.0 / 255.0) - 1.0


def prep_image(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 HWC -> square (size, size): shortest-side resize + center crop
    (`aclgan_tpu/serving.py::prep_image`). Shared by `serving.Translator` and
    `export.ExportedTranslator`, so both feed the model the same pixels."""
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
