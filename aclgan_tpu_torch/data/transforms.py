"""Image transforms of the serving path (`aclgan_tpu/data/transforms.py`).

PIL is imported only where an image must be resized, since the GPU host has
no Pillow; already-square images of the served size never reach it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


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


def normalize_batch(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 NHWC -> float32 in [-1, 1] (ToTensor + Normalize(.5,.5))."""
    return batch_u8.astype(np.float32) * (2.0 / 255.0) - 1.0
