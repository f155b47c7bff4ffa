"""Image grids and their files (`aclgan_tpu/utils/image.py`).

One grid per call: rows = each output's first `display_image_num` images,
grayscale expanded to 3 channels, min-max normalized over the whole grid,
no padding (the reference's `__write_images`). Saved as JPEG at quality 95
through Pillow where Pillow imports; on a host without it (the GPU host) as
a PNG under the same stem, by a small zlib writer.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

import numpy as np


def _to_nhwc_f32(x) -> np.ndarray:
    arr = np.asarray(x, dtype=np.float32)
    if arr.ndim != 4:
        raise ValueError(f"expected NHWC batch, got {arr.shape}")
    if arr.shape[-1] == 1:  # grayscale (masks) -> 3 channels
        arr = np.repeat(arr, 3, axis=-1)
    return arr


def make_grid(images: np.ndarray, nrow: int, normalize: bool = True) -> np.ndarray:
    """(N, H, W, C) -> (rows*H, nrow*W, C) uint8 grid; min-max normalized over
    the whole tensor like vutils.make_grid(normalize=True), padding 0."""
    arr = _to_nhwc_f32(images)
    if normalize:
        # before the filler tiles of a ragged batch, as torchvision does
        lo, hi = float(arr.min()), float(arr.max())
        arr = (arr - lo) / max(hi - lo, 1e-5)
    n, h, w, c = arr.shape
    ncols = nrow
    nrows = (n + ncols - 1) // ncols
    if n < nrows * ncols:
        arr = np.concatenate([arr, np.zeros((nrows * ncols - n, h, w, c), np.float32)], 0)
    grid = arr.reshape(nrows, ncols, h, w, c).transpose(0, 2, 1, 3, 4).reshape(
        nrows * h, ncols * w, c)
    return np.clip(grid * 255.0, 0, 255).astype(np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG, every row unfiltered."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)))
        f.write(_png_chunk(b"IEND", b""))


def save_image(images: np.ndarray, path: str, nrow: int = 8, normalize: bool = True) -> str:
    """Write the grid of `images` to `path` (JPEG, quality 95), or, without
    Pillow, to a PNG beside it under the same stem. Returns the path written."""
    grid = make_grid(images, nrow, normalize)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        from PIL import Image
    except ImportError:
        path = os.path.splitext(path)[0] + ".png"
        write_png(path, grid)
        return path
    Image.fromarray(grid).save(path, quality=95)
    return path


def write_2images(image_outputs: Sequence[np.ndarray], display_image_num: int,
                  image_directory: str, postfix: str) -> str:
    """One grid file `gen_a2b_<postfix>` of every output's first
    `display_image_num` images, one output a row. Returns the path written."""
    rows = [_to_nhwc_f32(np.asarray(t)[:display_image_num]) for t in image_outputs]
    return save_image(np.concatenate(rows, axis=0),
                      os.path.join(image_directory, f"gen_a2b_{postfix}.jpg"),
                      nrow=display_image_num, normalize=True)
