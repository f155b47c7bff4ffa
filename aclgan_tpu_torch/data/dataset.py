"""Dataset listing + image decode (`aclgan_tpu/data/dataset.py`).

Folder mode recursively collects files by extension whitelist, sorted; file-list
mode reads relative paths from a text file. Decoding converts to RGB through
Pillow, imported when a file is decoded; JPEGs may go through the native core
instead (`data/native.py`). Where Pillow is missing, `require_pillow` refuses
a file dataset that needs it before any worker starts.
"""

from __future__ import annotations

import os
from typing import List

IMG_EXTENSIONS = [
    ".jpg", ".JPG", ".jpeg", ".JPEG",
    ".png", ".PNG", ".ppm", ".PPM", ".bmp", ".BMP",
]


def is_image_file(filename: str) -> bool:
    return any(filename.endswith(ext) for ext in IMG_EXTENSIONS)


def list_images_folder(root: str) -> List[str]:
    """Recursive, sorted walk collecting image paths."""
    images: List[str] = []
    if not os.path.isdir(root):
        raise RuntimeError(f"{root} is not a directory")
    for dirpath, _, fnames in sorted(os.walk(root)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(dirpath, fname))
    if not images:
        raise RuntimeError(f"Found 0 images in: {root}")
    return images


def list_images_filelist(root: str, list_path: str) -> List[str]:
    """Paths from a text file, one per line, joined onto root."""
    with open(list_path, "r") as f:
        return [os.path.join(root, line.strip()) for line in f if line.strip()]


def require_pillow() -> None:
    """Raise one clear error when image files must be decoded without Pillow."""
    try:
        import PIL  # noqa: F401
    except ImportError as exc:
        raise RuntimeError(
            "this config reads image files, which needs Pillow, and Pillow is not "
            "installed; install it, or set `synthetic: true` to train on the "
            "built-in synthetic dataset") from exc


def load_image(path: str):
    """PIL open + RGB convert."""
    from PIL import Image

    return Image.open(path).convert("RGB")
