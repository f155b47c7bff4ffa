"""ctypes binding of the native decode/augment core (`native/aclgan_data.cpp`).

Port of `aclgan_tpu/data/native.py`, with its own build: at first use it
compiles the repository's C++ source with `g++` and libjpeg into
`aclgan_tpu_torch/_build/`, under a name keyed by a hash of the source, the
flags and the host CPU (the build uses `-march=native`, so a library built on
one CPU may not run on another that shares the checkout). It never writes
under `native/`. The flags are those of `native/Makefile`, so both packages
run the same machine code and decode the same bytes. Without `g++`,
libjpeg's headers, the source or a writable build directory the core is
unavailable and `available()` is False: the loader then decodes through
Pillow, as the JAX package does. ctypes releases the GIL for the call, so
the loader's worker threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "aclgan_data.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-ljpeg",)

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _host_cpu() -> str:
    """The machine and its CPU's feature flags, which `-march=native` reads."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith(("flags", "Features"))), "")
    except OSError:
        flags = platform.processor()
    return f"{platform.machine()} {flags.strip()}"


def library_path() -> Path:
    """Where the core for this source, these flags and this CPU is built;
    raises OSError when the source cannot be read."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(_host_cpu().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"aclgan_data-{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile the core unless an up-to-date library exists; the library's
    path, or None when the source is missing, the build directory cannot be
    made, `g++` is missing or the compile fails (no libjpeg headers, say)."""
    try:
        out = library_path()
        if out.exists():
            return out
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            return None
        BUILD_DIR.mkdir(exist_ok=True)
    except OSError:
        return None
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                              capture_output=True, timeout=120)
        if proc.returncode:
            return None
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    except (OSError, subprocess.TimeoutExpired):
        return None
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded core, built at the first call; None when it cannot be built."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.aclgan_decode_jpeg_augment.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, u8p, ctypes.c_int64,
            i32p, i32p, u8p, ctypes.c_int64]
        lib.aclgan_decode_jpeg_augment.restype = ctypes.c_int
        lib.aclgan_normalize_batch.argtypes = [u8p, ctypes.c_int64,
                                               ctypes.POINTER(ctypes.c_float)]
        lib.aclgan_normalize_batch.restype = None
        _lib = lib
        return lib


def available() -> bool:
    return get_lib() is not None


_INIT_DECODE = 2048 * 2048 * 3  # 12 MiB starting scratch per worker thread
_MAX_DECODE = 8192 * 8192 * 3   # cap of the on-demand growth (rc == -2 retry)


class _Scratch:
    """Per-thread decode buffers, grown on demand: the C side checks the
    decoded size against the buffer right after the JPEG header and returns
    -2, and the caller grows the buffer and retries, so a thread holds a
    large buffer only once it has met a large image."""

    def __init__(self):
        self._tls = threading.local()

    def get(self, min_size: int = _INIT_DECODE) -> np.ndarray:
        buf = getattr(self._tls, "buf", None)
        if buf is None or buf.size < min_size:
            buf = np.empty(min_size, np.uint8)
            self._tls.buf = buf
        return buf


_scratch = _Scratch()


def decode_jpeg_augment(jpeg_bytes: bytes, new_size: Optional[int], crop_h: Optional[int],
                        crop_w: Optional[int], flip: bool, crop_top_frac: float,
                        crop_left_frac: float) -> Optional[np.ndarray]:
    """Decode, resize (shortest side to `new_size`), crop and flip one JPEG.
    Returns HWC uint8, or None on any failure (the caller falls back to
    Pillow): a corrupt file, an image smaller than the crop."""
    lib = get_lib()
    if lib is None:
        return None
    scratch = _scratch.get()
    data = np.frombuffer(jpeg_bytes, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    while True:
        # without a crop the output is at most the (resized) decode size
        out = np.empty(crop_h * crop_w * 3 if crop_h else scratch.size, np.uint8)
        rc = lib.aclgan_decode_jpeg_augment(
            data.ctypes.data_as(u8p), len(jpeg_bytes),
            int(new_size or 0), int(crop_h or 0), int(crop_w or 0), int(flip),
            float(crop_top_frac), float(crop_left_frac),
            out.ctypes.data_as(u8p), out.size, ctypes.byref(h), ctypes.byref(w),
            scratch.ctypes.data_as(u8p), scratch.size)
        if rc == -2 and scratch.size < _MAX_DECODE:  # larger than the scratch
            scratch = _scratch.get(min(scratch.size * 4, _MAX_DECODE))
            continue
        break
    if rc == 0 and crop_h:
        return out.reshape(crop_h, crop_w, 3)
    if rc > 0:  # the no-crop path packs the output's (h, w) into rc
        rh, rw = rc >> 16, rc & 0xFFFF
        return out[: rh * rw * 3].reshape(rh, rw, 3).copy()
    return None


def normalize_batch_native(batch_u8: np.ndarray) -> Optional[np.ndarray]:
    """uint8 -> float32 in [-1, 1] through the core; None when it is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(batch_u8).reshape(-1)
    out = np.empty(flat.size, np.float32)
    lib.aclgan_normalize_batch(flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                               flat.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out.reshape(batch_u8.shape)
