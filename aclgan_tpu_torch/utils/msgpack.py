"""A reader for flax msgpack files (`flax.serialization.msgpack_serialize`).

The JAX package writes its generator snapshots (`gen_/ema_%08d.msgpack`) and
its fine-tuned InceptionV3 weights this way. The port reads them without the
`msgpack` package or flax: this module decodes the msgpack format itself.

    tree = read_msgpack("gen_00020000.msgpack")   # {'AB': {...}, 'BA': {...}}

What it decodes: maps, arrays, str, bin, ints, floats, nil, bool, and flax's
extension types (`flax/serialization.py`, `_MsgpackExtType`):
- 1, an ndarray: itself a packed `(shape, dtype name, C-order bytes)` tuple,
  returned as a `torch.Tensor` (a `bfloat16` array as `torch.bfloat16`);
- 3, a numpy scalar: packed as an ndarray, returned as a 0-dim tensor.
(Type 2, a Python complex, never occurs in a checkpoint and raises.)
Arrays come back as CPU tensors that own their memory. Flax splits an array
over 2**30 bytes into chunks; such a file raises one clear error.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

_DTYPES = {
    "bool": torch.bool, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32,
    "float64": torch.float64, "complex64": torch.complex64,
    "complex128": torch.complex128,
}
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """Decodes one msgpack object after another from a byte string."""

    def __init__(self, data: bytes, ext_hook: Callable[[int, bytes], Any]):
        self.data = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def bin_(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str_(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        return self.ext_hook(code, bytes(self.take(n)))

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map_(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map_(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return self.str_(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt) if isinstance(fmt, str) else fmt
            return getattr(self, kind)(n)
        raise ValueError(f"msgpack type byte 0x{b:02x} is not defined")


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# type byte -> (reader method, length format or fixed length)
_SIZED: Dict[int, Tuple[str, Any]] = {
    0xC4: ("bin_", ">B"), 0xC5: ("bin_", ">H"), 0xC6: ("bin_", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD4: ("ext", 1), 0xD5: ("ext", 2), 0xD6: ("ext", 4), 0xD7: ("ext", 8),
    0xD8: ("ext", 16),
    0xD9: ("str_", ">B"), 0xDA: ("str_", ">H"), 0xDB: ("str_", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map_", ">H"), 0xDF: ("map_", ">I"),
}


def _plain(data: bytes) -> Any:
    return _Reader(data, lambda code, _: _unknown_ext(code)).read()


def _unknown_ext(code: int):
    raise ValueError(f"msgpack extension type {code} is not supported")


def _ndarray(data: bytes) -> torch.Tensor:
    """flax `_ndarray_to_bytes` -> a CPU tensor that owns its memory."""
    shape, name, buf = _plain(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name not in _DTYPES:
        raise ValueError(f"array dtype {name!r} is not supported")
    if not buf:  # an empty array
        return torch.empty(tuple(shape), dtype=_DTYPES[name])
    raw = torch.from_numpy(np.frombuffer(buf, np.uint8).copy())
    return raw.view(_DTYPES[name]).reshape(tuple(shape))


def _ext(code: int, data: bytes) -> Any:
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        return _ndarray(data)  # a scalar is a 0-dim array
    return _unknown_ext(code)


def _check_unchunked(tree: Any, path: str = "") -> None:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise ValueError(f"{path or '/'}: an array flax split into chunks (over 2**30 "
                             "bytes); chunked arrays are not supported")
        for k, v in tree.items():
            _check_unchunked(v, f"{path}/{k}")


def loads(data: bytes) -> Any:
    """Decode flax msgpack bytes to nested dicts/lists of tensors and scalars."""
    reader = _Reader(data, _ext)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack object")
    _check_unchunked(tree)
    return tree


def read_msgpack(path: str) -> Any:
    with open(path, "rb") as f:
        return loads(f.read())
