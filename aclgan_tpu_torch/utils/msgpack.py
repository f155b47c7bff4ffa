"""A reader and a writer of flax msgpack files (`flax.serialization.msgpack_serialize`).

The JAX package writes its snapshot sets (`gen_/dis_/ema_%08d.msgpack`,
`optimizer.msgpack`) and its fine-tuned InceptionV3 weights this way. The port
reads them without the `msgpack` package or flax: this module decodes the
msgpack format itself.

    tree = read_msgpack("gen_00020000.msgpack")   # {'AB': {...}, 'BA': {...}}

`dumps` writes the same format (ndarrays, torch tensors in bfloat16 included,
as ext type 1; numpy scalars as ext type 3), so that a JAX-layout snapshot set
can be made where JAX is absent; no CLI exposes it.

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


_NAMES = {dtype: name for name, dtype in _DTYPES.items()}


def _pack_uint(n: int, fix_max: int, fix_base: int, codes: Tuple[int, ...]) -> bytes:
    """A length or count: fixed form up to fix_max, else the 8/16/32-bit codes
    (None where the format has no 8-bit form)."""
    if n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} items are more than msgpack can hold")


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    for code, fmt, lo, hi in ((0xCC, ">B", 0, 2**8 - 1), (0xCD, ">H", 0, 2**16 - 1),
                              (0xCE, ">I", 0, 2**32 - 1), (0xCF, ">Q", 0, 2**64 - 1),
                              (0xD0, ">b", -2**7, -1), (0xD1, ">h", -2**15, -1),
                              (0xD2, ">i", -2**31, -1), (0xD3, ">q", -2**63, -1)):
        if lo <= n <= hi:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} does not fit a msgpack integer")


def _pack_ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    elif n <= 0xFF:
        head = b"\xc7" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        head = b"\xc8" + struct.pack(">H", n)
    else:
        head = b"\xc9" + struct.pack(">I", n)
    return head + struct.pack(">b", code) + data


def _array_bytes(t: torch.Tensor) -> bytes:
    """flax `_ndarray_to_bytes`: (shape, dtype name, C-order bytes), packed."""
    t = t.detach().cpu().contiguous()
    if t.dtype not in _NAMES:
        raise ValueError(f"array dtype {t.dtype} is not supported")
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return _pack([list(t.shape), _NAMES[t.dtype], raw])


def _pack(obj: Any) -> bytes:
    if obj is None:
        return b"\xc0"
    if isinstance(obj, bool):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        data = obj.encode("utf-8")
        return _pack_uint(len(data), 0x1F, 0xA0, (0xD9, 0xDA, 0xDB)) + data
    if isinstance(obj, bytes):
        return _pack_uint(len(obj), -1, 0, (0xC4, 0xC5, 0xC6)) + obj
    if isinstance(obj, dict):  # keys sorted, as flax's state dicts come out
        return _pack_uint(len(obj), 0x0F, 0x80, (None, 0xDE, 0xDF)) + b"".join(
            _pack(k) + _pack(obj[k]) for k in sorted(obj))
    if isinstance(obj, (list, tuple)):
        return _pack_uint(len(obj), 0x0F, 0x90, (None, 0xDC, 0xDD)) + b"".join(
            _pack(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return _pack_ext(_EXT_NDARRAY, _array_bytes(obj))
    if isinstance(obj, np.ndarray):
        return _pack_ext(_EXT_NDARRAY, _array_bytes(torch.from_numpy(obj.copy())))
    if isinstance(obj, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _array_bytes(torch.from_numpy(np.asarray(obj))))
    raise TypeError(f"cannot write {type(obj).__name__} as flax msgpack")


def dumps(tree: Any) -> bytes:
    """Nested dicts / lists of tensors, arrays and scalars -> flax msgpack bytes
    (arrays are not chunked: each must stay under 2**30 bytes)."""
    return _pack(tree)
