"""A msgpack codec for flax's snapshot layout, in numpy (the port's own:
``swnerf_torch`` needs neither the ``msgpack`` package nor flax).

It encodes and decodes maps, arrays, ints, floats, str, bin, bool and nil,
and the one ext type that ``flax.serialization.to_bytes`` writes for an
array leaf (0-d arrays included): ext code 1 whose payload is the packed
triple ``[shape, dtype name, raw C-order little-endian bytes]``
(flax/serialization.py ``_ndarray_to_bytes``). A decoded map is a dict, a
decoded msgpack array a list, a decoded ext-1 payload a numpy array.
Anything else raises ``ValueError`` naming what it met: another ext code,
or an array dtype outside float32 / int32 / int64 / bool / uint8.

The encoder follows the msgpack specification's shortest forms, as the
``msgpack`` package does, so a flax reader restores what it writes. Tuples
encode as msgpack arrays; numpy scalars as 0-d arrays.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

NDARRAY_EXT = 1  # flax's _MsgpackExtType.ndarray
DTYPES = {name: np.dtype(name).newbyteorder("<") for name in ("float32", "int32", "int64", "bool", "uint8")}


# ---------------------------------------------------------------- encoding


def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes((x,))
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if x >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                               (0xCF, ">Q", 1 << 64)):
            if x < top:
                return bytes((code,)) + struct.pack(fmt, x)
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)), (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if x >= low:
                return bytes((code,)) + struct.pack(fmt, x)
    raise ValueError(f"msgpack: integer {x} does not fit 64 bits")


def _sized(n: int, fix_base: int, fix_limit: int, forms) -> bytes:
    """A str / bin / array / map / ext header: the fix form below
    ``fix_limit``, else the first of ``forms`` ((type byte, length format))
    whose length field holds ``n``."""
    if n < fix_limit:
        return bytes((fix_base | n,))
    for code, fmt in forms:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} does not fit 32 bits")


_STR = ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))
_BIN = ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I"))
_ARRAY = ((0xDC, ">H"), (0xDD, ">I"))
_MAP = ((0xDE, ">H"), (0xDF, ">I"))
_EXT = ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I"))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
# the decoder's tables: type byte -> value, struct format, ext size, (kind, length format)
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
            0xD2: ">i", 0xD3: ">q"}
_FIXEXT_SIZE = {code: n for n, code in _FIXEXT.items()}
_LENGTHS = {code: (kind, fmt) for kind, forms in (("str", _STR), ("bin", _BIN), ("array", _ARRAY), ("map", _MAP),
                                                   ("ext", _EXT)) for code, fmt in forms}


def _ext(code: int, data: bytes) -> bytes:
    head = bytes((_FIXEXT[len(data)],)) if len(data) in _FIXEXT else _sized(len(data), 0, 0, _EXT)
    return head + bytes((code,)) + data


def _ndarray(x: np.ndarray) -> bytes:
    name = x.dtype.name
    if name not in DTYPES:
        raise ValueError(f"msgpack: array dtype {name!r} is not one of {sorted(DTYPES)}")
    raw = np.ascontiguousarray(x, dtype=DTYPES[name]).tobytes()
    return _ext(NDARRAY_EXT, packb([list(x.shape), name, raw]))


def _pack(x: Any, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif isinstance(x, (np.ndarray, np.generic)):
        out.append(_ndarray(np.asarray(x)))
    elif isinstance(x, bool):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        out.append(_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        data = x.encode("utf-8")
        out.append(_sized(len(data), 0xA0, 32, _STR) + data)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        data = bytes(x)
        out.append(_sized(len(data), 0, 0, _BIN) + data)
    elif isinstance(x, (list, tuple)):
        out.append(_sized(len(x), 0x90, 16, _ARRAY))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        out.append(_sized(len(x), 0x80, 16, _MAP))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise ValueError(f"msgpack: cannot encode a {type(x).__name__}")


def packb(x: Any) -> bytes:
    """``x`` as msgpack bytes."""
    out: list = []
    _pack(x, out)
    return b"".join(out)


# ---------------------------------------------------------------- decoding


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated data at byte {self.pos} (need {n} more)")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0xC0:  # fixmap, fixarray, fixstr
            return getattr(self, ("map", "array", "str", "str")[(b - 0x80) >> 4])(b & (0x0F if b < 0xA0 else 0x1F))
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _FIXEXT_SIZE:
            return self.ext(_FIXEXT_SIZE[b])
        if b in _LENGTHS:
            kind, fmt = _LENGTHS[b]
            return getattr(self, kind)(self.unpack(fmt))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at byte {self.pos - 1}")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code != NDARRAY_EXT:
            raise ValueError(f"msgpack: ext type {code} is not flax's ndarray (ext type {NDARRAY_EXT})")
        shape, name, raw = unpackb(data)
        if name not in DTYPES:
            raise ValueError(f"msgpack: array dtype {name!r} is not one of {sorted(DTYPES)}")
        return np.frombuffer(raw, dtype=DTYPES[name]).astype(name).reshape(shape)


def unpackb(data: bytes) -> Any:
    """The one msgpack value ``data`` holds (trailing bytes raise)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes after the value")
    return out
