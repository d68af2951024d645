"""Read the bytes of ``flax.serialization.to_bytes`` without flax or msgpack.

The JAX package saves a network's ``NetState`` (params, batch stats,
optimizer state, step) as ``to_bytes(state)``: msgpack of nested maps with
string keys whose array leaves are msgpack extensions of type 1, each the
msgpack of ``(shape, dtype name, C-order bytes)`` (type 3 is the same for a
numpy scalar). Arrays above flax's chunk size are maps marked
``__msgpack_chunked_array__`` that hold the shape and the flat chunks.
``from_bytes`` decodes that subset: maps, arrays, str, bin, ints, floats,
nil, bool and those extensions, to dicts, lists, numpy arrays and Python
scalars. Anything else, and a truncated input, raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

_NDARRAY, _NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", self.bin), 0xC5: (">H", self.bin),
                 0xC6: (">I", self.bin), 0xD9: (">B", self.str),
                 0xDA: (">H", self.str), 0xDB: (">I", self.str),
                 0xDC: (">H", self.array), 0xDD: (">I", self.array),
                 0xDE: (">H", self.map), 0xDF: (">I", self.map),
                 0xC7: (">B", self.ext), 0xC8: (">H", self.ext),
                 0xC9: (">I", self.ext)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the subset "
                         "flax writes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_NDARRAY, _NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not an "
                             "array")
        shape, name, buf = _decode(payload)
        try:
            dtype = np.dtype(name)
        except TypeError as e:
            raise ValueError(f"array dtype {name!r} is unknown") from e
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
        return arr[()] if code == _NPSCALAR else arr


def _decode(data: bytes):
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack value")
    return out


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def from_bytes(data: bytes):
    """The tree of ``flax.serialization.to_bytes`` output: dicts with str
    keys, numpy array leaves. Raises ValueError on anything else."""
    try:
        return _unchunk(_decode(data))
    except (struct.error, UnicodeDecodeError, KeyError, TypeError) as e:
        raise ValueError(f"malformed msgpack data: {e}") from e
