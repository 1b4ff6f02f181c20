"""A msgpack decoder for the JAX package's `.ckpt` files, in the standard
library and numpy: what `flax.serialization.msgpack_restore` reads, with no
`msgpack` or `flax` package.

flax writes a state dict of nested maps with string keys; its leaves are
nil, booleans, integers, floats, strings, bytes, arrays and three extension
types: 1, an ndarray, itself a msgpack array (shape, dtype name, the C-order
bytes); 2, a native complex, a msgpack array (real, imag); 3, a numpy
scalar, encoded as an ndarray of shape (). An array leaf over 2^30 bytes is
split into a map `{"__msgpack_chunked_array__": True, "shape": {"0": ...},
"chunks": {"0": ...}}` of flat chunks, which `loads` joins again. A dtype
that numpy cannot read (bfloat16) raises ValueError.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"truncated msgpack data: want {n} bytes at {self.pos} of "
                             f"{len(self.data)}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
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
        kind = _FIXED.get(b)
        if kind is None:
            raise ValueError(f"msgpack type byte 0x{b:02x} at {self.pos - 1} is not supported")
        what, arg = kind
        if what == "const":
            return arg
        if what == "num":
            return self.unpack(arg)
        n = self.unpack(arg) if isinstance(arg, str) else arg
        if what == "bin":
            return bytes(self.take(n))
        if what == "str":
            return self.str(n)
        if what == "array":
            return self.array(n)
        if what == "map":
            return self.map(n)
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)))

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


# type byte -> (kind, a constant, a struct format of the value or its length,
# or a fixed length)
_FIXED = {
    0xC0: ("const", None), 0xC2: ("const", False), 0xC3: ("const", True),
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xCA: ("num", ">f"), 0xCB: ("num", ">d"),
    0xCC: ("num", ">B"), 0xCD: ("num", ">H"), 0xCE: ("num", ">I"), 0xCF: ("num", ">Q"),
    0xD0: ("num", ">b"), 0xD1: ("num", ">h"), 0xD2: ("num", ">i"), 0xD3: ("num", ">q"),
    0xD4: ("ext", 1), 0xD5: ("ext", 2), 0xD6: ("ext", 4), 0xD7: ("ext", 8), 0xD8: ("ext", 16),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(data).value()
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"the checkpoint holds an array of dtype {name!r}, which numpy cannot "
                         "read; save it as float32") from None
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")


def _ext(code: int, data: bytes) -> Any:
    if code == 1:
        return _ndarray(data)
    if code == 2:
        real, imag = _Reader(data).value()
        return complex(real, imag)
    if code == 3:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack extension type {code} is not one that flax writes")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape: Tuple[int, ...] = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def loads(data: bytes) -> Any:
    """The tree that `flax.serialization.msgpack_restore(data)` returns:
    nested dicts with numpy leaves (read-only views of `data`), chunked
    arrays joined."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes follow the msgpack object")
    return _unchunk(tree)
