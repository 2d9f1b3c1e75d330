"""Reader for flax's msgpack serialization, in pure Python on `struct`.

The counterpart of `flax.serialization.msgpack_restore`: the encoder assets
and the `.nww` payloads of the JAX package are flax msgpack blobs, and this
package reads them without `msgpack`, `flax` or `ml_dtypes`.

What flax writes (flax/serialization.py):
* ordinary msgpack maps, arrays, str, bin, ints, floats, nil and bool;
* ext code 1, an ndarray, packed as the msgpack array
  ``(shape, dtype_name, C-order bytes)``;
* ext code 2, a Python complex, packed as ``(real, imag)``;
* ext code 3, a numpy scalar, packed like an ndarray of shape ``()``;
* arrays above 1 GiB split into ``{"__msgpack_chunked_array__": True,
  "shape": {...}, "chunks": {...}}`` maps.

bfloat16 leaves decode to float32: the 16 stored bits are the top half of
the float32 with the same value, so the conversion is exact.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        (value,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return value

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.read_array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.read_str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.read_str(n)
            if kind == "array":
                return self.read_array(n)
            if kind == "map":
                return self.read_map(n)
            return self.read_ext(self.unpack(">b"), n)
        if b in _FIXEXT:
            return self.read_ext(self.unpack(">b"), _FIXEXT[b])
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def read_str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def read_array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read_ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).read()
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext code {code}")


_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_NUMBERS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, raw = _Reader(data).read()
    if dtype_name == "bfloat16":
        bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(raw, np.dtype(dtype_name)).copy()
    return arr.reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(encoded: bytes):
    """Flax msgpack bytes -> nested dicts of numpy arrays and scalars."""
    reader = _Reader(encoded)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack object")
    return _unchunk(tree)


def read_msgpack_file(path: str):
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
