"""A frozen reader of the `.nww` artifact and of flax's msgpack format.

The reference reads the committed weight files itself, so nothing that the
program under test derives from them reaches it. A `.nww` file is the magic
`NWW2`, a little-endian u32 header length, a JSON header and a flax msgpack
payload: `{"variables": <classifier tree>, "encoder_variables": <tree>}`.
flax writes an ndarray as msgpack ext code 1 holding `(shape, dtype name,
C-order bytes)`; bfloat16 leaves hold the top 16 bits of a float32. Only
float32 and bfloat16 artifacts are read here.
"""

from __future__ import annotations

import json
import struct

import numpy as np

MAGIC = b"NWW2"

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
            return {self.read(): self.read() for _ in range(b & 0x0F)}
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode("utf-8")
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return bytes(self.take(n)).decode("utf-8")
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return {self.read(): self.read() for _ in range(n)}
            return self.ext(self.unpack(">b"), n)
        if b in _FIXEXT:
            return self.ext(self.unpack(">b"), _FIXEXT[b])
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code not in (1, 3):
            raise ValueError(f"unsupported msgpack ext code {code}")
        shape, dtype_name, raw = _Reader(data).read()
        if dtype_name == "bfloat16":
            bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(raw, np.dtype(dtype_name)).copy()
        arr = arr.reshape(shape)
        return arr if code == 1 else arr[()]


def msgpack_restore(encoded: bytes):
    """flax msgpack bytes -> nested dicts of numpy arrays."""
    reader = _Reader(encoded)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return tree


def read_nww(path: str):
    """-> (header, classifier variables, encoder variables or None), each
    tree in the flax layout, leaves as float32 numpy arrays."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"'{path}' is not a .nww artifact")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode("utf-8"))
        payload = msgpack_restore(f.read())
    if header.get("weights_dtype", "float32") not in ("float32", "bfloat16"):
        raise ValueError(f"'{path}': only float32 and bfloat16 weights are "
                         "read by the reference")
    return header, payload["variables"], payload.get("encoder_variables")
