"""Reader and writer for flax's msgpack serialization, in pure Python on
`struct`.

The counterparts of `flax.serialization.msgpack_restore` and
`msgpack_serialize`: the encoder assets and the `.nww` payloads of the JAX
package are flax msgpack blobs, and this package reads and writes them
without `msgpack`, `flax` or `ml_dtypes`.

What flax writes (flax/serialization.py):
* ordinary msgpack maps, arrays, str, bin, ints, floats, nil and bool;
* ext code 1, an ndarray, packed as the msgpack array
  ``(shape, dtype_name, C-order bytes)``;
* ext code 2, a Python complex, packed as ``(real, imag)``;
* ext code 3, a numpy scalar, packed like an ndarray of shape ``()``;
* arrays above 1 GiB split into ``{"__msgpack_chunked_array__": True,
  "shape": {...}, "chunks": {...}}`` maps.

bfloat16 leaves decode to float32: the 16 stored bits are the top half of
the float32 with the same value, so the conversion is exact. To write a
bfloat16 leaf, wrap its 16-bit patterns in `Bfloat16Bits`. The writer
sorts map keys, as flax's tree flattening does, and writes the smallest
msgpack form of each value, as `msgpack.packb` does, so a tree of numpy
arrays serializes to the same bytes as under flax.

Both directions stream: `msgpack_dump` writes each array's bytes from its
own memory and `msgpack_load` reads them into the array's, so a payload of
gigabytes (a `.nww` of the Granite hybrid holds 3 GB) is held once in
memory, as its arrays.
"""

from __future__ import annotations

import io
import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder over a binary stream. An array's bytes are read
    straight into the array's own memory (`readinto`), so a file is copied
    once, into the arrays, whatever its size."""

    def __init__(self, stream):
        self.stream = stream
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.stream.read(n)
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def take_into(self, arr: np.ndarray) -> None:
        view = memoryview(arr.reshape(-1).view(np.uint8))
        if self.stream.readinto(view) != view.nbytes:
            raise ValueError("truncated msgpack data")
        self.pos += view.nbytes

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
                return self.take(n)
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
        return self.take(n).decode("utf-8")

    def read_array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read_ext(self, code: int, n: int):
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            end = self.pos + n
            arr = self.read_ndarray()
            if self.pos != end:
                raise ValueError("malformed msgpack ndarray")
            return arr[()] if code == _EXT_NPSCALAR else arr
        data = self.take(n)
        if code == _EXT_COMPLEX:
            re, im = _Reader(io.BytesIO(data)).read()
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext code {code}")

    def read_ndarray(self) -> np.ndarray:
        """The body of an ndarray ext, ``(shape, dtype_name, bytes)``, its
        bytes read into a new array; bfloat16 decodes to float32."""
        if self.take(1)[0] != 0x93:
            raise ValueError("malformed msgpack ndarray")
        shape, dtype_name = self.read(), self.read()
        head = self.take(1)[0]
        if head not in _BIN:
            raise ValueError("malformed msgpack ndarray")
        n = self.unpack(_BIN[head])
        bf16 = dtype_name == "bfloat16"
        dtype = np.dtype(np.uint16 if bf16 else dtype_name)
        count = int(np.prod(shape, dtype=np.int64))
        if n != count * dtype.itemsize:
            raise ValueError("malformed msgpack ndarray")
        arr = np.empty(count, dtype)
        self.take_into(arr)
        if bf16:
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return arr.reshape(shape)


_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_NUMBERS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_load(stream):
    """A binary stream holding one flax msgpack object, to its end -> nested
    dicts of numpy arrays and scalars."""
    tree = _Reader(stream).read()
    if stream.read(1):
        raise ValueError("trailing bytes after msgpack object")
    return _unchunk(tree)


def msgpack_restore(encoded: bytes):
    """Flax msgpack bytes -> nested dicts of numpy arrays and scalars."""
    return msgpack_load(io.BytesIO(encoded))


def read_msgpack_file(path: str):
    with open(path, "rb") as f:
        return msgpack_load(f)


# -- writer ------------------------------------------------------------------------


class Bfloat16Bits:
    """A bfloat16 array given by its uint16 bit patterns (numpy has no
    bfloat16 type without ml_dtypes)."""

    def __init__(self, bits: np.ndarray):
        self.bits = np.ascontiguousarray(bits, np.uint16)


def _pack_uint(n: int) -> bytes:
    if n <= 0x7F:
        return struct.pack(">B", n)
    for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                           (0xCE, ">I", 0xFFFFFFFF)):
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    return b"\xcf" + struct.pack(">Q", n)


def _pack_int(n: int) -> bytes:
    if n >= 0:
        return _pack_uint(n)
    if n >= -32:
        return struct.pack(">b", n)
    for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                           (0xD2, ">i", -0x80000000)):
        if n >= low:
            return bytes([code]) + struct.pack(fmt, n)
    return b"\xd3" + struct.pack(">q", n)


def _sized(n: int, fix: int, fix_max: int, codes) -> bytes:
    """Header of a str/bin/array/map of length n: the fix form when it
    fits, else the 8/16/32-bit length form (codes; None where absent)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object too large ({n})")


def _ext_head(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else \
        _sized(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code)


def _array_chunks(code: int, shape, dtype_name: str, arr: np.ndarray):
    """An ndarray ext, ``(shape, dtype_name, C-order bytes)``; the bytes are
    a view of the array's memory."""
    data = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    head = (b"\x93" + _pack(list(int(s) for s in shape)) + _pack(dtype_name)
            + _sized(data.nbytes, None, 0, (0xC4, 0xC5, 0xC6)))
    yield _ext_head(code, len(head) + data.nbytes)
    yield head
    yield data


def _chunks(obj):
    """The msgpack encoding of `obj` as a sequence of bytes and views, in
    order; an array's data is not copied."""
    if isinstance(obj, Bfloat16Bits):
        yield from _array_chunks(_EXT_NDARRAY, obj.bits.shape, "bfloat16",
                                 obj.bits)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise ValueError("object arrays cannot be serialized")
        yield from _array_chunks(_EXT_NDARRAY, obj.shape, obj.dtype.name,
                                 obj)
    elif isinstance(obj, np.generic):
        yield from _array_chunks(_EXT_NPSCALAR, (), obj.dtype.name,
                                 np.asarray(obj))
    elif isinstance(obj, (list, tuple)):
        yield _sized(len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            yield from _chunks(v)
    elif isinstance(obj, dict):
        yield _sized(len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k in sorted(obj):
            yield from _chunks(k)
            yield from _chunks(obj[k])
    else:
        yield _pack_scalar(obj)


def _pack_scalar(obj) -> bytes:
    if obj is None:
        return b"\xc0"
    if obj is True:
        return b"\xc3"
    if obj is False:
        return b"\xc2"
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, complex):
        data = _pack([obj.real, obj.imag])
        return _ext_head(_EXT_COMPLEX, len(data)) + data
    if isinstance(obj, str):
        data = obj.encode("utf-8")
        return _sized(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + data
    if isinstance(obj, (bytes, bytearray)):
        return _sized(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + bytes(obj)
    raise TypeError(f"cannot serialize {type(obj).__name__} to msgpack")


def _pack(obj) -> bytes:
    return b"".join(_chunks(obj))


def _check_sizes(tree) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _check_sizes(v)
    elif isinstance(tree, np.ndarray) and tree.nbytes > 2 ** 30:
        raise ValueError("arrays above 1 GiB are not supported")


def msgpack_serialize(tree) -> bytes:
    """Nested dicts of numpy arrays (and scalars, strings, lists) -> flax
    msgpack bytes. Arrays above 1 GiB, which flax would chunk, raise."""
    _check_sizes(tree)
    return _pack(tree)


def msgpack_dump(tree, stream) -> None:
    """`msgpack_serialize(tree)` written to a binary stream piece by piece,
    each array's bytes from its own memory."""
    _check_sizes(tree)
    for chunk in _chunks(tree):
        stream.write(chunk)
