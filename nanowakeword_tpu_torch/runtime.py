"""The native audio runtime: the host plumbing around the device path.

The counterpart of `nanowakeword_tpu/runtime.py`. `csrc/nww_runtime.cc`
(the same C ABI as the JAX package's library) is built with g++ at first
use into `build/nww_torch_kernels/` (ops/_build.py) and bound with ctypes,
which releases the GIL during every call:

* `AudioRing`: a single-producer/single-consumer int16 ring between a
  capture thread and the interpreter (`listen()`). Its capacity is rounded
  up to a power of two; on overflow the oldest samples are dropped.
* `decode_wav_bytes`: 16-bit PCM WAV bytes -> int16 mono (the channels'
  integer sum divided by their count, truncated toward zero). A buffer the
  native decoder rejects (not PCM16, WAVE_FORMAT_EXTENSIBLE, no data
  chunk) goes through the stdlib `wave` module, as in the JAX package.
* `Chunker`: 1280-sample chunk framing with the remainder carried.

If the library cannot be built or loaded, `load_native` raises with the
compiler's message: nothing falls back to numpy quietly. The numpy twins
(`PlainAudioRing`, `PlainChunker`, `plain_decode_wav_bytes`) compute the
same results; the tests hold the native classes against them.
"""

from __future__ import annotations

import ctypes
import io
import struct
import threading
import wave

import numpy as np

from nanowakeword_tpu_torch.ops import _build

LIBRARY = "nww_runtime"
_lib = None
_lib_lock = threading.Lock()


def load_native() -> ctypes.CDLL:
    """The native runtime, built at first use. Raises if it cannot be built
    or loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = _build.load(LIBRARY)
        size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
        signatures = {
            "nww_ring_create": (ptr, [size_t]),
            "nww_ring_destroy": (None, [ptr]),
            "nww_ring_size": (size_t, [ptr]),
            "nww_ring_capacity": (size_t, [ptr]),
            "nww_ring_push": (size_t, [ptr, ptr, size_t]),
            "nww_ring_pop": (size_t, [ptr, ptr, size_t]),
            "nww_wav_decode": (ctypes.c_int, [
                ptr, size_t, ptr, size_t, ctypes.POINTER(size_t),
                ctypes.POINTER(ctypes.c_int32)]),
            "nww_chunker_create": (ptr, [size_t]),
            "nww_chunker_destroy": (None, [ptr]),
            "nww_chunker_reset": (None, [ptr]),
            "nww_chunker_pending": (size_t, [ptr]),
            "nww_chunker_feed": (size_t, [ptr, ptr, size_t, ptr, size_t]),
            "nww_chunker_feed_f32": (size_t, [ptr, ptr, size_t, ptr, size_t]),
        }
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def library_path() -> str:
    """The path of the native runtime's shared library."""
    return str(_build.library_path(LIBRARY))


def ring_capacity(min_capacity: int) -> int:
    """The native ring's capacity: the least power of two >= the request
    (and >= 2)."""
    p = 1
    while p < max(int(min_capacity), 2):
        p <<= 1
    return p


# -- the ring --------------------------------------------------------------------


class AudioRing:
    """SPSC int16 ring buffer: capture threads push, the interpreter pops.
    On overflow the oldest samples are dropped, so capture never blocks."""

    def __init__(self, capacity: int = 16000 * 10):
        self._lib = load_native()
        self._handle = self._lib.nww_ring_create(capacity)
        if not self._handle:
            raise MemoryError(f"cannot allocate a ring of {capacity} samples")

    @property
    def capacity(self) -> int:
        return int(self._lib.nww_ring_capacity(self._handle))

    @property
    def size(self) -> int:
        return int(self._lib.nww_ring_size(self._handle))

    def push(self, samples: np.ndarray) -> int:
        """Append samples; returns how many were written (at most the
        capacity: of a longer push only the newest are kept)."""
        samples = np.ascontiguousarray(samples, np.int16).reshape(-1)
        return int(self._lib.nww_ring_push(self._handle, samples.ctypes.data,
                                           len(samples)))

    def pop(self, n: int) -> np.ndarray:
        """Up to n of the oldest samples."""
        out = np.empty(n, np.int16)
        got = int(self._lib.nww_ring_pop(self._handle, out.ctypes.data, n))
        return out[:got]

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.nww_ring_destroy(self._handle)
            self._handle = None


class PlainAudioRing:
    """AudioRing in numpy, with the native ring's capacity and overflow."""

    def __init__(self, capacity: int = 16000 * 10):
        self.capacity = ring_capacity(capacity)
        self._buf = np.zeros(0, np.int16)
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return len(self._buf)

    def push(self, samples: np.ndarray) -> int:
        samples = np.ascontiguousarray(samples, np.int16).reshape(-1)
        samples = samples[len(samples) - min(len(samples), self.capacity):]
        with self._lock:
            self._buf = np.concatenate([self._buf, samples])[-self.capacity:]
        return len(samples)

    def pop(self, n: int) -> np.ndarray:
        with self._lock:
            out = self._buf[:n].copy()
            self._buf = self._buf[len(out):]
        return out


# -- WAV decoding ---------------------------------------------------------------


def _decode_stdlib(buf: bytes):
    """The stdlib path for buffers the native decoder rejects (the JAX
    package's fallback): channels folded by their float mean, truncated."""
    with wave.open(io.BytesIO(buf), "rb") as f:
        sr = f.getframerate()
        data = np.frombuffer(f.readframes(f.getnframes()), np.int16)
        if f.getnchannels() > 1:
            data = data.reshape(-1, f.getnchannels()).mean(
                axis=1).astype(np.int16)
    return data, sr


def decode_wav_bytes(buf: bytes):
    """WAV bytes -> (int16 mono samples, sample rate). 16-bit PCM decodes
    natively; anything the native decoder rejects takes the stdlib path."""
    lib = load_native()
    cap = len(buf) // 2
    out = np.empty(max(cap, 1), np.int16)
    n = ctypes.c_size_t(0)
    rate = ctypes.c_int32(0)
    err = lib.nww_wav_decode(buf, len(buf), out.ctypes.data, cap,
                             ctypes.byref(n), ctypes.byref(rate))
    if err == 0:
        return out[:n.value].copy(), int(rate.value)
    return _decode_stdlib(buf)


def _parse_pcm16(buf: bytes):
    """The native decoder's parse in Python: (error code, channels, rate,
    data bytes). The error codes are the native ones: -1 not RIFF/WAVE or
    shorter than a header, -2 not 16-bit PCM, -3 no data or no channels."""
    if len(buf) < 44 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        return -1, 0, 0, b""
    pos, channels, rate, data = 12, 0, 0, None
    while pos + 8 <= len(buf):
        tag = buf[pos:pos + 4]
        (length,) = struct.unpack_from("<I", buf, pos + 4)
        if tag == b"fmt " and length >= 16:
            fmt, channels, rate = struct.unpack_from("<hhi", buf, pos + 8)
            (bits,) = struct.unpack_from("<h", buf, pos + 22)
            if fmt != 1 or bits != 16:
                return -2, 0, 0, b""
        elif tag == b"data":
            data = buf[pos + 8:pos + 8 + length]
        pos += 8 + length + (length & 1)
    if data is None or channels <= 0:
        return -3, 0, 0, b""
    return 0, channels, rate, data


def plain_decode_wav_bytes(buf: bytes):
    """decode_wav_bytes in numpy: the same parse, fold and fallback."""
    err, channels, rate, data = _parse_pcm16(buf)
    if err != 0:
        return _decode_stdlib(buf)
    frames = len(data) // 2 // channels
    pcm = np.frombuffer(data, np.int16, count=frames * channels)
    if channels == 1:
        return pcm.copy(), rate
    acc = pcm.astype(np.int32).reshape(frames, channels).sum(axis=1)
    return (np.sign(acc) * (np.abs(acc) // channels)).astype(np.int16), rate


# -- chunk framing ---------------------------------------------------------------


class Chunker:
    """Fixed-size chunk framing with the remainder carried to the next
    call."""

    def __init__(self, chunk: int = 1280):
        self.chunk = chunk
        self._lib = load_native()
        self._handle = self._lib.nww_chunker_create(chunk)
        if not self._handle:
            raise MemoryError("cannot allocate a chunker")

    @property
    def pending(self) -> int:
        return int(self._lib.nww_chunker_pending(self._handle))

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """int16 or float samples in -> [n_chunks, chunk] float32 out. Float
        input is framed unquantised (the float32 feed)."""
        samples = np.asarray(samples).reshape(-1)
        as_float = samples.dtype.kind == "f"
        samples = np.ascontiguousarray(
            samples, np.float32 if as_float else np.int16)
        max_chunks = (self.pending + len(samples)) // self.chunk
        out = np.empty((max(max_chunks, 1), self.chunk), np.float32)
        feed = (self._lib.nww_chunker_feed_f32 if as_float
                else self._lib.nww_chunker_feed)
        n = int(feed(self._handle, samples.ctypes.data, len(samples),
                     out.ctypes.data, max_chunks))
        return out[:n]

    def reset(self):
        self._lib.nww_chunker_reset(self._handle)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.nww_chunker_destroy(self._handle)
            self._handle = None


class PlainChunker:
    """Chunker in numpy."""

    def __init__(self, chunk: int = 1280):
        self.chunk = chunk
        self._pending = np.zeros(0, np.float32)

    @property
    def pending(self) -> int:
        return len(self._pending)

    def feed(self, samples: np.ndarray) -> np.ndarray:
        samples = np.asarray(samples).reshape(-1)
        if samples.dtype.kind != "f":
            samples = samples.astype(np.int16)
        self._pending = np.concatenate([self._pending,
                                        samples.astype(np.float32)])
        n = len(self._pending) // self.chunk
        out = self._pending[:n * self.chunk].reshape(n, self.chunk)
        self._pending = self._pending[n * self.chunk:]
        return out.copy()

    def reset(self):
        self._pending = np.zeros(0, np.float32)
