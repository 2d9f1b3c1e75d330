"""Host runtime helpers.

The counterparts of `Chunker` and `AudioRing` in
`nanowakeword_tpu/runtime.py`, in numpy. The native C++ runtime
(native/nww_runtime.cc) stays with the JAX package for now.
"""

from __future__ import annotations

import threading

import numpy as np


class AudioRing:
    """int16 ring buffer between a capture thread, which pushes, and the
    interpreter, which pops. On overflow the oldest samples are dropped, so
    capture never blocks."""

    def __init__(self, capacity: int = 16000 * 10):
        self._buf = np.zeros(0, np.int16)
        self._cap = capacity
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return len(self._buf)

    def push(self, samples: np.ndarray) -> int:
        samples = np.ascontiguousarray(samples, np.int16)
        with self._lock:
            self._buf = np.concatenate([self._buf, samples])[-self._cap:]
        return len(samples)

    def pop(self, n: int) -> np.ndarray:
        with self._lock:
            out = self._buf[:n].copy()
            self._buf = self._buf[len(out):]
        return out


class Chunker:
    """Fixed-size chunk framing with the remainder carried to the next call."""

    def __init__(self, chunk: int = 1280):
        self.chunk = chunk
        self._pending = np.zeros(0, np.float32)

    @property
    def pending(self) -> int:
        return len(self._pending)

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """int16 or float samples in -> [n_chunks, chunk] float32 out."""
        samples = np.asarray(samples).reshape(-1).astype(np.float32)
        self._pending = np.concatenate([self._pending, samples])
        n = len(self._pending) // self.chunk
        out = self._pending[:n * self.chunk].reshape(n, self.chunk)
        self._pending = self._pending[n * self.chunk:]
        return out.copy()

    def reset(self):
        self._pending = np.zeros(0, np.float32)
