"""Host runtime helpers.

The counterpart of `Chunker` in `nanowakeword_tpu/runtime.py`, in numpy.
The native C++ runtime (native/nww_runtime.cc) stays with the JAX package
for now.
"""

from __future__ import annotations

import numpy as np


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
