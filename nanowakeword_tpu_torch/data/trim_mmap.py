"""Trailing-zero-row trimmer for .npy feature memmaps.

A copy of `nanowakeword_tpu/data/trim_mmap.py`.

Parity target: the upstream `nanowakeword/data/trim_mmap.py:27-89` —
block-copies the non-zero prefix into a temp memmap and atomically swaps.
Used after feature-generation jobs drop corrupted clips, leaving zero rows
at the tail of the preallocated file.
"""

from __future__ import annotations

import os

import numpy as np
from numpy.lib.format import open_memmap


def trim_mmap(target_path: str, block_size: int = 1024) -> int:
    """Remove trailing all-zero rows in place. Returns rows kept."""
    source = np.load(target_path, mmap_mode="r")
    total_rows = source.shape[0]

    active_rows = total_rows
    while active_rows > 0 and not np.any(source[active_rows - 1]):
        active_rows -= 1

    if active_rows == total_rows:
        del source
        return total_rows

    tmp_path = target_path.replace(".npy", "_tmp.npy")
    dest = open_memmap(tmp_path, mode="w+", dtype=source.dtype,
                       shape=(active_rows,) + source.shape[1:])
    cursor = 0
    while cursor < active_rows:
        limit = min(cursor + block_size, active_rows)
        dest[cursor:limit] = source[cursor:limit]
        cursor = limit
    dest.flush()
    del source, dest
    os.replace(tmp_path, target_path)
    return active_rows
