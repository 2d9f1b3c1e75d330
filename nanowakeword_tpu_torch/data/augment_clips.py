"""Host-side augmentation generator: files in, int16 augmented batches out.

The counterpart of `nanowakeword_tpu/data/augment_clips.py`: the host only
decodes, crops and tiles on a thread pool and stacks fixed-shape arrays;
the whole augmentation chain (ops/augment.py) runs on `device`, with its
random draws from a seeded `torch.Generator`. The raw (no-augmentation)
generator keeps the reference's numpy RNG, so both packages give the same
batches on it.
"""

from __future__ import annotations

import random
from multiprocessing.pool import ThreadPool
from typing import List, Optional

import numpy as np
import torch

from nanowakeword_tpu_torch.ops.augment import AugmentParams, augment_batch
from nanowakeword_tpu_torch.utils.audio_io import load_audio

RIR_MAX_SAMPLES = 16000  # impulses truncated/padded to 1 s


def _prep_foreground(path: str, total_length: int, rng: random.Random):
    """Load a clip; crop randomly if long. Returns (audio [total_length]
    float int16-scale, true_length) or None."""
    data = load_audio(path)
    if data is None or len(data) == 0:
        return None
    n = len(data)
    if n > total_length:
        start = rng.randint(0, n - total_length)
        data = data[start:start + total_length]
        n = total_length
    out = np.zeros(total_length, np.float32)
    out[:n] = data
    return out, n


def _prep_background(path: Optional[str], total_length: int,
                     rng: random.Random):
    """Tile/crop a background to total_length."""
    if path is None:
        return np.zeros(total_length, np.float32), False
    data = load_audio(path)
    if data is None or len(data) == 0:
        return np.zeros(total_length, np.float32), False
    if len(data) < total_length:
        reps = int(np.ceil(total_length / len(data)))
        data = np.tile(data, reps)
    if len(data) > total_length:
        start = rng.randint(0, len(data) - total_length)
        data = data[start:start + total_length]
    has_real = bool(np.abs(data).max() > 1e-4 * 32768)
    return data.astype(np.float32), has_real


def _prep_rir(path: Optional[str]):
    if path is None:
        return np.zeros(RIR_MAX_SAMPLES, np.float32), False
    data = load_audio(path)
    if data is None or len(data) == 0:
        return np.zeros(RIR_MAX_SAMPLES, np.float32), False
    out = np.zeros(RIR_MAX_SAMPLES, np.float32)
    n = min(len(data), RIR_MAX_SAMPLES)
    out[:n] = data[:n]
    return out, True


def augment_clips(clip_paths: List[str],
                  total_length: int,
                  sr: int = 16000,
                  batch_size: int = 128,
                  augmentation_settings: Optional[dict] = None,
                  background_clip_paths: List[str] = (),
                  RIR_paths: List[str] = (),
                  num_workers: int = 0,
                  seed: int = 10,
                  device="cuda"):
    """Generator of [B, total_length] int16 augmented batches, as torch
    tensors on `device`."""
    del sr
    device = torch.device(device)
    params = AugmentParams.from_settings(augmentation_settings)
    if not RIR_paths:
        # static disable: no FFT convolution runs
        params = params._replace(rir_prob=0.0)
    rng = random.Random(seed)
    generator = torch.Generator().manual_seed(seed)

    clip_paths = list(clip_paths)
    rng.shuffle(clip_paths)
    background_clip_paths = list(background_clip_paths)
    RIR_paths = list(RIR_paths)

    pool = ThreadPool(processes=max(num_workers, 1)) if num_workers != 0 \
        else None
    try:
        for i in range(0, len(clip_paths), batch_size):
            fg_paths = clip_paths[i:i + batch_size]
            bg_paths = (rng.choices(background_clip_paths, k=len(fg_paths))
                        if background_clip_paths else [None] * len(fg_paths))
            rir_paths = (rng.choices(RIR_paths, k=len(fg_paths))
                         if RIR_paths else [None] * len(fg_paths))

            def load_fg(p):
                return _prep_foreground(p, total_length, rng)

            def load_bg(p):
                return _prep_background(p, total_length, rng)

            mapper = pool.map if pool else map
            fgs = list(mapper(load_fg, fg_paths))
            bgs = list(mapper(load_bg, bg_paths))
            rirs = list(mapper(_prep_rir, rir_paths))

            keep = [j for j, f in enumerate(fgs) if f is not None]
            if not keep:
                continue

            def stack(arrays, dtype):
                return torch.from_numpy(np.asarray(arrays, dtype)).to(device)

            # int16-scale floats, as decoded (resampling may leave them
            # off the integer grid); augment_batch detects the scale
            fg = stack([fgs[j][0] for j in keep], np.float32)
            fg_lens = np.asarray([fgs[j][1] for j in keep], np.int64)
            bg = stack([bgs[j][0] for j in keep], np.float32)
            has_bg = stack([bgs[j][1] for j in keep], bool)
            rir = stack([rirs[j][0] for j in keep], np.float32)
            has_rir = stack([rirs[j][1] for j in keep], bool)
            yield augment_batch(fg, bg, rir, fg_lens, has_bg, has_rir, params,
                                generator=generator)
    finally:
        if pool:
            pool.close()
            pool.join()


def raw_audio_batch_generator(clip_paths: List[str], total_length: int,
                              batch_size: int, sr: int = 16000,
                              num_workers: int = 0, seed: int = 10):
    """No-augmentation path with random-volume scaling: numpy int16
    batches, the same as the reference's for the same seed."""
    del sr
    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)
    clip_paths = list(clip_paths)
    rng.shuffle(clip_paths)

    pool = ThreadPool(processes=max(num_workers, 1)) if num_workers != 0 \
        else None
    try:
        for i in range(0, len(clip_paths), batch_size):
            batch_paths = clip_paths[i:i + batch_size]

            def load(p):
                return _prep_foreground(p, total_length, rng)

            mapper = pool.map if pool else map
            loaded = [x for x in mapper(load, batch_paths) if x is not None]
            if not loaded:
                continue
            batch = np.stack([x[0] for x in loaded]) / 32768.0
            volumes = np_rng.uniform(0.5, 1.0, (batch.shape[0], 1))
            batch = np.clip(batch * volumes, -1.0, 1.0)
            yield (batch * 32767).astype(np.int16)
    finally:
        if pool:
            pool.close()
            pool.join()
