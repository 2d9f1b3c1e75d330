"""Device-resident ISBL training: K steps per dispatch, nothing per step on
the host.

The counterpart of `nanowakeword_tpu/train/cached.py`. The features,
labels, per-rule index pools and the hardness array are uploaded once.
Each step samples the batch composition on the device (Gumbel top-k over
`log(hardness^0.75 + 1e-6)` for rules whose pool covers the quota,
categorical draws with replacement otherwise), gathers the batch, runs the
training step and scatters the hardness EMA back in place. The host reads
one [K, 6] metrics array per dispatch: loss, grad_norm, tp, fn, fa, n_pos
per step.

The reference may sample with the TPU's `approx_max_k` for large pools;
the port samples exactly for every `sampling` value.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nanowakeword_tpu_torch.train import loss as losses
from nanowakeword_tpu_torch.train.optim import Optimizer
from nanowakeword_tpu_torch.train.step import (forward_backward, make_loss,
                                               resolve_compute_dtype)
from nanowakeword_tpu_torch.utils.logger import print_info, print_warning

HARDNESS_SMOOTHING = 0.75
WEIGHT_FLOOR = 1e-6
SAMPLING_MODES = ("exact", "approx", "auto")
# the share of the card's free memory that a feature cache may take
CACHE_MEMORY_SHARE = 0.8


class CachedData(NamedTuple):
    features: torch.Tensor             # [N, T, F] on the device
    labels: torch.Tensor               # [N]
    hardness: torch.Tensor             # [N]
    pools: Tuple[torch.Tensor, ...]    # per-rule global index arrays
    quotas: Tuple[int, ...]
    replace: Tuple[bool, ...]          # pool smaller than its quota


def materialize_rows(dataset):
    """Dense float32 host copies of every (feature, label) row of a
    dataset, for one upload. Rows with differing frame counts are
    pad/truncated to the most common length, as the reference does; how
    many were padded and how many truncated is logged."""
    n = len(dataset)
    rows = []
    labels = np.empty(n, np.float32)
    for i in range(n):
        f, lbl, _ = dataset[i]
        rows.append(f)
        labels[i] = lbl
    lengths = [r.shape[0] for r in rows]
    target_len = max(set(lengths), key=lengths.count)
    feats = np.zeros((n, target_len, rows[0].shape[1]), np.float32)
    for i, f in enumerate(rows):
        m = min(f.shape[0], target_len)
        feats[i, :m] = f[:m]
    padded = sum(length < target_len for length in lengths)
    truncated = sum(length > target_len for length in lengths)
    if padded or truncated:
        print_warning(f"{padded} of {n} feature rows were zero-padded and "
                      f"{truncated} truncated to the most common length of "
                      f"{target_len} frames")
    return feats, labels


def check_cache_fits(n_bytes: int, device: torch.device,
                     what: str = "feature cache") -> None:
    """Raise if `n_bytes` of `what` would not fit in the share of the
    card's free memory that a cache may take. Host rows need no check."""
    if device.type != "cuda":
        return
    free, total = torch.cuda.mem_get_info(device)
    if n_bytes > CACHE_MEMORY_SHARE * free:
        raise MemoryError(
            f"the {what} needs {n_bytes / 2**30:.2f} GiB but the device has "
            f"{free / 2**30:.2f} GiB free of {total / 2**30:.2f} GiB (the "
            f"cache may take {CACHE_MEMORY_SHARE:.0%} of what is free); use "
            "fewer feature rows")


def build_cached_data(dataset, batch_composition: Dict[str, int],
                      feature_manifests, device) -> CachedData:
    """Upload the whole dataset and the ISBL state to `device`."""
    print_info(f"Uploading {len(dataset)} feature rows to the device "
               "(device-cache training mode)...")
    feats, labels = materialize_rows(dataset)
    device = torch.device(device)
    check_cache_fits(feats.nbytes + labels.nbytes
                     + dataset.sample_hardness.size * 4, device,
                     "device-cached training set")
    pools, quotas, replace = [], [], []
    for rule, quota in batch_composition.items():
        quota = int(quota)
        if quota == 0:
            continue
        if rule in dataset.index_pools:
            pool = dataset.index_pools[rule]
        else:
            keys = list(feature_manifests.get(rule, {}).keys())
            parts = [dataset.index_pools[k] for k in keys
                     if k in dataset.index_pools]
            if not parts:
                continue
            pool = np.concatenate(parts)
        pools.append(torch.as_tensor(pool, dtype=torch.int64, device=device))
        quotas.append(quota)
        replace.append(len(pool) < quota)
    return CachedData(
        features=torch.from_numpy(feats).to(device),
        labels=torch.from_numpy(labels).to(device),
        hardness=torch.from_numpy(
            dataset.sample_hardness.astype(np.float32)).to(device),
        pools=tuple(pools), quotas=tuple(quotas), replace=tuple(replace))


def sample_rule(pool: torch.Tensor, hardness: torch.Tensor, quota: int,
                with_replacement: bool,
                generator: torch.Generator) -> torch.Tensor:
    """ISBL selection for one composition rule, on the pool's device:
    weights hardness^0.75 + 1e-6; without replacement by Gumbel top-k
    (multinomial sampling without replacement), else categorical draws."""
    w = hardness[pool] ** HARDNESS_SMOOTHING + WEIGHT_FLOOR
    if with_replacement:
        chosen = torch.multinomial(w, quota, replacement=True,
                                   generator=generator)
    else:
        u = torch.rand(w.shape, generator=generator, device=w.device)
        u = u * (1.0 - 1e-7) + 1e-7                       # in [1e-7, 1)
        gumbel = -torch.log(-torch.log(u))
        chosen = torch.topk(torch.log(w) + gumbel, quota, sorted=False).indices
    return pool[chosen]


def make_cached_train_loop(module, optimizer: Optimizer, *,
                           quotas: Tuple[int, ...],
                           replace: Tuple[bool, ...], k_steps: int,
                           loss_function: str = "bias_weighted",
                           loss_bias: float = 0.75,
                           logit_reg_weight: float = 2e-4,
                           logit_reg_margin: float = 6.0,
                           hardness_alpha: float = 0.05,
                           hardness_floor: float = 0.05,
                           sampling: str = "auto",
                           compute_dtype: str = "float32",
                           dropout_seed: Optional[int] = None):
    """-> run(hardness, generator, features, labels, pools) -> metrics
    [K, 6] on the device. `module`, `optimizer` and `hardness` are updated
    in place."""
    if sampling not in SAMPLING_MODES:
        raise ValueError("device_cache.sampling must be 'exact', 'approx' "
                         f"or 'auto', got {sampling!r}")
    cdt = resolve_compute_dtype(compute_dtype)
    total_loss = make_loss(loss_function, loss_bias, logit_reg_weight,
                           logit_reg_margin)

    def one_step(hardness, generator, features, labels, pools):
        idx = torch.cat([sample_rule(pool, hardness, q, r, generator)
                         for pool, q, r in zip(pools, quotas, replace)])
        batch_x = features[idx]
        batch_y = labels[idx]
        total, grad_norm, logits = forward_backward(
            module, optimizer, total_loss, batch_x, batch_y, cdt,
            dropout_seed)
        raw = losses.raw_bce(logits, batch_y)
        new = torch.clamp(hardness_alpha * raw
                          + (1 - hardness_alpha) * hardness[idx],
                          min=hardness_floor)
        hardness[idx] = new
        yp = torch.sigmoid(logits)
        is_pos = batch_y == 1
        return torch.stack([
            total.float(), grad_norm.float(),
            ((yp >= 0.5) & is_pos).sum().float(),
            ((yp < 0.5) & is_pos).sum().float(),
            ((yp > 0.5) & ~is_pos).sum().float(),
            is_pos.sum().float()])

    def run(hardness, generator, features, labels, pools):
        return torch.stack([one_step(hardness, generator, features, labels,
                                     pools) for _ in range(k_steps)])

    return run
