"""Where a training step's time goes on the card: kernel launches per step,
the device's busy time per step and the host's time per step, for float32
and bf16 compute in turns, by `torch.profiler`.

    python -m nanowakeword_tpu_torch.tools.profile_train_step \\
        [--model-type crnn] [--steps 20] [--e2e] \\
        [--out train_step.json]

It runs the device-cached loop (train/cached.py) at the shipped width and
batch composition (96 positives, 160 negatives) on random features made on
the card from a seed, so it needs no files. For each compute dtype it warms
up, then profiles `--steps` steps and prints one JSON object: host
milliseconds per step (clock after a synchronize), kernel launches per step,
device-busy milliseconds per step (the union of the kernels' intervals), the
busy share, and the kernels that take the most device time. With `--e2e` it
profiles the end-to-end step instead (train/e2e.py: the bundled encoder in
bf16, its mel kernel, the shipped CRNN) on one batch of random int16-valued
audio made on the card, at batch 24 and 256 in turns: the step alone,
without the host loop's WAV decoding. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from nanowakeword_tpu_torch.models.model import Model
from nanowakeword_tpu_torch.train.cached import make_cached_train_loop
from nanowakeword_tpu_torch.train.optim import Optimizer

SHIPPED = {"embedding_dim": 96, "crnn_cnn_channels": [16, 32, 32],
           "crnn_rnn_type": "gru", "activation_function": "relu",
           "optimizer_type": "adamw", "learning_rate_max": 0.0015,
           "lr_scheduler_type": "onecycle", "weight_decay": 0.01}
LAYER_DIM = {"crnn": 64}        # the shipped CRNN; other families 128


def _device_intervals(prof):
    """(start us, end us, name) of every event that ran on the device."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == cuda]


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b, _ in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile(model_type: str, compute_dtype: str, steps: int, seed: int):
    """The device-cached loop of `model_type` in `compute_dtype`."""
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(seed)
    features = torch.randn(1024, 16, 96, device=cuda, generator=g)
    labels = (torch.arange(1024, device=cuda) < 512).float()
    hardness = torch.ones(1024, device=cuda)
    pools = (torch.arange(0, 512, device=cuda),
             torch.arange(512, 1024, device=cuda))
    model = Model(config=SHIPPED, model_name="profiled",
                  model_type=model_type,
                  layer_dim=LAYER_DIM.get(model_type, 128), n_blocks=2,
                  dropout_prob=0.3, seed=seed, device=cuda).train()
    optimizer = Optimizer(list(model.module.parameters()), SHIPPED, 20000)

    def loop(k):
        run = make_cached_train_loop(
            model.module, optimizer, quotas=(96, 160),
            replace=(False, False), k_steps=k, compute_dtype=compute_dtype,
            dropout_seed=seed)
        return run(hardness, g, features, labels, pools)

    return measure(loop, steps, {
        "model_type": model_type, "compute_dtype": compute_dtype,
        "n_params": model.n_params(), "batch": 256, "steps": steps})


def profile_e2e(batch: int, steps: int, seed: int):
    """The end-to-end step of train/e2e.py at `batch` clips of 32000
    samples, as the host loop launches it (train/step.py)."""
    from nanowakeword_tpu_torch.train.e2e import E2EModel
    from nanowakeword_tpu_torch.train.step import make_train_step
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(seed)
    audio = torch.randint(-3000, 3000, (batch, 32000), device=cuda,
                          generator=g).float()
    labels = (torch.arange(batch, device=cuda) % 3 == 0).float()
    model = E2EModel(Model(config=SHIPPED, model_name="profiled",
                           input_shape=(16, 96), model_type="crnn",
                           layer_dim=64, n_blocks=2, dropout_prob=0.3,
                           seed=seed, device=cuda)).train()
    optimizer = Optimizer(list(model.module.parameters()), SHIPPED, 20000)
    step = make_train_step(model.module, optimizer, dropout_seed=seed)

    def loop(k):
        for _ in range(k):
            metrics = step(audio, labels)
        return metrics.loss.item()

    return measure(loop, steps, {
        "model_type": "e2e: wide128 encoder (bf16) + crnn",
        "compute_dtype": "float32", "n_params": model.n_params(),
        "batch": batch, "steps": steps})


def measure(loop, steps: int, out: dict) -> dict:
    """Host ms per step of `loop(steps)` after a warm-up, then the same
    under the profiler: launches, device-busy ms and the top kernels."""
    loop(10)                                               # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop(steps)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        loop(steps)
        torch.cuda.synchronize()
    intervals = _device_intervals(prof)
    out["host_ms_per_step"] = host_ms
    if not intervals:
        out["device"] = "not measured: the profiler saw no device events"
        return out
    by_name: dict = {}
    for a, b, name in intervals:
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + (b - a), count + 1)
    busy_ms = _union_us(intervals) / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out.update({
        "launches_per_step": len(intervals) / steps,
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share_of_host_time": busy_ms / host_ms,
        "top_kernels": [{"name": name[:80], "ms_per_step": t / 1e3 / steps,
                         "launches_per_step": c / steps}
                        for name, (t, c) in top]})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model-type", default="crnn")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--e2e", action="store_true",
                        help="profile the end-to-end step at batch 24 and "
                             "256 instead")
    parser.add_argument("--out", default=None,
                        help="also write the results to this JSON file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 1
    if args.e2e:
        results = [profile_e2e(batch, args.steps, args.seed)
                   for batch in (24, 256, 256, 24)]
    else:
        results = [profile(args.model_type, dtype, args.steps, args.seed)
                   for dtype in ("float32", "bfloat16", "bfloat16",
                                 "float32")]
    card = {"card": torch.cuda.get_device_name(0)}
    for r in results:
        print(json.dumps({**card, **r}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**card, "runs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
