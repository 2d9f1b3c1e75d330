"""Where the benchmark headline's time goes on the card: the bf16 forward of
`nanowakeword_tpu_torch/bench.py::build_forward` split into its three
stages, and the kernels that take the most device time.

    python -m nanowakeword_tpu_torch.tools.profile_bench_forward \\
        [--out forward.json]

On int16 [4096, 16000] audio made as bench_throughput makes it (its batch
and seed), it times by CUDA events, each as one captured graph replayed 20
times: the whole forward, the mel kernel alone, the bf16 encoder alone on
that mel, and the CRNN alone on those features (with the pad, the cast and
the sigmoid). Then `torch.profiler` over 20 eager forwards gives launches
per forward and the kernels that take the most device time. Prints one
JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from nanowakeword_tpu_torch import bench
from nanowakeword_tpu_torch.data.features import EMB_OFFSET
from nanowakeword_tpu_torch.ops.mel_cuda import mel_frontend_fused

BATCH = 4096   # bench_throughput's batch
ITERS = 20     # replays per stage, eager forwards profiled


def _replay_ms(fn, device, iters: int) -> float:
    """Mean device ms of one replay of `fn` captured as a graph."""
    run = bench._Captured(fn, device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    run()
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_bench_forward: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    forward, model, encoder = bench.build_forward(device)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(np.asarray(
        rng.integers(-16000, 16000, (BATCH, 16000)), np.int16)).to(device)
    with torch.no_grad():
        mel = mel_frontend_fused(audio, out_dtype=torch.bfloat16)
        emb = encoder(mel[:, EMB_OFFSET:])
        feats = F.pad(emb, (0, 0, bench.WINDOW - emb.shape[1], 0))
    stages = {
        "forward": lambda: forward(audio),
        "mel": lambda: mel_frontend_fused(audio, out_dtype=torch.bfloat16),
        "encoder": lambda: encoder(mel[:, EMB_OFFSET:]),
        "classifier": lambda: torch.sigmoid(model.module(feats)),
    }
    with torch.no_grad():
        ms = {name: _replay_ms(fn, device, ITERS)
              for name, fn in stages.items()}
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(ITERS):
                forward(audio)
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    by_name = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    result = {
        "card": bench.card_line(device),
        "batch": BATCH,
        "clips_per_s_from_forward_ms": BATCH / ms["forward"] * 1e3,
        "replay_ms": ms,
        "launches_per_forward": len(kernels) / ITERS,
        "device_ms_per_eager_forward": sum(
            e.time_range.elapsed_us() for e in kernels) / ITERS / 1e3,
        "top_kernels": [{"name": name[:120], "ms_per_forward":
                         total / ITERS / 1e3, "per_forward":
                         count / ITERS}
                        for name, (total, count) in top],
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
