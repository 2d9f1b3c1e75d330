#!/usr/bin/env python3
"""Time the mel kernel of a checkout of this repository on a GPU.

    python3 nanowakeword_tpu_torch/tools/time_mel_kernel.py [--root DIR]

It imports `nanowakeword_tpu_torch` from DIR (default: this checkout),
builds that checkout's mel kernel, checks it against the same checkout's
plain version on int16 [4096, 16000] and [4096, 32000] (random samples from
seed 0) and prints one JSON line: the kernel's milliseconds at each shape
(CUDA events, mean of 20 calls after 3 warm-up calls) and max
|kernel - plain|. To compare two versions, run it on each checkout in one
call of the card, in turns (old, new, new, old).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = ((4096, 16000), (4096, 32000))


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=here,
                        help="checkout whose nanowakeword_tpu_torch is timed")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from nanowakeword_tpu_torch.ops import mel_cuda
    if not torch.cuda.is_available():
        print("time_mel_kernel: no CUDA device", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    result = {"root": root}
    for shape in SHAPES:
        x = torch.from_numpy(rng.integers(-20000, 20000, shape).astype(
            np.int16)).to("cuda")
        err = (mel_cuda.mel_frontend_cuda(x)
               - mel_cuda.mel_frontend_plain(x)).abs().max().item()
        for _ in range(3):
            mel_cuda.mel_frontend_cuda(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            mel_cuda.mel_frontend_cuda(x)
        end.record()
        torch.cuda.synchronize()
        result[f"{shape[0]}x{shape[1]}"] = {
            "ms": start.elapsed_time(end) / 20, "max_abs_err": err}
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
