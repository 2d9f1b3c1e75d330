"""The control of `correct`: the reference put in the program's place and
computed one precision below the configuration's, which has to come out as
not correct.

The configurations state float32 with TF32 off for the encoder and every
classifier, so the control computes the reference's forward in float32
with every operand of a matrix product or a convolution rounded to TF32
(reference/models.py::CONTROL_TF32); the log-mel stays as the
configuration states it. For a cell's seed it makes the cell's own traffic
and weights, scores every clip of the pool with the reference and with the
control, serves both as the cell's entry would (the interpreter's rules
for a stream), and reads the cell's compared number, `score_gap`, of the
control against the reference. It needs no program.

    python3 -m port_bench.control --workload <name> --seeds <n> [<n> ...]

prints one JSON line per seed. The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from port_bench import compare, program
from port_bench.drivers import bulk, stream
from port_bench.reference import models as refmodels
from port_bench.run import Cell, load_json


def control_gap(cell: Cell, seed: int, device,
                prec=refmodels.CONTROL_TF32) -> dict:
    """{"score_gap": the widest gap of the control against the reference,
    "answers": how many were compared, "limit": the cell's limit}."""
    config, traffic = cell.config, cell.traffic
    weights = program.Weights(config, seed, device)
    if traffic["entry"] == "stream":
        clips = dict(enumerate(stream.make_clips(traffic, seed, device)))
        names = list(config["stream_models"])
        margin = cell.limits["gate_margin"]
        want = stream.reference_served(config, weights, clips, names, device,
                                       refmodels.REFERENCE, margin)
        got = stream.reference_served(config, weights, clips, names, device,
                                      prec, margin)
        gaps = stream.chunk_gaps(config, names,
                                 [(i, got[i][0]) for i in clips], want)
    else:
        pool = bulk.make_pool(traffic, seed, device)
        want = bulk.reference_pool(config, weights, pool, device,
                                   refmodels.REFERENCE)
        got = bulk.reference_pool(config, weights, pool, device, prec)
        gaps = np.concatenate([compare.score_gaps(g, w)
                               for g, w in zip(got, want)])
    return {"score_gap": float(gaps.max()), "answers": int(gaps.size),
            "limit": cell.limits["score_gap"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    root = os.getcwd()
    cell = Cell(load_json(os.path.join(root, "BENCHMARK.json")),
                args.workload, root)
    device = torch.device(args.device)
    for seed in args.seeds:
        out = control_gap(cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
