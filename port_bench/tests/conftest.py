"""Shared fixtures of the benchmark's tests: tiny cells on the CPU, and the
card where a test needs one (decided here, never at import)."""

import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spec() -> dict:
    from port_bench.run import load_json
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def tiny_cell(workload: str, root: str = ROOT):
    """The cell with its traffic cut to a size the CPU runs in seconds:
    three clips of 16-18 chunks, or two batches of 6 clips."""
    from port_bench.run import Cell, load_json
    cell = Cell(load_json(os.path.join(root, "BENCHMARK.json")), workload,
                root)
    if cell.traffic["entry"] == "stream":
        cell.traffic.update(pool_clips=3, clip_chunks=[16, 18],
                            warmup_clips=1, trace_chunks=8)
    else:
        cell.traffic.update(batch=6, pool_batches=2, warmup_calls=1,
                            trace_calls=2)
    return cell


def measure_cpu(cell, seed: int = 2**31 + 11, seconds: float = None,
                trace: bool = False):
    """A whole run of the tiny cell on the CPU. A stream's window is long
    enough for every model to serve scores (it serves from chunk 16 of a
    clip)."""
    import time
    from port_bench.run import measure
    if seconds is None:
        seconds = 4.0 if cell.traffic["entry"] == "stream" else 0.5
    return measure(cell, seed, seconds, trace, torch.device("cpu"),
                   time.perf_counter())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
