"""One run of one benchmark cell: the command's arguments, the checks on the
machine, the cell's files, the metrics and the result line.

    python3 -m port_bench --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell is found by name in `BENCHMARK.json` at the root of the checkout
(the working directory): its configuration's file, its traffic mix
`port_bench/traffic/<traffic>.json` (whose "entry" names the driver,
`port_bench/drivers/<entry>.py`), its limits
`port_bench/limits/<workload>.json`, and one reader per metric,
`port_bench/metrics/<metric>.py`. With `--trace 0` the line carries the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics. The last
line of standard output is one JSON object; the compared numbers and their
limits close both that line and standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "nanowakeword_tpu")


class Refused(Exception):
    """The run cannot give a result; the message says why."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's nvcc builds already go to `build/nww_torch_kernels`);
    set before CUDA starts, which reads CUDA_CACHE_PATH."""
    cache = os.path.join(root, "build", "port_bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"


class Cell:
    """A workload of BENCHMARK.json with everything it names."""

    def __init__(self, spec: dict, workload: str, root: str):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise Refused(f"no workload '{workload}' in BENCHMARK.json")
        self.spec, self.workload = spec, cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = load_json(os.path.join(
            root, configs[self.workload["config"]]["file"]))
        self.traffic = load_json(os.path.join(
            HERE, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(HERE, "limits",
                                             workload + ".json"))["limits"]
        self.chips = int(self.workload["chips"])

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports: its end-to-end metrics, or
        with `trace` its per-layer metrics. A metric without a `workloads`
        key is reported where its moved metric is (per-layer) or
        everywhere (end-to-end)."""
        e2e = [m for m in self.spec["end_to_end"] if self._has(m)]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def metric_reader(name: str):
    """port_bench/metrics/<name>.py's `read(result)`."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Context:
    """What a driver needs: the cell, the run's arguments and the device."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float, workdir: str):
        self.config, self.traffic = cell.config, cell.traffic
        self.limits = cell.limits
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start, self.workdir = device, t_start, workdir
        self.marks = [("start", t_start)]

    def mark(self, name: str) -> None:
        """Note the end of a phase of the run (printed to standard error)."""
        self.marks.append((name, time.perf_counter()))

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.cuda:
            self.sync()
            torch.cuda.reset_peak_memory_stats(self.device)

    def memory_peak(self) -> int:
        if not self.cuda:
            return 0
        self.sync()
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        if self.cuda:
            torch.cuda.empty_cache()


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, t_ready: float = None):
    """Drive the cell on `device`; -> (Result, its result line as a
    dict). The caller has checked the device."""
    driver = importlib.import_module(
        "port_bench.drivers." + cell.traffic["entry"])
    with tempfile.TemporaryDirectory(prefix="port_bench_") as workdir:
        ctx = Context(cell, seed, seconds, trace, device, t_start, workdir)
        if t_ready is not None:
            ctx.marks.append(("imports", t_ready))
        result = driver.run(ctx)
        ctx.mark("reference")
    print("port_bench phases (s): " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(ctx.marks, ctx.marks[1:])),
        file=sys.stderr)
    print("port_bench " + window_profile(result), file=sys.stderr)
    metrics = {}
    for m in cell.metrics(trace):
        value = metric_reader(m["name"])(result)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = result.failed == 0 and result.attempted > 0 and all(
        c["value"] <= c["limit"] for c in result.checks.values())
    line = {"correct": correct, "attempted": result.attempted,
            "failed": result.failed, "metrics": metrics,
            "device": device_info(device, result)}
    if trace and result.trace is not None:
        line["breakdown"] = result.trace.breakdown()
    line["checks"] = result.checks
    return result, line


def window_profile(result) -> str:
    """The window's calls on the host clock, for standard error: quantiles
    of a call's seconds, the share of the window inside calls, and the
    calls finished in each second of the window."""
    t = np.asarray(result.call_seconds) * 1e3
    ends = np.asarray(result.extra.get("call_ends", ()))
    per_s = np.bincount(ends.astype(int)) if len(ends) else []
    q = np.percentile(t, [5, 50, 95, 99]) if len(t) else []
    return (f"call ms p5/p50/p95/p99 {np.round(q, 4).tolist()} mean "
            f"{t.mean():.4f} max {t.max():.3f}; in calls "
            f"{t.sum() / 1e3 / result.window_s:.4f} of the window; calls a "
            f"second {list(map(int, per_s))}")


def device_info(device, result) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = result.memory_peak_bytes
    if result.trace is not None:
        info["busy_s"] = result.trace.busy_s
        info["window_s"] = result.trace.window_s
    return info


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    parser = argparse.ArgumentParser(prog="python3 -m port_bench")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = os.getcwd()
    stdout = sys.stdout
    try:
        cell = Cell(load_json(os.path.join(root, "BENCHMARK.json")),
                    args.workload, root)
        _cache_env(root)
        if not torch.cuda.is_available():
            raise Refused("no CUDA device")
        torch.cuda.init()
        t_ready = time.perf_counter()
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"the cell needs {cell.chips} cards, "
                          f"{torch.cuda.device_count()} found")
        torch.set_num_threads(4)
        # the program's own messages go to standard error
        with contextlib.redirect_stdout(sys.stderr):
            result, line = measure(cell, args.seed, args.seconds,
                                   bool(args.trace), torch.device("cuda:0"),
                                   t_start, t_ready)
    except (Refused, ImportError, FileNotFoundError) as e:
        print(f"port_bench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), file=stdout, flush=True)
    return 0
