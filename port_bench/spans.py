"""The program's own spans and counters, as the per-layer metrics read them.

The program (`nanowakeword_tpu_torch/utils/tracing.py`) keeps a span at
each layer boundary while a `torch.profiler` records, so the traced
segment of a `--trace 1` run is one tracing session: `snapshot()` gives its
spans (host interval, device time from the program's timing events) and
its counters' changes. The same spans appear in the profiler's trace as
host events named `nww.*`, on the clock of the device's activity, which is
how idle time on the device is put down to the host stage behind it.

A program without the tracer (or one that recorded nothing) gives no
snapshot, and every reader then returns None: the metric is left out.
"""

from __future__ import annotations

import bisect
import importlib

from port_bench.trace import is_kernel, union_us


def snapshot():
    """The program's last tracing session, or None."""
    try:
        tracing = importlib.import_module(
            "nanowakeword_tpu_torch.utils.tracing")
    except ImportError:
        return None
    snap = tracing.snapshot()
    return snap if snap.spans else None


def per_unit_ms(snap, names, per: str):
    """The summed device milliseconds of the spans named in `names`, over
    the number of spans named `per`; None when there is none of either, or
    when one of them has no device time. A span's device time runs from its
    start event to its end event on the stream, so it counts the idle gaps
    inside the span where the device waits on the host."""
    units = len(snap.named(per)) if snap is not None else 0
    spans = [s for s in snap.spans if s.name in names] if units else []
    times = [s.device_ms for s in spans]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / units


def idle_us(trace) -> list:
    """The intervals of the traced window in which nothing ran on the
    device, in the trace's microseconds."""
    a, b = trace.window
    gaps, end = [], a
    for s, e in sorted((max(s, a), min(e, b)) for s, e, _ in trace.device
                       if e > a and s < b):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if b > end:
        gaps.append((end, b))
    return gaps


def host_us(trace, names) -> list:
    """The host intervals of the profiler's copies of the program's spans
    named in `names`."""
    return [(s, e) for s, e, n in trace.host if n in names]


def idle_inside_us(trace, names) -> float:
    """Microseconds of device idle time while the host is inside one of
    the spans named in `names`."""
    hosts = host_us(trace, names)
    within = [(max(a, s), min(b, e)) for a, b in idle_us(trace)
              for s, e in hosts if s < b and e > a]
    return union_us(within)


def step_kernels_ms(trace):
    """The kernels' busy milliseconds per chunk in the windows that tile
    the chunks: from the first `nww.step.replay` span's start to the end of
    the `nww.predict.readback` span after it, then from each readback's end
    to the next one's. A chunk's kernels are launched after the previous
    chunk's readback has returned and finish before its own readback ends,
    so each falls in its chunk's window; and tiled windows count every
    kernel once even where the trace's device clock sits a little off its
    host clock. None without such pairs."""
    replays = sorted(s for s, _ in host_us(trace, ("nww.step.replay",)))
    readbacks = sorted(e for _, e in host_us(trace,
                                             ("nww.predict.readback",)))
    if not replays or len(replays) != len(readbacks):
        return None
    kernels = sorted((s, e) for s, e, n in trace.device if is_kernel(n))
    starts = [s for s, _ in kernels]
    inside = kernels[bisect.bisect_left(starts, replays[0]):
                     bisect.bisect_left(starts, readbacks[-1])]
    return union_us(inside) * 1e-3 / len(replays)
