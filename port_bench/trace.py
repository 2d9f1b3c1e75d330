"""The device trace of a traced segment, reduced to what the per-layer
metrics read.

The harness brackets its own calls into the program with
`torch.profiler.record_function` ranges named `port_bench.<call>` and the
whole traced segment with `port_bench.window`; the program has no spans of
its own yet. The profiler (CUPTI on the card) gives every kernel, copy and
memset that ran on the device, on the host's clock. Because each bracketed
call ends by copying its result to the host, everything that a call
enqueued has finished before its range ends, so the device events that
start inside a range are that call's.

Busy time is the union of the device events' intervals inside the window
(the arithmetic of the program's `tools/profile_train_step.py`, copied).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

PREFIX = "port_bench."
WINDOW = PREFIX + "window"
US = 1e-6


def union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


@dataclass
class Trace:
    """Events of one traced segment, times in microseconds."""
    device: list                    # (start, end, name), sorted by start
    host: list                      # (start, end, name) of host events
    ranges: dict = field(default_factory=dict)   # name -> [(start, end)]
    units: int = 0                  # chunks or calls in the segment

    @property
    def window(self):
        return self.ranges[WINDOW][0]

    @property
    def window_s(self) -> float:
        a, b = self.window
        return (b - a) * US

    def _in_window(self):
        a, b = self.window
        return [(max(s, a), min(e, b)) for s, e, _ in self.device
                if e > a and s < b]

    @property
    def busy_s(self) -> float:
        return union_us(self._in_window()) * US

    def device_s(self, within: str = None, keep=is_kernel,
                 name: str = None, exclude: str = None) -> float:
        """Summed seconds of the device events that `keep` accepts, whose
        name contains `name` (if given) and not `exclude` (if given), and
        which start inside a `within` range (if given; else the window)."""
        spans = self.ranges[within] if within else [self.window]
        starts = [s for s, _, _ in self.device]
        total = 0.0
        for a, b in spans:
            lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(
                starts, b)
            for s, e, n in self.device[lo:hi]:
                if keep(n) and (name is None or name in n) and \
                        (exclude is None or exclude not in n):
                    total += e - s
        return total * US

    def range_s(self, name: str) -> float:
        return sum(b - a for a, b in self.ranges.get(name, ())) * US

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, by name, and the
        longest idle gaps on the device, each named by the innermost host
        event open at its start."""
        by_name: dict = {}
        for s, e, n in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s) * US
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        a, b = self.window
        gaps, end = [], a
        for s, e in sorted(self._in_window()):
            if s > end:
                gaps.append((s - end, end))
            end = max(end, e)
        if b > end:
            gaps.append((b - end, end))
        gaps = sorted(gaps, reverse=True)[:top]
        return {"device_ops": [[n[:96], t] for n, t in ops],
                "idle_gaps": [[self.host_at(t0), g * US] for g, t0 in gaps]}

    def host_at(self, t: float) -> str:
        best = None
        for s, e, n in self.host:
            if s > t:
                break
            if e > t and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        return best[2][:96] if best else "no_host_event"


def from_profiler(prof, units: int) -> Trace:
    """Reduce a finished `torch.profiler.profile` to a Trace."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host, ranges = [], [], {}
    for e in prof.events():
        s, t, n = e.time_range.start, e.time_range.end, e.name
        if n.startswith(PREFIX):
            if e.device_type != cuda:
                ranges.setdefault(n, []).append((s, t))
            continue
        if e.device_type == cuda:
            device.append((s, t, n))
        else:
            host.append((s, t, n))
    device.sort()
    host.sort()
    for spans in ranges.values():
        spans.sort()
    return Trace(device=device, host=host, ranges=ranges, units=units)
