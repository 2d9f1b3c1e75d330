"""What one run of a cell measured, as the metric readers see it."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from port_bench import trace as tracemod
from port_bench.flops import MelWork


@dataclass
class Result:
    kind: str                       # the traffic's entry: "stream", "bulk"
    setup_s: float                  # process start to the first timed call
    window_s: float                 # the measured window, host clock
    units: int                      # chunks or clips answered in the window
    calls: int                      # predict calls or bulk calls
    call_seconds: list              # host seconds of each call
    flops_per_unit: float           # model FLOPs of one chunk or clip
    trace: Optional[tracemod.Trace]
    memory_peak_bytes: int
    attempted: int                  # answers compared with the reference
    failed: int                     # of those, beyond the limit
    checks: dict                    # name -> {"value", "limit"}
    mel_work: Optional[MelWork] = None   # one call's log-mel (bulk)
    extra: dict = field(default_factory=dict)

    @property
    def units_per_s(self) -> float:
        return self.units / self.window_s


def traced(segment, units: int) -> tracemod.Trace:
    """Run `segment()` under the profiler inside a `port_bench.window`
    range; -> its Trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(tracemod.WINDOW):
            segment()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return tracemod.from_profiler(prof, units)
