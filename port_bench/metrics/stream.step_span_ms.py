"""stream.step_span_ms: the device time of the captured step per chunk, in
milliseconds: the busy time of the kernels in the profiler's trace from
the start of the first `nww.step.replay` span of the traced segment (the
graph's launch) to the end of its last `nww.predict.readback` span (the
scores on the host), over the chunks; each chunk's kernels lie between the
previous chunk's readback and its own (port_bench/spans.py::
step_kernels_ms). The chunk's upload and the scores' copies are not
kernels, so they are left out.

The span's own device time, from timing events around the launch, is not
used: under a profiler, whose tracing of a replayed graph's nodes submits
them from the host, a replay that finds the device idle stretches between
its first and last node, while the kernels' own durations in the trace do
not."""

from port_bench import spans


def read(result):
    t = result.trace
    if result.kind != "stream" or t is None or t.busy_s <= 0:
        return None
    return spans.step_kernels_ms(t)
