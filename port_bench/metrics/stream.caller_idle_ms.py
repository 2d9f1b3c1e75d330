"""stream.caller_idle_ms: per chunk of the traced segment, the device's idle
time while the host is outside every `predict` call, in milliseconds: the
gaps of the device trace that no `nww.predict` span (the profiler's copy
of the program's root span) covers. It is the idle time the caller's own
loop adds between chunks, as against the interpreter's."""

from port_bench import spans
from port_bench.trace import US, union_us


def read(result):
    t = result.trace
    if result.kind != "stream" or t is None or not t.units or t.busy_s <= 0 \
            or not spans.host_us(t, ("nww.predict",)):
        return None
    idle = union_us(spans.idle_us(t))
    inside = spans.idle_inside_us(t, ("nww.predict",))
    return (idle - inside) * US / t.units * 1e3
