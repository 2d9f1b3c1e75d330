"""bulk.copy_idle_ms: per bulk call of the traced segment, the device's
idle time while the host is inside one of the program's copy spans
(`nww.features.upload`, `nww.features.download`, `nww.session.upload`,
`nww.session.download`, the profiler's copies of them), in milliseconds:
the time the device waits on the host's side of a copy."""

from port_bench import spans
from port_bench.trace import US

COPIES = ("nww.features.upload", "nww.features.download",
          "nww.session.upload", "nww.session.download")


def read(result):
    t = result.trace
    if result.kind != "bulk" or t is None or not t.units or t.busy_s <= 0 \
            or not spans.host_us(t, COPIES):
        return None
    return spans.idle_inside_us(t, COPIES) * US / t.units * 1e3
