"""bulk.idle_pct: the share of the timed window in which nothing ran on the
device, in percent: one less the device's busy time per call (from the
traced segment: the union of every kernel, copy and memset) times the
window's calls, over the window's seconds. The profiler slows the host, not
the card, so the busy time comes from the trace and the wall time from the
untraced window."""


def read(result):
    t = result.trace
    if result.kind != "bulk" or t is None or not t.units or t.busy_s <= 0:
        return None
    busy = t.busy_s / t.units * result.calls
    return 100.0 * (1.0 - busy / result.window_s)
