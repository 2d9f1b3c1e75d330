"""stream.host_ms_per_chunk: the window's mean wall time per chunk less the
device's busy time per chunk (from the traced segment), in milliseconds:
what the interpreter's host side adds to a chunk that the card does not
cover. The profiler slows the host, not the card, so the wall time comes
from the untraced window."""


def read(result):
    t = result.trace
    if result.kind != "stream" or t is None or not t.units or t.busy_s <= 0:
        return None
    return (result.window_s / result.units - t.busy_s / t.units) * 1e3
