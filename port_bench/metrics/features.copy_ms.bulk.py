"""features.copy_ms.bulk: host<->device copy time per bulk call in the
traced segment (every Memcpy the profiler saw: the clips' upload, the
features' download and upload, the scores' download), in milliseconds."""

from port_bench.trace import is_copy


def read(result):
    t = result.trace
    if result.kind != "bulk" or t is None or not t.units:
        return None
    copies = t.device_s(keep=is_copy)
    return copies / t.units * 1e3 if copies > 0 else None
