"""classifier.device_ms.bulk: per bulk call, the kernels' device time inside
the harness's `port_bench.run_batch` range, in milliseconds: the
classifier's forward at batch."""


def read(result):
    t = result.trace
    if result.kind != "bulk" or t is None or not t.units:
        return None
    seconds = t.device_s(within="port_bench.run_batch")
    return seconds / t.units * 1e3 if seconds > 0 else None
