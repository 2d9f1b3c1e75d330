"""mel.span_roofline_pct.bulk: the least time for a call's log-mel on one
H100 (port_bench/flops.py::mel_work: the larger of its bytes at 3.35 TB/s
and its operations at their type's peak) over the device time of the
program's `nww.features.mel` span per call, in percent. On the kernel's
path the span holds the kernel's launch alone (ops/mel_cuda.py), so its
time is the kernel's and the launch's latency, in which the device waits
on the host; it reads a little under `mel.roofline_pct.bulk`, whose time
is the kernel's alone."""

from port_bench import spans


def read(result):
    if result.kind != "bulk" or result.mel_work is None:
        return None
    ms = spans.per_unit_ms(spans.snapshot(), ("nww.features.mel",),
                           "nww.embed_clips")
    if not ms:
        return None
    return 100.0 * result.mel_work.least_seconds() / (ms * 1e-3)
