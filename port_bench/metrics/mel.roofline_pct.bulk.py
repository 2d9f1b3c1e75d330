"""mel.roofline_pct.bulk: the least time for a call's log-mel on one H100
(port_bench/flops.py::mel_work: the larger of its bytes at 3.35 TB/s and
its operations at their type's peak) over the mel kernel's device time per
call, in percent.

The program has no span around its mel yet, so the kernel is found by its
symbol, MEL_KERNEL, in the device trace; a later change that adds a span
points this reader at it instead."""

MEL_KERNEL = "mel_frontend_kernel"


def read(result):
    t = result.trace
    if result.kind != "bulk" or t is None or not t.units \
            or result.mel_work is None:
        return None
    seconds = t.device_s(name=MEL_KERNEL) / t.units
    if seconds <= 0:
        return None
    return 100.0 * result.mel_work.least_seconds() / seconds
