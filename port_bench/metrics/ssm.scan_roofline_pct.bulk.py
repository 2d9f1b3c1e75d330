"""ssm.scan_roofline_pct.bulk: the least time of the program's `nww.ssm.scan`
spans on one H100 over their device time, in percent. Each span's least
time is `reference/families/granite_hybrid.py::ssd_work` of its attrs
(batch, length, heads, head_dim, state, groups, chunk): the larger of the
chunked algorithm's operations at the float32 peak (67 TFLOP/s) and its
bytes (x, B, C and the step sizes read, y written once) at 3.35 TB/s. The
span's time counts the gaps where the card waits on the host's launches.
None for a program or a model without such spans."""

from port_bench import spans
from port_bench.reference.families.granite_hybrid import ssd_work


def read(result):
    snap = spans.snapshot()
    if result.kind != "bulk" or snap is None:
        return None
    scans = snap.named("nww.ssm.scan")
    if not scans or any(s.device_ms is None for s in scans):
        return None
    least = sum(ssd_work(**s.attrs).least_seconds() for s in scans)
    return 100.0 * least / (sum(s.device_ms for s in scans) * 1e-3)
