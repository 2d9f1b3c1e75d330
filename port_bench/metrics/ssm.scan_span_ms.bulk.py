"""ssm.scan_span_ms.bulk: per bulk call, the device time of the program's
`nww.ssm.scan` spans, in milliseconds: every Mamba-2 mixer's SSD scan, from
its step sizes, x, B and C to y before the gate, timed by the program's
events on the device's stream. None for a program or a model without
them."""

from port_bench import spans


def read(result):
    if result.kind != "bulk":
        return None
    return spans.per_unit_ms(spans.snapshot(), ("nww.ssm.scan",),
                             "nww.run_batch")
