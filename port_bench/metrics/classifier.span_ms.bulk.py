"""classifier.span_ms.bulk: per bulk call, the device time of the program's
`nww.session.forward` span, in milliseconds: the classifier's forward and
its sigmoid at batch, timed by the program's events on the device's stream.
The span's time includes the host-paced gaps between the forward's
kernels, where the device waits on the host's launches (an eager model's
many small kernels), so it reads above the kernels' own busy time
(`classifier.device_ms.bulk`)."""

from port_bench import spans


def read(result):
    if result.kind != "bulk":
        return None
    return spans.per_unit_ms(spans.snapshot(), ("nww.session.forward",),
                             "nww.run_batch")
