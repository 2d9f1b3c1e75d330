"""encoder.span_ms.bulk: per bulk call, the device time of the program's
`nww.features.encoder` span, in milliseconds: the speech encoder on the
batch's log-mel, timed by the program's events on the device's stream.
The span's time includes any gap where the device waits on the host's
launches inside it."""

from port_bench import spans


def read(result):
    if result.kind != "bulk":
        return None
    return spans.per_unit_ms(spans.snapshot(), ("nww.features.encoder",),
                             "nww.embed_clips")
