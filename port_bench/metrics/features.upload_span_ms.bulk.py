"""features.upload_span_ms.bulk: per bulk call, the device time of the
program's `nww.features.upload` span, in milliseconds: the clips' copy from
pinned host memory to the device, timed by the program's events on the
device's stream. The span's time includes any gap where the device waits
on the host inside it."""

from port_bench import spans


def read(result):
    if result.kind != "bulk":
        return None
    return spans.per_unit_ms(spans.snapshot(), ("nww.features.upload",),
                             "nww.embed_clips")
