"""classifier.upload_span_ms.bulk: per bulk call, the device time of the
program's `nww.session.upload` span, in milliseconds: the embeddings' copy
back to the device in `_LocalSession.run_batch`, timed by the program's
events on the device's stream. From pageable memory the host stages the
copy, and the span's time includes the gaps where the device waits on
that."""

from port_bench import spans


def read(result):
    if result.kind != "bulk":
        return None
    return spans.per_unit_ms(spans.snapshot(), ("nww.session.upload",),
                             "nww.run_batch")
