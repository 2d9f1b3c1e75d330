"""features.download_span_ms.bulk: per bulk call, the device time of the
program's `nww.features.download` span, in milliseconds: the embeddings'
copy to pageable host memory (`.cpu().numpy()`), timed by the program's
events on the device's stream. The host stages a pageable copy, and the
span's time includes the gaps where the device waits on that."""

from port_bench import spans


def read(result):
    if result.kind != "bulk":
        return None
    return spans.per_unit_ms(spans.snapshot(), ("nww.features.download",),
                             "nww.embed_clips")
