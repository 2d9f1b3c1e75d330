"""attention.span_ms.bulk: per bulk call, the device time of the program's
`nww.attention.core` spans, in milliseconds: Q K^T, the causal mask, the
softmax and A V of every attention layer of the Granite hybrid, timed by
the program's events on the device's stream (the projections are outside).
None for a program or a model without them."""

from port_bench import spans


def read(result):
    if result.kind != "bulk":
        return None
    return spans.per_unit_ms(spans.snapshot(), ("nww.attention.core",),
                             "nww.run_batch")
