"""encoder.device_ms.bulk: per bulk call, the kernels' device time inside the
harness's `port_bench.embed_clips` range less the mel kernel's, in
milliseconds: the encoder (and the small kernels around it).

The program has no span around its encoder yet, so the encoder is what is
left of the range once MEL_KERNEL (the mel kernel's symbol) and the copies
are taken out."""

MEL_KERNEL = "mel_frontend_kernel"


def read(result):
    t = result.trace
    if result.kind != "bulk" or t is None or not t.units:
        return None
    seconds = t.device_s(within="port_bench.embed_clips", exclude=MEL_KERNEL)
    return seconds / t.units * 1e3 if seconds > 0 else None
