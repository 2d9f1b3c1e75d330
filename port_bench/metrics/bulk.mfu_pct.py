"""bulk.mfu_pct: the model FLOPs of a clip (port_bench/flops.py, from
shapes: log-mel, encoder, classifier) times the window's clips per second,
over the published dense float32 peak of one H100 (67 TFLOP/s), in
percent."""

from port_bench.flops import FP32_PEAK


def read(result):
    if result.kind != "bulk" or result.trace is None:
        return None
    return 100.0 * result.flops_per_unit * result.units_per_s / FP32_PEAK
