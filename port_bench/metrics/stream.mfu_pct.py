"""stream.mfu_pct: the model FLOPs of a chunk (port_bench/flops.py, from
shapes) times the window's chunks per second, over the published dense
float32 peak of one H100 (67 TFLOP/s), in percent."""

from port_bench.flops import FP32_PEAK


def read(result):
    if result.kind != "stream" or result.trace is None:
        return None
    return 100.0 * result.flops_per_unit * result.units_per_s / FP32_PEAK
