"""The `granite_bulk_42s` cell: its files are found, its counts equal hand
counts, and at a tiny size on the CPU the program agrees with the reference
while the control does not, nor a program whose scan drops the state passed
between chunks. A card test streams two clips through the captured step at
the configuration's published widths.

At the cell's own size the check does not see a dropped passed state: the
seeded steps and A (program.py draws them 0.1 normal) forget a state within
a few frames of a 256-frame chunk. tests/test_torch_granite_hybrid.py
checks the passed state at the published scan widths with Mamba-2's draws
instead."""

import numpy as np
import pytest
import torch

from port_bench import control, flops, program
from port_bench.drivers import stream
from port_bench.reference import models as refmodels
from port_bench.reference.families import granite_hybrid
from port_bench.run import Cell, metric_reader
from port_bench.tests.conftest import ROOT, measure_cpu, spec, tiny_cell

CELL = "granite_bulk_42s"
METRICS = ["ssm.scan_span_ms.bulk", "ssm.scan_roofline_pct.bulk",
           "attention.span_ms.bulk"]
TINY = {"granite_d_model": 64, "granite_intermediate_size": 96,
        "granite_mamba_d_state": 16, "granite_mamba_n_heads": 8,
        "granite_mamba_d_head": 16, "granite_mamba_chunk_size": 8,
        "granite_attention_heads": 4, "granite_kv_heads": 2,
        "granite_layer_types": ["mamba", "mamba", "attention", "mamba"],
        "n_blocks": 4, "input_shape": [16, 96]}
BULK_LAYERS = ["bulk.mfu_pct", "bulk.idle_pct", "classifier.span_ms.bulk",
               "classifier.device_ms.bulk", "classifier.upload_span_ms.bulk",
               "features.copy_ms.bulk", "features.upload_span_ms.bulk",
               "features.download_span_ms.bulk", "mel.roofline_pct.bulk",
               "mel.span_roofline_pct.bulk", "encoder.device_ms.bulk",
               "encoder.span_ms.bulk", "bulk.copy_idle_ms"]
CPU = torch.device("cpu")


def _tiny_cell():
    """The cell at d = 64 on 2 s clips (16 frames, two scan chunks of 8)."""
    cell = tiny_cell(CELL)
    cell.config["models"]["granite4_h_micro"].update(TINY)
    cell.traffic["clip_samples"] = 32000
    return cell


def test_the_cell_traffic_limits_and_metrics_are_files():
    s = spec()
    cell = Cell(s, CELL, ROOT)
    assert cell.traffic["entry"] == "bulk" and cell.chips == 1
    assert "score_gap" in cell.limits
    reported = {m["name"] for m in cell.metrics(False)}
    assert reported == {"setup_s", "bulk_clips_per_s"}
    layer = {m["name"] for m in cell.metrics(True)}
    assert set(METRICS) <= layer
    assert set(BULK_LAYERS) <= layer
    for name in reported | layer:
        assert callable(metric_reader(name))
    model = cell.config["models"]["granite4_h_micro"]
    assert model["granite_layer_types"] == cell.config["layer_types"]
    assert model["granite_layer_types"][5] == "attention"
    assert model["granite_layer_types"].count("mamba") == 9


def test_the_configuration_keeps_the_published_widths():
    config = Cell(spec(), CELL, ROOT).config
    model = config["models"]["granite4_h_micro"]
    pairs = {"hidden_size": "granite_d_model",
             "shared_intermediate_size": "granite_intermediate_size",
             "mamba_d_state": "granite_mamba_d_state",
             "mamba_d_conv": "granite_mamba_d_conv",
             "mamba_expand": "granite_mamba_expand",
             "mamba_n_heads": "granite_mamba_n_heads",
             "mamba_d_head": "granite_mamba_d_head",
             "mamba_n_groups": "granite_mamba_n_groups",
             "mamba_chunk_size": "granite_mamba_chunk_size",
             "num_attention_heads": "granite_attention_heads",
             "num_key_value_heads": "granite_kv_heads",
             "attention_multiplier": "granite_attention_multiplier",
             "residual_multiplier": "granite_residual_multiplier",
             "embedding_multiplier": "granite_embedding_multiplier",
             "rms_norm_eps": "granite_rms_norm_eps"}
    for published, key in pairs.items():
        assert model[key] == config[published], key
    assert config["num_hidden_layers"] == model["n_blocks"] == 10
    assert model["input_shape"] == [512, 96]


def test_ssd_work_and_flops_equal_hand_counts():
    w = granite_hybrid.ssd_work(2, 20, 8, 16, 16, 1, 8)
    # chunks of 8, 8 and 4 positions
    macs = sum(16 * q * q + 8 * q * q * 16 + 2 * 8 * q * 16 * 16
               for q in (8, 8, 4))
    assert w.operations == 2 * 2 * macs
    assert w.bytes == 4 * 40 * (2 * 8 * 16 + 2 * 16 + 8)
    assert w.least_seconds() == max(w.bytes / flops.HBM_BYTES_PER_S,
                                    w.operations / flops.FP32_PEAK)
    assert (granite_hybrid.FP32_PEAK, granite_hybrid.HBM_BYTES_PER_S) == \
        (flops.FP32_PEAK, flops.HBM_BYTES_PER_S)
    model = _tiny_cell().config["models"]["granite4_h_micro"]
    t, d, m, conv = 16, 64, 96, 128 + 32
    scan = granite_hybrid.ssd_work(1, 16, 8, 16, 16, 1, 8).operations
    mamba = t * d * (128 + conv + 8) + t * conv * 4 + t * 128 * d
    attention = t * d * (2 * d + 2 * 2 * 16) + 2 * t * t * 4 * 16
    mlp = t * 3 * d * m
    macs = t * 96 * d + d * 96 + 3 * mamba + attention + 4 * mlp
    assert granite_hybrid.flops(model) == 2 * macs + 3 * scan
    # the published period: 4.26 MFLOP a frame for each scan at T = 512
    full = Cell(spec(), CELL, ROOT).config["models"]["granite4_h_micro"]
    one = granite_hybrid.ssd_work(1, 512, 64, 64, 128, 1, 256)
    assert one.operations / 512 == 4259840
    assert 1.49e9 < (granite_hybrid.flops(full) - 9 * one.operations) / 512 \
        < 1.50e9


def test_the_tiny_cell_agrees_with_the_reference():
    result, line = measure_cpu(_tiny_cell())
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == result.units > 0


def test_the_control_is_not_correct_at_the_tiny_size():
    cell = _tiny_cell()
    cell.traffic.update(batch=48, pool_batches=1)
    out = control.control_gap(cell, 2**31 + 3, CPU)
    assert out["score_gap"] > out["limit"], out


def _drop_the_passed_state(monkeypatch):
    """Plant a fault in the state passed between chunks: the program's
    scan starts every chunk from the zero state, as a scan kernel that lost
    its carry would."""
    from nanowakeword_tpu_torch.models import architectures
    scan = architectures.ssd_chunked

    def restarted(x, dt, a, b, c, chunk):
        cut = lambda v, i: v[:, i:i + chunk]              # noqa: E731
        return torch.cat([scan(cut(x, i), cut(dt, i), a, cut(b, i),
                               cut(c, i), chunk)
                          for i in range(0, x.shape[1], chunk)], 1)
    monkeypatch.setattr(architectures, "ssd_chunked", restarted)


def test_a_state_dropped_between_chunks_is_caught(monkeypatch):
    _drop_the_passed_state(monkeypatch)
    result, line = measure_cpu(_tiny_cell())
    assert line["attempted"] > 0
    assert line["correct"] is False, line["checks"]


def test_the_new_readers_read_spans_and_stay_silent_without_them(
        monkeypatch):
    from nanowakeword_tpu_torch.utils.tracing import Snapshot, SpanRecord
    from port_bench import spans
    from port_bench.result import Result
    attrs = {"batch": 128, "length": 512, "heads": 64, "head_dim": 64,
             "state": 128, "groups": 1, "chunk": 256}
    rows = [SpanRecord(0, "nww.run_batch", None, 0, {}),
            SpanRecord(1, "nww.ssm.scan", 0, 0, dict(attrs), 0, 1, 8.0),
            SpanRecord(2, "nww.ssm.scan", 0, 0, dict(attrs), 0, 1, 10.0),
            SpanRecord(3, "nww.attention.core", 0, 0, {}, 0, 1, 3.0)]
    result = Result(kind="bulk", setup_s=1.0, window_s=1.0, units=2,
                    calls=1, call_seconds=[1.0], flops_per_unit=1.0,
                    trace=None, memory_peak_bytes=0, attempted=1, failed=0,
                    checks={})
    monkeypatch.setattr(spans, "snapshot", lambda: Snapshot(rows, {}))
    least = granite_hybrid.ssd_work(**attrs).least_seconds()
    assert metric_reader("ssm.scan_span_ms.bulk")(result) == 18.0
    assert metric_reader("attention.span_ms.bulk")(result) == 3.0
    assert metric_reader("ssm.scan_roofline_pct.bulk")(result) == \
        pytest.approx(100 * 2 * least / 18e-3)
    monkeypatch.setattr(spans, "snapshot", lambda: None)
    for name in METRICS:
        assert metric_reader(name)(result) is None


@pytest.mark.gpu
def test_two_clips_stream_through_the_captured_step_at_published_widths(
        cuda, tmp_path):
    """Window 16 (one scan chunk), the configuration's widths and weights;
    every served score against the reference, within the cell's limit."""
    config = Cell(spec(), CELL, ROOT).config
    config["models"]["granite4_h_micro"]["input_shape"] = [16, 96]
    weights = program.Weights(config, 2**31 + 17, cuda, str(tmp_path))
    traffic = {"clip_chunks": [20, 24], "pool_clips": 2,
               "audio": Cell(spec(), CELL, ROOT).traffic["audio"]}
    clips = dict(enumerate(stream.make_clips(traffic, 2**31 + 17, cuda)))
    interp = program.stream_interpreter(config, weights, cuda)
    assert interp._fused_step.graph is not None
    served = [(i, stream._stream(interp, clips[i], ["granite4_h_micro"])[0])
              for i in clips]
    del interp
    want = stream.reference_served(config, weights, clips,
                                   ["granite4_h_micro"], cuda,
                                   refmodels.REFERENCE, 1e-3)
    gaps = stream.chunk_gaps(config, ["granite4_h_micro"], served, want)
    limit = Cell(spec(), CELL, ROOT).limits["score_gap"]
    assert len(gaps) == sum(len(c) // 1280 for c in clips.values())
    assert gaps.max() < limit, gaps.max()
    assert np.ptp([want[i][0][-1, 0] for i in clips]) > 0

