"""The readers of the program's spans and counters (port_bench/spans.py and
the metrics that use it) on a synthetic Result, trace and snapshot, and
their silence where the program has no tracer."""

import sys

import pytest

from port_bench import spans
from port_bench import trace as tracemod
from port_bench.result import Result
from port_bench.run import metric_reader

STREAM = ["stream.step_span_ms", "stream.caller_idle_ms",
          "stream.verifier_useful_pct"]
BULK = ["features.upload_span_ms.bulk", "features.download_span_ms.bulk",
        "classifier.upload_span_ms.bulk", "mel.span_roofline_pct.bulk",
        "encoder.span_ms.bulk", "classifier.span_ms.bulk",
        "bulk.copy_idle_ms"]


class Work:
    def least_seconds(self):
        return 0.5e-3


def _result(kind, trace):
    return Result(kind=kind, setup_s=1.0, window_s=1.0, units=2, calls=2,
                  call_seconds=[0.5, 0.5], flops_per_unit=1.0, trace=trace,
                  memory_peak_bytes=0, attempted=1, failed=0, checks={},
                  mel_work=Work() if kind == "bulk" else None)


def _snapshot(rows, counters=None):
    """rows: (id, name, parent, host ms or None, device ms or None)."""
    from nanowakeword_tpu_torch.utils.tracing import Snapshot, SpanRecord
    records = [SpanRecord(i, name, parent, 0, {},
                          None if host is None else 0,
                          None if host is None else int(host * 1e6), dev)
               for i, name, parent, host, dev in rows]
    return Snapshot(records, dict(counters or {}))


def _stream_snapshot():
    rows = []
    for c in range(2):              # two chunks
        b = 10 * c
        rows += [(b, "nww.predict", None, 1.0, None),
                 (b + 1, "nww.predict.upload", b, 0.02, None),
                 (b + 2, "nww.step.replay", b, 0.03 + 0.01 * c, 0.9 + c),
                 (b + 3, "nww.predict.readback", b, 0.8, None),
                 (b + 4, "nww.predict.rules", b, 0.04, None)]
    return _snapshot(rows, {"interpreter.verifier_runs": 8,
                            "interpreter.verifier_served": 2})


def _stream_trace():
    # the device busy 10-20, 47-49 and 50-60 of a 0-100 window, idle 78;
    # predict spans on the host 5-30 and 45-70 cover 5-10, 20-30, 45-47,
    # 49-50 and 60-70 of it (28): the caller's loop leaves the device idle
    # for 50. The steps' kernels: 10-16 and 15-18 (the chunk's upload 18-20
    # is a copy), then 47-49 and 50-60 in the second chunk's window, from
    # the first readback's end (25) to its own (65): the kernel at 47-49
    # reads as starting before its replay (49), as a device clock a little
    # off the host's would show it
    return tracemod.Trace(
        device=[(10, 16, "k"), (15, 18, "k"), (18, 20, "Memcpy HtoD"),
                (47, 49, "k"), (50, 60, "k")],
        host=[(5, 30, "nww.predict"), (9, 11, "nww.step.replay"),
              (11, 25, "nww.predict.readback"), (45, 70, "nww.predict"),
              (49, 50, "nww.step.replay"),
              (50, 65, "nww.predict.readback"), (0, 100, "other")],
        ranges={tracemod.WINDOW: [(0, 100)]}, units=2)


def _bulk_snapshot():
    rows = []
    for c in range(2):              # two calls
        b = 20 * c
        rows += [(b, "nww.embed_clips", None, 50.0, None),
                 (b + 1, "nww.features.upload", b, 5.0, 5.0 + c),
                 (b + 2, "nww.features.mel", b, 0.1, 1.0),
                 (b + 3, "nww.features.encoder", b, 0.1, 6.0),
                 (b + 4, "nww.features.download", b, 12.0, 12.0),
                 (b + 10, "nww.run_batch", None, 20.0, None),
                 (b + 11, "nww.session.upload", b + 10, 4.0, 4.0),
                 (b + 12, "nww.session.forward", b + 10, 0.5, 5.5),
                 (b + 13, "nww.session.download", b + 10, 0.1, 0.1)]
    return _snapshot(rows)


def _bulk_trace():
    # busy 0-40 and 60-100; the host inside copies 30-70 and 95-100
    return tracemod.Trace(
        device=[(0, 40, "k"), (60, 100, "Memcpy")],
        host=[(30, 50, "nww.features.upload"),
              (50, 70, "nww.features.download"),
              (95, 100, "nww.session.upload"), (0, 100, "other")],
        ranges={tracemod.WINDOW: [(0, 100)]}, units=2)


def test_stream_readers(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", _stream_snapshot)
    result = _result("stream", _stream_trace())
    got = {name: metric_reader(name)(result) for name in STREAM}
    assert got == pytest.approx({
        "stream.step_span_ms": (8 + 12) * 1e-3 / 2,
        "stream.caller_idle_ms": (80 - 30) * 1e-3 / 2,
        "stream.verifier_useful_pct": 25.0})
    for name in BULK:
        assert metric_reader(name)(result) is None, name


def test_bulk_readers(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", _bulk_snapshot)
    result = _result("bulk", _bulk_trace())
    got = {name: metric_reader(name)(result) for name in BULK}
    assert got == pytest.approx({
        "features.upload_span_ms.bulk": 5.5,
        "features.download_span_ms.bulk": 12.0,
        "classifier.upload_span_ms.bulk": 4.0,
        "mel.span_roofline_pct.bulk": 100 * 0.5e-3 / 1e-3,
        "encoder.span_ms.bulk": 6.0,
        "classifier.span_ms.bulk": 5.5,
        "bulk.copy_idle_ms": 20 * 1e-3 / 2})
    for name in STREAM:
        assert metric_reader(name)(result) is None, name


def test_a_span_without_its_device_time_reads_nothing():
    snap = _snapshot([(0, "nww.embed_clips", None, 1.0, None),
                      (1, "nww.features.mel", 0, 0.1, None),
                      (2, "nww.features.encoder", 0, 0.1, 2.0)])
    assert spans.per_unit_ms(snap, ("nww.features.mel",),
                             "nww.embed_clips") is None
    assert spans.per_unit_ms(snap, ("nww.features.encoder",),
                             "nww.embed_clips") == 2.0
    assert spans.per_unit_ms(snap, ("nww.features.encoder",),
                             "nww.run_batch") is None


def test_a_program_without_the_tracer_leaves_every_metric_out(monkeypatch):
    """A checkout whose program has no tracer (the module is missing) gives
    no snapshot and no `nww.*` events in the trace, and no reader raises."""
    monkeypatch.setitem(sys.modules, "nanowakeword_tpu_torch.utils.tracing",
                        None)
    assert spans.snapshot() is None
    for kind, trace in (("stream", _stream_trace()),
                        ("bulk", _bulk_trace())):
        trace.host = [h for h in trace.host if not h[2].startswith("nww.")]
        result = _result(kind, trace)
        for name in STREAM + BULK:
            assert metric_reader(name)(result) is None, name
