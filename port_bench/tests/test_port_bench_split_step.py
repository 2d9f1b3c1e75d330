"""The benchmark against a program whose captured step is split at the
cascade's gate: `stream.verifier_skip_pct` on a synthetic snapshot, and a
wrong score from the verifier's own call, planted under a whole run of
`crnn_stream` on the CPU, comes out as not correct."""

import numpy as np
import pytest

from port_bench import spans
from port_bench.run import metric_reader
from port_bench.tests.conftest import measure_cpu, tiny_cell
from port_bench.tests.test_port_bench_spans import (_bulk_trace, _result,
                                                    _stream_snapshot,
                                                    _stream_trace)


@pytest.mark.parametrize("counters,expected", [
    # a step split at the gate: runs + skipped = chunks
    ({"interpreter.chunks": 40, "interpreter.verifier_runs": 6,
      "interpreter.verifier_served": 6, "interpreter.verifier_skipped": 34},
     85.0),
    # a program whose step runs the verifier on every chunk has no counter
    ({"interpreter.chunks": 40, "interpreter.verifier_runs": 40,
      "interpreter.verifier_served": 6}, None),
    # a single model: no verifier runs or is skipped
    ({"interpreter.chunks": 40, "interpreter.verifier_runs": 0,
      "interpreter.verifier_served": 0, "interpreter.verifier_skipped": 0},
     None),
    # nothing streamed in the segment
    ({"interpreter.chunks": 0, "interpreter.verifier_skipped": 0}, None),
])
def test_verifier_skip_share(monkeypatch, counters, expected):
    snap = _stream_snapshot()
    snap.counters = counters
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    read = metric_reader("stream.verifier_skip_pct")
    assert read(_result("stream", _stream_trace())) == expected
    assert read(_result("bulk", _bulk_trace())) is None


def test_a_verifier_score_altered_is_caught(monkeypatch):
    """Every third score of the split verifier's call, 1% off: the gate's
    scores are untouched, and the run is not correct all the same. At a
    gate threshold of 0 the program and the reference both serve the
    verifier on every chunk past its window's warm-up, so that a busy CPU's
    few chunks hold some verifier calls too."""
    from nanowakeword_tpu_torch.interpreter.nanointerpreter import _FusedStep
    run_verifier = _FusedStep.run_verifier
    calls = []

    def altered(self):
        score = run_verifier(self)
        calls.append(1)
        if len(calls) % 3 == 0:
            score = np.float64(np.float32(score * 1.01))
        return score
    monkeypatch.setattr(_FusedStep, "run_verifier", altered)
    cell = tiny_cell("crnn_stream")
    cell.config["cascade"]["gate_threshold"] = 0.0
    cell.traffic.update(pool_clips=8, clip_chunks=[40, 50])
    result, line = measure_cpu(cell)
    assert len(calls) >= 3, len(calls)
    assert line["correct"] is False, line["checks"]
    assert line["failed"] > 0
