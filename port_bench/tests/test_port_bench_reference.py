"""The comparison that decides `correct`, on the CPU at a tiny size: the
program agrees with the plain reference on both configurations and both
entries; the control (the reference one precision below) and the faults a
cell can have, planted under a whole run, come out as not correct; and the
generated audio reaches the encoder's weights."""

import numpy as np
import pytest
import torch

from port_bench import control, program
from port_bench.drivers import bulk, stream
from port_bench.reference import models as refmodels
from port_bench.tests.conftest import measure_cpu, tiny_cell

WORKLOADS = ["crnn_stream", "crnn_bulk_2s", "conformer_bulk_2s",
             "conformer_stream"]
CPU = torch.device("cpu")


def _enough(result) -> bool:
    """A stream serves scores from its 16th chunk; a bulk call scores all."""
    return result.units >= (16 if result.kind == "stream" else 1)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_program_agrees_with_the_reference(workload):
    result, line = measure_cpu(tiny_cell(workload))
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == result.units and _enough(result)
    assert line["failed"] == 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    cell = tiny_cell(workload)
    if cell.traffic["entry"] == "bulk":
        cell.traffic.update(batch=48, pool_batches=1)
    else:
        cell.traffic.update(pool_clips=24, clip_chunks=[16, 40])
    out = control.control_gap(cell, 2**31 + 3, CPU)
    assert out["score_gap"] > out["limit"], out


def test_the_audio_reaches_the_encoder():
    """Reference scores vary from clip to clip, in bulk and per chunk."""
    cell = tiny_cell("crnn_bulk_2s")
    cell.traffic.update(batch=8, pool_batches=1)
    weights = program.Weights(cell.config, 7, CPU)
    pool = bulk.make_pool(cell.traffic, 7, CPU)
    scores = bulk.reference_pool(cell.config, weights, pool, CPU,
                                 refmodels.REFERENCE)[0]
    logits = np.log(scores / (1 - scores))
    assert len(np.unique(np.round(logits, 3))) == len(logits)
    assert logits.std() > 0.1
    cell = tiny_cell("conformer_stream")
    weights = program.Weights(cell.config, 7, CPU)
    clips = dict(enumerate(stream.make_clips(cell.traffic, 7, CPU)))
    served = stream.reference_served(cell.config, weights, clips,
                                     cell.config["stream_models"], CPU,
                                     refmodels.REFERENCE, 1e-3)
    last = np.array([served[i][0][-1, 0] for i in clips])
    assert len(np.unique(np.round(last, 6))) == len(last)


def _not_correct(workload):
    result, line = measure_cpu(tiny_cell(workload))
    assert _enough(result)
    assert line["correct"] is False, line["checks"]
    assert line["failed"] > 0


@pytest.mark.parametrize("workload", ["crnn_stream", "conformer_stream"])
def test_a_step_that_keeps_its_state_is_caught(workload, monkeypatch):
    from nanowakeword_tpu_torch.data.features import AudioFeatures
    monkeypatch.setattr(AudioFeatures, "stream_step_",
                        lambda self, chunk: None)
    _not_correct(workload)


@pytest.mark.parametrize("workload", ["crnn_bulk_2s", "conformer_bulk_2s"])
def test_half_a_batch_left_out_is_caught(workload, monkeypatch):
    from nanowakeword_tpu_torch.interpreter.nanointerpreter import \
        _LocalSession
    run_batch = _LocalSession.run_batch

    def half(self, feats):
        kept = run_batch(self, feats[:len(feats) // 2])
        return np.concatenate([kept, np.full(len(feats) - len(kept),
                                             kept.mean(), kept.dtype)])
    monkeypatch.setattr(_LocalSession, "run_batch", half)
    _not_correct(workload)


@pytest.mark.parametrize("workload", ["crnn_bulk_2s", "conformer_bulk_2s"])
def test_a_bulk_answer_altered_is_caught(workload, monkeypatch):
    from nanowakeword_tpu_torch.interpreter.nanointerpreter import \
        _LocalSession
    run_batch = _LocalSession.run_batch

    def altered(self, feats):
        out = run_batch(self, feats).copy()
        out[1] = np.float32(out[1] * 1.01)
        return out
    monkeypatch.setattr(_LocalSession, "run_batch", altered)
    _not_correct(workload)


@pytest.mark.parametrize("workload", ["crnn_stream", "conformer_stream"])
def test_a_streamed_answer_altered_is_caught(workload, monkeypatch):
    from nanowakeword_tpu_torch.interpreter.nanointerpreter import _FusedStep
    run = _FusedStep.run
    calls = []

    def altered(self, chunk):
        out = run(self, chunk)
        calls.append(1)
        if len(calls) % 3 == 0:
            out = {k: np.float64(np.float32(v * 1.01)) for k, v in
                   out.items()}
        return out
    monkeypatch.setattr(_FusedStep, "run", altered)
    _not_correct(workload)
