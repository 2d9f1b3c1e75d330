"""The port's tracer (nanowakeword_tpu_torch/utils/tracing.py) on the CPU:
spans off by default while the counters count, the span tree of the
streaming and bulk paths inside `tracing.recording()`, the spans' copies
under a `torch.profiler`, the cascade's verifier counters against a hand
count, the old counter names, the replay helper and the bounded store."""

import collections
import os

import numpy as np
import pytest
import torch

from nanowakeword_tpu_torch import AudioFeatures, NanoInterpreter
from nanowakeword_tpu_torch.export.artifact import load_nww
from nanowakeword_tpu_torch.interpreter.nanointerpreter import _LocalSession
from nanowakeword_tpu_torch.ops import mel_cuda, mix_cuda
from nanowakeword_tpu_torch.utils import cuda_graph, tracing
from nanowakeword_tpu_torch.utils.tracing import counters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRNN = os.path.join(ROOT, "campaign", "hey_nano_crnn.nww")
CHUNK = 1280
# the chunker, then the chunk's copy to the device, each an upload span
FUSED = ["nww.predict.upload", "nww.predict.upload", "nww.step.replay",
         "nww.predict.readback", "nww.predict.rules"]


def _tone(seconds: float, hz: float = 200.0) -> np.ndarray:
    t = np.arange(int(16000 * seconds)) / 16000
    return (8000 * np.sin(2 * np.pi * hz * t)).astype(np.int16)


def _gate_crossing_clip() -> np.ndarray:
    """1.5 s at 1000 Hz, then 2 s at 200 Hz: once its window is filled, the
    shipped gate reads under its 0.3 threshold on the first tone and above
    it on most chunks of the second."""
    return np.concatenate([_tone(1.5, 1000.0), _tone(2.0)])


@pytest.fixture(scope="module")
def cascade():
    return NanoInterpreter.load_model(CRNN, cascade=True, device="cpu")


@pytest.fixture(scope="module")
def bulk():
    header, model, encoder = load_nww(CRNN, device="cpu")
    return AudioFeatures(encoder_state_dict=encoder, device="cpu"), \
        _LocalSession(model, header)


def _stream(interp, clip):
    interp.reset()
    return [interp.predict(clip[k * CHUNK:(k + 1) * CHUNK])
            for k in range(len(clip) // CHUNK)]


def _children(snap, record):
    return [s for s in snap.spans if s.parent == record.id]


def _ids(snap):
    return [id(s) for s in snap.spans]


def test_off_records_no_span_while_the_counters_count(cascade, bulk):
    frontend, session = bulk
    assert tracing.span("nww.predict") is tracing.NO_SPAN
    before, spans = dict(counters), _ids(tracing.snapshot())
    _stream(cascade, _tone(1.0))
    session.run_batch(frontend.embed_clips(_tone(2.0)[None].repeat(3, 0),
                                           batch_size=2))
    assert _ids(tracing.snapshot()) == spans
    assert counters["interpreter.chunks"] == before["interpreter.chunks"] \
        + 12
    assert counters["interpreter.verifier_runs"] \
        == before["interpreter.verifier_runs"] + 12
    # the CPU takes the kernels' plain versions: nothing launches
    assert counters["mel.launches"] == before["mel.launches"]


def test_recording_gives_the_fused_span_tree(cascade):
    cascade.reset()
    serial = cascade._chunk_serial
    with tracing.recording():
        assert tracing.span("x") is not tracing.NO_SPAN
        _stream(cascade, _tone(0.4))
    snap = tracing.snapshot()
    roots = [s for s in snap.spans if s.parent is None]
    assert [r.name for r in roots] == ["nww.predict"] * 5
    assert [r.request for r in roots] == list(range(serial, serial + 5))
    for root in roots:
        kids = _children(snap, root)
        assert [k.name for k in kids] == FUSED
        # the CPU runs the step eagerly: its mel is a span of its own
        (mel,) = _children(snap, kids[2])
        assert mel.name == "nww.features.mel"
        tree = [root] + kids + [mel]
        assert {s.request for s in tree} == {root.request}
        for s in tree:
            assert s.start_ns <= s.end_ns and s.device_ms is None
        for kid in kids:
            assert root.start_ns <= kid.start_ns <= kid.end_ns \
                <= root.end_ns
    assert len(snap.spans) == 5 * 7
    assert snap.counters["interpreter.chunks"] == 5
    assert snap.counters["mel.launches"] == 0


def test_general_path_and_bulk_span_trees(cascade, bulk):
    frontend, session = bulk
    fused = cascade._fused_step
    cascade._fused_step = None          # the general path
    try:
        with tracing.recording():
            _stream(cascade, _tone(1.6))
            runs = [s.attrs["model"] for s in tracing.snapshot().spans
                    if s.name == "nww.session.run"]
    finally:
        cascade._fused_step = fused
    snap = tracing.snapshot()
    roots = [s for s in snap.spans if s.parent is None]
    assert len(roots) == 20
    for root in roots:
        names = [k.name for k in _children(snap, root)]
        assert names[0] == "nww.predict.features"
        assert names[-1] == "nww.predict.rules"
        assert set(names[1:-1]) <= {"nww.session.run"}
    # the gate scores once its window is filled, the verifier after it
    assert runs.count("hey_nano_crnn_lite") == 20 - 15
    assert runs.count("hey_nano_crnn") > 0
    assert snap.counters["interpreter.verifier_runs"] \
        == runs.count("hey_nano_crnn") \
        == snap.counters["interpreter.verifier_served"]

    with tracing.recording():
        frontend_out = frontend.embed_clips(_tone(2.0)[None].repeat(3, 0),
                                            batch_size=2)
        session.run_batch(frontend_out)
    snap = tracing.snapshot()
    embed, run = [s for s in snap.spans if s.parent is None]
    assert embed.name == "nww.embed_clips" and run.name == "nww.run_batch"
    assert [k.name for k in _children(snap, embed)] == [
        "nww.features.upload", "nww.features.mel", "nww.features.encoder",
        "nww.features.download"] * 2
    assert [k.name for k in _children(snap, run)] == [
        "nww.session.upload", "nww.session.forward", "nww.session.download"]
    assert embed.request != run.request


def test_profiler_turns_spans_on_and_shows_their_copies(cascade):
    activities = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=activities) as prof:
        assert tracing.span("x") is not tracing.NO_SPAN
        _stream(cascade, _tone(0.24))
    names = collections.Counter(e.name for e in prof.events())
    for name, n in collections.Counter(["nww.predict"] + FUSED).items():
        assert names[name] == 3 * n, name
    snap = tracing.snapshot()
    assert [s.name for s in snap.spans if s.parent is None] \
        == ["nww.predict"] * 3
    assert tracing.span("x") is tracing.NO_SPAN


def test_verifier_counters_equal_a_hand_count(cascade):
    """The gate crosses 0.3: the verifier runs on every chunk of the
    captured step, and its score is served on the chunks whose gate was at
    or above the threshold once its own 16-frame window was filled."""
    assert cascade.cascade_config["gate_threshold"] == 0.3
    clip = _gate_crossing_clip()
    with tracing.recording():
        results = _stream(cascade, clip)
    snap = tracing.snapshot()
    window = cascade.model_feature_length["hey_nano_crnn"]
    gate = np.array([r.gate_score for r in results])
    served = sum(1 for k, g in enumerate(gate)
                 if k + 1 >= window and g >= 0.3)
    assert 0 < served < len(results) - window + 1
    assert (gate[window - 1:] < 0.3).any()
    assert snap.counters["interpreter.verifier_runs"] == len(results)
    assert snap.counters["interpreter.verifier_served"] == served
    assert served == sum(1 for r in results if r.score > 0)


def test_old_counter_names_read_the_registry():
    counters["mel.launches"] += 7
    counters["mel.captured"] += 2
    counters["mix.launches"] += 3
    assert mel_cuda.launches == counters["mel.launches"]
    assert mel_cuda.captured == counters["mel.captured"]
    assert mix_cuda.launches == counters["mix.launches"]
    mel_cuda.reset_launches()
    mix_cuda.reset_launches()
    assert mel_cuda.launches == 0 == counters["mel.launches"]
    assert mix_cuda.launches == 0 == counters["mix.launches"]
    with pytest.raises(AttributeError):
        mel_cuda.launched


def test_replay_counts_the_replay_and_its_launches():
    class Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    graph, before = Graph(), dict(counters)
    for _ in range(3):
        cuda_graph.replay(graph, 2)
    assert graph.replays == 3
    assert counters["graph.replays"] == before["graph.replays"] + 3
    assert counters["mel.launches"] == before["mel.launches"] + 6


def test_sessions_and_the_bounded_store(monkeypatch):
    with tracing.recording():
        with tracing.span("first"):
            pass
    monkeypatch.setattr(tracing, "MAX_SPANS", 8)
    with tracing.recording():
        for i in range(20):
            with tracing.span("outer", device=torch.device("cpu"),
                              request=100 + i):
                with tracing.span("inner", k=i):
                    counters["interpreter.chunks"] += 1
    snap = tracing.snapshot()
    assert [s.name for s in snap.spans] == ["outer", "inner"] * 4
    assert [s.request for s in snap.spans[::2]] == [116, 117, 118, 119]
    assert [s.attrs for s in snap.spans[1::2]] == [{"k": k} for k in
                                                   range(16, 20)]
    assert snap.counters["interpreter.chunks"] == 20
    # a CPU device times nothing
    assert all(s.device_ms is None for s in snap.spans)
