"""The quality bars of tests/test_quality_campaign.py, held against the
port on the CPU.

The same committed cascade (`campaign/hey_nano_crnn.nww` and its `_lite`
gate), the same eval clips regenerated from the same seeds (by the port's
synthesis functions, which write the JAX tool's bytes:
tests/test_torch_quality_campaign.py), the same bars. Each of the seven
tests of that file is one case of `test_quality_bar`; the cases share the
port's per-chunk traces, streamed once through `NanoInterpreter.predict`
on the CPU.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from nanowakeword_tpu_torch import NanoInterpreter
from nanowakeword_tpu_torch.tools import quality_campaign as qc

REPO = Path(__file__).resolve().parent.parent
ARTIFACT = REPO / "campaign" / "hey_nano_crnn.nww"
LITE = REPO / "campaign" / "hey_nano_crnn_lite.nww"

N_POS = 25
N_NEG_STREAMS = 8        # 10-s speech streams
N_FX = 15                # never-trained fx-chain transfer positives
THRESHOLD = 0.90         # raw per-frame threshold (upstream evaluator)
OP_THRESHOLD = 0.85      # swept production operating point
OP_PATIENCE = 2          # (campaign/results.json operating_point_sweep)
SR = 16000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port on the CPU while this module runs:
    its streaming step is hundreds of tiny ops, which run 2-3x slower on 8
    threads when other test processes share the cores."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _eval_clips():
    words = qc._words()
    rng = np.random.default_rng(55_000_000)
    pos = [qc._positive_eval_clip(rng, 55_000_000 + i) for i in range(N_POS)]
    negs = []
    srng = np.random.default_rng(56_000_000)
    for _ in range(N_NEG_STREAMS):
        negs.append(qc._speech_stream(srng, words, 10))
    noise = [qc._mic_floor(np.random.default_rng(57_000_000 + i), 10 * SR)
             * 30 for i in range(3)]
    frng = np.random.default_rng(58_000_000)
    fx = [qc._positive_eval_clip(frng, 58_000_000 + i, channel="formant_fx")
          for i in range(N_FX)]
    return pos, negs + noise, fx


def _int16(clip):
    return np.clip(np.asarray(clip) * 32767.0, -32768, 32767).astype(
        np.int16)


def _score_traces(interp, key, clips):
    out = []
    for clip in clips:
        interp.reset()
        audio = _int16(clip)
        row = []
        for i in range(0, len(audio), 1280):
            chunk = audio[i:i + 1280]
            if len(chunk) < 1280:
                break
            row.append(interp.predict(chunk).get(key, 0.0))
        out.append(np.asarray(row, np.float32))
    return out


def _cascade_run(interp, clips):
    verifier = interp.cascade_config["verifier"]
    gate = interp.cascade_config["gate"]
    gate_thr = interp.cascade_config["gate_threshold"]
    v_traces, invoked, chunks = [], 0, 0
    for clip in clips:
        interp.reset()
        audio = _int16(clip)
        row = []
        for i in range(0, len(audio) - 1279, 1280):
            res = interp.predict(audio[i:i + 1280])
            row.append(res.get(verifier, 0.0))
            invoked += res.get(gate, 0.0) >= gate_thr
            chunks += 1
        v_traces.append(np.asarray(row, np.float32))
    return v_traces, invoked / max(chunks, 1)


@pytest.fixture(scope="module")
def traces():
    pos, negs, fx = _eval_clips()
    full = NanoInterpreter.load_model(str(ARTIFACT), device="cpu")
    lite = NanoInterpreter.load_model(str(LITE), device="cpu")
    cascade = NanoInterpreter.load_model(str(ARTIFACT), cascade=True,
                                         device="cpu")
    assert cascade.is_cascade, "auto-discovery of the _lite gate failed"
    key = list(full.models)[0]
    cas_pos, _ = _cascade_run(cascade, pos)
    cas_neg, neg_invoke_rate = _cascade_run(cascade, negs)
    return {"pos": _score_traces(full, key, pos),
            "negs": _score_traces(full, key, negs),
            "fx": _score_traces(full, key, fx),
            "lite_pos": _score_traces(lite, list(lite.models)[0], pos),
            "cascade_pos": cas_pos, "cascade_negs": cas_neg,
            "cascade_neg_invoke_rate": neg_invoke_rate}


def _production_detect(traces, threshold=OP_THRESHOLD, patience=OP_PATIENCE):
    """Detection under the swept production operating point: `patience`
    consecutive chunk scores >= threshold."""
    hits = []
    for t in traces:
        h = t >= threshold
        hits.append(any(h[k:k + patience].all()
                        for k in range(len(h) - patience + 1)))
    return np.asarray(hits)


def _max_scores(traces):
    return np.asarray([t.max() if t.size else 0.0 for t in traces])


def _detects_held_out_speakers(tr):
    scores = _max_scores(tr["pos"])
    detected = int((scores >= THRESHOLD).sum())
    assert detected >= N_POS - 2, (
        f"miss rate too high: {N_POS - detected}/{N_POS} missed at "
        f"{THRESHOLD}; scores min {scores.min():.3f}")


def _rejects_speech_and_noise(tr):
    scores = _max_scores(tr["negs"])
    alarms = int((scores > THRESHOLD).sum())
    assert alarms <= 1, (
        f"false alarms: {alarms}/{len(scores)} streams crossed {THRESHOLD}; "
        f"max {scores.max():.3f}")


def _lite_gate_detects(tr):
    # the gate runs at a low threshold in the cascade (gate_threshold 0.3):
    # its job is recall, not precision
    detected = int((_max_scores(tr["lite_pos"]) >= 0.3).sum())
    assert detected >= N_POS - 2, (
        f"gate misses: {N_POS - detected}/{N_POS} below 0.3")


def _production_operating_point(tr):
    pos_hit = _production_detect(tr["pos"])
    assert pos_hit.sum() >= N_POS - 3, (
        f"production-point misses: {N_POS - int(pos_hit.sum())}/{N_POS} at "
        f"threshold {OP_THRESHOLD} patience {OP_PATIENCE}")
    neg_hit = _production_detect(tr["negs"])
    assert neg_hit.sum() <= 1, (
        f"production-point false alarms: {int(neg_hit.sum())}/"
        f"{len(neg_hit)} streams")


def _transfer_fx_channel(tr):
    raw = sum(t.max() >= THRESHOLD for t in tr["fx"])
    assert raw >= N_FX - 2, (
        f"fx-transfer raw misses: {N_FX - raw}/{N_FX} at {THRESHOLD}")
    prod = _production_detect(tr["fx"])
    assert prod.sum() >= N_FX - 3, (
        f"fx-transfer production misses: {N_FX - int(prod.sum())}/{N_FX}")


def _cascade_as_deployed(tr):
    hits = _production_detect(tr["cascade_pos"])
    assert hits.sum() >= N_POS - 4, (
        f"cascade production misses: {N_POS - int(hits.sum())}/{N_POS}")
    alarms = _production_detect(tr["cascade_negs"])
    assert alarms.sum() <= 1, (
        f"cascade false alarms: {int(alarms.sum())}/{len(alarms)} streams")
    # the cascade's reason to exist: the verifier is skipped on most
    # negative audio
    assert tr["cascade_neg_invoke_rate"] <= 0.5, (
        f"verifier invoked on {tr['cascade_neg_invoke_rate']:.0%} of "
        "negative chunks")


BARS = {
    "trained_model_detects_held_out_speakers": _detects_held_out_speakers,
    "trained_model_rejects_speech_and_noise": _rejects_speech_and_noise,
    "lite_gate_detects": _lite_gate_detects,
    "production_operating_point": _production_operating_point,
    "transfer_fx_channel": _transfer_fx_channel,
    "cascade_as_deployed": _cascade_as_deployed,
}


@pytest.mark.parametrize("bar", list(BARS))
def test_quality_bar(bar, traces):
    BARS[bar](traces)


def test_quality_bar_committed_evidence_is_consistent():
    """The seventh test of tests/test_quality_campaign.py, on the records
    the port's bars read: the committed tuning record (campaign/sweep.json)
    agrees with the published winner in campaign/results.json and with
    the operating point above."""
    sweep = json.loads((REPO / "campaign" / "sweep.json").read_text())
    results = json.loads((REPO / "campaign" / "results.json").read_text())
    published = results["operating_point_sweep"]["operating_point"]
    assert sweep["operating_point"] == published
    assert published["threshold"] == OP_THRESHOLD
    assert published["patience"] == OP_PATIENCE
    match = [r for r in sweep["grid"]
             if r["threshold"] == published["threshold"]
             and r["patience"] == published["patience"]]
    assert len(match) == 1 and match[0] == published
    assert published["negative_speech_fa_per_h"] == 0.0
    assert published["noise_fa_per_h"] == 0.0
