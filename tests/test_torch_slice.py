"""The port's serving slice end to end against the JAX package, on the CPU.

Batch scoring (AudioFeatures.embed_clips) and the streaming cascade
(NanoInterpreter.predict_clip) run in both packages on the same seeded
audio. Also: the port imports no JAX, a CPU tensor launches no kernel, an
unsupported device raises, and the `.onnx` options work.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanowakeword_tpu.data.features import AudioFeatures as JaxAudioFeatures
from nanowakeword_tpu.interpreter.nanointerpreter import \
    NanoInterpreter as JaxNanoInterpreter
from nanowakeword_tpu.runtime import Chunker as JaxChunker
from nanowakeword_tpu_torch import AudioFeatures, NanoInterpreter
from nanowakeword_tpu_torch.data.features import (CHUNK, EMB_OFFSET,
                                                  batch_embedding_frames)
from nanowakeword_tpu_torch.export.frontend import seeded_audio
from nanowakeword_tpu_torch.models.embedding import EMB_WINDOW
from nanowakeword_tpu_torch.ops import mel_cuda
from nanowakeword_tpu_torch.ops.mel import n_mel_frames
from nanowakeword_tpu_torch.runtime import Chunker
from nanowakeword_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRNN = os.path.join(ROOT, "campaign", "hey_nano_crnn.nww")
# the score-trace bar of tests/test_score_trace.py
SCORE_TOL = 1e-3


def _speech_like(seed, n):
    return np.clip(np.random.default_rng(seed).normal(0, 3000, n),
                   -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def port_features():
    return AudioFeatures(device="cpu")


def _clips(kind, seed, batch, n):
    """int16 test audio: white noise, or a tone (export/frontend.py's
    seeded_audio). The bundled encoder's output is constant on white noise,
    so only the tone reaches its weights."""
    if kind == "noise":
        return np.random.default_rng(seed).integers(
            -20000, 20000, (batch, n)).astype(np.int16)
    return np.round(seeded_audio(batch, n, seed=seed)).astype(np.int16)


@pytest.mark.parametrize("kind", ["noise", "tone"])
def test_embed_clips_matches_jax(port_features, kind):
    """[2, 32000] int16 -> [2, 16, 96]. Bound 5e-3: the two mel routes
    round differently ordered f32 sums (each within 2e-3 of the other),
    and the encoder carries that through four convs."""
    x = _clips(kind, 1, 2, 32000)
    ref = JaxAudioFeatures().embed_clips(x)
    out = port_features.embed_clips(x)
    assert out.shape == ref.shape == (2, 16, 96)
    assert out.shape[1] == batch_embedding_frames(n_mel_frames(32000))
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=5e-3)
    if kind == "tone":       # the features move with the audio
        assert out.std(axis=1).max() > 0.1


@pytest.mark.parametrize("batch_size", [1, 3, 5, 7],
                         ids=["one", "ragged_3", "ragged_5", "whole"])
def test_embed_clips_writes_each_batch_into_one_new_array(port_features,
                                                          batch_size):
    """7 clips of 1 s: the result is the per-batch embeddings joined, bit
    for bit, in one C-contiguous writeable float32 array of the call's own
    (a second call shares no memory with it); every batch counts as a
    download, none as pinned on the CPU."""
    def per_batch(x):
        with torch.no_grad():
            return np.concatenate([
                port_features._embed_impl(torch.from_numpy(
                    x[i:i + batch_size])).cpu().numpy()
                for i in range(0, len(x), batch_size)], axis=0)

    x = _clips("tone", 3, 7, 16000)
    expected = per_batch(x)
    before = dict(tracing.counters)
    out = port_features.embed_clips(x, batch_size=batch_size)
    assert tracing.counters["features.downloads"] \
        == before["features.downloads"] + -(-7 // batch_size)
    assert tracing.counters["features.downloads_pinned"] \
        == before["features.downloads_pinned"]
    assert out.shape == (7, batch_embedding_frames(n_mel_frames(16000)), 96)
    assert out.dtype == np.float32
    assert out.flags.c_contiguous and out.flags.writeable
    np.testing.assert_array_equal(out, expected)
    assert out.std(axis=0).max() > 0.1
    other = x[::-1].copy()
    again = port_features.embed_clips(other, batch_size=batch_size)
    assert not np.shares_memory(out, again)
    np.testing.assert_array_equal(out, expected)
    np.testing.assert_array_equal(again, per_batch(other))


@pytest.mark.parametrize("kind", ["noise", "tone"])
def test_streaming_equals_batch_after_warmup(port_features, kind):
    """As tests/test_features.py: every streamed embedding whose 76-frame
    mel window lies inside real audio equals the batch path's frame."""
    af = port_features
    af.reset()
    if kind == "noise":
        x = _speech_like(7, 16000 * 4).astype(np.float32)
    else:
        x = _clips(kind, 7, 1, 16000 * 4)[0].astype(np.float32)
    batch = af.embed_clips(x[None])[0]                   # [41, 96]
    stream = []
    for c in range(len(x) // CHUNK):
        af(x[c * CHUNK:(c + 1) * CHUNK])
        stream.append(af.get_features(1)[0, 0])
    assert af.feature_buffer.shape[0] == len(stream) == af.frames_available
    for c in range(9, len(stream)):
        i = (8 * (c + 1) - EMB_WINDOW) // 8
        np.testing.assert_allclose(stream[c], batch[i], rtol=1e-4,
                                   atol=2e-4, err_msg=f"chunk {c}")
    if kind == "tone":
        assert batch.std(axis=0).max() > 0.1
    assert EMB_OFFSET == 4
    af.reset()
    assert af.feature_buffer.shape[0] == 0 and af.accumulated_samples == 0
    assert af.frames_available == 0


@pytest.fixture(scope="module")
def jax_cascade():
    return JaxNanoInterpreter.load_model(CRNN, cascade=True,
                                         gate_threshold=0.0)


@pytest.fixture(scope="module")
def port_cascade():
    return NanoInterpreter.load_model(CRNN, cascade=True, gate_threshold=0.0,
                                      device="cpu")


@pytest.mark.parametrize("kwargs", [
    {},
    {"patience": {"hey_nano_crnn": 3}, "threshold": {"hey_nano_crnn": 0.002}},
    {"debounce_time": 0.5, "threshold": {"hey_nano_crnn_lite": 0.005}},
])
def test_cascade_predict_clip_matches_jax(jax_cascade, port_cascade, kwargs):
    """3 s streamed in 80 ms chunks; gate and verifier scores per chunk."""
    clip = _speech_like(5, 16000 * 3)
    jax_cascade.reset()
    port_cascade.reset()
    ref = jax_cascade.predict_clip(clip, **kwargs)
    out = port_cascade.predict_clip(clip, **kwargs)
    assert port_cascade.is_cascade
    assert port_cascade.gate_name == "hey_nano_crnn_lite"
    assert port_cascade.model_name == "hey_nano_crnn"
    assert len(out) == len(ref) == 38
    for attr in ("gate_score", "score"):
        a = np.array([getattr(r, attr) for r in out])
        b = np.array([getattr(r, attr) for r in ref])
        np.testing.assert_allclose(a, b, atol=SCORE_TOL)
        assert (a[:15] == 0).all()       # until 16 frames were emitted
        if not kwargs:
            assert (a[15:] > 0).all()
    for name, score in jax_cascade.raw_scores.items():
        assert abs(port_cascade.raw_scores[name] - score) <= SCORE_TOL


def test_gate_threshold_zeroes_the_verifier(port_cascade):
    port_cascade.cascade_config["gate_threshold"] = 1.0
    try:
        port_cascade.reset()
        out = port_cascade.predict_clip(_speech_like(6, 16000 * 3))
        assert all(r.score == 0.0 for r in out)
        assert any(r.gate_score > 0.0 for r in out)
    finally:
        port_cascade.cascade_config["gate_threshold"] = 0.0


def test_chunker_matches_jax():
    rng = np.random.default_rng(2)
    ours, ref = Chunker(CHUNK), JaxChunker(CHUNK)
    for n in (100, 1280, 3000, 0, 2000, 5):
        x = rng.integers(-30000, 30000, n).astype(np.int16)
        np.testing.assert_array_equal(ours.feed(x), ref.feed(x))
        assert ours.pending == ref.pending


def test_import_loads_no_jax():
    code = ("import sys, nanowakeword_tpu_torch\n"
            "from nanowakeword_tpu_torch import (VAD, NanoInterpreter, "
            "AudioFeatures, DetectionResult, __version__, PROJECT_ROOT)\n"
            "assert __version__ == '0.6.0'\n"
            "assert PROJECT_ROOT == __import__('pathlib').Path("
            "nanowakeword_tpu_torch.__file__).resolve().parent\n"
            "assert nanowakeword_tpu_torch.__all__ == ['NanoInterpreter', "
            "'DetectionResult', 'VAD', 'AudioFeatures']\n"
            "from nanowakeword_tpu_torch import convert\n"
            "from nanowakeword_tpu_torch.export import artifact, fx_onnx\n"
            "from nanowakeword_tpu_torch.train import pretrain_encoder\n"
            "from nanowakeword_tpu_torch import parallel, runtime\n"
            "from nanowakeword_tpu_torch.parallel import (collectives, dp,"
            " mesh)\n"
            "from nanowakeword_tpu_torch.tools import (quality_campaign,"
            " ship_decision_ci, encoder_ladder, eval_encoder_transfer)\n"
            "from nanowakeword_tpu_torch.test_model import ("
            "evaluate_model_with_audio, evaluate_model_with_features)\n"
            "runtime.load_native()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'msgpack', 'ml_dtypes', "
            "'nanowakeword_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cpu_tensor_launches_no_kernel(port_features):
    before = mel_cuda.launches
    port_features.embed_clips(np.zeros((2, 16000), np.int16))
    mel_cuda.mel_frontend_fused(torch.zeros(3, 1600))
    assert mel_cuda.launches == before


def test_unsupported_device_raises():
    with pytest.raises(ValueError, match="cpu and cuda"):
        mel_cuda.mel_frontend_fused(torch.zeros(1600, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        mel_cuda.mel_frontend_cuda(torch.zeros(1600))


@pytest.fixture(scope="module")
def crnn_onnx(tmp_path_factory):
    """The shipped CRNN exported to `.onnx` by the port."""
    from nanowakeword_tpu_torch.export.artifact import (export_onnx_model,
                                                        load_nww)
    root = tmp_path_factory.mktemp("crnn_onnx")
    _, model, _ = load_nww(CRNN, device="cpu")
    return export_onnx_model(model, model.input_shape, {}, "m", str(root))


def _load_onnx_model(path):
    interp = NanoInterpreter.load_model(path, device="cpu")
    assert interp.model_feature_length == {"m": 16}
    return interp.predict_clip(_speech_like(4, 16000 * 2))[-1].score


def _load_onnx_frontend(path):
    from nanowakeword_tpu_torch.data.features import \
        default_encoder_variables
    from nanowakeword_tpu_torch.export.frontend import export_frontend_onnx
    root = os.path.dirname(path)
    export_frontend_onnx(default_encoder_variables(), 16000, "m", root)
    interp = NanoInterpreter.load_model(CRNN, device="cpu",
                                        onnx_frontend=os.path.join(root, "m"))
    return interp.predict_clip(_speech_like(4, 16000 * 2))[-1].score


def _serve_onnx_model(path):
    import asyncio
    import json

    from nanowakeword_tpu_torch.interpreter import remote_verifier as rv
    server = rv._ScoringServer(path, device="cpu")
    feats = np.random.default_rng(4).normal(0, 1, (1, 16, 96))

    async def reply():
        server.start()          # the batcher's task
        return await server.reply(rv.encode_features(
            feats.astype(np.float32)), None)

    return json.loads(asyncio.run(reply()))["score"]


@pytest.mark.parametrize("call", [_load_onnx_model, _load_onnx_frontend,
                                  _serve_onnx_model])
def test_unported_options_raise(call, crnn_onnx):
    """The ONNX options of the interpreter and the server score a clip or a
    request: an `.onnx` model, the ONNX frontend, and an `.onnx` behind the
    server (held against the JAX package in tests/test_torch_onnx.py)."""
    score = call(crnn_onnx)
    assert 0.0 < score < 1.0
