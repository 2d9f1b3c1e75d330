"""The port's interpreter against the JAX package's, on the CPU.

Stateful models (`UniRNN`, `StreamingGRUModel`, the carry through
`_LocalSession` and `NanoInterpreter`), the VAD gate, the one-call step
against the general path, `listen()` and noise reduction with faked
modules, and the command line. Inputs come from numpy seeds; each tolerance
is stated where it is used.
"""

import contextlib
import os
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanowakeword_tpu_torch.interpreter.nanointerpreter as port_ni
from nanowakeword_tpu.export.artifact import save_nww as jax_save_nww
from nanowakeword_tpu.interpreter.nanointerpreter import \
    NanoInterpreter as JaxNanoInterpreter
from nanowakeword_tpu.interpreter.vad import VAD as JaxVAD
from nanowakeword_tpu.models import architectures as JA
from nanowakeword_tpu.models.model import Model as JaxModel
from nanowakeword_tpu.runtime import AudioRing as JaxAudioRing
from nanowakeword_tpu_torch import cli
from nanowakeword_tpu_torch.convert import (flax_params_from_unirnn,
                                            unirnn_state_dict_from_flax)
from nanowakeword_tpu_torch.export.artifact import save_nww
from nanowakeword_tpu_torch.interpreter import (VAD, DetectionResult,
                                                NanoInterpreter)
from nanowakeword_tpu_torch.interpreter.nanointerpreter import _FusedStep
from nanowakeword_tpu_torch.models import architectures as A
from nanowakeword_tpu_torch.models.model import Model
from nanowakeword_tpu_torch.runtime import AudioRing
from test_torch_tracing import _gate_crossing_clip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRNN = os.path.join(ROOT, "campaign", "hey_nano_crnn.nww")
LITE = os.path.join(ROOT, "campaign", "hey_nano_crnn_lite.nww")
# a module's forward in both frameworks, f32 sums in a different order
FORWARD_TOL = 1e-5
# the score-trace bar of tests/test_score_trace.py
SCORE_TOL = 1e-3
SGRU_CFG = {"activation_function": "relu", "embedding_dim": 16}


def _speech_like(seed, n):
    return np.clip(np.random.default_rng(seed).normal(0, 3000, n),
                   -32768, 32767).astype(np.int16)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tree_max_diff(jax_tree, torch_tree) -> float:
    """max |difference| over two trees of the same structure; printed, so
    that `pytest -rP` shows every measured maximum."""
    a = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_tree)]
    b = [x.detach().numpy() for x in jax.tree_util.tree_leaves(torch_tree)]
    assert len(a) == len(b) and all(x.shape == y.shape for x, y in zip(a, b))
    worst = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    print(f"max|jax - port| = {worst:.3g}")
    return worst


def _assert_close(ours, ref, atol):
    print(f"max|jax - port| = {np.abs(np.asarray(ours) - ref).max():.3g}")
    np.testing.assert_allclose(ours, ref, atol=atol)


# -- UniRNN and StreamingGRUModel ------------------------------------------------


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_unirnn_matches_flax(cell):
    """[2, 7, 5] through 2 layers of 8 units: outputs and carry from the
    zero state, then resumed from that carry, within 1e-5."""
    x = np.random.default_rng(0).normal(size=(2, 7, 5)).astype(np.float32)
    ref = JA.UniRNN(8, 2, cell)
    variables = ref.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ours = A.UniRNN(5, 8, 2, cell)
    ours.load_state_dict(unirnn_state_dict_from_flax(
        _numpy_tree(variables["params"])))
    with torch.no_grad():
        out1, carry1 = ours(torch.from_numpy(x))
        out2, carry2 = ours(torch.from_numpy(x), carry1)
    ref1, ref_carry1 = ref.apply(variables, jnp.asarray(x))
    ref2, ref_carry2 = ref.apply(variables, jnp.asarray(x), carry=ref_carry1)
    assert _tree_max_diff(ref1, out1) <= FORWARD_TOL
    assert _tree_max_diff(ref2, out2) <= FORWARD_TOL
    assert _tree_max_diff(ref_carry1, carry1) <= FORWARD_TOL
    assert _tree_max_diff(ref_carry2, carry2) <= FORWARD_TOL
    # an LSTM layer's carry is the pair (c, h), a GRU layer's one tensor
    assert isinstance(carry1[0], tuple) == (cell == "lstm")


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_unirnn_convert_round_trip(cell):
    ref = JA.UniRNN(8, 2, cell)
    params = _numpy_tree(ref.init(jax.random.PRNGKey(2),
                                  jnp.zeros((1, 3, 5)))["params"])
    back = flax_params_from_unirnn(unirnn_state_dict_from_flax(params))
    flat, flat_back = (jax.tree_util.tree_leaves_with_path(t)
                       for t in (params, back))
    assert [p for p, _ in flat] == [p for p, _ in flat_back]
    for (_, a), (_, b) in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)


def _sgru_pair(input_shape=(16, 96), layer_dim=24, n_blocks=2, seed=3):
    kwargs = dict(config=SGRU_CFG, model_name="sgru",
                  input_shape=input_shape, model_type="streaming_gru",
                  layer_dim=layer_dim, n_blocks=n_blocks, dropout_prob=0.0)
    ref = JaxModel(seed=seed, **kwargs)
    ours = Model(device="cpu", **kwargs)
    ours.load_variables(_numpy_tree(ref.variables))
    return ref, ours


def test_streaming_gru_model_matches_flax():
    """Logits and carry within 1e-5, from the zero state and resumed; the
    port's variables convert back to the flax tree they came from."""
    ref, ours = _sgru_pair()
    assert ours.stateful and ours.module.stateful
    x = np.random.default_rng(4).normal(size=(2, 16, 96)).astype(np.float32)
    logits, carry = ours(x)
    ref_logits, ref_carry = ref.module.apply(ref.variables, jnp.asarray(x))
    assert _tree_max_diff(ref_logits, logits) <= FORWARD_TOL
    assert _tree_max_diff(ref_carry, carry) <= FORWARD_TOL
    with torch.no_grad():
        logits2, _ = ours.module(torch.from_numpy(x), carry)
    ref_logits2, _ = ref.module.apply(ref.variables, jnp.asarray(x),
                                      carry=ref_carry)
    assert _tree_max_diff(ref_logits2, logits2) <= FORWARD_TOL
    flat = jax.tree_util.tree_leaves_with_path(_numpy_tree(ref.variables))
    flat_back = jax.tree_util.tree_leaves_with_path(ours.variables)
    assert [p for p, _ in flat] == [p for p, _ in flat_back]
    for (_, a), (_, b) in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)


def test_streaming_gru_fresh_init_is_flax_like():
    """A fresh model draws one orthogonal [H, H] recurrent kernel per gate
    and zero biases, as flax's GRUCell does."""
    m = Model(config=SGRU_CFG, model_name="s", input_shape=(16, 96),
              model_type="streaming_gru", layer_dim=24, n_blocks=1,
              device="cpu", seed=0)
    layer = m.module.backbone.rnn.layers[0]
    for block in layer.recurrent.weight.split(24, dim=0):
        assert (block @ block.T - torch.eye(24)).abs().max() < 1e-5
    assert not layer.input_proj.bias.any() and not layer.bias_hn.any()


def test_carry_over_frames_equals_one_call():
    """50 chunks of one frame, the carry threaded, end in the carry of one
    call on the 50 frames (1e-5), in the port as in the JAX package."""
    ref, ours = _sgru_pair(input_shape=(1, 96))
    x = np.random.default_rng(5).normal(size=(1, 50, 96)).astype(np.float32)
    with torch.no_grad():
        _, whole = ours.module(torch.from_numpy(x))
        carry = None
        for t in range(50):
            _, carry = ours.module(torch.from_numpy(x[:, t:t + 1]), carry)
    assert _tree_max_diff(_numpy_tree(tuple(w.numpy() for w in whole)),
                          carry) <= FORWARD_TOL
    _, ref_whole = ref.module.apply(ref.variables, jnp.asarray(x))
    assert _tree_max_diff(ref_whole, carry) <= FORWARD_TOL


# -- stateful models in the interpreters -------------------------------------------


@pytest.fixture(scope="module")
def sgru_artifacts(tmp_path_factory):
    """One streaming_gru model written by each package's save_nww."""
    root = tmp_path_factory.mktemp("sgru")
    ref, ours = _sgru_pair(input_shape=(1, 96), layer_dim=16, n_blocks=1)
    by_jax = str(root / "by_jax" / "sgru.nww")
    by_port = str(root / "by_port" / "sgru.nww")
    for path in (by_jax, by_port):
        os.makedirs(os.path.dirname(path))
    jax_save_nww(by_jax, model=ref, config=SGRU_CFG, model_name="sgru")
    save_nww(by_port, model=ours, config=SGRU_CFG, model_name="sgru")
    return {"jax": by_jax, "port": by_port}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stateful_nww_scores_the_same_in_both(sgru_artifacts, writer):
    """A streaming_gru `.nww` from either writer, streamed 2 s chunk by
    chunk through both interpreters: scores within 1e-3, carries alike."""
    path = sgru_artifacts[writer]
    ref = JaxNanoInterpreter.load_model(path)
    ours = NanoInterpreter.load_model(path, device="cpu")
    assert ours.is_stateful == {"sgru": True} and ref.is_stateful["sgru"]
    assert ours.hidden_states == {"sgru": None}
    clip = _speech_like(6, 16000 * 2)
    a = np.array([r.score for r in ours.predict_clip(clip)])
    b = np.array([r.score for r in ref.predict_clip(clip)])
    assert len(a) == len(b) == 25
    _assert_close(a, b, SCORE_TOL)
    assert (a[:5] == 0).all() and (a[5:] > 0).all()
    assert _tree_max_diff(ref.hidden_states["sgru"],
                          ours.hidden_states["sgru"]) <= SCORE_TOL
    ours.reset()
    assert ours.hidden_states["sgru"] is None
    # after reset the stream starts from the zero state again
    again = np.array([r.score for r in ours.predict_clip(clip)])
    np.testing.assert_array_equal(again, a)


def test_stateful_carry_moves_between_chunks(sgru_artifacts):
    interp = NanoInterpreter.load_model(sgru_artifacts["port"], device="cpu")
    rng = np.random.default_rng(3)

    def chunk():
        return rng.integers(-8000, 8000, 1280).astype(np.int16)

    for _ in range(8):
        interp.predict(chunk())
    carry1 = interp.hidden_states["sgru"][0].clone()
    interp.predict(chunk())
    assert not torch.allclose(carry1, interp.hidden_states["sgru"][0])


# -- the VAD ---------------------------------------------------------------------------


def test_vad_equals_the_jax_package():
    """The same chunks through both VADs: every probability equal."""
    rng = np.random.default_rng(7)
    t = np.arange(16000) / 16000
    speech = (9000 * np.sin(2 * np.pi * 700 * t)
              * (0.6 + 0.4 * np.sin(2 * np.pi * 4 * t)))
    audio = np.concatenate([rng.normal(0, 30, 16000), speech,
                            rng.normal(0, 2000, 8000)])
    ours, ref = VAD(), JaxVAD()
    for i in range(0, len(audio), 1280):
        x = audio[i:i + 1280].astype(np.int16)
        assert ours(x) == ref(x)
    assert list(ours.prediction_buffer) == list(ref.prediction_buffer)
    assert max(ours.prediction_buffer) > 0.5
    ours.reset()
    assert len(ours.prediction_buffer) == 0 and ours._noise_floor is None


# -- the one-call step and the general path ----------------------------------------


def _tone_clip(seed):
    """1.5 s of near silence, 1.5 s of a modulated tone in the speech band
    (the VAD opens on it), 1 s of noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(24000) / 16000
    speech = (9000 * np.sin(2 * np.pi * 700 * t)
              * (0.6 + 0.4 * np.sin(2 * np.pi * 4 * t)))
    return np.concatenate([rng.normal(0, 30, 24000), speech,
                           rng.normal(0, 3000, 16000)]).astype(np.int16)


def _cascade_trace(interp, clip, **kwargs):
    interp.reset()
    if interp.vad_threshold > 0:
        interp.vad.reset()      # reset() keeps the VAD's noise floor
    out = interp.predict_clip(clip, **kwargs)
    return (np.array([r.gate_score for r in out]),
            np.array([r.score for r in out]))


@pytest.fixture(scope="module")
def port_cascade_vad():
    return NanoInterpreter.load_model(CRNN, cascade=True, gate_threshold=0.0,
                                      vad_threshold=0.3, device="cpu")


def test_fused_step_equals_general_path(port_cascade_vad, sgru_artifacts):
    """The same clip through the one-call step and, with that step taken
    away, through one session.run per model: equal, for the stateless
    cascade (with the VAD gate) and for a stateful model."""
    clip = _tone_clip(8)
    for interp in (port_cascade_vad,
                   NanoInterpreter.load_model(sgru_artifacts["port"],
                                              device="cpu")):
        assert isinstance(interp._fused_step, _FusedStep)
        assert not interp._fused_step.use_graph      # the CPU runs it eagerly
        fused = _cascade_trace(interp, clip)
        step, interp._fused_step = interp._fused_step, None
        try:
            general = _cascade_trace(interp, clip)
        finally:
            interp._fused_step = step
        np.testing.assert_array_equal(fused[0], general[0])
        np.testing.assert_array_equal(fused[1], general[1])
        assert np.count_nonzero(fused[1]) > 0


def test_cascade_with_vad_gate_matches_jax(port_cascade_vad):
    """Cascade + VAD gate on a clip that is silence, then a modulated tone
    in the speech band, then noise: the VAD zeroes the scores of the parts
    it takes for non-speech, in both packages alike (1e-3)."""
    clip = _tone_clip(9)
    ref = JaxNanoInterpreter.load_model(CRNN, cascade=True,
                                        gate_threshold=0.0, vad_threshold=0.3)
    gate, verifier = _cascade_trace(port_cascade_vad, clip)
    ref_gate, ref_verifier = _cascade_trace(ref, clip)
    _assert_close(gate, ref_gate, SCORE_TOL)
    _assert_close(verifier, ref_verifier, SCORE_TOL)
    # the gate opened somewhere and closed somewhere after warm-up
    assert np.count_nonzero(gate[16:]) > 0
    assert (gate[16:] == 0).any()
    assert (gate == 0).tolist() == (ref_gate == 0).tolist()


def test_general_path_skips_the_verifier_when_the_gate_is_low():
    interp = NanoInterpreter.load_model(CRNN, cascade=True,
                                        gate_threshold=2.0, device="cpu")
    interp._fused_step = None
    calls = {"n": 0}
    session = interp.models["hey_nano_crnn"]
    run = session.run

    def counting_run(*args, **kwargs):
        calls["n"] += 1
        return run(*args, **kwargs)

    session.run = counting_run
    clip = _speech_like(10, 1280 * 20)
    assert all(r.score == 0.0 for r in interp.predict_clip(clip))
    assert calls["n"] == 0
    interp.cascade_config["gate_threshold"] = -1.0
    interp.predict_clip(clip[:1280 * 5])
    assert calls["n"] == 5


# -- the one-call step split at the gate ------------------------------------------

VERIFIER = "hey_nano_crnn"
CHUNK = 1280


def _whole_chunks_clip() -> np.ndarray:
    """The tracing tests' clip on which the shipped gate crosses its 0.3
    threshold, cut to 42 whole chunks (whole calls of three)."""
    return _gate_crossing_clip()[:42 * CHUNK]


@pytest.fixture(scope="module")
def port_cascade():
    """The shipped cascade at its default gate threshold, 0.3."""
    return NanoInterpreter.load_model(CRNN, cascade=True, device="cpu")


@contextlib.contextmanager
def _counted_calls(module):
    """A list that gains one item per forward call of `module` while the
    block runs."""
    calls = []
    handle = module.register_forward_hook(lambda *_: calls.append(1))
    try:
        yield calls
    finally:
        handle.remove()


def _verifier_counters():
    return {k: port_ni.counters[f"interpreter.{k}"]
            for k in ("chunks", "verifier_runs", "verifier_skipped",
                      "verifier_served")}


def _counted_trace(interp, clip, **kwargs):
    """-> (gate scores, verifier scores, counters' changes, verifier
    module calls) of the clip streamed from a reset."""
    before = _verifier_counters()
    with _counted_calls(interp.models[VERIFIER].model.module) as calls:
        gate, verifier = _cascade_trace(interp, clip, **kwargs)
    after = _verifier_counters()
    return gate, verifier, {k: after[k] - before[k] for k in after}, \
        len(calls)


@pytest.mark.parametrize("chunks_per_call", [1, 3])
def test_split_step_equals_general_path(port_cascade, chunks_per_call):
    """A clip on which the gate crosses 0.3, fed one chunk or three a
    call: the step split at the gate serves the same gate and verifier
    scores as the general path, bit for bit. Only the last chunk of a call
    is served, so the split verifier runs at most once a call."""
    interp = port_cascade
    assert interp._fused_step.verifier == VERIFIER
    assert interp._fused_step.names == ["hey_nano_crnn_lite"]
    clip = _whole_chunks_clip()
    kwargs = {"chunk_size": CHUNK * chunks_per_call}
    gate, verifier, count, calls = _counted_trace(interp, clip, **kwargs)
    step, interp._fused_step = interp._fused_step, None
    try:
        general = _cascade_trace(interp, clip, **kwargs)
    finally:
        interp._fused_step = step
    np.testing.assert_array_equal(gate, general[0])
    np.testing.assert_array_equal(verifier, general[1])
    served = int(np.count_nonzero(verifier))
    assert 0 < served < len(verifier)
    assert (gate[16 // chunks_per_call:] < 0.3).any()
    assert count["chunks"] == len(clip) // CHUNK
    assert calls == count["verifier_runs"] == count["verifier_served"] \
        == served <= len(verifier)
    assert count["verifier_runs"] + count["verifier_skipped"] \
        == count["chunks"]


def test_split_verifier_runs_once_per_served_score(port_cascade):
    """Over a gate that opens and closes, and through a reset, the
    verifier's module is called exactly as often as its score is served:
    never while its window fills or while the gate stays low."""
    interp = port_cascade
    clip = _whole_chunks_clip()
    twice = np.concatenate([clip[len(clip) // 2:], clip])
    results = []
    before = _verifier_counters()
    with _counted_calls(interp.models[VERIFIER].model.module) as calls:
        for piece in (clip, twice):
            interp.reset()
            results += interp.predict_clip(piece)
    served = sum(1 for r in results if r.score > 0)
    gated = sum(1 for r in results if r.gate_score < 0.3)
    assert served > 0 and gated > 0
    assert len(calls) == served
    assert port_ni.counters["interpreter.verifier_runs"] \
        - before["verifier_runs"] == served
    assert port_ni.counters["interpreter.verifier_skipped"] \
        - before["verifier_skipped"] == len(results) - served


# a gate this close to its threshold may fall on either side of it in the
# two packages' float32 sums, and with it the verifier's score
GATE_MARGIN = SCORE_TOL


@pytest.fixture(scope="module")
def jax_cascade():
    """The JAX package's shipped cascade at its default gate threshold."""
    return JaxNanoInterpreter.load_model(CRNN, cascade=True)


@pytest.mark.parametrize("chunks_per_call", [1, 3])
def test_split_step_matches_jax_where_the_gate_crosses(
        port_cascade, jax_cascade, chunks_per_call):
    """The shipped cascade at its 0.3 gate, on a clip whose gate crosses
    it, fed one chunk or three a call: the split step serves the JAX
    package's gate and verifier scores (1e-3), and zeroes the verifier on
    the same chunks, leaving out those whose gate lies within GATE_MARGIN
    of the threshold."""
    clip = _whole_chunks_clip()
    kwargs = {"chunk_size": CHUNK * chunks_per_call}
    gate, verifier = _cascade_trace(port_cascade, clip, **kwargs)
    ref_gate, ref_verifier = _cascade_trace(jax_cascade, clip, **kwargs)
    assert len(gate) == len(ref_gate) == 42 // chunks_per_call
    _assert_close(gate, ref_gate, SCORE_TOL)
    assert (gate == 0).tolist() == (ref_gate == 0).tolist()
    clear = np.abs(ref_gate - 0.3) > GATE_MARGIN
    _assert_close(verifier[clear], ref_verifier[clear], SCORE_TOL)
    assert (verifier[clear] == 0).tolist() == (ref_verifier[clear] == 0
                                                ).tolist()
    # after warm-up the gate both let the verifier through and held it back
    warm = np.arange(len(gate)) >= 16 // chunks_per_call
    assert (ref_verifier[clear & warm] > 0).any()
    assert (ref_verifier[clear & warm] == 0).any()
    assert clear[warm].sum() >= warm.sum() - 2


def test_stateful_verifier_stays_in_the_one_call(sgru_artifacts):
    """A cascade whose verifier threads a carry (a streaming_gru behind the
    shipped lite gate): the step is not split, the verifier runs on every
    chunk, gated or not, so that its carry advances as in the JAX
    package's one-call step, whose scores it matches (1e-3)."""
    path = sgru_artifacts["port"]
    ours = NanoInterpreter.load_model(path, gate_model=LITE, device="cpu")
    ref = JaxNanoInterpreter.load_model(path, gate_model=LITE)
    assert ours.cascade_config["verifier"] == "sgru"
    assert ours._fused_step.verifier is None
    assert ours._fused_step.names == ["hey_nano_crnn_lite", "sgru"]
    clip = _whole_chunks_clip()
    before = _verifier_counters()
    gate, verifier = _cascade_trace(ours, clip)
    after = _verifier_counters()
    ref_gate, ref_verifier = _cascade_trace(ref, clip)
    assert after["verifier_runs"] - before["verifier_runs"] == len(gate)
    assert after["verifier_skipped"] == before["verifier_skipped"]
    assert 0 < np.count_nonzero(verifier) < len(verifier)
    assert (gate == 0).tolist() == (ref_gate == 0).tolist()
    assert (verifier == 0).tolist() == (ref_verifier == 0).tolist()
    _assert_close(gate, ref_gate, SCORE_TOL)
    _assert_close(verifier, ref_verifier, SCORE_TOL)


def test_streaming_state_is_written_in_place(port_cascade_vad):
    """reset() and the stream step keep the same buffers: what a captured
    graph writes is what feature_buffer and get_features read."""
    pre = port_cascade_vad.preprocessor
    pointers = [t.data_ptr() for t in pre.state]
    port_cascade_vad.predict(_speech_like(11, 1280 * 3))
    port_cascade_vad.reset()
    pre(_speech_like(12, 1280 * 2))
    assert [t.data_ptr() for t in pre.state] == pointers
    assert pre.feature_buffer.shape[0] == 2
    np.testing.assert_array_equal(pre.get_features(2)[0], pre.feature_buffer)
    pre.reset()
    assert pre.feature_buffer.shape[0] == 0
    assert (pre.state.mel_buf == 1).all() and not pre.state.tail.any()


def test_interpreter_surface_matches_jax():
    ours = NanoInterpreter.load_model(LITE, device="cpu")
    ref = JaxNanoInterpreter.load_model(LITE)
    assert set(ours.info) == set(ref.info)
    assert ours.info["is_remote"] is False
    assert repr(ours) == repr(ref)
    assert ours.class_mapping == ref.class_mapping
    assert isinstance(ours.predict(np.zeros(100, np.int16)), DetectionResult)
    with pytest.raises(ValueError, match="Numpy"):
        ours.predict([0] * 1280)
    with pytest.raises(ValueError, match="at least one"):
        NanoInterpreter.load_model(None, device="cpu")
    with pytest.raises(ValueError, match="Invalid remote_pipeline"):
        NanoInterpreter.load_model(LITE, remote_pipeline="nope",
                                   device="cpu")


# -- listen() and noise reduction --------------------------------------------------


def test_audio_ring_matches_jax():
    ours, ref = AudioRing(capacity=3000), JaxAudioRing(capacity=3000)
    rng = np.random.default_rng(13)
    for n_push, n_pop in ((1280, 500), (1280, 1280), (100, 5000), (0, 10)):
        x = rng.integers(-30000, 30000, n_push).astype(np.int16)
        assert ours.push(x) == ref.push(x)
        assert ours.size == ref.size
        np.testing.assert_array_equal(ours.pop(n_pop), ref.pop(n_pop))
    # overflow: the native ring's capacity is rounded up to 4096, and of a
    # push past it only the newest samples are kept
    x = np.arange(5000).astype(np.int16)
    assert ours.push(x) == ref.push(x)
    assert ours.size == ref.size == 4096
    np.testing.assert_array_equal(ours.pop(1), ref.pop(1))
    assert ours.pop(1)[0] == ref.pop(1)[0] == 905          # oldest dropped


def test_listen_detects_scores_and_stops(monkeypatch):
    """The real capture -> ring -> predict loop on a faked pyaudio."""
    served = {"n": 0}

    class FakeStream:
        def read(self, n, exception_on_overflow=False):
            served["n"] += 1
            time.sleep(0.002)
            rng = np.random.default_rng(served["n"])
            return (rng.normal(0, 0.05, n) * 32767).astype(
                np.int16).tobytes()

        def stop_stream(self):
            pass

        def close(self):
            pass

    class FakePyAudio:
        def open(self, **kwargs):
            assert kwargs["rate"] == 16000 and kwargs["channels"] == 1
            return FakeStream()

        def terminate(self):
            pass

    fake = types.ModuleType("pyaudio")
    fake.paInt16 = 8
    fake.PyAudio = FakePyAudio
    monkeypatch.setitem(sys.modules, "pyaudio", fake)

    interp = NanoInterpreter.load_model(LITE, device="cpu")
    detections, scores, chunks = [], [], []
    interp.listen(
        on_detection=lambda name, s: detections.append(
            (name, s, time.monotonic())),
        threshold=-1.0, cooldown=0.2, blocking=False,
        on_score=lambda v, g: scores.append(v),
        on_audio=lambda a: chunks.append(a))
    deadline = time.time() + 60
    while len(detections) < 2 and time.time() < deadline:
        time.sleep(0.05)
    interp.stop()
    assert interp._listen_thread is None
    assert detections and detections[0][0] == "hey_nano_crnn_lite"
    assert scores and chunks
    assert all(c.dtype == np.int16 and len(c) == 1280 for c in chunks[:3])
    if len(detections) >= 2:
        assert detections[1][2] - detections[0][2] >= 0.2 * 0.9
    assert served["n"] >= len(chunks)


def test_listen_needs_pyaudio(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyaudio", None)
    interp = NanoInterpreter.load_model(LITE, device="cpu")
    with pytest.raises(ImportError, match="PyAudio"):
        interp.listen()


def _fake_noisereduce(monkeypatch, fn):
    monkeypatch.setattr(port_ni, "NOISEREDUCE_AVAILABLE", True)
    monkeypatch.setattr(port_ni, "nr", types.SimpleNamespace(reduce_noise=fn),
                        raising=False)


def test_noise_reduction_applied_on_predict(monkeypatch):
    calls = {"n": 0}

    def halve(y, sr, stationary=True):
        assert sr == 16000
        calls["n"] += 1
        return y * 0.5

    _fake_noisereduce(monkeypatch, halve)
    interp = NanoInterpreter.load_model(LITE, enable_noise_reduction=True,
                                        device="cpu")
    assert interp.noise_reducer_enabled
    x = (np.random.default_rng(0).normal(0, 0.05, 1280) * 32767).astype(
        np.int16)
    out = interp._reduce_noise(x)
    assert calls["n"] == 1
    np.testing.assert_allclose(
        out, (x.astype(np.float32) * 0.5).astype(np.int16), atol=1)
    interp.predict(x)
    assert calls["n"] == 2


def test_noise_reduction_failure_returns_original_audio(monkeypatch):
    def boom(y, sr, stationary=True):
        raise RuntimeError("synthetic failure")

    _fake_noisereduce(monkeypatch, boom)
    interp = NanoInterpreter.load_model(LITE, enable_noise_reduction=True,
                                        device="cpu")
    x = (np.random.default_rng(1).normal(0, 0.05, 1280) * 32767).astype(
        np.int16)
    np.testing.assert_array_equal(interp._reduce_noise(x), x)


def test_noise_reduction_disabled_when_package_missing(monkeypatch):
    monkeypatch.setattr(port_ni, "NOISEREDUCE_AVAILABLE", False)
    interp = NanoInterpreter.load_model(LITE, enable_noise_reduction=True,
                                        device="cpu")
    assert not interp.noise_reducer_enabled


# -- the command line -------------------------------------------------------------------


def test_cli_server_arguments():
    args = cli._build_parser().parse_args(
        ["--model", "m.nww", "--pipeline", "full", "--port", "9001",
         "--api-key", "a", "--api-key", "b", "--no-batching", "--max-batch",
         "64", "--batch-wait-ms", "2.5", "--device", "cpu"])
    assert (args.model, args.pipeline, args.port) == ("m.nww", "full", 9001)
    assert args.api_keys == ["a", "b"] and args.no_batching
    assert (args.max_batch, args.batch_wait_ms, args.device) == (64, 2.5,
                                                                 "cpu")
    defaults = cli._build_parser().parse_args(["--model", "m.nww"])
    assert (defaults.pipeline, defaults.host, defaults.port,
            defaults.device) == ("verifier_only", "0.0.0.0", 8765, "cuda")


def test_cli_runs_the_server(monkeypatch):
    """--model hands every server flag to serve()."""
    import nanowakeword_tpu_torch.interpreter.remote_verifier as rv
    seen = {}
    monkeypatch.setattr(rv, "serve", lambda **kw: seen.update(kw))
    cli.main(["--model", CRNN, "--pipeline", "full", "--device", "cpu",
              "--rate-limit", "7", "--data-parallel", "2"])
    assert seen["model_path"] == CRNN and seen["pipeline"] == "full"
    assert seen["device"] == "cpu" and seen["data_parallel"] == 2
    assert seen["batching"] and seen["security"].config.rate_limit == 7


def test_cli_training_flags_reach_the_trainer(monkeypatch, tmp_path):
    import nanowakeword_tpu_torch.trainer as trainer
    seen = {}
    monkeypatch.setattr(trainer, "train",
                        lambda cli_args: seen.update(argv=cli_args))
    cli.main(["-c", "cfg.yaml", "-G", "-t", "-T", "-f", "--overwrite",
              "--resume", "dir", "--device", "cpu"])
    assert seen["argv"] == ["-c", "cfg.yaml", "--device", "cpu", "-G", "-t",
                            "-T", "-f", "--overwrite", "--resume", "dir"]
    # stages read from the config file when no flag is given
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("train_model: true\n")
    cli.main(["-c", str(cfg)])
    assert seen["argv"] == ["-c", str(cfg), "--device", "cuda", "-T"]


@pytest.mark.parametrize("flag,error,match", [
    # both stages are ported: the flag reaches the pipeline, which opens
    # the config
    pytest.param("-G", FileNotFoundError, "cfg.yaml", id="-G"),
    pytest.param("-d", FileNotFoundError, "cfg.yaml", id="-d")])
def test_cli_unported_stages_raise(flag, error, match):
    with pytest.raises(error, match=match):
        cli.main(["-c", "cfg.yaml", flag])


def test_cli_info(capsys, sgru_artifacts):
    cli.main(["--info", CRNN])
    out = capsys.readouterr().out
    assert "hey_nano_crnn" in out and "155,713" in out
    assert "crnn (stateless)" in out and "bundled encoder" in out
    assert "shape=['batch', 16, 96]" in out
    cli.main(["--info", sgru_artifacts["port"]])
    assert "streaming_gru (stateful (carry))" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["--info", "/nonexistent/model.nww"])
    with pytest.raises(SystemExit):
        cli.main([])
