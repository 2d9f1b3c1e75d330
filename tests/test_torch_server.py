"""The port's RemoteVerifier server against the JAX package's, on the CPU.

The scoring path without a socket (`_ScoringServer.reply`, the dynamic
batcher, the per-connection state), the security layer across the two
packages, and, where `websockets` is installed, the wire protocol in both
directions over a loopback socket. Tolerances are stated where they are
used.
"""

import asyncio
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

from nanowakeword_tpu.interpreter import remote_verifier as jax_rv
from nanowakeword_tpu.interpreter import server_security as jax_sec
from nanowakeword_tpu_torch import AudioFeatures, NanoInterpreter
from nanowakeword_tpu_torch.export.artifact import load_nww
from nanowakeword_tpu_torch.interpreter import remote_verifier as rv
from nanowakeword_tpu_torch.interpreter import server_security as sec
from nanowakeword_tpu_torch.interpreter.nanointerpreter import _LocalSession
from nanowakeword_tpu_torch.ops import mel as melops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRNN = os.path.join(ROOT, "campaign", "hey_nano_crnn.nww")
LITE = os.path.join(ROOT, "campaign", "hey_nano_crnn_lite.nww")
# the score-trace bar of tests/test_score_trace.py, across the packages
SCORE_TOL = 1e-3
# a request in a batch against the same request alone: the libraries may
# choose by shape, so the last bits may differ
BATCH_TOL = 1e-5


def _speech_like(seed, n):
    return np.clip(np.random.default_rng(seed).normal(0, 3000, n),
                   -32768, 32767).astype(np.int16)


def _features(seed, n=1):
    return np.random.default_rng(seed).normal(
        0, 1, (n, 16, 96)).astype(np.float32)


def _score(reply: str) -> float:
    return json.loads(reply)["score"]


def _assert_close(ours, ref, atol):
    """assert_allclose that prints the measured maximum (`pytest -rP`)."""
    print(f"max|difference| = {np.abs(np.asarray(ours) - ref).max():.3g}")
    np.testing.assert_allclose(ours, ref, atol=atol)


@pytest.fixture(scope="module")
def crnn_session():
    header, model, _ = load_nww(CRNN, device="cpu")
    return _LocalSession(model, header)


# -- the wire helpers and the security layer, across the packages -----------------


def test_wire_helpers_equal_the_jax_package():
    feats, audio = _features(0, 2), _speech_like(0, 1280)
    assert rv.encode_features(feats) == jax_rv.encode_features(feats)
    assert rv.encode_mel(feats) == jax_rv.encode_mel(feats)
    assert rv.encode_audio(audio) == jax_rv.encode_audio(audio)
    assert rv.decode_score('{"score": 0.25}') == 0.25
    assert rv._VALID_PIPELINES == jax_rv._VALID_PIPELINES


@pytest.mark.parametrize("issuer,verifier", [(sec, jax_sec), (jax_sec, sec)])
def test_token_of_one_package_verifies_in_the_other(issuer, verifier):
    def manager(module, secret):
        return module.SecurityManager(module.SecurityConfig(
            api_keys=["k"], enable_tokens=True, token_secret=secret))

    token = manager(issuer, "shared").issue_token()
    assert manager(verifier, "shared").verify_token(token)
    assert not manager(verifier, "another").verify_token(token)
    assert not manager(verifier, "shared").verify_token(token + "x")
    request = issuer.encode_token_request("k")
    assert verifier.is_token_request(request)
    assert verifier.decode_token_request(request) == "k"
    assert manager(verifier, "shared").verify_api_key("k")


def test_build_security_matches_the_jax_package():
    assert sec.build_security() is None
    kwargs = dict(api_keys=["a"], rate_limit=5, ip_allowlist=["10.0.0.0/8"])
    ours, ref = sec.build_security(**kwargs), jax_sec.build_security(**kwargs)
    assert ours.config.summary() == ref.config.summary()
    assert ours.ip_allowed("10.1.2.3") and not ours.ip_allowed("11.0.0.1")
    for _ in range(5):
        assert ours.record_request("1.2.3.4")
    assert not ours.record_request("1.2.3.4") and ours.is_banned("1.2.3.4")


# -- the scoring path without a socket --------------------------------------------


def test_reply_to_features_equals_scoring_alone(crnn_session):
    """Tag 0x01 through reply() and the batcher: the session's own score."""
    server = rv._ScoringServer(CRNN, "verifier_only", device="cpu")

    async def run():
        server.start()
        return [await server.reply(rv.encode_features(_features(s)), None)
                for s in range(3)]

    for seed, reply in enumerate(asyncio.run(run())):
        alone, _ = crnn_session.run(_features(seed))
        assert 0.0 <= _score(reply) <= 1.0
        assert abs(_score(reply) - alone) <= BATCH_TOL


def test_reply_without_batching_and_with_a_batch_of_two(crnn_session):
    server = rv._ScoringServer(CRNN, "verifier_only", batching=False,
                               device="cpu")
    assert server.batcher is None
    feats = _features(3, 2)
    reply = asyncio.run(server.reply(rv.encode_features(feats), None))
    # a message with a batch answers with its first row's score
    assert abs(_score(reply) - crnn_session.run(feats[:1])[0]) <= BATCH_TOL


def test_reply_to_mel_in_embedding_mode(crnn_session):
    """Tag 0x02: mel frames -> the shared encoder -> the newest window."""
    server = rv._ScoringServer(CRNN, "embedding", device="cpu")
    audio = torch.from_numpy(_speech_like(4, 32000))
    mel = melops.mel_frontend(audio[None].float()).numpy()     # [1, 200, 32]

    async def run():
        server.start()
        return (await server.reply(rv.encode_mel(mel), None),
                await server.reply(rv.encode_mel(mel[:, :100]), None),
                await server.reply(rv.encode_audio(_speech_like(5, 1280)),
                                   server.connection()))

    full, short, audio_reply = asyncio.run(run())
    with torch.no_grad():
        emb = server.frontend.encoder(torch.from_numpy(mel))[:, -16:]
    alone, _ = crnn_session.run(emb.numpy())
    assert abs(_score(full) - alone) <= BATCH_TOL and _score(full) > 0
    assert _score(short) == 0.0        # 100 frames give fewer than 16 windows
    assert _score(audio_reply) == 0.0  # 0x03 is served in full mode only


def test_mel_tag_is_ignored_in_verifier_mode():
    server = rv._ScoringServer(LITE, "verifier_only", device="cpu")
    mel = np.zeros((1, 200, 32), np.float32)
    assert server.connection() is None
    assert _score(asyncio.run(server.reply(rv.encode_mel(mel), None))) == 0.0


def test_full_connection_streams_like_the_frontend(crnn_session):
    """Tag 0x03: 25 chunks through one connection's state equal the same
    chunks through an AudioFeatures and the session, chunk by chunk."""
    server = rv._ScoringServer(CRNN, "full", device="cpu")
    clip = _speech_like(6, 1280 * 25)

    async def run():
        server.start()
        state = server.connection()
        return [_score(await server.reply(
            rv.encode_audio(clip[i:i + 1280]), state))
            for i in range(0, len(clip), 1280)]

    scores = asyncio.run(run())
    _, _, encoder = load_nww(CRNN, device="cpu")
    features = AudioFeatures(encoder_state_dict=encoder, device="cpu")
    for c, score in enumerate(scores):
        features(clip[c * 1280:(c + 1) * 1280])
        if c < 15:
            assert score == 0.0      # until 16 frames were emitted
            continue
        alone, _ = crnn_session.run(features.get_features(16))
        assert abs(score - alone) <= BATCH_TOL and score > 0


def test_connections_share_one_encoder():
    server = rv._ScoringServer(LITE, "full", device="cpu")
    a, b = server.connection(), server.connection()
    assert a.features.encoder is b.features.encoder is server.frontend.encoder
    assert a.features.state.feat_buf.data_ptr() != \
        b.features.state.feat_buf.data_ptr()
    # a half chunk gives no score yet; the state of `b` is untouched
    assert a.process(_speech_like(7, 640)) is None
    assert b.features.accumulated_samples == 0


class _CountingSession:
    """A session whose score is its input's first value, counting calls."""
    stateful = False

    def __init__(self):
        self.batch_sizes = []

    def run_batch(self, feats):
        self.batch_sizes.append(feats.shape[0])
        return feats[:, 0, 0].copy()


def test_batcher_gives_each_of_32_callers_its_own_score():
    session = _CountingSession()

    async def run():
        batcher = rv._DynamicBatcher(session, max_batch=256, max_wait_ms=50)
        batcher.start()
        return await asyncio.gather(*[
            batcher.score(np.full((1, 16, 96), i, np.float32))
            for i in range(32)])

    assert asyncio.run(run()) == [float(i) for i in range(32)]
    assert sum(session.batch_sizes) >= 32
    assert len(session.batch_sizes) < 32          # the requests coalesced
    # batches are padded to powers of two
    assert all(n & (n - 1) == 0 for n in session.batch_sizes)


def test_batcher_respects_max_batch_and_pads():
    session = _CountingSession()

    async def run():
        batcher = rv._DynamicBatcher(session, max_batch=8, max_wait_ms=50)
        batcher.start()
        return await asyncio.gather(*[
            batcher.score(np.full((1, 2, 2), i, np.float32))
            for i in range(21)])

    assert asyncio.run(run()) == [float(i) for i in range(21)]
    assert session.batch_sizes == [8, 8, 8]       # 8 + 8 + 5 padded to 8


def test_batcher_hands_a_failure_to_every_caller():
    class Failing:
        def run_batch(self, feats):
            raise RuntimeError("synthetic failure")

    async def run():
        batcher = rv._DynamicBatcher(Failing(), max_wait_ms=20)
        batcher.start()
        return await asyncio.gather(
            *[batcher.score(np.zeros((1, 2, 2), np.float32))
              for _ in range(3)], return_exceptions=True)

    assert all(isinstance(r, RuntimeError) for r in asyncio.run(run()))


def test_concurrent_requests_batched_equal_alone(crnn_session):
    """32 concurrent 0x01 requests on the real CRNN: each reply equals the
    same request scored alone within 1e-5, in fewer device calls."""
    server = rv._ScoringServer(CRNN, "verifier_only", batch_wait_ms=50,
                               device="cpu")
    calls = []
    run_batch = server.session.run_batch
    server.session.run_batch = lambda f: (calls.append(len(f)),
                                          run_batch(f))[1]

    async def run():
        server.start()
        return await asyncio.gather(*[
            server.reply(rv.encode_features(_features(100 + i)), None)
            for i in range(32)])

    replies = asyncio.run(run())
    assert len(calls) < 32
    alone = [crnn_session.run(_features(100 + i))[0] for i in range(32)]
    _assert_close([_score(r) for r in replies], alone, BATCH_TOL)


def test_server_arguments():
    with pytest.raises(ValueError, match="Invalid pipeline"):
        rv._ScoringServer(LITE, "nope", device="cpu")
    with pytest.raises(ValueError, match="Invalid pipeline"):
        rv.serve(LITE, pipeline="nope", device="cpu")
    with pytest.raises(TypeError, match="SecurityConfig"):
        rv.serve(LITE, security="yes", device="cpu")
    # data_parallel is accepted: serving is single-device
    server = rv._ScoringServer(LITE, data_parallel=4, device="cpu")
    assert server.device.type == "cpu" and server.n_frames == 16


# -- over a loopback socket (needs websockets) ----------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(serve, model, pipeline, **kwargs):
    pytest.importorskip("websockets")
    port = _free_port()
    ready = threading.Event()

    def run():
        serve(model_path=model, pipeline=pipeline, host="127.0.0.1",
              port=port, log_level="ERROR",
              _ready_callback=lambda srv: ready.set(), **kwargs)

    threading.Thread(target=run, daemon=True).start()
    assert ready.wait(timeout=120), "server did not start"
    return f"ws://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def jax_full_server():
    return _start(jax_rv.serve, CRNN, "full")


@pytest.fixture(scope="module")
def port_full_server():
    return _start(rv.serve, CRNN, "full", device="cpu")


def _exchange_all(uri, messages):
    import websockets

    async def run():
        async with websockets.connect(uri) as ws:
            out = []
            for m in messages:
                await ws.send(m)
                out.append(_score(await asyncio.wait_for(ws.recv(), 60)))
            return out

    return asyncio.run(run())


def test_reply_matches_the_jax_server_for_every_tag(jax_full_server):
    """The same 0x01, 0x02 and 0x03 messages to the JAX package's server
    over a socket and to the port's reply(): scores within 1e-3."""
    audio = torch.from_numpy(_speech_like(8, 32000))
    mel = melops.mel_frontend(audio[None].float()).numpy()
    clip = _speech_like(9, 1280 * 20)
    messages = ([rv.encode_features(_features(s)) for s in range(3)]
                + [rv.encode_mel(mel)]
                + [rv.encode_audio(clip[i:i + 1280])
                   for i in range(0, len(clip), 1280)])
    ref = _exchange_all(jax_full_server, messages)
    server = rv._ScoringServer(CRNN, "full", device="cpu")

    async def run():
        server.start()
        state = server.connection()
        return [_score(await server.reply(m, state)) for m in messages]

    ours = asyncio.run(run())
    _assert_close(ours, ref, SCORE_TOL)
    assert (np.array(ours[:4]) > 0).all() and np.count_nonzero(ours[4:]) == 5
    # and the port's own server over a socket says what reply() says


def test_port_server_over_a_socket_equals_reply(port_full_server):
    clip = _speech_like(9, 1280 * 20)
    messages = ([rv.encode_features(_features(0))]
                + [rv.encode_audio(clip[i:i + 1280])
                   for i in range(0, len(clip), 1280)])
    over_socket = _exchange_all(port_full_server, messages)
    server = rv._ScoringServer(CRNN, "full", device="cpu")

    async def run():
        server.start()
        state = server.connection()
        return [_score(await server.reply(m, state)) for m in messages]

    _assert_close(over_socket, asyncio.run(run()), BATCH_TOL)


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_one_wire_protocol(client, server, jax_full_server,
                           port_full_server, crnn_session):
    """Either package's `_RemoteSession` against the other's server:
    features and streamed audio score as the local session does (1e-3)."""
    uri = port_full_server if server == "port" else jax_full_server
    module = jax_rv if client == "jax" else rv
    session = module._RemoteSession(uri, "hey_nano_crnn", pipeline="full",
                                    timeout=60)
    try:
        assert session.feature_length == 16 and not session.stateful
        feats = _features(11)
        score, carry = session.run(feats)
        assert carry is None
        _assert_close(score, crnn_session.run(feats)[0], SCORE_TOL)
        # the onnxruntime calling convention
        (out,) = session.run(None, {"input": feats})
        assert out.shape == (1, 1, 1) and abs(out[0, 0, 0] - score) <= 1e-6
        clip = _speech_like(12, 1280 * 18)
        streamed = [session.run_audio(clip[i:i + 1280])
                    for i in range(0, len(clip), 1280)]
        assert streamed[:15] == [0.0] * 15 and all(s > 0
                                                   for s in streamed[15:])
        _, _, encoder = load_nww(CRNN, device="cpu")
        features = AudioFeatures(encoder_state_dict=encoder, device="cpu")
        features(clip)
        local, _ = crnn_session.run(features.get_features(16))
        _assert_close(streamed[-1], local, SCORE_TOL)
    finally:
        session.close()


def test_secured_port_server_token_flow():
    import websockets
    security = sec.SecurityConfig(api_keys=["sekrit"], enable_tokens=True)
    uri = _start(rv.serve, LITE, "verifier_only", security=security,
                 device="cpu")
    with pytest.raises(Exception):
        _exchange_all(uri, [rv.encode_features(_features(0))])
    session = rv._RemoteSession(uri, "m", api_key="sekrit", timeout=60)
    try:
        token = session.request_token("sekrit")
        assert token and session.run(_features(0))[0] > 0
    finally:
        session.close()
    # the JAX package's client with the token that the port's server issued
    session = jax_rv._RemoteSession(uri, "m", token=token, timeout=60)
    try:
        assert session.run(_features(0))[0] > 0
    finally:
        session.close()

    async def bad_key():
        async with websockets.connect(
                uri, additional_headers={"X-API-Key": "sekrit"}) as ws:
            await ws.send(sec.encode_token_request("wrong"))
            return json.loads(await asyncio.wait_for(ws.recv(), 60))

    assert "error" in asyncio.run(bad_key())


def test_interpreter_with_a_remote_verifier(port_full_server):
    """A local gate with the verifier behind the socket scores as the local
    cascade does; the general path serves it (no one-call step)."""
    clip = _speech_like(13, 16000 * 2)
    local = NanoInterpreter.load_model(CRNN, cascade=True,
                                       gate_threshold=0.0, device="cpu")
    remote = NanoInterpreter.load_model(LITE, gate_threshold=0.0,
                                        remote_verifier=port_full_server,
                                        remote_timeout=60, device="cpu")
    try:
        assert remote._fused_step is None and remote.info["is_remote"]
        assert remote.info["remote_uri"] == port_full_server
        assert remote.model_name == "hey_nano_crnn"
        assert remote.gate_name == "hey_nano_crnn_lite"
        a, b = local.predict_clip(clip), remote.predict_clip(clip)
        for attr in ("gate_score", "score"):
            _assert_close([getattr(r, attr) for r in b],
                          [getattr(r, attr) for r in a], BATCH_TOL)
        assert b[-1].score > 0
        # the verifier is not asked while the gate is low
        remote.cascade_config["gate_threshold"] = 2.0
        remote.reset()
        assert all(r.score == 0.0 for r in remote.predict_clip(clip))
    finally:
        remote.models["hey_nano_crnn"].close()


def test_interpreter_with_no_local_model(port_full_server):
    """load_model(None, remote_verifier=...): raw audio goes to the server,
    which streams it through a connection of its own."""
    interp = NanoInterpreter.load_model(
        None, remote_verifier=port_full_server, remote_pipeline="full",
        remote_timeout=60, device="cpu")
    try:
        assert interp.preprocessor is None and interp._fused_step is None
        assert interp.model_name == "remote_model" and not interp.is_cascade
        clip = _speech_like(14, 1280 * 24)
        scores = [r.score for r in interp.predict_clip(clip)]
        # 15 chunks of warm-up on the server, then the first 5 predictions
        # zeroed by the interpreter
        assert scores[:5] == [0.0] * 5 and all(s > 0 for s in scores[15:])
        assert interp.raw_scores["remote_model"] == scores[-1]
        interp.reset()
        assert interp.score == 0.0
    finally:
        interp.models["remote_model"].close()
