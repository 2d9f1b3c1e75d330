"""The port's ONNX slice against the JAX package, on the CPU at small widths.

Export: for the same weights (carried across with convert.py), the port's
graph of every family equals the JAX exporter's node for node and byte for
byte; only the producer and the doc strings differ. Runtime: the port's
torch runtime (`OnnxTorchModel`) scores those bytes as `onnx_jax` does and
as the port's module does, within 1e-5; the port's numpy evaluator equals
the JAX package's exactly. Frontend: the hand-built graphs against the JAX
package's jaxpr-lowered ones through the same evaluator (1e-4), and the
streaming pair against the bulk graph (1e-5). Then the entry points:
NanoInterpreter, the server, `--info` and the trainer's exports.
"""

import asyncio
import functools
import json
import os
import shutil
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanowakeword_tpu.export import frontend as jax_frontend
from nanowakeword_tpu.export import onnx_eval as jax_eval
from nanowakeword_tpu.export.onnx_export import build_onnx as jax_build_onnx
from nanowakeword_tpu.export.onnx_jax import OnnxJaxModel
from nanowakeword_tpu.interpreter import nanointerpreter as jax_interp
from nanowakeword_tpu_torch import NanoInterpreter
from nanowakeword_tpu_torch.data.features import default_encoder_variables
from nanowakeword_tpu_torch.export import frontend as FE
from nanowakeword_tpu_torch.export import onnx_eval
from nanowakeword_tpu_torch.export import onnx_proto as P
from nanowakeword_tpu_torch.export.artifact import (export_onnx_model,
                                                    load_nww, save_nww)
from nanowakeword_tpu_torch.export.onnx_export import (DYNAMIC_BATCH_TYPES,
                                                       SUPPORTED_TYPES,
                                                       build_onnx)
from nanowakeword_tpu_torch.export.onnx_torch import OnnxTorchModel
from nanowakeword_tpu_torch.interpreter import remote_verifier as rv
from nanowakeword_tpu_torch.interpreter.nanointerpreter import _OnnxSession
from nanowakeword_tpu_torch.models.model import Model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRNN = os.path.join(ROOT, "campaign", "hey_nano_crnn.nww")
RUNTIME_TOL = 1e-5   # f32 graph in two runtimes, and against the module
INT8_TOL = 0.02      # an int8 graph against the float32 module (the JAX
                     # package's bar, tests/test_onnx_export.py)
FEATURE_TOL = 1e-4   # frontend graphs: build_onnx_from_fn's atol
STREAM_TOL = 1e-5    # the streaming pair against the bulk graph
CASCADE_TOL = 1e-4   # tests/test_onnx_jax.py's .onnx-vs-.nww score bar
SCORE_TOL = 1e-3     # the score-trace bar (numpy frontend vs the f32 one)

SMALL_CONFIG = {
    "activation_function": "gelu",
    "embedding_dim": 32,
    "transformer_d_model": 32, "transformer_n_head": 2,
    "conformer_d_model": 32, "conformer_n_head": 2,
    "branchformer_d_model": 32, "branchformer_n_head": 2,
    "crnn_cnn_channels": [8, 16], "crnn_rnn_type": "gru",
    "tcn_channels": [16, 32], "tcn_kernel_size": 3,
    "quartznet_config": [[32, 9, 1], [32, 8, 1], [64, 9, 1]],
}
BUILD = dict(layer_dim=16, n_blocks=2, dropout_prob=0.0)
CASES = [(t, None) for t in SUPPORTED_TYPES] + [
    (t, "int8") for t in ("dnn", "crnn", "streaming_gru")]
CASE_IDS = [t + ("-int8" if wd else "") for t, wd in CASES]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny graphs' many small ops otherwise spin
    torch's thread pool against the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomized(tree, rng):
    """The same flax tree with biases, norm scales and running statistics
    redrawn, so that all of them take part in a comparison."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = _randomized(leaf, rng)
        elif name in ("var", "scale"):
            out[name] = rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        elif name in ("bias", "mean", "recurrent_bias"):
            out[name] = rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        else:
            out[name] = leaf
    return out


@functools.lru_cache(maxsize=None)
def _models(model_type):
    """(what the JAX exporter reads of a Model, the port's Model), with the
    same randomized weights: a flax variables tree drawn from seed 5,
    carried into the port by convert.py (`load_variables`) and back out by
    the port's exporter (`Model.variables`). The JAX exporter reads a
    Model's attributes only, so it is handed the tree itself rather than
    a flax Model, whose initialization takes seconds per family here."""
    pm = Model(config=dict(SMALL_CONFIG), model_name="t",
               input_shape=(16, 96), model_type=model_type, device="cpu",
               seed=5, **BUILD)
    variables = _randomized(pm.variables, np.random.default_rng(3))
    pm.load_variables(variables)
    jm = SimpleNamespace(model_type=model_type, model_name="t",
                         config=dict(SMALL_CONFIG), input_shape=(16, 96),
                         n_classes=1, variables=variables,
                         params=variables["params"])
    return jm, pm


@functools.lru_cache(maxsize=None)
def _graphs(model_type, weights_dtype):
    """(the JAX exporter's bytes, the port's bytes) for one case."""
    jm, pm = _models(model_type)
    return (jax_build_onnx(jm, weights_dtype=weights_dtype),
            build_onnx(pm, weights_dtype=weights_dtype))


def _feed(data: bytes, batch=2, seed=0):
    """Seeded inputs in the graph's input shapes (a symbolic batch of
    `batch`); a stateful graph's state in [-1, 1]."""
    rng = np.random.default_rng(seed)
    feed = {}
    for vi in P.load_model(data).graph.inputs:
        shape = [batch if isinstance(d, str) else d for d in vi.shape]
        scale = 0.5 if vi.name in ("hidden_in", "cell_in") else 1.0
        feed[vi.name] = rng.normal(0, scale, shape).astype(np.float32)
    return feed


# -- export ---------------------------------------------------------------------


def _fields(data: bytes, skip):
    return {k: v for k, v in P.parse_message(data).items() if k not in skip}


@pytest.mark.parametrize("model_type,weights_dtype", CASES, ids=CASE_IDS)
def test_graph_equals_the_jax_exporters(model_type, weights_dtype):
    """Nodes, attributes, initializers (names, dtypes, raw bytes), inputs
    and outputs equal; the ModelProto differs in producer and doc only."""
    ref, ours = _graphs(model_type, weights_dtype)
    a, b = P.load_model(ref), P.load_model(ours)
    assert (a.producer, b.producer) == ("nanowakeword_tpu",
                                        "nanowakeword_tpu_torch")
    assert (a.ir_version, a.opsets) == (b.ir_version, b.opsets)
    ga, gb = a.graph, b.graph
    assert ga.name == gb.name
    assert [(n.op_type, n.inputs, n.outputs, n.name, n.attrs)
            for n in ga.nodes] == [(n.op_type, n.inputs, n.outputs, n.name,
                                    n.attrs) for n in gb.nodes]
    assert list(ga.initializers) == list(gb.initializers)
    for name, arr in ga.initializers.items():
        other = gb.initializers[name]
        assert (arr.dtype, arr.shape) == (other.dtype, other.shape), name
        assert arr.tobytes() == other.tobytes(), name
    for x, y in ((ga.inputs, gb.inputs), (ga.outputs, gb.outputs)):
        assert [(v.name, v.shape) for v in x] == [(v.name, v.shape)
                                                  for v in y]
    # and byte for byte, producer (2) and doc strings (6; graph's 10) aside
    ma, mb = _fields(ref, {2, 6}), _fields(ours, {2, 6})
    assert _fields(ma.pop(7)[0], {10}) == _fields(mb.pop(7)[0], {10})
    assert ma == mb
    if weights_dtype == "int8":
        assert any(n.op_type == "DequantizeLinear" for n in gb.nodes)


@pytest.mark.parametrize("model_type,weights_dtype", CASES, ids=CASE_IDS)
def test_runtime_matches_onnx_jax_and_the_module(model_type, weights_dtype):
    ours = _graphs(model_type, weights_dtype)[1]
    feed = _feed(ours)
    runtime = OnnxTorchModel(ours, device="cpu")
    names = runtime.output_names
    got = runtime.run(names, feed)
    ref = OnnxJaxModel(ours).run(names, feed)
    for name, g, r in zip(names, got, ref):
        assert g.shape == r.shape and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=0, atol=RUNTIME_TOL,
                                   err_msg=name)
    pm = _models(model_type)[1]
    x = next(iter(feed.values()))
    with torch.no_grad():
        if model_type == "streaming_gru":       # one carry per layer
            carry = tuple(torch.from_numpy(feed["hidden_in"]))
            logits, new_carry = pm.module(torch.from_numpy(x), carry)
            module_out = [torch.sigmoid(logits), torch.stack(new_carry),
                          torch.from_numpy(feed["cell_in"])]
        else:
            module_out = [torch.sigmoid(pm(x))]
    tol = INT8_TOL if weights_dtype == "int8" else RUNTIME_TOL
    for g, m in zip(got, module_out):
        np.testing.assert_allclose(g, m.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("model_type,weights_dtype", CASES, ids=CASE_IDS)
def test_evaluator_equals_the_jax_packages(model_type, weights_dtype):
    ours = _graphs(model_type, weights_dtype)[1]
    feed = _feed(ours, seed=1)
    got, ref = onnx_eval.run(ours, feed), jax_eval.run(ours, feed)
    assert list(got) == list(ref)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name])


@pytest.mark.parametrize("model_type", SUPPORTED_TYPES)
def test_batch_scores_as_its_rows_do_alone(model_type, tmp_path):
    """`run_batch` reads the graph's batch dimension: one call for a
    symbolic one (every family but streaming_gru), row by row for 1."""
    path = tmp_path / "m.onnx"
    path.write_bytes(_graphs(model_type, None)[1])
    session = _OnnxSession(str(path), device="cpu")
    assert session.stateful == (model_type == "streaming_gru")
    assert session.feature_length == 16
    dynamic = session._model.input_shape[0] == "batch_size"
    assert dynamic == (model_type in DYNAMIC_BATCH_TYPES)
    x = np.random.default_rng(2).normal(0, 1, (3, 16, 96)).astype(np.float32)
    batch = session.run_batch(x)
    alone = np.array([session.run(row[None])[0] for row in x])
    assert batch.shape == (3,)
    np.testing.assert_allclose(batch, alone, rtol=0, atol=RUNTIME_TOL)


def test_run_batch_raises_rather_than_falling_back(tmp_path):
    """A fixed batch other than 1 raises, and so does a fault inside the
    graph: no error turns into row-by-row scoring."""
    path = tmp_path / "m.onnx"
    path.write_bytes(_graphs("dnn", None)[1])
    session = _OnnxSession(str(path), device="cpu")
    with pytest.raises(RuntimeError):
        session.run_batch(np.zeros((2, 16, 95), np.float32))
    session._model.input_shape[0] = 2
    with pytest.raises(ValueError, match="fixed batch of 2"):
        session.run_batch(np.zeros((2, 16, 96), np.float32))


def test_unknown_op_raises_naming_it():
    graph = P.graph([P.node("Swizzle", ["features"], ["score"])], "g",
                    [P.value_info("features", (1, 4))],
                    [P.value_info("score", (1, 4))], [])
    runtime = OnnxTorchModel(P.model(graph), device="cpu")
    with pytest.raises(NotImplementedError, match="'Swizzle'"):
        runtime(np.zeros((1, 4), np.float32))


def test_custom_model_exports_nothing(tmp_path, capsys):
    """A custom module with an op that has no ONNX lowering writes no
    `.onnx`: the export is logged and skipped, naming the op (a custom
    module that lowers is exported: tests/test_torch_fx_onnx.py)."""
    src = tmp_path / "my_arch.py"
    src.write_text(
        "import torch\n"
        "class MyNet(torch.nn.Module):\n"
        "    def __init__(self, input_shape, embedding_dim):\n"
        "        super().__init__()\n"
        "        self.a = torch.nn.Linear(input_shape[0] * input_shape[1],\n"
        "                                 embedding_dim)\n"
        "    def forward(self, x):\n"
        "        return self.a(torch.cumsum(x, 1).flatten(1))\n")
    cfg = {"custom_model_config": {"module_path": str(src),
                                   "class_name": "MyNet"}}
    model = Model(config=cfg, model_name="c", model_type="custom",
                  device="cpu")
    assert export_onnx_model(model, (16, 96), cfg, "c", str(tmp_path)) is None
    assert not (tmp_path / "c.onnx").exists()
    assert "ONNX export skipped: op cumsum has no ONNX lowering" in " ".join(
        capsys.readouterr().out.split())


# -- the feature frontend ---------------------------------------------------------


@pytest.fixture(scope="module")
def frontend(tmp_path_factory):
    """The port's three graphs and the JAX package's, from the bundled
    encoder, for 1 s clips."""
    variables = default_encoder_variables()
    out = {}
    for pkg, export in (("port", FE.export_frontend_onnx),
                        ("jax", jax_frontend.export_frontend_onnx)):
        root = tmp_path_factory.mktemp(f"frontend_{pkg}")
        paths = export(variables, 16000, "probe", str(root))
        out[pkg] = dict(zip(("bulk", "mel", "emb"), paths),
                        prefix=str(root / "probe"))
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _frontend_audio(kind):
    if kind == "seed7":       # tests/test_frontend_onnx.py's audio
        return np.random.default_rng(7).integers(
            -12000, 12000, (3, 16000)).astype(np.float32)
    return FE.seeded_audio(3, 16000, seed=11)


@pytest.mark.parametrize("kind", ["seed7", "tones"])
def test_bulk_frontend_matches_the_jax_graph(frontend, kind):
    """Both bulk graphs through the JAX package's evaluator. (The bundled
    encoder's output is constant on seed 7's white noise, so the tones are
    what reach its weights.)"""
    audio = _frontend_audio(kind)
    got = jax_eval.run(_read(frontend["port"]["bulk"]),
                       {"audio": audio})["features"]
    want = jax_eval.run(_read(frontend["jax"]["bulk"]),
                        {"audio": audio})["features"]
    assert got.shape == want.shape == (3, 3, 96)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_TOL)
    if kind == "tones":
        assert np.abs(got[0] - got[1]).max() > 0.1


@pytest.mark.parametrize("graph", ["mel", "emb"])
def test_step_graphs_match_the_jax_graphs(frontend, graph):
    audio = FE.seeded_audio(1, 1600, seed=12)[0]
    if graph == "mel":
        feed = {"mel_tail": audio[:320], "chunk": audio[320:]}
    else:
        mel = jax_eval.run(_read(frontend["port"]["mel"]),
                           {"mel_tail": audio[:320], "chunk": audio[320:]})
        window = np.concatenate([np.ones((68, 32), np.float32),
                                 mel["frames"]])
        feed = {"mel_window": window}
    got = jax_eval.run(_read(frontend["port"][graph]), feed)
    want = jax_eval.run(_read(frontend["jax"][graph]), feed)
    assert list(got) == list(want)
    for name in want:
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=FEATURE_TOL, err_msg=name)


def test_streaming_pair_reproduces_the_bulk_graph(frontend):
    audio = _frontend_audio("tones")
    bulk = onnx_eval.run(_read(frontend["port"]["bulk"]),
                         {"audio": audio[:1]})["features"][0]
    stream = FE.OnnxStreamingFrontend(frontend["port"]["mel"],
                                      frontend["port"]["emb"])
    assert stream(audio[0]) == (16000 // FE.CHUNK) * FE.CHUNK
    got = stream.get_features(bulk.shape[0])[0]
    np.testing.assert_allclose(got, bulk, rtol=0, atol=STREAM_TOL)
    assert stream.frames_available == stream.feature_buffer.shape[0]
    stream.reset()
    assert stream.frames_seen == 0 and stream.feature_buffer.shape[0] == 0
    assert stream.frames_available == 0


def test_export_check_raises_on_a_tampered_graph(monkeypatch):
    log_mel = FE._log_mel
    monkeypatch.setattr(FE, "_log_mel", lambda g, rows, t: g.const_mul(
        log_mel(g, rows, t), 1.001, "tamper"))
    with pytest.raises(FE.FrontendExportError, match="misses"):
        FE.build_mel_stream_onnx("tampered")


@pytest.fixture(scope="module")
def cascade_onnx(tmp_path_factory):
    """The shipped cascade exported to `.onnx` by the port."""
    root = tmp_path_factory.mktemp("cascade_onnx")
    for name in ("hey_nano_crnn", "hey_nano_crnn_lite"):
        _, model, _ = load_nww(os.path.join(ROOT, "campaign",
                                            name + ".nww"), device="cpu")
        assert export_onnx_model(model, model.input_shape, {}, name,
                                 str(root)) == str(root / (name + ".onnx"))
    return str(root / "hey_nano_crnn.onnx")


def _speech_like(seed, n):
    return np.clip(np.random.default_rng(seed).normal(0, 3000, n),
                   -32768, 32767).astype(np.int16)


def _trace(results, attr="score"):
    return np.array([getattr(r, attr) for r in results])


def test_interpreter_onnx_frontend_matches_jax(frontend, cascade_onnx):
    """The numpy frontend pair and the `.onnx` classifier in both
    packages' interpreters, on the same files."""
    clip = FE.seeded_audio(1, 32000, seed=13)[0].astype(np.int16)
    prefix = frontend["port"]["prefix"]
    ours = NanoInterpreter.load_model(cascade_onnx, device="cpu",
                                      onnx_frontend=prefix)
    ref = jax_interp.NanoInterpreter.load_model(cascade_onnx,
                                                onnx_frontend=prefix)
    assert isinstance(ours.preprocessor, FE.OnnxStreamingFrontend)
    assert ours._fused_step is None
    a, b = _trace(ours.predict_clip(clip)), _trace(ref.predict_clip(clip))
    assert len(a) == len(b) == 25 and (a[15:] > 0).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=SCORE_TOL)
    # a (mel, embedding) pair works as the prefix does
    pair = NanoInterpreter.load_model(
        cascade_onnx, device="cpu",
        onnx_frontend=(frontend["port"]["mel"], frontend["port"]["emb"]))
    np.testing.assert_array_equal(_trace(pair.predict_clip(clip)), a)


# -- the interpreter, the server, the CLI ------------------------------------------


def test_onnx_cascade_matches_the_jax_interpreter(cascade_onnx):
    """The `.onnx` pair, the `_lite.onnx` gate found by auto-discovery,
    streamed in both packages with float32 frontends."""
    clip = _speech_like(5, 16000 * 3)
    ours = NanoInterpreter.load_model(cascade_onnx, cascade=True,
                                      gate_threshold=0.0, device="cpu",
                                      compute_dtype=torch.float32)
    ref = jax_interp.NanoInterpreter.load_model(
        cascade_onnx, cascade=True, gate_threshold=0.0,
        compute_dtype=jnp.float32)
    assert ours.gate_name == "hey_nano_crnn_lite" and ours.is_cascade
    assert ours._fused_step is None
    out, want = ours.predict_clip(clip), ref.predict_clip(clip)
    for attr in ("gate_score", "score"):
        a, b = _trace(out, attr), _trace(want, attr)
        assert len(a) == len(b) == 38 and (a[15:] > 0).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=CASCADE_TOL)


def test_onnx_cascade_scores_as_the_nww_cascade(cascade_onnx):
    clip = _speech_like(6, 16000 * 3)
    runs = [NanoInterpreter.load_model(path, cascade=True,
                                       gate_threshold=0.0, device="cpu")
            .predict_clip(clip) for path in (cascade_onnx, CRNN)]
    for attr in ("gate_score", "score"):
        np.testing.assert_allclose(_trace(runs[0], attr),
                                   _trace(runs[1], attr), rtol=0,
                                   atol=CASCADE_TOL)


def test_nww_verifier_finds_a_lite_onnx_gate(cascade_onnx, tmp_path):
    shutil.copy(CRNN, tmp_path / "big.nww")
    shutil.copy(cascade_onnx.replace(".onnx", "_lite.onnx"),
                tmp_path / "big_lite.onnx")
    interp = NanoInterpreter.load_model(str(tmp_path / "big.nww"),
                                        cascade=True, device="cpu")
    assert interp.is_cascade and interp.gate_name == "big_lite"
    assert isinstance(interp.models["big_lite"], _OnnxSession)
    assert interp._fused_step is None
    assert len(interp.predict_clip(_speech_like(7, 16000))) == 13


def test_stateful_onnx_threads_its_state_like_jax(tmp_path):
    """streaming_gru: 20 calls threading hidden_in / cell_in in both
    packages' sessions on the same bytes, and the port's interpreter
    on the `.onnx` against the same model's `.nww`, both on the general
    path."""
    path = tmp_path / "sg.onnx"
    path.write_bytes(_graphs("streaming_gru", None)[1])
    ours = _OnnxSession(str(path), device="cpu")
    ref = jax_interp._OnnxSession(str(path))
    assert ours.stateful and ref.stateful
    x = np.random.default_rng(4).normal(0, 1, (20, 1, 16, 96)).astype(
        np.float32)
    carry_a = carry_b = None
    for frame in x:
        sa, carry_a = ours.run(frame, carry_a)
        sb, carry_b = ref.run(frame, carry_b)
        assert abs(sa - sb) <= RUNTIME_TOL
    assert isinstance(carry_a[0], torch.Tensor)
    np.testing.assert_allclose(carry_a[0].numpy(), carry_b[0], rtol=0,
                               atol=RUNTIME_TOL)

    pm = _models("streaming_gru")[1]
    nww = save_nww(str(tmp_path / "sg.nww"), model=pm, config=SMALL_CONFIG,
                   model_name="sg")
    clip = _speech_like(8, 16000 * 2)
    traces = []
    for p in (str(path), nww):
        interp = NanoInterpreter.load_model(p, device="cpu")
        assert interp.is_stateful == {"sg": True}
        # the `.nww` through the general path too: the one-call step
        # threads the carry through the warm-up chunks as well
        interp._fused_step = None
        traces.append(_trace(interp.predict_clip(clip)))
    np.testing.assert_allclose(traces[0], traces[1], rtol=0,
                               atol=RUNTIME_TOL)


def test_serve_onnx_answers_as_the_jax_server(cascade_onnx):
    """The `.onnx` CRNN behind both packages' servers: feature requests
    (tag 0x01) alone and coalesced by the batcher."""
    import threading

    websockets = pytest.importorskip("websockets")
    from nanowakeword_tpu.interpreter import remote_verifier as jax_rv

    port_no = _free_port()
    ready = threading.Event()
    threading.Thread(target=lambda: jax_rv.serve(
        cascade_onnx, host="127.0.0.1", port=port_no, log_level="ERROR",
        _ready_callback=lambda srv: ready.set()), daemon=True).start()
    assert ready.wait(timeout=120)
    rng = np.random.default_rng(9)
    messages = [rv.encode_features(rng.normal(0, 1, (1, 16, 96)).astype(
        np.float32)) for _ in range(6)]

    async def jax_replies():
        async with websockets.connect(f"ws://127.0.0.1:{port_no}") as ws:
            out = []
            for m in messages:
                await ws.send(m)
                out.append(rv.decode_score(await asyncio.wait_for(
                    ws.recv(), 60)))
            return out

    server = rv._ScoringServer(cascade_onnx, device="cpu")
    assert isinstance(server.session, _OnnxSession)
    assert server.model_name == "hey_nano_crnn"

    async def replies():
        server.start()
        return [rv.decode_score(r) for r in await asyncio.gather(
            *[server.reply(m, None) for m in messages])]

    ref, ours = asyncio.run(jax_replies()), asyncio.run(replies())
    assert all(0 < s < 1 for s in ours)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=RUNTIME_TOL)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_info_prints_the_jax_clis_lines(cascade_onnx, capsys):
    from nanowakeword_tpu import cli as jax_cli
    from nanowakeword_tpu_torch import cli

    lite = cascade_onnx.replace(".onnx", "_lite.onnx")
    for path in (cascade_onnx, lite):
        cli.main(["--info", path])
        ours = capsys.readouterr().out.splitlines()
        jax_cli._run_info(path)
        ref = capsys.readouterr().out.splitlines()
        assert len(ours) == len(ref) > 10
        assert [l for l in ours if "Path" not in l] == [
            l for l in ref if "Path" not in l]
        assert any("ONNX (opset 17" in l for l in ours)


# -- the trainer's exports ------------------------------------------------------------


def test_train_and_distill_write_the_onnx_files(tmp_path):
    """A tiny `-T -d` through run_pipeline writes the `.onnx`, the three
    frontend graphs and the int8 `_lite.onnx` beside the `.nww` files; the
    `.onnx` scores as the `.nww` does."""
    from nanowakeword_tpu_torch.trainer import run_pipeline

    rng = np.random.default_rng(1)
    for name, shift, rows in (("pos", 1.0, 8), ("neg", 0.0, 16)):
        np.save(tmp_path / f"{name}.npy",
                rng.normal(size=(rows, 16, 96)).astype(np.float32) + shift)
    cfg = {"model_name": "tiny", "output_dir": str(tmp_path / "out"),
           "model_type": "dnn", "layer_size": 8, "n_blocks": 1,
           "embedding_dim": 16, "activation_function": "relu", "steps": 4,
           "early_stopping_patience": 0, "show_training_summary": False,
           "batch_composition": {"targets": 2, "negatives": 4},
           "distillation": {"steps": 4, "log_interval": 2,
                            "weights_dtype": "int8"},
           "feature_manifest": {
               "targets": {"t": str(tmp_path / "pos.npy")},
               "negatives": {"n": str(tmp_path / "neg.npy")}}}
    out = run_pipeline(cfg, train_model=True, distill=True, device="cpu")
    model_dir = os.path.dirname(out["artifact"])
    for suffix in (".onnx", "_frontend.onnx", "_mel_stream.onnx",
                   "_embedding.onnx", "_lite.onnx", "_lite.nww"):
        assert os.path.exists(os.path.join(model_dir, "tiny" + suffix)), \
            suffix
    lite = P.load_model(os.path.join(model_dir, "tiny_lite.onnx"))
    assert any(n.op_type == "DequantizeLinear" for n in lite.graph.nodes)
    # the default 16 frames: ((16 - 1) * 8 + 76 + 4) * 160 samples
    bulk = P.load_model(os.path.join(model_dir, "tiny_frontend.onnx"))
    assert bulk.graph.inputs[0].shape == ["batch_size", 32000]
    x = np.random.default_rng(2).normal(0, 1, (4, 16, 96)).astype(np.float32)
    onnx = _OnnxSession(os.path.join(model_dir, "tiny.onnx"), device="cpu")
    with torch.no_grad():
        want = torch.sigmoid(out["model"](x)).numpy().reshape(-1)
    np.testing.assert_allclose(onnx.run_batch(x), want, rtol=0,
                               atol=RUNTIME_TOL)
