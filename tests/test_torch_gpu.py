"""The port on a CUDA device: the mel and mix kernels against their plain
versions, the serving path on the card against the same port on the CPU
(batch, the streaming cascade through the replayed one-call step, a
stateful model, the server's scoring path), the augmentation chain
launching the mix kernel, end-to-end training's module and step, whose
forward launches the mel kernel, `.onnx` graphs on the card: the torch
runtime against the CPU, and an `.onnx` cascade behind the mel kernel, and
the quality campaign's evaluator: the card against the CPU, one graph
capture per interpreter across files, the benchmark's forward: the card
against the CPU, one mel launch per replay of its captured graph, and the
tracer's device times: the captured step's replay span against the graph's
own time, and the bulk path's timed spans.

Every test here is `gpu`-marked and skips without a CUDA device. On a
machine with one: `python -m pytest -m gpu tests/test_torch_gpu.py -q`.
This file imports only torch and the port (not the JAX package), so it runs
where flax is not installed.
"""

import os

import numpy as np
import pytest
import torch

from nanowakeword_tpu_torch import AudioFeatures, NanoInterpreter
from nanowakeword_tpu_torch.export.artifact import load_nww
from nanowakeword_tpu_torch.interpreter.nanointerpreter import _LocalSession
from nanowakeword_tpu_torch.ops import augment as TA
from nanowakeword_tpu_torch.ops import mel as TM
from nanowakeword_tpu_torch.ops import mel_cuda, mix_cuda
from test_torch_tracing import _gate_crossing_clip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRNN = os.path.join(ROOT, "campaign", "hey_nano_crnn.nww")
# kernel vs plain on float audio: the repo's bar (tests/test_mel_pallas.py);
# on int16 audio the kernel must equal the plain version bit for bit
KERNEL_TOL = 2e-3
# card vs CPU: f32 features through differently ordered sums, and the
# score-trace bar of tests/test_score_trace.py for scores
FEATURE_TOL = 1e-4
SCORE_TOL = 1e-3
# mix kernel vs plain: tests/test_mix_pallas.py's 2 ulp of the peak; the
# kernel rounds as the plain version does, so 0 is expected
MIX_ULPS = 2.0 ** -22

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _audio(rng, shape, dtype=np.int16):
    return rng.integers(-20000, 20000, shape).astype(dtype)


@pytest.mark.parametrize("shape,dtype,kind", [
    ((1, 16000), torch.float32, None), ((4, 16000), torch.int16, None),
    ((5, 12345), torch.float32, None), ((16000,), torch.float32, None),
    ((2, 16000), torch.bfloat16, None), ((1600,), torch.float32, None),
    ((256, 32000), torch.int16, None),
] + [(shape, torch.int16, kind) for shape in [(3, 48000), (1024, 32000)]
     for kind in mel_cuda.INT16_EDGES])
def test_kernel_matches_plain(rng, cuda, shape, dtype, kind):
    if kind is None:
        x = torch.from_numpy(_audio(rng, shape)).to(cuda).to(dtype)
    else:
        x = torch.from_numpy(mel_cuda.int16_edge_audio(rng, shape,
                                                       kind)).to(cuda)
    before = mel_cuda.launches
    out = mel_cuda.mel_frontend_fused(x)
    torch.cuda.synchronize()
    assert mel_cuda.launches == before + 1
    ref = mel_cuda.mel_frontend_plain(x)
    assert out.shape == ref.shape and out.dtype == torch.float32
    tol = 0.0 if dtype == torch.int16 else KERNEL_TOL
    assert (out - ref).abs().max().item() <= tol


def test_kernel_bf16_output_equals_cast_f32(rng, cuda):
    x = torch.from_numpy(_audio(rng, (4, 16000))).to(cuda)
    f32 = mel_cuda.mel_frontend_cuda(x)
    b16 = mel_cuda.mel_frontend_cuda(x, out_dtype=torch.bfloat16)
    assert b16.dtype == torch.bfloat16
    assert torch.equal(b16, f32.to(torch.bfloat16))


def test_kernel_int16_equals_float(rng, cuda):
    x = torch.from_numpy(_audio(rng, (4, 16000))).to(cuda)
    assert torch.equal(mel_cuda.mel_frontend_cuda(x),
                       mel_cuda.mel_frontend_cuda(x.float()))


def test_kernel_streaming_equals_batch(rng, cuda):
    """The kernel's per-row arithmetic does not depend on a row's place in
    its tile, so the streaming form equals the batch form bit for bit."""
    x = torch.from_numpy(_audio(rng, 16000 * 2, np.float32)).to(cuda)
    batch = mel_cuda.mel_frontend_cuda(x)
    tail = torch.zeros(TM.LEFT_PAD, device=cuda)
    frames = []
    for c in range(x.shape[0] // TM.CHUNK):
        buf = torch.cat([tail, x[c * TM.CHUNK:(c + 1) * TM.CHUNK]])
        frames.append(mel_cuda.mel_frontend_cuda(buf)[2:])
        tail = buf[-TM.LEFT_PAD:]
    assert torch.equal(torch.cat(frames), batch[:len(frames) * 8])


def test_kernel_rejects_bad_input(cuda):
    with pytest.raises(TypeError):
        mel_cuda.mel_frontend_cuda(torch.zeros(1600, dtype=torch.float64,
                                               device=cuda))
    with pytest.raises(TypeError):
        mel_cuda.mel_frontend_cuda(torch.zeros(1600, device=cuda),
                                   out_dtype=torch.float16)
    with pytest.raises(ValueError):
        mel_cuda.mel_frontend_cuda(torch.zeros(2, 3200, device=cuda)[:, ::2])
    with pytest.raises(ValueError):
        mel_cuda.mel_frontend_cuda(torch.zeros(1, 2, 1600, device=cuda))


def test_batch_scoring_card_matches_cpu(rng, cuda):
    clips = _audio(rng, (16, 32000))
    scores = {}
    for device in (cuda, "cpu"):
        header, model, encoder = load_nww(CRNN, device=device)
        features = AudioFeatures(encoder_state_dict=encoder, device=device)
        feats = features.embed_clips(clips)
        scores[str(device)] = (feats,
                               _LocalSession(model, header).run_batch(feats))
    (feats, s), (feats_c, s_c) = scores["cuda"], scores["cpu"]
    np.testing.assert_allclose(feats, feats_c, atol=FEATURE_TOL)
    np.testing.assert_allclose(s, s_c, atol=SCORE_TOL)


def test_streaming_cascade_card_matches_cpu(cuda):
    clip = np.clip(np.random.default_rng(5).normal(0, 3000, 16000 * 3),
                   -32768, 32767).astype(np.int16)
    results = {}
    for device in (cuda, "cpu"):
        interp = NanoInterpreter.load_model(CRNN, cascade=True,
                                            gate_threshold=0.0,
                                            device=device)
        before = mel_cuda.launches
        out = interp.predict_clip(clip)
        results[str(device)] = (np.array([r.gate_score for r in out]),
                                np.array([r.score for r in out]),
                                mel_cuda.launches - before)
    gate, verifier, launches = results["cuda"]
    gate_c, verifier_c, launches_c = results["cpu"]
    assert launches == 37 and launches_c == 0    # one per whole chunk
    np.testing.assert_allclose(gate, gate_c, atol=SCORE_TOL)
    np.testing.assert_allclose(verifier, verifier_c, atol=SCORE_TOL)
    assert (verifier[15:] > 0).all()


def test_replayed_step_equals_eager_step(cuda):
    """load_model captures the one-call step; its replays equal the same
    step run eagerly bit for bit, launch the mel kernel once per chunk, and
    start from the reset state (the capture's warm-up left no trace)."""
    clip = np.clip(np.random.default_rng(6).normal(0, 3000, 16000 * 2),
                   -32768, 32767).astype(np.int16)
    interp = NanoInterpreter.load_model(CRNN, cascade=True,
                                        gate_threshold=0.0, device=cuda)
    step = interp._fused_step
    assert step.graph is not None and step.mel_launches_per_replay == 1
    pre = interp.preprocessor
    assert (pre.state.mel_buf == 1).all() and not pre.state.feat_buf.any()
    traces = []
    for use_graph in (True, False, True):
        step.use_graph = use_graph
        interp.reset()
        before = mel_cuda.launches
        out = interp.predict_clip(clip)
        assert mel_cuda.launches == before + 25
        traces.append(np.array([[r.gate_score, r.score] for r in out]))
    np.testing.assert_array_equal(traces[0], traces[1])
    np.testing.assert_array_equal(traces[0], traces[2])
    assert (traces[0][15:] > 0).all()


def test_split_step_graphs_equal_the_eager_split_step(cuda):
    """The shipped cascade at its 0.3 gate: load_model captures two graphs,
    the step without the verifier and the verifier alone. Over a clip on
    which the gate both opens and stays low, their replays serve what the
    same split step run eagerly serves, bit for bit. Each chunk launches
    the mel kernel once and replays one graph, each verifier run one more;
    with tracing on, each chunk has one `nww.step.replay` and one
    `nww.predict.readback` span, each verifier run one `nww.step.verifier`.
    A single model's interpreter still captures one graph."""
    from nanowakeword_tpu_torch.utils import tracing
    from nanowakeword_tpu_torch.utils.tracing import counters
    captures = counters["graph.captures"]
    interp = NanoInterpreter.load_model(CRNN, cascade=True, device=cuda)
    step = interp._fused_step
    assert counters["graph.captures"] == captures + 2
    assert step.verifier == "hey_nano_crnn"
    assert step.graph is not None and step.verifier_graph is not None
    assert step.mel_launches_per_replay == 1
    clip = _gate_crossing_clip()[:42 * 1280]
    n = len(clip) // 1280
    traces, runs = [], []
    for use_graph in (True, False, True):
        step.use_graph = use_graph
        interp.reset()
        before = dict(counters)
        with tracing.recording():
            out = interp.predict_clip(clip)
        snap = tracing.snapshot()
        grew = {k: counters[k] - before[k] for k in counters}
        traces.append(np.array([[r.gate_score, r.score] for r in out]))
        ran = grew["interpreter.verifier_runs"]
        assert grew["interpreter.chunks"] == n
        assert ran + grew["interpreter.verifier_skipped"] == n
        assert ran == grew["interpreter.verifier_served"] \
            == np.count_nonzero(traces[-1][:, 1])
        assert grew["mel.launches"] == n
        assert grew["graph.replays"] == (n + ran if use_graph else 0)
        assert len(snap.named("nww.step.replay")) \
            == len(snap.named("nww.predict.readback")) == n
        assert len(snap.named("nww.step.verifier")) == ran
        assert all(s.device_ms is not None
                   for s in snap.named("nww.step.verifier"))
        runs.append(ran)
    assert counters["graph.captures"] == captures + 2
    np.testing.assert_array_equal(traces[0], traces[1])
    np.testing.assert_array_equal(traces[0], traces[2])
    gate = traces[0][16:, 0]
    assert (gate >= 0.3).any() and (gate < 0.3).any()
    assert 0 < runs[0] < n

    single = NanoInterpreter.load_model(CRNN, device=cuda)
    assert counters["graph.captures"] == captures + 3
    assert single._fused_step.verifier is None
    assert single._fused_step.verifier_graph is None


def test_stateful_model_card_matches_cpu(cuda, tmp_path):
    """A streaming_gru model from seed 0 through save_nww and load_model:
    scores and carry on the card (replayed step) against the CPU, and
    reset() brings back the zero state."""
    from nanowakeword_tpu_torch.export.artifact import save_nww
    from nanowakeword_tpu_torch.models.model import Model
    model = Model(config={}, model_name="sgru", model_type="streaming_gru",
                  layer_dim=32, seed=0, device="cpu")
    path = save_nww(str(tmp_path / "sgru.nww"), model=model, config={},
                    model_name="sgru")
    clip = np.clip(np.random.default_rng(7).normal(0, 3000, 16000 * 2),
                   -32768, 32767).astype(np.int16)
    runs = {}
    for device in (cuda, torch.device("cpu")):
        interp = NanoInterpreter.load_model(path, device=device)
        scores = np.array([r.score for r in interp.predict_clip(clip)])
        carry = interp.hidden_states["sgru"][0]
        assert carry.device.type == device.type
        runs[device.type] = (scores, carry.cpu().numpy())
        interp.reset()
        assert interp.hidden_states["sgru"] is None
        again = np.array([r.score for r in interp.predict_clip(clip)])
        np.testing.assert_array_equal(again, scores)
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0],
                               atol=SCORE_TOL)
    np.testing.assert_allclose(runs["cuda"][1], runs["cpu"][1],
                               atol=SCORE_TOL)
    assert (runs["cuda"][0][15:] > 0).all()


def test_server_batched_equals_alone_on_the_card(rng, cuda):
    """8 concurrent full connections and 32 concurrent feature requests
    through the message coroutine: each reply equals the same request
    scored alone (1e-5, the libraries may choose by shape) and the CPU
    server's (1e-3), in fewer device calls than requests."""
    import asyncio
    import json

    from nanowakeword_tpu_torch.interpreter import remote_verifier as rv
    audio = _audio(rng, (8, 1280 * 20))
    feats = rng.normal(0, 1, (32, 1, 16, 96)).astype(np.float32)

    async def client(server, i):
        state, out = server.connection(), []
        for c in range(20):
            message = rv.encode_audio(audio[i, c * 1280:(c + 1) * 1280])
            out.append(json.loads(await server.reply(message,
                                                     state))["score"])
            await asyncio.sleep(0)
        return out

    async def load(server, concurrent):
        server.start()
        if concurrent:
            streamed = await asyncio.gather(*[client(server, i)
                                              for i in range(8)])
        else:
            streamed = [await client(server, i) for i in range(8)]
        burst = await asyncio.gather(*[
            server.reply(rv.encode_features(f), None) for f in feats])
        return np.array(streamed), np.array(
            [json.loads(r)["score"] for r in burst])

    server = rv._ScoringServer(CRNN, "full", device=cuda)
    calls = []
    run_batch = server.session.run_batch
    server.session.run_batch = lambda f: (calls.append(len(f)),
                                          run_batch(f))[1]
    before = mel_cuda.launches
    streamed, burst = asyncio.run(load(server, True))
    assert mel_cuda.launches == before + 8 * 20
    assert len(calls) < 8 * 5 + 32
    assert (streamed[:, 15:] > 0).all() and (burst > 0).all()
    alone = rv._ScoringServer(CRNN, "full", batching=False, device=cuda)
    streamed_1, burst_1 = asyncio.run(load(alone, False))
    np.testing.assert_allclose(streamed, streamed_1, atol=1e-5)
    np.testing.assert_allclose(burst, burst_1, atol=1e-5)
    cpu = rv._ScoringServer(CRNN, "full", device="cpu")
    streamed_c, burst_c = asyncio.run(load(cpu, True))
    np.testing.assert_allclose(streamed, streamed_c, atol=SCORE_TOL)
    np.testing.assert_allclose(burst, burst_c, atol=SCORE_TOL)


def _mix_inputs(rng, cuda, b, n, dtype):
    fg = torch.from_numpy(_audio(rng, (b, n)))
    if dtype == torch.float32:
        fg = fg.float() / 32768.0
    q = rng.integers(0, n // 128, b)
    q[0] = n // 128 - 1
    has_bg = rng.random(b) < 0.6
    has_bg[0] = True
    per_clip = [torch.from_numpy(q.astype(np.int32)),
                torch.from_numpy(rng.uniform(0.05, 3.0, b).astype(np.float32)),
                torch.from_numpy(has_bg),
                torch.from_numpy(rng.uniform(0.7, 1.4, b).astype(np.float32))]
    bg = torch.from_numpy(rng.normal(0, 0.05, (b, n)).astype(np.float32))
    return [t.to(cuda) for t in [fg, bg] + per_clip]


@pytest.mark.parametrize("b,n", [(1, 1280), (3, 16000), (512, 32000)])
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
def test_mix_kernel_matches_plain(rng, cuda, b, n, dtype):
    args = _mix_inputs(rng, cuda, b, n, dtype)
    before = mix_cuda.launches
    out = mix_cuda.mix_gain_fused(*args)
    torch.cuda.synchronize()
    assert mix_cuda.launches == before + 1
    ref = mix_cuda.mix_gain_plain(*args)
    tol = MIX_ULPS * max(ref.abs().max().item(), 1.0)
    assert (out - ref).abs().max().item() <= tol


def test_mix_kernel_rejects_bad_input(rng, cuda):
    fg, bg, *per_clip = _mix_inputs(rng, cuda, 2, 1280, torch.int16)
    with pytest.raises(ValueError, match="n % 128"):
        mix_cuda.mix_gain_cuda(fg[:, :1000].contiguous(),
                               bg[:, :1000].contiguous(), *per_clip)
    with pytest.raises(ValueError, match="CUDA"):
        mix_cuda.mix_gain_cuda(fg.cpu(), bg.cpu(), *per_clip)
    with pytest.raises(ValueError, match="contiguous"):
        mix_cuda.mix_gain_cuda(fg.t().contiguous().t(), bg, *per_clip)


def test_augment_batch_launches_the_mix_kernel(rng, cuda):
    b, n = 16, 32000
    fg = torch.from_numpy(_audio(rng, (b, n), np.float32)).to(cuda)
    bg = torch.from_numpy(rng.normal(0, 1500, (b, n)).astype(
        np.float32)).to(cuda)
    params = TA.AugmentParams.from_settings({"rir_prob": 0.0})
    before = mix_cuda.launches
    out = TA.augment_batch(fg, bg, torch.zeros(b, 100, device=cuda),
                           np.full(b, n), torch.ones(b, dtype=bool),
                           torch.zeros(b, dtype=bool), params,
                           generator=torch.Generator().manual_seed(0))
    assert mix_cuda.launches == before + 1
    assert out.dtype == torch.int16 and out.shape == (b, n)
    assert out.device.type == "cuda" and out.abs().max() > 0


# -- the model zoo, the host loop and bf16 training on the card ----------------

ZOO = ["cnn", "lstm", "gru", "rnn", "transformer", "tcn", "quartznet",
       "conformer", "e_branchformer", "bcresnet"]
ZOO_TOL = 1e-4      # f32 logits of one family, card vs CPU


def _zoo_model(model_type, device, dropout=0.0, **cfg):
    from nanowakeword_tpu_torch.models.model import Model
    config = {"embedding_dim": 32, "transformer_d_model": 32,
              "transformer_n_head": 2, "conformer_d_model": 32,
              "conformer_n_head": 2, "branchformer_d_model": 32,
              "branchformer_n_head": 2, "tcn_channels": [16, 32],
              "quartznet_config": [[32, 9, 1], [64, 8, 1]], **cfg}
    return Model(config=config, model_name="t", model_type=model_type,
                 layer_dim=16, n_blocks=2, dropout_prob=dropout, seed=3,
                 device=device)


@pytest.mark.parametrize("model_type", ZOO)
def test_zoo_forward_card_matches_cpu(rng, cuda, model_type):
    x = rng.normal(0, 1, (8, 16, 96)).astype(np.float32)
    on_card = _zoo_model(model_type, cuda)(x).cpu().numpy()
    on_cpu = _zoo_model(model_type, "cpu")(x).numpy()
    assert on_card.shape == (8, 1) and np.isfinite(on_card).all()
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=ZOO_TOL)


ONNX_TOL = 1e-5     # an .onnx graph's f32 scores, card vs CPU (TF32 off)


@pytest.mark.parametrize("model_type", ["dnn", "crnn", "conformer",
                                        "bcresnet", "lstm", "streaming_gru"])
def test_onnx_runtime_card_matches_cpu(rng, cuda, model_type):
    """The port's exported graph run by OnnxTorchModel on the card and on
    the CPU; its Conv nodes run with cuDNN's TF32 off."""
    from nanowakeword_tpu_torch.export import onnx_proto as P
    from nanowakeword_tpu_torch.export.onnx_export import build_onnx
    from nanowakeword_tpu_torch.export.onnx_torch import OnnxTorchModel

    data = build_onnx(_zoo_model(model_type, "cpu", crnn_cnn_channels=[8, 16],
                                 crnn_rnn_type="gru"))
    feed = {vi.name: rng.normal(0, 1, [8 if isinstance(d, str) else d
                                       for d in vi.shape]).astype(np.float32)
            for vi in P.load_model(data).graph.inputs}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True      # the library's default
    try:
        on_card = OnnxTorchModel(data, device=cuda).run(None, feed)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    on_cpu = OnnxTorchModel(data, device="cpu").run(None, feed)
    for a, b in zip(on_card, on_cpu):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=ONNX_TOL)


def test_onnx_cascade_on_the_card_launches_the_mel_kernel(cuda, tmp_path):
    """The shipped cascade exported to `.onnx`: on the card it takes the
    general path, the mel kernel once per chunk, and scores as the `.nww`
    cascade on the card does."""
    from nanowakeword_tpu_torch.export.artifact import export_onnx_model

    for name in ("hey_nano_crnn", "hey_nano_crnn_lite"):
        _, model, _ = load_nww(os.path.join(ROOT, "campaign", name + ".nww"),
                               device="cpu")
        export_onnx_model(model, model.input_shape, {}, name, str(tmp_path))
    clip = np.clip(np.random.default_rng(5).normal(0, 3000, 16000 * 3),
                   -32768, 32767).astype(np.int16)
    traces = []
    for path in (str(tmp_path / "hey_nano_crnn.onnx"), CRNN):
        interp = NanoInterpreter.load_model(path, cascade=True,
                                            gate_threshold=0.0, device=cuda)
        before = mel_cuda.launches
        out = interp.predict_clip(clip)
        traces.append((np.array([[r.gate_score, r.score] for r in out]),
                       mel_cuda.launches - before, interp._fused_step))
    (onnx, launches, step), (nww, _, _) = traces
    assert step is None and launches == 37
    np.testing.assert_allclose(onnx, nww, rtol=0, atol=ONNX_TOL)
    assert (onnx[15:] > 0).all()


def _training_data(tmp_path):
    from nanowakeword_tpu_torch.data.dataset import (
        AdaptiveLossAwareDataset, DynamicClassAwareSampler)
    rng = np.random.default_rng(0)
    pos_p, neg_p = tmp_path / "pos.npy", tmp_path / "neg.npy"
    np.save(pos_p, rng.normal(size=(60, 16, 96)).astype(np.float32) + 1.0)
    np.save(neg_p, rng.normal(size=(120, 16, 96)).astype(np.float32))
    manifest = {"targets": {"t": str(pos_p)}, "negatives": {"n": str(neg_p)}}
    dataset = AdaptiveLossAwareDataset(manifest)
    return dataset, DynamicClassAwareSampler(dataset, {"t": 8, "n": 16},
                                             manifest)


def test_host_loop_pinned_side_stream_copies_match_synchronous(cuda,
                                                               tmp_path):
    """The host loop uploads each batch from pinned memory on a stream of
    its own and the step waits on the copy's event: the first 10 losses
    equal those of the same run with synchronous copies."""
    from nanowakeword_tpu_torch.train.trainer import Trainer
    cfg = {"learning_rate_max": 2e-3, "steps": 10,
           "early_stopping_patience": 0}
    losses = []
    for async_copies in (True, False):
        dataset, sampler = _training_data(tmp_path)
        trainer = Trainer(_zoo_model("gru", cuda, dropout=0.1), cfg)
        trainer.async_copies = async_copies
        trainer.train_model((dataset, sampler), None, 10, str(tmp_path))
        losses.append(trainer.history["loss"])
    assert len(losses[0]) == 10 and np.isfinite(losses[0]).all()
    assert losses[0] == losses[1]


def test_bf16_step_invariants_on_the_card(rng, cuda):
    """compute_dtype bfloat16 on the card: float32 masters, moments,
    BatchNorm statistics and metrics; the loss close to the float32
    step's."""
    from nanowakeword_tpu_torch.train.optim import Optimizer
    from nanowakeword_tpu_torch.train.step import make_train_step
    x = torch.from_numpy(rng.normal(0, 1, (32, 16, 96)).astype(
        np.float32)).to(cuda)
    y = (torch.arange(32, device=cuda) % 4 == 0).float()
    losses = {}
    for dtype in ("float32", "bfloat16"):
        model = _zoo_model("quartznet", cuda).train()
        opt = Optimizer(list(model.module.parameters()), {}, 10)
        metrics = make_train_step(model.module, opt,
                                  compute_dtype=dtype)(x, y)
        assert metrics.packed.dtype == torch.float32
        losses[dtype] = metrics.loss.item()
        for k, v in model.module.state_dict().items():
            if torch.is_floating_point(v):
                assert v.dtype == torch.float32, k
        for moments in opt.state.values():
            assert all(t.dtype == torch.float32 for t in moments)
        norm = model.module.backbone.blocks[0].norm
        assert norm.running_mean.abs().sum() > 0
    assert abs(losses["bfloat16"] - losses["float32"]) < 2e-2 * abs(
        losses["float32"])


def _e2e(device, encoder_dtype):
    from nanowakeword_tpu_torch.models.model import Model
    from nanowakeword_tpu_torch.train.e2e import E2EModel
    clf = Model(config={"embedding_dim": 16}, model_name="e2e",
                input_shape=(16, 96), model_type="dnn", layer_dim=16,
                n_blocks=1, dropout_prob=0.0, seed=3, device=device)
    return E2EModel(clf, encoder_dtype=encoder_dtype)


@pytest.mark.parametrize("encoder_dtype,tol", [
    # float32: the tolerances of the card-vs-CPU features and scores;
    # bf16: the bar of tests/test_torch_e2e.py's bf16 forward
    (torch.float32, FEATURE_TOL), (torch.bfloat16, 1e-2)])
def test_e2e_forward_launches_the_mel_kernel(rng, cuda, encoder_dtype, tol):
    """EndToEndModule on the card takes its mel from the kernel (one launch
    per forward) and gives the CPU's logits."""
    audio = _audio(rng, (6, 32000), np.float32)
    before = mel_cuda.launches
    with torch.no_grad():
        on_card = _e2e(cuda, encoder_dtype).module(
            torch.from_numpy(audio).to(cuda)).cpu().numpy()
    assert mel_cuda.launches == before + 1
    with torch.no_grad():
        on_cpu = _e2e("cpu", encoder_dtype).module(
            torch.from_numpy(audio)).numpy()
    assert on_card.shape == (6, 1) and np.isfinite(on_card).all()
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=tol)


def test_e2e_step_card_matches_cpu(rng, cuda):
    """One float32 AdamW step of the e2e stack: loss and grad norm on the
    card within 1e-4 of the CPU's, the mel kernel in the forward."""
    from nanowakeword_tpu_torch.train.optim import Optimizer
    from nanowakeword_tpu_torch.train.step import make_train_step
    x = torch.from_numpy(_audio(rng, (8, 32000), np.float32))
    y = (torch.arange(8) % 4 == 0).float()
    packed = []
    for device in (cuda, torch.device("cpu")):
        e2e = _e2e(device, torch.float32).train()
        opt = Optimizer(list(e2e.module.parameters()), {}, 10)
        before = mel_cuda.launches
        metrics = make_train_step(e2e.module, opt)(x.to(device), y.to(device))
        packed.append(metrics.fetch().packed.numpy())
        assert mel_cuda.launches == before + (device.type == "cuda")
    np.testing.assert_allclose(packed[0][:2], packed[1][:2], rtol=1e-4)


def test_cache_check_names_the_cache_on_the_card(cuda):
    """A cache larger than the card's free memory is refused before the
    upload, with the cache's name in the message."""
    from nanowakeword_tpu_torch.train.cached import check_cache_fits
    free, _ = torch.cuda.mem_get_info(cuda)
    check_cache_fits(1 << 20, cuda, "device-cached training set")
    with pytest.raises(MemoryError, match="device-cached training set"):
        check_cache_fits(free, cuda, "device-cached training set")


# -- encoder pretraining ----------------------------------------------------------

PRETRAIN = dict(vocab_size=4, confusable_fraction=0.0, variants_per_word=4,
                heldout_variants=1, clip_samples=16000, noise_clips=6,
                rir_clips=2, batch_size=8, steps=20, encoder_arch="wide128",
                contrastive_weight=0.5)


@pytest.fixture(scope="module")
def pretrain_corpus():
    from nanowakeword_tpu_torch.train import pretrain_encoder as PE
    return PE.build_corpus(PE.PretrainConfig(**PRETRAIN), verbose=False)


def test_pretrain_module_mel_through_the_kernel(rng, cuda):
    """EncoderPretrainModule on the card takes its mel from the kernel (one
    launch per forward), equal to the plain version on the card on int16
    audio, and gives the CPU's logits."""
    from nanowakeword_tpu_torch.train import pretrain_encoder as PE
    audio = torch.from_numpy(_audio(rng, (6, 24000)))
    module = PE.EncoderPretrainModule(7, "wide128")
    PE.flax_init_(module, torch.Generator().manual_seed(0))
    on_card = audio.to(cuda)
    kernel = mel_cuda.mel_frontend_fused(on_card)
    assert torch.equal(kernel, mel_cuda.mel_frontend_plain(on_card))
    # the CPU's log10 may round the last bit otherwise
    np.testing.assert_allclose(kernel.cpu().numpy(),
                               mel_cuda.mel_frontend_plain(audio).numpy(),
                               rtol=0, atol=1e-6)
    before = mel_cuda.launches
    with torch.no_grad():
        on_cpu = module(audio).numpy()
        on_card = module.to(cuda)(audio.to(cuda)).cpu().numpy()
    assert mel_cuda.launches == before + 1
    np.testing.assert_allclose(on_card, on_cpu, rtol=FEATURE_TOL,
                               atol=FEATURE_TOL)


def _float64_pretrain_steps(cfg, audio, y, n):
    """PretrainRun's fresh module after n steps of make_pretrain_step in
    float64 on the CPU -> (metrics [n, 3], module, name -> |clipped
    gradient| at the start)."""
    from nanowakeword_tpu_torch.train import pretrain_encoder as PE
    module = PE.EncoderPretrainModule(cfg.vocab_size, cfg.encoder_arch)
    PE.flax_init_(module, torch.Generator().manual_seed(cfg.seed))
    module = module.double()
    params = dict(module.named_parameters())
    logits, z = module(audio, return_embedding=True)
    loss = (torch.nn.functional.cross_entropy(logits, y)
            + cfg.contrastive_weight * PE.supcon_loss(z, y,
                                                      cfg.contrastive_temp))
    grads = torch.autograd.grad(loss, list(params.values()))
    clip = min(1.0, 1.0 / torch.sqrt(sum((g * g).sum()
                                         for g in grads)).item())
    step = PE.make_pretrain_step(
        module, PE.make_optimizer(list(params.values()), cfg), cfg)
    metrics = np.array([step(audio, y).numpy() for _ in range(n)])
    return metrics, module, {k: g.abs() * clip
                             for k, g in zip(params, grads)}


def test_pretrain_steps_card_match_cpu(cuda, pretrain_corpus):
    """Two AdamW steps of the pretraining module on the card (float32)
    from the same weights on one augmented batch (the first has lr 0, so
    both gradients are taken at the same weights), against the same steps
    in float64 on the CPU: loss and grad norm within 1e-4; weights within
    1e-5, except where the float64 clipped gradient is under 1e-6, where
    float32 rounding can decide the sign of g and Adam's g / (|g| + eps)
    moves the element by +-lr: those are held to 2 lr."""
    from nanowakeword_tpu_torch.train import pretrain_encoder as PE
    cfg = PE.PretrainConfig(**dict(PRETRAIN, steps=300))
    audio, y = PE.PretrainRun(cfg, pretrain_corpus, device="cpu",
                              verbose=False).draw_batch()
    run = PE.PretrainRun(cfg, pretrain_corpus, device=cuda, verbose=False)
    before = mel_cuda.launches
    metrics = np.array([run.train_on(audio.to(cuda), y.to(cuda)).cpu()
                        .numpy() for _ in range(2)])
    assert mel_cuda.launches == before + 2
    want, reference, g64 = _float64_pretrain_steps(cfg, audio, y, 2)
    np.testing.assert_allclose(metrics[:, [0, 2]], want[:, [0, 2]],
                               rtol=1e-4)
    bar = 2 * run.optimizer.lr(1)
    card = dict(run.module.named_parameters())
    for name, p in reference.named_parameters():
        diff = (card[name].detach().cpu().double() - p.detach()).abs()
        small = g64[name] < 1e-6
        assert (diff * ~small).max().item() <= 1e-5, name
        assert (diff * small).max().item() <= bar, name


def test_pretrain_int8_threshold_follows_the_card(cuda):
    from nanowakeword_tpu_torch.train import pretrain_encoder as PE
    free, _ = torch.cuda.mem_get_info(cuda)
    assert abs(PE.int8_threshold(cuda) - PE.INT16_CLIP_SHARE * free) \
        <= 0.05 * free


# -- the native runtime and data parallelism on the card ---------------------------


def test_native_decode_feeds_the_card(cuda, tmp_path):
    """A stereo 16-bit WAV decoded by the native runtime equals its numpy
    twin, and its features on the card equal the CPU's."""
    import wave

    from nanowakeword_tpu_torch import runtime
    from nanowakeword_tpu_torch.utils.audio_io import load_audio
    rng = np.random.default_rng(21)
    path = str(tmp_path / "stereo.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(_audio(rng, (32000, 2)).astype(np.int16).tobytes())
    buf = open(path, "rb").read()
    native, sr = runtime.decode_wav_bytes(buf)
    plain, sr_plain = runtime.plain_decode_wav_bytes(buf)
    assert sr == sr_plain == 16000
    np.testing.assert_array_equal(native, plain)
    clip = load_audio(path)
    np.testing.assert_array_equal(clip, native.astype(np.float32))
    feats = AudioFeatures(device=cuda).embed_clips(clip[None])
    feats_c = AudioFeatures(device="cpu").embed_clips(clip[None])
    np.testing.assert_allclose(feats, feats_c, atol=FEATURE_TOL)


@pytest.mark.parametrize("model_type,dropout", [("dnn", 0.3),
                                                ("crnn", 0.3)])
def test_dp_step_on_the_card_matches_one_device(rng, cuda, model_type,
                                                dropout):
    """Two replicas on the card (or every card) vs one device, one step
    with dropout: the loss within 1e-5, the weights within 1e-4 relative
    and 1e-6, conv biases before a BatchNorm (zero true gradient) within
    2 lr."""
    import copy

    from nanowakeword_tpu_torch.models.model import Model
    from nanowakeword_tpu_torch.parallel import dp
    from nanowakeword_tpu_torch.parallel import mesh as M
    from nanowakeword_tpu_torch.train.optim import Optimizer
    from nanowakeword_tpu_torch.train.step import make_train_step
    lr = 3e-3
    cfg = {"embedding_dim": 32, "crnn_cnn_channels": [8, 16],
           "crnn_rnn_type": "gru", "optimizer_type": "adamw",
           "learning_rate_max": lr, "lr_scheduler_type": "onecycle"}
    devices = M.visible_devices()
    mesh = M.make_mesh(devices=devices if len(devices) > 1
                       else devices * 2)
    base = Model(config=cfg, model_name="t", input_shape=(16, 96),
                 model_type=model_type, layer_dim=32, n_blocks=2,
                 dropout_prob=dropout, device=cuda).train().module
    x = torch.from_numpy(rng.normal(0, 1, (64, 16, 96)).astype(
        np.float32)).to(cuda)
    y = (torch.arange(64, device=cuda) % 3 == 0).float()
    results = []
    for sharded in (False, True):
        module = copy.deepcopy(base)
        opt = Optimizer(list(module.parameters()), cfg, 100)
        if sharded:
            opt = dp.shard_train_state(module, opt, mesh)
            step = dp.make_dp_train_step(module, opt, mesh, dropout_seed=5)
        else:
            step = make_train_step(module, opt, dropout_seed=5)
        results.append((step(x, y).loss.item(), module.state_dict()))
    (loss1, sd1), (loss2, sd2) = results
    assert abs(loss2 - loss1) <= 1e-5 * abs(loss1)
    for k, v in sd1.items():
        if not torch.is_floating_point(v):
            continue
        tol = 2 * lr / 25 if (k.startswith("backbone.convs.")
                              and k.endswith(".bias")) else 0
        diff = (sd2[k] - v).abs()
        assert (diff <= 1e-6 + 1e-4 * v.abs() + tol).all(), k


def _campaign_wavs(root):
    """3 held-out positives of the campaign (3 s) in root/pos and one
    10-s speech stream in root/stream."""
    from nanowakeword_tpu_torch.tools import quality_campaign as qc
    for sub in ("pos", "stream"):
        os.makedirs(os.path.join(root, sub))
    rng = np.random.default_rng(1_000_000)
    for i in range(3):
        qc._write_wav(os.path.join(root, "pos", f"p{i}.wav"),
                      qc._positive_eval_clip(rng, 1_000_000 + i))
    qc._write_wav(os.path.join(root, "stream", "s0.wav"), qc._speech_stream(
        np.random.default_rng(2_000_000), qc._words(), 10))


def test_campaign_evaluator_card_matches_cpu(cuda, tmp_path):
    """The campaign's `_eval_dir` (the evaluator's per-file streaming) of
    the full model and of the gate, card vs CPU."""
    from nanowakeword_tpu_torch.tools import quality_campaign as qc
    _campaign_wavs(str(tmp_path))
    for path in (CRNN, CRNN.replace(".nww", "_lite.nww")):
        key = os.path.splitext(os.path.basename(path))[0]
        out = {}
        for device in (cuda, torch.device("cpu")):
            interp = NanoInterpreter.load_model(path, device=device)
            out[device.type] = [qc._eval_dir(interp, key, tmp_path / sub,
                                             sub) for sub in ("pos",
                                                              "stream")]
        for card, cpu in zip(out["cuda"], out["cpu"]):
            assert card[2] == cpu[2] and card[3] == cpu[3] == 0
            np.testing.assert_allclose(card[0], cpu[0], atol=SCORE_TOL)
            assert card[0].max() > 0


def test_one_capture_per_interpreter(cuda, tmp_path):
    """The evaluator resets the interpreter before every file: the graph
    is captured once, at load, and replayed for every chunk of every
    file, one mel launch each."""
    from nanowakeword_tpu_torch.test_model.evaluate_model_with_audio import \
        stream_scores
    from nanowakeword_tpu_torch.utils.audio_io import load_audio
    _campaign_wavs(str(tmp_path))
    captured = mel_cuda.captured
    interp = NanoInterpreter.load_model(CRNN, cascade=True, device=cuda)
    graph = interp._fused_step.graph
    assert graph is not None and mel_cuda.captured == captured + 1
    before, chunks = mel_cuda.launches, 0
    for path in sorted(tmp_path.rglob("*.wav")):
        chunks += len(stream_scores(interp, load_audio(str(path)),
                                    "hey_nano_crnn"))
    assert chunks == 3 * 38 + 125
    assert interp._fused_step.graph is graph
    assert mel_cuda.captured == captured + 1
    assert mel_cuda.launches - before == chunks


# the port's benchmark (nanowakeword_tpu_torch/bench.py): build_forward's
# bf16 scores, card vs CPU on the same weights, within tests/
# test_torch_bench.py's bound (two bf16 steps of a score near 0.5)
BENCH_BF16_TOL = 2.0 ** -7


def _bench_audio(batch):
    from nanowakeword_tpu_torch.export.frontend import seeded_audio
    return torch.from_numpy(np.round(seeded_audio(batch, 16000, seed=16))
                            .astype(np.int16))


def test_bench_forward_card_matches_cpu(cuda):
    """build_forward on int16 [64, 16000] tones: the card's bf16 scores
    against the CPU's (the same seeded weights on both)."""
    from nanowakeword_tpu_torch import bench
    x = _bench_audio(64)
    scores = {}
    for device in (cuda, torch.device("cpu")):
        forward, model, _ = bench.build_forward(device)
        assert all(p.dtype == torch.bfloat16
                   for p in model.module.parameters())
        out = forward(x.to(device))
        assert out.dtype == torch.bfloat16 and out.shape == (64,)
        scores[device.type] = out.float().cpu().numpy()
    assert np.isfinite(scores["cuda"]).all()
    assert np.abs(scores["cuda"] - scores["cpu"]).max() <= BENCH_BF16_TOL


def test_bench_captured_forward_launches_mel_once_per_replay(cuda):
    """One forward captured as the headline captures it: one mel launch
    recorded, one counted per replay, and the replays compute the eager
    forward's sum."""
    from nanowakeword_tpu_torch import bench
    forward, _, _ = bench.build_forward(cuda)
    audio = _bench_audio(64).to(cuda)
    acc = torch.zeros((), device=cuda)
    captured = mel_cuda.captured
    run = bench._Captured(lambda: acc.add_(forward(audio).float().sum()),
                          cuda, state=(acc,))
    assert run.graph is not None and run.mel_launches == 1
    assert mel_cuda.captured == captured + 1
    assert float(acc) == 0.0
    before = mel_cuda.launches
    for _ in range(5):
        run()
    assert mel_cuda.launches - before == 5
    eager = float(forward(audio).float().sum())
    np.testing.assert_allclose(float(acc), 5 * eager, rtol=1e-6)


def test_replay_span_times_the_one_captured_graph(cuda):
    """With tracing on, the interpreter replays the same graphs: its scores
    equal those with tracing off bit for bit, and nothing is captured
    beyond what load_model captured. Each `nww.step.replay` span's device time
    holds at least the graph's work (its time per replay, back to back)
    and fits in its `predict` call's host interval up to the scores'
    copy."""
    from nanowakeword_tpu_torch.utils import tracing
    clip = np.clip(np.random.default_rng(6).normal(0, 3000, 16000 * 2),
                   -32768, 32767).astype(np.int16)
    captured = mel_cuda.captured
    interp = NanoInterpreter.load_model(CRNN, cascade=True,
                                        gate_threshold=0.0, device=cuda)
    assert mel_cuda.captured == captured + 1
    interp.reset()
    off = [[r.gate_score, r.score] for r in interp.predict_clip(clip)]
    interp.reset()
    with tracing.recording():
        on = [[r.gate_score, r.score] for r in interp.predict_clip(clip)]
    snap = tracing.snapshot()
    assert mel_cuda.captured == captured + 1
    np.testing.assert_array_equal(off, on)
    assert np.asarray(off)[15:].min() > 0

    step = interp._fused_step
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(50):
        step.graph.replay()
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end) / 50

    roots = snap.named("nww.predict")
    replays = snap.named("nww.step.replay")
    readbacks = snap.named("nww.predict.readback")
    assert len(roots) == len(replays) == len(readbacks) == 25
    for root, r, back in zip(roots, replays, readbacks):
        assert r.parent == back.parent == root.id
        assert r.device_ms >= 0.95 * plain_ms, (r.device_ms, plain_ms)
        assert r.device_ms <= (back.end_ns - root.start_ns) / 1e6


def test_bulk_spans_time_the_device(cuda):
    """embed_clips and run_batch inside tracing.recording(): every copy and
    compute span has a device time once the scores are on the host, and
    the spans match the work (the mel within the call's device time)."""
    from nanowakeword_tpu_torch.utils import tracing
    header, model, encoder = load_nww(CRNN, device=cuda)
    frontend = AudioFeatures(encoder_state_dict=encoder, device=cuda)
    session = _LocalSession(model, header)
    clips = torch.from_numpy(_audio(np.random.default_rng(3), (512, 32000)))
    session.run_batch(frontend.embed_clips(clips, batch_size=256))
    with tracing.recording():
        session.run_batch(frontend.embed_clips(clips, batch_size=256))
    snap = tracing.snapshot()
    timed = ["nww.features.upload", "nww.features.mel",
             "nww.features.encoder", "nww.features.download",
             "nww.session.upload", "nww.session.forward",
             "nww.session.download"]
    for name in timed:
        spans = snap.named(name)
        assert len(spans) == (2 if name.startswith("nww.features") else 1)
        assert all(s.device_ms is not None and s.device_ms > 0
                   for s in spans), name
    assert [s.name for s in snap.spans if s.parent is None] == [
        "nww.embed_clips", "nww.run_batch"]

    # the mel span holds the kernel's launch alone: its device time is the
    # kernel's, timed back to back, and the launch's own latency
    audio = clips[:256].to(cuda)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        frontend._mel(audio)
    end.record()
    end.synchronize()
    kernel_ms = start.elapsed_time(end) / 20
    for s in snap.named("nww.features.mel"):
        assert 0.95 * kernel_ms <= s.device_ms <= kernel_ms + 0.1, \
            (s.device_ms, kernel_ms)
