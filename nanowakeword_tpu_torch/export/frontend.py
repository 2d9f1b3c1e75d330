"""Feature-frontend ONNX export: raw audio -> [B, T, 96] features.

The counterpart of `nanowakeword_tpu/export/frontend.py`. The reference's
mel and embedding stages are onnx models, so its exported classifier runs
from raw audio with numpy and onnxruntime alone; these graphs give the same
deployment to a model trained here:

* `<name>_frontend.onnx`      bulk graph, audio [B, clip_samples]
                              (int16-scale floats) -> features [B, T, 96],
                              dynamic batch; pairs with the classifier
                              `.onnx` for batched scoring from raw audio.
* `<name>_mel_stream.onnx`    one streaming step: (mel_tail [320],
                              chunk [1280]) -> (new_tail [320],
                              frames [8, 32]); the client carries the tail
                              between calls (`mel_streaming_step`).
* `<name>_embedding.onnx`     one embedding window: mel [76, 32] ->
                              embedding [96].

The JAX package lowers its frontend's jaxpr; here the graphs are built by
hand with onnx_export's `_GraphBuilder` from the float32 plain log-mel
(ops/mel.py) and the encoder's weights: Pad for the 320-sample left
context, Reshape into 160-sample hops, MatMul with the cos and sin bases,
the two-hop phase combination, the 3-tap Hann, the power, MatMul with the
filterbank, Log times 1/ln 10 plus 2, then the encoder's convolutions and
dense from `EMB_OFFSET`. All three are float32 graphs: they follow
`AudioFeatures` in float32 mode. The served pipeline computes the mel in
bf16 mode, whose rounding reaches the encoder's output on tonal audio, so
scores through the two can differ by far more than float32 rounding. Each
graph is checked when
it is built: the port's numpy evaluator (onnx_eval.py) runs it on seeded
int16-scale audio (`seeded_audio`, or its mel for the embedding graph)
against the float32 plain frontend on the CPU, and a miss of 1e-4 raises.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from nanowakeword_tpu_torch.export import onnx_eval
from nanowakeword_tpu_torch.export import onnx_proto as P
from nanowakeword_tpu_torch.export.onnx_export import _GraphBuilder
from nanowakeword_tpu_torch.ops import mel as melops

MEL_TAIL = melops.LEFT_PAD      # 320 = WINDOW - HOP
CHUNK = melops.CHUNK            # 1280
FRAMES_PER_CHUNK = melops.FRAMES_PER_CHUNK
EMB_WINDOW = 76
N_MELS = melops.N_MELS
EMBEDDING_DIM = 96
EMB_OFFSET = 4                  # data/features.py::EMB_OFFSET
_END = 2 ** 31 - 1              # "to the end" in a Slice
CHECK_TOL = 1e-4                # graph vs the float32 plain frontend


class FrontendExportError(RuntimeError):
    """A frontend graph missed the float32 plain frontend at export."""


def _log_mel(g: _GraphBuilder, rows: str, t: int) -> str:
    """[..., t+2, 160] hop rows -> [..., t, 32] log-mel: ops/mel.py's
    `_log_mel_from_rows` at float32, one node per step."""
    b0c, b0s, p_re, p_im, fb = melops._hopdft_constants()
    s_re = g.add("MatMul", [rows, g.init_tensor("mel_cos", b0c)])
    s_im = g.add("MatMul", [rows, g.init_tensor("mel_sin", b0s)])

    def hops(s, k):                     # rows k .. k+t of the hop DFT
        return g.slice_range(s, axis=-2, start=k, end=t + k)

    f_re, f_im = hops(s_re, 0), hops(s_im, 0)
    for k in (1, 2):
        pr = g.init_tensor(f"mel_phase_re{k}", p_re[k].astype(np.float32))
        pi = g.init_tensor(f"mel_phase_im{k}", p_im[k].astype(np.float32))
        re_k, im_k = hops(s_re, k), hops(s_im, k)
        f_re = g.add("Sub", [g.add("Add", [f_re, g.add("Mul", [pr, re_k])]),
                             g.add("Mul", [pi, im_k])])
        f_im = g.add("Add", [g.add("Add", [f_im, g.add("Mul", [pr, im_k])]),
                             g.add("Mul", [pi, re_k])])

    def bins(x, start, end):
        return g.slice_range(x, axis=-1, start=start, end=end)

    # Hann: 0.5 X(f) - 0.25 (X(f-1) + X(f+1)); X(-1) = conj X(1), and the
    # top bin's +1 tap repeats the top bin (melops.hann_taps)
    m1_re = g.add("Concat", [bins(f_re, 1, 2), bins(f_re, 0, -1)], axis=-1)
    m1_im = g.add("Concat", [g.add("Neg", [bins(f_im, 1, 2)]),
                             bins(f_im, 0, -1)], axis=-1)
    p1_re = g.add("Concat", [bins(f_re, 1, _END), bins(f_re, -1, _END)],
                  axis=-1)
    p1_im = g.add("Concat", [bins(f_im, 1, _END), bins(f_im, -1, _END)],
                  axis=-1)

    def hann(f, m1, p1):
        return g.add("Sub", [g.const_mul(f, 0.5, "hann_half"),
                             g.const_mul(g.add("Add", [m1, p1]), 0.25,
                                         "hann_quarter")])

    w_re, w_im = hann(f_re, m1_re, p1_re), hann(f_im, m1_im, p1_im)
    power = g.add("Add", [g.add("Mul", [w_re, w_re]),
                          g.add("Mul", [w_im, w_im])])
    mel = g.add("MatMul", [power, g.init_tensor("mel_fb", fb)])
    # mel >= 0 (a sum of powers times non-negative weights): no clamp
    eps = g.init_tensor("mel_eps", np.float32(melops.MEL_EPS))
    log10 = g.const_mul(g.add("Log", [g.add("Add", [mel, eps])]),
                        1.0 / math.log(10.0), "inv_ln10")
    return g.add("Add", [log10, g.init_tensor(
        "log_offset", np.float32(melops.LOG_OFFSET))])


def _encoder(g: _GraphBuilder, mel: str, n_frames: int, state_dict,
             batch: int = 0) -> str:
    """[B, n_frames, 32] mel -> [B, T, 96] embeddings: models/embedding.py's
    convolutions (VALID, relu after each) and the per-frame dense. `batch`
    0 keeps the batch dimension symbolic (Reshape's "copy"); 1 reads a
    [n_frames, 32] window as one row."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32)
          for k, v in state_dict.items()}
    x = g.reshape(mel, [batch, 1, n_frames, N_MELS])      # [B, 1, T, 32]
    if "conv0.weight" not in sd:                           # conv4
        strides = ((2, 2), (2, 2), (2, 2), (1, 1))
        for i, stride in enumerate(strides):
            w = sd[f"convs.{i}.weight"]
            x = g.add("Relu", [g.conv(x, w, sd[f"convs.{i}.bias"],
                                      f"enc_conv{i}", pads=[0, 0, 0, 0],
                                      strides=list(stride))])
        channels = sd["convs.3.weight"].shape[0]
        t_out = n_frames
        for (kh, _), (sh, _) in zip(((10, 4), (8, 4), (8, 3), (4, 2)),
                                    strides):
            t_out = (t_out - kh) // sh + 1
        x = g.reshape(x, [0, channels, t_out])             # squeeze freq
    else:                                                  # wide128/256
        w = sd["conv0.weight"]
        x = g.add("Relu", [g.conv(x, w, sd["conv0.bias"], "enc_conv0",
                                  pads=[0, 0, 0, 0], strides=[2, 1])])
        width = w.shape[0]
        t_out = (n_frames - 10) // 2 + 1
        x = g.reshape(x, [0, width, t_out])
        for i, (k, s) in enumerate(((8, 2), (8, 2), (4, 1))):
            x = g.add("Relu", [g.conv(x, sd[f"convs.{i}.weight"],
                                      sd[f"convs.{i}.bias"],
                                      f"enc_conv{i + 1}", pads=[0, 0],
                                      strides=[s])])
            t_out = (t_out - k) // s + 1
    x = g.add("Transpose", [x], perm=[0, 2, 1])            # [B, T, C]
    return g.dense3d(x, sd["dense.weight"].T, sd["dense.bias"], "enc_dense")


def _encoder_state_dict(encoder_variables):
    from nanowakeword_tpu_torch.convert import encoder_state_dict_from_flax
    return encoder_state_dict_from_flax(encoder_variables)


def _plain_encoder(state_dict):
    from nanowakeword_tpu_torch.models.embedding import \
        encoder_from_state_dict
    return encoder_from_state_dict(state_dict, "cpu")


def _model_bytes(g: _GraphBuilder, name: str, inputs, outputs,
                 doc: str) -> bytes:
    graph = P.graph(g.nodes, name=name, inputs=inputs, outputs=outputs,
                    initializers=g.inits, doc=doc)
    return P.model(graph, opset=17,
                   doc="exported by nanowakeword_tpu_torch.export.frontend")


def check_graph(data: bytes, feeds: dict, want: dict, name: str) -> float:
    """Run `data` through onnx_eval on `feeds` -> the largest difference
    from `want` ({output: array}); raises FrontendExportError past
    CHECK_TOL (absolute plus relative, as np.allclose reads them)."""
    got = onnx_eval.run(data, feeds)
    worst = 0.0
    for out_name, w in want.items():
        gv = got[out_name]
        if gv.shape != w.shape:
            raise FrontendExportError(
                f"'{name}': '{out_name}' shape {gv.shape} vs the plain "
                f"frontend's {w.shape}")
        if not np.allclose(gv, w, rtol=CHECK_TOL, atol=CHECK_TOL):
            raise FrontendExportError(
                f"'{name}': '{out_name}' misses the float32 plain frontend "
                f"by {np.abs(gv - w).max():.3e}")
        worst = max(worst, float(np.abs(gv - w).max()))
    return worst


def seeded_audio(batch: int, n: int, seed: int = 0) -> np.ndarray:
    """[batch, n] int16-scale float32 test audio: per row a tone at a
    random pitch (300-1000 Hz) and level, amplitude-modulated at 4 Hz, plus
    noise. The bundled encoder's output is constant on white noise (every
    unit of a layer off), so a check on noise would not reach its weights."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / melops.SAMPLE_RATE
    rows = []
    for _ in range(batch):
        f0, amp = rng.uniform(300.0, 1000.0), rng.uniform(3000.0, 9000.0)
        tone = np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
        am = 0.6 + 0.4 * np.sin(2 * np.pi * 4.0 * t)
        rows.append(amp * tone * am + rng.normal(0, 300.0, n))
    return np.stack(rows).astype(np.float32)


def build_frontend_onnx(encoder_variables, clip_samples: int,
                        name: str = "frontend") -> bytes:
    """Bulk frontend graph: audio [B, clip_samples] -> features [B, T, 96]."""
    n = int(clip_samples)
    right = -n % melops.HOP
    t = (n + right) // melops.HOP
    n_frames = t - EMB_OFFSET
    sd = _encoder_state_dict(encoder_variables)
    g = _GraphBuilder()
    pads = g.init_tensor("pads", np.asarray([0, MEL_TAIL, 0, right],
                                            np.int64))
    audio = g.add("Pad", ["audio", pads])
    rows = g.reshape(audio, [0, t + 2, melops.HOP])
    mel = _log_mel(g, rows, t)
    mel = g.slice_range(mel, axis=-2, start=EMB_OFFSET, end=_END)
    feats = _encoder(g, mel, n_frames, sd)
    t_out = (n_frames - EMB_WINDOW) // 8 + 1
    g.nodes.append(P.node("Identity", [feats], ["features"],
                          name="n_features"))
    data = _model_bytes(
        g, f"{name}_frontend",
        [P.value_info("audio", ("batch_size", n))],
        [P.value_info("features", ("batch_size", t_out, EMBEDDING_DIM))],
        "nanowakeword_tpu_torch feature frontend: int16-scale audio -> "
        "[B, T, 96] speech embeddings (mel + encoder)")
    encoder = _plain_encoder(sd)
    for batch in (1, 3):
        x = seeded_audio(batch, n)
        with torch.no_grad():
            mel_ref = melops.mel_frontend(torch.from_numpy(x),
                                          compute_dtype=torch.float32)
            want = encoder(mel_ref[:, EMB_OFFSET:]).numpy()
        check_graph(data, {"audio": x}, {"features": want},
                    f"{name}_frontend")
    return data


def build_mel_stream_onnx(name: str = "frontend") -> bytes:
    """Streaming mel step graph: (mel_tail, chunk) -> (new_tail, frames)."""
    g = _GraphBuilder()
    buf = g.add("Concat", ["mel_tail", "chunk"], axis=0)   # [1600]
    new_tail = g.slice_range(buf, axis=0, start=CHUNK, end=CHUNK + MEL_TAIL)
    rows = g.reshape(buf, [FRAMES_PER_CHUNK + 2, melops.HOP])
    frames = _log_mel(g, rows, FRAMES_PER_CHUNK)
    g.nodes.append(P.node("Identity", [new_tail], ["new_tail"],
                          name="n_new_tail"))
    g.nodes.append(P.node("Identity", [frames], ["frames"], name="n_frames"))
    data = _model_bytes(
        g, f"{name}_mel_stream",
        [P.value_info("mel_tail", (MEL_TAIL,)),
         P.value_info("chunk", (CHUNK,))],
        [P.value_info("new_tail", (MEL_TAIL,)),
         P.value_info("frames", (FRAMES_PER_CHUNK, N_MELS))],
        "nanowakeword_tpu_torch streaming mel step: carry mel_tail between "
        "calls; chunk is 1280 int16-scale samples -> 8 mel frames")
    buf = seeded_audio(1, MEL_TAIL + CHUNK)[0]
    tail, chunk = buf[:MEL_TAIL], buf[MEL_TAIL:]
    want_tail, want_frames = melops.mel_streaming_step(
        torch.from_numpy(tail), torch.from_numpy(chunk),
        compute_dtype=torch.float32)
    check_graph(data, {"mel_tail": tail, "chunk": chunk},
                {"new_tail": want_tail.numpy(),
                 "frames": want_frames.numpy()}, f"{name}_mel_stream")
    return data


def build_embedding_onnx(encoder_variables,
                         name: str = "frontend") -> bytes:
    """Embedding window graph: mel [76, 32] -> embedding [96]."""
    sd = _encoder_state_dict(encoder_variables)
    g = _GraphBuilder()
    emb = _encoder(g, "mel_window", EMB_WINDOW, sd, batch=1)  # [1, 1, 96]
    emb = g.reshape(emb, [EMBEDDING_DIM])
    g.nodes.append(P.node("Identity", [emb], ["embedding"],
                          name="n_embedding"))
    data = _model_bytes(
        g, f"{name}_embedding",
        [P.value_info("mel_window", (EMB_WINDOW, N_MELS))],
        [P.value_info("embedding", (EMBEDDING_DIM,))],
        "nanowakeword_tpu_torch embedding window: the last 76 mel frames "
        "-> one 96-dim speech embedding (stride 8 frames = 80 ms)")
    with torch.no_grad():
        window = melops.mel_frontend(
            torch.from_numpy(seeded_audio(1, EMB_WINDOW * melops.HOP)[0]),
            compute_dtype=torch.float32).numpy()           # [76, 32]
        want = _plain_encoder(sd)(torch.from_numpy(window)[None])[0, 0]
    check_graph(data, {"mel_window": window}, {"embedding": want.numpy()},
                f"{name}_embedding")
    return data


def export_frontend_onnx(encoder_variables, clip_samples: int,
                         model_name: str, output_dir: str) -> list:
    """Write the three frontend graphs beside a model export -> the written
    paths (`_frontend`, `_mel_stream`, `_embedding`)."""
    written = []
    for suffix, data in (
            ("_frontend", build_frontend_onnx(encoder_variables,
                                              clip_samples, model_name)),
            ("_mel_stream", build_mel_stream_onnx(model_name)),
            ("_embedding", build_embedding_onnx(encoder_variables,
                                                model_name))):
        path = os.path.join(output_dir, f"{model_name}{suffix}.onnx")
        with open(path, "wb") as f:
            f.write(data)
        written.append(path)
    return written


class OnnxStreamingFrontend:
    """A numpy-only streaming feature frontend over the exported graphs.

    A copy of the JAX package's: AudioFeatures' streaming surface
    (`__call__`, `feature_buffer`, `get_features`, `reset`) inside
    NanoInterpreter, with feature extraction through the `_mel_stream` /
    `_embedding` graphs and the numpy evaluator on the host: the
    reference's edge deployment around two onnx models.
    """

    def __init__(self, mel_stream_path: str, embedding_path: str,
                 mel_buffer_frames: int = 970, feature_frames: int = 120):
        with open(mel_stream_path, "rb") as f:
            self._mel_data = P.load_model(f.read())
        with open(embedding_path, "rb") as f:
            self._emb_data = P.load_model(f.read())
        self._run = onnx_eval.run
        self._mel_buffer_frames = mel_buffer_frames
        self._feature_frames = feature_frames
        self.reset()

    def reset(self):
        self._tail = np.zeros(MEL_TAIL, np.float32)
        self._remainder = np.empty(0, np.float32)
        # the same warm buffers as AudioFeatures' streaming state
        self._mel_buf = np.ones((self._mel_buffer_frames, N_MELS),
                                np.float32)
        self._feat_buf = np.zeros((self._feature_frames, EMBEDDING_DIM),
                                  np.float32)
        self._frames_seen = 0

    def __call__(self, audio) -> int:
        """Accumulate int16-scale samples; process whole 1280-sample chunks.
        Returns the number of samples prepared (AudioFeatures' streaming
        contract, which the interpreter's general path reads)."""
        x = np.asarray(audio, np.float32).reshape(-1)
        data = np.concatenate([self._remainder, x])
        n_chunks = len(data) // CHUNK
        self._remainder = data[n_chunks * CHUNK:]
        for c in range(n_chunks):
            chunk = data[c * CHUNK:(c + 1) * CHUNK]
            out = self._run(self._mel_data,
                            {"mel_tail": self._tail, "chunk": chunk})
            self._tail = out["new_tail"]
            self._mel_buf = np.concatenate(
                [self._mel_buf[FRAMES_PER_CHUNK:], out["frames"]])
            emb = self._run(self._emb_data,
                            {"mel_window": self._mel_buf[-EMB_WINDOW:]})
            self._feat_buf = np.concatenate(
                [self._feat_buf[1:], emb["embedding"][None]])
            self._frames_seen += 1
        return n_chunks * CHUNK

    @property
    def frames_available(self) -> int:
        """Frames emitted since reset, at most the ring's length:
        `feature_buffer`'s length (AudioFeatures contract)."""
        return min(self._frames_seen, self._feature_frames)

    @property
    def feature_buffer(self) -> np.ndarray:
        """Frames emitted since reset, newest last."""
        return self._feat_buf[self._feature_frames - self.frames_available:]

    def get_features(self, n_feature_frames: int = 16,
                     start_ndx: int = -1) -> np.ndarray:
        """[1, n, 96] slice of the feature buffer (AudioFeatures contract)."""
        n = int(n_feature_frames)
        if start_ndx != -1:
            end = (start_ndx + n if start_ndx + n != 0
                   else self._feature_frames)
            return self._feat_buf[start_ndx:end][None]
        return self._feat_buf[-n:][None]

    @property
    def frames_seen(self) -> int:
        return self._frames_seen
