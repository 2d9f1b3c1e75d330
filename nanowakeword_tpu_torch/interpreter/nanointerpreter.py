"""NanoInterpreter: the streaming wake-word inference engine, on one torch
device.

The counterpart of `nanowakeword_tpu/interpreter/nanointerpreter.py` for
`.nww` models: `DetectionResult`, `_LocalSession` (stateless models, and
stateful ones that thread a carry), and `NanoInterpreter` with
`load_model()` (single models and cascades with `<stem>_lite` gate
auto-discovery, a remote verifier behind an optional local gate, or no local
model at all), `predict()` (warm-up guard, zeroed first predictions, cascade
gate, VAD gate, patience/debounce), `predict_clip()`, `listen()`, `reset()`,
`stop()` and the score properties.

When every model is local, an 80 ms chunk is ONE device call (`_FusedStep`):
the feature stream step and every model's score on static buffers, with one
copy of the scores back to the host. On a CUDA device that call is a CUDA
graph, captured once over the eager step and replayed per chunk; on the CPU
the same step runs eagerly. A cascade whose verifier is a stateless local
model is split at the gate into two such calls, two graphs on a CUDA
device: the second, the verifier alone, runs only on a chunk whose gate
lets the verifier's score through, as the general path does (a stateful
verifier, whose carry advances on every chunk, stays in the one call).
With a remote session among the models, `predict()` takes the general
path: one `session.run` per model, the verifier skipped while the gate is
low.

`.onnx` models load as `_OnnxSession`s (export/onnx_torch.py, on the same
device); like a remote session they take the general path, the eager
feature step (the mel kernel on a CUDA device) and one `session.run` per
model. `onnx_frontend=` swaps the feature frontend for the exported
`_mel_stream` / `_embedding` graphs run by the numpy evaluator on the host
(export/frontend.py::OnnxStreamingFrontend).
"""

from __future__ import annotations

import logging
import os
import threading
import time
import warnings
import wave
from collections import defaultdict, deque
from functools import partial
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from nanowakeword_tpu_torch.data.features import CHUNK, AudioFeatures
from nanowakeword_tpu_torch.export.artifact import EXTENSION, load_nww
from nanowakeword_tpu_torch.utils import tracing
from nanowakeword_tpu_torch.utils.cuda_graph import capture_graph, replay
from nanowakeword_tpu_torch.utils.tracing import counters

try:
    import noisereduce as nr
    NOISEREDUCE_AVAILABLE = True
except ImportError:
    NOISEREDUCE_AVAILABLE = False


class DetectionResult:
    """Result object returned by predict()."""

    __slots__ = ("scores", "model_name", "gate_name", "threshold", "_detected")

    def __init__(self, scores: dict, model_name: str,
                 gate_name: Optional[str], threshold: float = 0.0):
        self.scores = scores
        self.model_name = model_name
        self.gate_name = gate_name
        self.threshold = threshold
        self._detected = None

    @property
    def score(self) -> float:
        return self.scores.get(self.model_name, 0.0)

    @property
    def gate_score(self) -> float:
        if self.gate_name:
            return self.scores.get(self.gate_name, 0.0)
        return 0.0

    @property
    def detected(self) -> bool:
        return self.score >= self.threshold if self.threshold > 0 else False

    def get(self, model_name: str, default: float = 0.0) -> float:
        if model_name not in self.scores and self.scores:
            # a typo'd model name otherwise reads as a permanent 0.0
            warnings.warn(
                f"DetectionResult.get('{model_name}'): unknown model; "
                f"loaded models are {sorted(self.scores)}", stacklevel=2)
        return self.scores.get(model_name, default)

    def __getitem__(self, key: str) -> float:
        return self.scores[key]

    def __contains__(self, key: str) -> bool:
        return key in self.scores

    def __repr__(self) -> str:
        parts = [f"score={self.score:.4f}"]
        if self.gate_name:
            parts.append(f"gate={self.gate_score:.4f}")
        if self.threshold > 0:
            parts.append(f"detected={self.detected}")
        return f"DetectionResult({', '.join(parts)})"


class _LocalSession:
    """An eval session over a loaded .nww Model. Outputs the sigmoid
    probability, the exported-graph contract. A stateful model takes and
    returns a carry: a tuple of tensors that stays on the model's device.

    With `mesh` (parallel/mesh.py), `run_batch` of a stateless model pads
    the batch to a multiple of the data-axis size, scores a contiguous
    slice on each data row's device (a replica of the module there), and
    drops the padding. Stateful models stay on one device."""

    def __init__(self, model, header, mesh=None):
        self.model = model
        self.header = header
        self.stateful = bool(header.get("stateful", False))
        self.mesh = None if self.stateful else mesh
        self._replicas = []
        if self.mesh is not None:
            import copy
            own = next(model.module.parameters()).device
            self._replicas = [
                model.module if device == own
                else copy.deepcopy(model.module).to(device).eval()
                for device in self.mesh.data_devices]

    @property
    def feature_length(self) -> int:
        return int(self.header["input_shape"][0])

    def scores(self, feats: torch.Tensor, carry=None):
        """[B, T, F] tensor on the model's device -> [B] probabilities; for
        a stateful model `(probabilities, new carry)`, from `carry` (None is
        the zero state)."""
        if self.stateful:
            logits, new_carry = self.model.module(feats, carry)
            return torch.sigmoid(logits).reshape(-1), new_carry
        return torch.sigmoid(self.model.module(feats)).reshape(-1)

    def _tensor(self, feats) -> torch.Tensor:
        return torch.as_tensor(feats, dtype=torch.float32,
                               device=self.model.device)

    @torch.no_grad()
    def run(self, feats: np.ndarray, carry=None):
        """[1, T, F] features -> (probability, new carry); the carry of a
        stateless model is None."""
        if self.stateful:
            probs, new_carry = self.scores(self._tensor(feats), carry)
            return float(probs[0]), new_carry
        return float(self.scores(self._tensor(feats))[0]), None

    @torch.no_grad()
    def run_batch(self, feats: np.ndarray) -> np.ndarray:
        """[B, T, F] -> [B] probabilities (stateless models; the server's
        dynamic batching path)."""
        with tracing.span("nww.run_batch"):
            if self.mesh is None:
                device = self.model.device
                with tracing.span("nww.session.upload", device=device):
                    x = self._tensor(feats)
                with tracing.span("nww.session.forward", device=device):
                    probs = self.scores(x)
                with tracing.span("nww.session.download", device=device):
                    return probs.cpu().numpy()
            return self._run_sharded(feats)

    def _run_sharded(self, feats: np.ndarray) -> np.ndarray:
        from nanowakeword_tpu_torch.parallel import collectives
        feats = np.asarray(feats, np.float32)
        n, n_data = feats.shape[0], len(self._replicas)
        pad = -n % n_data
        if pad:
            feats = np.concatenate(
                [feats, np.zeros((pad,) + feats.shape[1:], np.float32)])
        probs = []
        for part, device, module in zip(np.split(feats, n_data),
                                        self.mesh.data_devices,
                                        self._replicas):
            x = torch.as_tensor(part, device=device)
            probs.append(torch.sigmoid(module(x)).reshape(-1))
        return collectives.gather(probs, self.mesh.primary).cpu().numpy()[:n]


class _OnnxSession:
    """A session over an exported `.onnx` graph on one torch device: the
    interchange-format twin of _LocalSession, with the same surface. The
    graph ends in a Sigmoid, so `run` returns the probability directly.

    A graph with `hidden_in` / `cell_in` inputs is stateful: its carry is
    the pair of tensors it feeds there, which stays on the device."""

    def __init__(self, path: str, device="cuda"):
        from nanowakeword_tpu_torch.export.onnx_torch import OnnxTorchModel
        self._model = OnnxTorchModel(path, device=device)
        self.device = self._model.device
        inputs = {vi.name: vi.shape for vi in self._model.graph.inputs}
        self._state_shapes = {k: [int(d) for d in inputs[k]]
                              for k in ("hidden_in", "cell_in")
                              if k in inputs}
        self.stateful = "hidden_in" in self._state_shapes

    @property
    def feature_length(self) -> int:
        # input [batch, T, 96], as the reference reads it off an ORT session
        return int(self._model.input_shape[1])

    def _scores(self, feats: np.ndarray, carry=None):
        """-> (score tensor, new carry or None), on the device."""
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 2:
            feats = feats[None]
        feed = {self._model.input_name: self._model.tensor(feats)}
        if not self.stateful:
            return self._model.forward(feed)["score"], None
        if carry is None:
            carry = tuple(torch.zeros(self._state_shapes[k],
                                      device=self.device)
                          for k in ("hidden_in", "cell_in"))
        feed["hidden_in"], feed["cell_in"] = carry
        out = self._model.forward(feed)
        return out["score"], (out["hidden_out"], out["cell_out"])

    def run(self, feats: np.ndarray, carry=None):
        """[1, T, F] features -> (probability, new carry); the carry of a
        stateless graph is None."""
        score, new_carry = self._scores(feats, carry)
        return float(score.reshape(-1)[0]), new_carry

    def run_batch(self, feats: np.ndarray) -> np.ndarray:
        """[B, T, F] -> [B] probabilities. The graph's batch dimension
        decides: a symbolic one scores the batch in one call, a fixed 1
        row by row."""
        feats = np.asarray(feats, np.float32)
        batch = self._model.input_shape[0]
        if isinstance(batch, str):
            return self._scores(feats)[0].cpu().numpy().reshape(len(feats))
        if batch != 1:
            raise ValueError(f"graph input has a fixed batch of {batch}")
        return np.asarray([self.run(f)[0] for f in feats], np.float32)


def _tree_tensors(tree) -> list:
    """The tensors of a carry (nested tuples of tensors), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _tree_tensors(sub)]


class _FusedStep:
    """One device call per 80 ms chunk: the feature stream step, then every
    local model's score, stateless and stateful, on static buffers (the
    chunk in, the frontend's rings and the models' carries updated in place,
    the scores out).

    A cascade whose verifier is a stateless local session is split at the
    gate (`verifier` names it): the call holds the feature step and every
    other model, and the verifier is a second call of its own, which reads
    the newest frames of the feature ring that the first call has just
    written and writes its score into a buffer of its own. The interpreter
    makes the second call only on a chunk whose verifier score its rules
    would serve (`NanoInterpreter._zeroed`). Any other set of models, a
    stateful verifier's included, runs in the one call on every chunk.

    On a CUDA device each call is a `torch.cuda.CUDAGraph`, captured over
    `_step` (and `_verifier_step`, into the same memory pool) after eager
    warm-up steps on a side stream (the warm-up builds the mel kernel,
    fills its constants and lets cuDNN and cuBLAS settle; none of that may
    happen under capture) and replayed once per chunk. The state that
    warm-up touched is put back before the first real chunk. If capture
    fails, `run` raises; there is no eager way back on the card. On a CPU
    device the same steps run eagerly, in turn. A graph must not be
    replayed from two threads at once: an interpreter serves one stream.

    While tracing is on (utils/tracing.py), the replay is the span
    `nww.step.replay` and the verifier's call with its score's copy to the
    host the span `nww.step.verifier`. The replay's host time is the
    graph's launch; the device time of both comes from timing events
    recorded on the stream around them, so it also counts the launch's
    latency, during which the device waits on the host.
    """

    WARMUP_STEPS = 3

    def __init__(self, interp: "NanoInterpreter",
                 verifier: Optional[str] = None):
        self.interp = interp
        self.pre = interp.preprocessor
        self.verifier = verifier
        self.names = [n for n in interp.models if n != verifier]
        self.sessions = [interp.models[n] for n in self.names]
        self.lengths = [interp.model_feature_length[n] for n in self.names]
        device = self.pre.device
        self.chunk = torch.zeros(CHUNK, device=device)
        self.scores = torch.zeros(len(self.names), device=device)
        self.verifier_score = torch.zeros(1, device=device)
        self.carries = {}
        for name, session, length in zip(self.names, self.sessions,
                                         self.lengths):
            if session.stateful:
                self.carries[name] = session.model.module.backbone \
                    .initial_carry(self.pre.state.feat_buf[-length:][None])
        self.use_graph = device.type == "cuda"
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.verifier_graph: Optional["torch.cuda.CUDAGraph"] = None
        self.mel_launches_per_replay = 0

    @torch.no_grad()
    def _step(self) -> None:
        self.pre.stream_step_(self.chunk)
        feat_buf = self.pre.state.feat_buf
        out = []
        for name, session, length in zip(self.names, self.sessions,
                                         self.lengths):
            feats = feat_buf[-length:][None]
            if session.stateful:
                probs, new_carry = session.scores(feats, self.carries[name])
                for dst, src in zip(_tree_tensors(self.carries[name]),
                                    _tree_tensors(new_carry)):
                    dst.copy_(src)
            else:
                probs = session.scores(feats)
            out.append(probs)
        self.scores.copy_(torch.cat(out))

    @torch.no_grad()
    def _verifier_step(self) -> None:
        length = self.interp.model_feature_length[self.verifier]
        feats = self.pre.state.feat_buf[-length:][None]
        self.verifier_score.copy_(
            self.interp.models[self.verifier].scores(feats))

    def _state_tensors(self) -> list:
        return list(self.pre.state) + _tree_tensors(
            tuple(self.carries.values()))

    def capture(self) -> None:
        """Warm up, capture `_step` into a graph, restore the state; the
        split verifier's step into a second graph in the same pool, warmed
        up on the same side stream."""
        side = torch.cuda.Stream(self.pre.device)
        self.graph, self.mel_launches_per_replay = capture_graph(
            self._step, self.pre.device, self._state_tensors(),
            self.WARMUP_STEPS, side=side)
        if self.verifier is not None:
            self.verifier_graph, _ = capture_graph(
                self._verifier_step, self.pre.device, (),
                self.WARMUP_STEPS, pool=self.graph.pool(), side=side)

    def run(self, chunk: np.ndarray) -> dict:
        """One [1280] float32 chunk -> {model: probability}, the split
        verifier left out."""
        hidden = self.interp.hidden_states
        with tracing.span("nww.predict.upload"):
            for name, carry in self.carries.items():
                if hidden[name] is None:    # after reset(): the zero state
                    for t in _tree_tensors(carry):
                        t.zero_()
            self.chunk.copy_(torch.from_numpy(chunk))
        if self.use_graph and self.graph is None:
            self.capture()
        with tracing.span("nww.step.replay", device=self.pre.device):
            if self.use_graph:
                replay(self.graph, self.mel_launches_per_replay)
            else:
                self._step()
        with tracing.span("nww.predict.readback"):
            scores = self.scores.cpu().numpy()
        self.pre._frames_seen += 1
        for name, carry in self.carries.items():
            hidden[name] = carry
        return dict(zip(self.names, scores.astype(np.float64)))

    def run_verifier(self) -> np.float64:
        """The split verifier's probability on the newest frames."""
        with tracing.span("nww.step.verifier", device=self.pre.device):
            if self.use_graph:
                replay(self.verifier_graph, 0)
            else:
                self._verifier_step()
            score = self.verifier_score.cpu().numpy()
        return score.astype(np.float64)[0]


class NanoInterpreter:
    """Main inference engine. Use `NanoInterpreter.load_model()`.

    `cascade_config`: the gate, verifier and gate threshold of a local
    cascade (load_model finds them), known before the one-call step is
    built. kwargs: `device` (default "cuda"), `encoder_state_dict` (default: the
    encoder bundled in the first artifact that has one),
    `enable_noise_reduction`, `vad_threshold`, and the AudioFeatures
    arguments.
    """

    def __init__(self, wakeword_models: List[str],
                 cascade_config: Optional[dict] = None, **kwargs):
        self._init_empty()
        self.cascade_config = dict(cascade_config or {})
        device = kwargs.get("device", "cuda")
        encoder = kwargs.pop("encoder_state_dict", None)
        for mdl_path in wakeword_models:
            model_key = os.path.splitext(os.path.basename(mdl_path))[0]
            if model_key in self.models:
                logging.warning(f"Model '{model_key}' already loaded. Skipping.")
                continue
            if mdl_path.endswith(".onnx"):
                self._register(model_key, _OnnxSession(mdl_path, device))
                continue
            header, model, enc = load_nww(mdl_path, device=device)
            self._register(model_key, _LocalSession(model, header))
            if encoder is None:
                encoder = enc
        self._setup_components(encoder_state_dict=encoder, **kwargs)
        self._fused_step = self._build_fused_step()

    def _init_empty(self) -> None:
        self.models: Dict[str, object] = {}
        self.model_feature_length: Dict[str, int] = {}
        self.is_stateful: Dict[str, bool] = {}
        self.hidden_states: Dict[str, object] = {}
        self.class_mapping: Dict[str, Dict[str, str]] = {}
        self.raw_scores: Dict[str, float] = {}
        self.post_processed_scores: Dict[str, float] = {}
        self.cascade_config: dict = {}
        self._listen_thread: Optional[threading.Thread] = None
        self._stop_event: Optional[threading.Event] = None
        self._fused_step: Optional[_FusedStep] = None
        self._chunk_serial = 0      # chunks scored: the spans' request id

    def _register(self, model_key: str, session) -> None:
        self.models[model_key] = session
        self.model_feature_length[model_key] = session.feature_length
        self.is_stateful[model_key] = session.stateful
        self.hidden_states[model_key] = None
        self.class_mapping[model_key] = {"0": model_key}
        self.raw_scores[model_key] = 0.0
        self.post_processed_scores[model_key] = 0.0

    # -- properties ---------------------------------------------------------------

    @property
    def is_cascade(self) -> bool:
        return bool(self.cascade_config)

    @property
    def model_name(self) -> str:
        if self.is_cascade:
            return self.cascade_config["verifier"]
        return next(iter(self.models))

    @property
    def gate_name(self) -> Optional[str]:
        return self.cascade_config.get("gate")

    @property
    def gate_score(self) -> float:
        if self.gate_name:
            return self.post_processed_scores.get(self.gate_name, 0.0)
        return 0.0

    @property
    def verifier_score(self) -> float:
        return self.post_processed_scores.get(self.model_name, 0.0)

    @property
    def score(self) -> float:
        return self.verifier_score

    @property
    def info(self) -> dict:
        from nanowakeword_tpu_torch.interpreter.remote_verifier import \
            _RemoteSession
        verifier_name = self.cascade_config.get("verifier", self.model_name)
        is_remote = isinstance(self.models.get(verifier_name), _RemoteSession)
        d = {
            "model_name": self.model_name,
            "is_cascade": self.is_cascade,
            "is_remote": is_remote,
            "gate_name": self.gate_name,
            "gate_threshold": self.cascade_config.get("gate_threshold", None),
            "loaded_models": list(self.models.keys()),
            "score": self.score,
            "gate_score": self.gate_score,
            "raw_scores": dict(self.raw_scores),
        }
        if is_remote:
            d["remote_uri"] = self.models[verifier_name].uri
        return d

    def __repr__(self) -> str:
        if self.is_cascade:
            return (f"NanoInterpreter(model='{self.model_name}', "
                    f"gate='{self.gate_name}', gate_threshold="
                    f"{self.cascade_config.get('gate_threshold', 0.3)})")
        models = list(self.models.keys())
        if len(models) == 1:
            return f"NanoInterpreter(model='{models[0]}')"
        return f"NanoInterpreter(models={models})"

    def detected(self, threshold: float, model: Optional[str] = None) -> bool:
        name = model or self.model_name
        return self.post_processed_scores.get(name, 0.0) >= threshold

    def stop(self) -> None:
        if self._stop_event is not None:
            self._stop_event.set()
        if self._listen_thread is not None and self._listen_thread.is_alive():
            self._listen_thread.join(timeout=2.0)
        self._listen_thread = None
        self._stop_event = None

    # -- load_model ------------------------------------------------------------------

    @classmethod
    def load_model(cls,
                   model: Union[str, List[str], None] = None,
                   cascade: bool = False,
                   gate_model: Optional[str] = None,
                   gate_threshold: float = 0.3,
                   remote_verifier: Optional[str] = None,
                   remote_pipeline: str = "verifier_only",
                   remote_timeout: float = 2.0,
                   remote_api_key: Optional[str] = None,
                   remote_token: Optional[str] = None,
                   remote_ssl_certfile: Optional[str] = None,
                   remote_ssl_keyfile: Optional[str] = None,
                   remote_ssl_ca_certs: Optional[str] = None,
                   **kwargs):
        from nanowakeword_tpu_torch.interpreter.remote_verifier import \
            _VALID_PIPELINES

        if remote_pipeline not in _VALID_PIPELINES:
            raise ValueError(f"Invalid remote_pipeline '{remote_pipeline}'. "
                             f"Choose from: {sorted(_VALID_PIPELINES)}")

        paths: List[str] = []
        if model is not None:
            if isinstance(model, str):
                paths = [model]
            elif isinstance(model, list):
                paths = model
            else:
                raise TypeError("`model` must be a string, list of strings, "
                                "or None.")
            for path in paths:
                if not os.path.exists(path):
                    raise FileNotFoundError(f"Model file not found: {path}")
        if not paths and remote_verifier is None:
            raise ValueError("load_model needs at least one local model or "
                             "a remote_verifier")

        remote_cfg: Optional[dict] = None
        if remote_verifier is not None:
            if len(paths) > 1:
                raise ValueError(
                    "remote_verifier supports at most one local model path "
                    "(the gate). The verifier runs on the remote server.")
            if paths:
                gate_stem = os.path.splitext(os.path.basename(paths[0]))[0]
                verifier_stem = (gate_stem[:-5] if gate_stem.endswith("_lite")
                                 else gate_stem + "_remote")
            else:
                gate_stem = None
                verifier_stem = "remote_model"
            remote_cfg = {
                "gate": gate_stem, "verifier": verifier_stem,
                "gate_threshold": gate_threshold, "uri": remote_verifier,
                "pipeline": remote_pipeline, "timeout": remote_timeout,
                "api_key": remote_api_key, "token": remote_token,
                "ssl_certfile": remote_ssl_certfile,
                "ssl_keyfile": remote_ssl_keyfile,
                "ssl_ca_certs": remote_ssl_ca_certs,
            }
            logging.info(
                f"[NanoInterpreter] Remote mode: gate='{gate_stem or 'none'}' "
                f"(local) -> verifier='{verifier_stem}' "
                f"(remote @ {remote_verifier}, pipeline='{remote_pipeline}')")

        cascade_cfg: dict = {}
        if (remote_cfg is None and (cascade or gate_model is not None)
                and len(paths) == 1):
            main_path = paths[0]
            stem = os.path.splitext(os.path.basename(main_path))[0]
            if gate_model is not None:
                if not os.path.exists(gate_model):
                    raise FileNotFoundError(
                        f"The specified gate model does not exist: {gate_model}")
                gate_path_found = gate_model
                gate_name = os.path.splitext(os.path.basename(gate_model))[0]
                logging.info(f"[NanoInterpreter] Cascade (custom gate): "
                             f"gate='{gate_name}' -> verifier='{stem}'")
            else:
                # auto-discover `<stem>_lite` beside the model: the native
                # artifact first, then the interchange `.onnx`
                model_dir = os.path.dirname(os.path.abspath(main_path))
                gate_name = stem + "_lite"
                gate_path_found = None
                for ext in (EXTENSION, ".onnx"):
                    candidate = os.path.join(model_dir, gate_name + ext)
                    if os.path.exists(candidate):
                        gate_path_found = candidate
                        break
                if gate_path_found is None:
                    logging.warning(
                        f"[NanoInterpreter] cascade=True but no lite model "
                        f"'{gate_name}' beside '{main_path}'. Falling back "
                        "to single-model mode.")
                else:
                    logging.info(
                        f"[NanoInterpreter] Cascade (auto-discovered): "
                        f"gate='{gate_name}' -> verifier='{stem}'")
            if gate_path_found:
                # the gate scores first, so the verifier can read its score
                paths = [gate_path_found, main_path]
                cascade_cfg = {"gate": gate_name, "verifier": stem,
                               "gate_threshold": gate_threshold}

        if remote_cfg is not None and not paths:
            # no local model: raw audio goes to the server, no preprocessor
            instance = cls.__new__(cls)
            instance._init_empty()
            instance._setup_components_no_preprocessor(**kwargs)
        else:
            instance = cls(wakeword_models=paths, cascade_config=cascade_cfg,
                           **kwargs)

        if remote_cfg is not None:
            instance._inject_remote_session(remote_cfg)
            if remote_cfg["gate"] is not None:
                instance.cascade_config = {
                    "gate": remote_cfg["gate"],
                    "verifier": remote_cfg["verifier"],
                    "gate_threshold": remote_cfg["gate_threshold"],
                }
        if instance._fused_step is not None and instance._fused_step.use_graph:
            # capture now, so that the first chunk is already one replay
            instance._fused_step.capture()
        return instance

    def _inject_remote_session(self, remote_cfg: dict) -> None:
        from nanowakeword_tpu_torch.interpreter.remote_verifier import \
            _RemoteSession
        verifier_name = remote_cfg["verifier"]
        session = _RemoteSession(
            uri=remote_cfg["uri"], model_name=verifier_name,
            pipeline=remote_cfg["pipeline"], timeout=remote_cfg["timeout"],
            api_key=remote_cfg.get("api_key"), token=remote_cfg.get("token"),
            ssl_certfile=remote_cfg.get("ssl_certfile"),
            ssl_keyfile=remote_cfg.get("ssl_keyfile"),
            ssl_ca_certs=remote_cfg.get("ssl_ca_certs"))
        self._register(verifier_name, session)
        # a remote session cannot join the one-call device step
        self._fused_step = None
        logging.info(f"[NanoInterpreter] Remote verifier '{verifier_name}' "
                     f"registered (pipeline='{remote_cfg['pipeline']}').")

    # -- component setup ---------------------------------------------------------

    def _setup_gates(self, kwargs: dict) -> None:
        """The prediction buffers, noise reduction and the VAD gate."""
        self.prediction_buffer = defaultdict(partial(deque, maxlen=30))
        use_noise_reduction = kwargs.pop("enable_noise_reduction", False)
        if use_noise_reduction and not NOISEREDUCE_AVAILABLE:
            logging.warning("`enable_noise_reduction` is True, but "
                            "`noisereduce` is not installed. Disabling.")
        self.noise_reducer_enabled = bool(use_noise_reduction
                                          and NOISEREDUCE_AVAILABLE)
        self.vad_threshold = kwargs.pop("vad_threshold", 0)
        if self.vad_threshold > 0:
            from nanowakeword_tpu_torch.interpreter.vad import VAD
            self.vad = VAD()

    def _setup_components(self, **kwargs):
        self._setup_gates(kwargs)
        onnx_frontend = kwargs.pop("onnx_frontend", None)
        if onnx_frontend is not None:
            # the exported `_mel_stream` / `_embedding` pair run by the
            # numpy evaluator on the host: (mel_path, emb_path) or a path
            # prefix such as "<dir>/<model_name>"
            from nanowakeword_tpu_torch.export.frontend import \
                OnnxStreamingFrontend
            if isinstance(onnx_frontend, (tuple, list)):
                mel_path, emb_path = onnx_frontend
            else:
                mel_path = f"{onnx_frontend}_mel_stream.onnx"
                emb_path = f"{onnx_frontend}_embedding.onnx"
            self.preprocessor = OnnxStreamingFrontend(mel_path, emb_path)
            return
        self.preprocessor = AudioFeatures(**kwargs)

    def _setup_components_no_preprocessor(self, **kwargs):
        self._setup_gates(kwargs)
        self.preprocessor = None

    # -- the one-call streaming step ------------------------------------------------

    def _build_fused_step(self) -> Optional[_FusedStep]:
        """The one-call step over all models, or None (general path) when
        the preprocessor is not AudioFeatures, or there is no model, or a
        session that is not local (remote, or `.onnx`). A cascade's
        stateless verifier is split off to run apart."""
        if not isinstance(self.preprocessor, AudioFeatures) or not self.models:
            return None
        if any(not isinstance(s, _LocalSession)
               for s in self.models.values()):
            return None
        verifier = self.cascade_config.get("verifier")
        if verifier is None or self.models[verifier].stateful:
            verifier = None     # a carry must advance on every chunk
        return _FusedStep(self, verifier)

    # -- predict ------------------------------------------------------------------------

    def _result(self, scores: dict) -> DetectionResult:
        return DetectionResult(scores=dict(scores),
                               model_name=self.model_name,
                               gate_name=self.gate_name)

    def _gate_is_low(self, model_key: str, chunk_scores: dict) -> bool:
        """Whether `model_key` is the cascade's verifier and its gate, which
        scored before it, stayed under the threshold."""
        cfg = self.cascade_config
        return bool(cfg) and model_key == cfg["verifier"] and \
            chunk_scores.get(cfg["gate"], 0.0) < cfg["gate_threshold"]

    def _zeroed(self, model_key: str, frames_avail: int,
                chunk_scores: dict) -> bool:
        """Whether the one-call step's rules serve 0.0 for `model_key`
        whatever it scored: its window is not yet filled with frames, or
        its gate, served before it in `chunk_scores`, stayed low."""
        return frames_avail < self.model_feature_length[model_key] \
            or self._gate_is_low(model_key, chunk_scores)

    def _served(self, model_key: str, raw: dict, frames_avail: int,
                chunk_scores: dict) -> float:
        """The score the one-call step's rules serve for `model_key` from
        its raw score (`_zeroed`, then `_record_raw`)."""
        if self._zeroed(model_key, frames_avail, chunk_scores):
            return 0.0
        return self._record_raw(model_key, float(raw[model_key]))

    def _record_raw(self, model_key: str, score: float) -> float:
        """Keep the raw score; the first 5 predictions are zeroed."""
        self.raw_scores[model_key] = score
        if len(self.prediction_buffer.get(model_key, [])) < 5:
            return 0.0
        return score

    def _finish(self, chunk_scores: dict, x: np.ndarray, patience,
                threshold, debounce_time, n_prepared: int) -> DetectionResult:
        """The VAD gate over frames [-7:-4], the patience / debounce
        filters, and the score buffers."""
        gated_scores = chunk_scores.copy()
        if self.vad_threshold > 0:
            self.vad(x)
            vad_frames = list(self.vad.prediction_buffer)[-7:-4]
            vad_max = np.max(vad_frames) if len(vad_frames) > 0 else 0
            if vad_max < self.vad_threshold:
                for model_key in gated_scores:
                    gated_scores[model_key] = 0.0
        self._apply_post_processing(gated_scores, patience, threshold,
                                    debounce_time, n_prepared)
        for model_key, score in gated_scores.items():
            self.prediction_buffer[model_key].append(score)
            self.post_processed_scores[model_key] = score
        return self._result(gated_scores)

    def _predict_fused(self, x: np.ndarray, patience, threshold,
                       debounce_time) -> DetectionResult:
        """predict() over the one-call step; same semantics as the general
        path. Only the last chunk fed in a call is served, so a split
        verifier runs at most once a call: on the last chunk, and only if
        the rules would serve its score. Any other model scores on every
        chunk."""
        pre, step = self.preprocessor, self._fused_step
        with tracing.span("nww.predict.upload"):
            chunks = pre._chunker.feed(np.asarray(x, np.float32).reshape(-1))
            pre.accumulated_samples = pre._chunker.pending
        n = chunks.shape[0]
        if n == 0:
            return self._result(self.post_processed_scores)

        raw = {}
        for chunk in chunks:
            raw = step.run(chunk)
        self._chunk_serial += n
        counters["interpreter.chunks"] += n
        frames_avail = min(pre._frames_seen, pre.state.feat_buf.shape[0])
        verifier = self.cascade_config.get("verifier")
        chunk_scores = {}
        if step.verifier is not None:
            gate = self.cascade_config["gate"]
            chunk_scores[gate] = self._served(gate, raw, frames_avail, {})
            ran = not self._zeroed(verifier, frames_avail, chunk_scores)
            if ran:
                raw[verifier] = step.run_verifier()
            counters["interpreter.verifier_runs"] += ran
            counters["interpreter.verifier_skipped"] += n - ran
        elif verifier in raw:
            counters["interpreter.verifier_runs"] += n

        with tracing.span("nww.predict.rules"):
            for model_key in self.models:
                if model_key not in chunk_scores:   # a split gate's is
                    chunk_scores[model_key] = self._served(
                        model_key, raw, frames_avail, chunk_scores)
            if verifier in raw and \
                    not self._zeroed(verifier, frames_avail, chunk_scores):
                counters["interpreter.verifier_served"] += 1
            return self._finish(chunk_scores, x, patience, threshold,
                                debounce_time, n * CHUNK)

    def predict(self, x: np.ndarray, patience: dict = {},
                threshold: dict = {},
                debounce_time: float = 0.0) -> DetectionResult:
        with tracing.span("nww.predict", request=self._chunk_serial):
            return self._predict(x, patience, threshold, debounce_time)

    def _predict(self, x: np.ndarray, patience, threshold,
                 debounce_time) -> DetectionResult:
        if not isinstance(x, np.ndarray):
            raise ValueError("Input audio `x` must be a Numpy array.")
        if self.noise_reducer_enabled:
            x = self._reduce_noise(x)

        # full-remote: no local preprocessor, raw audio to the server
        if self.preprocessor is None:
            chunk_scores = {}
            for model_key, session in self.models.items():
                chunk_scores[model_key] = self._record_raw(
                    model_key, session.run_audio(x))
            for model_key, score in chunk_scores.items():
                self.prediction_buffer[model_key].append(score)
                self.post_processed_scores[model_key] = score
            return self._result(chunk_scores)

        if self._fused_step is not None:
            return self._predict_fused(x, patience, threshold, debounce_time)

        # the general path: one session.run per model
        with tracing.span("nww.predict.features"):
            n_prepared_samples = self.preprocessor(x)
        if n_prepared_samples < CHUNK:
            return self._result(self.post_processed_scores)
        self._chunk_serial += n_prepared_samples // CHUNK
        counters["interpreter.chunks"] += n_prepared_samples // CHUNK

        verifier = (self.cascade_config or {}).get("verifier")
        chunk_scores = {}
        for model_key, session in self.models.items():
            required_frames = self.model_feature_length[model_key]
            if self.preprocessor.feature_buffer.shape[0] < required_frames \
                    or self._gate_is_low(model_key, chunk_scores):
                chunk_scores[model_key] = 0.0
                continue
            with tracing.span("nww.session.run", model=model_key):
                features = self.preprocessor.get_features(required_frames)
                if self.is_stateful.get(model_key, False):
                    score, new_carry = session.run(
                        features, carry=self.hidden_states.get(model_key))
                    self.hidden_states[model_key] = new_carry
                else:
                    score, _ = session.run(features)
            if model_key == verifier:
                counters["interpreter.verifier_runs"] += 1
                counters["interpreter.verifier_served"] += 1
            chunk_scores[model_key] = self._record_raw(model_key, score)
        with tracing.span("nww.predict.rules"):
            return self._finish(chunk_scores, x, patience, threshold,
                                debounce_time, n_prepared_samples)

    def reset(self):
        self.prediction_buffer.clear()
        if self.preprocessor is not None:
            self.preprocessor.reset()
        for model_key in self.hidden_states:
            self.hidden_states[model_key] = None
        for model_key in self.raw_scores:
            self.raw_scores[model_key] = 0.0
            self.post_processed_scores[model_key] = 0.0

    def predict_clip(self, clip: Union[str, np.ndarray],
                     chunk_size: int = 1280, **kwargs) -> list:
        """Predict on a full clip by simulating a stream."""
        if isinstance(clip, str):
            with wave.open(clip, mode="rb") as f:
                if (f.getframerate() != 16000 or f.getsampwidth() != 2
                        or f.getnchannels() != 1):
                    raise ValueError("Audio clip must be a 16kHz, 16-bit, "
                                     "single-channel WAV file.")
                data = np.frombuffer(f.readframes(f.getnframes()),
                                     dtype=np.int16)
        elif isinstance(clip, np.ndarray):
            data = clip
        else:
            raise TypeError("`clip` must be a file path or a numpy array.")
        return [self.predict(data[i:i + chunk_size], **kwargs)
                for i in range(0, len(data), chunk_size)]

    def listen(self,
               on_detection: Optional[Callable[[str, float], None]] = None,
               threshold: float = 0.5,
               cooldown: float = 1.0,
               chunk_size: int = 1280,
               on_score: Optional[Callable[[float, float], None]] = None,
               on_audio: Optional[Callable[[np.ndarray], None]] = None,
               blocking: bool = True) -> None:
        """Microphone loop. Requires pyaudio."""
        try:
            import pyaudio
        except ImportError:
            raise ImportError("PyAudio is required for listen(). Install it "
                              "with: pip install pyaudio")

        if on_detection is None:
            def on_detection(name: str, score: float) -> None:
                print(f"\nDetected '{name}'!  (score: {score:.5f})")

        def _loop():
            # A capture thread pushes int16 frames into the ring (which drops
            # the OLDEST samples on overflow, so capture never blocks); this
            # thread pops whole chunks and scores them. A slow scoring step
            # therefore skips audio instead of stalling the microphone.
            from nanowakeword_tpu_torch.runtime import AudioRing
            ring = AudioRing(capacity=16000 * 10)
            pa = pyaudio.PyAudio()
            stream = pa.open(format=pyaudio.paInt16, channels=1, rate=16000,
                             input=True, frames_per_buffer=chunk_size)
            last_detection = 0.0
            stop_event = self._stop_event
            capture_stop = threading.Event()

            def _capture():
                while not capture_stop.is_set():
                    try:
                        ring.push(np.frombuffer(
                            stream.read(chunk_size,
                                        exception_on_overflow=False),
                            dtype=np.int16))
                    except OSError:
                        return

            capture_thread = threading.Thread(target=_capture, daemon=True)
            capture_thread.start()
            try:
                while not (stop_event and stop_event.is_set()):
                    if ring.size < chunk_size:
                        time.sleep(chunk_size / 16000 / 4)
                        continue
                    audio = ring.pop(chunk_size)
                    if on_audio is not None:
                        on_audio(audio)
                    self.predict(audio)
                    v_score, g_score = self.verifier_score, self.gate_score
                    if on_score is not None:
                        on_score(v_score, g_score)
                    now = time.monotonic()
                    if (v_score > threshold
                            and (now - last_detection) > cooldown):
                        on_detection(self.model_name, v_score)
                        last_detection = now
                        self.reset()
            except KeyboardInterrupt:
                pass
            finally:
                capture_stop.set()
                stream.stop_stream()
                stream.close()
                pa.terminate()
                capture_thread.join(timeout=1.0)

        if blocking:
            _loop()
        else:
            self._stop_event = threading.Event()
            self._listen_thread = threading.Thread(target=_loop, daemon=True)
            self._listen_thread.start()

    # -- helpers ----------------------------------------------------------------

    def _reduce_noise(self, x: np.ndarray) -> np.ndarray:
        try:
            audio_float = x.astype(np.float32) / 32767.0
            reduced = nr.reduce_noise(y=audio_float, sr=16000, stationary=True)
            return (reduced * 32767.0).astype(np.int16)
        except Exception as e:  # noqa: BLE001
            logging.warning(f"Noise reduction failed: {e}. Returning original "
                            "audio.")
            return x

    def _apply_post_processing(self, predictions, patience, threshold,
                               debounce_time, n_prepared_samples):
        """Patience / debounce filters."""
        if not patience and debounce_time <= 0:
            return
        if (patience or debounce_time > 0) and not threshold:
            raise ValueError("`threshold` must be provided when using "
                             "`patience` or `debounce_time`.")
        if patience and debounce_time > 0:
            raise ValueError("`patience` and `debounce_time` cannot be used "
                             "together.")

        for model_key in predictions.keys():
            if predictions[model_key] == 0.0:
                continue
            if model_key in patience:
                required = patience[model_key]
                if len(self.prediction_buffer[model_key]) < required:
                    predictions[model_key] = 0.0
                    continue
                recent = np.array(
                    list(self.prediction_buffer[model_key])[-(required - 1):]
                    + [predictions[model_key]])
                if (recent >= threshold[model_key]).sum() < required:
                    predictions[model_key] = 0.0
            elif debounce_time > 0 and model_key in threshold:
                frame_dur = n_prepared_samples / 16000.0
                if frame_dur <= 0:
                    continue
                n_check = int(np.ceil(debounce_time / frame_dur))
                recent = np.array(self.prediction_buffer[model_key])[-n_check:]
                if (predictions[model_key] >= threshold[model_key]
                        and (recent >= threshold[model_key]).any()):
                    predictions[model_key] = 0.0
