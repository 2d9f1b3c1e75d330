"""NanoInterpreter: the streaming wake-word inference engine, on one torch
device.

The counterpart of `nanowakeword_tpu/interpreter/nanointerpreter.py` for
local `.nww` models: `DetectionResult`, `_LocalSession`, and
`NanoInterpreter` with `load_model()` (single models and cascades, with
`<stem>_lite` gate auto-discovery), `predict()` (warm-up guard, zeroed first
predictions, cascade gate, patience/debounce), `predict_clip()`, `reset()`
and the score properties.

Each 80 ms chunk is one eager step: the feature stream step and every
model's score, with one copy of the scores back to the host.

Not ported yet (ROADMAP.md): remote verifiers, `.onnx` models and the ONNX
frontend, the VAD gate (`vad_threshold > 0`), noise reduction and
`listen()`; each raises NotImplementedError.
"""

from __future__ import annotations

import logging
import os
import warnings
import wave
from collections import defaultdict, deque
from functools import partial
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from nanowakeword_tpu_torch.data.features import CHUNK, AudioFeatures
from nanowakeword_tpu_torch.export.artifact import EXTENSION, load_nww


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
    probability, the exported-graph contract."""

    def __init__(self, model, header):
        if header.get("stateful", False):
            raise NotImplementedError("stateful models are not ported yet")
        self.model = model
        self.header = header
        self.stateful = False

    @property
    def feature_length(self) -> int:
        return int(self.header["input_shape"][0])

    def scores(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, T, F] tensor on the model's device -> [B] probabilities."""
        return torch.sigmoid(self.model.module(feats)).reshape(-1)

    @torch.no_grad()
    def run(self, feats: np.ndarray, carry=None):
        """[1, T, F] features -> (probability, carry); carry stays None."""
        del carry
        probs = self.scores(torch.as_tensor(feats, dtype=torch.float32,
                                            device=self.model.device))
        return float(probs[0]), None

    @torch.no_grad()
    def run_batch(self, feats: np.ndarray) -> np.ndarray:
        """[B, T, F] -> [B] probabilities."""
        probs = self.scores(torch.as_tensor(feats, dtype=torch.float32,
                                            device=self.model.device))
        return probs.cpu().numpy()


class NanoInterpreter:
    """Main inference engine. Use `NanoInterpreter.load_model()`.

    kwargs: `device` (default "cuda"), `encoder_state_dict` (default: the
    encoder bundled in the first artifact that has one), and the
    AudioFeatures arguments.
    """

    def __init__(self, wakeword_models: List[str], **kwargs):
        self.models: Dict[str, _LocalSession] = {}
        self.model_feature_length: Dict[str, int] = {}
        self.raw_scores: Dict[str, float] = {}
        self.post_processed_scores: Dict[str, float] = {}
        self.cascade_config: dict = {}

        device = kwargs.get("device", "cuda")
        encoder = kwargs.pop("encoder_state_dict", None)
        for mdl_path in wakeword_models:
            model_key = os.path.splitext(os.path.basename(mdl_path))[0]
            if model_key in self.models:
                logging.warning(f"Model '{model_key}' already loaded. Skipping.")
                continue
            if not mdl_path.endswith(EXTENSION):
                raise NotImplementedError(
                    f"'{mdl_path}': only .nww models are ported to PyTorch; "
                    ".onnx models are still to be ported (ROADMAP.md)")
            header, model, enc = load_nww(mdl_path, device=device)
            session = _LocalSession(model, header)
            self.models[model_key] = session
            self.model_feature_length[model_key] = session.feature_length
            self.raw_scores[model_key] = 0.0
            self.post_processed_scores[model_key] = 0.0
            if encoder is None:
                encoder = enc
        self._setup_components(encoder_state_dict=encoder, **kwargs)

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
        return {
            "model_name": self.model_name,
            "is_cascade": self.is_cascade,
            "is_remote": False,
            "gate_name": self.gate_name,
            "gate_threshold": self.cascade_config.get("gate_threshold", None),
            "loaded_models": list(self.models.keys()),
            "score": self.score,
            "gate_score": self.gate_score,
            "raw_scores": dict(self.raw_scores),
        }

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

    # -- load_model ------------------------------------------------------------------

    @classmethod
    def load_model(cls,
                   model: Union[str, List[str], None] = None,
                   cascade: bool = False,
                   gate_model: Optional[str] = None,
                   gate_threshold: float = 0.3,
                   remote_verifier: Optional[str] = None,
                   **kwargs):
        if remote_verifier is not None:
            raise NotImplementedError(
                "remote verifiers are not ported to PyTorch yet (ROADMAP.md)")
        if isinstance(model, str):
            paths = [model]
        elif isinstance(model, list):
            paths = model
        else:
            raise TypeError("`model` must be a string or a list of strings.")
        if not paths:
            raise ValueError("load_model needs at least one local model")
        for path in paths:
            if not os.path.exists(path):
                raise FileNotFoundError(f"Model file not found: {path}")

        cascade_cfg: dict = {}
        if (cascade or gate_model is not None) and len(paths) == 1:
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

        instance = cls(wakeword_models=paths, **kwargs)
        instance.cascade_config = cascade_cfg
        return instance

    # -- component setup ---------------------------------------------------------

    def _setup_components(self, **kwargs):
        self.prediction_buffer = defaultdict(partial(deque, maxlen=30))
        if kwargs.pop("enable_noise_reduction", False):
            raise NotImplementedError(
                "noise reduction is not ported to PyTorch yet (ROADMAP.md)")
        self.vad_threshold = kwargs.pop("vad_threshold", 0)
        if self.vad_threshold > 0:
            raise NotImplementedError(
                "the VAD gate is not ported to PyTorch yet (ROADMAP.md)")
        if kwargs.pop("onnx_frontend", None) is not None:
            raise NotImplementedError(
                "the ONNX frontend is not ported to PyTorch yet (ROADMAP.md)")
        self.preprocessor = AudioFeatures(**kwargs)

    # -- streaming step -------------------------------------------------------------

    @torch.no_grad()
    def _step(self, chunk: np.ndarray) -> dict:
        """One 80 ms chunk: the feature stream step, then every model on the
        newest frames of the feature ring. -> {model: probability}."""
        pre = self.preprocessor
        pre.state = pre._stream_step_impl(
            pre.state, torch.from_numpy(chunk).to(pre.device))
        pre._frames_seen += 1
        feat_buf = pre.state.feat_buf
        scores = torch.cat([
            session.scores(feat_buf[-self.model_feature_length[name]:][None])
            for name, session in self.models.items()])
        return dict(zip(self.models, scores.cpu().numpy().astype(np.float64)))

    # -- predict ------------------------------------------------------------------------

    def predict(self, x: np.ndarray, patience: dict = {},
                threshold: dict = {},
                debounce_time: float = 0.0) -> DetectionResult:
        if not isinstance(x, np.ndarray):
            raise ValueError("Input audio `x` must be a Numpy array.")
        pre = self.preprocessor
        chunks = pre._chunker.feed(np.asarray(x, np.float32).reshape(-1))
        if chunks.shape[0] == 0:
            pre.accumulated_samples = pre._chunker.pending
            return DetectionResult(scores=dict(self.post_processed_scores),
                                   model_name=self.model_name,
                                   gate_name=self.gate_name)

        raw = {}
        for chunk in chunks:
            raw = self._step(chunk)
        n_prepared = chunks.shape[0] * CHUNK
        pre.accumulated_samples = pre._chunker.pending

        frames_avail = min(pre._frames_seen, pre.state.feat_buf.shape[0])
        chunk_scores = {}
        for model_key, score in raw.items():
            # warm-up guard: the model's window must be filled with frames
            if frames_avail < self.model_feature_length[model_key]:
                chunk_scores[model_key] = 0.0
                continue
            # the cascade's verifier scores only when the gate passed
            if self.cascade_config \
                    and model_key == self.cascade_config["verifier"]:
                gate_score = chunk_scores.get(
                    self.cascade_config["gate"], 0.0)
                if gate_score < self.cascade_config["gate_threshold"]:
                    chunk_scores[model_key] = 0.0
                    continue
            score = float(score)
            self.raw_scores[model_key] = score
            # the first 5 predictions are zeroed
            if len(self.prediction_buffer.get(model_key, [])) < 5:
                score = 0.0
            chunk_scores[model_key] = score

        gated_scores = chunk_scores.copy()
        self._apply_post_processing(gated_scores, patience, threshold,
                                    debounce_time, n_prepared)
        for model_key, score in gated_scores.items():
            self.prediction_buffer[model_key].append(score)
            self.post_processed_scores[model_key] = score
        return DetectionResult(scores=dict(gated_scores),
                               model_name=self.model_name,
                               gate_name=self.gate_name)

    def reset(self):
        self.prediction_buffer.clear()
        self.preprocessor.reset()
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

    def listen(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "listen() is not ported to PyTorch yet (ROADMAP.md)")

    # -- helpers ----------------------------------------------------------------

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
