"""End-to-end training: raw audio -> log-mel -> encoder -> classifier, jointly.

The counterpart of `nanowakeword_tpu/train/e2e.py`: one module over the
whole acoustic stack (`EndToEndModule`), the raw-audio training set
(`AudioClipDataset`), the Model-like handle the Trainer drives (`E2EModel`)
and `split_variables`. With `end_to_end.enabled: true` the -T stage trains
it from `end_to_end.audio_manifest` and bundles the trained encoder into the
`.nww`, so the interpreter serves it.

The log-mel has no parameter and the audio needs no gradient, so the
gradient starts at the encoder. `EndToEndModule` computes the mel outside
autograd with `ops/mel_cuda.mel_frontend_fused`: the hand-written kernel for
audio on a CUDA device, which has no backward and is asked for none, and
its plain version for audio on the CPU. On int16-valued audio (what
`load_audio` gives for 16-bit WAVs) the two are equal bit for bit.

The encoder runs in `encoder_dtype` (bfloat16 by default, as the
reference's module does): it is called with copies of its float32
parameters cast to that dtype, so each layer's activations round to it and
the gradient reaches the float32 masters through the cast. Its output is
cast back to float32 before the classifier.
"""

from __future__ import annotations

import pathlib
import random
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from nanowakeword_tpu_torch.convert import (
    e2e_state_dict_from_flax, encoder_state_dict_from_flax,
    flax_encoder_variables_from_state_dict)
from nanowakeword_tpu_torch.data.features import EMB_OFFSET
from nanowakeword_tpu_torch.models.embedding import (build_encoder,
                                                     infer_encoder_arch)
from nanowakeword_tpu_torch.models.model import Model, flax_init_
from nanowakeword_tpu_torch.ops.mel_cuda import mel_frontend_fused
from nanowakeword_tpu_torch.utils.audio_io import load_audio
from nanowakeword_tpu_torch.utils.logger import print_info


class EndToEndModule(nn.Module):
    """audio [B, S] (int16 scale) -> wake-word logits [B, 1].

    The parameter-free mel frontend, a trainable speech encoder and a
    classifier (a WakeWordModule). `freeze_encoder` keeps the encoder's
    parameters but gives them no gradient."""

    def __init__(self, encoder: nn.Module, classifier: nn.Module,
                 context_frames: int = 16, freeze_encoder: bool = False,
                 encoder_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.encoder = encoder
        self.classifier = classifier
        self.context_frames = context_frames
        self.freeze_encoder = freeze_encoder
        self.encoder_dtype = encoder_dtype

    def _embed(self, mel: torch.Tensor) -> torch.Tensor:
        if self.encoder_dtype == torch.float32:
            return self.encoder(mel)
        cast = {name: p.to(self.encoder_dtype)
                for name, p in self.encoder.named_parameters()}
        return torch.func.functional_call(self.encoder, cast, (mel,))

    def embed(self, audio: torch.Tensor) -> torch.Tensor:
        """audio [B, S] -> the classifier's input [B, context_frames, 96]
        in `encoder_dtype`: the last frames, left zero-padded when short."""
        with torch.no_grad():
            mel = mel_frontend_fused(audio.contiguous())[:, EMB_OFFSET:]
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_encoder):
            emb = self._embed(mel)
        t = emb.shape[1]
        if t >= self.context_frames:
            return emb[:, -self.context_frames:]
        return nn.functional.pad(emb, (0, 0, self.context_frames - t, 0))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.embed(audio).float())


def split_variables(e2e_variables) -> Tuple[dict, dict]:
    """E2E variables (flax layout) -> (encoder_variables,
    classifier_variables): the encoder half feeds AudioFeatures and `.nww`
    bundling, the classifier half a standalone Model."""
    def _split(coll):
        enc, clf = {}, {}
        for key, sub in coll.items():
            if key == "encoder":
                enc.update(sub)
            elif key == "classifier":
                clf.update(sub)
            else:
                clf[key] = sub
        return enc, clf

    enc_out, clf_out = {}, {}
    for coll_name, coll in e2e_variables.items():
        enc, clf = _split(coll)
        if enc:
            enc_out[coll_name] = enc
        if clf:
            clf_out[coll_name] = clf
    return enc_out, clf_out


class AudioClipDataset:
    """Raw-audio training set: (path, label) per clip, ISBL hardness per
    clip, with AdaptiveLossAwareDataset's index-pool / hardness interface so
    DynamicClassAwareSampler works unchanged. `gather` decodes and fixes the
    length on the host; a clip longer than `clip_samples` is cropped at a
    random offset drawn from `_rng`, which the host loop checkpoints."""

    def __init__(self, audio_manifest: Dict[str, List[str]],
                 clip_samples: int = 32000, seed: int = 10):
        self.clip_samples = clip_samples
        self._rng = random.Random(seed)
        self.entries: List[Tuple[str, float]] = []
        self.index_pools: Dict[str, np.ndarray] = {}
        cursor = 0
        for category, dirs in audio_manifest.items():
            label = 1.0 if category == "targets" else 0.0
            if isinstance(dirs, dict):   # manifest style {key: dir}
                pairs = dirs.items()
            else:
                pairs = ((f"{category}_{i}", d) for i, d in enumerate(dirs))
            for key, d in pairs:
                paths = sorted(str(p) for p in pathlib.Path(d).rglob("*.wav"))
                if not paths:
                    continue
                self.entries.extend((p, label) for p in paths)
                self.index_pools[key] = np.arange(cursor,
                                                  cursor + len(paths),
                                                  dtype=np.int64)
                cursor += len(paths)
        self.total_samples = cursor
        self.sample_hardness = np.ones(cursor, np.float32)
        print_info(f"E2E audio dataset: {len(self.index_pools)} sources | "
                   f"{cursor} clips")

    def __len__(self):
        return self.total_samples

    def _fixed_length(self, data: np.ndarray) -> np.ndarray:
        n = len(data)
        out = np.zeros(self.clip_samples, np.float32)
        if n > self.clip_samples:
            start = self._rng.randint(0, n - self.clip_samples)
            out[:] = data[start:start + self.clip_samples]
        else:
            out[:n] = data
        return out

    def gather(self, indices):
        feats = np.zeros((len(indices), self.clip_samples), np.float32)
        labels = np.zeros(len(indices), np.float32)
        for j, idx in enumerate(indices):
            path, label = self.entries[int(idx)]
            data = load_audio(path)
            if data is not None:
                feats[j] = self._fixed_length(data)
            labels[j] = label
        return feats, labels, np.asarray(indices, np.int64)

    def update_hardness(self, indices, raw_bce, alpha=0.05, floor=0.05):
        old = self.sample_hardness[indices]
        new = alpha * raw_bce.astype(np.float32) + (1 - alpha) * old
        self.sample_hardness[indices] = np.maximum(new, floor)

    def reset_hardness(self, decay=0.5):
        self.sample_hardness *= decay
        self.sample_hardness += 1.0 - decay


def _initial_encoder(seed: int) -> nn.Module:
    """The bundled pretrained encoder (e2e training then fine-tunes or
    freezes a real speech embedding), or, with no asset, a conv4 encoder
    drawn with flax's initializers."""
    from nanowakeword_tpu_torch.data.features import \
        pretrained_encoder_variables
    try:
        pretrained = pretrained_encoder_variables()
    except FileNotFoundError:
        encoder = build_encoder("conv4")
        flax_init_(encoder, torch.Generator().manual_seed(seed))
        return encoder
    encoder = build_encoder(infer_encoder_arch(pretrained))
    encoder.load_state_dict(encoder_state_dict_from_flax(pretrained))
    return encoder


class E2EModel:
    """A Model-like handle over an EndToEndModule: what the Trainer needs
    (`module`, `device`, `history`, `train`/`eval`) and the flax-layout
    `variables` of the reference's handle.

    The classifier's module is shared: after training, `classifier_model`
    holds the trained classifier. The module takes clips of any length, so
    the reference's `clip_samples` argument has no counterpart."""

    def __init__(self, classifier_model: Model, context_frames: int = 16,
                 freeze_encoder: bool = False, seed: int = 10,
                 encoder_dtype: torch.dtype = torch.bfloat16):
        self.classifier_model = classifier_model
        self.history = classifier_model.history
        self.device = classifier_model.device
        self.module = EndToEndModule(
            _initial_encoder(seed), classifier_model.module,
            context_frames=context_frames, freeze_encoder=freeze_encoder,
            encoder_dtype=encoder_dtype).to(self.device)
        self.eval()

    def train(self) -> "E2EModel":
        self.module.train().requires_grad_(True)
        return self

    def eval(self) -> "E2EModel":
        self.module.eval().requires_grad_(False)
        return self

    @property
    def variables(self) -> dict:
        """The weights in the reference's flax layout: {"params":
        {"encoder", "classifier"}} and the classifier's "batch_stats"."""
        enc = flax_encoder_variables_from_state_dict(
            self.module.encoder.state_dict())
        clf = self.classifier_model.variables
        out = {"params": {"encoder": enc["params"],
                          "classifier": clf["params"]}}
        if "batch_stats" in clf:
            out["batch_stats"] = {"classifier": clf["batch_stats"]}
        return out

    def load_variables(self, variables) -> None:
        self.module.load_state_dict(e2e_state_dict_from_flax(variables, self),
                                    strict=True)

    def n_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    def export_components(self):
        """-> (the classifier Model with the trained weights, the trained
        encoder's flax variables)."""
        return self.classifier_model, flax_encoder_variables_from_state_dict(
            self.module.encoder.state_dict())
