"""The reference's answers for the two entries the benchmark drives.

`bulk_scores`: clips -> log-mel -> (the first 4 frames dropped, so the
stride-8 windows fall on the stream's grid) -> encoder -> one classifier ->
a probability per clip.

`stream_scores`: what `predict` serves for every 80 ms chunk of a clip
streamed from a reset, worked out again from the clip alone. After chunk k
the stream has seen mel frames 0 .. 8k+7 of the clip (320 zero samples of
left context, so a chunk's frames are the whole clip's frames); its mel
ring starts as ones, so the encoder's window for chunk k is frames
8k+8-76 .. 8k+7 with ones before the clip, one embedding per chunk; its
embedding ring starts as zeros, so a model of window 16 reads embeddings
k-15 .. k with zeros before the clip. The interpreter then serves 0 for a
model until 16 embeddings exist and for its first 5 predictions, and, in
a cascade, 0 for the verifier where the gate served less than its
threshold.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import mel as refmel
from port_bench.reference import models as refmodels

EMB_OFFSET = 4          # mel frames the batch path drops
EMB_WINDOW = 76         # mel frames per embedding
EMB_STRIDE = 8          # mel frames per chunk and per embedding
FIRST_SERVED = 5        # predictions zeroed after a reset


def bulk_scores(clips: torch.Tensor, encoder_vars, model, prec,
                block: int = 1024) -> np.ndarray:
    """[N, n] int16 clips (on the device the reference runs on) -> [N]
    probabilities. `model` is (variables, model_type)."""
    variables, model_type = model
    out = []
    for i in range(0, clips.shape[0], block):
        mel = refmel.log_mel(clips[i:i + block])[:, EMB_OFFSET:]
        feats = refmodels.encoder(mel, encoder_vars, prec)
        out.append(refmodels.classifier(feats, variables, model_type,
                                        prec).double().cpu().numpy())
    return np.concatenate(out)


def stream_raw(clips: torch.Tensor, encoder_vars, models, prec,
               window: int = 16) -> np.ndarray:
    """[N, n] int16 clips, n a multiple of 1280 (shorter clips padded at the
    end, which changes no chunk before the padding) -> [N, n // 1280,
    len(models)] raw probabilities: every model's score after every chunk."""
    n_chunks = clips.shape[1] // refmel.CHUNK
    mel = refmel.log_mel(clips)                       # [N, 8K, 32]
    ones = mel.new_ones(mel.shape[0], EMB_WINDOW - EMB_STRIDE, mel.shape[2])
    emb = refmodels.encoder(torch.cat([ones, mel], 1), encoder_vars, prec)
    zeros = emb.new_zeros(emb.shape[0], window - 1, emb.shape[2])
    ext = torch.cat([zeros, emb], 1)                  # [N, K + 15, 96]
    windows = ext.unfold(1, window, 1).transpose(2, 3)  # [N, K, 16, 96]
    flat = windows.reshape(-1, window, emb.shape[2])
    cols = [refmodels.classifier(flat, variables, model_type, prec)
            .reshape(-1, n_chunks) for variables, model_type in models]
    return torch.stack(cols, -1).double().cpu().numpy()


def served(raw: np.ndarray, windows, cascade=None):
    """What `predict` returns for each chunk of one clip streamed from a
    reset: [K, M] raw probabilities -> ([K, M] served scores, [K] bool:
    the gate's reference score lies within `cascade[3]` of its threshold,
    so either gating is sound). `cascade` is (gate column, verifier column,
    threshold, margin) or None."""
    k = np.arange(raw.shape[0])[:, None]
    ready = (k + 1 >= np.asarray(windows)[None]) & (k >= FIRST_SERVED)
    out = np.where(ready, raw, 0.0)
    near = np.zeros(raw.shape[0], bool)
    if cascade is not None:
        gate, verifier, threshold, margin = cascade
        out[out[:, gate] < threshold, verifier] = 0.0
        near = ready[:, gate] & (np.abs(raw[:, gate] - threshold) <= margin)
    return out, near
