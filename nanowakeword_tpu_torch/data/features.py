"""AudioFeatures: audio -> mel -> 96-dim embeddings, batch and streaming.

The counterpart of `nanowakeword_tpu/data/features.py` on one torch device.
The batch path (`embed_clips`) and the streaming path (`__call__`, one step
per 1280-sample chunk over a fixed-shape state: mel ring, feature ring and
320-sample tail) give the same embeddings once the 76-frame window is filled
with real audio.

Both paths take their bf16-mode mel from `ops/mel_cuda.mel_frontend_fused`:
the hand-written kernel for a CUDA device, its plain version on the CPU. The
streaming step runs it on the 320-sample tail plus the new chunk and keeps
the last 8 frames, which is `mel_streaming_step` computed the way the batch
path computes it; so on the card, streaming equals batch exactly, as it does
in the reference. Other compute dtypes use ops/mel.py directly.

The streaming state lives in three buffers that are allocated once and
written in place (`stream_step_`, `reset`), so a CUDA graph captured over a
step keeps reading and writing the memory that `feature_buffer` and
`get_features` read: the counterpart of the reference's donated state.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from nanowakeword_tpu_torch.convert import encoder_state_dict_from_flax
from nanowakeword_tpu_torch.models.embedding import (EMB_STRIDE, EMB_WINDOW,
                                                     EMBEDDING_DIM,
                                                     encoder_from_state_dict)
from nanowakeword_tpu_torch.ops import mel as melops
from nanowakeword_tpu_torch.ops.mel_cuda import mel_frontend_fused
from nanowakeword_tpu_torch.runtime import Chunker

MEL_BUFFER_FRAMES = 970      # ~10 s of mel history
FEATURE_BUFFER_FRAMES = 120  # ~10 s of embeddings
CHUNK = melops.CHUNK         # 1280 samples / 80 ms

# Streaming emits one embedding per chunk from the newest 76 mel frames;
# those windows end at multiples of 8, i.e. start at offset 4 (mod 8). The
# batch path drops the first EMB_OFFSET mel frames so its stride-8 windows
# land on the same grid (2 s -> 16 frames, 4 s -> 41 frames).
EMB_OFFSET = 4
# mel frames of the 320-sample tail in a streaming step's 1600-sample buffer
_TAIL_FRAMES = melops.LEFT_PAD // melops.HOP


def batch_embedding_frames(n_mel: int) -> int:
    if n_mel < EMB_OFFSET + EMB_WINDOW:
        return 0
    return (n_mel - EMB_OFFSET - EMB_WINDOW) // EMB_STRIDE + 1


class StreamState(NamedTuple):
    """Fixed-shape streaming state, on the device."""
    tail: torch.Tensor       # [320] last raw samples (mel left context)
    mel_buf: torch.Tensor    # [970, 32] mel ring (newest at the end)
    feat_buf: torch.Tensor   # [120, 96] embedding ring (newest at the end)


@functools.lru_cache(maxsize=1)
def pretrained_encoder_variables():
    """The bundled pretrained encoder's flax variables, as numpy arrays.

    Raises FileNotFoundError when no asset is bundled (assets/__init__.py).
    """
    from nanowakeword_tpu_torch.assets import speech_encoder_asset_path
    from nanowakeword_tpu_torch.utils.flax_msgpack import read_msgpack_file
    return read_msgpack_file(speech_encoder_asset_path())


def default_encoder_variables():
    """The frontend's default encoder weights: the pretrained asset. (The
    JAX package falls back to a seeded random init, which torch cannot
    reproduce, so the port has no fallback.)"""
    return pretrained_encoder_variables()


class AudioFeatures:
    """Feature frontend with the reference's call surface, on `device`.

    `encoder_state_dict` is the encoder's weights in the port's layout (as
    `load_nww` returns them); by default the bundled pretrained encoder.
    `encoder` is an encoder module already on `device` to use as it is:
    many frontends (a server's connections) share one copy of the weights.
    """

    def __init__(self,
                 encoder_state_dict=None,
                 encoder: torch.nn.Module = None,
                 sr: int = 16000,
                 ncpu: int = 1,
                 inference_framework: str = "torch",
                 device="cuda",
                 compute_dtype=torch.bfloat16,
                 debug_mode: bool = False,
                 debug_limit: int = 10):
        # ncpu, inference_framework and the debug flags are accepted for the
        # reference's call surface and unused
        del ncpu, inference_framework, debug_mode, debug_limit
        self.sr = sr
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        if encoder is None:
            if encoder_state_dict is None:
                encoder_state_dict = encoder_state_dict_from_flax(
                    default_encoder_variables())
            encoder = encoder_from_state_dict(encoder_state_dict,
                                              self.device)
        self.encoder = encoder
        self._chunker = Chunker(CHUNK)
        dev = self.device
        self.state = StreamState(
            tail=torch.empty(melops.LEFT_PAD, device=dev),
            mel_buf=torch.empty(MEL_BUFFER_FRAMES, melops.N_MELS, device=dev),
            feat_buf=torch.empty(FEATURE_BUFFER_FRAMES, EMBEDDING_DIM,
                                 device=dev),
        )
        self.reset()

    # -- pure compute ---------------------------------------------------------

    def _mel(self, audio: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.bfloat16:
            return mel_frontend_fused(audio)
        return melops.mel_frontend(audio, compute_dtype=self.compute_dtype)

    def _embed_impl(self, audio: torch.Tensor) -> torch.Tensor:
        """[N, samples] audio -> [N, frames, 96]; one pass, no windows."""
        return self.encoder(self._mel(audio)[:, EMB_OFFSET:])

    def _stream_step_impl(self, state: StreamState,
                          chunk: torch.Tensor) -> StreamState:
        """1280 new samples -> 8 new mel frames -> 1 new embedding frame."""
        buf = torch.cat([state.tail, chunk.float()])          # [1600]
        new_mel = self._mel(buf)[_TAIL_FRAMES:]               # [8, 32]
        mel_buf = torch.cat([state.mel_buf[melops.FRAMES_PER_CHUNK:],
                             new_mel])
        emb = self.encoder(mel_buf[None, -EMB_WINDOW:])[0]    # [1, 96]
        feat_buf = torch.cat([state.feat_buf[1:], emb])
        return StreamState(tail=buf[-melops.LEFT_PAD:], mel_buf=mel_buf,
                           feat_buf=feat_buf)

    def stream_step_(self, chunk: torch.Tensor) -> None:
        """One streaming step on `self.state`, written in place. The new
        values are whole tensors before they are copied in, so no copy
        reads what it overwrites."""
        new = self._stream_step_impl(self.state, chunk)
        for dst, src in zip(self.state, new):
            dst.copy_(src)

    # -- lifecycle -------------------------------------------------------------

    def reset(self):
        """Reset the streaming buffers: the mel ring starts as ones, the
        feature ring as zeros, the tail as 320 zero samples."""
        self.accumulated_samples = 0
        self._chunker.reset()
        self._frames_seen = 0  # embedding frames emitted since reset
        self.state.tail.zero_()
        self.state.mel_buf.fill_(1.0)
        self.state.feat_buf.zero_()

    # -- batch path -------------------------------------------------------------

    @torch.no_grad()
    def embed_clips(self, x, batch_size: int = 128,
                    ncpu: int = 1) -> np.ndarray:
        """[N, samples] int16/float audio -> [N, frames, 96] float32.
        batch_size bounds the device memory of one call. `x` may be a numpy
        array or a torch tensor (a tensor already on the device is used
        where it lies)."""
        del ncpu
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        if x.ndim == 1:
            x = x[None]
        # int16 PCM goes to the device unconverted: half the bytes, and the
        # kernel converts in registers (int16 -> f32 is exact)
        in_dtype = torch.int16 if x.dtype == torch.int16 else torch.float32
        outs = []
        for i in range(0, x.shape[0], batch_size):
            audio = x[i:i + batch_size].to(self.device, in_dtype).contiguous()
            outs.append(self._embed_impl(audio).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def _get_melspectrogram(self, x) -> np.ndarray:
        """Whole-clip log-mel of [samples] or [N, samples] audio, in the
        frontend's compute dtype, as float32 numpy."""
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        with torch.no_grad():
            return self._mel(x).float().cpu().numpy()

    def _get_embeddings(self, x, **kwargs) -> np.ndarray:
        """Whole-clip embeddings [frames, 96] of one clip."""
        return self.embed_clips(np.asarray(x, np.float32)[None], **kwargs)[0]

    def load_encoder_params(self, variables) -> None:
        """Rebuild the encoder from a flax variables tree (any of the three
        architectures), on this frontend's device."""
        self.encoder = encoder_from_state_dict(
            encoder_state_dict_from_flax(variables), self.device)

    def get_embedding_shape(self, audio_length: float, sr: int = 16000):
        """Embedding shape of a clip of `audio_length` seconds."""
        n = int(audio_length * sr)
        return (batch_embedding_frames(melops.n_mel_frames(n)),
                EMBEDDING_DIM)

    # -- streaming path ----------------------------------------------------------

    @torch.no_grad()
    def _streaming_features(self, x) -> int:
        """Accumulate raw audio; process it in whole 1280-sample chunks.

        Returns the number of samples processed by this call (or the number
        accumulated so far if < 1280).
        """
        chunks = self._chunker.feed(np.asarray(x, np.float32).reshape(-1))
        if chunks.shape[0] == 0:
            self.accumulated_samples = self._chunker.pending
            return self.accumulated_samples
        for chunk in chunks:
            self.stream_step_(torch.from_numpy(chunk).to(self.device))
        self._frames_seen += chunks.shape[0]
        self.accumulated_samples = self._chunker.pending
        return chunks.shape[0] * CHUNK

    def __call__(self, x) -> int:
        return self._streaming_features(x)

    @property
    def feature_buffer(self) -> np.ndarray:
        """The embeddings emitted since reset (at most 120), newest last."""
        buf = self.state.feat_buf.cpu().numpy()
        n = min(self._frames_seen, FEATURE_BUFFER_FRAMES)
        return buf[FEATURE_BUFFER_FRAMES - n:]

    def get_features(self, n_feature_frames: int = 16,
                     start_ndx: int = -1) -> np.ndarray:
        """[1, n, 96] slice of the feature buffer."""
        buf = self.state.feat_buf.cpu().numpy()
        n = int(n_feature_frames)
        if start_ndx != -1:
            end = start_ndx + n if start_ndx + n != 0 else FEATURE_BUFFER_FRAMES
            return buf[start_ndx:end][None].astype(np.float32)
        return buf[-n:][None].astype(np.float32)
