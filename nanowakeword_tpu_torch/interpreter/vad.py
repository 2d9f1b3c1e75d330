"""Voice activity detection, in numpy.

A copy of `nanowakeword_tpu/interpreter/vad.py` (the port imports nothing of
the JAX package): a `VAD` class with `predict(chunk) -> prob`, `__call__`,
and a 125-deep `prediction_buffer` whose recent frames the interpreter gates
on.

A self-contained detector (no network, no ONNX runtime): an adaptive
noise-floor SNR estimate fused with a spectral-band energy ratio. Speech
concentrates energy in 300-3400 Hz while broadband noise does not. Stateful
across chunks.
"""

from __future__ import annotations

from collections import deque

import numpy as np

_FRAME = 320          # 20 ms sub-frames inside each chunk
_SPEECH_LO = 300.0    # Hz
_SPEECH_HI = 3400.0   # Hz


class VAD:
    def __init__(self, sample_rate: int = 16000, sensitivity: float = 1.0):
        self.sample_rate = sample_rate
        self.sensitivity = sensitivity
        self.prediction_buffer: deque = deque(maxlen=125)
        self._noise_floor = None   # EMA of minimum frame energy
        self._freqs = np.fft.rfftfreq(_FRAME, 1.0 / sample_rate)
        self._speech_band = ((self._freqs >= _SPEECH_LO)
                             & (self._freqs <= _SPEECH_HI))
        self._window = np.hanning(_FRAME).astype(np.float32)

    def reset(self):
        self.prediction_buffer.clear()
        self._noise_floor = None

    def _frame_probs(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32).reshape(-1) / 32768.0
        n_frames = len(x) // _FRAME
        if n_frames == 0:
            return np.zeros(0, np.float32)
        frames = x[:n_frames * _FRAME].reshape(n_frames, _FRAME) * self._window

        energy = (frames ** 2).mean(axis=1) + 1e-10
        spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2
        band_spec = spec[:, self._speech_band] + 1e-12
        band_ratio = band_spec.sum(axis=1) / (spec.sum(axis=1) + 1e-12)
        # spectral flatness inside the speech band: voiced speech is peaky
        # (formants; flatness ~0.001-0.1) while broadband transients — door
        # slams, decaying bursts — are flat (~0.6). A gentle penalty above
        # 0.5 rejects bursts without punishing fricative frames
        # (benchmarked in tests/test_vad.py).
        flatness = (np.exp(np.mean(np.log(band_spec), axis=1))
                    / band_spec.mean(axis=1))
        flat_penalty = 1.0 - np.clip((flatness - 0.5) * 1.5, 0.0, 0.5)

        # adaptive noise floor: fast decay down, slow rise up. The floor is
        # a data-dependent recurrence (asymmetric attack/release EMA), so
        # only IT runs as a scalar loop; the per-frame transcendentals
        # (log10/sigmoid) are vectorized over the whole chunk.
        floors = np.empty(n_frames, np.float32)
        floor = self._noise_floor
        for i in range(n_frames):
            e = energy[i]
            if floor is None:
                floor = e
            elif e < floor:
                floor = 0.6 * floor + 0.4 * e
            else:
                floor = 0.995 * floor + 0.005 * e
            floors[i] = floor
        self._noise_floor = floor

        snr_db = 10.0 * np.log10(energy / np.maximum(floors, 1e-10))
        # speech ≈ SNR >> 0 dB AND band-concentrated spectrum
        snr_score = 1.0 / (1.0 + np.exp(-(snr_db - 6.0)
                                        * 0.5 * self.sensitivity))
        return (snr_score * np.clip(band_ratio * 1.6, 0.0, 1.0)
                * flat_penalty).astype(np.float32)

    def predict(self, x: np.ndarray) -> float:
        """Average speech probability of a chunk; appended per-chunk to the
        prediction buffer."""
        probs = self._frame_probs(x)
        score = float(probs.mean()) if probs.size else 0.0
        self.prediction_buffer.append(score)
        return score

    def __call__(self, x: np.ndarray) -> float:
        return self.predict(x)
