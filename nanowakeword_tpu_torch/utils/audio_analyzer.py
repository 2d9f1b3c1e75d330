"""Dataset statistics for the intelligent config engine.

A copy of `nanowakeword_tpu/utils/audio_analyzer.py` (numpy and `wave`):
`DatasetAnalyzer.analyze()` computes H_pos/H_neg/H_noise (hours of audio),
A_noise (average RMS of the noise set), and N_rir (impulse count) for the
ConfigGenerator. (Nothing in the pipeline calls it; it is provided for
standalone use.)
"""

from __future__ import annotations

import os
import wave
from typing import Dict, List, Optional

import numpy as np

from nanowakeword_tpu_torch.utils.logger import print_warning

_AUDIO_EXTS = {".wav"}


def _wav_stats(path: str):
    """-> (duration_seconds, rms_normalised) or None."""
    try:
        with wave.open(path, "rb") as f:
            sr, n, width = f.getframerate(), f.getnframes(), f.getsampwidth()
            # RMS from a bounded sample of frames to keep analysis fast
            take = min(n, sr * 30)
            raw = f.readframes(take)
        duration = n / sr if sr else 0.0
        if width == 2 and raw:
            data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
            rms = float(np.sqrt(np.mean(data * data)))
        else:
            rms = 0.0
        return duration, rms
    except Exception as e:  # noqa: BLE001
        print_warning(f"Could not analyze '{os.path.basename(path)}': {e}")
        return None


def _scan_dir(path: Optional[str]):
    """-> (total_hours, mean_rms) for every wav under path."""
    if not path or not os.path.isdir(path):
        return 0.0, 0.0
    seconds, rms_vals = 0.0, []
    for root, _, files in os.walk(path):
        for name in files:
            if os.path.splitext(name)[1].lower() in _AUDIO_EXTS:
                stats = _wav_stats(os.path.join(root, name))
                if stats:
                    seconds += stats[0]
                    rms_vals.append(stats[1])
    return seconds / 3600.0, float(np.mean(rms_vals)) if rms_vals else 0.0


class DatasetAnalyzer:
    def __init__(self, positive_path: Optional[str] = None,
                 negative_path: Optional[str] = None,
                 noise_path: Optional[List[str]] = None,
                 rir_path: Optional[str] = None):
        self.positive_path = positive_path
        self.negative_path = negative_path
        self.noise_paths = noise_path if isinstance(noise_path, list) \
            else ([noise_path] if noise_path else [])
        self.rir_path = rir_path

    def analyze(self) -> Dict:
        h_pos, _ = _scan_dir(self.positive_path)
        h_neg, _ = _scan_dir(self.negative_path)

        h_noise, noise_rms, per_path = 0.0, [], {}
        for p in self.noise_paths:
            h, rms = _scan_dir(p)
            h_noise += h
            per_path[p] = h
            if rms > 0:
                noise_rms.append(rms)

        n_rir = 0
        if self.rir_path and os.path.isdir(self.rir_path):
            n_rir = sum(1 for f in os.listdir(self.rir_path)
                        if os.path.splitext(f)[1].lower() in _AUDIO_EXTS)

        return {
            "H_pos": h_pos,
            "H_neg": h_neg,
            "H_noise": h_noise,
            "H_noise_paths": per_path,
            "A_noise": float(np.mean(noise_rms)) if noise_rms else 0.0,
            "N_rir": n_rir,
        }
