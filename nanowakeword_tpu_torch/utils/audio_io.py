"""Audio file IO and directory preprocessing — dependency-light.

A copy of `nanowakeword_tpu/utils/audio_io.py`: 16-bit PCM WAVs decode
through the native runtime (runtime.py, `csrc/nww_runtime.cc`), other
widths through the stdlib `wave` module and numpy.

Parity target: the upstream `nanowakeword/utils/audio_preprocess.py` —
`verify_and_process_directory` converts every audio file in a directory to
16 kHz mono 16-bit PCM WAV in place (temp-file swap), and `needs_conversion`
probes formats. The reference uses torchaudio; we use the stdlib `wave`
module + scipy for resampling, gating non-WAV codecs on soundfile when
present.
"""

from __future__ import annotations

import os
import tempfile
import wave
from typing import Optional

import numpy as np

from nanowakeword_tpu_torch import runtime
from nanowakeword_tpu_torch.utils.logger import print_info, print_warning

TARGET_SR = 16000
AUDIO_EXTENSIONS = {".wav", ".mp3", ".flac", ".m4a", ".ogg"}
# the 16-bit PCM decoder of read_wav: None is the native
# runtime.decode_wav_bytes; runtime.plain_decode_wav_bytes, its numpy twin,
# is set here to measure or test one against the other
WAV_DECODER = None


def read_wav(path: str):
    """-> (int16-scale float32 mono samples, sample_rate). Handles 8/16/32-bit
    PCM WAV.

    16-bit PCM decodes with WAV_DECODER: the channels' integer sum divided
    by their count, truncated toward zero. Other widths take the stdlib
    path below.
    """
    with wave.open(path, "rb") as probe:
        is_pcm16 = probe.getsampwidth() == 2
    if is_pcm16:
        with open(path, "rb") as f:
            data, sr = (WAV_DECODER or runtime.decode_wav_bytes)(f.read())
        return data.astype(np.float32), sr
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        channels = f.getnchannels()
        raw = f.readframes(n)
    if width == 4:
        data = (np.frombuffer(raw, dtype=np.int32).astype(np.float32)
                / 65536.0)
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) * 256.0
    else:
        raise ValueError(f"Unsupported WAV sample width {width} in {path}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data.astype(np.float32), sr


def write_wav(path: str, samples: np.ndarray, sr: int = TARGET_SR):
    """Write int16-scale float or int16 samples as 16-bit mono PCM WAV."""
    pcm = np.clip(np.asarray(samples), -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def resample(samples: np.ndarray, orig_sr: int,
             target_sr: int = TARGET_SR) -> np.ndarray:
    if orig_sr == target_sr:
        return samples
    from scipy.signal import resample_poly
    from math import gcd
    g = gcd(orig_sr, target_sr)
    return resample_poly(samples, target_sr // g, orig_sr // g).astype(
        np.float32)


def load_audio(path: str, target_sr: int = TARGET_SR) -> Optional[np.ndarray]:
    """Load any supported audio file -> int16-scale float32 mono at 16 kHz.
    Returns None on failure (skip-and-continue, augment_clips.py:42-43)."""
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext == ".wav":
            data, sr = read_wav(path)
        else:
            try:
                import soundfile as sf
            except ImportError:
                print_warning(f"Cannot decode '{ext}' without soundfile; "
                              f"skipping {path}")
                return None
            arr, sr = sf.read(path, dtype="float32", always_2d=True)
            data = arr.mean(axis=1) * 32767.0
        return resample(data, sr, target_sr)
    except Exception as e:  # noqa: BLE001
        print_warning(f"Failed to load audio '{path}': {e}")
        return None


def needs_conversion(path: str) -> bool:
    """True if the file is not already 16 kHz mono 16-bit PCM WAV
    (audio_preprocess.py:34-57)."""
    if os.path.splitext(path)[1].lower() != ".wav":
        return True
    try:
        with wave.open(path, "rb") as f:
            return not (f.getframerate() == TARGET_SR
                        and f.getnchannels() == 1
                        and f.getsampwidth() == 2)
    except Exception:  # noqa: BLE001
        return True


def process_and_convert_audio(path: str) -> bool:
    """Convert one file in place to the target format via temp-file swap
    (audio_preprocess.py:60-93)."""
    data = load_audio(path)
    if data is None:
        return False
    target = os.path.splitext(path)[0] + ".wav"
    fd, tmp = tempfile.mkstemp(suffix=".wav",
                               dir=os.path.dirname(path) or ".")
    os.close(fd)
    try:
        write_wav(tmp, data)
        os.replace(tmp, target)
        if target != path and os.path.exists(path):
            os.remove(path)
        return True
    except Exception as e:  # noqa: BLE001
        print_warning(f"Conversion failed for '{path}': {e}")
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def verify_and_process_directory(directory: str) -> int:
    """Ensure every audio file in `directory` is 16 kHz/mono/16-bit WAV
    (audio_preprocess.py:96-112). Returns the number of files converted."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(directory)
    converted = 0
    for entry in sorted(os.listdir(directory)):
        path = os.path.join(directory, entry)
        if not os.path.isfile(path):
            continue
        if os.path.splitext(entry)[1].lower() not in AUDIO_EXTENSIONS:
            continue
        if needs_conversion(path):
            if process_and_convert_audio(path):
                converted += 1
    if converted:
        print_info(f"Converted {converted} file(s) in '{directory}' to "
                   "16 kHz mono 16-bit WAV.")
    return converted
