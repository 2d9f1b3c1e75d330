"""nanowakeword_tpu_torch: the PyTorch / CUDA port of nanowakeword_tpu.

The serving path on one torch device (default "cuda"): int16 PCM -> log-mel
(a hand-written CUDA kernel on the card) -> speech encoder -> classifier ->
sigmoid, in batch (`AudioFeatures.embed_clips`) and streaming
(`NanoInterpreter.predict`) form, locally or behind the remote-verifier
server (`interpreter/remote_verifier.py`, `cli.py`); and the training path
(`trainer.py`). The JAX package `nanowakeword_tpu` is the reference that
every part is tested against; this package never imports it.
"""

from pathlib import Path as _Path

from nanowakeword_tpu_torch.data.features import AudioFeatures
from nanowakeword_tpu_torch.interpreter.nanointerpreter import (
    DetectionResult, NanoInterpreter)
from nanowakeword_tpu_torch.interpreter.vad import VAD

__version__ = "0.6.0"      # the JAX package's version

__all__ = ["NanoInterpreter", "DetectionResult", "VAD", "AudioFeatures"]

# the package's own directory, as the JAX package's PROJECT_ROOT is its own
PROJECT_ROOT = _Path(__file__).resolve().parent
