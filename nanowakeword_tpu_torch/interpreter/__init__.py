"""Inference runtime package. Re-exports the interpreter, the VAD and the
security API, as `nanowakeword_tpu/interpreter/__init__.py` does."""

from nanowakeword_tpu_torch.interpreter.nanointerpreter import (  # noqa: F401
    DetectionResult, NanoInterpreter)
from nanowakeword_tpu_torch.interpreter.server_security import (  # noqa: F401
    SecurityConfig, SecurityManager, build_security)
from nanowakeword_tpu_torch.interpreter.vad import VAD  # noqa: F401

__all__ = ["NanoInterpreter", "DetectionResult", "VAD", "SecurityConfig",
           "SecurityManager", "build_security"]
