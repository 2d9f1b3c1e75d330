"""The pretrained speech-encoder assets, read from the JAX package's folder.

The assets are flax msgpack files that ship in `nanowakeword_tpu/assets/`.
They are found here by file path, not by importing `nanowakeword_tpu`
(whose import pulls in jax), and are not copied.
"""

import os

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "nanowakeword_tpu", "assets")

SPEECH_ENCODER_V1 = os.path.join(_DIR, "speech_encoder_v1.msgpack")
SPEECH_ENCODER_V2 = os.path.join(_DIR, "speech_encoder_v2.msgpack")
SPEECH_ENCODER_V3 = os.path.join(_DIR, "speech_encoder_v3.msgpack")
SPEECH_ENCODER_V4 = os.path.join(_DIR, "speech_encoder_v4.msgpack")


def speech_encoder_asset_path() -> str:
    """Path to the newest bundled pretrained encoder.

    Raises FileNotFoundError when none is present: the JAX package's
    seed-10 random initialisation cannot be reproduced in torch, so there
    is no fallback encoder.
    """
    for path in (SPEECH_ENCODER_V4, SPEECH_ENCODER_V3, SPEECH_ENCODER_V2,
                 SPEECH_ENCODER_V1):
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no speech-encoder asset in {_DIR}")
