"""Reader of the `.nww` model artifact.

The counterpart of `read_nww_header` and `load_nww` in
`nanowakeword_tpu/export/artifact.py`. An `.nww` file is the 4-byte magic
`NWW2`, a little-endian u32 header length, a JSON header that says how to
rebuild the model, and a flax msgpack payload with the classifier variables
and, optionally, the feature encoder's variables. Weights are stored as
float32, bfloat16, or int8 with per-output-channel scales; all load as
float32. Writing `.nww` files from torch is still to be ported.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from nanowakeword_tpu_torch.convert import (encoder_state_dict_from_flax,
                                            model_state_dict_from_flax)
from nanowakeword_tpu_torch.utils.flax_msgpack import msgpack_restore

MAGIC = b"NWW2"
EXTENSION = ".nww"
WEIGHTS_DTYPES = ("float32", "bfloat16", "int8")


def _read_header(f, path: str) -> dict:
    if f.read(4) != MAGIC:
        raise ValueError(f"'{path}' is not a .nww model artifact")
    (hlen,) = struct.unpack("<I", f.read(4))
    return json.loads(f.read(hlen).decode("utf-8"))


def read_nww_header(path: str) -> dict:
    with open(path, "rb") as f:
        return _read_header(f, path)


def _int8_dequantize_tree(stored, scales):
    """Per-channel int8 -> float32; leaves with an empty scale were stored
    unquantized."""
    if isinstance(stored, dict):
        return {k: _int8_dequantize_tree(v, scales[k])
                for k, v in stored.items()}
    x, s = np.asarray(stored), np.asarray(scales)
    return x.astype(np.float32) * s if s.size else x


def load_nww(path: str, device="cuda"):
    """-> (header, Model on `device` with the stored weights,
    encoder state_dict | None)."""
    from nanowakeword_tpu_torch.models.model import Model

    with open(path, "rb") as f:
        header = _read_header(f, path)
        payload = msgpack_restore(f.read())

    weights_dtype = header.get("weights_dtype", "float32")
    if weights_dtype not in WEIGHTS_DTYPES:
        raise ValueError(f"unknown weights_dtype {weights_dtype!r} in "
                         f"'{path}'")

    def restore(tree, scales):
        # bfloat16 leaves already decode to float32 (utils/flax_msgpack.py)
        if weights_dtype == "int8":
            return _int8_dequantize_tree(tree, scales)
        return tree

    build = header.get("build", {})
    model = Model(
        config=dict(header.get("arch_config", {})),
        model_name=header["model_name"],
        n_classes=int(header.get("n_classes", 1)),
        input_shape=tuple(header["input_shape"]),
        model_type=header["model_type"],
        layer_dim=int(build.get("layer_dim", 128)),
        n_blocks=int(build.get("n_blocks", 1)),
        dropout_prob=float(build.get("dropout_prob", 0.5)),
        device=device,
    )
    variables = restore(payload["variables"], payload.get("scales"))
    model.load_state_dict(model_state_dict_from_flax(variables, model))
    encoder = payload.get("encoder_variables")
    if encoder is not None:
        encoder = encoder_state_dict_from_flax(
            restore(encoder, payload.get("encoder_scales")))
    return header, model, encoder
