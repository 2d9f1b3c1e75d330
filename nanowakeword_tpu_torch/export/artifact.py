"""Reader and writer of the `.nww` model artifact, and the ONNX export step.

The counterpart of `save_nww`, `export_model`, `export_params_msgpack`,
`export_onnx_model`, `read_nww_header` and `load_nww` in
`nanowakeword_tpu/export/artifact.py`.
An `.nww` file is the 4-byte magic `NWW2`, a little-endian u32 header
length, a JSON header that says how to rebuild the model, and a flax
msgpack payload with the
classifier variables (in the reference's flax layout) and, optionally, the
feature encoder's variables. Weights are stored as float32, bfloat16, or
int8 with per-output-channel scales; all load as float32. The JAX
package's `load_nww` reads what this writer writes, and the other way.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional

import numpy as np
import torch

from nanowakeword_tpu_torch.convert import (encoder_state_dict_from_flax,
                                            model_state_dict_from_flax)
from nanowakeword_tpu_torch.utils.flax_msgpack import (Bfloat16Bits,
                                                       msgpack_dump,
                                                       msgpack_load)
from nanowakeword_tpu_torch.utils.logger import print_error, print_info

MAGIC = b"NWW2"
FORMAT_VERSION = 2
EXTENSION = ".nww"
WEIGHTS_DTYPES = ("float32", "bfloat16", "int8")

# arch config keys that must survive into the artifact so the module can be
# rebuilt at load time (the reference's list)
ARCH_CONFIG_KEYS = [
    "activation_function", "embedding_dim",
    "transformer_d_model", "transformer_n_head",
    "conformer_d_model", "conformer_n_head",
    "branchformer_d_model", "branchformer_n_head",
    "crnn_cnn_channels", "crnn_rnn_type",
    "tcn_channels", "tcn_kernel_size",
    "quartznet_config", "custom_model_config",
    "granite_d_model", "granite_layer_types", "granite_intermediate_size",
    "granite_mamba_d_state", "granite_mamba_d_conv", "granite_mamba_expand",
    "granite_mamba_n_heads", "granite_mamba_d_head",
    "granite_mamba_n_groups", "granite_mamba_chunk_size",
    "granite_attention_heads", "granite_kv_heads",
    "granite_attention_multiplier", "granite_residual_multiplier",
    "granite_embedding_multiplier", "granite_rms_norm_eps",
]
# marks a leaf stored unquantized inside an int8 artifact
_NO_SCALE = np.zeros((0,), np.float32)


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


def check_weights_dtype(cfg) -> None:
    """Reject a bad `weights_dtype` entry of a config section (for example
    `distillation`) before any training runs."""
    wd = cfg.get("weights_dtype")
    if wd is not None and wd not in WEIGHTS_DTYPES:
        raise ValueError("distillation.weights_dtype must be one of "
                         f"{WEIGHTS_DTYPES}, got {wd!r}")


def _read_nww(path: str):
    """-> (header, classifier variables, encoder variables | None), both
    trees in the flax layout as float32 numpy arrays."""
    with open(path, "rb") as f:
        header = _read_header(f, path)
        payload = msgpack_load(f)

    weights_dtype = header.get("weights_dtype", "float32")
    if weights_dtype not in WEIGHTS_DTYPES:
        raise ValueError(f"unknown weights_dtype {weights_dtype!r} in "
                         f"'{path}'")

    def restore(tree, scales):
        # bfloat16 leaves already decode to float32 (utils/flax_msgpack.py)
        if weights_dtype == "int8":
            return _int8_dequantize_tree(tree, scales)
        return tree

    variables = restore(payload["variables"], payload.get("scales"))
    encoder = payload.get("encoder_variables")
    if encoder is not None:
        encoder = restore(encoder, payload.get("encoder_scales"))
    return header, variables, encoder


def read_nww_payload(path: str):
    """-> (classifier variables, encoder variables | None) of an artifact,
    in the flax layout, as `save_nww` takes them."""
    return _read_nww(path)[1:]


def load_nww(path: str, device="cuda"):
    """-> (header, Model on `device` with the stored weights,
    encoder state_dict | None)."""
    from nanowakeword_tpu_torch.models.model import Model

    header, variables, encoder = _read_nww(path)
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
        seed=None, device=device,
    )
    model.load_state_dict(model_state_dict_from_flax(variables, model))
    if encoder is not None:
        encoder = encoder_state_dict_from_flax(encoder)
    return header, model, encoder


# -- writer ----------------------------------------------------------------------


def int8_quantize(x, axis: int = -1):
    """Symmetric per-channel int8 along `axis` (the output-channel axis of a
    flax kernel) -> (int8 array, 1-D scales), or (x, the no-scale marker)
    for leaves that stay unquantized (non-f32, < 2-D, < 64 values)."""
    x = np.asarray(x)
    if x.dtype != np.float32 or x.ndim < 2 or x.size < 64:
        return x, _NO_SCALE
    ax = axis % x.ndim
    red = tuple(i for i in range(x.ndim) if i != ax)
    amax = np.max(np.abs(x), axis=red, keepdims=True)
    scale = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale.reshape(-1)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_bf16(x):
    x = np.asarray(x)
    if x.dtype != np.float32:
        return x
    bits = torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)
    return Bfloat16Bits(bits.view(torch.int16).numpy().view(np.uint16))


def _cast_tree(tree, weights_dtype):
    """-> (stored tree, scales tree or None) for the storage dtype."""
    if weights_dtype == "int8":
        pairs = _map_tree(int8_quantize, tree)
        return _pick(pairs, 0), _pick(pairs, 1)
    if weights_dtype == "bfloat16":
        return _map_tree(_to_bf16, tree), None
    return _map_tree(np.asarray, tree), None


def _pick(pairs, i):
    """Element i of every (stored, scale) leaf pair of a tree."""
    if isinstance(pairs, dict):
        return {k: _pick(v, i) for k, v in pairs.items()}
    return pairs[i]


def save_nww(path: str, *, model, config, model_name: str,
             encoder_variables=None, extra_meta: Optional[dict] = None,
             weights_dtype: Optional[str] = None) -> str:
    """Serialize a Model (+ optional frontend encoder variables, in the
    flax layout) to one `.nww` file. weights_dtype "bfloat16" halves it;
    "int8" stores each >= 2-D float kernel as per-output-channel int8."""
    if weights_dtype is not None and weights_dtype not in WEIGHTS_DTYPES:
        raise ValueError(f"weights_dtype must be one of {WEIGHTS_DTYPES}, "
                         f"got {weights_dtype!r}")
    arch_config = {}
    # the model's own config wins; the passed config fills gaps
    sources = [getattr(model, "config", None), config]
    for key in ARCH_CONFIG_KEYS:
        val = None
        for src in sources:
            if src is not None and src.get(key, None) is not None:
                val = src.get(key)
                break
        if val is None:
            continue
        if hasattr(val, "to_dict"):
            val = val.to_dict()
        arch_config[key] = val
    arch_config["embedding_dim"] = model.embedding_dim

    header = {
        "format_version": FORMAT_VERSION,
        "model_name": model_name,
        "model_type": model.model_type,
        "input_shape": list(model.input_shape),
        "n_classes": model.n_classes,
        "embedding_dim": model.embedding_dim,
        "stateful": bool(model.stateful),
        "layer_dim": int(getattr(model, "layer_dim", 0)) or None,
        "arch_config": arch_config,
        "n_params": model.n_params(),
        "has_encoder": encoder_variables is not None,
        "build": {k: model._build_args[k]
                  for k in ("layer_dim", "n_blocks", "dropout_prob")},
    }
    if extra_meta:
        header["meta"] = extra_meta
    header["weights_dtype"] = weights_dtype or "float32"

    stored, scales = _cast_tree(model.variables, weights_dtype)
    payload = {"variables": stored}
    if scales is not None:
        payload["scales"] = scales
    if encoder_variables is not None:
        stored_enc, enc_scales = _cast_tree(encoder_variables, weights_dtype)
        payload["encoder_variables"] = stored_enc
        if enc_scales is not None:
            payload["encoder_scales"] = enc_scales
    header_bytes = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(header_bytes)))
        f.write(header_bytes)
        msgpack_dump(payload, f)
    print_info(f"Saved model artifact to '{path}' "
               f"({os.path.getsize(path) / 1024:.1f} KB)")
    return path


def export_model(model, input_shape, config, model_name: str,
                 output_dir: str, encoder_variables=None,
                 weights_dtype: Optional[str] = None) -> str:
    """The pipeline's export step: `<output_dir>/<model_name>.nww`."""
    del input_shape
    path = os.path.join(output_dir, model_name + EXTENSION)
    return save_nww(path, model=model, config=config, model_name=model_name,
                    encoder_variables=encoder_variables,
                    weights_dtype=weights_dtype)


def export_params_msgpack(model, model_name: str, output_dir: str) -> str:
    """The raw parameters as flax msgpack, `<output_dir>/<model_name>
    .msgpack`: the reference's raw-parameters export, in the flax layout
    the JAX package reads."""
    path = os.path.join(output_dir, model_name + ".msgpack")
    print_info(f"Saving raw parameters to '{path}'")
    with open(path, "wb") as f:
        msgpack_dump(model.variables, f)
    return path


def export_onnx_model(model, input_shape, config, model_name: str,
                      output_dir: str,
                      weights_dtype: Optional[str] = None) -> Optional[str]:
    """The ONNX interchange export, `<output_dir>/<model_name>.onnx`
    (export/onnx_export.py) -> its path, or None with a logged message
    where a model does not export (a family beyond SUPPORTED_TYPES, or a
    `custom` module with an op that has no lowering). int8 is the only quantized ONNX form: any other
    `weights_dtype` (bfloat16 is `.nww`-only) writes float32."""
    del config
    from nanowakeword_tpu_torch.export.onnx_export import (SUPPORTED_TYPES,
                                                           export_onnx)
    if model.model_type not in SUPPORTED_TYPES + ("custom", "custom_model"):
        print_error(f"ONNX export covers {SUPPORTED_TYPES} plus 'custom' "
                    f"models; '{model.model_type}' deploys via the .nww "
                    "artifact (served on the torch device).")
        return None
    path = os.path.join(output_dir, model_name + ".onnx")
    try:
        return export_onnx(model, path, input_shape=input_shape,
                           weights_dtype=("int8" if weights_dtype == "int8"
                                          else None))
    except NotImplementedError as e:
        print_error(f"ONNX export skipped: {e}")
        return None
