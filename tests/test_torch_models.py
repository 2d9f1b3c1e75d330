"""The port's weights, encoder and classifiers against the JAX package.

Inputs come from a numpy seed and go through both packages; results are
compared as numpy at the bound stated in each test.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from nanowakeword_tpu.assets import (SPEECH_ENCODER_V2, SPEECH_ENCODER_V3,
                                     SPEECH_ENCODER_V4)
from nanowakeword_tpu.data.features import \
    pretrained_encoder_variables as jax_pretrained
from nanowakeword_tpu.export.artifact import load_nww as jax_load_nww
from nanowakeword_tpu.export.artifact import save_nww
from nanowakeword_tpu.models.embedding import build_encoder as jax_encoder
from nanowakeword_tpu.models.model import Model as JaxModel
from nanowakeword_tpu_torch.convert import (encoder_state_dict_from_flax,
                                            model_state_dict_from_flax)
from nanowakeword_tpu_torch.data.features import pretrained_encoder_variables
from nanowakeword_tpu_torch.export.artifact import load_nww, read_nww_header
from nanowakeword_tpu_torch.models.embedding import encoder_from_state_dict
from nanowakeword_tpu_torch.models.model import Model, build_backbone
from nanowakeword_tpu_torch.utils.flax_msgpack import msgpack_restore

ARTIFACTS = ["campaign/hey_nano_crnn.nww", "campaign/hey_nano_crnn_lite.nww"]
# f32 on both sides; the bound covers differently ordered f32 sums through
# a few layers of convs, GRUs and LayerNorms (measured maxima ~3e-6)
F32_TOL = 1e-4


def _payload(path):
    with open(path, "rb") as f:
        data = f.read()
    if path.endswith(".nww"):
        (hlen,) = struct.unpack("<I", data[4:8])
        return data[8 + hlen:]
    return data


def _assert_same_tree(ours, ref):
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and set(ours) == set(ref)
        for k in ref:
            _assert_same_tree(ours[k], ref[k])
    elif isinstance(ref, list):
        assert len(ours) == len(ref)
        for o, r in zip(ours, ref):
            _assert_same_tree(o, r)
    elif isinstance(ref, (np.ndarray, np.generic)):
        r = np.asarray(ref)
        if r.dtype == jnp.bfloat16:
            r = r.astype(np.float32)            # exact
        o = np.asarray(ours)
        assert o.dtype == r.dtype and o.shape == r.shape
        np.testing.assert_array_equal(o, r)
    else:
        assert type(ours) is type(ref) and ours == ref


@pytest.mark.parametrize("path", [SPEECH_ENCODER_V4, SPEECH_ENCODER_V3,
                                  SPEECH_ENCODER_V2] + ARTIFACTS)
def test_msgpack_reader_matches_flax(path):
    blob = _payload(path)
    _assert_same_tree(msgpack_restore(blob),
                      serialization.msgpack_restore(blob))


def test_msgpack_reader_covers_every_type():
    tree = {
        "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
        "bf16": np.asarray(jnp.linspace(-3, 3, 7, dtype=jnp.bfloat16)),
        "i8": np.array([-127, 0, 127], np.int8),
        "u16": np.array([1, 65535], np.uint16),
        "scalar": np.float32(3.5),
        "ints": [0, 127, 128, 300, 70000, 2 ** 40, -3, -200, -70000,
                 -2 ** 40],
        "floats": [1.5, -0.25],
        "flags": [True, False, None],
        "short": "text",
        "str8": "x" * 40,
        "str16": "y" * 300,
        "array16": list(range(20)),
        "map16": {f"k{i}": i for i in range(20)},
        "bin": b"\x00\x01\x02",
        "nested": {"deeper": {"empty": np.zeros((0,), np.float32)}},
        "complex": 1 + 2j,
    }
    blob = serialization.msgpack_serialize(tree)
    _assert_same_tree(msgpack_restore(blob),
                      serialization.msgpack_restore(blob))


def test_msgpack_reader_rejects_trailing_bytes():
    blob = serialization.msgpack_serialize({"a": 1})
    with pytest.raises(ValueError):
        msgpack_restore(blob + b"\x00")


@pytest.fixture(scope="module")
def mel_input():
    return np.random.default_rng(3).normal(-2.0, 1.5, (2, 100, 32)).astype(
        np.float32)


def _encode(state_dict, mel):
    enc = encoder_from_state_dict(state_dict, "cpu")
    with torch.no_grad():
        return enc(torch.from_numpy(mel)).numpy()


def test_wide128_encoder_matches_jax(mel_input):
    ref = np.asarray(jax_encoder("wide128").apply(jax_pretrained(),
                                                  jnp.asarray(mel_input)))
    out = _encode(encoder_state_dict_from_flax(pretrained_encoder_variables()),
                  mel_input)
    assert out.shape == ref.shape == (2, 4, 96)
    np.testing.assert_allclose(out, ref, atol=F32_TOL)


def test_conv4_encoder_matches_jax(mel_input):
    enc = jax_encoder("conv4")
    variables = enc.init(jax.random.PRNGKey(7), jnp.zeros((1, 76, 32)))
    ref = np.asarray(enc.apply(variables, jnp.asarray(mel_input)))
    numpy_vars = jax.tree_util.tree_map(np.asarray, variables)
    out = _encode(encoder_state_dict_from_flax(numpy_vars), mel_input)
    assert out.shape == ref.shape == (2, 4, 96)
    np.testing.assert_allclose(out, ref, atol=F32_TOL)


@pytest.fixture(scope="module")
def features():
    return np.random.default_rng(4).normal(0.0, 1.0, (3, 16, 96)).astype(
        np.float32)


@pytest.mark.parametrize("path", ARTIFACTS)
def test_shipped_artifact_scores_match_jax(path, features):
    _, jax_model, _ = jax_load_nww(path)
    ref = np.asarray(jax.nn.sigmoid(jax_model(features)))
    header, model, encoder = load_nww(path, device="cpu")
    out = torch.sigmoid(model(features)).numpy()
    assert header == read_nww_header(path)
    assert header["has_encoder"] and encoder is not None
    np.testing.assert_allclose(out, ref, atol=F32_TOL)


@pytest.mark.parametrize("model_type,config,layer_dim,n_blocks", [
    ("dnn", {"activation_function": "gelu", "embedding_dim": 16}, 32, 2),
    ("crnn", {"activation_function": "silu", "embedding_dim": 32,
              "crnn_cnn_channels": [8, 16], "crnn_rnn_type": "lstm"}, 16, 2),
    ("crnn", {"embedding_dim": 32, "crnn_cnn_channels": [8, 8, 16],
              "crnn_rnn_type": "gru"}, 16, 1),
])
def test_backbones_match_jax(model_type, config, layer_dim, n_blocks,
                             features):
    """Random JAX weights (BatchNorm statistics drawn too) carried across."""
    jm = JaxModel(config=config, model_name="t", input_shape=(16, 96),
                  model_type=model_type, layer_dim=layer_dim,
                  n_blocks=n_blocks, dropout_prob=0.2, seed=5)
    rng = np.random.default_rng(6)
    variables = jax.tree_util.tree_map(np.asarray, jm.variables)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                      if p[-1].key == "var"
                      else rng.normal(0, 0.1, a.shape).astype(np.float32)
                      if p[-1].key == "mean" else a), variables)
    jm.load_variables(variables)
    ref = np.asarray(jm(features))

    model = Model(config=config, model_name="t", input_shape=(16, 96),
                  model_type=model_type, layer_dim=layer_dim,
                  n_blocks=n_blocks, dropout_prob=0.2, device="cpu")
    model.load_state_dict(model_state_dict_from_flax(variables, model))
    assert model.n_params() == jm.n_params()
    np.testing.assert_allclose(model(features).numpy(), ref, atol=F32_TOL)


@pytest.mark.parametrize("weights_dtype", ["float32", "bfloat16", "int8"])
def test_nww_weights_dtypes_load_like_jax(tmp_path, weights_dtype, features,
                                          mel_input):
    cfg = {"activation_function": "relu", "embedding_dim": 16}
    jm = JaxModel(config=cfg, model_name="tiny", input_shape=(16, 96),
                  model_type="dnn", layer_dim=16, n_blocks=1,
                  dropout_prob=0.0)
    path = str(tmp_path / f"tiny_{weights_dtype}.nww")
    save_nww(path, model=jm, config=cfg, model_name="tiny",
             encoder_variables=jax_pretrained(), weights_dtype=weights_dtype)
    _, jax_model, jax_enc = jax_load_nww(path)
    header, model, encoder = load_nww(path, device="cpu")
    assert header["weights_dtype"] == weights_dtype
    np.testing.assert_allclose(model(features).numpy(),
                               np.asarray(jax_model(features)),
                               atol=F32_TOL)
    ref = np.asarray(jax_encoder("wide128").apply(jax_enc,
                                                  jnp.asarray(mel_input)))
    np.testing.assert_allclose(_encode(encoder, mel_input), ref,
                               atol=F32_TOL)


def test_unported_model_type_raises():
    """Every model type of the reference is built; an unknown one raises
    ValueError, as the reference does."""
    backbone, stateful = build_backbone("transformer", {}, (16, 96), 32, 1,
                                        0.0, 16, torch.relu)
    assert backbone(torch.zeros(2, 16, 96)).shape == (2, 16) and not stateful
    with pytest.raises(ValueError, match="Unsupported model_type"):
        build_backbone("resnet99", {}, (16, 96), 32, 1, 0.0, 16, torch.relu)
