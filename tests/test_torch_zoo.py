"""The port's model zoo against the JAX package, on the CPU at small widths.

Weights are carried across with convert.py (both directions), inputs come
from a numpy seed. Bars: an eval forward within 1e-5, flax's batch
statistics within 1e-6, one training step (dropout 0) within 1e-5, the
round trip flax -> torch -> flax exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanowakeword_tpu.export.artifact import load_nww as jax_load_nww
from nanowakeword_tpu.export.artifact import save_nww as jax_save_nww
from nanowakeword_tpu.models.model import Model as JaxModel
from nanowakeword_tpu.train.optim import build_optimizer
from nanowakeword_tpu.train.step import create_train_state
from nanowakeword_tpu.train.step import make_train_step as jax_train_step
from nanowakeword_tpu_torch.export.artifact import load_nww, save_nww
from nanowakeword_tpu_torch.models import architectures as A
from nanowakeword_tpu_torch.models.model import Model
from nanowakeword_tpu_torch.train.optim import Optimizer
from nanowakeword_tpu_torch.train.step import make_train_step

T = torch.from_numpy
EVAL_TOL = 1e-5     # f32 eval forward in two frameworks
STATS_TOL = 1e-6    # flax's batch statistics after one training forward
STEP_TOL = 1e-5     # one training step: loss, grad norm, logits, weights

NEW_TYPES = ["cnn", "lstm", "gru", "rnn", "transformer", "tcn", "quartznet",
             "conformer", "e_branchformer", "bcresnet"]
ALL_TYPES = ["dnn", "crnn", "streaming_gru"] + NEW_TYPES
BATCHNORM_TYPES = ["quartznet", "conformer", "bcresnet"]

SMALL_CONFIG = {
    "activation_function": "gelu",
    "embedding_dim": 32,
    "transformer_d_model": 32, "transformer_n_head": 2,
    "conformer_d_model": 32, "conformer_n_head": 2,
    "branchformer_d_model": 32, "branchformer_n_head": 2,
    "crnn_cnn_channels": [8, 16], "crnn_rnn_type": "gru",
    "tcn_channels": [16, 32], "tcn_kernel_size": 3,
    "quartznet_config": [[32, 9, 1], [32, 8, 1], [64, 9, 1]],
}
BUILD = dict(layer_dim=16, n_blocks=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_model(model_type, input_shape=(16, 96), seed=5):
    return JaxModel(config=dict(SMALL_CONFIG), model_name="t",
                    input_shape=input_shape, model_type=model_type,
                    dropout_prob=0.0, seed=seed, **BUILD)


def _port_model(model_type, variables=None, input_shape=(16, 96), seed=10):
    m = Model(config=dict(SMALL_CONFIG), model_name="t",
              input_shape=input_shape, model_type=model_type,
              dropout_prob=0.0, seed=seed, device="cpu", **BUILD)
    if variables is not None:
        m.load_variables(variables)
    return m


def _randomized(variables, seed=3):
    """The same tree with every leaf redrawn, so biases, norm scales and
    running statistics take part in a comparison."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        a = np.asarray(leaf)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "mean", "recurrent_bias"):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(redraw, variables)


def _features(seed, shape=(4, 16, 96)):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _assert_trees_equal(ours, ref, atol=0.0):
    assert set(ours) == set(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_trees_equal(ours[k], ref[k], atol)
        else:
            assert ours[k].shape == np.asarray(ref[k]).shape, k
            np.testing.assert_allclose(ours[k], np.asarray(ref[k]), rtol=0,
                                       atol=atol, err_msg=k)


# -- eval forward -----------------------------------------------------------------


@pytest.mark.parametrize("model_type", NEW_TYPES)
def test_eval_forward_matches_jax(model_type):
    jm = _jax_model(model_type)
    variables = _randomized(_np_tree(jm.variables))
    model = _port_model(model_type, variables)
    x = _features(0)
    ref = jm.module.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                          jnp.asarray(x), deterministic=True)
    out = model(x).numpy()
    assert out.shape == (4, 1)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=EVAL_TOL)


@pytest.mark.parametrize("input_shape", [(18, 90), (15, 95)])
def test_bcresnet_same_padding_on_even_and_odd_lengths(input_shape):
    """flax pads a strided `SAME` convolution (0, 1) on an even length
    where torch's padding=1 pads (1, 1). The default (16, 96) of the
    other tests gives even maps at every strided block; (18, 90) and
    (15, 95) give odd ones, where the two rules agree."""
    jm = _jax_model("bcresnet", input_shape)
    variables = _randomized(_np_tree(jm.variables))
    model = _port_model("bcresnet", variables, input_shape)
    x = _features(1, (3,) + input_shape)
    ref = jm.module.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                          jnp.asarray(x), deterministic=True)
    np.testing.assert_allclose(model(x).numpy(), np.asarray(ref), rtol=0,
                               atol=EVAL_TOL)


def test_same_padding_follows_flax_rule():
    # (n, kernel, stride) -> flax's (before, after)
    assert A.same_padding(8, 3, 2) == (0, 1)
    assert A.same_padding(9, 3, 2) == (1, 1)
    assert A.same_padding(16, 31, 1) == (15, 15)
    assert A.same_padding(16, 8, 1) == (3, 4)
    assert A.same_padding(8, 1, 2) == (0, 0)
    for n, k, s in ((8, 3, 2), (9, 3, 2), (16, 8, 1), (7, 4, 3)):
        x = jnp.zeros((1, n, 1))
        ref = jax.lax.conv_general_dilated(
            x, jnp.zeros((k, 1, 1)), (s,), "SAME",
            dimension_numbers=("NWC", "WIO", "NWC"))
        lo, hi = A.same_padding(n, k, s)
        assert (n + lo + hi - k) // s + 1 == ref.shape[1]


# -- training-mode forward: flax's batch statistics -----------------------------------


@pytest.fixture
def no_dropout(monkeypatch):
    """`ConvolutionModule` has a fixed Dropout(0.1) that `dropout_prob: 0`
    does not reach, and dropout masks cannot match between frameworks: flax's
    Dropout becomes the identity here, and `_without_dropout` zeroes the
    port's rates."""
    import flax.linen as nn
    monkeypatch.setattr(
        nn.Dropout, "__call__",
        lambda self, inputs, deterministic=None, rng=None: inputs)


def _without_dropout(model):
    for m in model.module.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


@pytest.mark.parametrize("model_type", BATCHNORM_TYPES)
def test_training_forward_batch_stats_match_flax(model_type, no_dropout):
    jm = _jax_model(model_type)
    variables = _randomized(_np_tree(jm.variables))
    x = _features(2, (6, 16, 96))
    logits, updates = jm.module.apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x),
        deterministic=False, mutable=["batch_stats"])
    model = _without_dropout(_port_model(model_type, variables).train())
    out = model.module(T(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(logits), rtol=0,
                               atol=STEP_TOL)
    _assert_trees_equal(model.variables["batch_stats"],
                        _np_tree(updates["batch_stats"]), atol=STATS_TOL)


# -- one training step against the JAX step ----------------------------------------------


@pytest.mark.parametrize("model_type", NEW_TYPES)
def test_training_step_matches_jax(model_type, no_dropout):
    """One SGD-momentum step from the same weights and batch: loss, grad
    norm, per-example BCE and logits, then every updated weight and
    BatchNorm statistic, within 1e-5. SGD and not Adam: several of these
    families have parameters whose gradient is zero up to rounding (the
    attention key bias, a conv bias right before a BatchNorm), and Adam
    turns rounding noise into a full step of either sign."""
    train_cfg = {"optimizer_type": "sgd", "learning_rate_max": 1e-2,
                 "lr_scheduler_type": "cosine", "learning_rate_base": 1e-4,
                 "weight_decay": 0.01}
    jm = _jax_model(model_type)
    variables = _randomized(_np_tree(jm.variables))
    tx = build_optimizer(train_cfg, total_steps=50)
    jstate = create_train_state(jm.module, jax.tree_util.tree_map(
        jnp.asarray, variables), tx)
    jstep = jax_train_step(jm.module, tx, donate=False)

    model = _without_dropout(_port_model(model_type, variables).train())
    optimizer = Optimizer(list(model.module.parameters()), train_cfg, 50)
    step = make_train_step(model.module, optimizer)
    x = _features(6, (6, 16, 96))
    y = np.array([1, 0, 0, 1, 0, 0], np.float32)
    jstate, jm_metrics = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
    metrics = step(T(x), T(y))
    ref = np.asarray(jm_metrics.packed)
    np.testing.assert_allclose(metrics.loss.item(), ref[0], rtol=STEP_TOL)
    np.testing.assert_allclose(metrics.grad_norm.item(), ref[1],
                               rtol=STEP_TOL)
    np.testing.assert_allclose(metrics.packed.numpy()[2:], ref[2:], rtol=0,
                               atol=STEP_TOL)
    ours = model.variables
    _assert_trees_equal(ours["params"], _np_tree(jstate.params), STEP_TOL)
    if jstate.batch_stats:
        _assert_trees_equal(ours["batch_stats"],
                            _np_tree(jstate.batch_stats), STEP_TOL)


# -- weights carried across ------------------------------------------------------------------


@pytest.mark.parametrize("model_type", ALL_TYPES)
def test_variables_round_trip_is_exact(model_type):
    """flax -> torch -> flax gives the same tree, names and values; and a
    fresh port model's tree has exactly the JAX model's names and shapes."""
    variables = _randomized(_np_tree(_jax_model(model_type).variables))
    model = _port_model(model_type, variables)
    _assert_trees_equal(model.variables, variables, atol=0)
    fresh = _port_model(model_type).variables
    assert set(fresh) == set(variables)
    _assert_trees_equal(
        jax.tree_util.tree_map(np.zeros_like, fresh),
        jax.tree_util.tree_map(np.zeros_like, variables))


NWW_TYPES = ["transformer", "quartznet", "bcresnet"]


@pytest.mark.parametrize("weights_dtype", ["float32", "int8"])
@pytest.mark.parametrize("model_type", NWW_TYPES)
def test_nww_written_by_port_loads_in_jax(tmp_path, model_type,
                                          weights_dtype):
    variables = _randomized(_np_tree(_jax_model(model_type).variables))
    model = _port_model(model_type, variables)
    path = str(tmp_path / "port.nww")
    save_nww(path, model=model, config=dict(SMALL_CONFIG), model_name="t",
             weights_dtype=weights_dtype)
    header, jm, _ = jax_load_nww(path)
    assert header["model_type"] == model_type
    x = _features(7)
    if weights_dtype == "float32":
        _assert_trees_equal(_np_tree(jm.variables), variables, atol=0)
        np.testing.assert_allclose(np.asarray(jm(x)), model(x).numpy(),
                                   rtol=0, atol=EVAL_TOL)
    _, back, _ = load_nww(path, device="cpu")
    np.testing.assert_allclose(back(x).numpy(), np.asarray(jm(x)), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("weights_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model_type", NWW_TYPES)
def test_nww_written_by_jax_loads_in_port(tmp_path, model_type,
                                          weights_dtype):
    jm = _jax_model(model_type, seed=6)
    path = str(tmp_path / "jax.nww")
    jax_save_nww(path, model=jm, config=dict(SMALL_CONFIG), model_name="t",
                 weights_dtype=weights_dtype)
    header, model, encoder = load_nww(path, device="cpu")
    assert encoder is None and header["weights_dtype"] == weights_dtype
    _, jm_back, _ = jax_load_nww(path)
    _assert_trees_equal(model.variables, _np_tree(jm_back.variables), atol=0)
    x = _features(8)
    np.testing.assert_allclose(model(x).numpy(), np.asarray(jm_back(x)),
                               rtol=0, atol=EVAL_TOL)


# -- the fresh model ----------------------------------------------------------------------------


@pytest.mark.parametrize("model_type", ["transformer", "tcn", "quartznet"])
def test_fresh_model_draws_flax_initializers(model_type):
    """Per-tensor std within 10% of the JAX Model's, each pooled over 8
    seeds: attention projections (fan-in d_model for q/k/v, heads x
    head_dim for out), 1-D convolutions (fan-in channels per group x taps,
    so a depthwise kernel draws with fan-in k), zero biases, unit scales."""

    def leaves(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{path}/{k}")
            else:
                yield f"{path}/{k}", np.asarray(v)

    def pooled(models):
        out = {}
        for m in models:
            for name, a in leaves(m):
                out.setdefault(name, []).append(a)
        return out

    seeds = range(8)
    ref = pooled(_np_tree(_jax_model(model_type, seed=s).variables["params"])
                 for s in seeds)
    ours = pooled(_port_model(model_type, seed=s).variables["params"]
                  for s in seeds)
    assert set(ours) == set(ref)
    for name, arrays in ours.items():
        a, b = np.stack(arrays), np.stack(ref[name])
        assert a.shape == b.shape, name
        leaf = name.rsplit("/", 1)[1]
        if leaf == "bias":
            assert not a.any(), name
        elif leaf == "scale":
            assert (a == 1).all(), name
        elif a.size >= 2048:     # enough draws for a 10% bar
            assert abs(a.std() / b.std() - 1) < 0.1, (name, a.std(),
                                                      b.std())


# -- the dispatch ---------------------------------------------------------------------------------


def test_custom_model_loading(tmp_path):
    src = tmp_path / "my_arch.py"
    src.write_text(
        "import torch\n"
        "class MyNet(torch.nn.Module):\n"
        "    def __init__(self, input_shape, embedding_dim, width=4):\n"
        "        super().__init__()\n"
        "        n = input_shape[0] * input_shape[1]\n"
        "        self.a = torch.nn.Linear(n, width)\n"
        "        self.norm = torch.nn.BatchNorm1d(width)\n"
        "        self.b = torch.nn.Linear(width, embedding_dim)\n"
        "    def forward(self, x):\n"
        "        return self.b(self.norm(self.a(x.flatten(1))))\n")
    cfg = dict(SMALL_CONFIG)
    cfg["custom_model_config"] = {"module_path": str(src),
                                  "class_name": "MyNet",
                                  "params": {"width": 6}}
    model = Model(config=cfg, model_name="custom_test", input_shape=(16, 96),
                  model_type="custom", device="cpu")
    assert model.module.backbone.a.out_features == 6   # params reached it
    x = _features(9, (2, 16, 96))
    out = model(x)
    assert out.shape == (2, 1)
    # it trains: one step moves its weights and its BatchNorm statistics
    before = model.module.backbone.a.weight.clone()
    model.train()
    step = make_train_step(model.module, Optimizer(
        list(model.module.parameters()), {"learning_rate_max": 1e-2}, 10))
    metrics = step(T(x), torch.tensor([1.0, 0.0]))
    assert torch.isfinite(metrics.packed).all()
    assert not torch.equal(model.module.backbone.a.weight, before)
    assert int(model.module.backbone.norm.num_batches_tracked) == 1
    out = model.eval()(x)
    # the weights survive a .nww, integer buffers included
    path = str(tmp_path / "custom.nww")
    save_nww(path, model=model, config=cfg, model_name="custom_test")
    _, back, _ = load_nww(path, device="cpu")
    assert torch.equal(back(x), out)
    for k, v in model.module.state_dict().items():
        got = back.module.state_dict()[k]
        assert got.dtype == v.dtype and torch.equal(got, v), k

    cfg["custom_model_config"] = {"module_path": str(src)}
    with pytest.raises(ValueError, match="class_name"):
        Model(config=cfg, model_name="c", model_type="custom", device="cpu")
    cfg["custom_model_config"] = {"module_path": str(src),
                                  "class_name": "Missing"}
    with pytest.raises(AttributeError, match="Missing"):
        Model(config=cfg, model_name="c", model_type="custom", device="cpu")


def test_unstable_architectures_warn_and_summary_lists_the_flax_names(
        capsys):
    model = _port_model("conformer")
    assert "CONFORMER" in capsys.readouterr().out
    _port_model("tcn")
    assert "WARNING" not in capsys.readouterr().out
    text = model.summary()
    assert f"{model.n_params():,}" in text
    assert ("backbone/ConformerBlock_1/MultiHeadDotProductAttention_0/query/"
            "kernel") in text
    assert "(32, 2, 16)" in text
