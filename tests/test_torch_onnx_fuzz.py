"""Both property sweeps of the JAX package's ONNX exporters, against the port.

Sweep 1 (tests/test_onnx_fuzz.py): the same 20 seeded geometries of the
twelve families. Each case's flax variables tree (its shapes from the JAX
module's init, traced by `jax.eval_shape`) is drawn from the case's seed,
with the BatchNorm statistics perturbed by that file's
`_perturb_batch_stats`, and carried into the port by convert.py
(`Model.load_variables`). The port's logits equal the JAX module's within
1e-5, and the port's graph equals the port's module within 1e-5 in both the
numpy evaluator and the torch ONNX runtime.

Sweep 2 (tests/test_jaxpr_fuzz.py): the same 20 plans (`_random_plan`,
seeds 1000 + i), written as torch modules from idiomatic ops
(nn.MultiheadAttention or softmax attention, `F.avg_pool1d`, a list index
for `take`, `argmax` / `one_hot` gating). Each exports through torch.fx at
a dynamic batch without the fallback and matches its module at batch 2 and
7 (rtol 1e-4, atol 1e-5); the JAX exporter lowers the same plan at a
dynamic batch too.

Then the index kinds with no lowering: they raise ExportUnsupported, and
the trainer's exporter logs "ONNX export skipped" instead of raising.
"""

import contextlib
import importlib.util
import io
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from nanowakeword_tpu.export.jaxpr_onnx import \
    build_onnx_from_module as jax_build_onnx_from_module
from nanowakeword_tpu.models import architectures as JA
from nanowakeword_tpu.models.model import WakeWordModule, build_backbone
from nanowakeword_tpu_torch.export import onnx_eval
from nanowakeword_tpu_torch.export import onnx_proto as P
from nanowakeword_tpu_torch.export.artifact import export_onnx_model
from nanowakeword_tpu_torch.export.fx_onnx import (ExportUnsupported,
                                                   build_onnx_from_module)
from nanowakeword_tpu_torch.export.onnx_export import build_onnx
from nanowakeword_tpu_torch.export.onnx_torch import OnnxTorchModel
from nanowakeword_tpu_torch.models.model import Model

REPO = Path(__file__).resolve().parent.parent
LOGIT_TOL = 1e-5     # port vs JAX logits, float32 on both sides
ONNX_TOL = 1e-5      # a graph vs its module
FUZZ_RTOL, FUZZ_ATOL = 1e-4, 1e-5   # tests/test_jaxpr_fuzz.py's bars


def _reference(name: str):
    """A JAX-package test file, loaded under a private name."""
    key = "jax_reference_" + name
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, REPO / "tests" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


ONNX_FUZZ = _reference("test_onnx_fuzz")
JAXPR_FUZZ = _reference("test_jaxpr_fuzz")
T, FEAT = JAXPR_FUZZ.T, JAXPR_FUZZ.F


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the small graphs' many small ops otherwise spin
    torch's thread pool against the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(tree, rng):
    """Weights for a tree of shapes: kernels N(0, 1/fan_in), norm scales
    U(0.5, 1.5), biases and other vectors N(0, 0.1)."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = _draw(leaf, rng)
        elif len(leaf.shape) >= 2:
            fan_in = int(np.prod(leaf.shape[:-1]))
            out[name] = rng.normal(0, fan_in ** -0.5,
                                   leaf.shape).astype(np.float32)
        elif name == "scale":
            out[name] = rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        else:
            out[name] = rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    return out


def _shapes(module, *args):
    """The variables tree of a flax module's init, as shapes only."""
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(module.init, jax.random.PRNGKey(0), *args))


# -- sweep 1: random geometries of the twelve families ------------------------


@pytest.mark.parametrize("case", range(20))
def test_random_geometry_port_matches_jax_and_its_graph(case):
    rng = np.random.default_rng(1000 + case)
    family, config, layer_dim, n_blocks, batch = ONNX_FUZZ._random_case(rng)
    activation = JA.get_activation(config.get("activation_function", "relu"))
    embedding_dim = int(config.get("embedding_dim", 64))
    backbone, stateful = build_backbone(
        family, config, (16, 96), layer_dim, n_blocks, 0.1, embedding_dim,
        activation)
    module = WakeWordModule(backbone=backbone, embedding_dim=embedding_dim,
                            n_classes=1, dropout_prob=0.1,
                            activation=activation, stateful=stateful)
    shapes = _shapes(module, jnp.zeros((1, 16, 96), jnp.float32))
    holder = SimpleNamespace(variables=shapes)
    holder.load_variables = lambda v: setattr(holder, "variables", v)
    ONNX_FUZZ._perturb_batch_stats(holder, rng)      # the reference's draws
    variables = dict(holder.variables)
    variables["params"] = _draw(shapes["params"], rng)
    variables = jax.tree_util.tree_map(np.asarray, variables)

    feats = rng.normal(size=(batch, 16, 96)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: module.apply(
        v, x, deterministic=True))(variables, feats))

    pm = Model(config=config, model_name=f"fuzz_{case}", input_shape=(16, 96),
               model_type=family, layer_dim=layer_dim, n_blocks=n_blocks,
               dropout_prob=0.1, device="cpu")
    pm.load_variables(variables)
    with torch.no_grad():
        logits = pm(feats).numpy()
    what = (f"family={family} config={config} layer_dim={layer_dim} "
            f"n_blocks={n_blocks} batch={batch}")
    np.testing.assert_allclose(logits, want, rtol=0, atol=LOGIT_TOL,
                               err_msg=what)

    data = build_onnx(pm)
    scores = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    got = onnx_eval.run(data, {"features": feats})["score"]
    np.testing.assert_allclose(got, scores, rtol=0, atol=ONNX_TOL,
                               err_msg=what)
    served = OnnxTorchModel(data, device="cpu")(feats)
    np.testing.assert_allclose(np.asarray(served).reshape(scores.shape),
                               scores, rtol=0, atol=ONNX_TOL, err_msg=what)


# -- sweep 2: random custom modules, written in torch -------------------------


class TorchRandomModule(nn.Module):
    """A plan of tests/test_jaxpr_fuzz.py::_RandomModule in torch. Even
    seeds use nn.MultiheadAttention and nn.LayerNorm; odd seeds a
    hand-written softmax attention (einsum scores, matmul values) and a
    layer norm from var and rsqrt."""

    def __init__(self, plan, residual_at, hand_written: bool):
        super().__init__()
        self.plan, self.residual_at = plan, residual_at
        self.hand_written = hand_written
        self.blocks = nn.ModuleList()
        t, c = T, FEAT
        skip, self.close_at = None, None
        for i, (kind, width) in enumerate(plan):
            if i == residual_at:
                skip = (t, c)
            block = nn.Module()
            if kind == "dense":
                block.fc = nn.Linear(c, width)
                c = width
            elif kind == "layernorm":
                block.norm = nn.LayerNorm(c, eps=1e-6)
            elif kind == "attention":
                d = max(width // 2, 4) * 2
                block.proj = nn.Linear(c, d)
                if hand_written:
                    block.qkv = nn.Linear(d, 3 * d)
                    block.out = nn.Linear(d, d)
                    block.scale = 1.0 / math.sqrt(d // 2)
                else:
                    block.attn = nn.MultiheadAttention(d, 2,
                                                       batch_first=True)
                c = d
            elif kind == "conv":
                block.conv = nn.Conv1d(c, width, 3, padding=1)
                c = width
            elif kind in ("avgpool", "stride"):
                t = -(-t // 2)
            elif kind == "take":
                t = 3
            self.blocks.append(block)
            if skip is not None and self.close_at is None and (t, c) == skip:
                self.close_at = i
        self.head = nn.Linear(c, 1)

    def forward(self, x):
        skip = None
        for i, ((kind, _), block) in enumerate(zip(self.plan, self.blocks)):
            if i == self.residual_at:
                skip = x
            x = getattr(self, kind)(block, x)
            if i == self.close_at:
                x = x + skip
        return self.head(x.mean(dim=1))

    def dense(self, block, x):
        return F.gelu(block.fc(x), approximate="tanh")

    def layernorm(self, block, x):
        if not self.hand_written:
            return block.norm(x)
        centred = x - x.mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(x.var(dim=-1, keepdim=True, unbiased=False) + 1e-6)
        return centred * inv * block.norm.weight + block.norm.bias

    def attention(self, block, x):
        h = block.proj(x)
        if not self.hand_written:
            return block.attn(h, h, h, need_weights=False)[0]
        b, t, d = h.shape
        q, k, v = block.qkv(h).chunk(3, dim=-1)
        q = q.reshape(b, t, 2, d // 2).transpose(1, 2)
        k = k.reshape(b, t, 2, d // 2).transpose(1, 2)
        v = v.reshape(b, t, 2, d // 2).transpose(1, 2)
        weights = torch.softmax(
            torch.einsum("bhqd,bhkd->bhqk", q, k) * block.scale, dim=-1)
        return block.out((weights @ v).transpose(1, 2).reshape(b, t, d))

    def conv(self, block, x):
        return F.relu(block.conv(x.transpose(1, 2))).transpose(1, 2)

    def avgpool(self, block, x):
        return F.avg_pool1d(x.transpose(1, 2), 2).transpose(1, 2)

    def stride(self, block, x):
        return x[:, ::2, :]

    def take(self, block, x):
        t = x.shape[1]
        return x[:, [0, t - 1, t // 2], :]

    def argmax_gate(self, block, x):
        idx = (torch.argmax(x, -1) if self.hand_written
               else x.argmax(dim=-1))
        return x * (0.5 + F.one_hot(idx, x.shape[-1]))


def _batch_dim(data: bytes):
    return P.load_model(data).graph.inputs[0].shape[0]


@pytest.mark.parametrize("seed", range(20))
def test_random_custom_module_exports_at_a_dynamic_batch(seed):
    rng = np.random.default_rng(1000 + seed)
    plan, residual_at = JAXPR_FUZZ._random_plan(rng)
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        module = TorchRandomModule(plan, residual_at, seed % 2 == 1).eval()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        data = build_onnx_from_module(module, (T, FEAT), 1, f"fuzz_{seed}")
    assert "FIXED" not in log.getvalue(), log.getvalue()
    assert _batch_dim(data) == "batch_size"
    for batch in (2, 7):
        x = rng.normal(0, 1, (batch, T, FEAT)).astype(np.float32)
        with torch.no_grad():
            want = torch.sigmoid(module(torch.from_numpy(x))).numpy()
        got = onnx_eval.run(data, {"features": x})["score"]
        assert got.shape == want.shape == (batch, 1)
        np.testing.assert_allclose(got, want, rtol=FUZZ_RTOL,
                                   atol=FUZZ_ATOL,
                                   err_msg=f"case {seed} plan={plan}")

    # the JAX package lowers the same composition at a dynamic batch (its
    # own sweep holds that graph to its module)
    jax_module = JAXPR_FUZZ._RandomModule(plan=plan, residual_at=residual_at)
    variables = _draw(_shapes(jax_module, jnp.zeros((1, T, FEAT))), rng)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        ref = jax_build_onnx_from_module(jax_module, variables, (T, FEAT), 1,
                                         f"fuzz_{seed}", validate=False)
    assert "FIXED" not in log.getvalue(), log.getvalue()
    assert _batch_dim(ref) == "batch_size"


# -- index kinds with no lowering ---------------------------------------------


class Indexed(nn.Module):
    def __init__(self, kind):
        super().__init__()
        self.kind = kind
        self.out = nn.Linear(FEAT, 1)
        self.register_buffer("rows", torch.tensor([0, 2, 4]))

    def forward(self, x):
        if self.kind == "tensor":
            x = x[:, self.rows]
        elif self.kind == "traced":
            x = x[:, x[0, 0].argmax()][:, None]
        elif self.kind == "bool mask":
            x = x[:, x[0, :, 0] > 0]
        elif self.kind == "bool list":
            x = x[:, [True, False] * (T // 2)]
        elif self.kind == "two lists":
            x = x[:, [0, 1, 2], [0, 1, 2]][..., None].repeat(1, 1, FEAT)
        elif self.kind == "list and int":
            x = x[:, [0, 1], 0][..., None].repeat(1, 1, FEAT)
        else:                                   # a constant list: Gather
            x = x[:, [1, -1, 3, 3]]
        return self.out(x.mean(dim=1))


@pytest.mark.parametrize("kind", ["tensor", "traced", "bool mask",
                                  "bool list", "two lists", "list and int"])
def test_other_index_kinds_raise(kind):
    with pytest.raises(ExportUnsupported):
        build_onnx_from_module(Indexed(kind), (T, FEAT), 1)


def test_a_constant_list_index_is_a_gather():
    module = Indexed("list").eval()
    data = build_onnx_from_module(module, (T, FEAT), 1)
    gather = [n for n in P.load_model(data).graph.nodes
              if n.op_type == "Gather"]
    assert len(gather) == 1 and gather[0].attrs["axis"] == 1
    assert _batch_dim(data) == "batch_size"
    x = np.random.default_rng(4).normal(0, 1, (5, T, FEAT)).astype(
        np.float32)
    with torch.no_grad():
        want = torch.sigmoid(module(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(onnx_eval.run(data, {"features": x})["score"],
                               want, rtol=FUZZ_RTOL, atol=FUZZ_ATOL)


@pytest.mark.parametrize("kind", ["tensor", "bool mask"])
def test_export_onnx_model_skips_them(tmp_path, kind, capsys):
    src = tmp_path / "indexed.py"
    src.write_text(
        "import torch\n"
        "class MyNet(torch.nn.Module):\n"
        "    def __init__(self, input_shape, embedding_dim):\n"
        "        super().__init__()\n"
        "        self.a = torch.nn.Linear(input_shape[1], embedding_dim)\n"
        "        self.register_buffer('rows', torch.tensor([0, 2, 4]))\n"
        "    def forward(self, x):\n"
        + ("        x = x[:, self.rows]\n" if kind == "tensor"
           else "        x = x[:, x[0, :, 0] > 0]\n")
        + "        return self.a(x.mean(dim=1))\n")
    cfg = {"custom_model_config": {"module_path": str(src),
                                   "class_name": "MyNet"}}
    model = Model(config=cfg, model_name="idx", input_shape=(16, 96),
                  model_type="custom", device="cpu")
    assert export_onnx_model(model, (16, 96), cfg, "idx",
                             str(tmp_path)) is None
    assert "ONNX export skipped" in capsys.readouterr().out
    assert not (tmp_path / "idx.onnx").exists()
