"""A user's torch module -> ONNX through torch.fx (export/fx_onnx.py), on
the CPU: the graph against the module through the numpy evaluator and the
torch ONNX runtime, the dynamic batch, the fixed-batch fallback, an
unsupported op named, and the `custom` family through `build_onnx`, the
artifact exporter and the interpreter."""

import numpy as np
import pytest
import torch
from torch import nn
from torch.nn import functional as F

from nanowakeword_tpu_torch import NanoInterpreter
from nanowakeword_tpu_torch.export import onnx_eval
from nanowakeword_tpu_torch.export import onnx_proto as P
from nanowakeword_tpu_torch.export.artifact import export_onnx_model
from nanowakeword_tpu_torch.export.fx_onnx import (ExportUnsupported,
                                                   build_onnx_from_module)
from nanowakeword_tpu_torch.export.onnx_export import build_onnx
from nanowakeword_tpu_torch.export.onnx_torch import OnnxTorchModel
from nanowakeword_tpu_torch.interpreter.nanointerpreter import _OnnxSession
from nanowakeword_tpu_torch.models.model import Model

ONNX_TOL = 1e-5      # graph vs module, float32 on both sides

# the custom module of tests/test_torch_zoo.py::test_custom_model_loading
ZOO_CUSTOM = (
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


class ConvPool(nn.Module):
    """Convolutions, pooling, normalisation and the tensor plumbing a
    custom wake-word module is made of."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv1d(96, 24, 3, padding=1)
        self.pool = nn.MaxPool1d(2)
        self.bn = nn.BatchNorm1d(24)
        self.conv2d = nn.Conv2d(1, 4, (3, 5), stride=(1, 2),
                                padding="valid")
        self.avg = nn.AvgPool2d(2)
        self.norm = nn.LayerNorm(48)
        self.drop = nn.Dropout(0.3)
        self.act = nn.GELU()
        self.out = nn.Linear(48 + 4 * 6 * 23, 12)
        with torch.no_grad():            # running statistics of a trained BN
            self.bn.running_mean.uniform_(-0.5, 0.5)
            self.bn.running_var.uniform_(0.5, 2.0)

    def forward(self, x):                # [B, 16, 96]
        h = self.conv(x.transpose(1, 2))                   # [B, 24, 16]
        h = self.bn(torch.relu(self.pool(h)))              # [B, 24, 8]
        pooled = torch.cat([h.mean(dim=2), h.amax(dim=-1)], dim=1)
        pooled = self.drop(self.act(self.norm(pooled)))    # [B, 48]
        img = nn.functional.pad(x[:, 1:, :], (1, 1))[:, None]   # [B,1,15,98]
        img = self.avg(torch.tanh(self.conv2d(img))).flatten(1)
        return self.out(torch.cat([pooled * 0.5 + 1.0, img], 1))


def _features(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _module_scores(module, x):
    with torch.no_grad():
        logits = module.eval()(torch.from_numpy(x))
    return torch.sigmoid(logits.reshape(len(x), -1)).numpy()


def _custom_model(tmp_path, source=ZOO_CUSTOM, params=None):
    src = tmp_path / "my_arch.py"
    src.write_text(source)
    cfg = {"custom_model_config": {"module_path": str(src),
                                   "class_name": "MyNet",
                                   "params": ({"width": 6} if params is None
                                              else params)}}
    model = Model(config=cfg, model_name="c", input_shape=(16, 96),
                  model_type="custom", device="cpu")
    with torch.no_grad():                # running statistics of a trained BN
        for m in model.module.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    return model, cfg


def _dims(data):
    graph = P.load_model(data).graph
    return graph.inputs[0].shape[0], tuple(graph.outputs[0].shape)


@pytest.mark.parametrize("batch", [1, 3, 7])
@pytest.mark.parametrize("which", ["zoo_custom", "conv_pool"])
def test_graph_matches_module(tmp_path, which, batch):
    if which == "zoo_custom":
        model, _ = _custom_model(tmp_path)
        module, n_classes = model.module, 1
    else:
        module, n_classes = ConvPool(), 12
    data = build_onnx_from_module(module, (16, 96), n_classes)
    assert _dims(data) == ("batch_size", ("batch_size", n_classes))
    x = _features(batch, (batch, 16, 96))
    want = _module_scores(module, x)
    got = onnx_eval.run(data, {"features": x})["score"]
    np.testing.assert_allclose(got, want, atol=ONNX_TOL, rtol=ONNX_TOL)
    runtime = OnnxTorchModel(data, device="cpu")
    np.testing.assert_allclose(runtime(x), want, atol=ONNX_TOL,
                               rtol=ONNX_TOL)


def test_export_leaves_the_module_as_it_was():
    module = ConvPool().train()
    before = {k: v.clone() for k, v in module.state_dict().items()}
    build_onnx_from_module(module, (16, 96), 12)
    assert module.training
    for k, v in module.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("op,body", [
    ("cumsum", "return self.a(torch.cumsum(x, 1).flatten(1))"),
    ("sort", "return self.a(torch.sort(x, 1)[0].flatten(1))"),
    ("LSTM", "return self.a(self.rnn(x)[0][:, -1].repeat(1, 16))"),
])
def test_unsupported_op_is_named(tmp_path, op, body):
    source = ("import torch\n"
              "class MyNet(torch.nn.Module):\n"
              "    def __init__(self, input_shape, embedding_dim):\n"
              "        super().__init__()\n"
              "        self.rnn = torch.nn.LSTM(96, 96, batch_first=True)\n"
              "        self.a = torch.nn.Linear(16 * 96, embedding_dim)\n"
              "    def forward(self, x):\n"
              f"        {body}\n")
    model, _ = _custom_model(tmp_path, source, params={})
    with pytest.raises(ExportUnsupported, match=op):
        build_onnx(model)
    assert issubclass(ExportUnsupported, NotImplementedError)


def test_batch_bound_module_falls_back_to_batch_one(capsys):
    class FirstRow(nn.Module):
        def __init__(self):
            super().__init__()
            self.a = nn.Linear(96, 2)

        def forward(self, x):
            h = x.mean(dim=1)
            return self.a(torch.cat([h[:1], h[1:] * 2.0], 0))

    module = FirstRow()
    data = build_onnx_from_module(module, (16, 96), 2)
    assert "FIXED batch_size=1" in " ".join(capsys.readouterr().out.split())
    assert _dims(data) == (1, (1, 2))
    x = _features(1, (1, 16, 96))
    np.testing.assert_allclose(onnx_eval.run(data, {"features": x})["score"],
                               _module_scores(module, x), atol=ONNX_TOL)


def test_custom_onnx_is_written_and_served(tmp_path):
    """`build_onnx` no longer returns None for `custom`: the artifact
    exporter writes the graph and the interpreter serves it."""
    model, cfg = _custom_model(tmp_path)
    data = build_onnx(model)
    assert data is not None and _dims(data)[0] == "batch_size"
    path = export_onnx_model(model, (16, 96), cfg, "c", str(tmp_path))
    assert path == str(tmp_path / "c.onnx")
    feats = _features(5, (9, 16, 96))
    want = _module_scores(model.module, feats)[:, 0]
    got = _OnnxSession(path, "cpu").run_batch(feats)
    np.testing.assert_allclose(got, want, atol=ONNX_TOL)
    interp = NanoInterpreter.load_model(path, device="cpu")
    clip = np.random.default_rng(2).integers(-3000, 3000, 32000).astype(
        np.int16)
    scores = [r.score for r in interp.predict_clip(clip)]
    assert len(scores) == 25 and np.isfinite(scores).all()


# -- the torch counterparts of the jaxpr exporter's rules ---------------------

T, FEAT = 10, 12


class Body(nn.Module):
    """x -> body(x) [B, T', F'] -> a score from the mean over time."""

    def __init__(self, body):
        super().__init__()
        self.body = body
        self.mha = nn.MultiheadAttention(FEAT, 2, batch_first=True)
        self.norm = nn.LayerNorm(FEAT)
        self.pool = nn.AvgPool2d(3, 1, 1, count_include_pad=False)

    def forward(self, x):
        h = self.body(self, x).mean(dim=1)
        return (h * h).sum(dim=-1, keepdim=True) * 0.3


def _split_halves(m, x):
    a, b = x.chunk(2, dim=-1)
    c, d = torch.split(x, [5, 7], dim=-1)
    return torch.cat([b, a * 2, d, c], -1)


LOWERED = {
    "torch.softmax": lambda m, x: torch.softmax(x, -1) * x,
    "sdpa": lambda m, x: F.scaled_dot_product_attention(x, x, x * 2),
    "multihead_attention": lambda m, x: m.mha(x, x, x)[0],
    "multihead_attention_no_weights": lambda m, x: m.mha(
        x, x * 0.5, x, need_weights=False)[0] + x,
    "einsum": lambda m, x: torch.einsum("btf,bsf->bts", x, x) @ x,
    "chunk_split": _split_halves,
    "chunk_cat": lambda m, x: torch.cat(x.chunk(3, -1), -1) * 2,
    "unbind_stack": lambda m, x: torch.stack(x.unbind(1), 1) + torch.stack(
        torch.unbind(x, -1), -1),
    "stack_leading": lambda m, x: torch.stack([x, x * 2], 0).sum(0),
    "avg_pool1d": lambda m, x: F.avg_pool1d(x.transpose(1, 2), 2).transpose(
        1, 2),
    "avg_pool1d_padded": lambda m, x: F.avg_pool1d(
        x.transpose(1, 2), 3, 2, 1).transpose(1, 2),
    "avg_pool1d_padded_excluded": lambda m, x: F.avg_pool1d(
        x.transpose(1, 2), 3, 2, 1, count_include_pad=False).transpose(1, 2),
    "max_pool1d_padded": lambda m, x: F.max_pool1d(
        x.transpose(1, 2), 3, 2, padding=1).transpose(1, 2),
    "max_pool2d": lambda m, x: F.max_pool2d(x[:, None], 2)[:, 0],
    "avg_pool2d_module_padded": lambda m, x: m.pool(x[:, None])[:, 0],
    "argmax_one_hot": lambda m, x: x * (0.5 + F.one_hot(
        x.argmax(dim=-1), x.shape[-1])),
    "argmax_keepdim": lambda m, x: x + torch.argmax(x, 1, keepdim=True),
    "compares": lambda m, x: (x * (x > 0) + (x <= 0.5) * 2
                              + torch.ge(x, 0.1) - x.lt(0).float()
                              + (x == 0) + torch.eq(x, x)),
    "where": lambda m, x: torch.where(x > 0, x, 0.5 * x) + x.where(
        x < 1, x * 0),
    "clamp": lambda m, x: (x.clamp(-0.5, 0.5) + torch.clamp(x, min=0)
                           + torch.clip(x, max=0.2)),
    "rsqrt_var_square": lambda m, x: (
        (x - x.mean(-1, keepdim=True))
        * torch.rsqrt(x.var(-1, keepdim=True, unbiased=False) + 1e-5)
        + x.square() + x.var(1, keepdim=True) + torch.var(x, 2, True, True)),
    "layer_norm": lambda m, x: F.layer_norm(x, (FEAT,)) + F.layer_norm(
        x, (FEAT,), m.norm.weight, m.norm.bias, 1e-6),
    "max_min": lambda m, x: (x.max(dim=1, keepdim=True).values
                             + torch.min(x, 1)[0][:, None]
                             + torch.max(x, x * 2)),
    "flip": lambda m, x: x.flip(1) + torch.flip(x, [1, 2]),
    "list_index": lambda m, x: x[:, [0, x.shape[1] - 1, x.shape[1] // 2], :],
    "list_index_negative": lambda m, x: x[..., [-1, 0, 3]],
    "traced_slice": lambda m, x: x[:, : x.shape[1] // 2],
}
# ops that the numpy evaluator runs and the torch ONNX runtime does not (as
# the JAX package's onnx_jax.py does not): such graphs are not served
NOT_SERVED = {"argmax_one_hot": "ArgMax", "argmax_keepdim": "ArgMax",
              "flip": "Slice", "list_index": "Gather",
              "list_index_negative": "Gather"}


@pytest.mark.parametrize("name", sorted(LOWERED))
def test_op_lowers_at_a_dynamic_batch(name):
    module = Body(LOWERED[name]).eval()
    data = build_onnx_from_module(module, (T, FEAT), 1)
    assert _dims(data) == ("batch_size", ("batch_size", 1))
    for batch in (2, 7):
        x = _features(batch, (batch, T, FEAT))
        want = _module_scores(module, x)
        np.testing.assert_allclose(onnx_eval.run(data, {"features": x})[
            "score"], want, rtol=ONNX_TOL, atol=ONNX_TOL)
        runtime = OnnxTorchModel(data, device="cpu")
        if name in NOT_SERVED:
            with pytest.raises(NotImplementedError, match=NOT_SERVED[name]):
                runtime(x)
        else:
            np.testing.assert_allclose(runtime(x), want, rtol=ONNX_TOL,
                                       atol=ONNX_TOL)


UNSUPPORTED = {
    "causal sdpa": (lambda m, x: F.scaled_dot_product_attention(
        x, x, x, is_causal=True), "is_causal"),
    "masked sdpa": (lambda m, x: F.scaled_dot_product_attention(
        x, x, x, attn_mask=x @ x.transpose(1, 2) > 0), "mask"),
    "attention weights read": (lambda m, x: m.mha(x, x, x)[1] @ x,
                               "attention weights"),
    "max indices read": (lambda m, x: x + x.max(dim=1).indices[:, None, :],
                         "indices"),
    "one_hot without num_classes": (lambda m, x: x * F.one_hot(
        x.argmax(dim=-1))[..., :1], "num_classes"),
    "cumsum": (lambda m, x: torch.cumsum(x, 1), "cumsum"),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_form_is_named(name):
    body, what = UNSUPPORTED[name]
    with pytest.raises(ExportUnsupported, match=what):
        build_onnx_from_module(Body(body), (T, FEAT), 1)


def test_multihead_attention_needs_batch_first():
    class SeqFirst(nn.Module):
        def __init__(self):
            super().__init__()
            self.mha = nn.MultiheadAttention(FEAT, 2)

        def forward(self, x):
            return self.mha(x, x, x)[0].mean(dim=(1, 2))[:, None]

    with pytest.raises(ExportUnsupported, match="batch_first"):
        build_onnx_from_module(SeqFirst(), (T, FEAT), 1)


def test_argmax_over_the_batch_falls_back_to_batch_one(capsys):
    module = Body(lambda m, x: x + x.argmax(dim=0)[None]).eval()
    data = build_onnx_from_module(module, (T, FEAT), 1)
    out = " ".join(capsys.readouterr().out.split())
    assert "FIXED batch_size=1" in out and "argmax along the batch" in out
    assert _dims(data) == (1, (1, 1))
