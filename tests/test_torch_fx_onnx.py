"""A user's torch module -> ONNX through torch.fx (export/fx_onnx.py), on
the CPU: the graph against the module through the numpy evaluator and the
torch ONNX runtime, the dynamic batch, the fixed-batch fallback, an
unsupported op named, and the `custom` family through `build_onnx`, the
artifact exporter and the interpreter."""

import numpy as np
import pytest
import torch
from torch import nn

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
