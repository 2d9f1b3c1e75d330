"""A user's torch module -> an ONNX graph, by tracing it with torch.fx.

The counterpart of `nanowakeword_tpu/export/jaxpr_onnx.py`
(`build_onnx_from_module`), which lowers a flax module's jaxpr. A torch
module has no jaxpr: `torch.fx.symbolic_trace` records the forward as a
graph of `call_module`, `call_function` and `call_method` nodes, ShapeProp
runs it once at a sentinel batch to learn every node's shape, and each node
is lowered onto onnx_proto's nodes through onnx_export._GraphBuilder, as
the zoo's exporters are.

Dynamic batch: the trace runs at batch 509; a reshape whose target carries
509 in its leading dimension gets -1 there, so the graph accepts any batch.
The graph is validated against the module with the numpy evaluator
(onnx_eval.py) at batch 1 and 3; if that fails, the export falls back,
with a warning, to a fixed batch of 1, and raises if that fails too.

Lowered (what deterministic forward passes are made of): Linear, Conv1d,
Conv2d, BatchNorm (eval), LayerNorm over the last axis, max and average
pooling without padding, the activations, Dropout and Identity; elementwise
arithmetic, matmul, mean / sum / amax, reshape / view / flatten / squeeze /
unsqueeze, transpose / permute, cat, slicing getitem and constant pad.
Anything else raises ExportUnsupported with the op's name; such a model
still deploys through the `.nww` artifact.
"""

from __future__ import annotations

import copy
import operator
from typing import Dict, Optional

import numpy as np
import torch
import torch.fx
from torch import nn
from torch.fx.passes.shape_prop import ShapeProp

from nanowakeword_tpu_torch.export import onnx_proto as P
from nanowakeword_tpu_torch.export.onnx_export import _GraphBuilder
from nanowakeword_tpu_torch.utils.logger import print_warning

# the batch size of the trace: prime and large, so that no static dimension
# of a module is likely to equal it
SENTINEL_BATCH = 509
_RTOL, _ATOL = 1e-4, 1e-5      # validation against the module


class ExportUnsupported(NotImplementedError):
    """A traced op (or a module that does not trace) with no ONNX
    lowering."""


class _BatchBound(ExportUnsupported):
    """A lowering that exists only with a fixed batch."""


class _Scored(nn.Module):
    """The exported function: sigmoid(module(x) flattened per example)."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, x):
        logits = self.module(x)
        return torch.sigmoid(logits.reshape(logits.shape[0], -1))


class _Recorder(ShapeProp):
    """ShapeProp that also keeps every node's value (shapes, ints)."""

    def run_node(self, n):
        out = super().run_node(n)
        self.values[n] = out
        return out


_UNARY = {torch.relu: "Relu", nn.functional.relu: "Relu",
          torch.sigmoid: "Sigmoid", nn.functional.sigmoid: "Sigmoid",
          torch.tanh: "Tanh", nn.functional.tanh: "Tanh",
          torch.exp: "Exp", torch.log: "Log", torch.sqrt: "Sqrt",
          torch.abs: "Abs", torch.neg: "Neg", operator.neg: "Neg",
          torch.erf: "Erf"}
_UNARY_METHODS = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
                  "exp": "Exp", "log": "Log", "sqrt": "Sqrt", "abs": "Abs",
                  "neg": "Neg"}
_BINARY = {operator.add: "Add", torch.add: "Add", operator.sub: "Sub",
           torch.sub: "Sub", operator.mul: "Mul", torch.mul: "Mul",
           operator.truediv: "Div", torch.div: "Div",
           operator.matmul: "MatMul", torch.matmul: "MatMul",
           torch.bmm: "MatMul", operator.pow: "Pow", torch.pow: "Pow",
           torch.maximum: "Max", torch.minimum: "Min"}
_BINARY_METHODS = {"add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div",
                   "matmul": "MatMul", "pow": "Pow"}
_RESHAPES = {"reshape", "view", "flatten", "squeeze", "unsqueeze"}
_IDENTITY_METHODS = {"contiguous", "clone", "detach", "float"}
_REDUCE = {"mean": "ReduceMean", "sum": "ReduceSum", "amax": "ReduceMax"}


def _is_shape_value(value) -> bool:
    """Shapes, sizes and numbers: what a trace computes on the host."""
    if isinstance(value, (int, float)):
        return True
    return isinstance(value, (tuple, list)) and all(
        isinstance(v, int) for v in value)


def _op_name(node: torch.fx.Node, module=None) -> str:
    if node.op == "call_module":
        return type(module).__name__
    if node.op == "call_function":
        return getattr(node.target, "__name__", str(node.target))
    return f"Tensor.{node.target}"


class _Lowering:
    """One traced graph -> ONNX nodes on a _GraphBuilder."""

    def __init__(self, gm: torch.fx.GraphModule, values, dynamic: bool):
        self.gm, self.values, self.dynamic = gm, values, dynamic
        self.g = _GraphBuilder()
        self.env: Dict[torch.fx.Node, str] = {}
        self.modules = dict(gm.named_modules())

    # -- plumbing -------------------------------------------------------------

    def shape(self, node) -> tuple:
        return tuple(self.values[node].shape)

    def is_tensor(self, arg) -> bool:
        return (isinstance(arg, torch.fx.Node)
                and isinstance(self.values.get(arg), torch.Tensor))

    def read(self, arg) -> str:
        """A node's ONNX name, or a python number as a float32 scalar."""
        if isinstance(arg, torch.fx.Node):
            if arg in self.env:
                return self.env[arg]
            value = self.values.get(arg)
            if isinstance(value, (int, float)):
                return self.g.init_tensor("c", np.float32(value))
            raise ExportUnsupported(f"a non-tensor value ({arg.name}) feeds "
                                    "a tensor op")
        if isinstance(arg, (int, float)):
            return self.g.init_tensor("c", np.float32(arg))
        raise ExportUnsupported(f"constant argument {arg!r}")

    def target(self, shape) -> np.ndarray:
        """A static shape -> a Reshape target, the batch dim -> -1."""
        out = [int(d) for d in shape]
        if self.dynamic and out and out[0] == SENTINEL_BATCH:
            out[0] = -1
        return np.asarray(out, np.int64)

    def reshape(self, x: str, shape) -> str:
        return self.g.add("Reshape", [x, self.g.init_tensor(
            "shape", self.target(shape))])

    @staticmethod
    def axis(dim: int, ndim: int) -> int:
        return dim % ndim

    # -- the walk -------------------------------------------------------------

    def run(self) -> str:
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                self.env[node] = "features"
            elif node.op == "output":
                return self.read(node.args[0])
            elif node.op == "get_attr":
                value = self.values[node]
                if isinstance(value, torch.Tensor):
                    self.env[node] = self.g.init_tensor(
                        "attr", value.detach().float().numpy())
            elif node.op == "call_module":
                self.env[node] = self.call_module(node)
            elif self.is_tensor(node):
                self.env[node] = self.call(node)
            elif not _is_shape_value(self.values.get(node)):
                raise ExportUnsupported(
                    f"op {_op_name(node)} has no ONNX lowering (it returns "
                    f"{type(self.values.get(node)).__name__})")
        raise ExportUnsupported("the traced graph has no output")

    def call_module(self, node) -> str:
        m = self.modules[node.target]
        x = self.read(node.args[0])
        if isinstance(m, (nn.Dropout, nn.Identity)):
            return x
        if isinstance(m, nn.Linear):
            return self.linear(node.args[0], x, m.weight, m.bias)
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            return self.conv(node, x, m)
        if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            if m.running_mean is None:
                raise ExportUnsupported(
                    f"{type(m).__name__} without running statistics")
            c = m.num_features
            weight = (m.weight if m.weight is not None else torch.ones(c))
            bias = (m.bias if m.bias is not None else torch.zeros(c))
            return self.g.add("BatchNormalization", [
                x, *(self.g.init_tensor(h, t.detach().float().numpy())
                     for h, t in (("bn_scale", weight), ("bn_bias", bias),
                                  ("bn_mean", m.running_mean),
                                  ("bn_var", m.running_var)))],
                epsilon=float(m.eps))
        if isinstance(m, nn.LayerNorm):
            if len(m.normalized_shape) != 1:
                raise ExportUnsupported(
                    "LayerNorm over more than the last axis")
            c = m.normalized_shape[0]
            weight = m.weight if m.weight is not None else torch.ones(c)
            bias = m.bias if m.bias is not None else torch.zeros(c)
            return self.g.add("LayerNormalization", [
                x, self.g.init_tensor("ln_scale",
                                      weight.detach().float().numpy()),
                self.g.init_tensor("ln_bias", bias.detach().float().numpy())],
                axis=-1, epsilon=float(m.eps))
        if isinstance(m, (nn.MaxPool1d, nn.MaxPool2d, nn.AvgPool1d,
                          nn.AvgPool2d)):
            return self.pool(node, x, m)
        if isinstance(m, nn.Flatten):
            return self.reshape(x, self.shape(node))
        if isinstance(m, nn.Softmax):
            return self.g.add("Softmax", [x], axis=self.axis(
                m.dim, len(self.shape(node))))
        if isinstance(m, nn.GELU):
            return self.gelu(x, m.approximate)
        if isinstance(m, nn.SiLU):
            return self.g.swish(x)
        for cls, op in ((nn.ReLU, "Relu"), (nn.Sigmoid, "Sigmoid"),
                        (nn.Tanh, "Tanh")):
            if isinstance(m, cls):
                return self.g.add(op, [x])
        raise ExportUnsupported(
            f"module {node.target} ({_op_name(node, m)}) has no ONNX "
            "lowering")

    def linear(self, x_node, x: str, weight, bias) -> str:
        kernel = weight.detach().float().numpy().T.copy()    # [in, out]
        b = (bias.detach().float().numpy() if bias is not None
             else np.zeros(kernel.shape[1], np.float32))
        if len(self.shape(x_node)) == 2:
            return self.g.gemm(x, kernel, b, "fx_dense")
        return self.g.dense3d(x, kernel, b, "fx_dense")

    def conv(self, node, x: str, m) -> str:
        rank = 1 if isinstance(m, nn.Conv1d) else 2
        if m.padding_mode != "zeros":
            raise ExportUnsupported(f"{type(m).__name__} with padding_mode "
                                    f"'{m.padding_mode}'")
        if isinstance(m.padding, str):
            if m.padding == "valid":
                pad = [(0, 0)] * rank
            else:            # 'same' (stride 1): the odd pad goes at the end
                pad = []
                for k, d in zip(m.kernel_size, m.dilation):
                    total = d * (k - 1)
                    pad.append((total // 2, total - total // 2))
        else:
            pad = [(int(p), int(p)) for p in m.padding]
        pads = [lo for lo, _ in pad] + [hi for _, hi in pad]
        return self.g.conv(
            x, m.weight.detach().float().numpy(),
            None if m.bias is None else m.bias.detach().float().numpy(),
            "fx_conv", pads=pads, strides=list(m.stride),
            dilations=list(m.dilation), group=m.groups)

    def pool(self, node, x: str, m) -> str:
        rank = 1 if isinstance(m, (nn.MaxPool1d, nn.AvgPool1d)) else 2

        def pair(v):
            return [int(v)] * rank if isinstance(v, int) else [int(u) for u
                                                               in v]
        kernel = pair(m.kernel_size)
        stride = pair(m.stride if m.stride is not None else m.kernel_size)
        padding = pair(m.padding)
        if any(padding) or getattr(m, "ceil_mode", False) or any(
                d != 1 for d in pair(getattr(m, "dilation", 1))):
            raise ExportUnsupported(f"{type(m).__name__} with padding, "
                                    "ceil_mode or dilation")
        op = "MaxPool" if isinstance(m, (nn.MaxPool1d, nn.MaxPool2d)) \
            else "AveragePool"
        return self.g.add(op, [x], kernel_shape=kernel, strides=stride)

    def gelu(self, x: str, approximate: str) -> str:
        if approximate == "tanh":
            return self.g.activation(x, "gelu")
        # 0.5 x (1 + erf(x / sqrt 2))
        inner = self.g.add("Erf", [self.g.const_mul(x, 1.0 / np.sqrt(2.0))])
        one = self.g.init_tensor("c_one", np.float32(1.0))
        return self.g.add("Mul", [self.g.const_mul(x, 0.5),
                                  self.g.add("Add", [one, inner])])

    # -- functions and methods ---------------------------------------------------

    def call(self, node) -> str:
        fn, args, kw = node.target, node.args, node.kwargs
        method = node.op == "call_method"
        if not method and fn in _UNARY or method and fn in _UNARY_METHODS:
            op = _UNARY_METHODS[fn] if method else _UNARY[fn]
            return self.g.add(op, [self.read(args[0])])
        if not method and fn in _BINARY or method and fn in _BINARY_METHODS:
            op = _BINARY_METHODS[fn] if method else _BINARY[fn]
            if "alpha" in kw:
                raise ExportUnsupported(f"{_op_name(node)} with alpha")
            return self.g.add(op, [self.read(args[0]), self.read(args[1])])
        if method and fn in _IDENTITY_METHODS or fn is nn.functional.dropout:
            return self.read(args[0])
        if method and fn in _RESHAPES or fn in (torch.flatten,
                                                torch.reshape,
                                                torch.squeeze,
                                                torch.unsqueeze):
            return self.reshape(self.read(args[0]), self.shape(node))
        if method and fn in ("transpose", "permute") or fn in (
                torch.transpose, torch.permute):
            return self.transpose(node)
        if (method and fn in _REDUCE) or fn in (torch.mean, torch.sum,
                                                torch.amax):
            return self.reduce(node)
        if fn in (torch.cat, torch.concat):
            tensors = args[0]
            dim = kw.get("dim", args[1] if len(args) > 1 else 0)
            return self.g.add("Concat", [self.read(t) for t in tensors],
                              axis=self.axis(dim, len(self.shape(node))))
        if fn is operator.getitem:
            return self.getitem(node)
        if fn is nn.functional.pad:
            return self.pad(node)
        if fn is nn.functional.softmax or method and fn == "softmax":
            dim = kw.get("dim", args[1] if len(args) > 1 else None)
            return self.g.add("Softmax", [self.read(args[0])],
                              axis=self.axis(dim, len(self.shape(node))))
        if fn is nn.functional.gelu:
            return self.gelu(self.read(args[0]),
                             kw.get("approximate", "none"))
        if fn is nn.functional.silu:
            return self.g.swish(self.read(args[0]))
        if fn is nn.functional.linear:
            weight = self.values[args[1]]
            bias = self.values[args[2]] if len(args) > 2 else kw.get("bias")
            return self.linear(args[0], self.read(args[0]), weight,
                               bias if isinstance(bias, torch.Tensor)
                               else None)
        raise ExportUnsupported(f"op {_op_name(node)} has no ONNX lowering")

    def transpose(self, node) -> str:
        ndim = len(self.shape(node))
        args = node.args
        if node.target in ("permute", torch.permute):
            dims = args[1] if len(args) == 2 and isinstance(
                args[1], (list, tuple)) else args[1:]
            perm = [self.axis(d, ndim) for d in dims]
        else:
            a, b = (self.axis(d, ndim) for d in args[1:3])
            perm = list(range(ndim))
            perm[a], perm[b] = perm[b], perm[a]
        return self.g.add("Transpose", [self.read(args[0])], perm=perm)

    def reduce(self, node) -> str:
        op = _REDUCE[node.target if node.op == "call_method"
                     else node.target.__name__]
        x_node = node.args[0]
        ndim = len(self.shape(x_node))
        dim = node.kwargs.get("dim", node.args[1] if len(node.args) > 1
                              else None)
        keep = int(node.kwargs.get("keepdim", node.args[2]
                                   if len(node.args) > 2 else False))
        dims = (list(range(ndim)) if dim is None
                else [dim] if isinstance(dim, int) else list(dim))
        axes = [self.axis(d, ndim) for d in dims]
        x = self.read(x_node)
        if op == "ReduceSum":          # opset 13+: axes as an input
            return self.g.add(op, [x, self.g.init_tensor(
                "axes", np.asarray(axes, np.int64))], keepdims=keep)
        return self.g.add(op, [x], axes=axes, keepdims=keep)

    def getitem(self, node) -> str:
        x_node, index = node.args
        if not self.is_tensor(x_node):
            raise ExportUnsupported("indexing a non-tensor")
        in_shape = self.shape(x_node)
        index = index if isinstance(index, tuple) else (index,)
        if any(isinstance(i, torch.fx.Node) for i in index):
            raise ExportUnsupported("indexing by a tensor or a traced value")
        if Ellipsis in index:
            at = index.index(Ellipsis)
            fill = len(in_shape) - (len(index) - 1
                                    - sum(i is None for i in index))
            index = (index[:at] + (slice(None),) * fill + index[at + 1:])
        starts, ends, axes, steps = [], [], [], []
        dim = 0
        for i in index:
            if i is None:
                continue
            if isinstance(i, int):
                i = i % in_shape[dim]
                i = slice(i, i + 1, 1)
            if i != slice(None):
                start, stop, step = i.indices(in_shape[dim])
                if step <= 0:
                    raise ExportUnsupported("a slice with a negative step")
                starts.append(start)
                ends.append(stop)
                axes.append(dim)
                steps.append(step)
            dim += 1
        x = self.read(x_node)
        if axes:
            if self.dynamic and 0 in axes:
                raise _BatchBound("a slice along the batch axis")
            g = self.g
            x = g.add("Slice", [x] + [g.init_tensor(h, np.asarray(
                v, np.int64)) for h, v in (("sl_starts", starts),
                                           ("sl_ends", ends),
                                           ("sl_axes", axes),
                                           ("sl_steps", steps))])
        out_shape = self.shape(node)
        sliced = [e - s for s, e in zip(starts, ends)]
        if len(out_shape) != len(in_shape) or any(
                v != -(-sliced[k] // steps[k]) for k, v in enumerate(
                    out_shape[a] for a in axes)):
            x = self.reshape(x, out_shape)
        return x

    def pad(self, node) -> str:
        args, kw = node.args, node.kwargs
        width = list(kw.get("pad", args[1] if len(args) > 1 else ()))
        mode = kw.get("mode", args[2] if len(args) > 2 else "constant")
        value = kw.get("value", args[3] if len(args) > 3 else None) or 0.0
        if mode != "constant":
            raise ExportUnsupported(f"pad mode '{mode}'")
        ndim = len(self.shape(node))
        begins, ends = [0] * ndim, [0] * ndim
        for k in range(len(width) // 2):      # last dim first, as torch
            begins[ndim - 1 - k] = int(width[2 * k])
            ends[ndim - 1 - k] = int(width[2 * k + 1])
        if min(begins + ends) < 0:
            raise ExportUnsupported("negative padding")
        g = self.g
        return g.add("Pad", [self.read(args[0]), g.init_tensor(
            "pads", np.asarray(begins + ends, np.int64)),
            g.init_tensor("pad_value", np.float32(value))])


def _trace(module: nn.Module, input_shape, batch: int):
    """-> (the traced GraphModule of _Scored(module), every node's value)."""
    try:
        gm = torch.fx.symbolic_trace(_Scored(module))
    except Exception as e:  # noqa: BLE001 — any trace failure is unsupported
        raise ExportUnsupported(
            f"torch.fx cannot trace the module: {type(e).__name__}: "
            f"{e}") from e
    recorder = _Recorder(gm)
    recorder.values = {}
    x = torch.zeros((batch,) + tuple(input_shape))
    with torch.no_grad():
        recorder.propagate(x)
    return gm, recorder.values


def build_onnx_from_module(module: nn.Module, input_shape, n_classes: int,
                           name: str = "custom",
                           validate: bool = True) -> bytes:
    """Trace `sigmoid(module(x).reshape(B, -1))` in eval mode and lower it
    to an ONNX graph: input "features" [batch, *input_shape] -> output
    "score" [batch, n_classes]. A dynamic batch first, validated at batch 1
    and 3; a fixed batch of 1 as the loud fallback."""
    input_shape = tuple(int(d) for d in input_shape)
    module = copy.deepcopy(module).cpu().eval()

    def build(batch: int, dynamic: bool) -> bytes:
        gm, values = _trace(module, input_shape, batch)
        lowering = _Lowering(gm, values, dynamic)
        final = lowering.run()
        g = lowering.g
        g.nodes.append(P.node("Identity", [final], ["score"],
                              name="n_score"))
        batch_dim = "batch_size" if dynamic else 1
        graph = P.graph(
            g.nodes, name=f"{name}_custom",
            inputs=[P.value_info("features", (batch_dim,) + input_shape)],
            outputs=[P.value_info("score", (batch_dim, n_classes))],
            initializers=g.inits,
            doc="nanowakeword_tpu_torch custom-module export (torch.fx "
                "lowering)")
        return P.model(graph, opset=17,
                       doc="exported by nanowakeword_tpu_torch.export.fx_onnx")

    def check(data: bytes, batch: int) -> Optional[str]:
        """None when the graph matches the module; else the reason."""
        from nanowakeword_tpu_torch.export import onnx_eval
        x = np.random.default_rng(0).normal(
            0, 1, (batch,) + input_shape).astype(np.float32)
        with torch.no_grad():
            want = _Scored(module)(torch.from_numpy(x)).numpy()
        try:
            got = onnx_eval.run(data, {"features": x})["score"]
        except Exception as e:  # noqa: BLE001 — any failure means "not valid"
            return f"evaluator error at batch {batch}: {e}"
        if got.shape != want.shape:
            return (f"shape mismatch at batch {batch}: graph {got.shape} "
                    f"vs module {want.shape}")
        if not np.allclose(got, want, rtol=_RTOL, atol=_ATOL):
            return (f"numeric mismatch at batch {batch}: max abs diff "
                    f"{np.abs(got - want).max():.3e}")
        return None

    reason = None
    try:
        data = build(SENTINEL_BATCH, dynamic=True)
        if not validate:
            return data
        reason = check(data, 1) or check(data, 3)
        if reason is None:
            return data
    except _BatchBound as e:
        reason = f"unsupported for dynamic batch: {e}"
    print_warning(
        "Custom-module ONNX export falls back to a FIXED batch_size=1 "
        f"graph. Reason: {reason}")
    data = build(1, dynamic=False)
    if validate:
        fixed_reason = check(data, 1)
        if fixed_reason is not None:
            raise ExportUnsupported(
                f"custom module export failed validation: {fixed_reason}")
    return data
