"""A user's torch module -> an ONNX graph, by tracing it with torch.fx.

The counterpart of `nanowakeword_tpu/export/jaxpr_onnx.py`
(`build_onnx_from_module`), which lowers a flax module's jaxpr. A torch
module has no jaxpr: `torch.fx.symbolic_trace` records the forward as a
graph of `call_module`, `call_function` and `call_method` nodes, ShapeProp
runs it once at a sentinel batch to learn every node's shape, and each node
is lowered onto onnx_proto's nodes through onnx_export._GraphBuilder, as
the zoo's exporters are. Each rule emits the ONNX ops of the matching
jaxpr rule where the torch op has a counterpart there.

Dynamic batch: the trace runs at batch 509; a reshape whose target carries
509 gets -1 there, so the graph accepts any batch. The graph is validated
against the module with the numpy evaluator (onnx_eval.py) at batch 1 and
3; if that fails, the export falls back, with a warning, to a fixed batch
of 1, and raises if that fails too.

Lowered (what deterministic forward passes are made of): Linear, Conv1d,
Conv2d, BatchNorm (eval), LayerNorm and `F.layer_norm` over the last axis,
max and average pooling as modules or functions (padding kept, with
`count_include_pad`), nn.MultiheadAttention (batch_first, no masks; its
first output) and `F.scaled_dot_product_attention` (no mask, no dropout,
not causal), the activations, softmax, Dropout and Identity; elementwise
arithmetic, rsqrt, square, clamp, the compares (as 0/1 floats) and
`torch.where` (a blend), matmul, einsum, mean / sum / amax, max / min (the
values), var, argmax (as a float) and one_hot, reshape / view / flatten /
squeeze / unsqueeze, transpose / permute, flip, cat, stack, chunk / split /
unbind, slicing getitem, a constant list index on one axis (Gather) and
constant pad. Anything else raises ExportUnsupported with the op's name;
such a model still deploys through the `.nww` artifact. An op whose result
nothing reads is not lowered.
"""

from __future__ import annotations

import copy
import math
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

F = nn.functional

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


_UNARY = {torch.relu: "Relu", F.relu: "Relu",
          torch.sigmoid: "Sigmoid", F.sigmoid: "Sigmoid",
          torch.tanh: "Tanh", F.tanh: "Tanh",
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
# compares -> the ONNX compare + Cast to float, as the jaxpr's `_compare`
_COMPARE = {operator.gt: "Greater", torch.gt: "Greater",
            operator.lt: "Less", torch.lt: "Less",
            operator.ge: "GreaterOrEqual", torch.ge: "GreaterOrEqual",
            operator.le: "LessOrEqual", torch.le: "LessOrEqual",
            operator.eq: "Equal", torch.eq: "Equal"}
_COMPARE_METHODS = {"gt": "Greater", "lt": "Less", "ge": "GreaterOrEqual",
                    "le": "LessOrEqual", "eq": "Equal"}
_RESHAPES = {"reshape", "view", "flatten", "squeeze", "unsqueeze"}
_IDENTITY_METHODS = {"contiguous", "clone", "detach", "float"}
_REDUCE = {"mean": "ReduceMean", "sum": "ReduceSum", "amax": "ReduceMax"}
# the functional pools -> (ONNX op, spatial rank); then each op's
# arguments after the input, by name
_POOL_FUNCTIONS = {
    F.avg_pool1d: ("AveragePool", 1), F.avg_pool2d: ("AveragePool", 2),
    F.max_pool1d: ("MaxPool", 1), F.max_pool2d: ("MaxPool", 2)}
_POOL_ARGS = {
    "AveragePool": ("kernel_size", "stride", "padding", "ceil_mode",
                    "count_include_pad", "divisor_override"),
    "MaxPool": ("kernel_size", "stride", "padding", "dilation", "ceil_mode",
                "return_indices")}


def _is_shape_value(value) -> bool:
    """Shapes, sizes and numbers: what a trace computes on the host."""
    if isinstance(value, (int, float)):
        return True
    return isinstance(value, (tuple, list)) and all(
        isinstance(v, int) for v in value)


def _is_tensors(value) -> bool:
    """A tuple of tensors: chunk, split, unbind, max(dim)."""
    return isinstance(value, (tuple, list)) and bool(value) and all(
        isinstance(v, torch.Tensor) for v in value)


def _op_name(node: torch.fx.Node, module=None) -> str:
    if node.op == "call_module":
        return type(module).__name__
    if node.op == "call_function":
        return getattr(node.target, "__name__", str(node.target))
    return f"Tensor.{node.target}"


def _params(node: torch.fx.Node, names, skip: int = 0) -> dict:
    """A call's arguments after the first `skip`, by name."""
    out = dict(zip(names, node.args[skip:]))
    out.update(node.kwargs)
    return out


class _Lowering:
    """One traced graph -> ONNX nodes on a _GraphBuilder."""

    def __init__(self, gm: torch.fx.GraphModule, values, dynamic: bool):
        self.gm, self.values, self.dynamic = gm, values, dynamic
        self.g = _GraphBuilder()
        # a node's ONNX name; for a tuple-valued node, a list with one entry
        # per element (an ExportUnsupported where that element has none)
        self.env: Dict[torch.fx.Node, object] = {}
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
                if isinstance(self.env[arg], list):
                    raise ExportUnsupported(f"a tuple ({arg.name}) feeds a "
                                            "tensor op")
                return self.env[arg]
            value = self.values.get(arg)
            if isinstance(value, (int, float)):
                return self.g.init_tensor("c", np.float32(value))
            raise ExportUnsupported(f"a non-tensor value ({arg.name}) feeds "
                                    "a tensor op")
        if isinstance(arg, (int, float)):
            return self.g.init_tensor("c", np.float32(arg))
        raise ExportUnsupported(f"constant argument {arg!r}")

    def read_all(self, arg) -> list:
        """A list of tensors, or a tuple-valued node, -> their names."""
        if isinstance(arg, torch.fx.Node) and isinstance(self.env.get(arg),
                                                         list):
            return [self.pick(arg, i) for i in range(len(self.env[arg]))]
        return [self.read(t) for t in arg]

    def pick(self, node, i) -> str:
        """Element `i` of a tuple-valued node."""
        if not isinstance(i, int):
            raise ExportUnsupported(f"indexing a tuple by {i!r}")
        out = self.env[node][i]
        if isinstance(out, ExportUnsupported):
            raise out
        return out

    def const(self, arg):
        """A traced host value (sizes, and python arithmetic on them) ->
        its value, through lists, tuples and slices."""
        if isinstance(arg, torch.fx.Node):
            value = self.values.get(arg)
            if isinstance(value, torch.Tensor):
                raise ExportUnsupported("indexing by a tensor or a traced "
                                        "value")
            return value
        if isinstance(arg, (list, tuple)):
            return type(arg)(self.const(a) for a in arg)
        if isinstance(arg, slice):
            return slice(self.const(arg.start), self.const(arg.stop),
                         self.const(arg.step))
        return arg

    def target(self, shape) -> np.ndarray:
        """A static shape -> a Reshape target, the batch dim -> -1."""
        out = [int(d) for d in shape]
        if self.dynamic and out.count(SENTINEL_BATCH) == 1:
            out[out.index(SENTINEL_BATCH)] = -1
        return np.asarray(out, np.int64)

    def reshape(self, x: str, shape) -> str:
        return self.g.add("Reshape", [x, self.g.init_tensor(
            "shape", self.target(shape))])

    def batch_bound(self, shape, axes, what: str) -> None:
        """`what` along the batch axis exists only with a fixed batch."""
        if self.dynamic and any(shape[a] == SENTINEL_BATCH for a in axes):
            raise _BatchBound(f"{what} along the batch axis")

    def slice(self, x: str, starts, ends, axes, steps) -> str:
        g = self.g
        return g.add("Slice", [x] + [g.init_tensor(h, np.asarray(
            v, np.int64)) for h, v in (("sl_starts", starts),
                                       ("sl_ends", ends), ("sl_axes", axes),
                                       ("sl_steps", steps))])

    def as_float(self, x: str) -> str:
        return self.g.add("Cast", [x], to=P.FLOAT)

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
            elif not node.users:
                continue                    # nothing reads it
            elif node.op == "get_attr":
                value = self.values[node]
                if isinstance(value, torch.Tensor):
                    self.env[node] = self.g.init_tensor(
                        "attr", value.detach().float().numpy())
            elif node.op == "call_module":
                self.env[node] = self.call_module(node)
            elif self.is_tensor(node):
                self.env[node] = self.call(node)
            elif _is_tensors(self.values.get(node)):
                self.env[node] = self.call_tuple(node)
            elif not _is_shape_value(self.values.get(node)):
                raise ExportUnsupported(
                    f"op {_op_name(node)} has no ONNX lowering (it returns "
                    f"{type(self.values.get(node)).__name__})")
        raise ExportUnsupported("the traced graph has no output")

    def call_module(self, node):
        m = self.modules[node.target]
        if isinstance(m, nn.MultiheadAttention):
            return self.multihead_attention(node, m)
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
            return self.layer_norm(node.args[0], m.normalized_shape,
                                   m.weight, m.bias, m.eps)
        if isinstance(m, (nn.MaxPool1d, nn.MaxPool2d, nn.AvgPool1d,
                          nn.AvgPool2d)):
            op = "MaxPool" if isinstance(m, (nn.MaxPool1d, nn.MaxPool2d)) \
                else "AveragePool"
            rank = 1 if isinstance(m, (nn.MaxPool1d, nn.AvgPool1d)) else 2
            return self.pool(x, op, rank, {
                k: getattr(m, k) for k in _POOL_ARGS[op] if hasattr(m, k)},
                type(m).__name__)
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

    def layer_norm(self, x_node, normalized_shape, weight, bias,
                   eps) -> str:
        """nn.LayerNorm and F.layer_norm over the last axis; weight and
        bias are parameters, traced tensors or None."""
        c = self.shape(x_node)[-1]
        if tuple(normalized_shape) != (c,):
            raise ExportUnsupported("LayerNorm over more than the last axis")

        def operand(t, hint, fill):
            if isinstance(t, torch.fx.Node):
                return self.read(t)
            t = torch.full((c,), fill) if t is None else t
            return self.g.init_tensor(hint, t.detach().float().numpy())
        return self.g.add("LayerNormalization", [
            self.read(x_node), operand(weight, "ln_scale", 1.0),
            operand(bias, "ln_bias", 0.0)], axis=-1, epsilon=float(eps))

    def pool(self, x: str, op: str, rank: int, p: dict, what: str) -> str:
        """Max and average pooling, module or function: the padding as
        given, AveragePool's divisor by `count_include_pad`."""
        def per_axis(v):
            return [int(v)] * rank if isinstance(v, int) else [int(u) for u
                                                               in v]
        kernel = per_axis(p["kernel_size"])
        stride = per_axis(p.get("stride") or p["kernel_size"])
        padding = per_axis(p.get("padding", 0))
        if (p.get("ceil_mode") or p.get("divisor_override") is not None
                or p.get("return_indices")
                or any(d != 1 for d in per_axis(p.get("dilation", 1)))):
            raise ExportUnsupported(f"{what} with ceil_mode, dilation, "
                                    "divisor_override or return_indices")
        attrs = dict(kernel_shape=kernel, strides=stride)
        if any(padding):
            attrs["pads"] = padding + padding
            if op == "AveragePool":
                attrs["count_include_pad"] = int(p.get("count_include_pad",
                                                       True))
        return self.g.add(op, [x], **attrs)

    def gelu(self, x: str, approximate: str) -> str:
        if approximate == "tanh":
            return self.g.activation(x, "gelu")
        # 0.5 x (1 + erf(x / sqrt 2))
        inner = self.g.add("Erf", [self.g.const_mul(x, 1.0 / np.sqrt(2.0))])
        one = self.g.init_tensor("c_one", np.float32(1.0))
        return self.g.add("Mul", [self.g.const_mul(x, 0.5),
                                  self.g.add("Add", [one, inner])])

    def attention(self, q: str, k: str, v: str, rank: int,
                  scale: float) -> str:
        """softmax(q k^T * scale) v over the last two axes."""
        perm = list(range(rank))
        perm[-2], perm[-1] = perm[-1], perm[-2]
        g = self.g
        scores = g.const_mul(g.add("MatMul", [
            q, g.add("Transpose", [k], perm=perm)]), scale)
        weights = g.add("Softmax", [scores], axis=rank - 1)
        return g.add("MatMul", [weights, v])

    def multihead_attention(self, node, m) -> list:
        """nn.MultiheadAttention (batch_first, no masks) from its
        in_proj_weight / in_proj_bias and out_proj -> [the output, the
        attention weights unlowered]."""
        p = _params(node, ("query", "key", "value", "key_padding_mask",
                           "need_weights", "attn_mask",
                           "average_attn_weights", "is_causal"))
        if (not m.batch_first or not m._qkv_same_embed_dim
                or m.bias_k is not None or m.add_zero_attn
                or p.get("key_padding_mask") is not None
                or p.get("attn_mask") is not None or p.get("is_causal")
                or len(self.shape(p["query"])) != 3):
            raise ExportUnsupported(
                f"module {node.target} (MultiheadAttention) other than "
                "batch_first=True on [batch, time, embed] without masks")
        e, h = m.embed_dim, m.num_heads
        d = e // h
        weight = m.in_proj_weight.detach().float().numpy()
        bias = (None if m.in_proj_bias is None
                else m.in_proj_bias.detach().float().numpy())

        def heads(arg, i):              # [B, T, E] -> [B, H, T, d]
            b, t, _ = self.shape(arg)
            y = self.g.dense3d(
                self.read(arg), weight[i * e:(i + 1) * e].T.copy(),
                None if bias is None else bias[i * e:(i + 1) * e],
                "fx_mha_in")
            return self.g.add("Transpose", [self.reshape(y, (b, t, h, d))],
                              perm=[0, 2, 1, 3])
        out = self.attention(heads(p["query"], 0), heads(p["key"], 1),
                             heads(p["value"], 2), 4, 1.0 / math.sqrt(d))
        b, t, _ = self.shape(p["query"])
        out = self.reshape(self.g.add("Transpose", [out], perm=[0, 2, 1, 3]),
                           (b, t, e))
        out_proj = m.out_proj
        out = self.g.dense3d(
            out, out_proj.weight.detach().float().numpy().T.copy(),
            None if out_proj.bias is None
            else out_proj.bias.detach().float().numpy(), "fx_mha_out")
        return [out, ExportUnsupported(
            f"the attention weights of {node.target} (MultiheadAttention) "
            "are read")]

    # -- functions and methods ---------------------------------------------------

    def call(self, node) -> str:
        fn, args, kw = node.target, node.args, node.kwargs
        method = node.op == "call_method"
        g = self.g
        if not method and fn in _UNARY or method and fn in _UNARY_METHODS:
            op = _UNARY_METHODS[fn] if method else _UNARY[fn]
            return g.add(op, [self.read(args[0])])
        if not method and fn in _BINARY or method and fn in _BINARY_METHODS:
            op = _BINARY_METHODS[fn] if method else _BINARY[fn]
            if "alpha" in kw:
                raise ExportUnsupported(f"{_op_name(node)} with alpha")
            return g.add(op, [self.read(args[0]), self.read(args[1])])
        if not method and fn in _COMPARE or method and fn in _COMPARE_METHODS:
            op = _COMPARE_METHODS[fn] if method else _COMPARE[fn]
            return self.as_float(g.add(op, [self.read(args[0]),
                                            self.read(args[1])]))
        if method and fn in _IDENTITY_METHODS or fn is F.dropout:
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
        if method and fn in ("max", "min") or fn in (torch.max, torch.min):
            return self.max_min(node)
        if method and fn == "var" or fn is torch.var:
            return self.var(node)
        if method and fn == "argmax" or fn is torch.argmax:
            return self.argmax(node)
        if fn is F.one_hot:
            return self.one_hot(node)
        if fn is torch.where or method and fn == "where":
            return self.where(node)
        if method and fn in ("clamp", "clip") or fn in (torch.clamp,
                                                        torch.clip):
            p = _params(node, ("min", "max"), skip=1)
            y = self.read(args[0])
            if p.get("min") is not None:
                y = g.add("Max", [y, self.read(p["min"])])
            if p.get("max") is not None:
                y = g.add("Min", [y, self.read(p["max"])])
            return y
        if method and fn == "rsqrt" or fn is torch.rsqrt:
            return g.add("Reciprocal", [g.add("Sqrt", [self.read(args[0])])])
        if method and fn == "square" or fn is torch.square:
            x = self.read(args[0])
            return g.add("Mul", [x, x])
        if method and fn == "flip" or fn is torch.flip:
            return self.flip(node)
        if fn in (torch.cat, torch.concat):
            dim = kw.get("dim", args[1] if len(args) > 1 else 0)
            return g.add("Concat", self.read_all(args[0]),
                         axis=self.axis(dim, len(self.shape(node))))
        if fn is torch.stack:
            return self.stack(node)
        if fn is torch.einsum:
            operands = (args[1] if len(args) == 2
                        and isinstance(args[1], (list, tuple)) else args[1:])
            return g.add("Einsum", [self.read(t) for t in operands],
                         equation=args[0].replace(" ", ""))
        if fn is operator.getitem:
            return self.getitem(node)
        if fn is getattr and isinstance(self.env.get(args[0]), list):
            if args[1] not in ("values", "indices"):
                raise ExportUnsupported(f"attribute {args[1]!r} of a tuple")
            return self.pick(args[0], int(args[1] == "indices"))
        if fn is F.pad:
            return self.pad(node)
        if fn in (F.softmax, torch.softmax) or method and fn == "softmax":
            dim = kw.get("dim", args[1] if len(args) > 1 else None)
            return g.add("Softmax", [self.read(args[0])],
                         axis=self.axis(dim, len(self.shape(node))))
        if fn is F.scaled_dot_product_attention:
            return self.scaled_dot_product_attention(node)
        if fn in _POOL_FUNCTIONS:
            op, rank = _POOL_FUNCTIONS[fn]
            return self.pool(self.read(args[0]), op, rank,
                             _params(node, _POOL_ARGS[op], skip=1),
                             _op_name(node))
        if fn is F.layer_norm:
            p = _params(node, ("normalized_shape", "weight", "bias", "eps"),
                        skip=1)
            return self.layer_norm(args[0], p["normalized_shape"],
                                   p.get("weight"), p.get("bias"),
                                   p.get("eps", 1e-5))
        if fn is F.gelu:
            return self.gelu(self.read(args[0]),
                             kw.get("approximate", "none"))
        if fn is F.silu:
            return g.swish(self.read(args[0]))
        if fn is F.linear:
            weight = self.values[args[1]]
            bias = self.values[args[2]] if len(args) > 2 else kw.get("bias")
            return self.linear(args[0], self.read(args[0]), weight,
                               bias if isinstance(bias, torch.Tensor)
                               else None)
        raise ExportUnsupported(f"op {_op_name(node)} has no ONNX lowering")

    def call_tuple(self, node) -> list:
        """An op that returns a tuple of tensors -> one entry per element."""
        fn, method = node.target, node.op == "call_method"
        if method and fn in ("chunk", "split", "unbind") or fn in (
                torch.chunk, torch.split, torch.unbind):
            return self.split(node)
        if method and fn in ("max", "min") or fn in (torch.max, torch.min):
            # (values, indices) along one dim; the indices have no lowering
            p = _params(node, ("dim", "keepdim"), skip=1)
            ndim = len(self.shape(node.args[0]))
            ax = self.axis(p["dim"], ndim)
            self.batch_bound(self.shape(node.args[0]), [ax], _op_name(node))
            op = "ReduceMax" if getattr(fn, "__name__", fn) == "max" \
                else "ReduceMin"
            values = self.g.add(op, [self.read(node.args[0])], axes=[ax],
                                keepdims=int(bool(p.get("keepdim", False))))
            return [values, ExportUnsupported(
                f"the indices of {_op_name(node)} are read")]
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

    def max_min(self, node) -> str:
        """max / min of two tensors (Max, Min), or over every axis."""
        x_node, args = node.args[0], node.args[1:]
        other = node.kwargs.get("other", args[0] if args else None)
        op = "Max" if getattr(node.target, "__name__",
                              node.target) == "max" else "Min"
        if self.is_tensor(other):
            return self.g.add(op, [self.read(x_node), self.read(other)])
        shape = self.shape(x_node)
        self.batch_bound(shape, range(len(shape)), _op_name(node))
        return self.g.add(f"Reduce{op}", [self.read(x_node)],
                          axes=list(range(len(shape))), keepdims=0)

    def var(self, node) -> str:
        """Variance from ReduceMean, Sub and Mul, scaled by torch's
        correction n / (n - correction)."""
        x_node, args, kw = node.args[0], node.args[1:], node.kwargs
        if args and isinstance(args[0], bool):        # var(x, unbiased)
            args = (None,) + args
        p = dict(zip(("dim", "unbiased", "keepdim"), args))
        p.update(kw)
        correction = p.get("correction")
        if correction is None:
            correction = int(p.get("unbiased", True))
        shape = self.shape(x_node)
        dim = p.get("dim")
        dims = (range(len(shape)) if dim is None
                else [dim] if isinstance(dim, int) else dim)
        axes = [self.axis(d, len(shape)) for d in dims]
        self.batch_bound(shape, axes, _op_name(node))
        n = int(np.prod([shape[a] for a in axes]))
        if n <= correction:
            raise ExportUnsupported(f"{_op_name(node)} with a correction "
                                    f"({correction}) of {n} elements or more")
        g = self.g
        x = self.read(x_node)
        centred = g.add("Sub", [x, g.add("ReduceMean", [x], axes=axes,
                                         keepdims=1)])
        out = g.add("ReduceMean", [g.add("Mul", [centred, centred])],
                    axes=axes, keepdims=int(bool(p.get("keepdim", False))))
        return g.const_mul(out, n / (n - correction)) if correction else out

    def argmax(self, node) -> str:
        """ArgMax along one dim + Cast to float, as the jaxpr's p_argmax."""
        p = _params(node, ("dim", "keepdim"), skip=1)
        if p.get("dim") is None:
            raise ExportUnsupported(f"{_op_name(node)} over every axis")
        shape = self.shape(node.args[0])
        ax = self.axis(p["dim"], len(shape))
        self.batch_bound(shape, [ax], "argmax")
        return self.as_float(self.g.add(
            "ArgMax", [self.read(node.args[0])], axis=ax,
            keepdims=int(bool(p.get("keepdim", False)))))

    def one_hot(self, node) -> str:
        """Equal against a constant arange(n) + Cast, as the jaxpr of
        jax.nn.one_hot."""
        n = self.const(_params(node, ("num_classes",), skip=1).get(
            "num_classes", -1))
        if n < 0:
            raise ExportUnsupported("one_hot without num_classes")
        idx = node.args[0]
        column = self.reshape(self.read(idx), self.shape(idx) + (1,))
        return self.as_float(self.g.add("Equal", [
            column, self.g.init_tensor("arange",
                                       np.arange(n, dtype=np.float32))]))

    def where(self, node) -> str:
        """where(c, a, b) -> c a + (1 - c) b, as the jaxpr's p_select_n."""
        p = _params(node, ("input", "condition", "other")
                    if node.op == "call_method"          # a.where(c, b)
                    else ("condition", "input", "other"))
        if len(p) != 3:
            raise ExportUnsupported("torch.where(condition) alone")
        g = self.g
        c = self.read(p["condition"])
        one = g.init_tensor("one", np.float32(1.0))
        return g.add("Add", [
            g.add("Mul", [c, self.read(p["input"])]),
            g.add("Mul", [g.add("Sub", [one, c]), self.read(p["other"])])])

    def flip(self, node) -> str:
        """Slice with step -1 on each flipped axis."""
        dims = node.kwargs.get("dims", node.args[1] if len(node.args) == 2
                               else node.args[1:])
        dims = [dims] if isinstance(dims, int) else list(dims)
        shape = self.shape(node)
        axes = [self.axis(d, len(shape)) for d in dims]
        self.batch_bound(shape, axes, "flip")
        k = len(axes)
        return self.slice(self.read(node.args[0]), [-1] * k,
                          [np.iinfo(np.int64).min] * k, axes, [-1] * k)

    def split(self, node) -> list:
        """chunk / split / unbind -> one Slice per part (unbind: then a
        Reshape that drops the axis)."""
        unbind = getattr(node.target, "__name__", node.target) == "unbind"
        names = ("dim",) if unbind else ("sizes", "dim")
        x_node = node.args[0]
        shape = self.shape(x_node)
        ax = self.axis(_params(node, names, skip=1).get("dim", 0),
                       len(shape))
        self.batch_bound(shape, [ax], _op_name(node))
        x = self.read(x_node)
        out, start = [], 0
        for part in self.values[node]:
            size = 1 if unbind else part.shape[ax]
            y = self.slice(x, [start], [start + size], [ax], [1])
            out.append(self.reshape(y, part.shape) if unbind else y)
            start += size
        return out

    def stack(self, node) -> str:
        """Each tensor reshaped with the new axis, then Concat."""
        dim = _params(node, ("tensors", "dim")).get("dim", 0)
        shape = self.shape(node)
        ax = self.axis(dim, len(shape))
        one = shape[:ax] + (1,) + shape[ax + 1:]
        return self.g.add("Concat", [self.reshape(x, one) for x in
                                     self.read_all(node.args[0])], axis=ax)

    def scaled_dot_product_attention(self, node) -> str:
        p = _params(node, ("query", "key", "value", "attn_mask", "dropout_p",
                           "is_causal", "scale", "enable_gqa"))
        if (p.get("attn_mask") is not None or p.get("dropout_p", 0.0)
                or p.get("is_causal") or p.get("enable_gqa")):
            raise ExportUnsupported(
                "scaled_dot_product_attention with a mask, dropout, "
                "is_causal or enable_gqa")
        rank = len(self.shape(p["key"]))
        scale = p.get("scale")
        if scale is None:
            scale = 1.0 / math.sqrt(self.shape(p["query"])[-1])
        return self.attention(self.read(p["query"]), self.read(p["key"]),
                              self.read(p["value"]), rank, scale)

    def getitem(self, node) -> str:
        """Slices, ints, None and Ellipsis -> Slice (+ Reshape); a
        constant list of ints on one axis -> Gather, as the jaxpr's
        p_gather. torch rejects an entry out of range when the trace runs,
        so no Clip is needed; negative entries are wrapped."""
        x_node, index = node.args
        if isinstance(self.env.get(x_node), list):
            return self.pick(x_node, self.const(index))
        if not self.is_tensor(x_node):
            raise ExportUnsupported("indexing a non-tensor")
        in_shape = self.shape(x_node)
        index = self.const(index)
        index = index if isinstance(index, tuple) else (index,)
        if any(i is Ellipsis for i in index):
            at = [i is Ellipsis for i in index].index(True)
            fill = len(in_shape) - (len(index) - 1
                                    - sum(i is None for i in index))
            index = (index[:at] + (slice(None),) * fill + index[at + 1:])
        lists = [i for i in index if isinstance(i, list)]
        if len(lists) > 1:
            raise ExportUnsupported("index lists on two axes")
        if lists and any(isinstance(i, int) for i in index):
            raise ExportUnsupported("an index list beside an integer index")
        starts, ends, axes, steps = [], [], [], []
        gather = None
        mid = list(in_shape)
        dim = 0
        for i in index:
            if i is None:
                continue
            if isinstance(i, list):
                if not i or not all(isinstance(v, int)
                                    and not isinstance(v, bool) for v in i):
                    raise ExportUnsupported(
                        "an index list that is not of integers (a mask?)")
                gather = (dim, [v + in_shape[dim] if v < 0 else v
                                for v in i])
                mid[dim] = len(i)
                dim += 1
                continue
            if isinstance(i, bool) or not isinstance(i, (int, slice)):
                raise ExportUnsupported(f"index {i!r}")
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
                mid[dim] = len(range(start, stop, step))
            dim += 1
        x = self.read(x_node)
        if gather is not None:
            ax, indices = gather
            self.batch_bound(in_shape, [ax], "a gather")
            x = self.g.add("Gather", [x, self.g.init_tensor(
                "gather_idx", np.asarray(indices, np.int64))], axis=ax)
        if axes:
            self.batch_bound(in_shape, axes, "a slice")
            x = self.slice(x, starts, ends, axes, steps)
        out_shape = self.shape(node)
        if tuple(mid) != out_shape:
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
