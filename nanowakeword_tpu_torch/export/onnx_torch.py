"""ONNX graph -> torch ops on one device (the port's ONNX runtime).

The counterpart of `nanowakeword_tpu/export/onnx_jax.py`: the graph is
parsed by the bundled protobuf reader (onnx_proto.py) and run node by node
as torch ops on the session's device, so NanoInterpreter and the server
load `.onnx` files as the reference loads them through onnxruntime. Each
node is the library call of its op (a `Conv` node is `F.conv2d`, a `Gemm`
node a matmul); this runtime is an interpreter over ONNX nodes, not the
counterpart of a TPU kernel.

Supported ops: every op of onnx_jax.py, which covers everything
onnx_export.py and export/frontend.py emit (Gemm/Conv/MaxPool/
LayerNormalization/BatchNormalization/activations/shape ops/MatMul/
Softmax/Concat/DequantizeLinear/Einsum/Erf, and native GRU/LSTM in both
directions with `initial_h` / `initial_c`). An unknown op raises
NotImplementedError naming it.

Device rules:
* initializers become device tensors once, when the model is built;
* shape-bearing inputs (Reshape shapes, Slice starts/ends/axes/steps, Pad
  pads and value, Expand shapes, ReduceSum axes) must be initializers, and
  are read from their numpy copies on the host: no node reads a device
  tensor back, and the only host copies are the outputs `run` and
  `__call__` return;
* GRU and LSTM nodes are Python loops over T (onnx_jax.py's `lax.scan`),
  in ONNX gate order (z,r,h) and (i,o,f,c), with `linear_before_reset`;
* `Conv` nodes run with cuDNN's TF32 off (utils/precision.py), which would
  otherwise keep about 3 digits; MatMul and Gemm stay at PyTorch's default
  (TF32 off for matmuls).
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch
import torch.nn.functional as F

from nanowakeword_tpu_torch.export import onnx_proto as P
from nanowakeword_tpu_torch.utils.precision import no_tf32_convs


def _conv(x, w, b, pads, strides, dilations, group):
    """ONNX Conv on NCL / NCHW input; asymmetric pads are padded first."""
    rank = x.ndim - 2
    if rank == 1:
        lo, hi = int(pads[0]), int(pads[1])
        x = F.pad(x, (lo, hi))
        return F.conv1d(x, w, b, stride=int(strides[0]),
                        dilation=int(dilations[0]), groups=int(group))
    pt, pl_, pb, pr = (int(p) for p in pads)
    x = F.pad(x, (pl_, pr, pt, pb))
    return F.conv2d(x, w, b, stride=tuple(int(s) for s in strides),
                    dilation=tuple(int(d) for d in dilations),
                    groups=int(group))


def _maxpool(x, kernel, strides):
    """ONNX MaxPool without padding (VALID), over 1 or 2 spatial dims."""
    if x.ndim == 3:
        return F.max_pool1d(x, int(kernel[0]), int(strides[0]))
    return F.max_pool2d(x, tuple(int(k) for k in kernel),
                        tuple(int(s) for s in strides))


def _avgpool(x, kernel, strides):
    """ONNX AveragePool without padding (VALID), over 1 or 2 spatial
    dims."""
    if x.ndim == 3:
        return F.avg_pool1d(x, int(kernel[0]), int(strides[0]))
    return F.avg_pool2d(x, tuple(int(k) for k in kernel),
                        tuple(int(s) for s in strides))


def _gru_dir(X, W, R, B, linear_before_reset, h0=None):
    """One direction of an ONNX GRU ((z,r,h) gate order), a loop over T."""
    H = R.shape[1]
    Wb, Rb = B[:3 * H], B[3 * H:]
    xg = torch.matmul(X, W.t()) + Wb                   # [T, N, 3H]
    h = (X.new_zeros(X.shape[1], H) if h0 is None else h0)
    ys = []
    for t in range(X.shape[0]):
        xt = xg[t]
        hg = torch.matmul(h, R.t())
        z = torch.sigmoid(xt[:, :H] + hg[:, :H] + Rb[:H])
        r = torch.sigmoid(xt[:, H:2 * H] + hg[:, H:2 * H] + Rb[H:2 * H])
        if linear_before_reset:
            n = torch.tanh(xt[:, 2 * H:] + r * (hg[:, 2 * H:] + Rb[2 * H:]))
        else:
            n = torch.tanh(xt[:, 2 * H:] + torch.matmul(r * h, R[2 * H:].t())
                           + Rb[2 * H:])
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys)


def _lstm_dir(X, W, R, B, h0=None, c0=None):
    """One direction of an ONNX LSTM ((i,o,f,c) gate order), a loop over T
    -> (Y [T, N, H], final cell state [N, H])."""
    H = R.shape[1]
    Wb, Rb = B[:4 * H], B[4 * H:]
    xg = torch.matmul(X, W.t()) + (Wb + Rb)
    h = X.new_zeros(X.shape[1], H) if h0 is None else h0
    c = X.new_zeros(X.shape[1], H) if c0 is None else c0
    ys = []
    for t in range(X.shape[0]):
        gates = xg[t] + torch.matmul(h, R.t())
        i = torch.sigmoid(gates[:, :H])
        o = torch.sigmoid(gates[:, H:2 * H])
        f = torch.sigmoid(gates[:, 2 * H:3 * H])
        g = torch.tanh(gates[:, 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys), c


def _rnn_node(op, x, attrs):
    """GRU / LSTM node -> (Y [T, dirs, N, H], Y_h [dirs, N, H],
    Y_c [dirs, N, H] | None). The optional initial_h (and initial_c) come
    as the 5th / 6th present inputs (the empty sequence_lens is skipped)."""
    X, W, R, B = x[0], x[1], x[2], x[3]
    initial_h = x[4] if len(x) > 4 else None
    initial_c = x[5] if len(x) > 5 else None
    direction = attrs.get("direction", "forward")
    if isinstance(direction, bytes):
        direction = direction.decode()
    kw = {}
    if op == "GRU":
        kw["linear_before_reset"] = attrs.get("linear_before_reset", 0)
    dirs, finals, cells = [], [], []
    for d in range(W.shape[0]):
        reverse = d == 1 or direction == "reverse"
        Xd = X.flip(0) if reverse else X
        if initial_h is not None:
            kw["h0"] = initial_h[d]
        if op == "GRU":
            Y = _gru_dir(Xd, W[d], R[d], B[d], **kw)
        else:
            if initial_c is not None:
                kw["c0"] = initial_c[d]
            Y, c_fin = _lstm_dir(Xd, W[d], R[d], B[d], **kw)
            cells.append(c_fin)
        finals.append(Y[-1])                        # last processed state
        if reverse:
            Y = Y.flip(0)                           # align to input time
        dirs.append(Y)
    return (torch.stack(dirs, dim=1), torch.stack(finals, dim=0),
            torch.stack(cells, dim=0) if cells else None)


def _binary(fn):
    return lambda x, a: fn(x[0], x[1])


def _compare(fn):
    return lambda x, a: fn(x[0], x[1]).float()


def _reduce(fn):
    def run(x, a):
        return fn(x[0], dim=tuple(a["axes"]),
                  keepdim=bool(a.get("keepdims", 1)))
    return run


def _fold(fn):
    def run(x, a):
        y = x[0]
        for v in x[1:]:
            y = fn(y, v)
        return y
    return run


def _gemm(x, a):
    A, Bm = x[0], x[1]
    if a.get("transA", 0):
        A = A.t()
    if a.get("transB", 0):
        Bm = Bm.t()
    y = a.get("alpha", 1.0) * torch.matmul(A, Bm)
    if len(x) > 2:
        y = y + a.get("beta", 1.0) * x[2]
    return y


def _dequantize(x, a):
    """Weight-only per-axis symmetric form: (int8, scales[axis])."""
    w = x[0]
    axis = a.get("axis", 1) % w.ndim
    shape = [1] * w.ndim
    shape[axis] = -1
    return w.float() * x[1].reshape(shape)


def _flatten(x, a):
    axis = a.get("axis", 1)
    shape = x[0].shape
    return x[0].reshape(int(np.prod(shape[:axis] or (1,))), -1)


def _layer_norm(x, a):
    axis = a.get("axis", -1)
    eps = a.get("epsilon", 1e-5)
    v = x[0]
    mean = v.mean(dim=axis, keepdim=True)
    var = v.var(dim=axis, unbiased=False, keepdim=True)
    y = (v - mean) / torch.sqrt(var + eps)
    return y * x[1] + (x[2] if len(x) > 2 else 0.0)


def _conv_node(x, a):
    rank = x[0].ndim - 2
    with no_tf32_convs():
        return _conv(x[0], x[1], x[2] if len(x) > 2 else None,
                     a.get("pads", [0, 0] * rank),
                     a.get("strides", [1] * rank),
                     a.get("dilations", [1] * rank), a.get("group", 1))


def _batch_norm(x, a):
    scale, bias, mean, var = x[1:5]
    eps = a.get("epsilon", 1e-5)
    bshape = (1, -1) + (1,) * (x[0].ndim - 2)
    return ((x[0] - mean.reshape(bshape))
            / torch.sqrt(var.reshape(bshape) + eps)
            * scale.reshape(bshape) + bias.reshape(bshape))


def _einsum(x, a):
    eq = a["equation"]
    if isinstance(eq, bytes):
        eq = eq.decode()
    return torch.einsum(eq, *x)


# ops whose inputs are all device tensors: op -> fn(inputs, attrs)
_OPS = {
    "Gemm": _gemm,
    "MatMul": _binary(torch.matmul),
    "DequantizeLinear": _dequantize,
    "Relu": lambda x, a: torch.relu(x[0]),
    "Sigmoid": lambda x, a: torch.sigmoid(x[0]),
    "Tanh": lambda x, a: torch.tanh(x[0]),
    "Softmax": lambda x, a: torch.softmax(x[0], dim=a.get("axis", -1)),
    "Add": _binary(torch.add),
    "Sub": _binary(torch.sub),
    "Mul": _binary(torch.mul),
    "Div": _binary(torch.div),
    "Concat": lambda x, a: torch.cat(x, dim=a["axis"]),
    "Flatten": _flatten,
    "Transpose": lambda x, a: x[0].permute(*a["perm"]),
    "LayerNormalization": _layer_norm,
    "Conv": _conv_node,
    "MaxPool": lambda x, a: _maxpool(x[0], a["kernel_shape"],
                                     a.get("strides", a["kernel_shape"])),
    "AveragePool": lambda x, a: _avgpool(x[0], a["kernel_shape"],
                                         a.get("strides",
                                               a["kernel_shape"])),
    "BatchNormalization": _batch_norm,
    "ReduceMean": _reduce(torch.mean),
    "ReduceMax": _reduce(torch.amax),
    "ReduceMin": _reduce(torch.amin),
    "Einsum": _einsum,
    "Cast": lambda x, a: x[0].float(),
    "Exp": lambda x, a: torch.exp(x[0]),
    "Log": lambda x, a: torch.log(x[0]),
    "Erf": lambda x, a: torch.erf(x[0]),
    "Sqrt": lambda x, a: torch.sqrt(x[0]),
    "Reciprocal": lambda x, a: torch.reciprocal(x[0]),
    "Neg": lambda x, a: torch.neg(x[0]),
    "Abs": lambda x, a: torch.abs(x[0]),
    "Sign": lambda x, a: torch.sign(x[0]),
    "Floor": lambda x, a: torch.floor(x[0]),
    "Ceil": lambda x, a: torch.ceil(x[0]),
    "Pow": _binary(torch.pow),
    "Max": _fold(torch.maximum),
    "Min": _fold(torch.minimum),
    "Greater": _compare(torch.gt),
    "Less": _compare(torch.lt),
    "GreaterOrEqual": _compare(torch.ge),
    "LessOrEqual": _compare(torch.le),
    "Equal": _compare(torch.eq),
    "Identity": lambda x, a: x[0],
}


def make_torch_fn(model: Union[str, bytes, P.ParsedModel], device="cuda"):
    """Parse an ONNX model -> (fn, graph): `fn(inputs)` takes a dict of
    float32 tensors on `device` and returns {output_name: tensor} on
    `device`, with no copy to the host."""
    if not isinstance(model, P.ParsedModel):
        model = P.load_model(model)
    device = torch.device(device)
    g = model.graph
    host = {k: np.asarray(v) for k, v in g.initializers.items()}
    inits = {k: torch.from_numpy(np.array(v)).to(device)
             for k, v in host.items()}
    input_names = [vi.name for vi in g.inputs]

    def static(name: str, what: str) -> np.ndarray:
        if name not in host:
            raise NotImplementedError(
                f"{what} must be a graph initializer (static) for the torch "
                "ONNX runtime")
        return host[name]

    @torch.no_grad()
    def fn(inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        env: Dict[str, torch.Tensor] = dict(inits)
        for name in input_names:
            env[name] = inputs[name]
        for nd in g.nodes:
            a = nd.attrs
            names = [i for i in nd.inputs if i]
            x = [env[i] for i in names]
            op = nd.op_type
            if op in _OPS:
                y = _OPS[op](x, a)
            elif op == "Reshape":
                # 0 = "copy the input dim at this index" (ONNX allowzero=0)
                shape = static(names[1], "Reshape shape")
                y = x[0].reshape([x[0].shape[i] if int(d) == 0 else int(d)
                                  for i, d in enumerate(shape)])
            elif op == "ReduceSum":     # opset 13+: axes as second input
                axes = (tuple(int(v) for v in static(names[1],
                                                     "ReduceSum axes"))
                        if len(x) > 1
                        else tuple(a.get("axes", range(x[0].ndim))))
                y = x[0].sum(dim=axes, keepdim=bool(a.get("keepdims", 1)))
            elif op == "Expand":
                shape = [int(d) for d in static(names[1], "Expand shape")]
                y = torch.broadcast_to(
                    x[0], torch.broadcast_shapes(x[0].shape, shape))
            elif op == "Pad":
                pads = [int(v) for v in static(names[1], "Pad pads")]
                value = (float(static(names[2], "Pad value"))
                         if len(x) > 2 else 0.0)
                n = x[0].ndim
                width = []
                for i in reversed(range(n)):     # F.pad: last axis first
                    width += [pads[i], pads[n + i]]
                y = F.pad(x[0], width, value=value)
            elif op == "Slice":
                starts = static(names[1], "Slice starts")
                ends = static(names[2], "Slice ends")
                axes = (static(names[3], "Slice axes") if len(x) > 3
                        else np.arange(len(starts)))
                steps = (static(names[4], "Slice steps") if len(x) > 4
                         else np.ones(len(starts), np.int64))
                sl = [slice(None)] * x[0].ndim
                for s, e, ax, st in zip(starts, ends, axes, steps):
                    if int(st) < 1:
                        raise NotImplementedError(
                            "Slice with a step below 1 is not supported by "
                            "the torch ONNX runtime")
                    sl[int(ax)] = slice(int(s),
                                        None if e >= 2**31 else int(e),
                                        int(st))
                y = x[0][tuple(sl)]
            elif op in ("GRU", "LSTM"):
                Y, Y_h, Y_c = _rnn_node(op, x, a)
                if len(nd.outputs) > 1 and nd.outputs[1]:
                    env[nd.outputs[1]] = Y_h
                if len(nd.outputs) > 2 and nd.outputs[2] and Y_c is not None:
                    env[nd.outputs[2]] = Y_c
                y = Y
            else:
                raise NotImplementedError(
                    f"op '{op}' not supported by the torch ONNX runtime")
            env[nd.outputs[0]] = y
        return {vi.name: env[vi.name] for vi in g.outputs}

    return fn, g


class OnnxTorchModel:
    """An ONNX model on one torch device (the onnxruntime InferenceSession
    analogue). `input_shape` / `output_names` are what NanoInterpreter reads
    off a session; `forward` keeps everything on the device, `__call__` and
    `run` return numpy arrays."""

    def __init__(self, model: Union[str, bytes, P.ParsedModel],
                 device="cuda"):
        self.device = torch.device(device)
        self.forward, self.graph = make_torch_fn(model, self.device)
        self.input_name = self.graph.inputs[0].name
        self.input_shape = list(self.graph.inputs[0].shape)
        self.output_names = [vi.name for vi in self.graph.outputs]

    def tensor(self, value) -> torch.Tensor:
        return torch.as_tensor(np.asarray(value, np.float32),
                               device=self.device)

    def __call__(self, feats) -> np.ndarray:
        out = self.forward({self.input_name: self.tensor(feats)})
        return out[self.output_names[0]].cpu().numpy()

    def run(self, output_names, input_feed, run_options=None):
        """onnxruntime-compatible run()."""
        del run_options
        out = self.forward({k: self.tensor(v)
                            for k, v in input_feed.items()})
        return [out[n].cpu().numpy()
                for n in (output_names or self.output_names)]
