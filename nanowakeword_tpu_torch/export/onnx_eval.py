"""Reference numpy evaluator for ONNX graphs.

A copy of `nanowakeword_tpu/export/onnx_eval.py`: runs the ops that
onnx_export.py and export/frontend.py emit (Gemm, Conv, MaxPool,
LayerNormalization, activations, shape ops, GRU/LSTM) with numpy. It checks
an export without onnxruntime, drives the numpy streaming frontend
(`export/frontend.py::OnnxStreamingFrontend`), and is the host-side oracle
of the tests. It is a correctness tool, not a serving path: `.onnx` models
are served by export/onnx_torch.py on the session's device.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np

from nanowakeword_tpu_torch.export import onnx_proto as P


def _conv2d(x, w, b, pads, strides, dilations=(1, 1), group=1):
    """x [N,C,H,W], w [O,C/g,kH,kW] -> [N,O,H',W'] (groups + dilation)."""
    n, c, h, wd = x.shape
    o, cg, kh, kw = w.shape
    pt, pl, pb, pr = pads
    sh, sw = strides
    dh, dw = dilations
    ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1   # effective kernel
    xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)))
    oh = (h + pt + pb - ekh) // sh + 1
    ow = (wd + pl + pr - ekw) // sw + 1
    og = o // group
    out = np.empty((n, o, oh * ow), x.dtype)
    for gi in range(group):
        xg = xp[:, gi * cg:(gi + 1) * cg]
        # im2col over this group: [N, cg*kH*kW, oh*ow]
        cols = np.empty((n, cg * kh * kw, oh * ow), x.dtype)
        idx = 0
        for i in range(kh):
            for j in range(kw):
                patch = xg[:, :, i * dh:i * dh + oh * sh:sh,
                           j * dw:j * dw + ow * sw:sw]
                cols[:, idx * cg:(idx + 1) * cg] = patch.reshape(n, cg, -1)
                idx += 1
        wg = w[gi * og:(gi + 1) * og]                     # [og, cg, kh, kw]
        wmat = wg.transpose(2, 3, 1, 0).reshape(kh * kw * cg, og)
        out[:, gi * og:(gi + 1) * og] = np.einsum(
            "nkp,ko->nop", cols, wmat, optimize=True)
    if b is not None:
        out += b[None, :, None]
    return out.reshape(n, o, oh, ow)


def _conv(x, w, b, pads, strides, dilations, group):
    """Conv for 1D [N,C,L] or 2D [N,C,H,W] inputs (1D runs as H=1 2D)."""
    if x.ndim == 3:
        y = _conv2d(x[:, :, None, :], w[:, :, None, :],
                    b, [0, pads[0], 0, pads[1]],
                    [1, strides[0]], [1, dilations[0]], group)
        return y[:, :, 0, :]
    return _conv2d(x, w, b, pads, strides, dilations, group)


def _pool(x, kernel, strides, pads=None, mode="max", count_include_pad=1):
    """ONNX MaxPool / AveragePool over 1 or 2 spatial dims of
    [N, C, spatial...]. AveragePool honours count_include_pad: with 0 (the
    ONNX default) padded positions are excluded from each window's
    divisor."""
    rank = x.ndim - 2
    padded = bool(pads) and any(int(p) for p in pads)
    counts = None
    if padded:
        fill = -np.inf if mode == "max" else 0.0
        width = [(0, 0), (0, 0)] + [(int(pads[i]), int(pads[rank + i]))
                                    for i in range(rank)]
        if mode != "max" and not count_include_pad:
            counts = np.pad(np.ones(x.shape[2:], np.float64),
                            width[2:], constant_values=0.0)[None, None]
        x = np.pad(x, width, constant_values=fill)
    squeeze = rank == 1
    if squeeze:                       # route 1-D pooling through the 2-D path
        x = x[..., None]
        kernel, strides = list(kernel) + [1], list(strides) + [1]
        if counts is not None:
            counts = counts[..., None]
    n, c, h, w = x.shape
    kh, kw = kernel
    sh, sw = strides
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    init = -np.inf if mode == "max" else 0.0
    out = np.full((n, c, oh, ow), init, x.dtype)
    div = np.zeros((1, 1, oh, ow)) if counts is not None else None
    for i in range(kh):
        for j in range(kw):
            window = x[:, :, i:i + oh * sh:sh, j:j + ow * sw:sw]
            out = np.maximum(out, window) if mode == "max" else out + window
            if counts is not None:
                div = div + counts[:, :, i:i + oh * sh:sh, j:j + ow * sw:sw]
    if mode != "max":
        out = out / (kh * kw if div is None else np.maximum(div, 1.0))
    return out[..., 0] if squeeze else out


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _gru_direction(X, W, R, B, linear_before_reset=1, h0=None):
    """One-direction ONNX GRU: X [T,N,F], W [3H,F], R [3H,H], B [6H]
    in (z,r,h) gate order -> Y [T,N,H]."""
    H = R.shape[1]
    Wb, Rb = B[:3 * H], B[3 * H:]
    xg = X @ W.T + Wb                                 # [T, N, 3H]
    h = (np.zeros((X.shape[1], H), np.float32) if h0 is None
         else np.asarray(h0, np.float32))
    ys = np.empty(xg.shape[:2] + (H,), np.float32)
    for t in range(X.shape[0]):
        hg = h @ R.T
        z = _sigmoid(xg[t, :, :H] + hg[:, :H] + Rb[:H])
        r = _sigmoid(xg[t, :, H:2 * H] + hg[:, H:2 * H] + Rb[H:2 * H])
        if linear_before_reset:
            n = np.tanh(xg[t, :, 2 * H:] + r * (hg[:, 2 * H:] + Rb[2 * H:]))
        else:
            n = np.tanh(xg[t, :, 2 * H:] + (r * h) @ R[2 * H:].T
                        + Rb[2 * H:])
        h = (1.0 - z) * n + z * h
        ys[t] = h
    return ys


def _lstm_direction(X, W, R, B, h0=None, c0=None):
    """One-direction ONNX LSTM: gate order (i,o,f,c) -> (Y [T,N,H],
    final cell state [N,H])."""
    H = R.shape[1]
    Wb, Rb = B[:4 * H], B[4 * H:]
    xg = X @ W.T + (Wb + Rb)                          # [T, N, 4H]
    h = (np.zeros((X.shape[1], H), np.float32) if h0 is None
         else np.asarray(h0, np.float32))
    c = (np.zeros((X.shape[1], H), np.float32) if c0 is None
         else np.asarray(c0, np.float32))
    ys = np.empty(xg.shape[:2] + (H,), np.float32)
    for t in range(X.shape[0]):
        gates = xg[t] + h @ R.T
        i = _sigmoid(gates[:, :H])
        o = _sigmoid(gates[:, H:2 * H])
        f = _sigmoid(gates[:, 2 * H:3 * H])
        g = np.tanh(gates[:, 3 * H:])
        c = f * c + i * g
        h = o * np.tanh(c)
        ys[t] = h
    return ys, c


def _rnn_node(op, x, attrs):
    """GRU/LSTM node -> (Y [T, dirs, N, H], Y_h [dirs, N, H],
    Y_c [dirs, N, H] | None). Optional initial_h (and initial_c for LSTM)
    arrive as the 5th/6th present inputs (sequence_lens, which both
    onnx_export.py and torch leave empty, is skipped upstream)."""
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
        Xd = X[::-1] if reverse else X
        if initial_h is not None:
            kw["h0"] = initial_h[d]
        if op == "GRU":
            Y = _gru_direction(Xd, W[d], R[d], B[d], **kw)
        else:
            if initial_c is not None:
                kw["c0"] = initial_c[d]
            Y, c_fin = _lstm_direction(Xd, W[d], R[d], B[d], **kw)
            cells.append(c_fin)
        finals.append(Y[-1])                          # last processed state
        if reverse:
            Y = Y[::-1]                               # align to input time
        dirs.append(Y)
    return (np.stack(dirs, axis=1), np.stack(finals, axis=0),
            np.stack(cells, axis=0) if cells else None)


def run(model: Union[str, bytes, P.ParsedModel],
        inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Execute the graph; returns {output_name: array}."""
    if not isinstance(model, P.ParsedModel):
        model = P.load_model(model)
    g = model.graph
    env: Dict[str, np.ndarray] = dict(g.initializers)
    for vi in g.inputs:
        if vi.name not in inputs:
            raise KeyError(f"missing graph input '{vi.name}'")
        env[vi.name] = np.asarray(inputs[vi.name], np.float32)

    for nd in g.nodes:
        a = nd.attrs
        x = [env[i] for i in nd.inputs if i]
        op = nd.op_type
        if op == "Gemm":
            A, B = x[0], x[1]
            if a.get("transA", 0):
                A = A.T
            if a.get("transB", 0):
                B = B.T
            y = a.get("alpha", 1.0) * (A @ B)
            if len(x) > 2:
                y = y + a.get("beta", 1.0) * x[2]
        elif op == "DequantizeLinear":
            # weight-only per-axis symmetric form: (int8, scales[axis])
            axis = a.get("axis", 1) % x[0].ndim
            shape = [1] * x[0].ndim
            shape[axis] = -1
            y = x[0].astype(np.float32) * x[1].reshape(shape)
        elif op == "Relu":
            y = np.maximum(x[0], 0)
        elif op == "Sigmoid":
            y = 1.0 / (1.0 + np.exp(-x[0]))
        elif op == "Tanh":
            y = np.tanh(x[0])
        elif op == "Add":
            y = x[0] + x[1]
        elif op == "Sub":
            y = x[0] - x[1]
        elif op == "Mul":
            y = x[0] * x[1]
        elif op == "Div":
            y = x[0] / x[1]
        elif op == "Flatten":
            axis = a.get("axis", 1)
            shape = x[0].shape
            y = x[0].reshape(int(np.prod(shape[:axis] or (1,))), -1)
        elif op == "Reshape":
            # 0 = "copy the input dim at this index" (ONNX allowzero=0)
            y = x[0].reshape([x[0].shape[i] if int(d) == 0 else int(d)
                              for i, d in enumerate(x[1])])
        elif op == "Transpose":
            y = np.transpose(x[0], a["perm"])
        elif op == "LayerNormalization":
            axis = a.get("axis", -1)
            eps = a.get("epsilon", 1e-5)
            mean = x[0].mean(axis=axis, keepdims=True)
            var = x[0].var(axis=axis, keepdims=True)
            y = (x[0] - mean) / np.sqrt(var + eps)
            y = y * x[1] + (x[2] if len(x) > 2 else 0.0)
        elif op == "Conv":
            rank = x[0].ndim - 2
            y = _conv(x[0], x[1], x[2] if len(x) > 2 else None,
                      a.get("pads", [0, 0] * rank),
                      a.get("strides", [1] * rank),
                      a.get("dilations", [1] * rank),
                      a.get("group", 1))
        elif op == "MaxPool":
            y = _pool(x[0], a["kernel_shape"],
                      a.get("strides", a["kernel_shape"]),
                      a.get("pads"), mode="max")
        elif op == "AveragePool":
            y = _pool(x[0], a["kernel_shape"],
                      a.get("strides", a["kernel_shape"]),
                      a.get("pads"), mode="avg",
                      count_include_pad=int(a.get("count_include_pad", 0)))
        elif op == "BatchNormalization":
            scale, bias, mean, var = x[1], x[2], x[3], x[4]
            eps = a.get("epsilon", 1e-5)
            bshape = (1, -1) + (1,) * (x[0].ndim - 2)
            y = ((x[0] - mean.reshape(bshape))
                 / np.sqrt(var.reshape(bshape) + eps)
                 * scale.reshape(bshape) + bias.reshape(bshape))
        elif op == "ReduceMean":
            axes = tuple(a["axes"])
            y = x[0].mean(axis=axes, keepdims=bool(a.get("keepdims", 1)))
        elif op == "ReduceSum":       # opset 13+: axes as second input
            axes = tuple(int(v) for v in x[1]) if len(x) > 1 \
                else tuple(a.get("axes", range(x[0].ndim)))
            y = x[0].sum(axis=axes, keepdims=bool(a.get("keepdims", 1)))
        elif op == "ReduceMax":
            y = x[0].max(axis=tuple(a["axes"]),
                         keepdims=bool(a.get("keepdims", 1)))
        elif op == "ReduceMin":
            y = x[0].min(axis=tuple(a["axes"]),
                         keepdims=bool(a.get("keepdims", 1)))
        elif op == "Einsum":
            eq = a["equation"]
            if isinstance(eq, bytes):
                eq = eq.decode()
            y = np.einsum(eq, *x, optimize=True)
        elif op == "Expand":
            y = x[0] * np.ones([int(d) for d in x[1]], x[0].dtype)
        elif op == "Cast":
            y = x[0]                  # evaluator computes in f32 throughout
        elif op == "Pad":
            pads = [int(v) for v in x[1]]
            nd_ = x[0].ndim
            value = float(x[2]) if len(x) > 2 else 0.0
            width = [(pads[i], pads[nd_ + i]) for i in range(nd_)]
            y = np.pad(x[0], width, constant_values=value)
        elif op == "Exp":
            y = np.exp(x[0])
        elif op == "Log":
            y = np.log(x[0])
        elif op == "Erf":
            try:
                from scipy.special import erf as _erf
                y = np.asarray(_erf(x[0]), np.float32)
            except ImportError:
                from math import erf as _serf
                y = np.vectorize(_serf, otypes=[np.float32])(x[0])
        elif op == "Sqrt":
            y = np.sqrt(x[0])
        elif op == "Reciprocal":
            y = 1.0 / x[0]
        elif op == "Neg":
            y = -x[0]
        elif op == "Abs":
            y = np.abs(x[0])
        elif op == "Sign":
            y = np.sign(x[0])
        elif op == "Floor":
            y = np.floor(x[0])
        elif op == "Ceil":
            y = np.ceil(x[0])
        elif op == "Pow":
            y = np.power(x[0], x[1])
        elif op == "Max":
            y = x[0]
            for v in x[1:]:
                y = np.maximum(y, v)
        elif op == "Min":
            y = x[0]
            for v in x[1:]:
                y = np.minimum(y, v)
        elif op == "Clip":
            lo = x[1] if len(x) > 1 and x[1] is not None else None
            hi = x[2] if len(x) > 2 and x[2] is not None else None
            y = np.clip(x[0], lo, hi)
        elif op == "Greater":
            y = (x[0] > x[1]).astype(np.float32)
        elif op == "Less":
            y = (x[0] < x[1]).astype(np.float32)
        elif op == "GreaterOrEqual":
            y = (x[0] >= x[1]).astype(np.float32)
        elif op == "LessOrEqual":
            y = (x[0] <= x[1]).astype(np.float32)
        elif op == "Equal":
            y = (x[0] == x[1]).astype(np.float32)
        elif op == "Slice":
            data, starts, ends = x[0], x[1], x[2]
            axes = x[3] if len(x) > 3 else np.arange(len(starts))
            steps = x[4] if len(x) > 4 else np.ones(len(starts), np.int64)
            sl = [slice(None)] * data.ndim
            for s, e, ax, st in zip(starts, ends, axes, steps):
                sl[int(ax)] = slice(int(s), None if e >= 2**31 else int(e),
                                    int(st))
            y = data[tuple(sl)]
        elif op == "Gather":
            y = np.take(x[0], x[1].astype(np.int64),
                        axis=int(a.get("axis", 0)))
        elif op == "ArgMax":
            ax = int(a.get("axis", 0))
            y = np.argmax(x[0], axis=ax)
            if int(a.get("keepdims", 1)):
                y = np.expand_dims(y, ax)
        elif op == "MatMul":
            y = x[0] @ x[1]
        elif op == "Softmax":
            ax = a.get("axis", -1)
            e = np.exp(x[0] - x[0].max(axis=ax, keepdims=True))
            y = e / e.sum(axis=ax, keepdims=True)
        elif op == "Concat":
            y = np.concatenate(x, axis=a["axis"])
        elif op == "Identity":
            y = x[0]
        elif op in ("GRU", "LSTM"):
            Y, Y_h, Y_c = _rnn_node(op, x, a)
            if len(nd.outputs) > 1 and nd.outputs[1]:
                env[nd.outputs[1]] = np.asarray(Y_h, np.float32)
            if len(nd.outputs) > 2 and nd.outputs[2] and Y_c is not None:
                env[nd.outputs[2]] = np.asarray(Y_c, np.float32)
            y = Y
        else:
            raise NotImplementedError(f"op '{op}' not supported by the "
                                      "built-in ONNX evaluator")
        env[nd.outputs[0]] = np.asarray(y, np.float32)

    return {vi.name: env[vi.name] for vi in g.outputs}
