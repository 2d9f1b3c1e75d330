"""Wake-word models -> ONNX graphs.

The counterpart of `nanowakeword_tpu/export/onnx_export.py`. The graph is
built straight from the model's parameters in the reference's flax layout
(`Model.variables`: `params` and `batch_stats` as numpy arrays) and
serialized by onnx_proto.py, with no `onnx` package. For the same weights
it writes the JAX exporter's graph node for node and byte for byte; only
the producer and the doc strings differ. All 13 families export:
  * feed-forward/conv: "dnn" (Gemm/LayerNormalization stacks), "cnn"
    (Conv/MaxPool), "tcn" (dilated causal Conv1d), "quartznet" (grouped
    depthwise-separable Conv1d + BatchNormalization), "bcresnet"
    (depthwise-separable 2D residual blocks);
  * recurrent: "lstm"/"gru"/"rnn"/"crnn" emit native bidirectional ONNX
    LSTM/GRU nodes with the gates repacked from the Fast{GRU,LSTM} layout:
    torch order (r,z,n)/(i,f,g,o) to ONNX (z,r,n)/(i,o,f,c),
    linear_before_reset=1;
  * attention: "transformer"/"conformer"/"e_branchformer" lower
    multi-head self-attention to per-head MatMul/Softmax, GLU/conv
    modules to Conv + BatchNormalization, with sinusoidal positions baked
    as an initializer;
  * stateful: "streaming_gru" exports a STATEFUL graph with explicit
    `hidden_in`/`cell_in` inputs and `score`/`hidden_out`/`cell_out`
    outputs, the stateful-model convention of the reference's interpreter.
The shared WakeWordModule head is appended to every family. A user's
`custom` module is traced by torch.fx and lowered node by node
(export/fx_onnx.py), as the JAX package lowers its jaxpr.

Graph contract (with a DYNAMIC batch axis, as torch.onnx.export declares it
in the reference):
  input  "features" : float32 ["batch_size", T, 96]
  output "score"    : float32 ["batch_size", n_classes]  (sigmoid prob)

Numerical notes: flax Dense kernels are [in, out] and feed Gemm with
transB=0; flax Conv kernels are [kH, kW, in, out] (NHWC) and are transposed
to ONNX's [out, in, kH, kW] with explicit NCHW<->NHWC transposes at the
boundaries so flattening order matches the flax reshape semantics. GELU is
emitted as the tanh approximation (what flax nn.gelu computes).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from nanowakeword_tpu_torch.export import onnx_proto as P
from nanowakeword_tpu_torch.utils.logger import print_info

SUPPORTED_TYPES = ("dnn", "cnn", "tcn", "quartznet", "bcresnet",
                   "lstm", "gru", "rnn", "crnn",
                   "transformer", "conformer", "e_branchformer",
                   "streaming_gru")
# families whose graphs accept a dynamic batch axis (as the reference's
# torch.onnx.export declares batch_size dynamic).
# Attention families qualify since the per-head lowering keeps batch
# symbolic (0-copy reshapes + batched MatMul, see _mhsa).
DYNAMIC_BATCH_TYPES = ("dnn", "cnn", "tcn", "quartznet", "bcresnet",
                       "lstm", "gru", "rnn", "crnn",
                       "transformer", "conformer", "e_branchformer")


class _GraphBuilder:
    """Accumulates nodes/initializers and hands out unique tensor names.

    With ``quantize=True``, weight initializers whose call site passes a
    ``quant_axis`` are stored as symmetric per-channel int8 plus a float32
    scale vector and rehydrated in-graph by a DequantizeLinear node
    (opset >= 13 per-axis form) — weight-only quantization, ~4x smaller
    files, every compute op still runs float32.
    """

    def __init__(self, quantize: bool = False):
        self.nodes: List[bytes] = []
        self.inits: List[bytes] = []
        self._n = 0
        self.quantize = quantize

    def name(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init_tensor(self, hint: str, array, quant_axis=None) -> str:
        array = np.asarray(array)
        if self.quantize and quant_axis is not None:
            from nanowakeword_tpu_torch.export.artifact import \
                int8_quantize
            q, scale = int8_quantize(array, axis=quant_axis)
            if scale.size:  # eligible leaf (f32, >=2-D, above cutoff)
                qn = self.name(f"{hint}_q")
                sn = self.name(f"{hint}_s")
                self.inits.append(P.tensor(qn, q))
                self.inits.append(P.tensor(sn, scale))
                return self.add("DequantizeLinear", [qn, sn],
                                axis=quant_axis % array.ndim)
        name = self.name(hint)
        self.inits.append(P.tensor(name, array))
        return name

    def add(self, op: str, inputs, n_out: int = 1, **attrs) -> str:
        outs = [self.name(op.lower()) for _ in range(n_out)]
        self.nodes.append(P.node(op, inputs, outs,
                                 name=self.name(f"n_{op.lower()}"), **attrs))
        return outs[0] if n_out == 1 else outs

    # -- composite helpers -------------------------------------------------------

    def gemm(self, x: str, kernel: np.ndarray, bias: np.ndarray,
             hint: str) -> str:
        w = self.init_tensor(f"{hint}_w", kernel,
                             quant_axis=1)         # [in, out]
        b = self.init_tensor(f"{hint}_b", bias)
        return self.add("Gemm", [x, w, b])

    def layer_norm(self, x: str, scale: np.ndarray, bias: np.ndarray,
                   hint: str) -> str:
        s = self.init_tensor(f"{hint}_scale", scale)
        b = self.init_tensor(f"{hint}_bias", bias)
        return self.add("LayerNormalization", [x, s, b],
                        axis=-1, epsilon=1e-6)             # flax default eps

    def activation(self, x: str, kind: str) -> str:
        kind = (kind or "relu").lower()
        if kind == "relu":
            return self.add("Relu", [x])
        if kind == "silu":
            return self.add("Mul", [x, self.add("Sigmoid", [x])])
        if kind == "gelu":
            # tanh approximation — identical to flax nn.gelu(approximate=True)
            c0 = self.init_tensor("c_sqrt2opi", np.float32(0.7978845608028654))
            c1 = self.init_tensor("c_044715", np.float32(0.044715))
            half = self.init_tensor("c_half", np.float32(0.5))
            one = self.init_tensor("c_one", np.float32(1.0))
            x3 = self.add("Mul", [x, self.add("Mul", [x, x])])
            inner = self.add("Mul", [
                c0, self.add("Add", [x, self.add("Mul", [c1, x3])])])
            t = self.add("Tanh", [inner])
            return self.add("Mul", [
                self.add("Mul", [half, x]), self.add("Add", [one, t])])
        raise ValueError(f"unsupported activation '{kind}' for ONNX export")

    def conv(self, x: str, kernel_onnx: np.ndarray,
             bias: Optional[np.ndarray], hint: str, *, pads, strides,
             dilations=None, group: int = 1) -> str:
        """Conv node from an already-ONNX-layout kernel [O, C/g, *k]."""
        inputs = [x, self.init_tensor(f"{hint}_w", kernel_onnx,
                                      quant_axis=0)]
        if bias is not None:
            inputs.append(self.init_tensor(f"{hint}_b", bias))
        attrs = dict(kernel_shape=list(kernel_onnx.shape[2:]),
                     pads=list(pads), strides=list(strides), group=group)
        if dilations is not None:
            attrs["dilations"] = list(dilations)
        return self.add("Conv", inputs, **attrs)

    def batch_norm(self, x: str, bn_params: dict, bn_stats: dict,
                   hint: str) -> str:
        """Inference-mode BatchNormalization from flax params/batch_stats."""
        inputs = [x,
                  self.init_tensor(f"{hint}_scale", bn_params["scale"]),
                  self.init_tensor(f"{hint}_bias", bn_params["bias"]),
                  self.init_tensor(f"{hint}_mean", bn_stats["mean"]),
                  self.init_tensor(f"{hint}_var", bn_stats["var"])]
        return self.add("BatchNormalization", inputs,
                        epsilon=1e-5)            # flax nn.BatchNorm default

    def reduce_mean(self, x: str, axes, keepdims: int = 0) -> str:
        return self.add("ReduceMean", [x], axes=list(axes),
                        keepdims=keepdims)

    def slice_last(self, x: str, axis: int) -> str:
        """Take the final element along `axis` (keepdim)."""
        starts = self.init_tensor("sl_starts", np.asarray([-1], np.int64))
        ends = self.init_tensor("sl_ends",
                                np.asarray([2**31 - 1], np.int64))
        axes = self.init_tensor("sl_axes", np.asarray([axis], np.int64))
        return self.add("Slice", [x, starts, ends, axes])

    def slice_range(self, x: str, axis: int, start: int, end: int) -> str:
        starts = self.init_tensor("sl_starts", np.asarray([start], np.int64))
        ends = self.init_tensor("sl_ends", np.asarray([end], np.int64))
        axes = self.init_tensor("sl_axes", np.asarray([axis], np.int64))
        return self.add("Slice", [x, starts, ends, axes])

    def reshape(self, x: str, shape) -> str:
        s = self.init_tensor("shape", np.asarray(shape, np.int64))
        return self.add("Reshape", [x, s])

    def dense3d(self, x: str, kernel: np.ndarray, bias: np.ndarray,
                hint: str) -> str:
        """Dense over the LAST axis of an N-D tensor: MatMul + Add.
        kernel [in, out] in flax layout (batched matmul broadcasts)."""
        w = self.init_tensor(f"{hint}_w", kernel, quant_axis=1)
        y = self.add("MatMul", [x, w])
        if bias is not None:
            b = self.init_tensor(f"{hint}_b", bias)
            y = self.add("Add", [y, b])
        return y

    def const_mul(self, x: str, value: float, hint: str = "c") -> str:
        c = self.init_tensor(hint, np.float32(value))
        return self.add("Mul", [x, c])

    def swish(self, x: str) -> str:
        return self.add("Mul", [x, self.add("Sigmoid", [x])])


def _same_pads(in_size: int, k: int, s: int) -> tuple:
    """flax/XLA 'SAME' padding as explicit (lo, hi) for a static in_size."""
    out = -(-in_size // s)
    total = max((out - 1) * s + k - in_size, 0)
    return total // 2, total - total // 2


def _conv1d_kernel(kernel: np.ndarray) -> np.ndarray:
    """flax [k, in/g, out] -> ONNX [out, in/g, k]."""
    return np.transpose(kernel, (2, 1, 0))


def _conv2d_kernel(kernel: np.ndarray) -> np.ndarray:
    """flax [kH, kW, in/g, out] -> ONNX [out, in/g, kH, kW]."""
    return np.transpose(kernel, (3, 2, 0, 1))


def _dnn_backbone(g: _GraphBuilder, x: str, params: dict,
                  activation: str) -> str:
    """DNNModel (models/architectures.py): flatten -> n+1 blocks of
    Dense+LayerNorm+act (dropout is identity at inference) -> Dense."""
    x = g.add("Flatten", [x], axis=1)
    n_dense = len([k for k in params if k.startswith("Dense_")])
    for i in range(n_dense - 1):
        d = params[f"Dense_{i}"]
        x = g.gemm(x, d["kernel"], d["bias"], f"bb_dense{i}")
        ln = params[f"LayerNorm_{i}"]
        x = g.layer_norm(x, ln["scale"], ln["bias"], f"bb_ln{i}")
        x = g.activation(x, activation)
    d = params[f"Dense_{n_dense - 1}"]
    return g.gemm(x, d["kernel"], d["bias"], "bb_out")


def _conv_same(g: _GraphBuilder, x: str, kernel: np.ndarray,
               bias: np.ndarray, hint: str) -> str:
    """flax nn.Conv(ch, (3,3), SAME) on NCHW input."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    w = g.init_tensor(f"{hint}_w", np.transpose(kernel, (3, 2, 0, 1)),
                      quant_axis=0)
    b = g.init_tensor(f"{hint}_b", bias)
    return g.add("Conv", [x, w, b], kernel_shape=[kh, kw],
                 pads=[(kh - 1) // 2, (kw - 1) // 2, kh // 2, kw // 2],
                 strides=[1, 1])


def _cnn_backbone(g: _GraphBuilder, x: str, params: dict, activation: str,
                  input_shape) -> str:
    """CNNModel (models/architectures.py). The NHWC->NCHW transpose
    pair around the conv stack keeps ONNX's flatten order identical to the
    Flax [B, T, F, C] reshape."""
    t, f = int(input_shape[0]), int(input_shape[1])
    # [B, T, F] -> [B, 1, T, F] (NCHW with C=1; -1 keeps batch dynamic)
    shape4 = g.init_tensor("shape4", np.asarray([-1, 1, t, f], np.int64))
    x = g.add("Reshape", [x, shape4])
    x = _conv_same(g, x, params["Conv_0"]["kernel"],
                   params["Conv_0"]["bias"], "bb_conv0")
    x = g.activation(x, activation)
    x = g.add("MaxPool", [x], kernel_shape=[2, 2], strides=[2, 2])
    x = _conv_same(g, x, params["Conv_1"]["kernel"],
                   params["Conv_1"]["bias"], "bb_conv1")
    x = g.activation(x, activation)
    x = g.add("MaxPool", [x], kernel_shape=[2, 2], strides=[2, 2])
    x = g.add("Transpose", [x], perm=[0, 2, 3, 1])     # NCHW -> NHWC
    x = g.add("Flatten", [x], axis=1)
    d0 = params["Dense_0"]
    x = g.gemm(x, d0["kernel"], d0["bias"], "bb_dense0")
    x = g.activation(x, activation)
    d1 = params["Dense_1"]
    return g.gemm(x, d1["kernel"], d1["bias"], "bb_out")


def _tcn_backbone(g: _GraphBuilder, x: str, params: dict,
                  config: dict) -> str:
    """TCNModel (models/architectures.py): dilated causal
    TemporalBlocks in NCL layout, last-timestep readout, Dense."""
    kernel = int(config.get("tcn_kernel_size", 3))
    x = g.add("Transpose", [x], perm=[0, 2, 1])        # [1, 96, T]
    n_blocks = len([k for k in params if k.startswith("TemporalBlock_")])
    for i in range(n_blocks):
        bp = params[f"TemporalBlock_{i}"]
        dil = 2 ** i
        pad = (kernel - 1) * dil                       # causal: all-left pad
        h = g.conv(x, _conv1d_kernel(bp["Conv_0"]["kernel"]),
                   bp["Conv_0"]["bias"], f"tcn{i}_c0",
                   pads=[pad, 0], strides=[1], dilations=[dil])
        h = g.add("Relu", [h])
        h = g.conv(h, _conv1d_kernel(bp["Conv_1"]["kernel"]),
                   bp["Conv_1"]["bias"], f"tcn{i}_c1",
                   pads=[pad, 0], strides=[1], dilations=[dil])
        h = g.add("Relu", [h])
        res = x
        if "Conv_2" in bp:                             # channel-matching 1x1
            res = g.conv(x, _conv1d_kernel(bp["Conv_2"]["kernel"]),
                         bp["Conv_2"]["bias"], f"tcn{i}_res",
                         pads=[0, 0], strides=[1])
        x = g.add("Relu", [g.add("Add", [h, res])])
    last = g.slice_last(x, axis=2)                     # [1, C, 1]
    flat = g.add("Flatten", [last], axis=1)
    d = params["Dense_0"]
    return g.gemm(flat, d["kernel"], d["bias"], "tcn_out")


def _quartznet_backbone(g: _GraphBuilder, x: str, params: dict,
                        stats: dict) -> str:
    """QuartzNetModel (models/architectures.py): depthwise-separable
    1D blocks with BatchNorm + residual, mean-pool, Dense. Channel counts
    are read from the kernels, so any quartznet_config round-trips."""
    x = g.add("Transpose", [x], perm=[0, 2, 1])        # [1, 96, T]
    n_blocks = len([k for k in params if k.startswith("QuartzNetBlock_")])
    for i in range(n_blocks):
        bp = params[f"QuartzNetBlock_{i}"]
        bs = stats[f"QuartzNetBlock_{i}"]
        dw = bp["Conv_0"]["kernel"]                    # [k, 1, in_ch]
        k, in_ch = dw.shape[0], dw.shape[2]
        lo, hi = (k - 1) // 2, k // 2                  # SAME at stride 1
        h = g.conv(x, _conv1d_kernel(dw), bp["Conv_0"]["bias"],
                   f"qn{i}_dw", pads=[lo, hi], strides=[1], group=in_ch)
        h = g.conv(h, _conv1d_kernel(bp["Conv_1"]["kernel"]),
                   bp["Conv_1"]["bias"], f"qn{i}_pw",
                   pads=[0, 0], strides=[1])
        h = g.batch_norm(h, bp["BatchNorm_0"], bs["BatchNorm_0"], f"qn{i}_bn")
        res = x
        if "Conv_2" in bp:                             # channel-change path
            res = g.conv(x, _conv1d_kernel(bp["Conv_2"]["kernel"]),
                         bp["Conv_2"]["bias"], f"qn{i}_res",
                         pads=[0, 0], strides=[1])
            res = g.batch_norm(res, bp["BatchNorm_1"], bs["BatchNorm_1"],
                               f"qn{i}_resbn")
        x = g.add("Relu", [g.add("Add", [h, res])])
    pooled = g.reduce_mean(x, axes=[2])                # [1, C]
    d = params["Dense_0"]
    return g.gemm(pooled, d["kernel"], d["bias"], "qn_out")


def _bcresnet_backbone(g: _GraphBuilder, x: str, params: dict, stats: dict,
                       activation: str, input_shape) -> str:
    """BcResNetModel (models/architectures.py): stem conv + 3
    depthwise-separable residual blocks (strided, SAME) + global mean."""
    t, f = int(input_shape[0]), int(input_shape[1])
    shape4 = g.init_tensor("shape4", np.asarray([-1, 1, t, f], np.int64))
    x = g.add("Reshape", [x, shape4])                  # NCHW, C=1, dyn batch

    def same_conv(x, kernel, hint, stride, h, w, group=1):
        kh, kw = kernel.shape[2], kernel.shape[3]
        pt, pb = _same_pads(h, kh, stride[0])
        pl, pr = _same_pads(w, kw, stride[1])
        return g.conv(x, kernel, None, hint,
                      pads=[pt, pl, pb, pr], strides=list(stride),
                      group=group)

    h_sz, w_sz = t, f
    x = same_conv(x, _conv2d_kernel(params["Conv_0"]["kernel"]),
                  "bc_stem", (1, 1), h_sz, w_sz)
    x = g.batch_norm(x, params["BatchNorm_0"], stats["BatchNorm_0"],
                     "bc_stem_bn")
    x = g.activation(x, activation)
    x = g.add("MaxPool", [x], kernel_shape=[2, 2], strides=[2, 2])
    h_sz, w_sz = h_sz // 2, w_sz // 2

    n_blocks = len([k for k in params if k.startswith("BcResNetBlock_")])
    for i in range(n_blocks):
        bp = params[f"BcResNetBlock_{i}"]
        bs = stats[f"BcResNetBlock_{i}"]
        has_short = "Conv_2" in bp                     # shortcut declared 1st
        if has_short:
            short_p, dw_p, pw_p = bp["Conv_0"], bp["Conv_1"], bp["Conv_2"]
            short_bn, main_bn = "BatchNorm_0", "BatchNorm_1"
        else:
            dw_p, pw_p = bp["Conv_0"], bp["Conv_1"]
            main_bn = "BatchNorm_0"
        dw_k = _conv2d_kernel(dw_p["kernel"])          # [in, 1, 3, 3]
        in_ch = dw_k.shape[0]
        # stride is architectural: blocks 1/2 are (2,2), block 3 (2,1)
        # (models/architectures.py)
        stride = [(2, 2), (2, 2), (2, 1)][i] if n_blocks == 3 else (1, 1)
        short = x
        if has_short:
            short = same_conv(x, _conv2d_kernel(short_p["kernel"]),
                              f"bc{i}_short", stride, h_sz, w_sz)
            short = g.batch_norm(short, bp[short_bn], bs[short_bn],
                                 f"bc{i}_short_bn")
        h = same_conv(x, dw_k, f"bc{i}_dw", stride, h_sz, w_sz,
                      group=in_ch)
        h = g.conv(h, _conv2d_kernel(pw_p["kernel"]), None, f"bc{i}_pw",
                   pads=[0, 0, 0, 0], strides=[1, 1])
        h = g.batch_norm(h, bp[main_bn], bs[main_bn], f"bc{i}_bn")
        h = g.activation(h, activation)
        x = g.add("Add", [h, short])
        h_sz = -(-h_sz // stride[0])
        w_sz = -(-w_sz // stride[1])
    pooled = g.reduce_mean(x, axes=[2, 3])             # [1, C]
    d = params["Dense_0"]
    return g.gemm(pooled, d["kernel"], d["bias"], "bc_out")


# ---------------------------------------------------------------------------
# Recurrent families — native ONNX GRU/LSTM nodes
# ---------------------------------------------------------------------------

def _pack_gru(p: dict):
    """FastGRU params (models/fast_rnn.py, torch gate order r,z,n)
    -> ONNX GRU tensors W [3H,F], R [3H,H], B [6H] in (z,r,n) order.
    FastGRU's `n = tanh(xn + r*hn)` with the recurrent bias inside the
    reset product is exactly ONNX `linear_before_reset=1` semantics."""
    K = np.asarray(p["input_proj"]["kernel"], np.float32)     # [F, 3H]
    bi = np.asarray(p["input_proj"]["bias"], np.float32)      # [3H]
    Rk = np.asarray(p["recurrent_kernel"], np.float32)        # [H, 3H]
    br = np.asarray(p["recurrent_bias"], np.float32)          # [3H]
    H = Rk.shape[0]

    def reorder(m):  # (r,z,n) -> (z,r,n) along the last axis
        return np.concatenate([m[..., H:2 * H], m[..., :H], m[..., 2 * H:]],
                              axis=-1)
    W = reorder(K).T
    R = reorder(Rk).T
    B = np.concatenate([reorder(bi), reorder(br)])
    return W, R, B, H


def _pack_lstm(p: dict):
    """FastLSTM params (torch gate order i,f,g,o) -> ONNX LSTM tensors in
    (i,o,f,c) order: W [4H,F], R [4H,H], B [8H]."""
    K = np.asarray(p["input_proj"]["kernel"], np.float32)
    bi = np.asarray(p["input_proj"]["bias"], np.float32)
    Rk = np.asarray(p["recurrent_kernel"], np.float32)
    br = np.asarray(p["recurrent_bias"], np.float32)
    H = Rk.shape[0]

    def reorder(m):  # (i,f,g,o) -> (i,o,f,c)
        return np.concatenate([m[..., :H], m[..., 3 * H:],
                               m[..., H:2 * H], m[..., 2 * H:3 * H]],
                              axis=-1)
    W = reorder(K).T
    R = reorder(Rk).T
    B = np.concatenate([reorder(bi), reorder(br)])
    return W, R, B, H


def _bi_rnn(g: _GraphBuilder, x_seq: str, params: dict, cell: str,
            t: int, hint: str) -> tuple:
    """BiRNN (models/architectures.py) -> stacked bidirectional
    GRU/LSTM nodes. x_seq is [T, 1, F]; returns ([T, 1, 2H] name, 2H)."""
    pack = _pack_gru if cell == "gru" else _pack_lstm
    op = "GRU" if cell == "gru" else "LSTM"
    layer_key = "FastGRU_" if cell == "gru" else "FastLSTM_"
    n_layers = len([k for k in params if k.startswith(layer_key)]) // 2
    h = 0
    for i in range(n_layers):
        wf, rf, bf, h = pack(params[f"{layer_key}{2 * i}"])
        wb, rb, bb, _ = pack(params[f"{layer_key}{2 * i + 1}"])
        W = g.init_tensor(f"{hint}{i}_W", np.stack([wf, wb]),
                          quant_axis=1)
        R = g.init_tensor(f"{hint}{i}_R", np.stack([rf, rb]),
                          quant_axis=1)
        B = g.init_tensor(f"{hint}{i}_B", np.stack([bf, bb]))
        attrs = dict(hidden_size=h, direction="bidirectional")
        if op == "GRU":
            attrs["linear_before_reset"] = 1
        y = g.add(op, [x_seq, W, R, B], **attrs)   # [T, 2, B, H]
        y = g.add("Transpose", [y], perm=[0, 2, 1, 3])
        x_seq = g.reshape(y, [t, -1, 2 * h])       # [T, B, 2H], dyn batch
    return x_seq, 2 * h


def _rnn_backbone(g: _GraphBuilder, x: str, params: dict, cell: str,
                  t: int) -> str:
    """LSTMModel/GRUModel/RNNModel (models/architectures.py):
    bi-RNN over the feature frames, last timestep, Dense."""
    xs = g.add("Transpose", [x], perm=[1, 0, 2])   # [T, B, F]
    out, width = _bi_rnn(g, xs, params["BiRNN_0"], cell, t, "rnn")
    last = g.slice_last(out, axis=0)               # [1, B, 2H]
    flat = g.reshape(last, [-1, width])
    d = params["Dense_0"]
    return g.gemm(flat, d["kernel"], d["bias"], "rnn_out")


def _crnn_backbone(g: _GraphBuilder, x: str, params: dict, stats: dict,
                   config: dict, activation: str, input_shape) -> str:
    """CRNNModel (models/architectures.py): conv+BN+act+pool stack,
    sequence over the reduced WIDTH axis with channels x reduced-time
    features (the reference's quirky geometry), bi-RNN, last step, Dense."""
    t, f = int(input_shape[0]), int(input_shape[1])
    x4 = g.reshape(x, [-1, 1, t, f])               # NCHW, C=1, dyn batch
    h_sz, w_sz, ch = t, f, 1
    n_convs = len([k for k in params if k.startswith("Conv_")])
    for i in range(n_convs):
        x4 = _conv_same(g, x4, params[f"Conv_{i}"]["kernel"],
                        params[f"Conv_{i}"]["bias"], f"crnn_c{i}")
        x4 = g.batch_norm(x4, params[f"BatchNorm_{i}"],
                          stats[f"BatchNorm_{i}"], f"crnn_bn{i}")
        x4 = g.activation(x4, activation)
        x4 = g.add("MaxPool", [x4], kernel_shape=[2, 2], strides=[2, 2])
        h_sz, w_sz = h_sz // 2, w_sz // 2
        ch = params[f"Conv_{i}"]["kernel"].shape[-1]
    # [B,C,H,W] -> [B,W,C,H] -> [B,W,C*H]  (flax: transpose(0,2,3,1) of NHWC)
    seq = g.add("Transpose", [x4], perm=[0, 3, 1, 2])
    seq = g.reshape(seq, [-1, w_sz, ch * h_sz])
    seq = g.add("Transpose", [seq], perm=[1, 0, 2])   # [W, B, C*H]
    cell = "gru" if str(config.get("crnn_rnn_type", "lstm")).lower() == "gru" \
        else "lstm"
    out, width = _bi_rnn(g, seq, params["BiRNN_0"], cell, w_sz, "crnn_rnn")
    last = g.slice_last(out, axis=0)
    flat = g.reshape(last, [-1, width])
    d = params["Dense_0"]
    return g.gemm(flat, d["kernel"], d["bias"], "crnn_out")


def _pack_flax_gru(p: dict):
    """flax nn.GRUCell params (ir/iz/in + hr/hz/hn; hr/hz bias-free) ->
    one-direction ONNX GRU tensors W [1,3H,F], R [1,3H,H], B [1,6H] in
    (z,r,n) gate order with linear_before_reset=1 semantics (the flax cell
    computes n = tanh(in(x) + r*hn(h)) with hn's bias inside the reset
    product — exactly ONNX's Rb_h placement)."""
    def kern(name):
        return np.asarray(p[name]["kernel"], np.float32)

    def bias(name):
        return np.asarray(p[name]["bias"], np.float32) if "bias" in p[name] \
            else np.zeros(kern(name).shape[1], np.float32)

    H = kern("hr").shape[0]
    W = np.concatenate([kern("iz").T, kern("ir").T, kern("in").T], axis=0)
    R = np.concatenate([kern("hz").T, kern("hr").T, kern("hn").T], axis=0)
    B = np.concatenate([bias("iz"), bias("ir"), bias("in"),
                        np.zeros(H, np.float32), np.zeros(H, np.float32),
                        bias("hn")])
    return W[None], R[None], B[None], H


def build_onnx_stateful(model, input_shape=None,
                        weights_dtype=None) -> bytes:
    """StreamingGRUModel -> stateful ONNX with explicit hidden threading.

    Graph contract of the reference interpreter's stateful models: inputs
    `input`/`hidden_in`/`cell_in`, outputs `score` then the new hidden then
    the new cell state. The GRU has no cell state, so `cell_in` passes
    through unchanged."""
    input_shape = tuple(input_shape or model.input_shape)
    t = int(input_shape[0])
    activation = str(model.config.get("activation_function", "relu"))
    params = _to_np(model.variables["params"])
    rnn = params["backbone"]["UniRNN_0"]
    n_layers = len([k for k in rnn if k.startswith("GRUCell_")])

    g = _GraphBuilder(quantize=weights_dtype == "int8")
    xs = g.add("Transpose", ["input"], perm=[1, 0, 2])   # [T, 1, F]
    h_outs = []
    hidden = 0
    for i in range(n_layers):
        W, R, B, hidden = _pack_flax_gru(rnn[f"GRUCell_{i}"])
        h0 = g.slice_range("hidden_in", axis=0, start=i, end=i + 1)
        wn = g.init_tensor(f"sg{i}_W", W, quant_axis=1)
        rn = g.init_tensor(f"sg{i}_R", R, quant_axis=1)
        bn = g.init_tensor(f"sg{i}_B", B)
        y, y_h = g.add("GRU", [xs, wn, rn, bn, "", h0], n_out=2,
                       hidden_size=hidden, linear_before_reset=1)
        xs = g.reshape(y, [t, 1, hidden])                # [T,1,1,H] squeeze
        h_outs.append(y_h)
    last = g.slice_last(xs, axis=0)                      # [1, 1, H]
    flat = g.reshape(last, [1, hidden])
    d = params["backbone"]["Dense_0"]
    emb = g.gemm(flat, d["kernel"], d["bias"], "sg_out")
    h = g.gemm(emb, params["Dense_0"]["kernel"], params["Dense_0"]["bias"],
               "head0")
    h = g.activation(h, activation)
    logits = g.gemm(h, params["Dense_1"]["kernel"],
                    params["Dense_1"]["bias"], "head1")
    g.nodes.append(P.node("Sigmoid", [logits], ["score"], name="n_sigmoid"))
    g.nodes.append(P.node("Concat", h_outs, ["hidden_out"],
                          name="n_hout", axis=0))
    g.nodes.append(P.node("Identity", ["cell_in"], ["cell_out"],
                          name="n_cout"))

    graph = P.graph(
        g.nodes, name=f"{model.model_name}_streaming_gru",
        inputs=[P.value_info("input", (1,) + input_shape),
                P.value_info("hidden_in", (n_layers, 1, hidden)),
                P.value_info("cell_in", (n_layers, 1, hidden))],
        outputs=[P.value_info("score", (1, model.n_classes)),
                 P.value_info("hidden_out", (n_layers, 1, hidden)),
                 P.value_info("cell_out", (n_layers, 1, hidden))],
        initializers=g.inits,
        doc="nanowakeword_tpu_torch stateful streaming_gru wake-word "
            "scorer")
    return P.model(graph, opset=17,
                   doc="exported by nanowakeword_tpu_torch.export.onnx_export")


# ---------------------------------------------------------------------------
# Attention families — MHSA lowered to per-head MatMul/Softmax
# ---------------------------------------------------------------------------

def _mhsa(g: _GraphBuilder, x: str, p: dict, t: int, hint: str) -> str:
    """flax nn.MultiHeadDotProductAttention (self-attention) on [B, T, D]:
    per-head q/k/v MatMuls, 1/sqrt(head_dim) query scaling, Softmax over
    keys, context concat, output projection. Batch stays SYMBOLIC: head
    split/merge reshapes use ONNX's 0 ("copy input dim") at the batch axis
    and MatMul batches over the leading [B, H] dims."""
    n_head, head_dim = p["query"]["bias"].shape
    d_model = p["query"]["kernel"].shape[0]

    def proj(name):
        k = np.asarray(p[name]["kernel"],
                       np.float32).reshape(d_model, n_head * head_dim)
        b = np.asarray(p[name]["bias"], np.float32).reshape(-1)
        return g.dense3d(x, k, b, f"{hint}_{name}")

    q = proj("query")
    k = proj("key")
    v = proj("value")
    q = g.const_mul(q, 1.0 / np.sqrt(head_dim), f"{hint}_scale")

    def heads(tensor, hint2, *, kt=False):
        r = g.reshape(tensor, [0, t, n_head, head_dim])    # [B, T, H, hd]
        r = g.add("Transpose", [r], perm=[0, 2, 1, 3])     # [B, H, T, hd]
        if kt:
            r = g.add("Transpose", [r], perm=[0, 1, 3, 2])  # [B, H, hd, T]
        return r

    scores = g.add("MatMul", [heads(q, "q"), heads(k, "k", kt=True)])
    probs = g.add("Softmax", [scores], axis=-1)            # [B, H, T, T]
    ctx = g.add("MatMul", [probs, heads(v, "v")])          # [B, H, T, hd]
    ctx = g.add("Transpose", [ctx], perm=[0, 2, 1, 3])     # [B, T, H, hd]
    ctx = g.reshape(ctx, [0, t, n_head * head_dim])
    out_k = np.asarray(p["out"]["kernel"],
                       np.float32).reshape(n_head * head_dim, d_model)
    return g.dense3d(ctx, out_k, np.asarray(p["out"]["bias"], np.float32),
                     f"{hint}_out")


def _conv_module(g: _GraphBuilder, x: str, p: dict, stats: dict, t: int,
                 hint: str) -> str:
    """ConvolutionModule (models/architectures.py): LN -> pointwise
    2D expand -> GLU -> depthwise SAME conv over T -> BN -> swish ->
    pointwise. Pointwise (1,)-convs are emitted as MatMuls."""
    d = p["LayerNorm_0"]["scale"].shape[0]
    h = g.layer_norm(x, p["LayerNorm_0"]["scale"], p["LayerNorm_0"]["bias"],
                     f"{hint}_ln")
    h = g.dense3d(h, np.asarray(p["Conv_0"]["kernel"][0], np.float32),
                  p["Conv_0"]["bias"], f"{hint}_pw1")      # [1, T, 2D]
    a = g.slice_range(h, axis=-1, start=0, end=d)
    b = g.slice_range(h, axis=-1, start=d, end=2 * d)
    h = g.add("Mul", [a, g.add("Sigmoid", [b])])           # GLU
    hT = g.add("Transpose", [h], perm=[0, 2, 1])           # [1, D, T]
    dw = np.asarray(p["Conv_1"]["kernel"], np.float32)     # [k, 1, D]
    ksz = dw.shape[0]
    hT = g.conv(hT, _conv1d_kernel(dw), p["Conv_1"]["bias"], f"{hint}_dw",
                pads=[(ksz - 1) // 2, ksz // 2], strides=[1], group=d)
    hT = g.batch_norm(hT, p["BatchNorm_0"], stats["BatchNorm_0"],
                      f"{hint}_bn")
    hT = g.swish(hT)
    h = g.add("Transpose", [hT], perm=[0, 2, 1])
    return g.dense3d(h, np.asarray(p["Conv_2"]["kernel"][0], np.float32),
                     p["Conv_2"]["bias"], f"{hint}_pw2")


def _ff_module(g: _GraphBuilder, x: str, p: dict, hint: str) -> str:
    """FeedForwardModule (models/architectures.py): LN -> 4x Dense
    -> swish -> Dense (dropout is identity at inference)."""
    h = g.layer_norm(x, p["LayerNorm_0"]["scale"], p["LayerNorm_0"]["bias"],
                     f"{hint}_ln")
    h = g.swish(g.dense3d(h, p["Dense_0"]["kernel"], p["Dense_0"]["bias"],
                          f"{hint}_d0"))
    return g.dense3d(h, p["Dense_1"]["kernel"], p["Dense_1"]["bias"],
                     f"{hint}_d1")


def _transformer_backbone(g: _GraphBuilder, x: str, params: dict,
                          t: int) -> str:
    """TransformerModel (models/architectures.py): scaled input
    projection + sinusoidal positions, post-LN encoder layers (relu FFN),
    mean-pool, Dense."""
    from nanowakeword_tpu_torch.models.architectures import \
        sinusoidal_positions
    d_in = params["Dense_0"]
    d_model = d_in["kernel"].shape[1]
    h = g.dense3d(x, d_in["kernel"], d_in["bias"], "tf_in")
    h = g.const_mul(h, float(np.sqrt(d_model)), "tf_sqrtd")
    pe = sinusoidal_positions(t, d_model)[None]            # [1, T, D]
    h = g.add("Add", [h, g.init_tensor("tf_pe", pe)])
    n_layers = len([k for k in params if k.startswith("PostLNEncoderLayer_")])
    for i in range(n_layers):
        lp = params[f"PostLNEncoderLayer_{i}"]
        attn = _mhsa(g, h, lp["MultiHeadDotProductAttention_0"], t,
                     f"tf{i}_attn")
        h = g.layer_norm(g.add("Add", [h, attn]), lp["LayerNorm_0"]["scale"],
                         lp["LayerNorm_0"]["bias"], f"tf{i}_ln0")
        ff = g.add("Relu", [g.dense3d(h, lp["Dense_0"]["kernel"],
                                      lp["Dense_0"]["bias"], f"tf{i}_ff0")])
        ff = g.dense3d(ff, lp["Dense_1"]["kernel"], lp["Dense_1"]["bias"],
                       f"tf{i}_ff1")
        h = g.layer_norm(g.add("Add", [h, ff]), lp["LayerNorm_1"]["scale"],
                         lp["LayerNorm_1"]["bias"], f"tf{i}_ln1")
    pooled = g.reduce_mean(h, axes=[1])                    # [1, D]
    d = params["Dense_1"]
    return g.gemm(pooled, d["kernel"], d["bias"], "tf_out")


def _conformer_backbone(g: _GraphBuilder, x: str, params: dict, stats: dict,
                        t: int) -> str:
    """ConformerModel (models/architectures.py): FF(1/2) + MHSA +
    conv module + FF(1/2) blocks with final LN, mean-pool, Dense."""
    d_in = params["Dense_0"]
    h = g.dense3d(x, d_in["kernel"], d_in["bias"], "cf_in")
    n_layers = len([k for k in params if k.startswith("ConformerBlock_")])
    for i in range(n_layers):
        bp = params[f"ConformerBlock_{i}"]
        bs = stats[f"ConformerBlock_{i}"]
        ff1 = _ff_module(g, h, bp["FeedForwardModule_0"], f"cf{i}_ff1")
        h = g.add("Add", [h, g.const_mul(ff1, 0.5, f"cf{i}_half1")])
        attn = _mhsa(g, h, bp["MultiHeadDotProductAttention_0"], t,
                     f"cf{i}_attn")
        h = g.add("Add", [h, attn])
        conv = _conv_module(g, h, bp["ConvolutionModule_0"],
                            bs["ConvolutionModule_0"], t, f"cf{i}_conv")
        h = g.add("Add", [h, conv])
        ff2 = _ff_module(g, h, bp["FeedForwardModule_1"], f"cf{i}_ff2")
        h = g.add("Add", [h, g.const_mul(ff2, 0.5, f"cf{i}_half2")])
        h = g.layer_norm(h, bp["LayerNorm_0"]["scale"],
                         bp["LayerNorm_0"]["bias"], f"cf{i}_ln")
    pooled = g.reduce_mean(h, axes=[1])
    d = params["Dense_1"]
    return g.gemm(pooled, d["kernel"], d["bias"], "cf_out")


def _ebranchformer_backbone(g: _GraphBuilder, x: str, params: dict,
                            stats: dict, t: int) -> str:
    """EBranchformerModel (models/architectures.py): parallel
    attention/conv branches merged by a sigmoid gate, post-LN, FF."""
    d_in = params["Dense_0"]
    h = g.dense3d(x, d_in["kernel"], d_in["bias"], "eb_in")
    one = None
    n_layers = len([k for k in params if k.startswith("EBranchformerBlock_")])
    for i in range(n_layers):
        bp = params[f"EBranchformerBlock_{i}"]
        bs = stats[f"EBranchformerBlock_{i}"]
        attn_in = g.layer_norm(h, bp["LayerNorm_0"]["scale"],
                               bp["LayerNorm_0"]["bias"], f"eb{i}_ln0")
        attn = _mhsa(g, attn_in, bp["MultiHeadDotProductAttention_0"], t,
                     f"eb{i}_attn")
        conv = _conv_module(g, h, bp["ConvolutionModule_0"],
                            bs["ConvolutionModule_0"], t, f"eb{i}_conv")
        gate = g.add("Sigmoid", [g.dense3d(conv, bp["Dense_0"]["kernel"],
                                           bp["Dense_0"]["bias"],
                                           f"eb{i}_gate")])
        if one is None:
            one = g.init_tensor("c_one_eb", np.float32(1.0))
        merged = g.add("Add", [
            g.add("Mul", [attn, gate]),
            g.add("Mul", [conv, g.add("Sub", [one, gate])])])
        h = g.layer_norm(g.add("Add", [h, merged]),
                         bp["LayerNorm_1"]["scale"],
                         bp["LayerNorm_1"]["bias"], f"eb{i}_ln1")
        h = g.add("Add", [h, _ff_module(g, h, bp["FeedForwardModule_0"],
                                        f"eb{i}_ff")])
    pooled = g.reduce_mean(h, axes=[1])
    d = params["Dense_1"]
    return g.gemm(pooled, d["kernel"], d["bias"], "eb_out")


def build_onnx(model, input_shape=None, weights_dtype=None) -> bytes:
    """A Model (models/model.py) -> serialized ONNX ModelProto bytes."""
    model_type = model.model_type
    if model_type in ("custom", "custom_model"):
        # a user's module: traced by torch.fx and lowered node by node
        # (the JAX package lowers its jaxpr); ExportUnsupported names an op
        # with no lowering
        from nanowakeword_tpu_torch.export.fx_onnx import \
            build_onnx_from_module
        return build_onnx_from_module(
            model.module, tuple(input_shape or model.input_shape),
            int(model.n_classes), name=model.model_name)
    if model_type not in SUPPORTED_TYPES:
        raise ValueError(
            f"ONNX export supports {SUPPORTED_TYPES}; '{model_type}' models "
            "deploy via the .nww artifact.")
    if model_type == "streaming_gru":
        return build_onnx_stateful(model, input_shape=input_shape,
                                   weights_dtype=weights_dtype)
    input_shape = tuple(input_shape or model.input_shape)
    activation = str(model.config.get("activation_function", "relu"))
    variables = model.variables
    params = _to_np(variables["params"])
    stats = _to_np(variables.get("batch_stats", {}))

    g = _GraphBuilder(quantize=weights_dtype == "int8")
    x = "features"
    if model_type == "dnn":
        emb = _dnn_backbone(g, x, params["backbone"], activation)
    elif model_type == "cnn":
        emb = _cnn_backbone(g, x, params["backbone"], activation,
                            input_shape)
    elif model_type == "tcn":
        emb = _tcn_backbone(g, x, params["backbone"], model.config)
    elif model_type == "quartznet":
        emb = _quartznet_backbone(g, x, params["backbone"],
                                  stats.get("backbone", {}))
    elif model_type == "bcresnet":
        emb = _bcresnet_backbone(g, x, params["backbone"],
                                 stats.get("backbone", {}), activation,
                                 input_shape)
    elif model_type in ("lstm", "gru"):
        emb = _rnn_backbone(g, x, params["backbone"], model_type,
                            int(input_shape[0]))
    elif model_type == "rnn":
        emb = _rnn_backbone(g, x, params["backbone"], "lstm",
                            int(input_shape[0]))
    elif model_type == "crnn":
        emb = _crnn_backbone(g, x, params["backbone"],
                             stats.get("backbone", {}), model.config,
                             activation, input_shape)
    elif model_type == "transformer":
        emb = _transformer_backbone(g, x, params["backbone"],
                                    int(input_shape[0]))
    elif model_type == "conformer":
        emb = _conformer_backbone(g, x, params["backbone"],
                                  stats.get("backbone", {}),
                                  int(input_shape[0]))
    else:
        emb = _ebranchformer_backbone(g, x, params["backbone"],
                                      stats.get("backbone", {}),
                                      int(input_shape[0]))

    # shared head (models/model.py): Dense -> act -> Dense -> sigmoid
    h = g.gemm(emb, params["Dense_0"]["kernel"], params["Dense_0"]["bias"],
               "head0")
    h = g.activation(h, activation)
    logits = g.gemm(h, params["Dense_1"]["kernel"], params["Dense_1"]["bias"],
                    "head1")
    g.nodes.append(P.node("Sigmoid", [logits], ["score"], name="n_sigmoid"))

    batch_dim = ("batch_size" if model_type in DYNAMIC_BATCH_TYPES else 1)
    graph = P.graph(
        g.nodes, name=f"{model.model_name}_{model_type}",
        inputs=[P.value_info("features", (batch_dim,) + input_shape)],
        outputs=[P.value_info("score", (batch_dim, model.n_classes))],
        initializers=g.inits,
        doc=f"nanowakeword_tpu_torch {model_type} wake-word scorer")
    return P.model(graph, opset=17,
                   doc="exported by nanowakeword_tpu_torch.export.onnx_export")


def _to_np(tree):
    """A nested dict of arrays -> the same tree of float32 numpy arrays."""
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def export_onnx(model, path: str, input_shape=None,
                weights_dtype=None) -> str:
    """Write `build_onnx`'s graph to `path` -> `path`.
    weights_dtype="int8" emits weight-only-quantized
    graphs (symmetric per-channel int8 initializers + DequantizeLinear);
    None or "float32" emits plain float32."""
    if weights_dtype not in (None, "float32", "int8"):
        raise ValueError("ONNX export supports weights_dtype None/'float32'"
                         f"/'int8', got {weights_dtype!r}")
    data = build_onnx(model, input_shape=input_shape,
                      weights_dtype=weights_dtype)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    print_info(f"ONNX model written to '{path}' "
               f"({len(data) / 1024:.0f} KiB, opset 17)")
    return path
