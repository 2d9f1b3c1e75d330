"""The wake-word classifier architecture zoo, as torch modules.

The counterpart of `nanowakeword_tpu/models/architectures.py`: the thirteen
selectable backbones on [B, T, 96] feature frames, each emitting an
`embedding_dim` vector for the shared head (models/model.py), and one the
JAX package does not have, the Granite-4.0-H hybrid (Mamba-2 mixers and
grouped-query attention; its plain reference is
`port_bench/reference/families/granite_hybrid.py`). They are
`nn.Module`s on library calls (matrix products, cuDNN convolutions,
softmax), as the reference computes them in XLA.

flax infers input widths at first call; torch modules take them at
construction, so each backbone here takes the input shape it will see.

Every module with weights of its own lists its sub-modules in the order
the reference constructs them (`flax_order`); convert.py derives flax's
automatic names (`Conv_0`, `BatchNorm_1`, ...) from that order, so the
weights carry across in both directions without a table per family.

Where flax and torch differ, the modules follow flax: LayerNorm eps 1e-6,
BatchNorm momentum 0.99 with the biased variance, `SAME` padding computed
from the input length (with a stride it is not torch's symmetric padding),
the tanh gelu, and attention projections laid out head by head. Inside a
backbone, convolutions see [B, C, T] or [B, C, T, F] where flax sees
channels last.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nanowakeword_tpu_torch.models.fast_rnn import FastGRU, FastLSTM
from nanowakeword_tpu_torch.utils import tracing
from nanowakeword_tpu_torch.utils.precision import no_tf32_convs

Activation = Callable[[torch.Tensor], torch.Tensor]

# flax's defaults, which differ from torch's (LayerNorm 1e-5; BatchNorm
# running statistics updated with weight 0.1 and the unbiased variance)
LAYERNORM_EPS = 1e-6
BATCHNORM_EPS = 1e-5
BATCHNORM_MOMENTUM = 0.99


def get_activation(name: str) -> Activation:
    """relu/gelu/silu selection. flax's gelu is the tanh approximation."""
    name = (name or "relu").lower()
    if name == "gelu":
        return functools.partial(torch.nn.functional.gelu, approximate="tanh")
    if name == "silu":
        return torch.nn.functional.silu
    return torch.relu


class _FlaxBatchNorm:
    """flax `nn.BatchNorm`'s training semantics over [B, C, ...], mixed into
    torch's BatchNorm1d / BatchNorm2d.

    In training mode the batch statistics are mean(x) and the biased
    variance mean(x^2) - mean(x)^2 (flax's fast variance, floored at 0)
    over every axis but the channels, and the running statistics move as
    `running = 0.99 running + 0.01 batch`. Eval mode is torch's batch norm
    on the running statistics, unchanged. Statistics are taken and applied
    in float32 whatever the input's dtype, as flax does, so bf16 training
    keeps float32 running statistics.
    """

    def __init__(self, num_features: int, eps: float = BATCHNORM_EPS,
                 momentum: float = BATCHNORM_MOMENTUM):
        # torch's momentum is the weight of the new batch: 1 - flax's
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and x.dtype == torch.float32:
            return super().forward(x)
        dims = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x.float()
        if self.training:
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            m = self.flax_momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean.view(shape)) * mul.view(shape) + \
            self.bias.view(shape)
        return out.to(x.dtype)


class FlaxBatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """BatchNorm over [B, C, H, W] with flax's semantics."""


class FlaxBatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    """BatchNorm over [B, C, T] with flax's semantics."""


def same_padding(n: int, kernel: int, stride: int = 1,
                 dilation: int = 1) -> tuple:
    """flax / XLA `SAME` padding of one axis of length n -> (before, after):
    the output has ceil(n / stride) positions, the total is what that
    needs, and the smaller half comes first."""
    span = (kernel - 1) * dilation + 1
    total = max((-(-n // stride) - 1) * stride + span - n, 0)
    return total // 2, total - total // 2


class SameConv1d(nn.Conv1d):
    """Conv1d over [B, C, T] with flax's `SAME` padding."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = same_padding(x.shape[-1], self.kernel_size[0],
                              self.stride[0], self.dilation[0])
        if lo != hi:
            x, lo = F.pad(x, (lo, hi)), 0
        return F.conv1d(x, self.weight, self.bias, self.stride, lo,
                        self.dilation, self.groups)


class SameConv2d(nn.Conv2d):
    """Conv2d over [B, C, H, W] with flax's `SAME` padding on both axes."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (t, b), (l, r) = (same_padding(x.shape[-2 + i], self.kernel_size[i],
                                       self.stride[i], self.dilation[i])
                          for i in range(2))
        pad = (t, l)
        if t != b or l != r:
            x, pad = F.pad(x, (l, r, t, b)), (0, 0)
        return F.conv2d(x, self.weight, self.bias, self.stride, pad,
                        self.dilation, self.groups)


class BiRNN(nn.Module):
    """Multi-layer bidirectional LSTM/GRU over [B, T, F] -> [B, T, 2H].

    `layers` holds the directions in the reference's call order: layer i's
    forward RNN is `layers[2i]`, its backward RNN `layers[2i+1]` (flax names
    them FastGRU_{2i} and FastGRU_{2i+1}). Inter-layer dropout only when
    n_layers > 1.
    """

    def __init__(self, in_features: int, hidden: int, n_layers: int = 1,
                 cell: str = "lstm", dropout: float = 0.0):
        super().__init__()
        rnn = FastGRU if cell == "gru" else FastLSTM
        self.layers = nn.ModuleList()
        for i in range(n_layers):
            width = in_features if i == 0 else 2 * hidden
            self.layers.append(rnn(width, hidden, reverse=False))
            self.layers.append(rnn(width, hidden, reverse=True))
        self.dropout = nn.Dropout(dropout if n_layers > 1 else 0.0)

    def flax_order(self):
        return list(self.layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_layers = len(self.layers) // 2
        for i in range(n_layers):
            fwd, bwd = self.layers[2 * i], self.layers[2 * i + 1]
            x = torch.cat([fwd(x), bwd(x)], dim=-1)
            if i < n_layers - 1:
                x = self.dropout(x)
        return x


class UniGRULayer(nn.Module):
    """One causal GRU layer with flax `nn.GRUCell`'s formulas: the input side
    carries the r, z, n biases, the recurrent side has a bias on n only
    (`bias_hn`), and n = tanh(W_in x + b_in + r * (W_hn h + b_hn)). The
    three gates' kernels are stacked in r, z, n order."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.input_proj = nn.Linear(in_features, 3 * hidden)
        self.recurrent = nn.Linear(hidden, 3 * hidden, bias=False)
        self.bias_hn = nn.Parameter(torch.zeros(hidden))

    def initial_carry(self, x: torch.Tensor) -> torch.Tensor:
        return x.new_zeros(x.shape[0], self.hidden)

    def forward(self, x: torch.Tensor, carry: torch.Tensor):
        """[B, T, F], [B, H] -> ([B, T, H], new carry [B, H])."""
        xg = self.input_proj(x)                       # [B, T, 3H]
        h = carry
        outs = []
        for t in range(xg.shape[1]):
            xr, xz, xn = xg[:, t].chunk(3, dim=-1)
            hr, hz, hn = self.recurrent(h).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * (hn + self.bias_hn))
            h = (1.0 - z) * n + z * h
            outs.append(h)
        return torch.stack(outs, dim=1), h


class UniLSTMLayer(nn.Module):
    """One causal LSTM layer with flax `nn.OptimizedLSTMCell`'s layout: no
    bias on the input side, one on the recurrent side, gates stacked in
    i, f, g, o order. The carry is the pair (c, h)."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.input_proj = nn.Linear(in_features, 4 * hidden, bias=False)
        self.recurrent = nn.Linear(hidden, 4 * hidden)

    def initial_carry(self, x: torch.Tensor):
        zeros = x.new_zeros(x.shape[0], self.hidden)
        return zeros, zeros.clone()

    def forward(self, x: torch.Tensor, carry):
        """[B, T, F], (c, h) -> ([B, T, H], new (c, h))."""
        xg = self.input_proj(x)                       # [B, T, 4H]
        c, h = carry
        outs = []
        for t in range(xg.shape[1]):
            xi, xf, xgate, xo = xg[:, t].chunk(4, dim=-1)
            hi, hf, hgate, ho = self.recurrent(h).chunk(4, dim=-1)
            i = torch.sigmoid(hi + xi)
            f = torch.sigmoid(hf + xf)
            g = torch.tanh(hgate + xgate)
            o = torch.sigmoid(ho + xo)
            c = f * c + i * g
            h = o * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1), (c, h)


class UniRNN(nn.Module):
    """Unidirectional (causal, streamable) LSTM/GRU with explicit carry I/O.

    `forward(x, carry)` resumes from `carry`, a tuple with one entry per
    layer (a [B, H] tensor for a GRU, a (c, h) pair for an LSTM); None is
    the zero state. It returns the outputs and the new carry, whose tensors
    stay on the module's device between chunks.
    """

    def __init__(self, in_features: int, hidden: int, n_layers: int = 1,
                 cell: str = "lstm", dropout: float = 0.0):
        super().__init__()
        layer = UniGRULayer if cell == "gru" else UniLSTMLayer
        self.layers = nn.ModuleList(
            layer(in_features if i == 0 else hidden, hidden)
            for i in range(n_layers))
        self.dropout = nn.Dropout(dropout if n_layers > 1 else 0.0)

    def initial_carry(self, x: torch.Tensor) -> tuple:
        """The zero carry for a batch like `x` ([B, T, F])."""
        return tuple(layer.initial_carry(x) for layer in self.layers)

    def forward(self, x: torch.Tensor, carry=None):
        if carry is None:
            carry = self.initial_carry(x)
        new_carries = []
        for i, layer in enumerate(self.layers):
            x, c = layer(x, carry[i])
            new_carries.append(c)
            if i < len(self.layers) - 1:
                x = self.dropout(x)
        return x, tuple(new_carries)


class StreamingGRUModel(nn.Module):
    """Causal GRU with explicit carry, for stateful streaming inference
    (model_type "streaming_gru"): it carries its hidden state across chunks
    and scores each new frame in O(1), where the bidirectional models
    re-score a whole window per chunk."""

    def __init__(self, input_shape, hidden_dim: int, n_layers: int,
                 embedding_dim: int, dropout_prob: float, cell: str = "gru"):
        super().__init__()
        dr = dropout_prob if n_layers > 1 else 0.0
        self.rnn = UniRNN(int(input_shape[-1]), hidden_dim, n_layers, cell,
                          dr)
        self.dropout = nn.Dropout(dropout_prob)
        self.dense = nn.Linear(hidden_dim, embedding_dim)

    def flax_order(self):
        return [self.rnn, self.dense]

    def initial_carry(self, x: torch.Tensor) -> tuple:
        return self.rnn.initial_carry(x)

    def forward(self, x: torch.Tensor, carry=None):
        out, new_carry = self.rnn(x, carry)
        return self.dense(self.dropout(out[:, -1, :])), new_carry


class DNNModel(nn.Module):
    """Flatten, then Dense -> LayerNorm -> act blocks (reference "dnn")."""

    def __init__(self, input_shape, layer_dim: int, n_blocks: int,
                 embedding_dim: int, dropout_prob: float,
                 activation: Activation = torch.relu):
        super().__init__()
        n_in = 1
        for s in input_shape:
            n_in *= int(s)
        widths = [n_in] + [layer_dim] * (n_blocks + 1)
        self.linears = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        self.linears.append(nn.Linear(layer_dim, embedding_dim))
        self.norms = nn.ModuleList(
            nn.LayerNorm(layer_dim, eps=LAYERNORM_EPS)
            for _ in range(n_blocks + 1))
        self.dropout = nn.Dropout(dropout_prob)
        self.activation = activation

    def flax_order(self):
        return [*self.linears, *self.norms]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i, norm in enumerate(self.norms):
            x = self.activation(norm(self.linears[i](x)))
            if i == 0:
                x = self.dropout(x)
        return self.linears[-1](x)


class CRNNModel(nn.Module):
    """Conv stack then bi-RNN, with the reference's geometry: the RNN scans
    the reduced *feature* axis, with channels x reduced-time as the per-step
    feature vector."""

    def __init__(self, input_shape, cnn_channels: Sequence[int],
                 rnn_type: str, rnn_hidden_size: int, n_rnn_layers: int,
                 embedding_dim: int, dropout_prob: float,
                 activation: Activation = torch.relu):
        super().__init__()
        t, f = (int(s) for s in input_shape)
        chans = (1,) + tuple(int(c) for c in cnn_channels)
        # k=3 SAME conv is padding=1; the (2, 2) max-pool is VALID and floors
        self.convs = nn.ModuleList(
            nn.Conv2d(a, b, 3, padding=1) for a, b in zip(chans, chans[1:]))
        self.norms = nn.ModuleList(FlaxBatchNorm2d(c) for c in chans[1:])
        for _ in cnn_channels:
            t, f = t // 2, f // 2
        cell = "gru" if rnn_type.lower() == "gru" else "lstm"
        dr = dropout_prob if n_rnn_layers > 1 else 0.0
        self.rnn = BiRNN(chans[-1] * t, rnn_hidden_size, n_rnn_layers, cell,
                         dr)
        self.dropout = nn.Dropout(dropout_prob)
        self.dense = nn.Linear(2 * rnn_hidden_size, embedding_dim)
        self.activation = activation

    def flax_order(self):
        return [*self.convs, *self.norms, self.rnn, self.dense]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None]                              # [B, 1, T, F]
        with no_tf32_convs():
            for conv, norm in zip(self.convs, self.norms):
                h = self.activation(norm(conv(h)))
                h = torch.nn.functional.max_pool2d(h, 2, 2)
        # [B, C, H', W'] -> sequence over W' with features C*H'
        b, c, hc, wc = h.shape
        seq = h.permute(0, 3, 1, 2).reshape(b, wc, c * hc)
        out = self.rnn(seq)
        return self.dense(self.dropout(out[:, -1, :]))


class CNNModel(nn.Module):
    """Two conv + max-pool stages, then Dense(128) on the flattened map
    (reference "cnn"). The map is flattened channels last, as flax holds
    it, so the Dense kernel carries across unchanged."""

    def __init__(self, input_shape, embedding_dim: int, dropout_prob: float,
                 activation: Activation = torch.relu):
        super().__init__()
        t, f = (int(s) for s in input_shape)
        self.convs = nn.ModuleList([SameConv2d(1, 16, 3),
                                    SameConv2d(16, 32, 3)])
        self.hidden = nn.Linear(32 * (t // 4) * (f // 4), 128)
        self.dropout = nn.Dropout(dropout_prob)
        self.dense = nn.Linear(128, embedding_dim)
        self.activation = activation

    def flax_order(self):
        return [*self.convs, self.hidden, self.dense]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None]                              # [B, 1, T, F]
        with no_tf32_convs():
            for conv in self.convs:
                h = F.max_pool2d(self.activation(conv(h)), 2, 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.dense(self.dropout(self.activation(self.hidden(h))))


class LSTMModel(nn.Module):
    """Bidirectional LSTM (or GRU), last step, Dense (reference "lstm" /
    "gru"). Dropout between layers only when there is more than one."""

    cell = "lstm"

    def __init__(self, input_shape, hidden_dim: int, n_layers: int,
                 embedding_dim: int, dropout_prob: float):
        super().__init__()
        dr = dropout_prob if n_layers > 1 else 0.0
        self.rnn = BiRNN(int(input_shape[-1]), hidden_dim, n_layers,
                         self.cell, dr)
        self.dropout = nn.Dropout(dropout_prob)
        self.dense = nn.Linear(2 * hidden_dim, embedding_dim)

    def flax_order(self):
        return [self.rnn, self.dense]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(self.dropout(self.rnn(x)[:, -1, :]))


class GRUModel(LSTMModel):
    cell = "gru"


class RNNModel(LSTMModel):
    """The fixed bi-LSTM of width 64 (reference "rnn")."""

    def __init__(self, input_shape, n_blocks: int, embedding_dim: int,
                 dropout_prob: float):
        super().__init__(input_shape, 64, n_blocks, embedding_dim,
                         dropout_prob)


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    position = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


class MultiHeadAttention(nn.Module):
    """Self-attention as flax's `nn.MultiHeadDotProductAttention` computes
    it: softmax((Q / sqrt(head_dim)) K^T) V, dropout on the attention
    weights, then the output projection. The four projections have biases;
    row h * head_dim + d of `query.weight` is flax's `query/kernel[:, h, d]`
    and column h * head_dim + d of `out.weight` is `out/kernel[h, d, :]`,
    so the weights carry across by a reshape.

    The Granite hybrid's attention is the same module with other settings:
    `kv_heads` below `n_head` gives grouped-query attention, key and value
    head j serving query heads j g .. j g + g - 1 (g = n_head / kv_heads,
    the order of Hugging Face's `repeat_kv`); `bias=False` drops the four
    biases; `causal` masks every later position; `scale` multiplies Q in
    place of 1 / sqrt(head_dim). The defaults give flax's module as
    described above."""

    def __init__(self, d_model: int, n_head: int, dropout: float,
                 kv_heads: Optional[int] = None, bias: bool = True,
                 causal: bool = False, scale: Optional[float] = None):
        super().__init__()
        kv_heads = kv_heads or n_head
        if d_model % n_head or n_head % kv_heads:
            raise ValueError(f"d_model {d_model} is not divisible by "
                             f"n_head {n_head}, or n_head by kv_heads "
                             f"{kv_heads}")
        self.n_head, self.kv_heads = n_head, kv_heads
        self.head_dim = d_model // n_head
        kv_width = kv_heads * self.head_dim
        self.query = nn.Linear(d_model, d_model, bias=bias)
        self.key = nn.Linear(d_model, kv_width, bias=bias)
        self.value = nn.Linear(d_model, kv_width, bias=bias)
        self.out = nn.Linear(d_model, d_model, bias=bias)
        self.dropout = nn.Dropout(dropout)
        self.causal, self.scale = causal, scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        hd = self.head_dim
        q = self.query(x).view(b, t, self.n_head, hd).transpose(1, 2)
        k = self.key(x).view(b, t, self.kv_heads, hd).transpose(1, 2)
        v = self.value(x).view(b, t, self.kv_heads, hd).transpose(1, 2)
        q = q / math.sqrt(hd) if self.scale is None else q * self.scale
        mixed = self._core(q, k, v)                        # [B, h, T, hd]
        return self.out(mixed.transpose(1, 2).reshape(b, t, d))

    def _core(self, q, k, v):
        """[B, h, T, hd] queries, [B, kv, T, hd] keys and values -> [B, h,
        T, hd]. A group's query heads are stacked along the rows of one
        product with their key head, so no key or value is copied."""
        b, h, t, hd = q.shape
        g = h // self.kv_heads
        q = q.reshape(b, self.kv_heads, g * t, hd)
        scores = q @ k.transpose(-1, -2)                   # [B, kv, gT, T]
        if self.causal:
            later = torch.ones(t, t, dtype=torch.bool,
                               device=q.device).triu_(1)
            scores = scores.view(b, self.kv_heads, g, t, t).masked_fill(
                later, float("-inf")).view(b, self.kv_heads, g * t, t)
        weights = torch.softmax(scores, dim=-1)
        return (self.dropout(weights) @ v).view(b, h, t, hd)


class PostLNEncoderLayer(nn.Module):
    """Post-norm transformer encoder layer with a relu FFN of 4x width."""

    def __init__(self, d_model: int, n_head: int, dropout: float):
        super().__init__()
        self.attention = MultiHeadAttention(d_model, n_head, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LAYERNORM_EPS)
        self.ffn_in = nn.Linear(d_model, 4 * d_model)
        self.ffn_out = nn.Linear(4 * d_model, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LAYERNORM_EPS)
        self.dropout = nn.Dropout(dropout)

    def flax_order(self):
        return [self.attention, self.norm1, self.ffn_in, self.ffn_out,
                self.norm2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.dropout(self.attention(x)))
        h = self.dropout(torch.relu(self.ffn_in(x)))
        return self.norm2(x + self.dropout(self.ffn_out(h)))


class TransformerModel(nn.Module):
    def __init__(self, input_shape, d_model: int, n_head: int, n_layers: int,
                 embedding_dim: int, dropout_prob: float, max_len: int = 512):
        super().__init__()
        self.d_model = d_model
        self.embed = nn.Linear(int(input_shape[-1]), d_model)
        self.register_buffer(
            "positions", torch.from_numpy(sinusoidal_positions(max_len,
                                                               d_model)),
            persistent=False)
        self.dropout = nn.Dropout(dropout_prob)
        self.layers = nn.ModuleList(
            PostLNEncoderLayer(d_model, n_head, dropout_prob)
            for _ in range(n_layers))
        self.dense = nn.Linear(d_model, embedding_dim)

    def flax_order(self):
        return [self.embed, *self.layers, self.dense]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.embed(x) * math.sqrt(self.d_model)
        x = self.dropout(x + self.positions[:x.shape[1]].to(x.dtype))
        for layer in self.layers:
            x = layer(x)
        return self.dense(x.mean(dim=1))


class TemporalBlock(nn.Module):
    """Two causal dilated convolutions over [B, C, T] (left padding only)
    with a residual, which is a 1x1 convolution when the width changes."""

    def __init__(self, n_inputs: int, n_outputs: int, kernel_size: int,
                 dilation: int, dropout: float):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.conv1 = nn.Conv1d(n_inputs, n_outputs, kernel_size,
                               dilation=dilation)
        self.conv2 = nn.Conv1d(n_outputs, n_outputs, kernel_size,
                               dilation=dilation)
        self.residual = (nn.Conv1d(n_inputs, n_outputs, 1)
                         if n_inputs != n_outputs else None)
        self.dropout = nn.Dropout(dropout)

    def flax_order(self):
        order = [self.conv1, self.conv2]
        return order + [self.residual] if self.residual is not None else order

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.dropout(torch.relu(self.conv1(F.pad(x, (self.pad, 0)))))
        out = self.dropout(torch.relu(self.conv2(F.pad(out, (self.pad, 0)))))
        res = x if self.residual is None else self.residual(x)
        return torch.relu(out + res)


class TCNModel(nn.Module):
    def __init__(self, input_shape, num_channels: Sequence[int],
                 embedding_dim: int, kernel_size: int, dropout_prob: float):
        super().__init__()
        chans = (int(input_shape[-1]),) + tuple(int(c) for c in num_channels)
        self.blocks = nn.ModuleList(
            TemporalBlock(a, b, kernel_size, 2 ** i, dropout_prob)
            for i, (a, b) in enumerate(zip(chans, chans[1:])))
        self.dense = nn.Linear(chans[-1], embedding_dim)

    def flax_order(self):
        return [*self.blocks, self.dense]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)                       # [B, F, T]
        with no_tf32_convs():
            for block in self.blocks:
                h = block(h)
        return self.dense(h[:, :, -1])


class QuartzNetBlock(nn.Module):
    """Depthwise + pointwise convolution, BatchNorm, and a residual that is
    a 1x1 convolution + BatchNorm when the width changes, over [B, C, T]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dropout: float):
        super().__init__()
        self.depthwise = SameConv1d(in_channels, in_channels, kernel_size,
                                    groups=in_channels)
        self.pointwise = nn.Conv1d(in_channels, out_channels, 1)
        self.norm = FlaxBatchNorm1d(out_channels)
        self.residual = self.residual_norm = None
        if in_channels != out_channels:
            self.residual = nn.Conv1d(in_channels, out_channels, 1)
            self.residual_norm = FlaxBatchNorm1d(out_channels)
        self.dropout = nn.Dropout(dropout)

    def flax_order(self):
        order = [self.depthwise, self.pointwise, self.norm]
        if self.residual is not None:
            order += [self.residual, self.residual_norm]
        return order

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(self.pointwise(self.depthwise(x)))
        if self.residual is not None:
            x = self.residual_norm(self.residual(x))
        return self.dropout(torch.relu(h + x))


class QuartzNetModel(nn.Module):
    """`quartznet_config` is [[channels, kernel, repetitions], ...]."""

    def __init__(self, input_shape, quartznet_config: Sequence,
                 embedding_dim: int, dropout_prob: float):
        super().__init__()
        width = int(input_shape[-1])
        self.blocks = nn.ModuleList()
        for channels, kernel, reps in quartznet_config:
            for _ in range(int(reps)):
                self.blocks.append(QuartzNetBlock(width, int(channels),
                                                  int(kernel), dropout_prob))
                width = int(channels)
        self.dense = nn.Linear(width, embedding_dim)

    def flax_order(self):
        return [*self.blocks, self.dense]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)                       # [B, F, T]
        with no_tf32_convs():
            for block in self.blocks:
                h = block(h)
        return self.dense(h.mean(dim=2))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class ConvolutionModule(nn.Module):
    """The conformer's convolution module on [B, T, d]: LayerNorm, pointwise
    conv to 2d, GLU, depthwise conv, BatchNorm, swish, pointwise conv, and
    a fixed dropout of 0.1."""

    def __init__(self, d_model: int, kernel_size: int = 31):
        super().__init__()
        self.norm = nn.LayerNorm(d_model, eps=LAYERNORM_EPS)
        self.expand = nn.Conv1d(d_model, 2 * d_model, 1)
        self.depthwise = SameConv1d(d_model, d_model, kernel_size,
                                    groups=d_model)
        self.batch_norm = FlaxBatchNorm1d(d_model)
        self.project = nn.Conv1d(d_model, d_model, 1)
        self.dropout = nn.Dropout(0.1)

    def flax_order(self):
        return [self.norm, self.expand, self.depthwise, self.batch_norm,
                self.project]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(x).transpose(1, 2)            # [B, d, T]
        with no_tf32_convs():
            h = F.glu(self.expand(h), dim=1)        # a * sigmoid(b)
            h = swish(self.batch_norm(self.depthwise(h)))
            h = self.project(h)
        return self.dropout(h.transpose(1, 2))


class FeedForwardModule(nn.Module):
    def __init__(self, d_model: int, dropout: float = 0.1):
        super().__init__()
        self.norm = nn.LayerNorm(d_model, eps=LAYERNORM_EPS)
        self.expand = nn.Linear(d_model, 4 * d_model)
        self.project = nn.Linear(4 * d_model, d_model)
        self.dropout = nn.Dropout(dropout)

    def flax_order(self):
        return [self.norm, self.expand, self.project]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dropout(swish(self.expand(self.norm(x))))
        return self.dropout(self.project(h))


class ConformerBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, dropout: float = 0.1):
        super().__init__()
        self.ffn1 = FeedForwardModule(d_model, dropout)
        self.attention = MultiHeadAttention(d_model, n_head, dropout)
        self.conv = ConvolutionModule(d_model)
        self.ffn2 = FeedForwardModule(d_model, dropout)
        self.norm = nn.LayerNorm(d_model, eps=LAYERNORM_EPS)

    def flax_order(self):
        return [self.ffn1, self.attention, self.conv, self.ffn2, self.norm]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(x)
        x = x + self.attention(x)
        x = x + self.conv(x)
        x = x + 0.5 * self.ffn2(x)
        return self.norm(x)


class _BlockStackModel(nn.Module):
    """Dense to d_model, dropout, a stack of blocks, mean over time, Dense:
    the shape the conformer and the E-Branchformer share."""

    block = None

    def __init__(self, input_shape, d_model: int, n_head: int, n_layers: int,
                 embedding_dim: int, dropout_prob: float):
        super().__init__()
        self.embed = nn.Linear(int(input_shape[-1]), d_model)
        self.dropout = nn.Dropout(dropout_prob)
        self.blocks = nn.ModuleList(
            self.block(d_model, n_head, dropout_prob)
            for _ in range(n_layers))
        self.dense = nn.Linear(d_model, embedding_dim)

    def flax_order(self):
        return [self.embed, *self.blocks, self.dense]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dropout(self.embed(x))
        for block in self.blocks:
            x = block(x)
        return self.dense(x.mean(dim=1))


class ConformerModel(_BlockStackModel):
    block = ConformerBlock


class EBranchformerBlock(nn.Module):
    """Attention and convolution branches on the same input, merged by a
    learned gate, then LayerNorm and a feed-forward residual."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.1):
        super().__init__()
        self.attention_norm = nn.LayerNorm(d_model, eps=LAYERNORM_EPS)
        self.attention = MultiHeadAttention(d_model, n_head, dropout)
        self.conv = ConvolutionModule(d_model)
        self.gate = nn.Linear(d_model, d_model)
        self.merge_norm = nn.LayerNorm(d_model, eps=LAYERNORM_EPS)
        self.ffn = FeedForwardModule(d_model, dropout)

    def flax_order(self):
        return [self.attention_norm, self.attention, self.conv, self.gate,
                self.merge_norm, self.ffn]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn_out = self.attention(self.attention_norm(x))
        conv_out = self.conv(x)
        gate = torch.sigmoid(self.gate(conv_out))
        x = self.merge_norm(x + attn_out * gate + conv_out * (1.0 - gate))
        return x + self.ffn(x)


class EBranchformerModel(_BlockStackModel):
    block = EBranchformerBlock


class BcResNetBlock(nn.Module):
    """Depthwise 3x3 (strided, `SAME`) + pointwise convolution, BatchNorm,
    activation, plus a shortcut that is a strided 1x1 convolution +
    BatchNorm when the stride or the width changes, over [B, C, T, F]."""

    def __init__(self, in_channels: int, out_channels: int,
                 stride: tuple = (1, 1), activation: Activation = torch.relu):
        super().__init__()
        stride = tuple(stride)
        self.shortcut = self.shortcut_norm = None
        if stride != (1, 1) or in_channels != out_channels:
            self.shortcut = SameConv2d(in_channels, out_channels, 1,
                                       stride=stride, bias=False)
            self.shortcut_norm = FlaxBatchNorm2d(out_channels)
        self.depthwise = SameConv2d(in_channels, in_channels, 3,
                                    stride=stride, groups=in_channels,
                                    bias=False)
        self.pointwise = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.norm = FlaxBatchNorm2d(out_channels)
        self.activation = activation

    def flax_order(self):
        order = [self.depthwise, self.pointwise, self.norm]
        if self.shortcut is not None:
            order = [self.shortcut, self.shortcut_norm] + order
        return order

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.shortcut is not None:
            shortcut = self.shortcut_norm(self.shortcut(x))
        h = self.norm(self.pointwise(self.depthwise(x)))
        return self.activation(h) + shortcut


class BcResNetModel(nn.Module):
    def __init__(self, input_shape, embedding_dim: int,
                 dropout_prob: float = 0.2,
                 activation: Activation = torch.relu):
        super().__init__()
        del input_shape     # every layer adapts to the map it is given
        self.stem = SameConv2d(1, 32, 3, bias=False)
        self.stem_norm = FlaxBatchNorm2d(32)
        self.blocks = nn.ModuleList([
            BcResNetBlock(32, 64, (2, 2), activation),
            BcResNetBlock(64, 128, (2, 2), activation),
            BcResNetBlock(128, 256, (2, 1), activation)])
        self.dropout = nn.Dropout(dropout_prob)
        self.dense = nn.Linear(256, embedding_dim)
        self.activation = activation

    def flax_order(self):
        return [self.stem, self.stem_norm, *self.blocks, self.dense]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None]                              # [B, 1, T, F]
        with no_tf32_convs():
            h = self.activation(self.stem_norm(self.stem(h)))
            h = F.max_pool2d(h, 2, 2)
            for block in self.blocks:
                h = block(h)
        return self.dense(self.dropout(h.mean(dim=(2, 3))))


# -- the Granite-4.0-H hybrid: Mamba-2 mixers and grouped-query attention ----

GRANITE_LAYER_TYPES = tuple(
    "attention" if i % 10 == 5 else "mamba" for i in range(40))


class RMSNorm(nn.Module):
    """x / sqrt(mean(x^2) + eps) * scale over the last axis (flax's
    `RMSNorm`, whose one leaf is `scale`)."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) \
            * self.weight


def ssd_chunked(x, dt, a, b, c, chunk: int) -> torch.Tensor:
    """Mamba-2's scan by its chunked algorithm (the SSD of Dao and Gu,
    arXiv:2405.21060, section 6). x [B, T, H, P], dt [B, T, H] (the step
    sizes, after the softplus), a [H] (negative), b and c [B, T, G, N] with
    H a multiple of G -> y [B, T, H, P] where, for head h of group g and
    from the zero state,

        s_t = exp(dt_t a) s_{t-1} + dt_t x_t b_t^T,    y_t = s_t c_t.

    The window is cut into chunks of `chunk` positions (the last is padded
    at its end with zero steps, which change no earlier output). Within a
    chunk y = (L o C B^T)(dt x) with L_ij = exp(sum_{k=j+1..i} dt_k a) for
    i >= j; each chunk's own final state is B^T (dt x) decayed to its end;
    the states are passed from chunk to chunk; and position i reads the
    state that entered its chunk through c_i, decayed to i. The segment
    sums are differences of one cumulative sum per chunk, as the fused
    kernels of Mamba-2 take them."""
    bsz, t, h, p = x.shape
    g, n = b.shape[2:]
    hg = h // g
    q = min(chunk, t)
    nc = -(-t // q)
    if nc * q > t:
        x, dt, b, c = (F.pad(v, (0, 0) * (v.ndim - 2) + (0, nc * q - t))
                       for v in (x, dt, b, c))
    da = (dt * a).view(bsz, nc, q, h).permute(0, 3, 1, 2)      # [B, H, c, q]
    cum = torch.cumsum(da, dim=-1)
    xdt = (x * dt[..., None]).view(bsz, nc, q, h, p).permute(0, 3, 1, 2, 4)
    b = b.view(bsz, nc, q, g, n).permute(0, 3, 1, 2, 4)         # [B, G, c, q, N]
    c = c.view(bsz, nc, q, g, n).permute(0, 3, 1, 2, 4)
    # within each chunk
    later = torch.ones(q, q, dtype=torch.bool, device=x.device).triu_(1)
    mix = (cum[..., :, None] - cum[..., None, :]).masked_fill_(
        later, float("-inf")).exp_()                            # [B, H, c, q, q]
    mix.view(bsz, g, hg, nc, q, q).mul_((c @ b.transpose(-1, -2))[:, :, None])
    y = mix @ xdt                                               # [B, H, c, q, P]
    del mix
    # each chunk's own final state, heads of a group side by side
    xs = (xdt * torch.exp(cum[..., -1:] - cum)[..., None]).view(
        bsz, g, hg, nc, q, p).permute(0, 1, 3, 2, 5, 4).reshape(
        bsz, g, nc, hg * p, q)
    states = (xs @ b).view(bsz, g, nc, hg, p, n)
    # passed from chunk to chunk
    chunk_decay = torch.exp(cum[..., -1]).view(bsz, g, hg, nc)
    s = torch.zeros_like(states[:, :, 0])
    entering = []
    for k in range(nc):
        entering.append(s)
        s = chunk_decay[..., k, None, None] * s + states[:, :, k]
    entering = torch.stack(entering, 2).view(bsz, g, nc, hg * p, n)
    # the entering state read at each position
    y_in = (c @ entering.transpose(-1, -2)).view(bsz, g, nc, q, hg, p)
    y_in = y_in.permute(0, 1, 4, 2, 3, 5).reshape(bsz, h, nc, q, p)
    y = y + y_in * torch.exp(cum)[..., None]
    return y.permute(0, 2, 3, 1, 4).reshape(bsz, nc * q, h, p)[:, :t]


class Mamba2Mixer(nn.Module):
    """Mamba-2's mixer as Granite-4.0-H has it, on [B, T, d]: one input
    projection (no bias) split into z, xBC and dt; a causal depthwise
    convolution over xBC (with bias) and silu, split into x, B and C;
    dt = softplus(dt + dt_bias) and A = -exp(A_log) per head; the SSD scan
    (`ssd_chunked`) plus the skip D x; the gate y * silu(z) normalised by an
    RMSNorm over all of the inner width (one group); the output projection
    (no bias). `A_log`, `D` and `dt_bias` are the mixer's own leaves in the
    flax layout (`flax_params`); a fresh mixer draws them as Mamba-2 does
    (`reset_ssm_`)."""

    flax_params = ("A_log", "D", "dt_bias")

    def __init__(self, d_model: int, n_heads: int, head_dim: int,
                 d_state: int, n_groups: int, d_conv: int, chunk: int,
                 eps: float):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, head_dim
        self.d_state, self.n_groups, self.chunk = d_state, n_groups, chunk
        self.inner = n_heads * head_dim
        conv_dim = self.inner + 2 * n_groups * d_state
        self.in_proj = nn.Linear(d_model, self.inner + conv_dim + n_heads,
                                 bias=False)
        self.conv = nn.Conv1d(conv_dim, conv_dim, d_conv, groups=conv_dim)
        self.A_log = nn.Parameter(torch.zeros(n_heads))
        self.D = nn.Parameter(torch.ones(n_heads))
        self.dt_bias = nn.Parameter(torch.zeros(n_heads))
        self.norm = RMSNorm(self.inner, eps)
        self.out_proj = nn.Linear(self.inner, d_model, bias=False)

    def flax_order(self):
        return [self.in_proj, self.conv, self.norm, self.out_proj]

    @torch.no_grad()
    def reset_ssm_(self, g: torch.Generator, dt_min: float = 1e-3,
                   dt_max: float = 0.1) -> None:
        """Mamba-2's draws: A = -U[1, 16], dt_bias the softplus inverse of
        a step log-uniform in [dt_min, dt_max], D = 1."""
        h = self.n_heads
        self.A_log.copy_(torch.log(1 + 15 * torch.rand(h, generator=g)))
        dt = torch.exp(math.log(dt_min) + torch.rand(h, generator=g)
                       * (math.log(dt_max) - math.log(dt_min)))
        self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        self.D.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bsz, t, _ = x.shape
        h, p, gn = self.n_heads, self.head_dim, self.n_groups * self.d_state
        z, xbc, dt = self.in_proj(x).split(
            [self.inner, self.inner + 2 * gn, h], dim=-1)
        with no_tf32_convs():
            xbc = self.conv(F.pad(xbc.transpose(1, 2),
                                  (self.conv.kernel_size[0] - 1, 0)))
        xs, b, c = F.silu(xbc.transpose(1, 2)).split([self.inner, gn, gn],
                                                     dim=-1)
        xs = xs.reshape(bsz, t, h, p)
        dt = F.softplus(dt + self.dt_bias)
        with tracing.span("nww.ssm.scan", device=x.device, batch=bsz,
                          length=t, heads=h, head_dim=p, state=self.d_state,
                          groups=self.n_groups, chunk=self.chunk):
            y = ssd_chunked(
                xs, dt, -torch.exp(self.A_log),
                b.reshape(bsz, t, self.n_groups, self.d_state),
                c.reshape(bsz, t, self.n_groups, self.d_state), self.chunk)
            y = y + self.D[:, None] * xs
        if not tracing.capturing():
            tracing.counters["ssm.scans"] += 1
            tracing.counters["ssm.frames"] += bsz * t
        y = y.reshape(bsz, t, self.inner) * F.silu(z)
        return self.out_proj(self.norm(y))


class _GraniteAttention(MultiHeadAttention):
    """The hybrid's attention, its core in the device-timed span
    `nww.attention.core` (utils/tracing.py)."""

    def _core(self, q, k, v):
        with tracing.span("nww.attention.core", device=q.device):
            return super()._core(q, k, v)


class GatedMLP(nn.Module):
    """W_out(silu(x W_g) * x W_u), one input projection to twice the inner
    width (gate first, then up), no biases."""

    def __init__(self, d_model: int, inner: int):
        super().__init__()
        self.in_proj = nn.Linear(d_model, 2 * inner, bias=False)
        self.out_proj = nn.Linear(inner, d_model, bias=False)

    def flax_order(self):
        return [self.in_proj, self.out_proj]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.in_proj(x).chunk(2, dim=-1)
        return self.out_proj(F.silu(gate) * up)


class GraniteHybridLayer(nn.Module):
    """h + r mixer(RMSNorm(h)), then h + r MLP(RMSNorm(h)); the mixer is a
    Mamba-2 mixer or causal grouped-query attention without positions."""

    def __init__(self, kind: str, d_model: int, inner: int, mamba: dict,
                 attention: dict, residual_multiplier: float, eps: float):
        super().__init__()
        self.input_norm = RMSNorm(d_model, eps)
        if kind == "mamba":
            self.mixer = Mamba2Mixer(d_model, eps=eps, **mamba)
        elif kind == "attention":
            self.mixer = _GraniteAttention(
                d_model, dropout=0.0, bias=False, causal=True, **attention)
        else:
            raise ValueError(f"unknown Granite layer type {kind!r}")
        self.post_norm = RMSNorm(d_model, eps)
        self.mlp = GatedMLP(d_model, inner)
        self.residual_multiplier = residual_multiplier

    def flax_order(self):
        return [self.input_norm, self.mixer, self.post_norm, self.mlp]

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        r = self.residual_multiplier
        h = h + r * self.mixer(self.input_norm(h))
        return h + r * self.mlp(self.post_norm(h))


class GraniteHybridModel(nn.Module):
    """Granite-4.0-H's decoder stack over feature frames: h = m Dense(e)
    (the token embedding's place, m the embedding multiplier), dropout, the
    layers of `layer_types`, a final RMSNorm of the last frame (a causal
    stack's summary), Dense."""

    def __init__(self, input_shape, d_model: int, layer_types, inner: int,
                 mamba: dict, attention: dict, residual_multiplier: float,
                 embedding_multiplier: float, eps: float, embedding_dim: int,
                 dropout_prob: float):
        super().__init__()
        self.embed = nn.Linear(int(input_shape[-1]), d_model)
        self.dropout = nn.Dropout(dropout_prob)
        self.blocks = nn.ModuleList(
            GraniteHybridLayer(kind, d_model, inner, mamba, attention,
                               residual_multiplier, eps)
            for kind in layer_types)
        self.norm = RMSNorm(d_model, eps)
        self.dense = nn.Linear(d_model, embedding_dim)
        self.embedding_multiplier = embedding_multiplier

    def flax_order(self):
        return [self.embed, *self.blocks, self.norm, self.dense]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dropout(self.embed(x) * self.embedding_multiplier)
        for block in self.blocks:
            x = block(x)
        return self.dense(self.norm(x[:, -1]))
