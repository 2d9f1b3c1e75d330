"""The classifier backbones of the shipped artifacts, as torch modules.

The counterparts of `get_activation`, `BiRNN`, `UniRNN`, `DNNModel`,
`CRNNModel` and `StreamingGRUModel` in
`nanowakeword_tpu/models/architectures.py`, on [B, T, 96] feature frames,
emitting an `embedding_dim` vector for the shared head (models/model.py).
The rest of the zoo is still to be ported (ROADMAP.md).

flax infers input widths at first call; torch modules take them at
construction, so each backbone here takes the input shape it will see.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch
from torch import nn

from nanowakeword_tpu_torch.models.fast_rnn import FastGRU, FastLSTM
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


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over [B, C, H, W] with flax `nn.BatchNorm`'s training
    semantics.

    In training mode the batch statistics are mean(x) and the biased
    variance mean(x^2) - mean(x)^2 (flax's fast variance, floored at 0)
    over (B, H, W), and the running statistics move as
    `running = 0.99 running + 0.01 batch`. Eval mode is torch's
    BatchNorm2d on the running statistics, unchanged.
    """

    def __init__(self, num_features: int, eps: float = BATCHNORM_EPS,
                 momentum: float = BATCHNORM_MOMENTUM):
        # torch's momentum is the weight of the new batch: 1 - flax's
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = (0, 2, 3)
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        m = self.flax_momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
            self.num_batches_tracked.add_(1)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + \
            self.bias.view(shape)


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
