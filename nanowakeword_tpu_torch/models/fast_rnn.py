"""Recurrent layers with the input projections hoisted out of the loop.

The counterpart of `nanowakeword_tpu/models/fast_rnn.py`: one input
projection over all T steps, then a Python loop over T that keeps only the
recurrent product and the gates. Gate order and formulas are the torch
nn.GRU / nn.LSTM ones (r, z, n for the GRU; i, f, g, o for the LSTM), with
both input and recurrent biases.
"""

from __future__ import annotations

import torch
from torch import nn


class FastGRU(nn.Module):
    """Unidirectional GRU over [B, T, F] -> [B, T, H]."""

    def __init__(self, in_features: int, hidden: int, reverse: bool = False):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        self.input_proj = nn.Linear(in_features, 3 * hidden)
        self.recurrent = nn.Linear(hidden, 3 * hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xg = self.input_proj(x)                       # [B, T, 3H]
        if self.reverse:
            xg = xg.flip(1)
        h = xg.new_zeros(x.shape[0], self.hidden)
        outs = []
        for t in range(xg.shape[1]):
            xr, xz, xn = xg[:, t].chunk(3, dim=-1)
            hr, hz, hn = self.recurrent(h).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            outs.append(h)
        out = torch.stack(outs, dim=1)
        return out.flip(1) if self.reverse else out


class FastLSTM(nn.Module):
    """Unidirectional LSTM over [B, T, F] -> [B, T, H]."""

    def __init__(self, in_features: int, hidden: int, reverse: bool = False):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        self.input_proj = nn.Linear(in_features, 4 * hidden)
        self.recurrent = nn.Linear(hidden, 4 * hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xg = self.input_proj(x)                       # [B, T, 4H]
        if self.reverse:
            xg = xg.flip(1)
        h = xg.new_zeros(x.shape[0], self.hidden)
        c = torch.zeros_like(h)
        outs = []
        for t in range(xg.shape[1]):
            xi, xf, xgate, xo = xg[:, t].chunk(4, dim=-1)
            hi, hf, hgate, ho = self.recurrent(h).chunk(4, dim=-1)
            i = torch.sigmoid(xi + hi)
            f = torch.sigmoid(xf + hf)
            g = torch.tanh(xgate + hgate)
            o = torch.sigmoid(xo + ho)
            c = f * c + i * g
            h = o * torch.tanh(c)
            outs.append(h)
        out = torch.stack(outs, dim=1)
        return out.flip(1) if self.reverse else out
