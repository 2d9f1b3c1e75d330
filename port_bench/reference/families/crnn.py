"""The `crnn` family: 3x3 SAME convolutions, each with eval-mode BatchNorm
(eps 1e-5), ReLU and 2x2 max-pooling; then a bidirectional GRU over the
pooled feature axis (channels x pooled time per step; gates r, z, n, the
recurrent bias of n inside r * (...), forward and backward layers in turn),
the last step of the last layer through a Dense."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.models import batchnorm, conv2d, dense


def _gru(x, p, prec, reverse):
    xg = dense(x, p["input_proj"], prec)
    if reverse:
        xg = xg.flip(1)
    rec = {"kernel": p["recurrent_kernel"], "bias": p["recurrent_bias"]}
    h = xg.new_zeros(x.shape[0], p["recurrent_kernel"].shape[0])
    outs = []
    for t in range(xg.shape[1]):
        xr, xz, xn = xg[:, t].chunk(3, dim=-1)
        hr, hz, hn = dense(h, rec, prec).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        outs.append(h)
    out = torch.stack(outs, dim=1)
    return out.flip(1) if reverse else out


def backbone(x, variables, prec):
    p, s = variables["params"]["backbone"], variables["batch_stats"]["backbone"]
    h = x[:, None]
    n_convs = sum(k.startswith("Conv_") for k in p)
    for i in range(n_convs):
        h = conv2d(h, p[f"Conv_{i}"], prec, padding=1)
        h = batchnorm(h, p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"],
                      (1, -1, 1, 1))
        h = F.max_pool2d(torch.relu(h), 2, 2)
    b, c, hc, wc = h.shape
    seq = h.permute(0, 3, 1, 2).reshape(b, wc, c * hc)
    rnn = p["BiRNN_0"]
    for layer in range(len(rnn) // 2):
        seq = torch.cat([_gru(seq, rnn[f"FastGRU_{2 * layer}"], prec, False),
                         _gru(seq, rnn[f"FastGRU_{2 * layer + 1}"], prec,
                              True)], dim=-1)
    return dense(seq[:, -1], p["Dense_0"], prec)


def flops(model: dict) -> int:
    """Model FLOPs of the backbone on one window: the convolutions (each
    followed by a 2x2 pool), the input and recurrent products of 3 gates at
    every step of every direction, the Dense from the last step."""
    frames, features = model["input_shape"]
    hidden, emb = model["layer_size"], model["embedding_dim"]
    t, f, c_in, macs = frames, features, 1, 0
    for c in model["crnn_cnn_channels"]:
        macs += t * f * c * c_in * 9
        t, f, c_in = t // 2, f // 2, c
    steps, width = f, c_in * t
    for layer in range(model["n_blocks"]):
        x = width if layer == 0 else 2 * hidden
        macs += 2 * steps * (x * 3 * hidden + hidden * 3 * hidden)
    return 2 * (macs + 2 * hidden * emb)
