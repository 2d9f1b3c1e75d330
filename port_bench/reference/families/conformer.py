"""The `conformer` family: a Dense to d_model; blocks of a half-step
feed-forward (LayerNorm, Dense to 4d, swish, Dense), self-attention
(softmax(Q K^T / sqrt(d_head)) V and the output projection, no positions),
the convolution module (LayerNorm, pointwise to 2d, GLU, depthwise SAME
convolution, eval-mode BatchNorm, swish, pointwise), a second half-step
feed-forward and a LayerNorm; the mean over time, a Dense."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference.models import (operands, batchnorm, conv1d, dense,
                                         layernorm, swish)


def _feed_forward(x, p, prec):
    h = swish(dense(layernorm(x, p["LayerNorm_0"]), p["Dense_0"], prec))
    return dense(h, p["Dense_1"], prec)


def _attention(x, p, prec):
    b, t, d = x.shape
    heads, head_dim = p["query"]["kernel"].shape[1:]

    def project(name):
        w = {"kernel": p[name]["kernel"].reshape(d, heads * head_dim),
             "bias": p[name]["bias"].reshape(-1)}
        return dense(x, w, prec).view(b, t, heads, head_dim).transpose(1, 2)

    q = project("query") / math.sqrt(head_dim)
    k, v = project("key"), project("value")
    qa, ka = operands(prec, q, k)
    weights = torch.softmax(qa @ ka.transpose(-1, -2), dim=-1)
    wa, va = operands(prec, weights, v)
    mixed = (wa @ va).transpose(1, 2).reshape(b, t, heads * head_dim)
    out = {"kernel": p["out"]["kernel"].reshape(heads * head_dim, d),
           "bias": p["out"]["bias"]}
    return dense(mixed, out, prec)


def _conv_module(x, p, s, prec):
    h = layernorm(x, p["LayerNorm_0"]).transpose(1, 2)        # [B, d, T]
    h = F.glu(conv1d(h, p["Conv_0"], prec), dim=1)
    taps = p["Conv_1"]["kernel"].shape[0]
    h = conv1d(h, p["Conv_1"], prec, padding=(taps - 1) // 2,
               groups=h.shape[1])
    h = swish(batchnorm(h, p["BatchNorm_0"], s["BatchNorm_0"], (1, -1, 1)))
    return conv1d(h, p["Conv_2"], prec).transpose(1, 2)


def backbone(x, variables, prec):
    p, s = variables["params"]["backbone"], variables["batch_stats"]["backbone"]
    x = dense(x, p["Dense_0"], prec)
    n_blocks = sum(k.startswith("ConformerBlock_") for k in p)
    for i in range(n_blocks):
        bp, bs = p[f"ConformerBlock_{i}"], s[f"ConformerBlock_{i}"]
        x = x + 0.5 * _feed_forward(x, bp["FeedForwardModule_0"], prec)
        x = x + _attention(x, bp["MultiHeadDotProductAttention_0"], prec)
        x = x + _conv_module(x, bp["ConvolutionModule_0"],
                             bs["ConvolutionModule_0"], prec)
        x = x + 0.5 * _feed_forward(x, bp["FeedForwardModule_1"], prec)
        x = layernorm(x, bp["LayerNorm_0"])
    return dense(x.mean(dim=1), p["Dense_1"], prec)


CONV_KERNEL = 31        # the family's depthwise taps


def flops(model: dict) -> int:
    """Model FLOPs of the backbone on one window: the Dense to d_model, per
    block two feed-forwards (d -> 4d -> d), the Q, K, V and output
    projections, Q K^T and the weighted sum of V, and the convolution
    module (pointwise to 2d, depthwise, pointwise); the Dense after the
    mean over time."""
    t, features = model["input_shape"]
    d = model["conformer_d_model"]
    block = (2 * t * 8 * d * d + 4 * t * d * d + 2 * t * t * d
             + t * d * 2 * d + t * d * CONV_KERNEL + t * d * d)
    return 2 * (t * features * d + model["n_blocks"] * block
                + d * model["embedding_dim"])


def _dense(n_in: int, n_out: int) -> dict:
    return {"kernel": (n_in, n_out), "bias": (n_out,)}


def _norm(d: int) -> dict:
    return {"scale": (d,), "bias": (d,)}


def layout(model: dict) -> dict:
    """{"params": ..., "batch_stats": ...}: the shape of every leaf of a
    configuration file's conformer entry, as flax names them."""
    _, features = model["input_shape"]
    d, heads = model["conformer_d_model"], model["conformer_n_head"]
    emb = model["embedding_dim"]
    qkv = {"kernel": (d, heads, d // heads), "bias": (heads, d // heads)}
    ffn = {"LayerNorm_0": _norm(d), "Dense_0": _dense(d, 4 * d),
           "Dense_1": _dense(4 * d, d)}
    block = {
        "FeedForwardModule_0": ffn,
        "MultiHeadDotProductAttention_0": {
            "query": qkv, "key": qkv, "value": qkv,
            "out": {"kernel": (heads, d // heads, d), "bias": (d,)}},
        "ConvolutionModule_0": {
            "LayerNorm_0": _norm(d),
            "Conv_0": {"kernel": (1, d, 2 * d), "bias": (2 * d,)},
            "Conv_1": {"kernel": (CONV_KERNEL, 1, d), "bias": (d,)},
            "BatchNorm_0": _norm(d),
            "Conv_2": {"kernel": (1, d, d), "bias": (d,)}},
        "FeedForwardModule_1": ffn,
        "LayerNorm_0": _norm(d)}
    backbone = {"Dense_0": _dense(features, d), "Dense_1": _dense(d, emb)}
    stats = {}
    for i in range(model["n_blocks"]):
        backbone[f"ConformerBlock_{i}"] = block
        stats[f"ConformerBlock_{i}"] = {"ConvolutionModule_0": {
            "BatchNorm_0": {"mean": (d,), "var": (d,)}}}
    return {"params": {"backbone": backbone,
                       "Dense_0": _dense(emb, emb // 2),
                       "Dense_1": _dense(emb // 2, 1)},
            "batch_stats": {"backbone": stats}}
