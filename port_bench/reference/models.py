"""Plain forward passes of the speech encoder and the classifier head, and
the layers that the model families (reference/families/<model_type>.py)
share, on flax variable trees.

Each function reads its weights in the flax layout that the `.nww` artifact
stores (`kernel` [in, out] for a Dense, [kh, kw, in, out] or [k, in, out]
for a convolution, `scale` for a norm):

* the wide speech encoder: a [10, 32] convolution over (time, mel) with
  stride (2, 1), 1-D convolutions of 8 (stride 2), 8 (stride 2) and 4 taps,
  ReLU after each, a Dense to 96; VALID padding, so one output per stride-8
  window of 76 mel frames;
* the head of every family: Dense(E -> E/2), ReLU, Dense(-> 1), sigmoid.

`Precision` says how a forward computes. The reference itself runs in
float64. The control runs in float32 with every operand of a matrix
product or a convolution rounded to TF32 (10 explicit mantissa bits, round
to nearest, ties away), which is what the tensor cores do with float32
inputs when TF32 is allowed; rounding in software makes the control the
same on every device.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

LAYERNORM_EPS = 1e-6
BATCHNORM_EPS = 1e-5


@dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float64
    tf32: bool = False


REFERENCE = Precision(torch.float64, False)
CONTROL_TF32 = Precision(torch.float32, True)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10 mantissa bits, ties away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def to_tensors(tree, prec: Precision, device) -> dict:
    """A flax tree of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, prec, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float32)).to(device,
                                                            prec.dtype)


def operands(prec: Precision, *xs):
    """The operands of a product or a convolution, rounded to TF32 in the
    control."""
    return tuple(tf32_round(x) for x in xs) if prec.tf32 else xs


def dense(x, p, prec):
    a, w = operands(prec, x, p["kernel"])
    return a @ w + p["bias"]


def conv2d(x, p, prec, stride=1, padding=0):
    a, w = operands(prec, x, p["kernel"].permute(3, 2, 0, 1))
    return F.conv2d(a, w, p["bias"], stride, padding)


def conv1d(x, p, prec, stride=1, padding=0, groups=1):
    a, w = operands(prec, x, p["kernel"].permute(2, 1, 0))
    return F.conv1d(a, w, p["bias"], stride, padding, 1, groups)


def layernorm(x, p, eps=LAYERNORM_EPS):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def batchnorm(x, p, stats, channel_shape):
    """Eval-mode BatchNorm over channel axis 1."""
    def c(t):
        return t.reshape(channel_shape)
    return (x - c(stats["mean"])) / torch.sqrt(c(stats["var"])
                                              + BATCHNORM_EPS) \
        * c(p["scale"]) + c(p["bias"])


def swish(x):
    return x * torch.sigmoid(x)


def encoder(mel, p, prec):
    """[B, T, 32] log-mel -> [B, (T - 76) // 8 + 1, 96] embeddings (the
    wide encoder; its width is the first kernel's output count)."""
    p = p.get("params", p)
    x = mel.to(prec.dtype)[:, None]
    x = torch.relu(conv2d(x, p["Conv_0"], prec, stride=(2, 1))).squeeze(3)
    for i, stride in ((1, 2), (2, 2), (3, 1)):
        x = torch.relu(conv1d(x, p[f"Conv_{i}"], prec, stride=stride))
    return dense(x.transpose(1, 2), p["Dense_0"], prec)


def family(model_type: str):
    """The module of reference/families/ for a model family."""
    return importlib.import_module("port_bench.reference.families."
                                   + model_type)


def classifier(feats, variables, model_type: str, prec: Precision):
    """[B, 16, 96] features -> [B] probabilities (in `prec.dtype`)."""
    emb = family(model_type).backbone(feats.to(prec.dtype), variables, prec)
    p = variables["params"]
    h = torch.relu(dense(emb, p["Dense_0"], prec))
    return torch.sigmoid(dense(h, p["Dense_1"], prec)).reshape(-1)
