"""The `dnn` family: flatten, then Dense -> LayerNorm (eps 1e-6) -> ReLU
blocks, and a Dense."""

from __future__ import annotations

import torch

from port_bench.reference.models import dense, layernorm


def backbone(x, variables, prec):
    p = variables["params"]["backbone"]
    x = x.reshape(x.shape[0], -1)
    n_norms = sum(k.startswith("LayerNorm_") for k in p)
    for i in range(n_norms):
        x = torch.relu(layernorm(dense(x, p[f"Dense_{i}"], prec),
                                 p[f"LayerNorm_{i}"]))
    return dense(x, p[f"Dense_{n_norms}"], prec)


def flops(model: dict) -> int:
    """Model FLOPs of the backbone on one window."""
    frames, features = model["input_shape"]
    width, blocks = model["layer_size"], model["n_blocks"]
    return 2 * (frames * features * width + blocks * width * width
                + width * model["embedding_dim"])
