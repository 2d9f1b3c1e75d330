"""Model wrapper: backbone dispatch + the shared classifier head.

The counterpart of `build_backbone`, `WakeWordModule` and `Model` in
`nanowakeword_tpu/models/model.py`, for the backbones ported so far ("dnn"
and "crnn"). The head is Dense(E -> E/2) -> act -> Dropout -> Dense(-> 1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nanowakeword_tpu_torch.models import architectures as A

PORTED_MODEL_TYPES = ("dnn", "crnn")


def build_backbone(model_type: str, config, input_shape, layer_dim: int,
                   n_blocks: int, dropout_prob: float, embedding_dim: int,
                   activation) -> tuple[nn.Module, bool]:
    """Dispatch model_type -> (backbone module, is_stateful)."""
    mt = model_type.lower()
    if mt == "dnn":
        return A.DNNModel(input_shape, layer_dim, n_blocks, embedding_dim,
                          dropout_prob, activation), False
    if mt == "crnn":
        return A.CRNNModel(
            input_shape,
            cnn_channels=tuple(config.get("crnn_cnn_channels", [16, 32, 32])),
            rnn_type=str(config.get("crnn_rnn_type", "lstm")),
            rnn_hidden_size=layer_dim, n_rnn_layers=n_blocks,
            embedding_dim=embedding_dim, dropout_prob=dropout_prob,
            activation=activation), False
    raise NotImplementedError(
        f"model_type '{model_type}' is not ported to PyTorch yet (ported: "
        f"{', '.join(PORTED_MODEL_TYPES)}); see ROADMAP.md for the rest of "
        "the zoo")


class WakeWordModule(nn.Module):
    """Backbone + the shared classifier head."""

    def __init__(self, backbone: nn.Module, embedding_dim: int,
                 n_classes: int = 1, dropout_prob: float = 0.5,
                 activation=torch.relu):
        super().__init__()
        self.backbone = backbone
        self.head_hidden = nn.Linear(embedding_dim, embedding_dim // 2)
        self.head_dropout = nn.Dropout(dropout_prob)
        self.head_out = nn.Linear(embedding_dim // 2, n_classes)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.activation(self.head_hidden(self.backbone(x)))
        return self.head_out(self.head_dropout(h))


class Model:
    """Host-side model handle: an eval-mode WakeWordModule on `device`."""

    def __init__(self, config, model_name: str, n_classes: int = 1,
                 input_shape=(16, 96), model_type: str = "dnn",
                 layer_dim: int = 128, n_blocks: int = 1,
                 seconds_per_example: Optional[float] = None,
                 dropout_prob: float = 0.5, seed: int = 10,
                 device="cuda"):
        self.config = config
        self.model_name = model_name
        self.model_type = model_type.lower()
        self.n_classes = n_classes
        self.input_shape = tuple(int(s) for s in input_shape)
        self.seconds_per_example = seconds_per_example
        self.device = torch.device(device)

        activation = A.get_activation(config.get("activation_function", "relu"))
        self.embedding_dim = int(config.get("embedding_dim", 64))
        # seeded initial weights without touching the global generator
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            backbone, stateful = build_backbone(
                model_type, config, self.input_shape, layer_dim, n_blocks,
                dropout_prob, self.embedding_dim, activation)
            self.stateful = stateful
            self.module = WakeWordModule(
                backbone, self.embedding_dim, n_classes=n_classes,
                dropout_prob=dropout_prob, activation=activation)
        self.module.to(self.device).eval().requires_grad_(False)

    def load_state_dict(self, state_dict) -> None:
        self.module.load_state_dict(state_dict, strict=True)

    @torch.no_grad()
    def __call__(self, x) -> torch.Tensor:
        """Eval-mode logits for [B, T, F] features -> [B, n_classes]."""
        return self.module(torch.as_tensor(x, dtype=torch.float32,
                                           device=self.device))

    def n_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())
