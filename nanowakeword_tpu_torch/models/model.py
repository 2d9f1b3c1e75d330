"""Model wrapper: backbone dispatch + the shared classifier head.

The counterpart of `build_backbone`, `_build_custom`, `WakeWordModule` and
`Model` in `nanowakeword_tpu/models/model.py`: `model_type` selects one of
the thirteen backbones of models/architectures.py with the reference's
config keys, or a user's `torch.nn.Module` loaded from a file path or a
module name ("custom"). The head is Dense(E -> E/2) -> act -> Dropout ->
Dense(-> 1).

A fresh `Model` draws its weights with flax's initializers (lecun-normal
kernels, zero biases, orthogonal GRU/LSTM recurrent kernels, unit norm
scales) from a seeded `torch.Generator`, so a model the port trains from
scratch starts from the reference's distribution. `variables` and
`load_variables` speak the reference's flax layout (convert.py), which the
`.nww` writer and the trainer's SWA pool use. `plot_history` draws the
training graph where matplotlib is installed.
"""

from __future__ import annotations

import collections
import importlib
import importlib.util
import inspect
import math
import os
from typing import Optional

import torch
from torch import nn

from nanowakeword_tpu_torch.convert import (flax_variables_from_state_dict,
                                            model_state_dict_from_flax)
from nanowakeword_tpu_torch.models import architectures as A
from nanowakeword_tpu_torch.models.fast_rnn import FastGRU, FastLSTM
from nanowakeword_tpu_torch.utils.logger import print_info

UNSTABLE_ARCHS = {"conformer", "e_branchformer", "crnn"}
# flax's truncated normal keeps [-2, 2] of a unit normal, whose std is this
_TRUNC_STD = 0.87962566103423978


def build_backbone(model_type: str, config, input_shape, layer_dim: int,
                   n_blocks: int, dropout_prob: float, embedding_dim: int,
                   activation) -> tuple[nn.Module, bool]:
    """Dispatch model_type -> (backbone module, is_stateful), with the
    reference's config keys."""
    mt = model_type.lower()
    if mt == "dnn":
        return A.DNNModel(input_shape, layer_dim, n_blocks, embedding_dim,
                          dropout_prob, activation), False
    if mt == "cnn":
        return A.CNNModel(input_shape, embedding_dim, dropout_prob,
                          activation), False
    if mt == "lstm":
        return A.LSTMModel(input_shape, layer_dim, n_blocks, embedding_dim,
                           dropout_prob), False
    if mt == "gru":
        return A.GRUModel(input_shape, layer_dim, n_blocks, embedding_dim,
                          dropout_prob), False
    if mt == "rnn":
        return A.RNNModel(input_shape, n_blocks, embedding_dim,
                          dropout_prob), False
    if mt == "streaming_gru":
        return A.StreamingGRUModel(input_shape, layer_dim, n_blocks,
                                   embedding_dim, dropout_prob), True
    if mt == "transformer":
        return A.TransformerModel(
            input_shape,
            d_model=int(config.get("transformer_d_model", 128)),
            n_head=int(config.get("transformer_n_head", 4)),
            n_layers=n_blocks, embedding_dim=embedding_dim,
            dropout_prob=dropout_prob), False
    if mt == "crnn":
        return A.CRNNModel(
            input_shape,
            cnn_channels=tuple(config.get("crnn_cnn_channels", [16, 32, 32])),
            rnn_type=str(config.get("crnn_rnn_type", "lstm")),
            rnn_hidden_size=layer_dim, n_rnn_layers=n_blocks,
            embedding_dim=embedding_dim, dropout_prob=dropout_prob,
            activation=activation), False
    if mt == "tcn":
        return A.TCNModel(
            input_shape,
            num_channels=tuple(config.get("tcn_channels", [64, 64, 128])),
            embedding_dim=embedding_dim,
            kernel_size=int(config.get("tcn_kernel_size", 3)),
            dropout_prob=dropout_prob), False
    if mt == "quartznet":
        qcfg = config.get("quartznet_config",
                          [[256, 33, 1], [256, 33, 1], [512, 39, 1]])
        return A.QuartzNetModel(
            input_shape, quartznet_config=tuple(tuple(b) for b in qcfg),
            embedding_dim=embedding_dim, dropout_prob=dropout_prob), False
    if mt == "conformer":
        return A.ConformerModel(
            input_shape,
            d_model=int(config.get("conformer_d_model", 144)),
            n_head=int(config.get("conformer_n_head", 4)),
            n_layers=n_blocks, embedding_dim=embedding_dim,
            dropout_prob=dropout_prob), False
    if mt == "e_branchformer":
        return A.EBranchformerModel(
            input_shape,
            d_model=int(config.get("branchformer_d_model", 144)),
            n_head=int(config.get("branchformer_n_head", 4)),
            n_layers=n_blocks, embedding_dim=embedding_dim,
            dropout_prob=dropout_prob), False
    if mt == "bcresnet":
        return A.BcResNetModel(input_shape, embedding_dim, dropout_prob,
                               activation), False
    if mt in {"custom", "custom_model"}:
        return _build_custom(config, input_shape, embedding_dim, dropout_prob,
                             activation), False
    raise ValueError(f"Unsupported model_type: '{model_type}'.")


def _build_custom(config, input_shape, embedding_dim, dropout_prob,
                  activation) -> nn.Module:
    """Load a user's `torch.nn.Module` from a file path or an importable
    module name. It maps [B, T, F] features to a [B, embedding_dim]
    vector; of `input_shape`, `embedding_dim`, `dropout_prob` and
    `activation` it is given those its constructor names, then
    `custom_model_config.params`."""
    custom_cfg = config.get("custom_model_config", {})
    module_path = custom_cfg.get("module_path")
    class_name = custom_cfg.get("class_name")
    if not module_path or not class_name:
        raise ValueError(
            "For model_type='custom', custom_model_config must contain "
            "'module_path' and 'class_name'.")

    abs_path = os.path.abspath(str(module_path))
    if os.path.isfile(abs_path):
        module_name = os.path.splitext(os.path.basename(abs_path))[0]
        spec = importlib.util.spec_from_file_location(module_name, abs_path)
        if spec is None or spec.loader is None:
            raise ImportError(f"Unable to load custom module from '{abs_path}'")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(str(module_path))

    custom_class = getattr(module, str(class_name), None)
    if custom_class is None:
        raise AttributeError(
            f"Custom model class '{class_name}' not found in '{module_path}'.")

    params_cfg = custom_cfg.get("params", {}) or {}
    if hasattr(params_cfg, "to_dict"):
        params_cfg = params_cfg.to_dict()
    base_kwargs = {
        "input_shape": tuple(input_shape),
        "embedding_dim": embedding_dim,
        "dropout_prob": dropout_prob,
        "activation": activation,
    }
    try:
        sig = inspect.signature(custom_class)
        supported = {k: v for k, v in base_kwargs.items()
                     if k in sig.parameters}
    except (ValueError, TypeError):
        supported = base_kwargs
    supported.update(params_cfg)
    return custom_class(**supported)


class WakeWordModule(nn.Module):
    """Backbone + the shared classifier head. A stateful module's forward
    takes and returns the backbone's carry: `(x, carry) -> (logits, carry)`."""

    def __init__(self, backbone: nn.Module, embedding_dim: int,
                 n_classes: int = 1, dropout_prob: float = 0.5,
                 activation=torch.relu, stateful: bool = False):
        super().__init__()
        self.backbone = backbone
        self.stateful = stateful
        self.head_hidden = nn.Linear(embedding_dim, embedding_dim // 2)
        self.head_dropout = nn.Dropout(dropout_prob)
        self.head_out = nn.Linear(embedding_dim // 2, n_classes)
        self.activation = activation

    def forward(self, x: torch.Tensor, carry=None):
        if self.stateful:
            emb, new_carry = self.backbone(x, carry)
        else:
            emb = self.backbone(x)
        h = self.activation(self.head_hidden(emb))
        logits = self.head_out(self.head_dropout(h))
        return (logits, new_carry) if self.stateful else logits


@torch.no_grad()
def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   g: torch.Generator) -> None:
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
    w.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


@torch.no_grad()
def _orthogonal_(w: torch.Tensor, g: torch.Generator) -> None:
    """flax's orthogonal init of the [H, kH] kernel, stored as its [kH, H]
    transpose: a QR of a normal [kH, H] matrix with R's diagonal signs
    folded in, so the flax kernel has orthonormal rows."""
    a = torch.randn(w.shape, generator=g, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    w.copy_(q * torch.sign(torch.diagonal(r))[None, :])


@torch.no_grad()
def flax_init_(module: nn.Module, g: torch.Generator) -> None:
    """Re-draw every weight of `module` with flax's default initializers:
    lecun-normal kernels (fan-in over the kernel's input axes: the width for
    a Dense or an attention projection, channels per group times taps for a
    convolution), zero biases, unit norm scales, orthogonal recurrent
    kernels. A custom backbone keeps its own initialization."""
    recurrent = {id(m.recurrent) for m in module.modules()
                 if isinstance(m, (FastGRU, FastLSTM))}
    # flax's GRUCell / OptimizedLSTMCell draw one orthogonal [H, H] kernel
    # per gate
    per_gate = {id(m.recurrent) for m in module.modules()
                if isinstance(m, (A.UniGRULayer, A.UniLSTMLayer))}
    custom = set()
    backbone = getattr(module, "backbone", None)
    if backbone is not None and not hasattr(backbone, "flax_order"):
        custom = {id(m) for m in backbone.modules()}
    for m in module.modules():
        if id(m) in custom:
            continue
        if isinstance(m, nn.Linear):
            if id(m) in recurrent:
                _orthogonal_(m.weight, g)
            elif id(m) in per_gate:
                for block in m.weight.split(m.in_features, dim=0):
                    _orthogonal_(block, g)
            else:
                _lecun_normal_(m.weight, m.in_features, g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, A.UniGRULayer):
            m.bias_hn.zero_()
        elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
            _lecun_normal_(m.weight, m.weight[0].numel(), g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()


class Model:
    """Host-side model handle: a WakeWordModule on `device`, eval mode by
    default; `train()` makes its parameters trainable."""

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
        self.history = collections.defaultdict(list)
        self._build_args = {"layer_dim": layer_dim, "n_blocks": n_blocks,
                            "dropout_prob": dropout_prob}

        if self.model_type in UNSTABLE_ARCHS:
            print_info(
                f"\n[WARNING] The '{model_type.upper()}' architecture is highly "
                "sensitive to hyperparameters and may exhibit convergence "
                "instability.\n")

        activation = A.get_activation(config.get("activation_function", "relu"))
        self.embedding_dim = int(config.get("embedding_dim", 64))
        backbone, stateful = build_backbone(
            model_type, config, self.input_shape, layer_dim, n_blocks,
            dropout_prob, self.embedding_dim, activation)
        self.stateful = stateful
        self.module = WakeWordModule(
            backbone, self.embedding_dim, n_classes=n_classes,
            dropout_prob=dropout_prob, activation=activation,
            stateful=stateful)
        flax_init_(self.module, torch.Generator().manual_seed(seed))
        self.module.to(self.device)
        self.eval()

    def train(self) -> "Model":
        """Training mode: dropout and batch statistics on, gradients on."""
        self.module.train().requires_grad_(True)
        return self

    def eval(self) -> "Model":
        self.module.eval().requires_grad_(False)
        return self

    def load_state_dict(self, state_dict) -> None:
        self.module.load_state_dict(state_dict, strict=True)

    @property
    def variables(self) -> dict:
        """The weights in the reference's flax layout, as numpy arrays."""
        return flax_variables_from_state_dict(self.module.state_dict(), self)

    def load_variables(self, variables) -> None:
        """Load weights given in the reference's flax layout."""
        self.load_state_dict(model_state_dict_from_flax(variables, self))

    @staticmethod
    def average_models(state_dicts: list) -> dict:
        """Average a list of state_dicts (floating-point entries only)."""
        if not state_dicts:
            raise ValueError("Cannot average an empty list of state dicts.")
        out = {}
        for k, first in state_dicts[0].items():
            if torch.is_floating_point(first):
                out[k] = sum(sd[k].float() for sd in state_dicts) / len(
                    state_dicts)
            else:
                out[k] = first
        return out

    @torch.no_grad()
    def __call__(self, x):
        """Eval-mode logits for [B, T, F] features -> [B, n_classes]; a
        stateful model starts from the zero carry and returns
        (logits, carry)."""
        return self.module(torch.as_tensor(x, dtype=torch.float32,
                                           device=self.device))

    def n_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    def summary(self) -> str:
        """Name, input shape, parameter count and every parameter of the
        flax layout with its shape; printed and returned."""
        lines = [f"Model '{self.model_name}' ({self.model_type})",
                 f"  input shape : {self.input_shape}",
                 f"  parameters  : {self.n_params():,}"]

        def walk(tree, path):
            for k in sorted(tree):
                if isinstance(tree[k], dict):
                    walk(tree[k], path + [k])
                else:
                    name = "/".join(path + [k])
                    lines.append(f"    {name:50s} "
                                 f"{str(tuple(tree[k].shape)):>18s}")

        walk(self.variables["params"], [])
        out = "\n".join(lines)
        print_info(out)
        return out

    def plot_history(self, output_dir: str) -> Optional[str]:
        """The training graph (loss and its EMA, validation loss, recall
        and FPR) as `<output_dir>/graphs/training_performance_graph.png`.
        Without matplotlib it logs one line and returns None."""
        try:
            import matplotlib
        except ImportError:
            print_info("matplotlib is not installed; the training graph is "
                       "skipped.")
            return None
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np

        print_info("Generating training performance graph...")
        graph_dir = os.path.join(output_dir, "graphs")
        os.makedirs(graph_dir, exist_ok=True)

        loss_history = np.asarray(self.history.get("loss", []), np.float64)
        alpha = float(self.config.get("ema_alpha", 0.01))
        ema, ema_hist = None, []
        for v in loss_history:
            ema = v if ema is None else alpha * v + (1 - alpha) * ema
            ema_hist.append(ema)

        fig, ax_loss = plt.subplots(figsize=(13, 6))
        ax_rate = ax_loss.twinx()
        lines = []
        line, = ax_loss.plot(loss_history, color="#7EB6E8", alpha=0.3,
                             linewidth=1.0, label="Train Loss (Raw)")
        lines.append(line)
        line, = ax_loss.plot(ema_hist, color="#1A5FA6", linewidth=2.2,
                             label="Train Loss (EMA)")
        lines.append(line)
        if self.history.get("val_loss"):
            line, = ax_loss.plot(self.history["val_loss_steps"],
                                 self.history["val_loss"], color="#B85C00",
                                 linestyle="--", marker="o", markersize=4,
                                 linewidth=2.2, label="Val Loss")
            lines.append(line)
        ax_loss.set_ylabel("Loss", color="#1A5FA6")
        ax_loss.set_ylim(bottom=0)

        tr_steps = self.history.get("train_recall_steps", [])
        tr_vals = self.history.get("train_recall", [])
        if tr_vals:
            ema_r, ema_tr = None, []
            for r in tr_vals:
                ema_r = r if ema_r is None else 0.05 * r + 0.95 * ema_r
                ema_tr.append(ema_r)
            line, = ax_rate.plot(tr_steps, tr_vals, color="#82E0AA",
                                 alpha=0.4, linewidth=1.0,
                                 label="Train Recall (Raw)")
            lines.append(line)
            line, = ax_rate.plot(tr_steps, ema_tr, color="#1A8A44",
                                 linewidth=2.2, label="Train Recall (EMA)")
            lines.append(line)
        if self.history.get("val_recall"):
            vs = self.history["val_recall_steps"]
            line, = ax_rate.plot(vs, self.history["val_recall"],
                                 color="#C0392B", linestyle="--", marker="o",
                                 markersize=4, linewidth=2.2,
                                 label="Val Recall")
            lines.append(line)
            line, = ax_rate.plot(vs, self.history["val_fpr"],
                                 color="#7D3C98", linestyle=":", marker="s",
                                 markersize=3, linewidth=2.0, label="Val FPR")
            lines.append(line)
        ax_rate.set_ylabel("Recall / FPR", color="#555555")
        ax_rate.set_ylim(-0.02, 1.05)
        ax_loss.set_title("Training Performance", fontsize=14, weight="bold")
        ax_loss.set_xlabel("Training Steps")
        ax_loss.grid(True, linestyle="--", alpha=0.25)
        ax_loss.legend(lines, [ln.get_label() for ln in lines], loc="best",
                       frameon=True, framealpha=0.7, facecolor="white",
                       fontsize=9)
        save_path = os.path.join(graph_dir, "training_performance_graph.png")
        plt.tight_layout()
        plt.savefig(save_path, dpi=150)
        plt.close(fig)
        print_info(f"Performance graph saved to: {save_path}")
        return save_path
