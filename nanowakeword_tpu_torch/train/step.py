"""The training step: forward, loss, logit regularisation, clip, update,
packed metrics; and the eval step.

The counterpart of `nanowakeword_tpu/train/step.py`. torch modules carry
their own state, so the step mutates the module (weights, BatchNorm running
statistics) and the optimizer in place instead of returning a new state.
Dropout draws from torch's generator of the module's device, which the
trainer seeds.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from nanowakeword_tpu_torch.train import loss as losses
from nanowakeword_tpu_torch.train.optim import Optimizer
from nanowakeword_tpu_torch.utils.precision import no_tf32_convs


class StepMetrics(NamedTuple):
    """Step metrics packed into one device vector, so the host reads them
    with one copy: [loss, grad_norm, per_example_bce (B), logits (B)]."""

    packed: torch.Tensor

    @property
    def loss(self):
        return self.packed[0]

    @property
    def grad_norm(self):
        return self.packed[1]

    @property
    def per_example_bce(self):
        b = (self.packed.shape[0] - 2) // 2
        return self.packed[2:2 + b]

    @property
    def logits(self):
        b = (self.packed.shape[0] - 2) // 2
        return self.packed[2 + b:]

    def fetch(self) -> "StepMetrics":
        """One device -> host copy; the result holds a CPU tensor."""
        return StepMetrics(self.packed.cpu())


def resolve_compute_dtype(compute_dtype) -> None:
    """Accept float32; bfloat16 training is not ported yet."""
    name = str(compute_dtype).lower()
    if name in ("float32", "f32", "fp32"):
        return None
    if name in ("bfloat16", "bf16"):
        raise NotImplementedError(
            "compute_dtype 'bfloat16' is not ported to PyTorch yet: bf16 "
            "training is in ROADMAP.md's 'Still to port' queue; use "
            "'float32'")
    raise ValueError("training.compute_dtype must be 'float32' or "
                     f"'bfloat16', got {compute_dtype!r}")


def make_loss(loss_function: str = "bias_weighted", loss_bias: float = 0.75,
              logit_reg_weight: float = 2e-4, logit_reg_margin: float = 6.0,
              afl_gamma_pos: float = 0.0,
              afl_gamma_neg: float = 4.0) -> Callable:
    """(logits [B], labels [B]) -> total training loss (0-d)."""
    name = loss_function.lower()

    def total_loss(logits, labels):
        if name == "asymmetric_focal":
            total, _ = losses.asymmetric_focal_loss(
                logits, labels, loss_bias, gamma_pos=afl_gamma_pos,
                gamma_neg=afl_gamma_neg)
        else:
            total, _ = losses.bias_weighted_loss(logits, labels, loss_bias)
        if logit_reg_weight > 0:
            total = total + logit_reg_weight * losses.logit_regularisation(
                logits, labels, logit_reg_margin)
        return total

    return total_loss


def forward_backward(module: nn.Module, optimizer: Optimizer, total_loss,
                     features: torch.Tensor, labels: torch.Tensor):
    """Training-mode forward, loss, gradients and one optimizer update.
    -> (loss, grad norm before the clip, logits [B]), all detached. The
    backward convolutions run without TF32 too."""
    module.train()
    with no_tf32_convs():
        logits = module(features).reshape(-1).float()
        total = total_loss(logits, labels)
        grads = torch.autograd.grad(total, optimizer.params)
    grad_norm = optimizer.step(grads)
    return total.detach(), grad_norm, logits.detach()


def make_train_step(module: nn.Module, optimizer: Optimizer, *,
                    compute_dtype: str = "float32", **loss_kwargs):
    """(features [B, T, F], labels [B]) -> StepMetrics; updates `module`
    and `optimizer` in place."""
    resolve_compute_dtype(compute_dtype)
    total_loss = make_loss(**loss_kwargs)

    def step(features, labels) -> StepMetrics:
        total, grad_norm, logits = forward_backward(
            module, optimizer, total_loss, features, labels)
        raw = losses.raw_bce(logits, labels)
        return StepMetrics(torch.cat([total.reshape(1),
                                      grad_norm.reshape(1).float(), raw,
                                      logits]))

    return step


def make_eval_step(module: nn.Module):
    """features [B, T, F] -> eval-mode logits [B] (the module's mode is
    restored afterwards)."""

    @torch.no_grad()
    def eval_fn(features):
        was_training = module.training
        module.eval()
        try:
            return module(features).reshape(-1)
        finally:
            module.train(was_training)

    return eval_fn


def to_device_batch(features, labels, device):
    """Host arrays -> float32 tensors on `device`."""
    return (torch.as_tensor(np.asarray(features, np.float32), device=device),
            torch.as_tensor(np.asarray(labels, np.float32), device=device))
