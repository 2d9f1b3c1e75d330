"""The training step: forward, loss, logit regularisation, clip, update,
packed metrics; and the eval step.

The counterpart of `nanowakeword_tpu/train/step.py`. torch modules carry
their own state, so the step mutates the module (weights, BatchNorm running
statistics) and the optimizer in place instead of returning a new state.

Dropout draws from the default generator of the module's device. With a
`dropout_seed` the step seeds that generator from (seed, step count) before
every forward, as the reference folds the step into its key: the masks are
then a function of the step alone, so a run resumed from a checkpoint draws
what the uninterrupted run drew, whatever else used the generator.

`compute_dtype: bfloat16` runs the forward and backward on bf16 copies of
the parameters and features; the float32 masters receive the gradient
through the cast, and the optimizer moments, the loss and BatchNorm's
running statistics stay float32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

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

    def start_fetch(self) -> "PendingMetrics":
        """Start the one device -> host copy without waiting for it: on the
        card into a pinned buffer, behind an event on the current stream."""
        if self.packed.device.type != "cuda":
            return PendingMetrics(self.packed.detach(), None)
        host = torch.empty(self.packed.shape, dtype=self.packed.dtype,
                           pin_memory=True)
        host.copy_(self.packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return PendingMetrics(host, event)


class PendingMetrics(NamedTuple):
    """A packed metrics vector on its way to the host."""

    host: torch.Tensor
    event: Optional["torch.cuda.Event"]

    def result(self) -> "HostMetrics":
        if self.event is not None:
            self.event.synchronize()
        return HostMetrics(self.host.numpy())


class HostMetrics(NamedTuple):
    packed: np.ndarray

    @property
    def loss(self) -> float:
        return float(self.packed[0])

    @property
    def grad_norm(self) -> float:
        return float(self.packed[1])

    @property
    def per_example_bce(self) -> np.ndarray:
        b = (self.packed.shape[0] - 2) // 2
        return self.packed[2:2 + b]

    @property
    def logits(self) -> np.ndarray:
        b = (self.packed.shape[0] - 2) // 2
        return self.packed[2 + b:]


def resolve_compute_dtype(compute_dtype) -> Optional[torch.dtype]:
    """A config `compute_dtype` -> the dtype the forward is cast to:
    torch.bfloat16 for "bfloat16"/"bf16", None for full precision
    ("float32"/"f32"/"fp32"). Anything else is a config error: a silent
    fallback would let a "float16" typo train in full precision."""
    name = str(compute_dtype).lower()
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "f32", "fp32"):
        return None
    raise ValueError("training.compute_dtype must be 'float32' or "
                     f"'bfloat16', got {compute_dtype!r}")


def seed_dropout(device: torch.device, seed: int, step: int) -> None:
    """Seed the default generator of `device`, which dropout draws from,
    as a function of (seed, step)."""
    value = (int(seed) * 1_000_003 + int(step)) % (1 << 63)
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        torch.cuda.default_generators[index].manual_seed(value)
    else:
        torch.default_generator.manual_seed(value)


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
                     features: torch.Tensor, labels: torch.Tensor,
                     compute_dtype: Optional[torch.dtype] = None,
                     dropout_seed: Optional[int] = None):
    """Training-mode forward, loss, gradients and one optimizer update.
    -> (loss, grad norm before the clip, logits [B]), all detached. The
    backward convolutions run without TF32 too. `optimizer.params` are the
    module's parameters."""
    module.train()
    if dropout_seed is not None:
        seed_dropout(features.device, dropout_seed, optimizer.count)
    with no_tf32_convs():
        if compute_dtype is None:
            logits = module(features)
        else:
            # the module's buffers (BatchNorm statistics) are not passed,
            # so they stay the float32 tensors the module holds
            cast = {name: p.to(compute_dtype)
                    for name, p in module.named_parameters()}
            logits = torch.func.functional_call(
                module, cast, (features.to(compute_dtype),))
        logits = logits.reshape(-1).float()
        total = total_loss(logits, labels)
        # a parameter the loss does not reach (a frozen encoder) gets a zero
        # gradient, as jax.grad gives it, so the optimizer still decays it
        grads = torch.autograd.grad(total, optimizer.params,
                                    materialize_grads=True)
    grad_norm = optimizer.step(grads)
    return total.detach(), grad_norm, logits.detach()


def make_train_step(module: nn.Module, optimizer: Optimizer, *,
                    compute_dtype: str = "float32",
                    dropout_seed: Optional[int] = None, **loss_kwargs):
    """(features [B, T, F], labels [B]) -> StepMetrics; updates `module`
    and `optimizer` in place."""
    cdt = resolve_compute_dtype(compute_dtype)
    total_loss = make_loss(**loss_kwargs)

    def step(features, labels) -> StepMetrics:
        total, grad_norm, logits = forward_backward(
            module, optimizer, total_loss, features, labels, cdt,
            dropout_seed)
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
