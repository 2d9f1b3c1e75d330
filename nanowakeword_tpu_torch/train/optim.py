"""Optimizers and learning-rate schedules, computed as optax computes them.

The counterpart of `nanowakeword_tpu/train/optim.py`: AdamW (decoupled
weight decay), Adam with L2 added to the gradient, and SGD with momentum,
behind a global-norm clip, with the onecycle / cyclic (triangular2) /
cosine schedules, driven by the same config keys. Encoder pretraining
passes its own schedule (`warmup_cosine_decay_schedule`).

Each schedule is a function of the step count, written from optax's
definitions (not torch's OneCycleLR, which interpolates differently). The
clip is optax's: `g * max / |g|` when `|g| >= max` (torch's
clip_grad_norm_ adds 1e-6 to the norm). Updates run in place on the
parameter tensors with foreach ops; the step count lives on the host, so a
step never waits for the device.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]


def _cosine_interpolate(start, end, pct):
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Schedule:
    """optax.cosine_onecycle_schedule: cosine from peak/div up to peak over
    the first pct_start of the steps, then down to peak/(div * final)."""
    if transition_steps <= 0:
        raise ValueError("onecycle needs a positive number of steps")
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)]).tolist()

    def schedule(count: int) -> float:
        for i in range(2):
            lo, hi = bounds[i], bounds[i + 1]
            if lo <= count < hi:
                return _cosine_interpolate(values[i], values[i + 1],
                                           (count - lo) / (hi - lo))
        return values[-1] if count >= bounds[-1] else values[0]

    return schedule


def cyclic_triangular2_schedule(base_lr: float, max_lr: float,
                                step_size_up: int,
                                step_size_down: int) -> Schedule:
    """Triangle wave whose amplitude halves each cycle."""
    cycle_len = step_size_up + step_size_down

    def schedule(count: int) -> float:
        cycle = math.floor(count / cycle_len)
        pos = count - cycle * cycle_len
        if pos < step_size_up:
            frac = pos / step_size_up
        else:
            frac = 1.0 - (pos - step_size_up) / step_size_down
        amplitude = (max_lr - base_lr) * (0.5 ** cycle)
        return base_lr + amplitude * min(max(frac, 0.0), 1.0)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule with exponent 1."""
    if decay_steps <= 0:
        raise ValueError("cosine decay needs a positive number of steps")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * decay + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule with end value 0: linear from
    init_value to peak_value over warmup_steps, then a cosine decay to 0
    over the remaining decay_steps - warmup_steps."""
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        return decay(count - warmup_steps)

    return schedule


def build_schedule(config, total_steps: int) -> Schedule:
    """lr_scheduler_type -> schedule function of the step count."""
    sched_type = str(config.get("lr_scheduler_type", "onecycle")).lower()
    max_lr = float(config.get("learning_rate_max", 1e-4))
    if sched_type == "cyclic":
        step_up = int(config["clr_step_size_up"])
        step_down = int(config.get("clr_step_size_down", step_up))
        return cyclic_triangular2_schedule(
            float(config["learning_rate_base"]), max_lr, step_up, step_down)
    if sched_type == "onecycle":
        return cosine_onecycle_schedule(total_steps, max_lr)
    if sched_type == "cosine":
        eta_min = float(config.get("learning_rate_base", 1e-6))
        return cosine_decay_schedule(max_lr, total_steps, eta_min / max_lr)
    raise ValueError(
        f"Unsupported lr_scheduler_type: '{sched_type}'. "
        "Supported types are: 'cyclic', 'onecycle', 'cosine'.")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as a 0-d float32
    tensor. On the CPU the squares are summed in float64: torch's float32
    norm there runs one serial sum per vector lane, which is off by 2e-5
    relative on a 400k-element gradient, where the card's tree reduction
    and XLA's are not."""
    if tensors[0].device.type == "cpu":
        norms = torch._foreach_norm(tensors, 2, dtype=torch.float64)
        return torch.linalg.vector_norm(torch.stack(norms)).float()
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """Clip, then AdamW / Adam+L2 / SGD-momentum, then the schedule, in
    place on `params` (a list of tensors). `schedule` replaces the one the
    config names."""

    def __init__(self, params: List[torch.Tensor], config, total_steps: int,
                 grad_clip: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, schedule: Optional[Schedule] = None):
        self.params = list(params)
        self.kind = str(config.get("optimizer_type", "adamw")).lower()
        if self.kind not in ("adamw", "adam", "sgd"):
            self.kind = "adamw"
        self.weight_decay = float(config.get("weight_decay", 1e-2))
        self.momentum = float(config.get("momentum", 0.9))
        self.schedule = schedule or build_schedule(config, total_steps)
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        zeros = [torch.zeros_like(p) for p in self.params]
        if self.kind == "sgd":
            self.state = {"trace": zeros}
        else:
            self.state = {"mu": zeros,
                          "nu": [torch.zeros_like(p) for p in self.params]}

    def lr(self, count: Optional[int] = None) -> float:
        return self.schedule(self.count if count is None else count)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Apply one update from `grads` (modified in place); returns the
        global norm before the clip, as a 0-d device tensor."""
        g = list(grads)
        norm = global_norm(g)
        if self.grad_clip and self.grad_clip > 0:
            keep = norm < self.grad_clip
            clipped = torch._foreach_div(g, norm)
            torch._foreach_mul_(clipped, self.grad_clip)
            g = [torch.where(keep, t, c) for t, c in zip(g, clipped)]
        lr = self.lr()
        p = self.params
        if self.kind == "sgd":
            torch._foreach_add_(g, torch._foreach_mul(p, self.weight_decay))
            trace = self.state["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)
            update = trace
        else:
            if self.kind == "adam":
                torch._foreach_add_(g, torch._foreach_mul(p, self.weight_decay))
            update = self._adam_direction(g)
            if self.kind == "adamw":
                torch._foreach_add_(update,
                                    torch._foreach_mul(p, self.weight_decay))
        torch._foreach_add_(p, torch._foreach_mul(update, -lr))
        self.count += 1
        return norm

    def _adam_direction(self, g):
        b1, b2 = self.b1, self.b2
        mu, nu = self.state["mu"], self.state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1.0 - b2))
        # the bias corrections in float32, as optax takes them
        t = np.float32(self.count + 1)
        mu_hat = torch._foreach_div(mu, float(1 - np.float32(b1) ** t))
        nu_hat = torch._foreach_div(nu, float(1 - np.float32(b2) ** t))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        return torch._foreach_div(mu_hat, denom)

    def state_dict(self) -> dict:
        return {"count": self.count,
                "state": {k: [t.detach().cpu() for t in v]
                          for k, v in self.state.items()}}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        for k, v in sd["state"].items():
            for dst, src in zip(self.state[k], v):
                dst.copy_(src)
