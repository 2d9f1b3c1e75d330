"""Knowledge distillation: teacher -> tiny DNN "lite" gate model.

The counterpart of `nanowakeword_tpu/train/distill.py`: `distill_model`
from a trained teacher in memory, `distill_from_artifact` from an exported
`.nww`, and the student recipe: always a DNN, by default layer 8 / blocks 1
/ embedding 8, about 12.5k parameters; loss = alpha * T^2 * binaryKL +
(1 - alpha) * BCE with T = 4.0 and alpha = 0.7; AdamW under the one-cycle
schedule over 8000 steps, global-norm clip 1.0, and the weights of the best
loss EMA restored at the end. The lite model is the gate of the
interpreter's cascade (`load_model(..., cascade=True)`).

Everything per step stays on the device. The features are uploaded once
(after a check against the device's free memory) and each dispatch of up to
250 steps ships only the sampler's [K, batch] row indices. The loss EMA
(0.02, seeded by the first loss) and the best (EMA, weights) pair, kept on a
strict `<`, are device tensors updated without a host read; the host reads
one EMA value per dispatch, for the log. The frozen teacher runs in eval
mode inside the same step. Dropout's masks are a function of (10, step).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nanowakeword_tpu_torch.models.model import Model
from nanowakeword_tpu_torch.train.cached import materialize_rows
from nanowakeword_tpu_torch.train.loss import distill_loss
from nanowakeword_tpu_torch.train.optim import Optimizer
from nanowakeword_tpu_torch.train.step import seed_dropout
from nanowakeword_tpu_torch.utils.logger import print_info
from nanowakeword_tpu_torch.utils.precision import no_tf32_convs

DROPOUT_SEED = 10
EMA_ALPHA = 0.02
STEPS_PER_DISPATCH = 250
# share of the device's free memory that the cached features may take
CACHE_MEMORY_SHARE = 0.8


def build_student(teacher_name: str, input_shape: Tuple[int, ...],
                  dist_cfg, device="cuda") -> Model:
    """Tiny DNN student with the teacher's I/O interface."""
    student_config = {
        "activation_function": "relu",
        "embedding_dim": int(dist_cfg.get("student_embedding_dim", 8)),
    }
    return Model(
        config=student_config,
        model_name=teacher_name + "_lite",
        n_classes=1,
        input_shape=input_shape,
        model_type="dnn",
        layer_dim=int(dist_cfg.get("student_layer_size", 8)),
        n_blocks=int(dist_cfg.get("student_n_blocks", 1)),
        dropout_prob=float(dist_cfg.get("student_dropout_prob", 0.1)),
        device=device,
    )


def distill_optimizer(params, steps: int, lr: float) -> Optimizer:
    """Global-norm clip 1.0, then AdamW (weight decay 1e-3) under the
    one-cycle schedule with its peak `lr` at 30% of `steps`."""
    return Optimizer(list(params), {
        "optimizer_type": "adamw", "weight_decay": 1e-3,
        "lr_scheduler_type": "onecycle", "learning_rate_max": lr,
    }, total_steps=steps)


def make_distill_step(teacher_module, student_module, optimizer: Optimizer,
                      temperature: float, alpha: float):
    """(features [B, T, F], labels [B]) -> loss (0-d, detached); updates the
    student and the optimizer in place. The teacher is evaluated in eval
    mode without gradients; the student in training mode, with dropout
    drawn from (DROPOUT_SEED, the optimizer's step count)."""

    def step(features, labels):
        with no_tf32_convs():
            with torch.no_grad():
                teacher_module.eval()
                t_logits = teacher_module(features).reshape(-1)
            seed_dropout(features.device, DROPOUT_SEED, optimizer.count)
            student_module.train()
            s_logits = student_module(features).reshape(-1)
            loss = distill_loss(s_logits, t_logits, labels, temperature,
                                alpha)
            grads = torch.autograd.grad(loss, optimizer.params)
        optimizer.step(grads)
        return loss.detach()

    return step


def check_cache_fits(n_bytes: int, device: torch.device) -> None:
    """Raise if `n_bytes` of cached features would not fit in the share of
    the card's free memory that the cache may take."""
    if device.type != "cuda":
        return
    free, total = torch.cuda.mem_get_info(device)
    if n_bytes > CACHE_MEMORY_SHARE * free:
        raise MemoryError(
            f"the distillation feature cache needs {n_bytes / 2**30:.2f} GiB "
            f"but the device has {free / 2**30:.2f} GiB free of "
            f"{total / 2**30:.2f} GiB (the cache may take "
            f"{CACHE_MEMORY_SHARE:.0%} of what is free); use fewer feature "
            "rows")


def _run_distill_loop(teacher_module, student: Model, X_train, steps: int,
                      temperature: float, alpha: float, lr: float,
                      log_interval: int, desc: str) -> Model:
    device = student.device
    student.train()
    params = list(student.module.parameters())
    optimizer = distill_optimizer(params, steps, lr)
    step_fn = make_distill_step(teacher_module, student.module, optimizer,
                                temperature, alpha)

    feats_host, labels_host = materialize_rows(X_train[0])
    check_cache_fits(feats_host.nbytes + labels_host.nbytes, device)
    print_info(f"[Distillation] Uploading {len(feats_host)} feature rows "
               f"({feats_host.nbytes / 2**20:.1f} MiB) to the device...")
    cache_f = torch.from_numpy(feats_host).to(device)
    cache_l = torch.from_numpy(labels_host).to(device)
    del feats_host, labels_host

    ema = torch.zeros((), device=device)
    best_loss = torch.full((), float("inf"), device=device)
    best_params = [p.detach().clone() for p in params]
    _, sampler = X_train
    done, next_log = 0, log_interval
    while done < steps:
        k = min(STEPS_PER_DISPATCH, steps - done)
        # only these indices cross the host boundary
        row_idx = torch.from_numpy(np.stack([
            np.asarray(sampler.sample_batch(), np.int64)
            for _ in range(k)])).to(device)
        for i in range(k):
            loss = step_fn(cache_f[row_idx[i]], cache_l[row_idx[i]])
            if done + i == 0:
                ema = loss
                student.history["distill_first_loss"] = float(loss)
            else:
                ema = EMA_ALPHA * loss + (1 - EMA_ALPHA) * ema
            improved = ema < best_loss
            best_loss = torch.where(improved, ema, best_loss)
            with torch.no_grad():
                for best, p in zip(best_params, params):
                    best.copy_(torch.where(improved, p, best))
        done += k
        if done >= next_log or done == steps:
            next_log = done + log_interval
            print_info(f"[Distillation] {desc}: step {done}/{steps}, "
                       f"ema_loss {float(ema):.4f}")

    best_loss = float(best_loss)
    if np.isfinite(best_loss):
        with torch.no_grad():
            for best, p in zip(best_params, params):
                p.copy_(best)
        print_info(f"[Distillation] Best EMA loss: {best_loss:.4f}")
    student.history["distill_best_ema_loss"] = best_loss
    student.history["distill_final_ema_loss"] = float(ema)
    student.eval()
    print_info("[Distillation] Student model ready.")
    return student


def _settings(dist_cfg):
    return dict(steps=int(dist_cfg.get("steps", 8000)),
                temperature=float(dist_cfg.get("temperature", 4.0)),
                alpha=float(dist_cfg.get("alpha", 0.7)),
                lr=float(dist_cfg.get("learning_rate", 5e-4)),
                log_interval=int(dist_cfg.get("log_interval", 500)))


def distill_model(teacher: Model, X_train, config,
                  input_shape: Tuple[int, ...]) -> Model:
    """Distill from a trained teacher in memory, on the teacher's device."""
    dist_cfg = config.get("distillation", {})
    settings = _settings(dist_cfg)
    student = build_student(teacher.model_name, input_shape, dist_cfg,
                            teacher.device)
    t_params, s_params = teacher.n_params(), student.n_params()
    print_info(f"[Distillation] Teacher params : {t_params:,}")
    print_info(f"[Distillation] Student params : {s_params:,}  "
               f"({t_params / max(s_params, 1):.1f}x smaller)")
    print_info(f"[Distillation] Steps          : {settings['steps']}")
    print_info(f"[Distillation] Temperature    : {settings['temperature']}")
    print_info(f"[Distillation] Alpha (soft)   : {settings['alpha']}")
    return _run_distill_loop(teacher.module, student, X_train,
                             desc="Distilling", **settings)


def distill_from_artifact(artifact_path: str, X_train, config,
                          input_shape: Tuple[int, ...], output_dir: str,
                          model_name: str, device="cuda") -> str:
    """Standalone distillation from an exported `.nww` teacher; writes
    `<output_dir>/<model_name>_lite.nww` with the teacher's bundled encoder
    and returns its path."""
    from nanowakeword_tpu_torch.export.artifact import (
        EXTENSION, check_weights_dtype, export_model, load_nww,
        read_nww_payload)

    dist_cfg = config.get("distillation", {})
    check_weights_dtype(dist_cfg)   # fail before the distill loop runs
    settings = _settings(dist_cfg)

    _, teacher, _ = load_nww(artifact_path, device=device)
    student = build_student(model_name, input_shape, dist_cfg, device)
    print_info(f"[Distillation] Student params: {student.n_params():,}")
    print_info(f"[Distillation] Steps: {settings['steps']}, Temperature: "
               f"{settings['temperature']}, Alpha: {settings['alpha']}")
    student = _run_distill_loop(teacher.module, student, X_train,
                                desc="Distilling (from artifact)",
                                **settings)

    lite_name = model_name + "_lite"
    export_model(student, input_shape, config, lite_name, output_dir,
                 encoder_variables=read_nww_payload(artifact_path)[1],
                 weights_dtype=dist_cfg.get("weights_dtype"))
    lite_path = f"{output_dir}/{lite_name}{EXTENSION}"
    print_info(f"[Distillation] Lite model exported to: {lite_path}")
    return lite_path
