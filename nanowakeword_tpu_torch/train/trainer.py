"""The Trainer: step-driven training with ISBL feedback, the SWA checkpoint
pool, validation threshold sweeps, early stopping and durable resume.

The counterpart of `nanowakeword_tpu/train/trainer.py`, with its two loops:

* the host loop (the default): a background thread samples and gathers the
  next batches and starts their upload while the device runs the current
  step; the per-example BCE of each step comes back to the host and moves
  the dataset's hardness (the ISBL loop). The pipeline has a fixed total
  order, so the batch sequence is a function of the checkpointed state
  alone and a resumed run replays the uninterrupted one bit for bit;
* the device-cached loop (`device_cache: {enabled: true}`, train/cached.py),
  which keeps the data and the sampling on the device.

Checkpoints are pickles. The reference's other backend, orbax, is a JAX
library: asking for it raises.
"""

from __future__ import annotations

import collections
import logging
import os
import pickle
import re
import shutil
import threading
import time
from logging.handlers import RotatingFileHandler
from typing import Optional

import numpy as np
import torch

from nanowakeword_tpu_torch.models.model import Model
from nanowakeword_tpu_torch.train import loss as losses
from nanowakeword_tpu_torch.train.optim import Optimizer
from nanowakeword_tpu_torch.train.step import (make_eval_step,
                                               make_train_step,
                                               resolve_compute_dtype,
                                               to_device_batch)
from nanowakeword_tpu_torch.utils.logger import (print_final_report_header,
                                                 print_info, print_key_value)


def _loss_kwargs(config) -> dict:
    return dict(
        loss_function=str(config.get("loss_function", "bias_weighted")),
        loss_bias=float(config.get("LOSS_BIAS", 0.75)),
        logit_reg_weight=float(config.get("logit_reg_weight", 2e-4)),
        logit_reg_margin=float(config.get("logit_reg_margin", 6.0)))


class Trainer:
    """`mesh` (parallel/mesh.py) trains the host loop data- and
    tensor-parallel over it; `device_cache.data_parallel` does so for the
    device-cached loop over `mesh_devices` (by default every visible
    card)."""

    def __init__(self, model: Model, config, mesh=None):
        self.model = model.train()
        self.config = config
        self.device = model.device
        self.mesh = mesh
        self.mesh_devices = None
        # dropout's masks are a function of (seed, step): train/step.py
        self.seed = int(config.get("seed", 10))

        steps = int(config.get("steps", 15000))
        self.optimizer = Optimizer(list(model.module.parameters()), config,
                                   total_steps=steps)
        self.compute_dtype = str(config.get("compute_dtype", "float32"))
        resolve_compute_dtype(self.compute_dtype)
        step_kwargs = dict(
            compute_dtype=self.compute_dtype, dropout_seed=self.seed,
            afl_gamma_pos=float(config.get("afl_gamma_pos", 0.0)),
            afl_gamma_neg=float(config.get("afl_gamma_neg", 4.0)),
            **_loss_kwargs(config))
        if mesh is not None:
            from nanowakeword_tpu_torch.parallel.dp import (
                make_dp_train_step, shard_train_state)
            self.optimizer = shard_train_state(model.module, self.optimizer,
                                               mesh)
            self._step = make_dp_train_step(model.module, self.optimizer,
                                            mesh, **step_kwargs)
        else:
            self._step = make_train_step(model.module, self.optimizer,
                                         **step_kwargs)
        self._eval = make_eval_step(model.module)
        # the host loop uploads from pinned memory on a stream of its own;
        # False makes every copy synchronous on the step's stream
        self.async_copies = True

        print_info(f"Using optimizer: "
                   f"{str(config.get('optimizer_type', 'adamw')).upper()}")
        print_info(f"Learning rate scheduler: "
                   f"{str(config.get('lr_scheduler_type', 'onecycle')).upper()}")

        self.history = model.history
        # the host loop's last run: (seconds in the loop, seconds of them
        # the loop waited on the prefetch thread for a batch)
        self.loop_seconds = (0.0, 0.0)
        self.best_training_checkpoints: list = []
        self.best_training_scores: list = []
        self.best_error_score = float("inf")
        self.best_model_on_error_score = None

    # -- helpers -------------------------------------------------------------

    def _host_params(self) -> dict:
        """CPU copies of the trainable parameters (BatchNorm statistics
        excluded, as the reference pools params only)."""
        return {k: p.detach().cpu().clone()
                for k, p in self.model.module.named_parameters()}

    # -- validation -------------------------------------------------------------

    def validate(self, val_dataset):
        """Threshold-sweep validation minimising miss_weight*FN + fp_weight*FP."""
        batch_size = int(self.config.get("validation_batch_size", 256))
        max_batches = int(self.config.get("val_subsample_batches", 0))

        all_logits, all_labels = [], []
        for bi, (feats, labels) in enumerate(val_dataset.batches(batch_size)):
            if max_batches > 0 and bi >= max_batches:
                break
            x, _ = to_device_batch(feats, labels, self.device)
            all_logits.append(self._eval(x).cpu().numpy())
            all_labels.append(labels)
        logits = np.concatenate(all_logits)
        labels = np.concatenate(all_labels)

        val_loss = float(losses.raw_bce(torch.from_numpy(logits),
                                        torch.from_numpy(labels)).mean())
        miss_w = float(self.config.get("val_miss_weight", 4.0))
        fp_w = float(self.config.get("val_fp_weight", 1.0))
        probs = 1.0 / (1.0 + np.exp(-logits))

        best = dict(error=float("inf"), thresh=0.5, tp=0, tn=0, fp=0, fn=0)
        for thresh in np.linspace(0.2, 0.8, 13):
            preds = probs >= thresh
            tp = int(((preds == 1) & (labels == 1)).sum())
            tn = int(((preds == 0) & (labels == 0)).sum())
            fp = int(((preds == 1) & (labels == 0)).sum())
            fn = int(((preds == 0) & (labels == 1)).sum())
            err = miss_w * fn + fp_w * fp
            if err < best["error"]:
                best = dict(error=err, thresh=float(thresh),
                            tp=tp, tn=tn, fp=fp, fn=fn)

        recall = best["tp"] / max(best["tp"] + best["fn"], 1)
        fpr = best["fp"] / max(best["fp"] + best["tn"], 1)
        return collections.OrderedDict(
            val_loss=val_loss, val_recall=recall, val_fpr=fpr,
            total_false_alarms=best["fp"], total_misses=best["fn"],
            error_score=best["error"],
            raw_error_score=best["fp"] + best["fn"],
            best_threshold=best["thresh"])

    # -- checkpointing --------------------------------------------------------------

    def save_checkpoint(self, checkpoint_dir, step_ndx, sampler, **extra):
        """Durable pickle checkpoint: module state (weights and BatchNorm
        statistics), optimizer state, history and pools."""
        backend = str(self.config.get("checkpointing", {})
                      .get("backend", "pickle")).lower()
        if backend != "pickle":
            raise NotImplementedError(
                f"checkpointing.backend '{backend}' is not available in the "
                "PyTorch port (orbax is a JAX library); use 'pickle'")
        os.makedirs(checkpoint_dir, exist_ok=True)
        payload = {
            "step": step_ndx,
            "module": {k: v.detach().cpu()
                       for k, v in self.model.module.state_dict().items()},
            "optimizer": self.optimizer.state_dict(),
            "model_history": dict(self.history),
            "best_error_score": self.best_error_score,
            "best_model_on_error_score": self.best_model_on_error_score,
            "best_training_checkpoints": self.best_training_checkpoints,
            "best_training_scores": self.best_training_scores,
            "sampler_rng_state": sampler.rng.bit_generator.state
            if sampler is not None else None,
            **extra,
        }
        path = os.path.join(checkpoint_dir, f"checkpoint_step_{step_ndx}.pkl")
        with open(path, "wb") as f:
            pickle.dump(payload, f)
        return path

    @staticmethod
    def find_latest_checkpoint(checkpoint_dir) -> Optional[str]:
        if not os.path.isdir(checkpoint_dir):
            return None
        best_step, best = -1, None
        for f in os.listdir(checkpoint_dir):
            m = re.match(r"checkpoint_step_(\d+)\.pkl$", f)
            if m and int(m.group(1)) > best_step:
                best_step, best = int(m.group(1)), f
        return os.path.join(checkpoint_dir, best) if best else None

    def restore_checkpoint(self, path, sampler=None) -> dict:
        with open(path, "rb") as f:
            ckpt = pickle.load(f)
        self.model.module.load_state_dict(ckpt["module"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.history.clear()
        self.history.update(ckpt.get("model_history", {}))
        self.best_error_score = ckpt.get("best_error_score", float("inf"))
        self.best_model_on_error_score = ckpt.get("best_model_on_error_score")
        self.best_training_checkpoints = ckpt.get("best_training_checkpoints",
                                                  [])
        self.best_training_scores = ckpt.get("best_training_scores", [])
        if sampler is not None and ckpt.get("sampler_rng_state"):
            sampler.rng.bit_generator.state = ckpt["sampler_rng_state"]
        return ckpt

    @staticmethod
    def _rotate_checkpoints(checkpoint_dir, limit):
        all_ckpts = sorted(
            (f for f in os.listdir(checkpoint_dir)
             if f.startswith("checkpoint_step_")),
            key=lambda f: int(re.search(r"(\d+)", f).group(1)))
        while len(all_ckpts) > limit:
            victim = os.path.join(checkpoint_dir, all_ckpts.pop(0))
            if os.path.isdir(victim):
                shutil.rmtree(victim)
            else:
                os.remove(victim)

    # -- device-cached training (train/cached.py) -----------------------------------

    def _pool_params(self, step_ndx, score, top_k):
        host_params = self._host_params()
        if len(self.best_training_checkpoints) < top_k:
            self.best_training_checkpoints.append(host_params)
            self.best_training_scores.append(
                {"step": step_ndx, "stable_loss": score})
            return
        worst = max(s["stable_loss"] for s in self.best_training_scores)
        if score < worst:
            wi = [i for i, s in enumerate(self.best_training_scores)
                  if s["stable_loss"] == worst][0]
            self.best_training_checkpoints[wi] = host_params
            self.best_training_scores[wi] = {"step": step_ndx,
                                             "stable_loss": score}

    def train_device_cached(self, X, X_val, max_steps, log_path,
                            resume_from_dir=None):
        """Device-resident ISBL training in K-step dispatches, with the
        reference's bookkeeping at dispatch granularity: EMA and validation
        early stopping, the SWA checkpoint pool, periodic hardness reset,
        durable checkpoints and --resume."""
        from nanowakeword_tpu_torch.train.cached import (
            build_cached_data, make_cached_train_loop, put_cached_on_mesh)
        dataset, sampler = X
        config = self.config
        dc = config.get("device_cache", {})
        k_steps = int(dc.get("steps_per_dispatch", 100))

        cached = build_cached_data(dataset, sampler.batch_composition,
                                   sampler.feature_manifests, self.device)
        mesh = None
        if bool(dc.get("data_parallel", False)):
            from nanowakeword_tpu_torch.parallel import dp as DP
            from nanowakeword_tpu_torch.parallel import mesh as M
            devices = self.mesh_devices
            if devices is None:
                devices = (M.visible_devices() if self.device.type == "cuda"
                           else [self.device])
            if len(devices) > 1:
                mesh = M.make_mesh(
                    devices=devices,
                    model_parallel=int(dc.get("model_parallel", 1)))
                print_info(f"Device-cache training data-parallel over "
                           f"{mesh.size} devices (mesh {mesh.shape}).")
                self.optimizer = DP.shard_train_state(
                    self.model.module, self.optimizer, mesh)
                cached = put_cached_on_mesh(cached, mesh)
            else:
                print_info("device_cache.data_parallel requested but only "
                           "one device is visible; training on one device.")
        loop = make_cached_train_loop(
            self.model.module, self.optimizer, mesh=mesh,
            quotas=cached.quotas, replace=cached.replace, k_steps=k_steps,
            hardness_alpha=float(config.get("hardness_ema_alpha", 0.05)),
            hardness_floor=float(config.get("hardness_floor", 0.05)),
            sampling=str(dc.get("sampling", "auto")),
            compute_dtype=self.compute_dtype, dropout_seed=self.seed,
            **_loss_kwargs(config))

        ema_loss = None
        ema_alpha = float(config.get("ema_alpha", 0.01))
        top_k = int(config.get("checkpoint_averaging_top_k", 5))
        pool_interval = int(config.get("checkpoint_pool_interval", 500))
        stabilization = int(config.get("stabilization_steps",
                                       int(max_steps * 0.05)))
        val_interval = int(config.get("val_interval", 500))
        min_delta = float(config.get("min_delta", 0.0001))

        user_patience = config.get("early_stopping_patience", None)
        if user_patience is not None:
            patience = int(user_patience)
        elif int(config.get("steps", max_steps)) < 3000:
            patience = 0
        else:
            patience = int(max_steps * 0.10)
        best_ema_for_stopping = float("inf")
        steps_without_improvement = 0
        val_patience = int(config.get("val_early_stopping_patience",
                                      int(max_steps * 0.15)))
        val_steps_without_improvement = 0

        hardness_reset_interval = int(config.get("hardness_reset_interval",
                                                 5000))
        hardness_reset_decay = float(config.get("hardness_reset_decay", 0.5))

        ckpt_cfg = config.get("checkpointing", {})
        ckpt_enabled = bool(ckpt_cfg.get("enabled", False))
        ckpt_interval = int(ckpt_cfg.get("interval_steps", 1000))
        ckpt_limit = int(ckpt_cfg.get("limit", 3))
        checkpoint_dir = os.path.join(log_path, "checkpoints")
        if ckpt_enabled:
            os.makedirs(checkpoint_dir, exist_ok=True)
            print_info(f"Checkpointing ENABLED every ~{ckpt_interval} steps "
                       f"(dispatch-aligned).")

        hardness = cached.hardness
        generator = torch.Generator(device=self.device).manual_seed(
            int(config.get("seed", 10)) + 1)

        step_ndx = 0
        if resume_from_dir:
            resume_ckpt_dir = os.path.join(resume_from_dir,
                                           "training_artifacts", "checkpoints")
            latest = self.find_latest_checkpoint(resume_ckpt_dir)
            if latest:
                print_info(f"Resuming device-cached run from: {latest}")
                ckpt = self.restore_checkpoint(latest, sampler)
                step_ndx = int(ckpt["step"])
                ema_loss = ckpt.get("ema_loss")
                steps_without_improvement = ckpt.get(
                    "steps_without_improvement", 0)
                best_ema_for_stopping = ckpt.get("best_ema_loss_for_stopping",
                                                 float("inf"))
                val_steps_without_improvement = ckpt.get(
                    "val_steps_without_improvement", 0)
                if ckpt.get("dataset_hardness") is not None:
                    hardness.copy_(torch.as_tensor(ckpt["dataset_hardness"]))
                if ckpt.get("loop_generator_state") is not None:
                    generator.set_state(ckpt["loop_generator_state"])
                print_info(f"Restored state; resuming from step {step_ndx}.")
            else:
                print_info(f"WARNING: no checkpoint in '{resume_ckpt_dir}'. "
                           "Starting fresh.")

        def _save(step):
            self.save_checkpoint(
                checkpoint_dir, step, sampler,
                ema_loss=ema_loss,
                best_ema_loss_for_stopping=best_ema_for_stopping,
                steps_without_improvement=steps_without_improvement,
                val_steps_without_improvement=val_steps_without_improvement,
                dataset_hardness=hardness.cpu().numpy(),
                loop_generator_state=generator.get_state())
            self._rotate_checkpoints(checkpoint_dir, ckpt_limit)

        use_train_stop = X_val is None or len(X_val) == 0
        next_pool = max(((max(step_ndx, stabilization) // pool_interval) + 1)
                        * pool_interval, step_ndx + 1)
        next_val = max(((max(step_ndx, stabilization, int(config.get(
            "val_stabilization_steps", stabilization))) // val_interval) + 1)
            * val_interval, step_ndx + 1)
        next_ckpt = ((step_ndx // ckpt_interval) + 1) * ckpt_interval
        next_hreset = (((step_ndx // hardness_reset_interval) + 1)
                       * hardness_reset_interval
                       if hardness_reset_interval > 0 else None)
        stopped_early = False

        while step_ndx < max_steps and not stopped_early:
            metrics = loop(hardness, generator,
                           cached.replicas if mesh else cached.features,
                           cached.labels, cached.pools)
            m = metrics.cpu().numpy()   # one fetch per K steps
            losses_k = m[:, 0]
            self.history["loss"].extend(losses_k.tolist())
            for lv in losses_k:
                ema_loss = lv if ema_loss is None else (
                    ema_alpha * lv + (1 - ema_alpha) * ema_loss)
                if patience > 0:
                    if ema_loss < best_ema_for_stopping - min_delta:
                        best_ema_for_stopping = ema_loss
                        steps_without_improvement = 0
                    else:
                        steps_without_improvement += 1
            for off in range(0, k_steps, 100):
                tp, fn = m[off, 2], m[off, 3]
                if tp + fn > 0:
                    self.history["train_recall_steps"].append(step_ndx + off)
                    self.history["train_recall"].append(
                        float(tp / (tp + fn)))
            step_ndx += k_steps

            if next_hreset is not None and step_ndx >= next_hreset:
                next_hreset += hardness_reset_interval
                hardness.mul_(hardness_reset_decay).add_(
                    1.0 - hardness_reset_decay)

            if step_ndx >= next_pool and step_ndx > stabilization:
                next_pool += pool_interval
                self._pool_params(step_ndx, float(ema_loss), top_k)

            if (X_val is not None and len(X_val) > 0
                    and step_ndx >= next_val):
                next_val += val_interval
                vm = self.validate(X_val)
                self.history["val_loss_steps"].append(step_ndx)
                self.history["val_loss"].append(vm["val_loss"])
                self.history["val_recall_steps"].append(step_ndx)
                self.history["val_recall"].append(vm["val_recall"])
                self.history["val_fpr"].append(vm["val_fpr"])
                if vm["error_score"] < self.best_error_score:
                    self.best_error_score = vm["error_score"]
                    self.best_model_on_error_score = self._host_params()
                    val_steps_without_improvement = 0
                else:
                    val_steps_without_improvement += val_interval
                if (val_patience > 0 and step_ndx > stabilization
                        and val_steps_without_improvement >= val_patience):
                    print_info(f"\nValidation early stopping at step "
                               f"{step_ndx}: no val-error improvement for "
                               f"{val_patience} steps.")
                    stopped_early = True

            if (patience > 0 and use_train_stop and not stopped_early
                    and step_ndx > stabilization
                    and steps_without_improvement >= patience):
                print_info(f"\nEarly stopping at step {step_ndx}: no stable-"
                           f"loss improvement for {patience} steps.")
                stopped_early = True

            if ckpt_enabled and step_ndx >= next_ckpt:
                next_ckpt = ((step_ndx // ckpt_interval) + 1) * ckpt_interval
                _save(step_ndx)

        if ckpt_enabled and stopped_early:
            _save(step_ndx)
        dataset.sample_hardness[:] = hardness.cpu().numpy()
        print_info(f"Device-cached training finished at step {step_ndx} "
                   f"({k_steps} steps/dispatch).")
        return step_ndx

    # -- the host loop ----------------------------------------------------------------

    def _upload(self, feats, labels, copy_stream):
        """Host arrays -> (features, labels, event) on the device. With a
        copy stream the arrays are pinned and copied without blocking on
        that stream, and the event marks the end of the copy."""
        if self.mesh is not None:
            from nanowakeword_tpu_torch.parallel.dp import device_put_batch
            return (*device_put_batch(feats, labels, self.mesh), None)
        f = torch.from_numpy(np.ascontiguousarray(feats, np.float32))
        y = torch.from_numpy(np.ascontiguousarray(labels, np.float32))
        if copy_stream is None:
            return f.to(self.device), y.to(self.device), None
        with torch.cuda.stream(copy_stream):
            f_dev = f.pin_memory().to(self.device, non_blocking=True)
            y_dev = y.pin_memory().to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(copy_stream)
        return f_dev, y_dev, event

    def train_model(self, X, X_val, max_steps, log_path, table_updater=None,
                    resume_from_dir=None):
        """X: (dataset, sampler) pair; X_val: ValidationDataset or None;
        table_updater: a DynamicTable (utils/dynamic_table.py) printed once
        the host loop has read its settings."""
        dataset, sampler = X
        config = self.config

        dc_cfg = config.get("device_cache", {})
        if dc_cfg and dc_cfg.get("enabled", False) and self.mesh is None:
            return self.train_device_cached(X, X_val, max_steps, log_path,
                                            resume_from_dir=resume_from_dir)

        debug_mode = bool(config.get("debug_mode", False))
        log_dir = os.path.join(log_path, "training_debug")
        os.makedirs(log_dir, exist_ok=True)
        logger = logging.getLogger("NanoTrainerDebug")
        if debug_mode:
            logger.disabled = False
            logger.setLevel(logging.INFO)
            if not logger.handlers:
                handler = RotatingFileHandler(
                    os.path.join(log_dir, "training_debug.log"),
                    maxBytes=5_000_000, backupCount=30, encoding="utf-8")
                handler.setFormatter(logging.Formatter(
                    "%(asctime)s [%(levelname)s] %(message)s",
                    datefmt="%H:%M:%S"))
                logger.addHandler(handler)
            logger.propagate = False
            print_info(f"Debug mode ON. Logs in: {log_dir}")
        else:
            logger.disabled = True

        ckpt_cfg = config.get("checkpointing", {})
        ckpt_enabled = bool(ckpt_cfg.get("enabled", False))
        ckpt_interval = int(ckpt_cfg.get("interval_steps", 1000))
        ckpt_limit = int(ckpt_cfg.get("limit", 3))
        checkpoint_dir = os.path.join(log_path, "checkpoints")
        if ckpt_enabled:
            os.makedirs(checkpoint_dir, exist_ok=True)
            print_info(f"Checkpointing ENABLED every {ckpt_interval} steps.")

        ema_loss = None
        ema_alpha = float(config.get("ema_alpha", 0.01))
        top_k = int(config.get("checkpoint_averaging_top_k", 5))
        pool_interval = int(config.get("checkpoint_pool_interval", 500))

        stabilization_steps = int(config.get("stabilization_steps",
                                             int(max_steps * 0.05)))
        min_delta = float(config.get("min_delta", 0.0001))
        best_ema_for_stopping = float("inf")
        steps_without_improvement = 0

        user_patience = config.get("early_stopping_patience", None)
        if user_patience is not None:
            patience = int(user_patience)
        elif int(config.get("steps", max_steps)) < 3000:
            patience = 0
        else:
            patience = int(max_steps * 0.10)

        val_interval = int(config.get("val_interval", 500))
        val_stb = int(config.get("val_stabilization_steps",
                                 stabilization_steps))
        val_patience = int(config.get("val_early_stopping_patience",
                                      int(max_steps * 0.15)))
        val_steps_without_improvement = 0

        hardness_alpha = float(config.get("hardness_ema_alpha", 0.05))
        hardness_floor = float(config.get("hardness_floor", 0.05))
        hardness_reset_interval = int(config.get("hardness_reset_interval",
                                                 5000))
        hardness_reset_decay = float(config.get("hardness_reset_decay", 0.5))

        if patience == 0:
            print_info("Early stopping is DISABLED; training for the full "
                       "'steps' duration.")
        else:
            print_info(f"Training for {max_steps} steps; early stopping "
                       f"activates after {stabilization_steps} steps.")

        start_step = 0
        # (step, indices, bce) of the step whose hardness update was NOT yet
        # applied when the checkpoint was written: replayed after the first
        # resumed batch is drawn, exactly where the continuous run applied it
        pending_restored = None
        if resume_from_dir:
            resume_ckpt_dir = os.path.join(resume_from_dir,
                                           "training_artifacts", "checkpoints")
            latest = self.find_latest_checkpoint(resume_ckpt_dir)
            if latest:
                print_info(f"Resuming from checkpoint: {latest}")
                ckpt = self.restore_checkpoint(latest, sampler)
                start_step = int(ckpt["step"]) + 1
                ema_loss = ckpt.get("ema_loss")
                steps_without_improvement = ckpt.get(
                    "steps_without_improvement", 0)
                best_ema_for_stopping = ckpt.get("best_ema_loss_for_stopping",
                                                 float("inf"))
                val_steps_without_improvement = ckpt.get(
                    "val_steps_without_improvement", 0)
                if ckpt.get("dataset_hardness") is not None:
                    dataset.sample_hardness[:] = ckpt["dataset_hardness"]
                if (ckpt.get("dataset_rng_state") is not None
                        and hasattr(dataset, "_rng")):
                    dataset._rng.setstate(ckpt["dataset_rng_state"])
                pending_restored = ckpt.get("pending_hardness_update")
                print_info(f"Restored state; resuming from step {start_step}.")
            else:
                print_info(f"WARNING: no checkpoint in '{resume_ckpt_dir}'. "
                           "Starting fresh.")

        if table_updater is not None:
            table_updater.update(force_print=True)

        # optional device tracing of steps
        # [profile_start, profile_start + profile_steps)
        profile_dir = config.get("profile_trace_dir")
        profile_start = int(config.get("profile_start_step", 10))
        profile_steps = int(config.get("profile_steps", 20))
        profiler = None

        def stop_profiler():
            nonlocal profiler
            profiler.stop()
            os.makedirs(str(profile_dir), exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(str(profile_dir), "trace.json"))
            profiler = None
            print_info(f"Device trace written to {profile_dir}")

        # Batch prefetch as a DETERMINISTIC software pipeline. ISBL sampling
        # + gather run on a background thread overlapping device compute, but
        # hardness visibility follows a fixed total order regardless of
        # thread timing:
        #
        #     ... draw(N+1) -> update(N) [-> reset, if due] -> draw(N+2) ...
        #
        # i.e. the batch for step N is sampled against hardness that reflects
        # exactly the updates from steps <= N-2. That makes the batch
        # sequence a pure function of the sampler RNG + checkpoint state, so
        # a mid-run resume replays the uninterrupted run bit for bit.
        from nanowakeword_tpu_torch.utils.prefetch import Prefetcher

        cuda = self.device.type == "cuda"
        copy_stream = (torch.cuda.Stream(self.device)
                       if cuda and self.async_copies else None)
        pipe = threading.Condition()
        stop_pipe = [False]
        # last step whose batch has been drawn / whose hardness update landed
        drawn_through = [start_step - 1]
        drained_through = [start_step - 2 if pending_restored is not None
                           else start_step - 1]
        produce_counter = [start_step]

        def produce_batch():
            my_step = produce_counter[0]
            produce_counter[0] += 1
            with pipe:
                while drained_through[0] < my_step - 2 and not stop_pipe[0]:
                    pipe.wait(0.5)
                if stop_pipe[0]:
                    raise StopIteration
            batch_indices = np.asarray(sampler.sample_batch(), np.int64)
            if batch_indices.size == 0:
                raise ValueError("Sampler produced an empty batch - check "
                                 "batch_composition vs feature_manifest.")
            feats, labels, indices = dataset.gather(batch_indices)
            # the generators right after this batch was produced: the
            # sampler's and, for raw audio (train/e2e.py), the dataset's
            # random crops. Checkpointing THESE (not the live states, which
            # have drawn ahead) is what makes resume continue the exact
            # same batch sequence
            rng_snapshot = {
                "sampler": sampler.rng.bit_generator.state,
                "dataset": (dataset._rng.getstate()
                            if hasattr(dataset, "_rng") else None)}
            # the upload starts HERE, on the prefetch thread, so the copy
            # overlaps the current step
            f_dev, l_dev, copied = self._upload(feats, labels, copy_stream)
            with pipe:
                drawn_through[0] = my_step
                pipe.notify_all()
            return f_dev, l_dev, copied, labels, indices, rng_snapshot

        prefetcher = Prefetcher(produce_batch, depth=2)
        loop_start = time.perf_counter()
        # (step, indices, bce) of the most recently applied hardness update,
        # saved in checkpoints so resume can replay it in order
        last_update_record = [None]

        def apply_hardness_update(upd_step, indices, bce):
            """Apply step `upd_step`'s hardness EMA update (and the periodic
            reset, when step upd_step+1 is a reset step) in pipeline order:
            only after batch upd_step+1 has been drawn."""
            with pipe:
                while (drawn_through[0] < upd_step + 1 and not stop_pipe[0]
                       and prefetcher._error is None):
                    pipe.wait(0.5)
            dataset.update_hardness(indices, bce, alpha=hardness_alpha,
                                    floor=hardness_floor)
            last_update_record[0] = (upd_step, indices, bce)
            nxt = upd_step + 1
            if (hardness_reset_interval > 0 and nxt > 0
                    and nxt % hardness_reset_interval == 0):
                dataset.reset_hardness(hardness_reset_decay)
                logger.info(f"[{nxt:5d}] Hardness scores partially reset "
                            f"(decay={hardness_reset_decay}).")
            with pipe:
                drained_through[0] = upd_step
                pipe.notify_all()

        # Step N's metrics are read only after step N+1 has been launched,
        # so the device -> host copy hides behind compute.
        pending = None  # (step_ndx, indices, PendingMetrics)

        def drain(p):
            nonlocal ema_loss, steps_without_improvement, best_ema_for_stopping
            step_ndx, indices, fetch = p
            m = fetch.result()   # ONE device -> host copy for all metrics
            apply_hardness_update(step_ndx, indices,
                                  np.array(m.per_example_bce))
            current_loss = m.loss
            self.history["loss"].append(current_loss)
            if ema_loss is None:
                ema_loss = current_loss
            ema_loss = ema_alpha * current_loss + (1 - ema_alpha) * ema_loss

            # checkpoint pool for SWA
            if step_ndx > stabilization_steps and step_ndx % pool_interval == 0:
                self._pool_params(step_ndx, ema_loss, top_k)

            # recall logging every 100 steps
            if step_ndx % 100 == 0:
                labels01 = labels_cache.pop(step_ndx)
                yp = 1 / (1 + np.exp(-m.logits))
                is_pos = labels01 == 1
                tp = int((yp[is_pos] >= 0.5).sum())
                fn = int((yp[is_pos] < 0.5).sum())
                recall = tp / max(tp + fn, 1)
                self.history["train_recall_steps"].append(step_ndx)
                self.history["train_recall"].append(recall)
                if debug_mode:
                    is_neg = ~is_pos
                    fa = int((yp[is_neg] > 0.5).sum())
                    logger.info(
                        f"[{step_ndx:5d}] L:{current_loss:.6f} "
                        f"|PA:{yp[is_pos].mean() if is_pos.any() else 0:.3f} "
                        f"NA:{yp[is_neg].mean() if is_neg.any() else 0:.3f} "
                        f"|FA:{fa}/{int(is_neg.sum())} "
                        f"Ms:{fn}/{int(is_pos.sum())} |Recall:{recall:.3f} "
                        f"gNorm:{m.grad_norm:.8f}")

            # train-EMA early stopping bookkeeping
            if patience > 0:
                if ema_loss < best_ema_for_stopping - min_delta:
                    best_ema_for_stopping = ema_loss
                    steps_without_improvement = 0
                else:
                    steps_without_improvement += 1

        labels_cache: dict = {}
        use_train_stop = X_val is None or len(X_val) == 0
        step_ndx = start_step
        try:
            while step_ndx < max_steps:
                f_dev, l_dev, copied, labels, indices, rng_after_current = \
                    prefetcher.get()
                if copied is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(copied)
                    f_dev.record_stream(stream)
                    l_dev.record_stream(stream)
                if step_ndx % 100 == 0:
                    labels_cache[step_ndx] = labels.copy()

                if profile_dir and profiler is None \
                        and step_ndx == profile_start:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if cuda:
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                if profiler is not None \
                        and step_ndx == profile_start + profile_steps:
                    stop_profiler()

                fetch = self._step(f_dev, l_dev).start_fetch()

                if pending is not None:
                    drain(pending)
                elif pending_restored is not None:
                    # replay the checkpoint's deferred hardness update at the
                    # exact pipeline slot the continuous run applied it
                    apply_hardness_update(*pending_restored)
                    pending_restored = None
                pending = (step_ndx, indices, fetch)

                # early stopping on train EMA (only without val data)
                if (patience > 0 and use_train_stop
                        and step_ndx > stabilization_steps
                        and steps_without_improvement >= patience):
                    drain(pending)
                    pending = None
                    print_info(f"\nEarly stopping at step {step_ndx}: no stable-"
                               f"loss improvement for {patience} steps.")
                    break

                # durable checkpoint. The saved state is pipeline-consistent:
                # hardness BEFORE this step's update (what batch N+1 was
                # sampled against), plus that update itself for in-order
                # replay, plus the sampler's generator as it was right after
                # batch N was drawn (the live sampler has drawn ahead).
                if (ckpt_enabled and step_ndx > 0
                        and step_ndx % ckpt_interval == 0):
                    hardness_before = dataset.sample_hardness.copy()
                    drain(pending)
                    pending = None
                    self.save_checkpoint(
                        checkpoint_dir, step_ndx, sampler,
                        ema_loss=ema_loss,
                        best_ema_loss_for_stopping=best_ema_for_stopping,
                        steps_without_improvement=steps_without_improvement,
                        val_steps_without_improvement=val_steps_without_improvement,
                        dataset_hardness=hardness_before,
                        pending_hardness_update=last_update_record[0],
                        sampler_rng_state=rng_after_current["sampler"],
                        dataset_rng_state=rng_after_current["dataset"])
                    self._rotate_checkpoints(checkpoint_dir, ckpt_limit)

                # validation
                if (not use_train_stop and step_ndx > val_stb
                        and step_ndx % val_interval == 0):
                    if pending is not None:
                        drain(pending)
                        pending = None
                    vm = self.validate(X_val)
                    self.history["val_loss_steps"].append(step_ndx)
                    self.history["val_loss"].append(vm["val_loss"])
                    self.history["val_recall_steps"].append(step_ndx)
                    self.history["val_recall"].append(vm["val_recall"])
                    self.history["val_fpr"].append(vm["val_fpr"])
                    if vm["error_score"] < self.best_error_score:
                        self.best_error_score = vm["error_score"]
                        self.best_model_on_error_score = self._host_params()
                        val_steps_without_improvement = 0
                        logger.info(
                            f"[VAL {step_ndx:5d}] New best! "
                            f"err={vm['error_score']:.1f} "
                            f"FA={vm['total_false_alarms']} "
                            f"Miss={vm['total_misses']} "
                            f"thresh={vm['best_threshold']:.2f}")
                    else:
                        val_steps_without_improvement += val_interval
                    if (val_patience > 0 and step_ndx > stabilization_steps
                            and val_steps_without_improvement >= val_patience):
                        print_info(f"\nValidation early stopping at step "
                                   f"{step_ndx}: no val-error improvement for "
                                   f"{val_patience} steps.")
                        break

                step_ndx += 1

            if pending is not None:
                drain(pending)
        finally:
            # ALWAYS release the producer thread and close the prefetcher:
            # an exception mid-loop (device out of memory, a validation
            # error) must not leave the daemon producer waiting on the
            # pipeline gate forever
            with pipe:
                stop_pipe[0] = True
                pipe.notify_all()
            prefetcher.close()
            self.loop_seconds = (time.perf_counter() - loop_start,
                                 prefetcher.waited)
            if profiler is not None:
                stop_profiler()
        return step_ndx

    # -- auto_train ---------------------------------------------------------------------

    def auto_train(self, X_train, X_val, steps, table_updater=None,
                   debug_path=".", resume_from_dir=None):
        self.train_model(X=X_train, X_val=X_val, max_steps=steps,
                         log_path=debug_path, table_updater=table_updater,
                         resume_from_dir=resume_from_dir)
        print_info("Training finished. Building final model...")
        dataset, sampler = X_train
        final_params = None

        val_suspicious = (self.best_error_score == 0.0
                          and self.best_model_on_error_score is not None)
        if self.best_model_on_error_score is not None and not val_suspicious:
            print_info("Using best validation-error-score checkpoint as the "
                       "final model.")
            final_params = self.best_model_on_error_score
        elif self.best_training_checkpoints:
            if val_suspicious:
                print_info(
                    "WARNING: Validation achieved 0 errors — your validation "
                    "set likely overlaps training data. Using training-loss "
                    "checkpoint averaging instead.")
            else:
                print_info("No validation data used. Averaging top "
                           "training-loss checkpoints.")
            final_params = Model.average_models(self.best_training_checkpoints)
        else:
            print_info("No checkpoints available. Using the model at the end "
                       "of training.")
        if final_params is not None:
            self.model.module.load_state_dict(final_params, strict=False)
        self.model.eval()

        print_info("Calculating performance metrics for the final model...")
        final_results = collections.OrderedDict()
        if self.best_training_scores:
            avg_stable = float(np.mean(
                [s["stable_loss"] for s in self.best_training_scores]))
            final_results["Average Stable Loss"] = f"{avg_stable:.4f}"
        else:
            final_results["Average Stable Loss"] = "N/A"

        batch_indices = np.asarray(sampler.sample_batch(), np.int64)
        feats, labels, _ = dataset.gather(batch_indices)
        x, _ = to_device_batch(feats, labels, self.device)
        logits = self._eval(x).cpu().numpy()
        pos, neg = logits[labels == 1], logits[labels == 0]
        final_results["Avg. Positive Score (Logit)"] = (
            f"{pos.mean():.3f}" if pos.size else "N/A (No positives)")
        final_results["Avg. Negative Score (Logit)"] = (
            f"{neg.mean():.3f}" if neg.size else "N/A (No negatives)")

        print_final_report_header()
        print_info("NOTE: These metrics are indicators of model health, not "
                   "real-world performance.")
        for k, v in final_results.items():
            print_key_value(k, v)
        self.history["final_report"] = final_results
        return self.model
