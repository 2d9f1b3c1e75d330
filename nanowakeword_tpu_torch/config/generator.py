"""ConfigGenerator: heuristic auto-configuration from dataset + hardware stats.

The counterpart of `nanowakeword_tpu/config/generator.py`: derives `augmentation_rounds`, `steps`, `n_blocks`/`layer_size`, learning
rates, `dropout_prob`, CLR cycle sizes, `background_paths_duplication_rate`,
and batch sizes from dataset statistics (H_pos/H_neg/H_noise/A_noise/N_rir)
and host/accelerator resources. In the pipeline it is called with no
stats, so the hardware-dependent keys dominate. Device batch sizes come
from the CUDA devices torch sees (count and memory); a process that sees
none counts its CPU as one small device, as `jax.devices()` does for the
JAX package, so both packages write the same config on the same machine.
"""

from __future__ import annotations

import math
import os

import numpy as np

try:
    import psutil
    _PSUTIL = True
except ImportError:  # pragma: no cover
    _PSUTIL = False


def clamp(value, min_val, max_val):
    return max(min_val, min(value, max_val))


# a card with at least this much memory takes the large feature batches
LARGE_DEVICE_GIB = 40.0


def _device_info():
    """(number of CUDA devices, memory of device 0 in GiB); without one,
    the CPU as one device of unknown memory."""
    import torch
    if not torch.cuda.is_available():
        return 1, 0.0
    props = torch.cuda.get_device_properties(0)
    return torch.cuda.device_count(), props.total_memory / 2 ** 30


class ConfigGenerator:
    def __init__(self, stats=None):
        self.stats = stats if stats is not None else {}
        self.config = {}
        self.C = {
            "base_lr": 5e-5,
            "lr_size_sensitivity": 0.1,
            "dropout_risk_scaler": 0.5,
            "steps_per_effective_hour": 1000,
            "min_steps": 10000,
            "max_steps": 40000,
        }

    def generate(self) -> dict:
        H_pos = self.stats.get("H_pos", 0.0)
        H_neg = self.stats.get("H_neg", 0.0)
        A_noise = self.stats.get("A_noise", 0.0)
        N_rir = self.stats.get("N_rir", 0)

        base_hours = max(H_pos + H_neg, 0.01)

        # augmentation rounds from a dynamic effective-hours target
        progress = clamp(np.log1p(base_hours) / np.log1p(5), 0.0, 1.0)
        dynamic_target = 8.0 + (20.0 - 8.0) * progress
        multiplier = dynamic_target / base_hours if base_hours > 0.01 else 10
        rounds = int(round(clamp(multiplier, 2, 5)))
        self.config["augmentation_rounds"] = rounds
        effective_hours = base_hours * rounds

        # step budget scaled by data volume and quality
        quality = ((1 - clamp(A_noise, 0, 1)) + clamp(N_rir / 500, 0, 1)) / 2
        base_steps = int(effective_hours * self.C["steps_per_effective_hour"])
        steps = int(base_steps * (1.1 - 0.2 * quality))
        self.config["steps"] = int(clamp(steps, self.C["min_steps"],
                                         self.C["max_steps"]))

        # model size from data volume
        complexity = clamp(np.log10(effective_hours + 1) * 2.0, 1.0, 4.0)
        self.config["n_blocks"] = int(round(complexity))
        self.config["layer_size"] = int(
            clamp(64 * 2 ** (self.config["n_blocks"] - 1), 64, 512))

        # learning rates
        size_factor = (effective_hours / 20) ** self.C["lr_size_sensitivity"]
        noise_factor = (1 - clamp(A_noise, 0, 1)) ** 2
        max_lr = (self.C["base_lr"] * clamp(size_factor, 0.8, 2.0)
                  * clamp(noise_factor, 0.5, 1.0))
        self.config["learning_rate_max"] = max_lr
        self.config["learning_rate_base"] = max_lr / 10

        # dropout from overfitting risk
        capacity = self.config["n_blocks"] * self.config["layer_size"] ** 2
        risk = capacity / (effective_hours * 3600 * 1000 + 1e-6)
        self.config["dropout_prob"] = clamp(
            0.6 + risk * self.C["dropout_risk_scaler"] * 1.5, 0.4, 0.8)

        # CLR cycle geometry
        num_cycles = clamp(effective_hours / 25, 2, 4)
        cycle_steps = self.config["steps"] / num_cycles
        self.config["clr_step_size_up"] = int(cycle_steps * 0.4)
        self.config["clr_step_size_down"] = int(cycle_steps * 0.6)

        # balance unequal background-noise sources by duplication
        noise_durations = self.stats.get("H_noise_paths", {})
        if noise_durations:
            h_target = max(noise_durations.values())
            self.config["background_paths_duplication_rate"] = [
                int(math.ceil(h_target / noise_durations.get(p, 1e-6)))
                if noise_durations.get(p, 0) > 0.001 else 1
                for p in noise_durations
            ]
        else:
            self.config["background_paths_duplication_rate"] = []

        # host-side augmentation batch size from RAM + cores
        if _PSUTIL:
            safe_ram = max(0, psutil.virtual_memory().total / 2 ** 30 - 2.0)
            core_factor = math.sqrt((os.cpu_count() or 4) / 4.0)
            calc = 16.0 * (safe_ram / 6.0) * core_factor
            self.config["augmentation_batch_size"] = min(
                [16, 32, 64, 128], key=lambda x: abs(x - clamp(calc, 16, 128)))
        else:
            self.config["augmentation_batch_size"] = 32

        # device feature-extraction batch size, from the CUDA devices
        n_dev, mem_gib = _device_info()
        if mem_gib >= LARGE_DEVICE_GIB:
            self.config["feature_batch_size"] = 1024 * n_dev
            self.config["tts_batch_size"] = 256
        else:
            self.config["feature_batch_size"] = 256 * n_dev
            self.config["tts_batch_size"] = 64

        return self.config

    def save_config(self, path: str, base_config_path: str):
        import yaml
        with open(base_config_path, "r") as f:
            base = yaml.safe_load(f)
        base.update(self.config)
        with open(path, "w") as f:
            yaml.dump(base, f, default_flow_style=False, sort_keys=False)
