"""The program under test, built for one configuration: the only module of
the harness besides the drivers that imports `nanowakeword_tpu_torch`.

A configuration names its weights in one of two ways. "files": committed
`.nww` artifacts under `port_bench/configs/`. "seeded": every weight of the
flax layout that the reference gives for the family
(reference/families/<model_type>.py::layout) is drawn from the seed on the
device in one call, at the scales the configuration states. The drawn tree is handed to the
reference as it is, and to the program through its own `Model`
(`load_variables`, strict) and `save_nww`, which writes a `.nww` with the
encoder of `encoder_file` bundled into a temporary folder; the program then
loads that file through its own loader like any other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from port_bench.reference.models import family
from port_bench.reference.nww import read_nww

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
WEIGHT_SEED_OFFSET = 1_000_003


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _scaled(path, z: torch.Tensor, shape) -> torch.Tensor:
    leaf, parent = path[-1], path[-2] if len(path) > 1 else ""
    if leaf == "kernel":
        fan_in = shape[0] if parent in ("query", "key", "value") \
            else int(np.prod(shape[:-1]))
        return z / np.sqrt(fan_in)
    if leaf == "scale":
        return 1.0 + 0.1 * z
    if leaf == "var":
        return torch.exp(0.2 * z)
    return 0.1 * z                      # biases and running means


def seeded_variables(layout, seed: int, device) -> dict:
    """A flax tree of the shapes in `layout`, every leaf drawn from one
    normal draw on `device` seeded from `seed`, as float32 numpy arrays."""
    leaves = list(_leaves(layout))
    sizes = [int(np.prod(shape)) for _, shape in leaves]
    g = torch.Generator(device=device).manual_seed(
        int(seed) + WEIGHT_SEED_OFFSET)
    z = torch.randn(sum(sizes), generator=g, device=device).cpu()
    out: dict = {}
    for (path, shape), part in zip(leaves, torch.split(z, sizes)):
        _set(out, path, _scaled(path, part, shape).reshape(shape).numpy())
    return out


class Weights:
    """The weights of a configuration: a `.nww` path per model for the
    program, and (flax variables, model_type) per model plus the encoder's
    flax variables for the reference."""

    def __init__(self, config: dict, seed: int, device, workdir=None):
        """`workdir`: where a seeded model's `.nww` is written for the
        program; without it only the reference's trees are made."""
        spec = config["weights"]
        self.paths, self.variables = {}, {}
        if spec["kind"] == "files":
            for name, rel in spec["files"].items():
                path = os.path.join(CONFIGS, rel)
                _, variables, encoder = read_nww(path)
                self.paths[name], self.variables[name] = path, variables
                if name == spec["encoder_from"]:
                    self.encoder = encoder
        elif spec["kind"] == "seeded":
            self.encoder = read_nww(os.path.join(CONFIGS,
                                                 spec["encoder_file"]))[2]
            name = spec["model"]
            model = config["models"][name]
            self.variables[name] = seeded_variables(
                family(model["model_type"]).layout(model), seed, device)
            self.paths[name] = None if workdir is None else _write_seeded(
                model, name, self.variables[name], self.encoder, workdir)
        else:
            raise ValueError(f"unknown weights kind {spec['kind']!r}")
        self.types = {name: config["models"][name]["model_type"]
                      for name in self.variables}

    def reference_model(self, name: str):
        return self.variables[name], self.types[name]


def _write_seeded(model_cfg: dict, name: str, variables, encoder,
                  workdir: str) -> str:
    from nanowakeword_tpu_torch.export.artifact import save_nww
    from nanowakeword_tpu_torch.models.model import Model
    arch = {k: v for k, v in model_cfg.items()
            if k not in ("model_type", "input_shape", "layer_size",
                         "n_blocks", "dropout_prob", "n_params")}
    model = Model(config=arch, model_name=name,
                  input_shape=tuple(model_cfg["input_shape"]),
                  model_type=model_cfg["model_type"],
                  layer_dim=int(model_cfg.get("layer_size", 128)),
                  n_blocks=int(model_cfg["n_blocks"]),
                  dropout_prob=float(model_cfg.get("dropout_prob", 0.1)),
                  device="cpu")
    model.load_variables(variables)
    path = os.path.join(workdir, name + ".nww")
    save_nww(path, model=model, config=arch, model_name=name,
             encoder_variables=encoder)
    return path


def stream_interpreter(config: dict, weights: Weights, device,
                       vad_threshold: float = 0):
    """The streaming entry as users load it: `NanoInterpreter.load_model`
    on the configuration's model (a cascade finds its `_lite` gate beside
    the verifier), which captures the one-call step on a CUDA device."""
    from nanowakeword_tpu_torch import NanoInterpreter
    cascade = config.get("cascade")
    if cascade:
        return NanoInterpreter.load_model(
            weights.paths[cascade["verifier"]], cascade=True,
            gate_threshold=cascade["gate_threshold"], device=device,
            vad_threshold=vad_threshold)
    (name,) = config["stream_models"]
    return NanoInterpreter.load_model(weights.paths[name], device=device,
                                      vad_threshold=vad_threshold)


def bulk_scorer(config: dict, weights: Weights, device):
    """The bulk entry as the program's own feature evaluator builds it:
    `load_nww`, a `_LocalSession` on the model, and `AudioFeatures` on the
    encoder bundled in the model's artifact."""
    from nanowakeword_tpu_torch.data.features import AudioFeatures
    from nanowakeword_tpu_torch.export.artifact import load_nww
    from nanowakeword_tpu_torch.interpreter.nanointerpreter import \
        _LocalSession
    header, model, encoder = load_nww(weights.paths[config["bulk_model"]],
                                      device=device)
    return AudioFeatures(encoder_state_dict=encoder, device=device), \
        _LocalSession(model, header)
