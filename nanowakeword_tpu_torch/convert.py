"""Carry parameter trees between the JAX package's layout and the port's.

`*_state_dict_from_flax` take a flax variables tree as nested dicts of numpy
arrays (`params`, and `batch_stats` where the model has BatchNorm), as the
`.nww` and asset readers return it, and give the port's `state_dict`;
`flax_variables_from_state_dict` is the inverse for a classifier, as the
`.nww` writer stores it.

Layouts:
* a 2-D conv kernel [kh, kw, in, out] becomes [out, in, kh, kw];
* a 1-D conv kernel [k, in, out] becomes [out, in, k];
* a Dense kernel [in, out] becomes a Linear weight [out, in];
* LayerNorm and BatchNorm `scale` become `weight`, BatchNorm's running
  `mean`/`var` become `running_mean`/`running_var`.
"""

from __future__ import annotations

import numpy as np
import torch

from nanowakeword_tpu_torch.models.embedding import infer_encoder_arch
from nanowakeword_tpu_torch.models.fast_rnn import FastGRU


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _dense(p) -> dict:
    return {"weight": _t(np.asarray(p["kernel"]).T), "bias": _t(p["bias"])}


def _conv2d(p) -> dict:
    return {"weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)),
            "bias": _t(p["bias"])}


def _conv1d(p) -> dict:
    return {"weight": _t(np.asarray(p["kernel"]).transpose(2, 1, 0)),
            "bias": _t(p["bias"])}


def _layernorm(p) -> dict:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _batchnorm(p, stats) -> dict:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"]),
            "running_mean": _t(stats["mean"]),
            "running_var": _t(stats["var"]),
            "num_batches_tracked": torch.tensor(0, dtype=torch.long)}


def _rnn(p) -> dict:
    return {"input_proj.weight": _t(np.asarray(p["input_proj"]["kernel"]).T),
            "input_proj.bias": _t(p["input_proj"]["bias"]),
            "recurrent.weight": _t(np.asarray(p["recurrent_kernel"]).T),
            "recurrent.bias": _t(p["recurrent_bias"])}


def _prefixed(prefix: str, d: dict) -> dict:
    return {f"{prefix}.{k}": v for k, v in d.items()}


def encoder_state_dict_from_flax(variables) -> dict:
    """Encoder variables (conv4, wide128 or wide256) -> the state_dict of
    models/embedding.py's module of the same architecture."""
    params = variables.get("params", variables)
    sd = _prefixed("dense", _dense(params["Dense_0"]))
    if infer_encoder_arch(variables) == "conv4":
        for i in range(4):
            sd.update(_prefixed(f"convs.{i}", _conv2d(params[f"Conv_{i}"])))
    else:
        sd.update(_prefixed("conv0", _conv2d(params["Conv_0"])))
        for i in range(3):
            sd.update(_prefixed(f"convs.{i}",
                                _conv1d(params[f"Conv_{i + 1}"])))
    return sd


def _dnn(p) -> dict:
    sd = {}
    n_dense = sum(1 for k in p if k.startswith("Dense_"))
    for i in range(n_dense):
        sd.update(_prefixed(f"linears.{i}", _dense(p[f"Dense_{i}"])))
    for i in range(n_dense - 1):
        sd.update(_prefixed(f"norms.{i}", _layernorm(p[f"LayerNorm_{i}"])))
    return sd


def _crnn(p, stats) -> dict:
    sd = _prefixed("dense", _dense(p["Dense_0"]))
    n_conv = sum(1 for k in p if k.startswith("Conv_"))
    for i in range(n_conv):
        sd.update(_prefixed(f"convs.{i}", _conv2d(p[f"Conv_{i}"])))
        sd.update(_prefixed(f"norms.{i}", _batchnorm(
            p[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"])))
    (rnn_params,) = (v for k, v in p.items() if k.startswith("BiRNN_"))
    for name, layer in rnn_params.items():
        # FastGRU_j / FastLSTM_j, numbered in call order
        j = int(name.rsplit("_", 1)[1])
        sd.update(_prefixed(f"rnn.layers.{j}", _rnn(layer)))
    return sd


_GRU_GATES = ("r", "z", "n")
_LSTM_GATES = ("i", "f", "g", "o")


def unirnn_state_dict_from_flax(p) -> dict:
    """A flax `UniRNN`'s params (`GRUCell_i` / `OptimizedLSTMCell_i`, each a
    Dense per gate: `ir/iz/in` with biases and `hr/hz/hn` with a bias on
    `hn` only; for the LSTM `ii/if/ig/io` without and `hi/hf/hg/ho` with
    biases) -> the state_dict of architectures.UniRNN, whose layers stack
    the gates' kernels in that order."""
    sd = {}
    for name, cell in p.items():
        i = int(name.rsplit("_", 1)[1])
        gru = name.startswith("GRUCell")
        gates = _GRU_GATES if gru else _LSTM_GATES

        def stacked(side, leaf):
            return _t(np.concatenate(
                [np.asarray(cell[side + g][leaf]).T for g in gates], axis=0))

        sd[f"layers.{i}.input_proj.weight"] = stacked("i", "kernel")
        sd[f"layers.{i}.recurrent.weight"] = stacked("h", "kernel")
        if gru:
            sd[f"layers.{i}.input_proj.bias"] = stacked("i", "bias")
            sd[f"layers.{i}.bias_hn"] = _t(cell["hn"]["bias"])
        else:
            sd[f"layers.{i}.recurrent.bias"] = stacked("h", "bias")
    return sd


def _streaming_gru(p) -> dict:
    sd = _prefixed("dense", _dense(p["Dense_0"]))
    sd.update(_prefixed("rnn", unirnn_state_dict_from_flax(p["UniRNN_0"])))
    return sd


def model_state_dict_from_flax(variables, model) -> dict:
    """A Model's variables ({"params", "batch_stats"}) -> the state_dict of
    the port's `model.module` (a WakeWordModule)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if model.model_type == "dnn":
        backbone = _dnn(params["backbone"])
    elif model.model_type == "crnn":
        backbone = _crnn(params["backbone"], stats["backbone"])
    elif model.model_type == "streaming_gru":
        backbone = _streaming_gru(params["backbone"])
    else:
        raise NotImplementedError(
            f"no weight conversion for model_type '{model.model_type}'")
    sd = _prefixed("backbone", backbone)
    sd.update(_prefixed("head_hidden", _dense(params["Dense_0"])))
    sd.update(_prefixed("head_out", _dense(params["Dense_1"])))
    return sd


# -- the inverse: the port's state_dict -> flax variables -----------------------


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _sub(sd: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in sd.items()
            if k.startswith(prefix + ".")}


def _dense_flax(sd) -> dict:
    return {"bias": _np(sd["bias"]), "kernel": _np(sd["weight"]).T.copy()}


def _conv2d_flax(sd) -> dict:
    return {"bias": _np(sd["bias"]),
            "kernel": _np(sd["weight"]).transpose(2, 3, 1, 0).copy()}


def _rnn_flax(sd) -> dict:
    return {"input_proj": _dense_flax(_sub(sd, "input_proj")),
            "recurrent_bias": _np(sd["recurrent.bias"]),
            "recurrent_kernel": _np(sd["recurrent.weight"]).T.copy()}


def _count(sd: dict, prefix: str) -> int:
    return len({k.split(".")[1] for k in sd if k.startswith(prefix + ".")})


def flax_params_from_unirnn(sd) -> dict:
    """architectures.UniRNN's state_dict -> the flax `UniRNN`'s params: the
    inverse of `unirnn_state_dict_from_flax`."""
    params = {}
    for i in range(_count(sd, "layers")):
        layer = _sub(sd, f"layers.{i}")
        gru = "bias_hn" in layer
        gates = _GRU_GATES if gru else _LSTM_GATES
        w_i = np.split(_np(layer["input_proj.weight"]), len(gates))
        w_h = np.split(_np(layer["recurrent.weight"]), len(gates))
        cell = {}
        for k, g in enumerate(gates):
            cell["i" + g] = {"kernel": w_i[k].T.copy()}
            cell["h" + g] = {"kernel": w_h[k].T.copy()}
        if gru:
            for k, b in enumerate(np.split(_np(layer["input_proj.bias"]), 3)):
                cell["i" + gates[k]]["bias"] = b.copy()
            cell["hn"]["bias"] = _np(layer["bias_hn"])
        else:
            for k, b in enumerate(np.split(_np(layer["recurrent.bias"]), 4)):
                cell["h" + gates[k]]["bias"] = b.copy()
        name = "GRUCell" if gru else "OptimizedLSTMCell"
        params[f"{name}_{i}"] = cell
    return params


def flax_variables_from_state_dict(state_dict, model) -> dict:
    """The port's `model.module.state_dict()` -> the JAX `Model`'s variables
    ({"params"}, and {"batch_stats"} for the CRNN), as numpy arrays."""
    sd = dict(state_dict)
    bb = _sub(sd, "backbone")
    if model.model_type == "dnn":
        backbone = {f"Dense_{i}": _dense_flax(_sub(bb, f"linears.{i}"))
                    for i in range(_count(bb, "linears"))}
        for i in range(_count(bb, "norms")):
            norm = _sub(bb, f"norms.{i}")
            backbone[f"LayerNorm_{i}"] = {"bias": _np(norm["bias"]),
                                          "scale": _np(norm["weight"])}
        stats = None
    elif model.model_type == "crnn":
        backbone = {"Dense_0": _dense_flax(_sub(bb, "dense"))}
        stats = {}
        for i in range(_count(bb, "convs")):
            norm = _sub(bb, f"norms.{i}")
            backbone[f"Conv_{i}"] = _conv2d_flax(_sub(bb, f"convs.{i}"))
            backbone[f"BatchNorm_{i}"] = {"bias": _np(norm["bias"]),
                                          "scale": _np(norm["weight"])}
            stats[f"BatchNorm_{i}"] = {"mean": _np(norm["running_mean"]),
                                       "var": _np(norm["running_var"])}
        name = "FastGRU" if isinstance(
            model.module.backbone.rnn.layers[0], FastGRU) else "FastLSTM"
        backbone["BiRNN_0"] = {
            f"{name}_{j}": _rnn_flax(_sub(bb, f"rnn.layers.{j}"))
            for j in range(_count(_sub(bb, "rnn"), "layers"))}
    elif model.model_type == "streaming_gru":
        backbone = {"Dense_0": _dense_flax(_sub(bb, "dense")),
                    "UniRNN_0": flax_params_from_unirnn(_sub(bb, "rnn"))}
        stats = None
    else:
        raise NotImplementedError(
            f"no weight conversion for model_type '{model.model_type}'")
    params = {"Dense_0": _dense_flax(_sub(sd, "head_hidden")),
              "Dense_1": _dense_flax(_sub(sd, "head_out")),
              "backbone": backbone}
    if stats is None:
        return {"params": params}
    return {"batch_stats": {"backbone": stats}, "params": params}
