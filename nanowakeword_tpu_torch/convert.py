"""Carry parameter trees between the JAX package's layout and the port's.

`*_state_dict_from_flax` take a flax variables tree as nested dicts of numpy
arrays (`params`, and `batch_stats` where the model has BatchNorm), as the
`.nww` and asset readers return it, and give the port's `state_dict`;
`flax_variables_from_state_dict` is the inverse for a classifier, as the
`.nww` writer stores it, and `flax_encoder_variables_from_state_dict` for
an encoder. `e2e_state_dict_from_flax` carries the end-to-end module's
tree (encoder and classifier) across.

A classifier's tree is walked, not tabulated: every composite module of
models/architectures.py lists its sub-modules in the order the reference
constructs them (`flax_order`), and flax names the i-th sub-module of a
class `<Class>_<i>`, so the names follow from the order. The leaves (Dense,
Conv, LayerNorm, BatchNorm, the fast RNNs, the cell-based `UniRNN`,
attention) each have a converter in both directions. A backbone with no
`flax_order` (a user's custom module) is stored by its own state_dict
names, nested at the dots.

Layouts:
* a 2-D conv kernel [kh, kw, in, out] becomes [out, in, kh, kw];
* a 1-D conv kernel [k, in, out] becomes [out, in, k];
* a Dense kernel [in, out] becomes a Linear weight [out, in];
* a depthwise kernel [k, 1, C] becomes [C, 1, k] by the same transposes;
* LayerNorm and BatchNorm `scale` become `weight`, BatchNorm's running
  `mean`/`var` become `running_mean`/`running_var`;
* attention's `query`/`key`/`value` kernels [d, heads, head_dim] become
  Linear weights [heads * head_dim, d], and `out` [heads, head_dim, d]
  becomes [d, heads * head_dim].
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nanowakeword_tpu_torch.models import architectures as A
from nanowakeword_tpu_torch.models.embedding import infer_encoder_arch
from nanowakeword_tpu_torch.models.fast_rnn import FastGRU, FastLSTM


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _with_bias(sd: dict, p) -> dict:
    if "bias" in p:
        sd["bias"] = _t(p["bias"])
    return sd


def _dense(p) -> dict:
    return _with_bias({"weight": _t(np.asarray(p["kernel"]).T)}, p)


def _conv2d(p) -> dict:
    return _with_bias(
        {"weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))}, p)


def _conv1d(p) -> dict:
    return _with_bias(
        {"weight": _t(np.asarray(p["kernel"]).transpose(2, 1, 0))}, p)


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


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _sub(sd: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in sd.items()
            if k.startswith(prefix + ".")}


def _count(sd: dict, prefix: str) -> int:
    return len({k.split(".")[1] for k in sd if k.startswith(prefix + ".")})


def _kernel_flax(sd, axes) -> dict:
    """A Linear / Conv state_dict -> flax {kernel, bias}; `axes` moves the
    weight into flax's layout."""
    out = {"kernel": _np(sd["weight"]).transpose(axes).copy()}
    if "bias" in sd:
        out["bias"] = _np(sd["bias"])
    return out


def _dense_flax(sd) -> dict:
    return _kernel_flax(sd, (1, 0))


def _norm_flax(sd) -> dict:
    return {"bias": _np(sd["bias"]), "scale": _np(sd["weight"])}


def _rnn_flax(sd) -> dict:
    return {"input_proj": _dense_flax(_sub(sd, "input_proj")),
            "recurrent_bias": _np(sd["recurrent.bias"]),
            "recurrent_kernel": _np(sd["recurrent.weight"]).T.copy()}


def _attention(p, module) -> dict:
    d = module.out.in_features
    sd = {}
    for name in ("query", "key", "value"):
        sd[f"{name}.weight"] = _t(np.asarray(p[name]["kernel"])
                                  .reshape(-1, d).T)
        sd[f"{name}.bias"] = _t(np.asarray(p[name]["bias"]).reshape(d))
    sd["out.weight"] = _t(np.asarray(p["out"]["kernel"]).reshape(d, -1).T)
    sd["out.bias"] = _t(p["out"]["bias"])
    return sd


def _attention_flax(sd, module) -> dict:
    h = module.n_head
    d = module.out.in_features
    out = {}
    for name in ("query", "key", "value"):
        out[name] = {
            "kernel": _np(sd[f"{name}.weight"]).T.reshape(-1, h, d // h)
            .copy(),
            "bias": _np(sd[f"{name}.bias"]).reshape(h, d // h)}
    out["out"] = {"kernel": _np(sd["out.weight"]).T.reshape(h, d // h, -1)
                  .copy(),
                  "bias": _np(sd["out.bias"])}
    return out


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


# -- the walk over a classifier's modules ------------------------------------------

_BATCHNORMS = (A.FlaxBatchNorm1d, A.FlaxBatchNorm2d)
# leaf module type -> (flax class name,
#                      (flax params, flax stats, module) -> state_dict,
#                      (state_dict, module) -> flax params)
_LEAVES = (
    (nn.Linear, "Dense", lambda p, s, m: _dense(p),
     lambda sd, m: _dense_flax(sd)),
    (nn.Conv2d, "Conv", lambda p, s, m: _conv2d(p),
     lambda sd, m: _kernel_flax(sd, (2, 3, 1, 0))),
    (nn.Conv1d, "Conv", lambda p, s, m: _conv1d(p),
     lambda sd, m: _kernel_flax(sd, (2, 1, 0))),
    (nn.LayerNorm, "LayerNorm", lambda p, s, m: _layernorm(p),
     lambda sd, m: _norm_flax(sd)),
    (_BATCHNORMS, "BatchNorm", lambda p, s, m: _batchnorm(p, s),
     lambda sd, m: _norm_flax(sd)),
    (FastGRU, "FastGRU", lambda p, s, m: _rnn(p),
     lambda sd, m: _rnn_flax(sd)),
    (FastLSTM, "FastLSTM", lambda p, s, m: _rnn(p),
     lambda sd, m: _rnn_flax(sd)),
    (A.UniRNN, "UniRNN", lambda p, s, m: unirnn_state_dict_from_flax(p),
     lambda sd, m: flax_params_from_unirnn(sd)),
    (A.MultiHeadAttention, "MultiHeadDotProductAttention",
     lambda p, s, m: _attention(p, m), _attention_flax),
)


def _leaf(module):
    for types, name, from_flax, to_flax in _LEAVES:
        if isinstance(module, types):
            return name, from_flax, to_flax
    return None


def _flax_children(module):
    """(flax name, sub-module) in the reference's construction order: the
    i-th sub-module of a flax class is named `<Class>_<i>`."""
    counts: dict = {}
    for child in module.flax_order():
        leaf = _leaf(child)
        cls = leaf[0] if leaf else type(child).__name__
        i = counts.get(cls, 0)
        counts[cls] = i + 1
        yield f"{cls}_{i}", child


def _child_paths(module) -> dict:
    """id(sub-module) -> its state_dict prefix inside `module`, for direct
    children and the entries of a ModuleList."""
    names = {}
    for n, m in module.named_children():
        names[id(m)] = n
        if isinstance(m, nn.ModuleList):
            names.update({id(e): f"{n}.{i}" for i, e in enumerate(m)})
    return names


def _module_from_flax(module, params, stats) -> dict:
    leaf = _leaf(module)
    if leaf:
        return leaf[1](params, stats, module)
    if not hasattr(module, "flax_order"):
        return _opaque_from_tree(params)
    names = _child_paths(module)
    sd = {}
    for name, child in _flax_children(module):
        sd.update(_prefixed(names[id(child)], _module_from_flax(
            child, params[name], (stats or {}).get(name))))
    return sd


def _module_to_flax(module, sd):
    """-> (flax params, flax batch_stats or None) of one module, given its
    own state_dict."""
    leaf = _leaf(module)
    if leaf:
        stats = None
        if isinstance(module, _BATCHNORMS):
            stats = {"mean": _np(sd["running_mean"]),
                     "var": _np(sd["running_var"])}
        return leaf[2](sd, module), stats
    if not hasattr(module, "flax_order"):
        return _opaque_to_tree(sd), None
    names = _child_paths(module)
    params, stats = {}, {}
    for name, child in _flax_children(module):
        params[name], child_stats = _module_to_flax(
            child, _sub(sd, names[id(child)]))
        if child_stats:
            stats[name] = child_stats
    return params, stats or None


def _opaque_from_tree(tree, prefix="") -> dict:
    """A custom module's tree, nested at the dots of its state_dict names,
    back to that state_dict (dtypes as stored)."""
    sd = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sd.update(_opaque_from_tree(v, f"{prefix}{k}."))
        else:
            sd[prefix + k] = torch.tensor(np.asarray(v))
    return sd


def _opaque_to_tree(sd) -> dict:
    tree: dict = {}
    for k, v in sd.items():
        *path, leaf = k.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v.detach().cpu().numpy()
    return tree


def model_state_dict_from_flax(variables, model) -> dict:
    """A Model's variables ({"params", "batch_stats"}) -> the state_dict of
    the port's `model.module` (a WakeWordModule), for every model type."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = _prefixed("backbone", _module_from_flax(
        model.module.backbone, params["backbone"], stats.get("backbone")))
    sd.update(_prefixed("head_hidden", _dense(params["Dense_0"])))
    sd.update(_prefixed("head_out", _dense(params["Dense_1"])))
    return sd


def flax_variables_from_state_dict(state_dict, model) -> dict:
    """The port's `model.module.state_dict()` -> the JAX `Model`'s variables
    ({"params"}, and {"batch_stats"} where the backbone has BatchNorm), as
    numpy arrays."""
    sd = dict(state_dict)
    backbone, stats = _module_to_flax(model.module.backbone,
                                      _sub(sd, "backbone"))
    params = {"Dense_0": _dense_flax(_sub(sd, "head_hidden")),
              "Dense_1": _dense_flax(_sub(sd, "head_out")),
              "backbone": backbone}
    if stats is None:
        return {"params": params}
    return {"batch_stats": {"backbone": stats}, "params": params}


def flax_encoder_variables_from_state_dict(state_dict) -> dict:
    """The inverse of `encoder_state_dict_from_flax`: an encoder's
    state_dict -> its flax variables ({"params"}, numpy arrays)."""
    sd = dict(state_dict)
    params = {"Dense_0": _dense_flax(_sub(sd, "dense"))}
    if "conv0.weight" in sd:
        params["Conv_0"] = _kernel_flax(_sub(sd, "conv0"), (2, 3, 1, 0))
        for i in range(3):
            params[f"Conv_{i + 1}"] = _kernel_flax(_sub(sd, f"convs.{i}"),
                                                   (2, 1, 0))
    else:
        for i in range(4):
            params[f"Conv_{i}"] = _kernel_flax(_sub(sd, f"convs.{i}"),
                                               (2, 3, 1, 0))
    return {"params": params}


def e2e_state_dict_from_flax(variables, e2e_model) -> dict:
    """An end-to-end module's flax variables ({"params": {"encoder",
    "classifier"}}, and the classifier's "batch_stats") -> the state_dict
    of `e2e_model.module` (train/e2e.py's EndToEndModule)."""
    params = variables["params"]
    sd = _prefixed("encoder", encoder_state_dict_from_flax(
        {"params": params["encoder"]}))
    clf = {"params": params["classifier"],
           "batch_stats": variables.get("batch_stats", {})
           .get("classifier", {})}
    sd.update(_prefixed("classifier", model_state_dict_from_flax(
        clf, e2e_model.classifier_model)))
    return sd
