"""Device mesh construction and sharding rules.

The counterpart of `nanowakeword_tpu/parallel/mesh.py`: a 2-D ``(data,
model)`` grid of devices. Batches split over ``data``; wide parameters
split over ``model`` (tensor parallelism); everything else replicates.

One process drives the whole mesh, as the JAX package's single controller
does: a mesh device is a `torch.device`, and one device may appear more
than once (replicas on one card, or `[cpu] * 8` in the tests). The first
device of each data row computes that row's shard of the batch; the first
device of the mesh (the primary) holds the module that the caller owns.

The tensor-parallel rule is the JAX package's, applied to the flax shape
that convert.py maps each torch parameter to: a kernel with two or more
dimensions whose last flax dimension is >= `tp_threshold` and divisible by
the model-axis size is split into column shards over the model axis. A
shard is the set of torch elements that land in one column block of the
flax kernel, so the rule and the split follow the flax layout whatever the
torch layout (`Linear.weight` is [out, in] where flax has [in, out]).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A [data, model] grid of torch devices."""

    def __init__(self, grid: Sequence[Sequence]):
        self.grid: List[List[torch.device]] = [
            [torch.device(d) for d in row] for row in grid]
        if not self.grid or not self.grid[0] or len(
                {len(row) for row in self.grid}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.shape: Dict[str, int] = {DATA_AXIS: len(self.grid),
                                      MODEL_AXIS: len(self.grid[0])}

    @property
    def devices(self) -> List[torch.device]:
        return [d for row in self.grid for d in row]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        return self.grid[0][0]

    @property
    def data_devices(self) -> List[torch.device]:
        """The device that computes each data row's shard of a batch."""
        return [row[0] for row in self.grid]

    @property
    def model_devices(self) -> List[torch.device]:
        """The devices that hold the column shards of a wide parameter."""
        return list(self.grid[0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in r] for r in self.grid]})"


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over the first n_devices of `devices` (by
    default every visible CUDA device)."""
    devices = list(devices) if devices is not None else visible_devices()
    n = len(devices) if n_devices is None else n_devices
    if n % model_parallel != 0:
        raise ValueError(f"n_devices={n} not divisible by "
                         f"model_parallel={model_parallel}")
    if not 0 < n <= len(devices):
        raise ValueError(f"n_devices={n}, but {len(devices)} devices are "
                         "visible")
    devices = devices[:n]
    return Mesh([devices[i:i + model_parallel]
                 for i in range(0, n, model_parallel)])


class ParamSharding(NamedTuple):
    """Where one parameter lives: replicated (`index` None), or in column
    shards, `index[j]` holding the flat torch-layout positions of shard j
    (on the j-th model-axis device). `flax_paths` names the flax leaves the
    parameter maps to."""

    flax_paths: Tuple[str, ...]
    index: Optional[Tuple[torch.Tensor, ...]]

    @property
    def sharded(self) -> bool:
        return self.index is not None


def _flax_leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flax_leaves(v, path)
        else:
            yield path, np.asarray(v)


def _flax_layout(module: nn.Module):
    """name -> [(flax path, flax array of torch flat positions)] for each
    parameter of a WakeWordModule, through convert.py's walk; None for a
    module convert.py has no walk for, or whose flax leaves mix
    parameters."""
    if not hasattr(module, "backbone"):
        return None
    from types import SimpleNamespace

    from nanowakeword_tpu_torch.convert import flax_variables_from_state_dict
    shim = SimpleNamespace(module=module)
    params = dict(module.named_parameters())
    state = {k: torch.zeros_like(v, device="cpu")
             for k, v in module.state_dict().items()}

    def leaves(fill):
        sd = dict(state)
        for i, (name, p) in enumerate(params.items()):
            sd[name] = fill(i, p)
        variables = flax_variables_from_state_dict(sd, shim)
        return dict(_flax_leaves(variables["params"]))

    # convert.py hands the values on as float32, exact below 2**24: the
    # positions travel in two parts, position // 4096 and position % 4096
    def part(op):
        return leaves(lambda i, p: op(torch.arange(
            p.numel(), dtype=torch.int64), 4096).reshape(p.shape).float())

    owners = leaves(lambda i, p: torch.full(p.shape, float(i)))
    high, low = part(torch.floor_divide), part(torch.remainder)
    names = list(params)
    layout: Dict[str, list] = {name: [] for name in names}
    for path, owner in owners.items():
        ids = np.unique(owner)
        if len(ids) != 1:
            return None
        layout[names[int(ids[0])]].append(
            (path, high[path].astype(np.int64) * 4096
             + low[path].astype(np.int64)))
    return layout


def param_shardings(module: nn.Module, mesh: Mesh,
                    tp_threshold: int = 256) -> Dict[str, ParamSharding]:
    """name -> ParamSharding for every parameter of `module`:
    tensor-parallel on wide kernels (by their flax shape), replicated
    otherwise. Raises on a model axis wider than 1 where the module's flax
    layout cannot be worked out."""
    tp = mesh.shape[MODEL_AXIS]
    layout = _flax_layout(module)
    if layout is None:
        if tp > 1:
            raise ValueError(
                f"no flax layout for {type(module).__name__}, so the "
                "tensor-parallel rule cannot be applied; use model_parallel=1")
        return {name: ParamSharding((name,), None)
                for name, _ in module.named_parameters()}
    out = {}
    for name, p in module.named_parameters():
        leaves = layout[name]
        paths = tuple(path for path, _ in leaves)
        wide = [pos for _, pos in leaves
                if tp > 1 and pos.ndim >= 2 and pos.shape[-1] >= tp_threshold
                and pos.shape[-1] % tp == 0]
        if not leaves or len(wide) != len(leaves):
            out[name] = ParamSharding(paths, None)
            continue
        index = []
        for j in range(tp):
            cols = [np.array_split(pos, tp, axis=-1)[j].reshape(-1)
                    for pos in wide]
            index.append(torch.from_numpy(np.sort(np.concatenate(cols))))
        out[name] = ParamSharding(paths, tuple(index))
    return out


def opt_shardings(module: nn.Module, optimizer, mesh: Mesh,
                  tp_threshold: int = 256) -> Dict[str, List[ParamSharding]]:
    """Shardings of the optimizer's state: each moment buffer has its
    parameter's shape and goes with its parameter, so a wide parameter's
    moments are held in the same column shards."""
    by_tensor = {id(p): s for (_, p), s in zip(
        module.named_parameters(),
        param_shardings(module, mesh, tp_threshold).values())}
    per_param = [by_tensor[id(p)] for p in optimizer.params]
    return {kind: list(per_param) for kind in optimizer.state}
