"""Data- and tensor-parallel training over a device mesh, in one process.

The counterpart of `nanowakeword_tpu/parallel/dp.py`, where XLA splits the
jitted step over the mesh. Here one process drives every device:

* `shard_train_state(module, optimizer, mesh)` makes one replica of the
  module on each data row's device and places the optimizer by
  `opt_shardings`: replicated parameters and their moments stay with the
  module on the primary device; a wide parameter's moments, and a copy of
  the parameter, are held in column shards on the model-axis devices.
* A step (`make_dp_train_step`) splits the batch into contiguous shards
  over the data axis, as `P("data")` splits it, and runs each shard through
  its replica in a thread of its own, on the module's parameters broadcast
  to the replica. The logits are gathered on the primary, the loss is the
  global batch's loss, and one backward gives each replica's gradients,
  which are summed in shard order (parallel/collectives.py); one optimizer
  step follows, and the updated column shards are gathered back into the
  module's parameter before its next use (the weight is gathered, not the
  outputs).
* The replicas' threads run in lockstep at every BatchNorm and dropout, so
  a step computes what the one-device step computes:
  - BatchNorm in training mode normalises with the global batch's
    statistics: each shard's sum and sum of squares are summed over the
    replicas, and the running statistics are updated once, on the module;
  - dropout draws the global batch's mask once, on the primary, from the
    generator the one-device step draws from and in the layout of its
    input, and each replica takes its rows.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nanowakeword_tpu_torch.models.architectures import _FlaxBatchNorm
from nanowakeword_tpu_torch.parallel import collectives as C
from nanowakeword_tpu_torch.parallel import mesh as M
from nanowakeword_tpu_torch.train import loss as losses
from nanowakeword_tpu_torch.train.optim import Optimizer, global_norm
from nanowakeword_tpu_torch.train.step import (StepMetrics, make_loss,
                                               resolve_compute_dtype,
                                               seed_dropout)

_local = threading.local()


class _Lockstep:
    """The replicas' meeting point: each rank hands in a value, rank 0
    combines them in rank order, and every rank takes its part."""

    def __init__(self, n: int):
        self.n = n
        self._barrier = threading.Barrier(n)
        self._slots: list = [None] * n
        self._result = None

    def exchange(self, rank: int, value, combine):
        if self.n == 1:
            return combine([value])[0]
        self._slots[rank] = value
        self._barrier.wait()
        if rank == 0:
            try:
                self._result = combine(list(self._slots))
            except BaseException:
                self._barrier.abort()
                raise
        self._barrier.wait()
        return self._result[rank]

    def abort(self) -> None:
        self._barrier.abort()


class _Rank(NamedTuple):
    lockstep: _Lockstep
    rank: int
    primary: torch.device


def _current() -> _Rank:
    rank = getattr(_local, "rank", None)
    if rank is None:
        raise RuntimeError("a data-parallel replica runs only inside a "
                           "data-parallel step")
    return rank


class _AllSum(torch.autograd.Function):
    """One tensor per shard -> their sum (in shard order) on each shard's
    device; the backward sums the gradients in the same order."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.devices = [x.device for x in xs]
        total = C.reduce_sum(xs, ctx.devices[0])
        return tuple(t.clone() for t in C.broadcast(total, ctx.devices))

    @staticmethod
    def backward(ctx, *grads):
        total = C.reduce_sum(grads, ctx.devices[0])
        return tuple(t.clone() for t in C.broadcast(total, ctx.devices))


class SyncBatchNorm(nn.Module):
    """A replica's flax BatchNorm in training mode: the global batch's
    mean and biased variance; rank 0 updates the module's running
    statistics."""

    def __init__(self, bn: _FlaxBatchNorm, owner: _FlaxBatchNorm):
        super().__init__()
        self.weight, self.bias = bn.weight, bn.bias
        self.eps, self.momentum = bn.eps, bn.flax_momentum
        self._owner = [owner]           # not a sub-module

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        me = _current()
        dims = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x.float()
        local = torch.stack([xf.sum(dims), (xf * xf).sum(dims)])

        def combine(parts):
            sums = _AllSum.apply(*[s for s, _ in parts])
            count = sum(c for _, c in parts)
            return [(s, count) for s in sums]

        total, count = me.lockstep.exchange(
            me.rank, (local, xf.numel() // xf.shape[1]), combine)
        mean = total[0] / count
        var = torch.clamp(total[1] / count - mean * mean, min=0.0)
        if me.rank == 0:
            owner, m = self._owner[0], self.momentum
            with torch.no_grad():
                owner.running_mean.copy_(m * owner.running_mean + (1.0 - m)
                                         * mean.to(owner.running_mean.device))
                owner.running_var.copy_(m * owner.running_var + (1.0 - m)
                                        * var.to(owner.running_var.device))
                owner.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean.view(shape)) * mul.view(shape) + \
            self.bias.view(shape)
        return out.to(x.dtype)


class _MaskedScale(torch.autograd.Function):
    """x * keep * scale as the card's fused dropout computes it: in float32,
    with its forward and backward scales."""

    @staticmethod
    def forward(ctx, x, keep, p):
        ctx.save_for_backward(keep)
        ctx.scale = float(np.float32(1.0 / (1.0 - p)))
        fwd = float(np.float32(1.0 / np.float64(np.float32(1.0 - p))))
        return ((x.float() * keep) * fwd).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        (keep,) = ctx.saved_tensors
        return ((grad.float() * keep) * ctx.scale).to(grad.dtype), None, None


def _global_noise(xs: List[torch.Tensor], p: float,
                  primary: torch.device) -> List[torch.Tensor]:
    """The one-device step's dropout draw for the concatenated shards, made
    on the primary on an input of the same layout, split into each shard's
    rows: a keep mask on the card, the multiplier on the CPU."""
    sizes = [x.shape[0] for x in xs]
    x0 = xs[0]
    shape = (sum(sizes),) + tuple(x0.shape[1:])
    span = x0.storage_offset() + 1 + sum(
        (n - 1) * s for n, s in zip(shape, x0.stride()))
    dummy = torch.ones(span, dtype=x0.dtype, device=primary).as_strided(
        shape, x0.stride(), x0.storage_offset())
    if primary.type == "cuda":
        noise = torch.native_dropout(dummy, p, True)[1]
    else:
        noise = F.dropout(dummy, p, True)
    return [part.to(x.device) for part, x in zip(torch.split(noise, sizes),
                                                  xs)]


class SyncDropout(nn.Module):
    """A replica's dropout: its rows of the global batch's mask."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        me = _current()
        noise = me.lockstep.exchange(
            me.rank, x, lambda xs: _global_noise(xs, self.p, me.primary))
        if noise.dtype == torch.bool:
            return _MaskedScale.apply(x, noise, self.p)
        return x * noise


def _replica(module: nn.Module, device: torch.device) -> nn.Module:
    """A copy of `module` on `device` whose BatchNorms and dropouts run in
    lockstep with the other replicas."""
    rep = copy.deepcopy(module).to(device)
    owners = dict(module.named_modules())
    for name, sub in list(rep.named_modules()):
        for child_name, child in list(sub.named_children()):
            path = f"{name}.{child_name}" if name else child_name
            if isinstance(child, _FlaxBatchNorm):
                setattr(sub, child_name, SyncBatchNorm(child, owners[path]))
            elif isinstance(child, nn.modules.batchnorm._BatchNorm):
                raise NotImplementedError(
                    f"{path}: data parallelism synchronises the flax "
                    f"BatchNorm of models/architectures.py, not "
                    f"{type(child).__name__}")
            elif isinstance(child, nn.Dropout):
                setattr(sub, child_name, SyncDropout(child.p))
    return rep.train()


class ShardedOptimizer(Optimizer):
    """An Optimizer placed on a mesh, with the module's replicas. Its
    `params` and `state` hold each replicated parameter (the module's own
    tensor) and the column shards of each wide one; `state_dict` and
    `load_state_dict` speak the unsharded layout, so checkpoints move
    between a mesh and one device."""

    def __init__(self, optimizer: Optimizer, module: nn.Module, mesh,
                 tp_threshold: int = 256):
        if isinstance(optimizer, ShardedOptimizer):
            raise TypeError("the optimizer is already sharded")
        self.__dict__.update(optimizer.__dict__)
        self.module, self.mesh = module, mesh
        primary = mesh.primary
        module.to(primary)
        names = {id(p): n for n, p in module.named_parameters()}
        self.names = [names[id(p)] for p in optimizer.params]
        self.full_params = list(optimizer.params)
        by_name = M.param_shardings(module, mesh, tp_threshold)
        self.param_shardings = [by_name[n] for n in self.names]
        # (parameter index, shard or None) of each entry of self.params
        self.slots = []
        for i, s in enumerate(self.param_shardings):
            self.slots += ([(i, None)] if not s.sharded
                           else [(i, j) for j in range(len(s.index))])
        self.params = [self._place(self.full_params[i], self.param_shardings[i],
                                   j) for i, j in self.slots]
        moments = M.opt_shardings(module, optimizer, mesh, tp_threshold)
        self.state = {k: [self._place(v[i], moments[k][i], j)
                          for i, j in self.slots]
                      for k, v in optimizer.state.items()}
        self.replicas = [_replica(module, d) for d in mesh.data_devices]

    def _place(self, t: torch.Tensor, sharding: M.ParamSharding,
               j: Optional[int]) -> torch.Tensor:
        """A parameter or moment `t` on the primary (j None), or its j-th
        column shard on the j-th model-axis device."""
        if j is None:
            return t if t.device == self.mesh.primary \
                else t.to(self.mesh.primary)
        index = sharding.index[j].to(t.device)
        return t.detach().reshape(-1)[index].to(
            self.mesh.model_devices[j]).contiguous()

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """`Optimizer.step` over the mesh: the clip takes the global norm
        over every device's entries of `params` (each device's norm, then
        across, on the primary), and each device's entries then take the
        one-device update."""
        g = list(grads)
        groups: Dict[torch.device, List[int]] = {}
        for i, p in enumerate(self.params):
            groups.setdefault(p.device, []).append(i)
        norm = torch.linalg.vector_norm(torch.stack(
            [global_norm([g[i] for i in idx]).to(self.mesh.primary)
             for idx in groups.values()]))
        if self.grad_clip and self.grad_clip > 0:
            for i, t in enumerate(g):
                n = norm.to(t.device)
                g[i] = torch.where(n < self.grad_clip, t,
                                   t / n * self.grad_clip)
        params, state, clip, count = (self.params, self.state,
                                      self.grad_clip, self.count)
        try:
            self.grad_clip = 0.0    # clipped above, by the global norm
            for idx in groups.values():
                self.params = [params[i] for i in idx]
                self.state = {k: [v[i] for i in idx] for k, v in state.items()}
                self.count = count
                super().step([g[i] for i in idx])
        finally:
            self.params, self.state, self.grad_clip = params, state, clip
        self.count = count + 1
        return norm

    def slot_grads(self, grads: Dict[str, List[torch.Tensor]]):
        """Per-parameter gradients of every replica (in data order) -> the
        gradient of each entry of `params`, summed in shard order."""
        out = []
        for i, j in self.slots:
            per_replica = grads[self.names[i]]
            if j is None:
                out.append(C.reduce_sum(per_replica, self.mesh.primary))
                continue
            index = self.param_shardings[i].index[j]
            out.append(C.reduce_sum(
                [g.reshape(-1)[index.to(g.device)] for g in per_replica],
                self.mesh.model_devices[j]))
        return out

    @torch.no_grad()
    def write_back(self) -> None:
        """Gather the updated column shards into the module's parameters."""
        for (i, j), shard in zip(self.slots, self.params):
            if j is not None:
                full = self.full_params[i]
                index = self.param_shardings[i].index[j].to(full.device)
                full.view(-1)[index] = shard.to(full.device)

    def state_dict(self) -> dict:
        state = {}
        for k, entries in self.state.items():
            full = [torch.zeros(p.shape, dtype=p.dtype)
                    for p in self.full_params]
            for (i, j), t in zip(self.slots, entries):
                if j is None:
                    full[i] = t.detach().cpu().clone()
                else:
                    full[i].view(-1)[self.param_shardings[i].index[j]] = \
                        t.detach().cpu()
            state[k] = full
        return {"count": self.count, "state": state}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Restore onto the mesh: the moments split into their shards, and
        the parameters' shards taken again from the module (load the
        module's state first)."""
        self.count = int(sd["count"])
        for k, entries in self.state.items():
            for (i, j), dst in zip(self.slots, entries):
                dst.copy_(self._place(sd["state"][k][i],
                                      self.param_shardings[i], j))
        for (i, j), dst in zip(self.slots, self.params):
            if j is not None:
                dst.copy_(self._place(self.full_params[i],
                                      self.param_shardings[i], j))


def shard_train_state(module: nn.Module, optimizer: Optimizer, mesh,
                      tp_threshold: int = 256) -> ShardedOptimizer:
    """Place `module` and `optimizer` on `mesh`: the module on the primary
    device with one replica per data row, the optimizer's wide parameters
    and moments in column shards. Train through the returned optimizer."""
    return ShardedOptimizer(optimizer, module, mesh, tp_threshold)


class ShardedBatch(NamedTuple):
    """A batch's contiguous data-axis shards, each on its row's device."""
    shards: List[torch.Tensor]


def shard_batch(features: torch.Tensor, mesh) -> ShardedBatch:
    n = mesh.shape[M.DATA_AXIS]
    if features.shape[0] % n:
        raise ValueError(f"a batch of {features.shape[0]} does not split "
                         f"evenly over {n} data shards")
    return ShardedBatch([x.to(d) for x, d in zip(
        torch.chunk(features, n), mesh.data_devices)])


def device_put_batch(features, labels, mesh):
    """Host batch -> (ShardedBatch of float32 features, labels on the
    primary device)."""
    f = torch.as_tensor(np.asarray(features, np.float32))
    y = torch.as_tensor(np.asarray(labels, np.float32))
    return shard_batch(f, mesh), y.to(mesh.primary)


def dp_forward_backward(optimizer: ShardedOptimizer, total_loss,
                        batch: ShardedBatch, labels: torch.Tensor,
                        compute_dtype: Optional[torch.dtype] = None,
                        dropout_seed: Optional[int] = None):
    """The data-parallel `train.step.forward_backward`: -> (loss, grad
    norm before the clip, logits [B] on the primary), detached."""
    mesh = optimizer.mesh
    primary, devices = mesh.primary, mesh.data_devices
    n = len(devices)
    if dropout_seed is not None:
        seed_dropout(primary, dropout_seed, optimizer.count)
    leaves = {}
    for name, p in optimizer.module.named_parameters():
        leaves[name] = [c.detach().requires_grad_()
                        for c in C.broadcast(p.detach(), devices)]
    lockstep = _Lockstep(n)
    logits: list = [None] * n
    errors: list = [None] * n

    def run(rank: int) -> None:
        _local.rank = _Rank(lockstep, rank, primary)
        try:
            params = {k: v[rank] for k, v in leaves.items()}
            x = batch.shards[rank]
            if compute_dtype is not None:
                params = {k: v.to(compute_dtype) for k, v in params.items()}
                x = x.to(compute_dtype)
            if devices[rank].type == "cuda":
                torch.cuda.set_device(devices[rank])
            out = torch.func.functional_call(optimizer.replicas[rank],
                                             params, (x,))
            logits[rank] = out.reshape(-1).float()
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors[rank] = e
            lockstep.abort()
        finally:
            _local.rank = None

    # replicas' threads run convolutions at once: TF32 stays off for the
    # whole step, so no thread's save-and-restore of the flag lets it in
    saved_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        threads = [threading.Thread(target=run, args=(r,), daemon=True)
                   for r in range(1, n)]
        for t in threads:
            t.start()
        run(0)
        for t in threads:
            t.join()
        first = next((e for e in errors if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        gathered = torch.cat([lg.to(primary) for lg in logits])
        total = total_loss(gathered, labels)
        names = list(leaves)
        flat = [t for name in names for t in leaves[name]]
        grads = torch.autograd.grad(total, flat, materialize_grads=True)
    finally:
        torch.backends.cudnn.allow_tf32 = saved_tf32
    per_name = {name: list(grads[k * n:(k + 1) * n])
                for k, name in enumerate(names)}
    grad_norm = optimizer.step(optimizer.slot_grads(per_name))
    optimizer.write_back()
    return total.detach(), grad_norm, gathered.detach()


def make_dp_train_step(module: nn.Module, optimizer: ShardedOptimizer, mesh,
                       *, compute_dtype: str = "float32",
                       dropout_seed: Optional[int] = None, **loss_kwargs):
    """The data-parallel `train.step.make_train_step`: (features [B, ...]
    as a tensor or a ShardedBatch, labels [B]) -> StepMetrics on the
    primary device. `optimizer` is what `shard_train_state` returned."""
    if not isinstance(optimizer, ShardedOptimizer) \
            or optimizer.module is not module or optimizer.mesh is not mesh:
        raise TypeError("pass the optimizer that shard_train_state(module, "
                        "optimizer, mesh) returned")
    cdt = resolve_compute_dtype(compute_dtype)
    total_loss = make_loss(**loss_kwargs)

    def step(features, labels) -> StepMetrics:
        batch = features if isinstance(features, ShardedBatch) \
            else shard_batch(features, mesh)
        labels = labels.to(mesh.primary)
        total, grad_norm, logits = dp_forward_backward(
            optimizer, total_loss, batch, labels, cdt, dropout_seed)
        raw = losses.raw_bce(logits, labels)
        return StepMetrics(torch.cat([total.reshape(1),
                                      grad_norm.reshape(1).float(), raw,
                                      logits]))

    return step
