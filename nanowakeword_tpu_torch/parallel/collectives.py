"""Sum, broadcast and gather over a mesh's devices, in a fixed shard order.

Every mesh takes the same path: shards are moved to the destination with
`Tensor.to` and summed with plain tensor additions in shard order, and a
broadcast aliases the tensor on its own device. The order never depends on
timing or on where the devices lie, so a run over a mesh repeats bit for
bit, on replicas of one device and on distinct devices alike.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def reduce_sum(tensors: Sequence[torch.Tensor],
               destination: torch.device) -> torch.Tensor:
    """The sum of `tensors` (one per shard, in shard order) on
    `destination`."""
    destination = torch.device(destination)
    total = tensors[0].to(destination)
    if len(tensors) > 1 and total is tensors[0]:
        total = total.clone()
    for t in tensors[1:]:
        total.add_(t.to(destination))
    return total


def broadcast(tensor: torch.Tensor,
              devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """`tensor` on each of `devices`; the entries on its own device are
    `tensor` itself."""
    devices = [torch.device(d) for d in devices]
    copies = {d: tensor.to(d) for d in dict.fromkeys(devices)}
    return [copies[d] for d in devices]


def gather(tensors: Sequence[torch.Tensor], destination: torch.device,
           dim: int = 0) -> torch.Tensor:
    """The shards concatenated along `dim` in shard order, on
    `destination`."""
    destination = torch.device(destination)
    return torch.cat([t.to(destination) for t in tensors], dim=dim)
