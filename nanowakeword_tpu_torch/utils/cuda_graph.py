"""One step captured into a `torch.cuda.CUDAGraph`, for replay.

The step takes no arguments: it reads and writes tensors that stay in
place, so every replay repeats it on whatever those tensors then hold. It
runs eagerly first, on a side stream (the warm-up builds the kernels, fills
their constants and lets cuDNN and cuBLAS settle; none of that may happen
under capture), then once under capture. The tensors in `state`, which the
warm-up changed, are put back afterwards. Graphs captured with one `pool`
share its memory: each may then only read, of what another wrote, the
tensors that live outside the pool (allocated before any capture).

A mel kernel call made under capture launches nothing and is counted in
the `mel.captured` counter (utils/tracing.py); `capture_graph` returns how
many such calls the graph holds, and `replay` adds them to `mel.launches`
at each replay. Captures and replays are counted in `graph.captures` and
`graph.replays`.
"""

from __future__ import annotations

import torch

from nanowakeword_tpu_torch.utils.tracing import counters


def capture_graph(step, device, state=(), warmup: int = 3, pool=None,
                  side=None):
    """-> (graph, mel kernel launches per replay) of `step` on the CUDA
    `device`. `pool`: another graph's `pool()`, to capture into its memory
    pool; `side`: the side stream to warm up on (a new one by default), to
    share with another capture: cuBLAS keeps a workspace, 32 MiB on Hopper,
    for each stream it has run on."""
    saved = [t.clone() for t in state]
    side = side or torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            step()
    torch.cuda.current_stream(device).wait_stream(side)
    recorded = counters["mel.captured"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        step()
    for dst, src in zip(state, saved):
        dst.copy_(src)
    counters["graph.captures"] += 1
    return graph, counters["mel.captured"] - recorded


def replay(graph, mel_launches: int) -> None:
    """Replay a captured graph that holds `mel_launches` mel kernel calls,
    and count the replay and its launches."""
    graph.replay()
    counters["graph.replays"] += 1
    counters["mel.launches"] += mel_launches

