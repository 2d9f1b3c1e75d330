"""One step captured into a `torch.cuda.CUDAGraph`, for replay.

The step takes no arguments: it reads and writes tensors that stay in
place, so every replay repeats it on whatever those tensors then hold. It
runs eagerly first, on a side stream (the warm-up builds the kernels, fills
their constants and lets cuDNN and cuBLAS settle; none of that may happen
under capture), then once under capture. The tensors in `state`, which the
warm-up changed, are put back afterwards. A mel kernel call made under
capture launches nothing and is counted in `ops/mel_cuda.captured`; whoever
replays the graph counts its launches with `mel_cuda.count_replayed`.
"""

from __future__ import annotations

import torch

from nanowakeword_tpu_torch.ops import mel_cuda


def capture_graph(step, device, state=(), warmup: int = 3):
    """-> (graph, mel kernel launches per replay) of `step` on the CUDA
    `device`."""
    saved = [t.clone() for t in state]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            step()
    torch.cuda.current_stream(device).wait_stream(side)
    recorded = mel_cuda.captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for dst, src in zip(state, saved):
        dst.copy_(src)
    return graph, mel_cuda.captured - recorded
