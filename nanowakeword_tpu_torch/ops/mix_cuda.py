"""The mix + gain pass on the card, and the dispatch between it and its plain
version.

`mix_gain_cuda` launches the hand-written Hopper kernel (`csrc/mix_gain.cu`),
the counterpart of the TPU kernel
`nanowakeword_tpu/ops/mix_pallas.py::mix_gain_pallas`. `mix_gain_plain`
(ops/mix.py) is the same function in plain PyTorch. `mix_gain_fused` picks by
the device of its input: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel, and any other device raises. A CUDA tensor never falls
back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from nanowakeword_tpu_torch.ops import _build
from nanowakeword_tpu_torch.ops.mix import check_mix_inputs, mix_gain_plain
from nanowakeword_tpu_torch.utils.tracing import counters

_FG_DTYPES = {torch.int16: 0, torch.float32: 1}


def __getattr__(name: str):
    # `launches`: kernel launches since import (or the last reset), the
    # `mix.launches` counter of utils/tracing.py: a run shows with it that
    # the augmentation went through the kernel
    if name == "launches":
        return counters["mix.launches"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    counters["mix.launches"] = 0


def _library() -> ctypes.CDLL:
    lib = _build.load("mix_gain")
    fn = lib.nww_mix_gain
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, p, p, p, p, p, p, ll, ll, p]
        fn.restype = ctypes.c_int
    return lib


def mix_gain_cuda(fg: torch.Tensor, bg: torch.Tensor, q: torch.Tensor,
                  scale: torch.Tensor, has_bg: torch.Tensor,
                  gain: torch.Tensor) -> torch.Tensor:
    """`mix_gain_plain`'s function on a CUDA device, by the kernel."""
    if fg.device.type != "cuda":
        raise ValueError(f"mix_gain_cuda needs CUDA tensors, got {fg.device}")
    check_mix_inputs(fg, bg, q, scale, has_bg, gain)
    if not (fg.is_contiguous() and bg.is_contiguous()):
        raise ValueError("mix_gain_cuda needs contiguous fg and bg")
    batch, n = fg.shape
    q32 = q.to(torch.int32).contiguous()
    hb32 = has_bg.to(torch.int32).contiguous()
    sc = scale.to(torch.float32).contiguous()
    g = gain.to(torch.float32).contiguous()
    out = torch.empty((batch, n), dtype=torch.float32, device=fg.device)
    lib = _library()
    with torch.cuda.device(fg.device):
        stream = torch.cuda.current_stream(fg.device).cuda_stream
        err = lib.nww_mix_gain(
            fg.data_ptr(), _FG_DTYPES[fg.dtype], bg.data_ptr(),
            q32.data_ptr(), sc.data_ptr(), hb32.data_ptr(), g.data_ptr(),
            out.data_ptr(), batch, n, stream)
    if err != 0:
        raise RuntimeError(f"mix_gain kernel launch failed: CUDA error {err}")
    counters["mix.launches"] += 1
    return out


def mix_gain_fused(fg: torch.Tensor, bg: torch.Tensor, q: torch.Tensor,
                   scale: torch.Tensor, has_bg: torch.Tensor,
                   gain: torch.Tensor) -> torch.Tensor:
    """The mix + gain pass by the device of `fg`: the plain version for a
    CPU tensor, the kernel for a CUDA tensor; other devices raise."""
    if fg.device.type == "cpu":
        return mix_gain_plain(fg, bg, q, scale, has_bg, gain)
    if fg.device.type == "cuda":
        return mix_gain_cuda(fg, bg, q, scale, has_bg, gain)
    raise ValueError(f"mix_gain_fused supports cpu and cuda tensors, got "
                     f"{fg.device}")
