"""The augmentation pre-stage's mix + gain pass, in plain PyTorch.

`mix_gain_plain` is the contract of the TPU kernel
`nanowakeword_tpu/ops/mix_pallas.py::mix_gain_pallas` written as torch
ops; the hand-written CUDA kernel (`csrc/mix_gain.cu`, wrapper
`ops/mix_cuda.py`) computes the same values bit for bit.
"""

from __future__ import annotations

import torch

BLOCK = 128                 # the placement quantum of the shift, in samples
INT16_SCALE = 1.0 / 32768.0


def check_mix_inputs(fg: torch.Tensor, bg: torch.Tensor, *per_clip) -> None:
    """Shapes and dtypes the mix contract takes; raises on anything else."""
    if fg.ndim != 2 or bg.shape != fg.shape:
        raise ValueError(f"fg and bg must both be [B, n], got "
                         f"{tuple(fg.shape)} and {tuple(bg.shape)}")
    if fg.shape[1] % BLOCK:
        raise ValueError(f"the mix needs n % {BLOCK} == 0, got n = "
                         f"{fg.shape[1]}")
    if fg.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"fg must be int16 or unit-scale float32, got "
                        f"{fg.dtype}")
    if bg.dtype != torch.float32:
        raise TypeError(f"bg must be float32, got {bg.dtype}")
    for t in per_clip:
        if t.shape != (fg.shape[0],):
            raise ValueError(f"per-clip values must be [B] = "
                             f"[{fg.shape[0]}], got {tuple(t.shape)}")
        if t.device != fg.device or bg.device != fg.device:
            raise ValueError("all mix inputs must be on one device")


def mix_gain_plain(fg: torch.Tensor, bg: torch.Tensor, q: torch.Tensor,
                   scale: torch.Tensor, has_bg: torch.Tensor,
                   gain: torch.Tensor) -> torch.Tensor:
    """[B, n] fg (int16 or unit f32) + [B, n] bg f32 -> [B, n] f32.

        out[b] = (has_bg[b] ? bg[b] + shift(fg_unit[b], 128 q[b]) * scale[b]
                            : shift(fg_unit[b], 128 q[b])) * gain[b]

    shift moves a row right with zero fill; int16 fg is scaled by 1/32768
    (exact). Each product and sum rounds once, in this order.
    """
    check_mix_inputs(fg, bg, q, scale, has_bg, gain)
    n = fg.shape[1]
    unit = fg.float() * INT16_SCALE if fg.dtype == torch.int16 else fg
    src = (torch.arange(n, device=fg.device)[None, :]
           - BLOCK * q.long()[:, None])
    inside = (src >= 0) & (src < n)
    shifted = torch.where(inside, unit.gather(1, src.clamp(0, n - 1)),
                          unit.new_zeros(()))
    mixed = torch.where(has_bg.bool()[:, None],
                        bg + shifted * scale.float()[:, None], shifted)
    return mixed * gain.float()[:, None]
