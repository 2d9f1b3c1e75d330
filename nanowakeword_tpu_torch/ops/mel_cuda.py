"""The fused log-mel on the card, and the dispatch between it and its plain
version.

`mel_frontend_cuda` launches the hand-written Hopper kernel
(`csrc/mel_frontend.cu`: the hop DFT on the FP64 tensor cores, in the plain
version's summation order, so int16 audio gives the plain version's output
bit for bit), the counterpart of the TPU kernel
`nanowakeword_tpu/ops/mel_pallas.py::mel_frontend_pallas`.
`mel_frontend_plain` is the same function in plain PyTorch (ops/mel.py in
bf16 mode). `mel_frontend_fused` picks by the device of its input: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel, and any other
device raises. A CUDA tensor never falls back to the plain version.

INFERENCE path only: the kernel has no backward.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from nanowakeword_tpu_torch.ops import _build
from nanowakeword_tpu_torch.ops import mel as melops
from nanowakeword_tpu_torch.utils import tracing
from nanowakeword_tpu_torch.utils.tracing import counters

_IN_DTYPES = {torch.int16: 0, torch.float32: 1, torch.bfloat16: 2}
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TAPS = 16   # filterbank taps per mel the kernel keeps (MAXTAP in the .cu)

# Kernel launches since import (or the last reset), the `mel.launches`
# counter of utils/tracing.py, read here as `launches`: a run shows with it
# that the main path went through the kernel. A call made while its stream
# is being captured into a CUDA graph runs no kernel: it is recorded, and
# counted in `mel.captured` (`captured`); utils/cuda_graph.replay counts
# the launches of each replay of that graph.
_COUNTERS = {"launches": "mel.launches", "captured": "mel.captured"}


def __getattr__(name: str):
    if name in _COUNTERS:
        return counters[_COUNTERS[name]]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    counters["mel.launches"] = 0


def mel_frontend_plain(x: torch.Tensor,
                       out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ops/mel.mel_frontend in bf16
    mode, cast to `out_dtype`."""
    return melops.mel_frontend(
        x, compute_dtype=torch.bfloat16).to(out_dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("mel_frontend")
    fn = lib.nww_mel_frontend
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, p, i, p, p, p, p, ll, ll, ll, p]
        fn.restype = ctypes.c_int
    return lib


INT16_EDGES = ("random", "32767", "-32768", "square", "silence", "impulse",
               "ragged")


def int16_edge_audio(rng, shape, kind: str):
    """int16 [B, n] audio on which the kernel must equal its plain version
    bit for bit: random, all 32767 (bf16 rounds it to 32768), all -32768, a
    full-scale +-32767 square wave, silence, one impulse, or random with a
    length that is not a multiple of 160 (n - 37). `rng` is a numpy
    Generator."""
    b, n = shape
    if kind == "random":
        return rng.integers(-32768, 32768, shape).astype(np.int16)
    if kind == "ragged":
        return rng.integers(-32768, 32768, (b, n - 37)).astype(np.int16)
    if kind == "square":
        wave = np.where((np.arange(n) // 80) % 2 == 0, 32767, -32767)
        return np.ascontiguousarray(np.broadcast_to(wave, shape), np.int16)
    if kind == "impulse":
        x = np.zeros(shape, np.int16)
        x[:, n // 3] = 32767
        return x
    fill = {"32767": 32767, "-32768": -32768, "silence": 0}[kind]
    return np.full(shape, fill, np.int16)


def filterbank_taps(fb: torch.Tensor) -> list[list[tuple[int, float]]]:
    """For each mel, its nonzero (bin, weight) filterbank taps in ascending
    bin order: the kernel's sparse filterbank sum."""
    return [[(int(k), float(fb[k, m])) for k in torch.nonzero(fb[:, m])[:, 0]]
            for m in range(fb.shape[1])]


@functools.lru_cache(maxsize=None)
def _kernel_constants(device: str):
    """(b0c, b0s, phase [4, 128], fb) float32 on `device`: the plain
    version's bf16-rounded constants, so both use identical values.

    The kernel holds the bases in shared memory as bf16 and keeps at most
    MAX_TAPS filterbank taps per mel; both are checked here, so a change to
    the constants cannot silently change the kernel's sums.
    """
    b0c, b0s, p_re, p_im, fb = melops.hopdft_tensors(torch.bfloat16, device)
    for name, t in (("b0c", b0c), ("b0s", b0s), ("fb", fb)):
        if not torch.equal(t.to(torch.bfloat16).float(), t):
            raise ValueError(f"the mel kernel needs bf16 values in {name}")
        if not ((t == 0) | (t.abs() >= torch.finfo(torch.float32).tiny)).all():
            raise ValueError(f"the mel kernel needs zeros or normal numbers in "
                             f"{name}")
    taps = max(len(t) for t in filterbank_taps(fb.cpu()))
    if taps > MAX_TAPS:
        raise ValueError(f"a mel has {taps} filterbank taps; the kernel "
                         f"keeps {MAX_TAPS}")
    phase = torch.stack([p_re[1], p_im[1], p_re[2], p_im[2]]).contiguous()
    return b0c.contiguous(), b0s.contiguous(), phase, fb.contiguous()


def mel_frontend_cuda(x: torch.Tensor, out_dtype=torch.float32,
                      span=None) -> torch.Tensor:
    """[B, n] or [n] int16/f32/bf16 audio on a CUDA device ->
    [B, ceil(n/160), 32] (or [ceil(n/160), 32]) log-mel, by the kernel.
    `span`: the name of a program span (utils/tracing.py) opened around
    the kernel's launch alone, so that its device time starts at the
    launch and not at the checks and the output's allocation before it,
    while the stream may stand idle."""
    if x.device.type != "cuda":
        raise ValueError(f"mel_frontend_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _IN_DTYPES:
        raise TypeError(f"mel_frontend_cuda takes int16, float32 or bfloat16 "
                        f"audio, got {x.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if x.ndim not in (1, 2):
        raise ValueError(f"audio must be [n] or [B, n], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("mel_frontend_cuda needs a contiguous tensor")
    squeeze = x.ndim == 1
    x2 = x[None] if squeeze else x
    batch, n = x2.shape
    n_frames = melops.n_mel_frames(n)
    out = torch.empty((batch, n_frames, melops.N_MELS), dtype=out_dtype,
                      device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        b0c, b0s, phase, fb = _kernel_constants(str(x.device))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with (tracing.span(span, device=x.device) if span
              else tracing.NO_SPAN):
            err = lib.nww_mel_frontend(
                x2.data_ptr(), _IN_DTYPES[x.dtype], out.data_ptr(),
                _OUT_DTYPES[out_dtype], b0c.data_ptr(), b0s.data_ptr(),
                phase.data_ptr(), fb.data_ptr(), batch, n, n_frames, stream)
    if err != 0:
        raise RuntimeError(f"mel_frontend kernel launch failed: CUDA error "
                           f"{err}")
    if torch.cuda.is_current_stream_capturing():
        counters["mel.captured"] += 1
    else:
        counters["mel.launches"] += 1
    return out[0] if squeeze else out


def mel_frontend_fused(x: torch.Tensor, *,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Whole-clip bf16-mode log-mel, by the device of `x`: the plain version
    for a CPU tensor, the kernel for a CUDA tensor; other devices raise."""
    if x.device.type == "cpu":
        return mel_frontend_plain(x, out_dtype)
    if x.device.type == "cuda":
        return mel_frontend_cuda(x, out_dtype)
    raise ValueError(f"mel_frontend_fused supports cpu and cuda tensors, "
                     f"got {x.device}")
