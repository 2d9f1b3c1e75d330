"""The plain log-mel, frozen: 16 kHz int16-scale audio -> 32 log-mel bins per
160-sample hop, `log10(mel + 1e-8) + 2`, with 320 zero samples of left
context.

A copy of the program's plain version in its bf16 mode (the mode that the
program's feature frontend runs): a hop-granular DFT (N_FFT = 480 = 3 hops)
against a [160, 128] basis, the three overlapping hop rows combined per
frame, the periodic Hann window as a 3-tap filter in frequency, the power,
a 32-mel HTK filterbank and the log. The samples, the bases, the power and
the filterbank are rounded to bfloat16; both matrix products sum in float64
and round once to float32. On int16 audio this is exact up to the float64
summation order of the taps, which is ascending here, so it agrees with
any implementation that sums in that order bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
HOP = 160
N_FFT = 480
N_BINS = 128
N_MELS = 32
FMIN, FMAX = 60.0, 3800.0
CHUNK = 1280
LEFT_PAD = N_FFT - HOP
INT16_SCALE = 1.0 / 32768.0
MEL_EPS = 1e-8
LOG_OFFSET = 2.0


@functools.lru_cache(maxsize=None)
def _constants():
    """(basis cos, basis sin, phase re, phase im, filterbank) float64."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    hz = mel_to_hz(np.linspace(hz_to_mel(FMIN), hz_to_mel(FMAX), N_MELS + 2))
    bins = np.arange(N_BINS) * SAMPLE_RATE / N_FFT
    fb = np.zeros((N_BINS, N_MELS))
    for m in range(N_MELS):
        lo, mid, hi = hz[m], hz[m + 1], hz[m + 2]
        up = (bins - lo) / max(mid - lo, 1e-9)
        down = (hi - bins) / max(hi - mid, 1e-9)
        fb[:, m] = np.clip(np.minimum(up, down), 0.0, None)
    ang = 2.0 * np.pi * np.arange(HOP)[:, None] * np.arange(N_BINS)[None] \
        / N_FFT
    pang = 2.0 * np.pi * np.arange(3)[:, None] * np.arange(N_BINS)[None] / 3.0
    return (np.cos(ang) * INT16_SCALE, -np.sin(ang) * INT16_SCALE,
            np.cos(pang), -np.sin(pang), fb)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


@functools.lru_cache(maxsize=None)
def _tensors(device: str):
    b0c, b0s, p_re, p_im, fb = _constants()
    return (_bf16(torch.from_numpy(b0c)).to(device),
            _bf16(torch.from_numpy(b0s)).to(device),
            torch.from_numpy(p_re.astype(np.float32)).to(device),
            torch.from_numpy(p_im.astype(np.float32)).to(device),
            _bf16(torch.from_numpy(fb)).to(device))


def _exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.double(), b.double()).float()


def log_mel(x: torch.Tensor) -> torch.Tensor:
    """[B, n] int16-scale audio (any float or int dtype) -> [B, ceil(n/160),
    32] float32 log-mel."""
    x = x.float()
    n = x.shape[-1]
    right = -n % HOP
    t = (n + right) // HOP
    rows = torch.nn.functional.pad(x, (LEFT_PAD, right))
    rows = rows.reshape(x.shape[0], t + 2, HOP)
    b0c, b0s, p_re, p_im, fb = _tensors(str(rows.device))
    r = _bf16(rows)
    s_re = _exact_matmul(r, b0c)
    s_im = _exact_matmul(r, b0s)
    f_re, f_im = s_re[:, 0:t], s_im[:, 0:t]
    for k in (1, 2):
        f_re = f_re + p_re[k] * s_re[:, k:t + k] - p_im[k] * s_im[:, k:t + k]
        f_im = f_im + p_re[k] * s_im[:, k:t + k] + p_im[k] * s_re[:, k:t + k]
    # Hann as 0.5 X(f) - 0.25 X(f-1) - 0.25 X(f+1), X(-1) = conj X(1), the
    # top bin's +1 tap repeating the top bin
    m1_re = torch.cat([f_re[..., 1:2], f_re[..., :-1]], dim=-1)
    m1_im = torch.cat([-f_im[..., 1:2], f_im[..., :-1]], dim=-1)
    p1_re = torch.cat([f_re[..., 1:], f_re[..., -1:]], dim=-1)
    p1_im = torch.cat([f_im[..., 1:], f_im[..., -1:]], dim=-1)
    w_re = 0.5 * f_re - 0.25 * (m1_re + p1_re)
    w_im = 0.5 * f_im - 0.25 * (m1_im + p1_im)
    power = w_re * w_re + w_im * w_im
    mel = _exact_matmul(_bf16(power), fb)
    return torch.log10(torch.clamp(mel, min=0.0) + MEL_EPS) + LOG_OFFSET
