"""Log-mel frontend (hop-DFT formulation, N_FFT = 480) in PyTorch.

The counterpart of `nanowakeword_tpu/ops/mel.py`, with the same numeric
contract: 16 kHz int16-scale PCM in, 32 log-mel bins out per 160-sample hop,
``log10(mel + 1e-8) + 2``, and a 320-sample zero left context so that the
streaming step equals the batch path.

The transform:
* hop-granular DFT: with ``N_FFT == 480 == 3 * HOP`` the window DFT factors
  over hops, ``X(t, f) = sum_k e^{-i 2pi k f / 3} S(t + k, f)``, where
  ``S(r, f)`` is the DFT of hop row r against a ``[160, 128]`` basis. One
  cos and one sin product per row serve the three frames that overlap it.
* analytic Hann: the periodic Hann window is the 3-tap frequency filter
  ``0.5 X(f) - 0.25 X(f-1) - 0.25 X(f+1)`` with ``X(-1) = conj X(1)``.
* bin pruning: bins 0..127 are computed; the filterbank reads rows 2..114.

bf16 mode (``compute_dtype=torch.bfloat16``, the default) reproduces the
reference's rounding: the samples and the power are rounded to bf16 and
multiplied by bf16 bases, and the sums are kept at float32 or better. A torch
bf16 matmul would return bf16, so the operands are rounded with
``.to(torch.bfloat16).float()``.

The two matrix products (hop DFT and filterbank) sum in float64 and round
once to float32. Every product of two bf16 values is exact in float64. In
the hop DFT of int16-scale PCM the partial sums are exact as well (multiples
of 2^-29 below 2^24), except for the 1147 basis entries that are float
residues of cos/sin at multiples of pi/2 (|b| between 1.9e-23 and 1.3e-18).
Their products, ~4e-14 at most, are kept or rounded away depending on the
partial sums they meet, so the float64 sum depends on the order of the taps.
That order reaches float32 in two cases only: where the exact sum sits on a
float32 rounding midpoint (15-17% of the elements on int16 audio), since the
residue part then decides the rounding, and where |S| < 2^-11, since the
residues then reach the last bit; any other exact sum lies at least 2^-29
from a midpoint. So results agree bit for bit only between sums in the same
order: the CPU product and cuBLAS both chain the taps in ascending order, and
the CUDA kernel (ops/mel_cuda.py) does the same on the FP64 tensor cores
(nanowakeword_tpu_torch/tools/probe_hopdft_order.py). The filterbank sums
each mel in ascending bin order. With float32 sums the results would differ
much more often: the power is rounded to bf16, and a last-bit difference in
the power can flip that rounding and move a log-mel value by up to 3.4e-3.
Float64 products are not affected by the TF32 setting.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
HOP = 160                   # 10 ms
WINDOW = 480                # 30 ms = 3 hops
N_FFT = 480                 # == WINDOW: enables the hop-DFT factorization
N_BINS = 128                # computed spectral bins
N_MELS = 32
FMIN = 60.0
FMAX = 3800.0
CHUNK = 1280                # 80 ms streaming chunk
FRAMES_PER_CHUNK = CHUNK // HOP  # 8
LEFT_PAD = WINDOW - HOP     # 320 zero samples of left context
INT16_SCALE = 1.0 / 32768.0  # inputs arrive in int16 amplitude convention
MEL_EPS = 1e-8              # floor inside log10; silence sits at -6
LOG_OFFSET = 2.0            # the `spec/10 + 2` offset
PAD_VALUE = -6.0            # transformed-scale value of the -80 dB pad


def _hann(n: int) -> np.ndarray:
    """Periodic Hann window."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


@functools.lru_cache(maxsize=None)
def _mel_filterbank() -> np.ndarray:
    """[N_BINS, N_MELS] triangular filterbank (HTK mel) on the N_FFT grid."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(FMIN), hz_to_mel(FMAX), N_MELS + 2)
    hz_pts = mel_to_hz(mel_pts)
    bin_freqs = np.arange(N_BINS) * SAMPLE_RATE / N_FFT
    fb = np.zeros((N_BINS, N_MELS))
    for m in range(N_MELS):
        lo, mid, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_freqs - lo) / max(mid - lo, 1e-9)
        down = (hi - bin_freqs) / max(hi - mid, 1e-9)
        fb[:, m] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


@functools.lru_cache(maxsize=None)
def _hopdft_constants():
    """(b0_cos, b0_sin, phase_re, phase_im, mel_fb) float64 numpy constants.

    b0_cos/b0_sin: [HOP, N_BINS] hop-length real-DFT basis with the int16
                   normalisation folded in (the window is the analytic 3-tap
                   applied after the phase combine).
    phase_re/im:   [3, N_BINS] the e^{-i 2pi k f / 3} frame-combine factors.
    mel_fb:        [N_BINS, N_MELS] filterbank.
    """
    tau = np.arange(HOP)[:, None]
    f = np.arange(N_BINS)[None, :]
    ang = 2.0 * np.pi * tau * f / N_FFT
    b0c = np.cos(ang) * INT16_SCALE
    b0s = -np.sin(ang) * INT16_SCALE

    k = np.arange(3)[:, None]
    pang = 2.0 * np.pi * k * np.arange(N_BINS)[None, :] / 3.0
    return b0c, b0s, np.cos(pang), -np.sin(pang), _mel_filterbank()


def _round(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """float32 tensor holding x rounded to `compute_dtype`."""
    return x.to(compute_dtype).float()


@functools.lru_cache(maxsize=None)
def hopdft_tensors(compute_dtype: torch.dtype, device: str):
    """The constants as float32 tensors on `device`.

    The bases and the filterbank are rounded once from float64 to
    `compute_dtype` (bit-identical to the reference's bf16 constants); the
    phase factors are always float32, as in the reference.
    """
    b0c, b0s, p_re, p_im, fb = _hopdft_constants()

    def rounded(a):
        return _round(torch.from_numpy(a), compute_dtype).to(device)

    def f32(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    return rounded(b0c), rounded(b0s), f32(p_re), f32(p_im), rounded(fb)


def hann_taps(f_re: torch.Tensor, f_im: torch.Tensor):
    """Periodic-Hann 3-tap frequency convolution along the last (bin) axis:
    Xw(f) = 0.5 X(f) - 0.25 X(f-1) - 0.25 X(f+1).

    Edge semantics: X(-1) = conj(X(1)) (real input); X(N_BINS) is not
    computed, so the top bin's +1 tap repeats the top bin. Bins 115 and
    above have zero filterbank weight, so the result is unaffected.
    """
    m1_re = torch.cat([f_re[..., 1:2], f_re[..., :-1]], dim=-1)
    m1_im = torch.cat([-f_im[..., 1:2], f_im[..., :-1]], dim=-1)
    p1_re = torch.cat([f_re[..., 1:], f_re[..., -1:]], dim=-1)
    p1_im = torch.cat([f_im[..., 1:], f_im[..., -1:]], dim=-1)
    w_re = 0.5 * f_re - 0.25 * (m1_re + p1_re)
    w_im = 0.5 * f_im - 0.25 * (m1_im + p1_im)
    return w_re, w_im


def _exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 a @ b, summed in float64 and rounded once to float32."""
    return torch.matmul(a.double(), b.double()).float()


def _log_mel_from_rows(rows: torch.Tensor, t: int, *,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """[..., t+2, HOP] hop rows -> [..., t, N_MELS] transformed log-mel.

    The shared core of the batch and streaming paths: per-row hop DFT,
    phase combine over the 3 overlapping rows per frame, analytic Hann,
    power, filterbank, log compression. The CUDA kernel repeats the
    elementwise steps in this order, one rounding per operation.
    """
    b0c, b0s, p_re, p_im, fb = hopdft_tensors(compute_dtype, str(rows.device))
    r = _round(rows, compute_dtype)
    s_re = _exact_matmul(r, b0c)
    s_im = _exact_matmul(r, b0s)

    f_re = s_re[..., 0:t, :]
    f_im = s_im[..., 0:t, :]
    for k in (1, 2):
        pr, pi = p_re[k], p_im[k]
        f_re = f_re + pr * s_re[..., k:t + k, :] - pi * s_im[..., k:t + k, :]
        f_im = f_im + pr * s_im[..., k:t + k, :] + pi * s_re[..., k:t + k, :]

    w_re, w_im = hann_taps(f_re, f_im)
    power = w_re * w_re + w_im * w_im
    mel = _exact_matmul(_round(power, compute_dtype), fb)
    return torch.log10(torch.clamp(mel, min=0.0) + MEL_EPS) + LOG_OFFSET


def mel_frontend(x: torch.Tensor, *,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Whole-clip log-mel. [..., n] int16-scale audio -> [..., ceil(n/HOP), 32].

    The clip is left-padded with LEFT_PAD zeros (the stream's left context)
    and a ragged length is right-padded to a multiple of HOP.
    """
    x = x.float()
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    n = x.shape[-1]
    right = -n % HOP
    t = (n + right) // HOP
    rows = torch.nn.functional.pad(x, (LEFT_PAD, right))
    rows = rows.reshape(x.shape[:-1] + (t + 2, HOP))
    out = _log_mel_from_rows(rows, t, compute_dtype=compute_dtype)
    return out[0] if squeeze else out


def mel_streaming_step(tail: torch.Tensor, chunk: torch.Tensor,
                       *, compute_dtype=torch.bfloat16):
    """One streaming step: 1280 new samples -> 8 new mel frames.

    Args:
        tail:  [..., LEFT_PAD] the last 320 samples seen before `chunk`
               (zeros at stream start).
        chunk: [..., CHUNK] new audio samples (int16 scale).

    Returns:
        (new_tail [..., LEFT_PAD], frames [..., FRAMES_PER_CHUNK, N_MELS])

    Concatenating the frames of successive steps equals `mel_frontend` of
    the concatenated audio: both run the same per-row arithmetic.
    """
    buf = torch.cat([tail.float(), chunk.float()], dim=-1)   # [..., 1600]
    rows = buf.reshape(buf.shape[:-1] + (FRAMES_PER_CHUNK + 2, HOP))
    out = _log_mel_from_rows(rows, FRAMES_PER_CHUNK,
                             compute_dtype=compute_dtype)
    return buf[..., -LEFT_PAD:], out


def mel_frontend_reference(x: np.ndarray) -> np.ndarray:
    """Direct windowed N_FFT-point DFT mel in float64 numpy: the oracle the
    hop-DFT factorization is held against."""
    x = np.asarray(x, np.float64) * INT16_SCALE
    if x.ndim == 1:
        x = x[None]
    b, n = x.shape
    t = n // HOP
    xp = np.pad(x, ((0, 0), (LEFT_PAD, 0)))
    win = _hann(N_FFT)
    tau = np.arange(N_FFT)[:, None]
    f = np.arange(N_BINS)[None, :]
    basis = np.exp(-2j * np.pi * tau * f / N_FFT) * win[:, None]
    frames = np.stack([xp[:, i * HOP:i * HOP + N_FFT] for i in range(t)],
                      axis=1)                           # [B, T, 480]
    spec = frames @ basis
    power = np.abs(spec) ** 2
    mel = power @ _mel_filterbank()
    return np.log10(np.maximum(mel, 0.0) + MEL_EPS) + LOG_OFFSET


def n_mel_frames(n_samples: int) -> int:
    """Number of mel frames produced for an n_samples clip."""
    return (n_samples + HOP - 1) // HOP
