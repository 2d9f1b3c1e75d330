"""Augmentation on one torch device: SNR mixing, gain, pitch/speed, RIR,
EQ, band-limit, volume and companding, then int16; and SpecAugment.

The counterpart of `nanowakeword_tpu/ops/augment.py`. Every stage is split
into **draws** (`draw_augment`, `draw_spec_masks`: per-clip random numbers
from an explicit `torch.Generator`) and **application** (`augment_batch`,
`spec_augment`, and the stage functions: pure functions of the audio and
the draws). torch cannot reproduce JAX's threefry bits, so the tests hand
the JAX package's draws to the port's application and compare the audio,
and check the port's draws by their distributions.

The pre-stage (placement, SNR mix, gain) goes through `mix_gain_fused`
(ops/mix_cuda.py): the hand-written kernel for a CUDA batch, its plain
version on the CPU. The RMS, SNR scale and gain are computed outside it.
Placement offsets are quantized to 128 samples (the kernel's contract);
with quantization off, or a length that is not a multiple of 128, the
sample-exact `mix_snr` runs instead.

Scalar conversions `10^(dB/20)` and `2^(st/12)` are computed in float64
from the float32 quotient and rounded once to float32 (correctly rounded;
XLA's float32 pow differs from that in about 1 case in 2000, by 1 ulp).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from nanowakeword_tpu_torch.ops.mix_cuda import mix_gain_fused

EPS = 1.19209e-07          # float32 eps
MIN_BG_RMS = 0.005
MIN_FG_RMS = 0.01          # -40 dBFS floor of the scaled foreground
INT16_MAX = 32767.0

DEFAULT_SETTINGS = {
    "rir_prob": 0.5, "gain_prob": 1.0, "pitch_prob": 0.5,
    "min_pitch_semitones": -2.0, "max_pitch_semitones": 2.0,
    "max_snr_in_db": 30.0, "min_snr_in_db": 5.0,
    "min_gain_in_db": -3.0, "max_gain_in_db": 3.0,
    "min_volume_augmentation": 0.5, "max_volume_augmentation": 1.0,
    "eq_prob": 0.0,
    "companding_prob": 0.0,
    "bandlimit_prob": 0.0,
}

PITCH_SPAN_BLK = 16        # span-start alignment of the continuous pitch path
PITCH_RATE_DEN = 64        # rate quantum 1/64 of the rational pitch path
PITCH_FRAME = 40


class AugmentParams(NamedTuple):
    rir_prob: float
    gain_prob: float
    pitch_prob: float
    min_pitch: float
    max_pitch: float
    min_snr: float
    max_snr: float
    min_gain: float
    max_gain: float
    min_volume: float
    max_volume: float
    eq_prob: float = 0.0
    companding_prob: float = 0.0
    bandlimit_prob: float = 0.0
    # rate-quantized pitch: grid points (0 = continuous per-clip draws)
    pitch_grid: int = 16
    # placement quantum in samples (a multiple of 128 engages the kernel)
    offset_quantum: int = 128
    # rational rates p/64 with a static interleaved slot -> rate map
    pitch_rational: bool = True

    @classmethod
    def from_settings(cls, settings=None) -> "AugmentParams":
        cfg = dict(DEFAULT_SETTINGS)
        if settings:
            cfg.update({k: v for k, v in settings.items() if v is not None})
        return cls(
            rir_prob=float(cfg["rir_prob"]),
            gain_prob=float(cfg["gain_prob"]),
            pitch_prob=float(cfg["pitch_prob"]),
            min_pitch=float(cfg["min_pitch_semitones"]),
            max_pitch=float(cfg["max_pitch_semitones"]),
            min_snr=float(cfg["min_snr_in_db"]),
            max_snr=float(cfg["max_snr_in_db"]),
            min_gain=float(cfg["min_gain_in_db"]),
            max_gain=float(cfg["max_gain_in_db"]),
            min_volume=float(cfg["min_volume_augmentation"]),
            max_volume=float(cfg["max_volume_augmentation"]),
            eq_prob=float(cfg["eq_prob"]),
            companding_prob=float(cfg["companding_prob"]),
            bandlimit_prob=float(cfg["bandlimit_prob"]),
            pitch_grid=int(cfg.get("pitch_grid_rates",
                                   cls._field_defaults["pitch_grid"])),
            offset_quantum=int(cfg.get(
                "offset_quantum", cls._field_defaults["offset_quantum"])),
            pitch_rational=bool(cfg.get(
                "pitch_rational", cls._field_defaults["pitch_rational"])),
        )


class AugmentDraws(NamedTuple):
    """Per-clip random numbers of one batch (B clips; R = params.pitch_grid).

    Gates are booleans already compared with their probability; `rir_gate`
    is not yet combined with `has_rir`.
    """
    offset: torch.Tensor          # [B] int64, quantized placement offsets
    snr_db: torch.Tensor          # [B] float32
    gain_db: torch.Tensor         # [B] float32
    gain_gate: torch.Tensor       # [B] bool
    pitch_gate: torch.Tensor      # [B] bool
    semitones: torch.Tensor       # [B] float32 (continuous pitch path)
    pitch_perm: torch.Tensor      # [R] int64 (grouped pitch path)
    rir_gate: torch.Tensor        # [B] bool
    volume: torch.Tensor          # [B] float32, peak target
    eq_coeffs: torch.Tensor       # [B, 2] float32
    eq_gate: torch.Tensor         # [B] bool
    bandlimit_fc: torch.Tensor    # [B] float32, Hz
    bandlimit_gate: torch.Tensor  # [B] bool
    companding_gate: torch.Tensor  # [B] bool

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(*(t.to(device) for t in self))


def _offset_aligned(n: int, params: AugmentParams) -> bool:
    """Placement quantized to a 128-sample grid, so the pre-stage is the
    mix kernel's block shift."""
    return (params.offset_quantum > 1 and n % 128 == 0
            and params.offset_quantum % 128 == 0)


def draw_augment(fg_lens, n: int, params: AugmentParams,
                 generator: Optional[torch.Generator] = None,
                 device="cpu") -> AugmentDraws:
    """The random numbers of one batch, from `generator` (on the CPU; the
    draws are then moved to `device`)."""
    fg_lens = torch.as_tensor(np.asarray(fg_lens), dtype=torch.int64)
    b = fg_lens.shape[0]
    g = generator

    def uniform(lo, hi, shape=(b,)):
        u = torch.rand(shape, generator=g, dtype=torch.float32)
        return lo + u * (hi - lo)

    def gate(prob):
        return torch.rand(b, generator=g) < prob

    high = torch.clamp(n - fg_lens, min=0).clamp(min=1)
    offset = (torch.rand(b, generator=g, dtype=torch.float64)
              * high).floor().long()
    if _offset_aligned(n, params):
        offset = offset // params.offset_quantum * params.offset_quantum
    eq_lo = torch.tensor([-0.8, -0.4])
    draws = AugmentDraws(
        offset=offset,
        snr_db=uniform(params.min_snr, params.max_snr),
        gain_db=uniform(params.min_gain, params.max_gain),
        gain_gate=gate(params.gain_prob),
        pitch_gate=gate(params.pitch_prob),
        semitones=uniform(params.min_pitch, params.max_pitch),
        pitch_perm=torch.randperm(max(params.pitch_grid, 1), generator=g),
        rir_gate=gate(params.rir_prob),
        volume=uniform(params.min_volume, params.max_volume),
        eq_coeffs=uniform(eq_lo, -eq_lo, (b, 2)),
        eq_gate=gate(params.eq_prob),
        bandlimit_fc=uniform(2000.0, 7000.0),
        bandlimit_gate=gate(params.bandlimit_prob),
        companding_gate=gate(params.companding_prob),
    )
    return draws.to(device)


# -- scalar helpers ---------------------------------------------------------------

def _rms(x: torch.Tensor) -> torch.Tensor:
    """Per-row RMS of [B, n] -> [B], with the float32-eps floor inside."""
    return torch.sqrt((x * x).mean(dim=-1) + EPS)


def _pow_rounded(base: float, exponent: torch.Tensor) -> torch.Tensor:
    """base ** exponent for a float32 exponent, correctly rounded to f32."""
    return torch.pow(base, exponent.double()).float()


def db_to_gain(db: torch.Tensor) -> torch.Tensor:
    return _pow_rounded(10.0, db.float() / 20.0)


def semitone_rate(semitones: torch.Tensor) -> torch.Tensor:
    return _pow_rounded(2.0, semitones.float() / 12.0)


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    """int16 -> [-1, 1) by 1/32768; float input is taken as int16-scale
    when its peak is above 2 (a runtime test over the whole batch)."""
    if not torch.is_floating_point(x):
        return x.float() * (1.0 / 32768.0)
    x = x.float()
    return x * torch.where(x.abs().max() > 2.0, 1.0 / 32768.0, 1.0)


def _snr_scale(fg_unit, bg, snr_db):
    """Per-clip foreground scale for the target SNR, with the RMS floors."""
    fg_rms = _rms(fg_unit)
    bg_rms = torch.clamp(_rms(bg), min=MIN_BG_RMS)
    scale = db_to_gain(snr_db) * bg_rms / fg_rms
    scaled_rms = scale * fg_rms
    return torch.where(scaled_rms < MIN_FG_RMS,
                       scale * (MIN_FG_RMS / torch.clamp(scaled_rms, min=EPS)),
                       scale)


# -- pre-stage: placement, SNR mix, gain ------------------------------------------

def _shift_right(x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Zero-filled right shift of each row of [B, n] by offset[b] samples."""
    n = x.shape[-1]
    src = torch.arange(n, device=x.device)[None, :] - offset.long()[:, None]
    inside = (src >= 0) & (src < n)
    return torch.where(inside, x.gather(1, src.clamp(0, n - 1)),
                       x.new_zeros(()))


def mix_snr(fg: torch.Tensor, bg: torch.Tensor, offset: torch.Tensor,
            snr_db: torch.Tensor, has_bg: torch.Tensor) -> torch.Tensor:
    """Place unit-scale fg [B, n] into bg at a sample-exact `offset` with
    the SNR `snr_db`; clips without background get fg at offset 0,
    unscaled."""
    scale = _snr_scale(fg, bg, snr_db)
    has_bg = has_bg.bool()
    shifted = _shift_right(fg, torch.where(has_bg, offset.long(), 0))
    return torch.where(has_bg[:, None], bg + shifted * scale[:, None],
                       shifted)


def augment_pre(fg_raw: torch.Tensor, fg_unit: torch.Tensor,
                bg: torch.Tensor, has_bg: torch.Tensor, draws: AugmentDraws,
                params: AugmentParams) -> torch.Tensor:
    """Mix + gain for a batch. With 128-aligned placement, through the mix
    kernel on `fg_raw` (int16 read directly, or unit f32)."""
    n = fg_unit.shape[-1]
    has_bg = has_bg.bool()
    if not _offset_aligned(n, params):
        mixed = mix_snr(fg_unit, bg, draws.offset, draws.snr_db, has_bg)
        return torch.where(draws.gain_gate[:, None],
                           mixed * db_to_gain(draws.gain_db)[:, None], mixed)
    scale = _snr_scale(fg_unit, bg, draws.snr_db)
    offsets = torch.where(has_bg, draws.offset.long(), 0)
    gain = torch.where(draws.gain_gate, db_to_gain(draws.gain_db),
                       torch.ones((), device=bg.device))
    kfg = fg_raw if fg_raw.dtype == torch.int16 else fg_unit
    return mix_gain_fused(kfg.contiguous(), bg.contiguous(), offsets // 128,
                          scale, has_bg, gain)


# -- pitch ------------------------------------------------------------------------

def pitch_window(max_abs_semitones: float, frame: int = PITCH_FRAME,
                 blk: int = PITCH_SPAN_BLK) -> int:
    """Source-span width for rates up to 2^(st/12), blk-aligned."""
    span = (int(np.ceil(frame * 2.0 ** (abs(max_abs_semitones) / 12.0)))
            + 2 + (blk - 1))
    return ((span + blk - 1) // blk) * blk


def _resample_framed(x: torch.Tensor, rate: torch.Tensor, frame: int,
                     window: int) -> torch.Tensor:
    """Linear-interpolation resampling of each row of [B, n] at its rate
    [B], in frames of `frame` outputs read from blk-aligned spans of
    `window` bf16-rounded samples, with bf16 hat weights: the arithmetic
    of the reference's span-select formulation. Only the two non-zero taps
    of each hat are formed, so each output is one f32 rounding of two
    exact products, as there."""
    b, n = x.shape
    blk = PITCH_SPAN_BLK
    n_windows = n // blk - window // blk + 1
    n_frames = n // frame
    rate = rate.float()[:, None]
    frames = torch.arange(n_frames, dtype=torch.float32, device=x.device)
    f_start = frames[None, :] * frame * rate                     # [B, F]
    start = torch.clamp(torch.div(f_start, blk, rounding_mode="floor")
                        .to(torch.int64), 0, n_windows - 1) * blk
    j = torch.arange(frame, dtype=torch.float32, device=x.device)
    pos = ((frames[:, None] * frame + j)[None] * rate[:, :, None])
    rel = pos - start[:, :, None].float()                        # [B, F, fr]
    relc = torch.clamp(rel, 0.0, float(window - 1))
    lo = torch.floor(relc)
    w_lo = (1.0 - (relc - lo)).to(torch.bfloat16).float()
    w_hi = torch.clamp(1.0 - (lo + 1.0 - relc), min=0.0).to(
        torch.bfloat16).float()
    idx = (start[:, :, None] + lo.long()).reshape(b, n)
    xb = x.to(torch.bfloat16).float()
    x_lo = xb.gather(1, idx)
    x_hi = xb.gather(1, torch.clamp(idx + 1, max=n - 1))
    out = x_lo * w_lo.reshape(b, n) + x_hi * w_hi.reshape(b, n)
    return torch.where(pos.reshape(b, n) <= n - 1, out, 0.0)


def _framed_ok(n: int, frame: int, window: int) -> bool:
    blk = PITCH_SPAN_BLK
    return (n % (frame * blk // math.gcd(frame, blk)) == 0
            and n // blk - window // blk + 1 >= 1)


def resample_pitch(x: torch.Tensor, semitones: torch.Tensor,
                   apply: torch.Tensor, frame: int = PITCH_FRAME,
                   window: int = 128) -> torch.Tensor:
    """Per-clip pitch/speed shift by linear-interpolation resampling at
    rate 2^(semitones/12); reads past the end are 0. [B, n] -> [B, n]."""
    n = x.shape[-1]
    rate = semitone_rate(semitones)
    if _framed_ok(n, frame, window):
        out = _resample_framed(x, rate, frame, window)
    else:
        # direct formulation for odd lengths and short inputs
        pos = torch.arange(n, device=x.device)[None, :] * rate[:, None]
        lo = torch.clamp(torch.floor(pos).long(), 0, n - 1)
        frac = pos - lo
        out = (x.gather(1, lo) * (1.0 - frac)
               + x.gather(1, torch.clamp(lo + 1, 0, n - 1)) * frac)
        out = torch.where(pos <= n - 1, out, 0.0)
    return torch.where(apply.bool()[:, None], out, x)


def pitch_grid(min_st: float, max_st: float, n_rates: int) -> tuple:
    """n_rates uniform semitone points over [min_st, max_st]."""
    return tuple(float(s) for s in np.linspace(min_st, max_st, n_rates))


def resample_pitch_grouped(x: torch.Tensor, grid: tuple, perm: torch.Tensor,
                           apply: torch.Tensor, frame: int = PITCH_FRAME,
                           window: int = 128) -> torch.Tensor:
    """Rate-quantized pitch: clip b gets the grid rate perm[b // (B/R)].
    Caller guarantees B % R == 0 and the framed shape conditions."""
    b = x.shape[0]
    rates = semitone_rate(torch.tensor(grid, dtype=torch.float32,
                                       device=x.device))[perm.to(x.device)]
    per_clip = rates.repeat_interleave(b // len(grid))
    out = _resample_framed(x, per_clip, frame, window)
    return torch.where(apply.bool()[:, None], out, x)


def pitch_pgrid(min_st: float, max_st: float, n_rates: int,
                q: int = PITCH_RATE_DEN) -> tuple:
    """Integer numerators p of the rational rates p/q nearest 2^(st/12)."""
    sts = np.linspace(min_st, max_st, n_rates)
    return tuple(int(round(2.0 ** (s / 12.0) * q)) for s in sts)


def _hat_weights(p: int, q: int, device) -> torch.Tensor:
    """[p+1, q] bf16-rounded hat weights: column j interpolates position
    j*p/q of a span of p+1 samples."""
    m = torch.arange(p + 1, dtype=torch.float32, device=device)[:, None]
    jpos = (torch.arange(q, dtype=torch.float32, device=device) * p / q)
    return torch.clamp(1.0 - (jpos[None, :] - m).abs(), min=0.0).to(
        torch.bfloat16).float()


def resample_pitch_rational(x: torch.Tensor, p_grid: tuple,
                            apply: torch.Tensor,
                            q: int = PITCH_RATE_DEN) -> torch.Tensor:
    """Rational-rate pitch with the static interleaved map: clip b is
    resampled at p_grid[b % R] / q. Output row t of out.reshape(n/q, q)
    reads exactly x[t p : t p + p + 1], so each rate is a reshape and a
    [p+1, q] matmul of bf16-rounded operands accumulated in f32.
    Caller guarantees B % R == 0 and n % q == 0."""
    b, n = x.shape
    r_count = len(p_grid)
    g = b // r_count
    nq = n // q
    xg = x.view(g, r_count, n)
    xb = x.to(torch.bfloat16).float().view(g, r_count, n)
    out = torch.empty_like(xg)
    idx = torch.arange(n, device=x.device)
    for r, p in enumerate(int(v) for v in p_grid):
        xr = xb[:, r]
        pad = nq * p + 1 - n
        xp = torch.nn.functional.pad(xr, (0, pad)) if pad > 0 else xr
        rows = xp[:, :nq * p].reshape(g, nq, p)
        tail = xp[:, p:nq * p + 1:p]                  # x[(t+1) p]
        spans = torch.cat([rows, tail[:, :, None]], dim=2)
        res = (spans @ _hat_weights(p, q, x.device)).reshape(g, n)
        valid = idx * p <= (n - 1) * q
        out[:, r] = torch.where(valid[None, :], res, 0.0)
    out = out.reshape(b, n)
    return torch.where(apply.bool()[:, None], out, x)


# -- post-stage ---------------------------------------------------------------------

def _fft_len(target: int) -> int:
    return 1 << (int(target) - 1).bit_length()


def rir_convolve(x: torch.Tensor, rir: torch.Tensor,
                 apply: torch.Tensor) -> torch.Tensor:
    """Room-impulse-response FFT convolution of each row, truncated to its
    length; the impulse is peak-normalised and the wet signal RMS-matched
    to the dry one."""
    n = x.shape[-1]
    r = rir / torch.clamp(rir.abs().amax(dim=-1, keepdim=True), min=EPS)
    fft_len = _fft_len(n + rir.shape[-1] - 1)
    spec = torch.fft.rfft(x, fft_len) * torch.fft.rfft(r, fft_len)
    wet = torch.fft.irfft(spec, fft_len)[:, :n]
    wet = wet * (_rms(x) / _rms(wet))[:, None]
    return torch.where(apply.bool()[:, None], wet, x)


def _delay(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.nn.functional.pad(x[:, :-k], (k, 0))


def augment_post(mixed: torch.Tensor, rir: torch.Tensor,
                 has_rir: torch.Tensor, draws: AugmentDraws,
                 params: AugmentParams) -> torch.Tensor:
    """RIR, EQ, band-limit, peak-normalised volume, clip to [-1, 1], and
    mu-law companding. Stages with probability 0 do not run at all."""
    if params.rir_prob > 0:
        mixed = rir_convolve(mixed, rir,
                             draws.rir_gate & has_rir.bool())
    if params.eq_prob > 0:
        a1 = draws.eq_coeffs[:, 0:1]
        a2 = draws.eq_coeffs[:, 1:2]
        eq = mixed + a1 * _delay(mixed, 1) + a2 * _delay(mixed, 2)
        eq = eq / torch.sqrt(1.0 + a1 ** 2 + a2 ** 2)
        mixed = torch.where(draws.eq_gate[:, None], eq, mixed)
    if params.bandlimit_prob > 0:
        half = 7
        t = torch.arange(-half, half + 1, dtype=torch.float32,
                         device=mixed.device)
        window = torch.from_numpy(
            np.hamming(2 * half + 1).astype(np.float32)).to(mixed.device)
        h = (torch.sinc(2.0 * draws.bandlimit_fc[:, None] / 16000.0 * t)
             * window)
        h = h / h.sum(dim=-1, keepdim=True)           # unity DC gain
        b = mixed.shape[0]
        low = torch.nn.functional.conv1d(
            mixed[None], h.flip(-1)[:, None], padding=half, groups=b)[0]
        mixed = torch.where(draws.bandlimit_gate[:, None], low, mixed)
    peak = mixed.abs().amax(dim=-1)
    peak = torch.where(peak < 1e-8, 1.0, peak)
    out = torch.clamp(mixed * (draws.volume / peak)[:, None], -1.0, 1.0)
    if params.companding_prob > 0:
        mu = 255.0
        comp = torch.sign(out) * torch.log1p(mu * out.abs()) / math.log1p(mu)
        comp = torch.round(comp * 127.0) / 127.0
        dec = torch.sign(comp) * ((1.0 + mu) ** comp.abs() - 1.0) / mu
        out = torch.where(draws.companding_gate[:, None], dec, out)
    return out


# -- the chain ------------------------------------------------------------------------

def _pitch_route(b: int, n: int, params: AugmentParams) -> str:
    """Which pitch path the batch shape takes: "rational", "grouped",
    "continuous" or "off"."""
    if params.pitch_prob <= 0:
        return "off"
    if params.pitch_grid > 1:
        window = pitch_window(max(abs(params.min_pitch),
                                  abs(params.max_pitch)))
        if (params.pitch_rational and b % params.pitch_grid == 0
                and n % PITCH_RATE_DEN == 0):
            return "rational"
        if b % params.pitch_grid == 0 and _framed_ok(n, PITCH_FRAME, window):
            return "grouped"
    return "continuous"


@torch.no_grad()
def augment_batch(fg: torch.Tensor, bg: torch.Tensor, rir: torch.Tensor,
                  fg_lens, has_bg: torch.Tensor, has_rir: torch.Tensor,
                  params: AugmentParams, *,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[AugmentDraws] = None) -> torch.Tensor:
    """Batched augmentation on the device of `fg`.

    fg: [B, n] foreground (int16, or float at int16 or unit scale); bg:
    [B, n] background (zeros where none); rir: [B, R] impulses; fg_lens:
    [B] true foreground lengths; has_bg, has_rir: [B] bool. `draws` (from
    `draw_augment`) are made from `generator` when not given.
    Returns [B, n] int16 audio.
    """
    b, n = fg.shape
    device = fg.device
    if draws is None:
        draws = draw_augment(fg_lens, n, params, generator, device)
    fg_unit = _to_unit(fg)
    bg = _to_unit(bg)
    rir = rir.float()
    has_bg = has_bg.to(device)
    has_rir = has_rir.to(device)

    mixed = augment_pre(fg, fg_unit, bg, has_bg, draws, params)
    route = _pitch_route(b, n, params)
    window = pitch_window(max(abs(params.min_pitch), abs(params.max_pitch)))
    if route == "rational":
        mixed = resample_pitch_rational(
            mixed, pitch_pgrid(params.min_pitch, params.max_pitch,
                               params.pitch_grid), draws.pitch_gate)
    elif route == "grouped":
        mixed = resample_pitch_grouped(
            mixed, pitch_grid(params.min_pitch, params.max_pitch,
                              params.pitch_grid),
            draws.pitch_perm, draws.pitch_gate, window=window)
    elif route == "continuous":
        mixed = resample_pitch(mixed, draws.semitones, draws.pitch_gate,
                               window=window)
    out = augment_post(mixed, rir, has_rir, draws, params)
    return (out * INT16_MAX).to(torch.int16)


# -- SpecAugment ------------------------------------------------------------------------

def draw_spec_masks(b: int, t: int, f: int, time_masks: int = 2,
                    time_width: int = 10, freq_masks: int = 2,
                    freq_width: int = 6,
                    generator: Optional[torch.Generator] = None):
    """-> list of (axis, starts [B], widths [B]), time masks first."""
    masks = []
    for axis, count, length, width in ((1, time_masks, t, time_width),
                                       (2, freq_masks, f, freq_width)):
        for _ in range(count):
            high = max(length - width, 1)
            starts = torch.randint(0, high, (b,), generator=generator)
            widths = torch.randint(0, width + 1, (b,), generator=generator)
            masks.append((axis, starts, widths))
    return masks


def spec_augment(mel: torch.Tensor, masks=None, *,
                 generator: Optional[torch.Generator] = None,
                 time_masks: int = 2, time_width: int = 10,
                 freq_masks: int = 2, freq_width: int = 6) -> torch.Tensor:
    """SpecAugment on [B, T, F] features: each mask sets a band of frames
    (axis 1) or features (axis 2) to the batch minimum."""
    b, t, f = mel.shape
    if masks is None:
        masks = draw_spec_masks(b, t, f, time_masks, time_width, freq_masks,
                                freq_width, generator)
    fill = mel.min()
    for axis, starts, widths in masks:
        starts = starts.to(mel.device)[:, None]
        ends = starts + widths.to(mel.device)[:, None]
        idx = torch.arange(mel.shape[axis], device=mel.device)[None, :]
        band = (idx >= starts) & (idx < ends)
        band = band[:, :, None] if axis == 1 else band[:, None, :]
        mel = torch.where(band, fill, mel)
    return mel
