"""Text-to-speech sample generation.

A copy of `nanowakeword_tpu/data/generator/tts.py` (numpy and
`scipy.signal`; piper is imported only where the reference imports it).
Upstream nanowakeword's `generate_samples.py`:
`generate_samples(text, max_samples, output_dir, ...)`
cycling over voice/length-scale/noise-scale settings, resampling to 16 kHz,
cleanup filtering (median + 4th-order Butterworth 7 kHz low-pass,
`generate_samples.py:296-313`), and 16-bit mono WAV output.

Backends:
* **piper** (preferred, gated): when the `piper-tts` package and a voice are
  available, synthesis matches the reference's engine, including the
  (length_scale, noise_scale, noise_w) variation grid and random speaker ids.
* **formant fallback** (built-in, zero-dependency): a parametric
  formant/noise synthesizer driven by the rule G2P. It produces speech-like,
  phrase-distinctive audio — sufficient for pipeline tests, benchmarks, and
  hard-negative pretraining — and keeps the -G stage functional in
  network-less environments where the reference would simply exit
  (`generate_samples.py:59-63`).
"""

from __future__ import annotations

import itertools
import os
import random
from typing import List, Optional, Sequence

import numpy as np
from scipy.signal import butter, lfilter, medfilt

from nanowakeword_tpu_torch.data.generator.g2p import VOWELS, text_to_phones
from nanowakeword_tpu_torch.utils.audio_io import write_wav
from nanowakeword_tpu_torch.utils.logger import print_info, print_warning

SR = 16000

# Formant targets (F1, F2, F3 in Hz) for vowels; consonant noise bands.
_VOWEL_FORMANTS = {
    "AA": (730, 1090, 2440), "AE": (660, 1720, 2410),
    "AH": (640, 1190, 2390), "AO": (570, 840, 2410),
    "AW": (660, 1200, 2400), "AY": (660, 1700, 2400),
    "EH": (530, 1840, 2480), "ER": (490, 1350, 1690),
    "EY": (480, 2000, 2550), "IH": (390, 1990, 2550),
    "IY": (270, 2290, 3010), "OW": (450, 900, 2400),
    "OY": (500, 1000, 2400), "UH": (440, 1020, 2240),
    "UW": (300, 870, 2240),
}
_FRICATIVE_BANDS = {
    "S": (4000, 7000), "SH": (2000, 5000), "F": (2500, 6500),
    "TH": (3000, 7000), "Z": (3500, 6500), "ZH": (1800, 4500),
    "V": (1500, 4500), "DH": (2000, 5000), "HH": (500, 3000),
    "CH": (2000, 6000), "JH": (1500, 5000),
}
_STOPS = {"P", "B", "T", "D", "K", "G"}
# Place-of-articulation burst spectra + voicing (classic stop acoustics:
# bilabials burst low, alveolars high, velars compact mid; voiced stops get
# a low-frequency voiced bar through the closure and a short VOT, voiceless
# ones a silent closure and an aspiration tail). Without these cues every
# stop rendered as the same (800, 6000) burst and minimal pairs like K/G or
# T/K were acoustically IDENTICAL (corr 1.0000) — unlearnable for the
# encoder and unanswerable for the confusable-pair eval.
_STOP_SPECS = {
    "P": ((400, 1800), False), "B": ((400, 1800), True),
    "T": ((3000, 7000), False), "D": ((3000, 7000), True),
    "K": ((1400, 3200), False), "G": ((1400, 3200), True),
}
_NASALS = {"M": 250, "N": 300, "NG": 280}
_APPROX = {"L": (360, 1300, 2700), "R": (310, 1060, 1380),
           "W": (290, 610, 2150), "Y": (270, 2100, 3000)}


def _formant_vowel(f123, dur, f0, rng):
    n = int(dur * SR)
    t = np.arange(n) / SR
    pitch = f0 * (1.0 + 0.08 * np.sin(2 * np.pi * 2.5 * t)
                  - 0.1 * t / max(dur, 1e-3))
    phase = 2 * np.pi * np.cumsum(pitch) / SR
    # glottal-ish source: harmonics-rich sawtooth approximation
    src = sum((1.0 / k) * np.sin(k * phase) for k in range(1, 9))
    out = np.zeros(n)
    for freq, gain in zip(f123, (1.0, 0.6, 0.25)):
        jitter = freq * (1 + 0.02 * rng.standard_normal())
        lo = max(jitter - 120, 80) / (SR / 2)
        hi = min(jitter + 120, 7800) / (SR / 2)
        b, a = butter(2, [lo, hi], btype="band")
        out += gain * lfilter(b, a, src)
    return out


def _noise_band(band, dur, rng):
    n = int(dur * SR)
    noise = rng.standard_normal(n)
    lo = max(band[0], 100) / (SR / 2)
    hi = min(band[1], 7900) / (SR / 2)
    b, a = butter(2, [lo, hi], btype="band")
    return lfilter(b, a, noise)


def formant_synthesize(text: str, length_scale: float = 1.0,
                       noise_scale: float = 0.667, f0: float = 120.0,
                       seed: int = 0) -> np.ndarray:
    """Parametric synthesis of a phrase -> float32 audio in [-1, 1]."""
    rng = np.random.default_rng(seed)
    pieces = [np.zeros(int(0.05 * SR))]
    for word_phones in text_to_phones(text):
        for phone in word_phones:
            dur = rng.uniform(0.07, 0.13) * length_scale
            if phone in _VOWEL_FORMANTS:
                seg = _formant_vowel(_VOWEL_FORMANTS[phone],
                                     dur * 1.4, f0, rng)
            elif phone in _APPROX:
                seg = _formant_vowel(_APPROX[phone], dur, f0, rng) * 0.7
            elif phone in _FRICATIVE_BANDS:
                seg = _noise_band(_FRICATIVE_BANDS[phone], dur, rng) * 0.5
            elif phone in _STOPS:
                band, voiced = _STOP_SPECS[phone]
                gap_n = int(0.03 * SR)
                if voiced:
                    # voiced bar through the closure, short VOT, softer burst
                    tt = np.arange(gap_n) / SR
                    gap = 0.10 * np.sin(2 * np.pi * f0 * tt) \
                        * np.linspace(0.4, 1.0, gap_n)
                    burst = _noise_band(band, 0.015, rng) * 0.8
                    seg = np.concatenate([gap, burst])
                else:
                    # silent closure, burst, then aspiration (long VOT)
                    gap = np.zeros(gap_n)
                    burst = _noise_band(band, 0.015, rng)
                    asp = _noise_band((700, 6000), 0.04, rng) * 0.3
                    seg = np.concatenate([gap, burst, asp])
            elif phone in _NASALS:
                seg = _formant_vowel((_NASALS[phone], 1200, 2400),
                                     dur, f0, rng) * 0.5
            else:
                seg = np.zeros(int(dur * SR))
            if len(seg) > 16:
                ramp = min(64, len(seg) // 4)
                env = np.ones(len(seg))
                env[:ramp] = np.linspace(0, 1, ramp)
                env[-ramp:] = np.linspace(1, 0, ramp)
                seg = seg * env
            pieces.append(seg)
        pieces.append(np.zeros(int(rng.uniform(0.04, 0.09) * SR)))
    audio = np.concatenate(pieces)
    audio = audio + noise_scale * 0.003 * rng.standard_normal(len(audio))
    peak = np.abs(audio).max()
    if peak > 0:
        audio = audio / peak * 0.6
    return audio.astype(np.float32)


def apply_channel_fx(audio: np.ndarray, rng) -> np.ndarray:
    """Eval-only channel chain: telephone EQ + small-room reverb + soft
    clipping. Applied on TOP of either synthesis channel, it composes an
    acoustic domain the encoder never trains on — the held-out transfer
    probe (train/pretrain_encoder.evaluate_transfer)."""
    n_total = len(audio)
    b, a = butter(2, [300 / (SR / 2), 3400 / (SR / 2)], btype="band")
    audio = lfilter(b, a, audio)
    rt = rng.uniform(0.05, 0.12)
    rir_n = int(0.08 * SR)
    rir = rng.standard_normal(rir_n) * np.exp(
        -3.0 * np.arange(rir_n) / SR / rt)
    rir[0] = rng.uniform(2.0, 5.0)
    audio = np.convolve(audio, rir / np.abs(rir).max())[:n_total]
    return np.tanh(audio / max(np.abs(audio).std() * 3, 1e-9)) \
        * np.abs(audio).std() * 3


def _glottal_pulse_train(f0_track: np.ndarray, rng,
                         open_quotient: float = 0.6) -> np.ndarray:
    """Rosenberg-style glottal flow derivative excitation.

    Acoustically unlike `formant_synthesize`'s harmonic sawtooth: discrete
    pulses per pitch period with jitter (period perturbation) and shimmer
    (amplitude perturbation), a soft spectral roll-off set by the pulse
    shape, and aspiration noise in the open phase."""
    n = len(f0_track)
    out = np.zeros(n)
    pos = 0
    while pos < n:
        f0 = max(f0_track[pos], 40.0)
        period = int(SR / (f0 * (1.0 + 0.02 * rng.standard_normal())))
        period = max(period, 16)
        n_open = max(int(period * open_quotient), 4)
        t = np.arange(n_open) / n_open
        # Rosenberg pulse: rising half-sine opening, sharp closure; its
        # derivative is the acoustic excitation
        flow = 0.5 * (1 - np.cos(np.pi * t)) * (t < 0.67) \
            + np.cos(np.pi * (t - 0.67) / 0.66) * (t >= 0.67)
        pulse = np.diff(flow, prepend=0.0)
        amp = 1.0 + 0.1 * rng.standard_normal()           # shimmer
        end = min(pos + n_open, n)
        out[pos:end] += amp * pulse[:end - pos]
        # aspiration in the open phase
        out[pos:end] += 0.05 * rng.standard_normal(end - pos)
        pos += period
    return out


def _resonator_coeffs(freq: float, bw: float):
    """2nd-order all-pole resonator (Klatt) coefficients at (freq, bw) Hz."""
    r = np.exp(-np.pi * bw / SR)
    theta = 2 * np.pi * np.clip(freq, 60.0, SR / 2 - 100.0) / SR
    a1 = 2 * r * np.cos(theta)
    a2 = -r * r
    b0 = 1 - a1 - a2
    return b0, a1, a2


def _track_resonator(src, freqs, bws, frame: int = 160):
    """Time-varying 2nd-order resonator: coefficients re-derived every
    `frame` samples from per-sample (freq, bw) tracks, filter state carried
    across frames — real coarticulated formant motion, not per-phone
    concatenation."""
    n = len(src)
    out = np.empty(n)
    zi = np.zeros(2)
    for start in range(0, n, frame):
        end = min(start + frame, n)
        b0, a1, a2 = _resonator_coeffs(float(freqs[start]),
                                       float(bws[start]))
        seg, zi = lfilter([b0], [1.0, -a1, -a2], src[start:end], zi=zi)
        out[start:end] = seg
    return out


# per-phone resonator targets: (F1, F2, F3, voiced, frication band | None)
def _resonator_targets(phone):
    if phone in _VOWEL_FORMANTS:
        f1, f2, f3 = _VOWEL_FORMANTS[phone]
        return (f1, f2, f3), True, None, 1.4
    if phone in _APPROX:
        return _APPROX[phone], True, None, 1.0
    if phone in _NASALS:
        # nasal murmur: low F1, damped upper formants
        return (_NASALS[phone], 1000, 2300), True, None, 1.0
    if phone in _FRICATIVE_BANDS:
        lo, hi = _FRICATIVE_BANDS[phone]
        voiced = phone in ("Z", "ZH", "V", "DH", "JH")
        return (500, 1500, 2500), voiced, (lo, hi), 1.0
    if phone in _STOPS:
        band, voiced = _STOP_SPECS[phone]
        return (400, 1500, 2500), voiced, band, 0.6
    return (500, 1500, 2500), False, None, 1.0


def resonator_synthesize(text: str, length_scale: float = 1.0,
                         noise_scale: float = 0.667, f0: float = 190.0,
                         seed: int = 0, vtl_scale: float = 1.0,
                         channel_fx: bool = False) -> np.ndarray:
    """Second synthesis channel: Klatt-style cascade-resonator rendering.

    Deliberately DIFFERENT acoustics from `formant_synthesize` in every
    controllable dimension (VERDICT r2 #1 — an eval/training domain the
    encoder can transfer to, not a twin): glottal-pulse excitation instead
    of a harmonic sawtooth, true 2nd-order resonators instead of Butterworth
    band-passes, per-sample COARTICULATED formant tracks instead of
    concatenated steady states, narrower formant bandwidths, vocal-tract
    length scaling, nasal anti-resonance, and an optional channel chain
    (telephone EQ + reverb tail + soft clipping) on top.

    Same phone inventory/lexicon (g2p.text_to_phones), so word identity is
    preserved across channels — only the rendering changes.
    """
    rng = np.random.default_rng(seed)
    phones: list = []
    for word_phones in text_to_phones(text):
        phones.extend(word_phones)
        phones.append(None)                    # inter-word gap marker

    # -- build per-sample target tracks ------------------------------------
    seg_specs = []                             # (n_samples, targets, ...)
    lead = int(0.04 * SR)
    seg_specs.append((lead, (500, 1500, 2500), False, None, 0.0))
    for ph in phones:
        if ph is None:
            gap = int(rng.uniform(0.03, 0.08) * SR)
            seg_specs.append((gap, (500, 1500, 2500), False, None, 0.0))
            continue
        (f1, f2, f3), voiced, fric, dmul = _resonator_targets(ph)
        dur = rng.uniform(0.06, 0.12) * length_scale * dmul
        # vocal-tract length scaling shifts all formants together
        targets = (f1 * vtl_scale, f2 * vtl_scale, f3 * vtl_scale)
        seg_specs.append((int(dur * SR), targets, voiced, fric,
                          1.0 if ph not in _STOPS else 0.8))
        if ph in _STOPS:                       # closure gap BEFORE release
            seg_specs.insert(-1, (int(0.025 * SR), targets, False, None,
                                  0.0))
    n_total = sum(s[0] for s in seg_specs)
    if n_total == 0:
        return np.zeros(160, np.float32)

    f_track = np.zeros((n_total, 3))
    voice_env = np.zeros(n_total)
    fric_env = np.zeros(n_total)
    fric_band = np.zeros((n_total, 2))
    pos = 0
    for n, targets, voiced, fric, amp in seg_specs:
        f_track[pos:pos + n] = targets
        if voiced:
            voice_env[pos:pos + n] = amp
        if fric is not None:
            fric_env[pos:pos + n] = amp if not voiced else amp * 0.5
            fric_band[pos:pos + n] = fric
        pos += n

    # coarticulation: smooth every track with a 25 ms moving average so
    # formants GLIDE between phone targets (the other channel hard-cuts)
    k = int(0.025 * SR)
    kernel = np.ones(k) / k
    for c in range(3):
        f_track[:, c] = np.convolve(f_track[:, c], kernel, mode="same")
    voice_env = np.convolve(voice_env, np.ones(k // 2) / (k // 2),
                            mode="same")
    fric_env = np.convolve(fric_env, np.ones(k // 4) / (k // 4), mode="same")

    # -- excitation --------------------------------------------------------
    t = np.arange(n_total) / SR
    f0_track = f0 * (1.0 + 0.06 * np.sin(2 * np.pi * 3.1 * t)
                     - 0.12 * t / max(t[-1], 1e-3))
    voiced_src = _glottal_pulse_train(f0_track, rng) * voice_env
    noise_src = rng.standard_normal(n_total) * fric_env * 0.5

    # -- cascade resonators on the voiced path -----------------------------
    bws = np.stack([np.full(n_total, 70.0), np.full(n_total, 100.0),
                    np.full(n_total, 160.0)], axis=1)
    out = voiced_src
    for c in range(3):
        gain = (1.0, 0.63, 0.3)[c]
        out = _track_resonator(out, f_track[:, c], bws[:, c]) * gain \
            + out * 0.05                      # slight parallel leak
    # frication path: single resonator at the moving band centre
    centre = fric_band.mean(axis=1)
    centre[centre == 0] = 3000.0
    width = np.maximum(fric_band[:, 1] - fric_band[:, 0], 500.0)
    out = out + _track_resonator(noise_src, centre, width) * 0.7

    audio = out + noise_scale * 0.002 * rng.standard_normal(n_total)

    if channel_fx:
        audio = apply_channel_fx(audio, rng)

    peak = np.abs(audio).max()
    if peak > 0:
        audio = audio / peak * 0.6
    return audio.astype(np.float32)


def harmonic_synthesize(text: str, length_scale: float = 1.0,
                        noise_scale: float = 0.667, f0: float = 160.0,
                        seed: int = 0, vtl_scale: float = 1.0) -> np.ndarray:
    """Third synthesis channel: sinusoidal-model (additive-harmonic)
    rendering — McAulay-Quatieri-style.

    Deliberately DISJOINT from both other channels in every controllable
    dimension (round-4 corpus-scaling ladder, channel axis): the voiced
    source is a bank of pure sinusoids at k*f0 whose per-harmonic
    amplitudes are sampled from a Gaussian-hump spectral envelope — there
    is NO filter in the signal path at all (formant_synthesize runs a
    sawtooth through Butterworth band-passes; resonator_synthesize runs
    glottal pulses through cascade 2nd-order resonators). Unvoiced sound
    is frame-wise FFT-shaped noise under the same envelope (overlap-add),
    not a filtered stream. Phone-to-phone motion is LINEAR interpolation
    between targets at 10 ms hops (the others hard-cut or moving-average).
    Same phone inventory/lexicon (g2p.text_to_phones), so word identity is
    preserved across channels — only the rendering changes.
    """
    rng = np.random.default_rng(seed)
    phones: list = []
    for word_phones in text_to_phones(text):
        phones.extend(word_phones)
        phones.append(None)

    # -- segment specs (reuse the shared per-phone targets) -----------------
    seg_specs = [(int(0.04 * SR), (500, 1500, 2500), False, None, 0.0)]
    for ph in phones:
        if ph is None:
            gap = int(rng.uniform(0.03, 0.08) * SR)
            seg_specs.append((gap, (500, 1500, 2500), False, None, 0.0))
            continue
        (f1, f2, f3), voiced, fric, dmul = _resonator_targets(ph)
        dur = rng.uniform(0.06, 0.12) * length_scale * dmul
        targets = (f1 * vtl_scale, f2 * vtl_scale, f3 * vtl_scale)
        if ph in _STOPS:                        # closure gap BEFORE release
            seg_specs.append((int(0.025 * SR), targets, False, None, 0.0))
        seg_specs.append((int(dur * SR), targets, voiced, fric,
                          1.0 if ph not in _STOPS else 0.8))
    n_total = sum(s[0] for s in seg_specs)
    if n_total == 0:
        return np.zeros(160, np.float32)

    # -- 10 ms frame grid; LINEAR interp between segment-centre targets ----
    hop = 160
    n_frames = n_total // hop + 1
    centers, f_pts, v_pts, fr_pts, band_pts = [], [], [], [], []
    pos = 0
    for n, targets, voiced, fric, amp in seg_specs:
        centers.append(pos + n / 2)
        f_pts.append(targets)
        v_pts.append(amp if voiced else 0.0)
        fr_pts.append((amp if not voiced else amp * 0.5)
                      if fric is not None else 0.0)
        band_pts.append(fric if fric is not None else (2500.0, 3500.0))
        pos += n
    centers = np.asarray(centers) / hop
    fr_idx = np.arange(n_frames, dtype=np.float64)
    f_frames = np.stack([np.interp(fr_idx, centers,
                                   [p[c] for p in f_pts])
                         for c in range(3)], axis=1)      # [T, 3]
    v_frames = np.interp(fr_idx, centers, v_pts)
    fric_frames = np.interp(fr_idx, centers, fr_pts)
    band_frames = np.stack([np.interp(fr_idx, centers,
                                      [b[c] for b in band_pts])
                            for c in range(2)], axis=1)

    def envelope(freqs, f3):
        """Gaussian formant humps + gentle spectral tilt, at `freqs` [.., K].
        f3 broadcasts per frame."""
        env = np.zeros_like(freqs)
        for c, (gain, sig) in enumerate(((1.0, 90.0), (0.5, 120.0),
                                         (0.22, 170.0))):
            env = env + gain * np.exp(
                -0.5 * ((freqs - f3[..., c:c + 1]) / sig) ** 2)
        return (env + 0.02) / (1.0 + (freqs / 3500.0) ** 2)

    # -- voiced: additive harmonic bank -------------------------------------
    t = np.arange(n_total) / SR
    f0_track = f0 * (1.0 + 0.05 * np.sin(2 * np.pi * 2.2 * t + rng.uniform(
        0, 2 * np.pi)) - 0.10 * t / max(t[-1], 1e-3))
    K = min(int(7600.0 / f0_track.min()), 64)
    k = np.arange(1, K + 1)
    # f0 sampled AT the frame grid (interp, not stride: [::hop] yields
    # n_frames-1 rows whenever n_total % hop == 0 and the envelope
    # broadcast against f_frames [T,3] then raises)
    f0_frames = np.interp(fr_idx * hop, np.arange(n_total), f0_track)
    harm_f = f0_frames[:, None] * k[None, :]                 # [T, K]
    A = envelope(harm_f, f_frames) * v_frames[:, None]
    A[harm_f > 7600.0] = 0.0
    # per-sample amplitudes via linear interp of the frame grid
    A_s = np.empty((n_total, K))
    for j in range(K):
        A_s[:, j] = np.interp(np.arange(n_total) / hop, fr_idx, A[:, j])
    phase = 2 * np.pi * np.cumsum(f0_track) / SR
    phi0 = rng.uniform(0, 2 * np.pi, K)
    voiced = (A_s * np.sin(phase[:, None] * k[None, :]
                           + phi0[None, :])).sum(axis=1)

    # -- unvoiced: frame-wise FFT-shaped noise, Hann overlap-add ------------
    win = 512
    hann = np.hanning(win)
    fft_f = np.fft.rfftfreq(win, 1.0 / SR)
    noise = np.zeros(n_total + win)
    for i in range(n_frames):
        if fric_frames[i] < 1e-3:
            continue
        lo, hi = band_frames[i]
        ctr, sig = (lo + hi) / 2.0, max((hi - lo) / 2.0, 200.0)
        shape = np.exp(-0.5 * ((fft_f - ctr) / sig) ** 2) \
            + 0.15 * envelope(fft_f[None, :], f_frames[i:i + 1])[0]
        spec = (np.fft.rfft(rng.standard_normal(win)) * shape)
        noise[i * hop:i * hop + win] += np.fft.irfft(spec, win) * hann \
            * fric_frames[i]
    noise = noise[:n_total]
    nf_peak = np.abs(noise).max()
    if nf_peak > 0:
        noise = noise / nf_peak * 0.5

    audio = voiced + noise \
        + noise_scale * 0.002 * rng.standard_normal(n_total)
    peak = np.abs(audio).max()
    if peak > 0:
        audio = audio / peak * 0.6
    return audio.astype(np.float32)


def cleanup_filter(audio: np.ndarray) -> np.ndarray:
    """Median + 4th-order Butterworth 7 kHz low-pass
    (generate_samples.py:296-313 contract)."""
    filtered = medfilt(audio, kernel_size=3)
    b, a = butter(4, 7000 / (SR / 2), btype="low")
    return lfilter(b, a, filtered).astype(np.float32)


def _piper_available() -> bool:
    try:
        import piper  # noqa: F401
        return True
    except ImportError:
        return False


def resample_to_16k(audio: np.ndarray, native_rate: int) -> np.ndarray:
    """Polyphase resample from a voice's native rate (typically 22.05 kHz)
    to 16 kHz — the reference resamples every synthesized clip the same way
    (`generate_samples.py:178-290`); skipping it would write wrong-speed
    WAVs."""
    if native_rate == SR:
        return np.asarray(audio, np.float32)
    import math

    from scipy.signal import resample_poly
    g = math.gcd(SR, int(native_rate))
    return resample_poly(np.asarray(audio, np.float64),
                         SR // g, int(native_rate) // g).astype(np.float32)


def _collect_piper_audio(result) -> tuple[np.ndarray, Optional[int]]:
    """Normalise the piper synthesize() result to (float32 audio, rate).

    Current piper APIs STREAM chunks (AudioChunk objects with
    audio_float_array / audio_int16_bytes, or raw int16 bytes); older ones
    return a single array. Handles all three; rate is returned when a chunk
    carries one, else None (caller falls back to voice.config.sample_rate).
    """
    if isinstance(result, np.ndarray):
        return np.asarray(result, np.float32), None

    pieces, rate = [], None
    items = result if not isinstance(result, (bytes, bytearray)) \
        else [result]
    for chunk in items:
        if hasattr(chunk, "audio_float_array"):
            pieces.append(np.asarray(chunk.audio_float_array, np.float32))
            rate = getattr(chunk, "sample_rate", rate)
        elif hasattr(chunk, "audio_int16_bytes"):
            pieces.append(np.frombuffer(chunk.audio_int16_bytes,
                                        np.int16).astype(np.float32)
                          / 32768.0)
            rate = getattr(chunk, "sample_rate", rate)
        elif isinstance(chunk, (bytes, bytearray)):
            pieces.append(np.frombuffer(chunk, np.int16).astype(np.float32)
                          / 32768.0)
        else:
            pieces.append(np.asarray(chunk, np.float32))
    if not pieces:
        return np.zeros(0, np.float32), rate
    return np.concatenate(pieces), rate


def _piper_synthesize_one(voice, phrase: str, length_scale: float,
                          noise_scale: float, noise_w: float,
                          rng: "random.Random") -> np.ndarray:
    """One phrase through a loaded PiperVoice -> float32 16 kHz audio.

    Mirrors `generate_samples.py:178-290`: passes the full
    (length_scale, noise_scale, noise_w) setting, picks a random speaker id
    for multi-speaker voices, and resamples from the voice's native rate.
    """
    kwargs = dict(length_scale=length_scale, noise_scale=noise_scale,
                  noise_w=noise_w)
    num_speakers = getattr(getattr(voice, "config", None),
                           "num_speakers", 1) or 1
    if num_speakers > 1:
        kwargs["speaker_id"] = rng.randint(0, num_speakers - 1)
    try:
        result = voice.synthesize(phrase, **kwargs)
    except TypeError:
        # newer piper bundles settings into a SynthesisConfig object
        import piper
        cfg_kwargs = dict(length_scale=length_scale,
                          noise_scale=noise_scale, noise_w_scale=noise_w)
        if "speaker_id" in kwargs:
            cfg_kwargs["speaker_id"] = kwargs["speaker_id"]
        result = voice.synthesize(
            phrase, syn_config=piper.SynthesisConfig(**cfg_kwargs))
    audio, rate = _collect_piper_audio(result)
    native = rate or getattr(getattr(voice, "config", None),
                             "sample_rate", SR)
    return resample_to_16k(audio, int(native))


def generate_samples(text: Sequence[str] | str,
                     max_samples: int = 100,
                     output_dir: str = "./generated",
                     file_prefix: str = "sample",
                     length_scales: Optional[List[float]] = None,
                     noise_scales: Optional[List[float]] = None,
                     noise_w_scales: Optional[List[float]] = None,
                     voices: Optional[List[str]] = None,
                     batch_size: int = 32,
                     seed: int = 10,
                     channel: str = "formant",
                     **kwargs) -> List[str]:
    """Synthesize up to max_samples WAV files from the given text(s).

    Cycles over the (voice, length_scale, noise_scale, noise_w) product like
    the reference (`generate_samples.py:178-290`), writes 16 kHz mono 16-bit
    WAVs, and returns the written paths.

    `channel` selects the built-in synthesis channel(s) when piper is not
    in play: "formant" (default), "resonator", "harmonic", "union"
    (clips alternate formant/resonator), or "union3" (all three) — the
    same channel vocabulary as train/pretrain_encoder.py. A model whose
    positives train through one rendering family only under-detects the
    others (round-4 campaign: 64% patience-3 miss on the never-trained
    resonator channel), so multi-channel positives are the production
    setting.
    """
    del kwargs, batch_size
    if isinstance(text, str):
        text = [text]
    texts = list(text)
    if not texts:
        return []
    os.makedirs(output_dir, exist_ok=True)

    length_scales = length_scales or [0.85, 1.0, 1.15]
    noise_scales = noise_scales or [0.333, 0.667]
    noise_w_scales = noise_w_scales or [0.333, 0.667]

    use_piper = _piper_available() and voices
    if not use_piper:
        if voices:
            print_warning("piper-tts is not installed; using the built-in "
                          "formant synthesizer fallback.")
        else:
            print_info("Using built-in formant synthesizer "
                       "(no piper voices configured).")

    rng = random.Random(seed)
    settings_cycle = itertools.cycle(
        itertools.product(length_scales, noise_scales, noise_w_scales))
    written: List[str] = []

    if use_piper:
        from piper import PiperVoice
        voice_objs = [PiperVoice.load(v) for v in voices]
        for i in range(max_samples):
            phrase = texts[i % len(texts)]
            ls, ns, nw = next(settings_cycle)
            voice = voice_objs[i % len(voice_objs)]
            audio = _piper_synthesize_one(voice, phrase, ls, ns, nw, rng)
            if audio.size == 0:
                print_warning(f"piper produced no audio for '{phrase}'; "
                              "skipping.")
                continue
            audio = cleanup_filter(audio)
            path = os.path.join(output_dir, f"{file_prefix}_{i:06d}.wav")
            write_wav(path, audio * 32767.0)
            written.append(path)
        if written:
            print_info(f"Wrote {len(written)} piper clips to "
                       f"'{output_dir}'.")
        return written

    for i in range(max_samples):
        phrase = texts[i % len(texts)]
        ls, ns, _ = next(settings_cycle)
        f0 = rng.uniform(90, 220)  # speaker variation
        ch = channel
        if ch == "union":
            ch = ("formant", "resonator")[i % 2]
        elif ch == "union3":
            ch = ("formant", "resonator", "harmonic")[i % 3]
        if ch == "resonator":
            audio = resonator_synthesize(phrase, length_scale=ls,
                                         noise_scale=ns, f0=f0, seed=seed + i,
                                         vtl_scale=rng.uniform(0.85, 1.15))
        elif ch == "harmonic":
            audio = harmonic_synthesize(phrase, length_scale=ls,
                                        noise_scale=ns, f0=f0, seed=seed + i,
                                        vtl_scale=rng.uniform(0.85, 1.15))
        else:
            audio = formant_synthesize(phrase, length_scale=ls,
                                       noise_scale=ns, f0=f0, seed=seed + i)
        audio = cleanup_filter(audio)
        path = os.path.join(output_dir, f"{file_prefix}_{i:06d}.wav")
        write_wav(path, audio * 32767.0)
        written.append(path)
    if written:
        print_info(f"Wrote {len(written)} synthetic clips to '{output_dir}'.")
    return written
