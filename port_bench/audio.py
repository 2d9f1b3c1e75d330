"""Speech-like int16 audio made on the device from a seed.

Every clip is a glottal-like source (a sawtooth at a moving pitch) shaped by
three moving formants, cut into syllables and pauses, over white noise at a
chosen SNR, at a chosen level. The formants are applied frame by frame in
the frequency domain (64 ms Hann frames at a 32 ms hop, overlap-added, so
the frames sum back to the source where the filter is flat). The encoder of
the program under test gives a constant output on white noise, so audio
that reaches its weights has to look like speech to a log-mel.

The ranges come from the traffic file's "audio" section and are drawn per
clip (and per frame for the formants' jitter) from one
`torch.Generator(device).manual_seed(seed)` in a few large calls, so the
same seed on the same kind of device gives the same samples.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
FRAME = 1024
HOP = FRAME // 2


def _clips(n_clips: int, n_samples: int, g, device, p: dict) -> torch.Tensor:
    """[n_clips, n_samples] int16 on `device`."""
    def u(lo, hi, *shape):
        shape = shape or (n_clips, 1)
        return lo + (hi - lo) * torch.rand(*shape, generator=g,
                                           device=device)

    t = (torch.arange(n_samples, device=device, dtype=torch.float64)
         / SAMPLE_RATE)[None]

    def wobble(rate, depth, times):
        return 1.0 + depth * torch.sin(2 * math.pi * u(*rate) * times
                                       + u(0.0, 2 * math.pi))

    # pitch: a slow drift and a faster wobble; the phase is summed in
    # float64 and wrapped, so a 4 s clip keeps its pitch exact
    f0 = u(*p["f0_hz"]).double() * wobble((0.3, 1.5), 0.12, t) \
        * wobble((3.0, 6.0), 0.04, t)
    phase = torch.remainder(torch.cumsum(f0 / SAMPLE_RATE, 1), 1.0).float()
    source = 2.0 * phase - 1.0
    source = source - source.mean(1, keepdim=True)

    # three formants per frame, moving smoothly with a little jitter
    n_frames = n_samples // HOP + 2
    tf = (torch.arange(n_frames, device=device) * HOP / SAMPLE_RATE)[None]
    freqs = torch.fft.rfftfreq(FRAME, 1.0 / SAMPLE_RATE).to(device)
    envelope = 0.0
    for f_range, bw, gain in zip(p["formants_hz"], p["formant_bw_hz"],
                                 p["formant_gain"]):
        centre = u(*f_range) * wobble((0.5, 3.0), 0.2, tf) \
            * u(0.95, 1.05, n_clips, n_frames)
        envelope = envelope + gain * torch.exp(
            -0.5 * ((freqs - centre[..., None]) / bw) ** 2)
    window = torch.hann_window(FRAME, periodic=True, device=device)
    padded = F.pad(source, (HOP, (n_frames - 1) * HOP + FRAME
                            - n_samples - HOP))
    frames = padded.unfold(1, FRAME, HOP) * window
    shaped = torch.fft.irfft(torch.fft.rfft(frames) * envelope, n=FRAME)
    voiced = F.fold(shaped.transpose(1, 2), (1, padded.shape[1]),
                    (1, FRAME), stride=(1, HOP))[:, 0, 0, HOP:HOP + n_samples]

    syllables = torch.clamp(torch.sin(2 * math.pi * u(*p["syllable_hz"]) * t
                                      + u(0.0, 2 * math.pi)), min=0.0) ** 0.7
    talking = torch.sin(2 * math.pi * u(*p["phrase_hz"]) * t
                        + u(0.0, 2 * math.pi)) > -0.5
    speech = voiced * (syllables * talking).float()
    speech = speech / speech.pow(2).mean(1, keepdim=True).sqrt().clamp_min(
        1e-9)
    noise = torch.randn(n_clips, n_samples, generator=g, device=device)
    mixed = speech + noise * 10.0 ** (-u(*p["snr_db"]) / 20.0)
    mixed = mixed / mixed.pow(2).mean(1, keepdim=True).sqrt()
    level = 32768.0 * 10.0 ** (u(*p["level_dbfs"]) / 20.0)
    return torch.clamp(torch.round(mixed * level), -32768,
                       32767).to(torch.int16)


def speech_like(n_clips: int, n_samples: int, seed: int, device,
                params: dict, block: int = 1024) -> torch.Tensor:
    """[n_clips, n_samples] int16 speech-like audio on `device`, made in
    blocks of `block` clips from one generator seeded with `seed`."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.cat([_clips(min(block, n_clips - i), n_samples, g, device,
                             params)
                      for i in range(0, n_clips, block)])
