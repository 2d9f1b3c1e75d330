"""Silence-split slicer: cut long recordings into utterance-sized clips.

The port of `tools/audio_slicer.py`, the upstream project's tool, on the
port's audio_io: splits WAVs on silence gaps and writes individual clips,
for turning long captures into training samples.

Usage: python -m nanowakeword_tpu_torch.tools.audio_slicer IN.wav OUT_DIR \
          [--silence-db -40] [--min-gap-ms 300] [--min-clip-ms 250]
"""

import argparse
import os

import numpy as np

from nanowakeword_tpu_torch.utils.audio_io import read_wav, write_wav

SR = 16000


def split_on_silence(x, silence_db, min_gap_ms, min_clip_ms):
    frame = SR // 100  # 10 ms energy frames
    n = len(x) // frame
    energy_db = 20 * np.log10(np.maximum(
        np.sqrt((x[:n * frame].reshape(n, frame) / 32768.0) ** 2
                ).mean(axis=1), 1e-6))
    speech = energy_db > silence_db
    min_gap = max(int(min_gap_ms / 10), 1)
    min_clip = max(int(min_clip_ms / 10), 1)

    clips, start, gap = [], None, 0
    for i, s in enumerate(speech):
        if s:
            if start is None:
                start = i
            gap = 0
        elif start is not None:
            gap += 1
            if gap >= min_gap:
                end = i - gap + 1
                if end - start >= min_clip:
                    clips.append((start * frame, end * frame))
                start, gap = None, 0
    if start is not None and n - start >= min_clip:
        clips.append((start * frame, n * frame))
    return clips


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input")
    parser.add_argument("output_dir")
    parser.add_argument("--silence-db", type=float, default=-40.0)
    parser.add_argument("--min-gap-ms", type=int, default=300)
    parser.add_argument("--min-clip-ms", type=int, default=250)
    parser.add_argument("--pad-ms", type=int, default=100)
    args = parser.parse_args(argv)

    x, sr = read_wav(args.input)
    if sr != SR:
        from nanowakeword_tpu_torch.utils.audio_io import resample
        x = resample(x, sr, SR)
    clips = split_on_silence(x, args.silence_db, args.min_gap_ms,
                             args.min_clip_ms)
    os.makedirs(args.output_dir, exist_ok=True)
    pad = int(args.pad_ms / 1000 * SR)
    stem = os.path.splitext(os.path.basename(args.input))[0]
    for i, (a, b) in enumerate(clips):
        seg = x[max(a - pad, 0):min(b + pad, len(x))]
        write_wav(os.path.join(args.output_dir, f"{stem}_{i:04d}.wav"), seg)
    print(f"Wrote {len(clips)} clips to {args.output_dir}")


if __name__ == "__main__":
    main()
