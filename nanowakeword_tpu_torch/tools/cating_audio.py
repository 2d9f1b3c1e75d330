"""Concatenate short clips into fixed-length (default 5 s) composites.

The port of `tools/cating_audio.py`, the upstream project's tool, on the
port's audio_io: packs many short clips end-to-end into uniform-length WAVs
(useful for negative/noise sets).

Usage: python -m nanowakeword_tpu_torch.tools.cating_audio IN_DIR OUT_DIR \
           [--seconds 5]
"""

import argparse
import os

import numpy as np

from nanowakeword_tpu_torch.utils.audio_io import load_audio, write_wav

SR = 16000


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input_dir")
    parser.add_argument("output_dir")
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)

    target = int(args.seconds * SR)
    os.makedirs(args.output_dir, exist_ok=True)

    buffer = np.empty(0, np.float32)
    out_idx = 0
    files = sorted(f for f in os.listdir(args.input_dir)
                   if f.lower().endswith((".wav", ".mp3", ".flac", ".ogg")))
    for name in files:
        data = load_audio(os.path.join(args.input_dir, name))
        if data is None:
            continue
        buffer = np.concatenate([buffer, data])
        while len(buffer) >= target:
            write_wav(os.path.join(args.output_dir,
                                   f"concat_{out_idx:05d}.wav"),
                      buffer[:target])
            buffer = buffer[target:]
            out_idx += 1
    if len(buffer) > SR:  # keep a >=1 s remainder, zero-padded
        out = np.zeros(target, np.float32)
        out[:len(buffer)] = buffer
        write_wav(os.path.join(args.output_dir, f"concat_{out_idx:05d}.wav"),
                  out)
        out_idx += 1
    print(f"Wrote {out_idx} composite clips to {args.output_dir}")


if __name__ == "__main__":
    main()
