"""Batch preprocessor: convert a tree to 16 kHz mono 16-bit 1 s clips.

The port of `tools/batch_audio_preprocess.py`, the upstream project's tool,
on the port's audio_io: normalises format and optionally chops everything to
fixed-length segments.

Usage: python -m nanowakeword_tpu_torch.tools.batch_audio_preprocess \
           IN_DIR OUT_DIR [--seconds 1.0]
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
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--no-split", action="store_true",
                        help="Only convert format; keep original lengths.")
    args = parser.parse_args(argv)

    seg_len = int(args.seconds * SR)
    os.makedirs(args.output_dir, exist_ok=True)
    n_out = 0
    for root, _, files in os.walk(args.input_dir):
        for name in sorted(files):
            if not name.lower().endswith((".wav", ".mp3", ".flac", ".ogg")):
                continue
            data = load_audio(os.path.join(root, name))
            if data is None:
                continue
            stem = os.path.splitext(name)[0]
            if args.no_split:
                write_wav(os.path.join(args.output_dir, stem + ".wav"), data)
                n_out += 1
                continue
            for i in range(0, max(len(data), 1), seg_len):
                seg = data[i:i + seg_len]
                if len(seg) < seg_len // 2:
                    break
                out = np.zeros(seg_len, np.float32)
                out[:len(seg)] = seg
                write_wav(os.path.join(args.output_dir,
                                       f"{stem}_{i // seg_len:04d}.wav"), out)
                n_out += 1
    print(f"Wrote {n_out} clips to {args.output_dir}")


if __name__ == "__main__":
    main()
