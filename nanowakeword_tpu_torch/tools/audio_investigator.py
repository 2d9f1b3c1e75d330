"""Quarantine mover: relocate problem audio files out of a dataset.

The port of `tools/audio_investigator.py`, the upstream project's tool, on
the port's audio_io: scans a directory, moves unreadable / wrong-format /
too-quiet files into a `_quarantine/` subfolder so training sees only clean
data.

Usage: python -m nanowakeword_tpu_torch.tools.audio_investigator DIR \
           [--quiet-db -50] [--dry-run]
"""

import argparse
import os
import shutil
import wave

import numpy as np

from nanowakeword_tpu_torch.utils.audio_io import read_wav


def diagnose(path, quiet_db):
    try:
        with wave.open(path, "rb") as f:
            if f.getnframes() == 0:
                return "empty"
            if f.getframerate() != 16000 or f.getnchannels() != 1 \
                    or f.getsampwidth() != 2:
                return "wrong-format"
        data, _ = read_wav(path)
        x = data / 32768.0
        rms_db = 20 * np.log10(max(float(np.sqrt(np.mean(x * x) + 1e-12)),
                                   1e-6))
        if rms_db < quiet_db:
            return f"too-quiet ({rms_db:.1f} dB)"
        return None
    except Exception as e:  # noqa: BLE001
        return f"unreadable ({e})"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("directory")
    parser.add_argument("--quiet-db", type=float, default=-50.0)
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)

    quarantine = os.path.join(args.directory, "_quarantine")
    moved = 0
    for name in sorted(os.listdir(args.directory)):
        if not name.lower().endswith(".wav"):
            continue
        path = os.path.join(args.directory, name)
        reason = diagnose(path, args.quiet_db)
        if reason:
            print(f"{'DRY ' if args.dry_run else ''}QUARANTINE {name}: "
                  f"{reason}")
            if not args.dry_run:
                os.makedirs(quarantine, exist_ok=True)
                shutil.move(path, os.path.join(quarantine, name))
            moved += 1
    print(f"\n{moved} file(s) {'would be ' if args.dry_run else ''}moved to "
          f"{quarantine}")


if __name__ == "__main__":
    main()
