"""Per-file RMS / peak / clipping / silence report for a dataset directory.

The port of `tools/audio_analyzer.py`, the upstream project's tool, on the
port's audio_io: quality metrics used to spot too-quiet, clipped, or near-
silent clips before training.

Usage: python -m nanowakeword_tpu_torch.tools.audio_analyzer DIR \
           [--quiet-db -45] [--limit 0]
"""

import argparse
import os

import numpy as np

from nanowakeword_tpu_torch.utils.audio_io import read_wav


def analyze(path):
    data, sr = read_wav(path)
    x = data / 32768.0
    rms = float(np.sqrt(np.mean(x * x) + 1e-12))
    peak = float(np.abs(x).max()) if len(x) else 0.0
    clipped = float((np.abs(x) > 0.999).mean())
    return {
        "duration_s": len(x) / sr,
        "rms_db": 20 * np.log10(max(rms, 1e-6)),
        "peak": peak,
        "clipped_pct": clipped * 100,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("directory")
    parser.add_argument("--quiet-db", type=float, default=-45.0)
    parser.add_argument("--limit", type=int, default=0)
    args = parser.parse_args(argv)

    rows = []
    for root, _, files in os.walk(args.directory):
        for name in sorted(files):
            if not name.lower().endswith(".wav"):
                continue
            path = os.path.join(root, name)
            try:
                rows.append((path, analyze(path)))
            except Exception as e:  # noqa: BLE001
                print(f"unreadable: {path} ({e})")
            if args.limit and len(rows) >= args.limit:
                break

    if not rows:
        print("No WAV files found.")
        return
    print(f"{'file':<50} {'dur(s)':>7} {'rms(dB)':>8} {'peak':>6} "
          f"{'clip%':>6}")
    flagged = 0
    for path, m in rows:
        flag = ""
        if m["rms_db"] < args.quiet_db:
            flag = "  << QUIET"
            flagged += 1
        elif m["clipped_pct"] > 1.0:
            flag = "  << CLIPPED"
            flagged += 1
        print(f"{os.path.basename(path):<50} {m['duration_s']:>7.2f} "
              f"{m['rms_db']:>8.1f} {m['peak']:>6.2f} "
              f"{m['clipped_pct']:>6.2f}{flag}")
    durs = [m["duration_s"] for _, m in rows]
    print(f"\n{len(rows)} files | total {sum(durs) / 3600:.2f} h | "
          f"median {np.median(durs):.2f} s | {flagged} flagged")


if __name__ == "__main__":
    main()
