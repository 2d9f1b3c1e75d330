"""End-to-end model evaluation: stream WAVs through the interpreter.

The port of `test_model/evaluate_model_with_audio.py` (the upstream
project's evaluator): streams each file chunk by chunk (1280 samples)
through the port's NanoInterpreter on `--device`, takes the max score per
file, and reports the miss rate and the false-alarm rate at a fixed
threshold, over the first N files of each folder in name order.

Usage:
    python -m nanowakeword_tpu_torch.test_model.evaluate_model_with_audio \\
        --model trained_models/my/model/my.nww \\
        --positive data/positive --negative data/negative \\
        [--noise data/noise] [--threshold 0.90] [--max-samples 5000] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from glob import glob

import numpy as np

from nanowakeword_tpu_torch import NanoInterpreter
from nanowakeword_tpu_torch.utils.audio_io import load_audio

CHUNK_SIZE = 1280


def get_limited_files(folder_path, max_samples):
    """First-N alphabetical selection for run-to-run comparability."""
    if not folder_path or not os.path.isdir(folder_path):
        if folder_path:
            print(f"\nWarning: Directory not found: {folder_path}")
        return []
    files = sorted(glob(os.path.join(folder_path, "*.wav")))
    if not files:
        print(f"\nWarning: No .wav files found in {folder_path}")
        return []
    if max_samples is not None:
        print(f"(Selecting the first {min(max_samples, len(files))} of "
              f"{len(files)} files)")
        return files[:max_samples]
    return files


def stream_scores(interpreter, audio, key, times=None):
    """Stream a clip chunk by chunk; return the full per-chunk score trace.

    One score per 1280-sample (80 ms) chunk, the raw trace that the
    interpreter's patience and debounce filters work on. The last chunk is
    zero-padded. With `times`, the host seconds of each `predict` call are
    appended to it."""
    if audio is None:
        return np.zeros(0, np.float32)
    interpreter.reset()
    out = []
    for i in range(0, len(audio), CHUNK_SIZE):
        chunk = audio[i:i + CHUNK_SIZE]
        if len(chunk) < CHUNK_SIZE:
            chunk = np.concatenate(
                [chunk, np.zeros(CHUNK_SIZE - len(chunk), chunk.dtype)])
        t0 = time.perf_counter()
        out.append(interpreter.predict(chunk.astype(np.int16)).get(key, 0.0))
        if times is not None:
            times.append(time.perf_counter() - t0)
    return np.asarray(out, np.float32)


def max_stream_score(interpreter, audio, key):
    """Stream a clip; return the maximum score seen."""
    scores = stream_scores(interpreter, audio, key)
    return float(scores.max()) if len(scores) else 0.0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", required=True)
    parser.add_argument("--positive", required=True)
    parser.add_argument("--negative", required=True)
    parser.add_argument("--noise", default=None)
    parser.add_argument("--threshold", type=float, default=0.90)
    parser.add_argument("--max-samples", type=int, default=5000)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    print("-" * 60)
    if not os.path.exists(args.model):
        sys.exit(f"Error: Model not found at '{args.model}'")
    interpreter = NanoInterpreter.load_model(args.model, device=args.device)
    key = list(interpreter.models.keys())[0]
    print(f"Model '{os.path.basename(args.model)}' loaded; "
          f"wakeword key: '{key}'; threshold: {args.threshold}")
    print("-" * 60)

    print("\n>>> STEP 1: POSITIVE samples (misses)...")
    positive_files = get_limited_files(args.positive, args.max_samples)
    misses = sum(
        max_stream_score(interpreter, load_audio(f), key) < args.threshold
        for f in positive_files)

    print("\n>>> STEP 2: NEGATIVE samples (false alarms)...")
    negative_files = (get_limited_files(args.negative, args.max_samples)
                      + get_limited_files(args.noise, args.max_samples))
    false_alarms = sum(
        max_stream_score(interpreter, load_audio(f), key) > args.threshold
        for f in negative_files)

    print("\n" + "=" * 60)
    print("             EVALUATION COMPLETE - FINAL REPORT")
    print("=" * 60)
    n_pos, n_neg = len(positive_files), len(negative_files)
    miss_rate = misses / n_pos * 100 if n_pos else 0.0
    fa_rate = false_alarms / n_neg * 100 if n_neg else 0.0
    print(f"Positive files: {n_pos}  missed: {misses}  "
          f"success rate: {100 - miss_rate:.2f}%")
    print(f"Negative files: {n_neg}  false alarms: {false_alarms}  "
          f"correct rejection rate: {100 - fa_rate:.2f}%")
    print("=" * 60)


if __name__ == "__main__":
    main()
