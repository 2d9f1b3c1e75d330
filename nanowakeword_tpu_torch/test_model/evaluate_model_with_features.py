"""Model-only evaluation over precomputed feature files, with model ranking.

The port of `test_model/evaluate_model_with_features.py` (the upstream
project's evaluator): batched scoring of .npy feature sets for several
models on `--device`, a misses / false-alarms table ranked by total error,
with a fallback to batch 1 when batched scoring fails.

Usage:
    python -m nanowakeword_tpu_torch.test_model.evaluate_model_with_features \\
        --models a.nww b.onnx --positive pos_features.npy \\
        --negative neg_features.npy [--threshold 0.5] [--batch 328] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nanowakeword_tpu_torch.export.artifact import load_nww
from nanowakeword_tpu_torch.interpreter.nanointerpreter import _LocalSession


def _load_scorer(model_path, device):
    """-> (run_batch fn, feature_length). Takes `.nww` artifacts (scored by
    `_LocalSession.run_batch`) and exported `.onnx` graphs (the upstream
    script's model format, run as torch ops by export/onnx_torch.py)."""
    if model_path.endswith(".onnx"):
        from nanowakeword_tpu_torch.export.onnx_torch import OnnxTorchModel
        m = OnnxTorchModel(model_path, device=device)

        def run_batch(b):
            # a graph with a fixed batch of 1 raises here; the caller's
            # batch-1 fallback (the upstream behaviour) takes over
            return m(np.asarray(b, np.float32)).reshape(-1)

        return run_batch, int(m.input_shape[1])

    header, model, _ = load_nww(model_path, device=device)
    session = _LocalSession(model, header)
    return session.run_batch, session.feature_length


def score_features(run_batch, features, batch_size):
    """Batched sigmoid scores with fallback to batch 1 on failure."""
    out = []
    try:
        for i in range(0, len(features), batch_size):
            out.append(run_batch(features[i:i + batch_size]))
    except Exception as e:  # noqa: BLE001
        print(f"Batched scoring failed ({e}); retrying with batch size 1.")
        out = [run_batch(features[i:i + 1]) for i in range(len(features))]
    return np.concatenate(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--models", nargs="+", required=True)
    parser.add_argument("--positive", required=True)
    parser.add_argument("--negative", required=True)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--batch", type=int, default=328)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    pos = np.load(args.positive, mmap_mode="r")
    neg = np.load(args.negative, mmap_mode="r")
    print(f"Positive features: {pos.shape}; negative features: {neg.shape}")

    results = []
    for model_path in args.models:
        name = os.path.splitext(os.path.basename(model_path))[0]
        run_batch, T = _load_scorer(model_path, args.device)
        pos_t = np.array(pos[:, :T], np.float32)
        neg_t = np.array(neg[:, :T], np.float32)
        pos_scores = score_features(run_batch, pos_t, args.batch)
        neg_scores = score_features(run_batch, neg_t, args.batch)
        misses = int((pos_scores < args.threshold).sum())
        fas = int((neg_scores > args.threshold).sum())
        results.append((name, misses, fas, misses + fas))

    results.sort(key=lambda r: r[3])
    print("\n{:<32} {:>8} {:>12} {:>8}".format(
        "Model", "Misses", "FalseAlarms", "Total"))
    print("-" * 64)
    for name, misses, fas, total in results:
        print(f"{name:<32} {misses:>8} {fas:>12} {total:>8}")


if __name__ == "__main__":
    main()
