"""Minimal live microphone smoke test.

The port of `test_model/nww_model_test_from_mic.py` (the upstream
project's script): open the default microphone, stream 1280-sample chunks
through the port's interpreter on `--device`, and print scores. Requires
pyaudio; without it `listen()` raises its ImportError.

Usage: python -m nanowakeword_tpu_torch.test_model.nww_model_test_from_mic \\
           --model my_model.nww [--threshold 0.5] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from nanowakeword_tpu_torch import NanoInterpreter


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", required=True)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    interpreter = NanoInterpreter.load_model(args.model, device=args.device)
    print(f"Listening for '{interpreter.model_name}' "
          f"(threshold {args.threshold}). Ctrl+C to stop.")
    interpreter.listen(
        threshold=args.threshold,
        on_score=lambda v, g: print(f"score={v:.4f}", end="\r"),
    )


if __name__ == "__main__":
    main()
