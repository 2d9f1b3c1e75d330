"""Minimal wake-word recognition from the microphone.

The port of `examples/recognize_from_mic.py` (the upstream project's
example): load a model on `--device`, stream 80 ms chunks, print
detections. Requires pyaudio; without it `listen()` raises its
ImportError.

Usage: python -m nanowakeword_tpu_torch.examples.recognize_from_mic \\
           --model my_model.nww [--threshold 0.95] [--cascade] [--vad 0.5] \\
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from nanowakeword_tpu_torch import NanoInterpreter


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", required=True,
                        help="Path to the .nww model artifact")
    parser.add_argument("--threshold", type=float, default=0.95)
    parser.add_argument("--cascade", action="store_true",
                        help="Use the _lite gate model if present")
    parser.add_argument("--vad", type=float, default=0.0,
                        help="VAD gate threshold (0 disables)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    interpreter = NanoInterpreter.load_model(
        args.model, cascade=args.cascade, vad_threshold=args.vad,
        device=args.device)

    def on_detection(name, score):
        print(f"\n  >>> Wake word '{name}' detected!  (score {score:.4f})")

    def on_score(verifier, gate):
        if interpreter.is_cascade:
            print(f"  gate={gate:.3f}  verifier={verifier:.4f}   ", end="\r")
        else:
            print(f"  score={verifier:.4f}   ", end="\r")

    print(f"Listening for '{interpreter.model_name}' "
          f"(threshold {args.threshold}). Ctrl+C to stop.")
    interpreter.listen(on_detection=on_detection, on_score=on_score,
                       threshold=args.threshold)


if __name__ == "__main__":
    main()
