"""Record background noise from the microphone for the noise dataset.

The port of `tools/record_noise.py`, the upstream project's tool, on the
port's audio_io. Requires pyaudio.

Usage: python -m nanowakeword_tpu_torch.tools.record_noise OUT_DIR \
           [--seconds 30] [--clips 10]
"""

import argparse
import os
import sys
import time

import numpy as np

from nanowakeword_tpu_torch.utils.audio_io import write_wav

SR = 16000
CHUNK = 1280


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("output_dir")
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--clips", type=int, default=1)
    args = parser.parse_args(argv)

    try:
        import pyaudio
    except ImportError:
        sys.exit("pyaudio is required: pip install pyaudio")

    os.makedirs(args.output_dir, exist_ok=True)
    pa = pyaudio.PyAudio()
    stream = pa.open(format=pyaudio.paInt16, channels=1, rate=SR, input=True,
                     frames_per_buffer=CHUNK)
    try:
        for c in range(args.clips):
            print(f"Recording clip {c + 1}/{args.clips} "
                  f"({args.seconds:.0f}s)...")
            frames = []
            n_chunks = int(args.seconds * SR / CHUNK)
            for _ in range(n_chunks):
                frames.append(np.frombuffer(
                    stream.read(CHUNK, exception_on_overflow=False),
                    np.int16))
            audio = np.concatenate(frames)
            path = os.path.join(args.output_dir,
                                f"noise_{int(time.time())}_{c:03d}.wav")
            write_wav(path, audio)
            print(f"  saved {path}")
    finally:
        stream.stop_stream()
        stream.close()
        pa.terminate()


if __name__ == "__main__":
    main()
