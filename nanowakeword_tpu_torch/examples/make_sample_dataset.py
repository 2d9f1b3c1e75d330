"""Create the tiny sample dataset used by the quickstart walkthrough.

The port of `examples/make_sample_dataset.py`: a 4-class miniature
dataset (positive, positive_val, negative, noise) made by the port's
built-in formant synthesizer, no downloads, the same WAV bytes as the
JAX package's script. The output folder is required: the port writes
nothing into the repository's `examples/`.

    python -m nanowakeword_tpu_torch.examples.make_sample_dataset OUT_DIR
"""

import argparse
import os

import numpy as np

from nanowakeword_tpu_torch.data.generator.tts import formant_synthesize
from nanowakeword_tpu_torch.utils.audio_io import write_wav


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out", help="folder to write the dataset into")
    out = parser.parse_args(argv).out
    rng = np.random.default_rng(10)
    layout = {
        "positive": [("hey nano", i) for i in range(8)],
        "positive_val": [("hey nano", 100 + i) for i in range(4)],
        "negative": [("ok tomato", 200 + i) for i in range(6)]
        + [("hay mono over there", 300 + i) for i in range(6)],
        "noise": None,
    }
    for sub, spec in layout.items():
        d = os.path.join(out, sub)
        os.makedirs(d, exist_ok=True)
        if spec is None:
            for i in range(4):
                write_wav(os.path.join(d, f"noise_{i}.wav"),
                          rng.normal(0, 1200, 48000))
            continue
        for j, (phrase, seed) in enumerate(spec):
            audio = formant_synthesize(phrase, seed=seed,
                                       f0=float(rng.uniform(90, 210)))
            write_wav(os.path.join(d, f"{sub}_{j:03d}.wav"), audio * 32767)
    print(f"Sample dataset written to {out}")


if __name__ == "__main__":
    main()
