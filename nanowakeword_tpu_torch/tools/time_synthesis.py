"""How long encoder pretraining's host synthesis takes in one process and
in one process per CPU core, in turns (1, N, 1, N).

    python -m nanowakeword_tpu_torch.tools.time_synthesis \\
        [--vocab 128] [--variants 12] [--device cuda]

For each count it times `build_corpus` of the v4 recipe cut to `--vocab`
words x `--variants` speakers (union channels, 4 held-out variants, 240
noise clips, 64 impulses) and `evaluate_transfer` of the bundled v4
encoder (24 words, 24 pairs, cross-channel, the random baseline; the
embedding on `--device`), and prints one JSON object per run: seconds and
clips per second of each. The corpus is the same for any count
(`tests/test_torch_pretrain.py`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from nanowakeword_tpu_torch.data.features import pretrained_encoder_variables
from nanowakeword_tpu_torch.train import pretrain_encoder as PE


def run(config, workers: int, device) -> dict:
    t0 = time.perf_counter()
    corpus = PE.build_corpus(config, verbose=False, workers=workers)
    corpus_s = time.perf_counter() - t0
    clips = len(corpus["clips"]) + len(corpus["heldout_clips"])
    train_words = PE.sample_training_vocab(3072, seed=10)
    t0 = time.perf_counter()
    report = PE.evaluate_transfer(pretrained_encoder_variables(),
                                  train_words, verbose=False, device=device,
                                  workers=workers)
    transfer_s = time.perf_counter() - t0
    # 6 clips a word: 5 channels and the random baseline's formant
    transfer_clips = 6 * 6 * (report["n_transfer_words"]
                              + 2 * report["n_confusable_pairs"])
    return {"processes": workers, "corpus_s": corpus_s,
            "corpus_clips_per_s": clips / corpus_s,
            "transfer_eval_s": transfer_s,
            "transfer_clips_per_s": transfer_clips / transfer_s}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--vocab", type=int, default=128)
    parser.add_argument("--variants", type=int, default=12)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    config = PE.PretrainConfig(vocab_size=args.vocab,
                               variants_per_word=args.variants,
                               heldout_variants=4, noise_clips=240,
                               rir_clips=64, channels="union",
                               confusable_fraction=0.5)
    cores = os.cpu_count() or 1
    for workers in (1, cores, 1, cores):
        print(json.dumps(run(config, workers, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
