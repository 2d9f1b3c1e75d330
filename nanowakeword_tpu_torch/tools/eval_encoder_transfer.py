"""Cross-channel transfer evaluation for a pretrained speech encoder.

The port of `tools/eval_encoder_transfer.py`: the harness behind the
shipped asset's sidecar numbers, unseen-word centroid identification and
confusable minimal-pair discrimination on the formant channel, the
resonator channel and the held-out telephone-EQ/reverb/clip fx chains
(`train/pretrain_encoder.evaluate_transfer`), with the embeddings (the mel
kernel, then the encoder) on `--device`.

Usage:
    python -m nanowakeword_tpu_torch.tools.eval_encoder_transfer \\
        [ASSET.msgpack] [--words 48] [--pairs 96] [--vocab 1536] \\
        [--baseline] [--out r.json] [--device cuda|cpu]

ASSET defaults to the bundled asset. --vocab must match the asset's
training vocabulary so eval words are sampled disjoint from it (the
sidecar records vocab_size). The 48/96 defaults are the LARGE eval
(576 pair trials per channel, ~0.02 resolution); the build-time eval
uses 24/24 (~0.04 resolution). The random baseline is drawn from a torch
generator (ROADMAP, deliberate differences), so its numbers differ from the
JAX tool's.
"""

import argparse
import json
import os
import sys


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("asset", nargs="?", default=None,
                   help=".msgpack encoder asset (default: bundled)")
    p.add_argument("--words", type=int, default=48)
    p.add_argument("--pairs", type=int, default=96)
    p.add_argument("--vocab", type=int, default=None,
                   help="training vocab size to exclude "
                        "(default: the asset sidecar's vocab_size)")
    p.add_argument("--baseline", action="store_true",
                   help="also score a random-init encoder")
    p.add_argument("--out", default=None, help="write the report JSON here")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    from nanowakeword_tpu_torch.assets import speech_encoder_asset_path
    from nanowakeword_tpu_torch.train.pretrain_encoder import (
        evaluate_transfer, sample_training_vocab)
    from nanowakeword_tpu_torch.utils.flax_msgpack import read_msgpack_file

    asset = args.asset or speech_encoder_asset_path()
    if not asset or not os.path.exists(asset):
        sys.exit(f"encoder asset not found: {asset!r}")
    enc_vars = read_msgpack_file(asset)

    vocab = args.vocab
    if vocab is None:
        sidecar = asset + ".json"
        vocab = 1536
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                vocab = json.load(f).get("vocab_size", 1536)
    train_words = sample_training_vocab(int(vocab), seed=10,
                                        confusable_fraction=0.5)

    report = evaluate_transfer(enc_vars, train_words,
                               n_words=args.words, n_pairs=args.pairs,
                               with_random_baseline=args.baseline,
                               cross_channel=True, verbose=False,
                               device=args.device)
    report["asset"] = os.path.abspath(asset)
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
