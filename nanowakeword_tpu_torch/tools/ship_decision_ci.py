"""Paired-bootstrap confidence interval for the encoder ship decision.

The port of `tools/ship_decision_ci.py`. The corpus-scaling ladder decided
v4 (= rung L4) over the previously shipped v3 by ship_score 0.7899 vs
0.7625 (campaign/encoder_ladder/ladder.json), point estimates with no error
bar. Every rung is scored on the same seeded eval draw, so the comparison
is paired at the minimal-pair level: this tool synthesizes the shared
96-pair eval once per channel (the seeds and math of
train/pretrain_encoder.confusable_pair_accuracy: per-word clip seed
9003 + 37*i, enroll 3 / test 3, cosine-nearest of the pair's two
centroids), embeds the clips with both encoders on `--device` (the mel
kernel in bf16 mode, then the encoder), and bootstrap-resamples pairs to
put a CI and a P(v4 <= v3) on the ship_score difference.

The pair set excludes v4's 3072-word training vocab; sample_vocab is
sequential-deterministic, so v3's 1536-word vocab is a prefix of it and
the set is disjoint from both models' training words.

`reproduces_L4_eval` checks v4's per-channel accuracies on this set
against the recorded campaign/encoder_ladder/L4_eval.json to 1e-9. That
record was measured by the JAX package, whose bf16 log-mel sums in float32;
the port's sums in float64 (ROADMAP, deliberate differences), so a test
clip whose two centroid similarities nearly tie may fall the other way.
The report states the flag as measured, and beside it the trials closest
to a tie (`closest_trials`: channel, pair, margin), where a flip would be.

ship_score = mean(resonator_pair_acc, heldout_fx_pair_acc), fx = mean
of the formant_fx / resonator_fx chains (the ladder's ex-ante criterion,
tools/encoder_ladder.py).

Usage:
    python -m nanowakeword_tpu_torch.tools.ship_decision_ci --out ci.json \\
        [--pairs 96] [--boot 10000] [--a NAME=PATH] [--b NAME=PATH] \\
        [--device cuda|cpu]
"""

import argparse
import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

N_ENROLL = 3
N_TEST = 3
CLIP_SAMPLES = 24000
PAIR_SEED = 9003          # confusable_pair_accuracy's synthesis seed
CHANNELS = ("resonator", "formant_fx", "resonator_fx")
N_CLOSEST = 10            # trials listed nearest a tie, per channel


def _pair_sims(embed_fn, params, clips, n_pairs):
    """[P, 2, N_TEST, 2] cosine similarities of each test clip to its
    pair's two centroids, by the metric's exact centroid math."""
    from nanowakeword_tpu_torch.models.embedding import EMBEDDING_DIM

    vecs = []
    chunk = 384                        # the JAX tool's upload size
    for i in range(0, len(clips), chunk):
        vecs.append(np.asarray(embed_fn(params, clips[i:i + chunk])))
    vecs = np.concatenate(vecs)
    vecs /= np.maximum(np.linalg.norm(vecs, axis=-1, keepdims=True), 1e-8)
    vecs = vecs.reshape(n_pairs, 2, N_ENROLL + N_TEST, EMBEDDING_DIM)

    centroids = vecs[:, :, :N_ENROLL].mean(axis=2)
    centroids /= np.maximum(
        np.linalg.norm(centroids, axis=-1, keepdims=True), 1e-8)
    test = vecs[:, :, N_ENROLL:]
    return np.einsum("pwte,pce->pwtc", test, centroids)


def _outcomes(sims, n_pairs):
    pred = sims.argmax(axis=-1)
    truth = np.broadcast_to(np.arange(2)[None, :, None], pred.shape)
    return (pred == truth).reshape(n_pairs, -1).mean(axis=1)


def per_pair_outcomes(embed_fn, params, clips, n_pairs):
    """[P] per-pair accuracy from the metric's exact centroid math.
    `embed_fn(params, clips)` -> [N, 96] pooled embeddings."""
    return _outcomes(_pair_sims(embed_fn, params, clips, n_pairs), n_pairs)


def closest_trials(sims, pairs, channel, n=N_CLOSEST):
    """The `n` test clips whose two centroid similarities are nearest a
    tie: [{channel, pair, word, trial, margin}], margin = true centroid's
    similarity minus the other's (negative: a miss)."""
    margin = np.stack([sims[:, 0, :, 0] - sims[:, 0, :, 1],
                       sims[:, 1, :, 1] - sims[:, 1, :, 0]], axis=1)
    order = np.argsort(np.abs(margin), axis=None)[:n]
    out = []
    for flat in order:
        p, w, t = np.unravel_index(flat, margin.shape)
        out.append({"channel": channel, "pair": list(pairs[p]),
                    "word": pairs[p][w], "trial": int(t),
                    "margin": float(margin[p, w, t])})
    return out


def make_embed(device):
    """The tool's embed function: `embed_pooled` of the port's
    pretraining module (the bf16-mode log-mel by the kernel on a CUDA
    device, the encoder, the mean over frames)."""
    from nanowakeword_tpu_torch.train.pretrain_encoder import embed_pooled

    def embed(params, audio):
        return embed_pooled(params, np.asarray(audio, np.float32), device)
    return embed


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pairs", type=int, default=96)
    p.add_argument("--boot", type=int, default=10000)
    p.add_argument("--a", default=None, metavar="NAME=PATH",
                   help="baseline asset (default v3=<bundled v3>)")
    p.add_argument("--b", default=None, metavar="NAME=PATH",
                   help="candidate asset (default v4=<bundled v4>)")
    p.add_argument("--out", required=True,
                   help="path of the report JSON to write")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    report = ship_decision(args.pairs, args.boot, args.a, args.b,
                           args.device)
    print(json.dumps(report, indent=1))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[ci] written to {args.out}", flush=True)


def ship_decision(n_pairs=96, boot=10000, a=None, b=None, device="cuda"):
    """The report `main` writes, for `n_pairs` shared pairs and `boot`
    resamples, assets `a` and `b` as NAME=PATH (default the bundled v3 and
    v4), embeddings on `device`."""
    from nanowakeword_tpu_torch import assets
    from nanowakeword_tpu_torch.models.embedding import infer_encoder_arch
    from nanowakeword_tpu_torch.train.pretrain_encoder import (
        make_confusable_pairs, sample_training_vocab,
        synthesize_word_variants)
    from nanowakeword_tpu_torch.utils.flax_msgpack import read_msgpack_file

    def parse_asset(spec, default_name, default_path):
        if spec is None:
            return default_name, default_path
        name, _, path = spec.partition("=")
        return name, path

    name_a, path_a = parse_asset(a, "v3", assets.SPEECH_ENCODER_V3)
    name_b, path_b = parse_asset(b, "v4", assets.SPEECH_ENCODER_V4)
    paths = {name_a: path_a, name_b: path_b}
    enc_vars = {name: read_msgpack_file(path)
                for name, path in paths.items()}
    # one embed for both assets: the comparison needs one geometry
    arch_a, arch_b = (infer_encoder_arch(enc_vars[n]) for n in paths)
    if arch_a != arch_b:
        raise ValueError(f"{name_a} is {arch_a}, {name_b} is {arch_b}: "
                         "the paired comparison needs one geometry")
    embed = make_embed(device)

    # the ladder's eval draw: exclude v4's 3072-word vocab (v3's 1536 is a
    # deterministic prefix of it -> disjoint from both models' training)
    train_words = sample_training_vocab(3072, seed=10,
                                        confusable_fraction=0.5)
    pairs = make_confusable_pairs(n_pairs, seed=515151, exclude=train_words)
    words = [w for pair in pairs for w in pair]

    outcomes = {name: {} for name in paths}
    accs = {name: {} for name in paths}
    closest = []
    for channel in CHANNELS:
        print(f"[ci] synthesizing {len(words)} words x "
              f"{N_ENROLL + N_TEST} variants on {channel}", flush=True)
        clips = np.concatenate([
            synthesize_word_variants(w, N_ENROLL + N_TEST, CLIP_SAMPLES,
                                     seed=PAIR_SEED + 37 * i,
                                     channel=channel)
            for i, w in enumerate(words)]).astype(np.float32)
        for name in paths:
            sims = _pair_sims(embed, enc_vars[name], clips, len(pairs))
            o = _outcomes(sims, len(pairs))
            outcomes[name][channel] = o
            accs[name][channel] = float(o.mean())
            if name == name_b:
                closest += closest_trials(sims, pairs, channel)
            print(f"[ci]   {name} {channel}: {o.mean():.4f}", flush=True)

    def ship_vector(name):
        o = outcomes[name]
        fx = (o["formant_fx"] + o["resonator_fx"]) / 2.0
        return (o["resonator"] + fx) / 2.0          # [P]

    s_a, s_b = ship_vector(name_a), ship_vector(name_b)
    rng = np.random.default_rng(20260820)
    idx = rng.integers(0, len(s_a), (boot, len(s_a)))
    deltas = (s_b[idx] - s_a[idx]).mean(axis=1)
    report = {
        "criterion": "ship_score = mean(resonator_pair_acc, "
                     "heldout_fx_pair_acc); paired bootstrap over the "
                     f"{len(pairs)} shared eval pairs, {boot} resamples",
        "accs": accs,
        "ship_score": {name_a: float(s_a.mean()), name_b: float(s_b.mean())},
        f"delta_{name_b}_minus_{name_a}": float(s_b.mean() - s_a.mean()),
        "delta_ci95": [float(np.percentile(deltas, 2.5)),
                       float(np.percentile(deltas, 97.5))],
        f"p_{name_b}_le_{name_a}": float((deltas <= 0.0).mean()),
        "note": "all ladder evals share this seeded pair draw, so recorded "
                "per-channel accuracies reproduce exactly when an asset's "
                "own vocab exclusion drew the same pairs",
        "device": device if str(device) == "cpu" else _card_name(),
    }

    # integrity check against the committed ladder record (v4 == rung L4)
    if name_b == "v4":
        with open(os.path.join(REPO, "campaign", "encoder_ladder",
                               "L4_eval.json")) as f:
            l4 = json.load(f)
        if n_pairs == l4["n_confusable_pairs"]:
            rec_fx = (accs["v4"]["formant_fx"]
                      + accs["v4"]["resonator_fx"]) / 2
            report["reproduces_L4_eval"] = bool(
                abs(accs["v4"]["resonator"] - l4["resonator_pair_acc"]) < 1e-9
                and abs(rec_fx - l4["heldout_fx_pair_acc"]) < 1e-9)
            trials = n_pairs * 2 * N_TEST
            report["L4_eval_trials_apart"] = {
                "resonator": round((accs["v4"]["resonator"]
                                    - l4["resonator_pair_acc"]) * trials, 6),
                "heldout_fx (sum of both chains)": round(
                    (rec_fx - l4["heldout_fx_pair_acc"]) * 2 * trials, 6)}
    report["closest_trials"] = sorted(closest,
                                      key=lambda t: abs(t["margin"]))
    return report


def _card_name() -> str:
    import torch
    return torch.cuda.get_device_name(0)


if __name__ == "__main__":
    main()
