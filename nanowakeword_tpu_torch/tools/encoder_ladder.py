"""Corpus-scaling ladder for the pretrained speech encoder.

The port of `tools/encoder_ladder.py`; each rung pretrains with
`python -m nanowakeword_tpu_torch.train.pretrain_encoder` and scores with
`python -m nanowakeword_tpu_torch.tools.eval_encoder_transfer`, both on
`--device`.

EX-ANTE SHIP CRITERION, fixed before any rung runs:

    ship_score = mean(resonator_pair_acc, heldout_fx_pair_acc)
                 on the LARGE eval (48 unseen words / 96 confusable pairs),
    subject to confusable_pair_acc (formant, in-domain) >= 0.80.

The two transfer channels are the only honest proxy for real-world use;
the in-domain number is a FLOOR, not a tiebreaker.
heldout_fx_pair_acc is the mean of formant_fx and resonator_fx, so scores
stay comparable to the recorded v3-v8 numbers.

Recorded baselines (large eval; formant/resonator/fx pair acc):

    v3 shipped : 0.844 / 0.792 / 0.733 -> score 0.7625  (no supcon)
    v6         : 0.830 / 0.811 / 0.741 -> score 0.7760  (supcon 0.5)

Rungs: v6's recipe (supcon 0.5, wide128, 12k steps, batch 256) with one
corpus axis scaled each (RUNGS below: vocabulary, speakers, channels, and
L4 / L5 combining them).

Usage:
    python -m nanowakeword_tpu_torch.tools.encoder_ladder --workdir DIR \\
        [--rungs L1,L2,L3,v6r] [--steps 12000] [--cachedir DIR] \\
        [--device cuda|cpu]

Each rung synthesizes its corpus (cached under --cachedir, by default
`encoder_ladder` in the temporary directory: reproducible from seeds, too
large to commit), trains, runs the large transfer eval, and merges into
<workdir>/ladder.json. Rungs with an existing result are skipped, so the
ladder is resumable. --workdir is required: the port writes nothing into
the repository's campaign/encoder_ladder/.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

RUNGS = {
    "L1": dict(vocab=3072, variants=24, channels="union"),
    "L2": dict(vocab=1536, variants=48, channels="union"),
    "L3": dict(vocab=1536, variants=24, channels="union3"),
    "v6r": dict(vocab=1536, variants=24, channels="union"),
    # both winning axes together (L1 vocab x L2 speakers)
    "L4": dict(vocab=3072, variants=48, channels="union"),
    # the third channel at matched per-channel variants on the L4 recipe:
    # 24/channel x 3 channels = 72 variants
    "L5": dict(vocab=3072, variants=72, channels="union3"),
}

RECORDED = {   # large-eval numbers of the earlier encoders (their sidecars)
    "v3": {"confusable_pair_acc": 0.844, "resonator_pair_acc": 0.792,
           "heldout_fx_pair_acc": 0.733},
    "v6": {"confusable_pair_acc": 0.830, "resonator_pair_acc": 0.811,
           "heldout_fx_pair_acc": 0.741},
}

IN_DOMAIN_FLOOR = 0.80


def ship_score(report: dict):
    """(score, floor_ok) under the ex-ante criterion above."""
    score = (report["resonator_pair_acc"]
             + report["heldout_fx_pair_acc"]) / 2.0
    return score, report["confusable_pair_acc"] >= IN_DOMAIN_FLOOR


def rung_commands(name, spec, steps, workdir, cachedir, device):
    """-> (asset path, result path, [pretrain command, eval command])."""
    asset = os.path.join(workdir, f"{name}.msgpack")
    result = os.path.join(workdir, f"{name}_eval.json")
    pretrain = [sys.executable, "-m",
                "nanowakeword_tpu_torch.train.pretrain_encoder",
                "--out", asset, "--vocab", str(spec["vocab"]),
                "--variants", str(spec["variants"]),
                "--channels", spec["channels"], "--arch", "wide128",
                "--steps", str(steps), "--contrastive", "0.5",
                "--cache", os.path.join(cachedir, f"corpus_{name}.npz"),
                "--device", device]
    evaluate = [sys.executable, "-m",
                "nanowakeword_tpu_torch.tools.eval_encoder_transfer", asset,
                "--words", "48", "--pairs", "96", "--out", result,
                "--device", device]
    return asset, result, [pretrain, evaluate]


def run(cmd):
    print(f"[ladder] $ {' '.join(cmd)}", flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    subprocess.run(cmd, check=True, env=env, cwd=REPO)


def run_rung(name, spec, steps, workdir, cachedir, device):
    asset, result, (pretrain, evaluate) = rung_commands(
        name, spec, steps, workdir, cachedir, device)
    if os.path.exists(result):
        print(f"[ladder] {name}: result exists, skipping", flush=True)
        with open(result) as f:
            return json.load(f)
    t0 = time.time()
    if not os.path.exists(asset):
        run(pretrain)
    run(evaluate)
    with open(result) as f:
        report = json.load(f)
    report["wall_seconds_total"] = round(time.time() - t0, 1)
    with open(result, "w") as f:
        json.dump(report, f, indent=1)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rungs", default="L1,L2,L3,v6r")
    p.add_argument("--steps", type=int, default=12000)
    p.add_argument("--workdir", required=True,
                   help="folder of the rungs' assets, results and "
                        "ladder.json")
    p.add_argument("--cachedir", default=os.path.join(
        tempfile.gettempdir(), "encoder_ladder"))
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    os.makedirs(args.cachedir, exist_ok=True)

    # read-modify-write: merge this invocation's rungs into the existing
    # record, keeping the rungs and decision notes of earlier invocations
    ladder_path = os.path.join(workdir, "ladder.json")
    ladder = {}
    prior_decision = {}
    if os.path.exists(ladder_path):
        with open(ladder_path) as f:
            existing = json.load(f)
        ladder = existing.get("rungs", {})
        prior_decision = existing.get("decision", {})
    for name in args.rungs.split(","):
        name = name.strip()
        report = run_rung(name, RUNGS[name], args.steps, workdir,
                          args.cachedir, args.device)
        score, ok = ship_score(report)
        ladder[name] = {**report, "ship_score": round(score, 4),
                        "in_domain_floor_ok": bool(ok)}
        print(f"[ladder] {name}: score={score:.4f} floor_ok={ok} "
              f"(formant {report['confusable_pair_acc']:.3f} / resonator "
              f"{report['resonator_pair_acc']:.3f} / fx "
              f"{report['heldout_fx_pair_acc']:.3f})", flush=True)
        eligible = {k: v for k, v in ladder.items()
                    if v.get("in_domain_floor_ok")}
        winner = max(eligible, key=lambda k: eligible[k]["ship_score"],
                     default=None)
        out = dict(criterion=__doc__.split("Usage:")[0],
                   recorded={k: {**v, "ship_score": round(
                       (v["resonator_pair_acc"]
                        + v["heldout_fx_pair_acc"]) / 2, 4)}
                       for k, v in RECORDED.items()},
                   rungs=ladder)
        if winner is not None:
            # keep hand-recorded decision extras; regenerate the note only
            # if the winner changed
            out["decision"] = {
                **prior_decision,
                "winner": winner,
                "ship_score": ladder[winner]["ship_score"],
            }
            if prior_decision.get("winner") != winner \
                    or "note" not in prior_decision:
                out["decision"]["note"] = (
                    f"{winner} leads all floor-passing rungs under the "
                    "ex-ante criterion; recorded v3 scores 0.7625")
        with open(ladder_path, "w") as f:
            json.dump(out, f, indent=1)
    print("[ladder] done", flush=True)


if __name__ == "__main__":
    main()
