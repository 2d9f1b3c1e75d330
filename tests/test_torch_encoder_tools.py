"""The port's encoder decision tools against the JAX package's, on the CPU:

- `ship_decision_ci.per_pair_outcomes`: the same centroid math as the JAX
  tool's on the same embeddings, and the same outcomes from the port's
  embedding (bf16-mode log-mel, the v4 encoder) as from the JAX tool's
  (bf16 XLA log-mel, the same encoder) on a few shared pairs; the report
  of `ship_decision` at a cut pair count;
- `eval_encoder_transfer.main` prints the JAX tool's report at a cut size;
- `encoder_ladder`: `ship_score`, the rungs' command lines, and the
  ladder record merged as the JAX tool merges it.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from nanowakeword_tpu_torch import assets
from nanowakeword_tpu_torch.tools import encoder_ladder as ladder
from nanowakeword_tpu_torch.tools import ship_decision_ci as ci
from nanowakeword_tpu_torch.train import pretrain_encoder as PE
from nanowakeword_tpu_torch.utils.flax_msgpack import read_msgpack_file

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port on the CPU while this module runs:
    its streaming step is hundreds of tiny ops, which run 2-3x slower on 8
    threads when other test processes share the cores."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_script(relpath: str):
    name = "jax_script_" + relpath.replace("/", "_").replace(".py", "")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, REPO / relpath)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def test_per_pair_outcomes_math_matches_jax():
    """Both tools' centroid math on the same (fake) embeddings."""
    jax_ci = _jax_script("tools/ship_decision_ci.py")
    n_pairs = 7
    clips = np.random.default_rng(4).normal(
        0, 1, (n_pairs * 2 * 6, 200)).astype(np.float32)

    def embed(params, audio):
        return np.asarray(audio)[:, :96] * params

    ours = ci.per_pair_outcomes(embed, 1.0, clips, n_pairs)
    ref = jax_ci.per_pair_outcomes(embed, 1.0, clips, n_pairs)
    np.testing.assert_array_equal(ours, ref)
    assert 0.0 < ours.mean() < 1.0


@pytest.fixture(scope="module")
def shared_pairs():
    """4 pairs of the ladder's eval draw on the resonator channel."""
    train_words = PE.sample_training_vocab(3072, seed=10,
                                           confusable_fraction=0.5)
    pairs = PE.make_confusable_pairs(4, seed=515151, exclude=train_words)
    words = [w for pair in pairs for w in pair]
    clips = np.concatenate([
        PE.synthesize_word_variants(w, 6, ci.CLIP_SAMPLES,
                                    seed=ci.PAIR_SEED + 37 * i,
                                    channel="resonator")
        for i, w in enumerate(words)]).astype(np.float32)
    return pairs, clips


def test_per_pair_outcomes_match_jax_on_shared_pairs(shared_pairs):
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from nanowakeword_tpu.data.features import EMB_OFFSET
    from nanowakeword_tpu.models.embedding import (build_encoder,
                                                   infer_encoder_arch)
    from nanowakeword_tpu.ops import mel as melops
    jax_ci = _jax_script("tools/ship_decision_ci.py")
    pairs, clips = shared_pairs
    with open(assets.SPEECH_ENCODER_V4, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    encoder = build_encoder(infer_encoder_arch(params))

    @jax.jit
    def jax_embed(params, audio):
        mel = melops.mel_frontend(audio, compute_dtype=jnp.bfloat16)
        return encoder.apply(params, mel[:, EMB_OFFSET:]).mean(axis=1)

    ref = jax_ci.per_pair_outcomes(jax_embed, params, clips, len(pairs))
    port_params = read_msgpack_file(assets.SPEECH_ENCODER_V4)
    embed = ci.make_embed("cpu")
    ours = ci.per_pair_outcomes(embed, port_params, clips, len(pairs))
    sims = ci._pair_sims(embed, port_params, clips, len(pairs))
    closest = ci.closest_trials(sims, pairs, "resonator", n=3)
    print(f"outcomes {ours}; closest trials {closest}")
    np.testing.assert_array_equal(ours, ref)
    # a trial's margin is positive exactly where it was classified right
    margins = np.stack([sims[:, 0, :, 0] - sims[:, 0, :, 1],
                        sims[:, 1, :, 1] - sims[:, 1, :, 0]], axis=1)
    np.testing.assert_array_equal((margins > 0).reshape(len(pairs), -1)
                                  .mean(axis=1), ours)
    assert abs(closest[0]["margin"]) <= abs(closest[-1]["margin"])


def test_ship_decision_report_at_cut_size(tmp_path):
    out = tmp_path / "ci.json"
    ci.main(["--pairs", "3", "--boot", "200", "--out", str(out),
             "--device", "cpu"])
    report = json.loads(out.read_text())
    assert set(report["accs"]) == {"v3", "v4"}
    assert set(report["accs"]["v4"]) == set(ci.CHANNELS)
    assert report["device"] == "cpu"
    lo, hi = report["delta_ci95"]
    assert lo <= report["delta_v4_minus_v3"] <= hi
    # the L4 record is checked only at its own pair count (96)
    assert "reproduces_L4_eval" not in report
    assert len(report["closest_trials"]) == len(ci.CHANNELS) * ci.N_CLOSEST


def test_ship_decision_needs_out():
    with pytest.raises(SystemExit):
        ci.main(["--pairs", "3"])


def test_eval_encoder_transfer_matches_jax(tmp_path, monkeypatch, capsys):
    argv = ["--words", "2", "--pairs", "2"]
    monkeypatch.setattr(sys, "argv", ["eval_encoder_transfer.py", *argv,
                                      "--out", str(tmp_path / "jax.json")])
    _jax_script("tools/eval_encoder_transfer.py").main()
    from nanowakeword_tpu_torch.tools import eval_encoder_transfer
    eval_encoder_transfer.main([*argv, "--out", str(tmp_path / "port.json"),
                                "--device", "cpu"])
    ours = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert Path(ours.pop("asset")).name == Path(ref.pop("asset")).name
    assert ours == ref
    assert ours["n_confusable_pairs"] == 2


@pytest.mark.parametrize("report", [
    {"resonator_pair_acc": 0.82, "heldout_fx_pair_acc": 0.75,
     "confusable_pair_acc": 0.87},
    {"resonator_pair_acc": 0.9, "heldout_fx_pair_acc": 0.8,
     "confusable_pair_acc": 0.79},
])
def test_ship_score_matches_jax(report):
    jax_ladder = _jax_script("tools/encoder_ladder.py")
    assert ladder.ship_score(report) == jax_ladder.ship_score(report)
    assert ladder.RUNGS == jax_ladder.RUNGS
    assert ladder.RECORDED == jax_ladder.RECORDED


def test_rung_command_lines(tmp_path, capsys):
    asset, result, (pretrain, evaluate) = ladder.rung_commands(
        "L4", ladder.RUNGS["L4"], 12000, str(tmp_path), "/cache", "cuda")
    assert asset == str(tmp_path / "L4.msgpack")
    assert result == str(tmp_path / "L4_eval.json")
    assert pretrain[1:3] == ["-m",
                             "nanowakeword_tpu_torch.train.pretrain_encoder"]
    args = dict(zip(pretrain[3::2], pretrain[4::2]))
    assert args == {"--out": asset, "--vocab": "3072", "--variants": "48",
                    "--channels": "union", "--arch": "wide128",
                    "--steps": "12000", "--contrastive": "0.5",
                    "--cache": "/cache/corpus_L4.npz", "--device": "cuda"}
    assert evaluate[1:4] == ["-m",
                             "nanowakeword_tpu_torch.tools."
                             "eval_encoder_transfer", asset]
    assert dict(zip(evaluate[4::2], evaluate[5::2])) == {
        "--words": "48", "--pairs": "96", "--out": result,
        "--device": "cuda"}
    # the port's entry points take every flag of the rung's commands
    for command, main in ((pretrain, PE.main), (evaluate, _transfer_main())):
        with pytest.raises(SystemExit):
            main(["--help"])
        text = capsys.readouterr().out
        for flag in command:
            assert not flag.startswith("--") or flag in text, flag


def _transfer_main():
    from nanowakeword_tpu_torch.tools import eval_encoder_transfer
    return eval_encoder_transfer.main


def _fake_run(results):
    """A `run` that writes what each rung's two commands would."""
    def run(cmd, env=None):
        if "--words" in cmd:            # the transfer eval
            out = cmd[cmd.index("--out") + 1]
            name = Path(out).name.replace("_eval.json", "")
            Path(out).write_text(json.dumps(results[name]))
        else:
            Path(cmd[cmd.index("--out") + 1]).write_bytes(b"asset")
    return run


def test_ladder_record_merges_as_jax(tmp_path, monkeypatch):
    results = {
        "L1": {"resonator_pair_acc": 0.80, "heldout_fx_pair_acc": 0.74,
               "confusable_pair_acc": 0.85},
        "L2": {"resonator_pair_acc": 0.83, "heldout_fx_pair_acc": 0.70,
               "confusable_pair_acc": 0.86},
        "L4": {"resonator_pair_acc": 0.90, "heldout_fx_pair_acc": 0.80,
               "confusable_pair_acc": 0.79},
    }
    jax_ladder = _jax_script("tools/encoder_ladder.py")
    monkeypatch.setattr(jax_ladder, "run", _fake_run(results))
    monkeypatch.setattr(ladder, "run", _fake_run(results))
    for rungs in ("L1,L2", "L4"):
        monkeypatch.setattr(sys, "argv", [
            "encoder_ladder.py", "--rungs", rungs, "--workdir",
            str(tmp_path / "jax"), "--cachedir", str(tmp_path / "c")])
        jax_ladder.main()
        ladder.main(["--rungs", rungs, "--workdir", str(tmp_path / "port"),
                     "--cachedir", str(tmp_path / "c"), "--device", "cpu"])
    ours = json.loads((tmp_path / "port" / "ladder.json").read_text())
    ref = json.loads((tmp_path / "jax" / "ladder.json").read_text())
    for record in (ours, ref):
        record.pop("criterion")
        record["decision"].pop("note")
        for rung in record["rungs"].values():
            rung.pop("wall_seconds_total")
    assert ours == ref
    assert ours["decision"]["winner"] == "L1"     # L4 misses the floor


def test_ladder_needs_workdir():
    with pytest.raises(SystemExit):
        ladder.main(["--rungs", "L1"])
