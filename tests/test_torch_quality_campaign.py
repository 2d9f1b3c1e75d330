"""The port's quality campaign (nanowakeword_tpu_torch/tools/
quality_campaign.py) against the JAX package's tools/quality_campaign.py,
both on the CPU:

- synthesis: `stage_prep` at cut sizes writes the same WAV bytes in every
  eval set and pool (2-3 files of each kind), and the same config, paths
  aside;
- judgement: `stage_evaluate` (full and `_lite`), `stage_sweep` and
  `stage_evaluate_cascade` of the committed `campaign/hey_nano_crnn.nww`
  cascade on those sets give the same JSON numbers and per-chunk traces
  within 1e-3 (the port's log-mel sums in float64, the JAX package's in
  float32, which moves the bf16-rounded power and the scores by up to
  ~3e-5; tests/test_torch_evaluators.py holds the rest of the path to
  1e-5 with the JAX package's log-mel in the port's place);
- `_patience_detect`, `stage_sweep` and `stage_report` on seeded synthetic
  traces give the JAX tool's JSON; report refuses to run without an
  output folder and never writes into campaign/.

The JAX tool writes into module-level paths (its WORK, TRAINED,
RESULTS_DIR), which the tests point at temporary folders.
"""

import hashlib
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import quality_campaign as jax_qc  # noqa: E402

from nanowakeword_tpu_torch.tools import quality_campaign as qc  # noqa: E402

# port vs JAX per-chunk scores, both on the CPU, each with its own log-mel:
# the score-trace bar of tests/test_score_trace.py
SCORE_TOL = 1e-3
CUT = dict(n_train_noise=3, n_rir=2, n_eval_pos=2, n_eval_pos_reson=2,
           n_eval_pos_harm=2, n_eval_pos_fx=2, eval_speech_files=2,
           eval_adv_files=2, eval_noise_files=3, stream_seconds=4)
JAX_NAMES = dict(n_train_noise="N_TRAIN_NOISE", n_rir="N_RIR",
                 n_eval_pos="N_EVAL_POS", n_eval_pos_reson="N_EVAL_POS_RESON",
                 n_eval_pos_harm="N_EVAL_POS_HARM",
                 n_eval_pos_fx="N_EVAL_POS_FX",
                 eval_speech_files="EVAL_SPEECH_FILES",
                 eval_adv_files="EVAL_ADV_FILES",
                 eval_noise_files="EVAL_NOISE_FILES",
                 stream_seconds="STREAM_SECONDS")
FOLDERS = ["data/noise_train", "data/rir", "eval/positive",
           "eval/positive_resonator", "eval/positive_harmonic",
           "eval/positive_fx", "eval/negative_speech",
           "eval/negative_adversarial", "eval/noise"]
# keys the port adds to the JAX tool's eval JSON
PORT_KEYS = {"skipped_files", "device", "rate", "near_threshold"}


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


def _point_jax_tool(monkeypatch, work: Path, results: Path = None):
    monkeypatch.setattr(jax_qc, "WORK", work)
    monkeypatch.setattr(jax_qc, "DATA", work / "data")
    monkeypatch.setattr(jax_qc, "EVAL", work / "eval")
    monkeypatch.setattr(jax_qc, "TRAINED", work / "trained")
    monkeypatch.setattr(jax_qc, "CONFIG_PATH", work / "config_hey_nano.yaml")
    monkeypatch.setattr(jax_qc, "RESULTS_DIR",
                        results or work / "results_dir")


def _install_committed(work: Path):
    model = work / "trained" / qc.MODEL_NAME / "model"
    model.mkdir(parents=True, exist_ok=True)
    for name in ("hey_nano_crnn.nww", "hey_nano_crnn_lite.nww"):
        shutil.copy2(qc.COMMITTED / name, model / name)


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    """Both tools' prep, evaluate, evaluate_lite, sweep and cascade of the
    committed cascade at CUT sizes, each in its own work folder."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("campaigns")
    jax_work, port_work = root / "jax", root / "port"
    try:
        _point_jax_tool(mp, jax_work)
        for key, name in JAX_NAMES.items():
            mp.setattr(jax_qc, name, CUT[key])
        jax_qc.stage_prep()
        _install_committed(jax_work)
        jax_qc.stage_evaluate()
        jax_qc.stage_evaluate(model_suffix="_lite")
        jax_qc.stage_sweep()
        jax_qc.stage_evaluate_cascade()
    finally:
        mp.undo()
    qc.stage_prep(work=port_work, **CUT)
    _install_committed(port_work)
    port = {"eval": qc.stage_evaluate(work=port_work, device="cpu"),
            "eval_lite": qc.stage_evaluate("_lite", work=port_work,
                                           device="cpu"),
            "sweep": qc.stage_sweep(work=port_work),
            "cascade": qc.stage_evaluate_cascade(work=port_work,
                                                 device="cpu")}
    return jax_work, port_work, port


def _file_hashes(folder: Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.iterdir())}


@pytest.mark.parametrize("folder", FOLDERS)
def test_prep_synthesis_is_bit_identical(campaigns, folder):
    jax_work, port_work, _ = campaigns
    ours = _file_hashes(port_work / folder)
    assert len(ours) >= 2
    assert ours == _file_hashes(jax_work / folder)


def test_write_config_equals_jax_apart_from_paths(campaigns):
    jax_work, port_work, _ = campaigns
    ours = (port_work / "config_hey_nano.yaml").read_text()
    ref = (jax_work / "config_hey_nano.yaml").read_text()
    assert ours.replace(str(port_work), "W") == ref.replace(str(jax_work),
                                                            "W")


def test_campaign_config_cuts_only_depth():
    full = qc.campaign_config("/w")
    cut = qc.campaign_config("/w", steps=300, distill_steps=50,
                             clips_per_task=16)
    assert cut["steps"] == 300 and cut["distillation"]["steps"] == 50
    assert cut["stabilization_steps"] == 15
    assert cut["checkpointing"]["interval_steps"] == 30
    assert all(t["num_samples"] == 16 for t in cut["data_generation_tasks"])
    for key in ("crnn_cnn_channels", "layer_size", "batch_composition",
                "augmentation_settings", "feature_generation_manifest",
                "feature_manifest", "clip_length_samples"):
        assert cut[key] == full[key]


def _without_port_keys(obj):
    if isinstance(obj, dict):
        return {k: _without_port_keys(v) for k, v in obj.items()
                if k not in PORT_KEYS}
    return obj


@pytest.mark.parametrize("which,files", [
    ("eval", "traces"), ("eval_lite", "traces_lite"),
    ("eval_cascade", "traces_cascade")])
def test_judgement_matches_jax(campaigns, which, files):
    """The committed cascade judged by both tools on the same eval sets:
    per-chunk traces within SCORE_TOL (each package's own log-mel), the
    same JSON numbers."""
    jax_work, port_work, _ = campaigns
    worst = 0.0
    for ref in sorted((jax_work / files).glob("*.npy")):
        ours = np.load(port_work / files / ref.name)
        theirs = np.load(ref)
        assert ours.shape == theirs.shape, ref.name
        worst = max(worst, float(np.abs(ours - theirs).max()))
    print(f"{files}: max|port - jax| = {worst:.3g}")
    assert worst <= SCORE_TOL, worst
    ours = json.loads((port_work / f"{which}.json").read_text())
    ref = json.loads((jax_work / f"{which}.json").read_text())
    assert _without_port_keys(ours) == ref
    for name in qc.EVAL_SETS:
        assert ours[name]["skipped_files"] == 0
        assert ours["rate"][name]["files"] == ref[name]["files"]
    assert ours["device"] == "cpu"


def test_sweep_of_judgement_matches_jax(campaigns):
    jax_work, port_work, port = campaigns
    ref = json.loads((jax_work / "sweep.json").read_text())
    assert json.loads((port_work / "sweep.json").read_text()) == ref
    assert json.loads(json.dumps(port["sweep"])) == ref


@pytest.fixture(scope="module")
def synthetic_traces():
    rng = np.random.default_rng(7)
    traces = {}
    for name in qc.EVAL_SETS:
        n_files, n_chunks = (6, 37) if name.startswith("positive") \
            else (4, 60)
        base = 0.85 if name.startswith("positive") else 0.3
        traces[name] = np.clip(rng.normal(base, 0.12, (n_files, n_chunks)),
                               0, 1).astype(np.float32)
    return traces


@pytest.mark.parametrize("threshold", [0.8, 0.85, 0.9, 0.95])
@pytest.mark.parametrize("patience", [1, 2, 3, 4])
def test_patience_detect_matches_jax(synthetic_traces, threshold, patience):
    for traces in synthetic_traces.values():
        ours = qc._patience_detect(traces, threshold, patience)
        np.testing.assert_array_equal(
            ours, jax_qc._patience_detect(traces, threshold, patience))
        # the detection statistic decides exactly as the filter does
        np.testing.assert_array_equal(
            ours, qc._patience_score(traces, patience) >= threshold)


def test_near_threshold_names_the_files(synthetic_traces):
    tr = np.full((3, 10), 0.5, np.float32)
    tr[0, 4] = 0.9005
    tr[1, 2:4] = 0.8995
    tr[2, 6] = 0.95
    near = qc.near_threshold(tr, 0.90, 1, ["a", "b", "c"])
    assert [n["file"] for n in near] == ["a", "b"]
    near2 = qc.near_threshold(tr, 0.90, 2, ["a", "b", "c"])
    assert [n["file"] for n in near2] == ["b"]


def _write_traces(work: Path, traces: dict):
    (work / "traces").mkdir(parents=True)
    for name, tr in traces.items():
        np.save(work / "traces" / f"{name}.npy", tr)


def test_sweep_on_synthetic_traces_matches_jax(synthetic_traces, tmp_path,
                                               monkeypatch):
    _write_traces(tmp_path / "jax", synthetic_traces)
    _write_traces(tmp_path / "port", synthetic_traces)
    _point_jax_tool(monkeypatch, tmp_path / "jax")
    jax_qc.stage_sweep()
    qc.stage_sweep(work=tmp_path / "port")
    assert json.loads((tmp_path / "port" / "sweep.json").read_text()) == \
        json.loads((tmp_path / "jax" / "sweep.json").read_text())


def _campaign_hashes() -> dict:
    return {str(p): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(qc.COMMITTED.rglob("*")) if p.is_file()}


def test_report_matches_jax_and_spares_campaign(campaigns, tmp_path,
                                                monkeypatch):
    """stage_report of the JAX tool's eval files: the same results.json
    but for the anecdotes' source line, and the same artifacts copied."""
    jax_work, _, _ = campaigns
    journal = jax_work / "trained" / ".cache" / "journal_cache"
    journal.mkdir(parents=True, exist_ok=True)
    (journal / "training_history.json").write_text(json.dumps(
        [{"metrics": {"stable_loss": 0.5}},
         {"metrics": {"stable_loss": 0.01, "avg_pos_logit": 4.0}}]))
    before = _campaign_hashes()
    _point_jax_tool(monkeypatch, jax_work, results=tmp_path / "jax_out")
    (tmp_path / "jax_out").mkdir()
    jax_qc.stage_report()
    merged = qc.stage_report(work=jax_work, out=tmp_path / "port_out")
    ours = json.loads((tmp_path / "port_out" / "results.json").read_text())
    ref = json.loads((tmp_path / "jax_out" / "results.json").read_text())
    assert ours["reference_anecdotes"].pop("source").startswith(
        "the upstream nanowakeword README.md:325-333")
    ref["reference_anecdotes"].pop("source")
    assert ours == ref
    merged["reference_anecdotes"].pop("source")
    assert json.loads(json.dumps(merged)) == ours
    assert ours["training_final_report"]["stable_loss"] == 0.01
    assert sorted(p.name for p in (tmp_path / "port_out").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax_out").iterdir())
    assert _campaign_hashes() == before


def test_report_refuses_without_out_or_into_campaign(tmp_path):
    with pytest.raises(ValueError, match="needs `out`"):
        qc.stage_report(work=tmp_path)
    with pytest.raises(ValueError, match="refusing"):
        qc.stage_report(work=tmp_path, out=qc.COMMITTED)
    with pytest.raises(ValueError, match="refusing"):
        qc.stage_report(work=tmp_path, out=qc.COMMITTED / "sub")
    for stage in ("report", "all"):
        with pytest.raises(SystemExit):
            qc.main([stage])


def test_unreadable_file_is_skipped_and_counted(tmp_path):
    """A file that load_audio rejects is skipped and counted, and the
    traces stay with their files."""
    from nanowakeword_tpu_torch import NanoInterpreter
    folder = tmp_path / "set"
    folder.mkdir()
    rng = np.random.default_rng(3)
    for i in range(3):
        qc._write_wav(folder / f"f{i}.wav", _clip(rng, i))
    (folder / "f1b.wav").write_bytes(b"RIFF not a wav")
    interp = NanoInterpreter.load_model(
        str(qc.COMMITTED / "hey_nano_crnn_lite.nww"), device="cpu")
    traces, seconds, kept, skipped = qc._eval_dir(
        interp, "hey_nano_crnn_lite", folder, "set")
    assert skipped == 1 and kept == ["f0.wav", "f1.wav", "f2.wav"]
    assert seconds == pytest.approx(3 * 1.0)
    for row, name in zip(traces, kept):
        from nanowakeword_tpu_torch.test_model.evaluate_model_with_audio \
            import stream_scores
        from nanowakeword_tpu_torch.utils.audio_io import load_audio
        np.testing.assert_array_equal(
            row, stream_scores(interp, load_audio(str(folder / name)),
                               "hey_nano_crnn_lite"))


def _clip(rng, i):
    return (rng.normal(0, 0.05 * (i + 1), 16000)).astype(np.float32)


def test_campaign_config_yaml_round_trips(tmp_path):
    qc.write_config(work=tmp_path, steps=100, clips_per_task=8)
    cfg = yaml.safe_load((tmp_path / "config_hey_nano.yaml").read_text())
    assert cfg["steps"] == 100 and cfg["output_dir"] == str(
        tmp_path / "trained")


def test_compare_judgements_of_the_two_tools(campaigns):
    """tools/compare_judgements.py on the two tools' judgements: traces
    within SCORE_TOL with the same decisions, the same numbers, and a
    changed number found."""
    from nanowakeword_tpu_torch.tools import compare_judgements as cj
    jax_work, port_work, _ = campaigns
    traces = cj.compare_traces(jax_work, port_work)
    assert set(traces) == {"traces", "traces_lite", "traces_cascade"}
    for stage in traces.values():
        for name, entry in stage.items():
            assert entry["files"] == CUT[{
                "positive": "n_eval_pos", "positive_resonator":
                "n_eval_pos_reson", "positive_harmonic": "n_eval_pos_harm",
                "positive_fx": "n_eval_pos_fx", "negative_speech":
                "eval_speech_files", "negative_adversarial":
                "eval_adv_files", "noise": "eval_noise_files"}[name]]
            assert entry["max_abs_diff"] <= SCORE_TOL
            assert entry["decisions_differ"] == []

    def judgement(work):
        return {section: json.loads((work / f"{name}.json").read_text())
                for section, name in (("full_model", "eval"),
                                      ("lite_gate", "eval_lite"),
                                      ("cascade", "eval_cascade"))}

    ref, ours = judgement(jax_work), judgement(port_work)
    result = cj.compare_results(ref, ours)
    assert all(v["equal"] for v in result.values()), result
    ours["full_model"]["positive"]["detected"] += 1
    result = cj.compare_results(ref, ours)
    assert result["full_model"]["differences"] == {"positive": {
        "detected": [ref["full_model"]["positive"]["detected"],
                     ref["full_model"]["positive"]["detected"] + 1]}}
