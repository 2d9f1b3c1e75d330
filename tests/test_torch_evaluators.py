"""The port's evaluators, examples and audio tools against the JAX
package's scripts, on the CPU:

- `test_model/evaluate_model_with_audio.py` and
  `evaluate_model_with_features.py` (`.nww` and `.onnx`) print the same
  report on a tiny WAV and `.npy` set;
- the per-chunk traces of the committed cascade agree within 1e-5 with
  the JAX package's log-mel in the port's place;
- the microphone scripts raise pyaudio's ImportError as the JAX package's
  do; `make_sample_dataset` writes the same bytes;
- each audio tool gives the JAX tool's output on temporary WAVs;
- every new program runs with `python -m`, takes `--device` (default
  cuda) where it runs a model, and no module of the port imports jax,
  flax or the JAX package.

The JAX scripts are loaded from their files; they read `sys.argv`, which
the tests set.
"""

import ast
import contextlib
import hashlib
import importlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nanowakeword_tpu_torch.tools import quality_campaign as qc
from nanowakeword_tpu_torch.utils.audio_io import write_wav

REPO = Path(__file__).resolve().parent.parent
CRNN = REPO / "campaign" / "hey_nano_crnn.nww"
LITE = REPO / "campaign" / "hey_nano_crnn_lite.nww"
TRACE_TOL = 1e-5    # port vs JAX per-chunk scores on the same log-mel

# the port's programs (module under nanowakeword_tpu_torch) and whether each
# runs a model or a kernel on a torch device
PROGRAMS = {
    "test_model.evaluate_model_with_audio": True,
    "test_model.evaluate_model_with_features": True,
    "test_model.nww_model_test_from_mic": True,
    "examples.recognize_from_mic": True,
    "examples.make_sample_dataset": False,
    "tools.quality_campaign": True,
    "tools.eval_encoder_transfer": True,
    "tools.ship_decision_ci": True,
    "tools.encoder_ladder": True,
    "tools.investigate": False,
    "tools.audio_analyzer": False,
    "tools.audio_investigator": False,
    "tools.audio_slicer": False,
    "tools.batch_audio_preprocess": False,
    "tools.cating_audio": False,
    "tools.record_noise": False,
    "tools.compare_judgements": False,
}


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
    """A JAX-package script loaded from its file under a private name."""
    name = "jax_script_" + relpath.replace("/", "_").replace(".py", "")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, REPO / relpath)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _port(program: str):
    return importlib.import_module(f"nanowakeword_tpu_torch.{program}")


def _stdout(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def _run_jax(monkeypatch, relpath, argv) -> str:
    """The script's standard output, without the JAX package's one log
    line that the port does not print (its native library's load)."""
    monkeypatch.setattr(sys, "argv", [relpath] + [str(a) for a in argv])
    out = _stdout(_jax_script(relpath).main)
    return out.replace("[INFO] native audio runtime loaded\n", "")


def _run_port(program, argv) -> str:
    return _stdout(_port(program).main, [str(a) for a in argv])


def _tree_hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def wav_sets(tmp_path_factory):
    """3 positives, 2 speech streams of 4 s and one noise clip, synthesized
    by the campaign's generators, plus a file load_audio rejects."""
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(1_000_000)
    for sub in ("pos", "neg", "noise"):
        (root / sub).mkdir()
    for i in range(3):
        qc._write_wav(root / "pos" / f"p{i}.wav",
                      qc._positive_eval_clip(rng, 1_000_000 + i))
    srng = np.random.default_rng(2_000_000)
    for i in range(2):
        qc._write_wav(root / "neg" / f"n{i}.wav",
                      qc._speech_stream(srng, qc._words(), 4))
    qc._write_wav(root / "noise" / "z0.wav",
                  qc._pink_noise(np.random.default_rng(3), 3 * 16000) * 0.3)
    return root


@pytest.mark.parametrize("threshold", ["0.90", "0.3"])
def test_evaluate_model_with_audio_matches_jax(wav_sets, monkeypatch,
                                               threshold):
    # the gate: the JAX interpreter compiles the CRNN's step for ~10 s here,
    # and the cascade test below streams the CRNN
    argv = ["--model", LITE, "--positive", wav_sets / "pos",
            "--negative", wav_sets / "neg", "--noise", wav_sets / "noise",
            "--threshold", threshold, "--max-samples", "2"]
    ref = _run_jax(monkeypatch, "test_model/evaluate_model_with_audio.py",
                   argv)
    ours = _run_port("test_model.evaluate_model_with_audio",
                     argv + ["--device", "cpu"])
    assert "Positive files: 2" in ours and "Negative files: 3" in ours
    assert ours == ref


@pytest.fixture(scope="module")
def feature_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("feats")
    rng = np.random.default_rng(11)
    np.save(root / "pos.npy", rng.normal(0, 1, (40, 20, 96)).astype(
        np.float32))
    np.save(root / "neg.npy", rng.normal(0, 1, (30, 20, 96)).astype(
        np.float32))
    from nanowakeword_tpu_torch.export.artifact import (export_onnx_model,
                                                        load_nww)
    _, model, _ = load_nww(str(CRNN), device="cpu")
    onnx = export_onnx_model(model, model.input_shape, {}, "crnn_graph",
                             str(root))
    return root, onnx


@pytest.mark.parametrize("models", ["nww", "onnx"])
def test_evaluate_model_with_features_matches_jax(feature_sets, monkeypatch,
                                                  models):
    root, onnx = feature_sets
    # the JAX script applies a .nww CRNN op by op (~20 s here): the CRNN
    # goes as .onnx, the DNN gate as .nww
    paths = {"nww": [LITE], "onnx": [onnx, LITE]}[models]
    argv = ["--models", *paths, "--positive", root / "pos.npy",
            "--negative", root / "neg.npy", "--threshold", "0.02",
            "--batch", "64"]
    ref = _run_jax(monkeypatch, "test_model/evaluate_model_with_features.py",
                   argv)
    ours = _run_port("test_model.evaluate_model_with_features",
                     argv + ["--device", "cpu"])
    assert "Total" in ours and ours == ref


def _jax_streaming_mel():
    """The JAX package's streaming log-mel (its `mel_streaming_step`,
    jitted), in the place of the port's: [320 + 1280] samples -> the
    port's [10, 32] frames, of which the port keeps the last 8."""
    import jax
    import jax.numpy as jnp
    import torch

    from nanowakeword_tpu.ops import mel as jax_mel
    step = jax.jit(lambda tail, chunk: jax_mel.mel_streaming_step(
        tail, chunk)[1])

    def mel(buf):
        assert buf.shape == (1600,)
        frames = np.asarray(step(jnp.asarray(buf[:320].numpy()),
                                 jnp.asarray(buf[320:].numpy())))
        return torch.from_numpy(np.concatenate(
            [np.zeros((2, 32), np.float32), frames]))
    return mel


def test_cascade_traces_match_jax_on_the_same_mel(monkeypatch):
    """Per-chunk traces of three positives (formant, fx, harmonic) and a
    10-s speech stream (the regression test's first negative stream): the
    full model, the gate, and the cascade's verifier and gate, port vs
    JAX, with the JAX package's log-mel in the port's place. (On its own
    log-mel, summed in float64 where the JAX package sums in float32, the
    port is held to 1e-3: tests/test_torch_quality_campaign.py.)"""
    from nanowakeword_tpu.interpreter.nanointerpreter import \
        NanoInterpreter as JaxInterpreter

    from nanowakeword_tpu_torch import NanoInterpreter
    from nanowakeword_tpu_torch.data import features
    monkeypatch.setattr(features, "mel_frontend_fused", _jax_streaming_mel())
    rng = np.random.default_rng(55_000_000)
    clips = [qc._positive_eval_clip(rng, 55_000_000 + i, channel=ch)
             for i, ch in enumerate(("formant", "formant_fx", "harmonic"))]
    clips.append(qc._speech_stream(np.random.default_rng(56_000_000),
                                   qc._words(), 10))

    def run(interp, keys):
        rows = []
        for clip in clips:
            audio = (clip * 32767.0).astype(np.float32)
            interp.reset()
            for s in range(0, len(audio) - 1279, 1280):
                res = interp.predict(audio[s:s + 1280].astype(np.int16))
                rows.append([res.get(key, 0.0) for key in keys])
        return np.asarray(rows, np.float64)

    for path, cascade, keys in (
            (CRNN, False, ["hey_nano_crnn"]),
            (LITE, False, ["hey_nano_crnn_lite"]),
            (CRNN, True, ["hey_nano_crnn", "hey_nano_crnn_lite"])):
        ours = run(NanoInterpreter.load_model(str(path), cascade=cascade,
                                              device="cpu"), keys)
        ref = run(JaxInterpreter.load_model(str(path), cascade=cascade),
                  keys)
        assert ours.shape == (3 * 37 + 125, len(keys))
        print(f"{keys}: max|port - jax| = {np.abs(ours - ref).max():.3g}")
        np.testing.assert_allclose(ours, ref, rtol=0, atol=TRACE_TOL)
        assert np.count_nonzero(ours) > 0


@pytest.mark.parametrize("script,program,extra", [
    ("test_model/nww_model_test_from_mic.py",
     "test_model.nww_model_test_from_mic", []),
    ("examples/recognize_from_mic.py", "examples.recognize_from_mic",
     ["--cascade"]),
])
def test_mic_scripts_raise_without_pyaudio(monkeypatch, script, program,
                                           extra):
    monkeypatch.setitem(sys.modules, "pyaudio", None)
    argv = ["--model", CRNN] + extra
    with pytest.raises(ImportError, match="PyAudio"):
        _run_jax(monkeypatch, script, argv)
    with pytest.raises(ImportError, match="PyAudio"):
        _run_port(program, argv + ["--device", "cpu"])


def test_make_sample_dataset_matches_jax(tmp_path, monkeypatch):
    _run_jax(monkeypatch, "examples/make_sample_dataset.py",
             [tmp_path / "jax"])
    _run_port("examples.make_sample_dataset", [tmp_path / "port"])
    ours = _tree_hashes(tmp_path / "port")
    assert len(ours) == 28 and ours == _tree_hashes(tmp_path / "jax")


@pytest.fixture
def tool_wavs(tmp_path):
    """Three 16-bit WAVs (a loud one, a quiet one, speech with pauses),
    an 8-bit one, and a file that is not a WAV."""
    rng = np.random.default_rng(5)
    src = tmp_path / "src"
    src.mkdir()
    write_wav(str(src / "a_loud.wav"), np.clip(
        rng.normal(0, 20000, 24000), -32768, 32767))
    write_wav(str(src / "b_quiet.wav"), rng.normal(0, 30, 16000))
    speech = np.zeros(16000 * 3, np.float32)
    for start in (2000, 20000, 36000):
        speech[start:start + 6000] = rng.normal(0, 4000, 6000)
    write_wav(str(src / "c_speech.wav"), speech)
    import wave
    with wave.open(str(src / "d_8bit.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(1)
        f.setframerate(16000)
        f.writeframes(rng.integers(0, 255, 8000).astype(np.uint8).tobytes())
    (src / "e_broken.wav").write_bytes(b"RIFF....")
    return src


@pytest.mark.parametrize("args", [[], ["--quiet-db", "-20"],
                                  ["--limit", "2"]])
def test_audio_analyzer_matches_jax(tool_wavs, monkeypatch, args):
    argv = [tool_wavs] + args
    ref = _run_jax(monkeypatch, "tools/audio_analyzer.py", argv)
    assert _run_port("tools.audio_analyzer", argv) == ref


def test_audio_investigator_matches_jax(tool_wavs, tmp_path, monkeypatch):
    import shutil
    for who in ("jax", "port"):
        shutil.copytree(tool_wavs, tmp_path / who)
    dry = _run_jax(monkeypatch, "tools/audio_investigator.py",
                   [tmp_path / "jax", "--dry-run"])
    assert _run_port("tools.audio_investigator",
                     [tmp_path / "port", "--dry-run"]) == dry.replace(
        str(tmp_path / "jax"), str(tmp_path / "port"))
    ref = _run_jax(monkeypatch, "tools/audio_investigator.py",
                   [tmp_path / "jax"])
    ours = _run_port("tools.audio_investigator", [tmp_path / "port"])
    assert ours == ref.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert "QUARANTINE" in ours
    assert _tree_hashes(tmp_path / "port") == _tree_hashes(tmp_path / "jax")


@pytest.mark.parametrize("args", [[], ["--silence-db", "-30",
                                       "--min-gap-ms", "100"]])
def test_audio_slicer_matches_jax(tool_wavs, tmp_path, monkeypatch, args):
    src = tool_wavs / "c_speech.wav"
    ref = _run_jax(monkeypatch, "tools/audio_slicer.py",
                   [src, tmp_path / "jax"] + args)
    ours = _run_port("tools.audio_slicer", [src, tmp_path / "port"] + args)
    assert ours.replace("port", "jax") == ref
    assert _tree_hashes(tmp_path / "port") == _tree_hashes(tmp_path / "jax")
    assert len(_tree_hashes(tmp_path / "port")) >= 2


@pytest.mark.parametrize("script,args", [
    ("batch_audio_preprocess", []),
    ("batch_audio_preprocess", ["--seconds", "0.5"]),
    ("batch_audio_preprocess", ["--no-split"]),
    ("cating_audio", []),
    ("cating_audio", ["--seconds", "1.5"]),
])
def test_audio_converters_match_jax(tool_wavs, tmp_path, monkeypatch,
                                    script, args):
    ref = _run_jax(monkeypatch, f"tools/{script}.py",
                   [tool_wavs, tmp_path / "jax"] + args)
    ours = _run_port(f"tools.{script}", [tool_wavs, tmp_path / "port"]
                     + args)
    assert ours.replace("port", "jax") == ref
    hashes = _tree_hashes(tmp_path / "port")
    assert hashes and hashes == _tree_hashes(tmp_path / "jax")


def test_record_noise_exits_without_pyaudio(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pyaudio", None)
    with pytest.raises(SystemExit) as ref:
        _run_jax(monkeypatch, "tools/record_noise.py", [tmp_path])
    with pytest.raises(SystemExit) as ours:
        _run_port("tools.record_noise", [tmp_path])
    assert str(ours.value) == str(ref.value) and "pyaudio" in str(ref.value)


def test_investigate_reports_the_stack():
    out = _run_port("tools.investigate", [])
    assert "torch" in out and "cuda      available=False" in out
    assert "build     nww_runtime: nww_runtime-" in out
    # no nvcc here: the kernels' build is reported as failed, not skipped
    assert "build     mel_frontend: FAILED" in out


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_program_help_and_device(program, capsys):
    with pytest.raises(SystemExit) as exit_:
        _port(program).main(["--help"])
    assert exit_.value.code == 0
    text = capsys.readouterr().out
    if PROGRAMS[program]:
        assert "--device" in text and "cuda" in text


def test_programs_run_with_python_m():
    proc = subprocess.run(
        [sys.executable, "-m", "nanowakeword_tpu_torch.tools."
         "quality_campaign", "report"], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 2 and "needs --out" in proc.stderr


def _imported_roots(path: Path) -> set:
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


PORT_FILES = sorted((REPO / "nanowakeword_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_file_imports_jax(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "flax", "optax",
                                        "nanowakeword_tpu"}


def test_new_programs_load_no_jax():
    code = ("import sys\n"
            + "".join(f"import nanowakeword_tpu_torch.{p}\n"
                      for p in PROGRAMS)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'optax', 'nanowakeword_tpu')]\n"
              "print(bad)\n"
              "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
