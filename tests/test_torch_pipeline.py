"""The port's training slice end to end on the CPU: `-t` (feature
generation), `-T` (device-cached training) and `.nww` export, then serving
the artifact, against the JAX package on a few tiny synthesized wavs.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nanowakeword_tpu.config.proxy import ConfigProxy
from nanowakeword_tpu.data.transform_clips import \
    transform_clips as jax_transform_clips
from nanowakeword_tpu.export.artifact import load_nww as jax_load_nww
from nanowakeword_tpu.interpreter.nanointerpreter import \
    NanoInterpreter as JaxNanoInterpreter
from nanowakeword_tpu_torch import NanoInterpreter
from nanowakeword_tpu_torch.export.artifact import load_nww
from nanowakeword_tpu_torch.ops import mel_cuda, mix_cuda
from nanowakeword_tpu_torch.trainer import run_pipeline
from nanowakeword_tpu_torch.utils.audio_io import write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# raw path: the same int16 batches (shared numpy RNG) through the two mel
# routes and encoders (tests/test_torch_slice.py measures the same chain)
FEATURE_TOL = 1e-3
SCORE_TOL = 1e-3     # the score-trace bar of tests/test_score_trace.py
SHIPPED_AUGMENTATION = {"min_snr_in_db": 5.0, "max_snr_in_db": 30.0,
                        "pitch_prob": 0.5, "gain_prob": 1.0, "rir_prob": 0.5}


def _burst(rng, n):
    """Noise under a slow envelope: speech-like level changes."""
    env = np.abs(np.sin(np.linspace(0, rng.uniform(2, 6) * np.pi, n)))
    return rng.normal(0, 4000, n) * env


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    dirs = {k: root / k for k in ("pos", "neg", "noise", "rir")}
    for d in dirs.values():
        d.mkdir()
    for i in range(4):
        write_wav(str(dirs["pos"] / f"p{i}.wav"),
                  _burst(rng, int(rng.integers(18000, 28000))))
        write_wav(str(dirs["neg"] / f"n{i}.wav"),
                  _burst(rng, int(rng.integers(12000, 40000))) * 0.7)
    write_wav(str(dirs["noise"] / "bg.wav"), rng.normal(0, 1500, 48000))
    t = np.arange(4800)
    write_wav(str(dirs["rir"] / "r.wav"),
              rng.normal(0, 20000, 4800) * np.exp(-t / 800.0))
    return {k: str(v) for k, v in dirs.items()}


def _config(corpus, out_dir, augment: bool):
    def job(src, name, rounds):
        recipe = {"input_audio_dirs": [corpus[src]],
                  "output_filename": f"{name}.npy",
                  "use_background_noise": augment, "use_rir": augment,
                  "augmentation_rounds": rounds}
        if not augment:
            recipe["augmentation_settings"] = False
        return recipe

    rounds = 4 if augment else 1
    return {
        "model_name": "tiny", "output_dir": str(out_dir),
        "model_type": "crnn", "layer_size": 8, "n_blocks": 1,
        "embedding_dim": 16, "crnn_cnn_channels": [4, 8],
        "crnn_rnn_type": "gru", "dropout_prob": 0.0, "steps": 10,
        "clip_length_samples": 32000, "augmentation_batch_size": 16,
        "num_workers": 0, "background_paths": [corpus["noise"]],
        "rir_paths": [corpus["rir"]],
        "augmentation_settings": dict(SHIPPED_AUGMENTATION),
        "feature_generation_manifest": {"pos": job("pos", "pos", rounds),
                                        "neg": job("neg", "neg", rounds)},
        "batch_composition": {"targets": 4, "negatives": 4},
        "early_stopping_patience": 0, "stabilization_steps": 2,
        "checkpoint_pool_interval": 5,
        "device_cache": {"enabled": True, "steps_per_dispatch": 5},
        "distillation": {"enabled": False},
    }


def _feature_manifest(feature_dir):
    return {"targets": {"p": os.path.join(feature_dir, "pos.npy")},
            "negatives": {"n": os.path.join(feature_dir, "neg.npy")}}


def test_raw_transform_matches_jax(corpus, tmp_path):
    """-t with augmentation off: the raw path shares the reference's numpy
    RNG, so the features match the JAX transform_clips."""
    cfg = _config(corpus, tmp_path / "port", augment=False)
    out = run_pipeline(cfg, transform_clips=True, device="cpu")
    ref_dir = tmp_path / "jax"
    ref_dir.mkdir()
    jax_transform_clips(ConfigProxy(_config(corpus, ref_dir, False)),
                        SimpleNamespace(transform_clips=True, overwrite=False),
                        str(ref_dir))
    for name in ("pos", "neg"):
        ours = np.load(os.path.join(out["feature_dir"], f"{name}.npy"))
        ref = np.load(ref_dir / f"{name}.npy")
        assert ours.shape == ref.shape == (4, 16, 96)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=FEATURE_TOL)


def test_transform_train_export_serve(corpus, tmp_path):
    """-t with the shipped augmentation, -T for 10 device-cached steps,
    export, then the artifact served by the port and by the JAX package."""
    cfg = _config(corpus, tmp_path, augment=True)
    mix_before, mel_before = mix_cuda.launches, mel_cuda.launches
    out = run_pipeline(cfg, transform_clips=True, device="cpu")
    assert (mix_cuda.launches, mel_cuda.launches) == (mix_before, mel_before)
    for name in ("pos", "neg"):
        feats = np.load(os.path.join(out["feature_dir"], f"{name}.npy"))
        assert feats.shape == (16, 16, 96) and np.isfinite(feats).all()
        assert feats.std() > 0

    cfg["feature_manifest"] = _feature_manifest(out["feature_dir"])
    out = run_pipeline(cfg, train_model=True, device="cpu")
    path = out["artifact"]
    assert path.endswith(os.path.join("tiny", "model", "tiny.nww"))

    x = np.load(os.path.join(out["feature_dir"], "pos.npy"))[:4]
    _, jax_model, _ = jax_load_nww(path)
    header, model, encoder = load_nww(path, device="cpu")
    assert header["has_encoder"] and encoder is not None
    np.testing.assert_allclose(torch.sigmoid(model(x)).numpy(),
                               np.asarray(1 / (1 + np.exp(-jax_model(x)))),
                               atol=SCORE_TOL)

    clip = np.clip(np.random.default_rng(3).normal(0, 3000, 16000 * 2),
                   -32768, 32767).astype(np.int16)
    ours = NanoInterpreter.load_model(path, device="cpu").predict_clip(clip)
    ref = JaxNanoInterpreter.load_model(path).predict_clip(clip)
    a = np.array([r.score for r in ours])
    b = np.array([r.score for r in ref])
    assert len(a) == len(b) == 25
    assert np.isfinite(a).all() and ((a >= 0) & (a <= 1)).all()
    np.testing.assert_allclose(a, b, atol=SCORE_TOL)


def test_unported_stages_raise(tmp_path):
    """`generate_clips` is ported: the stage runs its tasks (the clips
    themselves are held against the JAX package in
    tests/test_torch_generator.py)."""
    out_dir = tmp_path / "clips"
    run_pipeline({"generate_clips": True, "output_dir": str(tmp_path),
                  "model_name": "g", "data_generation_tasks": [
                      {"name": "pos", "output_dir": str(out_dir),
                       "num_samples": 2,
                       "text_source": {"type": "fixed_phrase",
                                       "phrase": "hey nano"}}]},
                 device="cpu")
    assert sorted(os.listdir(out_dir)) == ["sample_000000.wav",
                                           "sample_000001.wav"]


def test_training_modules_load_no_jax():
    code = ("import sys\n"
            "import nanowakeword_tpu_torch.trainer\n"
            "import nanowakeword_tpu_torch.train.trainer\n"
            "import nanowakeword_tpu_torch.train.distill\n"
            "import nanowakeword_tpu_torch.utils.journal\n"
            "import nanowakeword_tpu_torch.tools.profile_train_step\n"
            "import nanowakeword_tpu_torch.data.transform_clips\n"
            "import nanowakeword_tpu_torch.export.artifact\n"
            "import nanowakeword_tpu_torch.export.custom_export\n"
            "import nanowakeword_tpu_torch.train.e2e\n"
            "import nanowakeword_tpu_torch.data.generator.generate_clips\n"
            "import nanowakeword_tpu_torch.interpreter.models\n"
            "import nanowakeword_tpu_torch.utils.dynamic_table\n"
            "import nanowakeword_tpu_torch.utils.audio_analyzer\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'ml_dtypes', "
            "'yaml', 'nanowakeword_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
