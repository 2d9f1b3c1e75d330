"""Clip generation (-G) and the orchestrator's small stages of the port,
against the JAX package, on the CPU.

The generator is numpy and scipy in both packages, so the same seed and
text give the same WAV bytes. The orchestrator's stages are held to the
reference's behaviour: audio conversion with receipts (`convert_audio`,
`-f`), the versioned default model name, the raw-parameter export, the
user's export hook, the config table, the dataset analyzer, the asset
registry, the frontend's helper methods and the training graph.
"""

import filecmp
import io
import os
import sys
import types
import wave
from contextlib import redirect_stdout

import numpy as np
import pytest

from nanowakeword_tpu.data.generator import generate_clips as jax_gc
from nanowakeword_tpu.data.generator import tts as jax_tts
from nanowakeword_tpu_torch.data.generator import generate_clips as port_gc
from nanowakeword_tpu_torch.data.generator import tts as port_tts
from nanowakeword_tpu_torch.models.model import Model
from nanowakeword_tpu_torch.trainer import run_pipeline

CFG = {"activation_function": "relu", "embedding_dim": 16}


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


@pytest.mark.parametrize("channel", ["formant", "harmonic", "union3"])
def test_generate_samples_writes_the_jax_bytes(tmp_path, channel):
    """The same texts, seed and channel: the same WAV files, byte for
    byte."""
    texts = ["hey nano", "ok tomato"]
    ours = port_tts.generate_samples(texts, 3, str(tmp_path / "port"),
                                     seed=4, channel=channel)
    ref = jax_tts.generate_samples(texts, 3, str(tmp_path / "jax"), seed=4,
                                   channel=channel)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p)
                                                   for p in ref]
    _same_files(tmp_path / "port", tmp_path / "jax")


def test_piper_path_matches_jax(tmp_path, monkeypatch):
    """With a (fake) piper installed and voices configured, both packages
    take the piper path: speaker ids, settings and the resampled audio
    agree byte for byte. Without piper the voices are ignored with a
    warning and the formant synthesizer runs."""
    port_tts.generate_samples(["hey nano"], 2, str(tmp_path / "no_piper"),
                              voices=["voice.onnx"], seed=1)
    port_tts.generate_samples(["hey nano"], 2, str(tmp_path / "formant"),
                              seed=1)
    _same_files(tmp_path / "no_piper", tmp_path / "formant")

    calls = []

    class Voice:
        class config:       # noqa: N801 - piper's attribute name
            sample_rate = 22050
            num_speakers = 4

        @classmethod
        def load(cls, path):
            return cls()

        def synthesize(self, text, **kwargs):
            calls.append(kwargs)
            t = np.linspace(0, 60, 11025)
            return np.sin(t * (1 + len(text))).astype(np.float32)

    fake = types.ModuleType("piper")
    fake.PiperVoice = Voice
    monkeypatch.setitem(sys.modules, "piper", fake)
    port_tts.generate_samples(["hey nano"], 3, str(tmp_path / "port"),
                              voices=["voice.onnx"], seed=2)
    jax_tts.generate_samples(["hey nano"], 3, str(tmp_path / "jax"),
                             voices=["voice.onnx"], seed=2)
    assert calls[:3] == calls[3:] and "speaker_id" in calls[0]
    _same_files(tmp_path / "port", tmp_path / "jax")


def _tasks(root):
    return {
        "target_phrase": "hey nano",
        "tts_settings": {"channel": "formant"},
        "data_generation_tasks": [
            {"name": "pos", "output_dir": str(root / "pos"), "num_samples": 4,
             "file_prefix": "pos", "text_source": {"type": "fixed_phrase"},
             "tts_settings": {"channel": "union3"}},
            {"name": "list", "output_dir": str(root / "list"),
             "num_samples": 3,
             "text_source": {"type": "from_list", "phrases": ["a b", "c d"],
                             "repeat_each": 2}},
            {"name": "adv", "output_dir": str(root / "adv"), "num_samples": 5,
             "text_source": {"type": "auto_adversarial",
                             "include_partial_phrase": 0.3}},
            {"name": "ph", "output_dir": str(root / "ph"), "num_samples": 5,
             "text_source": {"type": "phoneme_adversarial",
                             "min_distance": 0.3}},
            {"name": "off", "enabled": False, "output_dir": str(root / "off"),
             "num_samples": 2, "text_source": {"type": "fixed_phrase"}},
        ],
    }


def test_text_sources_match_jax(tmp_path, monkeypatch):
    """The four text sources give the JAX package's phrase lists and the
    same per-task synthesis settings."""
    seen = {"port": [], "jax": []}
    for name, module in (("port", port_gc), ("jax", jax_gc)):
        monkeypatch.setattr(module, "generate_samples",
                            lambda seen=seen[name], **kw: seen.append(kw))
        module.generate_clips(_tasks(tmp_path))
    assert len(seen["port"]) == 4
    assert seen["port"] == seen["jax"]
    texts = [call["text"] for call in seen["port"]]
    assert texts[0] == ["hey nano"] and texts[1] == ["a b", "a b", "c d",
                                                     "c d"]
    assert len(texts[2]) == len(texts[3]) == 5
    assert seen["port"][0]["channel"] == "union3"


def test_generate_stage_writes_the_jax_clips(tmp_path):
    """-G through run_pipeline writes every enabled task's clips, the same
    bytes as the JAX package's generate_clips."""
    cfg = dict(_tasks(tmp_path / "port"), output_dir=str(tmp_path / "out"),
               model_name="g")
    run_pipeline(cfg, generate_clips=True, device="cpu")
    jax_gc.generate_clips(_tasks(tmp_path / "jax"))
    for sub in ("pos", "list", "adv", "ph"):
        _same_files(tmp_path / "port" / sub, tmp_path / "jax" / sub)
    assert not (tmp_path / "port" / "off").exists()


# -- the orchestrator's stages ---------------------------------------------------


def _write_wav(path, samples, sr, channels):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(np.asarray(samples, np.int16).tobytes())


def test_convert_audio_verifies_once_with_receipts(tmp_path, capsys):
    """`convert_audio: true` converts a 44.1 kHz stereo WAV to 16 kHz mono
    as the JAX package does, writes a receipt, skips the unchanged
    directory on the next run, and re-verifies with force_verify (-f)."""
    from nanowakeword_tpu.utils.audio_io import \
        verify_and_process_directory as jax_verify
    rng = np.random.default_rng(0)
    stereo = rng.integers(-8000, 8000, (22050, 2))
    for d in ("pos", "ref"):
        (tmp_path / d).mkdir()
        _write_wav(tmp_path / d / "a.wav", stereo, 44100, 2)
    cfg = {"output_dir": str(tmp_path / "out"), "model_name": "v",
           "convert_audio": True, "positive_data_path": str(tmp_path / "pos")}
    run_pipeline(cfg, device="cpu")
    jax_verify(str(tmp_path / "ref"))
    with wave.open(str(tmp_path / "pos" / "a.wav")) as f:
        assert (f.getframerate(), f.getnchannels()) == (16000, 1)
    _same_files(tmp_path / "pos", tmp_path / "ref")
    receipts = os.listdir(tmp_path / "out" / ".cache" /
                          "verification_receipts")
    assert len(receipts) == 1
    capsys.readouterr()
    run_pipeline(cfg, device="cpu")
    assert "'pos' already verified. Skipping." in capsys.readouterr().out
    run_pipeline(cfg, force_verify=True, device="cpu")
    out = " ".join(capsys.readouterr().out.split())
    assert "forced re-verification" in out and "already verified" not in out


def test_default_model_name_is_versioned(tmp_path):
    """Without `model_name` each run gets its own project directory,
    `nww_<type>_model_vN`, named as the JAX package names it."""
    from nanowakeword_tpu.export.custom_export import \
        auto_gen_name as jax_name
    cfg = {"output_dir": str(tmp_path), "model_type": "dnn"}
    names = []
    for _ in range(2):
        expected = jax_name("dnn", base_dir=str(tmp_path))
        names.append(os.path.basename(run_pipeline(cfg,
                                                   device="cpu")["project_dir"]))
        assert names[-1] == expected
    assert names == ["nww_dnn_model_v1", "nww_dnn_model_v2"]


def test_export_params_msgpack_matches_jax(tmp_path):
    """The raw-parameter export of the same weights: the JAX package's
    bytes."""
    from nanowakeword_tpu.export.artifact import \
        export_params_msgpack as jax_export
    from nanowakeword_tpu.models.model import Model as JaxModel
    from nanowakeword_tpu_torch.export.artifact import export_params_msgpack
    cfg = dict(CFG, crnn_cnn_channels=[4, 8], crnn_rnn_type="gru")
    jm = JaxModel(config=cfg, model_name="p", input_shape=(16, 96),
                  model_type="crnn", layer_dim=8, n_blocks=1,
                  dropout_prob=0.0)
    model = Model(config=cfg, model_name="p", input_shape=(16, 96),
                  model_type="crnn", layer_dim=8, n_blocks=1,
                  dropout_prob=0.0, device="cpu")
    import jax
    model.load_variables(jax.tree_util.tree_map(np.asarray, jm.variables))
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    export_params_msgpack(model, "p", str(tmp_path / "port"))
    jax_export(jm, "p", str(tmp_path / "jax"))
    _same_files(tmp_path / "port", tmp_path / "jax")


def test_custom_export_hook(tmp_path):
    """The user's script gets the model by keyword; a command gets the
    placeholders; neither configured is a no-op."""
    from nanowakeword_tpu_torch.export.custom_export import \
        export_custom_model
    script = tmp_path / "hook.py"
    script.write_text(
        "def export_model(model, input_shape, config, model_name, "
        "output_dir):\n"
        "    open(output_dir + '/' + model_name + '.txt', 'w').write(\n"
        "        str(tuple(input_shape)) + model.model_type)\n")
    model = Model(config=CFG, model_name="h", device="cpu")
    cfg = {"custom_export": {"script": str(script)}}
    assert export_custom_model(model, (16, 96), cfg, "h", str(tmp_path))
    assert (tmp_path / "h.txt").read_text() == "(16, 96)dnn"
    cfg = {"custom_export": {"command": "echo {model_name} > "
                                        "{output_dir}/cmd.txt"}}
    assert export_custom_model(model, (16, 96), cfg, "h", str(tmp_path))
    assert (tmp_path / "cmd.txt").read_text().strip() == "h"
    assert not export_custom_model(model, (16, 96), {}, "h", str(tmp_path))


def test_dynamic_table_prints_what_jax_prints():
    """The table of the config keys that were read, path-like keys left
    out, long values cut: the JAX package's lines."""
    from nanowakeword_tpu.config.proxy import ConfigProxy as JaxProxy
    from nanowakeword_tpu.utils.dynamic_table import \
        DynamicTable as JaxTable
    from nanowakeword_tpu_torch.config.proxy import ConfigProxy
    from nanowakeword_tpu_torch.utils.dynamic_table import DynamicTable
    data = {"steps": 100, "output_dir": "/x", "layer_size": 32,
            "tags": list(range(40)), "unread": 1}
    printed = []
    for proxy_cls, table_cls in ((ConfigProxy, DynamicTable),
                                 (JaxProxy, JaxTable)):
        proxy = proxy_cls(dict(data))
        for key in ("steps", "output_dir", "layer_size", "tags"):
            proxy.get(key)
        buf = io.StringIO()
        with redirect_stdout(buf):
            table_cls(proxy, title="T").update(force_print=True)
            table_cls(proxy, enabled=False).update(force_print=True)
        printed.append(buf.getvalue())
    assert printed[0] == printed[1]
    assert "steps" in printed[0] and "output_dir" not in printed[0]
    assert "unread" not in printed[0] and "..." in printed[0]


def test_audio_analyzer_matches_jax(tmp_path):
    from nanowakeword_tpu.utils.audio_analyzer import \
        DatasetAnalyzer as JaxAnalyzer
    from nanowakeword_tpu_torch.utils.audio_analyzer import DatasetAnalyzer
    rng = np.random.default_rng(2)
    for d, n in (("pos", 2), ("neg", 3), ("noise", 2), ("rir", 1)):
        (tmp_path / d).mkdir()
        for i in range(n):
            _write_wav(tmp_path / d / f"{i}.wav",
                       rng.integers(-3000, 3000, 8000 * (i + 1)), 16000, 1)
    args = dict(positive_path=str(tmp_path / "pos"),
                negative_path=str(tmp_path / "neg"),
                noise_path=[str(tmp_path / "noise")],
                rir_path=str(tmp_path / "rir"))
    ours = DatasetAnalyzer(**args).analyze()
    assert ours == JaxAnalyzer(**args).analyze()
    assert ours["N_rir"] == 1 and ours["H_neg"] == pytest.approx(3 / 3600)


def test_asset_registry_serves_the_bundled_encoder(tmp_path, monkeypatch):
    """Without a URL in the environment the registry gives the bundled
    asset, read with the port's own msgpack reader."""
    from nanowakeword_tpu.interpreter.models import ModelRegistry as JaxReg
    from nanowakeword_tpu_torch.data.features import \
        pretrained_encoder_variables
    from nanowakeword_tpu_torch.interpreter.models import ModelRegistry
    monkeypatch.delenv("NWW_TPU_SPEECH_ENCODER_URL", raising=False)
    reg = ModelRegistry(cache_dir=str(tmp_path))
    assert reg.speech_encoder_path == reg.speech_encoder
    assert (os.path.realpath(reg.speech_encoder)
            == os.path.realpath(JaxReg(cache_dir=str(tmp_path))
                                .speech_encoder))
    ours = reg.load_speech_encoder_variables()
    ref = pretrained_encoder_variables()
    for name, leaf in ref["params"].items():
        for k, v in leaf.items():
            np.testing.assert_array_equal(ours["params"][name][k], v)
    with pytest.raises(AttributeError):
        reg.unknown_path


def test_audio_features_helpers_match_jax():
    """`_get_melspectrogram`, `_get_embeddings` and `load_encoder_params`
    (another bundled asset, v2) against the JAX frontend's."""
    from nanowakeword_tpu.data.features import \
        AudioFeatures as JaxAudioFeatures
    from nanowakeword_tpu_torch.assets import SPEECH_ENCODER_V2
    from nanowakeword_tpu_torch.data.features import AudioFeatures
    from nanowakeword_tpu_torch.utils.flax_msgpack import read_msgpack_file
    clip = np.random.default_rng(5).integers(-9000, 9000, 20000).astype(
        np.int16)
    ours, ref = AudioFeatures(device="cpu"), JaxAudioFeatures()
    mel = ours._get_melspectrogram(clip)
    np.testing.assert_allclose(mel, ref._get_melspectrogram(clip), rtol=0,
                               atol=1e-4)
    assert mel.shape == (125, 32)
    v4 = ours._get_embeddings(clip)
    np.testing.assert_allclose(v4, ref._get_embeddings(clip), rtol=0,
                               atol=1e-4)
    v2 = read_msgpack_file(SPEECH_ENCODER_V2)
    ours.load_encoder_params(v2)
    ref.load_encoder_params(v2)
    emb = ours._get_embeddings(clip)
    assert emb.shape == v4.shape and np.abs(emb - v4).max() > 1e-2
    np.testing.assert_allclose(emb, ref._get_embeddings(clip), rtol=0,
                               atol=1e-4)


def test_plot_history(tmp_path, monkeypatch):
    """The training graph lands in `graphs/`; without matplotlib one line
    is logged and nothing is written."""
    model = Model(config=CFG, model_name="g", device="cpu")
    model.history["loss"].extend(np.linspace(1.0, 0.2, 30).tolist())
    model.history["train_recall_steps"].extend([0, 10, 20])
    model.history["train_recall"].extend([0.2, 0.5, 0.9])
    path = model.plot_history(str(tmp_path / "a"))
    assert path.endswith(os.path.join("graphs",
                                      "training_performance_graph.png"))
    assert os.path.getsize(path) > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert model.plot_history(str(tmp_path / "b")) is None
    assert not (tmp_path / "b").exists()



@pytest.mark.parametrize("channels", [2, 3])
def test_read_wav_folds_channels_as_jax(tmp_path, channels):
    """16-bit channels fold to mono as the JAX package decodes them (its
    native decoder: the integer mean, truncated toward zero)."""
    from nanowakeword_tpu.utils.audio_io import read_wav as jax_read_wav
    from nanowakeword_tpu_torch.utils.audio_io import read_wav
    frames = np.random.default_rng(channels).integers(
        -32768, 32768, (4001, channels))
    _write_wav(tmp_path / "a.wav", frames, 22050, channels)
    ours, sr = read_wav(str(tmp_path / "a.wav"))
    ref, ref_sr = jax_read_wav(str(tmp_path / "a.wav"))
    assert sr == ref_sr == 22050 and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, np.fix(frames.sum(1) / channels))


def test_prefetcher_counts_the_wait():
    """`waited` is the time the consumer spent blocked on the producer."""
    import time
    from nanowakeword_tpu_torch.utils.prefetch import Prefetcher

    def slow():
        time.sleep(0.05)
        return 1

    prefetcher = Prefetcher(slow, depth=1)
    try:
        assert [prefetcher.get() for _ in range(3)] == [1, 1, 1]
    finally:
        prefetcher.close()
    assert 0.1 <= prefetcher.waited < 1.0
