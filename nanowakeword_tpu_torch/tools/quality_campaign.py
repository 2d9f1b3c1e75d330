"""Quality campaign on the port: does a model trained and served by the
PyTorch port detect the wake word, by the yardstick of the JAX package's
`tools/quality_campaign.py`?

The upstream project quantifies its value only as quality anecdotes
(its README.md:325-333): stable loss 0.0086, average positive / negative
logits +5.447 / -5.721, and under 1 false positive per 16-28 h of audio.
The campaign reproduces the product path on the built-in synthesis
channels and measures the same things:

  1. `prep`     - synthesize noise and RIR pools and held-out eval sets
                  (disjoint speaker seeds; positives placed mid-stream in
                  3-s clips; negatives as 30-s speech / noise streams), and
                  write the campaign's YAML config. The same bytes as the
                  JAX tool's.
  2. `pipeline` - the port's trainer end to end: `-G` (fixed-phrase
                  positives, phoneme / word-adversarial and generic-speech
                  negatives), `-t` (augmentation with the mix kernel,
                  features with the mel kernel), `-T` (the CRNN on the
                  device-cached loop, with validation), `-d` (the lite
                  gate).
  3. `evaluate` - stream every eval set through the interpreter on
                  `--device` with the semantics of the port's
                  `test_model/evaluate_model_with_audio.py` (per-file max
                  score at threshold 0.90; one replay of the captured step,
                  one mel-kernel launch, per 80 ms chunk on a card), for
                  the full model and (`evaluate_lite`) the lite gate.
  4. `sweep`    - grid patience x threshold over the recorded traces and
                  pick the production operating point.
  5. `cascade`  - evaluate gate + verifier composed, as `load_model(...,
                  cascade=True)` deploys it, with the verifier-invocation
                  rate.
  6. `report`   - merge the results into <--out>/results.json and copy the
                  artifacts there.

Beside the JAX tool's numbers, `evaluate` and `cascade` record per set how
many files `load_audio` rejected (skipped and counted), the evaluation rate
(files/s, audio hours per wall second, ms per chunk p50 / p90) and how many
files have a detection statistic within 1e-3 of a threshold, where the
card's scores (held to the CPU's within 1e-3) may decide otherwise.

Run everything:
    python -m nanowakeword_tpu_torch.tools.quality_campaign all --out DIR \\
        [--device cuda|cpu]
or one stage: `prep`, `pipeline [--stages GtTd] [--overwrite]`,
`evaluate`, `evaluate_lite`, `sweep`, `cascade`, `report --out DIR`.
The data live under $NWW_CAMPAIGN_DIR (default `nww_campaign` in the
temporary directory), made again from seeds. `all` runs the stages in one
process (the JAX tool needs one per stage, its backends being
process-global). `--out` is required for `report` and `all`: the port
writes nothing into the repository's `campaign/`. To judge the committed
cascade, copy `campaign/hey_nano_crnn.nww` and its `_lite` into
$NWW_CAMPAIGN_DIR/trained/hey_nano_crnn/model/ before `evaluate`.

The stage functions take the set sizes, the pipeline's depth, the work
folder and the model folder as keyword arguments, defaulting to the JAX
tool's constants.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

REPO = Path(__file__).resolve().parents[2]
COMMITTED = REPO / "campaign"

PHRASE = "hey nano"
MODEL_NAME = "hey_nano_crnn"
SR = 16000
THRESHOLD = 0.90
# Production operating point: the interpreter's patience post-filter
# (predict(patience={key: N})) requires N consecutive 80-ms frames >=
# threshold before a detection fires. Raw per-frame max (patience 1) is
# the upstream evaluator's semantics; deployments use patience to kill
# single-frame spikes. Both are reported.
PATIENCE = 3
# card vs CPU scores agree within this (tests/test_score_trace.py); a file
# whose detection statistic lies this close to a threshold may flip
NEAR_THRESHOLD = 1e-3

# Speaker-seed bases. A "speaker" is a (seed, f0) draw inside
# generate_samples / formant_synthesize; disjoint bases give disjoint
# speakers. Train/val use the -G stage (bases 10 / 20_000 via tts_settings);
# eval sets below use >= 1_000_000.
SEED_EVAL_POS = 1_000_000
SEED_EVAL_POS_RESON = 1_500_000
SEED_EVAL_POS_HARM = 1_750_000
SEED_EVAL_POS_FX = 1_250_000
SEED_EVAL_SPEECH = 2_000_000
SEED_EVAL_ADV = 2_500_000
SEED_EVAL_NOISE = 3_000_000
SEED_TRAIN_NOISE = 4_000_000
SEED_RIR = 5_000_000

N_EVAL_POS = 400            # held-out formant speakers
N_EVAL_POS_RESON = 150      # resonator channel, held-out speakers
N_EVAL_POS_HARM = 150       # harmonic channel, held-out speakers
N_EVAL_POS_FX = 150         # the honest transfer eval: held-out-speaker
                            # formant positives through the telephone-EQ/
                            # reverb/clip fx chain (tts.apply_channel_fx),
                            # a domain nothing in the product trains on
EVAL_SPEECH_FILES = 240     # 30-s generic-speech streams = 2.0 h
EVAL_ADV_FILES = 60         # 30-s adversarial-speech streams = 0.5 h
EVAL_NOISE_FILES = 120      # 30-s noise streams = 1.0 h
STREAM_SECONDS = 30
N_TRAIN_NOISE = 600         # 10-s background clips for augmentation mixing
N_RIR = 300
STEPS = 20000               # the config's training steps
DISTILL_STEPS = 8000

EVAL_SETS = ("positive", "positive_resonator", "positive_harmonic",
             "positive_fx", "negative_speech", "negative_adversarial",
             "noise")


def _paths(work=None) -> SimpleNamespace:
    """The campaign's folders under `work` (default $NWW_CAMPAIGN_DIR, or
    `nww_campaign` in the temporary directory)."""
    work = Path(work or os.environ.get(
        "NWW_CAMPAIGN_DIR", os.path.join(tempfile.gettempdir(),
                                         "nww_campaign")))
    return SimpleNamespace(work=work, data=work / "data", eval=work / "eval",
                           trained=work / "trained",
                           config=work / "config_hey_nano.yaml")


def _model_dir(paths, model_dir=None) -> Path:
    return Path(model_dir) if model_dir else (
        paths.trained / MODEL_NAME / "model")


def _write_wav(path, audio_f32):
    from nanowakeword_tpu_torch.utils.audio_io import write_wav
    write_wav(str(path), np.asarray(audio_f32, np.float32) * 32767.0)


def _dictionary_phrase(rng, words, n_words):
    return " ".join(words[rng.integers(len(words))] for _ in range(n_words))


def _pink_noise(rng, n):
    """1/f-ish noise via shaped rfft of white noise."""
    spec = np.fft.rfft(rng.standard_normal(n))
    freqs = np.maximum(np.fft.rfftfreq(n, 1 / SR), 1.0)
    out = np.fft.irfft(spec / np.sqrt(freqs), n)
    return out / (np.abs(out).max() + 1e-9)


def _babble(rng, words, n, n_voices=4):
    """Overlapping formant speech at low level: crowd babble."""
    from nanowakeword_tpu_torch.data.generator.tts import formant_synthesize
    out = np.zeros(n, np.float32)
    for v in range(n_voices):
        pos = 0
        while pos < n:
            seed = int(rng.integers(2**31))
            a = formant_synthesize(
                _dictionary_phrase(rng, words, int(rng.integers(2, 5))),
                seed=seed, f0=float(rng.uniform(90, 220)))
            end = min(pos + len(a), n)
            out[pos:end] += a[:end - pos] * 0.5
            pos += len(a) + int(rng.uniform(0, 0.5) * SR)
    peak = np.abs(out).max()
    return out / (peak + 1e-9)


def _mic_floor(rng, n):
    """Microphone-style noise floor for synthetic eval audio: real capture
    chains never emit exact digital zeros, and the training distribution's
    background RMS is floored at MIN_BG_RMS=0.005 (augment_clips.py), so
    eval streams carry a floor drawn around the trained-in minimum."""
    floor_rms = rng.uniform(0.003, 0.02)
    return _pink_noise(rng, n).astype(np.float32) * floor_rms * 3.0


def _speech_stream(rng, words, seconds, synth_fn=None):
    """Concatenate random phrases into one `seconds`-long stream."""
    from nanowakeword_tpu_torch.data.generator.tts import (cleanup_filter,
                                                           formant_synthesize)
    synth = synth_fn or formant_synthesize
    n = seconds * SR
    out = _mic_floor(rng, n)
    pos = int(rng.uniform(0, 0.4) * SR)
    while pos < n - SR // 2:
        seed = int(rng.integers(2**31))
        a = synth(_dictionary_phrase(rng, words, int(rng.integers(1, 5))),
                  seed=seed, f0=float(rng.uniform(90, 220)))
        a = cleanup_filter(a)
        end = min(pos + len(a), n)
        out[pos:end] += a[:end - pos]
        pos = end + int(rng.uniform(0.1, 0.6) * SR)
    return out


def _positive_eval_clip(rng, seed, channel="formant"):
    """3-s clip with the wake phrase placed mid-stream (past interpreter
    warm-up), faint noise floor so the stream is not digital silence."""
    from nanowakeword_tpu_torch.data.generator.tts import (
        apply_channel_fx, cleanup_filter, formant_synthesize,
        harmonic_synthesize, resonator_synthesize)
    if channel == "resonator":
        a = resonator_synthesize(PHRASE, seed=seed,
                                 f0=float(rng.uniform(140, 240)),
                                 vtl_scale=float(rng.uniform(0.9, 1.1)))
    elif channel == "harmonic":
        a = harmonic_synthesize(PHRASE, seed=seed,
                                f0=float(rng.uniform(120, 240)),
                                vtl_scale=float(rng.uniform(0.9, 1.1)))
    else:
        a = formant_synthesize(PHRASE, seed=seed,
                               f0=float(rng.uniform(90, 220)))
        if channel == "formant_fx":
            a = apply_channel_fx(a, np.random.default_rng(seed * 6007 + 1))
    a = cleanup_filter(a)
    n = 3 * SR
    out = _mic_floor(rng, n)
    offset = int(rng.uniform(0.9, max(0.91, 3.0 - len(a) / SR - 0.1)) * SR)
    end = min(offset + len(a), n)
    out[offset:end] += a[:end - offset]
    return out


def _adv_texts(n, seed):
    """Fresh phoneme-adversarial draws (disjoint from the -G stage's)."""
    import random as pyrandom

    from nanowakeword_tpu_torch.data.generator.adversarial_texts import (
        PhonemeAdversarialGenerator, get_phonemizer_model)
    from nanowakeword_tpu_torch.data.generator.g2p import \
        collapse_repeated_letters
    state = pyrandom.getstate()
    np_state = np.random.get_state()
    try:
        pyrandom.seed(seed)
        np.random.seed(seed % (2**31))
        gen = PhonemeAdversarialGenerator(get_phonemizer_model(),
                                          min_distance=0.35)
        return [collapse_repeated_letters(v)
                for v in gen.generate(PHRASE, n)]
    finally:
        pyrandom.setstate(state)
        np.random.set_state(np_state)


_EXTRA_WORDS = [
    "table", "doctor", "purple", "sunday", "monday", "kitchen", "jacket",
    "pillow", "rocket", "silver", "candle", "butter", "finger", "market",
    "pencil", "ticket", "travel", "velvet", "walnut", "basket", "bottle",
    "camera", "danger", "engine", "forest", "guitar", "hammer", "island",
    "jungle", "ladder", "magnet", "napkin", "orange", "planet", "rabbit",
    "saddle", "tunnel", "valley", "wagon", "zebra", "anchor", "bridge",
    "castle", "desert", "eleven", "frozen", "galaxy", "helmet", "insect",
    "timber", "meadow", "nickel", "oyster", "puzzle", "quarter", "ribbon",
    "shadow", "temple", "umbrella", "violin", "whisper", "yogurt",
]


def _words():
    from nanowakeword_tpu_torch.data.generator.adversarial_texts import \
        _FILLER_WORDS
    return list(_FILLER_WORDS) + _EXTRA_WORDS


# --------------------------------------------------------------------------
# prep
# --------------------------------------------------------------------------

def _noise_clip(rng, words, i, n):
    kind = i % 3
    if kind == 0:
        a = _pink_noise(rng, n)
    elif kind == 1:
        a = rng.standard_normal(n)
        a = a / np.abs(a).max()
    else:
        a = _babble(rng, words, n)
    return a * rng.uniform(0.05, 0.5)


def stage_prep(force=False, *, work=None, n_train_noise=N_TRAIN_NOISE,
               n_rir=N_RIR, n_eval_pos=N_EVAL_POS,
               n_eval_pos_reson=N_EVAL_POS_RESON,
               n_eval_pos_harm=N_EVAL_POS_HARM, n_eval_pos_fx=N_EVAL_POS_FX,
               eval_speech_files=EVAL_SPEECH_FILES,
               eval_adv_files=EVAL_ADV_FILES,
               eval_noise_files=EVAL_NOISE_FILES,
               stream_seconds=STREAM_SECONDS):
    """Synthesize the pools and eval sets (each set's files are drawn in
    order from its own seed, so a smaller count gives the first files of
    the full set) and write the config."""
    paths = _paths(work)
    t0 = time.time()
    words = _words()
    jobs = []

    def fresh(folder):
        if force or not folder.is_dir():
            folder.mkdir(parents=True, exist_ok=True)
            return True
        return False

    noise_dir = paths.data / "noise_train"
    if fresh(noise_dir):
        rng = np.random.default_rng(SEED_TRAIN_NOISE)
        for i in range(n_train_noise):
            _write_wav(noise_dir / f"noise_{i:05d}.wav",
                       _noise_clip(rng, words, i, 10 * SR))
        jobs.append(f"noise_train: {n_train_noise} x 10 s")

    rir_dir = paths.data / "rir"
    if fresh(rir_dir):
        rng = np.random.default_rng(SEED_RIR)
        for i in range(n_rir):
            rt = rng.uniform(0.08, 0.5)
            n = 4000
            rir = rng.standard_normal(n) * np.exp(-3.0 * np.arange(n)
                                                  / SR / rt)
            rir[0] = rng.uniform(1.5, 4.0)
            _write_wav(rir_dir / f"rir_{i:04d}.wav",
                       rir / np.abs(rir).max() * 0.9)
        jobs.append(f"rir: {n_rir}")

    for name, prefix, seed, count, channel in (
            ("positive", "pos", SEED_EVAL_POS, n_eval_pos, "formant"),
            ("positive_resonator", "posr", SEED_EVAL_POS_RESON,
             n_eval_pos_reson, "resonator"),
            ("positive_harmonic", "posh", SEED_EVAL_POS_HARM,
             n_eval_pos_harm, "harmonic"),
            ("positive_fx", "posfx", SEED_EVAL_POS_FX, n_eval_pos_fx,
             "formant_fx")):
        folder = paths.eval / name
        if fresh(folder):
            rng = np.random.default_rng(seed)
            for i in range(count):
                _write_wav(folder / f"{prefix}_{i:05d}.wav",
                           _positive_eval_clip(rng, seed + i,
                                               channel=channel))
            jobs.append(f"eval/{name}: {count}")

    speech_dir = paths.eval / "negative_speech"
    if fresh(speech_dir):
        rng = np.random.default_rng(SEED_EVAL_SPEECH)
        for i in range(eval_speech_files):
            _write_wav(speech_dir / f"neg_{i:05d}.wav",
                       _speech_stream(rng, words, stream_seconds))
        jobs.append(f"eval/negative_speech: {eval_speech_files} x "
                    f"{stream_seconds} s")

    adv_dir = paths.eval / "negative_adversarial"
    if fresh(adv_dir):
        from nanowakeword_tpu_torch.data.generator.tts import (
            cleanup_filter, formant_synthesize)
        texts = _adv_texts(300, SEED_EVAL_ADV)
        rng = np.random.default_rng(SEED_EVAL_ADV)
        for i in range(eval_adv_files):
            n = stream_seconds * SR
            out = _mic_floor(rng, n)
            pos = int(rng.uniform(0, 0.4) * SR)
            while pos < n - SR // 2:
                txt = texts[int(rng.integers(len(texts)))]
                a = cleanup_filter(formant_synthesize(
                    txt, seed=int(rng.integers(2**31)),
                    f0=float(rng.uniform(90, 220))))
                end = min(pos + len(a), n)
                out[pos:end] += a[:end - pos]
                pos = end + int(rng.uniform(0.15, 0.7) * SR)
            _write_wav(adv_dir / f"adv_{i:05d}.wav", out)
        jobs.append(f"eval/negative_adversarial: {eval_adv_files} x "
                    f"{stream_seconds} s")

    noise_eval_dir = paths.eval / "noise"
    if fresh(noise_eval_dir):
        rng = np.random.default_rng(SEED_EVAL_NOISE)
        for i in range(eval_noise_files):
            _write_wav(noise_eval_dir / f"noise_{i:05d}.wav",
                       _noise_clip(rng, words, i, stream_seconds * SR))
        jobs.append(f"eval/noise: {eval_noise_files} x {stream_seconds} s")

    write_config(work=paths.work)
    print(f"[prep] done in {time.time() - t0:.0f}s: "
          + ("; ".join(jobs) if jobs else "everything cached"))


def _generic_phrases(n, seed, min_words=1, max_words=5):
    """Random dictionary-word phrases: generic speech with no relation to
    the wake phrase (train negatives; the eval streams draw from the same
    distribution with disjoint seeds). Longer word counts give dense
    back-to-back speech clips, without which a model false-alarms on
    continuous speech streams."""
    rng = np.random.default_rng(seed)
    words = _words()
    return [_dictionary_phrase(rng, words,
                               int(rng.integers(min_words, max_words)))
            for _ in range(n)]


def campaign_config(work=None, *, steps=STEPS, distill_steps=DISTILL_STEPS,
                    clips_per_task=None) -> dict:
    """The campaign's training config. At its defaults it equals the JAX
    tool's, paths aside. Cut in depth: `steps` (the stabilization and
    checkpoint intervals scale with it), `distill_steps`, and
    `clips_per_task` (every generation task's num_samples)."""
    paths = _paths(work)
    data, trained = paths.data, paths.trained
    features = str(trained / MODEL_NAME / "features")
    scale = steps / STEPS
    cfg = {
        "model_name": MODEL_NAME,
        "output_dir": str(trained),
        "target_phrase": PHRASE,
        "background_paths": [str(data / "noise_train")],
        "rir_paths": [str(data / "rir")],
        "model_type": "crnn",
        "layer_size": 64,
        "n_blocks": 2,
        "embedding_dim": 96,
        "crnn_cnn_channels": [16, 32, 32],
        "crnn_rnn_type": "gru",
        "dropout_prob": 0.3,
        "activation_function": "relu",
        "steps": steps,
        "stabilization_steps": max(1, round(1000 * scale)),
        # no early stopping: the best checkpoint is selected over the full
        # budget
        "early_stopping_patience": 0,
        "val_early_stopping_patience": 1000000,
        "optimizer_type": "adamw",
        "learning_rate_max": 0.0015,
        "lr_scheduler_type": "onecycle",
        "weight_decay": 0.01,
        "augmentation_batch_size": 512,
        "clip_length_samples": 32000,
        "device_cache": {"enabled": True},
        "augmentation_settings": {
            "min_snr_in_db": 5.0, "max_snr_in_db": 30.0,
            "pitch_prob": 0.5, "gain_prob": 1.0, "rir_prob": 0.5,
        },
        "data_generation_tasks": [
            # positives and negatives render through all three rendering
            # families (union3), so the channel carries no label; the
            # transfer domain is the never-trained fx chain
            {"name": "positives", "enabled": True,
             "output_dir": str(data / "positive_train"),
             "num_samples": 3000,
             "text_source": {"type": "fixed_phrase", "phrase": PHRASE},
             "tts_settings": {"seed": 10, "channel": "union3"}},
            {"name": "positives_val", "enabled": True,
             "output_dir": str(data / "positive_val"),
             "num_samples": 300,
             "text_source": {"type": "fixed_phrase", "phrase": PHRASE},
             "tts_settings": {"seed": 20000, "channel": "union3"}},
            {"name": "phoneme_adversarial", "enabled": True,
             "output_dir": str(data / "neg_phoneme_adv"),
             "num_samples": 2000,
             "text_source": {"type": "phoneme_adversarial",
                             "base_phrase": PHRASE, "min_distance": 0.35},
             "tts_settings": {"seed": 30, "channel": "union3"}},
            # closer near-homophones (min_distance 0.2 vs the eval set's
            # 0.35) against the adversarial stress set's false alarms
            {"name": "phoneme_adversarial_hard", "enabled": True,
             "output_dir": str(data / "neg_phoneme_adv_hard"),
             "num_samples": 1500,
             "text_source": {"type": "phoneme_adversarial",
                             "base_phrase": PHRASE, "min_distance": 0.2},
             "tts_settings": {"seed": 35, "channel": "union3"}},
            {"name": "word_adversarial", "enabled": True,
             "output_dir": str(data / "neg_word_adv"),
             "num_samples": 1500,
             "text_source": {"type": "auto_adversarial",
                             "base_phrase": PHRASE},
             "tts_settings": {"seed": 40, "channel": "union3"}},
            {"name": "generic_speech", "enabled": True,
             "output_dir": str(data / "neg_generic"),
             "num_samples": 2000,
             "text_source": {"type": "from_list",
                             "phrases": _generic_phrases(500, seed=50)},
             "tts_settings": {"seed": 50, "channel": "union3"}},
            {"name": "dense_speech", "enabled": True,
             "output_dir": str(data / "neg_dense"),
             "num_samples": 2500,
             "text_source": {"type": "from_list",
                             "phrases": _generic_phrases(
                                 600, seed=55, min_words=4, max_words=10)},
             "tts_settings": {"seed": 55, "channel": "union3"}},
            {"name": "negatives_val", "enabled": True,
             "output_dir": str(data / "negative_val"),
             "num_samples": 400,
             "file_prefix": "pa",
             "text_source": {"type": "phoneme_adversarial",
                             "base_phrase": PHRASE, "min_distance": 0.35},
             "tts_settings": {"seed": 60000, "channel": "union3"}},
            {"name": "negatives_val_dense", "enabled": True,
             "output_dir": str(data / "negative_val"),
             "num_samples": 300,
             "file_prefix": "dn",
             "text_source": {"type": "from_list",
                             "phrases": _generic_phrases(
                                 150, seed=70000, min_words=4,
                                 max_words=10)},
             "tts_settings": {"seed": 70000, "channel": "union3"}},
        ],
        "feature_generation_manifest": {},
        "batch_composition": {"t": 96, "pa": 28, "pah": 20, "wa": 16,
                              "gen": 28, "dn": 36, "nz": 32},
        "feature_manifest": {
            "targets": {"t": f"{features}/positive_features.npy"},
            "negatives": {
                "pa": f"{features}/phoneme_adv_features.npy",
                "pah": f"{features}/phoneme_adv_hard_features.npy",
                "wa": f"{features}/word_adv_features.npy",
                "gen": f"{features}/generic_features.npy",
                "dn": f"{features}/dense_features.npy",
                "nz": f"{features}/noise_features.npy"},
            "targets_val": {"tv": f"{features}/positive_val_features.npy"},
            "negatives_val": {
                "nv": f"{features}/negative_val_features.npy",
                "nzv": f"{features}/noise_val_features.npy"},
        },
        "distillation": {"enabled": True, "steps": distill_steps},
        "checkpointing": {"enabled": True,
                          "interval_steps": max(1, round(2000 * scale)),
                          "limit": 2},
        "enable_journaling": True,
        "show_training_summary": False,
        "debug_mode": False,
    }
    # augmentation rounds per feature file: positives 8, negatives and the
    # noise pool 4, validation 1; noise joins validation so that best-
    # checkpoint selection sees it
    manifest = cfg["feature_generation_manifest"]
    for key, folder, rounds, rir in (
            ("positive_features", "positive_train", 8, True),
            ("phoneme_adv_features", "neg_phoneme_adv", 4, True),
            ("phoneme_adv_hard_features", "neg_phoneme_adv_hard", 4, True),
            ("word_adv_features", "neg_word_adv", 4, True),
            ("generic_features", "neg_generic", 4, True),
            ("dense_features", "neg_dense", 4, True),
            ("noise_features", "noise_train", 4, False),
            ("positive_val_features", "positive_val", 1, False),
            ("negative_val_features", "negative_val", 1, False),
            ("noise_val_features", "noise_train", 1, False)):
        entry = {"input_audio_dirs": [str(data / folder)],
                 "output_filename": f"{key}.npy",
                 "use_background_noise": True}
        if rir:
            entry["use_rir"] = True
        entry["augmentation_rounds"] = rounds
        manifest[key] = entry
    if clips_per_task is not None:
        for task in cfg["data_generation_tasks"]:
            task["num_samples"] = int(clips_per_task)
    return cfg


def write_config(work=None, **cut):
    """Write campaign_config(work, **cut) as YAML to the work folder."""
    import yaml
    paths = _paths(work)
    paths.work.mkdir(parents=True, exist_ok=True)
    paths.config.write_text(yaml.safe_dump(campaign_config(paths.work, **cut),
                                           sort_keys=False))
    print(f"[prep] config written: {paths.config}")


# --------------------------------------------------------------------------
# pipeline (-G -t -T -d through the port's trainer entry point)
# --------------------------------------------------------------------------

def stage_pipeline(stages="GtTd", overwrite=False, *, work=None,
                   device="cuda", **cut):
    """`trainer.train(cli_args=...)` on the campaign config with the flags
    of `stages`. With `steps`, `distill_steps` or `clips_per_task` the
    config is written again at that depth first. -> seconds per run."""
    from nanowakeword_tpu_torch.trainer import train
    paths = _paths(work)
    if cut:
        write_config(work=paths.work, **cut)
    flags = [f"-{s}" for s in "GtTd" if s in stages]
    if overwrite:
        flags.append("--overwrite")
    t0 = time.time()
    train(cli_args=["-c", str(paths.config), *flags, "--device",
                    str(device)])
    seconds = time.time() - t0
    print(f"[pipeline {stages}] done in {seconds:.0f}s")
    return seconds


# --------------------------------------------------------------------------
# evaluate
# --------------------------------------------------------------------------

def _eval_dir(interpreter, key, folder, desc, times=None):
    """Per-file score-trace streaming, the semantics of the port's
    test_model/evaluate_model_with_audio.py (chunk 1280, reset per file).
    A file that `load_audio` rejects is skipped and counted.
    -> (traces [kept files, chunks], audio seconds, kept file names,
    skipped count); max over axis 1 is the upstream evaluator's per-file
    score, and row i belongs to kept file i."""
    from nanowakeword_tpu_torch.test_model.evaluate_model_with_audio import (
        get_limited_files, stream_scores)
    from nanowakeword_tpu_torch.utils.audio_io import load_audio
    files = get_limited_files(str(folder), None)
    traces, kept, seconds, skipped = [], [], 0.0, 0
    t0 = time.time()
    for i, f in enumerate(files):
        audio = load_audio(f)
        if audio is None:
            skipped += 1
            continue
        seconds += len(audio) / SR
        traces.append(stream_scores(interpreter, audio, key, times=times))
        kept.append(os.path.basename(f))
        if (i + 1) % 50 == 0:
            rate = (i + 1) / (time.time() - t0)
            print(f"  [{desc}] {i + 1}/{len(files)} files "
                  f"({rate:.1f} files/s)", flush=True)
    trace_arr = (np.stack(traces) if traces
                 else np.zeros((0, 1), np.float32))
    return trace_arr, seconds, kept, skipped


def _patience_detect(traces, threshold, patience):
    """Per-file detection under the interpreter's patience post-filter
    (nanointerpreter.py `_apply_post_processing`): a hit fires only when
    the last `patience` consecutive 80-ms scores are ALL >= threshold."""
    hit = traces >= threshold
    run = np.ones_like(hit[:, patience - 1:], dtype=bool)
    for k in range(patience):
        run &= hit[:, k:k + run.shape[1]]
    return run.any(axis=1)


def _patience_score(traces, patience):
    """Per-file detection statistic: the largest over windows of
    `patience` consecutive scores of the window's smallest. A file is
    detected at threshold t exactly when this is >= t."""
    n = traces.shape[1] - patience + 1
    if n <= 0 or len(traces) == 0:
        return np.zeros(len(traces), np.float32)
    low = traces[:, :n]
    for k in range(1, patience):
        low = np.minimum(low, traces[:, k:k + n])
    return low.max(axis=1)


def near_threshold(traces, threshold, patience, files=None):
    """Files whose detection statistic lies within NEAR_THRESHOLD of
    `threshold`: -> [{"file", "statistic"}]."""
    stat = _patience_score(traces, patience)
    idx = np.nonzero(np.abs(stat - threshold) <= NEAR_THRESHOLD)[0]
    return [{"file": files[i] if files else int(i),
             "statistic": float(stat[i])} for i in idx]


def _rate(files, seconds, wall, times) -> dict:
    ms = np.asarray(times) * 1e3 if times else np.zeros(1)
    return {"files": files, "chunks": len(times), "wall_s": wall,
            "files_per_s": files / max(wall, 1e-9),
            "audio_h_per_wall_s": seconds / 3600.0 / max(wall, 1e-9),
            "chunk_ms_p50": float(np.percentile(ms, 50)),
            "chunk_ms_p90": float(np.percentile(ms, 90))}


def _device_name(device) -> str:
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def stage_evaluate(model_suffix="", out_name="eval", *, work=None,
                   model_dir=None, device="cuda"):
    """Stream every eval set through the interpreter of
    `<model_dir>/hey_nano_crnn<model_suffix>.nww` on `device` (model_dir
    defaults to the pipeline's). Writes traces/<set>.npy (one row per
    kept file, named in traces/<set>_files.json) and <out_name>.json."""
    from nanowakeword_tpu_torch import NanoInterpreter

    paths = _paths(work)
    model_path = (_model_dir(paths, model_dir)
                  / f"{MODEL_NAME}{model_suffix}.nww")
    if not model_path.exists():
        sys.exit(f"[evaluate] model missing: {model_path}")
    interpreter = NanoInterpreter.load_model(str(model_path), device=device)
    key = list(interpreter.models.keys())[0]
    print(f"[evaluate] model={model_path.name} key={key} "
          f"threshold={THRESHOLD} device={device}")

    results = {"model": model_path.name, "threshold": THRESHOLD,
               "patience": PATIENCE}
    rates, near = {}, {}
    trace_dir = paths.work / f"traces{model_suffix}"
    trace_dir.mkdir(parents=True, exist_ok=True)
    for name in EVAL_SETS:
        times = []
        t0 = time.perf_counter()
        traces, seconds, kept, skipped = _eval_dir(
            interpreter, key, paths.eval / name, name, times=times)
        rates[name] = _rate(len(kept), seconds, time.perf_counter() - t0,
                            times)
        np.save(trace_dir / f"{name}.npy", traces)
        (trace_dir / f"{name}_files.json").write_text(json.dumps(kept))
        scores = traces.max(axis=1) if traces.size else np.zeros(0)
        hours = seconds / 3600.0
        if name.startswith("positive"):
            detected = int((scores >= THRESHOLD).sum())
            det_pat = int(_patience_detect(traces, THRESHOLD,
                                           PATIENCE).sum())
            results[name] = {
                "files": len(scores), "hours": round(hours, 3),
                "detected": detected,
                "miss_rate_pct": round(
                    100.0 * (1 - detected / max(len(scores), 1)), 2),
                "miss_rate_pct_patience": round(
                    100.0 * (1 - det_pat / max(len(scores), 1)), 2),
                "median_max_score": round(float(np.median(scores)), 4)
                if len(scores) else None,
            }
        else:
            alarms = int((scores > THRESHOLD).sum())
            alarms_pat = int(_patience_detect(traces, THRESHOLD,
                                              PATIENCE).sum())
            results[name] = {
                "files": len(scores), "hours": round(hours, 3),
                "false_alarm_files": alarms,
                "fa_per_hour": round(alarms / max(hours, 1e-9), 3),
                "false_alarm_files_patience": alarms_pat,
                "fa_per_hour_patience": round(
                    alarms_pat / max(hours, 1e-9), 3),
                "max_score_seen": round(float(scores.max()), 4)
                if len(scores) else None,
            }
        results[name]["skipped_files"] = skipped
        near[name] = {"raw": near_threshold(traces, THRESHOLD, 1, kept),
                      "patience": near_threshold(traces, THRESHOLD,
                                                 PATIENCE, kept)}
        print(f"  {name}: {results[name]}; {rates[name]['files_per_s']:.1f} "
              f"files/s, chunk p50 {rates[name]['chunk_ms_p50']:.3f} ms; "
              f"near {THRESHOLD}: {len(near[name]['raw'])} raw, "
              f"{len(near[name]['patience'])} at patience {PATIENCE}")

    results["device"] = _device_name(device)
    results["rate"] = rates
    results["near_threshold"] = near
    out = paths.work / f"{out_name}{model_suffix}.json"
    out.write_text(json.dumps(results, indent=2))
    print(f"[evaluate] wrote {out}")
    return results


# --------------------------------------------------------------------------
# sweep: pick the production operating point from recorded traces
# --------------------------------------------------------------------------

def stage_sweep(*, work=None):
    """Grid patience x threshold over the full model's recorded traces.

    Threshold 0.90 with patience 3 drops never-trained-channel positives
    (transfer detections spike too briefly for 3 consecutive frames). The
    sweep selects the operating point that keeps speech+noise
    patience-filtered FA at zero, then minimises transfer miss, then
    adversarial FA, then in-domain miss. Written to sweep.json; report()
    publishes the winner as `operating_point`."""
    paths = _paths(work)
    trace_dir = paths.work / "traces"
    traces = {}
    for name in EVAL_SETS:
        p = trace_dir / f"{name}.npy"
        if p.exists():
            traces[name] = np.load(p)
    if not traces:
        sys.exit("[sweep] no traces; run `evaluate` first")

    grid = []
    for patience in (1, 2, 3, 4):
        for thr in (0.80, 0.85, 0.90, 0.92, 0.95):
            row = {"patience": patience, "threshold": thr}
            for name, tr in traces.items():
                det = _patience_detect(tr, thr, patience)
                if name.startswith("positive"):
                    row[f"{name}_miss_pct"] = round(
                        100.0 * (1 - det.sum() / max(len(det), 1)), 2)
                else:
                    hours = tr.shape[0] * tr.shape[1] * 0.08 / 3600.0
                    row[f"{name}_fa_per_h"] = round(
                        det.sum() / max(hours, 1e-9), 2)
            grid.append(row)

    def key(row):
        clean_fa = (row.get("negative_speech_fa_per_h", 9e9)
                    + row.get("noise_fa_per_h", 9e9))
        # transfer = the never-trained fx chain when measured, else the
        # held-out rendering channels
        transfer = row.get(
            "positive_fx_miss_pct",
            row.get("positive_harmonic_miss_pct", 100.0)
            + row.get("positive_resonator_miss_pct", 100.0))
        return (clean_fa > 0.0,                       # hard constraint
                transfer,
                row.get("negative_adversarial_fa_per_h", 9e9),
                row.get("positive_miss_pct", 100.0))
    best = min(grid, key=key)

    # stress-set ROC: adversarial FA/h vs in-domain + transfer miss along
    # the threshold axis at the chosen patience, the tradeoff curve a
    # deployer tunes on
    roc = []
    if "negative_adversarial" in traces:
        for thr in np.arange(0.80, 0.995, 0.01):
            thr = round(float(thr), 3)
            adv = _patience_detect(traces["negative_adversarial"], thr,
                                   best["patience"])
            hours = (traces["negative_adversarial"].shape[0]
                     * traces["negative_adversarial"].shape[1] * 0.08
                     / 3600.0)
            point = {"threshold": thr,
                     "adversarial_fa_per_h": round(adv.sum() / hours, 2)}
            for pos in ("positive", "positive_fx"):
                if pos in traces:
                    det = _patience_detect(traces[pos], thr,
                                           best["patience"])
                    point[f"{pos}_miss_pct"] = round(
                        100.0 * (1 - det.sum() / len(det)), 2)
            roc.append(point)

    out = {"grid": grid, "operating_point": best,
           "adversarial_roc_at_selected_patience": roc,
           "selection_rule": ("speech+noise patience FA == 0, then min "
                              "transfer miss (harmonic+resonator), then "
                              "min adversarial FA, then min in-domain "
                              "miss")}
    (paths.work / "sweep.json").write_text(json.dumps(out, indent=2))
    print(f"[sweep] operating point: {best}")
    return out


# --------------------------------------------------------------------------
# cascade: evaluate gate + verifier as deployed
# --------------------------------------------------------------------------

def stage_evaluate_cascade(*, work=None, model_dir=None, device="cuda"):
    """Stream every eval set through load_model(cascade=True), the
    flagship serving mode: the `<stem>_lite` gate scores every chunk, and
    the verifier's score counts only where the gate cleared
    gate_threshold (on the one-call step both score every chunk and the
    verifier is zeroed where the gate is low). Reports the composed
    miss / FA at the production operating point and the verifier's
    invocation rate, the compute the cascade saves on edge hardware."""
    from nanowakeword_tpu_torch import NanoInterpreter
    from nanowakeword_tpu_torch.test_model.evaluate_model_with_audio import \
        get_limited_files
    from nanowakeword_tpu_torch.utils.audio_io import load_audio

    paths = _paths(work)
    model_path = _model_dir(paths, model_dir) / f"{MODEL_NAME}.nww"
    interpreter = NanoInterpreter.load_model(str(model_path), cascade=True,
                                             device=device)
    if not interpreter.cascade_config:
        sys.exit("[cascade] no lite gate found - run the -d stage first")
    gate_key = interpreter.cascade_config["gate"]
    verifier_key = interpreter.cascade_config["verifier"]
    gate_thr = interpreter.cascade_config["gate_threshold"]
    print(f"[cascade] gate={gate_key} verifier={verifier_key} "
          f"gate_threshold={gate_thr} threshold={THRESHOLD} "
          f"patience={PATIENCE} device={device}")

    op = {"threshold": THRESHOLD, "patience": PATIENCE}
    sweep_path = paths.work / "sweep.json"
    if sweep_path.exists():
        sel = json.loads(sweep_path.read_text())["operating_point"]
        op = {"threshold": sel["threshold"], "patience": sel["patience"]}
        print(f"[cascade] using swept operating point: {op}")

    results = {"model": model_path.name, "gate": gate_key,
               "gate_threshold": gate_thr, **op}
    rates, near = {}, {}
    trace_dir = paths.work / "traces_cascade"
    trace_dir.mkdir(parents=True, exist_ok=True)
    for name in EVAL_SETS:
        files = get_limited_files(str(paths.eval / name), None)
        v_traces, g_traces, kept, times = [], [], [], []
        seconds, skipped = 0.0, 0
        t0 = time.perf_counter()
        for i, f in enumerate(files):
            audio = load_audio(f)
            if audio is None:
                skipped += 1
                continue
            seconds += len(audio) / SR
            interpreter.reset()
            v_row, g_row = [], []
            for s in range(0, len(audio), 1280):
                chunk = audio[s:s + 1280]
                if len(chunk) < 1280:
                    break
                t1 = time.perf_counter()
                res = interpreter.predict(chunk.astype(np.int16))
                times.append(time.perf_counter() - t1)
                v_row.append(res.get(verifier_key, 0.0))
                g_row.append(res.get(gate_key, 0.0))
            v_traces.append(np.asarray(v_row, np.float32))
            g_traces.append(np.asarray(g_row, np.float32))
            kept.append(os.path.basename(f))
            if (i + 1) % 50 == 0:
                print(f"  [cascade {name}] {i + 1}/{len(files)} "
                      f"({(i + 1) / (time.perf_counter() - t0):.1f} "
                      f"files/s)", flush=True)
        rates[name] = _rate(len(kept), seconds, time.perf_counter() - t0,
                            times)
        vt = np.stack(v_traces)
        gt = np.stack(g_traces)
        np.save(trace_dir / f"{name}_verifier.npy", vt)
        np.save(trace_dir / f"{name}_gate.npy", gt)
        (trace_dir / f"{name}_files.json").write_text(json.dumps(kept))
        det = _patience_detect(vt, op["threshold"], op["patience"])
        hours = seconds / 3600.0
        # the verifier counts only on gate-cleared chunks
        invoke_rate = float((gt >= gate_thr).mean())
        entry = {"files": len(vt), "hours": round(hours, 3),
                 "verifier_invocation_rate": round(invoke_rate, 4)}
        if name.startswith("positive"):
            entry["miss_rate_pct_patience"] = round(
                100.0 * (1 - det.sum() / max(len(det), 1)), 2)
        else:
            entry["false_alarm_files_patience"] = int(det.sum())
            entry["fa_per_hour_patience"] = round(
                det.sum() / max(hours, 1e-9), 3)
        entry["skipped_files"] = skipped
        results[name] = entry
        near[name] = {"verifier": near_threshold(vt, op["threshold"],
                                                 op["patience"], kept),
                      "gate": near_threshold(gt, gate_thr, 1, kept)}
        print(f"  {name}: {entry}; {rates[name]['files_per_s']:.1f} "
              f"files/s, chunk p50 {rates[name]['chunk_ms_p50']:.3f} ms")

    rates_inv = [results[n]["verifier_invocation_rate"] for n in EVAL_SETS
                 if n.startswith("negative") or n == "noise"]
    results["verifier_skip_rate_negatives"] = round(
        1.0 - float(np.mean(rates_inv)), 4)
    results["device"] = _device_name(device)
    results["rate"] = rates
    results["near_threshold"] = near
    out = paths.work / "eval_cascade.json"
    out.write_text(json.dumps(results, indent=2))
    print(f"[cascade] wrote {out}")
    return results


# --------------------------------------------------------------------------
# report
# --------------------------------------------------------------------------

REFERENCE_ANECDOTES = {
    "stable_loss": 0.0086, "avg_pos_logit": 5.447, "avg_neg_logit": -5.721,
    "false_positive_rate": "<1 per 16-28 h (real-world audio)",
    "source": "the upstream nanowakeword README.md:325-333"}


def stage_report(*, work=None, out=None):
    """Merge eval.json, eval_lite.json, the sweep's operating point,
    eval_cascade.json and the journal's final training report into
    `<out>/results.json`, and copy the trained artifacts and the config
    into `out`. `out` is required and may not be the repository's
    campaign/ folder."""
    if out is None:
        raise ValueError("stage_report needs `out`, the folder to write "
                         "results.json into")
    out = Path(out).resolve()
    if out == COMMITTED.resolve() or COMMITTED.resolve() in out.parents:
        raise ValueError(f"refusing to write into {COMMITTED}: the "
                         "committed campaign record is the JAX package's")
    paths = _paths(work)
    out.mkdir(parents=True, exist_ok=True)
    merged = {}
    for suffix in ("", "_lite"):
        p = paths.work / f"eval{suffix}.json"
        if p.exists():
            merged["full_model" if not suffix else "lite_gate"] = (
                json.loads(p.read_text()))
    for src, dest in (("sweep.json", "operating_point_sweep"),
                      ("eval_cascade.json", "cascade")):
        p = paths.work / src
        if p.exists():
            data = json.loads(p.read_text())
            merged[dest] = (data if dest != "operating_point_sweep"
                            else {"operating_point": data["operating_point"],
                                  "selection_rule": data["selection_rule"]})
    # training final report (stable loss + logit margins) from the journal
    db = paths.trained / ".cache" / "journal_cache" / "training_history.json"
    if db.exists():
        runs = json.loads(db.read_text())
        if runs:
            merged["training_final_report"] = runs[-1].get("metrics", {})
    merged["reference_anecdotes"] = dict(REFERENCE_ANECDOTES)
    (out / "results.json").write_text(json.dumps(merged, indent=2))

    for suffix in ("", "_lite"):
        src = _model_dir(paths) / f"{MODEL_NAME}{suffix}.nww"
        if src.exists():
            shutil.copy2(src, out / src.name)
    shutil.copy2(paths.config, out / "config_hey_nano.yaml")
    print(f"[report] wrote {out}/results.json + artifacts")
    return merged


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("stage", choices=["prep", "pipeline", "evaluate",
                                      "evaluate_lite", "sweep", "cascade",
                                      "report", "all"])
    ap.add_argument("--stages", default="GtTd",
                    help="pipeline stages subset, e.g. 'GT'")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--overwrite", action="store_true",
                    help="pipeline: regenerate existing feature files")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="folder for results.json and the artifacts "
                         "(required by report and all)")
    args = ap.parse_args(argv)
    if args.stage in ("report", "all") and not args.out:
        ap.error(f"{args.stage} needs --out (the port never writes into "
                 "the repository's campaign/)")

    stages = {
        "prep": lambda: stage_prep(force=args.force),
        "pipeline": lambda: stage_pipeline(args.stages,
                                           overwrite=args.overwrite,
                                           device=args.device),
        "evaluate": lambda: stage_evaluate(device=args.device),
        "evaluate_lite": lambda: stage_evaluate(model_suffix="_lite",
                                                device=args.device),
        "sweep": stage_sweep,
        "cascade": lambda: stage_evaluate_cascade(device=args.device),
        "report": lambda: stage_report(out=args.out),
    }
    # `all` runs the stages in this one process: the port's device is an
    # argument, not a process-global backend
    for name in (list(stages) if args.stage == "all" else [args.stage]):
        if args.stage == "all":
            print(f"[all] === {name} ===", flush=True)
        stages[name]()


if __name__ == "__main__":
    main()
