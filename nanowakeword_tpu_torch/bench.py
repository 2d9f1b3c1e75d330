"""Throughput benchmark of the PyTorch port: 1-sec clips/s per card (mel +
embedding + CRNN), the counterpart of the repository's `bench.py`.

    python -m nanowakeword_tpu_torch.bench [--all] [--device cpu]

The headline is end-to-end audio -> wake-word score throughput of the CRNN
configuration (int16 wav -> the mel kernel -> the bundled speech encoder ->
CRNN -> sigmoid, all in bf16) on audio resident on the card. Beside it: the
device time of one fused 80 ms streaming step (`on_chip_frame_ms`), the p50
of that step with one host fetch per frame, and the mel kernel against its
plain version (the tripwire). `--all` measures the five configurations of
`bench.py::bench_all`.

Each function has the name and the size parameters of its counterpart in
`bench.py`, so the two can be read side by side. Where JAX chains the
iterations inside one jitted `fori_loop`, the port captures one iteration
into a `torch.cuda.CUDAGraph` (utils/cuda_graph.py, as the interpreter's
one-call streaming step does) and replays it: each replay adds its score
sum to one device scalar, which the host fetches once at the end. On the
CPU (`--device cpu`, as the tests run it) the same steps run eagerly, and
the kernels' wrappers take their plain versions.

Prints ONE JSON line with `bench.py`'s headline keys, without `vs_baseline`
(its denominator is a TPU target) and with `card` (the card's name and power
limit, as nvidia-smi reports them). A failing phase raises: no measurement
is dropped silently.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from nanowakeword_tpu_torch.convert import encoder_state_dict_from_flax
from nanowakeword_tpu_torch.data.features import (CHUNK, EMB_OFFSET,
                                                  AudioFeatures,
                                                  default_encoder_variables)
from nanowakeword_tpu_torch.models.embedding import encoder_from_state_dict
from nanowakeword_tpu_torch.models.model import Model
from nanowakeword_tpu_torch.ops import mel_cuda, mix_cuda
from nanowakeword_tpu_torch.ops.augment import (AugmentDraws, AugmentParams,
                                                augment_batch, draw_augment,
                                                draw_spec_masks, spec_augment)
from nanowakeword_tpu_torch.ops.mel_cuda import mel_frontend_fused
from nanowakeword_tpu_torch.train.optim import Optimizer
from nanowakeword_tpu_torch.train.step import make_train_step
from nanowakeword_tpu_torch.utils.cuda_graph import capture_graph

METRIC = "1sec_clips_per_sec_per_chip_mel+embed+crnn_forward"
WINDOW = 16         # feature frames the classifiers see
# the CRNN of build_forward and the streaming steps (bench.py:33-41)
CRNN_CONFIG = {"activation_function": "relu", "embedding_dim": 96,
               "crnn_cnn_channels": [16, 32, 32], "crnn_rnn_type": "gru"}
# bench_all's widths (bench.py:243-247)
BASE = {"activation_function": "relu", "embedding_dim": 64,
        "crnn_cnn_channels": [16, 32, 32], "crnn_rnn_type": "gru",
        "transformer_d_model": 128, "transformer_n_head": 4,
        "conformer_d_model": 144, "conformer_n_head": 4,
        "quartznet_config": [[256, 33, 1], [256, 33, 1], [512, 39, 1]]}
# bench_all's batch and depths (bench.py:224, 210, 334, 385): clips per
# batch, iterations per timed chain, training steps per chain, streaming
# steps per family
ALL_BATCH = 2048
ALL_ITERS = 256
TRAIN_STEPS = 16
STREAM_STEPS = 60


def _model(name: str, model_type: str, config: dict, device) -> Model:
    return Model(config=dict(config), model_name=name,
                 input_shape=(WINDOW, 96), model_type=model_type,
                 layer_dim=64, n_blocks=2, dropout_prob=0.0, device=device)


def _bf16_encoder(device) -> torch.nn.Module:
    """The bundled encoder (the shipped asset) in bf16 on `device`."""
    return encoder_from_state_dict(encoder_state_dict_from_flax(
        default_encoder_variables()), device).to(torch.bfloat16)


def _classify(module, encoder, mel: torch.Tensor) -> torch.Tensor:
    """[B, frames, 32] log-mel -> [B, 1] scores: the encoder on the mel past
    EMB_OFFSET, left-padded with zeros to 16 frames, then the classifier in
    its own dtype and a sigmoid (bench.py:58-64, 279-283)."""
    emb = encoder(mel[:, EMB_OFFSET:])
    feats = F.pad(emb, (0, 0, WINDOW - emb.shape[1], 0))
    dtype = next(module.parameters()).dtype
    return torch.sigmoid(module(feats.to(dtype)))


class _Captured:
    """`step` (no arguments; reads and writes tensors that stay in place) as
    one CUDA graph on a CUDA device (utils/cuda_graph.py, `state` put back
    after the warm-up), replayed by each call, or run eagerly on the CPU.
    Replays count their mel kernel launches (`mel_launches` per replay)."""

    def __init__(self, step, device, state=()):
        self.step = step
        self.graph = None
        self.mel_launches = 0
        if torch.device(device).type == "cuda":
            self.graph, self.mel_launches = capture_graph(step, device, state)

    def __call__(self) -> None:
        if self.graph is None:
            self.step()
            return
        self.graph.replay()
        mel_cuda.count_replayed(self.mel_launches)


def _best_chain(run, acc: torch.Tensor, iters: int, reps: int) -> float:
    """Best host seconds of `iters` calls of `run` ended by one value fetch
    of `acc`, over `reps` chains after a warm-up chain."""
    def chain():
        for _ in range(iters):
            run()
        return float(acc)      # a value fetch: real synchronisation

    chain()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        chain()
        best = min(best, time.perf_counter() - t0)
    return best


def _check_mel_per_replay(run: _Captured, expected: int, what: str) -> None:
    if run.graph is not None and run.mel_launches != expected:
        raise RuntimeError(f"{what}: {run.mel_launches} mel kernel launches "
                           f"per replay, expected {expected}")


def build_forward(device="cuda"):
    """-> (forward, model, encoder): `forward(audio)` scores int16 [B, n]
    audio by the mel kernel (bf16 out), the bundled encoder in bf16 and a
    fresh CRNN (16/32/32 + bi-GRU 64, seed 10) with every float32 variable,
    BatchNorm statistics included, cast to bf16."""
    model = _model("bench_crnn", "crnn", CRNN_CONFIG, device)
    model.module.to(torch.bfloat16)
    encoder = _bf16_encoder(device)

    @torch.no_grad()
    def forward(audio: torch.Tensor) -> torch.Tensor:
        mel = mel_frontend_fused(audio, out_dtype=torch.bfloat16)
        return _classify(model.module, encoder, mel).reshape(-1)

    return forward, model, encoder


def bench_throughput(batch: int = 4096, iters: int = 256,
                     device="cuda") -> float:
    """Clips/s of `build_forward` on int16 [batch, 16000] resident on the
    device: `iters` chained forwards, one fetch, best of 3."""
    forward, _, _ = build_forward(device)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(np.asarray(
        rng.integers(-16000, 16000, (batch, 16000)), np.int16)).to(device)
    acc = torch.zeros((), device=device)

    def step():
        acc.add_(forward(audio).float().sum())

    run = _Captured(step, device, state=(acc,))
    _check_mel_per_replay(run, 1, "the captured forward")
    return batch * iters / _best_chain(run, acc, iters, reps=3)


def _stream_step(features: AudioFeatures, module):
    """-> (chunk, score, step): the fused 80 ms step of bench.py:133-137 on
    tensors that stay in place. `step()` streams `chunk` [1280] through
    `features` (its rings written in place) and writes the sigmoid of the
    classifier on the newest 16 feature frames into `score`."""
    chunk = torch.zeros(CHUNK, device=features.device)
    score = torch.zeros((), device=features.device)

    @torch.no_grad()
    def step():
        features.stream_step_(chunk)
        feats = features.state.feat_buf[-WINDOW:][None]
        score.copy_(torch.sigmoid(module(feats).reshape(())))

    return chunk, score, step


def _stream_p50_ms(features: AudioFeatures, module, chunk_host: np.ndarray,
                   warmup: int, n_frames: int) -> float:
    """p50 host ms of the captured streaming step on one repeated chunk,
    each step ended by a value fetch of its score."""
    chunk, score, step = _stream_step(features, module)
    chunk.copy_(torch.from_numpy(chunk_host))
    run = _Captured(step, features.device, state=tuple(features.state))
    _check_mel_per_replay(run, 1, "the captured streaming step")
    for _ in range(warmup):
        run()
        float(score)
    times = []
    for _ in range(n_frames):
        t0 = time.perf_counter()
        run()
        float(score)          # value fetch = real synchronisation
        times.append(time.perf_counter() - t0)
    return float(np.percentile(times, 50) * 1000.0)


def bench_stream_latency(n_frames: int = 200, device="cuda") -> float:
    """p50 latency of one fused 80 ms streaming step (mel + embed + score in
    one replay of a captured graph), with a value fetch per step."""
    model = _model("bench_stream", "crnn", CRNN_CONFIG, device)
    features = AudioFeatures(device=device)
    rng = np.random.default_rng(0)
    chunk = rng.integers(-16000, 16000, 1280).astype(np.float32)
    return _stream_p50_ms(features, model.module, chunk, 4, n_frames)


def bench_on_chip_frame_latency(k_frames: int = 512, reps: int = 5,
                                device="cuda") -> float:
    """Device ms per frame: K different chunks stepped with no host sync
    between them (a device-to-device copy of chunk k into the step's input,
    then a replay), one fetch at the end, best of `reps`, divided by K."""
    model = _model("bench_onchip", "crnn", CRNN_CONFIG, device)
    features = AudioFeatures(device=device)
    rng = np.random.default_rng(0)
    chunks = torch.from_numpy(np.asarray(
        rng.integers(-16000, 16000, (k_frames, 1280)), np.float32)).to(device)
    chunk, score, step = _stream_step(features, model.module)
    run = _Captured(step, device, state=tuple(features.state))
    _check_mel_per_replay(run, 1, "the captured streaming step")
    total = torch.zeros((), device=device)

    def run_k():
        features.reset()
        for k in range(k_frames):
            chunk.copy_(chunks[k])
            run()
            total.add_(score)
        return float(total)   # value fetch = real sync

    run_k()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run_k()
        best = min(best, time.perf_counter() - t0)
    return best / k_frames * 1000.0


def _fetch_timed(fn, *args, iters: int = 256, per_item: int = 1) -> float:
    """Items/s of `fn(*args)`: `iters` chained calls (one captured graph,
    replayed) and one value fetch, best of 2, as bench_throughput."""
    device = args[-1].device
    acc = torch.zeros((), device=device)

    @torch.no_grad()
    def step():
        acc.add_(fn(*args).float().sum())

    run = _Captured(step, device, state=(acc,))
    return per_item * iters / _best_chain(run, acc, iters, reps=2)


def _upload(t: torch.Tensor, device) -> torch.Tensor:
    """A host draw to `device`, from pinned memory: no host sync."""
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _all_inputs(rng, batch: int, device):
    """bench_all's inputs, drawn from `rng` in its order (bench.py:258-298):
    [batch, 16, 96] features, int16 [batch, 16000] audio, and the training
    chain's labels and background."""
    def to_device(x):
        return torch.from_numpy(np.asarray(x)).to(device)

    feats16 = to_device(rng.normal(size=(batch, WINDOW, 96))
                        .astype(np.float32))
    audio1s = to_device(rng.integers(-16000, 16000, (batch, 16000))
                        .astype(np.int16))
    labels = to_device((rng.random(batch) < 0.5).astype(np.float32))
    bg = to_device(rng.integers(-2000, 2000, (batch, 16000))
                   .astype(np.float32))
    return feats16, audio1s, labels, bg


def _augment_inputs(audio, bg) -> tuple:
    """The training chain's arguments of `_augment` after the generator:
    full-length foreground, a background on every clip, no RIR."""
    batch, device = audio.shape[0], audio.device
    return (audio, bg, torch.zeros((batch, 1600), device=device),
            np.full(batch, audio.shape[1], np.int64),
            torch.ones(batch, dtype=torch.bool, device=device),
            torch.zeros(batch, dtype=torch.bool, device=device),
            AugmentParams.from_settings({"rir_prob": 0.0}))


def _augment(generator, audio, bg, rirs, fg_lens, has_bg, has_rir,
             params) -> torch.Tensor:
    """One fresh augmentation of the chain (the mix kernel), its draws made
    from `generator`. -> int16 audio."""
    device = audio.device
    draws = draw_augment(fg_lens, audio.shape[1], params, generator)
    return augment_batch(audio, bg, rirs, fg_lens, has_bg, has_rir, params,
                         draws=AugmentDraws(*(_upload(t, device)
                                              for t in draws)))


def _train_with_aug(step_fn, generator, encoder, labels, aug_inputs):
    """One training step on freshly augmented audio (bench.py:300-325):
    augmentation (the mix kernel), the mel kernel on its int16 output,
    SpecAugment, the bf16 encoder, left-pad to 16 frames, one step. Every
    draw comes from `generator`, fresh at each call. -> the loss (on the
    device)."""
    device = labels.device
    aug = _augment(generator, *aug_inputs)
    with torch.no_grad():
        mel = mel_frontend_fused(aug, out_dtype=torch.bfloat16)
        masks = [(axis, _upload(starts, device), _upload(widths, device))
                 for axis, starts, widths in draw_spec_masks(
                     *mel.shape, generator=generator)]
        mel = spec_augment(mel, masks)
        emb = encoder(mel[:, EMB_OFFSET:])
        feats = F.pad(emb, (0, 0, WINDOW - emb.shape[1], 0)).float()
    return step_fn(feats, labels).loss


def bench_all(batch: int = ALL_BATCH, device="cuda") -> dict:
    """The five BASELINE configs, reported as items/s each (stream p50 in
    ms); each result is printed as it comes."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    results = {}

    def build(mt):
        return _model(f"b_{mt}", mt, BASE, device)

    def emit(k, v):
        results[k] = v
        print(f"{k}: {v:,.1f}", flush=True)

    encoder = _bf16_encoder(device)
    feats16, audio1s, labels, bg = _all_inputs(rng, batch, device)

    # 1. DNN scoring precomputed features (evaluate_model_with_features path)
    dnn = build("dnn")
    emit("dnn_features_scores_per_s", _fetch_timed(
        lambda f: torch.sigmoid(dnn.module(f)), feats16, iters=ALL_ITERS,
        per_item=batch))

    def from_audio(module):
        return lambda a: _classify(
            module, encoder, mel_frontend_fused(a, out_dtype=torch.bfloat16))

    # 2. CNN + GRU end-to-end wav -> score (evaluate_model_with_audio path)
    for mt in ("cnn", "gru"):
        emit(f"{mt}_e2e_clips_per_s", _fetch_timed(
            from_audio(build(mt).module), audio1s, iters=ALL_ITERS,
            per_item=batch))

    # 3. CRNN training step with augmentation (noise mix + SpecAugment), in
    # float32 and in bf16, each chain from the same initial weights
    crnn = build("crnn").train()
    initial = copy.deepcopy(crnn.module.state_dict())
    generator = torch.Generator().manual_seed(0)
    targs = (generator, encoder, labels, _augment_inputs(audio1s, bg))
    for metric, dtype in (("crnn_train_aug_clips_per_s", "float32"),
                          ("crnn_train_aug_bf16_clips_per_s", "bfloat16")):
        crnn.module.load_state_dict(initial)
        optimizer = Optimizer(list(crnn.module.parameters()),
                              {"optimizer_type": "adamw",
                               "learning_rate_max": 1e-3,
                               "lr_scheduler_type": "onecycle"}, 1000)
        step = make_train_step(crnn.module, optimizer, compute_dtype=dtype)

        def train_chain():
            loss = None
            for _ in range(TRAIN_STEPS):
                loss = _train_with_aug(step, *targs)
            return float(loss)   # one sync for the whole chain

        mel_before, mix_before = mel_cuda.launches, mix_cuda.launches
        train_chain()            # warm
        t0 = time.perf_counter()
        train_chain()
        emit(metric, batch * TRAIN_STEPS / (time.perf_counter() - t0))
        if device.type == "cuda" and not (mel_cuda.launches > mel_before
                                          and mix_cuda.launches > mix_before):
            raise RuntimeError(f"{metric}: the chain launched the mel kernel "
                               f"{mel_cuda.launches - mel_before} and the "
                               f"mix kernel {mix_cuda.launches - mix_before} "
                               f"times")

    # 4. BcResNet + QuartzNet feature-extraction + scoring throughput
    for mt in ("bcresnet", "quartznet"):
        emit(f"{mt}_feature_clips_per_s", _fetch_timed(
            from_audio(build(mt).module), audio1s, iters=ALL_ITERS,
            per_item=batch))

    # 5. Conformer + Transformer stateful frame-by-frame streaming
    for mt in ("conformer", "transformer"):
        m = build(mt)
        chunk = rng.integers(-16000, 16000, 1280).astype(np.float32)
        emit(f"{mt}_stream_p50_ms", _stream_p50_ms(
            AudioFeatures(device=device), m.module, chunk, 3, STREAM_STEPS))

    return results


def check_mel_kernel_exact(atol: float = 2e-3, device="cuda") -> float:
    """The tripwire: the mel kernel against its plain version on the card,
    on rng(7) [8, 16000] audio. As float32 it must agree within `atol` (the
    bar of tests/test_mel_pallas.py); as int16 it must be equal bit for
    bit. Raises on divergence. -> the float32 input's max |diff|."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(np.asarray(
        rng.integers(-20000, 20000, (8, 16000)), np.int16)).to(device)
    exact = (mel_frontend_fused(x) - mel_cuda.mel_frontend_plain(x)).abs()
    if exact.max().item() != 0.0:
        raise AssertionError(f"the mel kernel differs from its plain version "
                             f"on int16 audio: max|diff|={exact.max().item()}")
    xf = x.float()
    err = (mel_frontend_fused(xf)
           - mel_cuda.mel_frontend_plain(xf)).abs().max().item()
    if err > atol:
        raise AssertionError(f"the mel kernel diverges from its plain "
                             f"version: max|diff|={err}")
    return err


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def headline(mel_err: float, device="cuda") -> dict:
    """The headline's JSON object: throughput, the streaming p50 and the
    on-chip frame time measured on `device`, beside the tripwire's
    `mel_err`."""
    throughput = bench_throughput(device=device)
    p50_ms = bench_stream_latency(device=device)
    on_chip_ms = bench_on_chip_frame_latency(device=device)
    return {
        "metric": METRIC,
        "value": round(throughput, 1),
        "unit": "clips/s",
        # device time per 80 ms frame (K frames chained, one fetch)
        "on_chip_frame_ms": round(on_chip_ms, 4),
        # kernel vs plain on float32 audio (bar 2e-3); int16 is equal
        "mel_kernel_max_abs_diff": round(mel_err, 6),
        # one step with its host fetch
        "p50_stream_frame_latency_ms": round(p50_ms, 3),
        "note": ("Throughput: chained replays of one captured CUDA graph "
                 "of the bf16 forward on device-resident int16 audio, one "
                 "value fetch, host clock, best of 3. on_chip_frame_ms: "
                 "chained replays of the captured streaming step, each "
                 "after a device-to-device copy of its chunk, one fetch, "
                 "best of 5. p50 includes one host fetch per frame. On the "
                 "CPU the same steps run eagerly."),
        "card": card_line(device),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m nanowakeword_tpu_torch.bench",
        description="Throughput benchmark of the PyTorch port.")
    parser.add_argument("--all", action="store_true",
                        help="the five configurations of bench_all")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (pass --device cpu to run "
                         "on the CPU)")

    if args.all:
        results = bench_all(device=device)
        for k, v in results.items():
            print(f"{k:>40}: {v:,.1f}")
        return

    mel_err = check_mel_kernel_exact(device=device)  # raises on divergence
    print(json.dumps(headline(mel_err, device)))


if __name__ == "__main__":
    sys.exit(main())
