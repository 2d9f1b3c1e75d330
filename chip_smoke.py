#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (nanowakeword_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the root of the repository

It builds the port's CUDA kernels from the checkout and holds each against
its plain PyTorch version. It drives the serving path through the entry
points a user calls (batch scoring with `AudioFeatures.embed_clips` and a
session, and the streaming cascade `NanoInterpreter.load_model(...,
cascade=True)`), and compares the card's scores with the same port run on
the CPU. Then it drives the training path: the `-t` transform stage
(augmentation with the mix kernel, then features with the mel kernel) on
synthesized wavs, `-T` device-cached training of the shipped CRNN at full
width, one training step on the card against the CPU, and the exported
`.nww` served by the interpreter on the card. Then the rest of the serving
side: a stateful `streaming_gru` model streamed with its carry, the one-call
streaming step (a replayed CUDA graph) against the same step run eagerly,
and the remote-verifier server's scoring path with dynamic batching under
64 streaming connections and 256 concurrent feature requests (and over a
loopback WebSocket where `websockets` is installed). Then the rest of the
training side: every other family of the model zoo at its default width
through `save_nww` and the interpreter, the host training loop (`-T` without
`device_cache`) for the shipped CRNN and a conformer with a checkpoint and a
resumed run held against the straight run, bf16 training, and distillation
of the lite gate from the shipped artifact, which the cascade then serves.
Last, the campaign from text: clip generation (`-G`) and `-t` on a task
list in the shipped campaign's schema, end-to-end training of the bundled
encoder and the shipped CRNN from those WAVs with the mel kernel in every
step's forward, one such step on the card against the CPU, and the result
served on the card against the CPU. Then ONNX on the card: the shipped
cascade exported to `.onnx` and streamed against the `.nww` cascade, batch
scoring, every family's graph against its module, a stateful graph's
threaded state, the server on an `.onnx`, the numpy frontend graphs, and
the `.onnx` files that `-T`, `-d` and end-to-end training write. Last,
encoder pretraining: the recipe of the bundled v4 encoder at full width
and cut depth through `pretrain_encoder` (the mel kernel in every step),
three steps on the card against the CPU, a resumed run at the mix kernel's
clip length against a straight one, the transfer eval of the bundled asset
against the JAX package's gates, the new asset served, and a custom module
exported to `.onnx` through torch.fx and served. Then the native runtime
and data and tensor parallelism. Last, the quality campaign through the
port's tool (nanowakeword_tpu_torch/tools/quality_campaign.py): eval sets
cut to the first files of the JAX tool's, the committed cascade judged on
the card (one graph capture per interpreter, one mel launch per chunk,
card vs CPU), the bars of tests/test_quality_campaign.py, the report, the
campaign's `-G -t -T -d` at cut depth with its model judged, and the
encoder ship decision at 12 pairs. It times both kernels against their
plain versions, batch scoring, streaming latency (eager, replayed and
`.onnx`), the server's requests per second, the transform stage, training
steps of both loops in float32 and bf16, each family's forward (module and
`.onnx`), distillation steps, clip generation, end-to-end steps,
pretraining steps and the campaign's evaluation rate.

Phases print progress lines. Every check raises on failure, so any failed
phase exits non-zero. The line before the last is a JSON object with the
kernels' results; the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a CUDA device, or outside the repository, it exits non-zero before
printing any result. It never imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
CRNN = os.path.join(ROOT, "campaign", "hey_nano_crnn.nww")
SEED = 0
KERNEL_TOL = 2e-3   # kernel vs plain log-mel on float audio
                    # (tests/test_mel_pallas.py bar); int16 audio must be equal
HBM_BYTES_PER_S = 3.35e12       # H100 SXM peaks (NVIDIA's data sheet)
BF16_FLOP_PER_S = 989e12
FP64_TC_FLOP_PER_S = 67e12      # FP64 tensor cores (NVIDIA's H100 data sheet)
SCORE_TOL = 1e-3    # card vs CPU scores (tests/test_score_trace.py bar)
MIX_ULPS = 2.0 ** -22   # mix kernel vs plain, of max(|plain|, 1)
                        # (tests/test_mix_pallas.py); 0 is expected
CARRY_TOL = 1e-5    # a carry threaded over 50 one-frame calls vs one call
BATCH_TOL = 1e-5    # a request scored in a batch vs alone (the libraries
                    # may choose by shape)
RESUME_TOL = 1e-5   # a resumed run vs the straight run, if not bit for bit
STEP_RTOL = 1e-4    # one training step, card vs CPU: loss and grad norm
WEIGHT_TOL = 1e-5   # ... and the updated weights and BatchNorm statistics
NORM64_RTOL = 1e-5  # a pretraining step's grad norm, card (float32) vs float64
# the shipped configuration (campaign/config_hey_nano.yaml)
SHIPPED_AUGMENTATION = {"min_snr_in_db": 5.0, "max_snr_in_db": 30.0,
                        "pitch_prob": 0.5, "gain_prob": 1.0, "rir_prob": 0.5}
SHIPPED_CRNN = {"model_type": "crnn", "layer_size": 64, "n_blocks": 2,
                "embedding_dim": 96, "crnn_cnn_channels": [16, 32, 32],
                "crnn_rnn_type": "gru", "dropout_prob": 0.3,
                "activation_function": "relu", "optimizer_type": "adamw",
                "learning_rate_max": 0.0015, "lr_scheduler_type": "onecycle",
                "weight_decay": 0.01}
SHIPPED_COMPOSITION = {"t": 96, "pa": 28, "pah": 20, "wa": 16, "gen": 28,
                       "dn": 36, "nz": 32}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of fn on the card, by CUDA events."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mel_bound_ms(batch: int, n: int, fb_taps: int) -> tuple[float, str, float]:
    """(least time, what bounds it, float64 floor) of the log-mel on an
    int16 [batch, n] to f32: bytes at the memory rate against the hop DFT and
    the filterbank at the bf16 rate of their operands; the floor is the hop
    DFT at the FP64 tensor rate, which the kernel's float64 sums need."""
    frames = -(-n // 160)
    nbytes = batch * n * 2 + batch * frames * 32 * 4
    hop_flop = batch * (frames + 2) * 160 * 256 * 2
    flop = hop_flop + batch * frames * fb_taps * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", hop_flop / FP64_TC_FLOP_PER_S * 1e3)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nanowakeword_tpu_torch import AudioFeatures, NanoInterpreter
    from nanowakeword_tpu_torch.export.artifact import load_nww
    from nanowakeword_tpu_torch.interpreter.nanointerpreter import \
        _LocalSession
    from nanowakeword_tpu_torch.ops import _build, mel_cuda

    rng = np.random.default_rng(SEED)
    cuda = torch.device("cuda")

    # -- 1. the card -----------------------------------------------------------
    card = card_line()
    log(card)
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    # -- 2. the build: one nvcc per kernel and g++ for the host runtime, all
    # started together ---------------------------------------------------------
    t0 = time.perf_counter()
    names = ("mel_frontend", "mix_gain", "nww_runtime")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_build.build, names))
    for name, lib in zip(names, libs):
        log(f"[build] {os.path.relpath(lib, ROOT)} from "
            f"{os.path.relpath(_build._source(name), ROOT)}")
    log(f"[build] 2 kernels and the native runtime in "
        f"{time.perf_counter() - t0:.2f} s")

    # -- 3. the kernel against its plain version, on the card ------------------------
    def audio(shape, dtype):
        x = rng.integers(-20000, 20000, shape).astype(np.int16)
        return torch.from_numpy(x).to(cuda).to(dtype)

    def compare(x, label):
        out = mel_cuda.mel_frontend_cuda(x)
        torch.cuda.synchronize()
        ref = mel_cuda.mel_frontend_plain(x)
        check(out.shape == ref.shape, f"shape {tuple(out.shape)} vs "
              f"{tuple(ref.shape)}")
        err = (out - ref).abs().max().item()
        tol = 0.0 if x.dtype == torch.int16 else KERNEL_TOL
        log(f"[kernel] {label} {str(x.dtype)[6:]}: max|kernel - plain| = "
            f"{err:.3g} (bound {tol:g})")
        check(err <= tol, f"kernel vs plain {err} > {tol}")
        return err

    max_err = 0.0
    cases = [((1, 16000), torch.float32), ((4, 16000), torch.int16),
             ((5, 12345), torch.float32), ((16000,), torch.float32),
             ((2, 16000), torch.bfloat16),
             # the streaming step of the main path
             ((1600,), torch.float32)]
    for shape, dtype in cases:
        max_err = max(max_err, compare(audio(shape, dtype), str(shape)))
    # int16 edges at the test shape and at batch scoring's [1024, 32000]
    for shape in ((3, 48000), (1024, 32000)):
        for kind in mel_cuda.INT16_EDGES:
            x = mel_cuda.int16_edge_audio(rng, shape, kind)
            max_err = max(max_err, compare(torch.from_numpy(x).to(cuda),
                                           f"{shape} {kind}"))
    x = audio((4, 16000), torch.int16)
    f32 = mel_cuda.mel_frontend_cuda(x)
    b16 = mel_cuda.mel_frontend_cuda(x, out_dtype=torch.bfloat16)
    check(b16.dtype == torch.bfloat16
          and torch.equal(b16, f32.to(torch.bfloat16)),
          "bf16 output differs from the cast f32 output")
    log("[kernel] out_dtype=bf16 equals the cast f32 output")
    check(torch.equal(f32, mel_cuda.mel_frontend_cuda(x.float())),
          "int16 and float32 input differ")
    log("[kernel] int16 input equals the same samples as float32")

    # -- 4. batch scoring ----------------------------------------------------------------
    mel_cuda.reset_launches()
    header, model, encoder = load_nww(CRNN, device=cuda)
    features = AudioFeatures(encoder_state_dict=encoder, device=cuda)
    session = _LocalSession(model, header)
    clips = np.clip(rng.normal(0.0, 3000.0, (1024, 32000)), -32768,
                    32767).astype(np.int16)
    feats = features.embed_clips(clips, batch_size=256)
    scores = session.run_batch(feats)
    check(feats.shape == (1024, 16, 96), f"features {feats.shape}")
    check(scores.shape == (1024,) and np.isfinite(scores).all()
          and ((scores >= 0) & (scores <= 1)).all(), "scores malformed")
    batch_launches = mel_cuda.launches
    check(batch_launches > 0, "batch scoring did not launch the mel kernel")

    header_c, model_c, encoder_c = load_nww(CRNN, device="cpu")
    features_c = AudioFeatures(encoder_state_dict=encoder_c, device="cpu")
    feats_c = features_c.embed_clips(clips[:64])
    scores_c = _LocalSession(model_c, header_c).run_batch(feats_c)
    feat_err = float(np.abs(feats[:64] - feats_c).max())
    score_err = float(np.abs(scores[:64] - scores_c).max())
    log(f"[batch] [1024, 32000] int16 -> scores {scores.shape}, mean "
        f"{scores.mean():.4f}; mel kernel launches {batch_launches}; "
        f"card vs CPU on 64 clips: max|features| {feat_err:.3g}, "
        f"max|scores| {score_err:.3g}")
    check(score_err <= SCORE_TOL, f"batch card vs CPU {score_err}")

    # -- 5. streaming ------------------------------------------------------------------------
    clip = np.clip(rng.normal(0.0, 3000.0, 16000 * 4), -32768,
                   32767).astype(np.int16)

    def stream(device):
        interp = NanoInterpreter.load_model(CRNN, cascade=True,
                                            gate_threshold=0.0,
                                            device=device)
        check(interp.gate_name == "hey_nano_crnn_lite",
              f"cascade gate not found: {interp!r}")
        results = interp.predict_clip(clip)
        return interp, (np.array([r.gate_score for r in results]),
                        np.array([r.score for r in results]))

    interp, (gate, verifier) = stream(cuda)
    _, (gate_c, verifier_c) = stream("cpu")
    gate_err = float(np.abs(gate - gate_c).max())
    ver_err = float(np.abs(verifier - verifier_c).max())
    log(f"[stream] {interp!r}: {len(gate)} chunks, gate {gate[-1]:.4f}, "
        f"verifier {verifier[-1]:.4f}; card vs CPU max|gate| {gate_err:.3g}, "
        f"max|verifier| {ver_err:.3g}")
    check(gate_err <= SCORE_TOL and ver_err <= SCORE_TOL,
          "streaming card vs CPU")
    check(np.count_nonzero(verifier) > 0, "the verifier never scored")

    # streaming equals batch after warm-up (tests/test_features.py)
    pre = interp.preprocessor
    pre.reset()
    batch_frames = pre.embed_clips(clip[None])[0]             # [41, 96]
    stream_frames = []
    for c in range(len(clip) // 1280):
        pre(clip[c * 1280:(c + 1) * 1280])
        stream_frames.append(pre.get_features(1)[0, 0])
    worst = 0.0
    for c in range(9, len(stream_frames)):
        i = (8 * (c + 1) - 76) // 8
        np.testing.assert_allclose(stream_frames[c], batch_frames[i],
                                   rtol=1e-4, atol=2e-4)
        worst = max(worst, float(np.abs(stream_frames[c]
                                        - batch_frames[i]).max()))
    main_launches = mel_cuda.launches
    log(f"[stream] streaming == batch after warm-up: max|diff| {worst:.3g} "
        f"over {len(stream_frames) - 9} frames")
    log(f"[launches] mel kernel launches on the main path: {main_launches}")
    check(main_launches > batch_launches,
          "streaming did not launch the mel kernel")

    # -- 6. times ------------------------------------------------------------------------------
    fb_taps = sum(len(t) for t in mel_cuda.filterbank_taps(
        mel_cuda.melops.hopdft_tensors(torch.bfloat16, "cpu")[4]))
    mel_times = {}
    for n in (16000, 32000):
        x = audio((4096, n), torch.int16)
        max_err = max(max_err, compare(x, f"(4096, {n}) timed"))
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = (mel_cuda.mel_frontend_cuda if which == "kernel"
                  else mel_cuda.mel_frontend_plain)
            times[which].append(cuda_ms(lambda: fn(x), 20))
        bound, bound_by, fp64_floor = mel_bound_ms(4096, n, fb_taps)
        mel_times[n] = (min(times["kernel"]), min(times["plain"]), bound,
                        bound_by)
        log(f"[time] {card}: log-mel [4096, {n}] int16: kernel "
            f"{times['kernel']} ms, plain {times['plain']} ms (CUDA events, "
            f"mean of 20 after warm-up); bound {bound:.4f} ms ({bound_by}); "
            f"hop DFT at the FP64 tensor peak {fp64_floor:.4f} ms")
    # the yardstick: what the tensor cores do at the hop DFT's shape in bf16
    # (a different function; the port never calls it)
    rows = torch.randn(4096 * 102, 160, device=cuda).to(torch.bfloat16)
    basis = torch.randn(160, 256, device=cuda).to(torch.bfloat16)
    yard = cuda_ms(lambda: torch.matmul(rows, basis), 20)
    log(f"[time] {card}: yardstick bf16 torch.matmul [4096*102, 160] @ "
        f"[160, 256]: {yard} ms")
    del rows, basis
    kernel_ms, plain_ms, mel_bound, mel_bound_by = mel_times[16000]

    clips = np.clip(rng.normal(0.0, 3000.0, (4096, 32000)), -32768,
                    32767).astype(np.int16)
    runs = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.run_batch(features.embed_clips(clips, batch_size=4096))
        runs.append(time.perf_counter() - t0)
    best = min(runs[1:])
    log(f"[time] {card}: batch scoring [4096, 32000] int16 host -> scores: "
        f"{4096 / best:.1f} clips/s (best of {len(runs) - 1} after warm-up; "
        f"runs {[round(r, 4) for r in runs]} s)")

    interp.reset()
    lat = []
    for c in range(len(clip) // 1280):
        chunk = clip[c * 1280:(c + 1) * 1280]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        interp.predict(chunk)
        lat.append(time.perf_counter() - t0)
    lat_ms = np.array(lat[10:]) * 1e3
    log(f"[time] {card}: streaming predict per 80 ms chunk (cascade, "
        f"host clock): p50 {np.percentile(lat_ms, 50):.3f} ms, p90 "
        f"{np.percentile(lat_ms, 90):.3f} ms over {len(lat_ms)} chunks")

    # -- 7. the mix kernel against its plain version, on the card ---------------
    mix = mix_phase(rng, cuda, card)

    # -- 8-10 and 15-17. the training path --------------------------------------------
    with tempfile.TemporaryDirectory(prefix="nww_smoke_") as work:
        train = training_phases(rng, cuda, card, work)

    # -- 11-13. the rest of the serving side ------------------------------------------
    with tempfile.TemporaryDirectory(prefix="nww_smoke_") as work:
        serving_launches = stateful_phase(rng, cuda, work)
    serving_launches += one_call_step_phase(cuda, card)
    serving_launches += server_phase(rng, cuda, card)
    # -- 14. the rest of the zoo, served ------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="nww_smoke_") as work:
        serving_launches += zoo_phase(rng, cuda, card, work)
    serving_launches += train["cascade_launches"]
    log(f"[launches] mel kernel launches on the serving paths after phase "
        f"5: {serving_launches}")
    # -- 18. -G, -t and end-to-end training from the clips, served ------------
    with tempfile.TemporaryDirectory(prefix="nww_smoke_") as work:
        e2e = e2e_phase(rng, cuda, card, work)
    # -- 19. ONNX on the card ---------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="nww_smoke_") as work:
        onnx_launches = onnx_phase(rng, cuda, card, work)
    # -- 20. encoder pretraining, and a custom module's .onnx --------------------
    with tempfile.TemporaryDirectory(prefix="nww_smoke_") as work:
        pretrain = pretrain_phase(cuda, card, work)
    # -- 21. the native runtime; data and tensor parallelism ----------------
    runtime_phase(rng, e2e.pop("wavs"))
    parallel_launches = parallel_phase(rng, cuda, card)
    # -- 22. the quality campaign: the committed cascade judged, the
    # campaign's pipeline at cut depth ----------------------------------------
    with tempfile.TemporaryDirectory(prefix="nww_smoke_") as work:
        quality = quality_phase(cuda, card, Path(work))

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "nanowakeword_tpu"))
    check(not leaked, f"imported {leaked}")

    print(json.dumps({"kernels": [{
        "name": "mel_frontend",
        "route": "cuda",
        "source": "nanowakeword_tpu_torch/csrc/mel_frontend.cu",
        "replaces": "nanowakeword_tpu/ops/mel_pallas.py:269",
        "launches": (main_launches + serving_launches + e2e["mel"]
                     + onnx_launches + pretrain["mel"] + parallel_launches
                     + quality["mel"]),
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": mel_bound,
        "bound_by": mel_bound_by,
        "library_ms": None,
    }, {
        "name": "mix_gain",
        "route": "cuda",
        "source": "nanowakeword_tpu_torch/csrc/mix_gain.cu",
        "replaces": "nanowakeword_tpu/ops/mix_pallas.py:93",
        "launches": (train["mix_launches"] + e2e["mix"] + pretrain["mix"]
                     + quality["mix"]),
        "max_abs_err": mix["max_err"],
        "ms": mix["ms"],
        "plain_ms": mix["plain_ms"],
        "bound_ms": mix["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


ZOO = ("cnn", "lstm", "gru", "rnn", "transformer", "tcn", "quartznet",
       "conformer", "e_branchformer", "bcresnet")


def zoo_phase(rng, cuda, card, work) -> int:
    """Phase 14: every family beyond dnn / crnn / streaming_gru at
    `build_backbone`'s default widths (layer_size 128, n_blocks 2, input
    (16, 96)), weights from seed 0, through save_nww and load_model with
    the bundled encoder: one clip's scores on the card against the CPU;
    the forward at batch 256 by CUDA events. -> mel launches."""
    import numpy as np
    import torch
    from nanowakeword_tpu_torch import NanoInterpreter
    from nanowakeword_tpu_torch.data.features import \
        default_encoder_variables
    from nanowakeword_tpu_torch.export.artifact import save_nww
    from nanowakeword_tpu_torch.models.model import Model
    from nanowakeword_tpu_torch.ops import mel_cuda

    clip = np.clip(rng.normal(0.0, 3000.0, 16000 * 2), -32768,
                   32767).astype(np.int16)
    batch = torch.from_numpy(rng.normal(0, 1, (256, 16, 96)).astype(
        np.float32)).to(cuda)
    encoder = default_encoder_variables()
    mel_cuda.reset_launches()
    for model_type in ZOO:
        name = f"smoke_{model_type}"
        model = Model(config={}, model_name=name, model_type=model_type,
                      layer_dim=128, n_blocks=2, seed=SEED, device=cuda)
        path = save_nww(os.path.join(work, name + ".nww"), model=model,
                        config={}, model_name=name,
                        encoder_variables=encoder)
        traces = []
        for device in (cuda, "cpu"):
            interp = NanoInterpreter.load_model(path, device=device)
            traces.append(np.array([r.score
                                    for r in interp.predict_clip(clip)]))
        scores, scores_c = traces
        err = float(np.abs(scores - scores_c).max())
        check(len(scores) == 25 and np.isfinite(scores).all()
              and (scores[15:] > 0).all() and (scores <= 1).all(),
              f"{model_type} scores malformed")
        check(err <= SCORE_TOL, f"{model_type} card vs CPU {err}")
        with torch.no_grad():
            ms = cuda_ms(lambda: model.module(batch), 10)
        log(f"[zoo] {card}: {model_type}: {model.n_params()} parameters; "
            f"{len(scores)} chunks served, last score {scores[-1]:.4f}, card "
            f"vs CPU max|score| {err:.3g}; forward at batch 256: {ms:.4f} ms "
            f"(CUDA events, mean of 10 after warm-up)")
    launches = mel_cuda.launches
    check(launches >= len(ZOO) * 25,
          f"{launches} mel launches for {len(ZOO)} served families")
    return launches


def _tone_clip(seed: int):
    """4 s of int16 audio: 1.5 s near silence, 1.5 s of a modulated tone in
    the speech band (the VAD opens on it), 1 s of noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(24000) / 16000
    speech = (9000 * np.sin(2 * np.pi * 700 * t)
              * (0.6 + 0.4 * np.sin(2 * np.pi * 4 * t)))
    return np.concatenate([rng.normal(0, 30, 24000), speech,
                           rng.normal(0, 3000, 16000)]).astype(np.int16)


def stateful_phase(rng, cuda, work) -> int:
    """Phase 11: a `streaming_gru` model at its default width (1 layer of
    128 units), weights from seed 0, through save_nww and load_model; a 4 s
    clip streamed on the card against the CPU; the carry threaded over 50
    one-frame calls against one call on the 50 frames. -> mel launches."""
    import numpy as np
    import torch
    from nanowakeword_tpu_torch import NanoInterpreter
    from nanowakeword_tpu_torch.export.artifact import save_nww
    from nanowakeword_tpu_torch.models.model import Model
    from nanowakeword_tpu_torch.ops import mel_cuda

    model = Model(config={}, model_name="smoke_sgru",
                  model_type="streaming_gru", seed=SEED, device=cuda)
    check(model.stateful, "streaming_gru is not stateful")
    path = save_nww(os.path.join(work, "smoke_sgru.nww"), model=model,
                    config={}, model_name="smoke_sgru")
    clip = np.clip(rng.normal(0.0, 3000.0, 16000 * 4), -32768,
                   32767).astype(np.int16)
    mel_cuda.reset_launches()
    traces = []
    for device in (cuda, torch.device("cpu")):
        interp = NanoInterpreter.load_model(path, device=device)
        check(interp.is_stateful == {"smoke_sgru": True},
              f"is_stateful {interp.is_stateful}")
        scores = np.array([r.score for r in interp.predict_clip(clip)])
        carry = interp.hidden_states["smoke_sgru"]
        check(carry is not None and carry[0].device.type == device.type,
              "the carry left the device")
        traces.append((scores, carry[0].cpu().numpy()))
        interp.reset()
        check(interp.hidden_states["smoke_sgru"] is None, "reset kept a carry")
    launches = mel_cuda.launches
    (scores, carry), (scores_c, carry_c) = traces
    err = float(np.abs(scores - scores_c).max())
    carry_err = float(np.abs(carry - carry_c).max())
    log(f"[stateful] streaming_gru (n_params {model.n_params()}): "
        f"{len(scores)} chunks, last score {scores[-1]:.4f}; card vs CPU "
        f"max|score| {err:.3g}, max|carry| {carry_err:.3g}; mel launches "
        f"{launches}")
    check(len(scores) == 50 and np.isfinite(scores).all()
          and (scores[15:] > 0).all() and (scores <= 1).all(),
          "stateful scores malformed")
    check(err <= SCORE_TOL and carry_err <= SCORE_TOL,
          "stateful card vs CPU")
    check(launches >= 50, "the stateful stream did not launch the mel kernel")

    x = torch.from_numpy(rng.normal(0, 1, (1, 50, 96)).astype(
        np.float32)).to(cuda)
    with torch.no_grad():
        _, whole = model.module(x)
        threaded = None
        for t in range(50):
            _, threaded = model.module(x[:, t:t + 1], threaded)
    diff = (whole[0] - threaded[0]).abs().max().item()
    log(f"[stateful] carry after 50 one-frame calls vs one call on 50 "
        f"frames: max|diff| {diff:.3g} (bound {CARRY_TOL:g})")
    check(diff <= CARRY_TOL, f"threaded carry {diff}")
    return launches


def one_call_step_phase(cuda, card) -> int:
    """Phase 12: the shipped cascade with the VAD gate on. The replayed
    graph against the same step run eagerly (equal bit for bit) and against
    the CPU; per-chunk times of both. -> mel launches."""
    import numpy as np
    import torch
    from nanowakeword_tpu_torch import NanoInterpreter
    from nanowakeword_tpu_torch.ops import mel_cuda

    clip = _tone_clip(SEED)
    n_chunks = len(clip) // 1280

    def load(device):
        return NanoInterpreter.load_model(CRNN, cascade=True,
                                          gate_threshold=0.0,
                                          vad_threshold=0.3, device=device)

    def stream(interp):
        """-> (raw scores [chunks, 2], gated scores [chunks, 2], ms)."""
        interp.reset()
        interp.vad.reset()
        raw, gated, ms = [], [], []
        for c in range(n_chunks):
            chunk = clip[c * 1280:(c + 1) * 1280]
            if interp.preprocessor.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = interp.predict(chunk)       # ends with the scores on the host
            ms.append((time.perf_counter() - t0) * 1e3)
            raw.append([interp.raw_scores[n] for n in interp.models])
            gated.append([r.gate_score, r.score])
        return np.array(raw), np.array(gated), np.array(ms)

    mel_cuda.reset_launches()
    interp = load(cuda)
    step = interp._fused_step
    check(step is not None and step.graph is not None,
          "load_model did not capture the step")
    check(step.mel_launches_per_replay == 1,
          f"{step.mel_launches_per_replay} mel launches in the graph")
    step.use_graph = False
    raw_e, gated_e, ms_e = stream(interp)
    step.use_graph = True
    before = mel_cuda.launches
    raw_g, gated_g, ms_g = stream(interp)
    replay_launches = mel_cuda.launches - before
    launches = mel_cuda.launches
    _, gated_c, _ = stream(load("cpu"))

    check(replay_launches == n_chunks, f"{replay_launches} mel launches for "
          f"{n_chunks} replayed chunks")
    check(np.array_equal(raw_g, raw_e) and np.array_equal(gated_g, gated_e),
          f"replayed step differs from the eager step by "
          f"{np.abs(raw_g - raw_e).max()}")
    cpu_err = float(np.abs(gated_g - gated_c).max())
    opened = int(np.count_nonzero(gated_g[:, 1]))
    log(f"[step] {n_chunks} chunks, cascade + VAD gate: replayed == eager "
        f"bit for bit (raw and gated scores); card vs CPU max|score| "
        f"{cpu_err:.3g}; verifier scored on {opened} chunks, zeroed by the "
        f"VAD or warm-up on {n_chunks - opened}; mel launches: "
        f"{replay_launches} for {n_chunks} replays")
    check(cpu_err <= SCORE_TOL, f"one-call step card vs CPU {cpu_err}")
    check(0 < opened < n_chunks, "the VAD gate never opened or never closed")
    replay_ms = cuda_ms(step.graph.replay, 50)
    log(f"[time] {card}: one replay of the captured step alone (CUDA "
        f"events, mean of 50 back to back, no upload and no copy back): "
        f"{replay_ms:.4f} ms")
    for name, ms in (("eager step", ms_e), ("replayed graph", ms_g)):
        log(f"[time] {card}: streaming predict per 80 ms chunk, {name} "
            f"(cascade + VAD, host clock): p50 "
            f"{np.percentile(ms[10:], 50):.3f} ms, p90 "
            f"{np.percentile(ms[10:], 90):.3f} ms over {len(ms) - 10} chunks")
    return launches


def server_phase(rng, cuda, card) -> int:
    """Phase 13: the shipped CRNN behind the server's message coroutine and
    dynamic batcher: 64 concurrent `full` connections of 50 chunks (tag
    0x03), then 256 concurrent feature requests (tag 0x01); every request
    also scored alone, and a part of them on the CPU. -> mel launches."""
    import asyncio
    import json

    import numpy as np
    from nanowakeword_tpu_torch.interpreter import remote_verifier as rv
    from nanowakeword_tpu_torch.ops import mel_cuda

    n_conn, n_chunks, n_feat = 64, 50, 256
    audio = np.clip(rng.normal(0.0, 3000.0, (n_conn, n_chunks * 1280)),
                    -32768, 32767).astype(np.int16)
    feats = rng.normal(0, 1, (n_feat, 1, 16, 96)).astype(np.float32)

    def chunk_messages(i):
        return [rv.encode_audio(audio[i, c * 1280:(c + 1) * 1280])
                for c in range(n_chunks)]

    reply_ms = {}   # client -> host time from each message to its reply

    async def client(server, i):
        state = server.connection()
        out, reply_ms[i] = [], []
        for message in chunk_messages(i):
            t0 = time.perf_counter()
            out.append(json.loads(await server.reply(message, state))["score"])
            reply_ms[i].append((time.perf_counter() - t0) * 1e3)
            await asyncio.sleep(0)      # a socket would yield here
        return out

    calls = []      # the batch size of every device call of `server`

    async def load(server, conns):
        """-> (scores [conns, chunks], seconds, device calls so far,
        feature scores, seconds)."""
        server.start()
        t0 = time.perf_counter()
        streamed = await asyncio.gather(*[client(server, i) for i in conns])
        t1, stream_calls = time.perf_counter(), len(calls)
        burst = await asyncio.gather(*[
            server.reply(rv.encode_features(f), None) for f in feats])
        t2 = time.perf_counter()
        return (np.array(streamed), t1 - t0, stream_calls,
                np.array([json.loads(r)["score"] for r in burst]), t2 - t1)

    mel_cuda.reset_launches()
    server = rv._ScoringServer(CRNN, "full", device=cuda)
    run_batch = server.session.run_batch

    def counting_run_batch(f):
        calls.append(len(f))
        return run_batch(f)

    server.session.run_batch = counting_run_batch
    streamed, s_stream, stream_calls, burst, s_burst = asyncio.run(
        load(server, range(n_conn)))
    launches = mel_cuda.launches
    scored = int(np.count_nonzero(streamed))
    # replies of scored requests: each waited for its round's batch
    waited = np.array([reply_ms[i] for i in range(n_conn)])[streamed > 0]
    check(streamed.shape == (n_conn, n_chunks) and burst.shape == (n_feat,),
          "replies missing")
    for name, a in (("streamed", streamed), ("feature", burst)):
        check(np.isfinite(a).all() and ((a >= 0) & (a <= 1)).all(),
              f"{name} replies outside [0, 1]")
    check((streamed[:, :15] == 0).all() and (streamed[:, 15:] > 0).all(),
          "warm-up replies")
    check(launches == n_conn * n_chunks, f"{launches} mel launches for "
          f"{n_conn * n_chunks} audio messages")

    n_requests = scored + n_feat
    burst_calls = len(calls) - stream_calls
    log(f"[server] {n_conn} full connections x {n_chunks} chunks: "
        f"{n_conn * n_chunks} audio messages, {scored} scored, in "
        f"{stream_calls} device calls (batch sizes "
        f"{min(calls[:stream_calls])}-{max(calls[:stream_calls])}, "
        f"{stream_calls / scored:.3f} calls per scored request); {n_feat} "
        f"concurrent feature requests in {burst_calls} device calls")
    check(len(calls) < n_requests, f"{len(calls)} device calls for "
          f"{n_requests} requests")
    log(f"[time] {card}: server, {n_conn} concurrent full connections: "
        f"{n_conn * n_chunks / s_stream:.1f} audio messages/s "
        f"({scored / s_stream:.1f} scored requests/s; {s_stream:.3f} s, host "
        f"clock); {n_feat} concurrent feature requests: "
        f"{n_feat / s_burst:.1f} requests/s ({s_burst:.4f} s)")
    log(f"[time] {card}: server, message to reply of a scored request under "
        f"that load (host clock): p50 {np.percentile(waited, 50):.3f} ms, "
        f"p90 {np.percentile(waited, 90):.3f} ms, max {waited.max():.3f} ms "
        f"over {len(waited)} replies")

    # every request once more, alone: no batcher, one connection at a time
    alone = rv._ScoringServer(CRNN, "full", batching=False, device=cuda)

    async def one_by_one():
        streamed = [await client(alone, i) for i in range(n_conn)]
        burst = [json.loads(await alone.reply(rv.encode_features(f),
                                              None))["score"] for f in feats]
        return np.array(streamed), np.array(burst)

    streamed_1, burst_1 = asyncio.run(one_by_one())
    err_stream = float(np.abs(streamed - streamed_1).max())
    err_burst = float(np.abs(burst - burst_1).max())
    log(f"[server] batched vs alone: max|score| {err_stream:.3g} (streamed), "
        f"{err_burst:.3g} (features) (bound {BATCH_TOL:g})")
    check(err_stream <= BATCH_TOL and err_burst <= BATCH_TOL,
          "batched vs alone")

    # the same server on the CPU, 4 of the connections and all features
    cpu = rv._ScoringServer(CRNN, "full", device="cpu")
    streamed_c, _, _, burst_c, _ = asyncio.run(load(cpu, range(4)))
    err_c = max(float(np.abs(streamed[:4] - streamed_c).max()),
                float(np.abs(burst - burst_c).max()))
    log(f"[server] card vs CPU replies (4 connections, {n_feat} feature "
        f"requests): max|score| {err_c:.3g}")
    check(err_c <= SCORE_TOL, f"server card vs CPU {err_c}")

    socket_transport(rv, cuda, audio[:4], streamed[:4], feats[:8], burst[:8])
    return launches


def socket_transport(rv, cuda, audio, streamed, feats, burst) -> None:
    """The same requests through `serve` on a loopback WebSocket with
    `_RemoteSession` as the client, where `websockets` is installed."""
    import socket
    import threading

    import numpy as np
    try:
        import websockets  # noqa: F401
    except ImportError:
        log("[server] websockets is not installed: the WebSocket transport "
            "was not exercised (the message coroutine was)")
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ready = threading.Event()
    threading.Thread(
        target=lambda: rv.serve(CRNN, pipeline="full", host="127.0.0.1",
                                port=port, log_level="ERROR", device=cuda,
                                _ready_callback=lambda srv: ready.set()),
        daemon=True).start()
    check(ready.wait(timeout=120), "the server did not start")
    worst = 0.0
    for i in range(len(audio)):
        session = rv._RemoteSession(f"ws://127.0.0.1:{port}", "hey_nano_crnn",
                                    pipeline="full", timeout=60)
        got = [session.run_audio(audio[i, c * 1280:(c + 1) * 1280])
               for c in range(audio.shape[1] // 1280)]
        worst = max(worst, float(np.abs(np.array(got) - streamed[i]).max()))
        for f, expected in zip(feats, burst):
            worst = max(worst, abs(session.run(f)[0] - expected))
        session.close()
    log(f"[server] over a loopback WebSocket, {len(audio)} _RemoteSession "
        f"clients: max|score - coroutine's| {worst:.3g}")
    check(worst <= BATCH_TOL, f"socket vs coroutine {worst}")


def mix_phase(rng, cuda, card) -> dict:
    """Phase 7: the mix kernel against its plain version at the contract's
    edges and the transform's shapes; malformed input raises; times at
    [512, 32000] and [4096, 32000] int16."""
    import numpy as np
    import torch
    from nanowakeword_tpu_torch.ops import mix_cuda

    def inputs(b, n, dtype):
        fg = torch.from_numpy(rng.integers(-20000, 20000, (b, n)).astype(
            np.int16))
        if dtype == torch.float32:
            fg = fg.float() / 32768.0
        nb = n // 128
        q = rng.integers(0, nb, b)
        q[0] = nb - 1
        if b > 1:
            q[1] = 0
        has_bg = rng.random(b) < 0.6
        has_bg[0] = True
        if b > 2:
            has_bg[2] = False
        per_clip = [torch.from_numpy(q.astype(np.int32)),
                    torch.from_numpy(rng.uniform(0.05, 3.0, b).astype(
                        np.float32)),
                    torch.from_numpy(has_bg),
                    torch.from_numpy(rng.uniform(0.7, 1.4, b).astype(
                        np.float32))]
        bg = torch.from_numpy((rng.normal(0, 0.05, (b, n))).astype(
            np.float32))
        return [t.to(cuda) for t in [fg, bg] + per_clip]

    def compare(args, label):
        out = mix_cuda.mix_gain_cuda(*args)
        torch.cuda.synchronize()
        ref = mix_cuda.mix_gain_plain(*args)
        check(out.shape == ref.shape and out.dtype == torch.float32,
              f"mix shape {tuple(out.shape)}")
        err = (out - ref).abs().max().item()
        tol = MIX_ULPS * max(ref.abs().max().item(), 1.0)
        log(f"[mix] {label}: max|kernel - plain| = {err:.3g} (bound "
            f"{tol:.3g})")
        check(err <= tol, f"mix kernel vs plain {err} > {tol}")
        return err

    max_err = 0.0
    for b in (1, 3, 512):
        for n in (1280, 16000, 32000):
            for dtype in (torch.int16, torch.float32):
                max_err = max(max_err, compare(
                    inputs(b, n, dtype), f"[{b}, {n}] {str(dtype)[6:]}"))
    fg, bg, q, scale, has_bg, gain = inputs(4, 1280, torch.int16)
    for bad, label in (((fg[:, :1000], bg[:, :1000]), "n % 128 != 0"),
                       ((fg.cpu(), bg.cpu()), "a CPU tensor")):
        try:
            mix_cuda.mix_gain_cuda(*bad, q, scale, has_bg, gain)
        except ValueError as e:
            log(f"[mix] {label} raises: {e}")
        else:
            raise RuntimeError(f"check failed: {label} did not raise")

    times = {}
    for b in (512, 4096):
        args = inputs(b, 32000, torch.int16)
        fg, bg, has_bg = args[0], args[1], args[4]
        # fg read once, bg read where a clip has one, out written once, and
        # the per-clip scalars; a few f32 operations per element are far below
        nbytes = (fg.numel() * fg.element_size()
                  + int(has_bg.sum()) * bg.shape[1] * bg.element_size()
                  + fg.numel() * 4 + b * (4 + 4 + 1 + 4))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        max_err = max(max_err, compare(args, f"[{b}, 32000] int16 (timed)"))
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = (mix_cuda.mix_gain_cuda if which == "kernel"
                  else mix_cuda.mix_gain_plain)
            runs[which].append(cuda_ms(lambda: fn(*args), 20))
        times[b] = (min(runs["kernel"]), min(runs["plain"]), bound)
        log(f"[time] {card}: mix+gain [{b}, 32000] int16: kernel "
            f"{runs['kernel']} ms, plain {runs['plain']} ms (CUDA events, "
            f"mean of 20 after warm-up); bound {bound:.4f} ms (bytes)")
    return {"max_err": max_err, "ms": times[4096][0],
            "plain_ms": times[4096][1], "bound_ms": times[4096][2]}


def _write_corpus(rng, root) -> dict:
    """Synthesized 16 kHz wavs: 64 positives (1-1.75 s), 64 negatives
    (0.75-3 s), 8 backgrounds (3 s), 8 decaying-noise impulse responses."""
    import numpy as np
    from nanowakeword_tpu_torch.utils.audio_io import write_wav

    dirs = {k: os.path.join(root, k) for k in ("pos", "neg", "noise", "rir")}
    for d in dirs.values():
        os.makedirs(d)

    def burst(n, level):
        env = np.abs(np.sin(np.linspace(0, rng.uniform(2, 6) * np.pi, n)))
        return rng.normal(0, level, n) * env

    for i in range(64):
        write_wav(os.path.join(dirs["pos"], f"p{i}.wav"),
                  burst(int(rng.integers(16000, 28000)), 5000))
        write_wav(os.path.join(dirs["neg"], f"n{i}.wav"),
                  burst(int(rng.integers(12000, 48000)), 3500))
    for i in range(8):
        write_wav(os.path.join(dirs["noise"], f"bg{i}.wav"),
                  rng.normal(0, 1500, 48000))
        t = np.arange(4800)
        write_wav(os.path.join(dirs["rir"], f"r{i}.wav"),
                  rng.normal(0, 20000, 4800) * np.exp(-t / rng.uniform(300,
                                                                       900)))
    return dirs


def training_phases(rng, cuda, card, work) -> dict:
    """Phases 8-10: -t, -T and serving the trained artifact, on the card."""
    import numpy as np
    import torch
    from nanowakeword_tpu_torch import NanoInterpreter, runtime
    from nanowakeword_tpu_torch.models.model import Model
    from nanowakeword_tpu_torch.ops import mel_cuda, mix_cuda
    from nanowakeword_tpu_torch.train.cached import (build_cached_data,
                                                     make_cached_train_loop)
    from nanowakeword_tpu_torch.train.optim import Optimizer
    from nanowakeword_tpu_torch.trainer import run_pipeline
    from nanowakeword_tpu_torch.utils import audio_io

    dirs = _write_corpus(rng, work)

    def job(src, name):
        return {"input_audio_dirs": [dirs[src]],
                "output_filename": f"{name}.npy",
                "use_background_noise": True, "use_rir": True,
                "augmentation_rounds": 8}

    config = {
        "model_name": "smoke_crnn", "output_dir": os.path.join(work, "out"),
        "clip_length_samples": 32000, "augmentation_batch_size": 512,
        "feature_gen_num_workers": 8, "background_paths": [dirs["noise"]],
        "rir_paths": [dirs["rir"]],
        "augmentation_settings": dict(SHIPPED_AUGMENTATION),
        "feature_generation_manifest": {"positive": job("pos", "pos"),
                                        "negative": job("neg", "neg")},
        **SHIPPED_CRNN,
    }

    # -- 8. the transform stage -------------------------------------------------
    mix_cuda.reset_launches()
    mel_cuda.reset_launches()
    out = run_pipeline(config, transform_clips=True, device=cuda)
    mix_launches, mel_launches = mix_cuda.launches, mel_cuda.launches
    log(f"[transform] launches on the -t path: mix kernel {mix_launches}, "
        f"mel kernel {mel_launches}")
    check(mix_launches > 0, "the transform did not launch the mix kernel")
    check(mel_launches > 0, "the transform did not launch the mel kernel")
    feats = {k: np.load(os.path.join(out["feature_dir"], f"{k}.npy"))
             for k in ("pos", "neg")}
    for k, v in feats.items():
        check(v.shape == (512, 16, 96) and np.isfinite(v).all()
              and v.std() > 0, f"{k} features {v.shape}")
    log(f"[transform] features pos {feats['pos'].shape}, neg "
        f"{feats['neg'].shape}, finite; mean {feats['pos'].mean():.4f} / "
        f"{feats['neg'].mean():.4f}")
    # the second run decodes natively, the third with the numpy twin
    for decoder, label in ((None, "native"), (runtime.plain_decode_wav_bytes,
                                              "numpy twin")):
        audio_io.WAV_DECODER = decoder
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_pipeline(config, transform_clips=True, overwrite=True,
                         device=cuda)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            audio_io.WAV_DECODER = None
        log(f"[time] {card}: transform stage (decode + augment + features, "
            f"batch 512, 1024 clips of 2 s), WAVs decoded by the {label}: "
            f"{1024 / seconds:.1f} clips/s ({seconds:.3f} s, host clock)")

    # -- 9. device-cached training of the shipped CRNN at full width ------------
    paths = {"pos": os.path.join(out["feature_dir"], "pos.npy"),
             "neg": os.path.join(out["feature_dir"], "neg.npy")}
    config.update({
        "steps": 200, "early_stopping_patience": 0,
        "device_cache": {"enabled": True, "steps_per_dispatch": 100},
        "batch_composition": dict(SHIPPED_COMPOSITION),
        "feature_manifest": {
            "targets": {"t": paths["pos"]},
            "negatives": {k: paths["neg"] for k in SHIPPED_COMPOSITION
                          if k != "t"}},
        "distillation": {"enabled": False},
    })
    t0 = time.perf_counter()
    trained = run_pipeline(config, train_model=True, device=cuda)
    log(f"[train] 2 dispatches x 100 steps, batch "
        f"{sum(SHIPPED_COMPOSITION.values())}, in "
        f"{time.perf_counter() - t0:.2f} s (first run, with set-up)")
    history = trained["model"].history["loss"]
    hardness = trained["dataset"].sample_hardness
    check(len(history) == 200 and np.isfinite(history).all(),
          f"loss history {len(history)}")
    check(np.isfinite(hardness).all() and (hardness != 1.0).any(),
          "hardness was not updated")
    log(f"[train] loss {history[0]:.4f} -> {np.mean(history[-10:]):.4f} "
        f"(mean of the last 10); hardness moved on "
        f"{int((hardness != 1.0).sum())} of {hardness.size} rows")
    check_onnx_exports(os.path.dirname(trained["artifact"]), "smoke_crnn",
                       (".onnx",) + FRONTEND_GRAPHS)
    onnx_vs_nww(trained["artifact"],
                np.concatenate([feats["pos"][:128], feats["neg"][:128]]),
                cuda)

    model = Model(config=config, model_name="t", input_shape=(16, 96),
                  model_type="crnn", layer_dim=64, n_blocks=2,
                  dropout_prob=0.3, seed=SEED, device=cuda).train()
    data = build_cached_data(trained["dataset"], SHIPPED_COMPOSITION,
                             config["feature_manifest"], cuda)
    optimizer = Optimizer(list(model.module.parameters()), config, 20000)
    loop = make_cached_train_loop(model.module, optimizer, quotas=data.quotas,
                                  replace=data.replace, k_steps=100)
    gen = torch.Generator(device=cuda).manual_seed(SEED)
    loop(data.hardness, gen, data.features, data.labels, data.pools)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop(data.hardness, gen, data.features, data.labels, data.pools)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"[time] {card}: device-cached training, shipped CRNN, batch 256: "
        f"{100 / seconds:.2f} steps/s ({seconds * 10:.3f} ms/step over 100 "
        f"steps after 100 warm-up, host clock after synchronize)")

    step_card_vs_cpu(config, feats, cuda)

    # -- 10. serve what was trained -------------------------------------------------
    interp = NanoInterpreter.load_model(trained["artifact"], device=cuda)
    clip = np.clip(rng.normal(0.0, 3000.0, 16000 * 3), -32768,
                   32767).astype(np.int16)
    results = interp.predict_clip(clip)
    scores = np.array([r.score for r in results])
    check(len(scores) > 0 and np.isfinite(scores).all()
          and ((scores >= 0) & (scores <= 1)).all(), "served scores")
    log(f"[serve] {os.path.basename(trained['artifact'])} on the card: "
        f"{len(scores)} chunks, last score {scores[-1]:.4f}, max "
        f"{scores.max():.4f}")

    host_loop_phase(config, cuda, card, work, 100 / seconds)
    bf16_phase(config, trained["dataset"], cuda, card)
    cascade_launches = distill_phase(rng, config, cuda, card, work)
    return {"mix_launches": mix_launches,
            "cascade_launches": cascade_launches}


def host_loop_phase(config, cuda, card, work, cached_rate) -> None:
    """Phase 15: `run_pipeline(train_model=True)` with `device_cache` off
    (the host loop) on phase 8's features, for the shipped CRNN and a
    conformer at its default width: 200 steps straight with a checkpoint at
    step 100, then a run resumed from that checkpoint for 100 more. The
    resumed run must draw the same batches and end with the same weights."""
    import shutil

    import numpy as np
    import torch
    from nanowakeword_tpu_torch.data.dataset import DynamicClassAwareSampler
    from nanowakeword_tpu_torch.train.trainer import Trainer
    from nanowakeword_tpu_torch.trainer import run_pipeline

    drawn, loop_seconds = [], []
    sample_batch = DynamicClassAwareSampler.sample_batch
    train_model = Trainer.train_model

    def recording_sample_batch(self):
        batch = sample_batch(self)
        drawn.append(np.asarray(batch, np.int64).copy())
        return batch

    def timed_train_model(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = train_model(self, *args, **kwargs)
        torch.cuda.synchronize()
        loop_seconds.append(time.perf_counter() - t0)
        return steps

    families = {
        "crnn": dict(SHIPPED_CRNN),
        "conformer": dict(SHIPPED_CRNN, model_type="conformer",
                          layer_size=128, embedding_dim=64)}
    # cuDNN may pick a backward algorithm that sums with atomics; the two
    # runs are compared bit for bit, so both ask for deterministic ones
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    DynamicClassAwareSampler.sample_batch = recording_sample_batch
    Trainer.train_model = timed_train_model
    try:
        for family, arch in families.items():
            base = {k: v for k, v in config.items()
                    if k not in SHIPPED_CRNN and k != "device_cache"}
            base.update(arch, steps=200, model_name=f"host_{family}",
                        checkpointing={"enabled": True,
                                       "interval_steps": 100, "limit": 3})
            runs = {}
            for run in ("straight", "resumed"):
                cfg = dict(base, output_dir=os.path.join(work, "host", run))
                resume = None
                if run == "resumed":
                    resume = os.path.join(work, "host", f"resume_{family}")
                    ckpts = os.path.join(resume, "training_artifacts",
                                         "checkpoints")
                    os.makedirs(ckpts)
                    shutil.copy(os.path.join(
                        runs["straight"]["project_dir"],
                        "training_artifacts", "checkpoints",
                        "checkpoint_step_100.pkl"), ckpts)
                del drawn[:]
                runs[run] = run_pipeline(cfg, train_model=True, resume=resume,
                                         device=cuda)
                check_onnx_exports(os.path.dirname(runs[run]["artifact"]),
                                   f"host_{family}",
                                   (".onnx",) + FRONTEND_GRAPHS)
                runs[run]["drawn"] = list(drawn)
                runs[run]["seconds"] = loop_seconds[-1]
            a, b = runs["straight"], runs["resumed"]
            loss_a, loss_b = (r["model"].history["loss"] for r in (a, b))
            check(len(loss_a) == len(loss_b) == 200
                  and np.isfinite(loss_a).all(), f"{family} loss history")
            # the straight run's batches 101.. are the resumed run's first
            n = min(len(a["drawn"]) - 101, len(b["drawn"]), 99)
            same_batches = all(np.array_equal(a["drawn"][101 + i],
                                              b["drawn"][i])
                               for i in range(n))
            check(n == 99 and same_batches,
                  f"{family}: the resumed run drew other batches")
            sd_a, sd_b = (r["model"].module.state_dict() for r in (a, b))
            worst = max((sd_a[k].float() - sd_b[k].float()).abs().max().item()
                        for k in sd_a)
            equal = worst == 0.0 and loss_a == loss_b
            check(worst <= RESUME_TOL, f"{family} resumed weights {worst}")
            log(f"[host loop] {family} ({a['model'].n_params()} parameters), "
                f"batch {sum(SHIPPED_COMPOSITION.values())}: loss "
                f"{loss_a[0]:.4f} -> {np.mean(loss_a[-10:]):.4f}; resumed "
                f"from step 100: the same {n} batches, weights and BatchNorm "
                f"statistics "
                + ("and the loss history equal bit for bit" if equal else
                   f"max|diff| {worst:.3g} (bound {RESUME_TOL:g}; not bit "
                   f"for bit: a kernel of this family sums in another order "
                   f"from run to run)")
                + " (cudnn.deterministic on)")
            check(np.mean(loss_a[-10:]) < loss_a[0], f"{family} loss rose")
            log(f"[time] {card}: host-loop training, {family}, batch 256: "
                f"{200 / a['seconds']:.2f} steps/s over the straight 200 "
                f"steps (first steps included), {99 / b['seconds']:.2f} "
                f"steps/s over the resumed 99 (host clock after synchronize, "
                f"checkpoint writes included); the device-cached loop of "
                f"phase 9: {cached_rate:.2f} steps/s (shipped CRNN)")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        DynamicClassAwareSampler.sample_batch = sample_batch
        Trainer.train_model = train_model


def bf16_phase(config, dataset, cuda, card) -> None:
    """Phase 16: the shipped CRNN in the device-cached loop with
    `compute_dtype: bfloat16`: float32 masters, moments and BatchNorm
    statistics after 100 steps, a falling loss, and ms/step in turns with
    float32."""
    import numpy as np
    import torch
    from nanowakeword_tpu_torch.models.model import Model
    from nanowakeword_tpu_torch.train.cached import (build_cached_data,
                                                     make_cached_train_loop)
    from nanowakeword_tpu_torch.train.optim import Optimizer

    data = build_cached_data(dataset, SHIPPED_COMPOSITION,
                             config["feature_manifest"], cuda)
    gen = torch.Generator(device=cuda).manual_seed(SEED)

    def build(dtype, k_steps):
        model = Model(config=config, model_name="t", input_shape=(16, 96),
                      model_type="crnn", layer_dim=64, n_blocks=2,
                      dropout_prob=0.3, seed=SEED, device=cuda).train()
        optimizer = Optimizer(list(model.module.parameters()), config, 200)
        loop = make_cached_train_loop(
            model.module, optimizer, quotas=data.quotas, replace=data.replace,
            k_steps=k_steps, compute_dtype=dtype, dropout_seed=SEED)
        return model, optimizer, lambda: loop(
            data.hardness, gen, data.features, data.labels, data.pools)

    model, optimizer, run = build("bfloat16", 100)
    losses = run()[:, 0].cpu().numpy()
    check(np.isfinite(losses).all() and losses[-10:].mean() < losses[:10]
          .mean(), f"bf16 loss {losses[:10].mean()} -> {losses[-10:].mean()}")
    for k, v in model.module.state_dict().items():
        check(not torch.is_floating_point(v) or v.dtype == torch.float32,
              f"{k} is {v.dtype} after bf16 training")
    for moments in optimizer.state.values():
        check(all(t.dtype == torch.float32 for t in moments),
              "a moment is not float32")
    norm = model.module.backbone.norms[0]
    check(int(norm.num_batches_tracked) == 100
          and norm.running_mean.abs().sum().item() > 0,
          "BatchNorm statistics did not move")
    log(f"[bf16] shipped CRNN, compute_dtype bfloat16, 100 device-cached "
        f"steps: loss {losses[:10].mean():.4f} -> {losses[-10:].mean():.4f} "
        f"(means of 10); masters, moments and BatchNorm statistics float32")

    loops = {"bfloat16": build("bfloat16", 50)[2],
             "float32": build("float32", 50)[2]}
    times = {k: [] for k in loops}
    for dtype in ("float32", "bfloat16"):
        loops[dtype]()                                    # warm-up
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loops[dtype]()
        torch.cuda.synchronize()
        times[dtype].append((time.perf_counter() - t0) * 1e3 / 50)
    log(f"[time] {card}: device-cached training, shipped CRNN, batch 256, "
        f"ms/step over 50 steps after 50 warm-up (host clock after "
        f"synchronize, in turns): float32 "
        f"{[round(t, 3) for t in times['float32']]}, bfloat16 "
        f"{[round(t, 3) for t in times['bfloat16']]}")


def distill_phase(rng, config, cuda, card, work) -> int:
    """Phase 17: `distill_from_artifact` of the shipped CRNN on phase 8's
    features, the default student, 500 of the 8000 steps; the `_lite.nww`
    lands beside a copy of the teacher and the cascade serves it on the
    card against the CPU. -> mel launches."""
    import shutil

    import numpy as np
    import torch
    from nanowakeword_tpu_torch import NanoInterpreter
    from nanowakeword_tpu_torch.export.artifact import load_nww
    from nanowakeword_tpu_torch.ops import mel_cuda
    from nanowakeword_tpu_torch.train import distill
    from nanowakeword_tpu_torch.trainer import _build_training_data

    out_dir = os.path.join(work, "distilled")
    os.makedirs(out_dir)
    teacher = os.path.join(out_dir, "hey_nano_crnn.nww")
    shutil.copy(CRNN, teacher)
    cfg = dict(config, distillation={"steps": 500, "log_interval": 250})
    X_train = _build_training_data(cfg, config["feature_manifest"])

    students, seconds = [], []
    run_loop = distill._run_distill_loop

    def timed_loop(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        students.append(run_loop(*args, **kwargs))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return students[-1]

    distill._run_distill_loop = timed_loop
    try:
        lite = distill.distill_from_artifact(
            teacher, X_train, cfg, (16, 96), out_dir, "hey_nano_crnn",
            device=cuda)
    finally:
        distill._run_distill_loop = run_loop
    history = students[0].history
    first, best, final = (history["distill_first_loss"],
                          history["distill_best_ema_loss"],
                          history["distill_final_ema_loss"])
    check(lite == os.path.join(out_dir, "hey_nano_crnn_lite.nww")
          and os.path.exists(lite), f"lite artifact {lite}")
    # as the JAX package's distill_from_artifact: the `.nww` alone
    check(not os.path.exists(lite[:-len(".nww")] + ".onnx"),
          "standalone distillation wrote an _lite.onnx")
    check(np.isfinite([first, best, final]).all() and best < first
          and best <= final, f"EMA loss {first} -> best {best}, last {final}")
    header, written, encoder = load_nww(lite, device=cuda)
    check(header["has_encoder"] and encoder is not None,
          "the lite artifact has no encoder")
    for (k, v), p in zip(written.module.state_dict().items(),
                         students[0].module.state_dict().values()):
        check(torch.equal(v, p), f"{k} of the artifact is not the student's")
    log(f"[distill] {students[0].n_params()} parameters, 500 steps: loss "
        f"{first:.4f} -> EMA {final:.4f} (best {best:.4f}, restored); "
        f"{os.path.basename(lite)} written with the teacher's encoder")
    log(f"[time] {card}: distillation, shipped CRNN teacher, batch 256: "
        f"{500 / seconds[0]:.2f} steps/s (500 steps in two dispatches of 250 "
        f"row-index uploads, the feature upload included, host clock after "
        f"synchronize)")

    clip = np.clip(rng.normal(0.0, 3000.0, 16000 * 2), -32768,
                   32767).astype(np.int16)
    mel_cuda.reset_launches()
    traces = []
    for device in (cuda, "cpu"):
        interp = NanoInterpreter.load_model(teacher, cascade=True,
                                            gate_threshold=0.0, device=device)
        check(interp.gate_name == "hey_nano_crnn_lite",
              f"the cascade did not pick the new gate: {interp!r}")
        results = interp.predict_clip(clip)
        traces.append((np.array([r.gate_score for r in results]),
                       np.array([r.score for r in results])))
    launches = mel_cuda.launches
    (gate, ver), (gate_c, ver_c) = traces
    err = max(float(np.abs(gate - gate_c).max()),
              float(np.abs(ver - ver_c).max()))
    log(f"[distill] the cascade with the new gate: {len(gate)} chunks, gate "
        f"{gate[-1]:.4f}, verifier {ver[-1]:.4f}; card vs CPU max|score| "
        f"{err:.3g}; mel launches {launches}")
    check(np.isfinite(gate).all() and (gate[15:] > 0).all(),
          "gate scores malformed")
    check(err <= SCORE_TOL, f"distilled cascade card vs CPU {err}")
    check(launches >= len(gate), "the cascade did not launch the mel kernel")
    return launches


def e2e_phase(rng, cuda, card, work) -> dict:
    """Phase 18: the campaign's pipeline from text, on the card. `-G -t`
    through `run_pipeline` on a task list in campaign/config_hey_nano.yaml's
    schema (96 "hey nano" clips, 96 phoneme-adversarial and 96
    word-adversarial negatives, union3 voices, the campaign's augmentation),
    then `-T` with `end_to_end.enabled` from those WAVs: the bundled wide128
    v4 encoder (warm-started, trained in bf16) and the shipped CRNN at full
    width, 100 steps at the reference's e2e composition (8 targets + 16
    negatives) and 20 steps at 256 clips a batch, then the 20 again with
    the WAVs decoded by the native runtime's numpy twin; the mel kernel
    runs in every step's forward. Then one step card vs CPU with a float32
    encoder
    (judge_step), and the exported `.nww`, which bundles the trained
    encoder, served on the card against the CPU. -> the kernels' launches."""
    import numpy as np
    import torch
    from nanowakeword_tpu_torch import NanoInterpreter, runtime
    from nanowakeword_tpu_torch.convert import encoder_state_dict_from_flax
    from nanowakeword_tpu_torch.data.features import \
        pretrained_encoder_variables
    from nanowakeword_tpu_torch.data.generator import generate_clips as gc
    from nanowakeword_tpu_torch.export.artifact import load_nww
    from nanowakeword_tpu_torch.models.model import Model
    from nanowakeword_tpu_torch.ops import mel_cuda, mix_cuda
    from nanowakeword_tpu_torch.train.e2e import AudioClipDataset, E2EModel
    from nanowakeword_tpu_torch.train.trainer import Trainer
    from nanowakeword_tpu_torch.trainer import run_pipeline
    from nanowakeword_tpu_torch.utils import audio_io
    from nanowakeword_tpu_torch.utils.audio_io import load_audio
    import wave

    seconds = {"phase": time.perf_counter()}
    corpus = _write_corpus(rng, os.path.join(work, "corpus"))
    dirs = {k: os.path.join(work, "generated", k)
            for k in ("pos", "neg_phoneme", "neg_word")}
    voice = {"channel": "union3"}
    tasks = [
        {"name": "positives", "output_dir": dirs["pos"], "num_samples": 96,
         "text_source": {"type": "fixed_phrase", "phrase": "hey nano"},
         "tts_settings": dict(voice, seed=10)},
        {"name": "phoneme_adversarial", "output_dir": dirs["neg_phoneme"],
         "num_samples": 96,
         "text_source": {"type": "phoneme_adversarial",
                         "base_phrase": "hey nano", "min_distance": 0.35},
         "tts_settings": dict(voice, seed=30)},
        {"name": "word_adversarial", "output_dir": dirs["neg_word"],
         "num_samples": 96,
         "text_source": {"type": "auto_adversarial",
                         "base_phrase": "hey nano"},
         "tts_settings": dict(voice, seed=40)}]

    def job(sources, name):
        return {"input_audio_dirs": [dirs[k] for k in sources],
                "output_filename": f"{name}.npy",
                "use_background_noise": True, "use_rir": True,
                "augmentation_rounds": 1}

    config = {
        "model_name": "smoke_e2e", "output_dir": os.path.join(work, "out"),
        "target_phrase": "hey nano", "data_generation_tasks": tasks,
        "clip_length_samples": 32000, "augmentation_batch_size": 512,
        "feature_gen_num_workers": 8, "background_paths": [corpus["noise"]],
        "rir_paths": [corpus["rir"]], "show_training_summary": False,
        "augmentation_settings": dict(SHIPPED_AUGMENTATION),
        "feature_generation_manifest": {
            "positive": job(["pos"], "pos"),
            "negative": job(["neg_phoneme", "neg_word"], "neg")},
        **SHIPPED_CRNN,
    }

    # -G and -t: the clips from text, then their features
    gen_seconds = []
    generate = gc.generate_clips

    def timed_generate(cfg):
        t0 = time.perf_counter()
        generate(cfg)
        gen_seconds.append(time.perf_counter() - t0)

    mel_cuda.reset_launches()
    mix_cuda.reset_launches()
    gc.generate_clips = timed_generate
    t0 = time.perf_counter()
    try:
        out = run_pipeline(config, generate_clips=True, transform_clips=True,
                           device=cuda)
    finally:
        gc.generate_clips = generate
    seconds["-G -t"] = time.perf_counter() - t0
    launches = {"mel": mel_cuda.launches, "mix": mix_cuda.launches}
    counts = {k: len(os.listdir(d)) for k, d in dirs.items()}
    check(counts == {k: 96 for k in dirs}, f"generated clips {counts}")
    log(f"[generate] -G: {counts} union3 clips in {gen_seconds[0]:.3f} s: "
        f"{288 / gen_seconds[0]:.1f} clips/s (host work: numpy synthesis and "
        f"WAV writes; no device work)")
    for name, rows in (("pos", 96), ("neg", 192)):
        f = np.load(os.path.join(out["feature_dir"], f"{name}.npy"))
        check(f.shape == (rows, 16, 96) and np.isfinite(f).all()
              and f.std() > 0, f"{name} features {f.shape}")
    log(f"[transform] -t on the -G clips: features pos (96, 16, 96), neg "
        f"(192, 16, 96), finite; mix kernel launches {launches['mix']}, mel "
        f"kernel launches {launches['mel']}")
    check(launches["mix"] > 0 and launches["mel"] > 0,
          "-t on the -G clips did not launch both kernels")

    # -T end to end, at two batch compositions
    manifest = {"targets": [dirs["pos"]],
                "negatives": [dirs["neg_phoneme"], dirs["neg_word"]]}
    e2e_cfg = {"enabled": True, "audio_manifest": manifest,
               "clip_samples": 32000, "context_frames": 16}
    trainers = []
    train_model = Trainer.train_model

    def recording_train_model(self, *args, **kwargs):
        """Keeps the trainer and the host clock at each step's launch."""
        step, self.stamps = self._step, []

        def stamped(*step_args):
            self.stamps.append(time.perf_counter())
            return step(*step_args)

        self._step = stamped
        trainers.append(self)
        return train_model(self, *args, **kwargs)

    runs = {}
    mel_cuda.reset_launches()
    Trainer.train_model = recording_train_model
    small, large = {"targets": 8, "negatives": 16}, {"targets": 64,
                                                       "negatives": 192}
    try:
        # the WAVs decode natively; the last run decodes them with the
        # numpy twin, for the split of the loop's wait
        for name, steps, composition, decoder in (
                ("100", 100, small, None), ("20", 20, large, None),
                ("20_plain", 20, large, runtime.plain_decode_wav_bytes)):
            before = mel_cuda.launches
            t0 = time.perf_counter()
            audio_io.WAV_DECODER = decoder
            try:
                run = run_pipeline(dict(config, model_name=f"smoke_e2e_{name}",
                                        steps=steps, early_stopping_patience=0,
                                        batch_composition=composition,
                                        end_to_end=e2e_cfg),
                                   train_model=True, device=cuda)
            finally:
                audio_io.WAV_DECODER = None
            seconds[f"-T e2e, {name} steps"] = time.perf_counter() - t0
            run["launches"] = mel_cuda.launches - before
            run["loop"] = trainers[-1].loop_seconds
            run["stamps"] = trainers[-1].stamps
            run["steps"], run["decoder"] = steps, (
                "the numpy twin" if decoder else "the native decoder")
            runs[name] = run
    finally:
        Trainer.train_model = train_model
    for run in runs.values():
        steps = run["steps"]
        loss = run["model"].history["loss"]
        batch = 24 if steps == 100 else 256
        check(len(loss) == steps and np.isfinite(loss).all(),
              f"e2e loss history {len(loss)}")
        check(run["launches"] >= steps,
              f"{run['launches']} mel launches in {steps} e2e steps")
        loop, waited = run["loop"]
        stamps = run["stamps"][steps // 10:]      # after the first tenth
        steady = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        log(f"[e2e] {steps} steps at batch {batch}: loss {loss[0]:.4f} -> "
            f"{np.mean(loss[-10:]):.4f} (mean of the last 10); mel kernel "
            f"launches {run['launches']} (one in each step's forward, one "
            f"in the final report)")
        log(f"[time] {card}: e2e training, wide128 v4 encoder (bf16) + "
            f"shipped CRNN, batch {batch}: {steps / loop:.2f} steps/s "
            f"({loop:.3f} s for {steps} steps, first steps included, host "
            f"clock), {steady:.2f} steps/s between the launches of the last "
            f"{len(stamps)} steps; the loop waited on the prefetch thread "
            f"(WAV decoding by {run['decoder']}) for {waited:.3f} s, "
            f"{100 * waited / loop:.1f}% of it")

    # the artifact bundles the trained encoder
    e2e = runs["100"]["model"]
    header, _, encoder = load_nww(runs["100"]["artifact"], device="cpu")
    trained = e2e.module.encoder.state_dict()
    asset = encoder_state_dict_from_flax(pretrained_encoder_variables())
    check(header["has_encoder"] and all(torch.equal(encoder[k],
                                                    trained[k].cpu())
                                        for k in trained),
          "the artifact's encoder is not the trained one")
    moved = max((trained[k].cpu() - torch.as_tensor(asset[k])).abs().max()
                .item() for k in trained)
    check(moved > 0, "e2e training did not move the encoder")
    log(f"[e2e] {os.path.basename(runs['100']['artifact'])} bundles the "
        f"trained encoder (max|trained - asset| {moved:.3g})")
    from nanowakeword_tpu_torch.export import onnx_proto
    for name, run in runs.items():
        check_onnx_exports(os.path.dirname(run["artifact"]),
                           f"smoke_e2e_{name}", FRONTEND_GRAPHS)
    graph = onnx_proto.load_model(runs["100"]["artifact"][:-len(".nww")]
                                  + "_embedding.onnx").graph
    check(np.array_equal(graph.initializers[graph.nodes[1].inputs[1]],
                         trained["conv0.weight"].cpu().numpy()),
          "the embedding graph does not hold the trained encoder")
    log("[onnx] the e2e embedding graph holds the trained encoder's first "
        "convolution")

    # the prefetch thread's batch at 256 clips, produced alone (no step
    # holding the GIL), with each decoder
    dataset = AudioClipDataset(manifest, clip_samples=32000)
    pools = dataset.index_pools
    idx = np.concatenate([pools["targets_0"][:64], pools["negatives_0"][:96],
                          pools["negatives_1"][:96]])
    paths = [dataset.entries[int(i)][0] for i in idx]
    t0 = time.perf_counter()
    for path in paths:
        with open(path, "rb") as f:
            f.read()
    read_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for path in paths:
        load_audio(path)
    load_ms = (time.perf_counter() - t0) * 1e3
    # read_wav's width probe alone: one wave.open of each file
    t0 = time.perf_counter()
    for path in paths:
        with wave.open(path, "rb") as probe:
            probe.getsampwidth()
    probe_ms = (time.perf_counter() - t0) * 1e3
    log(f"[time] {card}: of one e2e batch of 256 WAVs, the file reads alone "
        f"{read_ms:.3f} ms, load_audio (probe, read, native decode) "
        f"{load_ms:.3f} ms, read_wav's width probe alone (wave.open and "
        f"getsampwidth, after the reads) {probe_ms:.3f} ms (host clock)")
    gather_ms = {}
    for label, decoder in (("native", None), ("numpy twin",
                                              runtime.plain_decode_wav_bytes)):
        audio_io.WAV_DECODER = decoder
        try:
            runs_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                dataset.gather(idx)
                runs_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            audio_io.WAV_DECODER = None
        gather_ms[label] = runs_ms
    log(f"[time] {card}: one e2e batch of 256 clips produced alone "
        f"(AudioClipDataset.gather: read, decode, crop; host clock, 3 runs): "
        + ", ".join(f"{k} {[round(t, 3) for t in v]} ms"
                    for k, v in gather_ms.items()))

    # one step, card vs CPU, from the same weights and audio
    idx = np.concatenate([pools["targets_0"][:8], pools["negatives_0"][:8],
                          pools["negatives_1"][:8]])
    audio, labels, _ = dataset.gather(idx)
    x, y = torch.from_numpy(audio), torch.from_numpy(labels)

    def fresh(device):
        clf = Model(config=config, model_name="t", input_shape=(16, 96),
                    model_type="crnn", layer_dim=64, n_blocks=2,
                    dropout_prob=0.0, seed=SEED, device=device)
        return E2EModel(clf, encoder_dtype=torch.float32).train()

    def logits(model, dtype):
        module = model.module.to(dtype)
        module.encoder_dtype = dtype
        return module.classifier(module.embed(x))

    before = mel_cuda.launches
    t0 = time.perf_counter()
    judge_step("one AdamW step of the e2e stack (wide128 v4 encoder in "
               "float32 + shipped CRNN, batch 24, dropout 0)", config, fresh,
               logits, x, y, cuda)
    seconds["step card vs CPU"] = time.perf_counter() - t0
    compare_launches = mel_cuda.launches - before

    # the artifact served, card vs CPU
    pos = sorted(os.listdir(dirs["pos"]))[0]
    speech = load_audio(os.path.join(dirs["pos"], pos))[:24000]
    clip = np.zeros(32000, np.int16)
    clip[8000:8000 + len(speech)] = speech
    traces = []
    t0 = time.perf_counter()
    for device in (cuda, "cpu"):
        interp = NanoInterpreter.load_model(runs["100"]["artifact"],
                                            device=device)
        traces.append(np.array([r.score for r in interp.predict_clip(clip)]))
    seconds["served, card and CPU"] = time.perf_counter() - t0
    err = float(np.abs(traces[0] - traces[1]).max())
    log(f"[e2e] served on the card: {len(traces[0])} chunks, last score "
        f"{traces[0][-1]:.4f}, max {traces[0].max():.4f}; card vs CPU "
        f"max|score| {err:.3g}")
    check(len(traces[0]) == 25 and np.isfinite(traces[0]).all(),
          "served scores")
    check(err <= SCORE_TOL, f"e2e artifact card vs CPU {err}")
    launches["mel"] += mel_cuda.launches - compare_launches
    log(f"[launches] phase 18: mel kernel {launches['mel']} (-t, e2e "
        f"training and serving), mix kernel {launches['mix']}")
    launches["wavs"] = [open(os.path.join(d, f), "rb").read()
                        for d in dirs.values() for f in sorted(os.listdir(d))]
    total = time.perf_counter() - seconds.pop("phase")
    log(f"[time] phase 18: {total:.3f} s, of it "
        + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
        + " (host clock)")
    return launches


# The bundled v4 encoder's recipe (its sidecar, speech_encoder_v4.msgpack
# .json) at full width: wide128, batch 256, 1.5 s clips, union channels,
# half the vocabulary confusable twins, SupCon 0.5 in groups of 4, the
# pretraining augmentation (EQ 0.5), 240 noise and 64 impulse clips. Cut in
# depth: 128 of 3072 words, 12 of 48 speakers, 300 of 12000 steps.
PRETRAIN_V4 = {"vocab_size": 128, "variants_per_word": 12,
               "heldout_variants": 4, "clip_samples": 24000,
               "noise_clips": 240, "rir_clips": 64, "batch_size": 256,
               "steps": 300, "encoder_arch": "wide128", "channels": "union",
               "confusable_fraction": 0.5, "contrastive_weight": 0.5,
               "contrastive_group": 4}
V4_CLIPS = 3072 * 48            # the v4 corpus: 3072 words x 48 speakers
V4_BUILD_NOTE = "formant 0.847 / resonator 0.806 / fx 0.743"
EMBED_TOL = 1e-3    # pooled embeddings card vs CPU (the score bar)


def pretrain_phase(cuda, card, work) -> dict:
    """Phase 20: encoder pretraining on the card. (a) the corpus of the v4
    recipe cut in depth, (b) 300 steps at full width through
    `pretrain_encoder` (the mel kernel in every step), profiled over 20
    steps, (c) three AdamW steps on the card against the same steps in
    float64 on the CPU, on one augmented batch, (d)
    resume at 16000 samples (the mix kernel's length) bit for bit, (e) the
    transfer eval of the bundled v4 asset against the JAX package's gates,
    (f) the asset written in (b) served by AudioFeatures, (g) a custom
    module's `.onnx` (torch.fx) served on the card. -> the launches."""
    import numpy as np
    import torch
    from nanowakeword_tpu_torch import AudioFeatures, NanoInterpreter
    from nanowakeword_tpu_torch.convert import encoder_state_dict_from_flax
    from nanowakeword_tpu_torch.data.features import \
        pretrained_encoder_variables
    from nanowakeword_tpu_torch.export.frontend import seeded_audio
    from nanowakeword_tpu_torch.ops import mel_cuda, mix_cuda
    from nanowakeword_tpu_torch.tools.profile_train_step import measure
    from nanowakeword_tpu_torch.train import pretrain_encoder as PE
    from nanowakeword_tpu_torch.utils.flax_msgpack import read_msgpack_file

    seconds = {"phase": time.perf_counter()}
    workers = os.cpu_count() or 1       # as pretrain_encoder.main
    launches = {"mel": 0, "mix": 0}

    def count(since):
        launches["mel"] += mel_cuda.launches - since[0]
        launches["mix"] += mix_cuda.launches - since[1]

    def now():
        return mel_cuda.launches, mix_cuda.launches

    # (a) the corpus
    cfg = PE.PretrainConfig(**PRETRAIN_V4)
    t0 = time.perf_counter()
    corpus = PE.build_corpus(cfg, verbose=False, workers=workers)
    seconds["corpus"] = time.perf_counter() - t0
    n_clips = len(corpus["clips"]) + len(corpus["heldout_clips"])
    check(corpus["clips"].shape == (cfg.vocab_size * cfg.variants_per_word,
                                    cfg.clip_samples)
          and len(corpus["heldout_clips"]) == cfg.vocab_size
          * cfg.heldout_variants
          and corpus["noise"].shape == (cfg.noise_clips, cfg.clip_samples)
          and corpus["rirs"].shape == (cfg.rir_clips, 2400), "corpus shapes")
    full = V4_CLIPS * 24000 * 2
    threshold = PE.int8_threshold(cuda)
    log(f"[pretrain] corpus: {cfg.vocab_size} words x "
        f"({cfg.variants_per_word} + {cfg.heldout_variants}) union clips of "
        f"1.5 s, 240 noise, 64 impulses: {seconds['corpus']:.3f} s of host "
        f"synthesis in {workers} processes ({n_clips / seconds['corpus']:.1f}"
        f" clips/s); the v4 corpus ({V4_CLIPS} clips) would take "
        f"{full / 1e9:.2f} GB on the card as int16, the threshold from free "
        f"memory is {threshold / 1e9:.2f} GB: stored as "
        f"{'int16' if full <= threshold else 'int8'}")

    # (b) 300 steps at full width
    history = []
    since = now()
    t0 = time.perf_counter()
    enc_vars, report = PE.pretrain_encoder(cfg, corpus=corpus, log_every=50,
                                           verbose=False, device=cuda,
                                           history=history)
    seconds[f"{cfg.steps} steps + held-out eval"] = time.perf_counter() - t0
    mel_train = mel_cuda.launches - since[0]
    count(since)
    check(mel_train >= cfg.steps,
          f"{mel_train} mel launches in {cfg.steps} pretraining steps")
    first, last = history[0], history[-1]
    rates = [(b["step"] - a["step"]) / (b["seconds"] - a["seconds"])
             for a, b in zip(history[1:], history[2:])]
    log(f"[pretrain] {cfg.steps} steps: loss {first['loss']:.4f} at step 1 "
        f"(CE ln {cfg.vocab_size} = {np.log(cfg.vocab_size):.4f} + 0.5 "
        f"SupCon) -> {last['loss']:.4f} at step {last['step']}; train acc "
        f"{report['final_train_acc']:.4f}, held-out variant acc "
        f"{report['heldout_variant_acc']:.4f}; mel kernel launches "
        f"{mel_train} (one per step, {mel_train - cfg.steps} in the held-out"
        f" eval)")
    log(f"[time] {card}: pretraining wide128 at batch 256, 24000 samples: "
        f"steps/s between log points {[round(r, 2) for r in rates]} (host "
        f"clock after a sync); {cfg.steps / last['seconds']:.2f} steps/s "
        f"over the whole loop")
    check(np.isfinite(last["loss"]) and last["loss"] < 0.8 * first["loss"],
          f"pretraining loss {first['loss']} -> {last['loss']}")
    check(report["heldout_variant_acc"] > 3.0 / cfg.vocab_size,
          f"held-out accuracy {report['heldout_variant_acc']}")

    run = PE.PretrainRun(cfg, corpus, device=cuda, verbose=False)

    def loop(k):
        for _ in range(k):
            metrics = run.step()
        return metrics.cpu()

    since = now()
    prof = measure(loop, 20, {})
    count(since)
    log(f"[time] {card}: one pretraining step (draw, augmentation, "
        f"forward, backward, AdamW), torch.profiler over 20 steps after 10 "
        f"of warm-up: host {prof['host_ms_per_step']:.3f} ms/step, "
        + (f"{prof['launches_per_step']:.0f} launches/step, device busy "
           f"{prof['device_busy_ms_per_step']:.3f} ms/step, busy share "
           f"{100 * prof['device_busy_share_of_host_time']:.1f}%; top "
           + ", ".join(f"{k['name'][:40]} {k['ms_per_step']:.3f} ms"
                       for k in prof["top_kernels"][:4])
           if "launches_per_step" in prof else prof["device"]))

    # the split of a step: the augmentation's host draws (and their copies
    # to the card), the whole draw (sampling and augmentation), the update
    from nanowakeword_tpu_torch.ops.augment import draw_augment

    def host_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3 / n, out

    draws_ms, _ = host_ms(lambda: draw_augment(
        run._fg_lens, cfg.clip_samples, run.aug_params, run.augment_rng,
        cuda))
    since = now()
    batch_ms, (audio, y) = host_ms(run.draw_batch)
    update_ms, _ = host_ms(lambda: run.train_on(audio, y))
    count(since)
    log(f"[time] {card}: the step's parts, host clock after a sync, 20 "
        f"calls each: the augmentation's draws on the host and their copies"
        f" to the card {draws_ms:.3f} ms, sampling and augmentation "
        f"{batch_ms:.3f} ms, forward, backward and AdamW {update_ms:.3f} "
        f"ms")

    # (c) three AdamW steps, card vs a float64 step on the CPU, each from
    # the card's weights and moments on one batch
    t0 = time.perf_counter()
    audio, y = audio.cpu(), y.cpu()
    card_run = PE.PretrainRun(cfg, corpus, device=cuda, verbose=False)
    tf32_err = []
    for k in range(3):
        start = {n: t.detach().cpu().clone()
                 for n, t in card_run.module.state_dict().items()}
        opt_state = card_run.optimizer.state_dict()
        lr = card_run.optimizer.lr()
        since = now()
        m_card = card_run.train_on(audio.to(cuda), y.to(cuda)).cpu()
        count(since)
        tf32_err.append(judge_pretrain_step(k, cfg, start, opt_state, audio,
                                            y, m_card.numpy(),
                                            card_run.module, lr, cuda))
    check(max(tf32_err) >= 2 * NORM64_RTOL,
          f"the TF32 control's grad norm errors {tf32_err} are within "
          f"twice the bar {NORM64_RTOL:g}")
    seconds["3 steps card vs CPU"] = time.perf_counter() - t0
    del run, card_run

    # (d) resume at 16000 samples, batch 32: the mix kernel's route
    t0 = time.perf_counter()
    cfg_r = cfg._replace(vocab_size=16, variants_per_word=8,
                         heldout_variants=1, clip_samples=16000,
                         noise_clips=20, rir_clips=8, batch_size=32, steps=8)
    corpus_r = PE.build_corpus(cfg_r, verbose=False)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    since = now()
    save = PE._save_ckpt

    class Killed(Exception):
        pass

    def save_then_die(checkpoint_dir, state):
        save(checkpoint_dir, state)
        if state["step"] == 4:
            raise Killed

    try:
        straight, _ = PE.pretrain_encoder(cfg_r, corpus=corpus_r,
                                          verbose=False, device=cuda)
        ck = os.path.join(work, "pretrain_ck")
        PE._save_ckpt = save_then_die
        try:
            PE.pretrain_encoder(cfg_r, corpus=corpus_r, verbose=False,
                                checkpoint_dir=ck, checkpoint_every=4,
                                device=cuda)
        except Killed:
            pass
        PE._save_ckpt = save
        resumed, _ = PE.pretrain_encoder(cfg_r, corpus=corpus_r,
                                         verbose=False, checkpoint_dir=ck,
                                         resume=True, device=cuda)
    finally:
        PE._save_ckpt = save
        torch.backends.cudnn.deterministic = deterministic
    mix_resume = mix_cuda.launches - since[1]
    count(since)
    same = all(np.array_equal(straight["params"][k][p],
                              resumed["params"][k][p])
               for k in straight["params"] for p in straight["params"][k])
    log(f"[pretrain] resume at 16000 samples, batch 32: 8 straight steps vs "
        f"4 steps, a kill after the step-4 checkpoint and a resumed run: "
        f"encoder equal bit for bit: {same} (cudnn.deterministic on); mix "
        f"kernel launches {mix_resume} in 16 steps")
    check(same, "the resumed pretraining run differs from the straight run")
    check(mix_resume >= 16, f"{mix_resume} mix launches in 16 steps")
    seconds["resume"] = time.perf_counter() - t0

    # (e) the transfer eval of the bundled v4 asset, on the card
    t0 = time.perf_counter()
    v4 = pretrained_encoder_variables()
    v4_words = PE.sample_training_vocab(3072, seed=10)
    since = now()
    transfer = PE.evaluate_transfer(v4, v4_words, verbose=False,
                                    device=cuda, workers=workers)
    count(since)
    log(f"[pretrain] transfer eval of the bundled v4 asset on the card (24 "
        "words, 24 pairs, cross-channel): "
        + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in transfer.items()})
        + f"; the sidecar's build-time 24-pair eval: {V4_BUILD_NOTE}; the "
        "random encoder is drawn by torch (not PRNGKey(10))")
    check(transfer["unseen_word_centroid_acc"] >= 0.8,
          f"v4 centroid accuracy {transfer['unseen_word_centroid_acc']}")
    check(transfer["confusable_pair_acc"] >= 0.6,
          f"v4 pair accuracy {transfer['confusable_pair_acc']}")
    check(transfer["unseen_word_centroid_acc"]
          >= transfer["random_encoder_centroid_acc"] + 0.2,
          "v4 not better than a random encoder by 0.2")
    words = PE.sample_vocab(24, seed=424242, exclude=v4_words)
    clips = np.concatenate([PE.synthesize_word_variants(
        w, 6, 24000, seed=9001 + 31 * i) for i, w in enumerate(words)])
    since = now()
    on_card = PE.embed_pooled(v4, clips, cuda)
    count(since)
    emb_err = float(np.abs(on_card - PE.embed_pooled(v4, clips, "cpu"))
                    .max())
    log(f"[pretrain] pooled embeddings of {len(clips)} clips, card vs CPU: "
        f"max|diff| {emb_err:.3g} (bound {EMBED_TOL:g})")
    check(emb_err <= EMBED_TOL, f"embeddings card vs CPU {emb_err}")
    seconds["transfer eval"] = time.perf_counter() - t0

    # (f) the asset written in (b), served by AudioFeatures on the card
    path = PE.save_encoder_asset(enc_vars, os.path.join(work, "enc.msgpack"),
                                 meta=report)
    encoder = encoder_state_dict_from_flax(read_msgpack_file(path))
    tone = np.round(seeded_audio(2, 32000, seed=3)).astype(np.int16)
    since = now()
    feats = AudioFeatures(encoder_state_dict=encoder,
                          device=cuda).embed_clips(tone)
    count(since)
    feats_c = AudioFeatures(encoder_state_dict=encoder,
                            device="cpu").embed_clips(tone)
    asset_err = float(np.abs(feats - feats_c).max())
    check(feats.shape == (2, 16, 96) and np.isfinite(feats).all()
          and feats.std() > 0, f"features of the new asset {feats.shape}")
    check(asset_err <= EMBED_TOL, f"new asset card vs CPU {asset_err}")
    log(f"[pretrain] the asset written after {cfg.steps} steps "
        f"({os.path.getsize(path)} bytes + sidecar) embeds a tone on the "
        f"card: {feats.shape}, card vs CPU max|diff| {asset_err:.3g}")

    # (g) a custom module's .onnx (torch.fx), served on the card
    since = now()
    custom_onnx(cuda, work)
    count(since)

    total = time.perf_counter() - seconds.pop("phase")
    log(f"[launches] phase 20: mel kernel {launches['mel']}, mix kernel "
        f"{launches['mix']}")
    log(f"[time] phase 20: {total:.3f} s, of it "
        + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
        + " (host clock)")
    return launches


def pretrain_update(cfg, state, opt_state, audio, y, device, dtype,
                    tf32=False):
    """One pretraining step taken by hand from `state` (a state_dict) and
    `opt_state` (an Optimizer.state_dict()) on one batch, on `device` in
    `dtype`: the forward and the backward inside no_tf32_convs, as
    make_pretrain_step takes them (with cuDNN's TF32 convolutions instead
    when `tf32`), then the port's clipped AdamW. -> ([loss, grad norm],
    name -> updated weight, name -> gradient), the tensors as float64 on
    the CPU."""
    import numpy as np
    import torch
    from nanowakeword_tpu_torch.train import pretrain_encoder as PE
    from nanowakeword_tpu_torch.utils.precision import no_tf32_convs

    module = PE.EncoderPretrainModule(state["word_head.weight"].shape[0],
                                      cfg.encoder_arch)
    module.load_state_dict(state)
    module = module.to(device=device, dtype=dtype)
    params = dict(module.named_parameters())
    optimizer = PE.make_optimizer(list(params.values()), cfg)
    optimizer.load_state_dict(opt_state)
    cudnn = torch.backends.cudnn
    flags = (cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=True)
             if tf32 else no_tf32_convs())
    with flags:
        yd = y.to(device)
        logits, z = module(audio.to(device), return_embedding=True)
        loss = (torch.nn.functional.cross_entropy(logits, yd)
                + cfg.contrastive_weight * PE.supcon_loss(
                    z, yd, cfg.contrastive_temp))
        grads = [g.detach().cpu().double() for g in torch.autograd.grad(
            loss, list(params.values()))]
        norm = torch.sqrt(sum((g * g).sum() for g in grads)).item()
        optimizer.step([g.to(device=device, dtype=dtype) for g in grads])
    return (np.array([loss.item(), norm]),
            {n: p.detach().cpu().double() for n, p in params.items()},
            dict(zip(params, grads)))


def judge_pretrain_step(k, cfg, state, opt_state, audio, y, m_card,
                        card_module, lr, cuda) -> float:
    """One pretraining step (count k) on the card, float32 as the port
    takes it, against the same step in float64 on the CPU, from the same
    weights and moments (`state`, `opt_state`) on one batch: loss within
    STEP_RTOL, grad norm within NORM64_RTOL; every weight within
    WEIGHT_TOL except the rounding-level ones, held to 2 lr (judge_step's
    rule). Adam moves an element by about lr * g / |g|, so where float32
    rounding can decide the sign of g it decides the step. Which elements
    those are is decided on the reference's side alone, never by the card:
    those whose float64 clipped |g| is under 1e-6 (judge_step's line) or
    under the largest error the CPU's float32 gradient of the same tensor
    makes (at batch 256 x 24000 a convolution's float32 weight gradient
    carries more noise than 1e-6). A control takes the same step by hand
    on the card with cuDNN's TF32 convolutions. -> its grad norm's
    relative error against float64, which the caller holds to twice
    NORM64_RTOL or more (else the judge could not tell the port's
    precision from TF32's)."""
    import torch

    m64, w64, g64 = pretrain_update(cfg, state, opt_state, audio, y, "cpu",
                                    torch.float64)
    _, _, g32 = pretrain_update(cfg, state, opt_state, audio, y, "cpu",
                                torch.float32)
    clip = min(1.0, 1.0 / m64[1])
    small = {n: g.abs() * clip < max(1e-6, clip * (g32[n] - g).abs().max()
                                     .item())
             for n, g in g64.items()}
    n_all = sum(s.numel() for s in small.values())
    n_small = sum(int(s.sum()) for s in small.values())
    n_line = sum(int((g.abs() * clip < 1e-6).sum()) for g in g64.values())

    def against_float64(weights):
        """-> (max|diff| of the others, its weight, max|diff| of the
        rounding-level elements, elements past WEIGHT_TOL by the 1e-6 line
        alone)"""
        worst, worst_name, quiet, n_over = 0.0, "", 0.0, 0
        for n, w in weights.items():
            diff = (w - w64[n]).abs()
            loud, rest = diff[~small[n]], diff[small[n]]
            if loud.numel() and loud.max().item() > worst:
                worst, worst_name = loud.max().item(), n
            if rest.numel():
                quiet = max(quiet, rest.max().item())
            n_over += int(((diff > WEIGHT_TOL)
                           & (g64[n].abs() * clip >= 1e-6)).sum())
        return worst, worst_name, quiet, n_over

    rel = abs(m_card[[0, 2]] - m64) / abs(m64)
    worst, worst_name, quiet, n_over = against_float64(
        {n: p.detach().cpu().double()
         for n, p in card_module.named_parameters()})
    m_tf32, w_tf32, _ = pretrain_update(cfg, state, opt_state, audio, y,
                                        cuda, torch.float32, tf32=True)
    tf32_rel = abs(m_tf32 - m64) / abs(m64)
    tf32_worst, _, _, tf32_over = against_float64(w_tf32)
    log(f"[step] card (float32) vs the CPU in float64, pretraining step "
        f"{k + 1} of 3 (wide128, batch 256, 24000 samples, SupCon 0.5, lr "
        f"{lr:.3g}) from the same state: loss {m64[0]:.6f}, rel {rel[0]:.3g},"
        f" grad norm rel {rel[1]:.3g} (bound {NORM64_RTOL:g}); weights "
        f"max|diff| {worst:.3g} ({worst_name}); {n_small} of {n_all} "
        f"elements ({100 * n_small / n_all:.2f}%) rounding-level ({n_line} "
        f"by the 1e-6 line, the rest under the CPU's float32 error): "
        f"max|diff| {quiet:.3g} (bound 2 lr = {2 * lr:.3g}); by the 1e-6 "
        f"line alone {n_over} elements would fail {WEIGHT_TOL:g}; control, "
        f"the step with TF32 convolutions: loss rel {tf32_rel[0]:.3g}, grad "
        f"norm rel {tf32_rel[1]:.3g}, weights max|diff| {tf32_worst:.3g}, "
        f"{tf32_over} elements past {WEIGHT_TOL:g} by the 1e-6 line")
    check(rel[0] <= STEP_RTOL and rel[1] <= NORM64_RTOL,
          f"pretraining step {k + 1}: loss or grad norm card vs CPU")
    check(worst <= WEIGHT_TOL,
          f"pretraining step {k + 1}: weights card vs CPU {worst}")
    check(quiet <= 2 * lr,
          f"pretraining step {k + 1}: rounding-level elements {quiet}")
    return tf32_rel[1]


# the custom module of tests/test_torch_zoo.py::test_custom_model_loading
ZOO_CUSTOM = (
    "import torch\n"
    "class MyNet(torch.nn.Module):\n"
    "    def __init__(self, input_shape, embedding_dim, width=4):\n"
    "        super().__init__()\n"
    "        n = input_shape[0] * input_shape[1]\n"
    "        self.a = torch.nn.Linear(n, width)\n"
    "        self.norm = torch.nn.BatchNorm1d(width)\n"
    "        self.b = torch.nn.Linear(width, embedding_dim)\n"
    "    def forward(self, x):\n"
    "        return self.b(self.norm(self.a(x.flatten(1))))\n")


def custom_onnx(cuda, work) -> None:
    """A user's custom module exported to `.onnx` through torch.fx by the
    `-T` exporter, served on the card by NanoInterpreter.load_model: graph
    vs module on the card within ONNX_TOL, card vs CPU within SCORE_TOL."""
    import numpy as np
    import torch
    from nanowakeword_tpu_torch import NanoInterpreter
    from nanowakeword_tpu_torch.export.artifact import export_onnx_model
    from nanowakeword_tpu_torch.export.frontend import seeded_audio
    from nanowakeword_tpu_torch.export.onnx_proto import load_model
    from nanowakeword_tpu_torch.models.model import Model

    src = os.path.join(work, "my_arch.py")
    with open(src, "w") as f:
        f.write(ZOO_CUSTOM)
    cfg = {"custom_model_config": {"module_path": src, "class_name": "MyNet",
                                   "params": {"width": 6}}}
    model = Model(config=cfg, model_name="custom", input_shape=(16, 96),
                  model_type="custom", seed=SEED, device=cuda)
    bn = model.module.backbone.norm
    with torch.no_grad():               # running statistics of a trained BN
        bn.running_mean.uniform_(-0.5, 0.5)
        bn.running_var.uniform_(0.5, 2.0)
    path = export_onnx_model(model, (16, 96), cfg, "custom", work)
    check(path is not None, "the custom module did not export")
    batch_dim = load_model(path).graph.inputs[0].shape[0]
    feats = np.random.default_rng(SEED).normal(0, 1, (256, 16, 96)).astype(
        np.float32)
    interp = NanoInterpreter.load_model(path, device=cuda)
    session = next(iter(interp.models.values()))
    got = session.run_batch(feats)
    with torch.no_grad():
        want = torch.sigmoid(model.module.eval()(
            torch.from_numpy(feats).to(cuda))).cpu().numpy()[:, 0]
    err = float(np.abs(got - want).max())
    clip = np.round(seeded_audio(1, 32000, seed=5)[0]).astype(np.int16)
    traces = [np.array([r.score for r in NanoInterpreter.load_model(
        path, device=device).predict_clip(clip)]) for device in (cuda, "cpu")]
    served = float(np.abs(traces[0] - traces[1]).max())
    log(f"[onnx] custom module (Linear, BatchNorm1d, Linear) exported "
        f"through torch.fx, batch dim {batch_dim!r}: 256 windows on the "
        f"card vs the module max|score| {err:.3g} (bound {ONNX_TOL:g}); "
        f"served 25 chunks card vs CPU max|score| {served:.3g} (bound "
        f"{SCORE_TOL:g})")
    check(batch_dim == "batch_size", f"batch dim {batch_dim}")
    check(err <= ONNX_TOL, f"custom .onnx vs module {err}")
    check(len(traces[0]) == 25 and np.isfinite(traces[0]).all()
          and served <= SCORE_TOL, f"custom .onnx served card vs CPU {served}")


ONNX_TOL = 1e-5     # an .onnx graph against the port's module, both on the
                    # card (and a request in a batch vs alone)
INT8_TOL = 0.02     # an int8 export against the float32 module (the JAX
                    # package's bar, tests/test_onnx_export.py)
ONNX_TYPES = ("dnn", "crnn", "streaming_gru") + ZOO


def onnx_phase(rng, cuda, card, work) -> int:
    """Phase 19: `.onnx` models on the card. The shipped cascade exported
    by the port and streamed (the `_lite.onnx` gate auto-discovered)
    against the `.nww` cascade; batch scoring through `_OnnxSession`; every
    family's export against its module; a stateful graph's carry; the
    server on an `.onnx`; the numpy frontend graphs. -> mel launches."""
    import asyncio

    import numpy as np
    import torch
    from nanowakeword_tpu_torch import AudioFeatures, NanoInterpreter
    from nanowakeword_tpu_torch.data.features import \
        default_encoder_variables
    from nanowakeword_tpu_torch.export.artifact import (export_onnx_model,
                                                        load_nww, save_nww)
    from nanowakeword_tpu_torch.export.frontend import export_frontend_onnx
    from nanowakeword_tpu_torch.export.onnx_export import build_onnx
    from nanowakeword_tpu_torch.export.onnx_torch import OnnxTorchModel
    from nanowakeword_tpu_torch.interpreter import remote_verifier as rv
    from nanowakeword_tpu_torch.interpreter.nanointerpreter import (
        _LocalSession, _OnnxSession)
    from nanowakeword_tpu_torch.models.model import Model
    from nanowakeword_tpu_torch.ops import mel_cuda

    t_phase = time.perf_counter()
    for name in ("hey_nano_crnn", "hey_nano_crnn_lite"):
        _, model, _ = load_nww(os.path.join(ROOT, "campaign", name + ".nww"),
                               device="cpu")
        export_onnx_model(model, model.input_shape, {}, name, work)
    crnn_onnx = os.path.join(work, "hey_nano_crnn.onnx")

    # a. the shipped cascade, phase 12's 50 chunks, VAD gate on
    clip = _tone_clip(SEED)
    n_chunks = len(clip) // 1280

    def stream(path, device, timed=False):
        interp = NanoInterpreter.load_model(path, cascade=True,
                                            gate_threshold=0.0,
                                            vad_threshold=0.3, device=device)
        check(interp.gate_name == os.path.basename(path).split(".")[0]
              + "_lite", f"cascade gate not found: {interp!r}")
        scores, ms = [], []
        for c in range(n_chunks):
            if timed:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = interp.predict(clip[c * 1280:(c + 1) * 1280])
            ms.append((time.perf_counter() - t0) * 1e3)
            scores.append([r.gate_score, r.score])
        return interp, np.array(scores), np.array(ms)

    mel_cuda.reset_launches()
    interp, onnx_scores, ms = stream(crnn_onnx, cuda, timed=True)
    launches = mel_cuda.launches
    check(interp._fused_step is None, "an .onnx cascade built the one-call "
          "step")
    _, nww_scores, _ = stream(CRNN, cuda)
    _, cpu_scores, _ = stream(crnn_onnx, "cpu")
    err_nww = float(np.abs(onnx_scores - nww_scores).max())
    err_cpu = float(np.abs(onnx_scores - cpu_scores).max())
    opened = int(np.count_nonzero(onnx_scores[:, 1]))
    log(f"[onnx] shipped cascade as .onnx on the card ({n_chunks} chunks, "
        f"VAD on): vs the .nww cascade on the card max|score| {err_nww:.3g} "
        f"(bound {ONNX_TOL:g}); vs .onnx on the CPU {err_cpu:.3g} (bound "
        f"{SCORE_TOL:g}); verifier scored on {opened} chunks; mel launches "
        f"{launches}")
    check(err_nww <= ONNX_TOL, f".onnx vs .nww cascade {err_nww}")
    check(err_cpu <= SCORE_TOL, f".onnx card vs CPU {err_cpu}")
    check(0 < opened < n_chunks, "the VAD gate never opened or never closed")
    check(launches >= n_chunks, f"{launches} mel launches for {n_chunks} "
          "chunks")
    log(f"[time] {card}: streaming predict per 80 ms chunk, .onnx cascade "
        f"(general path, eager feature step, cascade + VAD, host clock): "
        f"p50 {np.percentile(ms[10:], 50):.3f} ms, p90 "
        f"{np.percentile(ms[10:], 90):.3f} ms over {len(ms) - 10} chunks")

    # b. batch: embed_clips (mel kernel), then both sessions
    header, model, encoder = load_nww(CRNN, device=cuda)
    features = AudioFeatures(encoder_state_dict=encoder, device=cuda)
    sessions = {".nww": _LocalSession(model, header),
                ".onnx": _OnnxSession(crnn_onnx, cuda)}
    clips = np.clip(rng.normal(0.0, 3000.0, (1024, 32000)), -32768,
                    32767).astype(np.int16)
    before = mel_cuda.launches
    feats = features.embed_clips(clips, batch_size=1024)
    batch = {k: s.run_batch(feats) for k, s in sessions.items()}
    batch_launches = mel_cuda.launches - before
    err = float(np.abs(batch[".onnx"] - batch[".nww"]).max())
    check(batch[".onnx"].shape == (1024,) and err <= ONNX_TOL,
          f"batch .onnx vs .nww {err}")
    check(batch_launches >= 1, "batch scoring did not launch the mel kernel")
    rates = {k: [] for k in sessions}
    for k in sessions:                                    # warm-up
        sessions[k].run_batch(features.embed_clips(clips, batch_size=1024))
    for _ in range(3):
        for k, session in sessions.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session.run_batch(features.embed_clips(clips, batch_size=1024))
            rates[k].append(1024 / (time.perf_counter() - t0))
    launches += mel_cuda.launches - before
    log(f"[onnx] batch [1024, 32000] int16: .onnx vs .nww max|score| "
        f"{err:.3g} (bound {ONNX_TOL:g}); mel launches {batch_launches}")
    log(f"[time] {card}: batch scoring [1024, 32000] int16 host -> scores, "
        f"best of 3 after a warm-up (host clock): .onnx "
        f"{max(rates['.onnx']):.1f} clips/s, .nww {max(rates['.nww']):.1f} "
        f"clips/s (runs: "
        + "; ".join(f"{k} {[round(r, 1) for r in v]}" for k, v in rates.items())
        + ")")

    # c. the zoo: every exportable family at its default width, seed 0
    x = torch.from_numpy(rng.normal(0, 1, (256, 16, 96)).astype(
        np.float32)).to(cuda)
    for model_type in ONNX_TYPES:
        model = Model(config={}, model_name=f"smoke_{model_type}",
                      model_type=model_type, layer_dim=128, n_blocks=2,
                      seed=SEED, device=cuda)
        runtime = OnnxTorchModel(build_onnx(model), device=cuda)
        if model.stateful:               # a fixed batch of 1, zero state
            xs = x[:1]
            zero = torch.zeros(runtime.graph.inputs[1].shape, device=cuda)
            feed = {"input": xs, "hidden_in": zero, "cell_in": zero}
        else:
            xs = x
            feed = {"features": xs}

        def fwd():
            out = model.module(xs)
            return torch.sigmoid(out[0] if model.stateful else out)

        with torch.no_grad():
            err = (runtime.forward(feed)["score"] - fwd()).abs().max().item()
            ms_onnx = cuda_ms(lambda: runtime.forward(feed), 10)
            ms_mod = cuda_ms(fwd, 10)
        extra = ""
        if model_type in ("dnn", "crnn"):
            q = OnnxTorchModel(build_onnx(model, weights_dtype="int8"),
                               device=cuda)
            with torch.no_grad():
                q_err = (q.forward(feed)["score"] - fwd()).abs().max().item()
            check(q_err <= INT8_TOL, f"{model_type} int8 {q_err}")
            extra = f"; int8 export vs float32 {q_err:.3g} (bound {INT8_TOL})"
        log(f"[onnx] {card}: {model_type} at batch {xs.shape[0]}: .onnx vs "
            f"module max|score| {err:.3g}; forward .onnx {ms_onnx:.4f} ms, "
            f"module {ms_mod:.4f} ms (CUDA events, mean of 10 after "
            f"warm-up){extra}")
        check(err <= ONNX_TOL, f"{model_type} .onnx vs module {err}")

    # d. a stateful graph: hidden_in / cell_in threaded over 50 frames
    model = Model(config={}, model_name="smoke_sgru",
                  model_type="streaming_gru", seed=SEED, device=cuda)
    nww = save_nww(os.path.join(work, "smoke_sgru.nww"), model=model,
                   config={}, model_name="smoke_sgru")
    _, nww_model, _ = load_nww(nww, device=cuda)
    runtime = OnnxTorchModel(build_onnx(model, input_shape=(1, 96)),
                             device=cuda)
    frames = torch.from_numpy(rng.normal(0, 1, (1, 50, 96)).astype(
        np.float32)).to(cuda)
    hidden = torch.zeros(runtime.graph.inputs[1].shape, device=cuda)
    cell, carry, worst = hidden.clone(), None, 0.0
    with torch.no_grad():
        for t in range(50):
            out = runtime.forward({"input": frames[:, t:t + 1],
                                   "hidden_in": hidden, "cell_in": cell})
            hidden, cell = out["hidden_out"], out["cell_out"]
            logits, carry = nww_model.module(frames[:, t:t + 1], carry)
            worst = max(worst, (out["score"] - torch.sigmoid(logits))
                        .abs().max().item())
        carry_err = (hidden - torch.stack(carry)).abs().max().item()
    log(f"[onnx] streaming_gru .onnx, hidden_in / cell_in threaded over 50 "
        f"one-frame calls vs the .nww with its carry: max|score| "
        f"{worst:.3g}, max|hidden| {carry_err:.3g} (bound {ONNX_TOL:g})")
    check(worst <= ONNX_TOL and carry_err <= ONNX_TOL, "stateful .onnx")

    # e. the server on the .onnx: 16 full connections x 20 chunks
    n_conn, n_chunk = 16, 20
    audio = np.clip(rng.normal(0.0, 3000.0, (n_conn, n_chunk * 1280)),
                    -32768, 32767).astype(np.int16)
    calls = []

    async def drive(server, concurrent):
        server.start()

        async def client(i):
            state, out = server.connection(), []
            for c in range(n_chunk):
                out.append(json.loads(await server.reply(rv.encode_audio(
                    audio[i, c * 1280:(c + 1) * 1280]), state))["score"])
                await asyncio.sleep(0)
            return out
        if concurrent:
            return np.array(await asyncio.gather(*[client(i)
                                                   for i in range(n_conn)]))
        return np.array([await client(i) for i in range(n_conn)])

    before = mel_cuda.launches
    server = rv._ScoringServer(crnn_onnx, "full", device=cuda)
    check(isinstance(server.session, _OnnxSession), "server session")
    run_batch = server.session.run_batch

    def counting_run_batch(f):
        calls.append(len(f))
        return run_batch(f)

    server.session.run_batch = counting_run_batch
    batched = asyncio.run(drive(server, True))
    launches += mel_cuda.launches - before
    alone = asyncio.run(drive(rv._ScoringServer(crnn_onnx, "full",
                                                batching=False, device=cuda),
                              False))
    scored = int(np.count_nonzero(batched))
    err = float(np.abs(batched - alone).max())
    log(f"[onnx] server on the .onnx, {n_conn} full connections x {n_chunk} "
        f"chunks: {scored} scored requests in {len(calls)} device calls "
        f"(batch sizes {min(calls)}-{max(calls)}); batched vs alone "
        f"max|score| {err:.3g} (bound {BATCH_TOL:g})")
    check(scored == n_conn * (n_chunk - 15), f"{scored} scored replies")
    check(len(calls) < scored, f"{len(calls)} device calls for {scored}")
    check(err <= BATCH_TOL, f"server batched vs alone {err}")

    # f. the frontend graphs (numpy, host) with the .onnx classifier (card)
    t0 = time.perf_counter()
    export_frontend_onnx(default_encoder_variables(), 32000, "smoke", work)
    export_s = time.perf_counter() - t0
    # the graphs are float32: held against AudioFeatures in float32 on the
    # card; the bf16-mode path (the mel kernel) is logged beside it
    clip = _tone_clip(SEED + 1)
    traces = []
    for kwargs in ({"onnx_frontend": os.path.join(work, "smoke")},
                   {"compute_dtype": torch.float32}, {}):
        interp = NanoInterpreter.load_model(crnn_onnx, device=cuda, **kwargs)
        traces.append(np.array([r.score for r in interp.predict_clip(clip)]))
    err = float(np.abs(traces[0] - traces[1]).max())
    err_bf16 = float(np.abs(traces[0] - traces[2]).max())
    log(f"[onnx] the frontend graphs (exported in {export_s:.3f} s with "
        f"their check) on the host + the .onnx classifier on the card vs "
        f"AudioFeatures (float32) on the card: {len(traces[0])} chunks of a "
        f"tone clip, max|score| {err:.3g} (bound {SCORE_TOL:g}); vs the "
        f"bf16-mode AudioFeatures (mel kernel) {err_bf16:.3g}")
    check(len(traces[0]) == n_chunks and (traces[0][15:] > 0).all(),
          "numpy-frontend scores malformed")
    check(err <= SCORE_TOL, f"numpy frontend vs AudioFeatures {err}")
    # g. -T with distillation on the card: the `.onnx` files beside both
    from nanowakeword_tpu_torch.trainer import run_pipeline
    for name, shift, rows in (("pos", 1.0, 256), ("neg", 0.0, 512)):
        np.save(os.path.join(work, f"{name}.npy"), rng.normal(
            size=(rows, 16, 96)).astype(np.float32) + shift)
    out = run_pipeline({
        "model_name": "smoke_td", "output_dir": os.path.join(work, "td"),
        "model_type": "dnn", "layer_size": 64, "n_blocks": 1, "steps": 20,
        "early_stopping_patience": 0, "show_training_summary": False,
        "batch_composition": {"targets": 32, "negatives": 64},
        "distillation": {"steps": 20, "log_interval": 10,
                         "weights_dtype": "int8"},
        "feature_manifest": {
            "targets": {"t": os.path.join(work, "pos.npy")},
            "negatives": {"n": os.path.join(work, "neg.npy")}}},
        train_model=True, distill=True, device=cuda)
    check_onnx_exports(os.path.dirname(out["artifact"]), "smoke_td",
                       (".onnx", "_lite.onnx") + FRONTEND_GRAPHS)
    onnx_vs_nww(out["artifact"], feats[:256], cuda)
    log(f"[launches] phase 19: mel kernel {launches} (.onnx streaming, "
        f"batch and server)")
    log(f"[time] phase 19: {time.perf_counter() - t_phase:.3f} s (host "
        f"clock)")
    return launches


def onnx_vs_nww(artifact: str, feats, cuda) -> None:
    """The `.onnx` that -T wrote beside `artifact` scores the features as
    the `.nww` does, both on the card."""
    import numpy as np
    from nanowakeword_tpu_torch.export.artifact import load_nww
    from nanowakeword_tpu_torch.interpreter.nanointerpreter import (
        _LocalSession, _OnnxSession)

    header, model, _ = load_nww(artifact, device=cuda)
    want = _LocalSession(model, header).run_batch(feats)
    got = _OnnxSession(artifact[:-len(".nww")] + ".onnx", cuda).run_batch(
        feats)
    err = float(np.abs(got - want).max())
    log(f"[onnx] {os.path.basename(artifact)[:-4]}.onnx vs .nww on the card, "
        f"{len(feats)} feature windows: max|score| {err:.3g} (bound "
        f"{ONNX_TOL:g})")
    check(err <= ONNX_TOL, f".onnx vs .nww {err}")


FRONTEND_GRAPHS = ("_frontend.onnx", "_mel_stream.onnx", "_embedding.onnx")


def check_onnx_exports(model_dir: str, name: str, suffixes) -> None:
    """The ONNX files a stage writes beside the `.nww`: -T `<name>.onnx`
    and the three frontend graphs (and `<name>_lite.onnx` where it
    distilled), the e2e stage the frontend graphs."""
    missing = [s for s in suffixes
               if not os.path.exists(os.path.join(model_dir, name + s))]
    check(not missing, f"{name}: -T did not write {missing}")
    log(f"[onnx] {name}: -T wrote {', '.join(name + s for s in suffixes)}")


def step_card_vs_cpu(config, feats, cuda) -> None:
    """One AdamW step of the shipped CRNN from the same weights and batch
    with dropout 0, on the card and on the CPU (judge_step)."""
    import numpy as np
    import torch
    from nanowakeword_tpu_torch.models.model import Model

    x = torch.from_numpy(np.concatenate([feats["pos"][:96],
                                         feats["neg"][:160]]))
    y = torch.cat([torch.ones(96), torch.zeros(160)])

    def fresh(device):
        return Model(config=config, model_name="t", input_shape=(16, 96),
                     model_type="crnn", layer_dim=64, n_blocks=2,
                     dropout_prob=0.0, seed=SEED, device=device).train()

    def logits(model, dtype):
        model.module.to(dtype)
        return model.module(x.to(dtype))

    judge_step("one AdamW step of the shipped CRNN (batch 256, dropout 0)",
               config, fresh, logits, x, y, cuda)


def judge_step(what, config, fresh, logits, x, y, cuda) -> None:
    """One AdamW step of `fresh(device)` (a Model-like handle) on the batch
    (x, y), on the card and on the CPU; `logits(handle, dtype)` is its
    forward on the CPU in `dtype`.

    Adam's first step moves each weight by lr * g / (|g| + 1e-8) (plus the
    weight decay), so an element whose clipped gradient sits near rounding
    level moves by a fraction of lr that the rounding decides: a conv bias
    right before a BatchNorm has a gradient of exactly zero, and its float32
    rounding noise (up to ~6e-6, of either sign, different on the card and
    on the CPU) becomes a step of +-lr. Which elements those are is decided
    by the gradient in float64 on the CPU, which has no such noise: every
    element with |g| >= 1e-6 there is held to 1e-5, the others to 2 lr.
    """
    import torch
    from nanowakeword_tpu_torch.train.optim import Optimizer, global_norm
    from nanowakeword_tpu_torch.train.step import make_loss, make_train_step

    def one_step(device):
        model = fresh(device)
        optimizer = Optimizer(list(model.module.parameters()), config, 20000)
        metrics = make_train_step(model.module, optimizer)(x.to(device),
                                                           y.to(device))
        return (metrics.fetch().packed.numpy(),
                {k: v.cpu() for k, v in model.module.state_dict().items()})

    (m_card, sd_card), (m_cpu, sd_cpu) = one_step(cuda), one_step(
        torch.device("cpu"))

    def clipped_gradient(dtype):
        """|clipped gradient| on the CPU in dtype, element by element."""
        model = fresh("cpu")
        out = logits(model, dtype).reshape(-1)
        params = dict(model.module.named_parameters())
        grads = torch.autograd.grad(make_loss()(out, y.to(dtype)),
                                    list(params.values()))
        clip = min(1.0, 1.0 / global_norm(list(grads)).item())
        return {k: g.abs() * clip for k, g in zip(params, grads)}

    g64 = clipped_gradient(torch.float64)
    strict = {k: g >= 1e-6 for k, g in g64.items()}
    # rounding-level elements whose float32 noise alone reaches the bar
    n_loud = sum(int(((g >= 1e-6) & ~strict[k]).sum())
                 for k, g in clipped_gradient(torch.float32).items())

    loss_err = abs(m_card[0] - m_cpu[0]) / abs(m_cpu[0])
    norm_err = abs(m_card[1] - m_cpu[1]) / abs(m_cpu[1])
    lr = float(config["learning_rate_max"]) / 25.0      # onecycle, step 0
    worst, worst_name, worst_noise, n_noise = 0.0, "", 0.0, 0
    for k, v in sd_cpu.items():
        if not torch.is_floating_point(v):
            continue
        diff = (sd_card[k] - v).abs()
        mask = strict.get(k, torch.ones_like(v, dtype=torch.bool))
        if diff[mask].numel() and diff[mask].max().item() > worst:
            worst, worst_name = diff[mask].max().item(), k
        if (~mask).any():
            n_noise += int((~mask).sum())
            worst_noise = max(worst_noise, diff[~mask].max().item())
    log(f"[step] card vs CPU, {what}: loss rel {loss_err:.3g}, grad norm rel "
        f"{norm_err:.3g}; weights and BatchNorm stats max|diff| {worst:.3g} "
        f"({worst_name}); {n_noise} elements with float64 |g| < 1e-6 "
        f"({n_loud} of them read >= 1e-6 in float32): max|diff| "
        f"{worst_noise:.3g} (bound 2 lr = {2 * lr:.3g})")
    check(loss_err <= STEP_RTOL and norm_err <= STEP_RTOL,
          "loss or grad norm card vs CPU")
    check(worst <= WEIGHT_TOL, f"weights card vs CPU {worst}")
    check(worst_noise <= 2 * lr, f"rounding-level elements {worst_noise}")



# Phase 21: the native runtime, and data and tensor parallelism. On a
# machine with one card the mesh is two replicas on it.
DP_LOSS_RTOL = 1e-5     # a DP step vs the one-device step
DP_PARAM_RTOL, DP_PARAM_ATOL = 1e-4, 1e-6   # (tests/test_train_step.py)
LOOP_RTOL = 1e-4        # 20 cached steps: losses and hardness (same file)
LOOP_PARAM_RTOL = 1e-3  # ... and the weights


def runtime_phase(rng, wavs) -> None:
    """Phase 21, first half: the native runtime, built from csrc/ with g++,
    against its numpy twins: phase 18's WAVs decoded bit for bit (ms per
    clip for each), and a ring and a chunker over a 30 s stream."""
    import numpy as np
    from nanowakeword_tpu_torch import runtime

    lib = runtime.load_native()
    path = os.path.relpath(runtime.library_path(), ROOT)
    check(lib._name == runtime.library_path()
          and path.startswith(os.path.join("build", "nww_torch_kernels")),
          f"the native runtime is not the build under build/: {lib._name}")
    log(f"[runtime] native runtime {path} from "
        f"nanowakeword_tpu_torch/csrc/{runtime.LIBRARY}.cc (g++)")
    ms = {}
    outs = {}
    for name, fn in (("native", runtime.decode_wav_bytes),
                     ("numpy twin", runtime.plain_decode_wav_bytes)):
        t0 = time.perf_counter()
        outs[name] = [fn(buf) for buf in wavs]
        ms[name] = (time.perf_counter() - t0) * 1e3 / len(wavs)
    for (a, ra), (b, rb) in zip(outs["native"], outs["numpy twin"]):
        check(ra == rb and a.dtype == b.dtype and np.array_equal(a, b),
              "native decode differs from the numpy twin")
    n = sum(len(a) for a, _ in outs["native"])
    log(f"[runtime] phase 18's {len(wavs)} WAVs ({n} samples): native == "
        f"numpy twin bit for bit; ms per clip: native {ms['native']:.4f}, "
        f"numpy twin {ms['numpy twin']:.4f} (host clock)")

    stream = np.clip(rng.normal(0, 3000, 16000 * 30), -32768,
                     32767).astype(np.int16)
    rings = [runtime.AudioRing(16000 * 10), runtime.PlainAudioRing(16000 * 10)]
    chunkers = [runtime.Chunker(1280), runtime.PlainChunker(1280)]
    pos = popped = 0
    while pos < len(stream):
        n = int(rng.integers(1, 4000))
        part = stream[pos:pos + n]
        pos += n
        check(len({r.push(part) for r in rings}) == 1, "ring push")
        want = int(rng.integers(0, 3000))
        got = [r.pop(want) for r in rings]
        check(np.array_equal(got[0], got[1]), "ring pop differs")
        popped += len(got[0])
        frac = part.astype(np.float32) + 0.25
        chunks = [c.feed(frac) for c in chunkers]
        check(np.array_equal(chunks[0], chunks[1])
              and chunkers[0].pending == chunkers[1].pending,
              "chunker differs")
    check(rings[0].size == rings[1].size and rings[0].capacity == 262144,
          "ring size or capacity")
    log(f"[runtime] 30 s streamed in random pieces: ring (capacity "
        f"{rings[0].capacity}) and chunker (fractional float32) == their "
        f"numpy twins; {popped} samples popped, {rings[0].size} left")


def noise_elements(module, x, y) -> dict:
    """name -> elements whose clipped float64 gradient is < 1e-6 (judge_step's
    rule: a conv bias before a BatchNorm; Adam moves them by +-lr on
    rounding noise), with dropout off, on a float64 copy on the CPU."""
    import copy
    import torch
    from nanowakeword_tpu_torch.train.optim import global_norm
    from nanowakeword_tpu_torch.train.step import make_loss
    module = copy.deepcopy(module).cpu().double().train()
    for m in module.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    params = dict(module.named_parameters())
    out = module(x.double().cpu()).reshape(-1)
    grads = torch.autograd.grad(make_loss()(out, y.double().cpu()),
                                list(params.values()))
    clip = min(1.0, 1.0 / global_norm(list(grads)).item())
    return {k: g.abs() * clip < 1e-6 for k, g in zip(params, grads)}


def compare_weights(what, ours, ref, noise, rtol, atol, lr_bound) -> None:
    """State dicts: noise elements within lr_bound, the rest within
    rtol/atol."""
    import torch
    worst, worst_name, worst_noise = 0.0, "", 0.0
    for k, v in ref.items():
        if not torch.is_floating_point(v):
            continue
        diff = (ours[k].cpu() - v.cpu()).abs()
        mask = noise.get(k, torch.zeros_like(diff, dtype=torch.bool)).cpu()
        excess = diff - (atol + rtol * v.cpu().abs())
        if (~mask).any() and excess[~mask].max().item() > 0:
            raise RuntimeError(f"check failed: {what}: {k} off by "
                               f"{diff[~mask].max().item():.3g}")
        if (~mask).any() and diff[~mask].max().item() > worst:
            worst, worst_name = diff[~mask].max().item(), k
        if mask.any():
            worst_noise = max(worst_noise, diff[mask].max().item())
    check(worst_noise <= lr_bound, f"{what}: rounding-level elements "
          f"{worst_noise} > {lr_bound}")
    log(f"[dp] {what}: weights and BatchNorm stats max|diff| {worst:.3g} "
        f"({worst_name}; bound {rtol:g} relative + {atol:g}); "
        f"{sum(int(m.sum()) for m in noise.values())} rounding-level "
        f"elements max|diff| {worst_noise:.3g} (bound {lr_bound:.3g})")


def parallel_phase(rng, cuda, card) -> int:
    """Phase 21, second half: data and tensor parallelism over every visible
    card, or two replicas on cuda:0 where there is one: a DP step of the
    shipped CRNN (BatchNorm, dropout 0.3) at batch 256 against the
    one-device step; 20 steps of the device-cached loop against one device;
    a conformer at model_parallel=2 against one device; sharded embed_clips
    on int16 [1024, 32000] against unsharded; the server with
    data_parallel=-1 against the single-device server. -> mel launches."""
    import asyncio
    import copy
    import numpy as np
    import torch
    from nanowakeword_tpu_torch import AudioFeatures
    from nanowakeword_tpu_torch.export.artifact import load_nww
    from nanowakeword_tpu_torch.export.frontend import seeded_audio
    from nanowakeword_tpu_torch.interpreter import remote_verifier as rv
    from nanowakeword_tpu_torch.models.model import Model
    from nanowakeword_tpu_torch.ops import mel_cuda
    from nanowakeword_tpu_torch.parallel import dp
    from nanowakeword_tpu_torch.parallel import mesh as M
    from nanowakeword_tpu_torch.train.cached import (CachedData,
                                                     make_cached_train_loop,
                                                     put_cached_on_mesh)
    from nanowakeword_tpu_torch.train.optim import Optimizer
    from nanowakeword_tpu_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    devices = M.visible_devices()
    if len(devices) == 1:
        devices = [devices[0]] * 2
        log("[dp] one card visible: the mesh is two replicas on cuda:0")
    mesh = M.make_mesh(devices=devices)
    log(f"[dp] mesh {mesh}")
    lr = float(SHIPPED_CRNN["learning_rate_max"]) / 25.0   # onecycle, early

    def crnn(dropout):
        return Model(config=dict(SHIPPED_CRNN), model_name="t",
                     input_shape=(16, 96), model_type="crnn", layer_dim=64,
                     n_blocks=2, dropout_prob=dropout, seed=SEED,
                     device=cuda).train().module

    def steps(module, mesh, x, y, n, config=SHIPPED_CRNN):
        opt = Optimizer(list(module.parameters()), config, 20000)
        if mesh is None:
            step = make_train_step(module, opt, dropout_seed=SEED)
        else:
            opt = dp.shard_train_state(module, opt, mesh)
            step = dp.make_dp_train_step(module, opt, mesh, dropout_seed=SEED)
        losses, times = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(x, y).loss.item())
            times.append((time.perf_counter() - t0) * 1e3)
        return losses, times, {k: v.clone() for k, v in
                               module.state_dict().items()}

    # one DP step of the shipped CRNN at batch 256, dropout 0.3
    x = torch.from_numpy(rng.normal(0, 1, (256, 16, 96)).astype(
        np.float32)).to(cuda)
    y = torch.cat([torch.ones(96), torch.zeros(160)]).to(cuda)
    base = crnn(0.3)
    one = steps(copy.deepcopy(base), None, x, y, 1)
    sharded = steps(copy.deepcopy(base), mesh, x, y, 1)
    noise = noise_elements(base, x, y)
    loss_err = abs(sharded[0][0] - one[0][0]) / abs(one[0][0])
    log(f"[dp] one step of the shipped CRNN (dropout 0.3) at batch 256 over "
        f"{mesh.shape[M.DATA_AXIS]} replicas vs one device: loss "
        f"{sharded[0][0]:.6f} vs {one[0][0]:.6f}, rel {loss_err:.3g} "
        f"(bound {DP_LOSS_RTOL:g})")
    check(loss_err <= DP_LOSS_RTOL, f"DP step loss {loss_err}")
    compare_weights("one DP step vs one device", sharded[2], one[2], noise,
                    DP_PARAM_RTOL, DP_PARAM_ATOL, 2 * lr)
    one = steps(copy.deepcopy(base), None, x, y, 6)
    sharded = steps(copy.deepcopy(base), mesh, x, y, 6)
    log(f"[time] {card}: training step of the shipped CRNN at batch 256 "
        f"(host clock after synchronize, steps 2-6): one device "
        f"{[round(t, 3) for t in one[1][1:]]} ms, "
        f"{mesh.shape[M.DATA_AXIS]} replicas {[round(t, 3) for t in sharded[1][1:]]}"
        f" ms")

    # 20 steps of the device-cached loop
    n_rows = 2048
    feats = torch.from_numpy(rng.normal(0, 1, (n_rows, 16, 96)).astype(
        np.float32)).to(cuda)
    labels = torch.zeros(n_rows, device=cuda)
    labels[:512] = 1.0
    feats[:512] += 0.5

    def cached(mesh):
        module = copy.deepcopy(base)
        opt = Optimizer(list(module.parameters()), SHIPPED_CRNN, 20000)
        data = CachedData(features=feats, labels=labels,
                          hardness=torch.full((n_rows,), 0.05, device=cuda),
                          pools=(torch.arange(512, device=cuda),
                                 torch.arange(512, n_rows, device=cuda)),
                          quotas=(96, 160), replace=(False, False))
        features = data.features
        if mesh is not None:
            opt = dp.shard_train_state(module, opt, mesh)
            data = put_cached_on_mesh(data, mesh)
            features = data.replicas
        loop = make_cached_train_loop(module, opt, quotas=data.quotas,
                                      replace=data.replace, k_steps=20,
                                      dropout_seed=SEED, mesh=mesh)
        gen = torch.Generator(device=cuda).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = loop(data.hardness, gen, features, data.labels, data.pools)
        m = m.cpu().numpy()
        seconds = time.perf_counter() - t0
        return m, data.hardness.cpu().numpy(), gen.get_state(), \
            module.state_dict(), seconds

    m1, h1, g1, s1, t1 = cached(None)
    m2, h2, g2, s2, t2 = cached(mesh)
    check(torch.equal(g1, g2), "the cached loop drew differently")
    loss_err = float(np.max(np.abs(m2[:, 0] - m1[:, 0]) / np.abs(m1[:, 0])))
    hard_err = float(np.abs(h2 - h1).max())
    check(loss_err <= LOOP_RTOL, f"cached loop losses {loss_err}")
    np.testing.assert_allclose(h2, h1, rtol=LOOP_RTOL, atol=1e-6)
    check((m2[:, 5] == 96).all() and (m2[:, 2] + m2[:, 3] == 96).all(),
          "n_pos != the positive quota")
    log(f"[dp] 20 device-cached steps over the mesh vs one device: the same "
        f"draws; losses max rel {loss_err:.3g}, hardness max|diff| "
        f"{hard_err:.3g} (bounds {LOOP_RTOL:g}); n_pos == 96 every step; "
        f"steps/s (host clock): one device {20 / t1:.2f}, mesh {20 / t2:.2f}")
    # BatchNorm's running means follow the conv biases before them, which
    # rounding moves: they are held to the same bound
    follow = dict(noise, **{k: torch.ones_like(v, dtype=torch.bool)
                            for k, v in s1.items()
                            if k.endswith("running_mean")})
    compare_weights("20 cached steps vs one device", s2, s1, follow,
                    LOOP_PARAM_RTOL, DP_PARAM_ATOL, 2 * lr * 20)

    # a conformer at model_parallel=2
    tp_mesh = M.make_mesh(devices=devices[:2] if len(devices) >= 2
                          else devices, model_parallel=2)
    conformer = Model(config={}, model_name="t", input_shape=(16, 96),
                      model_type="conformer", layer_dim=128, n_blocks=2,
                      dropout_prob=0.0, seed=SEED, device=cuda).train().module
    cfg = dict(SHIPPED_CRNN)
    one = steps(copy.deepcopy(conformer), None, x, y, 2, cfg)
    split = steps(copy.deepcopy(conformer), tp_mesh, x, y, 2, cfg)
    shardings = M.param_shardings(conformer, tp_mesh)
    wide = sorted(p for s in shardings.values() if s.sharded
                  for p in s.flax_paths)
    check(wide, "no conformer parameter is wide enough to split")
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(one[0], split[0]))
    log(f"[tp] conformer (default widths) over mesh {tp_mesh.shape}: "
        f"{len(wide)} kernels split over the model axis ({wide[0]}, ...); "
        f"2 steps, losses max rel {loss_err:.3g} (bound {DP_LOSS_RTOL:g})")
    check(loss_err <= DP_LOSS_RTOL, f"TP step loss {loss_err}")
    compare_weights("2 TP steps vs one device", split[2], one[2],
                    noise_elements(conformer, x, y),
                    DP_PARAM_RTOL, DP_PARAM_ATOL, 2 * lr * 2)

    # sharded embed_clips: one mel launch per shard
    header, model, encoder = load_nww(CRNN, device=cuda)
    features = AudioFeatures(encoder_state_dict=encoder, device=cuda)
    clips = np.round(seeded_audio(1024, 32000, seed=SEED)).astype(np.int16)
    features.embed_clips(clips, batch_size=256, mesh=mesh)    # warm-up
    seconds = {}
    for which in ("one device", "mesh", "mesh", "one device"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "mesh":
            mel_cuda.reset_launches()
            split = features.embed_clips(clips, batch_size=256, mesh=mesh)
            launches = mel_cuda.launches
        else:
            alone = features.embed_clips(clips, batch_size=256, mesh=None)
        seconds.setdefault(which, []).append(time.perf_counter() - t0)
    n_shards = 4 * mesh.shape[M.DATA_AXIS]
    err = float(np.abs(split - alone).max())
    log(f"[dp] embed_clips int16 [1024, 32000] over the mesh vs one device: "
        f"max|diff| {err:.3g} (bound {BATCH_TOL:g}); mel launches {launches}"
        f" for {n_shards} shards; clips/s (host clock, in turns): "
        + ", ".join(f"{k} {[round(1024 / t, 1) for t in v]}"
                    for k, v in seconds.items()))
    check(err <= BATCH_TOL, f"sharded embed_clips {err}")
    check(launches >= n_shards, f"{launches} mel launches < {n_shards}")

    # the server, data_parallel=-1
    requests = [rng.normal(0, 1, (1, 16, 96)).astype(np.float32)
                for _ in range(256)]

    def serve(**kwargs):
        server = rv._ScoringServer(CRNN, "verifier_only", device=cuda,
                                   **kwargs)

        async def run():
            server.start()
            return await asyncio.gather(*[
                server.reply(rv.encode_features(f), None) for f in requests])
        return server, np.array([json.loads(r)["score"]
                                 for r in asyncio.run(run())])

    server, scores = serve(data_parallel=-1, mesh_devices=devices)
    check(server.session.mesh is not None, "the server did not shard")
    _, scores_one = serve()
    err = float(np.abs(scores - scores_one).max())
    log(f"[dp] server, data_parallel=-1 over {server.session.mesh.shape}: "
        f"256 concurrent requests vs the single-device server max|score| "
        f"{err:.3g} (bound {BATCH_TOL:g})")
    check(err <= BATCH_TOL, f"sharded server {err}")
    log(f"[time] phase 21 (parallel): {time.perf_counter() - t_phase:.3f} s "
        f"(host clock)")
    return launches


# Phase 22: the quality campaign on the card. Eval sets cut to the first
# files of each of the JAX tool's sets (formant 40 of 400, resonator /
# harmonic / fx 12 of 150 each, 8 of 240 speech, 4 of 60 adversarial and
# 4 of 120 noise streams of 30 s; 24 of 600 train noises and 24 of 300
# impulses), the pipeline cut to 64 clips per task, 300 of 20000 steps and
# 200 of 8000 distillation steps.
QUALITY_CUT = dict(n_train_noise=24, n_rir=24, n_eval_pos=40,
                   n_eval_pos_reson=12, n_eval_pos_harm=12, n_eval_pos_fx=12,
                   eval_speech_files=8, eval_adv_files=4, eval_noise_files=4)
PIPELINE_CUT = dict(steps=300, distill_steps=200, clips_per_task=64)
# the regression bars of tests/test_quality_campaign.py
BARS_OP = {"threshold": 0.85, "patience": 2}


def quality_phase(cuda, card, work) -> dict:
    """Phase 22: the campaign's judgement through the port's tool
    (nanowakeword_tpu_torch/tools/quality_campaign.py) on the card. `prep`
    at QUALITY_CUT; `evaluate`, `evaluate_lite`, `sweep` and `cascade` of
    the committed cascade: one graph capture per interpreter, mel launches
    == chunks streamed (+ the capture's warm-up steps), card vs CPU traces
    on the first files of each set within SCORE_TOL, files within 1e-3 of
    a threshold counted; the regression bars of tests/
    test_quality_campaign.py on the card; `report` into a temporary
    folder; the pipeline `-G`, `-t`, `-T -d` at PIPELINE_CUT (mix and mel
    launches in `-t`) and its model judged by `evaluate`; `ship_decision`
    at 12 pairs. -> the kernels' launches."""
    import numpy as np
    from nanowakeword_tpu_torch import NanoInterpreter
    from nanowakeword_tpu_torch.interpreter.nanointerpreter import _FusedStep
    from nanowakeword_tpu_torch.ops import mel_cuda, mix_cuda
    from nanowakeword_tpu_torch.test_model.evaluate_model_with_audio import \
        stream_scores
    from nanowakeword_tpu_torch.tools import quality_campaign as qc
    from nanowakeword_tpu_torch.tools import ship_decision_ci
    from nanowakeword_tpu_torch.utils.audio_io import load_audio

    seconds = {"phase": time.perf_counter()}
    launches = {"mel": 0, "mix": 0}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - t0
        return out

    def driven(name, fn, *args, **kwargs):
        """fn on the card with the counters set to 0 just before and read
        just after; -> (result, mel launches, mel captures, mix)."""
        mel_cuda.reset_launches()
        mix_cuda.reset_launches()
        captured = mel_cuda.captured
        out = timed(name, fn, *args, **kwargs)
        counts = (mel_cuda.launches, mel_cuda.captured - captured,
                  mix_cuda.launches)
        launches["mel"] += counts[0]
        launches["mix"] += counts[2]
        return (out,) + counts

    timed("prep", qc.stage_prep, work=work, **QUALITY_CUT)
    model_dir = qc.COMMITTED

    def judged(name, fn, **kwargs):
        res, mel, captures, _ = driven(name, fn, work=work, device=cuda,
                                       **kwargs)
        chunks = sum(res["rate"][s]["chunks"] for s in qc.EVAL_SETS)
        log(f"[quality] {name}: {chunks} chunks, mel launches {mel}, "
            f"graph captures {captures} (mel launches inside the graph)")
        check(captures == 1, f"{name}: {captures} captures, one expected")
        check(mel == chunks + _FusedStep.WARMUP_STEPS,
              f"{name}: {mel} mel launches for {chunks} chunks")
        for s in qc.EVAL_SETS:
            r = res["rate"][s]
            log(f"[time] {card}: {name} {s}: {r['files']} files, "
                f"{r['files_per_s']:.2f} files/s, "
                f"{r['audio_h_per_wall_s']:.5f} audio h per wall s, chunk "
                f"p50 {r['chunk_ms_p50']:.3f} ms p90 {r['chunk_ms_p90']:.3f}"
                f" ms (host clock)")
            near = res["near_threshold"][s]
            log(f"[quality] {name} {s}: {res[s]}; files within 1e-3 of a "
                f"threshold: " + ", ".join(
                    f"{k} {len(v)} {[n['file'] for n in v]}"
                    for k, v in near.items()))
        return res

    full = judged("evaluate", qc.stage_evaluate, model_dir=model_dir)
    lite = judged("evaluate_lite", qc.stage_evaluate, model_suffix="_lite",
                  model_dir=model_dir)
    sweep = timed("sweep", qc.stage_sweep, work=work)
    log(f"[quality] sweep: operating point {sweep['operating_point']}")
    cascade = judged("cascade", qc.stage_evaluate_cascade,
                     model_dir=model_dir)
    log(f"[quality] cascade: verifier skip rate on negatives "
        f"{cascade['verifier_skip_rate_negatives']}")
    for res in (full, lite, cascade):
        check(all(res[s]["skipped_files"] == 0 for s in qc.EVAL_SETS),
              "a synthesized eval file was skipped")

    # card vs CPU on the first files of each set (the first 10 s of a
    # stream: the streaming trace of a prefix is the prefix of the trace)
    def cpu_traces(path, cascade_mode, keys, subset):
        interp = NanoInterpreter.load_model(str(path), cascade=cascade_mode,
                                            device="cpu")
        rows = {}
        for name, files in subset.items():
            out = []
            for f in files:
                audio = load_audio(str(work / "eval" / name / f))[:160000]
                if not cascade_mode:
                    out.append(stream_scores(interp, audio, keys[0])[None])
                    continue
                interp.reset()
                row = []
                for s in range(0, len(audio) - 1279, 1280):
                    res = interp.predict(audio[s:s + 1280].astype(np.int16))
                    row.append([res.get(k, 0.0) for k in keys])
                out.append(np.asarray(row, np.float32).T)
            rows[name] = out
        return rows

    t0 = time.perf_counter()
    worst = {}
    for label, path, mode, keys, trace_dir in (
            ("full", model_dir / "hey_nano_crnn.nww", False,
             ["hey_nano_crnn"], "traces"),
            ("lite", model_dir / "hey_nano_crnn_lite.nww", False,
             ["hey_nano_crnn_lite"], "traces_lite"),
            ("cascade", model_dir / "hey_nano_crnn.nww", True,
             ["hey_nano_crnn", "hey_nano_crnn_lite"], "traces_cascade")):
        subset = {}
        for name in qc.EVAL_SETS:
            files = json.loads((work / trace_dir / f"{name}_files.json")
                               .read_text())
            subset[name] = files[:2 if name.startswith("positive") else 1]
        cpu = cpu_traces(path, mode, keys, subset)
        err = 0.0
        for name, rows in cpu.items():
            if mode:
                card_rows = [np.load(work / trace_dir / f"{name}_{w}.npy")
                             for w in ("verifier", "gate")]
            else:
                card_rows = [np.load(work / trace_dir / f"{name}.npy")]
            for i, row in enumerate(rows):
                for k, ours in enumerate(row):
                    n = len(ours)
                    err = max(err, float(np.abs(
                        card_rows[k][i][:n] - ours).max()))
        worst[label] = err
        check(err <= SCORE_TOL, f"{label} card vs CPU {err}")
    seconds["card vs CPU"] = time.perf_counter() - t0
    log(f"[quality] card vs CPU on the first 2 positives and the first 10 "
        f"s of the first stream of each set: max|score| {worst} (bound "
        f"{SCORE_TOL:g})")

    # the regression bars of tests/test_quality_campaign.py, on the card
    bars, mel, captures, _ = driven("bars", quality_bars, cuda)
    log(f"[quality] regression bars on the card: {bars}; mel launches "
        f"{mel}, graph captures {captures}")

    with tempfile.TemporaryDirectory(prefix="nww_report_") as out:
        merged = timed("report", qc.stage_report, work=work, out=out)
        check(set(merged) >= {"full_model", "lite_gate",
                              "operating_point_sweep", "cascade"},
              f"report has {sorted(merged)}")
        check(os.path.exists(os.path.join(out, "results.json")),
              "report wrote no results.json")

    # the pipeline of the campaign's config at cut depth
    _, mel_g, _, mix_g = driven("-G", qc.stage_pipeline, "G", work=work,
                                device=cuda, **PIPELINE_CUT)
    _, mel_t, _, mix_t = driven("-t", qc.stage_pipeline, "t", work=work,
                                device=cuda)
    log(f"[launches] phase 22 -t: mix kernel {mix_t}, mel kernel {mel_t}")
    check(mix_t > 0 and mel_t > 0, "-t launched no mix or mel kernel")
    driven("-T -d", qc.stage_pipeline, "Td", work=work, device=cuda)
    trained = judged("evaluate (trained)", qc.stage_evaluate,
                     out_name="eval_trained")
    log(f"[quality] the model trained at {PIPELINE_CUT}: " + "; ".join(
        f"{s} {trained[s]}" for s in qc.EVAL_SETS))

    report, mel, _, _ = driven("ship_decision", ship_decision_ci.ship_decision,
                               n_pairs=12, boot=1000, device=cuda)
    log(f"[quality] ship_decision at 12 pairs on the card: accs "
        f"{report['accs']}, ship_score {report['ship_score']}, delta CI "
        f"{report['delta_ci95']}; mel launches {mel}")
    check(mel > 0, "ship_decision launched no mel kernel")

    total = time.perf_counter() - seconds.pop("phase")
    log(f"[launches] phase 22: mel kernel {launches['mel']}, mix kernel "
        f"{launches['mix']}")
    log(f"[time] phase 22: {total:.3f} s, of it " + ", ".join(
        f"{k} {v:.3f} s" for k, v in seconds.items()) + " (host clock)")
    return launches


def quality_bars(cuda) -> dict:
    """The bars of tests/test_quality_campaign.py on the card: the
    committed cascade streamed over that test's regenerated clips (25
    positives, 8 speech streams of 10 s and 3 noise clips, 15 fx
    positives). -> each bar's measured count."""
    import numpy as np
    from nanowakeword_tpu_torch import NanoInterpreter
    from nanowakeword_tpu_torch.tools import quality_campaign as qc

    words = qc._words()
    rng = np.random.default_rng(55_000_000)
    pos = [qc._positive_eval_clip(rng, 55_000_000 + i) for i in range(25)]
    srng = np.random.default_rng(56_000_000)
    negs = [qc._speech_stream(srng, words, 10) for _ in range(8)]
    negs += [qc._mic_floor(np.random.default_rng(57_000_000 + i), 160000)
             * 30 for i in range(3)]
    frng = np.random.default_rng(58_000_000)
    fx = [qc._positive_eval_clip(frng, 58_000_000 + i, channel="formant_fx")
          for i in range(15)]

    def traces(interp, keys, clips):
        out = []
        for clip in clips:
            audio = np.clip(np.asarray(clip) * 32767.0, -32768,
                            32767).astype(np.int16)
            interp.reset()
            rows = []
            for i in range(0, len(audio) - 1279, 1280):
                res = interp.predict(audio[i:i + 1280])
                rows.append([res.get(k, 0.0) for k in keys])
            out.append(np.asarray(rows).T)
        return out

    def detect(rows, thr=BARS_OP["threshold"], pat=BARS_OP["patience"]):
        return int(sum(qc._patience_score(r[None], pat)[0] >= thr
                       for r in rows))

    full = NanoInterpreter.load_model(str(qc.COMMITTED / "hey_nano_crnn.nww"),
                                      device=cuda)
    lite = NanoInterpreter.load_model(
        str(qc.COMMITTED / "hey_nano_crnn_lite.nww"), device=cuda)
    cascade = NanoInterpreter.load_model(
        str(qc.COMMITTED / "hey_nano_crnn.nww"), cascade=True, device=cuda)
    key = ["hey_nano_crnn"]
    p, n, f = (traces(full, key, c) for c in (pos, negs, fx))
    lp = traces(lite, ["hey_nano_crnn_lite"], pos)
    ck = [cascade.cascade_config["verifier"], cascade.cascade_config["gate"]]
    cp, cn = traces(cascade, ck, pos), traces(cascade, ck, negs)
    gate_thr = cascade.cascade_config["gate_threshold"]
    invoke = float(np.mean(np.concatenate([r[1] for r in cn]) >= gate_thr))
    bars = [  # (what, measured, at least, at most)
        ("detected at 0.90, of 25", sum(r[0].max() >= 0.90 for r in p),
         23, None),
        ("false alarms at 0.90, of 11", sum(r[0].max() > 0.90 for r in n),
         None, 1),
        ("gate detected at 0.3, of 25", sum(r[0].max() >= 0.3 for r in lp),
         23, None),
        ("detected at the production point, of 25",
         detect([r[0] for r in p]), 22, None),
        ("false alarms at the production point, of 11",
         detect([r[0] for r in n]), None, 1),
        ("fx detected at 0.90, of 15", sum(r[0].max() >= 0.90 for r in f),
         13, None),
        ("fx detected at the production point, of 15",
         detect([r[0] for r in f]), 12, None),
        ("cascade detected at the production point, of 25",
         detect([r[0] for r in cp]), 21, None),
        ("cascade false alarms at the production point, of 11",
         detect([r[0] for r in cn]), None, 1),
        ("verifier invocation rate on negatives", invoke, None, 0.5),
    ]
    for what, value, low, high in bars:
        check((low is None or value >= low)
              and (high is None or value <= high),
              f"regression bar, {what}: {value}")
    return {what: float(value) for what, value, _, _ in bars}


if __name__ == "__main__":
    sys.exit(main())
