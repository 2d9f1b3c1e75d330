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
served on the card against the CPU. It times both kernels against their
plain versions, batch scoring, streaming latency (eager and replayed), the
server's requests per second, the transform stage, training steps of both
loops in float32 and bf16, each family's forward, distillation steps, clip
generation and end-to-end steps.

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

    # -- 2. the build: one nvcc per kernel, all started together ----------------
    t0 = time.perf_counter()
    names = ("mel_frontend", "mix_gain")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_build.build, names))
    for name, lib in zip(names, libs):
        log(f"[build] {os.path.relpath(lib, ROOT)} from "
            f"{os.path.relpath(_build.CSRC / (name + '.cu'), ROOT)}")
    log(f"[build] {len(names)} kernels in {time.perf_counter() - t0:.2f} s")

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

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "nanowakeword_tpu"))
    check(not leaked, f"imported {leaked}")

    print(json.dumps({"kernels": [{
        "name": "mel_frontend",
        "route": "cuda",
        "source": "nanowakeword_tpu_torch/csrc/mel_frontend.cu",
        "replaces": "nanowakeword_tpu/ops/mel_pallas.py:269",
        "launches": main_launches + serving_launches + e2e["mel"],
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
        "launches": train["mix_launches"] + e2e["mix"],
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
    from nanowakeword_tpu_torch import NanoInterpreter
    from nanowakeword_tpu_torch.models.model import Model
    from nanowakeword_tpu_torch.ops import mel_cuda, mix_cuda
    from nanowakeword_tpu_torch.train.cached import (build_cached_data,
                                                     make_cached_train_loop)
    from nanowakeword_tpu_torch.train.optim import Optimizer
    from nanowakeword_tpu_torch.trainer import run_pipeline

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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_pipeline(config, transform_clips=True, overwrite=True, device=cuda)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"[time] {card}: transform stage (decode + augment + features, batch "
        f"512, 1024 clips of 2 s): {1024 / seconds:.1f} clips/s ({seconds:.3f}"
        f" s, host clock, second run)")

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
    negatives) and 20 steps at 256 clips a batch; the mel kernel runs in
    every step's forward. Then one step card vs CPU with a float32 encoder
    (judge_step), and the exported `.nww`, which bundles the trained
    encoder, served on the card against the CPU. -> the kernels' launches."""
    import numpy as np
    import torch
    from nanowakeword_tpu_torch import NanoInterpreter
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
    from nanowakeword_tpu_torch.utils.audio_io import load_audio

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
    try:
        for steps, composition in ((100, {"targets": 8, "negatives": 16}),
                                   (20, {"targets": 64, "negatives": 192})):
            before = mel_cuda.launches
            t0 = time.perf_counter()
            run = run_pipeline(dict(config, model_name=f"smoke_e2e_{steps}",
                                    steps=steps, early_stopping_patience=0,
                                    batch_composition=composition,
                                    end_to_end=e2e_cfg),
                               train_model=True, device=cuda)
            seconds[f"-T e2e, {steps} steps"] = time.perf_counter() - t0
            run["launches"] = mel_cuda.launches - before
            run["loop"] = trainers[-1].loop_seconds
            run["stamps"] = trainers[-1].stamps
            runs[steps] = run
    finally:
        Trainer.train_model = train_model
    for steps, run in runs.items():
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
            f"(WAV decoding) for {waited:.3f} s, {100 * waited / loop:.1f}% "
            f"of it")

    # the artifact bundles the trained encoder
    e2e = runs[100]["model"]
    header, _, encoder = load_nww(runs[100]["artifact"], device="cpu")
    trained = e2e.module.encoder.state_dict()
    asset = encoder_state_dict_from_flax(pretrained_encoder_variables())
    check(header["has_encoder"] and all(torch.equal(encoder[k],
                                                    trained[k].cpu())
                                        for k in trained),
          "the artifact's encoder is not the trained one")
    moved = max((trained[k].cpu() - torch.as_tensor(asset[k])).abs().max()
                .item() for k in trained)
    check(moved > 0, "e2e training did not move the encoder")
    log(f"[e2e] {os.path.basename(runs[100]['artifact'])} bundles the "
        f"trained encoder (max|trained - asset| {moved:.3g})")

    # one step, card vs CPU, from the same weights and audio
    dataset = AudioClipDataset(manifest, clip_samples=32000)
    pools = dataset.index_pools
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
        interp = NanoInterpreter.load_model(runs[100]["artifact"],
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
    total = time.perf_counter() - seconds.pop("phase")
    log(f"[time] phase 18: {total:.3f} s, of it "
        + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
        + " (host clock)")
    return launches


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


if __name__ == "__main__":
    sys.exit(main())
