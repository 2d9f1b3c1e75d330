#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (nanowakeword_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the root of the repository

It builds the port's CUDA kernel from the checkout, holds it against its
plain PyTorch version, drives the serving path through the entry points a
user calls (batch scoring with `AudioFeatures.embed_clips` and a session, and
the streaming cascade `NanoInterpreter.load_model(..., cascade=True)`),
compares the card's scores with the same port run on the CPU, and times the
kernel, batch scoring and per-chunk streaming latency.

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
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CRNN = os.path.join(ROOT, "campaign", "hey_nano_crnn.nww")
SEED = 0
KERNEL_TOL = 2e-3   # kernel vs plain log-mel (tests/test_mel_pallas.py bar)
SCORE_TOL = 1e-3    # card vs CPU scores (tests/test_score_trace.py bar)


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

    # -- 2. the build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build("mel_frontend")
    log(f"[build] {os.path.relpath(lib, ROOT)} from "
        f"{os.path.relpath(_build.CSRC / 'mel_frontend.cu', ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")

    # -- 3. the kernel against its plain version, on the card ------------------------
    def audio(shape, dtype):
        x = rng.integers(-20000, 20000, shape).astype(np.int16)
        return torch.from_numpy(x).to(cuda).to(dtype)

    max_err = 0.0
    cases = [((1, 16000), torch.float32), ((4, 16000), torch.int16),
             ((3, 48000), torch.int16), ((5, 12345), torch.float32),
             ((16000,), torch.float32), ((2, 16000), torch.bfloat16),
             # the shapes of the main path: batch scoring, streaming step
             ((1024, 32000), torch.int16), ((1600,), torch.float32)]
    for shape, dtype in cases:
        x = audio(shape, dtype)
        out = mel_cuda.mel_frontend_cuda(x)
        torch.cuda.synchronize()
        ref = mel_cuda.mel_frontend_plain(x)
        check(out.shape == ref.shape, f"shape {tuple(out.shape)} vs "
              f"{tuple(ref.shape)}")
        err = (out - ref).abs().max().item()
        log(f"[kernel] {shape} {str(dtype)[6:]}: max|kernel - plain| = "
            f"{err:.3g}")
        check(err <= KERNEL_TOL, f"kernel vs plain {err} > {KERNEL_TOL}")
        max_err = max(max_err, err)
    x = audio((4, 16000), torch.int16)
    f32 = mel_cuda.mel_frontend_cuda(x)
    b16 = mel_cuda.mel_frontend_cuda(x, out_dtype=torch.bfloat16)
    check(b16.dtype == torch.bfloat16
          and torch.equal(b16, f32.to(torch.bfloat16)),
          "bf16 output differs from the cast f32 output")
    log("[kernel] out_dtype=bf16 equals the cast f32 output")

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
    x = audio((4096, 16000), torch.int16)
    err = (mel_cuda.mel_frontend_cuda(x)
           - mel_cuda.mel_frontend_plain(x)).abs().max().item()
    check(err <= KERNEL_TOL, f"kernel vs plain at [4096, 16000]: {err}")
    max_err = max(max_err, err)
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = (mel_cuda.mel_frontend_cuda if which == "kernel"
              else mel_cuda.mel_frontend_plain)
        times[which].append(cuda_ms(lambda: fn(x), 20))
    kernel_ms, plain_ms = min(times["kernel"]), min(times["plain"])
    log(f"[time] {card}: log-mel [4096, 16000] int16: kernel "
        f"{times['kernel']} ms, plain {times['plain']} ms "
        f"(CUDA events, mean of 20 after warm-up)")

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

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "nanowakeword_tpu"))
    check(not leaked, f"imported {leaked}")

    print(json.dumps({"kernels": [{
        "name": "mel_frontend",
        "route": "cuda",
        "source": "nanowakeword_tpu_torch/csrc/mel_frontend.cu",
        "replaces": "nanowakeword_tpu/ops/mel_pallas.py:269",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
