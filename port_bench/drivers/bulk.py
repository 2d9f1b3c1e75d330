"""The bulk entry: batches of recorded clips scored as a pipeline scores
them, `AudioFeatures.embed_clips` then `_LocalSession.run_batch`, one call
after another.

Set-up draws `pool_batches` batches of clips on the device, moves them to
pinned host memory (as a `DataLoader(pin_memory=True)` hands them over),
loads the model and its frontend, and makes the warm-up calls. The window
cycles through the pool until `--seconds` have passed; a clip counts once
its score is on the host. A traced run then makes `trace_calls` more calls
under the profiler. After the window every score of every call is held
against the reference's score of its clip.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from port_bench import audio, compare, flops, program
from port_bench.reference import models as refmodels
from port_bench.reference import scores as refscores
from port_bench.result import Result, traced


def make_pool(traffic: dict, seed: int, device) -> list:
    """`pool_batches` [batch, clip_samples] int16 CPU tensors, pinned when
    the traffic says so and a card is there."""
    n, b = traffic["pool_batches"], traffic["batch"]
    clips = audio.speech_like(n * b, traffic["clip_samples"], seed, device,
                              traffic["audio"])
    pin = traffic.get("pinned", False) and torch.cuda.is_available()
    pool = [clips[i * b:(i + 1) * b].cpu() for i in range(n)]
    return [t.pin_memory() if pin else t for t in pool]


def run(ctx) -> Result:
    config, traffic = ctx.config, ctx.traffic
    pool = make_pool(traffic, ctx.seed, ctx.device)
    ctx.mark("traffic")
    weights = program.Weights(config, ctx.seed, ctx.device, ctx.workdir)
    ctx.mark("weights")
    ctx.reset_peak()
    frontend, session = program.bulk_scorer(config, weights, ctx.device)
    ctx.mark("load")
    batch = traffic["batch"]

    def call(clips, record=False):
        if not record:
            return session.run_batch(frontend.embed_clips(
                clips, batch_size=batch))
        with torch.profiler.record_function("port_bench.embed_clips"):
            feats = frontend.embed_clips(clips, batch_size=batch)
        with torch.profiler.record_function("port_bench.run_batch"):
            return session.run_batch(feats)

    for k in range(traffic["warmup_calls"]):
        call(pool[k % len(pool)])
    ctx.sync()
    ctx.mark("warm-up")
    setup_s = time.perf_counter() - ctx.t_start

    scored, times, ends = [], [], []
    t0 = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        scored.append((i % len(pool), call(pool[i % len(pool)])))
        b = time.perf_counter()
        times.append(b - a)
        ends.append(b - t0)
        i += 1
        if b - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    ctx.mark("window")

    trace = None
    if ctx.trace:
        def segment():
            for j in range(traffic["trace_calls"]):
                call(pool[(i + j) % len(pool)], record=True)
        trace = traced(segment, traffic["trace_calls"])
        ctx.mark("trace")

    peak = ctx.memory_peak()
    del frontend, session
    gc.collect()
    ctx.free()
    attempted, failed, gap = _check(ctx, config, weights, pool, scored)
    return Result(
        kind="bulk", setup_s=setup_s, window_s=window_s,
        units=len(times) * batch, calls=len(times), call_seconds=times,
        flops_per_unit=flops.bulk_clip_flops(config,
                                             traffic["clip_samples"]),
        trace=trace, memory_peak_bytes=peak, attempted=attempted,
        failed=failed,
        checks={"score_gap": {"value": gap,
                              "limit": ctx.limits["score_gap"]}},
        mel_work=flops.mel_work(batch, traffic["clip_samples"]),
        extra={"call_ends": ends})


def reference_pool(config, weights, pool, device, prec) -> list:
    """The reference's [batch] probabilities for each batch of the pool."""
    encoder = refmodels.to_tensors(weights.encoder, prec, device)
    variables, model_type = weights.reference_model(config["bulk_model"])
    model = (refmodels.to_tensors(variables, prec, device), model_type)
    with torch.no_grad():
        return [refscores.bulk_scores(clips.to(device), encoder, model, prec)
                for clips in pool]


def _check(ctx, config, weights, pool, scored):
    expected = reference_pool(config, weights, pool, ctx.device,
                              refmodels.REFERENCE)
    gaps = np.concatenate([compare.score_gaps(s, expected[b])
                           for b, s in scored])
    limit = ctx.limits["score_gap"]
    return len(gaps), int((gaps > limit).sum()), float(gaps.max())
