"""The streaming entry: one stream, a closed loop of `NanoInterpreter.predict`
calls, one 80 ms int16 chunk each.

Set-up draws the clips (their lengths are the traffic's whole range of
chunk counts, each as often as the others, in an order drawn from the
seed), loads the interpreter (which captures its one-call step as a CUDA
graph on the card) and streams the warm-up clips. The window streams the
clips one after another, `reset()` before each, and times every `predict`
on the host clock until `--seconds` have passed. A traced run then streams
`trace_chunks` more chunks under the profiler. After the window every
served score of every chunk is held against the reference's.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from port_bench import audio, compare, flops, program
from port_bench.reference import models as refmodels
from port_bench.reference import scores as refscores
from port_bench.reference.mel import CHUNK
from port_bench.result import Result, traced

REFERENCE_BLOCK = 32        # clips per reference call


def make_clips(traffic: dict, seed: int, device) -> list:
    """The pool of clips as int16 numpy arrays, in the order they stream."""
    lo, hi = traffic["clip_chunks"]
    lengths = np.arange(traffic["pool_clips"]) % (hi - lo + 1) + lo
    order = torch.randperm(len(lengths), generator=torch.Generator()
                           .manual_seed(int(seed))).numpy()
    pool = audio.speech_like(len(lengths), hi * CHUNK, seed, device,
                             traffic["audio"]).cpu().numpy()
    return [pool[i, :lengths[i] * CHUNK] for i in order]


def _stream(interp, clip, names, until=None, times=None, record=None,
            ends=None):
    """Stream one clip from a reset; -> (served rows, stopped early)."""
    interp.reset()
    rows = []
    for k in range(len(clip) // CHUNK):
        t0 = time.perf_counter()
        if record is not None:
            with torch.profiler.record_function(record):
                res = interp.predict(clip[k * CHUNK:(k + 1) * CHUNK])
        else:
            res = interp.predict(clip[k * CHUNK:(k + 1) * CHUNK])
        t1 = time.perf_counter()
        rows.append([res.scores[n] for n in names])
        if times is not None:
            times.append(t1 - t0)
            ends.append(t1)
        if until is not None and t1 >= until:
            return rows, True
    return rows, False


def run(ctx) -> Result:
    config, traffic = ctx.config, ctx.traffic
    clips = make_clips(traffic, ctx.seed, ctx.device)
    ctx.mark("traffic")
    weights = program.Weights(config, ctx.seed, ctx.device, ctx.workdir)
    ctx.mark("weights")
    ctx.reset_peak()
    interp = program.stream_interpreter(config, weights, ctx.device,
                                        traffic.get("vad_threshold", 0))
    ctx.mark("load")
    names = list(interp.models)
    for clip in clips[:traffic["warmup_clips"]]:
        _stream(interp, clip, names)
    ctx.sync()
    ctx.mark("warm-up")
    setup_s = time.perf_counter() - ctx.t_start

    served, times, ends = [], [], []
    t0 = time.perf_counter()
    until, i, done = t0 + ctx.seconds, 0, False
    while not done:
        index = i % len(clips)
        rows, done = _stream(interp, clips[index], names, until, times,
                             ends=ends)
        served.append((index, rows))
        i += 1
    window_s = time.perf_counter() - t0
    ctx.mark("window")

    trace = None
    if ctx.trace:
        def segment():
            left, j = traffic["trace_chunks"], i
            while left > 0:
                clip = clips[j % len(clips)][:left * CHUNK]
                left -= len(_stream(interp, clip, names,
                                    record="port_bench.predict")[0])
                j += 1
        trace = traced(segment, traffic["trace_chunks"])
        ctx.mark("trace")

    peak = ctx.memory_peak()
    del interp
    gc.collect()
    ctx.free()
    attempted, failed, gap = _check(ctx, config, weights, clips, served,
                                    names)
    return Result(
        kind="stream", setup_s=setup_s, window_s=window_s,
        units=len(times), calls=len(times), call_seconds=times,
        flops_per_unit=flops.stream_chunk_flops(config), trace=trace,
        memory_peak_bytes=peak, attempted=attempted, failed=failed,
        checks={"score_gap": {"value": gap,
                              "limit": ctx.limits["score_gap"]}},
        extra={"call_ends": [e - t0 for e in ends]})


def reference_served(config, weights, clips, names, device, prec,
                     margin: float) -> dict:
    """{clip index: ([K, M] served scores, [K] gate near its threshold)}
    for every clip of `clips` (a dict index -> int16 array)."""
    encoder = refmodels.to_tensors(weights.encoder, prec, device)
    models = [tuple([refmodels.to_tensors(v, prec, device), t]) for v, t in
              (weights.reference_model(n) for n in names)]
    windows = [config["models"][n]["input_shape"][0] for n in names]
    cascade = config.get("cascade")
    spec = None if not cascade else (
        names.index(cascade["gate"]), names.index(cascade["verifier"]),
        cascade["gate_threshold"], margin)
    out = {}
    indices = sorted(clips, key=lambda j: len(clips[j]))
    for b in range(0, len(indices), REFERENCE_BLOCK):
        block = indices[b:b + REFERENCE_BLOCK]
        n = max(len(clips[j]) for j in block)
        batch = np.zeros((len(block), n), np.int16)
        for r, j in enumerate(block):
            batch[r, :len(clips[j])] = clips[j]
        with torch.no_grad():
            raw = refscores.stream_raw(torch.from_numpy(batch).to(device),
                                       encoder, models, prec)
        for r, j in enumerate(block):
            out[j] = refscores.served(raw[r, :len(clips[j]) // CHUNK],
                                      windows, spec)
    return out


def chunk_gaps(config, names, served, expected) -> np.ndarray:
    """The widest score gap of each chunk of `served` ([(clip index, [K, M]
    rows)]) against `expected` (reference_served's dict)."""
    cascade = config.get("cascade")
    gaps = []
    for index, rows in served:
        if len(rows) == 0:
            continue
        got = np.asarray(rows, np.float64)
        want, near = expected[index]
        gap = compare.score_gaps(got, want[:len(got)])
        if cascade:
            # where the gate sits on its threshold either gating is sound
            v = names.index(cascade["verifier"])
            ambiguous = near[:len(got)]
            alone = compare.score_gaps(got[ambiguous, v],
                                       np.zeros(int(ambiguous.sum())))
            gap[ambiguous, v] = np.minimum(gap[ambiguous, v], alone)
        gaps.append(gap.max(axis=1))
    return np.concatenate(gaps)


def _check(ctx, config, weights, clips, served, names):
    used = {index: clips[index] for index, _ in served}
    expected = reference_served(config, weights, used, names, ctx.device,
                                refmodels.REFERENCE,
                                ctx.limits["gate_margin"])
    per_chunk = chunk_gaps(config, names, served, expected)
    limit = ctx.limits["score_gap"]
    return (len(per_chunk), int((per_chunk > limit).sum()),
            float(per_chunk.max()))
