"""stream.verifier_skip_pct: of the chunks the interpreter scored, the share
on which the one-call step, split at the cascade's gate, did not run the
verifier, in percent: the program's `interpreter.verifier_skipped` over
`interpreter.chunks` counters in the traced segment. A program whose step
is not split has no such counter, and a stream with no cascade neither runs
nor skips a verifier: the metric is then left out."""

from port_bench import spans


def read(result):
    snap = spans.snapshot()
    if result.kind != "stream" or snap is None:
        return None
    counters = snap.counters
    skipped = counters.get("interpreter.verifier_skipped")
    chunks = counters.get("interpreter.chunks", 0)
    if skipped is None or chunks <= 0 \
            or skipped + counters.get("interpreter.verifier_runs", 0) <= 0:
        return None
    return 100.0 * skipped / chunks
