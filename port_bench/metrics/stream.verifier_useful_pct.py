"""stream.verifier_useful_pct: of the chunks on which the cascade's
verifier ran, the share whose verifier score reached the result (the
gate, at or above its threshold, and the window's warm-up guard let it
through), in percent: the program's `interpreter.verifier_served` over
`interpreter.verifier_runs` counters in the traced segment. The rest of
the verifier's work in the captured step was thrown away."""

from port_bench import spans


def read(result):
    snap = spans.snapshot()
    if result.kind != "stream" or snap is None:
        return None
    runs = snap.counters.get("interpreter.verifier_runs", 0)
    if runs <= 0:
        return None
    return 100.0 * snap.counters["interpreter.verifier_served"] / runs
