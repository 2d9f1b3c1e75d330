"""stream_chunks_per_s: 80 ms chunks answered by `predict` in the window,
over the window's seconds (host clock; the resets between clips count in
the window)."""


def read(result):
    return result.units_per_s if result.kind == "stream" else None
