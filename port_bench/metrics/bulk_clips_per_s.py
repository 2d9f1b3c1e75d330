"""bulk_clips_per_s: clips whose scores reached the host in the window,
over the window's seconds (host clock)."""


def read(result):
    return result.units_per_s if result.kind == "bulk" else None
