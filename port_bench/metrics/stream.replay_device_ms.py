"""stream.replay_device_ms: the device's busy time per chunk in the traced
segment (the union of every kernel, copy and memset), in milliseconds: the
captured step's replay with the chunk's upload and the scores' readback."""


def read(result):
    t = result.trace
    if result.kind != "stream" or t is None or not t.units or t.busy_s <= 0:
        return None
    return t.busy_s / t.units * 1e3
