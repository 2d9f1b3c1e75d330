"""stream_chunk_p95_ms: the 95th percentile of the host time of every
`predict(chunk)` call in the window, in milliseconds."""

import numpy as np


def read(result):
    if result.kind != "stream" or not result.call_seconds:
        return None
    return float(np.percentile(result.call_seconds, 95)) * 1e3
