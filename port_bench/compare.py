"""The number that decides `correct`: how far a served score lies from the
reference's.

A score is a sigmoid probability in float32. Its gap is
`max(|p - p_ref| - 2 ulp, 0) / max(p_ref (1 - p_ref), 1e-6)`: the distance,
less two float32 ulps of the larger of the two (the rounding of the served
value itself), in units of the sigmoid's slope at the reference. That is
the gap of the logits wherever float32 can resolve it, so a score near 0 or
near 1 is held as closely as one near 0.5. A score the program serves where
the reference serves 0, or the other way, reads as a gap of p / 1e-6.
"""

from __future__ import annotations

import numpy as np

SLOPE_FLOOR = 1e-6


def score_gaps(served: np.ndarray, reference: np.ndarray) -> np.ndarray:
    served = np.asarray(served, np.float64)
    reference = np.asarray(reference, np.float64)
    ulp = np.spacing(np.maximum(served, reference).astype(np.float32))
    num = np.maximum(np.abs(served - reference) - 2.0 * ulp.astype(np.float64),
                     0.0)
    return num / np.maximum(reference * (1.0 - reference), SLOPE_FLOOR)
