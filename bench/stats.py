"""Percentiles over every value given (never over chunks)."""
from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float | None:
    """The q-th percentile (numpy's linear interpolation) of all
    ``values``; None for none."""
    v = np.asarray(list(values), np.float64)
    return float(np.percentile(v, q)) if v.size else None

