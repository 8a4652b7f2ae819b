"""Order statistics over every sample: tails are taken over all values,
never from medians of chunks."""
from __future__ import annotations

import statistics


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (0-100) of ``values`` by linear
    interpolation between closest ranks (numpy's default method), or
    ``None`` for no values."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values) -> float | None:
    xs = [float(v) for v in values]
    return statistics.median(xs) if xs else None

