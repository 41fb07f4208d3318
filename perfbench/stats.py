"""Order statistics of the benchmark's samples."""

from __future__ import annotations

from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile by linear interpolation between the order
    statistics (numpy's default); None without samples."""
    if not values:
        return None
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
