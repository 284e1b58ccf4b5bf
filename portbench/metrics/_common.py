"""Helpers shared by the metric readers (not a reader: no metric starts with _)."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank q-th percentile (q in (0, 100]); None when empty."""
    v = sorted(values)
    if not v:
        return None
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


def per_transfer(run, span: str, value) -> List[float]:
    """Per transfer outside the profiled sub-window, the sum of value(call)
    over the span's calls in it."""
    t = run.tracer
    if t is None:
        return []
    sums: Dict[int, float] = {}
    for c in t.calls:
        if c.name == span and not c.profiled and c.transfer >= 0:
            v = value(c)
            if v is None:
                return []
            sums[c.transfer] = sums.get(c.transfer, 0.0) + v
    return list(sums.values())
