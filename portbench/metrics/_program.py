"""The program's own spans (hairfastgan_torch.utils.timing), as the readers
idle_ms and busy_ms take them (not a reader: no metric starts with _).

The program keeps its spans while torch's profiler runs, stamped with the
profiler's clock (Unix-epoch ns), so they lie on the timeline of the
profiled sub-window beside its device operations and kernel launches. A
program that records no spans, or a run that kept none in the sub-window,
gives None.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

Segment = Tuple[int, int, Optional[str]]


def kept(run):
    """(the profile, the program's kept spans that overlap its sub-window),
    or None."""
    t = run.tracer
    p = t.profile if t is not None else None
    if p is None or p.transfers <= 0:
        return None
    try:
        from hairfastgan_torch.utils import timing

        spans = timing.spans()
    except (ImportError, AttributeError):  # a program without spans
        return None
    lo, hi = p.window
    inside = [s for s in spans if s.t1 > lo and s.t0 < hi]
    return (p, inside) if inside else None


def timeline(spans, names: Sequence[str], lo: int, hi: int) -> List[Segment]:
    """[lo, hi] cut into (start, end, name) segments: at each instant the
    innermost span named in `names` that is open (the one opened last), or
    None where none is."""
    chosen = [s for s in spans if s.name in names]
    cuts = sorted({lo, hi} | {min(max(t, lo), hi) for s in chosen for t in (s.t0, s.t1)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        open_ = [s for s in chosen if s.t0 <= a and s.t1 >= b]
        out.append((a, b, max(open_, key=lambda s: (s.t0, s.id)).name if open_ else None))
    return out


def idle_gaps(p) -> List[Tuple[int, int]]:
    """The profile's sub-window minus the union of its device operations."""
    lo, hi = p.window
    gaps, at = [], lo
    for s, e in p.busy_intervals():
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def launched_ns(p, segments: List[Segment], name: str) -> int:
    """Device ns of the operations whose runtime launch lies in a segment
    named `name`."""
    starts = [s for s, _, _ in segments]
    total = 0
    for _, _, s, e, corr in p.device_ops:
        t = p.launches.get(corr)
        i = -1 if t is None else bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= segments[i][1] and segments[i][2] == name:
            total += e - s
    return total
