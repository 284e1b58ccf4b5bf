"""The comparison that decides `correct`, by kind. A configuration names
the kind that judges its runs (`"check"`, default registry.DEFAULT_CHECK);
kind <kind> is portbench/checks/<kind>.py, found through the Registry, with

  NUMBERS                                       the numbers it compares
  compare(conf, seed, device, samples, control) -> (found, detail): those
      numbers over the window's sampled requests (portbench/load.Sample),
      and what they were worked out from; with `control` (a precision mode
      of portbench/precision.py) the details also hold the control's
      readings, which the limits are set from

Every number is held to the cell's limit (portbench/limits/<cell>.json) by
`verdict`, which the kinds share.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def compared(numbers: List[str], limits: Dict[str, float]) -> List[str]:
    """The numbers a run is judged by: those of its kinds, then any limit's
    that they lack (which then fails)."""
    return list(numbers) + [k for k in limits if k not in numbers]


def verdict(found: Dict[str, float], limits: Dict[str, float],
            numbers: List[str]) -> Tuple[bool, List[str]]:
    """(correct, lines 'name value (limit L)'): every number at or under its
    limit, and every limit's number found."""
    lines, ok = [], bool(found) and bool(limits)
    for k in compared(numbers, limits):
        v, lim = found.get(k), limits.get(k)
        good = v is not None and lim is not None and v <= lim
        ok = ok and good
        lines.append(f"{k} {v} (limit {lim})")
    return ok, lines
