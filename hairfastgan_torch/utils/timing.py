"""Benchmark session: wall times of whole swaps, each ended by a device
synchronize that the caller makes (reference utils/time.py:9-36 prints
count/min/median/std to stderr)."""

from __future__ import annotations

import sys
import time
from typing import List

import numpy as np


class BenchSession:
    def __init__(self, name: str = "swap"):
        self.name = name
        self.times: List[float] = []
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def lap(self) -> None:
        """Close the lap begun by `start` (after the caller's synchronize)."""
        self.times.append(time.perf_counter() - self._t0)

    def report(self) -> dict:
        t = np.asarray(self.times)
        stats = {"n": len(t), "min": float(t.min()), "median": float(np.median(t)),
                 "std": float(t.std())}
        print(f"[bench:{self.name}] n={stats['n']} min={stats['min']:.3f}s "
              f"median={stats['median']:.3f}s std={stats['std']:.3f}s",
              file=sys.stderr)
        return stats
