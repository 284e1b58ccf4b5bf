"""The traced run's instruments, all set from outside the program.

Spans: each portbench/spans/<name>.json names callables of the program
(`"targets": ["module:attr[.attr]", ...]`) that the traced run wraps for its
length, all under the span's name.
A wrapped call is a `torch.profiler.record_function("pb.<name>")` range and
is timed by the host clock; with `"args": true` the shapes, item sizes and
ints of its positional arguments are kept. A target that the program no longer
has is skipped, and the metrics that read its span read nothing.

Profile: `torch.profiler` (CPU and CUDA activities) over a short sub-window
of whole transfers, read from the raw Kineto events: device operations
(kernels, copies, sets), the host's `pb.*` ranges, and the runtime launches
that tie each kernel to the host range it was launched in.
"""

from __future__ import annotations

import functools
import importlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Call:
    name: str
    transfer: int
    t0: float
    t1: float = 0.0
    args: Optional[list] = None
    profiled: bool = False


@dataclass
class Profile:
    """What the profiler saw, on its own clock (ns)."""
    window: Tuple[int, int]
    transfers: int
    device_ops: List[Tuple[str, str, int, int, int]]  # (activity, name, start, end, corr)
    ranges: List[Tuple[str, int, int]]  # host pb.* ranges (name, start, end)
    launches: Dict[int, int] = field(default_factory=dict)  # correlation id -> host ns

    def kernels(self):
        return [o for o in self.device_ops if o[0] == "kernel"]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals inside the window."""
        lo, hi = self.window
        iv = sorted((max(s, lo), min(e, hi)) for _, _, s, e, _ in self.device_ops
                    if e > lo and s < hi)
        out: List[List[int]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.busy_intervals())


class Tracer:
    def __init__(self, spans: List[Dict], device: torch.device):
        self.specs = spans
        self.device = device
        self.calls: List[Call] = []
        self.transfer = -1
        self.installed: List[Tuple[object, str, object]] = []
        self.missing: List[str] = []
        self.profiling = False
        self.prof = None
        self.profile: Optional[Profile] = None
        self._window_range = None
        self._profiled_transfers = 0

    # -- spans -------------------------------------------------------------

    def _wrap(self, fn, spec):
        name, keep_args = spec["name"], spec.get("args", False)

        @functools.wraps(fn)
        def call(*a, **k):
            c = Call(name, self.transfer, time.perf_counter(), profiled=self.profiling)
            if keep_args:
                c.args = [(tuple(x.shape), x.element_size()) if isinstance(x, torch.Tensor)
                          else x for x in a] + [v for v in k.values() if isinstance(v, int)]
            with torch.profiler.record_function("pb." + name):
                out = fn(*a, **k)
            c.t1 = time.perf_counter()
            self.calls.append(c)
            return out

        return call

    def install(self) -> None:
        for spec in self.specs:
            for target in spec["targets"]:
                mod_name, _, attr = target.partition(":")
                try:
                    obj = importlib.import_module(mod_name)
                    *parents, last = attr.split(".")
                    for p in parents:
                        obj = getattr(obj, p)
                    fn = getattr(obj, last)
                except (ImportError, AttributeError):
                    self.missing.append(target)
                    continue
                self.installed.append((obj, last, fn))
                setattr(obj, last, self._wrap(fn, spec))

    def remove(self) -> None:
        for obj, last, fn in reversed(self.installed):
            setattr(obj, last, fn)
        self.installed = []

    # -- the profiled sub-window -----------------------------------------

    def profile_start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts, record_shapes=False, with_stack=False)
        self.prof.start()
        self._window_range = torch.profiler.record_function("pb.window")
        self._window_range.__enter__()
        self.profiling = True
        self._profiled_transfers = 0

    def profiled(self, n: int = 1) -> None:
        """Count n transfers as completed inside the profiled sub-window."""
        if self.profiling:
            self._profiled_transfers += n

    def profile_stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window_range.__exit__(None, None, None)
        self.profiling = False
        self.prof.stop()
        self.profile = parse(self.prof, self._profiled_transfers)
        self.prof = None


def _activity(e) -> str:
    """The event's Kineto activity ("kernel", "gpu_memcpy", "cuda_runtime",
    "user_annotation", ...), or "" where this torch does not say."""
    at = getattr(e, "activity_type", None)
    act = at() if callable(at) else None
    return "" if act is None else str(act)


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def parse(prof, transfers: int) -> Profile:
    """The raw Kineto events of a finished profile -> Profile. Device
    operations: events on the CUDA device other than the annotations that
    mirror host ranges there (gpu_user_annotation)."""
    events = prof.profiler.kineto_results.events()
    device_ops, ranges, launches = [], [], {}
    window = None
    for e in events:
        act, name = _activity(e), e.name()
        if _is_device(e):
            if "annotation" in act or name.startswith("pb."):
                continue
            kind = act if act in DEVICE_ACTIVITIES else (
                "gpu_memcpy" if "Memcpy" in name else "gpu_memset" if "Memset" in name
                else "kernel")
            s = e.start_ns()
            device_ops.append((kind, name, s, s + e.duration_ns(), e.correlation_id()))
        elif act == "cuda_runtime" or (not act and name.startswith("cuda")):
            launches[e.correlation_id()] = e.start_ns()
        elif name.startswith("pb."):
            s = e.start_ns()
            if name == "pb.window":
                window = (s, s + e.duration_ns())
            else:
                ranges.append((name, s, s + e.duration_ns()))
    if window is None:
        raise RuntimeError("the profile holds no pb.window range")
    return Profile(window=window, transfers=transfers, device_ops=device_ops, ranges=ranges,
                   launches=launches)


def breakdown(p: Profile, top: int = 10) -> Dict:
    """The device operations that took most time, and the longest idle
    gaps of the device, each named by the innermost pb.* range that was
    open on the host when the gap began."""
    by_name: Dict[str, int] = {}
    for _, name, s, e, _ in p.device_ops:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = p.busy_intervals()
    lo, hi = p.window
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]

    def label(t):
        open_ = [(s, n) for n, s, e in p.ranges if s <= t <= e]
        return "host in " + (max(open_)[1][3:] if open_ else "no span")

    return {"device_ops": [[n[:200], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[label(s), (e - s) / 1e9] for s, e in gaps]}
