"""Timing: whole-swap laps (BenchSession) and the program's spans.

Benchmark session: wall times of whole swaps, each ended by a device
synchronize that the caller makes (reference utils/time.py:9-36 prints
count/min/median/std to stderr).

Spans: `span(name, **attrs)` marks an interval of the program, as a context
manager (`with span("upload") as s:`, then `s.ms`) or as a decorator
(`@span("generator")`). A span reads its two clock times always; it is
*kept* only while a `recording()` context is open or torch's profiler runs,
and then records its name, a span id, its parent's id, its request id, its
thread, t0 and t1 and its attrs into a bounded buffer (`spans()`, `clear()`,
`dropped()`); while the profiler runs it is also the range `hf.<name>` of
the profile (a host range, not mirrored onto the device's timeline). Times
are `time.time_ns()`, the Unix-epoch clock that torch's
profiler stamps its events with, so kept spans, kernel launches and device
operations share one timeline.

A request is a root `request` span (`request(**attrs)` opens one unless one
is open on the thread already): it takes a fresh id, and the spans nested in
it on its thread carry that id. A span given `parent=` (a record of another
thread's span) joins that span's request.

The port's spans, by layer:
  API       request (entry, case, rows); upload (host arrays to device
            tensors), serve (the swap on the device), fetch (device to host,
            the wait for the result included); http.decode, http.queue,
            http.swap, http.encode (serve.py, which builds its Server-Timing
            header from them)
  Pipeline  embed, align, shape, blend
  Models    generator (start_layer, end_layer), e4e, fse, bisenet, sean,
            shape_adaptor, rotate, blending, post_process: one per model call,
            never nested in one another
  Kernels   dilate_erode (shape, itemsize, iterations)
"""

from __future__ import annotations

import collections
import contextlib
import functools
import inspect
import itertools
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

CAPACITY = 65536  # kept spans; the oldest are dropped beyond it


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


class Span:
    """One span's record: ids (None unless kept), clock times in ns, attrs."""

    __slots__ = ("name", "id", "parent", "request", "thread", "t0", "t1", "attrs")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs
        self.id = self.parent = self.request = self.thread = None
        self.t0 = self.t1 = 0

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) / 1e6


class _Recorder:
    def __init__(self, capacity: int):
        self.kept = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.recording = 0  # open recording() contexts
        self.lock = threading.Lock()
        self.local = threading.local()  # .stack: this thread's open kept spans
        self.ids = itertools.count(1)

    def stack(self) -> List[Span]:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_REC = _Recorder(CAPACITY)
_profiling = torch._C._autograd._profiler_enabled
# a profiler range of the cpu_op kind: unlike record_function's user
# annotations, it is not mirrored onto the device's timeline, where a
# trace reader would take it for a device operation
_profile_range = torch._C._profiler._RecordFunctionFast


class span:
    """A named interval of the program; see the module docstring. As a
    decorator, `of_call(arguments)` (the call's arguments by name, defaults
    applied) gives further attrs of each kept call."""

    __slots__ = ("name", "attrs", "parent", "of_call", "_rec", "_range", "_stack")

    def __init__(self, name: str, *, parent: Optional[Span] = None,
                 of_call: Optional[Callable[[Dict], Dict]] = None, **attrs):
        self.name, self.attrs, self.parent, self.of_call = name, attrs, parent, of_call

    def __enter__(self) -> Span:
        rec = self._rec = Span(self.name, dict(self.attrs))
        self._range = self._stack = None
        profiling = _profiling()
        if _REC.recording or profiling:
            stack = self._stack = _REC.stack()
            up = self.parent if self.parent is not None else (stack[-1] if stack else None)
            rec.id = next(_REC.ids)
            rec.thread = threading.get_ident()
            if up is not None:
                rec.parent, rec.request = up.id, up.request
            if self.name == "request":
                rec.request = rec.id
            stack.append(rec)
            rec.t0 = time.time_ns()
            if profiling:
                self._range = _profile_range("hf." + self.name)
                self._range.__enter__()
        else:
            rec.t0 = time.time_ns()
        return rec

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
        rec = self._rec
        rec.t1 = time.time_ns()
        if self._stack is not None:
            if self._stack and self._stack[-1] is rec:
                self._stack.pop()
            else:  # closed out of order (a generator dropped mid-request)
                self._stack.remove(rec)
            with _REC.lock:
                if len(_REC.kept) == _REC.kept.maxlen:
                    _REC.dropped += 1
                _REC.kept.append(rec)

    def __call__(self, fn: Callable) -> Callable:
        name, attrs, of_call = self.name, self.attrs, self.of_call
        sig = inspect.signature(fn) if of_call is not None else None

        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, **attrs) as rec:
                if sig is not None and rec.id is not None:
                    bound = sig.bind(*args, **kwargs)
                    bound.apply_defaults()
                    rec.attrs.update(of_call(bound.arguments))
                return fn(*args, **kwargs)

        return call


def in_request() -> bool:
    """Whether a kept span of a request is open on this thread."""
    stack = _REC.stack()
    return bool(stack) and stack[-1].request is not None


def request(**attrs):
    """A `request` span, or nothing where this thread is in a request."""
    return contextlib.nullcontext() if in_request() else span("request", **attrs)


def annotate(**attrs) -> None:
    """Add attrs to the innermost kept `request` span open on this thread."""
    for rec in reversed(_REC.stack()):
        if rec.name == "request":
            rec.attrs.update(attrs)
            return


@contextlib.contextmanager
def recording():
    """Keep every span opened while this is open (on any thread)."""
    with _REC.lock:
        _REC.recording += 1
    try:
        yield
    finally:
        with _REC.lock:
            _REC.recording -= 1


def spans() -> List[Span]:
    """The kept spans, in the order they closed."""
    with _REC.lock:
        return list(_REC.kept)


def dropped() -> int:
    """Kept spans dropped from the full buffer since the last clear()."""
    return _REC.dropped


def clear() -> None:
    with _REC.lock:
        _REC.kept.clear()
        _REC.dropped = 0
