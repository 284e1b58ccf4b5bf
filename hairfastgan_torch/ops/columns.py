"""The hooks by which a model's one forward runs on either placement of its
parameters: a plain tree on one device, or a tree placed over a model axis
(parallel/mesh.shard_params_model_axis), which parallel/tensor.py runs
column-parallel. The ops and models call these; the rules that give a
placed tree its meaning live in parallel/tensor.py, which this module does
not import, so the ops and models stay below the parallel package.

  column_parallel  a model function fn(params, ...) that takes either tree
  by_columns       a function whose output channels are its weight's rows
  randn_rows       noise drawn inside a model, as the one-device call draws it
  Cols             a mesh position's slice of a tensor split over the model
                   axis, as a model reads it there
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

# .region and .pos of the SPMD region (parallel/tensor.py) this thread runs in
_CTX = threading.local()


def region():
    """The SPMD region this thread runs a mesh position of, or None."""
    return getattr(_CTX, "region", None)


class Placed:
    """A parameter tree placed over a model axis (parallel/mesh.ModelSharded):
    `spmd(fn, *args, **kwargs)` runs fn(tree, *args, **kwargs) on it."""

    def spmd(self, fn: Callable, *args, **kwargs):
        raise NotImplementedError


class Cols(Tensor):
    """This mesh position's slice of a tensor split over the model axis
    along `_split` (a negative dim), inside an SPMD region. Its shape reads
    as the whole tensor's; its data is slice j of n_model at model index j.
    `_weight` marks a parameter slice (one that may never move); `_whole`
    keeps the gathered tensor once an op needed it; `_src` (source, cast)
    marks a cast of another slice, whose whole is the cast of the source's.
    Outside a region it is the plain local slice."""

    _raw: Tensor
    _split: int
    _weight: bool
    _whole: Optional[Tensor]
    _src: Optional[Tuple["Cols", Callable]]

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        r = region()
        if r is None:
            return func(*tree_map(raw, args), **tree_map(raw, kwargs))
        return r.torch_function(func, args, kwargs)


def cols(t: Tensor, split: int, weight: bool = False) -> Cols:
    """`t`, a position's slice along `split`, as a Cols."""
    c = t.as_subclass(Cols)
    c._raw, c._split, c._weight, c._whole, c._src = t, split, weight, None, None
    return c


def raw(x):
    """A Cols's local slice; anything else as it is."""
    return x._raw if isinstance(x, Cols) else x


def tree_map(fn, tree):
    """fn over the leaves of nested tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def column_parallel(fn: Callable) -> Callable:
    """A model function fn(params, ...) that takes either placement: a
    plain tree runs fn as it is; a placed one runs it on the model axis."""
    @functools.wraps(fn)
    def call(params, *args, **kwargs):
        if isinstance(params, Placed):
            return params.spmd(fn, *args, **kwargs)
        return fn(params, *args, **kwargs)

    return call


def by_columns(fn: Callable) -> Callable:
    """fn(weight or {"w", "b"}, *args, **kwargs), whose output channels
    (dim 1) are the weight's output channels (dim 0), each from its own
    rows of the weight. With a split weight each position runs fn on its
    slice (the bias sliced with it) and whole inputs, and the output is its
    slice of the channels; with a replicated one and an input split, fn
    runs on the whole inputs."""
    @functools.wraps(fn)
    def call(p, *args, **kwargs):
        r = region()
        if r is None:
            return fn(p, *args, **kwargs)
        return r.by_columns(fn, p, args, kwargs)

    return call


def randn_rows(shape: Sequence[int], generator: torch.Generator, device) -> Tensor:
    """torch.randn(shape, generator=, device=); inside an SPMD region the
    whole batch (shape[0] rows on every data row) is drawn on the lead
    device, as the one-device call draws it, and each row takes its own."""
    r = region()
    if r is None:
        return torch.randn(tuple(shape), generator=generator, device=device)
    return r.randn_rows(tuple(shape), generator)
