"""The model axis: any model of the zoo run column-parallel on the
parameters that `mesh.shard_params_model_axis` placed (the port's
counterpart of jit with XLA's SPMD partitioner on the shardings of the
JAX package's shard_params_model_axis).

SPMD. A model call on a `ModelSharded` tree runs the model's one forward
once per mesh position, each on a worker thread of its own, on the tree
that the position holds: slice j of every split leaf at model index j, the
replicated leaves whole. The batch goes over `data`. A split leaf is seen
there as an `ops.columns.Cols` (`shard_params_model_axis` places it so):
the position's slice of a tensor split over the model axis, whose shape
reads as the whole tensor's. An op on a `Cols` computes its own slice
where it can:

  linear, conv2d  a weight split on its output features (port dim 0) gives
                  the output's slice from the whole input; the rank-1 bias
                  is replicated and sliced where it is used
  matmul          `y @ w` with w split on its last dim (CLIP's `proj`)
  elementwise     the same slice of each operand: a replicated operand is
                  sliced where it is used (bias, BatchNorm scale, the
                  dim-1 leaves latent_avg, pos_emb, mean_codes), so the
                  per-channel tails after a split conv (BatchNorm, PReLU,
                  bias, SE gating, activations) run on the slice
  prelu           its per-channel weight sliced
  mean, sum       over dims other than the split one
  cat, stack      along other dims
  indexing        of a split weight on other dims (`latent_avg[None]`)
  expand          (the generator's constant input to the batch)
  styled_conv2d,  (`by_columns`) the whole function on the weight's slice
  region conv     and the output channels it gives

Any other op reads the whole tensor: the row's slices are all-gathered on
every position of the row (`all_gather`, once per tensor: the whole is kept
with the slice) and the op runs on the whole, as does an elementwise op
whose split operands are all gathered already; a cast of a slice is
gathered as the cast of its source's whole. A split weight never moves:
an op that would gather one raises. Each all-gather is one collective of
the mesh, every position of it reaching the same gather in the same order
(they run the same code, taking turns: one runs until its next
collective, then the next); it is one call of `mesh.move`, counted under
`all_gather` in `mesh.MOVES`.

A split over cin (row-parallel) would need partial sums reduced across
devices; the JAX placement splits cout, and so does this. A layer whose
weight is replicated runs on every position of the row, as the SPMD
partitioner runs replicated work, and gives the same whole output there.

Entry and exit: a model function decorated with
`ops.columns.column_parallel` takes either tree. Given a `ModelSharded` one
it takes its batched tensors from the lead device in one `scatter` (one
`broadcast` on a mesh with one data row) and returns the results there
from each row's first position, one `gather` for each tensor returned
(none on one data row). Noise drawn inside a model
(`ops.columns.randn_rows`) is drawn on the lead device for the whole
batch, as the one-device call draws it, and scattered to the rows.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hairfastgan_torch.ops.columns import _CTX, Cols
from hairfastgan_torch.ops.columns import cols as _cols
from hairfastgan_torch.ops.columns import raw as _raw
from hairfastgan_torch.ops.columns import tree_map as _map
from hairfastgan_torch.parallel.mesh import ModelSharded, gather, move

Tensor = torch.Tensor
Grid = List[List]  # [i][j]: a value for each mesh position (data row i, model index j)


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# -- the SPMD region ----------------------------------------------------------


class _Region:
    """The threads of one SPMD call, one per mesh position, and their
    collectives. The positions take turns in mesh order, each running until
    its next collective (or its end), so one thread runs at a time and
    switches happen only at collectives; the last position to reach a
    collective runs it for all (one `mesh.move`)."""

    def __init__(self, tp: ModelSharded):
        self.tp = tp
        self.n_data, self.n_model = tp.trees.shape
        self.n = self.n_data * self.n_model
        self.lock = threading.Lock()
        self.wake = [threading.Condition(self.lock) for _ in range(self.n)]  # one per position
        self.turn, self.round, self.failed = 0, 0, False
        self.parts, self.ops, self.results = {}, {}, None

    def _wait(self, k: int, ready) -> None:
        """Position k waits (holding the lock) until ready() or a failure."""
        self.wake[k].wait_for(lambda: ready() or self.failed)
        if self.failed:
            raise _Aborted()

    def _hand_on(self, to: int) -> None:
        self.turn = to
        if to < self.n:
            self.wake[to].notify()

    def start(self, k: int) -> None:
        with self.lock:
            self._wait(k, lambda: self.turn == k)

    def finish(self, k: int) -> None:
        with self.lock:
            if self.parts:
                raise RuntimeError(f"mesh position {k} ended while others wait in a collective")
            self._hand_on(k + 1)

    def fail(self) -> None:
        with self.lock:
            self.failed = True
            for w in self.wake:
                w.notify()

    def collective(self, part, *op):
        """op[0](grid of every position's part, *op[1:]) -> grid; this
        position's entry."""
        pos = _CTX.pos
        k = pos[0] * self.n_model + pos[1]
        with self.lock:
            self.parts[pos], self.ops[pos] = part, op
            rnd = self.round
            if len(self.parts) == self.n:
                ops = set(self.ops.values())
                if len(ops) != 1:
                    raise RuntimeError(f"mesh positions diverged: {ops}")
                grid = [[self.parts[i, j] for j in range(self.n_model)]
                        for i in range(self.n_data)]
                self.results = op[0](grid, *op[1:])
                self.parts, self.ops = {}, {}
                self.round = rnd + 1
                self._hand_on(0)
            else:
                self._hand_on(k + 1)
            self._wait(k, lambda: self.round > rnd and self.turn == k)
            return self.results[pos[0]][pos[1]]

    def torch_function(self, func, args, kwargs):
        """An op with a Cols operand at this position: its rule, else the
        op on the whole operands (module docstring)."""
        rule = _RULES.get(func)
        if rule is not None:
            out = rule(self, func, args, kwargs)
            if out is not NotImplemented:
                return out
        if func in _ELEMENTWISE:
            return _elementwise(self, func, args, kwargs)
        name = getattr(func, "__name__", "")
        if name.endswith("_") and not name.startswith("__"):
            raise NotImplementedError(f"in-place {name} on a model-axis slice")
        return func(*_map(self.whole, args), **_map(self.whole, kwargs))

    def by_columns(self, fn: Callable, p, args, kwargs):
        """ops.columns.by_columns at this position."""
        w = p["w"] if isinstance(p, dict) else p
        if not any(isinstance(a, Cols) for a in (w, *args)):
            return fn(p, *args, **kwargs)
        args, kwargs = _map(self.whole, args), _map(self.whole, kwargs)
        if not isinstance(w, Cols):
            return fn(p, *args, **kwargs)
        if isinstance(p, dict):
            p = dict(p, w=w._raw)
            if p.get("b") is not None:
                p["b"] = self.local(p["b"], -1)
        else:
            p = w._raw
        y = fn(p, *args, **kwargs)
        return _cols(y, 1 - y.ndim)

    def randn_rows(self, shape: Tuple[int, ...], generator: torch.Generator) -> Tensor:
        """ops.columns.randn_rows at this position."""
        return self.collective(None, _draw_rows, self.tp, shape, generator)

    def whole(self, x):
        """`x` whole: a Cols activation all-gathered (once), anything else
        as it is."""
        if not isinstance(x, Cols):
            return x
        if x._whole is None:
            if x._weight:
                raise RuntimeError(f"a split weight {tuple(x.shape)} would move: an op that "
                                   "reads it whole is not column-parallel")
            if x._src is not None:
                src, cast = x._src
                x._whole = cast(self.whole(src))
            else:
                x._whole = self.collective(x._raw, self._all_gather, x._split)
        return x._whole

    def _all_gather(self, grid, dim):
        return all_gather(self.tp, grid, dim)

    def local(self, t: Tensor, split: int) -> Tensor:
        """This position's slice of a replicated `t` that broadcasts against
        a tensor split along `split`: t itself where its dim there is 1 or
        missing."""
        if t.ndim < -split or t.shape[split] == 1:
            return t
        n, j = self.n_model, _CTX.pos[1]
        size = t.shape[split] // n
        return t.narrow(split, j * size, size)


def all_gather(tp: ModelSharded, parts: Grid, dim: int) -> Grid:
    """Each row's model-axis slices concatenated along `dim` on every
    device of the row (one all_gather)."""
    grid = tp.plan.grid
    n_data, n_model = grid.shape
    src = [parts[i][k] for i in range(n_data) for _ in range(n_model) for k in range(n_model)]
    dst = [grid[i, j] for i in range(n_data) for j in range(n_model) for _ in range(n_model)]
    moved = iter(move(src, dst, "all_gather"))
    return [[torch.cat([next(moved) for _ in range(n_model)], dim=dim) for _ in range(n_model)]
            for _ in range(n_data)]


class _Workers:
    """The threads that run the mesh positions, kept across calls: cuDNN
    and cuBLAS keep their handles and plans per thread, so a thread made
    for each call would pay their set-up on every model call. One region
    runs at a time."""

    def __init__(self):
        self.queues: List = []
        self.lock = threading.Lock()

    def _loop(self, q):
        while True:
            job, done = q.get()
            try:
                job()
            finally:
                done.set()

    def run(self, jobs: Sequence[Callable]) -> None:
        import queue

        with self.lock:
            while len(self.queues) < len(jobs):
                self.queues.append(queue.SimpleQueue())
                threading.Thread(target=self._loop, args=(self.queues[-1],), daemon=True,
                                 name=f"model-axis-{len(self.queues) - 1}").start()
            events = [threading.Event() for _ in jobs]
            for q, job, done in zip(self.queues, jobs, events):
                q.put((job, done))
            for done in events:
                done.wait()


_WORKERS = _Workers()


class _Aborted(Exception):
    """Another position of the region failed."""


def _run(tp: ModelSharded, fn: Callable, args: Grid, kwargs: Grid) -> Grid:
    """fn(tree at (i, j), *args[i][j], **kwargs[i][j]) at every mesh
    position, each on its worker thread; the results whole."""
    region = _Region(tp)
    n_data, n_model = region.n_data, region.n_model
    out = [[None] * n_model for _ in range(n_data)]
    errors = []
    modes = torch.is_inference_mode_enabled(), torch.is_grad_enabled()

    def work(i, j):
        k = i * n_model + j
        _CTX.region, _CTX.pos = region, (i, j)
        try:
            region.start(k)
            with torch.inference_mode(modes[0]), torch.set_grad_enabled(modes[1]):
                res = fn(tp.trees[i, j], *args[i][j], **kwargs[i][j])
                out[i][j] = _map(lambda v: _raw(region.whole(v)), res)
            region.finish(k)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors.append(e)
            region.fail()
        finally:
            _CTX.region = None

    _WORKERS.run([functools.partial(work, i, j) for i in range(n_data) for j in range(n_model)])
    if errors:
        real = [e for e in errors if not isinstance(e, _Aborted)]
        raise (real or errors)[0]
    return out


def _scatter_rows(tp: ModelSharded, xs: Sequence[Optional[Tensor]]) -> List[Optional[Grid]]:
    """Batched tensors on the lead device -> for each, row i's shard on
    every device of row i (one scatter; one broadcast on one data row)."""
    grid = tp.plan.grid
    n_data, n_model = grid.shape
    live = [x for x in xs if x is not None]
    for x in live:
        if x.shape[0] % n_data:
            raise ValueError(f"batch {x.shape[0]} is not divisible by the {n_data} data rows")
    pos = [(i, j) for i in range(n_data) for j in range(n_model)]
    moved = iter(move([x.chunk(n_data)[i] for x in live for i, _ in pos],
                      [grid[i, j] for _ in live for i, j in pos],
                      "scatter" if n_data > 1 else "broadcast") if live else ())
    out = []
    for x in xs:
        if x is None:
            out.append(None)
            continue
        cells = [next(moved) for _ in pos]
        out.append([cells[i * n_model:(i + 1) * n_model] for i in range(n_data)])
    return out


def _gather_rows(tp: ModelSharded, g: Grid) -> Tensor:
    """Each row's (whole) result from its first device, concatenated on
    the lead device (one gather; none on one data row)."""
    if len(g) == 1:
        return g[0][0]
    return gather([row[0] for row in g], tp.plan.lead)


def spmd(tp: ModelSharded, fn: Callable, *args, **kwargs):
    """fn(params, *args, **kwargs) on the model axis: every tensor in args
    and kwargs (nested in tuples, lists and dicts) is batched on dim 0 and
    comes from the lead device; the results (a tensor or nested tuples,
    lists and dicts of tensors) go back there."""
    if not isinstance(tp, ModelSharded):
        raise TypeError("the model axis takes the parameters placed by "
                        "parallel.mesh.shard_params_model_axis on a (data, model) mesh")
    flat = list({id(x): x for x in _leaves((args, kwargs)) if isinstance(x, Tensor)}.values())
    cells = dict(zip(map(id, flat), _scatter_rows(tp, flat)))
    n_data, n_model = tp.trees.shape

    def at(i, j):
        return _map(lambda v: cells[id(v)][i][j] if isinstance(v, Tensor) else v, (args, kwargs))

    both = [[at(i, j) for j in range(n_model)] for i in range(n_data)]
    out = _run(tp, fn, [[c[0] for c in row] for row in both], [[c[1] for c in row] for row in both])
    rows = [_leaves(out[i][0]) for i in range(n_data)]
    k = iter(range(len(rows[0])))

    def back(v):
        i = next(k)
        return _gather_rows(tp, [[r[i]] for r in rows]) if isinstance(v, Tensor) else v

    return _map(back, out[0][0])


def _draw_rows(grid, tp, shape, generator):
    n_data = len(grid)
    z = torch.randn((shape[0] * n_data,) + shape[1:], generator=generator, device=tp.plan.lead)
    (rows,) = _scatter_rows(tp, [z])
    return rows


# -- the rules: ops that keep a slice -----------------------------------------


def _elementwise(region, func, args, kwargs):
    """An elementwise op (broadcasting; its operands are flat): the same
    slice of every operand. Operands split along other dims are gathered
    first; when every split operand is already gathered, the op runs
    whole."""
    vals = (*args, *kwargs.values())
    cols = [a for a in vals if isinstance(a, Cols)]
    split = cols[0]._split
    if any(c._split != split for c in cols) or all(c._whole is not None for c in cols):
        return func(*map(region.whole, args), **{k: region.whole(v) for k, v in kwargs.items()})
    weight = all(isinstance(a, Cols) and a._weight for a in vals if isinstance(a, Tensor))

    def local(a):
        if isinstance(a, Cols):
            return a._raw
        return region.local(a, split) if isinstance(a, Tensor) else a

    out = func(*map(local, args), **{k: local(v) for k, v in kwargs.items()})
    if len(cols) == 1 and out is cols[0]._raw:  # .to / .float to its own dtype
        return cols[0]
    res = _cols(out, split, weight)
    if func in _CASTS and len(cols) == 1 and args[0] is cols[0]:
        res._src = (cols[0], lambda whole: func(whole, *args[1:], **kwargs))
    return res


def _meta(region, func, args, kwargs):
    """shape, size, dim, numel read the whole tensor's; dtype, device and
    the rest the slice's."""
    x = args[0]
    whole = list(x._raw.shape)
    whole[x._split] *= region.n_model
    name = getattr(func, "__name__", "")
    if func == _SHAPE:
        return torch.Size(whole)
    if name == "size":
        return torch.Size(whole) if len(args) == 1 and "dim" not in kwargs else \
            whole[args[1] if len(args) > 1 else kwargs["dim"]]
    if name == "numel":
        return int(np.prod(whole))
    return func(*_map(_raw, args), **_map(_raw, kwargs))


def _pos(split: int, ndim: int) -> int:
    return split + ndim


def _reduce(region, func, args, kwargs):
    """mean / sum over dims other than the split one keep the slice."""
    x = args[0]
    dims = args[1] if len(args) > 1 else kwargs.get("dim")
    if not isinstance(x, Cols) or dims is None:
        return NotImplemented
    ndim = x._raw.ndim
    dims = [d % ndim for d in ((dims,) if isinstance(dims, int) else dims)]
    p = _pos(x._split, ndim)
    if p in dims:
        return NotImplemented
    keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    out = func(*_map(_raw, args), **_map(_raw, kwargs))
    new = p if keep else p - sum(d < p for d in dims)
    return _cols(out, new - out.ndim, x._weight)


def _concat(region, func, args, kwargs):
    """cat / stack along another dim than the split one."""
    xs = args[0]
    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    cols = [x for x in xs if isinstance(x, Cols)]
    split = cols[0]._split
    if len(cols) != len(xs) or any(c._split != split for c in cols):
        return NotImplemented
    ndim = cols[0]._raw.ndim
    out_ndim = ndim + (func is torch.stack)
    p = _pos(split, ndim)
    d = dim % out_ndim
    if func is torch.stack:
        new = p + 1 if d <= p else p
    elif d == p:
        return NotImplemented
    else:
        new = p
    out = func([c._raw for c in cols], *args[2:], **{k: v for k, v in kwargs.items()
                                                      if k != "dim"}, dim=dim)
    return _cols(out, new - out_ndim, all(c._weight for c in cols))


def _getitem(region, func, args, kwargs):
    """A split weight indexed on other dims (latent_avg[None]): its slice.
    An activation is indexed whole (a gather, kept for its other reads)."""
    x, idx = args
    if not x._weight:
        return NotImplemented
    idx = idx if isinstance(idx, tuple) else (idx,)
    ndim = x._raw.ndim
    p = _pos(x._split, ndim)
    d_in = d_out = 0
    new = None
    for e in idx:
        if e is None:
            d_out += 1
        elif isinstance(e, int) and d_in != p:
            d_in += 1
        elif isinstance(e, slice) and (d_in != p or e == slice(None)):
            new = d_out if d_in == p else new
            d_in, d_out = d_in + 1, d_out + 1
        else:
            raise RuntimeError(f"a split weight indexed by {idx} along its split dim")
    if new is None:
        new = d_out + (p - d_in)
    out = x._raw[idx]
    return _cols(out, new - out.ndim, True)


def _expand(region, func, args, kwargs):
    """expand (the generator's constant input to the batch): the slice
    expanded; the result is an activation."""
    x = args[0]
    sizes = list(args[1] if len(args) == 2 and isinstance(args[1], (tuple, list)) else args[1:])
    p = len(sizes) + x._split
    if sizes[p] not in (-1, x.shape[x._split]):
        return NotImplemented
    sizes[p] = -1
    return _cols(x._raw.expand(*sizes), x._split)


def _linear(region, func, args, kwargs):
    """F.linear(x, w, b) with w split on its output features."""
    x, w, *rest = args
    b = rest[0] if rest else kwargs.get("bias")
    if not isinstance(w, Cols):
        return NotImplemented
    if w._split != -2:
        raise RuntimeError("a linear splits its output features (port dim 0)")
    b = None if b is None else region.local(_raw(b), -1)
    return _cols(F.linear(region.whole(x), w._raw, b), -1)


def _conv2d(region, func, args, kwargs):
    """F.conv2d(x, w, b, stride, padding, dilation, groups=1) with w split
    on its output channels."""
    x, w, *rest = args
    if not isinstance(w, Cols):
        return NotImplemented
    groups = rest[4] if len(rest) > 4 else kwargs.get("groups", 1)
    if w._split != -4 or groups != 1:
        raise RuntimeError("a conv kernel splits its output channels (dim 0), ungrouped")
    b = rest[0] if rest else kwargs.get("bias")
    b = None if b is None else region.local(_raw(b), -1)
    kw = {k: v for k, v in kwargs.items() if k != "bias"}
    return _cols(F.conv2d(region.whole(x), w._raw, b, *rest[1:], **kw), -3)


def _matmul(region, func, args, kwargs):
    """y @ w with w split on its last dim (CLIP's proj)."""
    a, w = args
    if not (isinstance(w, Cols) and w._weight and w._split == -1):
        return NotImplemented
    return _cols(torch.matmul(region.whole(a), w._raw), -1)


def _prelu(region, func, args, kwargs):
    """PReLU, its weight per channel of dim 1: the slice's channels."""
    x, w = args
    if not isinstance(x, Cols) or isinstance(w, Cols) or _pos(x._split, x._raw.ndim) != 1:
        return NotImplemented
    return _cols(func(x._raw, region.local(w, -1)), x._split)


_T = torch.Tensor
_SHAPE = _T.shape.__get__
_ELEMENTWISE = {
    f for name in ("add", "sub", "rsub", "mul", "div", "true_divide", "neg", "pow", "square",
                   "sqrt", "rsqrt", "exp", "sigmoid", "tanh", "relu", "abs", "clamp", "where",
                   "maximum", "minimum", "__add__", "__radd__", "__sub__", "__rsub__",
                   "__mul__", "__rmul__", "__truediv__", "__rtruediv__", "__neg__", "__pow__",
                   "to", "float", "type_as", "contiguous")
    for f in (getattr(_T, name, None), getattr(torch, name, None)) if f is not None
} | {F.leaky_relu, F.relu}
_CASTS = {_T.to, _T.float, _T.type_as, _T.contiguous}  # whole(cast) = cast(whole(source))
_RULES = {f: _meta for f in (_SHAPE, _T.size, _T.dim, _T.ndim.__get__, _T.numel,
                             _T.dtype.__get__, _T.device.__get__, _T.is_floating_point)}
_RULES.update({_T.mean: _reduce, torch.mean: _reduce, _T.sum: _reduce, torch.sum: _reduce,
               torch.cat: _concat, torch.stack: _concat, _T.__getitem__: _getitem,
               _T.expand: _expand, F.linear: _linear, F.conv2d: _conv2d,
               torch.matmul: _matmul, _T.matmul: _matmul, _T.__matmul__: _matmul, F.prelu: _prelu})


# -- the generator's entry points (the API of the column-parallel generator) --


def _check(tp) -> Tuple[int, int]:
    if not isinstance(tp, ModelSharded):
        raise TypeError("the column-parallel generator takes the parameters placed by "
                        "parallel.mesh.shard_params_model_axis on a (data, model) mesh")
    return tp.trees.shape


def _at(tree, path: Sequence):
    for k in path:
        tree = tree[k]
    return tree


def modulated_conv2d(tp: ModelSharded, path: Sequence, xs: Grid, styles: Grid, *,
                     demodulate: bool = True, up: bool = False,
                     fuse_blur: bool = False) -> Grid:
    """ops/modconv.modulated_conv2d of the layer at `path` (its "conv"
    holds "w" and "modulation") on each position's whole input, with the
    column split; gathered output per position."""
    from hairfastgan_torch.ops import modconv

    _check(tp)
    n_data, n_model = tp.trees.shape
    kw = [[{} for _ in range(n_model)] for _ in range(n_data)]
    args = [[(xs[i][j], styles[i][j]) for j in range(n_model)] for i in range(n_data)]
    return _run(tp, lambda p, x, s: modconv.modulated_conv2d(
        _at(p, path)["conv"], x, s, demodulate=demodulate, up=up, fuse_blur=fuse_blur),
        args, kw)


def mapping(tp: ModelSharded, z: Tensor, cfg) -> Tensor:
    """stylegan2.mapping: z [B, style_dim] on the lead device -> w there."""
    from hairfastgan_torch.models import stylegan2

    _check(tp)
    return stylegan2.mapping(tp, z, cfg)


def _noise_nchw(tp: ModelSharded, latent: Tensor, noise, generator, cfg):
    """`noise` (NHWC, Nones kept) as NCHW, or drawn by `generator` on the
    lead device as the one-device call draws it."""
    from hairfastgan_torch.models import stylegan2

    _check(tp)
    if noise is None:
        return stylegan2.make_noise(generator, cfg, latent.shape[0], latent.device)
    return [None if n is None else n.permute(0, 3, 1, 2) for n in noise]


def synthesis_nchw(tp: ModelSharded, latent: Tensor, *, noise: Sequence[Optional[Tensor]],
                   start_layer: int = 0, end_layer: int = 8,
                   layer_in: Optional[Tensor] = None, skip: Optional[Tensor] = None, cfg,
                   dtype: torch.dtype) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """stylegan2.synthesis_nchw on the model axis: the same schedule over the
    same layers, every input and output on the lead device."""
    from hairfastgan_torch.models import stylegan2

    _check(tp)
    return stylegan2.synthesis_nchw(tp, latent, noise=noise, start_layer=start_layer,
                                    end_layer=end_layer, layer_in=layer_in, skip=skip,
                                    cfg=cfg, dtype=dtype)


def synthesis(tp: ModelSharded, latent: Tensor, *,
              noise: Optional[Sequence[Optional[Tensor]]] = None,
              generator: Optional[torch.Generator] = None,
              start_layer: int = 0, end_layer: int = 8,
              layer_in: Optional[Tensor] = None, skip: Optional[Tensor] = None, cfg,
              dtype: torch.dtype) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """stylegan2.synthesis (JAX layouts: NHWC layer_in, skip, noise and
    results) on the model axis; `generator` draws the noise on the lead
    device, as the one-device call draws it."""
    noise = _noise_nchw(tp, latent, noise, generator, cfg)
    nchw = [None if t is None else t.permute(0, 3, 1, 2) for t in (layer_in, skip)]
    out, sk = synthesis_nchw(tp, latent, noise=noise, start_layer=start_layer,
                             end_layer=end_layer, layer_in=nchw[0], skip=nchw[1], cfg=cfg,
                             dtype=dtype)
    return (None if out is None else out.permute(0, 2, 3, 1),
            None if sk is None else sk.permute(0, 2, 3, 1))


def generate(tp: ModelSharded, latent: Tensor, *,
             noise: Optional[Sequence[Optional[Tensor]]] = None,
             generator: Optional[torch.Generator] = None, cfg,
             dtype: torch.dtype = torch.float32) -> Tensor:
    """stylegan2.generate on the model axis: the full 0..8 render, NHWC RGB
    (only the RGB comes back to the lead device)."""
    from hairfastgan_torch.models import stylegan2

    noise = _noise_nchw(tp, latent, noise, generator, cfg)
    return spmd(tp, lambda p, lat, nz: stylegan2.synthesis_nchw(
        p, lat, noise=nz, cfg=cfg, dtype=dtype)[1], latent, noise).permute(0, 2, 3, 1)
