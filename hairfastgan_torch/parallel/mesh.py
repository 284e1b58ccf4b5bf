"""Device meshes and data parallelism on PyTorch (counterpart of
hairfastgan_tpu/parallel/mesh.py).

The JAX package is single-controller: one process drives every device of
`jax.devices()` through a `Mesh` with a `data` axis (triples and training
samples are independent) and an optional `model` axis. The port keeps that
shape: a `MeshPlan` is an array of `torch.device`s driven from one process,
and shards are issued in a loop from the one host thread (CUDA launches are
asynchronous, so the devices overlap as far as host enqueue allows). A mesh
may list one device more than once ([cuda:0] * n, [cpu] * n): every line of
the sharding, gathering and gradient-reduction code then runs on that one
device, which checks the math but not the speed.

Every tensor that crosses between devices goes through `move`, which copies
with `Tensor.to(device, non_blocking=True)` (a peer copy between two cards,
a no-op on a repeated device) and counts the collective by kind in `MOVES`:

  scatter    a batch split along dim 0 over the data devices (and the
             minibatch-stddev statistic sent back to its shards)
  gather     per-shard tensors concatenated on the lead device
  broadcast  a tree copied to each distinct device; for leaves that require
             grad the copy is differentiable, so the replicas' gradients
             sum back into the master leaves on the backward pass
  reduce     per-shard losses (and scalar aux values) summed, each weighted
             by its share of the batch, on the lead device
  all_gather the model axis' slices of an activation concatenated on every
             device of that axis (parallel/tensor.py's column-parallel
             layers: their features and their styles)

These counts stand in for the JAX tests' HLO collective counts
(tests/test_mesh_equivalence.py): a data-parallel swap scatters its inputs
and gathers its rows and does nothing else. One count is one call of
`move`, whatever the number of shards.

The model axis (`shard_params_model_axis`) places the JAX package's
tensor-parallel split: the output features of the wide linears and the
output channels of the wide conv kernels, one slice per model-axis device.
`MeshPlan.spatial()` with `place` bands the H axis of an NHWC map.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from hairfastgan_torch.ops.columns import Cols, Placed, cols, raw
from hairfastgan_torch.params.bridge import map_tree, port_perm

Tensor = torch.Tensor

KINDS = ("scatter", "gather", "broadcast", "reduce", "all_gather")
MOVES: collections.Counter = collections.Counter()  # kind -> calls of `move`


def local_devices(device) -> List[torch.device]:
    """The devices a mesh on `device`'s kind may use (counterpart of
    `jax.devices()`): every visible CUDA device for cuda, [cpu] for cpu."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def move(xs: Sequence[Tensor], to, kind: str) -> List[Tensor]:
    """The one cross-device copy: xs[i] -> to[i] (or every x -> `to` when it
    is one device), counted once under `kind`. Differentiable, as
    Tensor.to is."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    MOVES[kind] += 1
    devs = [to] * len(xs) if isinstance(to, (str, torch.device)) else list(to)
    if len(devs) != len(xs):
        raise ValueError(f"{len(xs)} tensors for {len(devs)} devices")
    return [x.to(d, non_blocking=True) for x, d in zip(xs, devs)]


@dataclasses.dataclass(frozen=True, eq=False)
class MeshPlan:
    """An array of torch.devices of shape (n_data,) or (n_data, n_model),
    with the JAX package's axis names."""

    devices: np.ndarray

    @property
    def axis_names(self):
        return ("data", "model")[: self.devices.ndim]

    @property
    def data_axis(self) -> str:
        return "data"

    @property
    def model_axis(self) -> Optional[str]:
        return "model" if self.devices.ndim == 2 else None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along `axis` through the lead device."""
        if self.devices.ndim == 1:
            return list(self.devices)
        return list(self.devices[:, 0] if axis == "data" else self.devices[0])

    @property
    def data_devices(self) -> List[torch.device]:
        return self.axis_devices("data")

    @property
    def lead(self) -> torch.device:
        """Where stages that are not sharded run and results are gathered."""
        return self.devices.flat[0]

    @property
    def distinct(self) -> List[torch.device]:
        """Each device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    @property
    def grid(self) -> np.ndarray:
        """The devices as a (n_data, n_model) array (n_model 1 on a 1-D mesh)."""
        return self.devices.reshape(self.devices.shape[0], -1)

    def spatial(self) -> "Placement":
        """The H axis (dim 1) of NHWC maps split over the model axis, or over
        `data` on a 1-D mesh, replicated over the other axis (the JAX
        package's P(None, axis, None, None)); `place` applies it."""
        return Placement(self.model_axis or self.data_axis, 1)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A tensor split into equal slices along `dim` over the mesh axis
    `axis`: the device at position (i, j) holds slice i for `data` and
    slice j for `model` (the counterpart of a NamedSharding)."""

    axis: str
    dim: int


def place(plan: MeshPlan, x: Tensor, placement: Placement) -> List[Tensor]:
    """`x` split as `placement` says, one slice per mesh position, in mesh
    order (row-major over (data, model)), in one scatter."""
    grid = plan.grid
    n = plan.shape[placement.axis]
    if x.shape[placement.dim] % n:
        raise ValueError(f"dim {placement.dim} of {tuple(x.shape)} is not divisible by the "
                         f"{n} devices of {placement.axis!r}")
    parts = x.chunk(n, dim=placement.dim)
    pos = np.ndindex(*grid.shape)
    idx = [i if placement.axis == "data" else j for i, j in pos]
    return move([parts[k] for k in idx], list(grid.flat), "scatter")


def _device_array(devs, shape) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(shape)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[torch.device]] = None) -> MeshPlan:
    """A 1-D data mesh, or a 2-D (data, model) mesh, over the first
    n_data * n_model of `devices` (default: local_devices of cuda)."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else local_devices("cuda"))]
    if n_data is None:
        n_data = len(devs) // n_model
    devs = devs[: n_data * n_model]
    if len(devs) != n_data * n_model or not devs:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} devices, "
                         f"got {len(devs)}")
    shape = (n_data, n_model) if n_model > 1 else (n_data,)
    return MeshPlan(_device_array(devs, shape))


def data_mesh_for_batch(batch_size: int,
                        devices: Optional[Sequence[torch.device]] = None) -> MeshPlan:
    """1-D data mesh sized to the LARGEST divisor of `batch_size` that fits
    the device count (shard_batch needs dim-0 divisibility; make_mesh slices
    devs[:n_data], so the divisor need not divide the device count itself).

    gcd(batch, n_devices) silently over-shrinks: batch 6 on 8 chips would
    train on 2 devices and a prime batch on 1. Here batch 6 on 8 chips gets
    all 6; a warning prints whenever devices are left idle so real-hardware
    runs surface the footgun instead of silently underusing the mesh.
    """
    devs = list(devices if devices is not None else local_devices("cuda"))
    n_data = max(d for d in range(1, min(batch_size, len(devs)) + 1)
                 if batch_size % d == 0)
    if n_data < len(devs):
        print(f"[mesh] data mesh uses {n_data}/{len(devs)} devices "
              f"(largest divisor of batch_size={batch_size}); pick a batch "
              f"divisible by the device count to use the full mesh",
              flush=True)
    return make_mesh(n_data=n_data, devices=devs)


class Replicas(dict):
    """device -> a copy of one tree on that device (from `replicate`)."""


def replicate(plan: MeshPlan, tree) -> Replicas:
    """One copy of `tree` per distinct device of the mesh (one broadcast).
    Leaves already on a device are that device's copy (no copy on a
    repeated device); leaves that require grad are copied differentiably,
    so the gradients of every replica reach the master leaf. A Replicas
    passes as it is."""
    if isinstance(tree, Replicas):
        return tree
    leaves: List[Tensor] = []
    map_tree(tree, lambda _, t: leaves.append(t) if isinstance(t, Tensor) else None)
    devs = plan.distinct
    moved = iter(move([t for _ in devs for t in leaves], [d for d in devs for _ in leaves],
                      "broadcast"))
    return Replicas({d: map_tree(tree, lambda _, t: next(moved) if isinstance(t, Tensor) else t)
                     for d in devs})


def on(tree, device):
    """The copy of `tree` for `device`: its entry when `tree` is Replicas,
    else the tree itself."""
    return tree[device] if isinstance(tree, Replicas) else tree


def shard_batch(plan: MeshPlan, x: Tensor) -> List[Tensor]:
    """Split dim 0 of `x` into one equal shard per data-axis device (one
    scatter)."""
    devs = plan.data_devices
    if x.shape[0] % len(devs):
        raise ValueError(f"batch {x.shape[0]} is not divisible by the {len(devs)} data devices")
    return move(list(x.chunk(len(devs))), devs, "scatter")


def gather(parts: Sequence[Tensor], device, dim: int = 0) -> Tensor:
    """Per-shard tensors concatenated along `dim` on `device` (one gather)."""
    return torch.cat(move(parts, device, "gather"), dim=dim)


def reduce_shards(plan: MeshPlan, results, sizes: Sequence[int]):
    """Per-shard (loss, aux) -> the global batch's (loss, aux) on the lead
    device: the loss and every scalar aux value summed with weights b_i / B
    (one reduce; for batch-mean losses this is the global mean), batched
    aux tensors concatenated (one gather each). The reduce's backward sends
    each shard the gradient of its weighted loss."""
    total = float(sum(sizes))
    losses, auxs = zip(*results)
    scalars = [k for k, v in auxs[0].items() if v.ndim == 0]
    flat = [torch.stack([loss] + [a[k].to(loss.dtype) for k in scalars])
            for loss, a in zip(losses, auxs)]
    moved = move(flat, plan.lead, "reduce")
    summed = sum(m * (b / total) for m, b in zip(moved, sizes))
    aux = {k: summed[i + 1] for i, k in enumerate(scalars)}
    for k, v in auxs[0].items():
        if v.ndim > 0:
            aux[k] = gather([a[k] for a in auxs], plan.lead)
    return summed[0], aux


def data_parallel(plan: MeshPlan, fn: Callable, in_batched: Sequence[bool]):
    """`fn` run on each data-axis device over its shard of the batch.

    `in_batched[i]` marks positional argument i as a tensor batched on dim
    0 (scattered over `data`); the others pass as they are, and a Replicas
    argument (from `replicate`) passes its copy for the shard's device. The
    outputs (a tensor or a tuple of tensors) are concatenated on the lead
    device. Nothing else crosses devices: batchwise-independent work pays
    for no other movement (the JAX package's shard_map with zero
    collectives)."""
    def call(*args):
        if len(args) != len(in_batched):
            raise ValueError(f"{len(args)} arguments for in_batched of {len(in_batched)}")
        shards = [shard_batch(plan, a) if b else None for a, b in zip(args, in_batched)]
        outs = []
        for i, dev in enumerate(plan.data_devices):
            outs.append(fn(*(s[i] if s is not None else on(a, dev)
                             for a, s in zip(args, shards))))
        if isinstance(outs[0], tuple):
            return tuple(gather(list(o), plan.lead) for o in zip(*outs))
        return gather(outs, plan.lead)

    return call


# -- the model axis ---------------------------------------------------------


def _model_spec_for(key: Optional[str], shape: Sequence[int]) -> Optional[int]:
    """The port dim that the JAX package's `_model_spec_for` splits over
    the model axis, or None (replicated). The JAX rule reads JAX layouts
    (HWIO conv kernels, [in, out] linears, the NHWC constant input): the
    last dim of a rank-2 or rank-4 leaf when it is >= 512. It is applied
    here to the leaf's JAX-layout shape (undoing `to_port`'s permutation,
    keyed on the dict key and rank as `to_port` is) and the split dim is
    mapped back, so a port linear [out, in] splits dim 0 and a port OIHW
    kernel dim 0 (its output channels), never the square matrices' in
    features. Leaves `to_port` leaves alone keep the JAX dim."""
    ndim = len(shape)
    perm = port_perm(key, ndim) or tuple(range(ndim))
    jax_shape = [0] * ndim
    for d, j in enumerate(perm):
        jax_shape[j] = shape[d]
    if ndim in (2, 4) and jax_shape[-1] >= 512:
        return perm.index(ndim - 1)
    return None


def model_split_dims(params, n_model: int):
    """The tree of `params` with each leaf's split dim over a model axis
    of n_model devices, None where it stays replicated: `_model_spec_for`,
    and a dim not divisible by n_model is replicated, as the JAX package's
    shard_params_model_axis places it. Leaves need only a `shape`."""
    return map_tree(params, lambda key, x: _split_dim(key, x, n_model))


def _split_dim(key: Optional[str], x, n_model: int) -> Optional[int]:
    d = _model_spec_for(key, tuple(x.shape))
    return None if d is None or x.shape[d] % n_model else d


@dataclasses.dataclass(frozen=True, eq=False)
class ModelSharded(Placed):
    """A parameter tree placed over the model axis of `plan`.

    dims:  the tree's split dims (`model_split_dims`; None: replicated)
    trees: an object array of the mesh grid's shape (n_data, n_model): the
           tree that the device at each position holds, slice j of every
           split leaf at model index j (an `ops.columns.Cols`: outside a
           model-axis region, the plain slice), the replicated leaves whole

    `tp[key]` is the subtree at `key` (one model of a zoo), placed as it is;
    a model function given `tp` runs column-parallel (parallel/tensor.py).
    """

    plan: MeshPlan
    dims: Any
    trees: np.ndarray

    def __getitem__(self, key) -> "ModelSharded":
        out = np.empty(self.trees.shape, dtype=object)
        for idx in np.ndindex(*self.trees.shape):
            out[idx] = self.trees[idx][key]
        return ModelSharded(self.plan, self.dims[key], out)

    def spmd(self, fn: Callable, *args, **kwargs):
        from hairfastgan_torch.parallel import tensor  # tensor.py imports this module

        return tensor.spmd(self, fn, *args, **kwargs)


def shard_params_model_axis(plan: MeshPlan, params):
    """Tensor-parallel placement of a parameter tree over the model axis
    (counterpart of the JAX package's shard_params_model_axis): each split
    leaf is cut into n_model slices on the device it lives on and slice j
    is sent to every device of model index j (one scatter), so no device
    holds a split leaf whole; the replicated leaves go to each distinct
    device (one broadcast). Without a model axis: `replicate`, as JAX."""
    if plan.model_axis is None:
        return replicate(plan, params)
    grid = plan.grid
    n_data, n_model = grid.shape
    leaves: List[Tensor] = []
    flat_dims: List[Optional[int]] = []

    def visit(key, t):
        leaves.append(t)
        flat_dims.append(_split_dim(key, t, n_model))
        return flat_dims[-1]

    dims = map_tree(params, visit)
    split = [(t, d) for t, d in zip(leaves, flat_dims) if d is not None]
    whole = [t for t, d in zip(leaves, flat_dims) if d is None]
    pos = list(np.ndindex(n_data, n_model))
    sliced = move([t.chunk(n_model, dim=d)[j] for i, j in pos for t, d in split],
                  [grid[i, j] for i, j in pos for _ in split], "scatter")
    devs = plan.distinct
    copies = move([t for _ in devs for t in whole], [d for d in devs for _ in whole],
                  "broadcast")
    trees = np.empty((n_data, n_model), dtype=object)
    for k, (i, j) in enumerate(pos):
        mine = iter(sliced[k * len(split):(k + 1) * len(split)])
        c = devs.index(grid[i, j])
        rep = iter(copies[c * len(whole):(c + 1) * len(whole)])
        ds = iter(flat_dims)

        def leaf(_, t):
            d = next(ds)
            return next(rep) if d is None else cols(next(mine), d - t.ndim, weight=True)

        trees[i, j] = map_tree(params, leaf)
    return ModelSharded(plan, dims, trees)


def whole_params(tp: ModelSharded):
    """The tree that `tp` places, whole on the lead device (the counterpart
    of the JAX package's replicated in_specs on a model-sharded zoo): each
    split leaf's model-axis slices from the lead's data row concatenated
    there, all in one `gather`; the replicated leaves as the lead position
    holds them."""
    n_model = tp.trees.shape[1]
    rows: List[List[Cols]] = [[] for _ in range(n_model)]
    for j, row in enumerate(rows):
        map_tree(tp.trees[0, j], lambda _, t: row.append(t) if isinstance(t, Cols) else None)
    moved = move([raw(r[k]) for k in range(len(rows[0])) for r in rows], tp.plan.lead, "gather")
    wholes = iter([torch.cat(moved[k * n_model:(k + 1) * n_model], dim=c._split)
                   for k, c in enumerate(rows[0])])
    return map_tree(tp.trees[0, 0], lambda _, t: next(wholes) if isinstance(t, Cols) else t)
