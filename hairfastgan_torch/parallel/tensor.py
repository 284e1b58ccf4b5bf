"""The column-parallel StyleGAN2 generator on the model axis (the port's
counterpart of jit with XLA's SPMD partitioner on the shardings of the JAX
package's shard_params_model_axis).

The parameters come from `mesh.shard_params_model_axis`: the wide linears
hold a slice of their output features on each model-axis device and the
wide conv kernels a slice of their output channels. The batch runs over
`data`. Each layer whose weight is split computes its own output slice
from the whole input and then all-gathers the slices on every device of
the row (`all_gather`), so the next layer again reads a whole input:

  equalized linear  y[:, slice j] = x @ W[slice j]^T + b[slice j]; the
                    rank-1 bias is replicated and sliced where it is used
  modulated conv    the style linear splits on cin, so its output s [B, cin]
                    is gathered; the kernel splits on cout, and each device
                    convolves the whole modulated input with its kernel
                    rows. Demodulation sums over cin and the kernel taps of
                    each output channel, so it is local, as are the noise,
                    the bias, sqrt(2) * lrelu and the up-conv's depthwise
                    blur (fused or not)
  ToRGB             (3 outputs) replicated; it reads the gathered map
  constant input    split on channels, gathered where conv1 reads it

A split over cin (row-parallel) would need the demodulation sums and the
outputs reduced across devices; the JAX placement splits cout, and so does
this. No split weight ever moves: only activations and styles do, each
move counted under `all_gather` in parallel.mesh.MOVES. A layer whose
weight is replicated runs on every device of the row, as the SPMD
partitioner runs replicated work, and gives the same whole output there.

Entry and exit: the batched inputs go from the lead device to the rows in
one `scatter` (one `broadcast` on a mesh with one data row), and the
results come back from each row's first device, one `gather` for each
tensor returned (`generate` returns the RGB alone; nothing moves on one
data row: position (0, 0) is the lead). All entry points
take and return the tensors of models/stylegan2.py on the lead device and
change placement, never the math.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from hairfastgan_torch.models import stylegan2
from hairfastgan_torch.ops.equalized import equal_linear, pixel_norm
from hairfastgan_torch.ops.modconv import styled_conv2d
from hairfastgan_torch.parallel.mesh import ModelSharded, gather, move

Tensor = torch.Tensor
Grid = List[List]  # [i][j]: a value for each mesh position (data row i, model index j)


def _check(tp) -> Tuple[int, int]:
    if not isinstance(tp, ModelSharded):
        raise TypeError("the column-parallel generator takes the parameters placed by "
                        "parallel.mesh.shard_params_model_axis on a (data, model) mesh")
    return tp.trees.shape


def _each(tp: ModelSharded, fn: Callable, *grids: Grid) -> Grid:
    """fn(i, j, *values at (i, j)) at every mesh position."""
    n_data, n_model = tp.trees.shape
    return [[fn(i, j, *(g[i][j] for g in grids)) for j in range(n_model)]
            for i in range(n_data)]


def _sub(tp: ModelSharded, path: Sequence) -> Tuple[Grid, object]:
    """The subtree at `path` on each position, and its split dims."""
    def walk(tree):
        for k in path:
            tree = tree[k]
        return tree

    n_data, n_model = tp.trees.shape
    return ([[walk(tp.trees[i, j]) for j in range(n_model)] for i in range(n_data)],
            walk(tp.dims))


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


def _local_slice(t: Tensor, j: int, n_model: int) -> Tensor:
    """Model index j's slice of a replicated per-feature vector (a bias)."""
    return t.chunk(n_model)[j]


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
                      "scatter" if n_data > 1 else "broadcast"))
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


def _linear(tp: ModelSharded, path: Sequence, xs: Grid, lr_mul: float = 1.0,
            activation: Optional[str] = None) -> Grid:
    """EqualLinear at `path`: column-parallel (then all-gathered) when its
    weight is split, else whole on every position."""
    ps, dims = _sub(tp, path)
    if dims["w"] is None:
        return _each(tp, lambda i, j, p, x: equal_linear(p, x, lr_mul, activation), ps, xs)
    if dims["w"] != 0:
        raise ValueError(f"{path}: a linear splits its output features (dim 0), not {dims['w']}")
    n_model = tp.trees.shape[1]

    def local(i, j, p, x):
        q = {"w": p["w"], "b": _local_slice(p["b"], j, n_model)} if "b" in p else p
        return equal_linear(q, x, lr_mul, activation)

    return all_gather(tp, _each(tp, local, ps, xs), dim=-1)


def _conv(tp: ModelSharded, path: Sequence, xs: Grid, styles: Grid, tail: Callable, *,
          demodulate: bool, up: bool = False, fuse_blur: bool = False) -> Grid:
    """The modulated conv at `path` (+ "conv") and its per-channel `tail`
    (params, y, bias slice, i, j) -> y: styles gathered when the modulation is split,
    output channels computed per slice and gathered when the kernel is."""
    ps, dims = _sub(tp, path)
    s = _linear(tp, tuple(path) + ("conv", "modulation"), styles)
    split = dims["conv"]["w"]
    if split not in (None, 0):
        raise ValueError(f"{path}: a conv kernel splits its output channels (dim 0), not {split}")
    n_model = tp.trees.shape[1]

    def local(i, j, p, x, s):
        y = styled_conv2d(p["conv"]["w"], x, s.to(x.dtype), demodulate=demodulate, up=up,
                          fuse_blur=fuse_blur)
        bias = p["bias"] if split is None else _local_slice(p["bias"], j, n_model)
        return tail(p, y, bias, i, j)

    ys = _each(tp, local, ps, xs, s)
    return ys if split is None else all_gather(tp, ys, dim=1)


def modulated_conv2d(tp: ModelSharded, path: Sequence, xs: Grid, styles: Grid, *,
                     demodulate: bool = True, up: bool = False,
                     fuse_blur: bool = False) -> Grid:
    """ops/modconv.modulated_conv2d of the layer at `path` (its "conv"
    holds "w" and "modulation") on each position's whole input, with the
    column split; gathered output per position."""
    return _conv(tp, path, xs, styles, lambda p, y, b, i, j: y, demodulate=demodulate, up=up,
                 fuse_blur=fuse_blur)


def mapping(tp: ModelSharded, z: Tensor, cfg) -> Tensor:
    """stylegan2.mapping: z [B, style_dim] on the lead device -> w there."""
    _check(tp)
    (zs,) = _scatter_rows(tp, [z])
    xs = _each(tp, lambda i, j, x: pixel_norm(x, dim=-1), zs)
    for k in range(len(tp.dims["style"])):
        xs = _linear(tp, ("style", k), xs, lr_mul=cfg.lr_mlp, activation="fused_lrelu")
    return _gather_rows(tp, xs)


def _styled_conv(tp, path, xs, styles, noise, *, up=False) -> Grid:
    def tail(p, y, bias, i, j):
        return stylegan2.styled_conv_tail(y, p["noise_weight"], bias,
                                          None if noise is None else noise[i][j])

    return _conv(tp, path, xs, styles, tail, demodulate=True, up=up)


def _to_rgb(tp, path, xs, styles, skip: Optional[Grid]) -> Grid:
    def tail(p, y, bias, i, j):
        return stylegan2.to_rgb_tail(y, bias, None if skip is None else skip[i][j])

    return _conv(tp, path, xs, styles, tail, demodulate=False)


def _synthesis_grids(tp: ModelSharded, latent: Tensor, *, noise: Sequence[Optional[Tensor]],
                     start_layer: int, end_layer: int, layer_in: Optional[Tensor],
                     skip: Optional[Tensor], cfg, dtype: torch.dtype
                     ) -> Tuple[Optional[Grid], Optional[Grid]]:
    """stylegan2.walk_synthesis on the mesh positions; its results left there."""
    n_data, n_model = _check(tp)
    lat, lay, sk, *nz = _scatter_rows(tp, [latent.to(dtype), layer_in, skip, *noise])
    b = latent.shape[0] // n_data

    def style(k):
        return _each(tp, lambda i, j, w: w[:, k], lat)

    if start_layer == 0:
        const, dims = _sub(tp, ("input",))
        xs = _each(tp, lambda i, j, c: c.to(dtype).expand(b, -1, -1, -1), const)
        if dims is not None:
            xs = all_gather(tp, xs, dim=1)
    else:
        xs = None if lay is None else _each(tp, lambda i, j, x: x.to(dtype), lay)
    return stylegan2.walk_synthesis(
        xs, sk, start_layer=start_layer, end_layer=end_layer, cfg=cfg,
        styled_conv=lambda path, h, k, up: _styled_conv(tp, path, h, style(k), nz[k], up=up),
        to_rgb=lambda path, h, k, skip: _to_rgb(tp, path, h, style(k), skip))


def synthesis_nchw(tp: ModelSharded, latent: Tensor, *, noise: Sequence[Optional[Tensor]],
                   start_layer: int = 0, end_layer: int = 8,
                   layer_in: Optional[Tensor] = None, skip: Optional[Tensor] = None, cfg,
                   dtype: torch.dtype) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """stylegan2.synthesis_nchw on the model axis: the same schedule over the
    same layers, every input and output on the lead device."""
    grids = _synthesis_grids(tp, latent, noise=noise, start_layer=start_layer,
                             end_layer=end_layer, layer_in=layer_in, skip=skip, cfg=cfg,
                             dtype=dtype)
    return tuple(None if g is None else _gather_rows(tp, g) for g in grids)


def _noise_nchw(tp: ModelSharded, latent: Tensor, noise, generator, cfg):
    """`noise` (NHWC, Nones kept) as NCHW, or drawn by `generator` on the
    lead device as the one-device call draws it."""
    _check(tp)
    if noise is None:
        return stylegan2.make_noise(generator, cfg, latent.shape[0], latent.device)
    return [None if n is None else n.permute(0, 3, 1, 2) for n in noise]


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
    noise = _noise_nchw(tp, latent, noise, generator, cfg)
    _, sk = _synthesis_grids(tp, latent, noise=noise, start_layer=0, end_layer=8,
                             layer_in=None, skip=None, cfg=cfg, dtype=dtype)
    return _gather_rows(tp, sk).permute(0, 2, 3, 1)
