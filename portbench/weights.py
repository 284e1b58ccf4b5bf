"""The benchmark's random weights, drawn on the device from the run's seed.

A configuration file names the zoo's shape tree (`"zoo"`, found by name:
portbench/zoos/<zoo>.py, through portbench/reference/zoo.py) and, per model,
the law its leaves are drawn by (`"laws"`, with "*" for the models it does
not name; law <law> is portbench/laws/<law>.py, whose `law(path, shape)`
gives a leaf's (kind, value)). Zoos and laws are found under `where`, the
bench folder of the part that asks (registry.part_root). Every normal number of the whole zoo comes
from ONE `torch.randn` call on the device in the dtype the program serves
in, and every uniform one from one `torch.rand` call, in the tree's leaf
order; each leaf is then a view of those buffers, scaled in place by its
law. So the same seed gives the same weights on any run, and the plain
reference redraws them itself instead of reading the program's copy.

The laws are the initialisations of the published models, as their code
draws them (each law's file says which). The port's own random zoo
(zoo.fill_random: 0.05 * N(0,1) everywhere) makes a swap's output the same
image whatever its inputs, which no comparison of outputs could hold to
anything. With the noise strengths at 0 the output does not depend on the
noise the swap draws, so the reference needs no copy of the program's noise
stream.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from portbench.reference.bridge import map_tree
from portbench.reference.zoo import zoo_shapes
from portbench.registry import HERE, load_part


def _leaves(tree, path=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (str(i),))]
    return [(path, tree)] if isinstance(tree, torch.Tensor) else []


def _rebuild(tree, values: Dict[Tuple[str, ...], torch.Tensor], path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values, path + (k,)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(v, values, path + (str(i),)) for i, v in enumerate(tree)]
    return values[path] if isinstance(tree, torch.Tensor) else tree


Row = Tuple[Tuple[str, ...], Tuple[int, ...], str, str, float, int]


def _plan(tree, laws: Dict[str, str], where: Path) -> List[Row]:
    """Per leaf of `tree`, in leaf order: (path, shape, law, kind, value,
    offset into the normal or the uniform buffer)."""
    fns = {name: load_part("laws", name, where).law for name in set(laws.values())}
    rows = []
    n_normal = n_uniform = 0
    for path, t in _leaves(tree):
        name = laws.get(path[0], laws["*"])
        kind, value = fns[name](path, tuple(t.shape))
        rows.append((path, tuple(t.shape), name, kind, value,
                     n_normal if kind == "normal" else n_uniform))
        n_normal += t.numel() if kind == "normal" else 0
        n_uniform += t.numel() if kind == "uniform" else 0
    return rows


def plan(spec: Dict, where: Path = HERE) -> List[Row]:
    """What make_zoo draws for the configuration's "weights" `spec`, leaf by
    leaf, without drawing it."""
    return _plan(zoo_shapes(spec["zoo"], where)[0], spec["laws"], where)


def make_zoo(spec: Dict, seed: int, device, dtype: torch.dtype, where: Path = HERE):
    """(zoo, HairFastConfig of the zoo's shapes): the configuration's weights
    from `seed`, on `device`, in `dtype`. `spec` is the configuration file's
    "weights" object: {"zoo": ..., "laws": {model: law, "*": law}}."""
    tree, cfg = zoo_shapes(spec["zoo"], where)
    rows = _plan(tree, spec["laws"], where)
    n_normal = sum(math.prod(r[1]) for r in rows if r[3] == "normal")
    n_uniform = sum(math.prod(r[1]) for r in rows if r[3] == "uniform")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    normal = torch.randn(n_normal, generator=g, device=device, dtype=dtype)
    uniform = torch.rand(max(n_uniform, 1), generator=g, device=device, dtype=dtype)
    values = {}
    with torch.no_grad():
        for path, shape, _, kind, value, at in rows:
            n = math.prod(shape)
            if kind == "const":
                values[path] = torch.full(shape, value, device=device, dtype=dtype)
                continue
            v = (normal if kind == "normal" else uniform)[at:at + n].view(shape)
            if kind == "normal" and value != 1.0:
                v.mul_(value)
            values[path] = v
    return _rebuild(tree, values), cfg


def as_float32(zoo):
    """The zoo with every float leaf in float32 (the reference's copy)."""
    return map_tree(zoo, lambda _, t: t.float() if t.is_floating_point() else t)


def shape_config(spec: Dict, where: Path = HERE):
    """The HairFastConfig of the zoo's shapes, without drawing anything."""
    return zoo_shapes(spec["zoo"], where)[1]

