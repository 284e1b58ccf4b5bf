"""The benchmark's random weights, drawn on the device from the run's seed.

A configuration file names the zoo's shape tree (`"zoo"`: "full" or "micro",
portbench/reference/zoo.py) and, per model, the law its leaves are drawn by
(`"laws"`, with "*" for the models it does not name). Every normal number of
the whole zoo comes from ONE `torch.randn` call on the device in the dtype
the program serves in, and every uniform one from one `torch.rand` call; each
leaf is then a view of those buffers, scaled in place by its law. So the same
seed gives the same weights on any run, and the plain reference redraws them
itself instead of reading the program's copy.

Laws (the initialisations of the published models, as their code draws them):
  lecun           conv and linear weights N(0,1) / sqrt(fan-in) (e4e's
                  EqualLinear heads N(0,1): they scale at run time), PReLU
                  slopes 0.25, norms the identity (gamma, var 1; beta, mean
                  0), biases 0, CLIP's embeddings N(0,1) / sqrt(width) and
                  its projection N(0,1) / sqrt(fan-in), SEAN's noise
                  strengths and blend logits 0 (normalization.py:
                  torch.zeros), latent averages and SEAN's mean codes N(0,1)
  stylegan2       every 'w' and the constant 'input' N(0,1) (the equalized
                  learning rate scales them at run time), modulation biases
                  1, other biases and the noise weights 0
  bisenet         conv weights 0.02 * N(0,1), biases 0, identity BatchNorm
  shape_adaptor   conv weights 0.02 * N(0,1), linear weights
                  N(0,1) / sqrt(fan-in), layer-norm gammas U(0,1), the rest 0
The port's own random zoo (zoo.fill_random: 0.05 * N(0,1) everywhere) makes
a swap's output the same image whatever its inputs, which no comparison of
outputs could hold to anything. With the noise strengths at 0 the output
does not depend on the noise the swap draws, so the reference needs no copy
of the program's noise stream.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from portbench.reference.bridge import map_tree
from portbench.reference.zoo import zoo_shapes

_ONES, _ZEROS = ("gamma", "var"), ("beta", "mean", "b", "bias", "noise_var", "blend_gamma",
                                   "blend_beta")


def _lecun(path: Tuple[str, ...], shape) -> Tuple[str, float]:
    """(kind, value): kind "normal" scales a N(0,1) view by value, "uniform"
    keeps a U(0,1) view, "const" fills value."""
    key = path[-1]
    if key == "w" and len(shape) == 4:  # conv [O,I,kh,kw]
        return "normal", 1.0 / math.sqrt(shape[1] * shape[2] * shape[3])
    if key == "w" and len(shape) == 2:  # linear [out,in]; e4e's EqualLinear scales at run time
        return "normal", 1.0 if path[0] == "e4e" else 1.0 / math.sqrt(shape[1])
    if key == "w" and len(shape) == 1:  # PReLU slopes
        return "const", 0.25
    if key == "proj":  # CLIP's output projection, x @ proj
        return "normal", 1.0 / math.sqrt(shape[0])
    if key in ("class_emb", "pos_emb"):
        return "normal", 1.0 / math.sqrt(shape[-1])
    if key in _ONES:
        return "const", 1.0
    if key in _ZEROS:
        return "const", 0.0
    return "normal", 1.0  # latent averages, SEAN's mean codes


def _stylegan2(path, shape):
    if path[-1] in ("w", "input"):
        return "normal", 1.0
    return "const", 1.0 if path[-2:] == ("modulation", "b") else 0.0


def _bisenet(path, shape):
    fixed = {"gamma": 1.0, "var": 1.0, "beta": 0.0, "mean": 0.0, "b": 0.0}
    if path[-1] in fixed:
        return "const", fixed[path[-1]]
    return "normal", 0.02


def _shape_adaptor(path, shape):
    if path[-1] == "w":  # conv [O,I,kh,kw] or linear [out,in]
        return "normal", 0.02 if len(shape) == 4 else 1.0 / math.sqrt(shape[1])
    if path[-1] == "gamma":
        return "uniform", 1.0
    return "const", 0.0


LAWS: Dict[str, Callable] = {"lecun": _lecun, "stylegan2": _stylegan2, "bisenet": _bisenet,
                             "shape_adaptor": _shape_adaptor}


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


def make_zoo(spec: Dict, seed: int, device, dtype: torch.dtype):
    """(zoo, HairFastConfig of the zoo's shapes): the configuration's weights
    from `seed`, on `device`, in `dtype`. `spec` is the configuration file's
    "weights" object: {"zoo": ..., "laws": {model: law, "*": law}}."""
    tree, cfg = zoo_shapes(spec["zoo"])
    laws = spec["laws"]
    leaves = _leaves(tree)
    plan = []
    n_normal = n_uniform = 0
    for path, t in leaves:
        kind, value = LAWS[laws.get(path[0], laws["*"])](path, tuple(t.shape))
        plan.append((path, t.shape, kind, value, n_normal if kind == "normal" else n_uniform))
        n_normal += t.numel() if kind == "normal" else 0
        n_uniform += t.numel() if kind == "uniform" else 0
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    normal = torch.randn(n_normal, generator=g, device=device, dtype=dtype)
    uniform = torch.rand(max(n_uniform, 1), generator=g, device=device, dtype=dtype)
    values = {}
    with torch.no_grad():
        for path, shape, kind, value, at in plan:
            n = math.prod(shape)
            if kind == "const":
                values[path] = torch.full(tuple(shape), value, device=device, dtype=dtype)
                continue
            v = (normal if kind == "normal" else uniform)[at:at + n].view(tuple(shape))
            if kind == "normal" and value != 1.0:
                v.mul_(value)
            values[path] = v
    return _rebuild(tree, values), cfg


def as_float32(zoo):
    """The zoo with every float leaf in float32 (the reference's copy)."""
    return map_tree(zoo, lambda _, t: t.float() if t.is_floating_point() else t)


def shape_config(spec: Dict):
    """The HairFastConfig of the zoo's shapes, without drawing anything."""
    return zoo_shapes(spec["zoo"])[1]

