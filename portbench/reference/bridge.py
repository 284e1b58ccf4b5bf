"""JAX zoo pytree -> the port's parameters.

The JAX package keeps conv weights HWIO and linear weights [in, out]; the
port keeps OIHW and [out, in] (ops/basic.py). Every leaf goes through
`to_port`, keyed by its dict key and rank:
  * 'w' of rank 4 (conv): HWIO -> OIHW. Up-conv kernels are stored by the
    converter in forward (lhs-dilated) form, already flipped; they stay so
    (ops/modconv.py flips them back for conv_transpose2d).
  * 'w' of rank 2 (linear / EqualLinear): [in, out] -> [out, in]
  * the generator's constant 'input' [1,4,4,C] (NHWC) -> NCHW
  * the packed layouts of zoo.pack_zoo: e4e's 'chain' kernels 'w' of rank
    5, [k,kh,kw,I,O] -> [k,O,I,kh,kw]; the stacked linears 'lin_w' (e4e),
    'styles_w' (FSE) and 'fc_mu_w' (SEAN), [k,in,out] -> [k,out,in]
  * everything else (biases, norms, embeddings, CLIP's raw 'proj' matrix)
    unchanged.
`models/layers.Static` leaves become their `.value`. The module imports no
JAX: leaves are read through np.asarray, Static by duck typing.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch


_STACKED_LINEARS = ("lin_w", "styles_w", "fc_mu_w")


def port_perm(key: Optional[str], ndim: int) -> Optional[Tuple[int, ...]]:
    """The permutation `to_port` applies to a leaf of rank `ndim` under
    dict key `key`: port dim d is JAX dim perm[d]; None leaves it as it is."""
    if key == "w" and ndim == 4:
        return (3, 2, 0, 1)
    if key == "w" and ndim == 2:
        return (1, 0)
    if key == "w" and ndim == 5:
        return (0, 4, 3, 1, 2)
    if key in _STACKED_LINEARS and ndim == 3:
        return (0, 2, 1)
    if key == "input" and ndim == 4:
        return (0, 3, 1, 2)
    return None


def to_port(key: Optional[str], t: torch.Tensor) -> torch.Tensor:
    """One leaf in JAX layout -> port layout (a view; callers copy)."""
    perm = port_perm(key, t.ndim)
    return t if perm is None else t.permute(perm)


def _is_static(leaf) -> bool:
    return type(leaf).__name__ == "Static" and hasattr(leaf, "value")


def map_tree(tree, leaf_fn: Callable[[Optional[str], Any], Any], key: Optional[str] = None):
    """Walk dicts (in sorted key order, as jax flattens them) and lists;
    call leaf_fn(last dict key or None, leaf) on array leaves; unwrap Static;
    keep plain Python values (ints and tuples are static config)."""
    if isinstance(tree, dict):
        return {k: map_tree(tree[k], leaf_fn, k) for k in sorted(tree)}
    if isinstance(tree, list):
        return [map_tree(v, leaf_fn, None) for v in tree]
    if _is_static(tree):
        return tree.value
    if hasattr(tree, "shape"):
        return leaf_fn(key, tree)
    return tree


def bridge_zoo(zoo):
    """JAX zoo (jax or numpy arrays) -> port parameter tree on the CPU, in
    the zoo's dtypes (zoo.cast_zoo casts; HairFast moves it to its device)."""
    return map_tree(zoo, lambda key, a: to_port(key, torch.from_numpy(np.array(a))).contiguous())
