"""The port's parameter bridge and jax-free random init, held against the
JAX package's zoo; and the port's import boundary (no JAX)."""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hairfastgan_tpu.config import HairFastConfig, StyleGANConfig
from hairfastgan_tpu.models import sean as jsean
from hairfastgan_tpu.models import stylegan2 as jsg
from hairfastgan_tpu.zoo import _fill_random, init_micro_zoo_fast, init_tiny_zoo, init_zoo
from hairfastgan_torch import zoo as tzoo
from hairfastgan_torch.models import sean as tsean
from hairfastgan_torch.models import stylegan2 as tsg
from hairfastgan_torch.params.bridge import bridge_zoo, map_tree, to_port

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
PORT = Path(__file__).resolve().parent.parent / "hairfastgan_torch"


def flat(tree, prefix=()):
    """{path: leaf} over dicts and lists; Python values (statics) included."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, prefix + (i,)))
        return out
    return {prefix: tree}


def port_shapes(jax_tree):
    """JAX tree (arrays or ShapeDtypeStructs) -> {path: port-layout shape or static}."""
    meta = map_tree(jax_tree, lambda k, a: to_port(k, torch.empty(a.shape, device="meta")))
    return {p: (tuple(v.shape) if isinstance(v, torch.Tensor) else v)
            for p, v in flat(meta).items()}


def jax_leaf_count(tree):
    return len(jax.tree_util.tree_leaves(tree))


def test_bridge_micro_zoo_every_leaf():
    jz, _ = init_micro_zoo_fast(0)
    tz = bridge_zoo(jz)
    leaves = {p: v for p, v in flat(tz).items() if isinstance(v, torch.Tensor)}
    assert len(leaves) == jax_leaf_count(jz)  # none dropped, none invented
    # values: each leaf is the JAX leaf under to_port's layout change
    jflat = flat(jax.tree.map(np.asarray, jz))
    for path, v in leaves.items():
        key = path[-1] if isinstance(path[-1], str) else None
        ref = torch.from_numpy(np.asarray(jflat[path]))
        np.testing.assert_array_equal(v.numpy(), to_port(key, ref).numpy())
    # Static config leaves come through as their values
    assert tz["e4e"]["backbone"]["body"][0]["stride"] == 2
    assert tz["fse"]["fs_layers"] == (5,)
    assert tz["bisenet"]["n_classes"] == 19


def test_bridge_tiny_zoo_every_leaf():
    """Every leaf of the tiny zoo maps, none dropped (shape level: the
    tiny zoo's real-width trunks need not be allocated for this)."""
    shapes = jax.eval_shape(lambda: init_tiny_zoo(KEY)[0])
    meta = map_tree(shapes, lambda k, a: to_port(k, torch.empty(a.shape, device="meta")))
    tensors = [v for v in flat(meta).values() if isinstance(v, torch.Tensor)]
    assert len(tensors) == jax_leaf_count(shapes)
    assert sum(v.numel() for v in tensors) == sum(
        int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))


def test_full_config_shapes_match_jax():
    """The port's own full-config tree has exactly the JAX init_zoo leaf
    shapes (port layout); meta tensors, so nothing is allocated."""
    jshapes = jax.eval_shape(lambda: init_zoo(KEY, HairFastConfig()))
    ours = {p: (tuple(v.shape) if isinstance(v, torch.Tensor) else v)
            for p, v in flat(tzoo.init_zoo(HairFastConfig(), seed=None)).items()}
    theirs = port_shapes(jshapes)
    assert ours == theirs
    n_tensors = sum(isinstance(v, torch.Tensor)
                    for v in flat(tzoo.init_zoo(HairFastConfig(), seed=None)).values())
    assert n_tensors == jax_leaf_count(jshapes)


@pytest.mark.parametrize("family", ["generator", "sean"])
def test_fill_random_matches_jax_fill(family):
    """A seed gives the JAX package's _fill_random weights, bridged (BN
    'var' -> 1 and 'mean' -> 0 included)."""
    if family == "generator":
        sg = StyleGANConfig(size=32, max_channels=16)
        jtree = jax.eval_shape(lambda: jsg.init_generator_params(KEY, sg))
        ours = tzoo.fill_random(tsg.init_generator_params(sg), seed=3)
    else:
        jtree = jax.eval_shape(lambda: jsean.init_sean_generator(KEY, ngf=4, z_ngf=4))
        ours = tzoo.fill_random(tsean.init_sean_generator(ngf=4, z_ngf=4), seed=3)
    ref = flat(bridge_zoo(_fill_random(jtree, 3)))
    got = flat(ours)
    assert got.keys() == ref.keys()
    for p in ref:
        if isinstance(ref[p], torch.Tensor):
            assert torch.equal(got[p], ref[p]), p
        else:
            assert got[p] == ref[p], p


def test_cast_zoo():
    tree = {"w": torch.ones(2, 3), "idx": torch.arange(3), "stride": 2,
            "blocks": [{"gamma": torch.ones(4)}]}
    out = tzoo.cast_zoo(tree, torch.bfloat16)
    assert out["w"].dtype == out["blocks"][0]["gamma"].dtype == torch.bfloat16
    assert out["idx"].dtype == torch.int64 and out["stride"] == 2


ALLOWED_TPU_IMPORTS = {"hairfastgan_tpu.config", "hairfastgan_tpu.utils.images"}


@pytest.mark.parametrize("path", sorted(str(p.relative_to(PORT))
                                        for p in PORT.rglob("*.py")))
def test_port_imports_no_jax(path):
    """No module of the port imports jax (or jaxlib), and the only JAX-package
    modules it imports are the jax-free config and image utilities."""
    tree = ast.parse((PORT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "optax"), (path, name)
            if name.startswith("hairfastgan_tpu"):
                assert name in ALLOWED_TPU_IMPORTS, (path, name)
