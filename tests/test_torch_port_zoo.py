"""The port's parameter bridge and jax-free random init, held against the
JAX package's zoo; and the port's import boundary: no JAX and nothing of
the JAX package, in the package and in chip_smoke.py."""

import ast
import subprocess
import sys
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


ALLOWED_TPU_IMPORTS = set()  # the port owns its config and host modules


@pytest.mark.parametrize("path", sorted(str(p.relative_to(PORT))
                                        for p in PORT.rglob("*.py")) + ["../chip_smoke.py"])
def test_port_imports_no_jax(path):
    """No module of the port, and not chip_smoke.py, imports jax (or jaxlib)
    or any module of the JAX package."""
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


BLOCKED_RUN = """
import importlib.abc, sys

class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "hairfastgan_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocked())
import numpy as np, torch
import hairfastgan_torch.api, hairfastgan_torch.convert_checkpoints
import hairfastgan_torch.main, hairfastgan_torch.serve
import hairfastgan_torch.scripts.gen_blending_data, hairfastgan_torch.scripts.gen_rotate_data
import hairfastgan_torch.scripts.train_blending, hairfastgan_torch.scripts.train_rotate
import hairfastgan_torch.scripts.gen_pp_data, hairfastgan_torch.scripts.train_pp
import hairfastgan_torch.scripts.fid_metric, hairfastgan_torch.eval.fid
import hairfastgan_torch.params.nvlabs
import hairfastgan_torch.pspace, hairfastgan_torch.models.inception
import hairfastgan_torch.scripts.align_faces, hairfastgan_torch.scripts.parity_harness
import hairfastgan_torch.scripts.upload_res_agreement
import hairfastgan_torch.train.datagen, hairfastgan_torch.losses
import hairfastgan_torch.parallel.mesh, hairfastgan_torch.parallel.spatial
import hairfastgan_torch.parallel.tensor
from hairfastgan_torch.train.blending import make_blending_train_step
from hairfastgan_torch.train.pp import make_pp_train_steps
from hairfastgan_torch.zoo import (blending_train_tiny, init_discriminator, init_micro_zoo,
                                   pp_train_frozen)

torch.set_num_threads(2)
zoo, cfg = init_micro_zoo(0)
hf = hairfastgan_torch.api.HairFast(cfg, zoo=zoo, device="cpu")
rng = np.random.default_rng(0)
out = hf.swap(*(rng.integers(0, 256, (128, 128, 3), dtype=np.uint8) for _ in range(3)),
              output="uint8")
assert out.shape == (128, 128, 3) and out.dtype == np.uint8
frozen, params, tcfg = blending_train_tiny(0)
step, tx = make_blending_train_step(frozen, tcfg)
n = tcfg.stylegan.n_latent
batch = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.1) for s in (
    (1, n, 512), (1, n, 512), (1, 32, 32, 512), (1, 256, 256, 3), (1, 256, 256, 3))]
batch += [torch.ones(1, 256, 256, 1)] * 3
_, _, aux = step(params, tx.init(params), *batch)
assert np.isfinite(float(aux["loss"]))
pp, _, _, ptx, _ = make_pp_train_steps(pp_train_frozen(zoo["generator"], 0.25), cfg=cfg,
                                        use_adv=True)
pp_batch = [torch.from_numpy(rng.random((1, 256, 256, c), dtype=np.float32)) for c in (3, 3, 1, 1)]
_, _, aux = pp(zoo["post_process"], ptx.init(zoo["post_process"]), *pp_batch,
               init_discriminator(cfg.stylegan), 0.5)
assert np.isfinite(float(aux["loss"])) and float(aux["adv"]) != 0
from hairfastgan_torch.eval.fid import inception_feature_fn
from hairfastgan_torch.models.inception import init_inception
feats = inception_feature_fn(init_inception(0))(rng.random((1, 32, 32, 3), dtype=np.float32))
assert feats.shape == (1, 2048) and np.isfinite(feats).all()
from hairfastgan_torch.config import StyleGANConfig
from hairfastgan_torch.models import stylegan2
from hairfastgan_torch.parallel import mesh, tensor
from hairfastgan_torch.zoo import fill_random
sg = StyleGANConfig(size=16)
tp = mesh.shard_params_model_axis(mesh.make_mesh(1, 2, devices=[torch.device("cpu")] * 2),
                                  fill_random(stylegan2.init_generator_params(sg), 0))
img = tensor.generate(tp, torch.full((2, sg.n_latent, 512), 0.1), cfg=sg)
assert img.shape == (2, 16, 16, 3) and mesh.MOVES["all_gather"] > 0
from hairfastgan_torch.pipeline.swap import hair_fast
trip = [torch.from_numpy(rng.random((1, 128, 128, 3), dtype=np.float32)) for _ in range(3)]
tpz = mesh.shard_params_model_axis(mesh.make_mesh(1, 2, devices=[torch.device("cpu")] * 2), zoo)
with torch.inference_mode():
    axis, flat = hair_fast(tpz, *trip, cfg=cfg), hair_fast(zoo, *trip, cfg=cfg)
assert axis.shape == (1, 128, 128, 3) and float((axis - flat).abs().max()) <= 1e-5
left = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "hairfastgan_tpu"))
assert not left, left
print("SWAPPED", out.shape, "STEPPED")
"""


def test_port_runs_with_jax_blocked():
    """With jax and the JAX package unimportable, the port's entry points
    (the training and evaluation scripts included) import, and a micro
    swap, a --tiny blending train step, a --micro PostProcess step with the
    discriminator, InceptionV3 features, a column-parallel render and a
    micro swap on a model-axis zoo on a (1, 2) mesh run on the CPU, in a
    fresh interpreter."""
    res = subprocess.run([sys.executable, "-c", BLOCKED_RUN], capture_output=True, text=True,
                         timeout=300, cwd=PORT.parent)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "SWAPPED (128, 128, 3) STEPPED" in res.stdout


def test_import_walk_covers_training():
    """The import check above walks the training modules and CLIs too."""
    walked = {str(p.relative_to(PORT)).split("/")[0] for p in PORT.rglob("*.py")}
    assert {"train", "losses", "scripts", "eval", "params", "parallel"} <= walked
