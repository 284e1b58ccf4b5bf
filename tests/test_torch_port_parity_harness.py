"""The port's parity harness (hairfastgan_torch/scripts/parity_harness.py)
on the tiny zoo, as tests/test_parity_harness.py holds the JAX one: a
golden in the reference's save_all layout (torch NCHW latents, vis-mask
PNGs, final.png) built from a run, fed back through compare_run.

Across packages: the golden written from the JAX package's tiny run
(`hair_fast(..., return_intermediate=True)` on init_tiny_zoo) passes the
port's compare_run on the port's run of the bridged zoo, at the harness's
default tolerances.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from hairfastgan_torch.config import HairFastConfig, StyleGANConfig
from hairfastgan_torch.params.bridge import bridge_zoo
from hairfastgan_torch.scripts.parity_harness import (Report, compare_run, decode_vis_mask,
                                                      resize_labels, run_pipeline)
from hairfastgan_torch.utils.save_utils import save_vis_mask
from tests.test_parity_harness import _write_golden as jax_write_golden

torch.set_num_threads(2)
ARGS = type("A", (), dict(tol=0.02, mask_floor=0.98, psnr_floor=30.0))


@pytest.fixture(scope="module")
def runs():
    """(JAX run, port run) of the same tiny zoo on the same images."""
    from hairfastgan_tpu.pipeline import hair_fast
    from hairfastgan_tpu.zoo import init_tiny_zoo

    zoo, jcfg = init_tiny_zoo(jax.random.PRNGKey(0))
    size = jcfg.stylegan.size
    rng = np.random.RandomState(0)
    imgs = [rng.rand(1, size, size, 3).astype(np.float32) for _ in range(3)]
    fn = jax.jit(lambda z, f, s, c: hair_fast(z, f, s, c, case="distinct", cfg=jcfg,
                                              return_intermediate=True))
    jfinal, jinter = fn(zoo, *map(jax.numpy.asarray, imgs))
    jrun = np.asarray(jfinal), {k: np.asarray(v) for k, v in jinter.items()}
    cfg = HairFastConfig(stylegan=StyleGANConfig(size=size, max_channels=512))
    assert cfg.stylegan == StyleGANConfig(**vars(jcfg.stylegan))
    trun = run_pipeline(bridge_zoo(zoo), [torch.from_numpy(x) for x in imgs], cfg)
    return jrun, trun


def test_compare_run_self_consistent(runs, tmp_path):
    _, (final, inter) = runs
    chip_smoke.write_golden(tmp_path, final, inter)
    rep = Report()
    compare_run(inter, final, tmp_path, ARGS, "zero", rep)
    assert rep.failures == []


def test_compare_run_detects_regression(runs, tmp_path):
    """A corrupted stage must be reported, and exactly that stage."""
    _, (final, inter) = runs
    chip_smoke.write_golden(tmp_path, final, inter)
    rep = Report()
    compare_run(dict(inter, S_blend=inter["S_blend"] + 1.0), final, tmp_path, ARGS, "zero", rep)
    assert rep.failures == ["zero:S_blend"]
    az = tmp_path / "Align" / "face_shape_F.npz"
    with np.load(az) as z:
        np.savez(az, latent_F_align=z["latent_F_align"] * 1.1)
    rep = Report()
    compare_run(inter, final, tmp_path, ARGS, "zero", rep)
    assert rep.failures == ["zero:latent_F_align"]


def test_vis_mask_decode_roundtrip(tmp_path):
    lab = np.random.RandomState(1).randint(0, 19, (64, 64))
    save_vis_mask(tmp_path, "Shape", "m.png", lab)
    np.testing.assert_array_equal(decode_vis_mask(tmp_path / "Shape" / "m.png"), lab)
    # a golden mask at another size is compared after a nearest resize
    np.testing.assert_array_equal(resize_labels(lab, (32, 32)), lab[::2, ::2])


def test_jax_golden_passes_port_run(runs, tmp_path):
    """The golden written by the JAX test's writer from the JAX run passes
    the port's harness on the port's run; and the two writers agree on
    the same run."""
    (jfinal, jinter), (final, inter) = runs
    jax_write_golden(tmp_path / "jax", jfinal, jinter)
    rep = Report()
    compare_run(inter, final, tmp_path / "jax", ARGS, "zero", rep)
    assert rep.failures == []
    chip_smoke.write_golden(tmp_path / "port", jfinal, jinter)
    for p in sorted((tmp_path / "jax").rglob("*.npz")):
        q = tmp_path / "port" / p.relative_to(tmp_path / "jax")
        with np.load(p) as a, np.load(q) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    for p in sorted((tmp_path / "jax").rglob("*.png")):
        q = tmp_path / "port" / p.relative_to(tmp_path / "jax")
        assert p.read_bytes() == q.read_bytes(), p
