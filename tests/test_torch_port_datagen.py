"""The port's training-data generators (hairfastgan_torch/train/datagen.py)
against the JAX package's (hairfastgan_tpu/train/datagen.py, jitted on the
CPU, where dilate_erode_auto takes its XLA twin), f32.

On the micro zoo (`init_micro_zoo_fast(0)` through
tests/torch_port_util.lively) and a 16-class BiSeNet at width 0.25. The
micro BiSeNet labels no hair on these images, so both packages'
embed_images are wrapped to paint a disc of hair into each image's labels
(at a different place per image): without it hair1 and hair3 are empty and
a mask dilated in the wrong place or order would give the right row.

Tolerance: 2e-4 of the reference's largest magnitude for the float rows
(torch_port_util.close, the stage tests' bound for the chained pipeline
stages); binary masks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairfastgan_tpu.models import bisenet as jbis
from hairfastgan_tpu.train import datagen as jdg
from hairfastgan_tpu.zoo import _fill_random, init_micro_zoo_fast
from hairfastgan_torch.ops import morphology as tmorph
from hairfastgan_torch.params.bridge import bridge_zoo
from hairfastgan_torch.train import datagen as tdg
from tests.torch_port_util import close, lively

torch.set_num_threads(2)
MASKS = ("target_mask", "HM_3E", "HM_XE", "HT_E")
CENTERS = ((96, 128), (128, 96), (150, 150))  # hair discs of face, shape, color


def _disc(cy, cx, r=48):
    yy, xx = np.mgrid[:256, :256]
    return (yy - cy) ** 2 + (xx - cx) ** 2 < r * r


def _with_hair(embed, where, as_array, label=13):
    """embed_images with a disc of hair painted into each third's labels."""
    def run(zoo, images, **kw):
        emb = embed(zoo, images, **kw)
        b = images.shape[0] // 3
        discs = np.concatenate([np.broadcast_to(_disc(cy, cx), (b, 256, 256))
                                for cy, cx in CENTERS])
        return {**emb, "mask": where(as_array(discs), label, emb["mask"])}
    return run


@pytest.fixture(scope="module")
def micro():
    jz, cfg = init_micro_zoo_fast(0)
    jz = jax.tree.map(np.array, lively(jz))
    seg16 = jax.tree.map(np.array, lively(_fill_random(jax.eval_shape(
        lambda: jbis.init_bisenet(jax.random.PRNGKey(0), n_classes=16, width=0.25)), 13)))
    rng = np.random.default_rng(14)
    imgs = [rng.random((1, 128, 128, 3), np.float32) for _ in range(3)]
    return jz, bridge_zoo(jz), cfg, seg16, imgs


@pytest.fixture
def painted_hair(monkeypatch):
    monkeypatch.setattr(jdg, "embed_images",
                        _with_hair(jdg.embed_images, jnp.where, jnp.asarray))
    monkeypatch.setattr(tdg, "embed_images",
                        _with_hair(tdg.embed_images, torch.where, torch.from_numpy))


def _rows_close(got, ref):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert tuple(got[k].shape) == v.shape, k
        if k in MASKS:
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        else:
            close(got[k].numpy(), v)


@pytest.mark.parametrize("seg16", [False, True])
def test_generate_blending_sample_matches_jax(micro, painted_hair, monkeypatch, seg16):
    """Every row key against JAX; hair1, hair3 and HM_X go through ONE
    [3b,256,256,1] dilate/erode launch."""
    jz, tz, cfg, jseg, imgs = micro
    ref = jax.jit(lambda z, s, a, b, c: jdg.generate_blending_sample(
        z, a, b, c, cfg, seg16_params=s))(jz, jseg if seg16 else None, *imgs)
    launches = []
    orig = tdg.dilate_erode

    def counted(mask, it):
        launches.append(tuple(mask.shape))
        return orig(mask, it)

    monkeypatch.setattr(tdg, "dilate_erode", counted)
    got = tdg.generate_blending_sample(tz, *map(torch.from_numpy, imgs), cfg,
                                       seg16_params=bridge_zoo(jseg) if seg16 else None)
    assert launches == [(3, 256, 256, 1)]
    _rows_close(got, ref)
    for k in ("HM_3E", "target_mask"):  # the painted hair reaches the masks
        assert 0 < float(got[k].mean()) < 1, k


def test_concatenated_dilate_equals_separate_calls(micro, painted_hair, monkeypatch):
    """The one [3b] launch gives what three separate calls give: the row's
    masks against dilate_erode of hair1, hair3 and HM_X one by one."""
    _, tz, cfg, _, imgs = micro
    seen = {}
    orig = tdg.dilate_erode

    def record(mask, it):
        seen["in"] = mask.clone()
        return orig(mask, it)

    monkeypatch.setattr(tdg, "dilate_erode", record)
    row = tdg.generate_blending_sample(tz, *map(torch.from_numpy, imgs), cfg)
    emb = tdg.embed_images(tz, torch.cat([torch.from_numpy(x) for x in imgs]), cfg=cfg)
    hair1 = (emb["mask"][:1] == cfg.hair_label).float()[..., None]
    hair3 = (emb["mask"][2:] == cfg.hair_label).float()[..., None]
    assert torch.equal(seen["in"][:1], hair1) and torch.equal(seen["in"][1:2], hair3)
    (d1, _), (d3, e3), (dx, ex) = (tmorph.dilate_erode_reference(m, cfg.smooth)
                                   for m in (hair1, hair3, seen["in"][2:]))
    assert torch.equal(row["HM_3E"], e3) and torch.equal(row["HM_XE"], ex)
    assert torch.equal(row["target_mask"], (1 - d1) * (1 - d3) * (1 - dx))


def test_generate_pp_sample_matches_jax(micro, painted_hair):
    jz, tz, cfg, _, imgs = micro
    ref = jax.jit(lambda z, a, b, c: jdg.generate_pp_sample(z, a, b, c, cfg))(jz, *imgs)
    got = tdg.generate_pp_sample(tz, *map(torch.from_numpy, imgs), cfg)
    _rows_close(got, ref)


def test_generate_mask16_matches_jax(micro):
    """(HM_XD, HM_XE) of the 16-class parser on renders in [-1,1]. The
    random parser labels almost no hair, so its head gets a bias on the
    hair class (10) that makes about a third of the pixels hair."""
    _, _, cfg, jseg, _ = micro
    x = np.random.default_rng(15).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    x = np.repeat(np.repeat(x[:, ::16, ::16], 16, 1), 16, 2)  # 16-pixel blocks
    logits = np.asarray(jbis.bisenet_logits(jseg, jbis.to_bisenet_input(
        np.asarray(jax.image.resize((x + 1) / 2, (2, 512, 512, 3), "bicubic")))))
    margin = np.delete(logits, 10, axis=-1).max(-1) - logits[..., 10]
    bias = np.zeros(16, np.float32)
    bias[10] = np.quantile(margin, 0.35)
    jseg = dict(jseg, head=dict(jseg["head"], out=dict(jseg["head"]["out"], b=bias)))
    ref = jax.jit(lambda p, a: jdg.generate_mask16(p, a, cfg.smooth))(jseg, x)
    got = tdg.generate_mask16(bridge_zoo(jseg), torch.from_numpy(x), cfg.smooth)
    assert 0.05 < float(got[1].mean()) and float(got[0].mean()) < 0.95
    for g, r in zip(got, ref):
        assert g.shape == (2, 256, 256, 1)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_generate_rotate_pair_matches_jax(micro):
    jz, tz, cfg, _, imgs = micro
    ref = jax.jit(lambda z, a, b: jdg.generate_rotate_pair(z, a, b, cfg))(jz, imgs[0], imgs[1])
    got = tdg.generate_rotate_pair(tz, *map(torch.from_numpy, imgs[:2]), cfg)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        close(got[k].numpy(), np.asarray(v))
