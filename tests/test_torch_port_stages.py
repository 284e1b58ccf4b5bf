"""Each stage of the port's pipeline against the JAX package's stage, f32, CPU.

On the micro zoo (`init_micro_zoo_fast(0)`) passed through
tests/torch_port_util.lively, so that signals carry through every model, the
JAX stages run under jit on the first of `__graft_entry__._pipeline_setup`'s
triples with zero noise: embed_images on the stacked triple,
shape_module(face, color), align_images(face, shape) and blend_images. Each
port stage gets the JAX stage's inputs, so a fault shows in the stage that
has it. The port's own composition (hair_fast) is held against the chained
JAX stages.

The micro BiSeNet labels no hair on these images, and the micro shape
adaptor's target hair is scattered pixels that five erosions wipe out: with
such masks a stage that dilates, erodes or lerps the wrong mask gives the
right answer. So the stage inputs carry discs of hair painted into their
labels, and align_images is also run with a target hair mask that is a solid
disc.

Tolerance: 2e-4 of the reference's largest magnitude (torch_port_util.close),
as in tests/test_torch_port_models.py: above the f32 drift of tens of chained
convs summed in another order, far below the O(scale) error of a wrong lerp,
mask choice or layout. Integer labels and binary masks are compared exactly,
the shape adaptor's argmax only where its top-2 logit gap is clear.
"""

import jax
import numpy as np
import pytest
import torch

from hairfastgan_tpu.pipeline import alignment as jal
from hairfastgan_tpu.pipeline import blending as jbl
from hairfastgan_tpu.pipeline import embedding as jem
from hairfastgan_tpu.zoo import init_micro_zoo_fast
from hairfastgan_torch.models import shape_adaptor as tsa
from hairfastgan_torch.params.bridge import bridge_zoo
from hairfastgan_torch.pipeline import alignment as tal
from hairfastgan_torch.pipeline import blending as tbl
from hairfastgan_torch.pipeline import embedding as tem
from hairfastgan_torch.pipeline.swap import hair_fast
from tests.torch_port_util import REL, close, graft_triples, lively

torch.set_num_threads(2)


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def painted(labels, cy, cx, label, r=48):
    """Labels with a disc of `label` painted in."""
    yy, xx = np.mgrid[:256, :256]
    labels = np.array(labels)
    labels[:, (yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = label
    return labels


def with_hair(emb, cy, cx, label):
    """The embedding with a disc of hair in its labels."""
    return {**emb, "mask": painted(emb["mask"], cy, cx, label)}


def with_target_hair(sm, label):
    """A shape-module result whose target mask holds a solid disc of hair."""
    target = painted(sm["target_mask"], 112, 112, label, r=56)
    return {**sm, "target_mask": target,
            "HM_X": (target == label).astype(np.float32)[..., None]}


@pytest.fixture(scope="module")
def zoos():
    jz, cfg = init_micro_zoo_fast(0)
    jz = lively(jz)
    return jz, bridge_zoo(jz), cfg


@pytest.fixture(scope="module")
def jax_stages(zoos):
    """The JAX stages, jitted one by one: chained as hair_fast chains them
    ('final'), and again on embeddings with hair painted in (the inputs of
    the stage tests)."""
    jz, _, cfg = zoos
    triple = [x[:1] for x in graft_triples(cfg.stylegan.size)]
    emb = jax.jit(lambda z, x: jem.embed_images(z, x, mix=True, cfg=cfg))(
        jz, np.concatenate(triple))
    sm = jax.jit(lambda z, a, b: jal.shape_module(z, a, b, cfg=cfg))
    # align_images(sm=shape_module(a, b)) is align_images(a, b); one compile
    align = jax.jit(lambda z, a, b, m: jal.align_images(z, a, b, cfg=cfg, sm=m))
    blend = jax.jit(lambda z, a, c, f, e: jbl.blend_images(z, a, c, f, e, cfg=cfg,
                                                           return_intermediate=True))
    e = [{k: v[i:i + 1] for k, v in emb.items()} for i in range(3)]
    final, _ = blend(jz, align(jz, e[0], e[1], sm(jz, e[0], e[1])), sm(jz, e[0], e[2]),
                     e[0], e[2])

    e_face, e_shape, e_color = (with_hair(x, cy, cx, cfg.hair_label) for x, (cy, cx)
                                in zip(e, ((96, 128), (128, 96), (150, 150))))
    sm_shape = sm(jz, e_face, e_shape)
    sm_target = with_target_hair(sm_shape, cfg.hair_label)
    s = {"triple": triple, "emb": emb, "final": final,
         "e_face": e_face, "e_shape": e_shape, "e_color": e_color,
         "sm_color": sm(jz, e_face, e_color), "sm_target": sm_target,
         "align": align(jz, e_face, e_shape, sm_shape),
         "align_target": align(jz, e_face, e_shape, sm_target)}
    s["blend"], s["blend_inter"] = blend(jz, s["align"], s["sm_color"], e_face, e_color)
    return s


def test_stage_embed_matches_jax(zoos, jax_stages):
    _, zoo, cfg = zoos
    ref = jax_stages["emb"]
    with torch.inference_mode():
        got = tem.embed_images(zoo, torch.from_numpy(np.concatenate(jax_stages["triple"])),
                               mix=True, cfg=cfg)
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["mask"].numpy(), ref["mask"])
    for k in ("W", "F", "S", "image_256", "image_norm_256"):
        close(got[k].numpy(), ref[k])


def test_stage_shape_module_matches_jax(zoos, jax_stages):
    _, zoo, cfg = zoos
    ref = jax_stages["sm_color"]
    with torch.inference_mode():
        got = tal.shape_module(zoo, to_torch(jax_stages["e_face"]),
                               to_torch(jax_stages["e_color"]), cfg=cfg)
    assert sorted(got) == sorted(ref)
    for k in ("rot_mask", "hair_mask1", "hair_mask2"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    # the target labels are an argmax of the adaptor's logits: compared where
    # the top-2 gap is clear of the logit tolerance (the logits themselves are
    # held by test_torch_port_models.test_shape_adaptor)
    sa = zoo["shape_adaptor"]
    face = tsa.get_face_code(sa, to_torch(jax_stages["e_face"])["mask"])
    hair = tsa.get_hair_code(sa, got["rot_mask"])
    hl = tsa.mask_decode(sa["hair_decoder"], torch.cat([face, hair], dim=-1))
    fl = tsa.mask_decode(sa["face_decoder"], face)
    logit = torch.cat([fl[:, :tsa.HAIR_IDX], hl, fl[:, tsa.HAIR_IDX:]], dim=1)
    top2 = logit.topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 2 * REL * logit.abs().max()).numpy()
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got["target_mask"].numpy()[clear], ref["target_mask"][clear])
    np.testing.assert_array_equal(got["HM_X"].numpy()[..., 0][clear], ref["HM_X"][..., 0][clear])
    for k in ("HM_X", "hair_mask1", "hair_mask2"):  # no mask is trivial
        assert 0 < float(ref[k].mean()) < 1, k


@pytest.mark.parametrize("target", ["shape_module", "solid_hair"])
def test_stage_align_matches_jax(zoos, jax_stages, target, monkeypatch):
    """'shape_module': the stage as it runs. 'solid_hair': its shape module
    replaced, on both sides, by one whose target hair is a solid disc, so
    that each of the three eroded or dilated masks of the F lerps is
    non-empty."""
    _, zoo, cfg = zoos
    ref = jax_stages["align"]
    if target == "solid_hair":
        ref = jax_stages["align_target"]
        sm = to_torch(jax_stages["sm_target"])
        monkeypatch.setattr(tal, "shape_module", lambda *a, **k: sm)
    with torch.inference_mode():
        got = tal.align_images(zoo, to_torch(jax_stages["e_face"]),
                               to_torch(jax_stages["e_shape"]), cfg=cfg)
    np.testing.assert_array_equal(got["HM_X"].numpy(), ref["HM_X"])
    close(got["latent_F_align"].numpy(), ref["latent_F_align"])
    # the soft-mask lerps moved F: the result is neither input's F
    for e in ("e_face", "e_shape"):
        assert np.abs(ref["latent_F_align"] - jax_stages[e]["F"]).max() > 1e-2


def test_stage_blend_matches_jax(zoos, jax_stages, monkeypatch):
    """The final image, and what the stage hands its two generator renders
    (S_blend with F_align, then PostProcess's S_final and F_final): past
    PostProcess the micro image hardly moves with S_blend, so the masks'
    part shows only in S_blend."""
    _, zoo, cfg = zoos
    s = jax_stages
    renders = []

    def spy(p, latent, **kw):
        out = synthesis_nchw(p, latent, **kw)
        renders.append((latent, kw["layer_in"].permute(0, 2, 3, 1), out[1].permute(0, 2, 3, 1)))
        return out

    synthesis_nchw = tbl.stylegan2.synthesis_nchw
    monkeypatch.setattr(tbl.stylegan2, "synthesis_nchw", spy)
    with torch.inference_mode():
        got = tbl.blend_images(zoo, to_torch(s["align"]), to_torch(s["sm_color"]),
                               to_torch(s["e_face"]), to_torch(s["e_color"]), cfg=cfg)
    ref = s["blend_inter"]
    (s_blend, f_align, i_blend), (s_final, f_final, _) = renders
    close(s_blend.numpy(), ref["S_blend"])
    close(f_align.numpy(), s["align"]["latent_F_align"])
    close(i_blend.numpy(), ref["I_blend"])
    close(s_final.numpy(), ref["S_final"])
    close(f_final.numpy(), ref["F_final"])
    close(got.numpy(), s["blend"])


def test_stages_composed_match_jax(zoos, jax_stages):
    """The port's hair_fast('distinct') against the chained JAX stages."""
    _, zoo, cfg = zoos
    with torch.inference_mode():
        got = hair_fast(zoo, *(torch.from_numpy(x) for x in jax_stages["triple"]),
                        case="distinct", cfg=cfg)
    close(got.numpy(), jax_stages["final"])
