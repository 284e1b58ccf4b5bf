"""Model-level parity of the PyTorch port against the JAX package, f32, CPU.

Both sides get the same weights: the JAX micro zoo (`init_micro_zoo_fast(0)`)
or a JAX parameter tree built with `jax.eval_shape` + `zoo._fill_random`
(seconds; the jax.random inits cost minutes), bridged into the port with
params/bridge.bridge_zoo. Inputs are numpy-seeded. JAX functions run under
jit, the port eagerly.

Both zoos pass through tests/torch_port_util.lively first (norm gammas
and modulation biases +1), so signals carry through every model.

Tolerance: 2e-4 of the reference's largest magnitude (`close`). Each model
chains tens of convs, norms and matmuls whose f32 sums the two frameworks
take in different orders; 2e-4 of scale is well above that drift and far
below any layout or semantics error (those move outputs by O(scale)).
Integer labels are compared only where the top-2 logit gap exceeds the
logit tolerance, since a near-tie may flip under that drift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairfastgan_tpu.models import bisenet as jbis
from hairfastgan_tpu.models import clip_vit as jclip
from hairfastgan_tpu.models import e4e as je4e
from hairfastgan_tpu.models import encoders as jenc
from hairfastgan_tpu.models import iresnet as jir
from hairfastgan_tpu.models import sean as jsean
from hairfastgan_tpu.models import shape_adaptor as jsa
from hairfastgan_tpu.models import stylegan2 as jsg
from hairfastgan_tpu.zoo import _fill_random, init_micro_zoo_fast
from hairfastgan_torch.models import bisenet as tbis
from hairfastgan_torch.models import clip_vit as tclip
from hairfastgan_torch.models import e4e as te4e
from hairfastgan_torch.models import encoders as tenc
from hairfastgan_torch.models import iresnet as tir
from hairfastgan_torch.models import sean as tsean
from hairfastgan_torch.models import shape_adaptor as tsa
from hairfastgan_torch.models import stylegan2 as tsg
from hairfastgan_torch.params.bridge import bridge_zoo
from tests.torch_port_util import REL, close, lively

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)


def t(x):
    return torch.from_numpy(np.array(x))  # a writable copy (JAX arrays are read-only)


def filled(init_fn, seed=0):
    """A JAX parameter tree from its shapes, numpy-filled (zoo._fill_random)."""
    return lively(_fill_random(jax.eval_shape(init_fn), seed))


@pytest.fixture(scope="module")
def micro():
    zoo, cfg = init_micro_zoo_fast(0)
    zoo = lively(zoo)
    return zoo, bridge_zoo(zoo), cfg


# --- StyleGAN2 synthesis slices ------------------------------------------------

SLICES = {  # (start, end, layer_in resolution)
    "G3_3": (3, 3, 16), "G0_3": (0, 3, None), "G0_8": (0, 8, None),
    "G4_8": (4, 8, 32), "G5_8": (5, 8, 64),
}


@pytest.mark.parametrize("noise", ["zero", "injected"])
@pytest.mark.parametrize("name", sorted(SLICES))
def test_synthesis_slices(micro, name, noise):
    jz, tz, cfg = micro
    sg = cfg.stylegan
    start, end, res = SLICES[name]
    rng = np.random.default_rng(10)
    latent = rng.standard_normal((2, sg.n_latent, 512), dtype=np.float32)
    layer_in = (None if res is None else
                rng.standard_normal((2, res, res, sg.channels(res)), dtype=np.float32))
    maps = None
    if noise == "injected":
        maps = [rng.standard_normal((2, r, r, 1), dtype=np.float32)
                for r in tsg.noise_resolutions(sg)]

    def jfn(p, lat, li, nz):
        return jsg.synthesis(p, lat, noise=nz, start_layer=start, end_layer=end,
                             layer_in=li, cfg=sg, dtype=jnp.float32)

    j_out, j_rgb = jax.jit(jfn)(jz["generator"], latent, layer_in, maps)
    t_out, t_rgb = tsg.synthesis(tz["generator"], t(latent),
                                 noise=None if maps is None else [t(m) for m in maps],
                                 start_layer=start, end_layer=end,
                                 layer_in=None if layer_in is None else t(layer_in),
                                 cfg=sg, dtype=torch.float32)
    close(t_out.numpy(), j_out)
    close(t_rgb.numpy(), j_rgb)


def test_make_noise_shapes(micro):
    sg = micro[2].stylegan
    g = torch.Generator().manual_seed(0)
    maps = tsg.make_noise(g, sg, batch=2)
    assert [tuple(m.shape) for m in maps] == [(2, 1, r, r) for r in tsg.noise_resolutions(sg)]
    assert [tuple(z.shape) for z in jsg.zero_noise(sg, 2)] == [(2, r, r, 1) for r in
                                                              tsg.noise_resolutions(sg)]


# --- encoders and parsers ------------------------------------------------------

def _image(seed, b=2, size=256):
    return np.random.default_rng(seed).uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("variant", ["micro", "ir_se"])
def test_e4e_encode(micro, variant):
    if variant == "micro":
        jp = micro[0]["e4e"]
    else:  # the full zoo's e4e has squeeze-excitation blocks; micro widths
        jp = filled(lambda: je4e.init_e4e(KEY, n_styles=18, se=True, width=0.25), seed=1)
    x = _image(11, b=1)
    ref = jax.jit(je4e.e4e_encode)(jp, x)
    close(te4e.e4e_encode(bridge_zoo(jp), t(x)).numpy(), ref)


def test_fs_encode(micro):
    jp = micro[0]["fse"]
    x = _image(12, b=2)
    s_ref, (c_ref,) = jax.jit(jir.fs_encode)(jp, x)
    s, (c,) = tir.fs_encode(bridge_zoo(jp), t(x))
    close(s.numpy(), s_ref)
    close(c.numpy(), c_ref)


def test_bisenet(micro):
    jp = micro[0]["bisenet"]
    img01 = np.random.default_rng(13).uniform(0, 1, (1, 512, 512, 3)).astype(np.float32)
    x = np.asarray(jbis.to_bisenet_input(jnp.asarray(img01)))
    logits_ref = np.asarray(jax.jit(jbis.bisenet_logits)(jp, x))
    tp = bridge_zoo(jp)
    close(tbis.bisenet_logits(tp, t(x)).numpy(), logits_ref)

    labels_ref = np.asarray(jax.jit(jbis.segment_256)(jp, img01))
    labels = tbis.segment_256(tp, t(img01)).numpy()
    np.testing.assert_array_equal(tbis.parse_to_celeba(tp, t(img01)).numpy()[:, ::2, ::2],
                                  labels)
    # labels where the (permuted) top-2 gap is clear of the logit drift
    perm = np.asarray(jbis.FACE_PARSING_TO_CELEBA)
    top2 = np.sort(logits_ref[..., perm], axis=-1)[..., -2:]
    gap = (top2[..., 1] - top2[..., 0])[:, ::2, ::2]
    clear = gap > 2 * REL * np.abs(logits_ref).max()
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(labels[clear], labels_ref[clear])


def _labels(seed, b=2):
    """Blocky 19-class label maps (every class present, some large regions)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 19, size=(b, 16, 16))
    return np.repeat(np.repeat(small, 16, axis=1), 16, axis=2).astype(np.int32)


def test_sean(micro):
    jp = micro[0]["sean"]
    img, labels, target = _image(14), _labels(15), _labels(16)
    codes_ref = jax.jit(jsean.sean_encode)(jp, img, labels)
    tp = bridge_zoo(jp)
    codes = tsean.sean_encode(tp, t(img), t(labels))
    close(codes.numpy(), codes_ref)
    # one empty region in sample 0 exercises the mean_codes fallback
    codes_np = np.asarray(codes_ref).copy()
    codes_np[0, 3] = 0.0
    out_ref = jax.jit(jsean.sean_decode)(jp, codes_np, target)
    close(tsean.sean_decode(tp, t(codes_np), t(target)).numpy(), out_ref)


def test_shape_adaptor(micro):
    jp = micro[0]["shape_adaptor"]
    tp = bridge_zoo(jp)
    m1, m2 = _labels(17), _labels(18)
    face_ref = jax.jit(jsa.get_face_code)(jp, m1)
    hair_ref = jax.jit(jsa.get_hair_code)(jp, m2)
    face, hair = tsa.get_face_code(tp, t(m1)), tsa.get_hair_code(tp, t(m2))
    close(face.numpy(), face_ref)
    close(hair.numpy(), hair_ref)
    # decoder logits, then labels where the top-2 gap is clear
    code = np.concatenate([np.asarray(face_ref), np.asarray(hair_ref)], -1)
    hl_ref = np.asarray(jax.jit(jsa.mask_decode)(jp["hair_decoder"], code))
    fl_ref = np.asarray(jax.jit(jsa.mask_decode)(jp["face_decoder"], np.asarray(face_ref)))
    close(tsa.mask_decode(tp["hair_decoder"], t(code)).permute(0, 2, 3, 1).numpy(), hl_ref)
    close(tsa.mask_decode(tp["face_decoder"], face).permute(0, 2, 3, 1).numpy(), fl_ref)
    new_ref = np.asarray(jax.jit(jsa.get_new_shape)(jp, face_ref, hair_ref))
    new = tsa.get_new_shape(tp, t(np.asarray(face_ref)), t(np.asarray(hair_ref))).numpy()
    logit = np.concatenate([fl_ref[..., :13], hl_ref, fl_ref[..., 13:]], -1)
    top2 = np.sort(logit, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * REL * np.abs(logit).max()
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(new[clear], new_ref[clear])


def test_rotate_model(micro):
    jp = micro[0]["rotate"]
    rng = np.random.default_rng(19)
    w_from, w_to = (rng.standard_normal((2, 6, 512), dtype=np.float32) for _ in range(2))
    ref = jax.jit(jenc.rotate_model)(jp, w_from, w_to)
    close(tenc.rotate_model(bridge_zoo(jp), t(w_from), t(w_to)).numpy(), ref)


def test_blending_model(micro):
    jp = micro[0]["blending"]
    rng = np.random.default_rng(20)
    s1, s3 = (rng.standard_normal((2, 12, 512), dtype=np.float32) for _ in range(2))
    face, color = _image(21), _image(22)
    ref = jax.jit(jenc.blending_model)(jp, s1, s3, face, color)
    close(tenc.blending_model(bridge_zoo(jp), t(s1), t(s3), t(face), t(color)).numpy(), ref)


def test_clip_tower(micro):
    jp = micro[0]["blending"]["clip"]
    img01 = np.random.default_rng(25).uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: jclip.clip_encode_image(p, jclip.clip_preprocess(x)))(jp, img01)
    tp = bridge_zoo(jp)
    close(tclip.clip_encode_image(tp, tclip.clip_preprocess(t(img01))).numpy(), ref)


def test_feature_iresnet(micro):
    jp = micro[0]["post_process"]["to_feature"]
    c = jp[0]["bn1"]["gamma"].shape[0]
    x = np.random.default_rng(26).standard_normal((1, 16, 16, c), dtype=np.float32)
    ref = jax.jit(jir.feature_iresnet)(jp, x)
    close(tir.feature_iresnet(bridge_zoo(jp), t(x)).numpy(), ref)


def test_post_process_model(micro):
    jp = micro[0]["post_process"]
    src, tgt = _image(23, b=1), _image(24, b=1)
    s_ref, f_ref = jax.jit(jenc.post_process_model)(jp, src, tgt)
    s, f = tenc.post_process_model(bridge_zoo(jp), t(src), t(tgt))
    close(s.numpy(), s_ref)
    close(f.numpy(), f_ref)
