"""The port's STAR landmark model (models/star.py) and its face-alignment
provider (utils/face_align.py) against the JAX package's, f32 on the CPU.

STAR weights fill the JAX package's `init_star` tree on a small config
(2 stacks of 2-level hourglasses, 8 channels) from a numpy seed, bridged. Tolerances:
landmarks and spreads within 2e-4 of scale, as the model parities
(tests/test_torch_port_models.py); the aligned crops within 1 uint8 step
(the quad moves by float noise, and PIL's resampling rounds each pixel).
"""

import jax
import numpy as np
import pytest
import torch

import hairfastgan_tpu.utils.face_align as jfa
from hairfastgan_tpu.models import star as jstar
from hairfastgan_tpu.zoo import _fill_random
from hairfastgan_torch import zoo as tzoo
from hairfastgan_torch.models import star as tstar
from hairfastgan_torch.params.bridge import bridge_zoo
from hairfastgan_torch.utils import face_align as tfa
from tests.test_torch_port_zoo import flat, port_shapes
from tests.torch_port_util import close, lively

torch.set_num_threads(2)
SMALL = dict(nstack=2, nlevels=2, channels=8)


@pytest.fixture(scope="module")
def small_star():
    """The small STAR's tree numpy-filled (norm gammas shifted to ~1) with
    the fixed E2H weights, as JAX and port parameters."""
    shapes = jax.eval_shape(lambda: jstar.init_star(jax.random.PRNGKey(0), **SMALL))
    jp = jax.tree.map(np.array, lively(_fill_random(shapes, 4)))
    jp["e2h_w"], jp["e2h_b"] = jstar._e2h_matrix(jstar.WFLW_EDGE_INFO, 98, 9)
    return jp, bridge_zoo(jp)


@pytest.fixture(scope="module")
def photo():
    """An in-the-wild-shaped [200,170,3] photo in [0,1]."""
    return np.random.default_rng(8).random((200, 170, 3), dtype=np.float32)


@pytest.mark.parametrize("kw", [{}, SMALL], ids=["wflw_full", "small"])
def test_star_shape_tree(kw):
    """The port's init_star tree has the JAX init_star leaf shapes (port
    layout), and its random fill keeps the fixed E2H weights."""
    jshapes = jax.eval_shape(lambda: jstar.init_star(jax.random.PRNGKey(0), **kw))
    ours = {p: (tuple(v.shape) if isinstance(v, torch.Tensor) else v)
            for p, v in flat(tzoo.fill_random(tstar.init_star(**kw), None)).items()}
    assert ours == port_shapes(jshapes)
    filled = tzoo.init_star(seed=1, **kw)
    ref = jstar._e2h_matrix(jstar.WFLW_EDGE_INFO, 98, 9)
    for k, r in zip(("e2h_w", "e2h_b"), ref):
        np.testing.assert_array_equal(filled[k].numpy(), r)


def test_star_landmarks(small_star):
    jp, tp = small_star
    x = np.random.default_rng(3).random((1, 256, 256, 3), dtype=np.float32) * 2 - 1
    lm_j, sp_j = jax.jit(lambda a: jstar.star_landmarks(jp, a, with_spread=True))(x)
    lm_t, sp_t = tstar.star_landmarks(tp, torch.from_numpy(x), with_spread=True)
    assert lm_t.shape == (1, 98, 2) and sp_t.shape == (1, 98)
    close(lm_t.numpy(), np.asarray(lm_j))
    close(sp_t.numpy(), np.asarray(sp_j))
    kp = tstar.keypoints_256(tp, torch.from_numpy((x + 1) / 2))
    close(kp.numpy(), np.asarray(jstar.keypoints_256(jp, (x + 1) / 2)))


def test_spread_gate_raises(small_star, photo):
    """Random weights give diffuse heatmaps: the spread gate raises."""
    with pytest.raises(tfa.AlignmentError, match="confident"):
        tfa.star_landmark_provider(small_star[1])(photo)


def test_agreement_gate_raises(small_star, photo, monkeypatch):
    """Refine landmarks far from the coarse ones: the agreement gate raises."""
    calls = []

    def fake(p, img, with_spread=False):  # coarse: a small cluster; refine: a far corner
        calls.append(img.shape)
        lm = torch.zeros((1, 98, 2))
        lm[0, :, 0] = torch.linspace(-0.1, 0.1, 98)
        if len(calls) == 2:
            lm += 0.9
        return lm, torch.full((1, 98), 0.1)

    monkeypatch.setattr(tfa, "star_landmarks_nchw", fake)
    with pytest.raises(tfa.AlignmentError, match="disagree"):
        tfa.star_landmark_provider(small_star[1])(photo)
    assert calls == [(1, 3, 256, 256)] * 2


def test_aligned_crop_matches_jax(small_star, photo, monkeypatch):
    """Gate off: the port's align_faces (its STAR provider driving its own
    FFHQ crop) within 1 uint8 step of the JAX package's crop."""
    jp, tp = small_star
    ref = jfa.align_faces([photo], output_size=128, landmark_layout="wflw98",
                          landmark_fn=jfa.star_landmark_provider(jp, check=False))[0]
    orig = tfa.star_landmark_provider
    monkeypatch.setattr(tfa, "star_landmark_provider",
                        lambda p, **kw: orig(p, **dict(kw, check=False)))
    got = tfa.align_faces([photo], output_size=128, star_params=tp)[0]
    assert got.shape == (128, 128, 3)
    step = np.abs(np.rint(got * 255) - np.rint(ref * 255))
    assert step.max() <= 1
    lm_j = jfa.star_landmark_provider(jp, check=False)(photo)
    lm_t = tfa.star_landmark_provider(tp, check=False)(photo)
    np.testing.assert_allclose(lm_t, lm_j, rtol=0, atol=2e-4 * 200)
