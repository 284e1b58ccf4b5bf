"""The port's Poisson composite (ops/poisson.py, pipeline/composite.py)
against the JAX package's, f32 on the CPU.

Inputs come from numpy seeds (and the graft triples); weights are the micro
zoo passed through torch_port_util.lively and bridged. The micro BiSeNet
labels no hair on these images, so `hair_prone` scales its head's hair
logit by 2.5: about 1% of the pixels of each image parse as hair, and their
union dilated 30 times covers ~74% of the 128^2 mask, neither empty nor full.

Tolerances: the Jacobi solves within 1e-5 absolute on [0,1] images (the same
f32 sweeps, summed in the same order); labels and binary masks exactly; the
composite within 2e-4 of scale, as the model parities
(tests/test_torch_port_models.py), for the BiSeNet parse inside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairfastgan_tpu.ops import poisson as jpo
from hairfastgan_tpu.ops.pallas_morphology import dilate_erode_pallas
from hairfastgan_tpu.pipeline import composite as jco
from hairfastgan_tpu.zoo import init_micro_zoo_fast
from hairfastgan_torch.ops import morphology as tmo
from hairfastgan_torch.ops import poisson as tpo
from hairfastgan_torch.params.bridge import bridge_zoo
from hairfastgan_torch.pipeline import composite as tco
from tests.torch_port_util import close, graft_triples, lively

torch.set_num_threads(2)
RAW_HAIR = 17  # bisenet.FACE_PARSING_TO_CELEBA[CELEBA_HAIR]


def hair_prone(jz):
    """The lively micro zoo with BiSeNet's raw hair logit scaled by 2.5."""
    jz = jax.tree.map(np.array, lively(jz))
    jz["bisenet"]["head"]["out"]["w"][..., RAW_HAIR] *= 2.5
    return jz


@pytest.fixture(scope="module")
def zoos():
    jz = hair_prone(init_micro_zoo_fast(0)[0])
    return jz, bridge_zoo(jz)


@pytest.fixture(scope="module")
def images():
    """(final, face): the first graft triple's face and shape images."""
    f, s, _ = graft_triples(128)
    return f[:1], s[:1]


def blend_inputs(size: int = 64):
    rng = np.random.default_rng(21)
    src, dst = (rng.random((2, size, size, 3), dtype=np.float32) for _ in range(2))
    yy, xx = np.mgrid[:size, :size]
    mask = ((yy - size / 2) ** 2 + (xx - size / 3) ** 2 < (size / 4) ** 2).astype(np.float32)
    return src, dst, np.broadcast_to(mask[None, ..., None], (2, size, size, 1)).copy()


@pytest.mark.parametrize("solver", ["poisson_blend", "poisson_blend_multigrid"])
def test_poisson_blend(solver):
    src, dst, mask = blend_inputs()
    kw = {"poisson_blend": {"n_iters": 100}, "poisson_blend_multigrid": {"n_iters": 40}}[solver]
    ref = np.asarray(jax.jit(lambda a, b, m: getattr(jpo, solver)(a, b, m, **kw))(src, dst, mask))
    got = getattr(tpo, solver)(*(torch.from_numpy(x) for x in (src, dst, mask)), **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    outside = mask[..., 0] == 0  # the boundary keeps dst, the inside moved off it
    np.testing.assert_array_equal(got[outside], np.clip(dst, 0, 1)[outside])
    assert np.abs(got - dst).max() > 0.05


def test_hair_union_mask(zoos, images):
    jz, tz = zoos
    ref = np.asarray(jax.jit(jco.hair_union_mask)(jz, *images))
    got = tco.hair_union_mask(tz, *(torch.from_numpy(x) for x in images))
    assert got.dtype == torch.float32 and got.shape == (1, 128, 128, 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0.05 < ref.mean() < 0.95  # neither empty nor full


def test_dilate_erode_composite_shape():
    """The composite's 30 iterations: the plain version == the Pallas kernel
    (interpret mode), exactly."""
    rng = np.random.default_rng(5)
    m = (rng.random((1, 128, 128, 1)) > 0.9995).astype(np.float32)
    m[0, 20:110, 15:120] = 1  # a block that 30 erosions leave a core of
    d, e = tmo.dilate_erode_reference(torch.from_numpy(m), 30)
    d_p, e_p = dilate_erode_pallas(jnp.asarray(m), 30, interpret=True)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_p))
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_p))
    assert 0 < d.mean() < 1 and 0 < e.mean() < m.mean()


def test_poisson_composite(zoos, images):
    jz, tz = zoos
    ref = np.asarray(jax.jit(jco.poisson_composite)(jz, *images))
    got = tco.poisson_composite(tz, *(torch.from_numpy(x) for x in images)).numpy()
    close(got, ref)
    assert not np.allclose(got, images[0], atol=1e-3)  # the face came back in
