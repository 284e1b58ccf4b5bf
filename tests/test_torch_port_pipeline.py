"""The port's slice end to end on the CPU: `hair_fast(case="distinct")`
against the committed JAX golden, every dedup case, and the HairFast API.

The golden (tests/golden/dryrun_pipeline_golden.npz, "ref_b8") is the JAX
package's hair_fast on the micro zoo (`init_micro_zoo_fast(0)`) over the
triples `__graft_entry__._pipeline_setup` draws from PRNGKey(2). Batch
elements are independent, so the first k triples are compared. Tolerance
1e-4 absolute on the [0,1] image: far above the f32 drift of the chained
stages (the two agree to the last bit on this host) and below the ~1e-3
by which the micro pipeline's output moves between different inputs.
NOTE: with the micro zoo's flat 0.05 weights the final image is dominated
by the last ToRGB biases (perturbing the blending, e4e, SEAN or BiSeNet
weights moves it by less than 1e-5), so this test holds the composition
(shapes, dtypes, control flow, layouts); the numerics of each model are
held by tests/test_torch_port_models.py and those of each stage by
tests/test_torch_port_stages.py, on signal-carrying weights.
"""

import numpy as np
import pytest
import torch

from hairfastgan_tpu.config import HairFastConfig
from hairfastgan_tpu.zoo import init_micro_zoo_fast
from hairfastgan_torch.api import HairFast
from hairfastgan_torch.params.bridge import bridge_zoo
from hairfastgan_torch.pipeline.swap import CASES, hair_fast, swap_cases
from tests.torch_port_util import graft_triples, lively

torch.set_num_threads(2)
GOLDEN = "tests/golden/dryrun_pipeline_golden.npz"
K = 2


@pytest.fixture(scope="module")
def micro_jax():
    return init_micro_zoo_fast(0)


@pytest.fixture(scope="module")
def micro(micro_jax):
    """The golden's zoo, bridged."""
    jz, cfg = micro_jax
    return bridge_zoo(jz), cfg


@pytest.fixture(scope="module")
def live(micro_jax):
    """The micro zoo with signals carrying through (noise reaches the image)."""
    jz, cfg = micro_jax
    return bridge_zoo(lively(jz)), cfg


@pytest.fixture(scope="module")
def triples(micro):
    """__graft_entry__._pipeline_setup's inputs (8 triples; the first K)."""
    return [x[:K] for x in graft_triples(micro[1].stylegan.size)]


def test_hair_fast_distinct_matches_jax_golden(micro, triples):
    zoo, cfg = micro
    with np.load(GOLDEN) as g:
        assert int(g["size"]) == cfg.stylegan.size
        ref = g["ref_b8"][:K]
    with torch.inference_mode():
        out = hair_fast(zoo, *(torch.from_numpy(x) for x in triples), case="distinct",
                        cfg=cfg).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_hair_fast_cases(live, triples, case):
    zoo, cfg = live
    face, shape, color = (torch.from_numpy(x[:1]) for x in triples)
    shape = face if case in ("face_eq_shape", "same") else shape
    color = {"shape_eq_color": shape, "face_eq_color": face, "same": face}.get(case, color)
    assert swap_cases(face, shape, color) == case
    with torch.inference_mode():
        out = hair_fast(zoo, face, shape, color, case=case, cfg=cfg)
    assert out.shape == (1, 128, 128, 3)
    assert torch.isfinite(out).all() and out.min() >= 0 and out.max() <= 1


def test_api_swap(live):
    zoo, cfg = live
    hf = HairFast(cfg, zoo=zoo, device="cpu")
    rng = np.random.default_rng(30)
    imgs = [rng.integers(0, 256, (128, 128, 3), dtype=np.uint8) for _ in range(3)]
    out = hf.swap(*imgs, seed=1)
    assert out.shape == (128, 128, 3) and out.dtype == np.float32
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
    np.testing.assert_array_equal(out, hf.swap(*imgs, seed=1))  # seeded noise
    assert not np.array_equal(out, hf.swap(*imgs, seed=2))      # fresh noise flows


def test_api_bf16(live):
    """compute_dtype=bfloat16 casts the zoo and computes the slice in bf16."""
    zoo, cfg = live
    cfg16 = HairFastConfig(stylegan=cfg.stylegan, compute_dtype="bfloat16")
    hf = HairFast(cfg16, zoo=zoo, device="cpu")
    assert hf.zoo["generator"]["input"].dtype == torch.bfloat16
    img = np.random.default_rng(31).integers(0, 256, (128, 128, 3), dtype=np.uint8)
    out = hf.swap_tensor(img, img[::-1].copy(), img[:, ::-1].copy())
    assert out.dtype == torch.bfloat16 and out.shape == (128, 128, 3)
    assert torch.isfinite(out.float()).all()
