"""The port's InceptionV3 (hairfastgan_torch/models/inception.py) and its
classic-FID feature function (eval/fid.inception_feature_fn) against the
JAX package's, f32, CPU.

One numpy weight set in the JAX layout (He-scaled convs and perturbed
BatchNorm statistics, so that the features vary with the input) goes to
both packages, bridged for the port (params/bridge.bridge_zoo).
Tolerance: 1e-4 of the reference's largest |value|; converters exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairfastgan_tpu.eval import fid as jfid
from hairfastgan_tpu.models import inception as jinc
from hairfastgan_torch.eval import fid as tfid
from hairfastgan_torch.models import inception as tinc
from hairfastgan_torch.params.bridge import bridge_zoo
from tests.test_convert_plumbing import synth_inception_state_dict
from tests.test_torch_port_convert import assert_same_tree
from tests.test_torch_port_zoo import flat, port_shapes
from tests.torch_port_util import close

torch.set_num_threads(2)
REL = 1e-4


def he_fill(shapes, seed: int):
    """JAX-layout tree of numpy arrays: conv weights N(0, 2/fan_in), BN
    gamma 1 + 0.1 N, beta / mean 0.1 N, var 1 + 0.1 |N|."""
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        key, shape = path[-1].key, leaf.shape
        n = rng.standard_normal(shape).astype(np.float32)
        if key == "w":
            return n * np.float32(np.sqrt(2.0 / np.prod(shape[:3])))
        return {"gamma": 1 + 0.1 * n, "beta": 0.1 * n, "mean": 0.1 * n,
                "var": 1 + 0.1 * np.abs(n)}[key].astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)


@pytest.fixture(scope="module")
def weights():
    shapes = jax.eval_shape(lambda: jinc.init_inception(jax.random.PRNGKey(0)))
    jp = he_fill(shapes, 4)
    return jax.tree.map(jnp.asarray, jp), bridge_zoo(jp)


def _images(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def test_init_inception_shapes_match_jax():
    """init_inception's tree is the JAX init's in the port's layout, and
    its random features vary with the input."""
    jtree = jax.eval_shape(lambda: jinc.init_inception(jax.random.PRNGKey(0)))
    p = tinc.init_inception(0)
    got = {k: tuple(v.shape) for k, v in flat(p).items()}
    assert got == port_shapes(jtree)
    f = tinc.inception_features(p, torch.from_numpy(_images(1, (2, 48, 48, 3)))).numpy()
    assert f.shape == (2, 2048) and np.isfinite(f).all()
    assert np.abs(f[0] - f[1]).max() > 1e-3 * np.abs(f).max()


def test_inception_features_match_jax(weights):
    """B=2 64^2 inputs, resized to 299^2 inside, to [B,2048] pool3 features."""
    jp, tp = weights
    x = _images(2, (2, 64, 64, 3))
    ref = np.asarray(jax.jit(jinc.inception_features)(jp, jnp.asarray(x)))
    got = tinc.inception_features(tp, torch.from_numpy(x)).numpy()
    assert ref.shape == got.shape == (2, 2048)
    close(got, ref, REL)
    # a swapped pair of the asymmetric convs keeps every shape: the features
    # must still tell two images apart by far more than the tolerance
    assert np.abs(ref[0] - ref[1]).max() > 100 * REL * np.abs(ref).max()


BLOCKS = {"a": ("a1", (1, 8, 8, 192), 256), "b": ("b", (1, 9, 9, 288), 768),
          "c": ("c1", (1, 8, 8, 768), 768), "d": ("d", (1, 9, 9, 768), 1280),
          "e": ("e1", (1, 8, 8, 1280), 2048)}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_inception_blocks_match_jax(weights, kind):
    """Each block at the shapes of test_aux_utils.test_inception_channel_progression."""
    jp, tp = weights
    name, shape, cout = BLOCKS[kind]
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    ref = np.asarray(getattr(jinc, f"_inception_{kind}")(jp[name], jnp.asarray(x)))
    got = getattr(tinc, f"_inception_{kind}")(tp[name], torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape[-1] == cout
    close(got, ref, REL)


def test_convert_inception_matches_jax():
    """A synthetic torchvision inception_v3 state dict: the port's converter
    equals the JAX converter bridged, leaf for leaf."""
    sd = synth_inception_state_dict()
    assert_same_tree(tinc.convert_inception(sd), bridge_zoo(jinc.convert_inception(sd)))


def test_inception_feature_fn_matches_jax(weights):
    jp, tp = weights
    x = _images(6, (3, 40, 40, 3))
    ref = jfid.inception_feature_fn(jp)(x)
    got = tfid.inception_feature_fn(tp)(x)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == (3, 2048)
    close(got, ref, REL)
