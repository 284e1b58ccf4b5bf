"""The port's PostProcess losses and discriminator (hairfastgan_torch/losses/
{objectives,perceptual}.py, models/stylegan2_discriminator.py,
params/convert.convert_discriminator, params/nvlabs.py, the `down` form of
ops/modconv) against the JAX package's, f32, CPU.

JAX functions take NHWC/HWIO, the port's losses NCHW/OIHW; weights are the
JAX trees numpy-filled and bridged (params/bridge.bridge_zoo). Tolerances,
as in tests/test_torch_port_train.py: losses 1e-5 relative, gradients 1e-4
of the largest |grad|, models 2e-4 of the output scale, converters exact.
"""

import math
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairfastgan_tpu.config import StyleGANConfig as JSG
from hairfastgan_tpu.losses import objectives as jobj
from hairfastgan_tpu.losses import perceptual as jper
from hairfastgan_tpu.models import stylegan2_discriminator as jdisc
from hairfastgan_tpu.ops import modconv as jmc
from hairfastgan_tpu.params import convert as JC
from hairfastgan_tpu.params import nvlabs as jnv
from hairfastgan_torch import zoo as tzoo
from hairfastgan_torch.config import StyleGANConfig
from hairfastgan_torch.losses import objectives as tobj
from hairfastgan_torch.losses import perceptual as tper
from hairfastgan_torch.models import stylegan2_discriminator as tdisc
from hairfastgan_torch.ops import modconv as tmc
from hairfastgan_torch.params import convert as TC
from hairfastgan_torch.params import nvlabs as tnv
from hairfastgan_torch.params.bridge import bridge_zoo, map_tree
from tests.test_nvlabs_loader import _rosinality_to_nvlabs_pickle
from tests.test_torch_port_convert import assert_same_tree
from tests.test_torch_port_train import jfill
from tests.torch_port_util import close

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
LOSS_REL = 1e-5
GRAD_REL = 1e-4
DSIZE = 64
JDCFG = JSG(size=DSIZE, max_channels=64)
TDCFG = StyleGANConfig(size=DSIZE, max_channels=64)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def rel_close(got, ref, rel=LOSS_REL):
    got, ref = float(got), float(ref)
    assert abs(got - ref) <= rel * abs(ref), (got, ref)


def grad_close(got, ref, rel=GRAD_REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert scale > 0
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (err, scale)


def normal_fill(init, seed, bias_std=0.1):
    """A JAX init tree's shapes filled N(0,1) (weights, as the JAX init
    draws them) and N(0, bias_std) (biases) from a numpy seed."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        std = 1.0 if getattr(path[-1], "key", None) == "w" else bias_std
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init))


def port_input_grad(fn, x):
    """(fn(x), d sum(fn(x)) / dx) of a port function, x a numpy NHWC array fed
    as NCHW; the gradient comes back NHWC."""
    t = nchw(x).requires_grad_(True)
    y = fn(t)
    (g,) = torch.autograd.grad(y.sum(), t)
    return y.detach(), nhwc(g)


# --- objectives ---------------------------------------------------------------

def test_adv_losses_and_feat_recon():
    rng = np.random.default_rng(0)
    r, f = rng.standard_normal((4, 1)).astype(np.float32), rng.standard_normal((4, 1)).astype(
        np.float32)
    rel_close(tobj.adv_g_loss(torch.from_numpy(f)), jobj.adv_g_loss(f))
    rel_close(tobj.adv_d_loss(torch.from_numpy(r), torch.from_numpy(f)), jobj.adv_d_loss(r, f))
    a, b = (rng.standard_normal((2, 16, 16, 8)).astype(np.float32) for _ in range(2))
    rel_close(tobj.feat_recon_loss(nchw(a), nchw(b)), jobj.feat_recon_loss(a, b))


def test_dice_loss_and_grad():
    """Focal dice over the class axis: dim 1 of the port's NCHW logits,
    the last axis of the JAX package's NHWC ones."""
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((2, 12, 12, 16)).astype(np.float32) * 2 for _ in range(2))
    ref, ref_g = jax.value_and_grad(jobj.dice_loss)(jnp.asarray(a), jnp.asarray(b))
    got, got_g = port_input_grad(lambda t: tobj.dice_loss(t, nchw(b)), a)
    rel_close(got, ref)
    grad_close(got_g, ref_g)


def test_dilated_mask():
    rng = np.random.default_rng(2)
    m = (rng.random((2, 64, 64, 1)) > 0.7).astype(np.float32)
    m[1] = 0.0  # an all-zero mask: its root must be 0, not NaN
    np.testing.assert_array_equal(tobj._disc_kernel(25), jobj._disc_kernel(25))
    got = tobj.dilated_mask(nchw(m), 25)
    ref = np.asarray(jobj.dilated_mask(jnp.asarray(m), 25))
    assert np.isfinite(nhwc(got)).all() and float(got[1].abs().max()) == 0.0
    close(nhwc(got), ref)


def test_r1_penalty_value():
    """coef/2 * E||grad_x D||^2 * 16 through each package's discriminator,
    one first-order gradient with respect to the real batch."""
    jp = normal_fill(lambda: jdisc.init_discriminator(KEY, JDCFG), 3)
    real = np.random.default_rng(4).standard_normal((4, DSIZE, DSIZE, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: jobj.r1_penalty(jdisc.discriminator, p, x))(jp, jnp.asarray(real))
    got = tobj.r1_penalty(tdisc.discriminator, bridge_zoo(jp), torch.from_numpy(real))
    assert not got.requires_grad
    rel_close(got, ref)


# --- perceptual ---------------------------------------------------------------

@pytest.fixture(scope="module")
def lpips_params():
    return jfill(lambda: jper.init_lpips_alex(KEY), 5)


def test_max_pool_and_unit_normalize():
    from hairfastgan_tpu.ops import basic as jb
    from hairfastgan_torch.ops import basic as tb

    x = np.random.default_rng(6).standard_normal((2, 15, 15, 4)).astype(np.float32)
    np.testing.assert_array_equal(nhwc(tb.max_pool(nchw(x), 3, 2)),
                                  np.asarray(jb.max_pool(jnp.asarray(x), 3, 2)))
    np.testing.assert_array_equal(nhwc(tb.relu(nchw(x))), np.asarray(jb.relu(jnp.asarray(x))))
    x[0, 3, 4] = 0.0  # a zero feature vector: eps on the norm keeps it 0
    close(nhwc(tper._unit_normalize(nchw(x))), np.asarray(jper._unit_normalize(jnp.asarray(x))))


@pytest.mark.parametrize("fn", ["lpips", "lpips_scale"])
def test_lpips_and_grad(lpips_params, fn):
    rng = np.random.default_rng(7)
    x = np.repeat(np.repeat(rng.uniform(-1, 1, (2, 16, 16, 3)), 8, 1), 8, 2).astype(np.float32)
    y = np.clip(x + rng.standard_normal(x.shape).astype(np.float32) * 0.2, -1, 1)
    jfn, tfn = getattr(jper, fn), getattr(tper, fn)
    ref, ref_g = jax.jit(jax.value_and_grad(lambda a: jfn(lpips_params, jnp.asarray(y), a)))(
        jnp.asarray(x))
    tp = bridge_zoo(lpips_params)
    got, got_g = port_input_grad(lambda t: tfn(tp, nchw(y), t), x)
    rel_close(got, ref)
    grad_close(got_g, ref_g)


def test_convert_lpips_alex():
    rng = np.random.default_rng(8)
    alex = {}
    cin = 3
    for name, (k, _, _, cout) in zip(("0", "3", "6", "8", "10"), jper._ALEX_CONVS):
        alex[f"{name}.weight"] = rng.standard_normal((cout, cin, k, k)).astype(np.float32)
        alex[f"{name}.bias"] = rng.standard_normal(cout).astype(np.float32)
        cin = cout
    for lin_key in ("{i}.1", "lin{i}.model.1"):  # both lpips checkpoint layouts
        lin = {lin_key.format(i=i) + ".weight": rng.standard_normal((1, c, 1, 1)).astype(
            np.float32) for i, c in enumerate(jper._ALEX_LIN_CH)}
        got = tper.convert_lpips_alex(alex, lin)
        assert_same_tree(got, bridge_zoo(jper.convert_lpips_alex(alex, lin)))
        assert len(got["lins"]) == 5


# --- discriminator ------------------------------------------------------------

@pytest.fixture(scope="module")
def disc_params():
    return normal_fill(lambda: jdisc.init_discriminator(KEY, JDCFG), 9)


def test_init_discriminator_shapes(disc_params):
    """The port's shape tree (zoo.init_discriminator) is the JAX init's,
    bridged."""
    got = tzoo.init_discriminator(TDCFG, seed=0)
    ref = bridge_zoo(disc_params)
    flat_got = {k: tuple(v.shape) for k, v in _flat(got)}
    assert flat_got == {k: tuple(v.shape) for k, v in _flat(ref)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("b", [2, 4, 8])
def test_discriminator_and_input_grad(disc_params, b):
    """B=2 and 4: one minibatch-stddev group; B=8: two groups of 4 taken
    B // 4 apart (the JAX reshape order). Each sample gets its own scale so
    that the group statistics differ. Logits in f32, and the gradient with
    respect to the image (what R1 reads) in float64 on both sides: in f32 a
    pre-activation within rounding of 0 may take the other slope of a leaky
    ReLU, which moved one B=8 sample's gradient by 1.2% (port) and another's
    by 0.45% (both packages) off float64 at these weights."""
    rng = np.random.default_rng(10 + b)
    x = (rng.standard_normal((b, DSIZE, DSIZE, 3))
         * rng.uniform(0.2, 2.0, (b, 1, 1, 1))).astype(np.float32)
    tp = bridge_zoo(disc_params)
    got = tdisc.discriminator_nchw(tp, nchw(x))
    assert got.shape == (b, 1)
    close(got.numpy(), np.asarray(jax.jit(jdisc.discriminator)(disc_params, jnp.asarray(x))))
    np.testing.assert_array_equal(tdisc.discriminator(tp, torch.from_numpy(x)).numpy(),
                                  got.numpy())

    x64 = x.astype(np.float64)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), disc_params)
        ref_g = np.asarray(jax.jit(jax.grad(
            lambda a: jnp.sum(jdisc.discriminator(p64, a))))(jnp.asarray(x64)))
    _, got_g = port_input_grad(
        lambda t: tdisc.discriminator_nchw(map_tree(tp, lambda _, v: v.double()), t), x64)
    grad_close(got_g, ref_g)


def test_minibatch_stddev_groups():
    """Sample i of 8 sits in group i // 2's slot i % 2: samples 0, 2, 4, 6
    share one statistic, 1, 3, 5, 7 the other; the variance is the
    population one."""
    x = torch.zeros((8, 2, 3, 3))
    x[1::2] = torch.arange(4.0).view(4, 1, 1, 1)
    y = tdisc.minibatch_stddev(x)
    assert y.shape == (8, 3, 3, 3)
    np.testing.assert_allclose(y[0::2, 2].numpy(), 1e-4, rtol=1e-3)
    np.testing.assert_allclose(y[1::2, 2].numpy(), math.sqrt(1.25 + 1e-8), rtol=1e-6)


def rosinality_sd(rng, size, max_channels=64):
    """A rosinality Discriminator(size, max_channels) state dict of random
    numpy values (the layout tests/test_nvlabs_loader.py builds)."""
    ch = JSG(size=size, max_channels=max_channels).channels
    sd = {}

    def conv(name, cin, cout, k):
        sd[name] = (rng.standard_normal((cout, cin, k, k)) * 0.1).astype(np.float32)

    def vec(name, n):
        sd[name] = (rng.standard_normal(n) * 0.1).astype(np.float32)

    conv("convs.0.0.weight", 3, ch(size), 1)
    vec("convs.0.1.bias", ch(size))
    in_ch = ch(size)
    for j, i in enumerate(range(int(math.log2(size)), 2, -1), start=1):
        out_ch = ch(2 ** (i - 1))
        conv(f"convs.{j}.conv1.0.weight", in_ch, in_ch, 3)
        vec(f"convs.{j}.conv1.1.bias", in_ch)
        conv(f"convs.{j}.conv2.1.weight", in_ch, out_ch, 3)
        vec(f"convs.{j}.conv2.2.bias", out_ch)
        conv(f"convs.{j}.skip.1.weight", in_ch, out_ch, 1)
        in_ch = out_ch
    conv("final_conv.0.weight", ch(4) + 1, ch(4), 3)
    vec("final_conv.1.bias", ch(4))
    sd["final_linear.0.weight"] = (rng.standard_normal((ch(4), ch(4) * 16)) * 0.1).astype(
        np.float32)
    vec("final_linear.0.bias", ch(4))
    sd["final_linear.1.weight"] = (rng.standard_normal((1, ch(4))) * 0.1).astype(np.float32)
    vec("final_linear.1.bias", 1)
    return sd


def test_convert_discriminator():
    sd = rosinality_sd(np.random.default_rng(11), DSIZE)
    got = TC.convert_discriminator(sd, size=DSIZE)
    assert_same_tree(got, bridge_zoo(JC.convert_discriminator(sd, size=DSIZE)))
    x = np.random.default_rng(12).standard_normal((2, DSIZE, DSIZE, 3)).astype(np.float32)
    assert tdisc.discriminator(got, torch.from_numpy(x)).shape == (2, 1)


# --- NVlabs persistence pickles -----------------------------------------------

@pytest.fixture(scope="module")
def nvlabs_pkl(tmp_path_factory):
    """A synthetic ffhq.pkl built as tests/test_nvlabs_loader.py builds one
    (its reconstruction function raises if the loader ever calls it)."""
    sd = rosinality_sd(np.random.default_rng(13), DSIZE)
    path = tmp_path_factory.mktemp("pkl") / "ffhq.pkl"
    path.write_bytes(_rosinality_to_nvlabs_pickle(
        {k: torch.from_numpy(v) for k, v in sd.items()}, DSIZE))
    return path, sd


def test_nvlabs_state_dict_and_converter(nvlabs_pkl):
    path, sd = nvlabs_pkl
    flat = tnv.stub_state_dict(tnv.load_nvlabs_pickle(str(path))["D"])
    ref = jnv.stub_state_dict(jnv.load_nvlabs_pickle(str(path))["D"])
    assert flat.keys() == ref.keys() and f"b{DSIZE // 2}.conv1.resample_filter" in flat
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k])
    got = tnv.convert_nvlabs_discriminator(flat, size=DSIZE)
    assert_same_tree(got, bridge_zoo(jnv.convert_nvlabs_discriminator(ref, size=DSIZE)))
    # the NVlabs layout maps onto the rosinality one exactly
    assert_same_tree(got, TC.convert_discriminator(sd, size=DSIZE))


def test_load_nvlabs_discriminator(nvlabs_pkl):
    path, _ = nvlabs_pkl
    got = tnv.load_nvlabs_discriminator(str(path), size=DSIZE)
    assert_same_tree(got, bridge_zoo(jnv.load_nvlabs_discriminator(str(path), size=DSIZE)))


def test_tf_legacy_pickle_raises(tmp_path):
    """A TF-era pickle (dnnlib.tflib Network entries) is refused with a
    ValueError by both loaders, never reconstructed."""
    mod = types.ModuleType("dnnlib.tflib.network")

    class Network:
        def __init__(self):
            self.state = {"name": "G"}

    Network.__module__, Network.__qualname__ = "dnnlib.tflib.network", "Network"
    mod.Network = Network
    saved = {k: sys.modules.get(k) for k in ("dnnlib.tflib.network",)}
    sys.modules["dnnlib.tflib.network"] = mod
    try:
        blob = pickle.dumps({"G": Network(), "D": Network()}, protocol=2)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    path = tmp_path / "tf.pkl"
    path.write_bytes(blob)
    for loader in (tnv.load_nvlabs_pickle, jnv.load_nvlabs_pickle):
        with pytest.raises(ValueError, match="TF-legacy"):
            loader(str(path))


# --- modulated conv, down form ------------------------------------------------

def test_modulated_conv2d_down():
    rng = np.random.default_rng(14)
    x, style = (rng.standard_normal((2, 16, 16, 6)).astype(np.float32),
                rng.standard_normal((2, 12)).astype(np.float32))
    p = {"w": rng.standard_normal((3, 3, 6, 5)).astype(np.float32),
         "modulation": {"w": rng.standard_normal((12, 6)).astype(np.float32),
                        "b": (1.0 + rng.standard_normal(6) * 0.1).astype(np.float32)}}
    ref = jmc.modulated_conv2d(p, jnp.asarray(x), jnp.asarray(style), down=True)
    got = tmc.modulated_conv2d(bridge_zoo(p), nchw(x), torch.from_numpy(style), down=True)
    assert tuple(got.shape) == (2, 5, 8, 8)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), rtol=1e-4, atol=1e-4)
