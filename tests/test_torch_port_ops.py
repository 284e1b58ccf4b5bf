"""Op-level parity of the PyTorch port (hairfastgan_torch/ops) against the
JAX package's ops, in f32 on the CPU.

Inputs come from numpy seeds; JAX ops take NHWC/HWIO, the port NCHW/OIHW,
so inputs and weights are transposed here and outputs compared in NHWC.
Tolerance: 1e-4 abs+rel for ops with sums (conv, matmul resize, norms);
the two frameworks accumulate in different orders in f32. Morphology is
binary and compared exactly.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hairfastgan_tpu.ops import basic as jb
from hairfastgan_tpu.ops import equalized as jeq
from hairfastgan_tpu.ops import fused_act as jfa
from hairfastgan_tpu.ops import modconv as jmc
from hairfastgan_tpu.ops import morphology as jmo
from hairfastgan_tpu.ops import resample as jrs
from hairfastgan_tpu.ops import segops as jso
from hairfastgan_tpu.ops.pallas_morphology import dilate_erode_pallas
from hairfastgan_torch.ops import basic as tb
from hairfastgan_torch.ops import equalized as teq
from hairfastgan_torch.ops import fused_act as tfa
from hairfastgan_torch.ops import modconv as tmc
from hairfastgan_torch.ops import morphology as tmo
from hairfastgan_torch.ops import resample as trs
from hairfastgan_torch.ops import segops as tso
from hairfastgan_torch.ops import upfirdn2d as tup
from hairfastgan_torch.params.bridge import bridge_zoo
from tests import torch_golden as tg

torch.set_num_threads(2)
# hairfastgan_tpu.ops re-exports a function named upfirdn2d over the module
jup = importlib.import_module("hairfastgan_tpu.ops.upfirdn2d")
TOL = dict(rtol=1e-4, atol=1e-4)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def randn(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


# --- basic -----------------------------------------------------------------

CONV_CASES = {
    "3x3_pad1": dict(k=3, stride=1, padding=1),
    "3x3_s2": dict(k=3, stride=2, padding=1),
    "1x1_s2": dict(k=1, stride=2, padding=0),
    "4x4_s2": dict(k=4, stride=2, padding=1),
    "asym_pad": dict(k=3, stride=1, padding=[(0, 2), (1, 0)]),
    "lhs_dil_sean": dict(k=3, stride=1, padding=[(1, 2), (1, 2)], lhs_dilation=2),
    "lhs_dil_modconv": dict(k=3, stride=1, padding=[(2, 2), (2, 2)], lhs_dilation=2),
    "patch32": dict(k=32, stride=32, padding=0),
}


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_conv2d(name):
    case = dict(CONV_CASES[name])
    k = case.pop("k")
    rng = np.random.default_rng(0)
    size = 64 if k == 32 else 9
    x = randn(rng, 2, size, size, 5)
    w, b = randn(rng, k, k, 5, 7), randn(rng, 7)
    ref = jb.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **case)
    p = bridge_zoo({"w": w, "b": b})
    got = tb.conv2d(nchw(x), p["w"], p["b"], **case)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("op", ["batch_norm", "layer_norm_1", "layer_norm_2", "instance_norm",
                                "prelu", "max_pool", "avg_pool_global", "adaptive_avg_pool"])
def test_basic_ops(op):
    rng = np.random.default_rng(1)
    x = randn(rng, 2, 12, 12, 6)
    c = 6
    if op == "batch_norm":
        p = {"gamma": randn(rng, c), "beta": randn(rng, c), "mean": randn(rng, c),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        ref, got = jb.batch_norm(p, jnp.asarray(x)), tb.batch_norm(bridge_zoo(p), nchw(x))
    elif op == "layer_norm_1":  # affine over the last axis, [B,rows,C] latents
        z = randn(rng, 2, 6, 16)
        g, bt = randn(rng, 16), randn(rng, 16)
        ref = jb.layer_norm(jnp.asarray(z), -1, jnp.asarray(g), jnp.asarray(bt))
        got = tb.layer_norm(torch.from_numpy(z), -1, torch.from_numpy(g), torch.from_numpy(bt))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        return
    elif op == "layer_norm_2":  # affine-free over (rows, C)
        z = randn(rng, 2, 6, 16)
        ref = jb.layer_norm(jnp.asarray(z), (-2, -1))
        got = tb.layer_norm(torch.from_numpy(z), (-2, -1))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        return
    elif op == "instance_norm":
        ref, got = jb.instance_norm(jnp.asarray(x)), tb.instance_norm(nchw(x))
    elif op == "prelu":
        p = {"w": randn(rng, c)}
        ref, got = jb.prelu(p, jnp.asarray(x)), tb.prelu(bridge_zoo(p), nchw(x))
    elif op == "max_pool":
        ref, got = jb.max_pool(jnp.asarray(x), 3, 2, padding=1), F.max_pool2d(nchw(x), 3, 2, 1)
    elif op == "avg_pool_global":
        ref, got = jb.avg_pool_global(jnp.asarray(x)), tb.avg_pool_global(nchw(x))
    else:
        ref = jb.adaptive_avg_pool(jnp.asarray(x), (5, 3))
        got = F.adaptive_avg_pool2d(nchw(x), (5, 3))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


def test_linear():
    rng = np.random.default_rng(2)
    x = randn(rng, 3, 4, 10)
    p = {"w": randn(rng, 10, 7), "b": randn(rng, 7)}
    np.testing.assert_allclose(tb.linear(bridge_zoo(p), torch.from_numpy(x)).numpy(),
                               np.asarray(jb.linear(p, jnp.asarray(x))), **TOL)


# --- resample ---------------------------------------------------------------

@pytest.mark.parametrize("mode,ac,src,dst", [
    ("nearest", False, 16, 7), ("nearest", False, 8, 32),
    ("bilinear", False, 16, 8), ("bilinear", True, 16, 37),
    ("bicubic", False, 256, 32), ("bicubic", False, 24, 40),
])
def test_resize(mode, ac, src, dst):
    rng = np.random.default_rng(3)
    x = randn(rng, 2, src, src, 3)
    np.testing.assert_array_equal(trs.resize_matrix(src, dst, mode, ac),
                                  jrs.resize_matrix(src, dst, mode, ac))
    ref = jrs.resize(jnp.asarray(x), (dst, dst), mode, align_corners=ac)
    got = trs.resize(nchw(x), (dst, dst), mode, align_corners=ac)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("factor", [2, 4])
def test_bicubic_downsample(factor):
    rng = np.random.default_rng(4)
    x = randn(rng, 1, 64, 64, 3)
    np.testing.assert_array_equal(trs.bicubic_downsample_matrix(64, factor),
                                  jrs.bicubic_downsample_matrix(64, factor))
    np.testing.assert_allclose(nhwc(trs.bicubic_downsample(nchw(x), factor)),
                               np.asarray(jrs.bicubic_downsample(jnp.asarray(x), factor)),
                               **TOL)


# --- upfirdn2d, fused act, equalized ------------------------------------------

@pytest.mark.parametrize("op", ["upsample2d", "downsample2d", "blur2d_up_pad", "blur2d_gain"])
def test_upfirdn(op):
    rng = np.random.default_rng(5)
    x = randn(rng, 2, 11, 11, 3)
    if op == "upsample2d":
        ref, got = jup.upsample2d(jnp.asarray(x)), tup.upsample2d(nchw(x))
    elif op == "downsample2d":
        ref, got = jup.downsample2d(jnp.asarray(x)), tup.downsample2d(nchw(x))
    elif op == "blur2d_up_pad":  # the blur after an up-conv (pad (1,1), gain 4)
        ref = jup.blur2d(jnp.asarray(x), (1, 3, 3, 1), pad=(1, 1), gain=4.0)
        got = tup.blur2d(nchw(x), (1, 3, 3, 1), pad=(1, 1), gain=4.0)
    else:
        ref = jup.blur2d(jnp.asarray(x), (1, 3, 3, 1), pad=(2, 1))
        got = tup.blur2d(nchw(x), (1, 3, 3, 1), pad=(2, 1))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("op", ["fused_lrelu_4d", "fused_lrelu_2d", "pixel_norm",
                                "pixel_norm_rows", "equal_linear", "equal_linear_lrelu"])
def test_equalized_and_act(op):
    rng = np.random.default_rng(6)
    if op == "fused_lrelu_4d":
        x, b = randn(rng, 2, 5, 5, 4), randn(rng, 4)
        np.testing.assert_allclose(
            nhwc(tfa.fused_leaky_relu(nchw(x), torch.from_numpy(b))),
            np.asarray(jfa.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b))), **TOL)
        return
    z = randn(rng, 3, 6, 16)
    if op == "fused_lrelu_2d":
        b = randn(rng, 16)
        ref = jfa.fused_leaky_relu(jnp.asarray(z[:, 0]), jnp.asarray(b))
        got = tfa.fused_leaky_relu(torch.from_numpy(z[:, 0]), torch.from_numpy(b))
    elif op == "pixel_norm":
        ref, got = jeq.pixel_norm(jnp.asarray(z)), teq.pixel_norm(torch.from_numpy(z))
    elif op == "pixel_norm_rows":
        ref = jeq.pixel_norm(jnp.asarray(z), axis=1)
        got = teq.pixel_norm(torch.from_numpy(z), dim=1)
    else:
        p = {"w": randn(rng, 16, 8), "b": randn(rng, 8)}
        act = "fused_lrelu" if op == "equal_linear_lrelu" else None
        ref = jeq.equal_linear(p, jnp.asarray(z[:, 0]), lr_mul=0.01, activation=act)
        got = teq.equal_linear(bridge_zoo(p), torch.from_numpy(z[:, 0]), lr_mul=0.01,
                               activation=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# --- modulated conv ----------------------------------------------------------

@pytest.mark.parametrize("form", ["plain", "up", "to_rgb"])
def test_modulated_conv2d(form):
    rng = np.random.default_rng(7)
    k, cin, cout = (1, 6, 3) if form == "to_rgb" else (3, 6, 5)
    x, style = randn(rng, 2, 8, 8, cin), randn(rng, 2, 12)
    p = {"w": randn(rng, k, k, cin, cout),
         "modulation": {"w": randn(rng, 12, cin), "b": 1.0 + randn(rng, cin) * 0.1}}
    demod = form != "to_rgb"
    ref = jmc.modulated_conv2d(p, jnp.asarray(x), jnp.asarray(style), demodulate=demod,
                               up=form == "up")
    got = tmc.modulated_conv2d(bridge_zoo(p), nchw(x), torch.from_numpy(style), demodulate=demod,
                               up=form == "up")
    assert tuple(got.shape[2:]) == ((16, 16) if form == "up" else (8, 8))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


# --- segops -------------------------------------------------------------------

def test_segops():
    rng = np.random.default_rng(8)
    labels = rng.integers(-1, 6, size=(2, 9, 9)).astype(np.int32)  # -1: out of range
    feat = randn(rng, 2, 9, 9, 4)
    oh_j = jso.one_hot_mask(jnp.asarray(labels), 5)
    oh_t = tso.one_hot_mask(torch.from_numpy(labels), 5)
    np.testing.assert_array_equal(nhwc(oh_t), np.asarray(oh_j))
    np.testing.assert_allclose(tso.region_mean(nchw(feat), oh_t).numpy(),
                               np.asarray(jso.region_mean(jnp.asarray(feat), oh_j)), **TOL)


# --- morphology: the plain version and the wrapper's CPU dispatch ---------------

def _masks(kind: str, shape):
    b, h, w, _ = shape
    m = np.zeros(shape, np.float32)
    if kind == "random":
        m = (np.random.default_rng(9).random(shape) > 0.6).astype(np.float32)
    elif kind == "ones":
        m[:] = 1
    elif kind == "pixel":
        m[:, h // 2, w // 3] = 1
    elif kind == "border":
        m[:, 0, :] = 1
        m[:, :, -1] = 1
    return m


@pytest.mark.parametrize("kind", ["random", "zeros", "ones", "pixel", "border"])
@pytest.mark.parametrize("iterations", [1, 5])
def test_dilate_erode(kind, iterations):
    """Plain version == JAX XLA scan == Pallas kernel (interpret mode) ==
    the independent conv-threshold golden, exactly (binary outputs)."""
    m = _masks(kind, (3, 32, 48, 1))
    d_t, e_t = tmo.dilate_erode_reference(torch.from_numpy(m), iterations)
    d_j, e_j = jmo.dilate_erode(jnp.asarray(m), iterations)
    d_p, e_p = dilate_erode_pallas(jnp.asarray(m), iterations, interpret=True)
    d_g, e_g = tg.dilate_erode_torch(nchw(m), iterations)
    for ref in ((d_j, e_j), (d_p, e_p)):
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(e_t.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(nhwc(d_g), d_t.numpy())
    np.testing.assert_array_equal(nhwc(e_g), e_t.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dilate_erode_cpu_dispatch(dtype):
    """A CPU tensor takes the plain version: same result, dtype kept, and
    the kernel's launch counter does not move."""
    m = torch.from_numpy(_masks("random", (2, 16, 16, 1))).to(dtype)
    before = tmo.dilate_erode.launches
    d, e = tmo.dilate_erode(m, 3)
    d_ref, e_ref = tmo.dilate_erode_reference(m, 3)
    assert tmo.dilate_erode.launches == before == 0
    assert d.dtype == e.dtype == dtype
    assert torch.equal(d, d_ref) and torch.equal(e, e_ref)


def test_dilate_erode_other_device_raises():
    with pytest.raises(RuntimeError, match="no path"):
        tmo.dilate_erode(torch.zeros((1, 4, 4, 1), device="meta"), 1)
