"""The port's serving surface (hairfastgan_torch/api.py) on the CPU: the
intermediates of `hair_fast(return_intermediate=True)` against the JAX
package's, the serving levers (uint8, upload_res, output_res), save_all
dumps, warmup, swap_batch, swap_stream and loading an existing checkpoint
directory.

The zoo is the micro zoo passed through torch_port_util.lively (signals
carry through every model), f32. Tolerances: intermediates within 2e-4 of
scale, as the stage parities (tests/test_torch_port_stages.py), integer
labels exactly; uint8 within 1 step of the rounded float output (the same
values quantized on either side of a .5); the output downsample within
1e-5 (the same FIR in another summation order). swap_batch and swap_stream
run the same CPU ops as their references, so they are compared exactly.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from hairfastgan_tpu.api import HairFast as JaxHairFast
from hairfastgan_tpu.config import HairFastConfig, StyleGANConfig
from hairfastgan_tpu.ops.resample import bicubic_downsample
from hairfastgan_tpu.pipeline.swap import hair_fast as jax_hair_fast
from hairfastgan_tpu.zoo import init_micro_zoo_fast
from hairfastgan_torch.api import HairFast, chunk_seed
from hairfastgan_torch.params.bridge import bridge_zoo
from hairfastgan_torch.params.checkpoint import save_zoo
from hairfastgan_torch.pipeline.swap import hair_fast
from tests.test_torch_port_convert import assert_same_tree
from tests.torch_port_util import close, graft_triples, lively

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def live():
    jz, cfg = init_micro_zoo_fast(0)
    jz = lively(jz)
    return jz, bridge_zoo(jz), cfg


@pytest.fixture(scope="module")
def hf(live, tmp_path_factory):
    _, tz, cfg = live
    cfg = dataclasses.replace(cfg, compute_dtype="float32", save_all=True,
                              save_all_dir=tmp_path_factory.mktemp("save_all"),
                              max_batch_per_dispatch=2)
    return HairFast(cfg, zoo=tz, device="cpu")


@pytest.fixture(scope="module")
def triple():
    """Three distinct uint8 128^2 images."""
    rng = np.random.default_rng(12)
    return [rng.integers(0, 256, (128, 128, 3), dtype=np.uint8) for _ in range(3)]


def test_intermediates_match_jax(live):
    jz, tz, cfg = live
    f, s, c = (x[:1] for x in graft_triples(cfg.stylegan.size))
    _, ref = jax.jit(lambda z, a, b, d: jax_hair_fast(z, a, b, d, cfg=cfg,
                                                      return_intermediate=True))(jz, f, s, c)
    with torch.inference_mode():
        _, got = hair_fast(tz, *(torch.from_numpy(x) for x in (f, s, c)), cfg=cfg,
                           return_intermediate=True)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        r = np.asarray(r)
        if np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(got[k].numpy(), r, err_msg=k)
        else:
            close(got[k].numpy(), r)


@pytest.mark.parametrize("size", [1024, 128])
def test_upload_and_output_res_match_jax(size):
    cfg = HairFastConfig(stylegan=StyleGANConfig(size=size))
    port = types.SimpleNamespace(cfg=cfg)
    for req in (None, 1, 7, 63, 64, 100, 127, 128, 129, 256, 300, 511, 512, 513, 700,
                1023, 1024, 2048):
        assert HairFast._upload_res(port, req) == JaxHairFast._upload_res(port, req), req
        assert HairFast._output_res(port, req) == JaxHairFast._output_res(port, req), req
    with pytest.raises(ValueError):
        HairFast._output_res(port, 0)


@pytest.fixture(scope="module")
def full(hf, triple):
    """The float result of a distinct swap of `triple` with seed 5."""
    return hf.swap(*triple, seed=5)


def test_uint8_and_output_res(hf, triple, full):
    u8 = hf.swap(*triple, seed=5, output="uint8")
    assert full.dtype == np.float32 and u8.dtype == np.uint8 and u8.shape == full.shape
    expect = np.clip(full * 255.0 + 0.5, 0, 255).astype(np.uint8)
    assert np.abs(u8.astype(np.int16) - expect).max() <= 1
    half = hf.swap(*triple, seed=5, output_res=64)
    assert half.shape == (64, 64, 3)
    ref = np.asarray(bicubic_downsample(full[None], 2)[0])
    np.testing.assert_allclose(half, ref, rtol=0, atol=1e-5)


def test_upload_res_and_poisson(hf, triple, full):
    """upload_res ships smaller inputs (on a 128^2 config nothing clamps);
    poisson composites at full size, then output_res shrinks the result."""
    small = hf.swap(*triple, seed=5, upload_res=64)
    assert small.shape == (128, 128, 3) and np.isfinite(small).all()
    assert not np.array_equal(small, full)
    comp = hf.swap(*triple, seed=5, poisson=True, upload_res=64, output_res=64,
                   output="uint8")
    assert comp.shape == (64, 64, 3) and comp.dtype == np.uint8


def test_save_all_dumps(hf, triple):
    hf.swap(*triple, exp_name="exp")
    d = hf.cfg.save_all_dir / "exp"
    for png, size in (("Final/final.png", 128), ("Blending/blending.png", 128),
                      ("Shape/mask_face.png", 256), ("Shape/mask_color.png", 256)):
        assert Image.open(d / png).size == (size, size), png
    n = hf.cfg.stylegan.n_latent
    shapes = {"FS/face.npz": {"latent_S": (1, n, 512), "latent_W": (1, n, 512)},
              "Blending/blending.npz": {"S_blend": (1, n, 512)},
              "Final/final.npz": {"S_final": (1, n, 512)}}
    for name, want in shapes.items():
        with np.load(d / name) as z:
            assert {k: z[k].shape for k in want} == want, name
    with np.load(d / "FS/face.npz") as z, np.load(d / "Align/align.npz") as a:
        assert z["latent_F"].shape == a["latent_F_align"].shape == (1, 32, 32, 128)
    with np.load(d / "Final/final.npz") as z:
        assert z["F_final"].shape[:3] == (1, 64, 64)


def test_warmup(hf):
    assert hf.warmup(cases=("same",), batch_sizes=(1, 2), output="uint8", output_res=64) is hf


def test_swap_batch_chunks(hf):
    """B=5 in chunks of 2: chunk i is hair_fast on its rows with the noise of
    chunk_seed(cfg.seed, i), quantized on the device. (The "same" case keeps
    the CPU cost down; chunking does not depend on the case.)"""
    faces = np.random.default_rng(13).integers(0, 256, (5, 128, 128, 3), dtype=np.uint8)
    out = hf.swap_batch(faces, faces, faces, case="same", output="uint8")
    assert out.shape == (5, 128, 128, 3) and out.dtype == np.uint8
    for i in (0, 2, 4):
        g = torch.Generator().manual_seed(chunk_seed(hf.cfg.seed, i))
        x = torch.from_numpy(faces[i:i + 2])
        with torch.inference_mode():
            ref = hair_fast(hf.zoo, x, x, x, case="same", cfg=hf.cfg, generator=g)
        ref = (ref * 255.0 + 0.5).clamp(0, 255).to(torch.uint8).numpy()
        np.testing.assert_array_equal(out[i:i + 2], ref)


def test_swap_stream(hf, tmp_path):
    """Results in launch order, the partial tail group padded with its last
    triple, and a triple that fails to decode yields None."""
    rng = np.random.default_rng(14)
    paths = []
    for i in range(4):
        paths.append(tmp_path / f"{i}.png")
        Image.fromarray(rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)).save(paths[-1])
    (tmp_path / "bad.png").write_bytes(b"not an image")
    triples = [(p, p, p) for p in paths]
    triples[2] = (paths[2], paths[2], tmp_path / "bad.png")
    with pytest.warns(UserWarning):
        got = list(hf.swap_stream(triples, case="same", depth=2, output="uint8", batch=2))
    assert [i for i, _ in got] == [0, 1, 2, 3] and got[2][1] is None

    def batch(idx):
        x = np.stack([np.asarray(Image.open(paths[i])) for i in idx])
        return hf.swap_batch(x, x, x, case="same", output="uint8")

    np.testing.assert_array_equal(np.stack([got[0][1], got[1][1]]), batch([0, 1]))
    np.testing.assert_array_equal(got[3][1], batch([3, 3])[0])


def test_existing_checkpoint_dir_loads(live, tmp_path):
    """An existing checkpoint_dir is loaded (its zoo_torch.pt), as the JAX
    package loads its own, in place of drawing random weights."""
    _, tz, cfg = live
    save_zoo(tmp_path, tz)
    hf = HairFast(dataclasses.replace(cfg, compute_dtype="float32", checkpoint_dir=tmp_path),
                  device="cpu")
    assert_same_tree(hf.zoo, tz)
