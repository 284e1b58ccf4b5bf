"""The port's own host modules against the JAX package's: the config
dataclasses, the image coercions, the native loader and the FFHQ crop.

All of these are numpy / PIL code on both sides (the native loader is the
same C++ source, built by each package), so they are compared exactly.
"""

import dataclasses

import numpy as np
import pytest
from PIL import Image

import hairfastgan_tpu.config as jcfg
import hairfastgan_tpu.utils.face_align as jfa
from hairfastgan_tpu.data import native_loader as jnl
from hairfastgan_tpu.utils import images as jimg
from hairfastgan_torch import config as tcfg
from hairfastgan_torch.data import native_loader as tnl
from hairfastgan_torch.utils import face_align as tfa
from hairfastgan_torch.utils import images as timg

CONFIGS = ("StyleGANConfig", "SEANConfig", "ShapeAdaptorConfig", "CLIPConfig", "HairFastConfig")


@pytest.mark.parametrize("name", CONFIGS)
def test_config_dataclasses_match_jax(name):
    ours, theirs = getattr(tcfg, name), getattr(jcfg, name)
    names = [[f.name for f in dataclasses.fields(c)] for c in (ours, theirs)]
    assert names[0] == names[1]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    assert ours.__dataclass_params__.frozen


def test_stylegan_config_properties_match_jax():
    for size, mc in ((1024, 512), (128, 128), (32, 16)):
        ours, theirs = tcfg.StyleGANConfig(size=size, max_channels=mc), \
            jcfg.StyleGANConfig(size=size, max_channels=mc)
        assert (ours.log_size, ours.n_latent, ours.num_layers) == \
            (theirs.log_size, theirs.n_latent, theirs.num_layers)
        assert [ours.channels(2 ** i) for i in range(2, 11)] == \
            [theirs.channels(2 ** i) for i in range(2, 11)]
    assert tcfg.HairFastConfig().checkpoint_dir == jcfg.HairFastConfig().checkpoint_dir


def _inputs():
    rng = np.random.default_rng(30)
    u8 = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    other = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    return {
        "uint8 at size": u8,
        "uint8 to resize": other,
        "float01": rng.random((64, 64, 3), dtype=np.float32),
        "float01 to resize": rng.random((40, 48, 3), dtype=np.float32),
        "PIL": Image.fromarray(other),
        "gray uint8": rng.integers(0, 256, (64, 64, 1), dtype=np.uint8),
        "CHW float": rng.random((3, 64, 64), dtype=np.float32),
    }


@pytest.mark.parametrize("kind", sorted(_inputs()))
def test_image_coercions_match_jax(kind, tmp_path):
    img = _inputs()[kind]
    for fn in ("to_image_u8", "to_image_array"):
        got, ref = getattr(timg, fn)(img, 64), getattr(jimg, fn)(img, 64)
        assert got.dtype == ref.dtype and got.shape == ref.shape == (64, 64, 3), fn
        np.testing.assert_array_equal(got, ref, err_msg=fn)
    np.testing.assert_array_equal(timg.to_raw_image(img), jimg.to_raw_image(img))


def test_image_paths_and_save_match_jax(tmp_path):
    img = _inputs()["uint8 to resize"]
    timg.save_image01(tmp_path / "ours.png", img.astype(np.float32) / 255.0)
    jimg.save_image01(tmp_path / "theirs.png", img.astype(np.float32) / 255.0)
    assert (tmp_path / "ours.png").read_bytes() == (tmp_path / "theirs.png").read_bytes()
    for fn in ("to_image_u8", "to_raw_image"):
        args = (tmp_path / "ours.png",) + ((64,) if fn == "to_image_u8" else ())
        np.testing.assert_array_equal(getattr(timg, fn)(*args), getattr(jimg, fn)(*args))


def test_equal_replacer_matches_jax():
    rng = np.random.default_rng(31)
    a = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    b = a.copy()
    c = a.copy()
    c[40, 40, 0] ^= 1  # differs off the strided sample only
    f = a.astype(np.float32) / 255.0
    for imgs in ([a, b, c], [a, c, a], [f, f.copy(), a], [c, b, a.copy()]):
        ours, theirs = timg.equal_replacer(imgs), jimg.equal_replacer(imgs)
        assert [[x is y for y in ours] for x in ours] == [[x is y for y in theirs] for x in theirs]


def _pngs(tmp_path):
    rng = np.random.default_rng(32)
    paths = []
    for i, shape in enumerate(((64, 64, 3), (90, 70, 3), (40, 120, 3))):
        paths.append(tmp_path / f"{i}.png")
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(paths[-1])
    jpg = tmp_path / "3.jpg"
    Image.fromarray(rng.integers(0, 256, (80, 80, 3), dtype=np.uint8)).save(jpg, quality=90)
    return paths + [jpg]


def test_native_loader_matches_jax(tmp_path):
    """The port builds native/hf_loader.cpp itself; its decodes and resizes
    equal the JAX package's loader's."""
    if not tnl.native_available():
        pytest.skip(f"the port's native loader did not build here: {tnl.native_error()}")
    if not jnl.native_available():
        pytest.skip("the JAX package's native loader is unavailable here")
    assert tnl.native_error() is None
    paths = _pngs(tmp_path)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    for size in (48, 64):
        with pytest.warns(UserWarning, match="decode failed"):
            with tnl.NativeImageLoader(paths + [bad], out_size=size, threads=2) as loader:
                got = dict(loader)
        ref = dict(jnl.NativeImageLoader([str(p) for p in paths], out_size=size, threads=2,
                                         dtype=np.uint8))
        assert sorted(got) == sorted(ref) == list(range(len(paths)))
        for i, p in enumerate(paths):
            np.testing.assert_array_equal(got[i], ref[i])
            np.testing.assert_array_equal(got[i], jnl.load_image_native_u8(str(p), size))
    img = np.asarray(Image.open(paths[1]))
    np.testing.assert_array_equal(tnl.resize_u8_native(img, 33), jnl.resize_u8_native(img, 33))
    with pytest.raises(ValueError):
        tnl.resize_u8_native(img.astype(np.float32), 33)


def test_native_loader_reports_build_error(monkeypatch, tmp_path):
    """A failed build leaves the reason for the caller (swap_stream's PIL route)."""
    monkeypatch.setattr(tnl, "SOURCE", tmp_path / "missing.cpp")
    tnl._load.cache_clear()
    try:
        assert not tnl.native_available()
        assert "missing.cpp" in tnl.native_error()
        with pytest.raises(RuntimeError, match="unavailable"):
            tnl.NativeImageLoader([tmp_path / "x.png"])
    finally:
        tnl._load.cache_clear()


RESIZES = {"1024->512": ((1024, 1024, 3), 512), "1500x1200->1024": ((1500, 1200, 3), 1024)}


@pytest.mark.parametrize("case", sorted(RESIZES))
def test_resize_only_library_equals_loader(case):
    """The codec-free csrc/resize_u8.cpp gives the full loader's
    hfl_resize_u8 bytes (both build here)."""
    shape, out = RESIZES[case]
    full, err = tnl._load()
    only, only_err = tnl._load_resize_only()
    assert full is not None, err
    assert only is not None, only_err
    img = np.random.default_rng(31).integers(0, 256, shape, dtype=np.uint8)
    got = tnl._resize_with(only, img, out)
    assert got.shape == (out, out, 3)
    np.testing.assert_array_equal(got, tnl._resize_with(full, img, out))


@pytest.mark.parametrize("case", sorted(RESIZES))
def test_upload_res_keeps_keys_bicubic_without_codec(monkeypatch, case):
    """Where the codec build fails (a host without jpeglib.h), to_image_u8
    still resizes with the Keys bicubic, through the resize-only library:
    the same bytes as the full loader's, not PIL LANCZOS's."""
    shape, out = RESIZES[case]
    img = np.random.default_rng(32).integers(0, 256, shape, dtype=np.uint8)
    keys = tnl.resize_u8_native(img, out)

    def no_codec():
        raise RuntimeError("g++ failed (1): fatal error: jpeglib.h: No such file or directory")

    monkeypatch.setattr(tnl, "build", no_codec)
    tnl._load.cache_clear()
    tnl._load_resize_only.cache_clear()
    try:
        assert not tnl.native_available() and "jpeglib.h" in tnl.native_error()
        assert tnl.resize_available() and tnl.resize_error() is None
        got = timg.to_image_u8(img, out)
        np.testing.assert_array_equal(got, keys)
        assert not np.array_equal(got, timg.resize_u8_lanczos(img, out))
    finally:
        tnl._load.cache_clear()
        tnl._load_resize_only.cache_clear()


def test_upload_res_falls_back_to_lanczos_without_any_build(monkeypatch, tmp_path):
    """Neither library builds: LANCZOS, and resize_error says why the
    resize-only library did not."""
    def no_codec():
        raise RuntimeError("g++ failed (1): jpeglib.h")

    monkeypatch.setattr(tnl, "build", no_codec)
    monkeypatch.setattr(tnl, "RESIZE_SOURCE", tmp_path / "missing_resize.cpp")
    tnl._load.cache_clear()
    tnl._load_resize_only.cache_clear()
    try:
        img = np.random.default_rng(33).integers(0, 256, (64, 48, 3), dtype=np.uint8)
        np.testing.assert_array_equal(timg.to_image_u8(img, 32), timg.resize_u8_lanczos(img, 32))
        assert "missing_resize.cpp" in tnl.resize_error()
        with pytest.raises(RuntimeError, match="no native resize"):
            tnl.resize_u8_native(img, 32)
    finally:
        tnl._load.cache_clear()
        tnl._load_resize_only.cache_clear()


def test_upload_res_never_resizes_with_the_full_loader(monkeypatch, tmp_path):
    """The resize comes from the resize-only library alone: with the full
    loader built and the resize-only build failing, to_image_u8 takes
    LANCZOS, so every host resizes with the same library."""
    assert tnl.native_available(), tnl.native_error()
    monkeypatch.setattr(tnl, "RESIZE_SOURCE", tmp_path / "missing_resize.cpp")
    tnl._load_resize_only.cache_clear()
    try:
        img = np.random.default_rng(34).integers(0, 256, (64, 48, 3), dtype=np.uint8)
        assert not tnl.resize_available()
        np.testing.assert_array_equal(timg.to_image_u8(img, 32), timg.resize_u8_lanczos(img, 32))
    finally:
        tnl._load_resize_only.cache_clear()


def _landmarks(rng, n, center, scale):
    return center + rng.standard_normal((n, 2)) * scale


@pytest.mark.parametrize("where", ["inside", "padded", "shrunk"])
def test_ffhq_crop_matches_jax(where):
    """The same landmarks give the same quad and the same crop: a face
    inside the frame, one whose quad leaves it (reflect-pad and fade), and
    one large enough to shrink the photo first."""
    rng = np.random.default_rng(33)
    h, w, size, scale = {"inside": (200, 160, 64, 12.0), "padded": (120, 100, 64, 30.0),
                         "shrunk": (600, 560, 32, 80.0)}[where]
    photo = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    center = np.array([w / 2, h / 2]) + (20 if where == "padded" else 0)
    for quad_fn in ("_ffhq_quad", "_ffhq_quad_wflw"):
        lm = _landmarks(rng, 68 if quad_fn == "_ffhq_quad" else 98, center, scale)
        ours, theirs = getattr(tfa, quad_fn)(lm), getattr(jfa, quad_fn)(lm)
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1] == theirs[1]
        np.testing.assert_array_equal(tfa._warp_quad(photo, *ours, size),
                                      jfa._warp_quad(photo, *theirs, size))


def test_align_faces_without_a_provider_raises(monkeypatch):
    """No STAR weights and no dlib: both raise with guidance."""
    def no_dlib():
        raise ImportError("No module named 'dlib'")

    monkeypatch.setattr(tfa, "_dlib_landmark_fn", no_dlib)
    monkeypatch.setattr(jfa, "_dlib_landmark_fn", no_dlib)
    photo = np.zeros((32, 32, 3), np.float32)
    for fa in (tfa, jfa):
        with pytest.raises(RuntimeError, match="landmark provider"):
            fa.align_faces([photo], output_size=16)
