"""The port's evaluation and offline CLIs in-process on the CPU:
hairfastgan_torch/scripts/{fid_metric,align_faces,upload_res_agreement}.py,
and the state-dict writers chip_smoke.py feeds them on the card
(inception_state_dict, star_state_dict), held against the converters.

fid_metric's values are held against frechet_distance of the same feature
functions in this process (to the CSV's 6 decimals), its per-net cache
names against the JAX CLI's; align_faces' PNGs against
utils/face_align.align_faces on the same photo, exactly.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from hairfastgan_torch.eval.fid import FIDStats, clip_feature_fn, frechet_distance
from hairfastgan_torch.models import inception as tinc
from hairfastgan_torch.models import star as tstar
from hairfastgan_torch.params.convert import load_torch_state_dict
from hairfastgan_torch.scripts import align_faces, fid_metric, upload_res_agreement
from hairfastgan_torch.utils import face_align
from hairfastgan_torch.utils.images import save_image01, to_raw_image
from hairfastgan_torch.zoo import init_star
from tests.test_torch_port_convert import assert_same_tree

torch.set_num_threads(2)


def _numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def test_inception_state_dict_round_trip():
    p = tinc.init_inception(3)
    assert_same_tree(tinc.convert_inception(_numpy_sd(chip_smoke.inception_state_dict(p))), p)


def test_star_state_dict_round_trip():
    p = init_star(seed=4, channels=16)
    sd = _numpy_sd(chip_smoke.star_state_dict(p)["net"])
    assert_same_tree(tstar.convert_star(sd), p)


@pytest.fixture(scope="module")
def fid_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fid")
    rng = np.random.default_rng(50)
    for sub in ("real", "m1", "m2"):
        (d / sub).mkdir()
        for i in range(5):
            Image.fromarray(rng.integers(0, 256, (80, 72, 3), dtype=np.uint8)).save(
                d / sub / f"{i}.png")
    torch.save(chip_smoke.inception_state_dict(tinc.init_inception(1)), d / "inception_v3.pth")
    return d


@pytest.mark.parametrize("with_inception", [True, False])
def test_fid_metric_main(fid_dirs, tmp_path, with_inception):
    d = fid_dirs
    out = tmp_path / "fid.csv"
    argv = ["--real_dir", str(d / "real"), "--method_dirs", str(d / "m1"), str(d / "m2"),
            "--zoo_dir", str(tmp_path / "nozoo"), "--size", "64", "--limit", "4", "--batch", "3",
            "--fid_cache", str(tmp_path / "cache" / "real.npz"), "--out_csv", str(out),
            "--device", "cpu"]
    if with_inception:
        argv += ["--inception_ckpt", str(d / "inception_v3.pth")]
    fid_metric.main(argv)
    lines = out.read_text().splitlines()
    names = ["fid", "fid_clip"] if with_inception else ["fid_clip"]
    assert lines[0] == "method," + ",".join(names)
    assert [r.split(",")[0] for r in lines[1:]] == ["m1", "m2"]
    assert sorted(p.name for p in (tmp_path / "cache").iterdir()) == sorted(
        f"real_{n}.npz" for n in names)

    fns = {"fid_clip": clip_feature_fn(fid_metric.clip_tower(tmp_path / "nozoo", "cpu"))}
    if with_inception:
        fns["fid"] = fid_metric.load_inception_feature_fn(d / "inception_v3.pth")
    for row in lines[1:]:
        m, *vals = row.split(",")
        for name, v in zip(names, vals):
            fn = fns[name]
            real = FIDStats().update(fn(fid_metric.load_dir(d / "real", 64, 4))).finalize()
            fake = FIDStats().update(fn(fid_metric.load_dir(d / m, 64, 4))).finalize()
            ref = frechet_distance(*real, *fake)
            assert np.isfinite(ref) and abs(float(v) - ref) <= 5e-6 + 1e-6 * abs(ref), (m, name)


def test_feature_cache_names_match_jax(tmp_path):
    from scripts.fid_metric import _feature_cache as jax_cache

    for base in (tmp_path / "real.npz", tmp_path / "stats", None):
        for name in ("fid", "fid_clip"):
            assert fid_metric._feature_cache(base, name) == jax_cache(base, name)


def test_device_cuda_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main, argv in ((fid_metric.main, ["--real_dir", str(tmp_path), "--method_dirs",
                                          str(tmp_path)]),
                       (align_faces.main, ["--input_dir", str(tmp_path), "--output_dir",
                                           str(tmp_path / "o")]),
                       (upload_res_agreement.main, ["--n", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


def _gate_off(monkeypatch):
    """Random STAR weights give diffuse heatmaps, which the gate refuses."""
    orig = face_align.star_landmark_provider
    monkeypatch.setattr(face_align, "star_landmark_provider",
                        lambda p, **kw: orig(p, **dict(kw, check=False)))


def test_align_faces_main_equals_align_faces(monkeypatch, tmp_path):
    """STAR from <zoo_dir>/star_wflw.pth on --device cpu: each PNG is
    utils/face_align.align_faces of the same photo, saved."""
    rng = np.random.default_rng(51)
    (tmp_path / "in").mkdir()
    (tmp_path / "zoo").mkdir()
    for i, (h, w) in enumerate(((150, 120), (96, 128))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / "in" / f"p{i}.png")
    torch.save(chip_smoke.star_state_dict(init_star(seed=5, channels=16)),
               tmp_path / "zoo" / "star_wflw.pth")
    _gate_off(monkeypatch)
    align_faces.main(["--input_dir", str(tmp_path / "in"), "--output_dir", str(tmp_path / "out"),
                      "--size", "64", "--zoo_dir", str(tmp_path / "zoo"), "--device", "cpu"])
    star_p = tstar.convert_star(load_torch_state_dict(tmp_path / "zoo" / "star_wflw.pth",
                                                      key="net"))
    for i in range(2):
        ref = face_align.align_faces([to_raw_image(tmp_path / "in" / f"p{i}.png")],
                                     output_size=64, star_params=star_p)[0]
        save_image01(tmp_path / "ref.png", ref)
        got = np.asarray(Image.open(tmp_path / "out" / f"p{i}.png"))
        assert got.shape == (64, 64, 3)
        np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "ref.png")))


def test_align_faces_without_provider_fails_loudly(monkeypatch, tmp_path):
    """--dlib without dlib (or no STAR file and no dlib) raises with guidance."""
    def no_dlib():
        raise ImportError("No module named 'dlib'")

    monkeypatch.setattr(face_align, "_dlib_landmark_fn", no_dlib)
    (tmp_path / "in").mkdir()
    Image.fromarray(np.zeros((40, 30, 3), np.uint8)).save(tmp_path / "in" / "a.png")
    with pytest.raises(RuntimeError, match="landmark provider"):
        align_faces.main(["--input_dir", str(tmp_path / "in"), "--output_dir",
                          str(tmp_path / "out"), "--zoo_dir", str(tmp_path / "nozoo"),
                          "--dlib", "--device", "cpu"])


def test_upload_res_agreement_prints_both_routes(capsys):
    out = upload_res_agreement.main(["--n", "2", "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert out["n"] == 2 and out["upload_res"] == 512
    for route in ("keys", "lanczos"):
        r = out[route]
        assert 0.0 <= r["seg_agreement"] <= 1.0
        # BISENET_SEED's weights give hair pixels, so the IoU is defined
        assert r["hair_iou"] is not None and 0.0 < r["hair_iou"] <= 1.0
        assert 0.0 < r["e4e_in_rmse"] < 0.05 and 0.0 < r["fse_in_rmse"] < 0.05
    assert '"keys"' in printed and '"lanczos"' in printed
    # the Keys route tracks the device bicubic closer than LANCZOS
    assert out["keys"]["e4e_in_rmse"] < out["lanczos"]["e4e_in_rmse"]


def _unrounded(monkeypatch, module):
    """The scripts round what they print; a module-level `round` shadows
    the builtin so the comparison sees the full float."""
    monkeypatch.setattr(module, "round", lambda x, ndigits=None: x, raising=False)


def test_upload_res_agreement_matches_jax(monkeypatch, capsys):
    """The JAX package's scripts/upload_res_agreement.py on the CPU, on the
    same RandomState(0) fields and the JAX init_bisenet(PRNGKey(0)) weights
    bridged into the port: the port's route that the JAX script took
    (Keys where its native loader builds) gives the same four numbers.
    The encoder-input RMSEs do not read the net: 5e-5 relative (7.4e-6
    seen; the Keys and LANCZOS routes differ by 13-30%). A BiSeNet label
    flips where two logits tie within f32 rounding: 1e-4 absolute, 13 of
    the 131,072 pixels (one seen)."""
    import jax

    import scripts.upload_res_agreement as jura
    from hairfastgan_tpu.data import native_loader as jnl
    from hairfastgan_tpu.models import bisenet as jbis
    from hairfastgan_torch.params.bridge import bridge_zoo

    _unrounded(monkeypatch, jura)
    monkeypatch.setattr("sys.argv", ["upload_res_agreement", "--n", "2", "--batch", "2"])
    jura.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    jz = jbis.init_bisenet(jax.random.PRNGKey(0), n_classes=19)
    _unrounded(monkeypatch, upload_res_agreement)
    monkeypatch.setattr(upload_res_agreement, "scaled_bisenet",
                        lambda seed, device: bridge_zoo(jz))
    out = upload_res_agreement.main(["--n", "2", "--batch", "2", "--device", "cpu"])
    got = out["keys" if jnl.native_available() else "lanczos"]
    assert ref["hair_iou"] > 0.5, ref  # the JAX weights give hair pixels
    for k in ("e4e_in_rmse", "fse_in_rmse"):
        np.testing.assert_allclose(got[k], ref[k], rtol=5e-5, err_msg=k)
    for k in ("seg_agreement", "seg_agreement_nonmodal", "hair_iou"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4, err_msg=k)

