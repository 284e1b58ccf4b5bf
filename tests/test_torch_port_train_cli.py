"""The port's data-generation and training CLIs
(hairfastgan_torch/scripts/{gen_blending_data,gen_rotate_data,
train_blending,train_rotate}.py), run in-process on the CPU with
--device cpu, as tests/test_train_cli.py runs the JAX package's.

Row shapes are held against the JAX generators' (jax.eval_shape on the
same micro zoo), the rotate rows' cycle structure exactly, and the
trainers' epochs by their observable results: best/last train states, the
jsonl log, render grids, the refusal without STAR.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from hairfastgan_tpu.train import common as jcommon
from hairfastgan_tpu.train import datagen as jdg
from hairfastgan_tpu.zoo import init_micro_zoo_fast
from hairfastgan_torch.params.checkpoint import TRAIN_STATE_FILE, restore_train_state
from hairfastgan_torch.scripts import gen_blending_data, gen_rotate_data, train_blending
from hairfastgan_torch.scripts import train_rotate
from hairfastgan_torch.train.common import MovingAverageLoss

torch.set_num_threads(2)
N_LATENT_TINY = 12  # 128-res generator: 2*log2(128) - 2


def _make_rows(tmp_path):
    """Pose and hair rows of the tiny config (test_train_cli's)."""
    rng = np.random.RandomState(0)
    pose, hair = tmp_path / "pose", tmp_path / "hair"
    pose.mkdir()
    hair.mkdir()
    for i in range(4):
        np.savez(pose / f"{i}.npz",
                 I_from=rng.rand(1, 256, 256, 3).astype(np.float32),
                 kp_to=rng.rand(1, 76, 2).astype(np.float32) * 255,
                 W_from=rng.randn(1, N_LATENT_TINY, 512).astype(np.float32) * 0.1,
                 W_to=rng.randn(1, N_LATENT_TINY, 512).astype(np.float32) * 0.1)
        np.savez(hair / f"{i}.npz",
                 W_from=rng.randn(1, N_LATENT_TINY, 512).astype(np.float32) * 0.1,
                 W_to=rng.randn(1, N_LATENT_TINY, 512).astype(np.float32) * 0.1)
    return pose, hair


def _make_blending_rows(tmp_path):
    """Rows of the tiny config: S rows n_latent(128) = 12; align_f stays the
    structural 32x32x512 F."""
    rng = np.random.RandomState(0)
    data = tmp_path / "blend"
    data.mkdir()
    for i in range(4):
        np.savez(data / f"row_{i:06d}.npz",
                 color_s=rng.randn(1, N_LATENT_TINY, 512).astype(np.float32) * 0.1,
                 align_s=rng.randn(1, N_LATENT_TINY, 512).astype(np.float32) * 0.1,
                 align_f=rng.randn(1, 32, 32, 512).astype(np.float32) * 0.1,
                 color_i=rng.randn(1, 256, 256, 3).astype(np.float32) * 0.5,
                 face_i=rng.randn(1, 256, 256, 3).astype(np.float32) * 0.5,
                 target_mask=(rng.rand(1, 256, 256, 1) > 0.5).astype(np.float32),
                 HM_3E=(rng.rand(1, 256, 256, 1) > 0.5).astype(np.float32),
                 HM_XE=(rng.rand(1, 256, 256, 1) > 0.5).astype(np.float32))
    return data


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (128, 128, 3), np.uint8)).save(str(d / f"f{i}.png"))
    return d


@pytest.fixture(scope="module")
def jax_micro():
    return init_micro_zoo_fast(0)


def _records(log):
    return [json.loads(line) for line in log.read_text().splitlines()]


def test_rotate_cli_fails_without_star(tmp_path):
    """No STAR checkpoint and no --no_keypoints => a hard error, not a
    silent constant-loss run."""
    pose, hair = _make_rows(tmp_path)
    with pytest.raises(SystemExit, match="STAR"):
        train_rotate.main(["--pose_dir", str(pose), "--hair_dir", str(hair),
                           "--zoo_dir", str(tmp_path / "nozoo"), "--tiny", "--device", "cpu",
                           "--epochs", "1", "--batch_size", "2",
                           "--log", str(tmp_path / "log.jsonl")])


def test_rotate_cli_tiny_epoch(tmp_path):
    """One --tiny epoch: val metrics logged, best/last train states, grid."""
    pose, hair = _make_rows(tmp_path)
    log = tmp_path / "log.jsonl"
    train_rotate.main(["--pose_dir", str(pose), "--hair_dir", str(hair),
                       "--zoo_dir", str(tmp_path / "nozoo"), "--tiny", "--no_keypoints",
                       "--device", "cpu", "--epochs", "1", "--batch_size", "2",
                       "--test_frac", "0.5", "--ckpt_dir", str(tmp_path / "ckpt"),
                       "--grid_dir", str(tmp_path / "grids"), "--log", str(log)])
    for name in ("last", "best"):
        assert (tmp_path / "ckpt" / name / TRAIN_STATE_FILE).exists()
    state = restore_train_state(tmp_path / "ckpt" / "last")
    assert state["step"] == 3 and len(state["params"]["mods"]) == 5  # pose, hair, val
    assert list((tmp_path / "grids").glob("epoch_*.png"))
    recs = _records(log)
    assert any("val_loss" in rec for rec in recs)
    assert any("mse_latents" in rec for rec in recs)
    assert any("arc_face" in rec and "grad_norm" in rec for rec in recs)


def test_blending_cli_tiny_epoch(tmp_path):
    """One --tiny epoch of the blending CLI: val loss logged, best/last
    train states without the CLIP tower, a render grid."""
    data = _make_blending_rows(tmp_path)
    log = tmp_path / "log.jsonl"
    train_blending.main(["--data_dir", str(data), "--zoo_dir", str(tmp_path / "nozoo"),
                         "--tiny", "--device", "cpu", "--epochs", "1", "--batch_size", "2",
                         "--test_frac", "0.5", "--ckpt_dir", str(tmp_path / "ckpt"),
                         "--grid_dir", str(tmp_path / "grids"), "--log", str(log)])
    for name in ("last", "best"):
        state = restore_train_state(tmp_path / "ckpt" / name)
        assert sorted(state["params"]) == ["mods"] and state["opt_state"]["state"]
    grids = list((tmp_path / "grids").glob("epoch_*.png"))
    assert grids and np.asarray(Image.open(grids[0])).shape == (256, 2560, 3)
    recs = _records(log)
    assert any("val_loss" in rec for rec in recs)
    assert any("face" in rec for rec in recs)


def test_blending_cli_refuses_missing_rows(tmp_path):
    with pytest.raises(FileNotFoundError, match="no .npz rows"):
        train_blending.main(["--data_dir", str(tmp_path), "--tiny", "--device", "cpu"])


def test_gen_rotate_data_micro(tmp_path, images, jax_micro):
    """gen_rotate_data --micro writes pose/hair rows with the JAX generator's
    shapes and the cycle structure train_rotate reads."""
    pose, hair = tmp_path / "pose", tmp_path / "hair"
    gen_rotate_data.main(["--input_dir", str(images), "--n_pairs", "3", "--pose_dir", str(pose),
                          "--hair_dir", str(hair), "--zoo_dir", str(tmp_path / "nozoo"),
                          "--micro", "--no_keypoints", "--device", "cpu"])
    pose_rows, hair_rows = sorted(pose.glob("*.npz")), sorted(hair.glob("*.npz"))
    assert len(pose_rows) == 3 and len(hair_rows) == 3
    jz, cfg = jax_micro
    x = jax.ShapeDtypeStruct((1, 128, 128, 3), np.float32)
    ref = jax.eval_shape(lambda a, b: jdg.generate_rotate_pair(jz, a, b, cfg), x, x)
    p = np.load(pose_rows[0])
    for k in ("I_from", "W_from", "W_to"):
        assert p[k].shape == ref[k].shape and p[k].dtype == np.float32, k
    assert p["kp_to"].shape == (1, 76, 2) and not p["kp_to"].any()
    assert np.isfinite(p["I_from"]).all() and np.isfinite(p["W_from"]).all()
    h = np.load(hair_rows[0])
    assert h["W_from"].shape == h["W_to"].shape == (1, N_LATENT_TINY, 512)
    # cycle structure: hair W_from rows 6: are the pose row's W_from rows 6:
    np.testing.assert_array_equal(h["W_from"][:, 6:], p["W_from"][:, 6:])
    np.testing.assert_array_equal(h["W_from"][:, :6], p["W_to"][:, :6])
    np.testing.assert_array_equal(h["W_to"], p["W_from"])


def test_gen_rotate_data_refuses_without_star(tmp_path, images):
    with pytest.raises(SystemExit, match="STAR"):
        gen_rotate_data.main(["--input_dir", str(images), "--n_pairs", "1",
                              "--pose_dir", str(tmp_path / "p"), "--hair_dir", str(tmp_path / "h"),
                              "--zoo_dir", str(tmp_path / "nozoo"), "--micro",
                              "--device", "cpu"])


@pytest.mark.parametrize("listing", [False, True])
def test_gen_blending_data_micro(tmp_path, images, jax_micro, listing):
    """gen_blending_data --micro writes one row per triple (from --n_random
    or a --file_path listing) with the keys and shapes of the JAX
    generate_blending_sample on the same micro zoo."""
    args = ["--input_dir", str(images), "--out_dir", str(tmp_path / "rows"),
            "--zoo_dir", str(tmp_path / "nozoo"), "--micro", "--device", "cpu"]
    if listing:
        (tmp_path / "triples.txt").write_text("f0.png f1.png f2.png\n\nf2.png f0.png f1.png\n")
        args += ["--file_path", str(tmp_path / "triples.txt")]
    else:
        args += ["--n_random", "2"]
    gen_blending_data.main(args)
    rows = sorted((tmp_path / "rows").glob("row_*.npz"))
    assert [r.name for r in rows] == ["row_000000.npz", "row_000001.npz"]
    jz, cfg = jax_micro
    x = jax.ShapeDtypeStruct((1, 128, 128, 3), np.float32)
    ref = jax.eval_shape(lambda a, b, c: jdg.generate_blending_sample(jz, a, b, c, cfg), x, x, x)
    row = np.load(rows[0])
    assert sorted(row.files) == sorted(ref)
    for k, v in ref.items():
        assert row[k].shape == v.shape and row[k].dtype == np.float32, k
        assert np.isfinite(row[k]).all(), k
    assert set(np.unique(row["target_mask"])) <= {0.0, 1.0}


@pytest.mark.parametrize("script", [gen_blending_data, gen_rotate_data, train_blending,
                                    train_rotate], ids=lambda m: m.__name__.split(".")[-1])
def test_scripts_default_to_cuda(script):
    """--device defaults to cuda, and without a GPU a script raises (before
    it reads any path) instead of falling back to the CPU."""
    assert script.parser().get_default("device") == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda is valid here")
    argv = {"gen_blending_data": ["--input_dir", "x", "--out_dir", "y"],
            "gen_rotate_data": ["--input_dir", "x", "--pose_dir", "y", "--hair_dir", "z"],
            "train_blending": ["--data_dir", "x"],
            "train_rotate": ["--pose_dir", "x", "--hair_dir", "y"]}[script.__name__.split(".")[-1]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(argv)


def _jax_tiny_trees(which):
    """((frozen, params), cfg) as the JAX CLIs build them under --tiny
    (scripts/train_blending.py:71-87, scripts/train_rotate.py:74-81), the
    trees as shapes."""
    from hairfastgan_tpu.config import HairFastConfig, StyleGANConfig
    from hairfastgan_tpu.losses.identity import init_irse_backbone
    from hairfastgan_tpu.models import clip_vit, encoders, stylegan2

    key = jax.random.PRNGKey(0)
    if which == "blending":
        cfg = HairFastConfig(stylegan=StyleGANConfig(size=128))

        def trees():
            clip = clip_vit.init_clip_image_tower(key, width=64, layers=2, heads=2,
                                                  embed_dim=512)
            blending = encoders.init_blending_model(key, clip_params=clip)
            return ({"generator": stylegan2.init_generator_params(key, cfg.stylegan),
                     "clip": blending["clip"]}, {"mods": blending["mods"]})
    else:
        cfg = HairFastConfig(stylegan=StyleGANConfig(size=128, max_channels=128))

        def trees():
            return ({"generator": stylegan2.init_generator_params(key, cfg.stylegan),
                     "arcface": init_irse_backbone(key)}, encoders.init_rotate_model(key))
    return jax.eval_shape(trees), cfg


@pytest.mark.parametrize("which", ["blending", "rotate"])
def test_tiny_trees_match_jax_cli(which):
    """zoo.blending_train_tiny / rotate_train_tiny have the JAX CLIs' --tiny
    shapes and configs (seed None keeps meta tensors: shapes only)."""
    import dataclasses

    from hairfastgan_torch import zoo as tzoo
    from tests.test_torch_port_zoo import flat, port_shapes

    frozen, params, cfg = getattr(tzoo, f"{which}_train_tiny")(None)
    (jfrozen, jparams), jcfg = _jax_tiny_trees(which)
    for got, ref in ((frozen, jfrozen), (params, jparams)):
        assert {p: tuple(v.shape) if isinstance(v, torch.Tensor) else v
                for p, v in flat(got).items()} == port_shapes(ref)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_moving_average_loss_matches_reference():
    """MovingAverageLoss mirrors rotate_train.py:26-42 (multiplier =
    weight_k / EMA_k, alpha 0.02, EMA seeded at the first value), and
    equals the JAX package's class step for step."""
    mal = MovingAverageLoss({"a": 6.0}, alpha=0.02)
    ref = jcommon.MovingAverageLoss({"a": 6.0}, alpha=0.02)
    assert mal.multipliers(("a", "b")) == (6.0, 1.0)
    mal.update({"a": 3.0, "b": 2.0})
    assert mal.multipliers(("a",))[0] == pytest.approx(6.0 / 3.0)
    mal.update({"a": 5.0})
    ema = 0.02 * 5.0 + 0.98 * 3.0
    assert mal.multipliers(("a", "b"))[0] == pytest.approx(6.0 / ema)
    assert mal.multipliers(("b",))[0] == pytest.approx(1.0 / 2.0)
    for step in ({"a": 3.0, "b": 2.0}, {"a": 5.0}, {"a": torch.tensor(1e-12), "b": 7.0}):
        ref.update({k: float(v) for k, v in step.items()})
    mal.update({"a": torch.tensor(1e-12), "b": 7.0})
    assert mal.multipliers(("a", "b", "c")) == ref.multipliers(("a", "b", "c"))
