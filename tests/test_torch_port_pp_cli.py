"""The port's PostProcess CLIs (hairfastgan_torch/scripts/{gen_pp_data,
train_pp}.py) and train_blending's FID-CLIP flags, run in-process on the CPU
with --device cpu --micro (--tiny for train_blending), as
tests/test_train_cli.py runs the JAX package's.

Rows are held against the JAX generate_pp_sample's shapes (jax.eval_shape
on the same micro zoo), the trainers' frozen trees against the JAX CLI's,
and the epochs by their observable results: the jsonl log, the printed
lines, best/last train states with the discriminator, grids, the FID cache.
"""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from hairfastgan_tpu.train import datagen as jdg
from hairfastgan_tpu.zoo import init_micro_zoo
from hairfastgan_torch.params.checkpoint import restore_train_state
from hairfastgan_torch.scripts import gen_pp_data, train_blending, train_pp
from hairfastgan_torch.train.common import tensor_leaves
from tests.test_nvlabs_loader import _rosinality_to_nvlabs_pickle
from tests.test_torch_port_pp_losses import rosinality_sd
from tests.test_torch_port_train_cli import _make_blending_rows

torch.set_num_threads(2)
PP_KEYS = ("source", "target", "target_mask", "HT_E", "source_full")


def _records(log):
    return [json.loads(line) for line in log.read_text().splitlines()]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(1)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (128, 128, 3), np.uint8)).save(str(d / f"f{i}.png"))
    return d


@pytest.fixture(scope="module")
def pp_rows(tmp_path_factory, images):
    """gen_pp_data --micro: 3 rows from random triples of `images`."""
    out = tmp_path_factory.mktemp("pp_rows")
    gen_pp_data.main(["--input_dir", str(images), "--n_random", "3", "--out_dir", str(out),
                      "--zoo_dir", str(out / "nozoo"), "--micro", "--device", "cpu"])
    return out


def _jax_shapes(init):
    """(zoo as shapes, cfg) of a JAX `init(key) -> (zoo, cfg)`, traced only."""
    made = {}

    def zoo():
        z, made["cfg"] = init(jax.random.PRNGKey(0))
        return z

    z = jax.eval_shape(zoo)
    return z, made["cfg"]


def test_gen_pp_data_micro_rows(pp_rows):
    """One row per triple with the keys, shapes and dtype of the JAX
    generate_pp_sample on the same micro zoo, finite, binary masks."""
    rows = sorted(pp_rows.glob("row_*.npz"))
    assert [r.name for r in rows] == [f"row_{i:06d}.npz" for i in range(3)]
    jz, cfg = _jax_shapes(lambda key: init_micro_zoo(key))
    x = jax.ShapeDtypeStruct((1, 128, 128, 3), np.float32)
    ref = jax.eval_shape(lambda z, a, b, c: jdg.generate_pp_sample(z, a, b, c, cfg), jz, x, x, x)
    assert sorted(ref) == sorted(PP_KEYS)
    with np.load(rows[0]) as row:
        assert sorted(row.files) == sorted(ref)
        for k, v in ref.items():
            assert row[k].shape == v.shape and row[k].dtype == np.float32, k
            assert np.isfinite(row[k]).all(), k
        assert set(np.unique(row["target_mask"])) <= {0.0, 1.0}
        assert set(np.unique(row["HT_E"])) <= {0.0, 1.0}
        assert row["source_full"].shape == (1, 128, 128, 3)


def _train_argv(tmp_path, pp_rows, *extra, epochs=1):
    return (["--data_dir", str(pp_rows), "--zoo_dir", str(tmp_path / "nozoo"),
             "--torch_dir", str(tmp_path / "no_torch"), "--micro", "--device", "cpu",
             "--epochs", str(epochs), "--batch_size", "1", "--test_frac", "0.67",
             "--ckpt_dir", str(tmp_path / "ckpt"), "--log", str(tmp_path / "log.jsonl")]
            + list(extra))


@pytest.fixture(scope="module")
def adv_run(tmp_path_factory, pp_rows, images):
    """Two adversarial --micro epochs of 1 step at batch 1 (one row trains,
    two validate): the warm-up step without
    the discriminator, then one with it, its D step and R1; FID-CLIP against
    `images` with an npz cache."""
    tmp = tmp_path_factory.mktemp("adv")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_pp.main(_train_argv(tmp, pp_rows, "--use_adv", "--iter_before", "1",
                                  "--d_reg_every", "1", "--grid_dir", str(tmp / "grids"),
                                  "--fid_real_dir", str(images), "--fid_cache",
                                  str(tmp / "fid" / "real.npz"), epochs=2))
    return tmp, buf.getvalue()


def test_train_pp_micro_adversarial(adv_run):
    """The log holds the step terms, val_loss, disc_adv and r1; the RANDOM
    discriminator warning is printed; last/ and best/ hold train states with
    the discriminator; one grid per epoch."""
    tmp, out = adv_run
    assert "RANDOM discriminator" in out and "epoch 1: val" in out
    recs = _records(tmp / "log.jsonl")
    assert any("val_loss" in r and "val_dice" in r for r in recs)
    assert sum("disc_adv" in r for r in recs) == 1  # step 1 only (iter_before 1)
    assert sum("r1" in r for r in recs) == 1 and all(r["r1"] > 0 for r in recs if "r1" in r)
    steps = [r for r in recs if "grad_norm" in r and "dice" in r]
    assert len(steps) == 2 and "adv" not in steps[0] and "adv" in steps[1]
    for name in ("last", "best"):
        state = restore_train_state(tmp / "ckpt" / name)
        assert "disc" in state and state["opt_state"]["state"]
    last = restore_train_state(tmp / "ckpt" / "last")
    assert last["step"] == 2 and len(last["disc"]["blocks"]) == 5  # 128^2: 5 blocks
    assert sorted((tmp / "grids").glob("epoch_*.png"))[-1].name == "epoch_0001.png"
    grid = np.asarray(Image.open(tmp / "grids" / "epoch_0001.png"))
    assert grid.shape == (256, 10240, 3)  # [source|target|gen_W|gen_F] x 10 columns


def test_train_pp_resume(tmp_path, adv_run, pp_rows, capsys):
    """--resume brings back the params, the optimizer state, the step and the
    discriminator, and training goes on from there."""
    tmp, _ = adv_run
    saved = restore_train_state(tmp / "ckpt" / "last")
    train_pp.main(_train_argv(tmp_path, pp_rows, "--use_adv", "--iter_before", "1",
                              "--d_reg_every", "1", "--resume", str(tmp / "ckpt" / "last")))
    assert f"at step {saved['step']}" in capsys.readouterr().out
    state = restore_train_state(tmp_path / "ckpt" / "last")
    assert state["step"] == saved["step"] + 1
    # one more D step from the restored discriminator moved it
    moved = [not torch.equal(a, b) for a, b in zip(tensor_leaves(state["disc"]),
                                                    tensor_leaves(saved["disc"]))]
    assert any(moved) and len(moved) == len(tensor_leaves(saved["disc"]))
    recs = _records(tmp_path / "log.jsonl")
    assert any("disc_adv" in r for r in recs)  # past iter_before from the first step


def test_train_pp_split_compile_bf16_pretrained_disc(tmp_path, pp_rows, capsys):
    """--split_compile --bf16 parse and step, with the adversarial phase
    started from a synthetic NVlabs ffhq.pkl (--disc_pkl): finite terms in
    the log, the D step and R1 at step 0, f32 master params, and the
    pickle's discriminator in the train state before its one D step."""
    pkl = tmp_path / "ffhq.pkl"
    sd = rosinality_sd(np.random.default_rng(15), 128, max_channels=128)
    pkl.write_bytes(_rosinality_to_nvlabs_pickle(
        {k: torch.from_numpy(v) for k, v in sd.items()}, 128))
    train_pp.main(_train_argv(tmp_path, pp_rows, "--split_compile", "--bf16", "--use_adv",
                              "--disc_pkl", str(pkl)))
    assert f"pretrained D: {pkl}" in capsys.readouterr().out
    recs = _records(tmp_path / "log.jsonl")
    step = next(r for r in recs if "grad_norm" in r)
    assert all(np.isfinite(step[k]) for k in ("loss", "dice", "id", "lpips_face", "inpaint",
                                              "adv"))
    assert any("disc_adv" in r for r in recs) and any("r1" in r for r in recs)
    assert any("val_loss" in r for r in recs)
    state = restore_train_state(tmp_path / "ckpt" / "last")
    assert all(t.dtype == torch.float32 for t in tensor_leaves(state["params"]))
    assert state["disc"]["blocks"][0]["skip"]["conv"]["w"].shape == tuple(
        sd["convs.1.skip.1.weight"].shape)


def test_train_pp_fid_clip(adv_run):
    """--fid_real_dir logs fid_clip each epoch; --fid_cache keeps the real
    stats for the next run."""
    tmp, out = adv_run
    fid = [r["fid_clip"] for r in _records(tmp / "log.jsonl") if "fid_clip" in r]
    assert len(fid) == 2 and all(np.isfinite(fid)) and "fid-clip" in out
    assert (tmp / "fid" / "real.npz").exists()


def test_train_blending_fid_clip(tmp_path, images):
    """train_blending --fid_real_dir / --fid_cache (the JAX CLI's
    train_blending.py:48-51,133-170): fid_clip in the log, the cache file."""
    data = _make_blending_rows(tmp_path)
    cache = tmp_path / "real.npz"
    train_blending.main(["--data_dir", str(data), "--zoo_dir", str(tmp_path / "nozoo"),
                         "--tiny", "--device", "cpu", "--epochs", "1", "--batch_size", "2",
                         "--test_frac", "0.5", "--ckpt_dir", str(tmp_path / "ckpt"),
                         "--fid_real_dir", str(images), "--fid_cache", str(cache),
                         "--log", str(tmp_path / "log.jsonl")])
    fid = [r["fid_clip"] for r in _records(tmp_path / "log.jsonl") if "fid_clip" in r]
    assert len(fid) == 1 and np.isfinite(fid[0]) and cache.exists()


@pytest.mark.parametrize("script", [gen_pp_data, train_pp],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_pp_scripts_default_to_cuda(script):
    """--device defaults to cuda, and without a GPU a script raises instead
    of falling back to the CPU."""
    assert script.parser().get_default("device") == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda is valid here")
    argv = {"gen_pp_data": ["--input_dir", "x", "--out_dir", "y"],
            "train_pp": ["--data_dir", "x"]}[script.__name__.split(".")[-1]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(argv)


def _jax_pp_trees(mode):
    """(frozen nets, post_process, discriminator) as the JAX CLI builds them
    under --micro / --tiny (scripts/train_pp.py:104-131), as shapes."""
    from hairfastgan_tpu.losses.identity import init_irse_backbone
    from hairfastgan_tpu.losses.perceptual import init_lpips_alex
    from hairfastgan_tpu.models import bisenet
    from hairfastgan_tpu.models.stylegan2_discriminator import init_discriminator

    from hairfastgan_tpu.zoo import init_tiny_zoo

    key = jax.random.PRNGKey(0)
    zoo, cfg = _jax_shapes(init_micro_zoo if mode == "micro" else init_tiny_zoo)
    width = 0.25 if mode == "micro" else 1.0

    def trees():
        return ({"bisenet16": bisenet.init_bisenet(key, n_classes=16, width=width),
                 "id_backbone": init_irse_backbone(key, width=width),
                 "lpips": init_lpips_alex(key)},
                init_discriminator(key, cfg.stylegan))
    frozen, disc = jax.eval_shape(trees)
    return (dict(frozen, generator=zoo["generator"]), zoo["post_process"], disc), cfg


@pytest.mark.parametrize("mode", ["micro", "tiny"])
def test_pp_trees_match_jax_cli(mode):
    """zoo.pp_train_frozen / init_discriminator beside the micro / tiny zoo
    have the JAX CLI's shapes and configs (seed None: shapes only)."""
    import dataclasses

    from hairfastgan_torch import zoo as tzoo
    from tests.test_torch_port_zoo import flat, port_shapes

    shapes, cfg = (tzoo.micro_zoo_shapes() if mode == "micro" else tzoo.tiny_zoo_shapes())
    zoo = tzoo.fill_random(shapes, None)
    ours = (tzoo.pp_train_frozen(zoo["generator"], 0.25 if mode == "micro" else 1.0, seed=None),
            zoo["post_process"], tzoo.init_discriminator(cfg.stylegan, seed=None))
    ref, jcfg = _jax_pp_trees(mode)
    for got, want in zip(ours, ref):
        assert {p: tuple(v.shape) if isinstance(v, torch.Tensor) else v
                for p, v in flat(got).items()} == port_shapes(want)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
