"""The port's zoo file (params/checkpoint.py), HairFast loading its
checkpoint_dir, and the convert_checkpoints CLI, on the CPU.

The zoo file stores the tree as it is, so every round trip is compared
exactly; so is the micro swap of a loaded zoo against the same zoo passed
as zoo= (the same weights through the same CPU ops).
"""

import dataclasses

import numpy as np
import pytest
import torch

from hairfastgan_torch import convert_checkpoints
from hairfastgan_torch import zoo as tzoo
from hairfastgan_torch.api import HairFast
from hairfastgan_torch.config import HairFastConfig
from hairfastgan_torch.params.checkpoint import ZOO_FILE, load_zoo_file, save_zoo
from tests.test_torch_port_convert import SMALL_GAN, assert_same_tree, write_reference_dir

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def micro():
    return tzoo.init_micro_zoo(0)


@pytest.fixture(scope="module")
def micro_dir(micro, tmp_path_factory):
    d = tmp_path_factory.mktemp("micro_zoo")
    save_zoo(d, micro[0])
    return d


def test_save_load_round_trip(micro, micro_dir):
    zoo, cfg = micro
    assert (micro_dir / ZOO_FILE).is_file() and not list(micro_dir.glob("*.tmp"))
    assert_same_tree(load_zoo_file(micro_dir / ZOO_FILE), zoo)
    assert_same_tree(tzoo.load_zoo(micro_dir, cfg, device="cpu"), zoo)
    assert tzoo.load_zoo(micro_dir, cfg)["fse"]["fs_layers"] == (5,)


def test_save_zoo_stores_f32(tmp_path):
    tree = {"a": torch.ones(2, 3, dtype=torch.bfloat16), "i": torch.arange(3), "s": (2, 2)}
    got = load_zoo_file(save_zoo(tmp_path, tree))
    assert got["a"].dtype == torch.float32 and torch.equal(got["a"], torch.ones(2, 3))
    assert torch.equal(got["i"], torch.arange(3)) and got["s"] == (2, 2)


def test_hairfast_loads_checkpoint_dir(micro, micro_dir):
    """checkpoint_dir holding zoo_torch.pt: the same swap as zoo=, exactly."""
    zoo, cfg = micro
    cfg = dataclasses.replace(cfg, compute_dtype="float32", checkpoint_dir=micro_dir)
    rng = np.random.default_rng(40)
    imgs = [rng.integers(0, 256, (128, 128, 3), dtype=np.uint8) for _ in range(3)]
    loaded = HairFast(cfg, device="cpu")
    assert_same_tree(loaded.zoo, zoo)
    got = loaded.swap(*imgs, seed=3, output="uint8")
    ref = HairFast(cfg, zoo=zoo, device="cpu").swap(*imgs, seed=3, output="uint8")
    assert got.shape == (128, 128, 3)
    np.testing.assert_array_equal(got, ref)


def test_hairfast_casts_loaded_zoo(micro, micro_dir):
    """compute_dtype bfloat16: the loaded f32 zoo is cast leaf by leaf."""
    zoo, cfg = micro
    hf = HairFast(dataclasses.replace(cfg, checkpoint_dir=micro_dir), device="cpu")
    assert_same_tree(hf.zoo, tzoo.cast_zoo(zoo, torch.bfloat16))


def test_orbax_only_dir_names_the_converter(tmp_path):
    (tmp_path / "zoo").mkdir()
    with pytest.raises(FileNotFoundError, match="hairfastgan_torch.convert_checkpoints"):
        HairFast(HairFastConfig(checkpoint_dir=tmp_path), device="cpu")


def test_convert_checkpoints_cli(tmp_path, capsys):
    """The CLI on a reference-layout tree writes the raw path's tree."""
    raw = write_reference_dir(tmp_path / "pretrained_models")
    out = tmp_path / "converted"
    assert convert_checkpoints.main(["--torch_dir", str(raw), "--out_dir", str(out)]) == 0
    ref = tzoo.load_zoo(raw, HairFastConfig(), device="cpu")
    got = load_zoo_file(out / ZOO_FILE)
    assert_same_tree(got, ref)
    assert got["fse_latent_avg"].shape == (HairFastConfig().stylegan.n_latent, 512)
    n = sum(t.numel() for t in _tensors(ref))
    assert f"converted zoo: {n} parameters" in capsys.readouterr().out
    # the converted directory loads through the fast path, at any config
    assert_same_tree(tzoo.load_zoo(out, HairFastConfig(stylegan=SMALL_GAN)), ref)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree
