"""The port's CLI (python -m hairfastgan_torch.main) and its model flags on
the CPU: parser defaults equal to the JAX CLI's, the --tiny / --micro zoos
against the JAX package's, and --micro runs that write PNGs. The port's
config classes are its own, so configs compare field for field."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from hairfastgan_tpu import api as japi
from hairfastgan_tpu.config import HairFastConfig, StyleGANConfig
from hairfastgan_tpu.zoo import init_micro_zoo_fast, init_tiny_zoo
from hairfastgan_torch import api as tapi
from hairfastgan_torch import main as tmain
from hairfastgan_torch import zoo as tzoo
from hairfastgan_torch.params.bridge import bridge_zoo
from tests.test_torch_port_zoo import flat, port_shapes

torch.set_num_threads(2)


def test_parser_defaults_match_jax():
    """Every model flag and default of the JAX CLI but --compile_cache_dir
    (XLA's compile cache), and the same config from them."""
    ours = vars(tapi.get_parser().parse_args([]))
    theirs = vars(japi.get_parser().parse_args([]))
    assert theirs.pop("compile_cache_dir") and ours == theirs
    runner = vars(tmain.parser().parse_args([]))
    assert runner["device"] == "cuda" and runner["batch"] == 1
    cfg = tapi.config_from_args(tapi.get_parser().parse_args(["--size", "256", "--save_all"]))
    ref = japi.config_from_args(japi.get_parser().parse_args(["--size", "256", "--save_all"]))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        dataclasses.replace(ref, compile_cache_dir=None))


@pytest.fixture(scope="module")
def micro():
    return tzoo.init_micro_zoo(0)


def test_micro_zoo_is_jax_micro_zoo(micro):
    """--micro's weights are the JAX package's init_micro_zoo_fast(0), bridged."""
    ours, cfg = micro
    theirs, jcfg = init_micro_zoo_fast(0)
    ref = flat(bridge_zoo(theirs))
    got = flat(ours)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) and got.keys() == ref.keys()
    for p, v in ref.items():
        assert (torch.equal(got[p], v) if isinstance(v, torch.Tensor) else got[p] == v), p


def test_tiny_zoo_shapes_match_jax():
    shapes, cfg = tzoo.tiny_zoo_shapes()
    jshapes = jax.eval_shape(lambda: init_tiny_zoo(jax.random.PRNGKey(0))[0])
    ours = {p: (tuple(v.shape) if isinstance(v, torch.Tensor) else v)
            for p, v in flat(tzoo.fill_random(shapes, None)).items()}
    assert ours == port_shapes(jshapes)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        HairFastConfig(stylegan=StyleGANConfig(size=128, max_channels=512)))


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.build(tmain.parser().parse_args(["--micro"]))


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    d = tmp_path_factory.mktemp("in")
    rng = np.random.default_rng(15)
    for name in ("a", "b", "c"):
        Image.fromarray(rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)).save(d / f"{name}.png")
    return d


def run(args, micro, monkeypatch):
    """The CLI with --micro on the CPU; the micro zoo is drawn once per module."""
    monkeypatch.setattr(tzoo, "init_micro_zoo", lambda seed, device: micro)
    tmain.main(tmain.parser().parse_args(["--micro", "--device", "cpu"] + args))


def test_micro_single_triple(photos, tmp_path, micro, monkeypatch):
    run(["--input_dir", str(photos), "--face_path", "a.png", "--shape_path", "b.png",
         "--color_path", "c.png", "--output_dir", str(tmp_path), "--output_res", "64",
         "--benchmark"],
        micro, monkeypatch)
    out = np.asarray(Image.open(tmp_path / "a_b_c.png"))
    assert out.shape == (64, 64, 3) and out.dtype == np.uint8


def test_micro_batch_file(photos, tmp_path, micro, monkeypatch):
    listing = tmp_path / "triples.txt"
    listing.write_text("a.png b.png c.png\nb.png b.png b.png\nc.png a.png a.png\n")
    run(["--input_dir", str(photos), "--file_path", str(listing), "--batch", "2",
         "--output_dir", str(tmp_path / "out")], micro, monkeypatch)
    for name in ("a_b_c", "b_b_b", "c_a_a"):
        assert np.asarray(Image.open(tmp_path / "out" / f"{name}.png")).shape == (128, 128, 3)
