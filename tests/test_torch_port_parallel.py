"""The port's multi-device layer (hairfastgan_torch/parallel) for inference,
against the JAX package's, f32, CPU.

Meshes are lists of torch.devices; a test gets a multi-device CPU mesh by
repeating the CPU ([cpu] * n, or by patching parallel.mesh.local_devices as
the JAX tests' conftest forces 8 virtual CPU devices). On a repeated device
every line of the sharding, banding and gathering code runs; the moves it
makes are counted in parallel.mesh.MOVES, which these tests pin as the JAX
tests pin the HLO's collectives (tests/test_mesh_equivalence.py).

Tolerances, stated once:
  * against the JAX package's plain synthesis: REL, 2e-4 of the
    reference's largest magnitude (tests/torch_port_util.py; f32 convs in
    another order);
  * against the committed JAX golden (tests/golden/dryrun_pipeline_golden.npz,
    hair_fast on the micro zoo over __graft_entry__'s triples): 2e-4
    absolute on the [0,1] image, the mesh test's own tolerance
    (test_mesh_equivalence.py) and above the port's 1e-4 one-device gap;
  * banded against the port's own unbanded render or swap: 1e-5 of scale
    (the same ops on row slices; only the conv algorithm's blocking over
    the shorter maps can differ);
  * halo=1 must be off by more than 1e-2, the JAX test's threshold: the
    halo is load-bearing.
"""

import jax
import numpy as np
import pytest
import torch

from hairfastgan_tpu.config import StyleGANConfig as JSG
from hairfastgan_tpu.models import stylegan2 as jsg
from hairfastgan_tpu.parallel import data_mesh_for_batch as jax_data_mesh_for_batch
from hairfastgan_torch.api import HairFast, chunk_seed
from hairfastgan_torch.config import HairFastConfig
from hairfastgan_torch.models import stylegan2 as tsg
from hairfastgan_torch.params.bridge import bridge_zoo
from hairfastgan_torch.parallel import mesh, spatial
from hairfastgan_torch.pipeline.swap import hair_fast
from hairfastgan_torch.zoo import init_micro_zoo
from tests.torch_port_util import close, graft_triples

torch.set_num_threads(2)
CPU = torch.device("cpu")
GOLDEN = "tests/golden/dryrun_pipeline_golden.npz"


def cpus(n):
    return [CPU] * n


def moves():
    return {k: v for k, v in mesh.MOVES.items() if v}


# -- the mesh -------------------------------------------------------------


@pytest.mark.parametrize("batch", range(1, 13))
def test_data_mesh_for_batch_matches_jax(batch, capsys):
    """The largest-divisor rule and its idle-device warning, word for word,
    over 1-8 devices (JAX gets the first n of the conftest's 8)."""
    for n in range(1, 9):
        jp = jax_data_mesh_for_batch(batch, jax.devices()[:n])
        jout = capsys.readouterr().out
        tp = mesh.data_mesh_for_batch(batch, cpus(n))
        tout = capsys.readouterr().out
        assert tp.shape == dict(jp.mesh.shape) and tp.data_devices == cpus(tp.shape["data"])
        assert tout == jout, (n, tout, jout)


def test_mesh_plan_axes_and_moves():
    plan = mesh.make_mesh(n_data=2, n_model=3, devices=cpus(8))
    assert plan.axis_names == ("data", "model") and plan.model_axis == "model"
    assert plan.shape == {"data": 2, "model": 3} and plan.distinct == [CPU]
    assert len(plan.data_devices) == 2 and len(plan.axis_devices("model")) == 3
    one = mesh.make_mesh(devices=cpus(4))
    assert one.model_axis is None and one.shape == {"data": 4} and one.lead == CPU
    with pytest.raises(ValueError, match="mesh needs"):
        mesh.make_mesh(n_data=3, n_model=2, devices=cpus(4))
    assert mesh.local_devices("cpu") == [CPU]

    mesh.MOVES.clear()
    x = torch.arange(12.0).reshape(6, 2)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch(one, x)
    parts = mesh.shard_batch(mesh.make_mesh(devices=cpus(3)), x)
    assert [p.shape[0] for p in parts] == [2, 2, 2]
    assert torch.equal(mesh.gather(parts, CPU), x)
    with pytest.raises(ValueError, match="kind"):
        mesh.move([x], CPU, "copy")
    # a differentiable broadcast: the replicas' gradients reach the master leaf
    w = torch.ones(3, requires_grad=True)
    reps = mesh.replicate(one, {"w": w, "n": 2})
    assert mesh.replicate(one, reps) is reps and reps[CPU]["n"] == 2
    (reps[CPU]["w"] * 3).sum().backward()
    assert torch.equal(w.grad, torch.full((3,), 3.0))
    assert moves() == {"scatter": 1, "gather": 1, "broadcast": 1}


def test_data_parallel_runs_shards_and_gathers():
    """Per-shard calls on the shard's rows, non-batched arguments as they
    are (a Replicas one per device), tuple outputs gathered."""
    plan = mesh.make_mesh(devices=cpus(4))
    seen = []

    def fn(x, k, r):
        seen.append((x.shape[0], k, r))
        return x * k, x.sum(1)

    x = torch.arange(16.0).reshape(8, 2)
    mesh.MOVES.clear()
    a, b = mesh.data_parallel(plan, fn, (True, False, False))(x, 3.0, mesh.Replicas({CPU: "r"}))
    assert seen == [(2, 3.0, "r")] * 4 and torch.equal(a, x * 3) and torch.equal(b, x.sum(1))
    assert moves() == {"scatter": 1, "gather": 2}
    with pytest.raises(ValueError, match="in_batched"):
        mesh.data_parallel(plan, fn, (True,))(x, 3.0)


# -- the banded synthesis ---------------------------------------------------


def _init_law(shapes, seed):
    """A JAX generator shape tree filled from a numpy seed by its init's
    law (stylegan2.init_generator_params: weights and the constant input
    N(0, 1), modulation biases 1, other biases and noise weights 0), at a
    fraction of jax.random's leaf-by-leaf time."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] in ("w", "input"):
            return rng.standard_normal(x.shape, np.float32)
        return np.full(x.shape, 1.0 if keys[-2:] == ["modulation", "b"] else 0.0, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def gen128():
    """The JAX test's generator (size 128 at 64 channels, drawn by its
    init's law) and latents, bridged, with the JAX package's plain renders."""
    cfg = JSG(size=128, max_channels=64)
    params = _init_law(jax.eval_shape(
        lambda: jsg.init_generator_params(jax.random.PRNGKey(0), cfg)), 0)
    lat = jax.random.normal(jax.random.PRNGKey(1), (2, cfg.n_latent, 512)) * 0.5
    synth = jax.jit(lambda p, lt, fi, sk: jsg.synthesis(p, lt, start_layer=4, end_layer=8,
                                                        layer_in=fi, skip=sk, cfg=cfg)[1])
    ref = np.asarray(jax.jit(lambda p, lt: jsg.synthesis(p, lt, cfg=cfg)[1])(params, lat))
    f, skip = jax.jit(lambda p, lt: jsg.synthesis(p, lt, end_layer=3, cfg=cfg))(params, lat)
    ref_resume = np.asarray(synth(params, lat, f, None))
    ref_skip = np.asarray(synth(params, lat, f, skip))
    port = {"gen": bridge_zoo(params), "lat": torch.from_numpy(np.array(lat)),
            "f": torch.from_numpy(np.array(f)), "skip": torch.from_numpy(np.array(skip))}
    return cfg, port, {"full": ref, "resume": ref_resume, "skip": ref_skip}


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def test_synthesis_skip_matches_jax(gen128):
    """synthesis(skip=) resumes the ToRGB chain as the JAX package's does."""
    cfg, p, ref = gen128
    out = tsg.synthesis(p["gen"], p["lat"], start_layer=4, end_layer=8, layer_in=p["f"],
                        skip=p["skip"], cfg=cfg, dtype=torch.float32)[1]
    close(out.numpy(), ref["skip"])
    full = tsg.synthesis(p["gen"], p["lat"], cfg=cfg, dtype=torch.float32)[1]
    close(out.numpy(), full.numpy(), rel=1e-5)


@pytest.mark.parametrize("form", ["banded", "gathered", "resume"])
def test_sharded_synthesis_matches_jax(gen128, form):
    """H-band sharding over n=4 bands (from_res 64, halo 8) against the JAX
    package's plain synthesis, and against the port's unbanded render. The
    full render resumes each band's skip chain from the sliced skip of
    pairs 0-3; the resume form starts at pair 4 from layer_in (the blend
    render's shape)."""
    cfg, p, ref = gen128
    sp = spatial.spatial_plan(mesh.make_mesh(devices=cpus(4)), p["gen"], from_res=64, halo=8)
    assert sp.n == 4 and sp.gens is None  # one distinct device: no copies
    kw = dict(cfg=cfg, dtype=torch.float32)
    mesh.MOVES.clear()
    if form == "resume":
        f = p["f"].permute(0, 3, 1, 2)
        bands = spatial.sharded_synthesis(sp, p["gen"], p["lat"], start_layer=4, layer_in=f,
                                          gather=False, **kw)
        out, want = torch.cat(bands, dim=2), ref["resume"]
        plain = tsg.synthesis_nchw(p["gen"], p["lat"], noise=tsg.make_noise(None, cfg),
                                   start_layer=4, layer_in=f, **kw)[1]
    else:
        got = spatial.sharded_synthesis(sp, p["gen"], p["lat"], gather=form == "gathered", **kw)
        out = got if form == "gathered" else torch.cat(got, dim=2)
        want = ref["full"]
        plain = tsg.synthesis_nchw(p["gen"], p["lat"], noise=tsg.make_noise(None, cfg), **kw)[1]
    assert moves() == ({"scatter": 1, "gather": 1} if form == "gathered" else {"scatter": 1})
    close(_nhwc(out), want)
    close(out.numpy(), plain.numpy(), rel=1e-5)


def test_sharded_synthesis_halo_is_load_bearing(gen128):
    """halo=1 must break the equality (banding engaged), as the JAX test
    requires of the JAX package's."""
    cfg, p, ref = gen128
    sp = spatial.SpatialPlan(devices=tuple(cpus(4)), from_res=64, halo=1)
    out = spatial.sharded_synthesis(sp, p["gen"], p["lat"], cfg=cfg)
    err = np.abs(_nhwc(out) - ref["full"]).max()
    assert err > 1e-2, f"halo=1 unexpectedly exact (err {err})"


def test_sharded_synthesis_edges(gen128):
    """Entry rows not divisible by n raise; a render with no pair at
    from_res is the plain render, unbanded; the plan of a 2-D mesh bands
    over its model axis."""
    cfg, p, _ = gen128
    kw = dict(cfg=cfg, dtype=torch.float32)
    with pytest.raises(ValueError, match="not divisible"):
        spatial.sharded_synthesis(spatial.SpatialPlan(tuple(cpus(3)), 64), p["gen"], p["lat"],
                                  **kw)
    mesh.MOVES.clear()
    low = spatial.sharded_synthesis(spatial.SpatialPlan(tuple(cpus(4)), 256), p["gen"],
                                    p["lat"], end_layer=3, **kw)
    plain = tsg.synthesis_nchw(p["gen"], p["lat"], noise=tsg.make_noise(None, cfg),
                               end_layer=3, **kw)[1]
    assert torch.equal(low, plain) and moves() == {}
    sp = spatial.spatial_plan(mesh.make_mesh(n_data=2, n_model=2, devices=cpus(4)),
                              from_res=64)
    assert sp.n == 2 and sp.from_res == 64 and sp.halo == 8


# -- the composed swap ------------------------------------------------------


@pytest.fixture(scope="module")
def micro():
    return init_micro_zoo(0)


@pytest.fixture(scope="module")
def golden(micro):
    with np.load(GOLDEN) as g:
        assert int(g["size"]) == micro[1].stylegan.size
        return g["ref_b8"]


@pytest.fixture(scope="module")
def triples(micro):
    return [torch.from_numpy(x[:2]) for x in graft_triples(micro[1].stylegan.size)]


def test_data_parallel_hair_fast_matches_golden(micro, golden, triples):
    """hair_fast data-parallel over [cpu] * 2 (B=2, one triple per shard)
    equals the JAX golden; it moves the three inputs' shards and the rows
    back and nothing else (JAX: zero collectives)."""
    zoo, cfg = micro
    swap = mesh.data_parallel(mesh.make_mesh(devices=cpus(2)),
                              lambda z, f, s, c: hair_fast(z, f, s, c, cfg=cfg),
                              (False, True, True, True))
    mesh.MOVES.clear()
    with torch.inference_mode():
        out = swap(zoo, *triples).numpy()
    assert moves() == {"scatter": 3, "gather": 1}
    np.testing.assert_allclose(out, golden[:2], rtol=0, atol=2e-4)


def test_sharded_swap_matches_golden(micro, golden, triples):
    """make_sharded_swap over 4 bands (from_res 64, halo 8) equals the JAX
    golden. Moves: one scatter per band render (two rotate renders,
    I_blend, the final render), 3 gathers of whole renders (the rotate
    renders the re-segmentation reads, the I_blend PostProcess reads) and
    the final image's assembly."""
    zoo, cfg = micro
    swap = spatial.make_sharded_swap(mesh.make_mesh(devices=cpus(4)), cfg=cfg, from_res=64,
                                     halo=8)
    one = [x[:1] for x in triples]
    mesh.MOVES.clear()
    with torch.inference_mode():
        out = swap(zoo, *one).numpy()
    assert moves() == {"scatter": 4, "gather": 3 + 1}
    np.testing.assert_allclose(out, golden[:1], rtol=0, atol=2e-4)


def _lively(tree, key=None):
    """tests/torch_port_util.lively on a port tree (a copy): norm gammas and
    StyleGAN modulation biases shifted by +1, their real initial values."""
    if isinstance(tree, dict):
        return {k: (v + 1.0 if isinstance(v, torch.Tensor) and (
                    k == "gamma" or (k == "b" and key == "modulation")) else _lively(v, k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_lively(v) for v in tree]
    return tree


def test_sharded_swap_matches_unbanded_on_lively_zoo(micro, triples):
    """On a zoo whose signals reach the image (the flat micro fill would
    hide a wrong band), the banded swap equals the port's unbanded one."""
    zoo, cfg = _lively(micro[0]), micro[1]
    one = [x[:1] for x in triples]
    swap = spatial.make_sharded_swap(mesh.make_mesh(devices=cpus(2)), cfg=cfg, from_res=64)
    with torch.inference_mode():
        ref = hair_fast(zoo, *one, cfg=cfg).numpy()
        out = swap(zoo, *one).numpy()
    assert ref.std() > 1e-2  # the image carries signal
    close(out, ref, rel=1e-5)


def test_sharded_swap_refuses_noise_and_intermediates(micro, triples):
    zoo, cfg = micro
    sp = spatial.SpatialPlan(devices=tuple(cpus(2)), from_res=64)
    one = [x[:1] for x in triples]
    with pytest.raises(ValueError, match="zero-noise"):
        hair_fast(zoo, *one, cfg=cfg, sp=sp, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="zero-noise"):
        hair_fast(zoo, *one, cfg=cfg, sp=sp, return_intermediate=True)


def test_swap_batch_multi_device_branch(micro, monkeypatch):
    """With local_devices patched to [cpu] * 4, swap_batch B=4 takes the
    data-parallel branch: every shard draws its noise from one seed, so
    each row equals a B=1 swap_batch of its triple (the chunked path with
    chunk_seed(seed, 0)), bit for bit (the last shard's row is compared).
    B=6 does not divide over 4 devices and takes the chunked path."""
    zoo, cfg = micro
    monkeypatch.setattr(mesh, "local_devices", lambda device: cpus(4))
    hf = HairFast(HairFastConfig(stylegan=cfg.stylegan, compute_dtype="float32"), zoo=zoo,
                  device="cpu")
    rng = np.random.default_rng(70)
    trip = [rng.integers(0, 256, (4, 128, 128, 3), dtype=np.uint8) for _ in range(3)]
    mesh.MOVES.clear()
    out = hf.swap_batch(*trip, output="uint8")
    assert moves() == {"broadcast": 1, "scatter": 3, "gather": 1}  # the zoo's copies once
    assert out.shape == (4, 128, 128, 3) and out.dtype == np.uint8
    mesh.MOVES.clear()
    row = hf.swap_batch(*(a[3:] for a in trip), output="uint8")  # the last shard's row
    assert moves() == {}
    np.testing.assert_array_equal(out[3:], row)

    calls = []

    def serve(case, face, shape, color, g, u8, res, zoo=None):
        calls.append((face.shape[0], g.initial_seed()))
        return torch.zeros((face.shape[0], res, res, 3), dtype=torch.uint8)

    monkeypatch.setattr(hf, "_serve", serve)
    mesh.MOVES.clear()
    hf.swap_batch(*(np.concatenate([a, a[:2]]) for a in trip), output="uint8")
    assert calls == [(6, chunk_seed(hf.cfg.seed, 0))] and moves() == {}
    calls.clear()
    hf.swap_batch(*trip, output="uint8")
    assert calls == [(1, chunk_seed(hf.cfg.seed, 0))] * 4
    assert moves() == {"scatter": 3, "gather": 1}
