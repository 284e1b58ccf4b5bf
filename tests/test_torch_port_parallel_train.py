"""The port's data-parallel training (train/common.shard_loss and
make_train_step(plan=), the discriminator's minibatch stddev over the
global batch, the PostProcess steps and the three training CLIs on a data
mesh) against the one-device step and the JAX package's jax.grad on the
conftest's 8-device mesh, CPU.

Meshes repeat the CPU ([cpu] * n); the CLIs get theirs by patching
parallel.mesh.local_devices. Tolerances, stated once:
  * the generic and blending steps on a mesh against the one-device step:
    in float64, losses 1e-10 relative and gradients 1e-10 of the largest
    |grad| (the same sums with the batch mean taken as a weighted sum of
    shard means; in f32 that reordering moved losses by 1.5e-6 relative
    on some hosts, past the 1e-6 these checks had);
  * against JAX: both packages' f32 runs against the port's float64 one
    (tests/test_torch_port_train.py's f32_no_worse): the JAX run's loss
    within 1e-5 relative and its gradients within 1e-4 of the largest
    |grad| (f32 backward sums in another order), the port's f32 gradient
    error at most twice the JAX run's (measured 1.12 at n=2 and n=4);
  * params after an Adam step: lr/5 absolute (Adam's first step is
    lr * sign(g) for |g| >> eps, so a sign flip of a noise-level gradient
    would move a coordinate by 2 lr);
  * the discriminator in float64: 1e-10 (a random D's f32 input gradient
    flips leaky-ReLU slopes near 0, tests/test_torch_port_pp_losses.py);
  * the CLIs' logged values: 1e-5 of the record's largest |value|, or 20
    ulps of 1.0 (2.4e-6) where that is larger: their random CLIP and IR-SE
    towers embed every image along nearly one direction, so the 1 - cos
    terms sit at the f32 floor of cos ~ 1 (one ulp of 1.0 is 1.2e-7, and
    the identity term is 20 * (1 - cos)).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairfastgan_tpu.config import StyleGANConfig as JSG
from hairfastgan_tpu.models import stylegan2 as jsg
from hairfastgan_tpu.parallel import make_mesh as jax_make_mesh
from hairfastgan_tpu.parallel import replicate as jax_replicate
from hairfastgan_tpu.parallel import shard_batch as jax_shard_batch
from hairfastgan_torch.config import HairFastConfig, StyleGANConfig
from hairfastgan_torch.models import clip_vit, encoders
from hairfastgan_torch.models import stylegan2 as tsg
from hairfastgan_torch.models import stylegan2_discriminator as D
from hairfastgan_torch.params.bridge import bridge_zoo, map_tree
from hairfastgan_torch.parallel import mesh
from hairfastgan_torch.scripts import train_blending, train_rotate
from hairfastgan_torch.train import blending as tbl
from hairfastgan_torch.train import common as tcommon
from hairfastgan_torch.train import pp as tpp
from hairfastgan_torch.train.common import tensor_leaves
from hairfastgan_torch.zoo import (fill_random, init_discriminator, micro_zoo_shapes,
                                   pp_train_frozen)
from tests.test_torch_port_parallel import _init_law
from tests.test_torch_port_train import blend_batch, d64, f32_no_worse
from tests.test_torch_port_train_cli import _make_blending_rows, _make_rows

torch.set_num_threads(2)
CPU = torch.device("cpu")
LR = 1e-3


def cpus(n):
    return [CPU] * n


def moves():
    return {k: v for k, v in mesh.MOVES.items() if v}


def copy(tree):
    return map_tree(tree, lambda _, t: t.detach().clone())


def grads_close(got, ref, rel):
    scale = max(float(r.abs().max()) for r in ref)
    assert scale > 0
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, i
        err = float((g - r).abs().max())
        assert err <= rel * scale, (i, err, scale)


# -- the generic step: the JAX mesh test's loss -----------------------------


@pytest.fixture(scope="module")
def gen32():
    """tests/test_mesh_equivalence.py's generator (size 32 at 64 channels,
    drawn by its init's law) and batch: z [8,512], targets [8,32,32,3]."""
    cfg = JSG(size=32, max_channels=64)
    params = _init_law(jax.eval_shape(
        lambda: jsg.init_generator_params(jax.random.PRNGKey(0), cfg)), 0)
    z = jax.random.normal(jax.random.PRNGKey(0), (8, cfg.style_dim))
    t = jax.random.normal(jax.random.PRNGKey(1), (8, cfg.size, cfg.size, 3))
    return cfg, params, np.array(z), np.array(t)


def _jax_loss(cfg):
    def loss(p, z, t):
        w = jsg.mapping(p, z, cfg)
        img = jsg.generate(p, jsg.latent_to_wplus(w, cfg.n_latent), cfg=cfg)
        return jnp.mean((img - t) ** 2)

    return loss


def _port_loss(cfg):
    def loss(p, z, t):
        w = tsg.mapping(p, z, cfg)
        img = tsg.generate(p, tsg.latent_to_wplus(w, cfg.n_latent), cfg=cfg, dtype=z.dtype)
        return torch.mean((img - t) ** 2), {"mean_img": img.mean(), "img": img.detach()}

    return loss


def _grads(params, fn, *args):
    leaves = tensor_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss, aux = fn(params, *args)
    loss.backward()
    grads = [torch.zeros_like(x) if x.grad is None else x.grad.clone() for x in leaves]
    for x in leaves:
        x.grad = None
        x.requires_grad_(False)
    return loss.detach(), aux, grads


@pytest.fixture(scope="module")
def jax_grads32(gen32):
    """jax.grad of the loss with the batch sharded over the conftest's 8
    devices (test_mesh_equivalence.py's check), as port-layout leaves."""
    cfg, jparams, z, t = gen32
    jplan = jax_make_mesh(n_data=8)
    zs, ts = jax_shard_batch(jplan, (jnp.asarray(z), jnp.asarray(t)))
    with jplan.mesh:
        jloss, jg = jax.jit(jax.value_and_grad(_jax_loss(cfg)))(
            jax_replicate(jplan, jparams), zs, ts)
    return float(jloss), tensor_leaves(bridge_zoo(jg))


@pytest.mark.parametrize("n", [2, 4])
def test_data_parallel_step_matches_one_device_and_jax(gen32, jax_grads32, n):
    """B=8 over n devices: the global loss, its gradients (one reduction:
    the batch scattered, the params broadcast, the losses reduced) and the
    params after the Adam step equal the one-device step's in float64, and
    the f32 loss and gradients on the mesh hold against that float64 run no
    worse than jax.grad's with the batch sharded over the conftest's 8
    devices."""
    cfg, jparams, z, t = gen32
    jloss, jgrads = jax_grads32

    loss_fn = _port_loss(cfg)
    batch = (torch.from_numpy(z), torch.from_numpy(t))
    batch64 = d64(batch)
    plan = mesh.make_mesh(devices=cpus(n))
    l1, a1, g1 = _grads(d64(bridge_zoo(jparams)), loss_fn, *batch64)
    mesh.MOVES.clear()
    ln, an, gn = _grads(d64(bridge_zoo(jparams)), tcommon.shard_loss(plan, loss_fn), *batch64)
    assert moves() == {"broadcast": 1, "scatter": 2, "reduce": 1, "gather": 1}
    assert abs(float(ln) - float(l1)) <= 1e-10 * abs(float(l1))
    assert abs(float(an["mean_img"]) - float(a1["mean_img"])) <= 1e-10 * abs(
        float(a1["mean_img"]))
    scale = float(a1["img"].abs().max())
    assert float((an["img"] - a1["img"]).abs().max()) <= 1e-10 * scale
    grads_close(gn, g1, 1e-10)

    l32, _, g32 = _grads(bridge_zoo(jparams), tcommon.shard_loss(plan, loss_fn), *batch)
    for got in (float(l32), jloss):
        assert abs(got - float(l1)) <= 1e-5 * abs(float(l1))
    f32_no_worse(g32, jgrads, g1)

    tx = tcommon.adam_with_clip(LR)
    after = []
    for p in (None, plan):
        params = d64(bridge_zoo(jparams))
        step = tcommon.make_train_step(loss_fn, tx, plan=p)
        params, _, aux = step(params, tx.init(params), *batch64)
        after.append((params, aux))
    (p1, aux1), (pn, auxn) = after
    for k in ("loss", "grad_norm"):
        assert abs(float(auxn[k]) - float(aux1[k])) <= 1e-10 * float(aux1[k]), k
    for a, b in zip(tensor_leaves(pn), tensor_leaves(p1)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=LR / 5)


def _centred_clip(clip, crops):
    """The CLIP tower with ln_post's beta set so that the embeddings of
    `crops` average to zero: a random tower embeds every image along nearly
    one direction, so the 1 - cos losses would sit at the f32 noise floor
    (tests/test_torch_port_train.py's centered_clip, on the port's tree)."""
    c = dict(clip, ln_post=dict(clip["ln_post"], beta=torch.zeros_like(clip["ln_post"]["beta"])))
    e0 = encoders.clip_image_embed(c, crops)
    c["ln_post"]["beta"] = -(e0.mean(0) @ torch.linalg.pinv(c["proj"]))
    return c


def test_blending_step_on_mesh():
    """The blending step (micro: 64^2 generator at 128 channels, CLIP 64 x 2
    centred on the batch's crops, B=2) over [cpu] * 2 equals the one-device
    step in float64 (losses, params after Adam); a step scatters the 8
    batch tensors, broadcasts the params and reduces once (the frozen nets
    are replicated when the step is made). One f32 step on the mesh is a
    smoke check: finite terms and params, every module moved."""
    cfg = HairFastConfig(stylegan=StyleGANConfig(size=64, max_channels=128))
    clip = clip_vit.init_clip_image_tower(width=64, layers=2, embed_dim=512)
    w32 = fill_random({"generator": tsg.init_generator_params(cfg.stylegan), "clip": clip,
                       "mods": encoders.init_blending_model(clip)["mods"]}, 3)
    w = d64(w32)
    batch = [torch.from_numpy(x).double() for x in blend_batch(np.random.default_rng(4), 2)]
    crops = torch.cat([batch[4] * batch[5], batch[3] * batch[6]])
    frozen = {"generator": w["generator"], "clip": _centred_clip(w["clip"], crops)}

    frozen32 = {"generator": w32["generator"], "clip": _centred_clip(w32["clip"], crops.float())}
    step, tx = tbl.make_blending_train_step(frozen32, cfg, lr=LR,
                                            plan=mesh.make_mesh(devices=cpus(2)))
    p0 = {"mods": copy(w32["mods"])}
    p32, _, a32 = step(p0, tx.init(p0), *[t.float() for t in batch])
    assert all(np.isfinite(float(a32[k])) for k in ("loss", "face_loss", "hair_loss",
                                                      "grad_norm"))
    for k, (moved, init) in enumerate(zip(p32["mods"], w32["mods"])):
        new, old = tensor_leaves(moved), tensor_leaves(init)
        assert all(bool(torch.isfinite(a).all()) for a in new), k
        assert any(not torch.equal(a, b) for a, b in zip(new, old)), k

    after = []
    for plan in (None, mesh.make_mesh(devices=cpus(2))):
        step, tx = tbl.make_blending_train_step(frozen, cfg, lr=LR, plan=plan)
        params = {"mods": copy(w["mods"])}
        mesh.MOVES.clear()
        params, _, aux = step(params, tx.init(params), *batch)
        assert moves() == ({} if plan is None else {"scatter": 8, "broadcast": 1, "reduce": 1})
        after.append((params, aux))
    (p1, a1), (pn, an) = after
    assert float(a1["loss"]) > 0.1  # centred: far above the f32 floor of 1 - cos
    for k in ("loss", "face_loss", "hair_loss", "grad_norm"):
        assert abs(float(an[k]) - float(a1[k])) <= 1e-10 * abs(float(a1[k])), k
    for a, b in zip(tensor_leaves(pn), tensor_leaves(p1)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=LR / 5)


# -- the discriminator ------------------------------------------------------


@pytest.fixture(scope="module")
def disc64():
    """A float64 discriminator at 32^2 (64 channels) and 8 real and 8 fake
    images."""
    cfg = StyleGANConfig(size=32, max_channels=64)
    d = map_tree(init_discriminator(cfg, seed=4), lambda _, t: t.double())
    rng = np.random.default_rng(9)
    real, fake = (torch.from_numpy(rng.uniform(-1, 1, (8, 32, 32, 3))) for _ in range(2))
    return d, real, fake


def test_minibatch_stddev_spans_the_global_batch(disc64):
    """On a mesh of 2 the stddev groups are the global batch's (sample i
    with i + 2, i + 4, i + 6, on both shards): the logits equal the
    one-device D's; per-shard groups give other logits (by far more than
    the 1e-10 at which float64 holds the same computation)."""
    d, real, _ = disc64
    plan = mesh.make_mesh(devices=cpus(2))
    one = D.discriminator(d, real)
    mesh.MOVES.clear()
    sharded = D.discriminator(d, mesh.shard_batch(plan, real), plan)
    assert moves() == {"scatter": 2, "gather": 1}  # the batch; the stddev map out and back
    assert float((torch.cat(sharded) - one).abs().max()) <= 1e-10
    per_shard = torch.cat([D.discriminator(d, x) for x in real.chunk(2)])
    assert float((per_shard - one).abs().max()) > 1e-6


def test_disc_step_and_r1_on_mesh(disc64):
    """The discriminator step and R1 over [cpu] * 2 equal the one-device
    ones in float64 (loss, every gradient, params after Adam). A disc step
    reduces once and gathers the stddev map once per D call (real, fake)."""
    d, real, fake = disc64
    plan = mesh.make_mesh(devices=cpus(2))
    l1, _, g1 = _grads(copy(d), tpp.pp_disc_loss, real, fake)
    mesh.MOVES.clear()
    ln, aux, gn = _grads(copy(d), lambda p, r, f: tpp.pp_disc_loss(p, r, f, plan), real, fake)
    assert moves() == {"broadcast": 1, "scatter": 2 + 2, "gather": 2, "reduce": 1}
    assert abs(float(ln - l1)) <= 1e-10 and float(aux["disc_adv"]) == float(ln.detach())
    grads_close(gn, g1, 1e-10)

    steps = [tpp.make_pp_train_steps({}, lr=LR, use_adv=True, plan=p) for p in (None, plan)]
    after = []
    for _, disc_step, r1_step, _, d_tx in steps:
        params = copy(d)
        params, _, daux = disc_step(params, d_tx.init(params), real, fake)
        after.append((params, float(daux["loss"]), float(r1_step(d, real))))
    (p1, dl1, r1), (pn, dln, rn) = after
    assert abs(dln - dl1) <= 1e-10 and abs(rn - r1) <= 1e-10 * abs(r1) and r1 > 0
    for a, b in zip(tensor_leaves(pn), tensor_leaves(p1)):
        assert float((a - b).abs().max()) <= 1e-10


# -- the CLIs on a data mesh ------------------------------------------------


def _records(log):
    return [json.loads(line) for line in log.read_text().splitlines()]


def _same_logs(a, b):
    """Record by record, each value within 1e-5 of the record's largest
    |value| or 20 ulps of 1.0 (the module docstring)."""
    ra, rb = _records(a), _records(b)
    assert len(ra) == len(rb) and ra
    for x, y in zip(ra, rb):
        assert sorted(x) == sorted(y)
        tol = max(1e-5 * max(abs(v) for k, v in y.items() if k != "step"), 20 * 2.0 ** -23)
        for k in x:
            assert abs(x[k] - y[k]) <= tol, (k, x[k], y[k], tol)


def _run_both(monkeypatch, tmp_path, run, capsys):
    """run(out_dir) once on the one CPU and once on [cpu] * 2 -> the two logs."""
    logs = []
    for n in (1, 2):
        monkeypatch.setattr(mesh, "local_devices", lambda device, n=n: cpus(n))
        out = tmp_path / f"n{n}"
        out.mkdir()
        run(out)
        logs.append(out / "log.jsonl")
    assert "[mesh]" not in capsys.readouterr().out  # batch 2 fills both meshes
    return logs


def test_blending_cli_on_mesh(tmp_path, monkeypatch, capsys):
    data = _make_blending_rows(tmp_path)
    logs = _run_both(monkeypatch, tmp_path, lambda out: train_blending.main(
        ["--data_dir", str(data), "--zoo_dir", str(tmp_path / "nozoo"), "--tiny",
         "--device", "cpu", "--epochs", "1", "--batch_size", "2", "--test_frac", "0.5",
         "--ckpt_dir", str(out / "ckpt"), "--log", str(out / "log.jsonl")]), capsys)
    _same_logs(*logs)


def test_rotate_cli_on_mesh(tmp_path, monkeypatch, capsys):
    pose, hair = _make_rows(tmp_path)
    logs = _run_both(monkeypatch, tmp_path, lambda out: train_rotate.main(
        ["--pose_dir", str(pose), "--hair_dir", str(hair), "--zoo_dir", str(tmp_path / "nozoo"),
         "--tiny", "--no_keypoints", "--device", "cpu", "--epochs", "1", "--batch_size", "2",
         "--test_frac", "0.5", "--ckpt_dir", str(out / "ckpt"), "--log",
         str(out / "log.jsonl")]), capsys)
    _same_logs(*logs)


def test_pp_enc_step_on_mesh():
    """The fused PostProcess step with the discriminator (128^2 generator at
    32 channels, trunks at width 0.25, as chip_smoke's micro PP steps) at
    B=2 over [cpu] * 2
    logs the one-device step's terms and gathers its renders. Moves per
    step: the params and the discriminator broadcast, the 4 batch tensors
    scattered, the stddev map gathered and scattered back, the 3 batched
    renders of its aux gathered, one reduce. (train_pp's own mesh code runs
    at n = 1 in tests/test_torch_port_pp_cli.py; a run of the CLI per mesh
    would take this file past its time budget.)"""
    shapes, cfg = micro_zoo_shapes(max_channels=32)
    zoo = fill_random({k: shapes[k] for k in ("generator", "post_process")}, 0)
    frozen = pp_train_frozen(zoo["generator"], 0.25, seed=0)
    disc = init_discriminator(cfg.stylegan, seed=1)
    rng = np.random.default_rng(13)
    batch = [torch.from_numpy(rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32))
             for _ in range(2)]
    batch += [torch.from_numpy((rng.random((2, 256, 256, 1)) > 0.5).astype(np.float32))
              for _ in range(2)]
    auxs = []
    for plan in (None, mesh.make_mesh(devices=cpus(2))):
        step, _, _, tx, _ = tpp.make_pp_train_steps(frozen, cfg=cfg, lr=LR, use_adv=True,
                                                    plan=plan)
        params = copy(zoo["post_process"])
        mesh.MOVES.clear()
        auxs.append(step(params, tx.init(params), *batch, disc, 0.5)[2])
        assert moves() == ({} if plan is None else
                           {"broadcast": 2, "scatter": 4 + 1, "gather": 1 + 3, "reduce": 1})
    one, two = auxs
    assert sorted(one) == sorted(two) and float(two["adv"]) != 0
    tol = 1e-5 * float(one["loss"])
    for k, v in one.items():
        if v.ndim == 0:
            assert abs(float(two[k]) - float(v)) <= tol, (k, float(two[k]), float(v))
        else:  # the gathered renders
            assert float((two[k] - v).abs().max()) <= 1e-5 * float(v.abs().max()), k
