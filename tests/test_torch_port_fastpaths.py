"""The port's fast-path opt-ins against the JAX package's, f32, CPU:
paired shape modules (shape_module_pair, cfg.pair_shape_modules), the
rotate render cut short or parsed smaller (cfg.rot_render_pairs,
cfg.rot_seg_size), the fused up-blur (modulated_conv2d(fuse_blur=True)),
the packed zoo (zoo.pack_zoo and the packed e4e / FSE / SEAN forwards, and
the bridge of a JAX-packed zoo) and scripts/fastpath_agreement.

On the micro zoo (`init_micro_zoo_fast(0)` through
tests/torch_port_util.lively), bridged; the stage inputs are the port's
embedding of the first `_pipeline_setup` triple with discs of hair painted
into the labels (a mask test on a hairless mask would pass by accident).

Tolerances:
- argmax labels (rot_mask, target_mask, HM_X): equal on >= 99.9% of the
  pixels, the JAX package's own bar for its paired path
  (tests/test_pipeline.py): a B=2 batch sums in another order than B=1, and
  a near-tie of two logits may flip at an isolated pixel. Binary masks
  read from the inputs (hair_mask1/2) are equal.
- the fused up-blur: rtol 1e-4, atol 1e-5, as tests/test_ops_golden.py
  holds the JAX package's fused path.
- the packed forwards: 1e-5 of the reference's largest magnitude, against
  the JAX packed forwards and the port's own unpacked forwards: the same
  products summed in another order.
- the swaps with pack_zoo or paired shape modules against the default swap:
  5e-3 max and 2e-4 mean on the [0,1] image, the JAX package's tolerance
  for its packed swap.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairfastgan_tpu import ops as jops
from hairfastgan_tpu import zoo as jzoo
from hairfastgan_tpu.config import HairFastConfig
from hairfastgan_tpu.config import StyleGANConfig as JSG
from hairfastgan_tpu.models import bisenet as jbis
from hairfastgan_tpu.models import e4e as je4e
from hairfastgan_tpu.models import iresnet as jir
from hairfastgan_tpu.models import sean as jsean
from hairfastgan_tpu.models import stylegan2 as jsg
from hairfastgan_tpu.pipeline import alignment as jal
from hairfastgan_torch import zoo as tzoo
from hairfastgan_torch.api import HairFast
from hairfastgan_torch.config import StyleGANConfig as TSG
from hairfastgan_torch.models import bisenet as tbis
from hairfastgan_torch.models import e4e as te4e
from hairfastgan_torch.models import iresnet as tir
from hairfastgan_torch.models import sean as tsean
from hairfastgan_torch.ops.modconv import modulated_conv2d
from hairfastgan_torch.params.bridge import bridge_zoo, map_tree
from hairfastgan_torch.parallel.spatial import SpatialPlan
from hairfastgan_torch.pipeline import alignment as tal
from hairfastgan_torch.pipeline.embedding import embed_images
from hairfastgan_torch.pipeline.swap import hair_fast
from hairfastgan_torch.scripts import fastpath_agreement
from hairfastgan_torch.scripts.upload_res_agreement import BISENET_SEED
from tests.test_torch_port_parallel import _init_law
from tests.torch_port_util import REL, close, graft_triples, lively

torch.set_num_threads(2)
LABEL_BAR = 0.999
PACKED_REL = 1e-5


@pytest.fixture(scope="module")
def micro():
    jz, cfg = jzoo.init_micro_zoo_fast(0)
    jz = lively(jz)
    return jz, bridge_zoo(jz), cfg


def painted(labels, cy, cx, label, r=48):
    yy, xx = np.mgrid[:256, :256]
    labels = np.array(labels)
    labels[:, (yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = label
    return labels


@pytest.fixture(scope="module")
def triple(micro):
    return [torch.from_numpy(x[:1]) for x in graft_triples(micro[2].stylegan.size)]


@pytest.fixture(scope="module")
def embeds(micro, triple):
    """(face, shape, color) embeddings as numpy, hair discs in the labels."""
    _, tz, cfg = micro
    with torch.inference_mode():
        emb = embed_images(tz, torch.cat(triple), mix=True, cfg=cfg)
    out = []
    for i, (cy, cx) in enumerate(((96, 128), (128, 96), (150, 150))):
        e = {k: v[i:i + 1].numpy() for k, v in emb.items()}
        e["mask"] = painted(e["mask"], cy, cx, cfg.hair_label)
        out.append(e)
    return out


def to_torch(e):
    return {k: torch.from_numpy(np.array(v)) for k, v in e.items()}


def agree(got, ref, key):
    a, b = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert a.shape == b.shape, key
    frac = float((a == b).mean())
    assert frac >= LABEL_BAR, f"{key}: {frac}"


def held(got, ref):
    """Hair masks equal; the labels and HM_X on >= 99.9% of the pixels."""
    assert sorted(got) == sorted(ref)
    for k in ("hair_mask1", "hair_mask2"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    for k in ("target_mask", "rot_mask", "HM_X"):
        agree(got[k], ref[k], k)
    assert 0 < float(np.asarray(ref["HM_X"]).mean()) < 1  # no trivial target


# --- paired shape modules ------------------------------------------------------

@pytest.fixture(scope="module")
def pair_inputs(embeds):
    """(face, shape, color) at B=2, each row another image: a face code
    tiled in the wrong order would pair a face with another row's hair."""
    e = embeds
    return [{k: np.concatenate([e[i][k], e[j][k]]) for k in e[0]}
            for i, j in ((0, 1), (1, 2), (2, 0))]


@pytest.fixture(scope="module")
def port_pair(micro, pair_inputs):
    _, tz, cfg = micro
    with torch.inference_mode():
        return tal.shape_module_pair(tz, *map(to_torch, pair_inputs), cfg=cfg)


def test_shape_module_pair_matches_jax(micro, pair_inputs, port_pair):
    jz, _, cfg = micro
    ref = jax.jit(lambda z, a, b, c: jal.shape_module_pair(z, a, b, c, cfg=cfg))(
        jz, *pair_inputs)
    for got, want in zip(port_pair, ref):
        held({k: v.numpy() for k, v in got.items()}, want)


def test_shape_module_pair_matches_two_calls(micro, pair_inputs, port_pair):
    _, tz, cfg = micro
    face, shape, color = map(to_torch, pair_inputs)
    with torch.inference_mode():
        refs = [tal.shape_module(tz, face, e2, cfg=cfg) for e2 in (shape, color)]
    for got, ref in zip(port_pair, refs):
        held(got, ref)


# --- the rotate render cut short or parsed smaller -----------------------------

ROT = {"pairs": dict(rot_render_pairs=4), "seg": dict(rot_seg_size=64),
       "both": dict(rot_render_pairs=4, rot_seg_size=32)}


def _rot_cfg(cfg, name):
    return HairFastConfig(stylegan=cfg.stylegan, **ROT[name])


@pytest.mark.parametrize("name", sorted(ROT))
def test_rotate_and_segment_matches_jax(micro, embeds, name):
    jz, tz, cfg = micro
    rcfg = _rot_cfg(cfg, name)
    face, shape = embeds[0], embeds[1]
    ref = jax.jit(lambda z, w2, w1: jal._rotate_and_segment(
        z, w2, w1, cfg=rcfg, dtype=np.float32, noise_key=None))(jz, shape["W"],
                                                                  face["W"][:, :6])
    with torch.inference_mode():
        got = tal._rotate_and_segment(tz, torch.from_numpy(shape["W"]),
                                      torch.from_numpy(face["W"][:, :6]), cfg=rcfg,
                                      dtype=torch.float32, generator=None)
        full = tal._rotate_and_segment(tz, torch.from_numpy(shape["W"]),
                                       torch.from_numpy(face["W"][:, :6]), cfg=cfg,
                                       dtype=torch.float32, generator=None)
    agree(got.numpy(), ref, name)
    assert got.shape == (1, 256, 256)
    assert not torch.equal(got, full)  # the option changed the parse


def test_rotate_render_pairs_banded(micro, embeds):
    """With `sp` the cut render is the banded one: its end pair reaches the
    bands (from_res 32 bands pairs 3-4 of a render stopped at pair 4)."""
    _, tz, cfg = micro
    rcfg = _rot_cfg(cfg, "pairs")
    sp = SpatialPlan(devices=(torch.device("cpu"),) * 2, from_res=32, halo=8)
    w2, w1 = torch.from_numpy(embeds[1]["W"]), torch.from_numpy(embeds[0]["W"][:, :6])
    with torch.inference_mode():
        banded = tal._rotate_and_segment(tz, w2, w1, cfg=rcfg, dtype=torch.float32,
                                         generator=None, sp=sp)
        plain = tal._rotate_and_segment(tz, w2, w1, cfg=rcfg, dtype=torch.float32,
                                        generator=None)
    agree(banded.numpy(), plain.numpy(), "banded")


# --- the fused up-blur ---------------------------------------------------------

@pytest.mark.parametrize("b,cin,cout,hw,demodulate", [(2, 6, 8, 8, True), (1, 16, 4, 5, True),
                                                      (2, 8, 8, 4, False)])
def test_fused_up_blur(b, cin, cout, hw, demodulate):
    rng = np.random.default_rng(40 + hw)
    x = rng.standard_normal((b, hw, hw, cin), dtype=np.float32)
    w = rng.standard_normal((3, 3, cin, cout), dtype=np.float32)
    style = rng.standard_normal((b, 16), dtype=np.float32)
    mod_w = rng.standard_normal((16, cin), dtype=np.float32)
    jp = {"w": w, "modulation": {"w": mod_w, "b": np.ones(cin, np.float32)}}
    ref = np.asarray(jops.modulated_conv2d(jp, x, style, up=True, fuse_blur=True,
                                           demodulate=demodulate))
    tp = bridge_zoo(jp)
    xt, st = torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(style)
    fused = modulated_conv2d(tp, xt, st, up=True, fuse_blur=True, demodulate=demodulate)
    two_pass = modulated_conv2d(tp, xt, st, up=True, demodulate=demodulate)
    assert fused.shape == two_pass.shape == (b, cout, 2 * hw, 2 * hw)
    np.testing.assert_allclose(fused.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(fused.numpy(), two_pass.numpy(), rtol=1e-4, atol=1e-5)


# --- the packed zoo ------------------------------------------------------------

@pytest.fixture(scope="module")
def packed(micro):
    jz, tz, _ = micro
    return jzoo.pack_zoo(jz), tzoo.pack_zoo(tz)


def _image(seed, b):
    return np.random.default_rng(seed).uniform(-1, 1, (b, 256, 256, 3)).astype(np.float32)


def _labels(seed, b=2):
    small = np.random.default_rng(seed).integers(0, 19, size=(b, 16, 16))
    return np.repeat(np.repeat(small, 16, axis=1), 16, axis=2).astype(np.int32)


def test_packed_layouts(micro, packed):
    jz, tz, _ = micro
    jp, tp = packed
    assert "styles_packed" in tp["e4e"] and "styles" not in tp["e4e"]
    assert "styles_w" in tp["fse"] and "styles_w" in tp["post_process"]["encoder_face"]
    assert "fc_mu_w" in tp["sean"]["head0"]["ace0"]
    assert "gb" in tp["sean"]["up3"]["ace0"]["spade"]  # up3's ACEs have no fc_mu
    # idempotent: packing twice changes no leaf
    again = tzoo.pack_zoo(tp)
    flat = lambda z: [v for v in _leaves(z)]  # noqa: E731
    assert all(a is b for a, b in zip(flat(again), flat(tp)))
    assert len(flat(again)) == len(flat(tp))
    # the bridge of a JAX-packed zoo is the port's pack of the bridged zoo
    bridged = bridge_zoo(jp)
    assert _structure(bridged) == _structure(tp)
    for a, b in zip(flat(bridged), flat(tp)):
        assert a.shape == b.shape and torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _structure(tree):
    return map_tree(tree, lambda key, t: (key, tuple(t.shape)))


def test_packed_e4e(micro, packed):
    x = _image(41, 3)
    ref = jax.jit(je4e.e4e_encode)(packed[0]["e4e"], x)
    got = te4e.e4e_encode(packed[1]["e4e"], torch.from_numpy(x))
    close(got.numpy(), ref, rel=PACKED_REL)
    close(got.numpy(), te4e.e4e_encode(micro[1]["e4e"], torch.from_numpy(x)).numpy(),
          rel=PACKED_REL)


@pytest.mark.parametrize("tree", ["fse", "encoder_face"])
def test_packed_fs_encode(micro, packed, tree):
    pick = (lambda z: z["fse"]) if tree == "fse" else (lambda z: z["post_process"]["encoder_face"])
    x = _image(42, 2)
    s_ref, _ = jax.jit(jir.fs_encode)(pick(packed[0]), x)
    s, _ = tir.fs_encode(pick(packed[1]), torch.from_numpy(x))
    close(s.numpy(), s_ref, rel=PACKED_REL)
    close(s.numpy(), tir.fs_encode(pick(micro[1]), torch.from_numpy(x))[0].numpy(),
          rel=PACKED_REL)


def test_packed_sean(micro, packed):
    codes = np.random.default_rng(43).standard_normal((2, 19, 512)).astype(np.float32) * 0.5
    codes[0, 3] = 0.0  # one empty region: the mean_codes fallback
    target = _labels(44)
    ref = jax.jit(jsean.sean_decode)(packed[0]["sean"], codes, target)
    got = tsean.sean_decode(packed[1]["sean"], torch.from_numpy(codes), torch.from_numpy(target))
    close(got.numpy(), ref, rel=PACKED_REL)
    close(got.numpy(), tsean.sean_decode(micro[1]["sean"], torch.from_numpy(codes),
                                         torch.from_numpy(target)).numpy(), rel=PACKED_REL)


# --- the swap with each opt-in against the default swap -----------------------

@pytest.fixture(scope="module")
def default_swap(micro, triple):
    _, tz, cfg = micro
    with torch.inference_mode():
        return hair_fast(tz, *triple, cfg=cfg, return_intermediate=True)


def _image_close(got, ref):
    d = (got - ref).abs()
    assert float(d.max()) <= 5e-3 and float(d.mean()) <= 2e-4, (float(d.max()), float(d.mean()))


def test_hair_fast_packed_zoo(micro, packed, triple, default_swap):
    cfg = micro[2]
    with torch.inference_mode():
        got = hair_fast(packed[1], *triple, cfg=cfg)
    _image_close(got, default_swap[0])


def test_hair_fast_paired_shape_modules(micro, triple, default_swap):
    _, tz, cfg = micro
    pcfg = HairFastConfig(stylegan=cfg.stylegan, pair_shape_modules=True)
    with torch.inference_mode():
        got, inter = hair_fast(tz, *triple, cfg=pcfg, return_intermediate=True)
    _image_close(got, default_swap[0])
    ref_inter = default_swap[1]
    agree(inter["HM_X"].numpy(), ref_inter["HM_X"].numpy(), "HM_X")
    close(inter["latent_F_align"].numpy(), ref_inter["latent_F_align"].numpy(), rel=2e-4)


@pytest.mark.parametrize("opt", [dict(pair_shape_modules=True), dict(rot_render_pairs=4),
                                 dict(rot_seg_size=64)])
def test_api_swaps_with_opt_ins(micro, opt):
    """HairFast takes each opt-in (no config is refused) and swaps."""
    _, tz, cfg = micro
    hf = HairFast(HairFastConfig(stylegan=cfg.stylegan, compute_dtype="float32", **opt),
                  zoo=tz, device="cpu")
    rng = np.random.default_rng(45)
    imgs = [rng.integers(0, 256, (128, 128, 3), dtype=np.uint8) for _ in range(3)]
    out = hf.swap(*imgs, seed=1)
    assert out.shape == (128, 128, 3) and np.isfinite(out).all()
    assert out.min() >= 0 and out.max() <= 1


# --- scripts/fastpath_agreement ------------------------------------------------

# the keys scripts/fastpath_agreement.py (the JAX package's) prints
JAX_KEYS = {"seg512": {"label_agreement", "nonmodal_agreement", "hair_iou"},
            "pairs6": {"label_agreement", "nonmodal_agreement", "hair_iou"},
            "pairs6_seg512": {"label_agreement", "nonmodal_agreement", "hair_iou"},
            "_diagnostics": {"classes_present", "nonmodal_px_frac"}}
AGREE_CHANNELS = 16  # the 1024^2 generator at 16 channels a layer: the cuts
AGREE_BISENET_WIDTH = 0.25  # are the JAX script's fixed pair 6 and 512 parse
AGREE_VARIANTS = ("exact", "seg512", "pairs6", "pairs6_seg512")  # the scripts' parse order
HAIR = fastpath_agreement.HAIR


def _law_bisenet(seed, width):
    """A JAX-layout BiSeNet at `width` by upload_res_agreement.scaled_bisenet's
    law: conv weights 0.02 * N(0,1), zero biases, identity BatchNorm."""
    shapes = jax.eval_shape(lambda: jbis.init_bisenet(jax.random.PRNGKey(0), n_classes=19,
                                                      width=width))
    rng = np.random.default_rng(seed)
    fixed = {"gamma": 1.0, "var": 1.0, "beta": 0.0, "mean": 0.0, "b": 0.0}

    def leaf(path, x):
        key = path[-1].key
        if key in fixed:
            return np.full(x.shape, fixed[key], np.float32)
        return rng.standard_normal(x.shape, np.float32) * np.float32(0.02)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _json_printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn()
    return ret, json.loads(buf.getvalue())


def _recording_jax_segment_256(record):
    """bisenet.segment_256 of the JAX package (parse_to_celeba, then the
    nearest resize to 256) that hands each call's raw logits and 256
    labels to `record` from inside the script's jit."""
    def segment_256(p, img01):
        logits = jbis.bisenet_logits(p, jbis.to_bisenet_input(img01))
        lab = jnp.argmax(logits[..., jnp.asarray(jbis.FACE_PARSING_TO_CELEBA)], axis=-1)
        out = jbis.resize(lab[..., None].astype(jnp.float32), (256, 256), "nearest")
        out = out[..., 0].astype(jnp.int32)
        jax.debug.callback(lambda lg, o: record.append((np.array(o), np.array(lg))),
                           logits, out)
        return out

    return segment_256


def _recording_port_parse(record, mp):
    """Patch the port's parse_render and bisenet_logits_nchw so that each
    parse hands its 256 labels and its raw logits (NHWC) to `record`."""
    logits_seen = []
    logits_fn, parse = tbis.bisenet_logits_nchw, tal.parse_render

    def bisenet_logits_nchw(p, x):
        out = logits_fn(p, x)
        logits_seen.append(out.permute(0, 2, 3, 1).numpy().copy())
        return out

    def parse_render(bisenet_p, rgb, seg_size):
        labels = parse(bisenet_p, rgb, seg_size)
        record.append((labels.numpy().copy(), logits_seen.pop()))
        return labels

    mp.setattr(tbis, "bisenet_logits_nchw", bisenet_logits_nchw)
    mp.setattr(tal, "parse_render", parse_render)


def _parse_pairs(port, jax_, variants):
    """The two scripts' parses, call by call (batch by batch, each batch in
    the variants' order) -> per call: the variant, both 256 label maps, the
    largest |logit| difference, the JAX logits' largest |value|, and the
    JAX logits' top-two gap at each 512 pixel whose argmax differs."""
    perm = np.asarray(jbis.FACE_PARSING_TO_CELEBA)
    assert len(port) == len(jax_) and len(port) % len(variants) == 0
    pairs = []
    for c, ((tlab, tlg), (jlab, jlg)) in enumerate(zip(port, jax_)):
        assert tlab.shape == jlab.shape and tlg.shape == jlg.shape
        top2 = np.sort(jlg, axis=-1)[..., -2:]
        flipped = tlg[..., perm].argmax(-1) != jlg[..., perm].argmax(-1)
        pairs.append({"variant": variants[c % len(variants)], "port": tlab, "jax": jlab,
                      "delta": float(np.abs(tlg - jlg).max()), "scale": float(np.abs(jlg).max()),
                      "gaps": (top2[..., 1] - top2[..., 0])[flipped]})
    return pairs


@pytest.fixture(scope="module")
def agreement_runs():
    """The JAX package's scripts/fastpath_agreement.py and the port's, both
    in-process on the CPU at --n 2 --batch 2, on the same weights and
    latents: the 1024^2 generator at 16 channels drawn by its init's law
    (the port's own scaled_generator draw; the JAX script's is replaced by
    the same tree), a narrowed BiSeNet by scaled_bisenet's law, and the
    port's --seed 0 latents handed to the JAX script in place of its
    jax.random draws. The renders run in f32 on both sides (in the
    scripts' bf16 the two packages round apart and labels move), and neither script rounds what it prints (a
    module-level `round` shadows the builtin), so the comparison sees every
    pixel. Each f32 parse's labels and raw logits are recorded on both
    sides (the JAX package folds norms and demodulation in f32 even for f64
    inputs, so it has no f64 run to hold the port's against). Returns (the
    port CLI's bf16 result, what it printed, the port's f32 result, the JAX
    script's f32 result, the JAX generator tree, the parses of
    `_parse_pairs`)."""
    import scripts.fastpath_agreement as jfa
    from hairfastgan_tpu import config as jconfig
    from hairfastgan_torch import config as tconfig

    jsg_cfg = JSG(max_channels=AGREE_CHANNELS)
    jcfg = dataclasses.replace(HairFastConfig(), stylegan=jsg_cfg)
    gen = _init_law(jax.eval_shape(
        lambda: jsg.init_generator_params(jax.random.PRNGKey(0), jsg_cfg)), 0)
    bis = _law_bisenet(BISENET_SEED, AGREE_BISENET_WIDTH)
    g = torch.Generator()
    g.manual_seed(0)  # the port's latents: --seed 0, one generator, batch by batch
    synthesis = jsg.synthesis
    jrec, trec = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig, "HairFastConfig", lambda: jcfg)
        mp.setattr(jsg, "init_generator_params", lambda key, cfg: gen)
        mp.setattr(jsg, "synthesis", lambda *a, dtype=None, **kw: synthesis(*a, **kw))
        mp.setattr(jbis, "init_bisenet", lambda key, n_classes: bis)
        mp.setattr(jbis, "segment_256", _recording_jax_segment_256(jrec))
        mp.setattr(jax.random, "normal", lambda key, shape: jnp.asarray(
            torch.randn(shape, generator=g).numpy()))
        mp.setattr("sys.argv", ["fastpath_agreement", "--n", "2", "--batch", "2"])
        mp.setattr(jfa, "round", lambda x, ndigits=None: x, raising=False)
        _, ref = _json_printed(jfa.main)
    sg = TSG(max_channels=AGREE_CHANNELS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fastpath_agreement, "scaled_bisenet", lambda seed, device: bridge_zoo(bis))
        mp.setattr(fastpath_agreement, "round", lambda x, ndigits=None: x, raising=False)
        with pytest.MonkeyPatch.context() as rec:
            _recording_port_parse(trec, rec)
            got32 = fastpath_agreement.measure(sg, n=2, batch=2, seed=0, device="cpu",
                                               dtype=torch.float32)
        mp.setattr(tconfig, "StyleGANConfig", lambda: sg)
        got, printed = _json_printed(lambda: fastpath_agreement.main(
            ["--n", "2", "--batch", "2", "--device", "cpu"]))
    pairs = _parse_pairs(trec, jrec, AGREE_VARIANTS)
    return got, printed, got32, ref, gen, pairs


def test_fastpath_agreement_generator_law(agreement_runs):
    """The port's scaled_generator is the JAX init law's tree, bridged."""
    gen = agreement_runs[4]
    port = fastpath_agreement.scaled_generator(TSG(max_channels=AGREE_CHANNELS), 0)
    ref = bridge_zoo(gen)
    assert _structure(port) == _structure(ref)
    for a, b in zip(_leaves(port), _leaves(ref)):
        assert torch.equal(a, b)


def test_fastpath_agreement_cli(agreement_runs):
    got, printed, _, ref, _, _ = agreement_runs
    assert printed == got
    assert {k: set(v) for k, v in got.items()} == {k: set(v) for k, v in ref.items()} == JAX_KEYS


def _agreement_bounds(pairs, variant):
    """How far each metric of `variant` may move when the port's labels
    differ from the JAX script's at d_k pixels of the cut and d_e of the
    exact parse (counted per batch, at 256), each batch's bound averaged
    over the batches as the scripts average the metrics:
      label_agreement     (d_k + d_e) / (B * 256^2)
      nonmodal_agreement  (d_k + 2 d_e) / M, M the smaller count of
                          non-modal pixels (a flip moves a match and the
                          pixel's membership; the modal class is the same)
      hair_iou            2 (d_k + d_e) / max(U, 1), U the smaller union
      classes_present     2 d_e (a flip adds a class or takes one away)
      nonmodal_px_frac    d_e / (n * 256^2)"""
    n_v = len(AGREE_VARIANTS)
    n_b = len(pairs) // n_v
    bounds = {"label_agreement": 0.0, "nonmodal_agreement": 0.0, "hair_iou": 0.0,
              "classes_present": 0.0, "nonmodal_px_frac": 0.0}
    for b in range(n_b):
        parses = {p["variant"]: (p["port"], p["jax"]) for p in pairs[b * n_v:(b + 1) * n_v]}
        te, je = parses["exact"]
        d_e = int((te != je).sum())
        modal = [int(np.bincount(x.ravel(), minlength=19).argmax()) for x in (te, je)]
        assert modal[0] == modal[1]
        bounds["classes_present"] += 2 * d_e
        bounds["nonmodal_px_frac"] += d_e / (n_b * te.size)
        if variant == "_diagnostics":
            continue
        tk, jk = parses[variant]
        d_k = int((tk != jk).sum())
        m = min(int((te != modal[0]).sum()), int((je != modal[0]).sum()))
        u = min(int(((tk == HAIR) | (te == HAIR)).sum()), int(((jk == HAIR) | (je == HAIR)).sum()))
        bounds["label_agreement"] += (d_k + d_e) / te.size / n_b
        bounds["nonmodal_agreement"] += (d_k + 2 * d_e) / max(m, 1) / n_b
        bounds["hair_iou"] += 2 * (d_k + d_e) / max(u, 1) / n_b
    return bounds


@pytest.mark.parametrize("variant", ["seg512", "pairs6", "pairs6_seg512", "_diagnostics"])
def test_fastpath_agreement_matches_jax(agreement_runs, variant):
    """Each cut's agreement, non-modal agreement and hair IoU, and the
    diagnostics, as the JAX script gives them on the same weights and
    latents in f32. A label may flip where two logits tie within f32
    rounding, and one flipped label moves a metric by one pixel over that
    metric's own denominator (non-modal pixels, the hair union), which can
    be far fewer than all 2 * 256^2. So the test compares the parses: the
    two packages' logits agree to 2e-4 of their largest value (the model
    parities' bound, tests/torch_port_util.REL), every pixel whose label
    differs has a JAX top-two logit gap within twice the measured logit
    difference (a tie within the two runs' rounding), and each metric is
    within the count of differing pixels over its own denominator
    (`_agreement_bounds`; zero when the labels agree, as seen here)."""
    _, _, got, ref, _, pairs = agreement_runs
    assert ref["_diagnostics"]["classes_present"] > 1  # the parser is not degenerate
    for p in pairs:
        assert p["delta"] <= REL * p["scale"], (p["variant"], p["delta"], p["scale"])
        assert (p["gaps"] <= 2 * p["delta"]).all(), (p["variant"], p["gaps"].max(), p["delta"])
    bounds = _agreement_bounds(pairs, variant)
    for k, v in ref[variant].items():
        np.testing.assert_allclose(got[variant][k], v, rtol=0, atol=bounds[k] + 1e-12,
                                   err_msg=k)
