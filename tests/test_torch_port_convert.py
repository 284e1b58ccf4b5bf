"""The port's reference-checkpoint converters (hairfastgan_torch/params/
convert.py, models/star.convert_star, zoo.load_zoo) against the JAX
package's converters followed by params/bridge.bridge_zoo.

Every case feeds one synthetic state dict, with the reference's key names
and narrow widths drawn from a numpy seed, to both sides; the trees must
have the same structure and every leaf must be equal (atol 0: both sides
do numpy's arithmetic, and the bridge only permutes axes). The StyleGAN2
state dict is tests/test_convert_stylegan2.synth_state_dict's; the others
follow tests/test_convert_plumbing.py's layouts at narrow widths, with
random norm statistics and spectral-norm SEAN convs. `write_reference_dir`
writes a whole reference pretrained_models/ tree of them, which the JAX
and the port's load_zoo must read alike.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from hairfastgan_tpu.config import HairFastConfig, StyleGANConfig
from hairfastgan_tpu.models import star as jstar
from hairfastgan_tpu.params import convert as J
from hairfastgan_tpu.zoo import load_zoo as jax_load_zoo
from hairfastgan_torch import zoo as tzoo
from hairfastgan_torch.models import star as tstar
from hairfastgan_torch.models.e4e import _blocks_50
from hairfastgan_torch.params import convert as T
from hairfastgan_torch.params.bridge import bridge_zoo
from tests.test_convert_stylegan2 import synth_state_dict
from tests.test_torch_port_zoo import flat

torch.set_num_threads(2)

SMALL_GAN = StyleGANConfig(size=32, max_channels=16)  # n_latent 8


class SD(dict):
    """A state dict under construction: reference key names, values drawn
    from `rng`."""

    def __init__(self, rng):
        super().__init__()
        self.rng = rng

    def arr(self, *shape, dtype=np.float32):
        return (self.rng.standard_normal(shape) * 0.1).astype(dtype)

    def conv(self, n, ci, co, k, bias=True):
        self[f"{n}.weight"] = self.arr(co, ci, k, k)
        if bias:
            self[f"{n}.bias"] = self.arr(co)

    def conv_sn(self, n, ci, co, k, bias=True):
        self[f"{n}.weight_orig"] = self.arr(co, ci, k, k)
        self[f"{n}.weight_u"] = self.arr(co)
        self[f"{n}.weight_v"] = self.arr(ci * k * k)
        if bias:
            self[f"{n}.bias"] = self.arr(co)

    def linear(self, n, ci, co):
        self[f"{n}.weight"] = self.arr(co, ci)
        self[f"{n}.bias"] = self.arr(co)

    def bn(self, n, c, affine=True):
        if affine:
            self[f"{n}.weight"] = 1.0 + self.arr(c)
            self[f"{n}.bias"] = self.arr(c)
        self[f"{n}.running_mean"] = self.arr(c)
        self[f"{n}.running_var"] = self.rng.uniform(0.5, 1.5, c).astype(np.float32)

    def prelu(self, n, c):
        self[f"{n}.weight"] = self.rng.uniform(0.1, 0.3, c).astype(np.float32)

    def ln(self, n, c, gamma="weight", beta="bias"):
        self[f"{n}.{gamma}"] = 1.0 + self.arr(c)
        self[f"{n}.{beta}"] = self.arr(c)

    def ibasic(self, n, ci, co):
        self.bn(f"{n}.bn1", ci)
        self.conv(f"{n}.conv1", ci, co, 3, bias=False)
        self.bn(f"{n}.bn2", co)
        self.prelu(f"{n}.prelu", co)
        self.conv(f"{n}.conv2", co, co, 3, bias=False)
        self.bn(f"{n}.bn3", co)
        if ci != co:
            self.conv(f"{n}.downsample.0", ci, co, 1, bias=False)
            self.bn(f"{n}.downsample.1", co)

    def modulation(self, n, inp=8, mid=8, dim=8):
        self.linear(f"{n}.fc", dim, dim)
        for br in ("gamma_function", "beta_function"):
            self.linear(f"{n}.{br}.0", inp, mid)
            self.ln(f"{n}.{br}.1", mid)
            self.linear(f"{n}.{br}.3", mid, dim)


def make_fs(rng, n_styles=3, multi=False) -> SD:
    """fs_encoder_v2 layout: iresnet stem, four stages of two blocks, style
    heads, one content layer (or two, FeatureEncoderMult's numbering)."""
    d = SD(rng)
    d.conv("conv.0", 3, 4, 3, bias=False)
    d.bn("conv.1", 4)
    d.prelu("conv.2", 4)
    for st, (ci, co) in zip(("block_1", "block_2", "block_3", "block_4"),
                            ((4, 4), (4, 6), (6, 8), (8, 8))):
        d.ibasic(f"{st}.0", ci, co)
        d.ibasic(f"{st}.1", co, co)
    for i in range(n_styles):
        d.linear(f"styles.{i}", 12, 8)
    for name in (("content_layer.0", "content_layer.1") if multi else ("content_layer",)):
        d.bn(f"{name}.0", 6)
        d.conv(f"{name}.1", 6, 8, 3, bias=False)
        d.bn(f"{name}.2", 8)
        d.prelu(f"{name}.3", 8)
        d.conv(f"{name}.4", 8, 8, 3, bias=False)
        d.bn(f"{name}.5", 8)
    return d


def make_e4e(rng) -> SD:
    """Encoder4Editing: the 24 bottlenecks of _blocks_50 at 1/16 width (SE
    on every other one), three style heads of 2-3 convs, lateral layers."""
    d = SD(rng)
    d.conv("input_layer.0", 3, 16, 3, bias=False)
    d.bn("input_layer.1", 16)
    d.prelu("input_layer.2", 16)
    for i, (ci, co, _) in enumerate(_blocks_50(width=1 / 16)):
        n = f"body.{i}"
        d.bn(f"{n}.res_layer.0", ci)
        d.conv(f"{n}.res_layer.1", ci, co, 3, bias=False)
        d.prelu(f"{n}.res_layer.2", co)
        d.conv(f"{n}.res_layer.3", co, co, 3, bias=False)
        d.bn(f"{n}.res_layer.4", co)
        if i % 2:
            d.conv(f"{n}.res_layer.5.fc1", co, 2, 1, bias=False)
            d.conv(f"{n}.res_layer.5.fc2", 2, co, 1, bias=False)
        if ci != co:
            d.conv(f"{n}.shortcut_layer.0", ci, co, 1, bias=False)
            d.bn(f"{n}.shortcut_layer.1", co)
    for i, n_convs in enumerate((2, 3, 3)):
        for j in range(n_convs):
            d.conv(f"styles.{i}.convs.{2 * j}", 8, 8, 3)
        d.linear(f"styles.{i}.linear", 8, 8)
    d.conv("latlayer1", 16, 8, 1)
    d.conv("latlayer2", 16, 8, 1)
    return d


def make_bisenet(rng) -> SD:
    d = SD(rng)
    d.conv("cp.resnet.conv1", 3, 4, 7, bias=False)
    d.bn("cp.resnet.bn1", 4)
    ci = 4
    for li, co in zip(range(1, 5), (4, 6, 8, 8)):
        for b in (0, 1):
            n = f"cp.resnet.layer{li}.{b}"
            cin = ci if b == 0 else co
            d.conv(f"{n}.conv1", cin, co, 3, bias=False)
            d.bn(f"{n}.bn1", co)
            d.conv(f"{n}.conv2", co, co, 3, bias=False)
            d.bn(f"{n}.bn2", co)
            if b == 0 and li > 1:
                d.conv(f"{n}.downsample.0", cin, co, 1, bias=False)
                d.bn(f"{n}.downsample.1", co)
        ci = co

    def cbr(n, cin, cout, k=3):
        d.conv(f"{n}.conv", cin, cout, k, bias=False)
        d.bn(f"{n}.bn", cout)

    for n, cin in (("cp.arm16", 8), ("cp.arm32", 8)):
        cbr(f"{n}.conv", cin, 6)
        d.conv(f"{n}.conv_atten", 6, 6, 1, bias=False)
        d.bn(f"{n}.bn_atten", 6)
    for n in ("cp.conv_head32", "cp.conv_head16"):
        cbr(n, 6, 6)
    cbr("cp.conv_avg", 8, 6, 1)
    cbr("ffm.convblk", 12, 8, 1)
    d.conv("ffm.conv1", 8, 2, 1, bias=False)
    d.conv("ffm.conv2", 2, 8, 1, bias=False)
    for n, cin in (("conv_out", 8), ("conv_out16", 6), ("conv_out32", 6)):
        cbr(f"{n}.conv", cin, 6)
        d.conv(f"{n}.conv_out", 6, 19, 1, bias=False)
    return d


def make_sean(rng) -> SD:
    """SEAN netG at ngf=2 (style codes of 8), spectral-norm block convs."""
    d = SD(rng)
    z = "Zencoder.model"
    d.conv(f"{z}.1", 3, 4, 3)
    d.conv(f"{z}.4", 4, 4, 3)
    d.conv(f"{z}.7", 4, 6, 3)
    d[f"{z}.10.weight"] = d.arr(6, 5, 3, 3)  # ConvTranspose2d [in, out, kh, kw]
    d[f"{z}.10.bias"] = d.arr(5)
    d.conv(f"{z}.14", 5, 8, 3)
    d.conv("fc", 19, 32, 3)
    d.conv("conv_img", 2, 3, 3)

    def ace(n, nc, use_rgb):
        d[f"{n}.noise_var"] = d.arr(nc)
        d.bn(f"{n}.param_free_norm", nc, affine=False)
        d.conv(f"{n}.Spade.mlp_shared.0", 19, 4, 3)
        d.conv(f"{n}.Spade.mlp_gamma", 4, nc, 3)
        d.conv(f"{n}.Spade.mlp_beta", 4, nc, 3)
        if use_rgb:
            d[f"{n}.blending_gamma"] = d.arr(1)
            d[f"{n}.blending_beta"] = d.arr(1)
            for j in range(19):
                d.linear(f"{n}.fc_mu{j}", 8, 8)
            d.conv(f"{n}.conv_gamma", 8, nc, 3)
            d.conv(f"{n}.conv_beta", 8, nc, 3)

    def block(n, fin, fout, use_rgb=True):
        fmid = min(fin, fout)
        ace(f"{n}.ace_0", fin, use_rgb)
        d.conv_sn(f"{n}.conv_0", fin, fmid, 3)
        ace(f"{n}.ace_1", fmid, use_rgb)
        d.conv_sn(f"{n}.conv_1", fmid, fout, 3)
        if fin != fout:
            ace(f"{n}.ace_s", fin, use_rgb)
            d.conv_sn(f"{n}.conv_s", fin, fout, 1, bias=False)

    for n, fin, fout in (("head_0", 32, 32), ("G_middle_0", 32, 32), ("G_middle_1", 32, 32),
                         ("up_0", 32, 16), ("up_1", 16, 8), ("up_2", 8, 4)):
        block(n, fin, fout)
    block("up_3", 4, 2, use_rgb=False)
    return d


def make_shape_adaptor(rng) -> SD:
    """CtrlHair mask encoders (3 layers) and decoders (LAYER_NUM layers)."""
    from hairfastgan_torch.models.shape_adaptor import LAYER_NUM

    d = SD(rng)
    for enc, cin, out, vae in (("hair_encoder", 41, 4, True), ("face_encoder", 58, 6, False)):
        for i in range(3):
            d.conv(f"{enc}.layers.{i}.conv", cin, 4, 4)
            d.ln(f"{enc}.layers.{i}.norm", 4, "gamma", "beta")
            cin = 4
        d.linear(f"{enc}.out_layer.fc", 16, out)
        if vae:
            d.linear(f"{enc}.std_out_layer.fc", 16, out)
    for dec, din, cout in (("hair_decoder", 10, 1), ("face_decoder", 6, 18)):
        d.linear(f"{dec}.in_layer.fc", din, 16)
        for i in range(LAYER_NUM):
            d.conv(f"{dec}.layers.{2 * i + 1}.conv", 4, 4, 3)
            d.ln(f"{dec}.layers.{2 * i + 1}.norm", 4, "gamma", "beta")
        d.conv(f"{dec}.out_layer.conv", 4, cout, 3)
    return d


def make_clip(rng) -> SD:
    """The clip package's visual tower, in half precision as it ships."""
    d = SD(rng)
    width, f16 = 8, np.float16
    d["visual.conv1.weight"] = d.arr(width, 3, 32, 32, dtype=f16)
    d["visual.class_embedding"] = d.arr(width, dtype=f16)
    d["visual.positional_embedding"] = d.arr(50, width, dtype=f16)
    d["visual.proj"] = d.arr(width, 16, dtype=f16)
    d["transformer.resblocks.0.ln_1.weight"] = d.arr(4, dtype=f16)  # text tower: ignored
    for n in ("ln_pre", "ln_post"):
        d[f"visual.{n}.weight"] = d.arr(width, dtype=f16)
        d[f"visual.{n}.bias"] = d.arr(width, dtype=f16)
    for i in range(2):
        b = f"visual.transformer.resblocks.{i}"
        d[f"{b}.attn.in_proj_weight"] = d.arr(3 * width, width, dtype=f16)
        d[f"{b}.attn.in_proj_bias"] = d.arr(3 * width, dtype=f16)
        for n, ci, co in (("attn.out_proj", width, width), ("mlp.c_fc", width, 4 * width),
                          ("mlp.c_proj", 4 * width, width)):
            d[f"{b}.{n}.weight"] = d.arr(co, ci, dtype=f16)
            d[f"{b}.{n}.bias"] = d.arr(co, dtype=f16)
        for ln in ("ln_1", "ln_2"):
            d[f"{b}.{ln}.weight"] = d.arr(width, dtype=f16)
            d[f"{b}.{ln}.bias"] = d.arr(width, dtype=f16)
    return d


def make_mods(rng, prefix, n=3) -> SD:
    d = SD(rng)
    for i in range(n):
        d.modulation(f"{prefix}.{i}")
    return d


def make_post_process(rng) -> SD:
    d = SD(rng)
    d.update({f"encoder_face.{k}": v for k, v in make_fs(rng).items()})
    for n_blk, (ci, co) in enumerate(((16, 8), (8, 8)), 1):
        d.ibasic(f"to_feature.res_blocks.res_block_{n_blk}_1", ci, co)
        d.ibasic(f"to_feature.res_blocks.res_block_{n_blk}_2", co, co)
    for i in range(2):
        d.modulation(f"to_latent_1.{i}")
        d.modulation(f"to_latent_2.{i}")
    return d


def make_star(rng, ch=8) -> SD:
    """STAR (StackedHGNetV1, WFLW heads) at `ch` channels; torch builds
    every skip_layer, used only where the widths differ."""
    d = SD(rng)

    def cb(n, ci, co, k, bn=False):
        d.conv(f"{n}.conv", ci, co, k)
        if bn:
            d.bn(f"{n}.bn", co)

    def rb(n, ci, co):
        d.bn(f"{n}.bn1", ci)
        cb(f"{n}.conv1", ci, co // 2, 1)
        d.bn(f"{n}.bn2", co // 2)
        cb(f"{n}.conv2", co // 2, co // 2, 3)
        d.bn(f"{n}.bn3", co // 2)
        cb(f"{n}.conv3", co // 2, co, 1)
        cb(f"{n}.skip_layer", ci, co, 1)

    def hg(n, lvl, first):
        for part in ("up1", "low1", "low3"):
            rb(f"{n}.{part}", ch, ch)
        if lvl > 1:
            hg(f"{n}.low2", lvl - 1, False)
        else:
            rb(f"{n}.low2", ch, ch)
        cb(f"{n}.coordconv", ch + (3 if first else 5), ch, 1)

    cb("pre.0", 6, 4, 7, bn=True)
    rb("pre.1", 4, ch)
    rb("pre.3", ch, ch)
    rb("pre.4", ch, ch)
    for i in range(4):
        hg(f"hgs.{i}", 4, i == 0)
        rb(f"features.{i}.0", ch, ch)
        cb(f"features.{i}.1", ch, ch, 1, bn=True)
        cb(f"out_heatmaps.{i}", ch, 98, 1)
        cb(f"out_pointmaps.{i}", ch, 98, 1)
        cb(f"out_edgemaps.{i}", ch, 9, 1)
        if i < 3:
            cb(f"merge_features.{i}", ch, ch, 1)
            cb(f"merge_heatmaps.{i}", 98, ch, 1)
            cb(f"merge_pointmaps.{i}", 98, ch, 1)
            cb(f"merge_edgemaps.{i}", 9, ch, 1)
    return d


def assert_same_tree(got, ref):
    """Same structure; tensors equal in dtype, shape and every value;
    Python values (strides, layer tables) equal."""
    got, ref = flat(got), flat(ref)
    assert got.keys() == ref.keys()
    for p, r in ref.items():
        g = got[p]
        if isinstance(r, torch.Tensor):
            assert isinstance(g, torch.Tensor) and g.dtype == r.dtype, p
            assert g.shape == r.shape and torch.equal(g, r), p
            assert g.is_contiguous(), p
        else:
            assert g == r, p


def _latent(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# converter name -> (state dict maker, extra arguments from an rng)
CASES = {
    "stylegan2": lambda rng: ((synth_state_dict(SMALL_GAN, np.random.RandomState(1)),), {}),
    "e4e": lambda rng: ((make_e4e(rng),), {"latent_avg": _latent(rng, 3, 8)}),
    "fs_encoder": lambda rng: ((make_fs(rng),), {"fs_layers": (5,)}),
    "fs_encoder_multi": lambda rng: ((make_fs(rng, multi=True),), {"fs_layers": (5, 3)}),
    "bisenet": lambda rng: ((make_bisenet(rng),), {"n_classes": 19}),
    "sean": lambda rng: ((make_sean(rng),), {"mean_codes": _latent(rng, 19, 8)}),
    "shape_adaptor": lambda rng: ((make_shape_adaptor(rng),), {}),
    "clip_image_tower": lambda rng: ((make_clip(rng),), {}),
    "rotate": lambda rng: ((make_mods(rng, "modulation_module_list"),), {}),
    "post_process": lambda rng: ((make_post_process(rng),), {"latent_avg": _latent(rng, 8, 8)}),
    "feature_iresnet": lambda rng: ((make_post_process(rng),), {"prefix": "to_feature.res_blocks"}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_converter_matches_jax(name):
    args, kw = CASES[name](np.random.default_rng(sorted(CASES).index(name)))
    fn = name.replace("_multi", "")
    got = getattr(T, f"convert_{fn}")(*args, **kw)
    ref = getattr(J, f"convert_{fn}")(*args, **kw)
    assert_same_tree(got, bridge_zoo(ref))


def test_convert_blending_matches_jax():
    """Blending carries the CLIP tower's tree, converted by each side."""
    rng = np.random.default_rng(20)
    sd, clip = make_mods(rng, "modulation_module_list"), make_clip(rng)
    got = T.convert_blending(sd, clip_params=T.convert_clip_image_tower(clip))
    ref = J.convert_blending(sd, clip_params=J.convert_clip_image_tower(clip))
    assert_same_tree(got, bridge_zoo(ref))


def test_convert_star_matches_jax():
    sd = make_star(np.random.default_rng(21))
    got = tstar.convert_star(sd)
    assert_same_tree(got, bridge_zoo(jstar.convert_star(sd)))
    assert "skip" in got["pre_r1"] and "skip" not in got["pre_r2"]


def test_spectral_norm_is_baked():
    """t_conv_sn divides by sigma = u^T W v: the SEAN block convs."""
    sd = make_sean(np.random.default_rng(22))
    w, u, v = (sd[f"head_0.conv_0.weight_{k}"] for k in ("orig", "u", "v"))
    got = T.t_conv_sn(sd, "head_0.conv_0")["w"].numpy()
    np.testing.assert_allclose(got, w / (u @ w.reshape(len(w), -1) @ v), rtol=1e-6)


def _save(path: Path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(obj, path)


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def write_reference_dir(root: Path, seed: int = 0, star: bool = True) -> Path:
    """A reference pretrained_models/ tree of synthetic checkpoints, with
    the file names, entry keys and key prefixes zoo.load_zoo reads."""
    rng = np.random.default_rng(seed)
    n_latent = SMALL_GAN.n_latent
    _save(root / "StyleGAN/ffhq.pt",
          {"g_ema": _tensors(synth_state_dict(SMALL_GAN, np.random.RandomState(seed))),
           "latent_avg": torch.from_numpy(_latent(rng, 512))})  # [512]: tiled to n_latent
    e4e = {f"encoder.{k}": v for k, v in make_e4e(rng).items()}
    e4e["decoder.style.1.weight"] = _latent(rng, 4, 4)  # not the encoder's
    _save(root / "encoder4editing/e4e_ffhq_encode.pt",
          {"state_dict": _tensors(e4e), "latent_avg": torch.from_numpy(_latent(rng, n_latent, 8)),
           "opts": {"encoder_type": "Encoder4Editing"}})
    _save(root / "FeatureStyleEncoder/143_enc.pth",
          _tensors({f"enc.{k}": v for k, v in make_fs(rng).items()}))
    _save(root / "BiSeNet/face_parsing_79999_iter.pth", _tensors(make_bisenet(rng)))
    _save(root / "sean_checkpoints/CelebA-HQ_pretrained/latest_net_G.pth",
          _tensors(make_sean(rng)))
    for j in (0, 13):  # the other regions have no mean code: zeros
        (root / f"sean_mean_codes/{j}").mkdir(parents=True)
        np.save(root / f"sean_mean_codes/{j}/ACE.npy", _latent(rng, 512))
    _save(root / "ShapeAdaptor/mask_generator.pth", _tensors(make_shape_adaptor(rng)))
    _save(root / "Rotate/rotate_best.pth",
          {"model_state_dict": _tensors(make_mods(rng, "modulation_module_list")), "epoch": 3})
    _save(root / "Blending/checkpoint.pth",
          {"model_state_dict": _tensors(make_mods(rng, "modulation_module_list"))})
    _save(root / "PostProcess/pp_model.pth",
          {"model_state_dict": _tensors(make_post_process(rng)), "cur_iter": 7})
    _save(root / "PostProcess/latent_avg.pt", torch.from_numpy(_latent(rng, n_latent, 8)))
    _save(root / "clip_vit_b32.pt", _tensors(make_clip(rng)))
    if star:
        _save(root / "star_wflw.pth", {"net": _tensors(make_star(rng))})
    return root


@pytest.mark.parametrize("star", [True, False])
def test_load_zoo_reference_dir_matches_jax(tmp_path, star):
    root = write_reference_dir(tmp_path / "pretrained_models", star=star)
    cfg = HairFastConfig(stylegan=SMALL_GAN)
    got = tzoo.load_zoo(root, cfg, device="cpu")
    assert_same_tree(got, bridge_zoo(jax_load_zoo(root, cfg)))
    assert ("star" in got) == star
    assert tuple(got["fse_latent_avg"].shape) == (SMALL_GAN.n_latent, 512)
    codes = got["sean"]["mean_codes"]
    assert codes[0].abs().sum() > 0 and codes[1].abs().sum() == 0


def test_load_zoo_missing_file_names_it(tmp_path):
    root = write_reference_dir(tmp_path / "pretrained_models", star=False)
    (root / "BiSeNet/face_parsing_79999_iter.pth").unlink()
    with pytest.raises(FileNotFoundError, match="face_parsing_79999_iter.pth"):
        tzoo.load_zoo(root, HairFastConfig(stylegan=SMALL_GAN))
