"""Reference PyTorch checkpoints -> the port's parameter trees (counterpart
of hairfastgan_tpu/params/convert.py, the "weights ABI").

One converter per checkpoint family of the reference inventory (SURVEY.md
§2.12). Each takes a flat `{key: ndarray}` state dict (`load_torch_state_dict`)
and returns the tree of the matching `init_*` in hairfastgan_torch/models,
with tensor leaves on the CPU that own their memory (in the checkpoint's
dtype; float64 as float32). The port keeps the
reference's own layouts (ops/basic.py), so most leaves are the checkpoint's
tensors as they are:
  * Linear [out, in] and Conv2d OIHW stay as they are;
  * ConvTranspose2d [in, out, kh, kw] -> the forward conv's OIHW kernel,
    both spatial axes flipped (ops/modconv.py takes that form);
  * StyleGAN2's up-convs (conv_transpose2d of the transposed weight,
    model.py:243-255) keep OIHW with both spatial axes flipped;
  * BatchNorm -> {gamma, beta, mean, var} (gamma 1, beta 0 when affine=False);
  * spectral-norm convs are baked: W = W_orig / sigma, sigma = u^T W v.
The arithmetic is numpy's, as in the JAX package's converters, so a tree
equals the JAX converter's followed by params/bridge.bridge_zoo exactly.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hairfastgan_torch.models.e4e import _blocks_50
from hairfastgan_torch.models.iresnet import FS_STRIDES
from hairfastgan_torch.models.shape_adaptor import LAYER_NUM

SD = Dict[str, np.ndarray]


def load_torch_state_dict(path, key: Optional[str] = None) -> SD:
    """A reference checkpoint file -> {key: ndarray} (state_dict_of). The
    reference's files pickle more than tensors, so this unpickles: load
    trusted files only."""
    return state_dict_of(torch.load(str(path), map_location="cpu", weights_only=False), key)


def state_dict_of(ckpt: dict, key: Optional[str] = None) -> SD:
    """A loaded checkpoint -> {key: ndarray}: its entry `key` when it has
    one, then that entry's 'state_dict' when it has one."""
    if key is not None and key in ckpt:
        ckpt = ckpt[key]
    if "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in ckpt.items()}


def _t(a) -> torch.Tensor:
    """ndarray -> a C-contiguous tensor of its own (float64 -> float32, as
    the JAX package's zoo stores it)."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(a, np.float32 if a.dtype == np.float64 else a.dtype,
                                     order="C"))


# -- primitive translators ---------------------------------------------------

def _with_bias(sd: SD, name: str, w) -> dict:
    p = {"w": _t(w)}
    if f"{name}.bias" in sd:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def t_linear(sd: SD, name: str) -> dict:
    return _with_bias(sd, name, sd[f"{name}.weight"])


def t_conv(sd: SD, name: str) -> dict:
    return _with_bias(sd, name, sd[f"{name}.weight"])


def t_conv_sn(sd: SD, name: str) -> dict:
    """Conv with spectral norm baked: W_orig / sigma, sigma = u^T (W_mat v)."""
    if f"{name}.weight_orig" not in sd:
        return t_conv(sd, name)
    w = sd[f"{name}.weight_orig"]
    sigma = float(sd[f"{name}.weight_u"] @ (w.reshape(w.shape[0], -1) @ sd[f"{name}.weight_v"]))
    return _with_bias(sd, name, w / sigma)


def t_convT(sd: SD, name: str) -> dict:
    """ConvTranspose2d [in,out,kh,kw] -> the forward conv's flipped OIHW kernel."""
    return _with_bias(sd, name, sd[f"{name}.weight"][:, :, ::-1, ::-1].transpose(1, 0, 2, 3))


def t_bn(sd: SD, name: str) -> dict:
    mean = sd[f"{name}.running_mean"]
    out = {"mean": _t(mean), "var": _t(sd[f"{name}.running_var"])}
    if f"{name}.weight" in sd:
        out["gamma"], out["beta"] = _t(sd[f"{name}.weight"]), _t(sd[f"{name}.bias"])
    else:  # affine=False
        out["gamma"], out["beta"] = _t(np.ones_like(mean)), _t(np.zeros_like(mean))
    return out


def t_prelu(sd: SD, name: str) -> dict:
    return {"w": _t(sd[f"{name}.weight"])}


def t_ln(sd: SD, name: str, gamma: str = "weight", beta: str = "bias") -> dict:
    return {"gamma": _t(sd[f"{name}.{gamma}"]), "beta": _t(sd[f"{name}.{beta}"])}


def _subkeys(sd: SD, prefix: str) -> SD:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def _n_children(sd: SD, prefix: str) -> int:
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.")
    idx = {int(m.group(1)) for k in sd for m in [pat.match(k)] if m}
    return max(idx) + 1 if idx else 0


# -- StyleGAN2 (ffhq.pt 'g_ema', reference models/stylegan2/model.py:368-465)

def _t_modconv(sd: SD, name: str, up: bool = False) -> dict:
    w = sd[f"{name}.weight"][0]  # [out, in, k, k]
    return {"w": _t(w[:, :, ::-1, ::-1] if up else w),
            "modulation": t_linear(sd, f"{name}.modulation")}


def convert_stylegan2(sd: SD) -> dict:
    """'g_ema' state dict -> stylegan2.init_generator_params' tree."""
    n_style = _n_children(sd, "style") or 9
    n_convs = _n_children(sd, "convs")

    def styled(name, up=False):
        return {"conv": _t_modconv(sd, f"{name}.conv", up=up),
                "noise_weight": _t(sd[f"{name}.noise.weight"].reshape(())),
                "bias": _t(sd[f"{name}.activate.bias"])}

    def to_rgb(name):
        return {"conv": _t_modconv(sd, f"{name}.conv"), "bias": _t(sd[f"{name}.bias"].reshape(-1))}

    return {
        "style": [t_linear(sd, f"style.{i}") for i in range(1, n_style)],
        "input": _t(sd["input.input"]),
        "conv1": styled("conv1"),
        "to_rgb1": to_rgb("to_rgb1"),
        "convs": [styled(f"convs.{i}", up=(i % 2 == 0)) for i in range(n_convs)],
        "to_rgbs": [to_rgb(f"to_rgbs.{i}") for i in range(n_convs // 2)],
    }


def convert_discriminator(sd: SD, size: int = 1024) -> dict:
    """rosinality Discriminator state dict (model.py:667-725) ->
    models/stylegan2_discriminator.init_discriminator's tree.

    convs.0 = ConvLayer(3, ch, 1) [EqualConv2d, FusedLeakyReLU]; convs.1..N
    are ResBlocks whose conv2/skip are Sequential(Blur, EqualConv2d,
    [FusedLeakyReLU]). The Blur 'kernel' buffers are the fixed (1,3,3,1) the
    model rebuilds, so only weights and biases map."""
    def conv(name, bias=None):
        p = {"conv": {"w": _t(sd[f"{name}.weight"])}}
        if bias is not None:
            p["bias"] = _t(sd[f"{bias}.bias"])
        return p

    p = {"conv_in": conv("convs.0.0", "convs.0.1"), "blocks": [],
         "final_conv": conv("final_conv.0", "final_conv.1"),
         "final_linear1": t_linear(sd, "final_linear.0"),
         "final_linear2": t_linear(sd, "final_linear.1")}
    for j in range(1, int(np.log2(size)) - 1):
        n = f"convs.{j}"
        p["blocks"].append({"conv1": conv(f"{n}.conv1.0", f"{n}.conv1.1"),
                            "conv2": conv(f"{n}.conv2.1", f"{n}.conv2.2"),
                            "skip": conv(f"{n}.skip.1")})
    return p


# -- insightface IResNet trunk (FSE / PostProcess encoders) ------------------

def _t_ibasic(sd: SD, name: str) -> dict:
    p = {"bn1": t_bn(sd, f"{name}.bn1"), "conv1": t_conv(sd, f"{name}.conv1"),
         "bn2": t_bn(sd, f"{name}.bn2"), "prelu": t_prelu(sd, f"{name}.prelu"),
         "conv2": t_conv(sd, f"{name}.conv2"), "bn3": t_bn(sd, f"{name}.bn3")}
    if f"{name}.downsample.0.weight" in sd:
        p["downsample"] = {"conv": t_conv(sd, f"{name}.downsample.0"),
                           "bn": t_bn(sd, f"{name}.downsample.1")}
    return p


def _t_trunk(sd: SD, stem: Sequence[str], stages: Sequence[str]) -> dict:
    return {"conv1": t_conv(sd, stem[0]), "bn1": t_bn(sd, stem[1]),
            "prelu": t_prelu(sd, stem[2]),
            "stages": [[_t_ibasic(sd, f"{st}.{i}") for i in range(_n_children(sd, st))]
                       for st in stages]}


def convert_arcface(sd: SD) -> dict:
    """insightface IResNet ArcFace state dict (conv1/bn1/prelu, layer1-4,
    bn2, fc, features) -> the JAX package's iresnet.init_arcface tree."""
    return {"trunk": _t_trunk(sd, stem=("conv1", "bn1", "prelu"),
                              stages=("layer1", "layer2", "layer3", "layer4")),
            "bn2": t_bn(sd, "bn2"), "fc": t_linear(sd, "fc"), "features_bn": t_bn(sd, "features")}


def _t_content_layer(sd: SD, name: str, stride) -> dict:
    # Sequential(BN, Conv, BN, PReLU, Conv, BN) (Net.py:352-360)
    return {"bn0": t_bn(sd, f"{name}.0"), "conv1": t_conv(sd, f"{name}.1"),
            "bn1": t_bn(sd, f"{name}.2"), "prelu": t_prelu(sd, f"{name}.3"),
            "conv2": t_conv(sd, f"{name}.4"), "bn2": t_bn(sd, f"{name}.5"), "stride": stride}


def convert_fs_encoder(sd: SD, fs_layers: Sequence[int] = (5,)) -> dict:
    """fs_encoder_v2 / FeatureEncoder(Mult) state dict -> iresnet.init_fs_encoder's tree."""
    shift = 0 if max(fs_layers) <= 7 else 2
    multi = any(k.startswith("content_layer.0.0") for k in sd)
    return {
        "trunk": _t_trunk(sd, stem=("conv.0", "conv.1", "conv.2"),
                          stages=("block_1", "block_2", "block_3", "block_4")),
        "styles": [t_linear(sd, f"styles.{i}") for i in range(_n_children(sd, "styles"))],
        "content": [_t_content_layer(sd, f"content_layer.{i}" if multi else "content_layer",
                                     FS_STRIDES[l - shift]) for i, l in enumerate(fs_layers)],
        "fs_layers": tuple(fs_layers),
    }


def convert_feature_iresnet(sd: SD, prefix: str = "res_blocks") -> list:
    """FeatureiResnet ModuleDict res_block_{n}_{k} (Encoders.py:35-57)."""
    names = sorted(
        {m.group(0) for k in sd for m in [re.match(rf"{prefix}\.res_block_(\d+)_(\d+)", k)] if m},
        key=lambda s: tuple(int(x) for x in re.findall(r"\d+", s.split("res_block_")[1])))
    return [_t_ibasic(sd, n) for n in names]


# -- e4e (Encoder4Editing of the pSp checkpoint: 'encoder.*' and latent_avg)

def _t_bottleneck_ir(sd: SD, name: str, stride: int) -> dict:
    p = {"bn_in": t_bn(sd, f"{name}.res_layer.0"), "conv1": t_conv(sd, f"{name}.res_layer.1"),
         "prelu": t_prelu(sd, f"{name}.res_layer.2"), "conv2": t_conv(sd, f"{name}.res_layer.3"),
         "bn_out": t_bn(sd, f"{name}.res_layer.4"), "stride": stride}
    if f"{name}.res_layer.5.fc1.weight" in sd:
        p["se"] = {"fc1": t_conv(sd, f"{name}.res_layer.5.fc1"),
                   "fc2": t_conv(sd, f"{name}.res_layer.5.fc2")}
    if f"{name}.shortcut_layer.0.weight" in sd:
        p["shortcut"] = {"conv": t_conv(sd, f"{name}.shortcut_layer.0"),
                         "bn": t_bn(sd, f"{name}.shortcut_layer.1")}
    return p


def convert_e4e(sd: SD, latent_avg: Optional[np.ndarray] = None) -> dict:
    """Encoder state dict (prefix stripped) -> e4e.init_e4e's tree."""
    styles = []
    for i in range(_n_children(sd, "styles")):
        # the convs Sequential alternates Conv2d (even index) and LeakyReLU,
        # the last LeakyReLU has no parameters: max index 2(n-1)
        n_convs = (_n_children(sd, f"styles.{i}.convs") + 1) // 2
        styles.append({"convs": [t_conv(sd, f"styles.{i}.convs.{2 * j}") for j in range(n_convs)],
                       "linear": t_linear(sd, f"styles.{i}.linear")})
    return {
        "backbone": {
            "input": {"conv": t_conv(sd, "input_layer.0"), "bn": t_bn(sd, "input_layer.1"),
                      "prelu": t_prelu(sd, "input_layer.2")},
            "body": [_t_bottleneck_ir(sd, f"body.{i}", stride)
                     for i, (_, _, stride) in enumerate(_blocks_50())],
        },
        "styles": styles,
        "latlayer1": t_conv(sd, "latlayer1"),
        "latlayer2": t_conv(sd, "latlayer2"),
        "latent_avg": _t(latent_avg if latent_avg is not None
                         else np.zeros((len(styles), 512), np.float32)),
    }


# -- BiSeNet (face_parsing_79999_iter.pth) -----------------------------------

def _t_basicblock(sd: SD, name: str, stride: int) -> dict:
    p = {"conv1": {"conv": t_conv(sd, f"{name}.conv1"), "bn": t_bn(sd, f"{name}.bn1")},
         "conv2": {"conv": t_conv(sd, f"{name}.conv2"), "bn": t_bn(sd, f"{name}.bn2")},
         "stride": stride}
    if f"{name}.downsample.0.weight" in sd:
        p["downsample"] = {"conv": t_conv(sd, f"{name}.downsample.0"),
                           "bn": t_bn(sd, f"{name}.downsample.1")}
    return p


def _t_convbnrelu(sd: SD, name: str) -> dict:
    return {"conv": t_conv(sd, f"{name}.conv"), "bn": t_bn(sd, f"{name}.bn")}


def _t_arm(sd: SD, name: str) -> dict:
    return {"conv": _t_convbnrelu(sd, f"{name}.conv"), "atten": t_conv(sd, f"{name}.conv_atten"),
            "bn_atten": t_bn(sd, f"{name}.bn_atten")}


def _t_bise_head(sd: SD, name: str) -> dict:
    return {"conv": _t_convbnrelu(sd, f"{name}.conv"), "out": t_conv(sd, f"{name}.conv_out")}


def convert_bisenet(sd: SD, n_classes: int = 19) -> dict:
    resnet = {"conv1": {"conv": t_conv(sd, "cp.resnet.conv1"), "bn": t_bn(sd, "cp.resnet.bn1")}}
    for li, stride in zip(range(1, 5), (1, 2, 2, 2)):
        resnet[f"layer{li}"] = [_t_basicblock(sd, f"cp.resnet.layer{li}.0", stride),
                                _t_basicblock(sd, f"cp.resnet.layer{li}.1", 1)]
    return {
        "resnet": resnet,
        "arm16": _t_arm(sd, "cp.arm16"),
        "arm32": _t_arm(sd, "cp.arm32"),
        "conv_head32": _t_convbnrelu(sd, "cp.conv_head32"),
        "conv_head16": _t_convbnrelu(sd, "cp.conv_head16"),
        "conv_avg": _t_convbnrelu(sd, "cp.conv_avg"),
        "ffm": {"convblk": _t_convbnrelu(sd, "ffm.convblk"), "conv1": t_conv(sd, "ffm.conv1"),
                "conv2": t_conv(sd, "ffm.conv2")},
        "head": _t_bise_head(sd, "conv_out"),
        "head16": _t_bise_head(sd, "conv_out16"),
        "head32": _t_bise_head(sd, "conv_out32"),
        "n_classes": n_classes,
    }


# -- SEAN generator (netG of CelebA-HQ_pretrained) ---------------------------

def _t_ace(sd: SD, name: str, use_rgb: bool) -> dict:
    p = {"spade": {"shared": t_conv(sd, f"{name}.Spade.mlp_shared.0"),
                   "gamma": t_conv(sd, f"{name}.Spade.mlp_gamma"),
                   "beta": t_conv(sd, f"{name}.Spade.mlp_beta")},
         "bn": t_bn(sd, f"{name}.param_free_norm"),
         "noise_var": _t(sd[f"{name}.noise_var"])}
    if use_rgb:
        p["blend_gamma"] = _t(sd[f"{name}.blending_gamma"].reshape(()))
        p["blend_beta"] = _t(sd[f"{name}.blending_beta"].reshape(()))
        p["fc_mu"] = [t_linear(sd, f"{name}.fc_mu{j}") for j in range(19)]
        p["conv_gamma"] = t_conv(sd, f"{name}.conv_gamma")
        p["conv_beta"] = t_conv(sd, f"{name}.conv_beta")
    return p


def _t_spade_block(sd: SD, name: str, use_rgb: bool = True) -> dict:
    p = {"ace0": _t_ace(sd, f"{name}.ace_0", use_rgb), "conv0": t_conv_sn(sd, f"{name}.conv_0"),
         "ace1": _t_ace(sd, f"{name}.ace_1", use_rgb), "conv1": t_conv_sn(sd, f"{name}.conv_1")}
    if any(k.startswith(f"{name}.conv_s.") for k in sd):
        p["ace_s"] = _t_ace(sd, f"{name}.ace_s", use_rgb)
        p["conv_s"] = t_conv_sn(sd, f"{name}.conv_s")
    return p


def convert_sean(sd: SD, mean_codes: Optional[np.ndarray] = None) -> dict:
    # Zencoder Sequential indices (architecture.py:158-178):
    # 1 conv_in, 4 down1, 7 down2, 10 convT up, 14 conv_out
    z = "Zencoder.model"
    return {
        "zencoder": {"conv_in": t_conv(sd, f"{z}.1"), "down1": t_conv(sd, f"{z}.4"),
                     "down2": t_conv(sd, f"{z}.7"), "up": t_convT(sd, f"{z}.10"),
                     "conv_out": t_conv(sd, f"{z}.14")},
        "fc": t_conv(sd, "fc"),
        "head0": _t_spade_block(sd, "head_0"),
        "mid0": _t_spade_block(sd, "G_middle_0"),
        "mid1": _t_spade_block(sd, "G_middle_1"),
        "up0": _t_spade_block(sd, "up_0"),
        "up1": _t_spade_block(sd, "up_1"),
        "up2": _t_spade_block(sd, "up_2"),
        "up3": _t_spade_block(sd, "up_3", use_rgb=False),
        "conv_img": t_conv(sd, "conv_img"),
        "mean_codes": _t(mean_codes if mean_codes is not None
                         else np.zeros((19, 512), np.float32)),
    }


def load_sean_mean_codes(style_dir) -> np.ndarray:
    """styles_test/mean_style_code/median/<j>/ACE.npy -> [19,512] (zeros
    for a region without a file)."""
    codes = np.zeros((19, 512), np.float32)
    for j in range(19):
        path = os.path.join(str(style_dir), str(j), "ACE.npy")
        if os.path.exists(path):
            codes[j] = np.load(path)
    return codes


# -- shape adaptor (mask_generator.pth) --------------------------------------

def _t_mask_encoder(sd: SD, name: str, vae: bool) -> dict:
    p = {"layers": [{"conv": t_conv(sd, f"{name}.layers.{i}.conv"),
                     "ln": t_ln(sd, f"{name}.layers.{i}.norm", "gamma", "beta")}
                    for i in range(_n_children(sd, f"{name}.layers"))],
         "out": t_linear(sd, f"{name}.out_layer.fc")}
    if vae and f"{name}.std_out_layer.fc.weight" in sd:
        p["std_out"] = t_linear(sd, f"{name}.std_out_layer.fc")
    return p


def _t_mask_decoder(sd: SD, name: str) -> dict:
    # the Sequential alternates Upsample (no parameters) and Conv2dBlock
    idx = [2 * i + 1 for i in range(LAYER_NUM)]
    return {"in": t_linear(sd, f"{name}.in_layer.fc"),
            "layers": [{"conv": t_conv(sd, f"{name}.layers.{j}.conv"),
                        "ln": t_ln(sd, f"{name}.layers.{j}.norm", "gamma", "beta")} for j in idx],
            "out": t_conv(sd, f"{name}.out_layer.conv")}


def convert_shape_adaptor(sd: SD) -> dict:
    return {"hair_encoder": _t_mask_encoder(sd, "hair_encoder", vae=True),
            "face_encoder": _t_mask_encoder(sd, "face_encoder", vae=False),
            "hair_decoder": _t_mask_decoder(sd, "hair_decoder"),
            "face_decoder": _t_mask_decoder(sd, "face_decoder")}


# -- CLIP ViT-B/32 image tower (visual.* of the clip package's checkpoint) ---

def convert_clip_image_tower(sd: SD, prefix: str = "visual") -> dict:
    """The clip checkpoint's half-precision tower -> f32 clip_vit tree."""
    def g(k):
        return _t(sd[f"{prefix}.{k}"].astype(np.float32))

    def lin(b, k):
        return {"w": g(f"{b}.{k}.weight"), "b": g(f"{b}.{k}.bias")}

    def ln(k):
        return {"gamma": g(f"{k}.weight"), "beta": g(f"{k}.bias")}

    blocks = []
    for i in range(_n_children(sd, f"{prefix}.transformer.resblocks")):
        b = f"transformer.resblocks.{i}"
        blocks.append({"ln1": ln(f"{b}.ln_1"),
                       "attn": {"in_proj": {"w": g(f"{b}.attn.in_proj_weight"),
                                            "b": g(f"{b}.attn.in_proj_bias")},
                                "out_proj": lin(b, "attn.out_proj")},
                       "ln2": ln(f"{b}.ln_2"),
                       "mlp": {"fc": lin(b, "mlp.c_fc"), "proj": lin(b, "mlp.c_proj")}})
    return {"patch_conv": {"w": g("conv1.weight")}, "class_emb": g("class_embedding"),
            "pos_emb": g("positional_embedding"), "ln_pre": ln("ln_pre"), "blocks": blocks,
            "ln_post": ln("ln_post"), "proj": g("proj")}


# -- trained glue encoders (Rotate / Blending / PostProcess checkpoints) -----

def _t_modulation(sd: SD, name: str) -> dict:
    def branch(bn):
        return {"fc1": t_linear(sd, f"{name}.{bn}.0"), "ln": t_ln(sd, f"{name}.{bn}.1"),
                "fc2": t_linear(sd, f"{name}.{bn}.3")}

    return {"fc": t_linear(sd, f"{name}.fc"), "gamma": branch("gamma_function"),
            "beta": branch("beta_function")}


def _modulations(sd: SD, prefix: str) -> list:
    return [_t_modulation(sd, f"{prefix}.{i}") for i in range(_n_children(sd, prefix))]


def convert_rotate(sd: SD) -> dict:
    return {"mods": _modulations(sd, "modulation_module_list")}


def convert_blending(sd: SD, clip_params=None) -> dict:
    """Blending checkpoint plus the CLIP tower's tree (convert_clip_image_tower)."""
    return {"mods": _modulations(sd, "modulation_module_list"), "clip": clip_params}


def convert_post_process(sd: SD, latent_avg: np.ndarray, fs_layers=(9,)) -> dict:
    return {"encoder_face": convert_fs_encoder(_subkeys(sd, "encoder_face"), fs_layers=fs_layers),
            "latent_avg": _t(np.asarray(latent_avg, np.float32)),
            "to_feature": convert_feature_iresnet(_subkeys(sd, "to_feature")),
            "to_latent_1": _modulations(sd, "to_latent_1"),
            "to_latent_2": _modulations(sd, "to_latent_2")}
