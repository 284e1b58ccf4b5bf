"""The port's parameter zoo: a jax-free random init at any config, the
loader of a checkpoint directory (`load_zoo`), and the cast to the compute
dtype (counterpart of hairfastgan_tpu/zoo.py).

`zoo_shapes(cfg)` is the tree of `init_zoo` in the JAX package as `meta`
tensors in JAX layout (no memory). `fill_random` fills it leaf by leaf
with numpy by the rule of the JAX package's `zoo._fill_random` (BN 'var'
-> 1, 'mean' -> 0, other floats 0.05*N(0,1) drawn in JAX layout and leaf
order) and converts each leaf through params/bridge.to_port straight onto
the device, so the full zoo (1.25 G parameters at the default config) never
exists twice. A seed therefore gives exactly the weights of the JAX
package's init_zoo_fast(seed), bridged.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from hairfastgan_torch.config import HairFastConfig, StyleGANConfig
from hairfastgan_torch.losses import identity, perceptual
from hairfastgan_torch.models import bisenet, clip_vit, e4e, encoders, iresnet, sean, star
from hairfastgan_torch.models import stylegan2_discriminator
from hairfastgan_torch.models import shape_adaptor as sa
from hairfastgan_torch.models import stylegan2
from hairfastgan_torch.models.layers import spec
from hairfastgan_torch.params.bridge import map_tree, to_port


def zoo_shapes(cfg: HairFastConfig = HairFastConfig()) -> Dict:
    """Shape tree of the JAX package's init_zoo(key, cfg), JAX layout, meta tensors."""
    n_latent = cfg.stylegan.n_latent
    return {
        "generator": stylegan2.init_generator_params(cfg.stylegan),
        "e4e": e4e.init_e4e(n_styles=n_latent),
        "fse": iresnet.init_fs_encoder(n_styles=n_latent, fs_layers=(5,)),
        "fse_latent_avg": spec(n_latent, 512),
        "bisenet": bisenet.init_bisenet(n_classes=19),
        "sean": sean.init_sean_generator(),
        "shape_adaptor": sa.init_shape_adaptor(),
        "rotate": encoders.init_rotate_model(),
        "blending": encoders.init_blending_model(clip_vit.init_clip_image_tower()),
        "post_process": encoders.init_post_process_model(n_latent),
    }


def fill_random(shapes, seed: Optional[int], device="cpu"):
    """Fill a JAX-layout shape tree from a numpy seed and convert to the
    port's layout, f32 on `device`. seed=None keeps meta tensors (shapes
    only); leaves that are real tensors (STAR's fixed E2H weights) are
    kept as they are and draw nothing."""
    rng = None if seed is None else np.random.default_rng(seed)

    def leaf(key, t):
        if t.device.type != "meta":  # a fixed constant (STAR's E2H weights)
            return to_port(key, t).to(device)
        if rng is None:
            return to_port(key, t)
        shape = tuple(t.shape)
        if key == "var":
            a = np.ones(shape, np.float32)
        elif key == "mean":
            a = np.zeros(shape, np.float32)
        else:
            a = np.asarray(rng.standard_normal(shape, dtype=np.float32) * 0.05)
        return to_port(key, torch.from_numpy(a)).to(device).contiguous()

    return map_tree(shapes, leaf)


def init_zoo(cfg: HairFastConfig = HairFastConfig(), seed: Optional[int] = 0,
             device="cpu") -> Dict:
    """Random full f32 zoo at `cfg` on `device` (seed=None: meta tensors
    only); zoo.cast_zoo casts it to the compute dtype."""
    return fill_random(zoo_shapes(cfg), seed, device)


def tiny_zoo_shapes(size: int = 128, max_channels: int = 512):
    """(shape tree, cfg) of the JAX package's init_tiny_zoo: a small
    generator resolution and shallow trunks at the real widths."""
    cfg = HairFastConfig(stylegan=StyleGANConfig(size=size, max_channels=max_channels))
    n_latent = cfg.stylegan.n_latent
    clip = clip_vit.init_clip_image_tower(width=64, layers=2, embed_dim=512)
    shapes = {
        "generator": stylegan2.init_generator_params(cfg.stylegan),
        "e4e": e4e.init_e4e(n_styles=n_latent, se=False),
        "fse": iresnet.init_fs_encoder(n_styles=n_latent, fs_layers=(5,), depth=18),
        "fse_latent_avg": spec(n_latent, 512),
        "bisenet": bisenet.init_bisenet(n_classes=19),
        "sean": sean.init_sean_generator(ngf=16),
        "shape_adaptor": sa.init_shape_adaptor(),
        "rotate": encoders.init_rotate_model(),
        "blending": encoders.init_blending_model(clip),
        "post_process": _post_process(n_latent, iresnet.init_fs_encoder(
            n_styles=n_latent, fs_layers=(9,), depth=18), iresnet.init_feature_iresnet()),
    }
    return shapes, cfg


def micro_zoo_shapes(size: int = 128, max_channels: int = 128, width: float = 0.25):
    """(shape tree, cfg) of the JAX package's init_micro_zoo: the tiny zoo
    with `width`-scaled trunks and a max_channels-capped generator."""
    cfg = HairFastConfig(stylegan=StyleGANConfig(size=size, max_channels=max_channels))
    n_latent = cfg.stylegan.n_latent
    c16, c64 = cfg.stylegan.channels(16), cfg.stylegan.channels(64)
    clip = clip_vit.init_clip_image_tower(width=64, layers=2, embed_dim=512)
    shapes = {
        "generator": stylegan2.init_generator_params(cfg.stylegan),
        "e4e": e4e.init_e4e(n_styles=n_latent, se=False, width=width),
        "fse": iresnet.init_fs_encoder(n_styles=n_latent, fs_layers=(5,), depth=18,
                                       width=width, content_ch=c16),
        "fse_latent_avg": spec(n_latent, 512),
        "bisenet": bisenet.init_bisenet(n_classes=19, width=width),
        "sean": sean.init_sean_generator(ngf=8, z_ngf=8),
        "shape_adaptor": sa.init_shape_adaptor(hidden=8),
        "rotate": encoders.init_rotate_model(),
        "blending": encoders.init_blending_model(clip),
        "post_process": _post_process(
            n_latent, iresnet.init_fs_encoder(n_styles=n_latent, fs_layers=(9,), depth=18,
                                              width=width, content_ch=c64),
            iresnet.init_feature_iresnet(blocks=((c64, 1), (c64, 1)), inplanes=2 * c64)),
    }
    return shapes, cfg


def _post_process(n_latent: int, encoder_face, to_feature):
    return {"encoder_face": encoder_face, "latent_avg": spec(n_latent, 512),
            "to_feature": to_feature,
            "to_latent_1": [encoders.init_modulation_module() for _ in range(5)],
            "to_latent_2": [encoders.init_modulation_module() for _ in range(5)]}


def init_tiny_zoo(seed: int = 0, device="cpu"):
    """(random zoo, cfg) with init_tiny_zoo's shapes (the CLI's --tiny)."""
    shapes, cfg = tiny_zoo_shapes()
    return fill_random(shapes, seed, device), cfg


def init_micro_zoo(seed: int = 0, device="cpu"):
    """(zoo, cfg): exactly the JAX package's init_micro_zoo_fast(seed),
    bridged (the CLI's --micro)."""
    shapes, cfg = micro_zoo_shapes()
    return fill_random(shapes, seed, device), cfg


def init_star(seed: int = 0, device="cpu", **kw) -> Dict:
    """Random STAR landmark weights (models/star.init_star's tree; WFLW, 4
    stacks x 4 levels x 256 channels by default) for zoo["star"]. Random
    zoos carry no STAR; the JAX package adds it only from a checkpoint."""
    return fill_random(star.init_star(**kw), seed, device)


def init_arcface(seed: int = 0, device="cpu", width: float = 1.0) -> Dict:
    """Random IR-SE-50 identity backbone (losses/identity.init_irse_backbone's
    tree) for the rotate trainer's frozen["arcface"]."""
    return fill_random(identity.init_irse_backbone(width=width), seed, device)


def blending_train_tiny(seed: int = 0, device="cpu"):
    """(frozen, params, cfg) of train_blending --tiny, with the shapes of
    the JAX CLI's --tiny trees: a 128^2 generator at max_channels 512 (the
    blend renders G[4..8] from the structural 512-channel F at 32^2), a
    CLIP tower of width 64 x 2 layers, and the blending encoder's mods."""
    cfg = HairFastConfig(stylegan=StyleGANConfig(size=128))
    clip = clip_vit.init_clip_image_tower(width=64, layers=2, embed_dim=512)
    t = fill_random({"generator": stylegan2.init_generator_params(cfg.stylegan), "clip": clip,
                     "mods": encoders.init_blending_model(clip)["mods"]}, seed, device)
    return {"generator": t["generator"], "clip": t["clip"]}, {"mods": t["mods"]}, cfg


def rotate_train_tiny(seed: int = 0, device="cpu"):
    """(frozen, params, cfg) of train_rotate --tiny, with the shapes of the
    JAX CLI's --tiny trees: a 128^2 generator at max_channels 128, the
    full-width IR-SE-50 backbone and the rotate encoder."""
    cfg = HairFastConfig(stylegan=StyleGANConfig(size=128, max_channels=128))
    t = fill_random({"generator": stylegan2.init_generator_params(cfg.stylegan),
                     "arcface": identity.init_irse_backbone(), "rotate": encoders.init_rotate_model()},
                    seed, device)
    return {"generator": t["generator"], "arcface": t["arcface"]}, t["rotate"], cfg


def pp_train_frozen(generator: Dict, trunk_width: float = 1.0, seed: int = 0,
                    device="cpu") -> Dict:
    """The PostProcess trainer's frozen tree (the JAX CLI's train_pp.py
    :118-131): `generator` beside a random 16-class BiSeNet (seg.pth's
    shapes), IR-SE-50 identity backbone and LPIPS-AlexNet. trunk_width 0.25
    matches the --micro zoo's trunks; LPIPS keeps its widths."""
    t = fill_random({"bisenet16": bisenet.init_bisenet(n_classes=16, width=trunk_width),
                     "id_backbone": identity.init_irse_backbone(width=trunk_width),
                     "lpips": perceptual.init_lpips_alex()}, seed, device)
    return dict(t, generator=generator)


def init_discriminator(cfg: StyleGANConfig, seed: Optional[int] = 0, device="cpu") -> Dict:
    """Random StyleGAN2 discriminator at the generator's config (the JAX
    CLI's start without ffhq.pkl), drawn as the JAX init and rosinality's
    draw it: weights N(0, 1) (equalized learning rate scales them at run
    time), biases 0; from a numpy seed in JAX layout and leaf order.
    seed=None keeps meta tensors (shapes only)."""
    shapes = stylegan2_discriminator.init_discriminator(cfg)
    if seed is None:
        return fill_random(shapes, None)
    rng = np.random.default_rng(seed)

    def leaf(key, t):
        shape = tuple(t.shape)
        a = (rng.standard_normal(shape, dtype=np.float32) if key == "w"
             else np.zeros(shape, np.float32))
        return to_port(key, torch.from_numpy(a)).to(device).contiguous()

    return map_tree(shapes, leaf)


def pack_zoo(zoo: Dict) -> Dict:
    """The zoo with its many small ops' weights packed (exact, idempotent,
    opt-in; counterpart of the JAX package's zoo.pack_zoo): e4e's style
    heads per FPN group (e4e.pack_style_heads), every SEAN ACE's fc_mu heads
    and gamma/beta pairs (sean.pack_sean), and the style heads of the FSE
    and of the PostProcess face encoder (iresnet.pack_fs_styles). The model
    forwards dispatch on the layout they get; HairFast does not pack."""
    q = dict(zoo)
    if "e4e" in q:
        q["e4e"] = e4e.pack_style_heads(q["e4e"])
    if "sean" in q:
        q["sean"] = sean.pack_sean(q["sean"])
    if "fse" in q:
        q["fse"] = iresnet.pack_fs_styles(q["fse"])
    if "post_process" in q and "encoder_face" in q["post_process"]:
        q["post_process"] = dict(q["post_process"], encoder_face=iresnet.pack_fs_styles(
            q["post_process"]["encoder_face"]))
    return q


def cast_zoo(zoo: Dict, dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Float leaves -> the compute dtype (the JAX package's zoo.cast_zoo);
    norm statistics are promoted back to f32 inside the norm folds."""
    return map_tree(zoo, lambda _, t: t.to(dtype) if t.is_floating_point() else t)


def load_zoo(checkpoint_dir, cfg: HairFastConfig = HairFastConfig(), device="cpu") -> Dict:
    """The zoo of a checkpoint directory, on `device`, in the files' dtype
    (f32 for the reference's checkpoints; counterpart of the JAX package's
    zoo.load_zoo).

    First `<dir>/zoo_torch.pt` (params/checkpoint.save_zoo). Else the
    reference's raw pretrained_models/ layout (SURVEY.md §2.12), converted
    by params/convert.py; a missing file raises with its name, and the STAR
    landmark model (star_wflw.pth, for the on-device align path) is
    optional. A directory that holds only the JAX package's orbax zoo/
    raises with the command that converts for the port.
    """
    from hairfastgan_torch.params import convert as C
    from hairfastgan_torch.params.checkpoint import ZOO_FILE, load_zoo_file

    d = Path(checkpoint_dir)
    if (d / ZOO_FILE).exists():
        return load_zoo_file(d / ZOO_FILE, device)
    if (d / "zoo").is_dir() and not (d / "StyleGAN" / "ffhq.pt").exists():
        raise FileNotFoundError(
            f"{d} holds the JAX package's orbax zoo ({d / 'zoo'}), which the PyTorch port "
            "does not read; convert the reference checkpoints with: python -m "
            f"hairfastgan_torch.convert_checkpoints --torch_dir pretrained_models --out_dir {d}")

    def load(rel: str):
        return torch.load(str(d / rel), map_location="cpu", weights_only=False)

    def sd(rel: str, key=None):
        return C.load_torch_state_dict(d / rel, key=key)

    raw = load("StyleGAN/ffhq.pt")
    g_ema = {k: v.numpy() for k, v in raw["g_ema"].items()}
    latent_avg = raw["latent_avg"].numpy()  # [512] or [n_latent, 512]
    if latent_avg.ndim == 1:
        latent_avg = np.tile(latent_avg[None], (cfg.stylegan.n_latent, 1))
    e4e_ckpt = load("encoder4editing/e4e_ffhq_encode.pt")
    e4e_enc = {k[len("encoder."):]: v for k, v in C.state_dict_of(e4e_ckpt).items()
               if k.startswith("encoder.")}
    e4e_avg = e4e_ckpt.get("latent_avg")
    e4e_avg = e4e_avg.numpy() if e4e_avg is not None else latent_avg
    fse_sd = {k[len("enc."):] if k.startswith("enc.") else k: v
              for k, v in sd("FeatureStyleEncoder/143_enc.pth").items()}
    zoo = {
        "generator": C.convert_stylegan2(g_ema),
        "e4e": C.convert_e4e(e4e_enc, latent_avg=e4e_avg),
        "fse": C.convert_fs_encoder(fse_sd, fs_layers=(5,)),
        "fse_latent_avg": torch.from_numpy(np.array(latent_avg, np.float32)),
        "bisenet": C.convert_bisenet(sd("BiSeNet/face_parsing_79999_iter.pth"), n_classes=19),
        "sean": C.convert_sean(sd("sean_checkpoints/CelebA-HQ_pretrained/latest_net_G.pth"),
                               mean_codes=C.load_sean_mean_codes(d / "sean_mean_codes")),
        "shape_adaptor": C.convert_shape_adaptor(sd("ShapeAdaptor/mask_generator.pth")),
        "rotate": C.convert_rotate(sd("Rotate/rotate_best.pth", key="model_state_dict")),
        "blending": C.convert_blending(sd("Blending/checkpoint.pth", key="model_state_dict"),
                                       clip_params=C.convert_clip_image_tower(
                                           sd("clip_vit_b32.pt"))),
        "post_process": C.convert_post_process(
            sd("PostProcess/pp_model.pth", key="model_state_dict"),
            latent_avg=load("PostProcess/latent_avg.pt").numpy()),
    }
    if (d / "star_wflw.pth").exists():  # the on-device (dlib-free) align path
        zoo["star"] = star.convert_star(sd("star_wflw.pth", key="net"))
    return map_tree(zoo, lambda _, t: t.to(device))
