"""Shape trees of the model zoo, as `meta` tensors in the port's layout
(conv OIHW, linear [out, in]): the full HairFastGAN zoo and the micro zoo
that the CPU tests use. The benchmark draws the weights into these shapes."""

from __future__ import annotations

from typing import Dict

from portbench.reference.bridge import map_tree, to_port
from portbench.reference.config import HairFastConfig, StyleGANConfig
from portbench.reference.models import (bisenet, clip_vit, e4e, encoders, iresnet, sean,
                                        shape_adaptor, stylegan2)
from portbench.reference.models.layers import spec


def _post_process(n_latent: int, encoder_face, to_feature):
    return {"encoder_face": encoder_face, "latent_avg": spec(n_latent, 512),
            "to_feature": to_feature,
            "to_latent_1": [encoders.init_modulation_module() for _ in range(5)],
            "to_latent_2": [encoders.init_modulation_module() for _ in range(5)]}


def _jax_layout(kind: str):
    """(JAX-layout shape tree, config) of the zoo `kind` ("full" or "micro")."""
    if kind == "full":
        cfg = HairFastConfig()
        n = cfg.stylegan.n_latent
        return {
            "generator": stylegan2.init_generator_params(cfg.stylegan),
            "e4e": e4e.init_e4e(n_styles=n),
            "fse": iresnet.init_fs_encoder(n_styles=n, fs_layers=(5,)),
            "fse_latent_avg": spec(n, 512),
            "bisenet": bisenet.init_bisenet(n_classes=19),
            "sean": sean.init_sean_generator(),
            "shape_adaptor": shape_adaptor.init_shape_adaptor(),
            "rotate": encoders.init_rotate_model(),
            "blending": encoders.init_blending_model(clip_vit.init_clip_image_tower()),
            "post_process": encoders.init_post_process_model(n),
        }, cfg
    if kind == "micro":
        cfg = HairFastConfig(stylegan=StyleGANConfig(size=128, max_channels=128))
        n, width = cfg.stylegan.n_latent, 0.25
        c16, c64 = cfg.stylegan.channels(16), cfg.stylegan.channels(64)
        clip = clip_vit.init_clip_image_tower(width=64, layers=2, embed_dim=512)
        return {
            "generator": stylegan2.init_generator_params(cfg.stylegan),
            "e4e": e4e.init_e4e(n_styles=n, se=False, width=width),
            "fse": iresnet.init_fs_encoder(n_styles=n, fs_layers=(5,), depth=18,
                                           width=width, content_ch=c16),
            "fse_latent_avg": spec(n, 512),
            "bisenet": bisenet.init_bisenet(n_classes=19, width=width),
            "sean": sean.init_sean_generator(ngf=8, z_ngf=8),
            "shape_adaptor": shape_adaptor.init_shape_adaptor(hidden=8),
            "rotate": encoders.init_rotate_model(),
            "blending": encoders.init_blending_model(clip),
            "post_process": _post_process(
                n, iresnet.init_fs_encoder(n_styles=n, fs_layers=(9,), depth=18, width=width,
                                           content_ch=c64),
                iresnet.init_feature_iresnet(blocks=((c64, 1), (c64, 1)), inplanes=2 * c64)),
        }, cfg
    raise ValueError(f"unknown zoo {kind!r}")


def zoo_shapes(kind: str = "full"):
    """(shape tree in the port's layout, meta tensors; HairFastConfig)."""
    tree, cfg = _jax_layout(kind)
    return map_tree(tree, to_port), cfg
