"""zoo "full": the published HairFastGAN zoo at FFHQ-1024 (StyleGAN2
config-f, e4e, the FSE encoder, BiSeNet-19, SEAN, the CtrlHair shape
adaptor, the rotate, blending (CLIP ViT-B/32) and PostProcess encoders)."""

from portbench.reference.bridge import map_tree, to_port
from portbench.reference.config import HairFastConfig
from portbench.reference.models import (bisenet, clip_vit, e4e, encoders, iresnet, sean,
                                        shape_adaptor, stylegan2)
from portbench.reference.models.layers import spec


def shapes():
    """(shape tree in the port's layout, meta tensors; HairFastConfig)."""
    cfg = HairFastConfig()
    n = cfg.stylegan.n_latent
    return map_tree({
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
    }, to_port), cfg
