"""The port's parameter zoo: a jax-free random init at any config, and the
cast to the compute dtype (counterpart of hairfastgan_tpu/zoo.py).

`zoo_shapes(cfg)` is the tree of `init_zoo` in the JAX package as `meta`
tensors in JAX layout (no memory). `fill_random` fills it leaf by leaf
with numpy by the rule of the JAX package's `zoo._fill_random` (BN 'var'
-> 1, 'mean' -> 0, other floats 0.05*N(0,1) drawn in JAX layout and leaf
order) and converts each leaf through params/bridge.to_port straight onto
the device, so the full zoo (1.25 G parameters at the default config) never
exists twice. A seed therefore
gives exactly the weights of the JAX package's init_zoo_fast(seed), bridged.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hairfastgan_torch.config import HairFastConfig
from hairfastgan_torch.models import bisenet, clip_vit, e4e, encoders, iresnet, sean
from hairfastgan_torch.models import shape_adaptor as sa
from hairfastgan_torch.models import stylegan2
from hairfastgan_torch.params.bridge import map_tree, to_port


def zoo_shapes(cfg: HairFastConfig = HairFastConfig()) -> Dict:
    """Shape tree of the JAX package's init_zoo(key, cfg), JAX layout, meta tensors."""
    n_latent = cfg.stylegan.n_latent
    return {
        "generator": stylegan2.init_generator_params(cfg.stylegan),
        "e4e": e4e.init_e4e(n_styles=n_latent),
        "fse": iresnet.init_fs_encoder(n_styles=n_latent, fs_layers=(5,)),
        "fse_latent_avg": torch.empty((n_latent, 512), device="meta"),
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
    only)."""
    rng = None if seed is None else np.random.default_rng(seed)

    def leaf(key, spec):
        if rng is None:
            return to_port(key, spec)
        shape = tuple(spec.shape)
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


def cast_zoo(zoo: Dict, dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Float leaves -> the compute dtype (the JAX package's zoo.cast_zoo);
    norm statistics are promoted back to f32 inside the norm folds."""
    return map_tree(zoo, lambda _, t: t.to(dtype) if t.is_floating_point() else t)
