"""The configuration tree: frozen dataclasses with the JAX package's class
names, fields and defaults (hairfastgan_tpu/config.py), so that a config of
either package reads the same here. The port reads a config by its fields
only; a JAX-package config object works in its place.

The values are the reference's: StyleGAN2 config-f FFHQ (hair_swap.py),
SEAN's frozen options (pix2pix_model.py:328-339) and CtrlHair's shape
branch (shape_branch/config.py:16-40).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class StyleGANConfig:
    """StyleGAN2 config-f FFHQ (reference hair_swap.py:116-120)."""

    size: int = 1024
    style_dim: int = 512
    n_mlp: int = 8
    channel_multiplier: int = 2
    blur_kernel: Tuple[int, ...] = (1, 3, 3, 1)
    lr_mlp: float = 0.01
    max_channels: int = 512  # cap; tests shrink this for small models

    @property
    def log_size(self) -> int:
        return self.size.bit_length() - 1

    @property
    def n_latent(self) -> int:
        return self.log_size * 2 - 2  # 18 for 1024

    @property
    def num_layers(self) -> int:
        return (self.log_size - 2) * 2 + 1  # 17 noise-carrying convs

    def channels(self, res: int) -> int:
        if res <= 32:
            return min(512, self.max_channels)
        return min((2 ** 14 // res) * self.channel_multiplier, self.max_channels)


@dataclasses.dataclass(frozen=True)
class SEANConfig:
    """SEAN CelebA-HQ generator (reference SEAN_OPT, pix2pix_model.py:328-339)."""

    semantic_nc: int = 19
    ngf: int = 64
    crop_size: int = 256
    num_up_layers: int = 5  # 'normal'
    style_dim: int = 512
    z_enc_ngf: int = 32


@dataclasses.dataclass(frozen=True)
class ShapeAdaptorConfig:
    """CtrlHair shape branch (reference shape_branch/config.py:16-40)."""

    hair_dim: int = 16
    face_dim: int = 1024
    pos_encoding_order: int = 10
    layer_num: int = 7
    input_size: int = 256
    norm: str = "ln"
    n_classes: int = 19
    hair_idx: int = 13  # PARSING_LABEL_LIST.index('hair'), global_value_utils.py:49-52


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """CLIP ViT-B/32 image tower (the reference loads it via the clip pip pkg)."""

    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512


@dataclasses.dataclass(frozen=True)
class HairFastConfig:
    """Top-level config matching reference hair_swap.get_parser defaults."""

    stylegan: StyleGANConfig = dataclasses.field(default_factory=StyleGANConfig)
    sean: SEANConfig = dataclasses.field(default_factory=SEANConfig)
    shape_adaptor: ShapeAdaptorConfig = dataclasses.field(default_factory=ShapeAdaptorConfig)
    clip: CLIPConfig = dataclasses.field(default_factory=CLIPConfig)

    # HairFast knobs (hair_swap.py:122-132)
    batch_size: int = 3
    mixing: float = 0.95
    smooth: int = 5  # dilate/erode iterations
    seed: int = 3407

    # I/O: checkpoint_dir is loaded by zoo.load_zoo when it exists
    save_all: bool = False
    save_all_dir: Path = Path("output")
    checkpoint_dir: Path = Path("pretrained_models_jax")

    # execution
    compute_dtype: str = "bfloat16"  # dtype of the activations and the resident weights
    param_dtype: str = "float32"
    # fields of the JAX package's execution, kept so that its configs and
    # these read alike; neither package reads them: the meshes are sized by
    # parallel/mesh.local_devices (swap_batch) and data_mesh_for_batch
    # (the trainers), and the port has no compile cache
    mesh_data_axis: int = 1
    compile_cache_dir: Optional[str] = None

    # fast-path opt-ins, off by default: rot_seg_size parses a larger rotate
    # render at this size, rot_render_pairs stops that render at this pair
    # (pipeline/alignment._rotate_and_segment), pair_shape_modules batches
    # the distinct swap's two shape modules (pipeline/swap.hair_fast)
    rot_seg_size: int = 1024
    rot_render_pairs: Optional[int] = None
    # largest swap_batch chunk on one device; larger batches run as chunks
    # of this size (0: one chunk)
    max_batch_per_dispatch: int = 8
    pair_shape_modules: bool = False

    # hair label in the 19-class CelebAMask order used throughout the pipeline
    hair_label: int = 13


DEFAULT_CONFIG = HairFastConfig()
