"""The configuration tree, shared with the JAX package.

hairfastgan_tpu/config.py is dataclasses only (it imports no JAX), so the
port re-exports it rather than keeping a second copy.
"""

from hairfastgan_tpu.config import (CLIPConfig, HairFastConfig, SEANConfig,  # noqa: F401
                                    ShapeAdaptorConfig, StyleGANConfig)
