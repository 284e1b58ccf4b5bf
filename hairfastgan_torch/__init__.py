"""hairfastgan_torch: the PyTorch / CUDA (Hopper) port of hairfastgan_tpu.

The package imports torch and never jax. It reuses the JAX package's
jax-free modules (hairfastgan_tpu.config, hairfastgan_tpu.utils.images).
Entry point: `hairfastgan_torch.api.HairFast`.
"""
