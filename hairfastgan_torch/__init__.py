"""hairfastgan_torch: the PyTorch / CUDA (Hopper) port of hairfastgan_tpu.

The package imports torch and never jax. It reuses the JAX package's
jax-free host modules (hairfastgan_tpu.config, utils.images,
utils.save_utils, utils.timing, utils.face_align, data.native_loader).
Entry points: `hairfastgan_torch.api.HairFast` and the CLI
`python -m hairfastgan_torch.main`.
"""
