"""hairfastgan_torch: the PyTorch / CUDA (Hopper) port of hairfastgan_tpu.

The package imports torch and never jax, and nothing of hairfastgan_tpu:
it owns its configuration, host utilities and checkpoint converters.
Entry points: `hairfastgan_torch.api.HairFast`, the CLI
`python -m hairfastgan_torch.main`, the HTTP server
`python -m hairfastgan_torch.serve` and the checkpoint converter
`python -m hairfastgan_torch.convert_checkpoints`.
"""
