"""Parameter-shape helpers for the jax-free random init (zoo.init_zoo).

Each `init_*` mirrors hairfastgan_tpu/models/layers.py and returns a tree
whose tensor leaves are `meta` tensors IN THE JAX LAYOUT (conv HWIO, linear
[in, out]): they allocate nothing. zoo.fill_random draws every leaf with
numpy in JAX layout and order, and params/bridge.py turns it into the
port's layout, so a seed gives the same weights as the JAX package's
`zoo._fill_random` bridged. Python ints/tuples in the tree are the JAX
package's `Static` values.
"""

from __future__ import annotations

import torch


def spec(*shape: int) -> torch.Tensor:
    return torch.empty(shape, device="meta")


def init_linear(in_dim: int, out_dim: int, bias: bool = True):
    p = {"w": spec(in_dim, out_dim)}
    if bias:
        p["b"] = spec(out_dim)
    return p


def init_conv(k, cin: int, cout: int, bias: bool = True):
    kh, kw = (k, k) if isinstance(k, int) else k
    p = {"w": spec(kh, kw, cin, cout)}
    if bias:
        p["b"] = spec(cout)
    return p


def init_bn(c: int):
    return {"gamma": spec(c), "beta": spec(c), "mean": spec(c), "var": spec(c)}


def init_prelu(c: int):
    return {"w": spec(c)}


def init_ln(c: int):
    return {"gamma": spec(c), "beta": spec(c)}


def init_conv_bn(k, cin: int, cout: int):
    return {"conv": init_conv(k, cin, cout, bias=False), "bn": init_bn(cout)}


def mlp_ln_lrelu(in_dim: int, mid_dim: int, out_dim: int):
    """Linear -> LayerNorm -> LeakyReLU(0.01) -> Linear (ModulationModule branch)."""
    return {"fc1": init_linear(in_dim, mid_dim), "ln": init_ln(mid_dim),
            "fc2": init_linear(mid_dim, out_dim)}
