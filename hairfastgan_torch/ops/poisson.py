"""Poisson image blending (seamless cloning), plain PyTorch (counterpart of
hairfastgan_tpu/ops/poisson.py).

Jacobi iterations of the discrete Poisson equation

    lap(out) = lap(src)   inside the mask,   out = dst   outside

with edge-replicating 4-neighbour stencils. The JAX package runs them as a
`lax.scan`; here they are a Python loop of elementwise PyTorch ops (a few
launches per sweep). Public functions take and return NHWC in [0,1], like
the JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hairfastgan_torch.ops.resample import resize

Tensor = torch.Tensor


def _neighbor_sum(x: Tensor) -> Tensor:
    """up + down + left + right neighbours of NCHW maps, edges replicated."""
    p = F.pad(x, (1, 1, 1, 1), mode="replicate")
    return p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2] + p[..., 1:-1, 2:]


def _lap(x: Tensor) -> Tensor:
    """4-neighbour Laplacian of NCHW maps, edges replicated."""
    return 4.0 * x - _neighbor_sum(x)


def _jacobi(start: Tensor, dst: Tensor, m: Tensor, target_lap: Tensor, n_iters: int) -> Tensor:
    outside = (1 - m) * dst  # the fixed boundary term of every sweep
    x = start
    for _ in range(n_iters):
        x = m * ((_neighbor_sum(x) + target_lap) / 4.0) + outside
    return x


def poisson_blend(src: Tensor, dst: Tensor, mask: Tensor, n_iters: int = 300) -> Tensor:
    """Seamless-clone `src` into `dst` inside `mask` ([B,H,W,1] binary), all
    NHWC in [0,1]; gradients from `src`, boundary values from `dst`."""
    src, dst, mask = (t.permute(0, 3, 1, 2) for t in (src, dst, mask))
    m = (mask > 0.5).to(src.dtype)
    out = _jacobi(dst * (1 - m) + src * m, dst, m, _lap(src), n_iters)
    return out.clamp(0.0, 1.0).permute(0, 2, 3, 1)


def poisson_blend_multigrid(src: Tensor, dst: Tensor, mask: Tensor, n_iters: int = 150,
                            levels: int = 4) -> Tensor:
    """Coarse-to-fine Poisson blend: solve at 1/2^(levels-1) first, then
    each finer level starts from the bilinear upsample of the coarser one."""
    src, dst, mask = (t.permute(0, 3, 1, 2) for t in (src, dst, mask))
    h, w = src.shape[-2:]
    out = None
    for lvl in reversed(range(levels)):
        hw = (h // 2 ** lvl, w // 2 ** lvl)
        src_l = resize(src, hw, "bilinear")
        dst_l = resize(dst, hw, "bilinear")
        m_l = (resize(mask, hw, "nearest") > 0.5).to(src.dtype)
        init = src_l if out is None else m_l * resize(out, hw, "bilinear") + (1 - m_l) * dst_l
        start = m_l * init + (1 - m_l) * dst_l
        out = _jacobi(start, dst_l, m_l, _lap(src_l), n_iters)
    return out.clamp(0.0, 1.0).permute(0, 2, 3, 1)
