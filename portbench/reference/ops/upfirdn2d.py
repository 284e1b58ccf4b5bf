"""upfirdn2d: pad -> zero-stuff upsample -> FIR -> downsample, NCHW.

Counterpart of hairfastgan_tpu/ops/upfirdn2d.py (reference
models/stylegan2/op/upfirdn2d_kernel.cu). The FIR kernels are separable
([1,3,3,1] outer products), so each spatial axis runs a 1-D pass as shifted
multiply-adds. Zero-stuffing keeps the reference's trailing zeros (n*up
samples per axis), as the JAX version does. Plain PyTorch; the hand kernel
is later work (ROADMAP kernel queue item 3).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def make_fir_kernel(k: Tuple[int, ...], gain: float = 1.0) -> np.ndarray:
    """Normalized 1-D taps times sqrt(gain) (applied once per axis)."""
    arr = np.asarray(k, dtype=np.float32)
    return arr / arr.sum() * np.sqrt(gain)


def _fir_1d(x: Tensor, taps: np.ndarray, dim: int, up: int, down: int,
            pad: Tuple[int, int]) -> Tensor:
    """1-D up-FIR-down along `dim` (2 = H, 3 = W) of NCHW, true convolution."""
    if up > 1:
        shape = list(x.shape)
        x = torch.stack([x] + [torch.zeros_like(x)] * (up - 1), dim=dim + 1)
        shape[dim] *= up
        x = x.reshape(shape)
    n = x.shape[dim]
    t_len = len(taps)
    m_out = (n + pad[0] + pad[1] - t_len) // down + 1
    cfg = [0, 0, 0, 0]  # F.pad order: (W lo, W hi, H lo, H hi)
    off = 0 if dim == 3 else 2
    cfg[off:off + 2] = [pad[0], pad[1]]
    xp = F.pad(x, cfg)
    kt = np.flip(taps)
    y = None
    for t in range(t_len):
        term = xp.narrow(dim, t, (m_out - 1) * down + 1)
        if down > 1:
            term = term[:, :, ::down] if dim == 2 else term[..., ::down]
        term = term * float(kt[t])
        y = term if y is None else y + term
    return y


def upfirdn2d(x: Tensor, kernel_1d: Sequence[int], up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0), gain: float = 1.0) -> Tensor:
    """Separable upfirdn2d with identical pad on both axes; the 2-D kernel is
    the outer product of `kernel_1d` normalized to sum 1, times `gain`."""
    taps = make_fir_kernel(tuple(int(v) for v in kernel_1d), gain)
    y = _fir_1d(x, taps, 2, up, down, pad)
    return _fir_1d(y, taps, 3, up, down, pad)


def blur2d(x: Tensor, kernel_1d, pad: Tuple[int, int], gain: float = 1.0) -> Tensor:
    """FIR blur (reference Blur)."""
    return upfirdn2d(x, kernel_1d, pad=pad, gain=gain)


def upsample2d(x: Tensor, kernel_1d=(1, 3, 3, 1), factor: int = 2) -> Tensor:
    """Reference Upsample: kernel gain factor**2."""
    p = len(kernel_1d) - factor
    pad = ((p + 1) // 2 + factor - 1, p // 2)
    return upfirdn2d(x, kernel_1d, up=factor, pad=pad, gain=float(factor ** 2))


def downsample2d(x: Tensor, kernel_1d=(1, 3, 3, 1), factor: int = 2) -> Tensor:
    """Reference Downsample."""
    p = len(kernel_1d) - factor
    return upfirdn2d(x, kernel_1d, down=factor, pad=((p + 1) // 2, p // 2))
