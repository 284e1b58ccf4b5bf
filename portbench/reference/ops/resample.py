"""Resize/resampling as precomputed separable matrices, NCHW.

Counterpart of hairfastgan_tpu/ops/resample.py: torch `F.interpolate`
nearest (floor indexing) / bilinear / bicubic (a=-0.75) with either
align_corners convention, and the PULSE bicubic FIR downsampler of the
reference `utils/bicubic.py`. Each is a fixed linear map per spatial axis,
built once with numpy and applied as two matmuls; nearest is an exact
index gather.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _cubic_weight(x: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic kernel with parameter a (torch bicubic uses a=-0.75)."""
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0,
        np.where(ax < 2.0, a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """torch legacy 'nearest': src = floor(dst * in/out)."""
    scale = in_size / out_size
    return np.minimum(np.floor(np.arange(out_size) * scale).astype(np.int64),
                      in_size - 1)


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int, mode: str,
                  align_corners: bool = False) -> np.ndarray:
    """[out, in] matrix reproducing torch F.interpolate on one axis
    (border replication at the edges)."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if mode == "nearest":
        m[np.arange(out_size), _nearest_index(in_size, out_size)] = 1.0
        return m.astype(np.float32)

    if align_corners and out_size > 1:
        src = np.arange(out_size) * ((in_size - 1) / (out_size - 1))
    else:
        src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5

    if mode == "bilinear":
        s = np.clip(src, 0.0, None)  # torch clamps src >= 0 before floor+frac
        j0 = np.floor(s).astype(np.int64)
        frac = s - j0
        j0 = np.clip(j0, 0, in_size - 1)
        j1 = np.clip(j0 + 1, 0, in_size - 1)
        for i in range(out_size):
            m[i, j0[i]] += 1.0 - frac[i]
            m[i, j1[i]] += frac[i]
        return m.astype(np.float32)

    if mode == "bicubic":
        j0 = np.floor(src).astype(np.int64)
        t = src - j0
        for i in range(out_size):
            for k in range(-1, 3):  # taps j0-1 .. j0+2, clamped indices
                j = int(np.clip(j0[i] + k, 0, in_size - 1))
                m[i, j] += float(_cubic_weight(np.array(t[i] - k), -0.75))
        return m.astype(np.float32)

    raise ValueError(f"unknown resize mode {mode!r}")


@functools.lru_cache(maxsize=None)
def bicubic_downsample_matrix(in_size: int, factor: int) -> np.ndarray:
    """PULSE BicubicDownSample as an [in/factor, in] matrix: a 4*factor-tap
    bicubic FIR (a=-0.5), normalized, stride `factor`, after reflect padding
    of (4*factor - factor) split floor/ceil."""
    size = factor * 4
    xs = (np.arange(size) - np.floor(size / 2) + 0.5) / factor
    k = _cubic_weight(xs, -0.5)
    k = k / k.sum()
    pad_lo = (size - factor) // 2
    pad_hi = size - factor - pad_lo
    idx = np.abs(np.arange(-pad_lo, in_size + pad_hi))  # reflect at 0
    idx = np.where(idx >= in_size, 2 * (in_size - 1) - idx, idx)
    m = np.zeros((in_size // factor, in_size), dtype=np.float64)
    for o in range(in_size // factor):
        for t in range(size):
            m[o, idx[o * factor + t]] += k[t]
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _on_device(kind: str, args: Tuple, device: torch.device,
               dtype: torch.dtype) -> Tensor:
    """The cached matrix of `kind` on the device. Made outside inference
    mode even under torch.inference_mode(): an inference tensor in the cache
    would make every later autograd pass through it (training) raise."""
    make = {"resize": resize_matrix, "down": bicubic_downsample_matrix,
            "nearest": _nearest_index}[kind]
    with torch.inference_mode(False):
        return torch.from_numpy(make(*args)).to(device=device, dtype=dtype)


def _apply_axis_matrices(x: Tensor, ah: Tensor, aw: Tensor) -> Tensor:
    """y[..., o, p] = sum_hw ah[o, h] x[..., h, w] aw[p, w]."""
    return torch.matmul(torch.matmul(ah, x), aw.transpose(0, 1))


def resize(x: Tensor, out_hw: Tuple[int, int], mode: str = "bilinear",
           align_corners: bool = False) -> Tensor:
    """torch-F.interpolate-equivalent resize over the last two dims."""
    (h, w), (oh, ow) = x.shape[-2:], out_hw
    if (oh, ow) == (h, w):
        return x
    if mode == "nearest":
        ih = _on_device("nearest", (h, oh), x.device, torch.int64)
        iw = _on_device("nearest", (w, ow), x.device, torch.int64)
        return x.index_select(-2, ih).index_select(-1, iw)
    ah = _on_device("resize", (h, oh, mode, align_corners), x.device, x.dtype)
    aw = _on_device("resize", (w, ow, mode, align_corners), x.device, x.dtype)
    return _apply_axis_matrices(x, ah, aw)


def bicubic_downsample(x: Tensor, factor: int) -> Tensor:
    """PULSE downsample by an integer factor over the last two dims."""
    ah = _on_device("down", (x.shape[-2], factor), x.device, x.dtype)
    aw = _on_device("down", (x.shape[-1], factor), x.device, x.dtype)
    return _apply_axis_matrices(x, ah, aw)
