"""Style-modulated convolution, NCHW (counterpart of hairfastgan_tpu/ops/modconv.py).

Reference: ModulatedConv2d (models/stylegan2/model.py:183-279). The JAX
package's activation-scaling form is kept:

    conv(x, scale*W*s[b])  ==  conv(x * s[b], scale*W)          (linearity)
    demod[b,o] = rsqrt( sum_{i,kh,kw} (scale*W[o,i]*s[b,i])^2 + eps )

so the conv runs with ONE shared weight (cuDNN) and the per-sample style
becomes two channel scalings. `up=True` is the reference's stride-2
transposed conv followed by a [1,3,3,1] blur with gain 4; `down=True` is
the reference's [1,3,3,1] blur followed by a stride-2 conv. The zoo stores
the up kernel in forward (lhs-dilated) form, pre-flipped by the JAX
converter; conv_transpose2d wants the unflipped kernel with I/O swapped, so
it is flipped back here (once, not twice). `fuse_blur=True` (an op option
no pipeline path passes) composes the up kernel with the blur into one
(k+3)^2 kernel and runs one transposed conv: the same output and shape.
Plain PyTorch; the hand kernel with the noise/bias/lrelu epilogue is later
work (ROADMAP kernel queue 2).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.ops.basic import conv2d, fold_dtype
from portbench.reference.ops.equalized import equal_linear
from portbench.reference.ops.upfirdn2d import blur2d, make_fir_kernel


def _demod_coeff(w: torch.Tensor, s: torch.Tensor, fan_scale: float,
                 eps: float = 1e-8) -> torch.Tensor:
    """demod[b,o] = rsqrt(sum_{i,kh,kw} (fan_scale*w[o,i,kh,kw]*s[b,i])^2 + eps),
    in fold_dtype(s)."""
    fd = fold_dtype(s)
    w2 = w.to(fd).square().sum(dim=(2, 3)).transpose(0, 1)  # [I, O]
    q = s.to(fd).square() @ w2  # [B, O]
    return torch.rsqrt(q * (fan_scale * fan_scale) + eps)


@functools.lru_cache(maxsize=32)
def _blur_matrix(k: int, blur_kernel: Tuple[int, ...], gain: float, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """[k, k+pk-1] matrix m[a, t] = flip(taps)[t - a]: one axis of the
    correlation chain corr(corr(z, W), flip(taps)) == corr(z, W @ m), for
    `taps` the 1-D blur with sqrt(gain) (a true convolution flips them).
    Made outside inference mode, as ops/resample._on_device's tables."""
    taps = np.flip(make_fir_kernel(blur_kernel, gain))
    m = np.zeros((k, k + len(taps) - 1), np.float32)
    for a in range(k):
        m[a, a:a + len(taps)] = taps
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(device=device, dtype=dtype)


def _fuse_blur_kernel(w: torch.Tensor, blur_kernel: Tuple[int, ...],
                      gain: float) -> torch.Tensor:
    """The forward-form OIHW kernel composed with the separable blur:
    [O,I,kh,kw] -> [O,I,kh+pk-1,kw+pk-1], K = m_h^T W m_w per (o, i)."""
    mh = _blur_matrix(w.shape[2], blur_kernel, gain, w.device, w.dtype)
    mw = _blur_matrix(w.shape[3], blur_kernel, gain, w.device, w.dtype)
    return torch.einsum("oiab,at,bs->oits", w, mh, mw)


def modulated_conv2d(p, x: torch.Tensor, style: torch.Tensor, *,
                     demodulate: bool = True, up: bool = False, down: bool = False,
                     blur_kernel: Tuple[int, ...] = (1, 3, 3, 1),
                     fuse_blur: bool = False) -> torch.Tensor:
    """x [B,I,H,W], style [B,style_dim] -> [B,O,H',W'].

    p['w']: OIHW kernel (forward form; for up=True the flipped transposed-conv
    kernel); p['modulation']: EqualLinear(style_dim -> I, bias init 1).
    Forms: plain, up and down (demodulated StyledConv) and ToRGB (1x1,
    demodulate=False). fuse_blur=True (up only): the blur composed into the
    kernel, one stride-2 transposed conv of a (kh+pk-1)^2 kernel in place of
    the conv and the blur's passes (4x the conv's MACs at pk=4).
    """
    s = equal_linear(p["modulation"], style).to(x.dtype)  # [B, I]
    return styled_conv2d(p["w"], x, s, demodulate=demodulate, up=up, down=down,
                         blur_kernel=blur_kernel, fuse_blur=fuse_blur)


def styled_conv2d(weight: torch.Tensor, x: torch.Tensor, s: torch.Tensor, *,
                  demodulate: bool = True, up: bool = False, down: bool = False,
                  blur_kernel: Tuple[int, ...] = (1, 3, 3, 1),
                  fuse_blur: bool = False) -> torch.Tensor:
    """The conv of `modulated_conv2d` given its style scales s [B, I] (the
    modulation's output): weight OIHW. Every output channel reads only its
    own kernel rows."""
    cout, cin, kh, kw = weight.shape
    fan_scale = 1.0 / math.sqrt(cin * kh * kw)
    xm = x * s[:, :, None, None]
    w = weight.to(x.dtype) * fan_scale
    if up and fuse_blur:
        # the two-pass path is the lhs-dilated conv padded by k-1, then the
        # blur padded by (lo, hi); as the first conv's outer k-1 rows of
        # padding yield zeros, the blur's padding moves onto its input:
        # one lhs-dilated conv of the composed kernel, padded k-1 + (lo, hi)
        pp = (len(blur_kernel) - 2) - (kh - 1)
        lo, hi = (pp + 1) // 2 + 1, pp // 2 + 1
        y = conv2d(xm, _fuse_blur_kernel(w, blur_kernel, 4.0),
                   padding=[(lo + kh - 1, hi + kh - 1), (lo + kw - 1, hi + kw - 1)],
                   lhs_dilation=2)
        if demodulate:
            y = y * _demod_coeff(weight, s, fan_scale).to(x.dtype)[:, :, None, None]
        return y
    if up:
        y = F.conv_transpose2d(xm, torch.flip(w, (2, 3)).transpose(0, 1), stride=2)
    elif down:
        # the reference ModulatedConv2d(downsample=True): Blur, then a stride-2 conv
        pp = (len(blur_kernel) - 2) + (kh - 1)
        y = F.conv2d(blur2d(xm, blur_kernel, pad=((pp + 1) // 2, pp // 2)), w, stride=2)
    else:
        y = F.conv2d(xm, w, padding=kh // 2)
    if demodulate:
        d = _demod_coeff(weight, s, fan_scale).to(x.dtype)
        y = y * d[:, :, None, None]
    if up:
        # reference Blur pad (model.py:204-210) with gain factor**2
        pp = (len(blur_kernel) - 2) - (kh - 1)
        y = blur2d(y, blur_kernel, pad=((pp + 1) // 2 + 1, pp // 2 + 1), gain=4.0)
    return y
