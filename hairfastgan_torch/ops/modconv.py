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
it is flipped back here (once, not twice). Plain PyTorch; the hand kernel
with the noise/bias/lrelu epilogue is later work (ROADMAP kernel queue 2).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from hairfastgan_torch.ops.basic import fold_dtype
from hairfastgan_torch.ops.equalized import equal_linear
from hairfastgan_torch.ops.upfirdn2d import blur2d


def _demod_coeff(w: torch.Tensor, s: torch.Tensor, fan_scale: float,
                 eps: float = 1e-8) -> torch.Tensor:
    """demod[b,o] = rsqrt(sum_{i,kh,kw} (fan_scale*w[o,i,kh,kw]*s[b,i])^2 + eps),
    in fold_dtype(s)."""
    fd = fold_dtype(s)
    w2 = w.to(fd).square().sum(dim=(2, 3)).transpose(0, 1)  # [I, O]
    q = s.to(fd).square() @ w2  # [B, O]
    return torch.rsqrt(q * (fan_scale * fan_scale) + eps)


def modulated_conv2d(p, x: torch.Tensor, style: torch.Tensor, *,
                     demodulate: bool = True, up: bool = False, down: bool = False,
                     blur_kernel: Tuple[int, ...] = (1, 3, 3, 1)) -> torch.Tensor:
    """x [B,I,H,W], style [B,style_dim] -> [B,O,H',W'].

    p['w']: OIHW kernel (forward form; for up=True the flipped transposed-conv
    kernel); p['modulation']: EqualLinear(style_dim -> I, bias init 1).
    Forms: plain, up and down (demodulated StyledConv) and ToRGB (1x1,
    demodulate=False).
    """
    cout, cin, kh, kw = p["w"].shape
    fan_scale = 1.0 / math.sqrt(cin * kh * kw)
    s = equal_linear(p["modulation"], style).to(x.dtype)  # [B, I]
    xm = x * s[:, :, None, None]
    w = p["w"].to(x.dtype) * fan_scale
    if up:
        y = F.conv_transpose2d(xm, torch.flip(w, (2, 3)).transpose(0, 1), stride=2)
    elif down:
        # the reference ModulatedConv2d(downsample=True): Blur, then a stride-2 conv
        pp = (len(blur_kernel) - 2) + (kh - 1)
        y = F.conv2d(blur2d(xm, blur_kernel, pad=((pp + 1) // 2, pp // 2)), w, stride=2)
    else:
        y = F.conv2d(xm, w, padding=kh // 2)
    if demodulate:
        d = _demod_coeff(p["w"], s, fan_scale).to(x.dtype)
        y = y * d[:, :, None, None]
    if up:
        # reference Blur pad (model.py:204-210) with gain factor**2
        pp = (len(blur_kernel) - 2) - (kh - 1)
        y = blur2d(y, blur_kernel, pad=((pp + 1) // 2 + 1, pp // 2 + 1), gain=4.0)
    return y
