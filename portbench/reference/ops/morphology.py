"""Binary dilate/erode with a 3x3 cross, in plain PyTorch (utils/image_utils.py:27-55
of the published HairFastGAN: N iterations of a float conv with the cross kernel,
thresholded, which for binary masks is N-fold dilate/erode with zero padding)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _cross(x: Tensor, op) -> Tensor:
    """op (torch.maximum or torch.minimum) over the 3x3 cross of [B,H,W]
    planes, zero outside."""
    up = F.pad(x[:, 1:], (0, 0, 0, 1))
    dn = F.pad(x[:, :-1], (0, 0, 1, 0))
    lf = F.pad(x[:, :, 1:], (0, 1))
    rt = F.pad(x[:, :, :-1], (1, 0))
    return op(op(op(up, dn), op(lf, rt)), x)


def dilate_erode(mask: Tensor, iterations: int = 5) -> Tuple[Tensor, Tensor]:
    """(dilated, eroded) of [B,H,W,1] masks after `iterations` rounds, in the
    input dtype."""
    b = (mask[..., 0] > 0).to(mask.dtype)
    d = e = b
    for _ in range(iterations):
        d, e = _cross(d, torch.maximum), _cross(e, torch.minimum)
    return d[..., None], e[..., None]
