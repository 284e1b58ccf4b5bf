"""LPIPS (alex, v0.1) perceptual loss, NCHW (counterpart of
hairfastgan_tpu/losses/perceptual.py).

Rebuilds the vendored LPIPS of reference losses/pp_losses.py:380-542:
AlexNet feature trunk (torchvision layout), per-layer channel-L2 unit
normalization, learned 1x1 linear weights, spatial mean, summed over layers;
plus the multi-scale LPIPSScaleLoss (256/128/64 bilinear pyramid).

Inputs follow the reference convention: [-1,1] NCHW images, z-scored with
the LPIPS shift/scale (BaseNet buffers, pp_losses.py:403-409).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from hairfastgan_torch.models.layers import init_conv
from hairfastgan_torch.ops.basic import conv2d_p, max_pool, relu
from hairfastgan_torch.ops.resample import resize

Tensor = torch.Tensor

LPIPS_MEAN = (-0.030, -0.088, -0.188)
LPIPS_STD = (0.458, 0.448, 0.450)

# torchvision alexnet.features conv geometry: (k, stride, pad, out_ch)
_ALEX_CONVS = ((11, 4, 2, 64), (5, 1, 2, 192), (3, 1, 1, 384),
               (3, 1, 1, 256), (3, 1, 1, 256))
_ALEX_LIN_CH = (64, 192, 384, 256, 256)


def init_lpips_alex() -> Dict:
    """Shape tree (JAX layout, meta tensors; zoo.fill_random fills it)."""
    cin = 3
    convs = []
    for k, _, _, cout in _ALEX_CONVS:
        convs.append(init_conv(k, cin, cout))
        cin = cout
    return {"convs": convs, "lins": [init_conv(1, c, 1, bias=False) for c in _ALEX_LIN_CH]}


def convert_lpips_alex(alex_sd, lin_sd) -> Dict:
    """torchvision alexnet.features + lpips lin state dicts ({key: ndarray})
    -> params (OIHW convs as they are)."""
    from hairfastgan_torch.params.convert import t_conv

    convs = [t_conv(alex_sd, n) for n in ("0", "3", "6", "8", "10")]
    lins = []
    for i in range(5):
        for cand in (f"{i}.1", f"lin{i}.model.1"):
            if f"{cand}.weight" in lin_sd:
                lins.append(t_conv(lin_sd, cand))
                break
    return {"convs": convs, "lins": lins}


def _alex_features(p, x: Tensor) -> List[Tensor]:
    """Normalized input -> activations after each ReLU (target layers)."""
    feats = []
    for i, (conv, (_, s, pad, _)) in enumerate(zip(p["convs"], _ALEX_CONVS)):
        x = relu(conv2d_p(conv, x, stride=s, padding=pad))
        feats.append(x)
        if i in (0, 1):  # maxpool after relu1 and relu2 (torchvision alexnet)
            x = max_pool(x, 3, 2)
    return feats


def _unit_normalize(x: Tensor, eps: float = 1e-10) -> Tensor:
    """x / (||x||_channels + eps): eps on the norm, not under the root."""
    return x / (torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True)) + eps)


def lpips(p, x: Tensor, y: Tensor) -> Tensor:
    """x, y: [-1,1] NCHW -> scalar mean LPIPS distance."""
    mean = torch.tensor(LPIPS_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(LPIPS_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    b = x.shape[0]
    # one trunk pass over both images
    feats = _alex_features(p, (torch.cat([x, y]) - mean) / std)
    total = 0.0
    for f, lin in zip(feats, p["lins"]):
        d = torch.square(_unit_normalize(f[:b]) - _unit_normalize(f[b:]))
        total = total + torch.mean(conv2d_p(lin, d), dim=(1, 2, 3))
    return torch.mean(total)


def lpips_scale(p, x: Tensor, y: Tensor, scales: Sequence[int] = (256, 128, 64)) -> Tensor:
    """Multi-scale LPIPS (LPIPSScaleLoss, pp_losses.py:531-542)."""
    total = 0.0
    for res in scales:
        total = total + lpips(p, resize(x, (res, res), "bilinear"),
                              resize(y, (res, res), "bilinear"))
    return total
