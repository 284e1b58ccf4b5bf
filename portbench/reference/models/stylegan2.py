"""StyleGAN2 config-f synthesis with the HairFast layer-slice API, PyTorch.

Counterpart of hairfastgan_tpu/models/stylegan2.py (reference
models/stylegan2/model.py:368-594): the mapping network (`mapping`,
`mean_latent`), W -> W+ broadcast, and the sliced synthesis. Layer pairs:
  pair 0: conv1 @4x4 + to_rgb1                      styles latent[:, 0], [:, 1]
  pair l in 1..: up-conv + conv + to_rgb @ 2^(l+2)  styles [:, 2l-1], [:, 2l], [:, 2l+1]
Noise maps: pair l uses noise[2l-1], noise[2l] (pair 0 uses noise[0]).

`synthesis` keeps the JAX signature layouts (layer_in, noise maps and the
returned maps are NHWC) and runs NCHW inside. Its compute dtype is an
explicit argument: the latent and layer_in are cast to it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from portbench.reference.models.layers import spec
from portbench.reference.ops.equalized import equal_linear, pixel_norm
from portbench.reference.ops.fused_act import fused_leaky_relu
from portbench.reference.ops.modconv import modulated_conv2d
from portbench.reference.ops.upfirdn2d import upsample2d

Tensor = torch.Tensor


def _init_equal_linear(in_dim: int, out_dim: int):
    return {"w": spec(in_dim, out_dim), "b": spec(out_dim)}


def _init_modconv(in_ch: int, out_ch: int, k: int, style_dim: int):
    return {"w": spec(k, k, in_ch, out_ch),
            "modulation": _init_equal_linear(style_dim, in_ch)}


def init_generator_params(cfg):
    """Shape tree of the generator at `cfg` (a StyleGANConfig)."""
    ch4 = cfg.channels(4)
    params = {
        "style": [_init_equal_linear(cfg.style_dim, cfg.style_dim)
                  for _ in range(cfg.n_mlp)],
        "input": spec(1, 4, 4, ch4),
        "conv1": {"conv": _init_modconv(ch4, ch4, 3, cfg.style_dim),
                  "noise_weight": spec(), "bias": spec(ch4)},
        "to_rgb1": {"conv": _init_modconv(ch4, 3, 1, cfg.style_dim), "bias": spec(3)},
        "convs": [],
        "to_rgbs": [],
    }
    in_ch = ch4
    for i in range(3, cfg.log_size + 1):
        out_ch = cfg.channels(2 ** i)
        for cin in (in_ch, out_ch):
            params["convs"].append({"conv": _init_modconv(cin, out_ch, 3, cfg.style_dim),
                                    "noise_weight": spec(), "bias": spec(out_ch)})
        params["to_rgbs"].append({"conv": _init_modconv(out_ch, 3, 1, cfg.style_dim),
                                  "bias": spec(3)})
        in_ch = out_ch
    return params


def noise_resolutions(cfg) -> List[int]:
    return [2 ** ((i + 5) // 2) for i in range(cfg.num_layers)]


def make_noise(generator: Optional[torch.Generator], cfg, batch: int = 1,
               device=None) -> List[Optional[Tensor]]:
    """Noise maps for `synthesis_nchw`: fresh gaussians [B,1,res,res] (f32)
    drawn from `generator` (reference NoiseInjection with randomize_noise),
    or Nones (zero noise) without one."""
    if generator is None:
        return [None] * cfg.num_layers
    device = generator.device if device is None else device
    return [torch.randn((batch, 1, r, r), generator=generator, device=device)
            for r in noise_resolutions(cfg)]


def zero_noise(cfg, batch: int = 1, device=None) -> List[Tensor]:
    """Zero noise maps for `synthesis`, NHWC [B,res,res,1] (f32)."""
    return [torch.zeros((batch, r, r, 1), device=device) for r in noise_resolutions(cfg)]


def mapping(params, z: Tensor, cfg) -> Tensor:
    """z [B, style_dim] -> w through PixelNorm + n_mlp EqualLinear(fused_lrelu,
    lr_mul cfg.lr_mlp) over params["style"]."""
    x = pixel_norm(z, dim=-1)
    for lp in params["style"]:
        x = equal_linear(lp, x, lr_mul=cfg.lr_mlp, activation="fused_lrelu")
    return x


def mean_latent(params, generator: torch.Generator, n: int, cfg) -> Tensor:
    """Mean w [1, style_dim] of n mapped gaussian z drawn from `generator`
    (on the generator's device)."""
    z = torch.randn((n, cfg.style_dim), generator=generator, device=generator.device)
    return mapping(params, z, cfg).mean(dim=0, keepdim=True)


def latent_to_wplus(w: Tensor, n_latent: int = 18) -> Tensor:
    """[B,512] -> [B,n_latent,512] broadcast (reference model.py:515-522);
    a W+ code passes through."""
    if w.ndim == 3:
        return w
    return w[:, None, :].expand(-1, n_latent, -1)


def _styled_conv(p, x: Tensor, style: Tensor, noise: Optional[Tensor], *,
                 up: bool = False) -> Tensor:
    """StyledConv: the modulated conv, then noise, bias and sqrt(2) * lrelu,
    each per output channel."""
    y = modulated_conv2d(p["conv"], x, style, demodulate=True, up=up)
    if noise is not None:
        y = y + p["noise_weight"].to(y.dtype) * noise.to(y.dtype)
    return fused_leaky_relu(y, p["bias"])


def _to_rgb(p, x: Tensor, style: Tensor, skip: Optional[Tensor] = None) -> Tensor:
    """ToRGB: the 1x1 modulated conv, its bias and the upsampled skip."""
    y = modulated_conv2d(p["conv"], x, style, demodulate=False)
    y = y + p["bias"].to(y.dtype).view(1, -1, 1, 1)
    if skip is not None:
        y = y + upsample2d(skip)
    return y


def synthesis_nchw(params, latent: Tensor, *, noise: Sequence[Optional[Tensor]],
                   start_layer: int = 0, end_layer: int = 8,
                   layer_in: Optional[Tensor] = None, skip: Optional[Tensor] = None, cfg,
                   dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """The synthesis loop on NCHW maps; `noise` is a list of num_layers
    NCHW maps or Nones. `skip` is the ToRGB skip that enters pair
    `start_layer` (None starts the chain there), as the JAX package's; a
    start at pair 0 begins a new chain. Returns the last pair's (features,
    skip)."""
    latent = latent.to(dtype)
    out = None
    if start_layer == 0:
        x = params["input"].to(dtype).expand(latent.shape[0], -1, -1, -1)
        out = x = _styled_conv(params["conv1"], x, latent[:, 0], noise[0])
        skip = _to_rgb(params["to_rgb1"], out, latent[:, 1])
    else:
        x = None if layer_in is None else layer_in.to(dtype)
    if end_layer == 0:
        return out, skip
    for pair in range(max(start_layer, 1), min(end_layer, cfg.log_size - 2) + 1):
        i = 2 * pair - 1
        h = _styled_conv(params["convs"][2 * pair - 2], x, latent[:, i], noise[i], up=True)
        out = x = _styled_conv(params["convs"][2 * pair - 1], h, latent[:, i + 1], noise[i + 1])
        skip = _to_rgb(params["to_rgbs"][pair - 1], out, latent[:, i + 2], skip)
    return out, skip


def synthesis(params, latent: Tensor, *,
              noise: Optional[Sequence[Optional[Tensor]]] = None,
              generator: Optional[torch.Generator] = None,
              start_layer: int = 0, end_layer: int = 8,
              layer_in: Optional[Tensor] = None, skip: Optional[Tensor] = None, cfg,
              dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """Sliced synthesis (Generator.forward, model.py:477-565), JAX layouts.

    latent: [B, n_latent, 512] W+ codes. noise: list of num_layers NHWC maps
    [B,res,res,1] (or Nones); without it, `generator` draws fresh noise and
    no generator means zero noise. layer_in: NHWC features entering pair
    `start_layer`; skip: the NHWC rgb skip entering it (a resumed chain).
    Returns NHWC (features_out, rgb_skip) of the last pair.
    """
    if noise is not None:
        noise = [None if n is None else n.permute(0, 3, 1, 2) for n in noise]
    else:
        noise = make_noise(generator, cfg, latent.shape[0], latent.device)
    if layer_in is not None:
        layer_in = layer_in.permute(0, 3, 1, 2)
    if skip is not None:
        skip = skip.permute(0, 3, 1, 2)
    out, skip = synthesis_nchw(params, latent, noise=noise, start_layer=start_layer,
                               end_layer=end_layer, layer_in=layer_in, skip=skip, cfg=cfg,
                               dtype=dtype)
    return (None if out is None else out.permute(0, 2, 3, 1),
            None if skip is None else skip.permute(0, 2, 3, 1))


def generate(params, latent: Tensor, *, noise: Optional[Sequence[Optional[Tensor]]] = None,
             generator: Optional[torch.Generator] = None, cfg,
             dtype: torch.dtype = torch.float32) -> Tensor:
    """Full 0..8 render -> NHWC RGB in [-1, 1] (noise as in `synthesis`)."""
    return synthesis(params, latent, noise=noise, generator=generator, cfg=cfg, dtype=dtype)[1]
