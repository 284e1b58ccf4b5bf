"""Blending + PostProcess stage (counterpart of
hairfastgan_tpu/pipeline/blending.py; reference models/Blending.py:35-81).

  * dilate/erode the hair masks of face and color and the target hair mask
    (the three calls are independent per mask, so they run as ONE launch
    of the morphology kernel over the concatenated batch)
  * target face region = (1-HM1D)(1-HM3D)(1-HMXD)
  * ClipBlendingModel(S1[:,6:], S3[:,6:], I1*mask, I3*HM3E) -> S_blend[6:]
    (skipped when all three images are the same)
  * I_blend = G[4..8](S_blend, layer_in=F_align); PostProcessModel(I_1,
    downsample(I_blend)) -> S_final, F_final; I_final = G[5..8](S_final, F_final)

With `sp` (parallel/spatial.SpatialPlan) both renders H-band their
>= from_res pairs over its devices: I_blend is gathered (PostProcess reads
all of it), the final render is finished per band and its bands are
assembled on the lead device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from hairfastgan_torch.config import HairFastConfig
from hairfastgan_torch.models import encoders, stylegan2
from hairfastgan_torch.ops.morphology import dilate_erode
from hairfastgan_torch.parallel import mesh
from hairfastgan_torch.parallel.spatial import sharded_synthesis
from hairfastgan_torch.pipeline.embedding import to_res
from hairfastgan_torch.utils import timing

Tensor = torch.Tensor


@timing.span("blend")
def blend_images(zoo: Dict, align_shape: Dict[str, Tensor], align_color: Dict[str, Tensor],
                 embed_face: Dict[str, Tensor], embed_color: Dict[str, Tensor], *,
                 all_same: bool = False, cfg: HairFastConfig = HairFastConfig(),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 return_intermediate: bool = False, sp=None):
    """-> final image [B,H,W,3] in [0,1] (NHWC); with return_intermediate,
    (final, {I_blend (NHWC, [-1,1]), S_blend, S_final, F_final (NHWC)})."""
    i_1 = embed_face["image_norm_256"].to(dtype)
    i_3 = embed_color["image_norm_256"].to(dtype)
    b, dev = i_1.shape[0], i_1.device

    hair1 = (embed_face["mask"] == cfg.hair_label).to(dtype)[..., None]
    hair3 = (embed_color["mask"] == cfg.hair_label).to(dtype)[..., None]
    hm_x = align_color["HM_X"].to(dtype)
    dil, ero = dilate_erode(torch.cat([hair1, hair3, hm_x]), cfg.smooth)
    hm_1d, hm_3d, hm_xd = dil[:b], dil[b:2 * b], dil[2 * b:]
    hm_3e = ero[b:2 * b]
    target_mask = (1.0 - hm_1d) * (1.0 - hm_3d) * (1.0 - hm_xd)

    latent_s_1 = embed_face["S"].to(dtype)
    if all_same:
        s_blend = latent_s_1
    else:
        s_blend_6 = encoders.blending_model(zoo["blending"], latent_s_1[:, 6:],
                                            embed_color["S"].to(dtype)[:, 6:],
                                            i_1 * target_mask, i_3 * hm_3e)
        s_blend = torch.cat([latent_s_1[:, :6], s_blend_6], dim=1)

    f_align = align_shape["latent_F_align"].to(dtype).permute(0, 3, 1, 2)
    gen = zoo["generator"]
    if sp is not None:
        i_blend = sharded_synthesis(sp, gen, s_blend, start_layer=4, end_layer=8,
                                    layer_in=f_align, cfg=cfg.stylegan, dtype=dtype)
    else:
        _, i_blend = stylegan2.synthesis_nchw(
            gen, s_blend, noise=stylegan2.make_noise(generator, cfg.stylegan, b, dev),
            start_layer=4, end_layer=8, layer_in=f_align, cfg=cfg.stylegan, dtype=dtype)
    i_blend_256 = to_res(i_blend, 256).permute(0, 2, 3, 1)

    s_final, f_final = encoders.post_process_model(zoo["post_process"], i_1, i_blend_256)
    f_final_nchw = f_final.permute(0, 3, 1, 2)
    if sp is not None:
        bands = sharded_synthesis(sp, gen, s_final, start_layer=5, end_layer=8,
                                  layer_in=f_final_nchw, cfg=cfg.stylegan, dtype=dtype,
                                  gather=False)
        final = mesh.gather([((x + 1.0) / 2.0).clamp(0.0, 1.0) for x in bands], dev, dim=2)
    else:
        _, i_final = stylegan2.synthesis_nchw(
            gen, s_final, noise=stylegan2.make_noise(generator, cfg.stylegan, b, dev),
            start_layer=5, end_layer=8, layer_in=f_final_nchw, cfg=cfg.stylegan, dtype=dtype)
        final = ((i_final + 1.0) / 2.0).clamp(0.0, 1.0)
    final = final.permute(0, 2, 3, 1)
    if return_intermediate:
        return final, {"I_blend": i_blend.permute(0, 2, 3, 1), "S_blend": s_blend,
                       "S_final": s_final, "F_final": f_final}
    return final
