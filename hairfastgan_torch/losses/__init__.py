from hairfastgan_torch.losses.identity import (  # noqa: F401
    convert_irse_backbone,
    id_loss,
    init_irse_backbone,
    irse_embed,
)
from hairfastgan_torch.losses.objectives import (  # noqa: F401
    adv_d_loss,
    adv_g_loss,
    dice_loss,
    dilated_mask,
    feat_recon_loss,
    r1_penalty,
)
from hairfastgan_torch.losses.perceptual import (  # noqa: F401
    convert_lpips_alex,
    init_lpips_alex,
    lpips,
    lpips_scale,
)
