from hairfastgan_torch.losses.identity import (  # noqa: F401
    convert_irse_backbone,
    id_loss,
    init_irse_backbone,
    irse_embed,
)
