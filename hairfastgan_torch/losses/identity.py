"""ArcFace IR-SE-50 identity loss, TreB1eN Backbone variant (counterpart of
hairfastgan_tpu/losses/identity.py).

Rebuilds IDLoss of reference losses/pp_losses.py:267-296: crop the face
region [35:223, 32:220] of the 256 image, adaptive-pool to 112, embed with
IR-SE-50 (input_layer + 24 bottlenecks + BN/flatten/linear/BN head), then
1 - cosine between (already unit-ish) embeddings. The trunk is
models/e4e.py's bottleneck_IR_SE body: one implementation for the e4e
encoder and this loss. Public functions take NHWC images, as the JAX
package's do; the trunk runs NCHW.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from hairfastgan_torch.models.e4e import _blocks_50, bottleneck_ir, init_irse_body, irse_stem
from hairfastgan_torch.models.layers import init_bn, init_linear
from hairfastgan_torch.ops.basic import batch_norm, linear
from hairfastgan_torch.params.convert import _t_bottleneck_ir, t_bn, t_conv, t_linear, t_prelu

Tensor = torch.Tensor


def init_irse_backbone(embed_dim: int = 512, width: float = 1.0):
    """Shape tree (JAX layout, meta tensors; zoo.fill_random fills it).
    width<1 thins the trunk (micro test configs only: converted checkpoints
    always load at width 1)."""
    c512 = max(16, int(512 * width))
    return {"body": init_irse_body(se=True, width=width), "bn_out": init_bn(c512),
            "fc": init_linear(c512 * 7 * 7, embed_dim), "bn_feat": init_bn(embed_dim)}


def irse_embed(p, x112: Tensor) -> Tensor:
    """[B,112,112,3] in [-1,1] (NHWC) -> [B,512] (l2-unnormalized) embedding."""
    y = irse_stem(p["body"], x112.permute(0, 3, 1, 2))
    for blk in p["body"]["body"]:
        y = bottleneck_ir(blk, y)
    y = batch_norm(p["bn_out"], y).flatten(1)  # torch's NCHW flatten
    return batch_norm(p["bn_feat"], linear(p["fc"], y))


def extract_id_feats(p, img256: Tensor) -> Tensor:
    """Crop + pool to 112 then embed (pp_losses.py:279-283), NHWC."""
    crop = img256[:, 35:223, 32:220, :].permute(0, 3, 1, 2).contiguous()  # see train/rotate
    return irse_embed(p, F.adaptive_avg_pool2d(crop, (112, 112)).permute(0, 2, 3, 1))


def id_loss(p, y_hat256: Tensor, y256: Tensor) -> Tensor:
    """mean(1 - <e(y_hat), e(y)>) (pp_losses.py:285-296); y's embedding is
    detached (computed without a graph)."""
    a = extract_id_feats(p, y_hat256)
    with torch.no_grad():
        b = extract_id_feats(p, y256)
    return torch.mean(1.0 - torch.sum(a * b, dim=-1))


def convert_irse_backbone(sd) -> Dict:
    """TreB1eN ir_se50.pth state dict ({key: ndarray}) -> init_irse_backbone's tree.

    Keys: input_layer.{0 conv,1 bn,2 prelu}, body.N.*, output_layer.{0 bn,
    3 linear, 4 bn1d}.
    """
    return {
        "body": {"input": {"conv": t_conv(sd, "input_layer.0"), "bn": t_bn(sd, "input_layer.1"),
                           "prelu": t_prelu(sd, "input_layer.2")},
                 "body": [_t_bottleneck_ir(sd, f"body.{i}", stride)
                          for i, (_, _, stride) in enumerate(_blocks_50())]},
        "bn_out": t_bn(sd, "output_layer.0"),
        "fc": t_linear(sd, "output_layer.3"),
        "bn_feat": t_bn(sd, "output_layer.4"),
    }
