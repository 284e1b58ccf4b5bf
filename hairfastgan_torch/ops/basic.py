"""Primitive NN ops over param dicts, NCHW (counterpart of hairfastgan_tpu/ops/basic.py).

Conventions (the bridge, params/bridge.py, produces them from the JAX zoo):
  * feature maps are NCHW
  * conv weights are OIHW (JAX HWIO -> permute(3, 2, 0, 1))
  * linear weights are [out, in] (JAX [in, out] -> .T)
  * params are plain dicts of tensors

Norms keep the JAX package's precision convention: statistics fold in f32,
the map-sized affine runs in the map's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Padding = Union[int, Tuple[int, int], Sequence[Tuple[int, int]]]


def linear(p, x: Tensor) -> Tensor:
    """y = x @ w.T + b with w: [out, in]."""
    b = p.get("b")
    return F.linear(x, p["w"].to(x.dtype), None if b is None else b.to(x.dtype))


def _pads(padding: Padding) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """int | (ph, pw) | [(top, bottom), (left, right)] -> ((t, b), (l, r))."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    if isinstance(padding[0], int):
        return (padding[0], padding[0]), (padding[1], padding[1])
    return tuple(padding[0]), tuple(padding[1])


def _channel_view(v: Tensor, ndim: int) -> Tensor:
    """[C] -> broadcastable over dim 1 of an ndim tensor."""
    return v.reshape((-1,) + (1,) * (ndim - 2))


def conv2d(
    x: Tensor,
    w: Tensor,
    b: Optional[Tensor] = None,
    *,
    stride: Union[int, Tuple[int, int]] = 1,
    padding: Padding = 0,
    lhs_dilation: int = 1,
) -> Tensor:
    """NCHW cross-correlation with OIHW weights; JAX conv_general_dilated
    semantics, including asymmetric padding and `lhs_dilation` (input
    dilation, the forward form of a transposed conv)."""
    w = w.to(x.dtype)
    bias = None if b is None else b.to(x.dtype)
    (pt, pb), (pl, pr) = _pads(padding)
    if lhs_dilation > 1:
        # lhs-dilated conv with forward kernel K and pads (lo, hi) ==
        # conv_transpose2d with flip(K) (I/O swapped), padding k-1-lo and
        # output_padding hi-lo
        kh, kw = w.shape[2], w.shape[3]
        ph, pw = kh - 1 - pt, kw - 1 - pl
        oph, opw = pb - pt, pr - pl
        if min(ph, pw, oph, opw) < 0 or max(oph, opw) >= lhs_dilation:
            raise ValueError(f"unsupported lhs-dilated padding {padding}")
        wt = torch.flip(w, (2, 3)).transpose(0, 1)
        return F.conv_transpose2d(x, wt, bias, stride=lhs_dilation,
                                  padding=(ph, pw), output_padding=(oph, opw))
    if pt == pb and pl == pr:
        return F.conv2d(x, w, bias, stride=stride, padding=(pt, pl))
    x = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(x, w, bias, stride=stride)


def conv2d_p(p, x: Tensor, **kw) -> Tensor:
    """conv2d reading weights from a param dict {'w': OIHW, 'b': optional}."""
    return conv2d(x, p["w"], p.get("b"), **kw)


def batch_norm(p, x: Tensor, eps: float = 1e-5) -> Tensor:
    """Inference BatchNorm over dim 1 with running stats (scale/bias folded
    in f32, applied in x.dtype)."""
    scale = p["gamma"].float() * torch.rsqrt(p["var"].float() + eps)
    bias = p["beta"].float() - p["mean"].float() * scale
    return (x * _channel_view(scale.to(x.dtype), x.ndim)
            + _channel_view(bias.to(x.dtype), x.ndim))


def _norm_apply(x: Tensor, mean: Tensor, var: Tensor, gamma, beta,
                eps: float) -> Tensor:
    """y = (x - mean) * rsqrt(var + eps) [* gamma] [+ beta]; f32 fold, map in x.dtype."""
    scale = torch.rsqrt(var + eps)
    if gamma is not None:
        scale = scale * gamma.float()
    shift = -mean * scale
    if beta is not None:
        shift = shift + beta.float()
    return x * scale.to(x.dtype) + shift.to(x.dtype)


def layer_norm(x: Tensor, dims, gamma=None, beta=None, eps: float = 1e-5) -> Tensor:
    """LayerNorm over the trailing `dims` (negative ints), optional affine
    shaped like those dims."""
    if isinstance(dims, int):
        dims = (dims,)
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    return _norm_apply(x, mean, var, gamma, beta, eps)


def instance_norm(x: Tensor, eps: float = 1e-5) -> Tensor:
    """InstanceNorm2d over the spatial dims of NCHW, affine-free (SEAN's use)."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    return _norm_apply(x, mean, var, None, None, eps)


def prelu(p, x: Tensor) -> Tensor:
    """PReLU with a per-channel weight on dim 1."""
    return F.prelu(x, p["w"].to(x.dtype))


def avg_pool_global(x: Tensor) -> Tensor:
    """Global average pool NCHW -> [N,C,1,1]."""
    return x.mean(dim=(2, 3), keepdim=True)
