"""The control of the comparison: the plain reference computed in fp8.

The configurations compute in bfloat16; the nearest precision below it is
fp8 (or int8). Inside `Fp8()` every operand of a convolution or a matrix
product (F.conv2d, F.conv_transpose2d, F.linear, matmul, mm, bmm, addmm,
baddbmm, einsum) is rounded to float8 e4m3 with a per-tensor scale (its
largest magnitude onto 448), as an fp8 inference path feeds the H100's
tensor cores; the products accumulate, and everything else computes, in
float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in x's dtype."""
    if not x.is_floating_point() or x.numel() == 0:
        return x
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    q = (x.float() / scale).clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)
    return (q.float() * scale).to(x.dtype)


# function -> positions of the operands that are rounded
_OPERANDS = {F.conv2d: (0, 1), F.conv_transpose2d: (0, 1), F.linear: (0, 1),
             torch.matmul: (0, 1), torch.Tensor.matmul: (0, 1),
             torch.Tensor.__matmul__: (0, 1), torch.Tensor.__rmatmul__: (0, 1),
             torch.mm: (0, 1), torch.bmm: (0, 1), torch.addmm: (1, 2),
             torch.baddbmm: (1, 2)}


class Fp8(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.einsum:
            eq, *ops = args
            if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                ops = list(ops[0])
            return func(eq, *[fp8_round(o) if isinstance(o, torch.Tensor) else o for o in ops])
        pos = _OPERANDS.get(func)
        if pos is not None:
            args = tuple(fp8_round(a) if i in pos and isinstance(a, torch.Tensor) else a
                         for i, a in enumerate(args))
            for k in ("weight", "other", "mat2", "batch2"):
                if isinstance(kwargs.get(k), torch.Tensor):
                    kwargs[k] = fp8_round(kwargs[k])
        return func(*args, **kwargs)
