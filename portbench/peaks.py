"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense rates,
without sparsity, at the full 700 W power limit), and the least time of the
port's one hand-written kernel."""

from __future__ import annotations

import math

BF16_FLOPS_PER_S = 989e12  # bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12  # HBM3
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def dilate_erode_bound(shape, itemsize: int, iterations: int):
    """(ms, "bytes" or "operations"): the least time the card could take for
    dilate_erode at `shape` ([B,H,W,1] masks): one read of the mask and one
    write of each of the two outputs over the HBM rate, or the 4 two-input
    max (dilate) and 4 min (erode) per pixel per round over the float32
    rate, whichever is larger (bytes on a tie)."""
    n = int(math.prod(shape))
    t_bytes = 3 * n * itemsize / HBM_BYTES_PER_S
    t_ops = 8 * iterations * n / F32_OPS_PER_S
    if t_bytes >= t_ops * (1 - 1e-9):  # [1,1024,1024,1] f32 x30 ties to rounding
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"
