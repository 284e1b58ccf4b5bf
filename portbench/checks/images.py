"""kind "images": what the timed path served, held against the plain
reference (portbench/reference/) on the same inputs and the same weights,
which the reference draws again from the seed (portbench/weights.py) once
the program is gone.

For each checked request (a portbench/load.Sample, drawn by the traffic's
loop) the reference runs the request's own call (its `entry` under
portbench/reference/, its case and options, at its batch size) twice, in
float32 with TF32 off and in the precision the configuration states
(bfloat16), and serves both as the program serves (the PULSE downsample
to `out_res`, then [0,1] -> uint8 as `quantize_u8` does). Over the checked
rows, in uint8 levels:
  D_p  the mean absolute difference of the program's output from the
       float32 reference's
  D_r  the same of the reference's own bfloat16 run
  D_x  the mean absolute difference between the float32 answers of two
       different rows (row i against row i + 1, cyclically)
  mad_excess = (D_p - D_r) / (D_x + 0.05)
that is, how much farther from the float32 answer the program lands than an
honest bfloat16 run of the same mathematics, as a share of how far apart two
different answers are; and row_excess_max, the same taken row by row (each
row's own D_p and D_r, over the same D_x), the worst row: a fault that moves
one row, or a region of each, is not averaged away. The swap's label maps (BiSeNet's and the shape
adaptor's argmax) flip where two logits nearly tie, a flipped label moves
whole regions of the (nearly binary) output, so any bfloat16 run lands
0.2-19 levels from float32 depending on the seed's model: no limit on D_p
alone both holds sound runs and fails the control. Both numbers are compared
with the cell's limits (portbench/limits/<cell>.json).
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import weights
from portbench.load import Sample
from portbench.reference.config import reference_config
from portbench.reference.ops.resample import bicubic_downsample
from portbench.registry import part_root

BENCH = part_root(__file__)

NUMBERS = ("mad_excess", "row_excess_max")
FLOOR_LEVELS = 0.05


def served_u8(final01: torch.Tensor, out_res: Optional[int]) -> torch.Tensor:
    """[B,S,S,3] in [0,1] -> the served uint8 [B,R,R,3]."""
    size = final01.shape[1]
    if out_res is not None and out_res < size:
        final01 = bicubic_downsample(final01.permute(0, 3, 1, 2),
                                     size // out_res).permute(0, 2, 3, 1)
    return (final01.float() * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def mad(a: np.ndarray, b: np.ndarray) -> float:
    """Mean absolute difference of two [B,H,W,3] uint8 outputs, in levels
    (inf when their shapes differ)."""
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a.astype(np.int16) - b.astype(np.int16)).mean())


def excess(d: float, d_ref: float, d_apart: float) -> float:
    """(d - d_ref) / (d_apart + FLOOR_LEVELS)."""
    return (d - d_ref) / (d_apart + FLOOR_LEVELS)


def apart(refs: List[np.ndarray]) -> float:
    """D_x: the mean distance between consecutive rows' answers (0 for one row)."""
    rows = [r for ref in refs for r in ref]
    return float(np.mean([mad(rows[i], rows[(i + 1) % len(rows)]) for i in range(len(rows))]))


def entry(name: str):
    """The reference's function "module:function" under portbench.reference."""
    mod, _, fn = name.partition(":")
    return getattr(importlib.import_module(f"portbench.reference.{mod}"), fn)


class Reference:
    """The reference's zoo (float32, redrawn from the seed) on `device`."""

    def __init__(self, conf: Dict, seed: int, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        zoo, _ = weights.make_zoo(conf["weights"], seed, self.device,
                                  getattr(torch, conf["weights"]["dtype"]), BENCH)
        self.zoo = weights.as_float32(zoo)
        del zoo
        self.cfg = reference_config(conf, BENCH)

    def served(self, s: Sample, precision=None, dtype=torch.float32,
               shares: Optional[List] = None) -> np.ndarray:
        """The reference's uint8 answer to the request `s`. With `shares` (a
        list), an entry that returns its intermediates appends the share of
        hair in the face's and color's parses and in HM_X, per row."""
        imgs = {id(a): torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in s.images}
        mode = precision if precision is not None else contextlib.nullcontext()
        zoo = self.zoo if dtype == torch.float32 else weights.map_tree(
            self.zoo, lambda _, t: t.to(dtype) if t.is_floating_point() else t)
        fn = entry(s.entry)
        probe = shares is not None and "return_intermediate" in inspect.signature(fn).parameters
        with torch.no_grad(), mode:
            out = fn(zoo, *(imgs[id(a)] for a in s.images), case=s.case, cfg=self.cfg,
                     dtype=dtype, generator=None, **s.options,
                     **({"return_intermediate": True} if probe else {}))
            final, inter = out if probe else (out, None)
            if inter is not None:
                lab = self.cfg.hair_label
                shares += [[round(float((inter["mask_face"][i] == lab).float().mean()), 4),
                            round(float((inter["mask_color"][i] == lab).float().mean()), 4),
                            round(float((inter["HM_X"][i] > 0).float().mean()), 4)]
                           for i in range(len(final))]
            res = served_u8(final, s.out_res)
        return res.cpu().numpy()


def compare(conf: Dict, seed: int, device, samples: List[Sample],
            control=None) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(the compared numbers, details) over `samples`. The details hold D_p,
    D_r and D_x; with `control` (a precision mode, precision.Fp8()) they
    also hold the readings that the limits are set from: the control's
    mad_excess (the float32 reference run in `control`) and a wrong
    answer's (each output against the next sample's float32 answer)."""
    ref = Reference(conf, seed, device)
    low = getattr(torch, conf.get("hairfast", {}).get("compute_dtype", "float32"))
    d_p, d_r, d_c, d_w = [], [], [], []
    refs, rows = [], []  # rows: per row, (program's, bf16 reference's, control's) distance
    shares = []
    for s in samples:
        r32 = ref.served(s, shares=shares)
        r16 = ref.served(s, dtype=low)
        rc = ref.served(s, control) if control is not None else None
        refs.append(r32)
        d_p.append(mad(s.output, r32))
        d_r.append(mad(r16, r32))
        if rc is not None:
            d_c.append(mad(rc, r32))
        rows += [(mad(s.output[i:i + 1], r32[i:i + 1]), mad(r16[i:i + 1], r32[i:i + 1]),
                  mad(rc[i:i + 1], r32[i:i + 1]) if rc is not None else None)
                 for i in range(len(r32))]
    if control is not None:
        d_w = [mad(s.output, refs[(i + 1) % len(refs)]) for i, s in enumerate(samples)]
    mean = lambda v: float(np.mean(v)) if v else float("nan")  # noqa: E731
    d_x = apart(refs) if refs else float("nan")
    row_ex = [excess(p, r, d_x) for p, r, _ in rows]
    found = {"mad_excess": excess(mean(d_p), mean(d_r), d_x),
             "row_excess_max": max(row_ex)} if samples else {}
    detail = {"D_p": mean(d_p), "D_r": mean(d_r), "D_x": d_x, "rows": len(rows),
              "row_excess": row_ex, "hair_shares": shares}
    if control is not None:
        control_rows = [excess(c, r, d_x) for _, r, c in rows]
        wrong = [mad(s.output[i:i + 1], refs[(j + 1) % len(refs)][i:i + 1])
                 for j, s in enumerate(samples) for i in range(len(s.output))]
        wrong_rows = [excess(w, r, d_x) for w, (_, r, _) in zip(wrong, rows)]
        detail.update(control=excess(mean(d_c), mean(d_r), d_x),
                      wrong=excess(mean(d_w), mean(d_r), d_x),
                      D_control=mean(d_c), D_wrong=mean(d_w),
                      control_row_excess=control_rows,
                      control_row_excess_max=max(control_rows),
                      wrong_row_excess_max=max(wrong_rows))
    return found, detail
