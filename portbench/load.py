"""The traffic generator: a traffic mix is data (portbench/traffic/<t>.json),
and its `kind` names the loop that drives the program with it
(portbench/loops/<kind>.py, found by name through the Registry). A new mix
of a kind that exists is a data file; a new kind is a new loop file.

A loop module defines `Loop(traffic, hf, seed, device)` with:
  setup()                  make the mix's inputs and warm the shapes it uses
  window(seconds, tracer)  drive the program for `seconds`; fill `records`
                           (per request: t0, t1, transfers, ok, profiled)
                           and `start`, `end`
  samples(rng, k)          k Samples of the window's finished requests,
                           drawn from `rng`: what the check compares
  close()                  stop what it started, drop its outputs

This module holds what the loops share: seeded image pools and request
plans, and the Sample that tells the check (portbench/check.py) how the
reference computes a request's answer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for the run seed's `stream`."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 128, stream]).generate_state(
        2, dtype=np.uint32).view(np.uint64)[0] >> 1)


def make_pool(seed: int, n: int, res: int, low: int, device) -> List[np.ndarray]:
    """n seeded uint8 [res,res,3] images, made on `device`: `low`^2 uniform
    noise per channel, bicubic-upsampled, so that they have smooth regions
    as photos do."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 1))
    lo = torch.rand((n, 3, low, low), generator=g, device=device)
    hi = F.interpolate(lo, size=(res, res), mode="bicubic", align_corners=False)
    u8 = (hi.clamp(0, 1) * 255 + 0.5).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    return list(u8.cpu().numpy())


def triples(seed: int, n_pool: int, count: int, per: int = 1) -> np.ndarray:
    """[count, per, 3] pool indices: each request's `per` triples of three
    distinct images."""
    rng = np.random.default_rng(sub_seed(seed, 2))
    return np.stack([np.stack([rng.choice(n_pool, 3, replace=False) for _ in range(per)])
                     for _ in range(count)])


# which of a triple's three images each role (face, shape, color) takes, by case
ROLES = {"distinct": (0, 1, 2), "shape_eq_color": (0, 1, 1), "face_eq_shape": (0, 0, 2),
         "face_eq_color": (0, 1, 0), "same": (0, 0, 0)}


@dataclass
class Sample:
    """One finished request, as the check needs it: the inputs as the
    program got them, what it served, and the reference's call that answers
    it (`entry` a "module:function" under portbench.reference, called as
    entry(zoo, face, shape, color, case=, cfg=, dtype=, generator=None,
    **options) -> [B,S,S,3] in [0,1]; `out_res` the served size)."""
    images: Tuple[np.ndarray, np.ndarray, np.ndarray]  # face, shape, color [B,H,W,3] uint8
    output: np.ndarray  # the program's [B,R,R,3] uint8
    case: str = "distinct"
    entry: str = "pipeline.swap:hair_fast"
    options: Dict = field(default_factory=dict)
    out_res: Optional[int] = None


def draw(records: List[Dict], rng: np.random.Generator, k: int, key=None) -> List[int]:
    """Up to k indices of the requests that returned, drawn from `rng`; with
    `key` (request index -> its inputs' identity), no two with the same inputs."""
    done = [i for i, r in enumerate(records) if r["ok"]]
    out, seen = [], set()
    for j in rng.permutation(len(done)):
        i = done[j]
        kk = i if key is None else key(i)
        if kk not in seen:
            seen.add(kk)
            out.append(i)
        if len(out) == k:
            break
    return sorted(out)
