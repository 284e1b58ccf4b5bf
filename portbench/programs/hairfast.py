"""program "hairfast": the port's serving handle, hairfastgan_torch.api.HairFast,
on the configuration's weights, as the configuration serves (its
`hairfast` settings and `zoo_transforms`)."""

import dataclasses
from typing import Dict

from portbench.reference.config import reference_config
from portbench.registry import part_root

BENCH = part_root(__file__)


def program_config(conf: Dict):
    """The program's HairFastConfig of a configuration file."""
    from hairfastgan_torch import config as P

    rcfg = reference_config(conf, BENCH)
    fields = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}
    fields["stylegan"] = P.StyleGANConfig(**dataclasses.asdict(rcfg.stylegan))
    for k in ("sean", "shape_adaptor", "clip"):
        fields[k] = getattr(P, type(getattr(rcfg, k)).__name__)(
            **dataclasses.asdict(getattr(rcfg, k)))
    return P.HairFastConfig(**fields)


def build(conf: Dict, seed: int, device):
    """HairFast on the configuration's weights, as the configuration serves."""
    import torch

    from hairfastgan_torch import zoo as Z
    from hairfastgan_torch.api import HairFast

    from portbench import weights

    zoo, _ = weights.make_zoo(conf["weights"], seed, device,
                              getattr(torch, conf["weights"]["dtype"]), BENCH)
    for name in conf.get("zoo_transforms", []):  # e.g. "pack_zoo"
        zoo = getattr(Z, name)(zoo)
    return HairFast(program_config(conf), zoo=zoo, device=device)


def flops(conf: Dict, batch: int = 1):
    """(FLOPs per transfer, {operator: FLOPs per transfer}): the reference
    swap (portbench/reference/, the `distinct` case) at `batch` on `meta`
    tensors, weights and images alike, under FlopCounterMode."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.bridge import map_tree
    from portbench.reference.pipeline.swap import hair_fast
    from portbench.reference.zoo import zoo_shapes

    tree, _ = zoo_shapes(conf["weights"]["zoo"], BENCH)
    zoo = map_tree(tree, lambda _, t: torch.empty(t.shape, device="meta"))
    cfg = reference_config(conf, BENCH)
    size = cfg.stylegan.size
    img = torch.empty((batch, size, size, 3), dtype=torch.uint8, device="meta")
    face, shape, color = img, img.clone(), img.clone()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        hair_fast(zoo, face, shape, color, case="distinct", cfg=cfg, dtype=torch.float32)
    per_op = {str(k): v / batch for k, v in fc.get_flop_counts()["Global"].items()}
    return fc.get_total_flops() / batch, per_op
