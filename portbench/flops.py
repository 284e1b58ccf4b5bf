"""FLOPs per transfer of a configuration, counted on its plain reference.

    python3 -m portbench.flops <config> [<config> ...]

runs the reference swap (portbench/reference/, the `distinct` case, B=1) on
`meta` tensors, weights and images alike, under
`torch.utils.flop_counter.FlopCounterMode`, which counts 2 x the
multiply-adds of every convolution and matrix product (elementwise work is
not counted), and prints each configuration's count with the breakdown by
operator. The count does not depend on the program: it is written into the
configuration's file ("flops_per_transfer") and read from there.
"""

from __future__ import annotations

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.check import reference_config
from portbench.reference.bridge import map_tree
from portbench.reference.pipeline.swap import hair_fast
from portbench.reference.zoo import zoo_shapes
from portbench.registry import Registry


def count(conf, batch: int = 1):
    """(FLOPs per transfer, {operator: FLOPs per transfer}) of `conf`."""
    tree, _ = zoo_shapes(conf["weights"]["zoo"])
    zoo = map_tree(tree, lambda _, t: torch.empty(t.shape, device="meta"))
    cfg = reference_config(conf)
    size = cfg.stylegan.size
    img = torch.empty((batch, size, size, 3), dtype=torch.uint8, device="meta")
    face, shape, color = img, img.clone(), img.clone()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        hair_fast(zoo, face, shape, color, case="distinct", cfg=cfg, dtype=torch.float32)
    per_op = {str(k): v / batch for k, v in fc.get_flop_counts()["Global"].items()}
    return fc.get_total_flops() / batch, per_op


def main(argv=None) -> None:
    reg = Registry.load()
    for name in (argv if argv is not None else sys.argv[1:]):
        total, per_op = count(reg.config(name))
        print(json.dumps({"config": name, "flops_per_transfer": total, "by_op": per_op}))


if __name__ == "__main__":
    main()
