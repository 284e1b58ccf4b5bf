"""FLOPs per transfer of a configuration, counted on its plain reference.

    python3 -m portbench.flops <config> [<config> ...]

asks the configuration's program (portbench/programs/<name>.py, its
`flops(conf)`) to count the work of one transfer on the plain reference,
under `torch.utils.flop_counter.FlopCounterMode`, which counts 2 x the
multiply-adds of every convolution and matrix product (elementwise work is
not counted), and prints each configuration's count with the breakdown by
operator. The count does not depend on the program's speed: it is written
into the configuration's file ("flops_per_transfer") and read from there.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional

from portbench.registry import Registry


def count(conf: Dict, reg: Optional[Registry] = None):
    """(FLOPs per transfer, {operator: FLOPs per transfer}) of `conf`."""
    return (reg or Registry.load()).program(conf).flops(conf)


def main(argv=None) -> None:
    reg = Registry.load()
    for name in (argv if argv is not None else sys.argv[1:]):
        total, per_op = count(reg.config(name), reg)
        print(json.dumps({"config": name, "flops_per_transfer": total, "by_op": per_op}))


if __name__ == "__main__":
    main()
