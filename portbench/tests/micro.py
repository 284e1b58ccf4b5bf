"""A micro cell for the CPU tests: the micro zoo (128^2 generator, narrowed
trunks) under each traffic mix, in a registry copied to a temporary folder,
with limits set from the micro zoo's own readings."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from portbench.registry import HERE, ROOT, Registry

PARTS = ("configs", "traffic", "loops", "programs", "checks", "zoos", "laws", "metrics",
         "spans", "limits")
MICRO_CONFIG = {
    "name": "micro", "source": "portbench tests", "reduced": [],
    "weights": {"zoo": "micro", "dtype": "float32",
                "laws": {"generator": "stylegan2", "bisenet": "bisenet",
                         "shape_adaptor": "shape_adaptor", "*": "lecun"}},
    "hairfast": {"compute_dtype": "bfloat16"}, "zoo_transforms": [],
    "flops_per_transfer": 199439671296.0,
}
# from the micro cells' readings on the CPU (seeds 1-6, 2-3 requests each):
# the bf16 program reads mad_excess 0.0 (on the CPU it runs the reference's
# operations), the fp8 control 0.21-0.46, a wrong answer 0.65-0.95
MICRO_LIMITS = {"mad_excess": 0.1, "row_excess_max": 0.1}


def micro_registry(tmp: Path, traffics=("swap_b1", "batch8"), config=None) -> Registry:
    """A Registry under `tmp` holding portbench's parts plus a micro cell
    `micro.<traffic>` per traffic mix, with short plans and micro limits."""
    d = Path(tmp) / "portbench"
    for part in PARTS:
        shutil.copytree(HERE / part, d / part, dirs_exist_ok=True)
    conf = dict(MICRO_CONFIG, **(config or {}))
    (d / "configs" / f"{conf['name']}.json").write_text(json.dumps(conf))
    bench = copy.deepcopy(json.loads((ROOT / "BENCHMARK.json").read_text()))
    for t in traffics:
        cell = f"{conf['name']}.{t}"
        traffic = json.loads((d / "traffic" / f"{t}.json").read_text())
        traffic["max_requests"] = 40
        (d / "traffic" / f"{t}.json").write_text(json.dumps(traffic))
        bench["workloads"].append({"name": cell, "config": conf["name"], "traffic": t,
                                   "chips": 1, "why": "micro"})
        (d / "limits" / f"{cell}.json").write_text(json.dumps({"limits": MICRO_LIMITS}))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if any(w.endswith("." + t) for w in m.get("workloads", [])):
                m["workloads"].append(cell)
    return Registry(bench, d)
