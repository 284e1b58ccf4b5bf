"""Finds the benchmark's parts by name, so that a new cell, configuration,
traffic mix, span or metric is a new file and an entry in BENCHMARK.json,
never an edit:

  BENCHMARK.json                the cells (`workloads`) and the metrics
  portbench/configs/<c>.json    a configuration (the program's settings, the
                                weights' laws, the FLOPs per transfer)
  portbench/traffic/<t>.json    a traffic mix: data, whose `kind` names its loop
  portbench/loops/<kind>.py     the loop that drives the program with a mix of
                                that kind (portbench/load.py says what it holds)
  portbench/zoos/<z>.py         a configuration's `"weights"` `"zoo"`: `shapes()`
                                gives the weights' shape tree and its
                                HairFastConfig (portbench/reference/zoo.py)
  portbench/laws/<l>.py         a law the configuration's `"weights"` `"laws"`
                                name: `law(path, shape)` (portbench/weights.py)
  portbench/programs/<p>.py     what a configuration's `"program"` names (default
                                "hairfast"): `build(conf, seed, device)` returns
                                the object that the traffic's loop drives, and
                                `flops(conf)` counts the configuration's
                                "flops_per_transfer" (portbench/flops.py)
  portbench/checks/<kind>.py    the kind of comparison a configuration's
                                `"check"` names (default "images"): its compared
                                `NUMBERS` and `compare(conf, seed, device,
                                samples, control)` (portbench/check.py)
  portbench/limits/<cell>.json  the limits of the numbers that decide `correct`
  portbench/spans/<s>.json      a span the traced run wraps around a call
  portbench/metrics/<f>.py      the reader of every metric whose name starts
                                with <f> (the part before the first dot); its
                                `spans(suffix)`, where it has one, names the
                                spans it reads, and a traced run installs only
                                the spans that its cell's metrics name
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DEFAULT_PROGRAM = "hairfast"
DEFAULT_CHECK = "images"
_PARTS = {}


def load_part(kind: str, name: str, where: Path = HERE):
    """<where>/<kind>/<name>.py, loaded from its file once per process. A
    part that finds other parts passes its own bench folder as `where`
    (part_root), so that a copied folder uses its own parts throughout."""
    path = Path(where).resolve() / kind / f"{name}.py"
    if path not in _PARTS:
        if not path.is_file():
            raise KeyError(f"no {kind} file {path}")
        spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _PARTS[path] = mod
    return _PARTS[path]


def part_root(part_file: str) -> Path:
    """The bench folder that holds the part file `part_file` (its __file__)."""
    return Path(part_file).resolve().parents[1]


class Registry:
    """The parts under `bench_dir` (portbench/), with the cells and metrics
    of `benchmark` (BENCHMARK.json's object)."""

    def __init__(self, benchmark: Dict, bench_dir: Path = HERE):
        self.benchmark = benchmark
        self.dir = Path(bench_dir)

    @classmethod
    def load(cls, root: Path = ROOT, bench_dir: Path = HERE) -> "Registry":
        return cls(json.loads((Path(root) / "BENCHMARK.json").read_text()), bench_dir)

    def _json(self, kind: str, name: str) -> Dict:
        path = self.dir / kind / f"{name}.json"
        if not path.is_file():
            raise KeyError(f"no {kind} file {path}")
        return json.loads(path.read_text())

    def cell(self, name: str) -> Dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> Dict[str, float]:
        path = self.dir / "limits" / f"{cell}.json"
        return json.loads(path.read_text())["limits"] if path.is_file() else {}

    def program(self, conf: Dict):
        """The module of the configuration's program (programs/<name>.py)."""
        return load_part("programs", conf.get("program", DEFAULT_PROGRAM), self.dir)

    def check(self, conf: Dict):
        """The module of the configuration's kind of comparison (checks/<kind>.py)."""
        return load_part("checks", conf.get("check", DEFAULT_CHECK), self.dir)

    def loop(self, traffic: Dict, hf, seed: int, device):
        """The loop of the traffic mix's kind (loops/<kind>.py), on `hf`."""
        return load_part("loops", traffic["kind"], self.dir).Loop(traffic, hf, seed, device)

    def spans(self, metrics: List[str]) -> List[Dict]:
        """The span files that the readers of `metrics` name."""
        names = []
        for m in metrics:
            fn = getattr(self.reader(m), "spans", None)
            for n in (fn(m.split(".", 1)[1] if "." in m else "") if fn else []):
                if n not in names:
                    names.append(n)
        return [dict(self._json("spans", n), name=n) for n in names]

    def metrics(self, section: str, cell: str) -> List[Dict]:
        """The `section` ("end_to_end" or "per_layer") metrics that `cell`
        reports: those that list it, and those without a list whose moved
        metric (per-layer) or own name (end-to-end) the cell reports."""
        e2e = [m["name"] for m in self.benchmark["end_to_end"]
               if cell in m.get("workloads", [cell])]
        out = []
        for m in self.benchmark[section]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif section == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out

    def reader(self, metric: str):
        """The module that reads `metric`: metrics/<name before the dot>.py."""
        return load_part("metrics", metric.split(".")[0], self.dir)

    def read(self, metric: str, run) -> Optional[float]:
        """The metric's value in `run` (a harness.RunRecord), or None where
        its reader finds nothing to read."""
        suffix = metric.split(".", 1)[1] if "." in metric else ""
        return self.reader(metric).read(suffix, run)
