"""One run of one cell: set up, measure for --seconds, check, print one line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as setup_s from the process's start): the configuration's
weights drawn on the device from the seed, `HairFast` built on them, the
traffic's images made and its shapes warmed (by the traffic's loop,
portbench/loops/<kind>.py). Then the window. With --trace 0 the line carries
the cell's end-to-end metrics; with --trace 1 the spans that the cell's
per-layer metrics read (portbench/spans/) are set on the program for the
run, a short sub-window of whole transfers is profiled, and the line carries
the cell's per-layer metrics. After the window: the device's peak memory, the program
freed, and the comparison with the plain reference on a sample of the
window's outputs drawn from the seed (portbench/check.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from portbench import check
from portbench.registry import Registry

FORBIDDEN = ("jax", "jaxlib", "flax", "hairfastgan_tpu")


def forbidden_modules() -> List[str]:
    """The modules loaded in this process whose top-level name (before the
    first dot) is exactly one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class RunRecord:
    """What a run measured, for the metric readers (portbench/metrics/)."""
    cell: Dict
    config: Dict
    traffic: Dict
    setup_s: float = 0.0
    window_s: float = 0.0
    requests: List[Dict] = field(default_factory=list)
    tracer: object = None
    device_name: str = ""
    power_limit: str = ""

    def latencies_ms(self) -> List[float]:
        """Per request, ms; a failed request is +inf (it met no limit)."""
        return [(r["t1"] - r["t0"]) * 1e3 if r["ok"] else float("inf") for r in self.requests]

    def transfers(self) -> int:
        return sum(r["transfers"] for r in self.requests)


def program_config(conf: Dict):
    """The program's HairFastConfig of a configuration file."""
    from hairfastgan_torch import config as P

    rcfg = check.reference_config(conf)
    fields = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}
    fields["stylegan"] = P.StyleGANConfig(**dataclasses.asdict(rcfg.stylegan))
    for k in ("sean", "shape_adaptor", "clip"):
        fields[k] = getattr(P, type(getattr(rcfg, k)).__name__)(
            **dataclasses.asdict(getattr(rcfg, k)))
    return P.HairFastConfig(**fields)


def build_program(conf: Dict, seed: int, device):
    """HairFast on the configuration's weights, as the configuration serves."""
    import torch

    from hairfastgan_torch import zoo as Z
    from hairfastgan_torch.api import HairFast

    from portbench import weights

    zoo, _ = weights.make_zoo(conf["weights"], seed, device,
                              getattr(torch, conf["weights"]["dtype"]))
    for name in conf.get("zoo_transforms", []):  # e.g. "pack_zoo"
        zoo = getattr(Z, name)(zoo)
    return HairFast(program_config(conf), zoo=zoo, device=device)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def run_cell(reg: Registry, cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None, control=None) -> Dict:
    """The result object of one run (without printing it). `control` (a
    precision mode) also reads the control's numbers."""
    import torch

    from portbench import load
    from portbench.trace import Tracer, breakdown

    t_start = time.perf_counter() if t_start is None else t_start
    cell = reg.cell(cell_name)
    conf, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    dev = torch.device(device)
    rec = RunRecord(cell=cell, config=conf, traffic=traffic)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        rec.device_name = torch.cuda.get_device_name(dev)
        rec.power_limit = power_limit()

    hf = build_program(conf, seed, dev)
    loop = reg.loop(traffic, hf, seed, dev)
    tracer = None
    try:
        loop.setup()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec.setup_s = time.perf_counter() - t_start
        if trace:
            tracer = Tracer(reg.spans([m["name"] for m in reg.metrics("per_layer", cell_name)]),
                            dev)
            tracer.install()
        own0 = time.process_time()
        try:
            loop.window(seconds, tracer)
        finally:
            if tracer is not None:
                tracer.remove()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if tracer is not None:
            tracer.resolve()
        own1 = time.process_time()
        rec.window_s = loop.end - loop.start
        rec.requests = loop.records
        rec.tracer = tracer
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        rng = np.random.default_rng(load.sub_seed(seed, 4))
        samples = loop.samples(rng, traffic["check_requests"])
    finally:
        loop.close()
    del hf, loop
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    found, detail = check.compare(conf, seed, dev, samples, control)
    correct, lines = check.verdict(found, reg.limits(cell_name))

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in reg.metrics(section, cell_name):
        v = reg.read(m["name"], rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = len(rec.requests)
    failed = sum(1 for r in rec.requests if not r["ok"])
    result = {"correct": bool(correct and failed == 0 and attempted > 0),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": rec.device_name, "count": cell["chips"],
                         "memory_peak_bytes": int(peak)}}
    if trace:
        p = tracer.profile
        if p is None or not p.device_ops:
            raise RuntimeError("the profiled sub-window saw no device operations")
        result["device"]["busy_s"] = p.busy_ns() / 1e9
        result["device"]["window_s"] = (p.window[1] - p.window[0]) / 1e9
        result["breakdown"] = breakdown(p)
    result["power_limit"] = rec.power_limit
    result["transfers"] = rec.transfers()
    # this process's CPU seconds per second of the window (about 1 where
    # one thread launching kernels is the bottleneck)
    result["host"] = {"own_cpu_per_s": (own1 - own0) / max(rec.window_s, 1e-9)}
    result["check_detail"] = detail
    result["checks"] = {k: {"value": found.get(k), "limit": reg.limits(cell_name).get(k)}
                        for k in check.NUMBERS}
    result["_lines"] = lines
    return result


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None, t_start: Optional[float] = None) -> int:
    args = parser().parse_args(argv)
    reg = Registry.load()
    cell = reg.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: cell {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(reg, args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the port may not use: {bad}", file=sys.stderr)
        return 3
    lines = result.pop("_lines")
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0
