"""The readings that the limits of `correct` are set from, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 11,12,... \
        [--seconds 8] [--control fp8] [--faults kernel_skipped,...] [--out calibrate.jsonl]

For each seed, one run of the cell as the benchmark makes it (set-up, a
window of --seconds, the comparison with the plain reference on the
window's sampled outputs) prints the program's numbers; with --control fp8
the reference computed in fp8 (portbench/precision.Fp8) is also held
against the float32 reference on the same requests, and its numbers are
printed beside them. With --faults, each seed runs once more with each
named fault of portbench/faults.py planted in the program. One JSON line per
run, to stdout and to --out.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

from portbench import faults, harness, precision
from portbench.registry import Registry

CONTROLS = {"fp8": precision.Fp8}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", choices=sorted(CONTROLS))
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--faults", default="", help="comma-separated names of portbench/faults.py")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    reg = Registry.load()
    out = Path(args.out) if args.out else None
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
    runs = [(int(s), f) for s in args.seeds.split(",")
            for f in [None] + [f for f in args.faults.split(",") if f]]
    for seed, fault in runs:
        t0 = time.perf_counter()
        with faults.planted(fault) if fault else contextlib.nullcontext():
            r = harness.run_cell(reg, args.workload, seed, args.seconds, bool(args.trace),
                                 t_start=t0,
                                 control=CONTROLS[args.control]() if args.control else None)
        r.pop("_lines")
        r.update(seed=seed, workload=args.workload, fault=fault,
                 wall_s=time.perf_counter() - t0)
        line = json.dumps(r)
        print(line, flush=True)
        if out is not None:
            with out.open("a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
