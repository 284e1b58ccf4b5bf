"""What the model axis costs on one card, and where: the full-width
StyleGAN2-FFHQ render (1024^2, B=2, bf16, 18 latents) unsharded and
column-parallel on (1, 2), (1, 4) and (2, 2) meshes of the one card repeated
([cuda:0] * n: every position's work runs on it, so this reads the host and
device cost of the math, not multi-card speed), for each checkout given:

    python -m hairfastgan_torch.scripts.model_axis_time --roots OLD . . OLD \
        [--n 10] [--out model_axis_time.json]

Each root runs in a process of its own, one after another in the order
given, importing hairfastgan_torch from that checkout, so two versions of
parallel/tensor.py compare on one card within one call (list them as
A B B A). It uses only what the column-parallel generator has offered since
it came in: mesh.make_mesh, mesh.shard_params_model_axis, tensor.generate,
stylegan2.generate, scripts.fastpath_agreement.scaled_generator and
zoo.cast_zoo. Per root:

  p50_ms, ratio   the p50 of --n renders of each mesh (CUDA events, the
                  meshes in turns, the order reversed every other round)
                  and its ratio to the unsharded render's p50
  rules,          where the checkout runs model-axis regions (a
  collectives     tensor._Region): the ops dispatched on a slice (every
                  position's) and the collectives (all_gathers and draws)
                  of one render
  rule_us,        the same checkout's host cost per slice rule (a region of
  collective_us   2000 elementwise ops on a slice, less the same ops on a
                  plain tensor, per op and position) and per collective (a
                  region of 200 ops whose result is all-gathered, less
                  the ops alone, per collective), on each mesh

Prints one JSON line per root and a summary line; --out keeps them all.
The card's name and power limit go with every line. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

MESHES = ((1, 2), (1, 4), (2, 2))


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def _host_costs(torch, mesh, tensor, plan) -> dict:
    """Per-op rule and per-collective host cost of `tensor` on `plan`."""
    dev = plan.lead
    tp = mesh.shard_params_model_axis(plan, {"w": torch.zeros(512, 512, device=dev)})
    x = torch.zeros(2 * plan.grid.shape[0], 512, device=dev)
    n_pos = plan.grid.size

    def ops(k, mode):
        def fn(p, x):
            y = torch.nn.functional.linear(x, p["w"])  # a slice of the columns
            for _ in range(k):
                if mode == "plain":
                    x = x + 1.0
                else:
                    z = y + 1.0  # a new slice
                    if mode == "gather":
                        torch.flatten(z)  # no slice rule: one all_gather
            return x

        return fn

    def wall(fn, reps=3):
        best = None
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.inference_mode():
                tensor.spmd(tp, fn, x)
            torch.cuda.synchronize()
            best = min(best or 1e9, time.perf_counter() - t)
        return best

    k_rule, k_coll = 2000, 200
    plain, rule = wall(ops(k_rule, "plain")), wall(ops(k_rule, "rule"))
    alone, coll = wall(ops(k_coll, "rule")), wall(ops(k_coll, "gather"))
    return {"rule_us": (rule - plain) / (k_rule * n_pos) * 1e6,
            "collective_us": (coll - alone) / k_coll * 1e6}


def child(root: str, n: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from hairfastgan_torch.config import StyleGANConfig
    from hairfastgan_torch.models import stylegan2 as G
    from hairfastgan_torch.parallel import mesh, tensor
    from hairfastgan_torch.scripts import fastpath_agreement
    from hairfastgan_torch.zoo import cast_zoo

    if not torch.cuda.is_available():
        raise SystemExit("model_axis_time needs a CUDA card")
    dev = torch.device("cuda:0")
    sg = StyleGANConfig()
    gen16 = cast_zoo(fastpath_agreement.scaled_generator(sg, 0, dev), torch.bfloat16)
    lat = torch.from_numpy(np.random.default_rng(18).standard_normal(
        (2, sg.n_latent, 512), dtype=np.float32)).to(dev)
    renders = {"unsharded": lambda: G.generate(gen16, lat, cfg=sg, dtype=torch.bfloat16)}
    plans = {}
    for shape in MESHES:
        name = "x".join(map(str, shape))
        plans[name] = mesh.make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
        renders[name] = (lambda tp: lambda: tensor.generate(tp, lat, cfg=sg,
                                                            dtype=torch.bfloat16))(
            mesh.shard_params_model_axis(plans[name], gen16))

    def event_ms(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    times = {k: [] for k in renders}
    with torch.inference_mode():
        for fn in renders.values():
            event_ms(fn)
            event_ms(fn)
        for r in range(n):
            for k in (list(renders) if r % 2 == 0 else list(renders)[::-1]):
                times[k].append(event_ms(renders[k]))
    p50 = {k: statistics.median(v) for k, v in times.items()}
    out = {"root": root, "card": card(), "torch": torch.__version__, "n": n,
           "p50_ms": p50, "min_ms": {k: min(v) for k, v in times.items()},
           "max_ms": {k: max(v) for k, v in times.items()},
           "ratio": {k: p50[k] / p50["unsharded"] for k in p50}}
    region = getattr(tensor, "_Region", None)
    if region is not None and hasattr(region, "torch_function"):
        counts = {}
        for name in plans:
            seen = {"rules": 0, "collectives": 0}
            wrapped = region.torch_function, region.collective

            def rule(self, *a, _f=wrapped[0], **k):
                seen["rules"] += 1
                return _f(self, *a, **k)

            def coll(self, *a, _f=wrapped[1], **k):
                seen["collectives"] += 1
                return _f(self, *a, **k)

            region.torch_function, region.collective = rule, coll
            try:
                with torch.inference_mode():
                    renders[name]()
            finally:
                region.torch_function, region.collective = wrapped
            counts[name] = dict(seen, **_host_costs(torch, mesh, tensor, plans[name]))
        out["per_mesh"] = counts
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print("RESULT " + json.dumps(child(args.child, args.n)), flush=True)
        return 0
    results = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                               "--n", str(args.n)], capture_output=True, text=True,
                              timeout=600)
        lines = [ln[7:] for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"model_axis_time: root {root} exited {proc.returncode}")
        results.append(json.loads(lines[-1]))
        print(lines[-1], flush=True)
    summary = {"card": card(), "ratio_by_root": {}}
    for r in results:
        summary["ratio_by_root"].setdefault(r["root"], []).append(r["ratio"])
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": results, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
