"""Zoos, laws, programs and kinds of comparison found by name: the moved
parts draw, build and judge what they did before they moved, and a
configuration that brings its own of each is new files and BENCHMARK.json
entries only."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from portbench import load, weights
from portbench.registry import HERE, ROOT, Registry, load_part
from portbench.tests.micro import MICRO_CONFIG

FULL = {"zoo": "full", "dtype": "bfloat16",
        "laws": {"generator": "stylegan2", "bisenet": "bisenet",
                 "shape_adaptor": "shape_adaptor", "*": "lecun"}}
# sha256 digests, computed at commit 477030a (before the zoos and laws moved
# to files), of the plans (json of [path, shape, law, kind, value, offset]
# per leaf; that commit's weights.py had no `plan`, so its rows were built
# there from its `_leaves` and `LAWS`, in leaf order, with the offsets that
# its make_zoo takes), the configs (repr) and a float32 CPU draw of the micro
# zoo at seed 2**31 + 7 (each leaf's "/"-joined path, then its bytes)
PLANS = {"full": ("fa5c2303ce93373c524e511f65b35ec62e52a58d45dce1d54d15dd6865286671", 3307),
         "micro": ("0f07a173888f7456fd74336f296de3238b61d945229bd7c3e25d30b9611f7d3b", 2444)}
FULL_CONFIG = "f3c75fc28546c818cf88909e4b72d81a834b6c58e221c2bfd6caf1ca10996a97"
MICRO_DRAW = ("73a612a91ebfc2c2e46cd3955e117bc502e1a8837667a8593d73ad064c7fee82",
              "8eac9c6c0ee7dfc13278785010382d840344897eb8beac93f92b4d1e7315d813")
# the parent's images check on two micro swaps (seed 2**31 + 13, one thread)
IMAGES_DETAIL = {"D_p": 0.4929707845052083, "D_r": 0.4929707845052083,
                 "D_x": 15.841959635416666}


@pytest.mark.parametrize("zoo", sorted(PLANS))
def test_plans_are_the_parents(zoo):
    spec = FULL if zoo == "full" else MICRO_CONFIG["weights"]
    rows = [[list(p), list(s), law, kind, value, at]
            for p, s, law, kind, value, at in weights.plan(spec)]
    assert (hashlib.sha256(json.dumps(rows).encode()).hexdigest(), len(rows)) == PLANS[zoo]


def test_micro_draw_and_configs_are_the_parents():
    zoo, cfg = weights.make_zoo(MICRO_CONFIG["weights"], 2 ** 31 + 7, "cpu", torch.float32)
    h = hashlib.sha256()
    for path, t in weights._leaves(zoo):
        h.update("/".join(path).encode())
        h.update(t.contiguous().numpy().tobytes())
    assert (h.hexdigest(), hashlib.sha256(repr(cfg).encode()).hexdigest()) == MICRO_DRAW
    assert hashlib.sha256(repr(weights.shape_config(FULL)).encode()).hexdigest() == FULL_CONFIG


def test_the_images_check_reads_as_the_parent():
    seed, threads = 2 ** 31 + 13, torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU's sums depend on the thread count
    try:
        reg = Registry.load()
        hf = reg.program(MICRO_CONFIG).build(MICRO_CONFIG, seed, "cpu")
        pool = load.make_pool(seed, 6, 128, 8, "cpu")
        samples = []
        for i, (a, b, c) in enumerate([(0, 1, 2), (3, 4, 5)]):
            out = np.asarray(hf.swap(pool[a], pool[b], pool[c], seed=i, output="uint8"))
            samples.append(load.Sample(images=(pool[a][None], pool[b][None], pool[c][None]),
                                       output=out.reshape((1,) + out.shape[-3:])))
        del hf
        kind = reg.check(MICRO_CONFIG)
        found, detail = kind.compare(MICRO_CONFIG, seed, "cpu", samples)
    finally:
        torch.set_num_threads(threads)
    assert {k: detail[k] for k in IMAGES_DETAIL} == IMAGES_DETAIL
    assert found == {"mad_excess": 0.0, "row_excess_max": 0.0}
    assert kind is load_part("checks", "images") and kind.NUMBERS == tuple(found)


def test_the_yardstick_names_no_part():
    """harness, check, weights and the reference's zoo finder name no zoo,
    program or kind of comparison; the harness does not import HairFast."""
    names = {p.stem for part in ("zoos", "programs", "checks", "laws")
             for p in (HERE / part).glob("*.py")}
    for rel in ("harness.py", "check.py", "weights.py", "reference/zoo.py"):
        text = (HERE / rel).read_text()
        assert not [n for n in names if f'"{n}"' in text or f"'{n}'" in text], rel
    assert "HairFast" not in (HERE / "harness.py").read_text()


# A trainer-shaped configuration, every part of it a new file: a zoo (a
# linear head), its law, a program that takes plain SGD steps on it, a
# loop of training steps and a kind of comparison that replays the
# sampled steps in float64 from the weights drawn again from the seed.
TOY = {
    "zoos/toy_head.py": '''
        import torch
        from portbench.reference.config import HairFastConfig

        def shapes():
            m = lambda *s: torch.empty(s, device="meta")  # noqa: E731
            return {"head": {"w": m(4, 16), "b": m(4)}}, HairFastConfig()
        ''',
    "laws/toy.py": '''
        def law(path, shape):
            return ("normal", 0.5) if path[-1] == "w" else ("const", 0.1)
        ''',
    "programs/toy_sgd.py": '''
        import torch
        from portbench import weights
        from portbench.registry import part_root

        class Trainer:
            def __init__(self, params, lr):
                self.p, self.lr = params, lr

            def update(self, grads):
                with torch.no_grad():
                    for k, g in grads.items():
                        self.p[k] -= self.lr * g

            def step(self, x, y):
                p = {k: v.detach().requires_grad_() for k, v in self.p.items()}
                loss = ((x @ p["w"].T + p["b"] - y) ** 2).mean()
                loss.backward()
                self.p = {k: v.detach() for k, v in p.items()}
                self.update({k: v.grad for k, v in p.items()})
                return float(loss)

        def build(conf, seed, device):
            zoo, _ = weights.make_zoo(conf["weights"], seed, device, torch.float32,
                                      part_root(__file__))
            return Trainer(zoo["head"], conf["lr"])

        def flops(conf, batch=1):  # one step's, per row
            from torch.utils.flop_counter import FlopCounterMode

            w, b = torch.zeros(4, 16, requires_grad=True), torch.zeros(4, requires_grad=True)
            with FlopCounterMode(display=False) as fc:
                ((torch.zeros(batch, 16) @ w.T + b - torch.zeros(batch, 4)) ** 2).mean().backward()
            return fc.get_total_flops() / batch, {
                str(k): v / batch for k, v in fc.get_flop_counts()["Global"].items()}
        ''',
    "loops/toy_steps.py": '''
        import time
        import numpy as np
        import torch
        from portbench.load import Sample, sub_seed

        class Loop:
            def __init__(self, traffic, program, seed, device):
                self.t, self.p, self.seed, self.device = traffic, program, seed, device
                self.records, self.losses = [], []

            def setup(self):
                g = torch.Generator().manual_seed(sub_seed(self.seed, 1))
                self.x = torch.randn(self.t["rows"], 16, generator=g)
                self.y = torch.randn(self.t["rows"], 4, generator=g)

            def _rows(self, i):
                b = self.t["batch"]
                at = (i * b) % len(self.x)
                return self.x[at:at + b], self.y[at:at + b]

            def window(self, seconds, tracer=None):
                self.start = time.perf_counter()
                i = 0
                while time.perf_counter() < self.start + seconds:
                    t0 = time.perf_counter()
                    self.losses.append(self.p.step(*self._rows(i)))
                    self.records.append({"t0": t0, "t1": time.perf_counter(),
                                         "transfers": self.t["batch"], "ok": True,
                                         "profiled": False})
                    i += 1
                self.end = time.perf_counter()

            def samples(self, rng, k):
                n = min(k, len(self.losses))  # the first steps, replayed in order
                rows = [self._rows(i) for i in range(n)]
                return [Sample(images=tuple(np.stack([r[j].numpy() for r in rows])
                                            for j in range(2)),
                               output=np.array(self.losses[:n]), options={"lr": self.p.lr})]

            def close(self):
                pass
        ''',
    "checks/toy_loss.py": '''
        import torch
        from portbench import weights
        from portbench.registry import part_root

        NUMBERS = ("loss_gap",)

        def compare(conf, seed, device, samples, control=None):
            zoo, _ = weights.make_zoo(conf["weights"], seed, "cpu", torch.float32,
                                      part_root(__file__))
            gaps = []
            for s in samples:
                p = {k: v.double() for k, v in zoo["head"].items()}
                for x, y, got in zip(torch.from_numpy(s.images[0]).double(),
                                     torch.from_numpy(s.images[1]).double(), s.output):
                    q = {k: v.clone().requires_grad_() for k, v in p.items()}
                    loss = ((x @ q["w"].T + q["b"] - y) ** 2).mean()
                    loss.backward()
                    p = {k: (v - s.options["lr"] * v.grad).detach() for k, v in q.items()}
                    gaps.append(abs(got - float(loss)) / float(loss))
            return {"loss_gap": max(gaps)}, {"steps": len(gaps)}
        ''',
    "metrics/toy_step_ms.py": '''
        import statistics

        def read(suffix, run):
            ms = [(r["t1"] - r["t0"]) * 1e3 for r in run.requests]
            return statistics.median(ms) if ms else None
        ''',
    "configs/toy.json": {"name": "toy", "reduced": [], "program": "toy_sgd",
                         "check": "toy_loss", "lr": 0.05, "flops_per_transfer": 256.0,
                         "weights": {"zoo": "toy_head", "dtype": "float32",
                                     "laws": {"*": "toy"}}},
    "traffic/toy_steps.json": {"kind": "toy_steps", "batch": 8, "rows": 256,
                               "check_requests": 4},
    "limits/toy.steps.json": {"limits": {"loss_gap": 1e-5}},
}

RUN = '''
import json, sys
from portbench import harness
from portbench.registry import Registry

reg = Registry.load()
if sys.argv[1] == "frozen":  # a step that returns its state unchanged
    reg.program(reg.config("toy")).Trainer.update = lambda self, grads: None
r = harness.run_cell(reg, "toy.steps", 2 ** 31 + 3, 0.5, False, device="cpu")
r.pop("_lines")
print(json.dumps(r))
'''


def test_a_trainer_shaped_configuration_is_new_files_only(tmp_path):
    """The toy's parts are new files in a copy of portbench/ and its cell,
    configuration, per-layer metric and end-to-end metric (train_rows_per_s,
    whose reader metrics/ has) are BENCHMARK.json entries; the
    copy's own schema, registry and FLOPs tests then hold them as they hold
    the benchmark's, and a run of the cell reads train_rows_per_s and is
    judged by the toy's own numbers."""
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    for rel, body in TOY.items():
        path = tmp_path / "portbench" / rel
        assert not path.exists(), rel  # a new file, not an edit
        path.write_text(json.dumps(body) if isinstance(body, dict) else textwrap.dedent(body))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "https://pytorch.org/docs/stable/optim.html",
                             "file": "portbench/configs/toy.json", "reduced": [],
                             "why": "a linear head trained by SGD"})
    bench["workloads"].append({"name": "toy.steps", "config": "toy", "traffic": "toy_steps",
                               "chips": 1, "why": "SGD steps of a linear head"})
    bench["per_layer"].append({"name": "toy_step_ms", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "toy trainer",
                               "moves": "train_rows_per_s", "workloads": ["toy.steps"]})
    bench["end_to_end"].append({"name": "train_rows_per_s", "unit": "rows/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock", "workloads": ["toy.steps"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=str(ROOT))  # the port, for the copy's micro cells

    def run(mode):
        res = subprocess.run([sys.executable, "-c", RUN, mode], cwd=tmp_path,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        return json.loads(res.stdout.strip().splitlines()[-1])

    r = run("sound")
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s", "train_rows_per_s"}
    assert r["metrics"]["train_rows_per_s"]["unit"] == "rows/s"
    assert r["metrics"]["train_rows_per_s"]["value"] == pytest.approx(
        8 * r["attempted"] / 0.5, rel=0.5)
    assert list(r["checks"]) == ["loss_gap"] and r["checks"]["loss_gap"]["limit"] == 1e-5
    assert r["check_detail"]["steps"] == min(4, r["attempted"])
    bad = run("frozen")
    assert not bad["correct"] and bad["checks"]["loss_gap"]["value"] > 1e-5

    res = subprocess.run([sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
                          "portbench/tests/test_portbench_registry.py",
                          "portbench/tests/test_portbench_peaks.py"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-4000:]
    assert "PASSED portbench/tests/test_portbench_registry.py::test_every_cell_resolves[toy.steps]" \
        in res.stdout
    assert "test_flops_per_transfer_recount[portbench/configs/toy.json]" in res.stdout
