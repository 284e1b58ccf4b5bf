"""The port's spans (utils/timing): the recorder, the span tree of a swap,
the profiler's clock, and the benchmark readers that split the device's idle
and busy time by them (portbench/metrics/idle_ms.py, busy_ms.py)."""

import dataclasses
import json
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hairfastgan_torch import zoo as Z
from hairfastgan_torch.api import HairFast
from hairfastgan_torch.ops import morphology
from hairfastgan_torch.params.bridge import map_tree
from hairfastgan_torch.pipeline import alignment
from hairfastgan_torch.utils import timing
from portbench.registry import Registry
from portbench.trace import Profile, Tracer

ROOT = Path(__file__).resolve().parent.parent
STAGES = ("embed", "align", "shape", "blend")
MODELS = ("generator", "e4e", "fse", "bisenet", "sean", "shape_adaptor", "rotate", "blending",
          "post_process")


@pytest.fixture(autouse=True)
def fresh():
    timing.clear()
    yield
    timing.clear()


def by_id(spans):
    return {s.id: s for s in spans}


def ancestors(s, ids):
    out = []
    while s.parent is not None:
        s = ids[s.parent]
        out.append(s.name)
    return out


def test_nesting_parents_and_request_ids():
    @timing.span("model", of_call=lambda a: {"k": a["k"]})
    def model(x, k=3):
        """doc"""
        return x + k

    assert model.__name__ == "model" and model.__doc__ == "doc" and model.__wrapped__
    got = []

    def worker(outer):
        with timing.span("alone") as alone:
            pass
        with timing.span("joined", parent=outer) as joined:
            got.extend([alone, joined, timing.in_request()])

    with timing.recording():
        with timing.request(entry="swap"):
            with timing.span("outer", tag=1) as outer:
                assert model(1) == 4
                with timing.request() as none:  # inside a request: no second one
                    timing.annotate(case="distinct")
                t = threading.Thread(target=worker, args=(outer,))
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
        with timing.span("request") as second:
            pass
    spans = timing.spans()
    assert [s.name for s in spans] == ["model", "alone", "joined", "outer", "request", "request"]
    model_s, alone, joined, _, req, _ = spans
    assert none is None and got[2] is True
    assert req.parent is None and req.request == req.id
    assert req.attrs == {"entry": "swap", "case": "distinct"}
    assert outer.parent == req.id and outer.request == req.id and outer.attrs == {"tag": 1}
    assert model_s.parent == outer.id and model_s.request == req.id and model_s.attrs == {"k": 3}
    assert ancestors(model_s, by_id(spans)) == ["outer", "request"]
    assert alone.parent is None and alone.request is None and alone.thread == joined.thread
    assert joined.parent == outer.id and joined.request == req.id and joined.thread != req.thread
    assert second.request == second.id != req.id and second.parent is None
    assert req.t0 <= outer.t0 <= model_s.t0 <= model_s.t1 <= outer.t1 <= req.t1
    assert timing.dropped() == 0


def test_nothing_is_kept_unless_recording_or_profiling():
    @timing.span("model")
    def model(x):
        return x * 2

    with timing.request(entry="swap") as none:
        with timing.span("outer") as outer:
            assert model(torch.ones(3)).sum() == 6
    assert none is None or none.id is None
    assert outer.id is None and outer.t1 >= outer.t0 > 0 and outer.ms >= 0
    assert timing.spans() == [] and not timing.in_request()


def test_profiler_keeps_spans_on_its_own_clock():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("warm"):
            pass
        with timing.span("probe") as probe:
            torch.ones(16).add_(1)
    with timing.span("after"):
        pass
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()}
    assert [s.name for s in timing.spans()] == ["warm", "probe"]
    assert abs(starts["hf.probe"] - probe.t0) < 200_000  # ns


@pytest.fixture(scope="module")
def micro():
    """The micro zoo's shapes, filled with constants (zoo.fill_random's
    draw of 210 M normals takes seconds; the spans do not depend on the
    weights)."""
    shapes, cfg = Z.micro_zoo_shapes()
    zoo = map_tree(Z.fill_random(shapes, None), lambda k, t: torch.full(
        t.shape, 1.0 if k == "var" else 0.0 if k == "mean" else 0.05))
    rng = np.random.default_rng(0)
    return zoo, dataclasses.replace(cfg, compute_dtype="float32"), [
        rng.integers(0, 256, (128, 128, 3), dtype=np.uint8) for _ in range(3)]


@pytest.mark.parametrize("paired", [False, True], ids=["distinct", "paired"])
def test_a_swap_gives_the_span_tree(micro, paired):
    zoo, cfg, imgs = micro
    hf = HairFast(dataclasses.replace(cfg, pair_shape_modules=paired), zoo=zoo, device="cpu")
    with timing.recording():
        out = hf.swap(*imgs, output="uint8")
    assert out.shape == (128, 128, 3)
    spans = sorted(timing.spans(), key=lambda s: (s.t0, s.id))
    ids = by_id(spans)
    (req,) = [s for s in spans if s.name == "request"]
    assert req.attrs == {"entry": "swap", "case": "distinct", "rows": 1}
    assert all(s.request == req.id and s.thread == req.thread for s in spans)
    top = [s.name for s in spans if s.parent == req.id]
    assert top == ["upload"] * 4 + ["serve", "fetch"]
    (serve,) = [s for s in spans if s.name == "serve"]
    stages = [s.name for s in spans if s.parent == serve.id]
    assert stages == (["embed", "shape", "align", "blend"] if paired
                      else ["embed", "align", "shape", "blend"])
    nested = [s for s in spans if s.name == "shape" and ids[s.parent].name == "align"]
    assert len(nested) == (0 if paired else 1)
    models = [s for s in spans if s.name in MODELS]
    assert {s.name for s in models} == set(MODELS)
    assert all(ids[s.parent].name in STAGES for s in models)  # never inside another model
    gens = [(s.attrs["start_layer"], s.attrs["end_layer"]) for s in models
            if s.name == "generator"]
    assert (4, 8) in gens and (5, 8) in gens and len(gens) == (6 if paired else 7)
    de = [s for s in spans if s.name == "dilate_erode"]
    assert [ids[s.parent].name for s in de] == ["align", "blend"]
    assert all(s.attrs == {"shape": (3, 256, 256, 1), "itemsize": 4, "iterations": cfg.smooth}
               for s in de)


def test_dilate_erode_attrs_match_the_outside_span():
    spec = json.loads((ROOT / "portbench/spans/dilate_erode.json").read_text())
    tracer = Tracer([dict(spec, name="dilate_erode")], torch.device("cpu"))
    tracer.install()
    try:
        mask = (torch.rand(3, 32, 32, 1, generator=torch.Generator().manual_seed(0)) > 0.5)
        with timing.recording():
            alignment.dilate_erode(mask.to(torch.bfloat16), 4)
            alignment.dilate_erode(mask.float())
    finally:
        tracer.remove()
    assert alignment.dilate_erode is morphology.dilate_erode
    kept = timing.spans()
    assert len(kept) == len(tracer.calls) == 2
    for s, c in zip(kept, tracer.calls):
        (shape, itemsize), *rest = c.args
        assert s.attrs == {"shape": shape, "itemsize": itemsize,
                           "iterations": rest[0] if rest else 5}


def test_every_outside_span_target_still_resolves():
    specs = [dict(json.loads(p.read_text()), name=p.stem)
             for p in sorted((ROOT / "portbench/spans").glob("*.json"))]
    tracer = Tracer(specs, torch.device("cpu"))
    tracer.install()
    try:
        assert tracer.missing == [] and len(tracer.installed) == sum(
            len(s["targets"]) for s in specs)
        assert all(getattr(obj, last).__name__ == fn.__name__ == last
                   for obj, last, fn in tracer.installed)
    finally:
        tracer.remove()


def _span(name, t0, t1, sid, parent=None):
    s = timing.Span(name, {})
    s.t0, s.t1, s.id, s.parent, s.request = t0, t1, sid, parent, 1
    return s


def test_readers_split_idle_and_busy_time(monkeypatch):
    spans = [_span("request", 0, 1000, 1), _span("upload", 10, 100, 2, 1),
             _span("serve", 100, 800, 3, 1), _span("embed", 150, 300, 4, 3),
             _span("generator", 160, 200, 5, 4), _span("align", 300, 600, 6, 3),
             _span("shape", 350, 450, 7, 6), _span("rotate", 360, 370, 8, 7),
             _span("blend", 600, 780, 9, 3), _span("fetch", 800, 950, 10, 1),
             _span("request", 2000, 3000, 11)]  # after the window: not read
    monkeypatch.setattr(timing, "spans", lambda: spans)
    ops = [("gpu_memcpy", "H2D", 50, 120, 1), ("kernel", "g", 170, 260, 2),
           ("kernel", "glue", 300, 330, 3), ("kernel", "r", 400, 500, 4),
           ("kernel", "a", 520, 560, 5), ("kernel", "b", 700, 900, 6),
           ("gpu_memcpy", "D2H", 905, 920, 7), ("kernel", "nolaunch", 930, 940, 8)]
    launches = {1: 40, 2: 165, 3: 140, 4: 365, 5: 500, 6: 650, 7: 810}
    p = Profile(window=(0, 1000), transfers=2, device_ops=ops, ranges=[], launches=launches)
    run = SimpleNamespace(tracer=SimpleNamespace(profile=p))
    reg = Registry.load()

    def read(name):
        return reg.read(name, run) * 1e6 * p.transfers  # ns of the window

    idle = {k: read(f"idle_ms.{k}.b1") for k in ("upload", "serve", "fetch", "other")}
    # idle gaps: [0,50] other 10 + upload 40; serve [120,170] [260,300] [330,400]
    # [500,520] [560,700]; fetch [900,905] [920,930] [940,950]; other [950,1000]
    assert idle == pytest.approx({"upload": 40, "serve": 320, "fetch": 25, "other": 60})
    assert sum(idle.values()) == pytest.approx(1000 - p.busy_ns())
    # launched at 165 in embed, 365 in shape inside align, 500 in align, 650 in blend
    assert {k: read(f"busy_ms.{k}.b1") for k in STAGES} == pytest.approx(
        {"embed": 90, "align": 40, "shape": 100, "blend": 200})
    models = {k: read(f"busy_ms.{k}.batch8") for k in MODELS + ("glue",)}
    assert models == pytest.approx(dict(dict.fromkeys(MODELS, 0), generator=90, rotate=100,
                                        glue=30 + 40 + 200))  # glue: serve, in no model
    monkeypatch.setattr(timing, "spans", lambda: spans[-1:])
    assert reg.read("idle_ms.other.b1", run) is None and reg.read("busy_ms.embed.b1", run) is None
