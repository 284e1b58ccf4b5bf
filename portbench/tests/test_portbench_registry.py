"""The harness finds every part by name, and a part added as a new file is
found without an edit; BENCHMARK.json keeps to its schema."""

import json
import re
import shutil

import pytest

from portbench import faults
from portbench.registry import HERE, ROOT, Registry
from portbench.tests.micro import micro_registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in BENCH["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in BENCH["workloads"])
    assert all(0 < len(x["why"]) <= 200 for x in BENCH["configs"] + BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if "workloads" in m:  # a list, if given, names one cell or more
            assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    reg = Registry.load()
    w = reg.cell(cell)
    conf, traffic = reg.config(w["config"]), reg.traffic(w["traffic"])
    assert conf["name"] == w["config"] and (reg.dir / "loops" / f"{traffic['kind']}.py").is_file()
    e2e = [m["name"] for m in reg.metrics("end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = reg.metrics("per_layer", cell)
    assert per_layer and all(m["moves"] in e2e for m in per_layer)
    assert set(reg.limits(cell)) == set(reg.check(conf).NUMBERS)


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end", "per_layer")
                                    for m in BENCH[k]])
def test_every_metric_has_a_reader(metric):
    assert callable(Registry.load().reader(metric).read)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_run_installs_the_spans_its_metrics_read(cell):
    reg = Registry.load()
    names = [m["name"] for m in reg.metrics("per_layer", cell)]
    spans = reg.spans(names)
    want = {"host_enqueue_ms.b1": "host_enqueue", "dilate_erode_roofline": "dilate_erode"}
    assert sorted(s["name"] for s in spans) == sorted({want[n] for n in names if n in want})
    assert all(s["targets"] and all(":" in t for t in s["targets"]) for s in spans)


def test_every_span_file_is_read_by_a_metric():
    reg = Registry.load()
    read = {s["name"] for s in reg.spans([m["name"] for m in BENCH["per_layer"]])}
    assert read == {p.stem for p in (HERE / "spans").glob("*.json")}


def test_configs_files_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"] == []


def test_new_parts_in_new_files_are_found(tmp_path):
    reg = micro_registry(tmp_path, traffics=("swap_b1",))
    d = reg.dir
    (d / "traffic" / "swap_b2.json").write_text(json.dumps(
        dict(json.loads((d / "traffic" / "swap_b1.json").read_text()), batch=2)))
    (d / "metrics" / "double_setup_s.py").write_text(
        "def read(suffix, run):\n    return 2 * run.setup_s\n")
    (d / "metrics" / "mapping_calls.py").write_text(
        "def spans(suffix):\n    return ['mapping']\n\n\n"
        "def read(suffix, run):\n    return None\n")
    (d / "spans" / "mapping.json").write_text(json.dumps(
        {"targets": ["hairfastgan_torch.models.stylegan2:mapping"]}))
    reg.benchmark["workloads"].append({"name": "micro.swap_b2", "config": "micro",
                                       "traffic": "swap_b2", "chips": 1, "why": "new"})
    reg.benchmark["per_layer"].append({"name": "double_setup_s.new", "unit": "s",
                                       "better": "lower", "source": "host_clock",
                                       "layer": "API", "moves": "setup_s"})
    assert reg.traffic(reg.cell("micro.swap_b2")["traffic"])["batch"] == 2
    assert "double_setup_s.new" in [m["name"] for m in reg.metrics("per_layer", "micro.swap_b2")]
    assert reg.read("double_setup_s.new", type("R", (), {"setup_s": 1.5})()) == 3.0
    assert [s["name"] for s in reg.spans(["mapping_calls.b1"])] == ["mapping"]
    assert reg.config("micro")["weights"]["zoo"] == "micro"


def test_harness_code_names_no_part():
    """No cell, configuration or traffic name is written into the code."""
    names = {w["name"] for w in BENCH["workloads"]} | {c["name"] for c in BENCH["configs"]} | {
        w["traffic"] for w in BENCH["workloads"]}
    for path in HERE.glob("*.py"):
        text = path.read_text()
        assert not [n for n in names if f'"{n}"' in text], path


def test_a_new_kind_of_traffic_in_new_files_runs(tmp_path):
    """A new loop (loops/<kind>.py, here tests/half_res_repeat.py), its mix
    (traffic/<t>.json), its limits and a cell: new files and a BENCHMARK.json
    entry, no edit. It runs on the micro zoo, and the check answers it with
    the loop's own reference call (its case and served size)."""
    from portbench import harness
    from portbench.tests.micro import MICRO_LIMITS

    reg = micro_registry(tmp_path, traffics=())
    d = reg.dir
    shutil.copy(HERE / "tests" / "half_res_repeat.py", d / "loops" / "half_res_repeat.py")
    (d / "traffic" / "repeat_face.json").write_text(json.dumps(
        {"kind": "half_res_repeat", "pool": 4, "check_requests": 2}))
    (d / "limits" / "micro.repeat_face.json").write_text(json.dumps({"limits": MICRO_LIMITS}))
    reg.benchmark["workloads"].append({"name": "micro.repeat_face", "config": "micro",
                                       "traffic": "repeat_face", "chips": 1, "why": "new"})
    for m in reg.benchmark["end_to_end"]:
        if m["name"] == "swap_ms_p50":
            m["workloads"].append("micro.repeat_face")
    r = harness.run_cell(reg, "micro.repeat_face", 2 ** 31 + 21, 1.0, False, device="cpu")
    assert r["correct"] and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", "swap_ms_p50"}
    assert r["check_detail"]["rows"] == min(2, r["attempted"])
    with faults.planted("answer_altered"):
        bad = harness.run_cell(reg, "micro.repeat_face", 2 ** 31 + 21, 1.0, False, device="cpu")
    assert not bad["correct"]
