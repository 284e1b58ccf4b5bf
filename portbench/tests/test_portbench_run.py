"""A run's last line, the check that nothing of JAX is loaded, and the
runs that must fail: without a card, and without the program."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness, load
from portbench.registry import ROOT
from portbench.tests.micro import MICRO_LIMITS, micro_registry

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("hairfastgan_tpu_extra", "jaxtyping", "flaxen.x", "hairfastgan_torch.api"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "hairfastgan_tpu.ops", object())
    assert harness.forbidden_modules() == ["hairfastgan_tpu", "jax"]


def test_last_line_has_the_result_keys(tmp_path):
    reg = micro_registry(tmp_path, traffics=("swap_b1",))
    r = harness.run_cell(reg, "micro.swap_b1", 2 ** 31 + 7, 2.5, False, device="cpu")
    lines = r.pop("_lines")
    assert RESULT_KEYS <= set(r) and list(r)[-1] == "checks"
    assert set(r["checks"]) == set(MICRO_LIMITS) and "own_cpu_per_s" in r["host"]
    assert {k: c["limit"] for k, c in r["checks"].items()} == MICRO_LIMITS
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["metrics"]) == {"setup_s", "swap_ms_p50", "swap_ms_p90"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert [line.split()[0] for line in lines] == ["mad_excess", "row_excess_max"]
    json.dumps(r)


def test_same_seed_same_inputs():
    a, b = load.triples(2 ** 33 + 1, 24, 5), load.triples(2 ** 33 + 1, 24, 5)
    assert (a == b).all() and all(len(set(t[0])) == 3 for t in a)
    p = load.make_pool(2 ** 33 + 1, 2, 32, 8, "cpu")
    q = load.make_pool(2 ** 33 + 1, 2, 32, 8, "cpu")
    assert all((x == y).all() for x, y in zip(p, q)) and p[0].dtype.name == "uint8"


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "ffhq1024.swap_b1", "--seed", "1", "--seconds", "1", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    res = _run(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "needs 1 CUDA device" in res.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_a_mix_of_cases_is_data_only(tmp_path):
    """`cases` in a closed mix sends the cases in turn, each with the roles
    it makes equal given one image object, and the check answers each case."""
    reg = micro_registry(tmp_path, traffics=("swap_b1",))
    t = reg.dir / "traffic" / "swap_b1.json"
    t.write_text(json.dumps(dict(json.loads(t.read_text()), cases=["same", "shape_eq_color"],
                                 check_requests=2)))
    r = harness.run_cell(reg, "micro.swap_b1", 2 ** 31 + 5, 2.0, False, device="cpu")
    assert r["correct"] and r["attempted"] >= 2 and r["check_detail"]["rows"] == 2
    assert load.ROLES["same"] == (0, 0, 0) and load.ROLES["shape_eq_color"] == (0, 1, 1)
