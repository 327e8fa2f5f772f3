"""The harness on the CPU: what BENCHMARK.json names is found by name, a tiny
run prints a line of the contract's shape marked as no device result, the
entry refuses to run without a card or without the program, and nothing in
``benchmark/`` imports JAX, the JAX package or the root ``bench.py``."""

import ast
import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, spec
from benchmark.tests import tiny

ROOT = spec.ROOT
BENCH = spec.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SOURCES = sorted(p for p in spec.HERE.rglob("*.py"))


def test_benchmark_json_has_the_contracts_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(workload):
    cell = spec.cell(workload)
    assert cell.workload["name"] == workload and cell.config["name"] == cell.workload["config"]
    assert {m.name for m in cell.end_to_end} >= {"setup_s", "env_steps_per_s"}
    assert cell.per_layer and all(hasattr(m.reader, "read") for m in cell.per_layer)
    assert set(cell.workload["limits"]) == set(harness.check.NUMBERS)


def test_every_config_and_metric_has_its_file():
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert spec.load_json(ROOT / c["file"])["name"] == c["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "dfd_tpu"}
    if "reference" in path.parts:  # the plain reference takes nothing of the program
        assert "dfd_tpu_torch" not in tops


def test_top_level_names_are_compared_whole():
    assert harness.BANNED == ("jax", "jaxlib", "flax", "dfd_tpu")
    assert "dfd_tpu_torch".split(".")[0] not in harness.BANNED


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_nothing_reads_the_root_bench_or_the_jax_records(path):
    text = path.read_text()
    if path.name == "test_benchmark_harness.py":
        return
    for word in ("bench.py", "BENCH_r", "MULTICHIP_", "BASELINE", "dfd_tpu_torch.bench"):
        assert word not in text
    assert "bench" not in {name.split(".")[0] for name in _imports(path)}


def test_a_tiny_run_prints_a_contract_line_marked_off_the_card(tmp_path):
    cell = tiny.cell(tmp_path)
    res = harness.run(cell, 2 ** 31 + 7, 1.0, False, "cpu", time.perf_counter())
    line = harness.result_line(res, on_card=False)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert line["metrics"] == {} and line["device"]["platform"] == "cpu"
    assert set(line["cpu_readings"]) == {"env_steps_per_s", "setup_s"}
    assert set(line["checks"]) == set(harness.check.NUMBERS)
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    assert res.lines[-1].startswith("check archive_gap")
    json.dumps(line)


def test_a_tiny_traced_run_reads_the_per_layer_metrics_it_can(tmp_path):
    cell = tiny.cell(tmp_path, "impala_procgen_bf16.p1536")
    res = harness.run(cell, 5, 0.5, True, "cpu", time.perf_counter())
    assert res.correct is True
    assert set(res.metrics) == {"archive_ms"}  # the rest read the card
    assert res.device["window_s"] > 0 and res.breakdown is not None


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys, time; sys.path.insert(0, %r); from pathlib import Path; "
            "from benchmark import harness; from benchmark.tests import tiny; "
            "c = tiny.cell(Path(%r)); harness.run(c, 3, 0.5, False, 'cpu', time.perf_counter()); "
            "print(harness.banned_modules())") % (str(ROOT), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _entry(cwd):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_entry_prints_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = _entry(ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_the_entry_prints_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _entry(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_inputs_and_draws_come_from_the_seed_alone(tmp_path):
    from benchmark import check

    cell = tiny.cell(tmp_path)
    seed = 2 ** 31 + 99
    a, b = (check.draw_source(cell, seed, "cpu") for _ in range(2))
    for x, y in zip(a(3), b(3)):
        assert torch.equal(x, y)
    assert not torch.equal(a(3)[0], a(4)[0])
    gumbel, _, ties, perm, levels = a(0)
    P = cell.workload["population"]
    assert gumbel.shape == (P + 1, 1, cell.workload["episode_length"], 5)
    assert set(ties.tolist()) <= {-1.0, 1.0} and sorted(perm.tolist()) == list(range(8))
    assert int(levels.max()) < cell.config["num_levels"]
    t1, z1 = cell.arch.initial_inputs(cell.config, cell.workload, seed, "cpu")
    t2, z2 = cell.arch.initial_inputs(cell.config, cell.workload, seed, "cpu")
    assert torch.equal(t1, t2) and torch.equal(z1, z2)
    assert t1.shape == (cell.arch.reference_policy(cell.config, "f32").d,)
