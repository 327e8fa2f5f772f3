"""What ``BENCHMARK.json`` names, found by name.

A cell ``<name>`` reads ``benchmark/workloads/<name>.json`` (its traffic:
population, horizon, zeta, archive, the trainer's rates, the epochs its
check follows, the members whose actions it judges and the limits of the
check's numbers); its configuration is the file ``BENCHMARK.json`` gives, whose
``arch`` names ``benchmark/arch/<arch>.py``; each metric ``<m>`` is read by
``benchmark/metrics/<m>.py``'s ``read(ctx)``.  A later cell, configuration
or metric is a file of its own and an entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, NamedTuple

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


class Metric(NamedTuple):
    name: str
    unit: str
    reader: Any


class Cell(NamedTuple):
    name: str
    chips: int
    workload: Dict[str, Any]
    config: Dict[str, Any]
    arch: Any
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def reader(name: str):
    """``benchmark/metrics/<name>.py``, loaded by its path (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(name: str, root: Path = ROOT, bench=None, workload=None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` under ``root`` (or of
    ``bench``, a dict of its form), with its workload file (or
    ``workload``), its configuration and the metrics it reports."""
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = workload if workload is not None else load_json(HERE / "workloads" / f"{name}.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(root / conf_entry["file"])
    arch = importlib.import_module(f"benchmark.arch.{config['arch']}")

    def mine(kind):
        return [Metric(m["name"], m["unit"], reader(m["name"])) for m in bench[kind]
                if name in m.get("workloads", [name])]

    return Cell(name, entry["chips"], workload, config, arch, mine("end_to_end"),
                mine("per_layer"))
