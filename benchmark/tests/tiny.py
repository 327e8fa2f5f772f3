"""A tiny cell of either configuration for the CPU tests: 8/8/8 channels, a
16-unit core, 8 members (4 of them judged), 12 steps, on the cell's own
frames, env and limits."""

import json
from pathlib import Path

from benchmark import spec

ROOT = spec.ROOT


def cell(tmp: Path, workload: str = "impala_procgen.p1536", population: int = 8,
         episode_length: int = 12, check_members: int = 4):
    bench = spec.load_json(ROOT / "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = spec.load_json(ROOT / conf["file"])
    cfg.update(channels=[8, 8, 8], hidden=16)
    (tmp / "benchmark" / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / conf["file"]).write_text(json.dumps(cfg))
    w = spec.load_json(spec.HERE / "workloads" / f"{workload}.json")
    w.update(population=population, episode_length=episode_length, trace_seconds=1,
             check_members=check_members)
    return spec.cell(workload, root=tmp, bench=bench, workload=w)
