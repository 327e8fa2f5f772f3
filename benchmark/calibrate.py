"""The readings the check's limits are set from.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 \\
        --subjects program,control,unchanged,half_batch,altered [--out file.jsonl]

For each seed and subject, in one process: the subject's first epochs
(``check_epochs`` of the cell) and the check's numbers against the plain
reference.  ``program`` is the program, driven as a run's set-up drives it;
``control`` the reference put in its place one precision below the
configuration's (TF32 for float32, float8 e4m3 for bfloat16); the others the
reference put in its place with a fault planted: a step that returns its
state unchanged, half the members left out of the update and the means, an
action altered where it is chosen.  One JSON line a reading, on standard
output and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import check, harness, spec

SUBJECTS = ("program", "control", "unchanged", "half_batch", "altered")


def record_of(cell, seed: int, subject: str, device):
    if subject == "program":
        trainer, _, record = harness.setup(cell, seed, device)
        del trainer
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        return record
    if subject == "control":
        return check.run_free(cell, seed, device, cell.arch.control_precision(cell.config))
    return check.run_free(cell, seed, device, "f32", fault=subject)


def readings(cell, seeds, subjects, device):
    for subject in subjects:
        for seed in seeds:
            t = time.perf_counter()
            numbers = check.judge(cell, seed, record_of(cell, seed, subject, device), device)
            yield {"workload": cell.name, "subject": subject, "seed": seed,
                   "seconds": time.perf_counter() - t, **numbers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--subjects", default=",".join(SUBJECTS))
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    subjects = args.subjects.split(",")
    bad = [s for s in subjects if s not in SUBJECTS]
    if bad:
        p.error(f"unknown subjects {bad}; choose from {SUBJECTS}")
    seeds = [int(s) for s in args.seeds.split(",")]
    for row in readings(cell, seeds, subjects, args.device):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
