"""Epoch reporting with the reference's metric vocabulary
(reference run_sequential.py:167-196, run_server.py:172-215), a copy of
``dfd_tpu.utils.metrics``.

The metric names are the comparison surface for learning-curve parity, so
they are kept verbatim: Epoch, Epoch Time, Cumulative Timesteps, Policy
Reward/Entropy/Novelty, Noisy Reward/Novelty, Update Magnitude, Omega,
Delayed Ratio, Discarded Returns.  Optional wandb sink; keys starting with
"_" are console-suppressed.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional


class EpochReporter:
    def __init__(self, wandb_run=None, quiet: bool = False, sink: Optional[Callable] = None):
        self.wandb_run = wandb_run
        self.quiet = quiet
        self.sink = sink
        self.history: List[Dict] = []

    def report(self, epoch_report: Dict) -> None:
        self.history.append(dict(epoch_report))
        if self.wandb_run is not None:
            self.wandb_run.log(epoch_report)
        if self.sink is not None:
            self.sink(epoch_report)
        if not self.quiet:
            print("\n***********Begin Epoch Report***********")
            for key, val in epoch_report.items():
                if key.startswith("_"):
                    continue
                if isinstance(val, float):
                    print("{} {:7.4f}".format(key, val))
                else:
                    print(key, val)
            print("***********End Epoch Report***********")

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for row in self.history:
                f.write(json.dumps(row) + "\n")


def make_reporter(
    wandb_project: Optional[str] = None,
    wandb_group: Optional[str] = None,
    wandb_run_name: Optional[str] = None,
    quiet: bool = False,
) -> EpochReporter:
    """Reporter factory with optional wandb attachment (the reference's
    run-logging setup, run_sequential.py:44-51); silently degrades to
    console/history-only when wandb is unavailable or no project is given."""
    run = None
    if wandb_project is not None:
        try:
            import wandb

            run = wandb.init(
                project=wandb_project, group=wandb_group, name=wandb_run_name, reinit=True
            )
        except Exception:
            run = None
    return EpochReporter(wandb_run=run, quiet=quiet)
