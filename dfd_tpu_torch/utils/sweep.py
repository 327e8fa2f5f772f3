"""Hyperparameter sweeps (reference run_server.py:245-281), a copy of
``dfd_tpu.utils.sweep``.

The reference delegates to a wandb random-search agent over lr/noise_std/
batch_size, maximizing "Policy Reward".  This is the self-contained
equivalent: random search over a discrete space, driving any runner factory
and scoring it on a reporter metric; wandb logging hooks in when a run
object is supplied to the runner's reporter.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

DEFAULT_SPACE: Dict[str, Sequence] = {
    "learning_rate": [0.005, 0.01, 0.025, 0.05, 0.075, 0.1],
    "noise_std": [0.005, 0.01, 0.025, 0.05, 0.075, 0.1],
    "batch_size": [10, 25, 50, 75, 100],
}


@dataclasses.dataclass
class Trial:
    params: Dict[str, Any]
    score: float
    history_len: int


@dataclasses.dataclass
class SweepResult:
    trials: List[Trial]
    metric: str
    maximize: bool

    @property
    def best(self) -> Trial:
        key = (lambda t: t.score) if self.maximize else (lambda t: -t.score)
        return max(self.trials, key=key)


def random_search(
    run_trial: Callable[[Dict[str, Any]], Sequence[Dict]],
    space: Optional[Dict[str, Sequence]] = None,
    n_trials: int = 10,
    metric: str = "Policy Reward",
    maximize: bool = True,
    seed: int = 0,
    score_last_k: int = 5,
) -> SweepResult:
    """``run_trial(params) -> epoch-report history``; scored by the mean of
    ``metric`` over the last ``score_last_k`` reports."""
    space = space or DEFAULT_SPACE
    rng = np.random.RandomState(seed)
    trials: List[Trial] = []
    for _ in range(n_trials):
        params = {k: v[rng.randint(len(v))] for k, v in space.items()}
        history = run_trial(params)
        vals = [h[metric] for h in history if metric in h][-score_last_k:]
        score = float(np.mean(vals)) if vals else float("-inf" if maximize else "inf")
        trials.append(Trial(params=params, score=score, history_len=len(history)))
    return SweepResult(trials=trials, metric=metric, maximize=maximize)


# -- wandb-native sweep agent (reference run_server.py:245-281) ----------------

REFERENCE_SWEEP_CONFIG: Dict[str, Any] = {
    "method": "random",
    "metric": {"goal": "maximize", "name": "Policy Reward"},
    "parameters": {k: {"values": list(v)} for k, v in DEFAULT_SPACE.items()},
}


def wandb_sweep(
    runner_factory: Callable[..., Any],
    sweep_config: Optional[Dict[str, Any]] = None,
    sweep_id: Optional[str] = None,
    project: str = "dfd-tpu-sweep",
    count: int = 180,
    train_epochs: Optional[int] = None,
    _wandb=None,
) -> str:
    """Delegate the search to a wandb random-search agent, exactly the
    reference's sweep entry (reference run_server.py:245-281): build (or
    reuse) a sweep, then run ``wandb.agent`` whose trial function constructs
    a runner from ``run.config`` and trains it, logging through the run.

    ``runner_factory(wandb_run=..., learning_rate=..., noise_std=...,
    batch_size=...)`` must return an object with ``train(n)`` (sequential /
    vectorized cadence) or ``train()`` (server cadence, when
    ``train_epochs`` is None).  Returns the sweep id so agents on other
    hosts can join the same sweep.
    """
    wandb = _wandb
    if wandb is None:
        try:
            import wandb  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "wandb is not installed; use random_search() for the "
                "self-contained local sweep"
            ) from e

    cfg = sweep_config or REFERENCE_SWEEP_CONFIG
    if sweep_id is None:
        sweep_id = wandb.sweep(sweep=cfg, project=project)

    def trial_fn():
        run = wandb.init(project=project)
        runner = runner_factory(
            wandb_run=run,
            **{k: run.config[k] for k in cfg["parameters"]},
        )
        if train_epochs is None:
            runner.train()
        else:
            runner.train(train_epochs)

    wandb.agent(sweep_id, function=trial_fn, count=count, project=project)
    return sweep_id
