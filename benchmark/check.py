"""The comparison that decides ``correct``.

The program's first epochs (``check_epochs`` of the cell), driven from the
seed through the window's own ``train`` and draws, leave a
:class:`~benchmark.reference.dfd.Record`: theta and zeta after each epoch,
the actions its rollout took, its reported metrics and its archive's
members.  The plain reference (``benchmark/reference``, float32 with TF32
off) then runs the same epochs from the same inputs, taking the recorded
actions and archive members as its own, and measures:

- ``action_gap``: the widest gap, over every step still running of the
  judged members (``check_members`` of them drawn from the seed, and the
  evaluation member), by which the action taken scores below the
  reference's best (log probability plus the step's Gumbel draw; the greedy
  member's log probability): the perturbation, the policy forward and the
  env.  Every member's episode is replayed through the reference env on the
  program's actions, so the rewards, the fitness and the update cover all
  of them;
- ``reward_gap``: the largest gap of the reported mean reward and averaged
  evaluation reward, in reward units: the env's rewards and the
  accumulation;
- ``novelty_gap``: the largest gap of the reported mean and averaged
  novelty, in distance units: the strategies over zeta, the distances and
  the least of them;
- ``update_gap``: the largest distance between the unit directions of an
  epoch's update: eps, the fitness, the combine and DSGD's direction;
- ``grad_gap``, ``change_gap``: the worst leaf's gap of update norms, of the
  first epoch and of all of them, over the larger of the reference leaf's
  norm and the median leaf's: DSGD's step under omega;
- ``zeta_gap``: the largest gap of zeta's pixels: the zeta refresh;
- ``archive_gap``: how far the archive's selection lies on the wrong side
  of the reference's criteria.

Each is held to the cell's limit (``limits`` in its workload file), set
from the readings in ``PERF.md``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from benchmark import draws as draws_mod
from benchmark.reference import dfd, noise_jax

NUMBERS = ("action_gap", "reward_gap", "novelty_gap", "update_gap", "grad_gap", "change_gap",
           "zeta_gap", "archive_gap")


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """float32 products with TF32 off inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def settings(cell, seed: int) -> dfd.Settings:
    w = cell.workload
    om = w["omega"]
    return dfd.Settings(
        P=w["population"], T=w["episode_length"], Z=w["zeta_size"], H=w["archive_size"],
        learning_rate=w["learning_rate"], noise_std=w["noise_std"], eval_every=w["eval_every"],
        noise_seed=cell.arch.train_seed(seed), omega_default=om["default_value"],
        omega_threshold=om["improvement_threshold"], omega_history=om["reward_history_size"],
        omega_min=om["min_value"], omega_max=om["max_value"],
        omega_steps_to_min=om["steps_to_min"], omega_steps_to_max=om["steps_to_max"],
        dsgd_min_scale=w["dsgd_min_scale"], dsgd_max_scale=w["dsgd_max_scale"])


def draw_source(cell, seed: int, device):
    w, c = cell.workload, cell.config
    return draws_mod.source(seed, w["population"], 1, w["episode_length"], w["zeta_size"],
                            c["n_actions"], c["num_levels"], device)


def judged_members(cell, seed: int):
    """The members whose every action the reference judges: ``check_members``
    of the P drawn from the seed, and the evaluation member P; None where
    that is all of them."""
    P, n = cell.workload["population"], cell.workload["check_members"]
    if n >= P:
        return None
    gen = torch.Generator().manual_seed(seed % (1 << 63))
    return torch.cat([torch.randperm(P, generator=gen)[:n].sort().values, torch.tensor([P])])


def reference(cell, seed: int, device, precision: str = "f32", fault=None) -> dfd.DFD:
    """The plain trainer of ``cell`` at ``precision``, with ``fault`` planted."""
    def noise(noise_seed, epoch, P, d, dev):
        return noise_jax.normal(noise_jax.member_keys(noise_seed, epoch, np.arange(P)), d, dev)

    return dfd.DFD(cell.arch.reference_policy(cell.config, precision),
                   cell.arch.reference_env(cell.config, device), settings(cell, seed),
                   draw_source(cell, seed, device), noise, device, fault=fault)


def judge(cell, seed: int, record: dfd.Record, device) -> Dict[str, float]:
    """The numbers of ``record`` against the reference from the same inputs."""
    theta0, zeta0 = cell.arch.initial_inputs(cell.config, cell.workload, seed, device)
    with full_f32(), torch.no_grad():
        _, gaps = reference(cell, seed, device).run(theta0, zeta0, len(record.metrics),
                                                     follow=record,
                                                     judged=judged_members(cell, seed))
    return {k: gaps[k] for k in NUMBERS}


def run_free(cell, seed: int, device, precision: str, fault=None) -> dfd.Record:
    """The record of the reference put in the program's place: at
    ``precision`` (the control) or with ``fault`` planted."""
    theta0, zeta0 = cell.arch.initial_inputs(cell.config, cell.workload, seed, device)
    with full_f32(), torch.no_grad():
        rec, _ = reference(cell, seed, device, precision, fault).run(
            theta0, zeta0, cell.workload["check_epochs"])
    return rec


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[str], Dict]:
    """(whether every number is within its limit, a line each, the
    numbers with their limits)."""
    ok, lines, table = True, [], {}
    for name in NUMBERS:
        value, limit = float(numbers[name]), float(limits[name])
        good = value <= limit
        ok &= good
        lines.append(f"check {name} {value:.6g} limit {limit:.6g} {'ok' if good else 'FAILED'}")
        table[name] = {"value": value, "limit": limit}
    return ok, lines, table
