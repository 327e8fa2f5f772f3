"""The check on the CPU at tiny sizes: the plain reference computes what the
program computes, a sound run comes out correct, and the control and each
fault the cells can have come out not correct."""

import time

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.arch import impala as arch
from benchmark.reference import impala as plain
from benchmark.reference import noise_jax, procmaze
from benchmark.tests import tiny

WORKLOADS = ("impala_procgen.p1536", "impala_procgen_bf16.p1536")


def _program_model(cell):
    from dfd_tpu_torch.models import ImpalaPolicy

    cfg = cell.config
    dtype = {"float32": None, "bfloat16": torch.bfloat16}[cfg["compute_dtype"]]
    return ImpalaPolicy(arch.frame_shape(cfg), cfg["n_actions"], compute_dtype=dtype,
                        conv_impl=cfg["conv_impl"], channels=tuple(cfg["channels"]),
                        hidden=cfg["hidden"], device="cpu")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_policy_is_the_programs(tmp_path, workload):
    cell = tiny.cell(tmp_path, workload)
    model = _program_model(cell)
    precision = {"float32": "f32", "bfloat16": "bf16"}[cell.config["compute_dtype"]]
    # bf16 rounds intermediate activations: a float32 difference in a sum can move one
    # across a rounding boundary, so the two agree to bf16's precision only
    tol = dict(rtol=1e-4, atol=1e-6) if precision == "f32" else dict(rtol=2e-2, atol=2e-3)
    ref = arch.reference_policy(cell.config, precision)
    gen = torch.Generator().manual_seed(0)
    theta = plain.initial_theta(ref.layout, 3, "cpu")
    theta = torch.stack([theta, theta + 0.05 * torch.randn(theta.shape, generator=gen)])
    _, bn_state = model.init(0)
    params = model.set_flat(theta)
    frames = torch.rand((2,) + arch.frame_shape(cell.config), generator=gen) * 255
    rewards = torch.tensor([0.5, -2.0])
    carry = tuple(torch.randn((2, cell.config["hidden"]), generator=gen) for _ in range(2))
    probs, (h, c) = model.step_probs(params, bn_state, frames, rewards, carry)
    mine, (h2, c2) = ref.step(plain.unflatten(theta, ref.layout), frames[:, None],
                              rewards[:, None], tuple(x[:, None] for x in carry))
    torch.testing.assert_close(mine[:, 0], probs, **tol)
    torch.testing.assert_close(c2[:, 0], c, **tol)
    zeta = torch.rand((4,) + arch.frame_shape(cell.config), generator=gen) * 255
    torch.testing.assert_close(ref.strategy(plain.unflatten(theta, ref.layout), zeta),
                               model.strategy(params, bn_state, zeta), **tol)


def test_reference_env_is_the_programs():
    from dfd_tpu_torch.envs import ProcMazeEnv

    env = ProcMazeEnv(grid=8, scale=8, max_steps=40, num_levels=200, device="cpu")
    ref = procmaze.Maze(8, 8, 3, 200, 0, "easy", 255.0, 40, "cpu")
    for a, b in zip(env.level_arrays(), (ref._start, ref._goal, ref._walls, ref._tint)):
        assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(1)
    levels = torch.randint(0, 200, (64,), generator=gen)
    s1, o1 = env.reset(64, levels)
    s2, o2 = ref.reset(levels)
    assert torch.equal(o1, o2)
    for _ in range(40):
        a = torch.randint(0, 5, (64,), generator=gen)
        s1, o1, r1, d1 = env.step(s1, a)
        s2, o2, r2, d2 = ref.step(s2, a)
        assert torch.equal(o1, o2) and torch.equal(r1, r2) and torch.equal(d1, d2)


def test_reference_noise_is_the_programs():
    from dfd_tpu_torch.core.noise import CounterNoise

    seed, d = 2 ** 31 + 11, 3001
    eps = CounterNoise(d, random_seed=seed, device="cpu").generate_block(4, range(5))
    mine = noise_jax.normal(noise_jax.member_keys(seed, 4, np.arange(5)), d, "cpu")
    # XLA's float32 polynomial for erfinv is within a few 1e-6 of float64's in the tails
    torch.testing.assert_close(mine, eps, rtol=5e-6, atol=1e-6)


def _run(cell, seed=9):
    return harness.run(cell, seed, 0.5, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct(tmp_path, workload):
    res = _run(tiny.cell(tmp_path, workload))
    assert res.correct, res.lines


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(tmp_path, workload):
    """At this size, limits set as the cells' are (above the program's readings on
    the same seeds, here 3x their largest; exact numbers 0) fail the control on
    every seed; the cells' own limits come from readings at the cells' sizes."""
    cell = tiny.cell(tmp_path, workload, population=16, episode_length=24)
    seeds = (4, 5)
    program = [check.judge(cell, s, harness.setup(cell, s, "cpu")[2], "cpu") for s in seeds]
    limits = {k: 3 * max(r[k] for r in program) for k in check.NUMBERS}
    for s in seeds:
        record = check.run_free(cell, s, "cpu", cell.arch.control_precision(cell.config))
        ok, lines, _ = check.verdict(check.judge(cell, s, record, "cpu"), limits)
        assert not ok, lines


def _unchanged(monkeypatch):
    from dfd_tpu_torch.runners import vectorized

    step = vectorized.VectorizedTrainer._epoch_step

    def stuck(self, state, archive, count):
        return state, step(self, state, archive, count)[1]

    monkeypatch.setattr(vectorized.VectorizedTrainer, "_epoch_step", stuck)


def _half_batch(monkeypatch):
    from dfd_tpu_torch.runners import vectorized

    combine = vectorized.fd_combine.combine_gradient

    def half(eps, fitness, sigma):
        n = eps.shape[0] // 2
        return combine(eps[:n], fitness[:n], sigma)

    monkeypatch.setattr(vectorized.fd_combine, "combine_gradient", half)


def _altered(monkeypatch):
    from dfd_tpu_torch.models import impala as program

    sample, calls = program.sample_action, []

    def altered(probs, deterministic, gumbel):
        action, entropy = sample(probs, deterministic, gumbel)
        if not calls:  # every sampled member's first action, set to its worst
            worst = (torch.log(probs.clamp_min(1e-38)) + gumbel).argmin(-1)
            action = torch.where(deterministic[:, None], action, worst)
        calls.append(1)
        return action, entropy

    monkeypatch.setattr(program, "sample_action", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_program_is_not_correct(tmp_path, monkeypatch, workload, fault):
    cell = tiny.cell(tmp_path, workload)
    fault(monkeypatch)
    res = _run(cell)
    assert not res.correct, res.lines


def test_judged_members_come_from_the_seed_and_hold_the_evaluation_member(tmp_path):
    cell = tiny.cell(tmp_path, population=8, check_members=4)
    a, b = check.judged_members(cell, 2 ** 31 + 5), check.judged_members(cell, 2 ** 31 + 5)
    assert torch.equal(a, b) and a.tolist() == sorted(set(a.tolist()))
    assert a.shape == (5,) and int(a[-1]) == 8 and int(a[:-1].max()) < 8
    assert not all(torch.equal(a, check.judged_members(cell, s)) for s in range(6, 12))
    everyone = tiny.cell(tmp_path, population=8, check_members=8)
    assert check.judged_members(everyone, 5) is None


def test_a_judged_sample_reads_as_judging_everyone_on_a_sound_run(tmp_path):
    """The replay of every member's episode gives the same rewards, update and
    archive whichever members the policy judges."""
    some, every = (tiny.cell(tmp_path, check_members=n) for n in (3, 8))
    record = harness.setup(some, 12, "cpu")[2]
    a, b = check.judge(some, 12, record, "cpu"), check.judge(every, 12, record, "cpu")
    for key in ("reward_gap", "novelty_gap", "update_gap", "grad_gap", "change_gap",
                "zeta_gap", "archive_gap"):
        assert a[key] == b[key], key
    assert a["action_gap"] <= b["action_gap"]
