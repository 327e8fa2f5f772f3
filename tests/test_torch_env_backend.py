"""The fat client's host-env backend policy (``dfd_tpu_torch.runners.
fat_client``) held against the JAX package's: ``choose_backend``'s
decisions on a grid, ``resolve_backend`` and ``default_vector_env`` with the
probes replaced, the probe resolved once across lanes, and the explicit
backends.  No test asserts a wall-clock bound: the probes' timings are
replaced wherever a decision depends on them."""

import itertools

import numpy as np
import pytest

from dfd_tpu.runners import fat_client as jfat
from dfd_tpu_torch.envs.native_pool import NativeTrapPool
from dfd_tpu_torch.envs.vector_host import PythonVectorEnv, ThreadPoolVectorEnv
from dfd_tpu_torch.runners import fat_client

CPU = "cpu"


@pytest.mark.parametrize("cores", [None, 1, 2, 8])
def test_choose_backend_matches_jax_on_a_grid(cores):
    assert fat_client.THREAD_CROSSOVER_S == jfat.THREAD_CROSSOVER_S
    costs = [0.0, 0.01e-3, 0.03e-3, 0.149e-3, jfat.THREAD_CROSSOVER_S, 0.151e-3, 0.4e-3, 5e-3]
    speedups = [None, 0.8, 1.02, 1.2499, 1.25, 1.7, 3.0]
    for cost, speedup in itertools.product(costs, speedups):
        assert fat_client.choose_backend(cost, cpu_count=cores, parallel_speedup=speedup) == \
            jfat.choose_backend(cost, cpu_count=cores, parallel_speedup=speedup), (cost, speedup)


def test_resolve_backend_applies_the_probes(monkeypatch):
    """auto: probe one step's cost, and for a heavy step the 2-thread
    speedup; a light step or one core never runs the second probe."""
    calls = []

    def speedup(env_id, seed, device=None):
        calls.append((env_id, seed, device))
        return speedup.value

    monkeypatch.setattr(fat_client, "probe_parallel_speedup", speedup)
    monkeypatch.setattr(fat_client.os, "cpu_count", lambda: 4)
    for cost, value, want in ((0.5e-3, 1.8, "thread"), (0.5e-3, 1.0, "serial"),
                              (0.01e-3, 1.8, "serial")):
        monkeypatch.setattr(fat_client, "probe_step_cost",
                            lambda env_id, seed, device=None, cost=cost: cost)
        speedup.value = value
        calls.clear()
        assert fat_client.resolve_backend("CartPole-v1", 3, CPU) == want
        assert calls == ([("CartPole-v1", 3, CPU)] if cost >= 0.15e-3 else [])
    monkeypatch.setattr(fat_client.os, "cpu_count", lambda: 1)
    monkeypatch.setattr(fat_client, "probe_step_cost", lambda env_id, seed, device=None: 1e-3)
    calls.clear()
    assert fat_client.resolve_backend("CartPole-v1", 3, CPU) == "serial" and not calls


def test_default_vector_env_auto_builds_what_the_probe_decides(monkeypatch):
    monkeypatch.setattr(fat_client, "resolve_backend", lambda env_id, seed, device=None: "thread")
    heavy = fat_client.default_vector_env("CartPole-v1", 2, seed=0, backend="auto", device=CPU)
    assert isinstance(heavy, ThreadPoolVectorEnv)
    heavy.close()
    monkeypatch.setattr(fat_client, "resolve_backend", lambda env_id, seed, device=None: "serial")
    light = fat_client.default_vector_env("CartPole-v1", 2, seed=0, backend="auto", device=CPU)
    assert type(light) is PythonVectorEnv
    light.close()


def test_default_vector_env_explicit_backends():
    thread = fat_client.default_vector_env("SimpleTrapEnv-v0", 3, seed=0, backend="thread",
                                           device=CPU)
    assert isinstance(thread, ThreadPoolVectorEnv)
    serial = fat_client.default_vector_env("SimpleTrapEnv-v0", 3, seed=0, backend="serial",
                                           device=CPU)
    assert isinstance(serial, NativeTrapPool)  # the trap's serial backend is the native pool
    outs = []
    for vec in (thread, serial):
        obs = vec.reset_all()
        assert obs.shape == (3, 2)
        o2, r, d = vec.step(np.array([8, 5, 0], np.int64))
        assert o2.shape == obs.shape and r.shape == (3,) and d.shape == (3,)
        outs.append((obs, o2, r, d))
        vec.close()
    for a, b in zip(*outs):  # the two backends step the same trap
        np.testing.assert_allclose(a, b, rtol=1.2e-7, atol=0)
    with pytest.raises(ValueError):
        fat_client.default_vector_env("SimpleTrapEnv-v0", 3, seed=0, backend="processes")


def test_auto_probe_resolved_once_across_lanes(monkeypatch):
    calls = []

    def fake_resolve(env_id, seed, device=None):
        calls.append((env_id, device))
        return "serial"

    monkeypatch.setattr(fat_client, "resolve_backend", fake_resolve)
    runner = fat_client.FatClientRunner(n_envs=4, pipeline_lanes=2, env_backend="auto",
                                        device=CPU)
    for lane in range(2):
        runner._vector_env_factory("SimpleTrapEnv-v0", 2, lane * 2).close()
    assert [c[0] for c in calls] == ["SimpleTrapEnv-v0"]
    assert str(calls[0][1]) == CPU


def test_fat_client_default_factory_carries_backend_and_device():
    runner = fat_client.FatClientRunner(n_envs=2, env_backend="thread", device=CPU)
    vec = runner._vector_env_factory("CartPole-v1", 2, 0)
    assert isinstance(vec, ThreadPoolVectorEnv)
    assert all(str(e.env.device) == CPU for e in vec.envs)
    vec.close()


def test_probes_step_real_envs():
    """The probes run: one step's median cost is a positive time and the
    2-thread speedup a positive ratio (their sizes are not asserted)."""
    cost = fat_client.probe_step_cost("SimpleTrapEnv-v0", seed=0, device=CPU)
    speedup = fat_client.probe_parallel_speedup("SimpleTrapEnv-v0", seed=0, n_steps=2, device=CPU)
    assert np.isfinite(cost) and cost > 0
    assert np.isfinite(speedup) and speedup > 0


def test_fat_client_pipeline_lanes_must_divide():
    with pytest.raises(ValueError):
        fat_client.FatClientRunner(n_envs=5, pipeline_lanes=2, device=CPU)
