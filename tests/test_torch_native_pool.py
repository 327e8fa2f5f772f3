"""The port's native trap pool (its own ``g++`` build of
``runtime/envpool.cc`` under ``build/dfd_tpu_torch/``) held against the JAX
package's trap env and pool on the CPU: observations within 1e-6 (the
world-unit division in float32), rewards and done flags exact."""

import os
from pathlib import Path

import jax
import numpy as np
import pytest

from dfd_tpu.envs.native_pool import NativeTrapPool as JNativeTrapPool
from dfd_tpu.envs.trap import TrapEnv as JTrapEnv
from dfd_tpu_torch.envs import native_pool
from dfd_tpu_torch.envs.native_pool import NativeTrapPool, native_pool_available

ROOT = Path(__file__).resolve().parents[1]


def test_native_matches_jax_env():
    env = JTrapEnv()
    pool = NativeTrapPool(3)
    obs0 = pool.reset_all()
    _, jobs = env.reset(jax.random.key(0))
    np.testing.assert_allclose(obs0[0], np.asarray(jobs), atol=1e-6)
    step = jax.jit(env.step)
    rng = np.random.RandomState(0)
    states = [env.reset(jax.random.key(0))[0] for _ in range(3)]
    for t in range(210):
        actions = rng.randint(0, 9, size=3)
        obs, rew, done = pool.step(actions)
        for i in range(3):
            states[i], jobs, jrew, jdone = step(states[i], int(actions[i]))
            np.testing.assert_allclose(obs[i], np.asarray(jobs), atol=1e-6)
            assert float(rew[i]) == float(jrew), (t, i)
            assert bool(done[i]) == bool(jdone)
        if done.all():
            break
    assert bool(done.all())  # 201-step episodes terminated


def test_native_out_of_range_actions_noop():
    pool = NativeTrapPool(2)
    pool.reset_all()
    obs, rew, done = pool.step(np.array([9, -1]))
    np.testing.assert_array_equal(rew, [0.0, 0.0])


def test_native_auto_reset_matches_jax_pool():
    """Auto-reset reports the start observation after the episode's end,
    and the port's pool equals the JAX package's step for step."""
    pools = [NativeTrapPool(2), JNativeTrapPool(2)]
    start = [p.reset_all()[0] for p in pools]
    np.testing.assert_array_equal(start[0], start[1])
    rng = np.random.RandomState(1)
    for _ in range(201):
        a = rng.randint(0, 9, size=2)
        outs = [p.step(a, auto_reset=True) for p in pools]
        for x, y in zip(*outs):
            np.testing.assert_array_equal(x, y)
    pool = pools[0]
    pool.reset_all()
    for _ in range(201):
        obs, rew, done = pool.step(np.array([4, 4]), auto_reset=True)  # stay put
    assert bool(done[0])
    np.testing.assert_allclose(obs[0], start[0], atol=1e-6)


def test_native_throughput_smoke():
    import time

    n = 512
    pool = NativeTrapPool(n)
    pool.reset_all()
    actions = np.random.RandomState(0).randint(0, 9, size=n).astype(np.int32)
    t0 = time.perf_counter()
    iters = 200
    for _ in range(iters):
        pool.step(actions, auto_reset=True)
    steps_per_s = n * iters / (time.perf_counter() - t0)
    assert steps_per_s > 100_000, steps_per_s


def test_lib_search_order(tmp_path, monkeypatch):
    """DFD_ENVPOOL_LIB overrides; otherwise the port's own build under
    build/dfd_tpu_torch/, never the JAX package's copies."""
    assert native_pool_available()
    found = Path(native_pool._find_lib())
    assert found.parent == ROOT / "build" / "dfd_tpu_torch"
    assert found.name.startswith("libdfd_envpool-") and found.suffix == ".so"
    assert found == native_pool.library_path() and found.exists()
    monkeypatch.setattr(native_pool, "SOURCE", tmp_path / "envpool.cc")
    (tmp_path / "envpool.cc").write_bytes((ROOT / "runtime" / "envpool.cc").read_bytes()
                                          + b"\n// edited\n")
    assert native_pool.library_path() != found  # an edited source gets a library of its own

    override = tmp_path / "libdfd_envpool.so"
    override.write_bytes(b"")  # existence is all _find_lib checks
    monkeypatch.setenv("DFD_ENVPOOL_LIB", str(override))
    assert native_pool._find_lib() == str(override)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ cannot compile raises, with the compiler's output."""
    bad = tmp_path / "envpool.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_pool, "SOURCE", bad)
    monkeypatch.setattr(native_pool, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_pool.build()


def test_pool_reads_a_text_map(tmp_path):
    """A pool built from a reference-format text map of the shipped grid
    steps as the default one."""
    from _torch_port import trap_map_text
    from dfd_tpu_torch.envs.trap import load_walkable_grid

    path = tmp_path / "map.txt"
    path.write_text(trap_map_text(load_walkable_grid()))
    pools = [NativeTrapPool(3), NativeTrapPool(3, map_path=str(path))]
    for p in pools:
        p.reset_all()
    rng = np.random.RandomState(2)
    for _ in range(50):
        a = rng.randint(0, 9, size=3)
        outs = [p.step(a) for p in pools]
        for x, y in zip(*outs):
            np.testing.assert_array_equal(x, y)


def test_an_installed_port_loads_its_native_copy(tmp_path, monkeypatch):
    """Outside a checkout (no ``runtime/envpool.cc``) the loader takes the
    wheel's copy in ``dfd_tpu_torch/_native``, and that pool steps as JAX's
    does; with no copy there either it raises, naming all three places."""
    import subprocess

    native = tmp_path / "_native"
    native.mkdir()
    lib = native / "libdfd_envpool.so"
    subprocess.run(["g++", *native_pool.GXX_FLAGS, "-o", str(lib),
                    str(ROOT / "runtime" / "envpool.cc")], check=True)
    monkeypatch.delenv("DFD_ENVPOOL_LIB", raising=False)
    monkeypatch.setattr(native_pool, "SOURCE", tmp_path / "runtime" / "envpool.cc")
    monkeypatch.setattr(native_pool, "NATIVE_DIR", native)
    monkeypatch.setattr(native_pool, "_lib", None)
    assert native_pool._find_lib() == str(lib)

    pools = [NativeTrapPool(2), JNativeTrapPool(2)]
    assert native_pool._lib._name == str(lib)
    np.testing.assert_array_equal(pools[0].reset_all(), pools[1].reset_all())
    rng = np.random.RandomState(3)
    for _ in range(205):
        a = rng.randint(0, 9, size=2)
        outs = [p.step(a, auto_reset=True) for p in pools]
        for x, y in zip(*outs):
            np.testing.assert_array_equal(x, y)

    lib.unlink()
    with pytest.raises(FileNotFoundError) as err:
        native_pool._find_lib()
    for place in ("DFD_ENVPOOL_LIB", str(tmp_path / "runtime" / "envpool.cc"), str(lib)):
        assert place in str(err.value)
