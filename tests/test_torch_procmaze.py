"""The port's ProcMaze env held against the JAX package's, on the CPU.

Everything here is exact: the level table (integer draws, wall comparisons
and the float32 tint of ``jax.random``), the integer dynamics, and frames
that are a tint times 0 or 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_tpu.envs.procmaze import ProcMazeEnv as JaxProcMazeEnv
from dfd_tpu_torch.envs import ProcMazeEnv
from dfd_tpu_torch.envs import _levels

CPU = "cpu"
torch.set_num_threads(1)  # the suite runs under xdist: one thread per worker
BENCH = dict(grid=8, scale=8, max_steps=40, num_levels=200)  # bench.py impala_procmaze


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("kw", [
    BENCH,
    dict(grid=4, scale=4, channels=4, distribution_mode="hard", num_levels=64),
    dict(grid=6, scale=2, max_steps=10, num_levels=50, start_level=12345),
], ids=["bench", "hard-grid4-c4", "start-level"])
def test_level_table_equals_jax(kw):
    jenv, penv = JaxProcMazeEnv(**kw), ProcMazeEnv(**kw, device=CPU)
    ids = jnp.arange(jenv.start_level, jenv.start_level + jenv.num_levels, dtype=jnp.int32)
    want = jax.jit(jax.vmap(jenv._gen_level))(ids)
    got = penv.level_arrays()
    for name, a, b in zip(("start", "goal", "walls", "tint"), got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)
    assert got[3].dtype == torch.float32 and got[2].dtype == torch.bool
    assert 0 < float(got[2].float().mean()) < 0.5  # walls exist and carve paths


def test_threefry_primitives_equal_jax():
    """The numpy generator bit for bit against jax.random at one key."""
    key = jax.random.fold_in(jax.random.key(977), 31)
    raw = np.asarray(jax.random.key_data(key))
    np.testing.assert_array_equal(_levels.fold_in(np.array([0, 977], np.uint32), np.uint32(31)),
                                  raw)
    np.testing.assert_array_equal(_levels.split(raw, 3),
                                  np.asarray(jax.random.key_data(jax.random.split(key, 3))))
    np.testing.assert_array_equal(_levels.randint(raw, (5,), 3, 1000),
                                  np.asarray(jax.random.randint(key, (5,), 3, 1000)))
    np.testing.assert_array_equal(_levels.uniform(raw, (4, 3)),
                                  np.asarray(jax.random.uniform(key, (4, 3))))


def test_dynamics_match_jax_for_48_steps():
    """M = 16 episodes reset from JAX's level draws, then 48 random actions:
    states, frames, rewards and dones equal JAX's at every step."""
    M = 16
    jenv, penv = JaxProcMazeEnv(**BENCH), ProcMazeEnv(**BENCH, device=CPU)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(jnp.arange(M))
    levels = jax.vmap(lambda k: jax.random.randint(k, (), 0, jenv.num_levels))(keys)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    pstate, pobs = penv.reset(M, torch.from_numpy(np.array(levels)))
    actions = np.random.RandomState(0).randint(0, 5, size=(48, M))
    jstep = jax.jit(jax.vmap(jenv.step))

    def same(ps, js, pobs, jobs):
        for name, a, b in zip(ps._fields, ps, js):
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)
        np.testing.assert_array_equal(_np(pobs), np.asarray(jobs))

    same(pstate, jstate, pobs, jobs)
    assert pobs.shape == (M, 3, 64, 64) and pobs.dtype == torch.float32
    rewards = dones = 0
    for t in range(48):
        jstate, jobs, jrew, jdone = jstep(jstate, jnp.asarray(actions[t], jnp.int32))
        pstate, pobs, prew, pdone = penv.step(pstate, torch.from_numpy(actions[t]))
        same(pstate, jstate, pobs, jobs)
        np.testing.assert_array_equal(_np(prew), np.asarray(jrew))
        np.testing.assert_array_equal(_np(pdone), np.asarray(jdone))
        rewards += int((prew != 0).sum())
        dones += int(pdone.sum())
    assert rewards > 0 and dones > 0


def test_with_levels_replays_and_reset_checks_its_draw():
    env = ProcMazeEnv(**BENCH, device=CPU)
    wide = env.with_levels(num_levels=400)
    shifted = env.with_levels(num_levels=100, start_level=50)
    assert wide.max_episode_steps == 40 and wide.num_levels == 400
    for a, b, c in zip(env.level_arrays(), wide.level_arrays(), shifted.level_arrays()):
        assert torch.equal(a, b[:200])
        assert torch.equal(a[50:150], c)
    with pytest.raises(ValueError, match="reset_level"):
        env.reset(3, torch.zeros(2, dtype=torch.int64))


def test_entry_point_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProcMazeEnv(**BENCH)
