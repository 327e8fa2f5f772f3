"""The IMPALA flagship's rollout and trainer held against the JAX package's,
on the CPU, at a parity size: ``ProcMazeEnv(grid=4, scale=8)`` (3x32x32
frames) and ``ImpalaPolicy(channels=(8, 16, 16), hidden=32,
conv_impl="fused_feat")``, where both fused kernels are on the path (the res
stage at 8 ch x 16x16, the feature block 8 -> 16 at 16x16).  JAX runs its
Pallas kernels in interpret mode; the port runs their plain versions.

Both packages consume the same random numbers, the levels included (see
``tests/_torch_port.py``), so rewards and steps agree exactly and every
float to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import episode_draws, jax_state_numpy, run_and_compare
from dfd_tpu.config import TrainConfig as JaxTrainConfig
from dfd_tpu.envs.procmaze import ProcMazeEnv as JaxProcMazeEnv
from dfd_tpu.fd import rollout as jax_rollout
from dfd_tpu.models.impala import ImpalaPolicy as JaxImpala
from dfd_tpu.ops import distances as jax_distances
from dfd_tpu.runners import VectorizedTrainer as JaxTrainer
from dfd_tpu_torch.config import TrainConfig
from dfd_tpu_torch.convert import params_from_numpy, train_state_from_numpy
from dfd_tpu_torch.envs import ProcMazeEnv
from dfd_tpu_torch.fd import rollout as port_rollout
from dfd_tpu_torch.models import ImpalaPolicy
from dfd_tpu_torch.ops import distances
from dfd_tpu_torch.runners import VectorizedTrainer

CPU = "cpu"
ENV = dict(grid=4, scale=8, max_steps=10, num_levels=20)
MODEL = dict(channels=(8, 16, 16), hidden=32, conv_impl="fused_feat")


def _np(t):
    return t.detach().cpu().numpy()


def test_episode_rollout_matches_jax():
    """M = 5 perturbed members, one deterministic, each on its own level:
    the LSTM carry and the previous reward ride the step loop."""
    M, Z = 5, 4
    jenv, penv = JaxProcMazeEnv(**ENV), ProcMazeEnv(**ENV, device=CPU)
    jm = JaxImpala(jenv.obs_shape, 5, **MODEL)
    pm = ImpalaPolicy(penv.obs_shape, 5, device=CPU, **MODEL)
    params_np, bn_np = jm.init(3)
    flat = jm.get_flat(params_np)
    flats = (flat[None] + 0.2 * np.random.RandomState(0).randn(M, flat.size)).astype(np.float32)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(2), i))(jnp.arange(M))
    det = np.arange(M) == 2
    T = jenv.max_episode_steps
    zero, one = np.zeros(jenv.obs_shape, np.float32), np.ones(jenv.obs_shape, np.float32)

    def one_episode(v, k, d):
        return jax_rollout.episode_rollout(
            jm, jenv, jm.set_flat(v, xp=jnp), bn_np, k, T, deterministic=d,
            obs_mean=zero, obs_std=one, normalize_obs=False, obs_stats_update_chance=0.0,
            collect_states=False, collect_limit=Z,
        )

    want = jax.jit(jax.vmap(one_episode))(flats, keys, det)
    g, u, level = episode_draws(keys, T, 5, penv)
    _, bn = params_from_numpy(pm, params_np, bn_np, CPU)
    got = port_rollout.episode_rollout(
        pm, penv, pm.set_flat(torch.from_numpy(flats)), bn, T, torch.from_numpy(det),
        torch.from_numpy(zero), torch.from_numpy(one), normalize_obs=False,
        obs_stats_update_chance=0.0, action_noise=torch.from_numpy(g)[:, None],
        stats_uniform=torch.from_numpy(u)[:, None], reset_level=torch.from_numpy(level)[:, None],
        collect_limit=Z,
    )
    got = got._replace(reward=got.reward[:, 0], entropy=got.entropy[:, 0], steps=got.steps[:, 0])
    np.testing.assert_array_equal(_np(got.reward), np.asarray(want.reward))
    np.testing.assert_array_equal(_np(got.steps), np.asarray(want.steps))
    assert len(set(_np(got.reward).tolist())) > 1  # the members really differ
    assert (_np(got.steps) < T).any()  # some reach the goal: the carry freezes
    np.testing.assert_allclose(_np(got.entropy), np.asarray(want.entropy), rtol=1e-5)
    np.testing.assert_array_equal(_np(got.states), np.asarray(want.states))


def test_trainer_matches_jax_epoch_by_epoch(monkeypatch):
    """Three epochs of ``train(1)`` at P = 8, Z = 4, H = 4: the archive
    fills, novelty turns on, and zeta holds the eval episode's frames."""
    kw = dict(batch_size=8, learning_rate=0.05, noise_std=0.05, zeta_size=4,
              max_strategy_history_size=4, random_seed=5, noise_backend="pallas")
    jenv = JaxProcMazeEnv(**ENV)
    jtr = JaxTrainer(JaxImpala(jenv.obs_shape, 5, **MODEL), jenv, jax_distances.categorical_tvd,
                     JaxTrainConfig(**kw))
    draws = {}
    penv = ProcMazeEnv(**ENV, device=CPU)
    ptr = VectorizedTrainer(
        ImpalaPolicy(penv.obs_shape, 5, device=CPU, **MODEL), penv, distances.categorical_tvd,
        TrainConfig(**kw), device=CPU, draw_source=lambda epoch: draws[epoch],
    )
    ptr.state = train_state_from_numpy(jax_state_numpy(jtr.state), CPU)
    assert ptr.state.zeta.shape == (4, 3, 32, 32)
    run_and_compare(jtr, ptr, draws, 3, monkeypatch)
    assert ptr.reporter.history[-1]["Noisy Novelty"] > 0


def test_trainer_own_draws_include_the_levels():
    """Without injected draws the trainer draws each episode's level from
    its own generator; the zeta seed buffer resets through drawn levels."""
    env = ProcMazeEnv(**ENV, device=CPU)
    cfg = TrainConfig(batch_size=4, zeta_size=3, max_strategy_history_size=2, random_seed=1,
                      noise_backend="pallas")
    tr = VectorizedTrainer(ImpalaPolicy(env.obs_shape, 5, device=CPU, **MODEL), env,
                           distances.categorical_tvd, cfg, device=CPU)
    draws = tr.draw_source(0)
    assert draws.reset_level.shape == (5, 1) and draws.reset_level.dtype == torch.int64
    assert int(draws.reset_level.min()) >= 0 and int(draws.reset_level.max()) < env.num_levels
    tr.train(2)
    assert all(np.isfinite(r["Update Magnitude"]) and r["Update Magnitude"] > 0
               for r in tr.reporter.history)


def test_bf16_trainer_matches_jax_epoch_by_epoch(monkeypatch):
    """``compute_dtype`` bf16 (the production model's), three epochs of
    ``train(1)`` at the parity size.  Both packages round the same float32
    conv and fc operands to bf16 and accumulate in float32, but a float32
    intermediate one ulp apart (sums in another order) can round to the
    neighbouring bf16 value, so a probability can differ by ~1e-3 of itself.
    The sampled actions, and with them the rewards, the update, ``flat`` and
    zeta, still agree exactly at seed 5: no Gumbel draw of these three epochs
    brings two actions within that margin.  The metrics read from the
    probabilities (entropies and novelties) are held to rtol 1e-3; the
    largest deviation there is 1.3e-4, in ``Noisy Novelty``."""
    kw = dict(batch_size=8, learning_rate=0.05, noise_std=0.05, zeta_size=4,
              max_strategy_history_size=4, random_seed=5, noise_backend="pallas")
    jenv = JaxProcMazeEnv(**ENV)
    jtr = JaxTrainer(JaxImpala(jenv.obs_shape, 5, compute_dtype=jnp.bfloat16, **MODEL), jenv,
                     jax_distances.categorical_tvd, JaxTrainConfig(**kw))
    draws = {}
    penv = ProcMazeEnv(**ENV, device=CPU)
    ptr = VectorizedTrainer(
        ImpalaPolicy(penv.obs_shape, 5, compute_dtype=torch.bfloat16, device=CPU, **MODEL), penv,
        distances.categorical_tvd, TrainConfig(**kw), device=CPU,
        draw_source=lambda epoch: draws[epoch],
    )
    ptr.state = train_state_from_numpy(jax_state_numpy(jtr.state), CPU)
    run_and_compare(jtr, ptr, draws, 3, monkeypatch,
                    loose=("Policy Entropy", "Policy Novelty", "Noisy Novelty"), loose_rtol=1e-3)
    assert ptr.reporter.history[-1]["Noisy Novelty"] > 0


def test_trainer_on_the_jax_noise_backend_matches_jax(monkeypatch):
    """The flagship's own ``bench.py`` backend, ``noise_backend="jax"``, with
    E = 2 episodes a member (each member's episodes are two frames of its
    torso calls) and chunks of P/2: three epochs of ``train(1)`` at the
    parity size."""
    kw = dict(batch_size=8, learning_rate=0.05, noise_std=0.05, zeta_size=4,
              max_strategy_history_size=4, random_seed=5, envs_per_perturbation=2,
              population_chunk=4)
    jenv = JaxProcMazeEnv(**ENV)
    jtr = JaxTrainer(JaxImpala(jenv.obs_shape, 5, **MODEL), jenv, jax_distances.categorical_tvd,
                     JaxTrainConfig(**kw))
    draws = {}
    penv = ProcMazeEnv(**ENV, device=CPU)
    ptr = VectorizedTrainer(
        ImpalaPolicy(penv.obs_shape, 5, device=CPU, **MODEL), penv, distances.categorical_tvd,
        TrainConfig(**kw), device=CPU, draw_source=lambda epoch: draws[epoch],
    )
    ptr.state = train_state_from_numpy(jax_state_numpy(jtr.state), CPU)
    run_and_compare(jtr, ptr, draws, 3, monkeypatch)
    assert ptr.reporter.history[-1]["Noisy Novelty"] > 0
