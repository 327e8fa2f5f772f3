"""Shared helpers for the tests that hold ``dfd_tpu_torch`` against ``dfd_tpu``.

Data crosses between the packages as numpy arrays.  The port takes its
randomness as :class:`dfd_tpu_torch.runners.EpochDraws`; these helpers
rebuild one epoch's draws from the JAX trainer's own key chain with
``jax.random`` itself, so both packages consume the same random numbers:

- ``split(state.key, 6)`` gives (next key, eps, roll, eval, tie, zeta)
  (``dfd_tpu/runners/vectorized.py:277``);
- member i rolls out under ``fold_in(roll, i)``, the eval slot under ``eval``;
  with E > 1 episodes a member (``envs_per_perturbation``), member i's
  episode j under ``split(fold_in(roll, i), E)[j]`` and every episode of the
  eval slot under ``eval`` itself (``vectorized.py:298-357``);
- each episode key splits into (reset, act, stats) (``fd/rollout.py:62``):
  the env's reset draws from ``reset`` (ProcMaze its level as
  ``randint(reset, (), 0, num_levels)``, ``envs/procmaze.py:117``; PixelGrid
  its agent and goal cells, ``envs/pixelgrid.py:50-55``; the trap env
  ignores it), which the port env's ``reset_draw`` computes from the key's
  words on the host; step t draws from ``fold_in(act, t)`` and
  ``fold_in(stats, t)``;
- ``jax.random.categorical(k, logits)`` is ``argmax(gumbel(k, (A,)) +
  logits)``, so the Gumbel draw reproduces JAX's sampled action; a Gaussian
  policy acts ``mean + std * normal(k, (A,))`` (``models/base.py:106-108``),
  so for a continuous env the draw is that normal.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dfd_tpu_torch.utils.closeness import bn_state_mismatch

torch.set_num_threads(1)  # the suite runs under xdist: one thread per worker


def _episode_draws(keys, T: int, A: int, discrete: bool = True):
    """(action noise [M, T, A]: Gumbel for a discrete env, else normal;
    stats uniform [M, T]; reset key words [M, 2])."""
    draw = jax.random.gumbel if discrete else jax.random.normal

    def one(k):
        reset, act, stats = jax.random.split(k, 3)
        ts = jnp.arange(T)
        g = jax.vmap(lambda t: draw(jax.random.fold_in(act, t), (A,), jnp.float32))(ts)
        u = jax.vmap(lambda t: jax.random.uniform(jax.random.fold_in(stats, t)))(ts)
        return g, u, jax.random.key_data(reset)

    return jax.vmap(one)(keys)


def episode_draws(keys, T: int, A: int, env):
    """(action noise [M, T, A], stats uniform [M, T], reset draw
    [M, *reset_shape]) of the episodes keyed by ``keys``, the resets those
    the port ``env`` computes from the reset keys; the noise Gumbel or
    normal as ``env`` is discrete or continuous."""
    g, u, reset = _episode_draws(keys, T, A, env.discrete)
    return np.array(g), np.array(u), env.reset_draw(np.array(reset))


def episode_keys(roll_key, eval_key, P: int, E: int):
    """Keys [P + 1, E] of every episode of an epoch, the eval slot last."""
    member_keys = jax.vmap(lambda i: jax.random.fold_in(roll_key, i))(jnp.arange(P))
    if E == 1:
        keys = member_keys[:, None]
    else:
        keys = jax.vmap(lambda k: jax.random.split(k, E))(member_keys)
    return jnp.concatenate([keys, jnp.repeat(eval_key[None, None], E, axis=1)])


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _epoch_draws(key, P: int, T: int, A: int, Z: int, E: int, discrete: bool):
    key, _eps, roll_key, eval_key, tie_key, zeta_key = jax.random.split(key, 6)
    keys = episode_keys(roll_key, eval_key, P, E).reshape(-1)
    g, u, reset = _episode_draws(keys, T, A, discrete)
    tie = jax.random.rademacher(tie_key, (P,), jnp.float32)
    perm = jax.random.permutation(zeta_key, Z)
    M = P + 1
    return (g.reshape(M, E, T, A), u.reshape(M, E, T), tie, perm, reset.reshape(M, E, 2))


def jax_epoch_draws(jax_trainer, env):
    """The port's EpochDraws for the JAX trainer's next epoch (CPU tensors),
    the resets computed by the port ``env`` from JAX's reset keys."""
    from dfd_tpu_torch.runners import EpochDraws

    st, jenv = jax_trainer.state, jax_trainer.env
    A = jenv.n_actions if jenv.discrete else jenv.action_dim
    *out, reset = _epoch_draws(st.key, jax_trainer.P, jax_trainer.horizon, A,
                               int(st.zeta.shape[0]), jax_trainer.cfg.envs_per_perturbation,
                               jenv.discrete)
    out.append(env.reset_draw(np.array(reset)))
    return EpochDraws(*(torch.from_numpy(np.array(x)) for x in out))


def jax_state_numpy(state):
    """A JAX TrainState as a dict of numpy trees (its key left out)."""
    return {
        f: jax.tree.map(np.asarray, getattr(state, f))
        for f in state._fields
        if f != "key"
    }


def jax_epoch_rewards(jtr):
    """Per-episode rewards of the JAX trainer's next epoch ([P + 1, E], the
    eval slot last), each episode rolled out as the JAX step rolls it out,
    on perturbed weights from its noise backend."""
    from dfd_tpu.core import welford as jax_welford
    from dfd_tpu.fd import rollout as jax_rollout
    from dfd_tpu.ops.perturb import pallas_perturb

    env, run = getattr(jtr, "_parity_rewards", (None, None))
    if env is not jtr.env:  # traced again after a set_env
        cfg, model, P = jtr.cfg, jtr.model, jtr.P
        E = cfg.envs_per_perturbation
        Z = int(jtr.state.zeta.shape[0])

        @jax.jit
        def run(st):
            _, _, roll_key, eval_key, _, _ = jax.random.split(st.key, 6)
            if cfg.noise_backend == "pallas":
                pop, _ = pallas_perturb(st.flat, cfg.noise_std, cfg.random_seed, st.epoch, P,
                                        antithetic=cfg.antithetic)
            else:
                eps = jax.vmap(lambda i: jtr.noise.generate(st.epoch, i))(jnp.arange(P))
                pop = st.flat[None, :] + cfg.noise_std * eps
            flats = jnp.repeat(jnp.concatenate([pop, st.flat[None]]), E, axis=0)
            keys = episode_keys(roll_key, eval_key, P, E).reshape(-1)
            det = jnp.repeat(jnp.arange(P + 1) == P, E)
            mean, std = jax_welford.jnp_mean_std(st.obs_stats)

            def one(v, k, d):
                return jax_rollout.episode_rollout(
                    model, jtr.env, model.set_flat(v, xp=jnp), st.bn_state, k, jtr.horizon,
                    deterministic=d, obs_mean=mean, obs_std=std,
                    normalize_obs=cfg.normalize_obs,
                    obs_stats_update_chance=cfg.obs_stats_update_chance,
                    collect_states=False, collect_limit=Z or None,
                ).reward

            return jax.vmap(one)(flats, keys, det).reshape(P + 1, E)

        jtr._parity_rewards = (jtr.env, run)  # one trace for every epoch on this env
    return np.asarray(run(jtr.state))


def port_rollout_rows(ptr, epoch: int):
    """The rows of [P + 1, E] that each of the port's ``episode_rollout``
    calls of ``epoch`` covers, in call order: chunk by chunk, the eval slot
    riding chunk 0 (zeta_size > 0), else alone on eval epochs (episode 0)."""
    P, C = ptr.P, ptr.chunk
    fused = ptr.cfg.zeta_size > 0
    calls = [(list(range(c0, c0 + C)) + ([P] if fused and c0 == 0 else []), ptr.E)
             for c0 in range(0, P, C)]
    if not fused and epoch % ptr.cfg.eval_every == 0:
        calls.append(([P], 1))
    return calls


def trap_map_text(grid: np.ndarray) -> str:
    """A trap grid in the reference's text format: "0" walkable, "1" not,
    rows ending in the reference's "0\\n" token (parsed unwalkable), the last
    row without a newline; it parses back to ``grid`` where the grid's last
    column is unwalkable on every row but the last, as the shipped map's is."""
    rows = [["0" if c else "1" for c in row] for row in grid]
    for row in rows[:-1]:
        row[-1] = "0"
    return "\n".join(" ".join(row) for row in rows)


def assert_bn_close(got, want, err_msg=""):
    """BatchNorm statistics ``got`` (the port's tensors) against ``want``
    (JAX's) under ``utils/closeness.py``'s rule at rtol 1e-5 (a mean over
    many positions summed in another order than XLA's)."""
    faults, _ = bn_state_mismatch(got, want)
    assert not faults, f"{err_msg}: {faults}"


METRICS = ("Policy Reward", "Policy Entropy", "Policy Novelty", "Noisy Reward",
           "Noisy Novelty", "Update Magnitude", "Omega", "Epoch", "Cumulative Timesteps")


def run_and_compare(jtr, ptr, draws, n_epochs, monkeypatch, loose=(), loose_rtol=1e-5,
                    reward_rtol=None, flat_rtol=1e-5, loose_atol=0.0):
    """``train(1)`` on both trainers ``n_epochs`` times, the port on JAX's
    draws; after every epoch the port's per-member rewards equal JAX's
    (within ``reward_rtol`` of the largest |reward| where it is given: a
    continuous env's float rewards; a categorical env's stay exact), and
    ``flat`` (to ``flat_rtol``), every reported metric (those in ``loose``
    to ``loose_rtol`` and ``loose_atol``: a number, or a dict of each
    metric's), the timestep count, the archive size, zeta (a
    continuous env's observations within ``reward_rtol`` of their largest)
    and ``bn_state`` agree."""
    from dfd_tpu_torch.fd import rollout as port_rollout

    seen = []
    inner = port_rollout.episode_rollout

    def spy(*a, **kw):
        seen.append(inner(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(port_rollout, "episode_rollout", spy)
    for e in range(n_epochs):
        epoch = int(jtr.state.epoch)
        draws[epoch] = jax_epoch_draws(jtr, ptr.env)
        want_rewards = jax_epoch_rewards(jtr)
        jtr.train(1)
        seen.clear()
        ptr.train(1)
        calls = port_rollout_rows(ptr, epoch)
        assert len(seen) == len(calls), f"epoch {e}: {len(seen)} rollouts"
        for res, (rows, episodes) in zip(seen, calls):
            got, want = res.reward.cpu().numpy(), want_rewards[rows, :episodes]
            if reward_rtol is None:
                np.testing.assert_array_equal(got, want, err_msg=f"epoch {e}")
            else:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=reward_rtol * np.abs(want).max(),
                                           err_msg=f"epoch {e}")
        np.testing.assert_allclose(ptr.state.flat.cpu().numpy(), np.asarray(jtr.state.flat),
                                   rtol=flat_rtol, atol=1e-6, err_msg=f"epoch {e}")
        jm, pm = jtr.reporter.history[-1], ptr.reporter.history[-1]
        for k in METRICS:
            np.testing.assert_allclose(pm[k], jm[k], rtol=loose_rtol if k in loose else 1e-5,
                                       atol=(loose_atol.get(k, 0.0) if isinstance(loose_atol, dict)
                                             else loose_atol) if k in loose else 0.0,
                                       err_msg=f"epoch {e}: {k}")
        assert ptr.cumulative_timesteps == jtr.cumulative_timesteps
        assert len(ptr.handler.archive) == len(jtr.handler.archive)
        zeta = np.asarray(jtr.state.zeta)
        zeta_atol = 0 if reward_rtol is None else reward_rtol * max(1.0, np.abs(zeta).max())
        np.testing.assert_allclose(ptr.state.zeta.cpu().numpy(), zeta, rtol=1e-6, atol=zeta_atol)
        assert_bn_close(ptr.state.bn_state, jtr.state.bn_state, f"epoch {e}: bn_state")


def jax_window_draws(sub_words, member_ids, T: int, env):
    """The port slice client's ``WindowDraws`` for the window whose sub-key
    words are ``sub_words``, rebuilt as the JAX slice client keys a window
    (``dfd_tpu/runners/slice_client.py:196-197``): member ``id`` under
    ``fold_in(sub, id)`` and the eval member, last, under
    ``fold_in(sub, 0xE7A1)``; each episode's draws as ``episode_draws``
    gives them."""
    from dfd_tpu_torch.runners.slice_client import EVAL_FOLD, WindowDraws

    sub = jax.random.wrap_key_data(jnp.asarray(np.asarray(sub_words, np.uint32)))
    ids = jnp.asarray(np.asarray(member_ids), jnp.int32)
    keys = jnp.concatenate([jax.vmap(lambda i: jax.random.fold_in(sub, i))(ids),
                            jax.random.fold_in(sub, jnp.uint32(EVAL_FOLD))[None]])
    A = env.n_actions if env.discrete else env.action_dim
    g, u, reset = episode_draws(keys, T, A, env)
    return WindowDraws(torch.from_numpy(g), torch.from_numpy(u), torch.as_tensor(reset))
