"""The port's deepmind-style Atari preprocessing
(``dfd_tpu_torch/envs/atari_wrappers.py``) on the CPU: the nine cases of
``tests/test_atari_wrappers.py`` on the port, then the port's wrappers and
JAX's stepped side by side on the same synthetic streams and seeds (frames,
rewards, dones, ``info`` and noop counts equal bit for bit), the whole
pipeline feeding the port's ``AtariCNN`` and JAX's with the same weights
(probabilities within rtol 1e-5), and the factory's ``NoFrameskip`` branch
with the synthetic env standing in for gymnasium.
"""

import numpy as np
import pytest
import torch

from dfd_tpu_torch.envs.atari_wrappers import (
    EpisodicLifeEnv,
    FireResetEnv,
    MaxAndSkipEnv,
    NoopResetEnv,
    ScaledClipStackEnv,
    WarpFrame,
    _action_meanings,
    area_resize_weights,
    wrap_deepmind_style,
)

CPU = "cpu"


class FakeAtari:
    """(210, 160, 3) uint8 frames whose red channel encodes the global step
    count, with lives/action-meaning hooks like a real ALE env (a copy of
    ``tests/test_atari_wrappers.py``'s)."""

    n_actions = 6

    def __init__(self, episode_len=1000, lives=3, meanings=None):
        self.episode_len = episode_len
        self.start_lives = lives
        self.meanings = meanings or ["NOOP", "FIRE", "UP", "DOWN", "LEFT", "RIGHT"]
        self.t = 0
        self.resets = 0
        self.actions = []
        self.lives = lives

    def get_action_meanings(self):
        return self.meanings

    def _frame(self):
        f = np.zeros((210, 160, 3), np.uint8)
        f[..., 0] = self.t % 256
        f[..., 1] = 7
        return f

    def reset(self):
        self.resets += 1
        self.t = 0
        self.lives = self.start_lives
        return self._frame()

    def step(self, action):
        self.t += 1
        self.actions.append(action)
        if action == 5 and self.lives > 0:  # RIGHT costs a life (test hook)
            self.lives -= 1
        done = self.t >= self.episode_len or self.lives == 0
        return self._frame(), float(self.t), done, {"lives": self.lives}


class NoisyAtari(FakeAtari):
    """FakeAtari with seeded random frames and signed rewards, so the warp,
    the max, the clip and the stack see every value."""

    def __init__(self, seed, **kw):
        super().__init__(**kw)
        self.rng = np.random.default_rng(seed)

    def _frame(self):
        return self.rng.integers(0, 256, (210, 160, 3), dtype=np.uint8)

    def step(self, action):
        obs, _, done, info = super().step(action)
        return obs, float(self.rng.integers(-3, 4)), done, info


# -- tests/test_atari_wrappers.py's cases on the port -------------------------------------


def test_area_resize_weights_match_bruteforce():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (210, 160)).astype(np.float32)
    wh, ww = area_resize_weights(210, 84), area_resize_weights(160, 84)
    np.testing.assert_allclose(wh.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(ww.sum(axis=1), 1.0, atol=1e-6)
    got = wh @ img @ ww.T
    ry, rx = 210 / 84, 160 / 84
    for j, i in [(0, 0), (41, 37), (83, 83), (10, 80)]:
        ylo, yhi, xlo, xhi = j * ry, (j + 1) * ry, i * rx, (i + 1) * rx
        acc = w = 0.0
        for y in range(int(ylo), int(np.ceil(yhi))):
            for x in range(int(xlo), int(np.ceil(xhi))):
                wt = (min(yhi, y + 1) - max(ylo, y)) * (min(xhi, x + 1) - max(xlo, x))
                acc += wt * img[y, x]
                w += wt
        np.testing.assert_allclose(got[j, i], acc / w, rtol=1e-5)
    img2 = rng.uniform(0, 1, (8, 8)).astype(np.float32)
    w2 = area_resize_weights(8, 4)
    np.testing.assert_allclose(w2 @ img2 @ w2.T, img2.reshape(4, 2, 4, 2).mean(axis=(1, 3)),
                               rtol=1e-6)


def test_warp_frame_grayscale_and_shape():
    obs = WarpFrame(FakeAtari()).reset()
    assert obs.shape == (84, 84, 1)
    np.testing.assert_allclose(obs, 0.587 * 7, rtol=1e-5)


def test_noop_reset_takes_1_to_30_noops():
    raw = FakeAtari()
    env = NoopResetEnv(raw, noop_max=30, seed=3)
    counts = set()
    for _ in range(12):
        env.reset()
        assert raw.actions[-raw.t:] == [0] * raw.t if raw.t else True
        assert 1 <= raw.t <= 30
        counts.add(raw.t)
    assert len(counts) > 1


def test_max_and_skip_sums_rewards_and_maxes_last_two_frames():
    raw = FakeAtari()
    env = MaxAndSkipEnv(raw, skip=4)
    env.reset()
    obs, rew, done, _ = env.step(2)
    assert rew == 1.0 + 2.0 + 3.0 + 4.0
    assert obs[0, 0, 0] == 4
    assert raw.t == 4


def test_episodic_life_ends_episode_without_resetting_game():
    raw = FakeAtari(lives=2)
    env = EpisodicLifeEnv(raw)
    env.reset()
    _, _, done, info = env.step(5)
    assert done and info["lives"] == 1
    before = raw.resets
    env.reset()  # life-loss reset: no real env reset, one no-op step
    assert raw.resets == before
    _, _, done, _ = env.step(5)
    assert done
    env.reset()
    assert raw.resets == before + 1


def test_fire_reset_presses_fire():
    raw = FakeAtari()
    FireResetEnv(raw, fire_action=1).reset()
    assert raw.actions[-1] == 1


def test_scaled_clip_stack_semantics():
    env = ScaledClipStackEnv(WarpFrame(FakeAtari()), n_stack=4, clip_rewards=True)
    obs = env.reset()
    assert obs.shape == (84, 84, 4) and obs.dtype == np.float32
    assert np.ptp(obs[0, 0]) == 0
    obs, rew, done, info = env.step(2)
    assert rew == 1.0 and info["raw_reward"] == 1.0
    obs2, *_ = env.step(2)
    assert obs2[0, 0, 3] > obs2[0, 0, 0]
    assert 0.0 <= obs2.min() and obs2.max() <= 1.0


def test_wrap_deepmind_style_full_pipeline_into_atari_cnn():
    """The composed pipeline emits (84, 84, 4) in [0, 1] that the port's
    AtariCNN consumes channels-last, on the CPU."""
    from dfd_tpu_torch.models import AtariCNN

    env = wrap_deepmind_style(FakeAtari(), seed=0)
    assert env.obs_shape == (84, 84, 4) and env.n_actions == 6
    env.reset()
    obs, rew, done, _ = env.step(3)
    assert obs.shape == (84, 84, 4) and 0.0 <= obs.min() and obs.max() <= 1.0
    assert rew == 1.0
    model = AtariCNN((84, 84), env.n_actions, device=CPU)
    params, state = model.init(0)
    one = model.set_flat(model.get_flat(params)[None])
    probs = model.apply(one, state, torch.from_numpy(obs))
    assert probs.shape == (1, 1, 6)
    np.testing.assert_allclose(float(probs.sum()), 1.0, rtol=1e-5)
    a = model.act(one, state, torch.from_numpy(obs), torch.zeros(6), deterministic=True)
    assert 0 <= int(a[0]) < 6


def _fake_gymnasium(monkeypatch, make):
    """The factory's gymnasium adapter replaced by ``make(env_id, seed)``."""
    monkeypatch.setattr("dfd_tpu_torch.envs.gym_adapter.GymnasiumEnv",
                        lambda env_id, seed=0: make(env_id, seed))
    monkeypatch.setattr("dfd_tpu_torch.envs.gym_adapter.gymnasium_available", lambda: True)


def test_factory_noframeskip_branch_builds_the_pipeline(monkeypatch):
    """The factory's NoFrameskip branch: the wrapped env and a matching
    AtariCNN on the device asked for, without ALE."""
    from dfd_tpu_torch.models import AtariCNN
    from dfd_tpu_torch.utils import factory

    _fake_gymnasium(monkeypatch, lambda env_id, seed: FakeAtari())
    env, model, distance_fn = factory.get_init_data("PongNoFrameskip-v4", 0, CPU)
    assert env.obs_shape == (84, 84, 4)
    assert isinstance(model, AtariCNN) and model.input_shape == (4, 84, 84)
    assert model.device == torch.device(CPU) and distance_fn.__name__ == "categorical_tvd"
    obs = env.reset()
    params, state = model.init(0)
    assert tuple(model.apply(model.set_flat(model.get_flat(params)[None]), state,
                             torch.from_numpy(obs)).shape) == (1, 1, 6)


# -- the port against JAX's wrappers ------------------------------------------------------


def _pipelines(seed, **kw):
    """(the port's pipeline, JAX's, their raw envs) over two NoisyAtari
    streams of ``seed``."""
    from dfd_tpu.envs import atari_wrappers as jaw

    raws = NoisyAtari(seed, **kw), NoisyAtari(seed, **kw)
    return (wrap_deepmind_style(raws[0], seed=seed), jaw.wrap_deepmind_style(raws[1], seed=seed),
            *raws)


def _same_step(a, b):
    (oa, ra, da, ia), (ob, rb, db, ib) = a, b
    np.testing.assert_array_equal(oa, ob)
    assert (ra, da, ia) == (rb, db, ib)


@pytest.mark.parametrize("seed", [0, 5])
def test_pipeline_steps_equal_jax_bit_for_bit(seed):
    """wrap_deepmind_style of each package over the same random streams: 60
    steps of a fixed action sequence with lives lost, game overs and the
    episodic-life resets; frames, clipped rewards, dones, info and the raw
    env's action stream (noop counts, FIRE presses) equal."""
    mine, theirs, raw_m, raw_t = _pipelines(seed, episode_len=90, lives=3)
    np.testing.assert_array_equal(mine.reset(), theirs.reset())
    acts = np.random.default_rng(seed + 100).integers(0, 6, 60)
    for t, a in enumerate(acts):
        a = int(a)
        step_m, step_t = mine.step(a), theirs.step(a)
        _same_step(step_m, step_t)
        if step_m[2]:
            np.testing.assert_array_equal(mine.reset(), theirs.reset(), err_msg=f"step {t}")
    assert raw_m.actions == raw_t.actions and raw_m.resets == raw_t.resets
    assert raw_m.resets > 1 and 1 in raw_m.actions  # game overs and FIRE presses ran


@pytest.mark.parametrize("make", ["warp", "noop", "skip", "life", "fire", "stack"])
def test_each_wrapper_equals_jax(make):
    """Each wrapper alone over the same stream: equal steps and resets."""
    from dfd_tpu.envs import atari_wrappers as jaw

    def build(mod, seed=3):
        raw = NoisyAtari(seed, lives=2, episode_len=40)
        return {
            "warp": lambda: mod.WarpFrame(raw, size=42),
            "noop": lambda: mod.NoopResetEnv(raw, noop_max=7, seed=seed),
            "skip": lambda: mod.MaxAndSkipEnv(raw, skip=3),
            "life": lambda: mod.EpisodicLifeEnv(raw),
            "fire": lambda: mod.FireResetEnv(raw, fire_action=1),
            "stack": lambda: mod.ScaledClipStackEnv(mod.WarpFrame(raw), n_stack=3),
        }[make](), raw

    from dfd_tpu_torch.envs import atari_wrappers as paw

    (mine, raw_m), (theirs, raw_t) = build(paw), build(jaw)
    for episode in range(3):
        np.testing.assert_array_equal(mine.reset(), theirs.reset())
        for a in (5, 2, 5, 0, 1, 3, 5, 4):
            step_m, step_t = mine.step(a), theirs.step(a)
            _same_step(step_m, step_t)
            if step_m[2]:
                break
    assert raw_m.actions == raw_t.actions and raw_m.resets == raw_t.resets
    assert _action_meanings(mine) == jaw._action_meanings(theirs)


def test_noop_counts_equal_jax():
    """NoopResetEnv's draws come from ``np.random.default_rng(seed)`` in
    both packages: the noop counts of 20 resets, and after a reseed."""
    from dfd_tpu.envs import atari_wrappers as jaw

    counts = []
    for mod in (None, jaw):
        raw = FakeAtari()
        env = NoopResetEnv(raw, seed=11) if mod is None else mod.NoopResetEnv(raw, seed=11)
        seen = []
        for k in range(20):
            if k == 10:
                env.seed(4)
            env.reset()
            seen.append(raw.t)
        counts.append(seen)
    assert counts[0] == counts[1] and len(set(counts[0])) > 3


def test_pipeline_into_atari_cnn_equals_jax():
    """Frames of the whole pipeline through the port's AtariCNN and JAX's,
    the weights carried across by ``convert``: probabilities within rtol
    1e-5, one frame and a batch of 8 (the stack channels-last in both)."""
    import jax.numpy as jnp

    from dfd_tpu.models.atari import AtariCNN as JAtariCNN
    from dfd_tpu_torch.convert import params_from_numpy
    from dfd_tpu_torch.models import AtariCNN

    mine, theirs, _, _ = _pipelines(2, episode_len=60)
    frames = [mine.reset()]
    theirs.reset()
    for a in (1, 2, 3, 4, 0, 2, 1):
        frames.append(mine.step(a)[0])
        theirs.step(a)
    frames = np.stack(frames)
    jm = JAtariCNN((84, 84), 6)
    pm = AtariCNN((84, 84), 6, device=CPU)
    params_np, bn_np = jm.init(4)
    params, bn = params_from_numpy(pm, params_np, bn_np, CPU)
    one = pm.set_flat(pm.get_flat(params)[None])
    want = np.asarray(jm.apply(params_np, bn_np, jnp.asarray(frames)))
    got = pm.apply(one, bn, torch.from_numpy(frames))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    want1 = np.asarray(jm.apply(params_np, bn_np, jnp.asarray(frames[3])))
    np.testing.assert_allclose(pm.apply(one, bn, torch.from_numpy(frames[3]))[0].numpy(), want1,
                               rtol=1e-5, atol=1e-7)


def test_factory_noframeskip_equals_jax(monkeypatch):
    """Both factories' NoFrameskip branch over the same synthetic stream:
    the same pipeline (equal first frames) and AtariCNN shapes."""
    import dfd_tpu.utils.factory as jfactory
    from dfd_tpu_torch.utils import factory

    _fake_gymnasium(monkeypatch, lambda env_id, seed: NoisyAtari(seed))
    monkeypatch.setattr("dfd_tpu.envs.gym_adapter.GymnasiumEnv",
                        lambda env_id, seed=0: NoisyAtari(seed))
    monkeypatch.setattr("dfd_tpu.envs.gym_adapter.gymnasium_available", lambda: True)
    env, model, _ = factory.get_init_data("ALE/Breakout-v5", 9, CPU)
    jenv, jmodel, _ = jfactory.get_init_data("ALE/Breakout-v5", 9)
    np.testing.assert_array_equal(env.reset(), jenv.reset())
    assert (model.input_shape, model.output_shape, model.num_params) == \
        (tuple(jmodel.input_shape), jmodel.output_shape, jmodel.num_params)
