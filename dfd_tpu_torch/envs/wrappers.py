"""Host env wrappers, copies of ``dfd_tpu.envs.wrappers``.

They wrap a host-surface env (``reset() -> obs``, ``step(a) -> (obs,
reward, done, info)``, such as :class:`dfd_tpu_torch.runners.HostEnv`) and
see numpy observations only.

:class:`ImpalaObsWrapper` is the reference ImpalaEnvWrapper's role
(reference utils/impala_env_wrapper.py:5-28): turn a pixel env's raw frames
into the dict observations the IMPALA policy consumes — the frame in CHW
float32 plus the *previous* step's reward and done flag (the wrapper returns
the current transition's reward/done alongside its observation, which the
policy sees on the next act call — same timing as the reference).
"""

from __future__ import annotations

import numpy as np


def frame_of(obs):
    """The plain frame array of an observation.

    Dict observations (recurrent/pixel wrappers) contribute their ``frame``
    entry; plain arrays pass through.  Zeta, the wire, and the vector-host
    surface carry frames only — the reference's own distributed path cannot
    serialize dict states (reference learner/fd_return.py:35 ravels
    ``eval_states`` into a repeated-float proto field)."""
    return obs["frame"] if isinstance(obs, dict) else obs


def _to_chw(frame: np.ndarray) -> np.ndarray:
    f = np.asarray(frame, np.float32)
    if f.ndim == 3 and f.shape[-1] in (1, 3, 4) and f.shape[0] not in (1, 3, 4):
        f = np.transpose(f, (2, 0, 1))  # HWC -> CHW
    return f


class ActionPlaybackRecorder:
    """Opt-in action-playback recording for host-surface envs — the
    reference trap env's offline behavior-inspection dump (reference
    custom_envs/simple_trap_env/environment.py:50-52, 63-75).

    On each ``reset()``, if the episode that just ended ran the full
    ``episode_length + 1`` steps (the reference env reports done on the
    201st step), one line is appended to ``{folder}/{opt_id}.txt``: the
    first ``episode_length`` actions, space-separated with a leading space
    — byte-identical to the reference's ``Environment.save``.  Shorter
    episodes are silently dropped, like the reference.

    ``episode_length`` defaults to the wrapped env's own length when it
    declares one (``episode_length``, or ``max_episode_steps - 1`` — the
    trap convention where done arrives one step past the nominal length),
    falling back to the reference trap env's 200.  Because incomplete
    episodes are dropped silently, a mismatched length would make recording
    a silent no-op; a one-time warning fires if nothing has been saved
    after many resets."""

    _WARN_AFTER_RESETS = 50

    def __init__(
        self,
        env,
        opt_id: str | None = None,
        episode_length: int | None = None,
        folder: str = "data/custom_novelty_playbacks/in_progress",
    ):
        import os

        self._env = env
        self.opt_id = opt_id if opt_id is not None else "fd_worker_{}".format(os.getpid())
        if episode_length is None:
            episode_length = getattr(env, "episode_length", None)
        if episode_length is None:
            declared = getattr(env, "max_episode_steps", None)
            episode_length = declared - 1 if declared else 200
        self.episode_length = int(episode_length)
        self.folder = folder
        self.action_record: list = []
        self._saved = 0
        self._resets = 0
        self._warned = False
        for attr in ("n_actions", "obs_shape", "action_space", "observation_space"):
            if hasattr(env, attr):
                setattr(self, attr, getattr(env, attr))

    def seed(self, seed):
        if hasattr(self._env, "seed"):
            self._env.seed(seed)

    def reset(self):
        if len(self.action_record) > 0:
            self._save()
        self.action_record = []
        self._resets += 1
        if (
            not self._warned
            and self._saved == 0
            and self._resets >= self._WARN_AFTER_RESETS
        ):
            self._warned = True
            import warnings

            warnings.warn(
                f"ActionPlaybackRecorder({self.opt_id}): no complete episode "
                f"saved after {self._resets} resets — episodes must run "
                f"exactly episode_length+1 = {self.episode_length + 1} steps "
                "to be recorded; pass episode_length= if the env's length "
                "differs",
                stacklevel=2,
            )
        return self._env.reset()

    def step(self, action):
        out = self._env.step(action)
        self.action_record.append(action)
        return out

    def _save(self) -> None:
        # the reference only keeps complete episodes (environment.py:64-65)
        if len(self.action_record) != self.episode_length + 1:
            return
        self._saved += 1
        import os

        os.makedirs(self.folder, exist_ok=True)
        with open(os.path.join(self.folder, f"{self.opt_id}.txt"), "a") as f:
            string = ""
            for arg in self.action_record[: self.episode_length]:
                string = "{} {}".format(string, arg)
            f.write(string)
            f.write("\n")

    def close(self):
        if hasattr(self._env, "close"):
            self._env.close()


class ImpalaObsWrapper:
    def __init__(self, env):
        self._env = env
        self.action_space = getattr(env, "action_space", None)
        self.observation_space = getattr(env, "observation_space", None)

    @property
    def n_actions(self):
        return getattr(self._env, "n_actions", None) or getattr(self.action_space, "n", None)

    def seed(self, seed):
        if hasattr(self._env, "seed"):
            self._env.seed(seed)

    def reset(self):
        obs = self._env.reset()
        return self._format(obs, 0.0, False)

    def step(self, action):
        obs, rew, done, info = self._env.step(action)
        return self._format(obs, rew, done), rew, done, info

    def _format(self, obs, rew, done):
        return {
            "frame": _to_chw(obs),
            "reward": np.float32(rew),
            "done": bool(done),
        }

    def close(self):
        if hasattr(self._env, "close"):
            self._env.close()
