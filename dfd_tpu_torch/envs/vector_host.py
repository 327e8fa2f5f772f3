"""Vector-env backends for the batched host evaluator, the port of
``dfd_tpu.envs.vector_host``.

Anything exposing ``n_envs``, ``reset_all() -> obs[N]`` and
``step(actions[N]) -> (obs[N], rew[N], done[N])`` (numpy) can drive
:class:`dfd_tpu_torch.runners.host_evaluator.BatchedHostEvaluator`:

- :class:`PythonVectorEnv` — N independent gym-surface envs stepped in a
  Python loop (one call per env per step);
- :class:`ThreadPoolVectorEnv` — the same surface over a persistent worker
  pool: envs are sharded across threads, so envs whose ``step`` releases
  the GIL (C engines, ctypes calls) step concurrently;
- the native C++ pool (:mod:`dfd_tpu_torch.envs.native_pool`) for lockstep
  trap instances with one call per batch.

Finished episodes freeze (their obs and reward stop changing) until
``reset_all``; the evaluator's per-member alive mask does the accounting.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

import numpy as np

from dfd_tpu_torch.envs.wrappers import frame_of


class PythonVectorEnv:
    def __init__(self, make_env: Callable[[int], object], n_envs: int):
        self.envs: List[object] = [make_env(i) for i in range(n_envs)]
        self.n_envs = n_envs
        self._done = np.zeros(n_envs, bool)
        self._last_obs = None

    @staticmethod
    def _frame(obs) -> np.ndarray:
        # dict observations carry reward and done beside the frame; the
        # evaluator tracks those itself, so the vector surface is frames only
        return np.asarray(frame_of(obs))

    def reset_all(self) -> np.ndarray:
        obs = [self._frame(e.reset()) for e in self.envs]
        self._done[:] = False
        self._last_obs = np.stack(obs)
        return self._last_obs.copy()

    def _step_env(self, i: int, action, rews: np.ndarray, dones: np.ndarray) -> None:
        if self._done[i]:
            dones[i] = True
            return
        obs, rew, done, _ = self.envs[i].step(action)
        self._last_obs[i] = self._frame(obs)
        rews[i] = rew
        dones[i] = bool(done)
        self._done[i] = bool(done)

    def step(self, actions):
        rews = np.zeros(self.n_envs, np.float32)
        dones = self._done.copy()
        for i in range(self.n_envs):
            self._step_env(i, actions[i], rews, dones)
        return self._last_obs.copy(), rews, dones

    def close(self) -> None:
        for e in self.envs:
            if hasattr(e, "close"):
                e.close()


class ThreadPoolVectorEnv(PythonVectorEnv):
    """PythonVectorEnv stepped across a persistent thread pool.

    Envs are pre-sharded into ``n_workers`` contiguous index blocks; each
    ``step``/``reset_all`` issues one task per shard, and every worker
    writes disjoint rows of the shared output buffers.  Throughput scales
    with cores only when the env's ``step`` releases the GIL."""

    def __init__(self, make_env: Callable[[int], object], n_envs: int,
                 n_workers: Optional[int] = None):
        super().__init__(make_env, n_envs)
        self.n_workers = min(n_envs, n_workers or (os.cpu_count() or 1))
        self._pool = ThreadPoolExecutor(max_workers=self.n_workers, thread_name_prefix="dfd-env")
        self._shards = [s for s in np.array_split(np.arange(n_envs), self.n_workers) if len(s)]

    def reset_all(self) -> np.ndarray:
        if self._last_obs is None:
            return super().reset_all()  # the first reset learns the frame shape serially

        def reset_shard(idx):
            for i in idx:
                self._last_obs[i] = self._frame(self.envs[i].reset())

        list(self._pool.map(reset_shard, self._shards))
        self._done[:] = False
        return self._last_obs.copy()

    def step(self, actions):
        rews = np.zeros(self.n_envs, np.float32)
        dones = self._done.copy()

        def step_shard(idx):
            for i in idx:
                self._step_env(i, actions[i], rews, dones)

        list(self._pool.map(step_shard, self._shards))
        return self._last_obs.copy(), rews, dones

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        super().close()
