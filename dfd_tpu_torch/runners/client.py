"""Elastic worker process (reference run_client.py:18-136), the counterpart
of ``dfd_tpu.runners.client.ClientRunner``: the thin client, one host env
and one episode at a time, its policy and env on ``device`` (the card
unless the caller passes ``"cpu"``).

Polls the server for a config (NEW_EXPERIMENT), builds env/policy/worker from
it, then loops: ~10 ms of rollouts -> submit returns -> poll state.  Applies
NEW_STATE broadcasts in place; on RPC failure retries for 60 x 1 s before
giving up; a NEW_EXPERIMENT mid-run reconfigures in place without a restart.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from dfd_tpu_torch.core.device import full_f32, resolve_device
from dfd_tpu_torch.core.noise import CounterNoise, CounterNoiseSampler, RNGNoiseSource
from dfd_tpu_torch.distributed.client import FDClient
from dfd_tpu_torch.novelty.handler import StrategyHandler
from dfd_tpu_torch.runners.agent import Agent
from dfd_tpu_torch.runners.policy import HostPolicy
from dfd_tpu_torch.runners.worker import Worker
from dfd_tpu_torch.utils.factory import get_init_data


class ClientRunner:
    def __init__(self, address: str = "localhost", port: int = 1025, collect_window_s: float = 0.01,
                 device=None):
        self.device = resolve_device(device)
        self.address = address
        self.port = port
        self.collect_window_s = collect_window_s
        self.client = FDClient()
        self.worker: Optional[Worker] = None
        self.policy: Optional[HostPolicy] = None
        self.env = None
        self.strategy_handler = None
        self.rng = None
        self._stop = False

    def request_stop(self) -> None:
        """Ask a running :meth:`run` loop (typically on another thread) to
        exit gracefully at its next iteration or reconnect poll."""
        self._stop = True

    @full_f32()
    def run(self, max_iterations: Optional[int] = None, reconnect_attempts: int = 60) -> bool:
        """Returns False if the server connection was permanently lost."""
        client = self.client
        client.connect(address=self.address, port=self.port)
        self.receive_config()

        self.policy.deserialize(client.current_state.policy_params)
        self.strategy_handler.add_policy(self.policy.get_trainable_flat())
        self.worker.update(client.current_state)

        iterations = 0
        while not self._stop and (max_iterations is None or iterations < max_iterations):
            iterations += 1
            returns = []
            t1 = time.time()
            while time.time() - t1 < self.collect_window_s:
                returns += self.worker.collect_returns()
            client.submit_returns(returns)

            status = client.get_server_state()
            if status == FDClient.NEW_STATE_FLAG:
                self.worker.update(client.current_state)
            elif status == FDClient.RPC_FAILED_FLAG:
                recovered = False
                for _ in range(reconnect_attempts):
                    if self._stop:
                        client.disconnect()
                        return True
                    time.sleep(1)
                    status = client.get_server_state()
                    if status != FDClient.RPC_FAILED_FLAG:
                        recovered = True
                        break
                if not recovered:
                    client.disconnect()
                    return False
                self.worker.update(client.current_state)
            if status == FDClient.NEW_EXPERIMENT_FLAG:
                self._configure(client.current_state.cfg)
                self.policy.deserialize(client.current_state.policy_params)
                self.strategy_handler.add_policy(self.policy.get_trainable_flat())
                self.worker.update(client.current_state)

        client.disconnect()
        return True

    def receive_config(self, poll_s: float = 0.2) -> None:
        status = self.client.get_server_state()
        while status != FDClient.NEW_EXPERIMENT_FLAG:
            time.sleep(poll_s)
            status = self.client.get_server_state()
        self._configure(self.client.current_state.cfg)

    def _configure(self, cfg: dict) -> None:
        env_id = cfg["env_id"]
        random_seed = int(cfg["random_seed"])
        self.rng = np.random.RandomState(random_seed)

        self.env, model, distance_fn = get_init_data(env_id, random_seed, self.device)
        self.policy = HostPolicy(model, seed=random_seed)
        if cfg.get("noise_kind") == "counter":
            # counter-mode server: share its base seed, mint unique member
            # ids from this client's (minted) seed
            antithetic = bool(cfg.get("antithetic", False))
            base = CounterNoise(
                model.num_params, random_seed=int(cfg["noise_seed"]), antithetic=antithetic,
                device=self.device,
            )
            offset = random_seed * 2654435761
            if antithetic:
                offset &= ~1  # even-align: consecutive samples form +-eps pairs
            noise_source = CounterNoiseSampler(base, id_offset=offset)
        else:
            noise_source = RNGNoiseSource(model.num_params, random_seed=random_seed)
        self.strategy_handler = StrategyHandler(
            model,
            self.policy.bn_state,
            distance_fn,
            max_history_size=int(cfg["max_strategy_history_size"]),
        )
        agent = Agent(
            self.policy,
            self.env,
            random_seed,
            normalize_obs=bool(cfg["normalize_obs"]),
            obs_stats_update_chance=float(cfg["obs_stats_update_chance"]),
        )
        self.worker = Worker(
            self.policy,
            agent,
            noise_source,
            self.strategy_handler,
            sigma=float(cfg["noise_std"]),
            random_seed=random_seed,
            eval_prob=float(cfg["eval_prob"]),
        )
