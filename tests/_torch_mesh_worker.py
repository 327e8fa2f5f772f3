"""One rank of a 2-process gloo group on the CPU, for the tests of the port's
population mesh (``tests/test_torch_parallel.py``):

    python tests/_torch_mesh_worker.py MODE RANK PORT OUT [ARGS_JSON]

MODE is ``combine`` (``shard_map_combine`` at D = 96, P = 16, sigma =
0.05, epoch 3), ``trainer`` (``VectorizedTrainer`` on a mesh for the
epochs and config in ARGS_JSON, from the initial state and draws pickled at
its ``inputs`` path) or ``slice`` (one slice-client window, rank 0 serving
it and rank 1 following).  Each rank writes its result to OUT (numpy or
pickle).  Imports the port only, never JAX.
"""

import json
import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)


def combine_inputs():
    """(D, P, sigma, epoch, fitness [P]) of the combine case."""
    D, P, sigma, epoch = 96, 16, 0.05, 3
    return D, P, sigma, epoch, np.sin(np.arange(P, dtype=np.float32))


SLICE_CFG = dict(noise_kind="counter", random_seed=7, noise_std=0.05, normalize_obs=True,
                 obs_stats_update_chance=0.5, max_strategy_history_size=4, noise_seed=123,
                 eval_prob=1.0, antithetic=False, env_id="SimpleTrapEnv-v0")


def slice_state():
    """A broadcast for the trap MLP: its init at seed 3, 4 random zeta
    frames, 2 random archived strategies, sampled obs stats."""
    from dfd_tpu_torch.core.welford import Welford
    from dfd_tpu_torch.fd.returns import FDState
    from dfd_tpu_torch.models import DiscreteMLP

    model = DiscreteMLP(2, 9, device="cpu")
    params, bn = model.init(3)
    rng = np.random.RandomState(0)
    stats = Welford((2,))
    for _ in range(6):
        stats.update(rng.rand(2))
    return FDState(policy_params=model.serialize(params, bn).numpy().tolist(),
                   strategy_frames=rng.rand(4, 2).astype(np.float32),
                   strategy_history=rng.rand(2, 4, 9).astype(np.float32),
                   obs_stats=stats.serialize(), epoch=2, experiment_id="e", cfg=None)


def main():
    mode, rank, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    args = json.loads(sys.argv[5]) if len(sys.argv) > 5 and sys.argv[5] else {}

    from dfd_tpu_torch.parallel import initialize_multihost, make_pop_mesh

    initialize_multihost(f"127.0.0.1:{port}", 2, rank, device="cpu")
    mesh = make_pop_mesh("cpu")
    assert (mesh.rank, mesh.size) == (rank, 2), mesh

    if mode == "combine":
        from dfd_tpu_torch.core.noise import CounterNoise
        from dfd_tpu_torch.parallel import shard_map_combine

        D, P, sigma, epoch, fitness = combine_inputs()
        noise = CounterNoise(D, random_seed=0, device="cpu")
        g = shard_map_combine(noise, mesh, epoch, range(P), torch.from_numpy(fitness), sigma)
        np.save(out, g.numpy())
    elif mode == "trainer":
        from dfd_tpu_torch.config import TrainConfig
        from dfd_tpu_torch.convert import train_state_from_numpy
        from dfd_tpu_torch.envs import TrapEnv
        from dfd_tpu_torch.models import DiscreteMLP
        from dfd_tpu_torch.ops import distances
        from dfd_tpu_torch.runners import EpochDraws, VectorizedTrainer
        from dfd_tpu_torch.utils.metrics import EpochReporter

        with open(args["inputs"], "rb") as f:
            inputs = pickle.load(f)
        draws = {e: EpochDraws(*(torch.from_numpy(x) for x in d))
                 for e, d in inputs["draws"].items()}
        tr = VectorizedTrainer(DiscreteMLP(2, 9, device="cpu"), TrapEnv(device="cpu"),
                               distances.categorical_tvd, TrainConfig(**args["cfg"]), mesh=mesh,
                               reporter=EpochReporter(quiet=True), device="cpu",
                               draw_source=draws.__getitem__)
        tr.state = train_state_from_numpy(inputs["state"], "cpu")
        mesh.timed = bool(args.get("timed"))
        tr.train(args["epochs"])
        hist = tr.reporter.history
        np.savez(out, flat=tr.state.flat.numpy(),
                 noisy=np.asarray([r["Noisy Reward"] for r in hist], np.float64),
                 policy=np.asarray([r["Policy Reward"] for r in hist], np.float64),
                 timesteps=np.int64(tr.cumulative_timesteps),
                 members=np.asarray(list(tr.members)),
                 seconds=np.asarray([mesh.wait_s, mesh.collective_s]))
    elif mode == "slice":
        from dfd_tpu_torch.runners.slice_client import SliceClientRunner

        r = SliceClientRunner(n_members=args["P"], population_chunk=args.get("chunk"),
                              mesh=mesh)
        if rank == 0:  # what run() does on rank 0 once the server answers
            r._configure(SLICE_CFG)
            r._apply_state(slice_state())
            r.windows = 1
            got = r._collect_window()
            r._broadcast(None)  # releases rank 1, as run() does on its way out
        else:  # rank 1 learns the cfg and state from rank 0's broadcast
            got = r._follow()
        with open(out, "wb") as f:
            pickle.dump(got, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
