"""Command-line entry points, the counterpart of ``python -m dfd_tpu``:

    python -m dfd_tpu_torch train --env SimpleTrapEnv-v0 --epochs 200 --batch-size 256
    python -m dfd_tpu_torch train --topology sequential --env SimpleTrapEnv-v0 --epochs 50
    python -m dfd_tpu_torch server --env SimpleTrapEnv-v0 --port 1025
    python -m dfd_tpu_torch client --address learner-host --port 1025 [--mode thin|fat|slice]
    python -m dfd_tpu_torch sweep --env SimpleTrapEnv-v0 --trials 10 --epochs 30
    python -m dfd_tpu_torch bench
    torchrun --nproc-per-node 4 -m dfd_tpu_torch train --mesh --env SimpleTrapEnv-v0

The subcommands and flags are the JAX package's, plus ``--device``: the
port trains on the card (``cuda``) unless ``--device cpu`` is given, and
fails without a card rather than falling back.  ``train`` runs the
vectorized trainer (the default) or the sequential topology, one episode at
a time on the host.  ``server`` runs the elastic learner and ``client`` its
workers over gRPC; the wire is the JAX package's, so port and JAX processes
serve each other.  ``--mesh`` (``train`` and ``client --mode slice``) shards
the population over the ranks of a ``torch.distributed`` process group,
one process per card, which it joins from torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) where they
are set, else runs as a mesh of one; NCCL joins the cards, gloo the CPU
(``--device cpu``).  ``bench`` runs the throughput benchmark's six cells
(``dfd_tpu_torch/bench.py``; its weak-scaling mesh harness is ``python -m
dfd_tpu_torch.bench --mesh N``).
"""

from __future__ import annotations

import argparse
import sys


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--env", default="SimpleTrapEnv-v0")
    p.add_argument("--wandb-project", default=None, help="log epochs to wandb when installed")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--noise-std", type=float, default=0.02)
    p.add_argument("--batch-size", type=int, default=40)
    p.add_argument("--zeta-size", type=int, default=64)
    p.add_argument("--history-size", type=int, default=64)
    p.add_argument("--normalize-obs", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu); no fallback to the CPU")


def _device(args):
    """The resolved ``--device``, or None after printing why there is none."""
    from dfd_tpu_torch.core.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return None


def _mesh(device):
    """The population mesh of this process on ``device`` (``cuda`` for the
    card ``cuda:{LOCAL_RANK}``): a process group joined from torchrun's
    variables where they are set, else a mesh of one."""
    import os

    from dfd_tpu_torch.parallel import initialize_multihost, make_pop_mesh

    env = os.environ
    if int(env.get("WORLD_SIZE", "1")) > 1:
        initialize_multihost(f"{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}",
                             int(env["WORLD_SIZE"]), int(env["RANK"]), device=device.type)
    return make_pop_mesh(None if str(device) == "cuda" else device)


def _leave(mesh) -> None:
    """Leave the process group ``_mesh`` joined, if it joined one."""
    import torch.distributed as dist

    if mesh is not None and mesh.size > 1:
        dist.barrier(group=mesh.group)
        dist.destroy_process_group()


def _train_profiled(train_fn, epochs: int, args) -> None:
    """Run ``train_fn(n)`` across ``epochs``, tracing ``--profile-epochs``
    of them into ``--profile-dir`` (torch.profiler, a Chrome trace).  One
    warmup epoch runs untraced first so the trace shows steady-state device
    work, not the first call's kernel builds."""
    if not args.profile_dir:
        train_fn(epochs)
        return
    from dfd_tpu_torch.utils.profiling import trace

    warm = min(1, max(epochs - 1, 0))
    prof = max(min(args.profile_epochs, epochs - warm), 0)
    if warm:
        train_fn(warm)
    if prof:
        with trace(args.profile_dir):
            train_fn(prof)
        print(f"profile: traced {prof} epoch(s) into {args.profile_dir}")
    rest = epochs - warm - prof
    if rest > 0:
        train_fn(rest)


def cmd_train(args) -> int:
    from dfd_tpu_torch.config import TrainConfig
    from dfd_tpu_torch.utils.metrics import make_reporter

    if args.playback_id and args.topology != "sequential":
        print(
            "error: --playback-id requires --topology sequential (device "
            "rollouts have no per-episode host action stream)",
            file=sys.stderr,
        )
        return 2
    if args.antithetic and args.topology != "vectorized":
        print(
            "error: --antithetic requires --topology vectorized (the host "
            "sequential loop reproduces the reference's one-sided scheme)",
            file=sys.stderr,
        )
        return 2
    device = _device(args)
    if device is None:
        return 2

    if args.topology == "vectorized":
        from dfd_tpu_torch.runners import VectorizedTrainer
        from dfd_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
        from dfd_tpu_torch.utils.factory import get_vectorized_init_data

        mesh = _mesh(device) if args.mesh else None
        if mesh is not None:
            device = mesh.device
        env, model, distance_fn = get_vectorized_init_data(args.env, device)
        cfg = TrainConfig(
            env_id=args.env,
            learning_rate=args.lr,
            noise_std=args.noise_std,
            batch_size=args.batch_size,
            zeta_size=args.zeta_size,
            max_strategy_history_size=args.history_size,
            random_seed=args.seed,
            normalize_obs=args.normalize_obs,
            noise_backend=args.noise_backend,
            scan_unroll=args.unroll,
            population_chunk=args.population_chunk,
            antithetic=args.antithetic,
        )
        trainer = VectorizedTrainer(
            model, env, distance_fn, cfg, mesh=mesh, device=device,
            # one rank logs
            reporter=make_reporter(args.wandb_project if mesh is None or mesh.rank == 0 else None,
                                   wandb_group=args.env, quiet=args.quiet),
        )
        if args.resume:
            load_checkpoint(args.resume, trainer)
        if args.fast:
            _train_profiled(
                lambda n: trainer.train_fast(n, sync_every=args.sync_every),
                args.epochs, args,
            )
        else:
            _train_profiled(trainer.train, args.epochs, args)
        if args.checkpoint and trainer.mesh.rank == 0:
            # every rank holds the same state: rank 0 alone writes it
            save_checkpoint(args.checkpoint, trainer)
        _leave(mesh)
        last = trainer.reporter.history[-1] if trainer.reporter.history else {}
        print({k: last.get(k) for k in ("Epoch", "Policy Reward", "Noisy Reward")})
        return 0

    from dfd_tpu_torch.runners import SequentialRunner
    from dfd_tpu_torch.utils.factory import get_init_data

    env, model, distance_fn = get_init_data(args.env, args.seed, device)
    if args.playback_id:
        from dfd_tpu_torch.envs.wrappers import ActionPlaybackRecorder

        env = ActionPlaybackRecorder(
            env, opt_id=args.playback_id, episode_length=args.playback_episode_length
        )
    runner = SequentialRunner(
        model,
        env,
        distance_fn,
        learning_rate=args.lr,
        noise_std=args.noise_std,
        batch_size=args.batch_size,
        random_seed=args.seed,
        zeta_size=args.zeta_size,
        max_strategy_history_size=args.history_size,
        normalize_obs=args.normalize_obs,
        reporter=make_reporter(args.wandb_project, wandb_group=args.env, quiet=args.quiet),
    )
    _train_profiled(runner.train, args.epochs, args)
    return 0


def cmd_server(args) -> int:
    from dfd_tpu_torch.runners.server import ServerRunner
    from dfd_tpu_torch.utils.metrics import make_reporter

    device = _device(args)
    if device is None:
        return 2
    ServerRunner(
        reporter=make_reporter(args.wandb_project, wandb_group=args.env),
        env_id=args.env,
        learning_rate=args.lr,
        noise_std=args.noise_std,
        batch_size=args.batch_size,
        random_seed=args.seed,
        zeta_size=args.zeta_size,
        max_strategy_history_size=args.history_size,
        normalize_obs=args.normalize_obs,
        address=args.address,
        port=args.port,
        timestep_limit=args.timestep_limit,
        device=device,
    ).train()
    return 0


def cmd_client(args) -> int:
    device = _device(args)
    if device is None:
        return 2
    if args.mode == "fat":
        from dfd_tpu_torch.runners.fat_client import FatClientRunner

        ok = FatClientRunner(
            n_envs=args.n_envs, address=args.address, port=args.port,
            pipeline_lanes=args.pipeline_lanes, env_backend=args.env_backend, device=device,
        ).run(max_windows=args.max_windows)
    elif args.mode == "slice":
        from dfd_tpu_torch.runners.slice_client import SliceClientRunner

        mesh = _mesh(device) if args.mesh else None
        ok = SliceClientRunner(
            n_members=args.n_envs, address=args.address, port=args.port, mesh=mesh,
            population_chunk=args.population_chunk, device=device,
        ).run(max_windows=args.max_windows)
        _leave(mesh)
    else:
        from dfd_tpu_torch.runners.client import ClientRunner

        ok = ClientRunner(address=args.address, port=args.port, device=device).run()
    return 0 if ok else 1


def cmd_sweep(args) -> int:
    from dfd_tpu_torch.config import TrainConfig
    from dfd_tpu_torch.runners import VectorizedTrainer
    from dfd_tpu_torch.utils.factory import get_vectorized_init_data
    from dfd_tpu_torch.utils.metrics import EpochReporter
    from dfd_tpu_torch.utils.sweep import random_search

    device = _device(args)
    if device is None:
        return 2

    def make_trainer(params, reporter):
        env, model, distance_fn = get_vectorized_init_data(args.env, device)
        cfg = TrainConfig(
            env_id=args.env,
            learning_rate=params["learning_rate"],
            noise_std=params["noise_std"],
            batch_size=int(params["batch_size"]),
            zeta_size=args.zeta_size,
            max_strategy_history_size=args.history_size,
            random_seed=args.seed,
        )
        return VectorizedTrainer(model, env, distance_fn, cfg, device=device, reporter=reporter)

    if args.wandb:
        # delegate the search to a wandb random-search agent (the
        # reference's sweep entry, run_server.py:245-281)
        from dfd_tpu_torch.utils.sweep import wandb_sweep

        sweep_id = wandb_sweep(
            lambda wandb_run=None, **params: make_trainer(
                params, EpochReporter(wandb_run=wandb_run, quiet=True)),
            sweep_id=args.sweep_id,
            project=args.wandb_project or "dfd-tpu-sweep",
            count=args.trials, train_epochs=args.epochs,
        )
        print("sweep:", sweep_id)
        return 0

    def run_trial(params):
        trainer = make_trainer(params, EpochReporter(quiet=True))
        trainer.train_fast(args.epochs)
        return trainer.reporter.history

    result = random_search(run_trial, n_trials=args.trials, seed=args.seed)
    print("best:", result.best.params, "score:", result.best.score)
    return 0


def cmd_bench(args) -> int:
    from dfd_tpu_torch import bench

    device = _device(args)
    if device is None:
        return 2
    bench.main(device=device)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="dfd_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train a policy")
    _add_common(p)
    p.add_argument("--topology", choices=["vectorized", "sequential"], default="vectorized")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--fast", action="store_true", help="chunked dispatch (no per-epoch host sync)")
    p.add_argument("--sync-every", type=int, default=10)
    p.add_argument("--mesh", action="store_true",
                   help="shard the population over the ranks of a process group (torchrun's), "
                        "one process per device")
    p.add_argument("--noise-backend", choices=["jax", "pallas"], default="jax",
                   help="jax: normal_kernel's threefry normals; pallas: the perturb and "
                        "combine kernels' counter-hash noise")
    p.add_argument("--antithetic", action="store_true",
                   help="mirrored +-sigma*eps perturbation pairs (even batch size)")
    p.add_argument("--unroll", type=int, default=1,
                   help="rollout scan unroll factor (TrainConfig.scan_unroll; the port does "
                        "not read it)")
    p.add_argument("--population-chunk", type=int, default=None,
                   help="microbatch the population to bound memory")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--playback-id", default=None,
                   help="record complete episodes' action sequences to "
                        "data/custom_novelty_playbacks/in_progress/<id>.txt "
                        "(sequential topology only; reference trap-env dump format)")
    p.add_argument("--playback-episode-length", type=int, default=None,
                   help="complete-episode length for --playback-id (default: "
                        "derived from the env, 200 for the trap env)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace (trace.json) of "
                        "--profile-epochs steady-state epochs")
    p.add_argument("--profile-epochs", type=int, default=3,
                   help="epochs to trace into --profile-dir (after 1 warmup epoch)")
    p.add_argument("--quiet", action="store_true")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("server", help="elastic distributed learner")
    _add_common(p)
    p.add_argument("--address", default="localhost")
    p.add_argument("--port", type=int, default=1025)
    p.add_argument("--timestep-limit", type=int, default=50_000_000)
    p.set_defaults(fn=cmd_server)

    p = sub.add_parser("client", help="elastic worker")
    p.add_argument("--address", default="localhost")
    p.add_argument("--port", type=int, default=1025)
    p.add_argument("--mode", choices=["thin", "fat", "slice"], default="thin",
                   help="thin: one host env per process (reference run_client); "
                        "fat: N host envs + device-batched forwards; "
                        "slice: device-evaluated population shards (needs a "
                        "counter-noise server)")
    p.add_argument("--n-envs", type=int, default=64,
                   help="envs per window (fat) / members per shard (slice)")
    p.add_argument("--max-windows", type=int, default=None,
                   help="stop after N collection windows (default: run forever)")
    p.add_argument("--mesh", action="store_true",
                   help="slice mode: shard members over the ranks of a process group "
                        "(torchrun's), one process per device")
    p.add_argument("--population-chunk", type=int, default=None,
                   help="slice mode: evaluate the shard in memory-bounded "
                        "chunks of this many members (production-width models)")
    p.add_argument("--pipeline-lanes", type=int, default=1,
                   help="fat mode: split envs into this many lanes and "
                        "overlap device forwards with host env stepping")
    p.add_argument("--env-backend", choices=["auto", "serial", "thread"],
                   default="auto",
                   help="fat mode host-env backend: thread-pool C-engine "
                        "envs, serial python loop, or auto (probe one step's "
                        "cost and apply the crossover)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, or cpu); no fallback to the CPU")
    p.set_defaults(fn=cmd_client)

    p = sub.add_parser("sweep", help="random hyperparameter search")
    _add_common(p)
    p.add_argument("--trials", type=int, default=10)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--wandb", action="store_true",
                   help="delegate to a wandb sweep agent instead of the local search")
    p.add_argument("--sweep-id", default=None,
                   help="join an existing wandb sweep instead of creating one")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("bench", help="throughput benchmark: bench.py's six cells")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, or cpu); no fallback to the CPU")
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
