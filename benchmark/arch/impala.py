"""Everything the harness needs of an IMPALA-on-ProcMaze configuration.

A configuration file with ``"arch": "impala"`` names this module.  It
builds the program's trainer (``dfd_tpu_torch``: ``ImpalaPolicy`` on
``ProcMazeEnv`` under ``VectorizedTrainer``), the plain reference's policy
and env (``benchmark/reference``), the inputs both sides share (the initial
weights and zeta, made on the device from the seed), and the operations and
bytes of the work, counted from the shapes.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from benchmark import peaks
from benchmark.reference import impala as plain
from benchmark.reference import procmaze


def frame_shape(cfg) -> tuple:
    side = cfg["grid"] * cfg["scale"]
    return (cfg["frame_channels"], side, side)


def train_seed(seed: int) -> int:
    """The trainer's ``random_seed`` (its noise keys) from the run's seed."""
    return seed % (1 << 32)


# -- the program ------------------------------------------------------------------------

def build_program(cfg, cell, seed: int, device, reporter, draw_source):
    """The program's trainer for the cell, its draws from ``draw_source``:
    one episode a member, the counter noise (``noise_backend="jax"``), the
    population in one piece, as the plain reference runs it."""
    from dfd_tpu_torch.config import OmegaConfig, TrainConfig
    from dfd_tpu_torch.envs import ProcMazeEnv
    from dfd_tpu_torch.models import ImpalaPolicy
    from dfd_tpu_torch.ops import distances
    from dfd_tpu_torch.runners import VectorizedTrainer

    env = ProcMazeEnv(grid=cfg["grid"], scale=cfg["scale"], channels=cfg["frame_channels"],
                      max_steps=cfg["max_episode_steps"], num_levels=cfg["num_levels"],
                      start_level=cfg["start_level"],
                      distribution_mode=cfg["distribution_mode"], intensity=cfg["intensity"],
                      device=device)
    dtype = {"float32": None, "bfloat16": torch.bfloat16}[cfg["compute_dtype"]]
    model = ImpalaPolicy(env.obs_shape, env.n_actions, use_lstm=True, compute_dtype=dtype,
                         conv_impl=cfg["conv_impl"], channels=tuple(cfg["channels"]),
                         hidden=cfg["hidden"], device=device)
    tcfg = TrainConfig(batch_size=cell["population"], envs_per_perturbation=1,
                       episode_length=cell["episode_length"], zeta_size=cell["zeta_size"],
                       max_strategy_history_size=cell["archive_size"],
                       eval_every=cell["eval_every"], learning_rate=cell["learning_rate"],
                       noise_std=cell["noise_std"], noise_backend="jax",
                       population_chunk=None, random_seed=train_seed(seed),
                       omega=OmegaConfig(**cell["omega"]), dsgd_min_scale=cell["dsgd_min_scale"],
                       dsgd_max_scale=cell["dsgd_max_scale"])
    return VectorizedTrainer(model, env, distances.categorical_tvd, tcfg, reporter=reporter,
                             device=device, draw_source=draw_source)


# -- the reference and the shared inputs --------------------------------------------------

def reference_policy(cfg, precision: str) -> plain.Policy:
    return plain.Policy(frame_shape(cfg), cfg["channels"], cfg["hidden"], cfg["n_actions"],
                        precision)


def reference_env(cfg, device) -> procmaze.Maze:
    return procmaze.Maze(cfg["grid"], cfg["scale"], cfg["frame_channels"], cfg["num_levels"],
                         cfg["start_level"], cfg["distribution_mode"], cfg["intensity"],
                         cfg["max_episode_steps"], device)


def control_precision(cfg) -> str:
    """The precision one step below the configuration's."""
    return {"float32": "tf32", "bfloat16": "fp8"}[cfg["compute_dtype"]]


def initial_inputs(cfg, cell, seed: int, device):
    """(theta0 [d], zeta0 [Z, C, H, W]): the initial weights, PyTorch's
    default draws from one generator on the device, and zeta's first frames,
    a random-action walk through one level."""
    policy = reference_policy(cfg, "f32")
    theta0 = plain.initial_theta(policy.layout, seed, device)
    env = reference_env(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    Z = cell["zeta_size"]
    level = torch.randint(0, cfg["num_levels"], (1,), generator=gen, device=device)
    actions = torch.randint(0, cfg["n_actions"], (Z,), generator=gen, device=device)
    state, obs = env.reset(level)
    frames = []
    for k in range(Z):
        frames.append(obs[0])
        state, obs, _, done = env.step(state, actions[k:k + 1])
        if bool(done[0]):
            state, obs = env.reset(level)
    return theta0, torch.stack(frames)


# -- operations and bytes --------------------------------------------------------------------

class Conv(NamedTuple):
    kind: str   # "feat" (BN, conv, max pool) or "res" (a stage's four convs)
    ci: int
    co: int
    H: int      # the conv's input rows and columns
    W: int
    fused: bool  # computed by the program's torso kernels


def convs(cfg) -> List[Conv]:
    """The torso's conv blocks with the program's routing: a feature block
    through ``fused_feat_pool`` where the frame's rows and columns are even,
    H * W a multiple of 128 and the input channels a multiple of 8, a
    stage's residual pair through ``fused_res_stage`` where H * W is a
    multiple of 128 (``conv_impl="fused_feat"``)."""
    c, h, w = frame_shape(cfg)
    out = []
    feat_ok = cfg["conv_impl"] == "fused_feat"
    res_ok = cfg["conv_impl"] in ("fused", "fused_feat")
    for ch in cfg["channels"]:
        out.append(Conv("feat", c, ch, h, w,
                        feat_ok and h * w % 128 == 0 and h % 2 == 0 and w % 2 == 0 and c % 8 == 0))
        h, w = (h + 1) // 2, (w + 1) // 2
        out.append(Conv("res", ch, ch, h, w, res_ok and h * w % 128 == 0))
        c = ch
    return out


def _conv_flops(conv: Conv) -> float:
    one = 2.0 * 9 * conv.ci * conv.co * conv.H * conv.W
    return one if conv.kind == "feat" else 4 * one


def frame_flops(cfg) -> float:
    """Multiply-adds x 2 of one frame's forward: the convs, the fc layer,
    the LSTM cell and the policy layer."""
    c, h, w = frame_shape(cfg)
    for _ in cfg["channels"]:
        h, w = (h + 1) // 2, (w + 1) // 2
    flat = cfg["channels"][-1] * h * w
    hid, A = cfg["hidden"], cfg["n_actions"]
    dense = 2.0 * (flat * hid + 4 * hid * (hid + 1) + 4 * hid * hid + hid * A)
    return sum(_conv_flops(conv) for conv in convs(cfg)) + dense


def torso_call_bound_s(cfg, members: int, frames: int) -> float:
    """The least seconds of one torso call's fused kernels over ``members``
    x ``frames`` frames: each kernel's larger of its convs' operations at
    the product rate and its bytes (input and output activations in
    float32 once, each member's float32 weights, bias and BN fold once) at
    the memory rate."""
    total = 0.0
    for conv in convs(cfg):
        if not conv.fused:
            continue
        n = members * frames
        if conv.kind == "feat":
            out_hw = ((conv.H + 1) // 2) * ((conv.W + 1) // 2)
            act = 4.0 * n * (conv.ci * conv.H * conv.W + conv.co * out_hw)
            weights = 4.0 * members * (conv.co * 9 * conv.ci + conv.co + 2 * conv.ci)
        else:
            act = 4.0 * n * 2 * conv.ci * conv.H * conv.W
            weights = 4.0 * members * 4 * (conv.co * 9 * conv.ci + 3 * conv.co)
        total += peaks.bound_s(n * _conv_flops(conv), act + weights, cfg["compute_dtype"])
    return total


def epoch_torso_bound_s(cfg, cell) -> float:
    """The torso kernels' least seconds in one epoch of the window (archive
    full): T rollout calls over the P + 1 members, the novelty's call over
    zeta, and the archive's H re-evaluations and one candidate over zeta."""
    M, Z, H = cell["population"] + 1, cell["zeta_size"], cell["archive_size"]
    rollout = cell["episode_length"] * torso_call_bound_s(cfg, M, 1)
    return rollout + torso_call_bound_s(cfg, M, Z) + (H + 1) * torso_call_bound_s(cfg, 1, Z)


def window_flops(cfg, cell, env_steps: int, epochs: int) -> float:
    """The model operations of a window of ``epochs`` epochs in which the
    trainer counted ``env_steps`` env steps: a forward a step, the novelty's
    forward over zeta for each of the P + 1 members, the archive's H + 1
    forwards over zeta, and 2 operations a parameter a member for the
    perturbation and for the combine."""
    f = frame_flops(cfg)
    P, Z, H = cell["population"], cell["zeta_size"], cell["archive_size"]
    d = reference_policy(cfg, "f32").d
    per_epoch = (P + 1 + H + 1) * Z * f + 4.0 * d * P
    return env_steps * f + epochs * per_epoch
