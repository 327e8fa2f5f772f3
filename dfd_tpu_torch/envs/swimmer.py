"""The JAX-native multi-link planar swimmer, batched over the population.

The same env as ``dfd_tpu.envs.swimmer.SwimmerEnv`` (see its module
docstring): an ``n_links`` rigid chain in a viscous planar fluid, joint
torques in [-1, 1] as actions, the forward velocity of the centre of mass
less a control cost as reward, observations ``[theta0, alphas, qdot]``.

``dynamics="closed"`` (the default) steps through
``ops/swimmer.py::swimmer_step``: one ``swimmer_step_kernel`` launch a step
on the card, its plain PyTorch version on the CPU.  ``dynamics="autodiff"``
is the JAX package's test oracle: the mass matrix, drag and Coriolis terms
by ``torch.func.jacfwd``, ``jvp`` and ``grad`` of the kinematics, each
episode's under ``torch.func.vmap``, through the plain step on any device.
Any link count from 1 to ``ops.swimmer.MAX_LINKS`` (64) is taken, on every
device; a single link has no joint and an empty action.

A reset draws ``2 * ndof - 2`` float32 uniforms in [-0.1, 0.1]: the joint
angles ``q[2:]`` then the velocities ``qdot`` (``reset_shape``); the JAX env
draws them as ``uniform(kq, (ndof - 2,))`` and ``uniform(kv, (ndof,))`` with
``kq, kv = split(key)``, which :meth:`SwimmerEnv.reset_draw` reproduces bit
for bit on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.envs import _levels
from dfd_tpu_torch.envs.base import TorchEnv
from dfd_tpu_torch.ops.swimmer import (SwimmerConstants, check_links, swimmer_step,
                                       swimmer_step_plain, terms_closed)

RESET_RANGE = 0.1  # resets draw in [-RESET_RANGE, RESET_RANGE]


class SwimmerState(NamedTuple):
    q: torch.Tensor     # [N, ndof] generalized coordinates (x, y, theta0, alphas)
    qdot: torch.Tensor  # [N, ndof] generalized velocities
    t: torch.Tensor     # [N] int64 step counter


class SwimmerEnv(TorchEnv):
    def __init__(
        self,
        n_links: int = 7,
        link_length: float = 0.25,
        link_mass: float = 1.0,
        dt: float = 0.01,
        frame_skip: int = 4,
        torque_scale: float = 2.0,
        joint_damping: float = 0.3,
        joint_stiffness: float = 2.0,
        drag_tangent: float = 0.1,
        drag_normal: float = 6.0,
        drag_rot: float = 0.02,
        ctrl_cost: float = 1e-3,
        max_steps: int = 200,
        dynamics: str = "closed",
        device=None,
    ):
        self.device = resolve_device(device)
        check_links(int(n_links))
        if dynamics not in ("closed", "autodiff"):
            raise ValueError(f"unknown dynamics impl: {dynamics!r}")
        self.dynamics = dynamics
        self.consts = SwimmerConstants.make(
            n_links, link_length, link_mass, dt, frame_skip, torque_scale, joint_damping,
            joint_stiffness, drag_tangent, drag_normal, drag_rot, ctrl_cost, max_steps,
            self.device)
        self.n_links = self.consts.n_links
        self.n_joints = self.n_links - 1
        self.ndof = self.consts.ndof
        self.action_dim = self.n_joints
        self.max_episode_steps = int(max_steps)
        self.obs_shape = (1 + self.n_joints + self.ndof,)
        self.reset_shape = (2 * self.ndof - 2,)

    # -- reset draws ----------------------------------------------------------------

    def sample_reset(self, shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
        """Reset draws [*shape, 2 ndof - 2] float32 uniform in [-0.1, 0.1)."""
        u = torch.rand(tuple(shape) + self.reset_shape, generator=generator,
                       device=generator.device)
        return u * (2 * RESET_RANGE) - RESET_RANGE

    def reset_draw(self, keys: np.ndarray) -> np.ndarray:
        """The JAX env's angles and velocities [..., 2 ndof - 2] under each
        reset key."""
        k = _levels.split(np.asarray(keys, np.uint32), 2)
        angles = _levels.uniform(k[..., 0, :], (self.ndof - 2,), -RESET_RANGE, RESET_RANGE)
        rates = _levels.uniform(k[..., 1, :], (self.ndof,), -RESET_RANGE, RESET_RANGE)
        return np.concatenate([angles, rates], axis=-1)

    # -- TorchEnv -------------------------------------------------------------------

    def reset(self, n: int, reset_level: torch.Tensor) -> Tuple[SwimmerState, torch.Tensor]:
        """``reset_level`` [n, 2 ndof - 2]: each episode's angles, then velocities."""
        draw = reset_level.to(device=self.device, dtype=torch.float32)
        if tuple(draw.shape) != (n,) + self.reset_shape:
            raise ValueError(f"reset_level must have shape {(n,) + self.reset_shape}, got "
                             f"{tuple(draw.shape)}")
        q = torch.cat([torch.zeros((n, 2), device=self.device), draw[:, :self.ndof - 2]], dim=1)
        state = SwimmerState(q=q, qdot=draw[:, self.ndof - 2:].contiguous(),
                             t=torch.zeros(n, dtype=torch.int64, device=self.device))
        return state, self._obs(state)

    def step(self, state: SwimmerState, action: torch.Tensor):
        action = action.to(torch.float32).contiguous()
        if self.dynamics == "closed":
            q, qdot, t, obs, reward, done = swimmer_step(self.consts, state.q.contiguous(),
                                                         state.qdot.contiguous(), state.t, action)
        else:
            q, qdot, t, obs, reward, done = swimmer_step_plain(
                self.consts, state.q, state.qdot, state.t, action,
                terms=lambda c, q, qdot: self._terms_autodiff(q, qdot))
        return SwimmerState(q, qdot, t), obs, reward, done

    def _obs(self, state: SwimmerState) -> torch.Tensor:
        return torch.cat([state.q[:, 2:], state.qdot], dim=1)

    # -- the dynamics terms ---------------------------------------------------------

    def _terms_closed(self, q: torch.Tensor, qdot: torch.Tensor):
        """(M, D, bias) at q, qdot [N, ndof], in closed form."""
        return terms_closed(self.consts, q, qdot)

    def _kinematics(self, q: torch.Tensor):
        """One episode's q [ndof] -> (link centres [n, 2], link angles [n])."""
        L = self.consts.L
        phis = q[2] + torch.cat([torch.zeros_like(q[:1]), torch.cumsum(q[3:], dim=0)])
        d = L * torch.stack([torch.cos(phis), torch.sin(phis)], dim=-1)
        joints = torch.cumsum(torch.cat([q[:2][None], d[:-1]], dim=0), dim=0)
        return joints + 0.5 * d, phis

    def _terms_one(self, q: torch.Tensor, qdot: torch.Tensor):
        """One episode's (M, D, bias) by nested autodiff of the kinematics
        (``dfd_tpu``'s ``_terms_autodiff``)."""
        from torch.func import grad, jacfwd, jvp

        c = self.consts
        n, ndof = c.n_links, c.ndof

        def stacked(qq):
            centers, phis = self._kinematics(qq)
            return torch.cat([centers.reshape(-1), phis])

        def Mq(qq):
            Jq = jacfwd(stacked)(qq)
            Jcq = Jq[: 2 * n].reshape(n, 2, ndof)
            Jpq = Jq[2 * n:]
            return c.m * torch.einsum("nij,nik->jk", Jcq, Jcq) + c.I * Jpq.T @ Jpq

        J = jacfwd(stacked)(q)
        Jc = J[: 2 * n].reshape(n, 2, ndof)
        Jphi = J[2 * n:]
        M = c.m * torch.einsum("nij,nik->jk", Jc, Jc) + c.I * Jphi.T @ Jphi
        _, Mdot = jvp(Mq, (q,), (qdot,))
        bias = grad(lambda qq: 0.5 * qdot @ Mq(qq) @ qdot)(q) - Mdot @ qdot

        _, phis = self._kinematics(q)
        tang = torch.stack([torch.cos(phis), torch.sin(phis)], dim=-1)
        norm = torch.stack([-torch.sin(phis), torch.cos(phis)], dim=-1)
        A = c.c_t * torch.einsum("ni,nj->nij", tang, tang) + c.c_n * torch.einsum(
            "ni,nj->nij", norm, norm)
        JcT = Jc.transpose(1, 2)
        D = torch.einsum("nia,nab,njb->ij", JcT, A, JcT) + c.c_r * Jphi.T @ Jphi
        damp = torch.cat([torch.zeros(3, device=q.device),
                          torch.full((n - 1,), c.joint_damping, device=q.device)])
        return M, D + torch.diag(damp), bias

    def _terms_autodiff(self, q: torch.Tensor, qdot: torch.Tensor):
        """(M, D, bias) at q, qdot [N, ndof], by autodiff, episode by episode
        under ``torch.func.vmap``."""
        from torch.func import vmap

        return vmap(self._terms_one)(q, qdot)
