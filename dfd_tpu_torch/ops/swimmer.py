"""The swimmer's physics step on the card: ``swimmer_step_kernel``.

Not a Pallas kernel: this replaces XLA's fusion of
``dfd_tpu/envs/swimmer.py::SwimmerEnv.step`` with ``dynamics="closed"`` (four
semi-implicit substeps, each the closed-form dynamics terms of
``_terms_closed`` and a 9 x 9 SPD solve by ``spd_solve_unrolled``, then the
centre-of-mass reward, the control cost and the step counter).  The JAX
package counts on XLA to fuse the ~330 elementwise ops of a substep; written
as eager PyTorch, a step of the default 7-link swimmer is ~1,300 launches.
The kernel (``csrc/swimmer.cu``) runs every episode's step in one launch,
a warp an episode.  It has two kinds of form, chosen by the link count:

- a template form for each count from 1 to ``FORM_LINKS``
  (``swimmer_step_kernel<NL>``, counted in ``swimmer_step.launches``): four
  episodes a block (513 episodes are 129 blocks, one on each of 129 SMs).
  The warp's lanes split each substep's work (a link's angles and Jacobian
  a lane, the entries of M and of the system over the lanes, the Cholesky
  factor's rows a lane, column by column) and exchange through the
  episode's scratch in shared memory between phases; every lane keeps the
  state and the forward substitution in registers and runs the back
  substitution itself;
- past that, up to ``MAX_LINKS``, one form with the link count at run time
  (``swimmer_step_dyn_kernel``, counted in ``swimmer_step.dyn_launches``):
  the same arithmetic in the same order, with what the template forms keep
  in registers in the episode's shared scratch, sized at launch (four
  episodes a block at every count).  Its lanes split each phase's work
  without summing anything twice: a Jacobian column a lane as running sums
  over the links, the system's entries stepped from their index, the
  Cholesky factor right-looking in place with rows owned by lanes, and the
  back substitution on one lane.

More than ``MAX_LINKS`` links are refused on every device.

:func:`swimmer_step` runs the kernel on CUDA tensors and
:func:`swimmer_step_plain` on CPU ones, after the same checks on both;
``swimmer_step.launches`` counts its launches.  :func:`swimmer_step_plain`
mirrors the JAX step op for op over a leading batch axis (:func:`terms_closed`
and ``ops/smallsolve.py``); the env's ``dynamics="autodiff"`` oracle runs it
with its own terms on any device.

Tolerance: the kernel contracts products into fused multiply-adds (nvcc's
default ``-fmad=true``) where the plain version rounds twice, and sums the
links in its own order; cosf, sinf, sqrtf and the divisions are the
accurate ones on both.  The two agree to ulps after one step; the deviation
grows along a trajectory (see ``chip_smoke.py``'s limits).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from dfd_tpu_torch.ops import build
from dfd_tpu_torch.ops.smallsolve import spd_solve_unrolled

FORM_LINKS = 11  # link counts 1 .. FORM_LINKS have a template form each (csrc kFormLinks)
MAX_LINKS = 64   # the run-time form's bound (csrc kMaxLinks)


class _Args(ctypes.Structure):
    """``SwimmerArgs`` of ``csrc/swimmer.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "q", "qdot", "t", "action", "q_out", "qdot_out", "t_out", "obs", "reward", "done")] + [
        ("n", ctypes.c_longlong), ("max_steps", ctypes.c_longlong), ("frame_skip", ctypes.c_int)] + [
        (name, ctypes.c_float) for name in (
            "L", "m", "dt", "torque_scale", "stiffness", "c_t", "c_n", "ctrl_cost", "step_time")] + [
        ("m0", ctypes.c_void_p), ("d0", ctypes.c_void_p)]


class SwimmerConstants(NamedTuple):
    """The env's constants: the scalars as Python floats, the structure
    matrices as float32 tensors on the env's device, as the JAX env builds
    them (``dfd_tpu/envs/swimmer.py:99-124``)."""

    n_links: int
    L: float
    m: float
    I: float
    dt: float
    frame_skip: int
    torque_scale: float
    joint_damping: float
    joint_stiffness: float
    c_t: float
    c_n: float
    c_r: float
    ctrl_cost: float
    max_steps: int
    T: torch.Tensor     # [n, n] weight of phi_k in centre_i: 1 (k < i), 1/2 (k == i)
    Aphi: torch.Tensor  # [n, 1 + J] d phi_k / d (theta0, alpha_1..alpha_J)
    M0: torch.Tensor    # [ndof, ndof] the constant blocks of M and D
    D0: torch.Tensor
    args: _Args         # the kernel's argument struct with every scalar set and no pointer:
                        # kernel_args copies it for each step and points it at the tensors

    @property
    def ndof(self) -> int:
        return self.n_links + 2

    @classmethod
    def make(cls, n_links: int, link_length: float, link_mass: float, dt: float,
             frame_skip: int, torque_scale: float, joint_damping: float, joint_stiffness: float,
             drag_tangent: float, drag_normal: float, drag_rot: float, ctrl_cost: float,
             max_steps: int, device) -> "SwimmerConstants":
        n, J = int(n_links), int(n_links) - 1
        ndof = 3 + J
        L, m = float(link_length), float(link_mass)
        inertia = m * L ** 2 / 12.0
        ii, kk = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        T = np.where(kk < ii, 1.0, np.where(kk == ii, 0.5, 0.0))
        Aphi = np.zeros((n, 1 + J))
        Aphi[:, 0] = 1.0
        for j in range(1, 1 + J):
            Aphi[j:, j] = 1.0
        AtA = Aphi.T @ Aphi
        M0 = np.zeros((ndof, ndof))
        M0[2:, 2:] = inertia * AtA
        D0 = np.zeros((ndof, ndof))
        D0[2:, 2:] = float(drag_rot) * AtA
        D0 += np.diag(np.concatenate([np.zeros(3), np.full(J, float(joint_damping))]))
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        args = _Args(max_steps=int(max_steps), frame_skip=int(frame_skip), L=L, m=m, dt=float(dt),
                     torque_scale=float(torque_scale), stiffness=float(joint_stiffness),
                     c_t=float(drag_tangent), c_n=float(drag_normal), ctrl_cost=float(ctrl_cost),
                     step_time=float(np.float32(float(dt) * int(frame_skip))))
        return cls(n, L, m, inertia, float(dt), int(frame_skip), float(torque_scale),
                   float(joint_damping), float(joint_stiffness), float(drag_tangent),
                   float(drag_normal), float(drag_rot), float(ctrl_cost), int(max_steps),
                   t(T), t(Aphi), t(M0), t(D0), args)


# -- the plain version -------------------------------------------------------------


def _angles(x: torch.Tensor) -> torch.Tensor:
    """x[..., 2] + [0, cumsum(x[..., 3:])]: the links' absolute angles of q
    (or their rates, of qdot) [..., n]."""
    zero = torch.zeros_like(x[..., :1])
    return x[..., 2:3] + torch.cat([zero, torch.cumsum(x[..., 3:], dim=-1)], dim=-1)


def terms_closed(c: SwimmerConstants, q: torch.Tensor, qdot: torch.Tensor):
    """(M [N, ndof, ndof], D [N, ndof, ndof], bias [N, ndof]) at q, qdot
    [N, ndof]: ``dfd_tpu``'s ``_terms_closed`` over a leading batch axis."""
    m, L = c.m, c.L
    n = c.n_links
    phis = _angles(q)
    cs, sn = torch.cos(phis), torch.sin(phis)
    d = L * torch.stack([cs, sn], dim=-1)                               # [N, n, 2]
    Nv = L * torch.stack([-sn, cs], dim=-1)                             # [N, n, 2] = dd/dphi
    B = torch.einsum("ik,nka,kc->niac", c.T, Nv, c.Aphi)                # [N, n, 2, 1 + J]
    eye2 = torch.eye(2, dtype=B.dtype, device=B.device).expand(q.shape[0], n, 2, 2)
    Jc = torch.cat([eye2, B], dim=-1)                                   # [N, n, 2, ndof]
    M = m * torch.einsum("nkai,nkaj->nij", Jc, Jc) + c.M0
    phidots = _angles(qdot)
    a0c = -torch.einsum("ik,nka->nia", c.T, d * (phidots ** 2)[..., None])
    bias = -m * torch.einsum("nkai,nka->ni", Jc, a0c)
    tang = torch.stack([cs, sn], dim=-1)
    norm = torch.stack([-sn, cs], dim=-1)
    A = c.c_t * torch.einsum("nki,nkj->nkij", tang, tang) + c.c_n * torch.einsum(
        "nki,nkj->nkij", norm, norm)
    D = torch.einsum("nkai,nkab,nkbj->nij", Jc, A, Jc) + c.D0
    return M, D, bias


def com_x(c: SwimmerConstants, q: torch.Tensor) -> torch.Tensor:
    """The x of the chain's centre of mass [N]: link heads by a running sum
    from the nose, centres half a link further, their mean."""
    dx = c.L * torch.cos(_angles(q))                                    # [N, n]
    heads = torch.cumsum(torch.cat([q[..., :1], dx[..., :-1]], dim=-1), dim=-1)
    return (heads + 0.5 * dx).mean(dim=-1)


def swimmer_step_plain(c: SwimmerConstants, q: torch.Tensor, qdot: torch.Tensor,
                       t: torch.Tensor, action: torch.Tensor, terms=terms_closed):
    """(q, qdot, t, obs, reward, done) after one env step of every episode,
    in the JAX step's order of operations; ``terms(c, q, qdot)`` gives the
    dynamics terms (:func:`terms_closed`, or the env's autodiff oracle)."""
    tau = c.torque_scale * torch.clamp(action.to(torch.float32), -1.0, 1.0)
    eye = torch.eye(c.ndof, dtype=torch.float32, device=q.device)
    q0 = q
    for _ in range(c.frame_skip):
        M, D, bias = terms(c, q, qdot)
        Q = torch.cat([torch.zeros_like(q[..., :3]), tau - c.joint_stiffness * q[..., 3:]],
                      dim=-1)
        qdot = spd_solve_unrolled(
            M + c.dt * D + 1e-9 * eye,
            torch.einsum("nij,nj->ni", M, qdot) + c.dt * (Q + bias),
        )
        q = q + c.dt * qdot
    dx = com_x(c, q) - com_x(c, q0)
    reward = dx / (c.dt * c.frame_skip) - c.ctrl_cost * torch.sum(tau ** 2, dim=-1)
    t = t + 1
    done = t >= c.max_steps
    obs = torch.cat([q[..., 2:], qdot], dim=-1)
    return q, qdot, t, obs, reward.to(torch.float32), done


# -- the kernel ----------------------------------------------------------------------


def kernel_args(c: SwimmerConstants, inputs, outputs) -> _Args:
    """The kernel's argument struct for ``inputs`` (q, qdot, t, action) and
    ``outputs`` (q, qdot, t, obs, reward, done), any device's tensors: a copy
    of ``c.args`` with the pointers (the env's own M0 and D0 among them) and
    the episode count set."""
    args = _Args.from_buffer_copy(c.args)
    for (name, _), x in zip(_Args._fields_, (*inputs, *outputs)):
        setattr(args, name, x.data_ptr())
    args.m0, args.d0 = c.M0.data_ptr(), c.D0.data_ptr()
    args.n = inputs[0].shape[0]
    return args


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    lib = build.load("swimmer")
    lib.dfd_swimmer_step.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    lib.dfd_swimmer_step.restype = ctypes.c_int
    lib.dfd_swimmer_launch_shape.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.dfd_swimmer_form_links.restype = lib.dfd_swimmer_max_links.restype = ctypes.c_int
    return lib


def check_links(n_links: int) -> None:
    if not 1 <= n_links <= MAX_LINKS:
        raise ValueError(f"n_links must be 1 to {MAX_LINKS} (the swimmer kernel's run-time form "
                         f"holds an episode of at most {MAX_LINKS} links in shared memory), got "
                         f"{n_links}")


def _check(c: SwimmerConstants, q, qdot, t, action) -> bool:
    """Checks what the kernel needs on any device, so that the CPU refuses
    what the card does; then whether the operands lie on the CPU."""
    check_links(c.n_links)
    N, nd = q.shape[0] if q.ndim == 2 else -1, c.ndof
    for name, x, dtype, shape in (("q", q, torch.float32, (N, nd)),
                                  ("qdot", qdot, torch.float32, (N, nd)),
                                  ("t", t, torch.int64, (N,)),
                                  ("action", action, torch.float32, (N, c.n_links - 1))):
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} tensor, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != q.device or c.M0.device != q.device:
            raise ValueError(f"{name} ({x.device}) and the env's constants ({c.M0.device}) must "
                             f"lie on q's device ({q.device})")
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"q must lie on the CPU or a CUDA device, got {q.device}")
    return False


def swimmer_step(c: SwimmerConstants, q: torch.Tensor, qdot: torch.Tensor, t: torch.Tensor,
                 action: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(q, qdot, t, obs [N, 2 ndof - 2], reward [N], done [N] bool) after one
    step of each of N episodes: q, qdot [N, ndof] float32, t [N] int64,
    action [N, n_links - 1] float32, all contiguous.  One launch a call on
    the card (none for N = 0): the template form up to ``FORM_LINKS``
    links, the run-time form past them."""
    if _check(c, q, qdot, t, action):
        return swimmer_step_plain(c, q, qdot, t, action)
    N, nd = q.shape[0], c.ndof
    new = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=q.device)
    outs = (new(N, nd), new(N, nd), new(N, dtype=torch.int64), new(N, 2 * nd - 2), new(N),
            new(N, dtype=torch.bool))
    if N == 0:
        return outs
    args = kernel_args(c, (q, qdot, t, action), outs)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.raise_on(_kernels().dfd_swimmer_step(ctypes.byref(args), c.n_links, stream),
                       "swimmer_step")
    if c.n_links <= FORM_LINKS:
        swimmer_step.launches += 1
    else:
        swimmer_step.dyn_launches += 1
    return outs


swimmer_step.launches = 0
swimmer_step.dyn_launches = 0
