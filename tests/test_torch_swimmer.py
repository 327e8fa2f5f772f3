"""The port's swimmer held against the JAX package's, on the CPU.

``ops/smallsolve.py``, the closed-form and autodiff dynamics terms, the
resets, one step and a 100-step wave-gait episode of
``envs/swimmer.py::SwimmerEnv`` against ``dfd_tpu.envs.swimmer`` on the same
inputs; and the arithmetic of ``ops/csrc/swimmer.cu``, compiled by ``g++``
as plain C++, against the plain step (``ops/swimmer.py``).

Tolerances.  Resets, step counts and ``done`` are exact.  The step solves
``(M + dt D) qdot' = rhs`` in float32; at 7 links that system's condition
number is ~5.2e3, so float32 alone moves the new velocities by up to
cond * 2^-24 of their size (JAX's own step differs from a float64 step by
1.7e-4 of max |qdot| at the states below).  Two float32 steps that round in
another order (XLA's fused multiply-adds, the einsums' sums, the kernel's
FMAs) are therefore held to ``2 * cond * 2^-24`` of max |qdot| for the
velocities, the conditioning computed at the test's states, and q to
``dt * frame_skip`` of that (q integrates the velocities).  Measured against
JAX at 256 reset states and uniform actions: qdot 6.8e-6, 4.1e-5 and
1.9e-4 of max |qdot| at 3, 5 and 7 links, q 6.6e-7, 5.5e-6 and 2.2e-5, the
reward 1.5e-6, 3.3e-6 and 6.3e-6 absolute (held to 2e-5).
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_tpu.envs.swimmer import SwimmerEnv as JaxSwimmerEnv
from dfd_tpu.ops import smallsolve as jss
from dfd_tpu_torch.envs import SwimmerEnv
from dfd_tpu_torch.ops import smallsolve as pss
from dfd_tpu_torch.ops import swimmer as sw

CPU = "cpu"
EPS32 = 2.0 ** -24
REWARD_ATOL = 2e-5  # one step's reward, absolute (6.3e-6 measured at 7 links)


def _np(t):
    return t.detach().cpu().numpy()


def _rel(got, want) -> float:
    """max |got - want| relative to max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _cond(env, q, qdot) -> float:
    """The largest condition number of M + dt D over the episodes, in float64."""
    c = env.consts
    c64 = c._replace(T=c.T.double(), Aphi=c.Aphi.double(), M0=c.M0.double(), D0=c.D0.double())
    M, D, _ = sw.terms_closed(c64, q.double(), qdot.double())
    return float(np.linalg.cond(_np(M + c.dt * D)).max())


def _jax_reset(jenv, env, n, seed):
    """JAX's resets of n episodes and the port's from the same keys."""
    keys = jax.random.split(jax.random.key(seed), n)
    jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    draw = env.reset_draw(np.asarray(jax.random.key_data(keys)))
    state, obs = env.reset(n, torch.from_numpy(draw))
    return jstate, jobs, state, obs


def _wave(t, n_joints):
    """tests/test_envs.py's traveling-wave gait at step t."""
    return np.sin(0.4 * np.float32(t) + 0.8 * np.arange(n_joints, dtype=np.float32)).astype(
        np.float32)


# -- ops/smallsolve.py ------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 5, 9])
def test_spd_solve_matches_jax(n):
    """The unrolled Cholesky and both substitutions against JAX's on 16
    random SPD systems: the factor to 1e-6 and the solution to 1e-5 of
    their scale (the same ops in the same order; XLA contracts FMAs)."""
    rng = np.random.RandomState(n)
    R = rng.randn(16, n, n).astype(np.float32)
    A = (np.einsum("bij,bkj->bik", R, R) + 0.5 * np.eye(n)).astype(np.float32)
    b = rng.randn(16, n).astype(np.float32)
    L_j = np.asarray(jax.jit(jss.cholesky_unrolled)(A))
    x_j = np.asarray(jax.jit(jss.spd_solve_unrolled)(A, b))
    L_p = pss.cholesky_unrolled(torch.from_numpy(A))
    x_p = pss.spd_solve_unrolled(torch.from_numpy(A), torch.from_numpy(b))
    assert _rel(_np(L_p), L_j) < 1e-6
    assert np.array_equal(np.triu(_np(L_p), 1), np.zeros_like(L_j))
    assert _rel(_np(x_p), x_j) < 1e-5
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A, _np(x_p)), b, rtol=1e-4, atol=1e-4)


# -- the dynamics terms -------------------------------------------------------------


@pytest.mark.parametrize("n_links", [3, 5, 7])
def test_terms_closed_match_jax_and_autodiff(n_links):
    """The port's closed-form M, D and bias against JAX's ``_terms_closed``
    at 8 random states (rtol 1e-5, atol 1e-6: einsums summed in another
    order), and against the port's autodiff oracle at JAX's own tolerances
    (tests/test_envs.py: M and D 1e-5, bias 1e-4)."""
    env, jenv = SwimmerEnv(n_links=n_links, device=CPU), JaxSwimmerEnv(n_links=n_links)
    rng = np.random.RandomState(n_links)
    q = rng.uniform(-1.5, 1.5, (8, env.ndof)).astype(np.float32)
    qdot = rng.uniform(-2.0, 2.0, (8, env.ndof)).astype(np.float32)
    want = jax.jit(jax.vmap(jenv._terms_closed))(q, qdot)
    got = env._terms_closed(torch.from_numpy(q), torch.from_numpy(qdot))
    oracle = env._terms_autodiff(torch.from_numpy(q), torch.from_numpy(qdot))
    for name, g, w, o, tol in zip(("M", "D", "bias"), got, want, oracle, (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(_np(g), _np(o), rtol=tol, atol=tol, err_msg=name)


def test_autodiff_dynamics_steps_like_closed():
    """``dynamics="autodiff"`` (the oracle, through the plain step) against
    the closed form over 10 wave-gait steps, at JAX's own trajectory
    tolerance (rtol and atol 1e-3, tests/test_envs.py)."""
    closed, auto = (SwimmerEnv(n_links=5, dynamics=d, device=CPU) for d in ("closed", "autodiff"))
    draw = torch.from_numpy(closed.reset_draw(np.asarray(
        jax.random.key_data(jax.random.split(jax.random.key(2), 4)))))
    (sc, _), (sa, _) = closed.reset(4, draw), auto.reset(4, draw)
    for t in range(10):
        act = torch.from_numpy(_wave(t, 4)).expand(4, -1)
        sc, oc, rc, _ = closed.step(sc, act)
        sa, oa, ra, _ = auto.step(sa, act)
    np.testing.assert_allclose(_np(oa), _np(oc), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_np(ra), _np(rc), rtol=1e-3, atol=1e-3)


# -- resets and steps against JAX -------------------------------------------------------


@pytest.mark.parametrize("n_links", [3, 5, 7])
def test_swimmer_reset_is_bit_exact(n_links):
    """``reset_draw`` reproduces JAX's two uniforms under ``split(key)``,
    XLA's fused scaling included: q, qdot and the observation equal JAX's
    bit for bit at 64 keys."""
    env, jenv = SwimmerEnv(n_links=n_links, device=CPU), JaxSwimmerEnv(n_links=n_links)
    jstate, jobs, state, obs = _jax_reset(jenv, env, 64, n_links)
    assert env.reset_shape == (2 * env.ndof - 2,) and obs.shape == (64,) + env.obs_shape
    np.testing.assert_array_equal(_np(state.q), np.asarray(jstate.q))
    np.testing.assert_array_equal(_np(state.qdot), np.asarray(jstate.qdot))
    np.testing.assert_array_equal(_np(obs), np.asarray(jobs))
    assert not state.t.any() and state.t.dtype == torch.int64


@pytest.mark.parametrize("n_links", [3, 5, 7])
def test_swimmer_step_matches_jax(n_links):
    """One step of 256 episodes from JAX's resets under uniform actions in
    [-1.2, 1.2] (the clip is exercised): q, qdot and the observation within
    the conditioning bound of the module docstring, the reward within 2e-5,
    t and done exact."""
    env = SwimmerEnv(n_links=n_links, max_steps=1, device=CPU)
    jenv = JaxSwimmerEnv(n_links=n_links, max_steps=1)
    jstate, _, state, _ = _jax_reset(jenv, env, 256, 10 + n_links)
    action = np.random.RandomState(n_links).uniform(-1.2, 1.2, (256, n_links - 1)).astype(
        np.float32)
    js, jobs, jr, jd = jax.jit(jax.vmap(jenv.step))(jstate, jnp.asarray(action))
    ps, pobs, pr, pd = env.step(state, torch.from_numpy(action))
    tol_v = 2 * _cond(env, state.q, state.qdot) * EPS32
    tol_q = env.consts.dt * env.consts.frame_skip * tol_v * max(1.0, float(np.abs(js.qdot).max()))
    assert _rel(_np(ps.qdot), js.qdot) <= tol_v
    assert np.abs(_np(ps.q) - np.asarray(js.q)).max() <= tol_q
    assert _rel(_np(pobs), jobs) <= tol_v
    np.testing.assert_allclose(_np(pr), np.asarray(jr), rtol=0, atol=REWARD_ATOL)
    np.testing.assert_array_equal(_np(ps.t), np.asarray(js.t))
    np.testing.assert_array_equal(_np(pd), np.asarray(jd))
    assert pd.all()  # max_steps=1


def test_swimmer_wave_gait_episode_matches_jax():
    """A 100-step wave-gait episode (tests/test_envs.py:178-180's gait) of
    64 episodes of 7 links from JAX's resets.  The deviation does not grow
    exponentially: the drag dissipates.  Measured against JAX: qdot 6.4e-5 of
    max |qdot| after 1 step, 2.5e-4 after 10, 3.2e-4 after 100; q 6.9e-6,
    7.6e-5, 6.8e-5 (max 1.4e-4 at step 50); the reward 6.7e-6, 1.3e-5,
    3.8e-5; the summed return 2.2e-5 of the largest.  Held to qdot 1e-3,
    q 5e-4 and the reward 1e-4 at every step, the summed return to 1e-4 of
    the largest, the steps and done exact; the
    gait moves the body forward as JAX's test asks."""
    env, jenv = SwimmerEnv(max_steps=100, device=CPU), JaxSwimmerEnv(max_steps=100)
    jstate, _, state, _ = _jax_reset(jenv, env, 64, 3)
    jstep = jax.jit(jax.vmap(jenv.step))
    x0 = _np(sw.com_x(env.consts, state.q))
    ret_j, ret_p = np.zeros(64), np.zeros(64)
    worst = {"q": 0.0, "qdot": 0.0, "reward": 0.0}
    for t in range(100):
        act = np.broadcast_to(_wave(t, 6), (64, 6)).copy()
        jstate, _, jr, jd = jstep(jstate, jnp.asarray(act))
        state, _, pr, pd = env.step(state, torch.from_numpy(act))
        worst["q"] = max(worst["q"], _rel(_np(state.q), jstate.q))
        worst["qdot"] = max(worst["qdot"], _rel(_np(state.qdot), jstate.qdot))
        worst["reward"] = max(worst["reward"], float(np.abs(_np(pr) - np.asarray(jr)).max()))
        np.testing.assert_array_equal(_np(pd), np.asarray(jd))
        ret_j, ret_p = ret_j + np.asarray(jr), ret_p + _np(pr)
    assert worst["q"] <= 5e-4 and worst["qdot"] <= 1e-3 and worst["reward"] <= 1e-4, worst
    np.testing.assert_allclose(ret_p, ret_j, rtol=0, atol=1e-4 * np.abs(ret_j).max())
    assert (_np(sw.com_x(env.consts, state.q)) - x0).mean() > 1.0
    assert pd.all() and (_np(state.t) == 100).all()


# -- the wrapper's refusals --------------------------------------------------------------


def test_swimmer_refuses_what_the_kernel_refuses():
    """1 to 64 links (the run-time form's bound), on every device; and the
    wrapper checks dtype, shape and contiguity before it branches on the
    device."""
    for n in (0, 65, 100):
        with pytest.raises(ValueError, match="n_links must be 1 to 64"):
            SwimmerEnv(n_links=n, device=CPU)
    env = SwimmerEnv(n_links=3, device=CPU)
    state, _ = env.reset(4, torch.zeros(4, 8))
    c, a = env.consts, torch.zeros(4, 2)
    cases = [
        ((state.q.double(), state.qdot, state.t, a), "q must be"),
        ((state.q, state.qdot, state.t.int(), a), "t must be"),
        ((state.q, state.qdot, state.t, torch.zeros(4, 3)), "action must be"),
        ((state.q, state.qdot[:, :4], state.t, a), "qdot must be"),
        ((state.q, state.qdot, state.t, torch.zeros(2, 4).t()), "action must be"),
    ]
    for args, what in cases:
        with pytest.raises(ValueError, match=what):
            sw.swimmer_step(c, *args)
    with pytest.raises(ValueError, match="n_links must be 1 to 64"):
        sw.swimmer_step(c._replace(n_links=65), state.q, state.qdot, state.t, a)
    with pytest.raises(ValueError, match="reset_level must have shape"):
        env.reset(4, torch.zeros(4, 7))


# -- the kernel's arithmetic, compiled by g++ --------------------------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``csrc/swimmer.cu`` compiled as plain C++: ``dfd_swimmer_step_host``
    runs ``swimmer_episode`` over the episodes in a loop, each phase of an
    episode as a loop over its lanes, exchanging through a local scratch."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's source for the host")
    lib = tmp_path_factory.mktemp("swimmer") / "libswimmer_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-o", str(lib), str(sw.build.CSRC / "swimmer.cu")],
                   check=True, capture_output=True)
    host = ctypes.CDLL(str(lib))
    host.dfd_swimmer_step_host.argtypes = [ctypes.POINTER(sw._Args), ctypes.c_int]
    host.dfd_swimmer_step_host.restype = ctypes.c_int

    def step(c, q, qdot, t, action):
        N, nd = q.shape[0], c.ndof
        outs = (torch.empty(N, nd), torch.empty(N, nd), torch.empty(N, dtype=torch.int64),
                torch.empty(N, 2 * nd - 2), torch.empty(N), torch.empty(N, dtype=torch.bool))
        assert host.dfd_swimmer_step_host(
            ctypes.byref(sw.kernel_args(c, (q, qdot, t, action), outs)), c.n_links) == 0
        return outs

    return step


@pytest.mark.parametrize("n_links", [3, 5, 7])
def test_host_compiled_kernel_matches_plain(host_kernel, n_links):
    """The kernel's per-episode step on the host against
    ``swimmer_step_plain`` at 37 random states (angles and velocities in
    [-1, 1], actions in [-1.5, 1.5], t in [0, 100)) and along a 100-step
    wave gait from them: the conditioning bound after one step, qdot 1e-3,
    q 5e-4 and the reward 1e-4 after 100 (measured at 7 links: 2.9e-4,
    1.9e-5, 4.2e-5); t and done exact throughout."""
    env = SwimmerEnv(n_links=n_links, max_steps=100, device=CPU)
    c, rng = env.consts, np.random.RandomState(n_links)
    f32 = lambda *shape, lim: torch.from_numpy(rng.uniform(-lim, lim, shape).astype(np.float32))
    q, qdot, a = f32(37, c.ndof, lim=1.0), f32(37, c.ndof, lim=1.0), f32(37, n_links - 1, lim=1.5)
    t = torch.from_numpy(rng.randint(0, 100, 37).astype(np.int64))
    got, want = host_kernel(c, q, qdot, t, a), sw.swimmer_step_plain(c, q, qdot, t, a)
    tol_v = 2 * _cond(env, q, qdot) * EPS32
    assert _rel(_np(got[1]), _np(want[1])) <= tol_v
    assert _rel(_np(got[0]), _np(want[0])) <= c.dt * c.frame_skip * tol_v * max(
        1.0, float(want[1].abs().max()))
    assert _rel(_np(got[3]), _np(want[3])) <= tol_v
    np.testing.assert_allclose(_np(got[4]), _np(want[4]), rtol=0, atol=REWARD_ATOL)
    assert torch.equal(got[2], want[2]) and torch.equal(got[5], want[5])
    ga, wa = (q, qdot, torch.zeros(37, dtype=torch.int64)), (q, qdot, torch.zeros(37, dtype=torch.int64))
    for s in range(100):
        act = torch.from_numpy(_wave(s, n_links - 1)).expand(37, -1).contiguous()
        g, w = host_kernel(c, *ga, act), sw.swimmer_step_plain(c, *wa, act)
        ga, wa = g[:3], w[:3]
        assert torch.equal(g[2], w[2]) and torch.equal(g[5], w[5])
    assert _rel(_np(g[1]), _np(w[1])) <= 1e-3 and _rel(_np(g[0]), _np(w[0])) <= 5e-4
    assert float((g[4] - w[4]).abs().max()) <= 1e-4 and w[5].all()


@pytest.mark.parametrize("n_links", [3, 5, 7])
def test_host_compiled_kernel_episode_ignores_its_neighbours(host_kernel, n_links):
    """Each of 37 episodes stepped alone (N = 1) gives the outputs it gives
    among the 37, bit for bit: an episode's result depends on neither its
    neighbours nor its slot."""
    c, rng = SwimmerEnv(n_links=n_links, device=CPU).consts, np.random.RandomState(10 + n_links)
    f32 = lambda *shape, lim: torch.from_numpy(rng.uniform(-lim, lim, shape).astype(np.float32))
    ins = (f32(37, c.ndof, lim=1.0), f32(37, c.ndof, lim=1.0),
           torch.from_numpy(rng.randint(0, 100, 37).astype(np.int64)), f32(37, n_links - 1, lim=1.5))
    together = host_kernel(c, *ins)
    alone = [host_kernel(c, *(x[e:e + 1].contiguous() for x in ins)) for e in range(37)]
    for k, out in enumerate(together):
        assert torch.equal(torch.cat([a[k] for a in alone]), out), k
