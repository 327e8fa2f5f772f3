"""Every shape the JAX package runs, on the port, held to the JAX package on
the CPU: the IMPALA torso kernels where no cluster of blocks holds a frame
(or an f32 conv has more than 256 output channels), the swimmer at any link
count from 1 to 64, and the jax noise backend past 65,535 draws.

On the CPU the port's wrappers run their plain versions, so these tests
hold the shapes the launch plans now take (each one's tiled plan is checked
here) and the arithmetic the kernels are held to on the card
(``chip_smoke.py``'s ``shapes`` phase).  JAX runs its Pallas kernels in
interpret mode, as its own tests do.

Tolerances.  The torso: f32 rtol 1e-5 and atol 1e-5 (``test_torch_impala``'s:
sums of 9C products in another order than the Pallas interpreter's dot);
bf16 4e-3 of the output's scale (``chip_smoke.py``'s ``TOL_FUSED_RES_BF16``:
an f32 intermediate an ulp apart can round to the neighbouring bf16 value).
The trainer pair: ``flat`` within rtol 1e-5 after 3 epochs, rewards and
steps exact (``tests/_torch_port.py``).  The swimmer: resets, t and done
exact; q, qdot and the reward within ``2 * cond * 2^-24`` of max |qdot|,
cond the largest condition number of ``M + dt D`` along the episode (float32
solves that round in another order; measured at 20 steps: 0.03 to 0.66 of
it from 1 to 15 links).  The noise: JAX's bits exactly, eps within 4e-6
(``test_torch_noise``'s: the CPU's log1p and XLA's differ by an ulp now and
then).
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_state_numpy, run_and_compare
from dfd_tpu.config import TrainConfig as JaxTrainConfig
from dfd_tpu.envs.procmaze import ProcMazeEnv as JaxProcMazeEnv
from dfd_tpu.envs.swimmer import SwimmerEnv as JaxSwimmerEnv
from dfd_tpu.models.impala import ImpalaPolicy as JaxImpala
from dfd_tpu.ops import distances as jax_distances
from dfd_tpu.ops import fused_resblock as jfr
from dfd_tpu.runners import VectorizedTrainer as JaxTrainer
from dfd_tpu_torch.config import TrainConfig
from dfd_tpu_torch.convert import train_state_from_numpy
from dfd_tpu_torch.envs import ProcMazeEnv, SwimmerEnv
from dfd_tpu_torch.models import ImpalaPolicy
from dfd_tpu_torch.ops import distances
from dfd_tpu_torch.ops import fused_resblock as pfr
from dfd_tpu_torch.ops import noise as nz
from dfd_tpu_torch.ops import swimmer as sw
from dfd_tpu_torch.runners import VectorizedTrainer

CPU = "cpu"
T = torch.from_numpy
EPS32 = 2.0 ** -24
TOL_FUSED_RES_BF16 = 4e-3
TOL_EPS = 4e-6


def _np(t):
    return t.detach().cpu().numpy()


# -- the torso kernels past the cluster form ------------------------------------------


def _inputs(rng, kind, M, B, ci, co, H, W):
    x = rng.randn(M, B, ci, H, W).astype(np.float32)
    if kind == "res":
        w = (rng.randn(M, 4, ci, 9 * ci) / np.sqrt(9 * ci)).astype(np.float32)
        b, s, t = (0.1 * rng.randn(M, 4, ci), rng.rand(M, 4, ci) + 0.5, 0.2 * rng.randn(M, 4, ci))
    else:
        w = (rng.randn(M, co, 9 * ci) / np.sqrt(9 * ci)).astype(np.float32)
        b, s, t = (0.1 * rng.randn(M, co), rng.rand(M, ci) + 0.5, 0.2 * rng.randn(M, ci))
    return (x, w) + tuple(v.astype(np.float32) for v in (b, s, t))


@pytest.mark.parametrize("kind, M, B, ci, co, H, W, bf16", [
    ("res", 2, 1, 64, 64, 64, 64, False),     # the 128-pixel flagship's first res stage
    ("res", 1, 1, 264, 264, 16, 16, False),   # past the f32 cluster kernels' 256 channels
    ("feat", 2, 1, 64, 128, 64, 64, False),   # the 128-pixel flagship's second feature block
    ("res", 1, 1, 64, 64, 96, 96, True),      # 192-pixel frames' first res stage in bf16
    ("res", 2, 1, 128, 128, 32, 32, False),   # the 128-pixel flagship's third res stage
    ("res", 1, 1, 128, 128, 48, 48, True),    # 192-pixel frames' second res stage in bf16
    ("feat", 2, 1, 1, 1, 2, 536, True),       # the smallest bf16 feature pool no band fits
], ids=["f32-res-64@64x64", "f32-res-264@16x16", "f32-feat-64to128@64x64",
        "bf16-res-64@96x96", "f32-res-128@32x32", "bf16-res-128@48x48", "bf16-feat-1to1@2x536"])
def test_fused_kernels_past_the_cluster_form_match_pallas(kind, M, B, ci, co, H, W, bf16):
    """The shapes the cluster plans cannot take: each plan is the tiled
    form's, in a block's shared memory, and the port's result is JAX's."""
    args = _inputs(np.random.RandomState(ci + H), kind, M, B, ci, co, H, W)
    if kind == "res":
        plan = (pfr.res_stage_mma_plan if bf16 else pfr.res_stage_tf32_plan)(ci, H, W)
        jfn, pfn = jfr.fused_res_stage, pfr.fused_res_stage
    else:
        plan = (pfr.feat_pool_mma_plan if bf16 else pfr.feat_pool_tf32_plan)(ci, co, H, W)
        jfn, pfn = jfr.fused_feat_pool, pfr.fused_feat_pool
    assert isinstance(plan, pfr.TiledPlan) and plan.smem <= pfr.SMEM_MAX
    assert plan.group == ((128 if co > 64 else 64) if bf16 else
                          pfr.TF32_RES_GROUP if kind == "res" else pfr.TF32_POOL_GROUP)
    jcd, pcd = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    want = np.asarray(jax.vmap(lambda *a: jfn(*a, interpret=True, compute_dtype=jcd))(*args))
    got = _np(pfn(*map(T, args), compute_dtype=pcd))
    assert got.shape == want.shape
    if bf16:
        assert np.abs(got - want).max() <= TOL_FUSED_RES_BF16 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind, ci, co", [("res", 64, 64), ("res", 128, 128), ("feat", 64, 128),
                                           ("feat", 6, 20), ("res", 264, 264)])
def test_tf32_weight_image_holds_jax_weights(kind, ci, co):
    """The f32 tiled forms' weight image (``tf32_weight_image_plain``, what
    ``split_weights_kernel`` writes) of OIHW weights: hi and lo are TF32
    values (the low 13 bits zero), |lo| at most half an ulp of hi's, and
    hi + lo, read back at each weight's place, is JAX's tap-ordered weight
    (``dfd_tpu``'s ``reorder_conv_weight``) within 2^-22 of it."""
    rng = np.random.RandomState(ci + co)
    convs = 4 if kind == "res" else 1
    w_oihw = (rng.randn(2, convs, co, ci, 3, 3) / np.sqrt(9 * ci)).astype(np.float32)
    want = np.stack([np.stack([np.asarray(jfr.reorder_conv_weight(w_oihw[m, j]))
                               for j in range(convs)]) for m in range(2)])  # [2, J, co, 9ci]
    plan = (pfr.res_stage_tiled_plan(ci, 16, 16, "tf32") if kind == "res"
            else pfr.feat_pool_tiled_plan(ci, co, 16, 16, "tf32"))
    group, kc = plan.group, pfr.TF32_TILED_KC
    img = pfr.tf32_weight_image_plain(T(want), ci, group)
    ng, nk = -(-co // group), -(-ci // kc)
    assert img.shape == (2, convs, ng, nk, 2, 9, kc // 4, group, 4)
    bits = _np(img).view(np.uint32)
    assert not (bits & 0x1FFF).any()
    hi, lo = _np(img[:, :, :, :, 0]), _np(img[:, :, :, :, 1])
    assert (np.abs(lo) <= np.abs(hi) * 2.0 ** -11 + 1e-30).all()
    # [.., ng, nk, 9, kq, group, 4] -> [.., ng * group, 9, nk * kc]
    back = (hi.astype(np.float64) + lo).transpose(0, 1, 2, 6, 4, 3, 5, 7)
    back = back.reshape(2, convs, ng * group, 9, nk * kc)[:, :, :co, :, :ci]
    np.testing.assert_allclose(back.reshape(want.shape), want, rtol=2.0 ** -22, atol=0)


@pytest.mark.parametrize("kind, ci, co", [("res", 64, 64), ("res", 128, 128), ("feat", 64, 128),
                                           ("feat", 6, 20), ("res", 264, 264)])
def test_mma_weight_image_holds_jax_weights(kind, ci, co):
    """The bf16 tiled forms' weight image (``mma_weight_image_plain``, what
    ``round_weights_kernel`` writes) of OIHW weights, read back at each
    weight's place, is JAX's tap-ordered weight (``dfd_tpu``'s
    ``reorder_conv_weight``) rounded to bf16 as the Pallas kernel's dot
    rounds it (``astype(bfloat16)``, round to nearest even), bit for bit;
    the rest of the image is zero."""
    rng = np.random.RandomState(ci + co)
    convs = 4 if kind == "res" else 1
    w_oihw = (rng.randn(2, convs, co, ci, 3, 3) / np.sqrt(9 * ci)).astype(np.float32)
    want = np.stack([np.stack([np.asarray(jfr.reorder_conv_weight(w_oihw[m, j]))
                               for j in range(convs)]) for m in range(2)])  # [2, J, co, 9ci]
    want16 = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32))
    img = pfr.mma_weight_image_plain(T(want), ci)
    ng, nk = (2 if co > 64 else 1) * -(-(-(-co // 64)) // (2 if co > 64 else 1)), -(-ci // 16)
    assert img.shape == (2, convs, nk, ng, 9, 2, 64, 8)
    # [.., nk, ng, 9, 2, 64, 8] -> [.., ng * 64, 9, nk * 16]
    back = _np(img.float()).transpose(0, 1, 3, 6, 4, 2, 5, 7).reshape(2, convs, ng * 64, 9,
                                                                        nk * 16)
    np.testing.assert_array_equal(back[:, :, :co, :, :ci].reshape(want.shape), want16)
    assert not back[:, :, co:].any() and not back[:, :, :, :, ci:].any()


def test_flagship_at_128_pixels_takes_the_tiled_forms():
    """The f32 flagship at 128 x 128 frames (widths 64/128/128): three of its
    five fused calls take the tiled form, two keep the cluster kernels."""
    m = ImpalaPolicy((3, 128, 128), 5, channels=(64, 128, 128), hidden=512,
                     conv_impl="fused_feat", device=CPU)
    shapes = [("res", 64, 64, 64, 64), ("feat", 64, 128, 64, 64), ("res", 128, 128, 32, 32),
              ("feat", 128, 128, 32, 32), ("res", 128, 128, 16, 16)]
    assert [s.feat_fused for s in m._stages] == [False, True, True]
    assert all(s.res_fused for s in m._stages)
    tiled = []
    for kind, ci, co, H, W in shapes:
        plan = (pfr.res_stage_tf32_plan(ci, H, W) if kind == "res"
                else pfr.feat_pool_tf32_plan(ci, co, H, W))
        tiled.append(isinstance(plan, pfr.TiledPlan))
    assert tiled == [True, True, True, False, False]


def test_trainer_at_128_pixels_matches_jax_epoch_by_epoch(monkeypatch):
    """Three epochs of ``train(1)`` at 128 x 128 frames
    (``ProcMazeEnv(grid=16, scale=8)``) with the narrowest widths that reach
    the tiled res stage, (64, 16, 16): P = 4, Z = 2, 4 steps an episode, a
    learning rate and noise of 0.5 so that the policy's novelty leaves zero
    by the third epoch."""
    env_kw = dict(grid=16, scale=8, max_steps=4, num_levels=20)
    model_kw = dict(channels=(64, 16, 16), hidden=16, conv_impl="fused_feat")
    assert isinstance(pfr.res_stage_tf32_plan(64, 64, 64), pfr.TiledPlan)
    kw = dict(batch_size=4, learning_rate=0.5, noise_std=0.5, zeta_size=2,
              max_strategy_history_size=2, random_seed=5, noise_backend="pallas")
    jenv = JaxProcMazeEnv(**env_kw)
    jtr = JaxTrainer(JaxImpala(jenv.obs_shape, 5, **model_kw), jenv,
                     jax_distances.categorical_tvd, JaxTrainConfig(**kw))
    draws = {}
    penv = ProcMazeEnv(**env_kw, device=CPU)
    assert penv.obs_shape == (3, 128, 128)
    ptr = VectorizedTrainer(
        ImpalaPolicy(penv.obs_shape, 5, device=CPU, **model_kw), penv,
        distances.categorical_tvd, TrainConfig(**kw), device=CPU,
        draw_source=lambda epoch: draws[epoch],
    )
    ptr.state = train_state_from_numpy(jax_state_numpy(jtr.state), CPU)
    run_and_compare(jtr, ptr, draws, 3, monkeypatch)
    assert ptr.reporter.history[-1]["Policy Novelty"] > 0


# -- the swimmer at every link count ----------------------------------------------------

LINKS = [1, 2, 4, 6, 10, 15]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _cond(env, q, qdot) -> float:
    """The largest condition number of M + dt D over the episodes, in float64."""
    c = env.consts
    c64 = c._replace(T=c.T.double(), Aphi=c.Aphi.double(), M0=c.M0.double(), D0=c.D0.double())
    M, D, _ = sw.terms_closed(c64, q.double(), qdot.double())
    return float(np.linalg.cond(_np(M + c.dt * D)).max())


def _wave(t, n_joints):
    return np.sin(0.4 * np.float32(t) + 0.8 * np.arange(n_joints, dtype=np.float32)).astype(
        np.float32)


def _reset(n_links, n, seed, max_steps):
    env = SwimmerEnv(n_links=n_links, max_steps=max_steps, device=CPU)
    jenv = JaxSwimmerEnv(n_links=n_links, max_steps=max_steps)
    keys = jax.random.split(jax.random.key(seed), n)
    jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    state, obs = env.reset(n, T(env.reset_draw(np.asarray(jax.random.key_data(keys)))))
    return env, jenv, jstate, jobs, state, obs


def test_swimmer_constructs_and_steps_at_every_link_count():
    """Every count from 1 to 64 links builds and steps (the plain step, as
    the CPU runs it), its shapes JAX's; 65 is refused with the bound."""
    for n in range(1, sw.MAX_LINKS + 1):
        env = SwimmerEnv(n_links=n, max_steps=3, device=CPU)
        state, obs = env.reset(2, torch.zeros(2, *env.reset_shape))
        state, obs, reward, done = env.step(state, torch.full((2, n - 1), 0.5))
        assert obs.shape == (2, 2 * n + 2) and reward.shape == (2,) and not done.any()
        assert torch.isfinite(obs).all() and torch.isfinite(reward).all()
    with pytest.raises(ValueError, match="n_links must be 1 to 64"):
        SwimmerEnv(n_links=sw.MAX_LINKS + 1, device=CPU)


@pytest.mark.parametrize("n_links", LINKS)
def test_swimmer_reset_at_any_link_count_is_bit_exact(n_links):
    env, _, jstate, jobs, state, obs = _reset(n_links, 64, n_links, 20)
    assert env.obs_shape == (1 + (n_links - 1) + n_links + 2,) and env.action_dim == n_links - 1
    np.testing.assert_array_equal(_np(state.q), np.asarray(jstate.q))
    np.testing.assert_array_equal(_np(state.qdot), np.asarray(jstate.qdot))
    np.testing.assert_array_equal(_np(obs), np.asarray(jobs))


@pytest.mark.parametrize("n_links", LINKS)
def test_swimmer_step_and_episode_at_any_link_count_match_jax(n_links):
    """One step under uniform actions in [-1.2, 1.2], then a 20-step
    wave-gait episode, of 64 episodes from JAX's resets."""
    env, jenv, jstate, _, state, _ = _reset(n_links, 64, 10 + n_links, 20)
    jstep = jax.jit(jax.vmap(jenv.step))
    J = n_links - 1
    action = np.random.RandomState(n_links).uniform(-1.2, 1.2, (64, J)).astype(np.float32)
    cond = _cond(env, state.q, state.qdot)
    js, jobs, jr, _ = jstep(jstate, jnp.asarray(action))
    ps, pobs, pr, _ = env.step(state, T(action))
    tol = 2 * cond * EPS32
    assert _rel(_np(ps.qdot), js.qdot) <= tol and _rel(_np(pobs), jobs) <= tol
    assert np.abs(_np(pr) - np.asarray(jr)).max() <= tol
    worst = dict(q=0.0, qdot=0.0, reward=0.0)
    for t in range(20):
        cond = max(cond, _cond(env, state.q, state.qdot))
        act = np.broadcast_to(_wave(t, J), (64, J)).copy()
        jstate, _, jr, jd = jstep(jstate, jnp.asarray(act))
        state, _, pr, pd = env.step(state, T(act))
        worst["q"] = max(worst["q"], _rel(_np(state.q), jstate.q))
        worst["qdot"] = max(worst["qdot"], _rel(_np(state.qdot), jstate.qdot))
        worst["reward"] = max(worst["reward"], float(np.abs(_np(pr) - np.asarray(jr)).max()))
        np.testing.assert_array_equal(_np(state.t), np.asarray(jstate.t))
        np.testing.assert_array_equal(_np(pd), np.asarray(jd))
    tol = 2 * cond * EPS32
    assert max(worst.values()) <= tol, (worst, tol)
    assert pd.all()


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """``csrc/swimmer.cu`` compiled as plain C++ (``tests/test_torch_swimmer.py``'s
    build), once with its template forms, once with every count on the
    run-time form (``-DDFD_FORM_LINKS=0``: its register forms up to 32
    unknowns) and once with every count on the run-time form's shared-memory
    form (``-DDFD_REGISTER_ND=0`` too): each a step function over the
    kernel's argument struct."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's source for the host")
    steps = {}
    for name, flags in (("forms", []), ("runtime", ["-DDFD_FORM_LINKS=0"]),
                        ("shared", ["-DDFD_FORM_LINKS=0", "-DDFD_REGISTER_ND=0"])):
        lib = tmp_path_factory.mktemp("swimmer") / f"libswimmer_{name}.so"
        subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                        "-Wno-unknown-pragmas", *flags, "-o", str(lib),
                        str(sw.build.CSRC / "swimmer.cu")], check=True, capture_output=True)
        host = ctypes.CDLL(str(lib))
        host.dfd_swimmer_step_host.argtypes = [ctypes.POINTER(sw._Args), ctypes.c_int]
        host.dfd_swimmer_step_host.restype = ctypes.c_int
        steps[name] = host

    def step(which, c, q, qdot, t, action):
        N, nd = q.shape[0], c.ndof
        outs = (torch.empty(N, nd), torch.empty(N, nd), torch.empty(N, dtype=torch.int64),
                torch.empty(N, 2 * nd - 2), torch.empty(N), torch.empty(N, dtype=torch.bool))
        args = sw.kernel_args(c, (q, qdot, t, action), outs)
        assert steps[which].dfd_swimmer_step_host(ctypes.byref(args), c.n_links) == 0
        return outs

    return step


@pytest.mark.parametrize("n_links", [1, 2, 4, 6, 8, 12, 15, 18, 19, 30, 31, 32, 33, 63, 64])
def test_host_compiled_kernel_at_any_link_count_matches_plain(host_build, n_links):
    """The kernel's step (its template form up to ``FORM_LINKS`` links, its
    run-time form past them) against ``swimmer_step_plain`` at 33 states
    near the reset's (angles and velocities in [-0.1, 0.1]), actions in
    [-1.5, 1.5]: the conditioning bound; t and done exact."""
    env = SwimmerEnv(n_links=n_links, max_steps=100, device=CPU)
    c, rng = env.consts, np.random.RandomState(n_links)
    f32 = lambda *shape, lim: T(rng.uniform(-lim, lim, shape).astype(np.float32))
    q, qdot = f32(33, c.ndof, lim=0.1), f32(33, c.ndof, lim=0.1)
    a, t = f32(33, n_links - 1, lim=1.5), T(rng.randint(0, 100, 33).astype(np.int64))
    got, want = host_build("forms", c, q, qdot, t, a), sw.swimmer_step_plain(c, q, qdot, t, a)
    tol = 2 * _cond(env, q, qdot) * EPS32
    for k in (0, 1, 3, 4):  # q, qdot, obs, reward
        assert _rel(_np(got[k]), _np(want[k])) <= tol, k
    assert torch.equal(got[2], want[2]) and torch.equal(got[5], want[5])


def test_host_compiled_runtime_form_reruns_a_substep_on_the_exact_operators(host_build):
    """The run-time form at 15 links with one episode at rest, straight
    joints and torques of 1e-25 among 9 near the reset's (its substitutions'
    numerators below the 2^-60 of the card's branch-free divisions, so each
    substep is taken again on the compiler's operators after the state is
    restored): within the conditioning bound of the plain step, t and done
    exact, and the other episodes' outputs those of the batch without it,
    bit for bit."""
    env = SwimmerEnv(n_links=15, max_steps=100, device=CPU)
    c, rng = env.consts, np.random.RandomState(315)
    f32 = lambda *shape, lim: T(rng.uniform(-lim, lim, shape).astype(np.float32))
    ins = [f32(9, c.ndof, lim=0.1), f32(9, c.ndof, lim=0.1),
           T(rng.randint(0, 100, 9).astype(np.int64)), f32(9, 14, lim=1.5)]
    calm = host_build("forms", c, *ins)
    ins = [x.clone() for x in ins]
    ins[0][4, 3:], ins[1][4], ins[3][4] = 0.0, 0.0, ins[3][4] * 1e-25
    got, want = host_build("forms", c, *ins), sw.swimmer_step_plain(c, *ins)
    assert 0 < want[1][4].abs().max().item() < 2.0 ** -60
    tol = 2 * _cond(env, ins[0][4:5], ins[1][4:5]) * EPS32
    rel = lambda x, y: float((x.double() - y.double()).abs().max() / y.double().abs().max())
    v0 = c.ndof - 2  # where the velocities start in the observation
    assert rel(got[1][4], want[1][4]) <= tol and rel(got[3][4, v0:], want[3][4, v0:]) <= tol
    assert torch.equal(got[2], want[2]) and torch.equal(got[5], want[5])
    rest = [e for e in range(9) if e != 4]
    assert all(torch.equal(x[rest], y[rest]) for x, y in zip(got, calm))


@pytest.mark.parametrize("n_links", [1, 3, 7, 11])
def test_runtime_form_equals_the_template_forms(host_build, n_links):
    """The run-time form takes the template forms' operations in their
    order: on the host (no FMA contraction) the two give every output bit
    for bit, at 37 random states and actions."""
    c, rng = SwimmerEnv(n_links=n_links, device=CPU).consts, np.random.RandomState(n_links)
    f32 = lambda *shape, lim: T(rng.uniform(-lim, lim, shape).astype(np.float32))
    ins = (f32(37, c.ndof, lim=1.0), f32(37, c.ndof, lim=1.0),
           T(rng.randint(0, 100, 37).astype(np.int64)), f32(37, n_links - 1, lim=1.5))
    assert n_links <= sw.FORM_LINKS
    for a, b in zip(host_build("forms", c, *ins), host_build("runtime", c, *ins)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_links", [1, 3, 7, 11, 12, 15, 30])
def test_runtime_shared_memory_form_equals_the_other_forms(host_build, n_links):
    """The run-time form's shared-memory form (its route past 32 unknowns)
    takes the operations of the template forms (1 to 11 links) and of the
    register forms (12 to 30) in their order: on the host every output bit
    for bit, at 37 random states and actions."""
    c, rng = SwimmerEnv(n_links=n_links, device=CPU).consts, np.random.RandomState(50 + n_links)
    f32 = lambda *shape, lim: T(rng.uniform(-lim, lim, shape).astype(np.float32))
    ins = (f32(37, c.ndof, lim=1.0), f32(37, c.ndof, lim=1.0),
           T(rng.randint(0, 100, 37).astype(np.int64)), f32(37, n_links - 1, lim=1.5))
    for a, b in zip(host_build("forms", c, *ins), host_build("shared", c, *ins)):
        assert torch.equal(a, b)


# -- the jax noise backend past 65,535 draws --------------------------------------------


@pytest.mark.parametrize("antithetic", [False, True])
def test_normal_past_65535_draws_equals_jax(antithetic):
    """65,537 draws at d = 3 (131,074 rows when antithetic): the bits equal
    ``jax.random``'s, eps equals ``jax.random.normal``'s within 4e-6, and
    antithetic rows pair up as + and -."""
    draws, d = 65_537, 3
    base = jax.random.key(11)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(draws))
    kd = np.asarray(jax.vmap(jax.random.key_data)(jkeys))
    tkeys = T(kd.view(np.int32).copy())
    rows = 2 * draws if antithetic else draws
    eps, _ = nz.normal(tkeys, rows, d, antithetic=antithetic)
    assert eps.shape == (rows, d)
    bits = nz._uniform_bits(tkeys, d)
    want_bits = jax.vmap(lambda k: jax.random.bits(k, (d,), jnp.uint32))(jkeys)
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32), np.asarray(want_bits))
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (d,), jnp.float32))(jkeys))
    if antithetic:
        np.testing.assert_array_equal(_np(eps[1::2]), -_np(eps[0::2]))
        eps = eps[0::2]
    np.testing.assert_allclose(_np(eps), want, rtol=0, atol=TOL_EPS)
