"""The port's IMPALA pieces held against the JAX package's, on the CPU: the
fused torso kernels' plain versions against the Pallas kernels in interpret
mode (vmapped over members with their own weights), their weight helpers,
and ``ImpalaPolicy`` for every ``conv_impl`` (each against JAX's own
lowering of the same name).

Tolerances.  f32: rtol 1e-5 with atol 1e-5 for the kernels, whose outputs
are sums of 9C (up to 144) products of O(1) terms and of residuals up to
~10, taken in another order than the Pallas interpreter's dot; rtol 1e-5 /
atol 1e-6 for the model's probabilities and entropies.  bf16: both sides
round the same f32 operands to bf16 and accumulate in f32, but an f32
intermediate that differs by one ulp can round to the neighbouring bf16
value, so bf16 cases are held to atol 2e-3 relative to the output's scale.
Flat views, init draws and the reordered weights are exact; the BN folds
agree to one ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_tpu.models.impala import ImpalaPolicy as JaxImpala
from dfd_tpu.models import layers as jlayers
from dfd_tpu.ops import fused_resblock as jfr
from dfd_tpu_torch.convert import params_from_numpy
from dfd_tpu_torch.models import ImpalaPolicy
from dfd_tpu_torch.models import impala as ipm
from dfd_tpu_torch.models import layers as players
from dfd_tpu_torch.models.atari import batchnorm2d_eval
from dfd_tpu_torch.ops import fused_resblock as pfr

CPU = "cpu"
torch.set_num_threads(1)  # the suite runs under xdist: one thread per worker
T = torch.from_numpy
FRAME = (3, 32, 32)
SMALL = dict(channels=(8, 16, 16), hidden=32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jvmap(fn, *args, **kw):
    return np.asarray(jax.vmap(lambda *a: fn(*a, interpret=True, **kw))(*args))


def _stage_inputs(rng, M, B, C, H, W):
    x = rng.randn(M, B, C, H, W).astype(np.float32)
    w = (rng.randn(M, 4, C, 9 * C) / np.sqrt(9 * C)).astype(np.float32)
    b = rng.randn(M, 4, C).astype(np.float32) * 0.1
    s = (rng.rand(M, 4, C) + 0.5).astype(np.float32)
    t = rng.randn(M, 4, C).astype(np.float32) * 0.2
    return x, w, b, s, t


@pytest.mark.parametrize("M, B, C, H, W, bf16", [
    (3, 2, 8, 16, 16, False),
    (3, 2, 5, 8, 12, False),   # ragged: odd C, H != W, S = 96 (no lane multiple)
    (3, 2, 8, 16, 16, True),
], ids=["c8-16x16", "ragged-c5-8x12", "bf16"])
def test_res_stage_plain_matches_pallas(M, B, C, H, W, bf16):
    args = _stage_inputs(np.random.RandomState(C + H), M, B, C, H, W)
    jcd, pcd = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    want = _jvmap(jfr.fused_res_stage, *args, compute_dtype=jcd)
    got = pfr.fused_res_stage(*map(T, args), compute_dtype=pcd)
    assert got.shape == (M, B, C, H, W) and got.dtype == torch.float32
    if bf16:
        assert np.abs(_np(got) - want).max() <= 2e-3 * np.abs(want).max()
    else:
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def _feat_inputs(rng, M, B, ci, co, H, W):
    x = rng.randn(M, B, ci, H, W).astype(np.float32)
    w = (rng.randn(M, co, 9 * ci) * 0.3).astype(np.float32)
    b = rng.randn(M, co).astype(np.float32)
    s = (rng.rand(M, ci) + 0.5).astype(np.float32)
    t = rng.randn(M, ci).astype(np.float32)
    return x, w, b, s, t


@pytest.mark.parametrize("M, B, ci, co, H, W, bf16", [
    (3, 2, 8, 16, 16, 16, False),
    (3, 2, 5, 7, 16, 8, False),    # odd channels, rectangular (tests/test_impala.py:194)
    (3, 2, 8, 16, 16, 16, True),
], ids=["8to16-16x16", "odd-5to7-16x8", "bf16"])
def test_feat_pool_plain_matches_pallas(M, B, ci, co, H, W, bf16):
    args = _feat_inputs(np.random.RandomState(ci + co), M, B, ci, co, H, W)
    jcd, pcd = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    want = _jvmap(jfr.fused_feat_pool, *args, compute_dtype=jcd)
    got = pfr.fused_feat_pool(*map(T, args), compute_dtype=pcd)
    assert got.shape == (M, B, co, H // 2, W // 2)
    if bf16:
        assert np.abs(_np(got) - want).max() <= 2e-3 * np.abs(want).max()
    else:
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_feat_pool_refuses_column_vector_operands():
    """The TPU kernel's [c, 1] column-vector form of b/s/t (2-D per member)
    is refused with ValueError where JAX asserts; so are wrong shapes."""
    x, w, b, s, t = map(T, _feat_inputs(np.random.RandomState(0), 2, 1, 5, 7, 8, 8))
    with pytest.raises(AssertionError):
        jfr.fused_feat_pool(_np(x[0]), _np(w[0]), _np(b[0])[:, None], _np(s[0]), _np(t[0]),
                            interpret=True)
    for bad in ((b[..., None], s, t), (b, s[..., None], t), (b, s, t[..., None])):
        with pytest.raises(ValueError, match="1-D per member"):
            pfr.fused_feat_pool(x, w, *bad)
    with pytest.raises(ValueError, match=r"\[M, co, 9ci\]"):
        pfr.fused_feat_pool(x, w[:, :, :-1], b, s, t)
    xs, ws, bs, ss, ts = map(T, _stage_inputs(np.random.RandomState(1), 2, 1, 5, 8, 8))
    with pytest.raises(ValueError, match=r"\[M, 4, C\]"):
        pfr.fused_res_stage(xs, ws, bs[:, :3], ss, ts)


def _pair(impl="fused_feat", compute_dtype=None, seed=3, use_lstm=True):
    jcd = None if compute_dtype is None else jnp.bfloat16
    jm = JaxImpala(FRAME, 5, conv_impl=impl, compute_dtype=jcd, use_lstm=use_lstm, **SMALL)
    pm = ImpalaPolicy(FRAME, 5, conv_impl=impl, compute_dtype=compute_dtype, use_lstm=use_lstm,
                      device=CPU, **SMALL)
    params_np, bn_np = jm.init(seed)
    # running statistics away from (0, 1), so the BN folds are not identities
    rng = np.random.RandomState(seed)
    bn_np = {k: dict(v, mean=(rng.randn(*v["mean"].shape) * 0.1).astype(np.float32),
                     var=(rng.rand(*v["var"].shape) + 0.5).astype(np.float32))
             for k, v in bn_np.items()}
    _, bn = params_from_numpy(pm, params_np, bn_np, CPU)
    flat = jm.get_flat(params_np)
    flats = (flat[None] + 0.05 * np.random.RandomState(1).randn(3, flat.size)).astype(np.float32)
    jparams = jax.vmap(lambda v: jm.set_flat(v, xp=jnp))(flats)
    return jm, pm, bn_np, bn, flats, jparams, pm.set_flat(T(flats))


def test_weight_helpers_match_jax():
    """The reordered weights and biases are exact; the BN folds to 1 ulp
    (XLA may compute ``w / sqrt(v)`` as ``w * rsqrt(v)``)."""
    jm, pm, bn_np, bn, flats, _, pparams = _pair()
    for m in range(3):
        jp = jm.set_flat(flats[m])
        for k in (0, 1, 2):
            for got, want in zip(pfr.stage_weights(pparams, bn, k, players.BN_EPS),
                                 jfr.stage_weights(jp, bn_np, k, jlayers.BN_EPS)):
                np.testing.assert_allclose(_np(got[m]), np.asarray(want), rtol=2e-7, atol=0)
            for got, want in zip(pfr.feat_weights(pparams, bn, k, players.BN_EPS),
                                 jfr.feat_weights(jp, bn_np, k, jlayers.BN_EPS)):
                np.testing.assert_allclose(_np(got[m]), np.asarray(want), rtol=2e-7, atol=0)
            got_w, want_w = pfr.stage_weights(pparams, bn, k, players.BN_EPS)[0], \
                jfr.stage_weights(jp, bn_np, k, jlayers.BN_EPS)[0]
            np.testing.assert_array_equal(_np(got_w[m]), np.asarray(want_w))
        w = jp["res1_0_conv1"]["w"]
        np.testing.assert_array_equal(_np(pfr.reorder_conv_weight(T(w))),
                                      np.asarray(jfr.reorder_conv_weight(w)))
    assert pfr.fused_supported(16, 16) == jfr.fused_supported(16, 16)
    assert pfr.fused_supported(8, 8) == jfr.fused_supported(8, 8) is False


def test_batchnorm2d_eval_matches_jax():
    from dfd_tpu.models.atari import batchnorm2d_eval as jbn

    rng = np.random.RandomState(4)
    x = rng.randn(3, 2, 5, 4, 6).astype(np.float32)
    p = {"w": rng.rand(3, 5).astype(np.float32), "b": rng.randn(3, 5).astype(np.float32)}
    s = {"mean": rng.randn(5).astype(np.float32), "var": rng.rand(5).astype(np.float32) + 0.1}
    want = np.stack([np.asarray(jbn({k: v[m] for k, v in p.items()}, s, x[m])) for m in range(3)])
    got = batchnorm2d_eval({k: T(v) for k, v in p.items()}, {k: T(v) for k, v in s.items()}, T(x))
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-7)


def test_linear_bf16_and_lstm_step_match_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(3, 4, 33).astype(np.float32)
    p = {"w": rng.randn(3, 16, 33).astype(np.float32), "b": rng.randn(3, 16).astype(np.float32)}
    want = np.stack([np.asarray(jlayers.linear({k: v[m] for k, v in p.items()}, x[m],
                                               compute_dtype=jnp.bfloat16)) for m in range(3)])
    got = players.linear({k: T(v) for k, v in p.items()}, T(x), compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    from dfd_tpu.models.impala import lstm_step as jlstm

    H = 8
    lp = {"w_ih": rng.randn(3, 4 * H, 9), "w_hh": rng.randn(3, 4 * H, H),
          "b_ih": rng.randn(3, 4 * H), "b_hh": rng.randn(3, 4 * H)}
    lp = {k: (v * 0.3).astype(np.float32) for k, v in lp.items()}
    xs, h, c = (rng.randn(3, n).astype(np.float32) for n in (9, H, H))
    want_h, (_, want_c) = jax.vmap(lambda q, a, b_, c_: jlstm(q, a, (b_, c_)))(lp, xs, h, c)
    got_h, (_, got_c) = players.lstm_step({k: T(v) for k, v in lp.items()}, T(xs)[:, None],
                                          (T(h)[:, None], T(c)[:, None]))
    np.testing.assert_allclose(_np(got_h[:, 0]), np.asarray(want_h), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(got_c[:, 0]), np.asarray(want_c), rtol=1e-5, atol=1e-6)


def test_init_is_bit_exact_and_the_spec_matches():
    jm, pm = JaxImpala(FRAME, 5, **SMALL), ImpalaPolicy(FRAME, 5, device=CPU, **SMALL)
    assert pm.param_spec.entries == jm.param_spec.entries
    assert pm.state_spec.entries == jm.state_spec.entries
    for seed in (0, 7):
        jp, js = jm.init(seed)
        pp, ps = pm.init(seed)
        np.testing.assert_array_equal(pm.get_flat(pp).numpy(), jm.get_flat(jp))
        for name in js:
            for k in js[name]:
                np.testing.assert_array_equal(ps[name][k].numpy(), js[name][k])
    assert pm.num_params == jm.num_params == 42_523


@pytest.mark.parametrize("impl", ["lax", "patches", "nhwc", "split", "fused", "fused_feat"])
def test_forwards_match_jax(impl):
    """apply, strategy, entropy and apply_seq (real rewards) on a perturbed
    population of M = 3."""
    jm, pm, bn_np, bn, flats, jparams, pparams = _pair(impl)
    rng = np.random.RandomState(6)
    frames = (rng.rand(4, *FRAME) * 255).astype(np.float32)
    for fn in ("apply", "strategy", "entropy"):
        want = jax.vmap(lambda p: getattr(jm, fn)(p, bn_np, frames))(jparams)
        np.testing.assert_allclose(_np(getattr(pm, fn)(pparams, bn, T(frames))), np.asarray(want),
                                   rtol=1e-5, atol=1e-6, err_msg=fn)
    seq = (rng.rand(3, 5, *FRAME) * 255).astype(np.float32)
    rew = rng.randn(3, 5).astype(np.float32) * 2
    want = jax.vmap(lambda p, f, r: jm.apply_seq(p, bn_np, f, r))(jparams, seq, rew)
    got = pm.apply_seq(pparams, bn, T(seq), T(rew))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


ACT_IMPLS = ("lax", "patches", "nhwc", "split", "fused_feat")


@pytest.mark.parametrize("impl, compute_dtype", [pytest.param(i, None, id=i) for i in ACT_IMPLS]
                         + [pytest.param(i, torch.bfloat16, id=f"{i}-bf16") for i in ACT_IMPLS])
def test_act_step_reproduces_jax(impl, compute_dtype):
    """Two chained steps with JAX's Gumbel draws: actions exact, entropy and
    carry to float32 rounding (float32 operands); prepare() changes nothing
    but the speed, bit for bit, with float32 or bf16 operands.  The port
    steps E episodes a member: here E = 1."""
    jm, pm, bn_np, bn, flats, jparams, pparams = _pair(impl, compute_dtype)
    M = 3
    rng = np.random.RandomState(8)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(2), i))(jnp.arange(M))
    det = np.array([False, True, False])
    gumbel = np.array(jax.vmap(lambda k: jax.random.gumbel(k, (5,), jnp.float32))(keys))
    jcarry = jax.vmap(lambda _: jm.initial_carry())(jnp.arange(M))
    pcarry = tuple(c[:, None] for c in pm.initial_carry(M))
    prepared = pm.prepare(pparams, bn)
    prev_reward = np.zeros(M, np.float32)
    for step in range(2):
        obs = (rng.rand(M, *FRAME) * 255).astype(np.float32)
        got_a, got_e, pcarry = pm.act_step(prepared, bn, T(obs)[:, None], T(prev_reward)[:, None],
                                           torch.zeros((M, 1), dtype=torch.bool), pcarry, T(det),
                                           T(gumbel)[:, None])
        if compute_dtype is None:  # bf16 is held to JAX by the bf16 tests below
            want_a, want_e, jcarry = jax.vmap(
                lambda p, o, r, c, k, d: jm.act_step(p, bn_np, o, r, False, c, k, d)
            )(jparams, obs, prev_reward, jcarry, keys, det)
            np.testing.assert_array_equal(_np(got_a)[:, 0], np.asarray(want_a))
            np.testing.assert_allclose(_np(got_e)[:, 0], np.asarray(want_e), rtol=1e-5, atol=1e-6)
            for a, b in zip(pcarry, jcarry):
                np.testing.assert_allclose(_np(a)[:, 0], np.asarray(b), rtol=1e-5, atol=1e-6)
        prev_reward = np.array([3.0, -0.5, 0.25], np.float32)  # clipped to [-1, 1]
    carry0 = tuple(c.reshape(M, 2, -1) for c in pm.initial_carry(2 * M))
    two = lambda v: torch.stack([v, v], dim=1)  # E = 2 episodes a member
    unprepared = pm.act_step(pparams, bn, two(T(obs)), two(T(prev_reward)),
                             torch.zeros((M, 2), dtype=torch.bool), carry0, T(det),
                             two(T(gumbel)))
    again = pm.act_step(prepared, bn, two(T(obs)), two(T(prev_reward)),
                        torch.zeros((M, 2), dtype=torch.bool), carry0, T(det), two(T(gumbel)))
    for a, b in zip(unprepared[:2] + unprepared[2], again[:2] + again[2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["patches", "nhwc", "fused_feat"])
def test_bf16_prepare_keeps_the_rounded_weights_bit_for_bit(impl):
    """A bf16 prepare() keeps fc's weight and those of the convs off the
    kernels as ``w.to(bfloat16).to(float32)``; the fused stages' convs get
    none, and the source weights are left as they were."""
    _, pm, _, bn, _, _, pparams = _pair(impl, torch.bfloat16)
    prepared = pm.prepare(pparams, bn)
    off = {f"feat{k}_conv" for k, s in enumerate(pm._stages) if not s.feat_fused}
    off |= {f"res{r}_{k}_conv{j}" for k, s in enumerate(pm._stages) if not s.res_fused
            for r in (1, 2) for j in (1, 2)}
    assert set(pm._rounded_layers) == off | {"fc"}
    assert impl != "fused_feat" or len(off) < 15  # FRAME fuses some stages
    for name, p in prepared.items():
        if not isinstance(p, dict) or name == ipm._PREPARED:
            continue
        assert players.ROUNDED not in pparams[name]
        if name not in off | {"fc"}:
            assert players.ROUNDED not in p, name
            continue
        image, w = p[players.ROUNDED], pparams[name]["w"]
        assert image.dtype == torch.float32 and image.shape == w.shape
        assert torch.equal(image, w.to(torch.bfloat16).to(torch.float32)), name
        assert not torch.equal(image, w), name
        assert p["w"] is w and p["b"] is pparams[name]["b"]


@pytest.mark.parametrize("impl", ["patches", "nhwc", "fused_feat"])
def test_float32_prepare_adds_no_rounded_weights(impl):
    _, pm, _, bn, _, _, pparams = _pair(impl)
    prepared = pm.prepare(pparams, bn)
    assert set(prepared) == set(pparams) | {ipm._PREPARED}
    for name in pparams:
        assert prepared[name] is pparams[name]


def test_forward_without_lstm_matches_jax():
    """use_lstm=False: the clipped reward goes straight to the head, and the
    carry is empty."""
    jm, pm, bn_np, bn, flats, jparams, pparams = _pair(use_lstm=False)
    assert pm.num_params == jm.num_params and pm.initial_carry(3) == ()
    rng = np.random.RandomState(10)
    seq = (rng.rand(3, 4, *FRAME) * 255).astype(np.float32)
    rew = rng.randn(3, 4).astype(np.float32) * 2
    want = jax.vmap(lambda p, f, r: jm.apply_seq(p, bn_np, f, r))(jparams, seq, rew)
    got = pm.apply_seq(pparams, bn, T(seq), T(rew))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_bf16_forward_matches_jax():
    jm, pm, bn_np, bn, flats, jparams, pparams = _pair("fused_feat", torch.bfloat16)
    frames = (np.random.RandomState(9).rand(4, *FRAME) * 255).astype(np.float32)
    want = np.asarray(jax.vmap(lambda p: jm.apply(p, bn_np, frames))(jparams))
    got = _np(pm.apply(pparams, bn, T(frames)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("impl", ["lax", "nhwc", "split"])
def test_bf16_lowerings_match_jax(impl):
    """bf16 operands on each unfused lowering, against JAX's own lowering at
    the bf16 cases' tolerance (module docstring).  XLA's CPU backend has no
    bf16 x bf16 -> f32 dot for ``split``'s einsum, so there the einsum
    takes its bf16 operands widened to f32 (exactly) with the f32 result
    that ``preferred_element_type`` asks for: the same products and sums."""
    import types

    from dfd_tpu.models import impala as jimpala

    jm, pm, bn_np, bn, flats, jparams, pparams = _pair(impl, torch.bfloat16)
    frames = (np.random.RandomState(9).rand(4, *FRAME) * 255).astype(np.float32)
    widen = lambda *ops, **kw: jnp.einsum(*(o.astype(jnp.float32) if hasattr(o, "astype") else o
                                            for o in ops), **kw)
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.einsum = widen
    with pytest.MonkeyPatch.context() as mp:
        if impl == "split":
            mp.setattr(jimpala, "jnp", proxy)
        want = np.asarray(jax.vmap(lambda p: jm.apply(p, bn_np, frames))(jparams))
    got = _np(pm.apply(pparams, bn, T(frames)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("impl", ["lax", "nhwc", "split"])
def test_vbn_lowerings_match_jax(impl):
    """The VBN refresh on each lowering's own conv (``nhwc``'s is the patches
    conv, as in JAX): every BatchNorm's statistics within rtol 1e-5 under
    ``utils/closeness.py``'s rule."""
    from _torch_port import assert_bn_close

    jm, pm, bn_np, bn, flats, jparams, pparams = _pair(impl)
    rng = np.random.RandomState(12)
    buf = (rng.rand(6, *FRAME) * 255).astype(np.float32)
    rew = rng.randn(6).astype(np.float32)
    want = jm.vbn(jm.set_flat(flats[0]), bn_np, buf, rew)
    got = pm.vbn(pm.set_flat(T(flats[:1])), bn, T(buf), rewards=T(rew))
    assert_bn_close(got, jax.tree.map(np.asarray, want), impl)


def test_unported_options_raise():
    """Every conv lowering of the JAX model builds; an unknown one, and a
    compute dtype other than bfloat16, raise."""
    from dfd_tpu.models.impala import CONV_IMPLS as JAX_CONV_IMPLS

    for impl in JAX_CONV_IMPLS:
        assert ImpalaPolicy(FRAME, 5, conv_impl=impl, device=CPU).conv_impl == impl
    with pytest.raises(ValueError, match="conv_impl"):
        ImpalaPolicy(FRAME, 5, conv_impl="winograd", device=CPU)
    with pytest.raises(ValueError, match="compute_dtype"):
        ImpalaPolicy(FRAME, 5, compute_dtype=torch.float16, device=CPU)


def test_params_from_numpy_carries_the_lstm_and_bn_state():
    jm = JaxImpala(FRAME, 5, **SMALL)
    pm = ImpalaPolicy(FRAME, 5, device=CPU, **SMALL)
    params_np, bn_np = jm.init(1)
    params, bn = params_from_numpy(pm, params_np, bn_np, CPU)
    np.testing.assert_array_equal(pm.get_flat(params).numpy(), jm.get_flat(params_np))
    assert params["lstm"]["w_hh"].shape == (4 * 32, 32)
    assert set(bn["fc_bn"]) == {"mean", "var", "n"}
    del params_np["lstm"]
    with pytest.raises(ValueError, match="lstm"):
        params_from_numpy(pm, params_np, bn_np, CPU)


def test_the_main_path_shapes_take_every_kernel():
    """At the flagship's frames (3x64x64, 16/32/32) fused_feat runs the res
    kernel at stages 0-1 and the feat kernel at stages 1-2, as JAX gates."""
    pm = ImpalaPolicy((3, 64, 64), 5, conv_impl="fused_feat", device=CPU)
    assert [(s.feat_fused, s.res_fused) for s in pm._stages] == [
        (False, True), (True, True), (True, False)]
    assert pm.num_params == JaxImpala((3, 64, 64), 5).num_params == 1_156_139


def test_entry_point_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ImpalaPolicy(FRAME, 5)
