"""The Hopper probes' plain versions held against the TPU probes' own Pallas kernels.

Each ``tools/probe_pallas_*.py`` is loaded from its path and run as it is,
with ``pallas_call`` in interpret mode (patched for the test only).  The
test catches each case's output through the probe's own helper (``run`` in
the pool and torso probes, ``bench`` in the wide probe) or through
``jax.block_until_ready``; a hook that has what it needs raises, so that the
probe's timing loop is skipped (the probe's own ``try`` reports it and goes
on to the next case).  The same numpy inputs then go through the port's
wrappers, which run their plain versions on CPU tensors.

Tolerances: data movement bit-exact; float32 products and chains within
1e-5 x max(1, |want|) (sums in another order); bf16 chains within 4e-3 x
max(1, |want|), since both sides round the same f32 operands to bf16 but an
f32 intermediate one ulp apart can round to the neighbouring bf16 value.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import _torch_port  # noqa: F401  (one torch thread per xdist worker)
from dfd_tpu_torch.ops import gemm_chain as gc
from dfd_tpu_torch.ops import relayout as rl
from dfd_tpu_torch.ops import res_chain as rc
from dfd_tpu_torch.probes import gemm as pgemm
from dfd_tpu_torch.probes import pool as ppool
from dfd_tpu_torch.probes import torso as ptorso
from dfd_tpu_torch.probes import wide as pwide

ROOT = Path(__file__).resolve().parents[1]
TOL_F32, TOL_BF16 = 1e-5, 4e-3
T = torch.from_numpy


class _Captured(Exception):
    """Raised by a hook once it holds the output it needs."""


class _Stop(BaseException):
    """Raised by a hook to leave a probe's ``main`` (no ``try`` catches it)."""


def _close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape
    if tol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= tol * scale


@pytest.fixture
def load(monkeypatch):
    """Loads ``tools/<name>.py`` with ``pallas_call`` in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(sys, "path", list(sys.path))  # the probes prepend to it

    def _load(name):
        spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    return _load


def _capture_ready(monkeypatch, stop_after=None):
    """Patches ``jax.block_until_ready`` to record each output and raise
    ``_Captured`` (``_Stop`` once ``stop_after`` outputs are held)."""
    seen = []

    def hook(x):
        seen.append(np.asarray(x))
        if stop_after is not None and len(seen) >= stop_after:
            raise _Stop
        raise _Captured("output captured")  # the probe's handler prints the first line

    monkeypatch.setattr(jax, "block_until_ready", hook)
    return seen


def _capture_run(monkeypatch, probe):
    """Patches the probe's ``run(name, fn, *args)`` to record each output by name."""
    seen = {}

    def run(name, fn, *args, check=None):
        seen[name] = np.asarray(jax.jit(fn)(*args))
        return seen[name]

    monkeypatch.setattr(probe, "run", run)
    return seen


@pytest.mark.parametrize("M, K, N, iters, mode", [
    (16, 24, 8, 3, "acc"),
    (16, 24, 8, 3, "feed"),
    (9, 130, 70, 5, "acc"),
    (70, 33, 9, 4, "feed"),
], ids=["acc", "feed", "acc-ragged", "feed-ragged"])
def test_gemm_chain_plain_matches_pallas(load, monkeypatch, M, K, N, iters, mode):
    probe = load("probe_pallas_gemm")
    seen = _capture_ready(monkeypatch)
    with pytest.raises(_Captured):
        probe.gemm_chain(M, K, N, iters, mode=mode)
    rng = np.random.RandomState(0)
    a = rng.randn(M, K).astype(np.float32) * 0.01
    b = rng.randn(K, N).astype(np.float32) * 0.01
    _close(gc.gemm_chain(T(a), T(b), iters, mode), seen[0], TOL_F32)


def test_gemm_feed_scale_rounds_to_one():
    """``feed``'s 1 + y[0, 0] * 1e-20 is 1 in float32 at the probes' values,
    so its chain ends on a @ b exactly."""
    rng = np.random.RandomState(0)
    a = T(rng.randn(1024, 144).astype(np.float32) * 0.01)
    b = T(rng.randn(144, 16).astype(np.float32) * 0.01)
    y = a @ b
    assert float(1.0 + y[0, 0] * 1e-20) == 1.0 and float(1.0 + torch.tensor(6e12) * 1e-20) > 1
    np.testing.assert_array_equal(gc.gemm_chain(a, b, 3, "feed").numpy(), y.numpy())


def test_torso_probe_plain_matches_pallas(load, monkeypatch):
    probe = load("probe_pallas_torso")
    runs = _capture_run(monkeypatch, probe)
    gemms = _capture_ready(monkeypatch)
    probe.main()
    x = T(np.random.RandomState(0).randn(128, 1024).astype(np.float32))
    cases = ptorso.relayout_cases(x)
    assert sorted(runs) == sorted(name for name, *_ in cases)
    for name, _, kernel_call, _, _ in cases:
        _close(kernel_call(), runs[name], 0.0)
    assert len(gemms) == len(ptorso.GEMM_SHAPES)
    rng = np.random.RandomState(0)
    for (_, M, K, N), want in zip(ptorso.GEMM_SHAPES, gemms):
        a, b = T(rng.randn(M, K).astype(np.float32)), T(rng.randn(K, N).astype(np.float32))
        _close(gc.gemm_chain(a, b, ptorso.ITERS, "acc_scaled"), want, TOL_F32)


def test_pool_probe_plain_matches_pallas(load, monkeypatch):
    """Candidates A-D, the three fused chains and the XLA chain."""
    probe = load("probe_pallas_pool")
    runs = _capture_run(monkeypatch, probe)
    chains = _capture_ready(monkeypatch, stop_after=4)
    with pytest.raises(_Stop):
        probe.main()
    x = np.random.RandomState(0).randn(16, 4096).astype(np.float32)
    idx = ppool.even_positions(64, 64)
    xt = np.random.RandomState(1).randn(48, 1024).astype(np.float32)
    sel = np.zeros((4096, 1024), np.float32)
    sel[idx, np.arange(1024)] = 1.0
    _close(rl.gather_cols(T(x), T(idx)), runs["A jnp.take lanes"], 0.0)
    _close(rl.strided_copy(T(x)[:, ::2]), runs["B lax.slice stride-2 lanes"], 0.0)
    _close(rl.transpose(T(x)), runs["C transpose [16,4096]->[4096,16]"], 0.0)
    _close(rl.transpose(T(xt)), runs["C2 transpose [48,1024]->[1024,48]"], 0.0)
    _close(gc.gemm_chain(T(x), T(sel), 1), runs["D Sel-GEMM"], TOL_F32)

    rng = np.random.RandomState(2)
    xs = T(rng.randn(64, 16, 1024).astype(np.float32) * 0.1)
    ws = T(rng.randn(64, 4, 16, 144).astype(np.float32) * 0.05)
    bs = T(rng.randn(64, 4, 16).astype(np.float32) * 0.01)
    xs_m, ws_m = xs.transpose(1, 2).contiguous(), ws.transpose(2, 3).contiguous()
    _close(rc.res_chain(xs, ws, bs, 32, 32, "channel_major"), chains[0], TOL_F32)
    _close(rc.res_chain(xs_m, ws_m, bs, 32, 32, "channel_minor"), chains[1], TOL_F32)
    _close(rc.res_chain(xs_m, ws_m, bs, 32, 32, "channel_minor", torch.bfloat16), chains[2],
           TOL_BF16)
    # the XLA chain reads each weight row in the patches' (c, dy, dx) order
    _close(pwide.patches_chain(xs, ws.reshape(64, 4, 16, 16, 3, 3), bs, 32, 32), chains[3],
           TOL_F32)


@pytest.mark.parametrize("P, C, H, W", [(2, 8, 8, 8), (3, 12, 5, 7)], ids=["c8-8x8", "ragged"])
def test_wide_probe_plain_matches_pallas(load, monkeypatch, P, C, H, W):
    """Both layouts and both types of the fused chain, and the XLA chain."""
    probe = load("probe_pallas_wide")
    seen = []

    def bench(f, args, n=20):
        seen.append(([np.array(a) for a in args], np.asarray(f(*args))))
        return 1.0

    monkeypatch.setattr(probe, "bench", bench)
    probe.probe_stage(P, C, H, W)
    variants = [("channel_major", None), ("channel_major", torch.bfloat16),
                ("channel_minor", None), ("channel_minor", torch.bfloat16)]
    assert len(seen) == len(variants) + 2
    for (layout, cd), (args, want) in zip(variants, seen):
        x, w, b = (T(a) for a in args[:3])
        got = rc.res_chain(x, w, b, H, W, layout, cd)
        _close(got, want, TOL_F32 if cd is None else TOL_BF16)
        if cd is not None:  # the bf16 path rounds: nearer JAX's bf16 result than f32 is
            f32 = rc.res_chain(x, w, b, H, W, layout).numpy()
            assert np.abs(got.numpy() - want).max() < np.abs(f32 - want).max()
    for cd, (args, want) in zip((None, torch.bfloat16), seen[len(variants):]):
        x, w, b = (T(a) for a in args)
        got = pwide.patches_chain(x, w.reshape(P, 4, C, C, 3, 3), b, H, W, cd)
        _close(got, want, TOL_F32 if cd is None else TOL_BF16)


def test_port_probes_ask_the_tpu_probes_cases(load, monkeypatch):
    """The gemm probe's calls and the wide probe's stages are the TPU probes'."""
    gemm = load("probe_pallas_gemm")
    calls = []
    monkeypatch.setattr(gemm, "gemm_chain",
                        lambda M, K, N, iters, mode="acc": calls.append((M, K, N, iters, mode)))
    gemm.main()
    assert tuple(calls) == pgemm.CASES
    wide = load("probe_pallas_wide")
    stages = []
    monkeypatch.setattr(wide, "probe_stage", lambda P, C, H, W: stages.append((P, C, H, W)))
    monkeypatch.setattr(sys, "argv", ["probe_pallas_wide.py"])
    wide.main()
    assert tuple(stages) == tuple((64, *s) for s in pwide.STAGES)


@pytest.mark.parametrize("name, kwargs, n_rows", [
    ("gemm", dict(cases=((16, 24, 8, 3, "acc"), (9, 5, 70, 2, "feed"))), 2),
    ("torso", dict(rows=8, cols=128, gemm_shapes=(("g", 16, 27, 40),), iters=3), 9),
    ("pool", dict(C=4, H=8, W=8, P=2, Cs=8, Hs=8, Ws=8), 8),
    ("wide", dict(P=2, stages=((8, 8, 8), (5, 6, 7))), 8),
])
def test_port_probe_runs_on_the_cpu(name, kwargs, n_rows):
    """Each Hopper probe's ``run`` end to end at a small size on the CPU,
    where its wrappers run their plain versions (a rehearsal: the times are
    the host's).  Every row is checked and launches nothing here."""
    mod = {"gemm": pgemm, "torso": ptorso, "pool": ppool, "wide": pwide}[name]
    rows = mod.run(device="cpu", n=1, **kwargs)
    assert len(rows) == n_rows
    for row in rows:
        assert row["device"] == "cpu" and row["launches"] == 0
        assert np.isfinite(row["max_abs_err"]) and row["ms"] > 0 and row["bound_ms"] >= 0
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.run()
