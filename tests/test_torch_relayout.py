"""The launch plans of the roll and strided copy kernels, on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``); their plan
is a Python mirror (``ops/relayout.py::rows_plan``) that the C entry points
recompute and refuse to differ from.  Checked here: each probe case and each
case at the production shape takes the route its design expects (a
contiguous view one flat row, unit-stride rows float4 loads and stores,
strided or shifted lanes scalar loads under float4 stores, odd rows scalar,
offsets past 2^31 the 64-bit kernels); and, for ragged shapes, shifts and
storage offsets, the kernel's index arithmetic (``csrc/relayout.cu::
copy_rows``: a thread's first row, then fixed increments with one carry, in
32- or 64-bit unsigned offsets) emulated in numpy writes each output element
exactly once, from the right source element, with every float4 aligned.
"""

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per xdist worker)
from dfd_tpu_torch.ops import relayout as rl

R, L = 128, 1024          # the torso probe's x
PR, PL = 33280, 1024      # impala_prod_bf16's stage-0 novelty activation, as rows of 1024
WIDE = 2 ** 30 + 8        # a [2, WIDE] tensor's last offset passes 2^31


def _view_plan(view: torch.Tensor, addr: int = 0) -> rl.RowsPlan:
    pad = 3 - view.ndim
    return rl.strided_copy_plan(addr, (1,) * pad + tuple(view.shape),
                                (0,) * pad + tuple(view.stride()))


def _views(rows: int, cols: int, cols3: int):
    """The probe's and the production phase's strided copies of ``x [rows, cols]``."""
    x = torch.empty(rows, cols, device="meta")
    x3 = x.view(rows, cols // cols3, cols3)
    return {"x[::2, :]": x[::2, :], "x[:, ::2]": x[:, ::2], "x3[:, ::2, :]": x3[:, ::2, :],
            "reshape": x3}


ROUTES = {
    "x[::2, :]": "rows, vector", "x[:, ::2]": "flat, aligned stores",
    "x3[:, ::2, :]": "rows, vector", "reshape": "flat, vector",
}


@pytest.mark.parametrize("rows, cols, cols3, unroll", [(R, L, 64, 1), (PR, PL, 32, 4)],
                         ids=["probe", "production"])
def test_probe_and_production_routes(rows, cols, cols3, unroll):
    # rolls: along lanes rows of cols, float4 loads where the shift is a multiple of 4;
    # along rows one flat row
    expect = {(1, 1): "rows, aligned stores", (64, 1): "rows, vector", (32, 1): "rows, vector",
              (1, 0): "flat, vector"}
    for (shift, axis), route in expect.items():
        p = rl.roll_plan(0, rows, cols, shift, axis)
        assert p.route == route + ", 32-bit" and p.unroll == unroll
    for name, view in _views(rows, cols, cols3).items():
        p = _view_plan(view)
        assert p.route == ROUTES[name] + ", 32-bit" and p.unroll == unroll, name
        # no block without work; and at the production shape the card is full
        assert (p.bx - 1) * p.g * p.unroll < p.L // p.width
        assert (p.by - 1) * (rl.THREADS // p.g) < p.n0 * p.n1
        assert p.bx * p.by >= (rl.MAX_BLOCKS if unroll > 1 else 16)
    # the reshape copy is one flat row of every element; x3[:, ::2, :] merges its two outer axes
    assert _view_plan(_views(rows, cols, cols3)["reshape"])[:3] == (1, 1, rows * cols)
    assert _view_plan(_views(rows, cols, cols3)["x3[:, ::2, :]"])[:3] == (
        1, rows * cols // cols3 // 2, cols3)


def test_pool_probe_and_odd_routes():
    assert _view_plan(torch.empty(16, 4096, device="meta")[:, ::2]).route == (
        "flat, aligned stores, 32-bit")
    # a storage offset off 16 bytes: scalar loads under aligned stores
    assert rl.roll_plan(4, R, L, 4, 1).route == "rows, aligned stores, 32-bit"
    assert _view_plan(torch.empty(R, L, device="meta")[:, 4:], 4).route == (
        "rows, aligned stores, 32-bit")
    # odd rows: scalar stores; one flat odd row: float4 stores and a short last unit
    for cols in (1, 3, 5):
        assert rl.roll_plan(0, 2 ** 20, cols, cols - 1, 1).route == "rows, scalar, 32-bit"
    assert _view_plan(torch.empty(7, 130, device="meta")).route == "flat, vector, 32-bit"
    assert rl.roll_plan(0, 7, 130, 2, 0).route == "flat, aligned stores, 32-bit"
    # past 2^31: the 64-bit kernels
    x = torch.empty(2, WIDE, device="meta")
    assert rl.roll_plan(0, 2, WIDE, 1, 1).route == "rows, aligned stores, 64-bit"
    assert rl.roll_plan(0, 2, WIDE, 1, 0).route == "flat, vector, 64-bit"
    assert _view_plan(x[:, 3:]).route == "rows, scalar, 64-bit"
    assert _view_plan(x[:, ::2]).route == "flat, aligned stores, 64-bit"
    assert _view_plan(torch.empty(2 ** 31 - 8192, device="meta")).wide == 0


def test_many_short_rows_loop_over_grid_strides():
    """A [2^20, 1] roll has more row runs than fill the card: the grid stops
    at MAX_BLOCKS and each thread loops over rows."""
    p = rl.roll_plan(0, 2 ** 20, 1, 0, 1)
    assert (p.g, p.unroll, p.bx) == (1, rl.UNROLL, 1) and p.by == rl.MAX_BLOCKS
    assert p.by * rl.THREADS // p.g < 2 ** 20


# -- the kernel's index arithmetic, emulated ----------------------------------------------


def _emulate(p: rl.RowsPlan, x_off: int, wrap: bool):
    """(output index, source index) of every element the kernel writes,
    following ``copy_rows`` step by step in the kernel's unsigned offsets;
    asserts every float4 load and store lies on a 16-byte boundary."""
    with np.errstate(over="ignore"):
        return _emulate_steps(p, x_off, wrap)


def _emulate_steps(p: rl.RowsPlan, x_off: int, wrap: bool):
    U = np.uint64 if p.wide else np.uint32
    rows, W = p.n0 * p.n1, p.width
    units = -(-p.L // W)
    per_block = rl.THREADS // p.g
    bx, by, t = np.meshgrid(np.arange(p.bx), np.arange(p.by), np.arange(rl.THREADS),
                            indexing="ij")
    bx, by, t = bx.ravel(), by.ravel(), t.ravel()
    r = (by * per_block + t // p.g).astype(U)
    live = r < rows
    r, bx, t = r[live], bx[live], t[live]
    live = np.ones(r.shape, bool)
    n1, s0, s1 = U(p.n1), U(p.s0), U(p.s1)
    step = U(p.by * per_block)
    i1, src = r, r * s1  # one outer index (n0 == 1): no division
    if rows != p.n1:
        i1 = r % n1
        src = (r // n1) * s0 + i1 * s1
    dst = r * U(p.L)
    q, rem = step // n1, step % n1  # on the host
    d_src, carry = q * s0 + rem * s1, s0 - n1 * s1
    d_dst = step * U(p.L)
    j0 = bx * p.g * p.unroll + t % p.g
    outs, srcs = [], []
    while live.any():
        for u in range(p.unroll):
            j = j0 + u * p.g
            ok = live & (j < units)
            full = j[ok] * W + W <= p.L  # a flat row's short last unit goes by element
            for e in range(W):
                c0 = j[ok] * W + e
                c = c0 - p.k if wrap else c0
                c = np.where(c < 0, c + p.L, c)
                s = src[ok] + c.astype(U) * U(p.s2)
                if e == 0 and p.vec_load:
                    assert ((s[full].astype(np.int64) + x_off) % 4 == 0).all()
                outs.append((dst[ok] + c0.astype(U))[c0 < p.L].astype(np.int64))
                srcs.append(s[c0 < p.L].astype(np.int64))
            if W == 4:
                assert ((dst[ok] + (j[ok] * W).astype(U))[full] % U(4) == 0).all()
        dst = dst + d_dst
        src = src + d_src
        i1 = i1 + rem
        over = i1 >= n1
        i1 = np.where(over, i1 - n1, i1)
        src = np.where(over, src + carry, src)
        r = r + step
        live = live & (r < rows)
    return np.concatenate(outs), np.concatenate(srcs)


def _check_cover(p, x_off, wrap, want):
    out, src = _emulate(p, x_off, wrap)
    assert np.bincount(out, minlength=want.size).max() == 1 and out.size == want.size
    got = np.empty(want.size, np.int64)
    got[out] = src
    assert np.array_equal(got, want), p


# (rows, cols): ragged and aligned rows, one column, one row, more rows than the grid takes
SHAPES = [(1, 1), (3, 1), (5, 3), (7, 130), (16, 64), (9, 1031), (1, 4099), (2, 5), (300, 8),
          (64, 1024), (5000, 3), (3000, 16)]


@pytest.mark.parametrize("rows, cols", SHAPES)
def test_roll_plans_write_each_output_once(rows, cols):
    flat = np.arange(rows * cols).reshape(rows, cols)
    for x_off in (0, 1, 3):
        for shift, axis in {(0, 1), (1, 1), (4 % cols, 1), (cols - 1, 1), (1 % rows, 0),
                            (rows - 1, 0)}:
            p = rl.roll_plan(4 * x_off, rows, cols, shift, axis)
            _check_cover(p, x_off, True, np.roll(flat, shift, axis).ravel())


@pytest.mark.parametrize("rows, cols", SHAPES)
def test_strided_copy_plans_write_each_output_once(rows, cols):
    x = torch.arange(rows * cols + 3)
    for x_off in (0, 1, 3):
        xx = x[x_off:x_off + rows * cols].view(rows, cols)
        views = [xx, xx[::2, :], xx[:, ::2], xx[1:, 3::5], xx.t(), xx[:, 1:], xx[:, :1],
                 xx[:1, :], xx[:1, :].expand(3, cols)]
        if cols % 8 == 0:
            x3 = xx.view(rows, cols // 8, 8)
            views += [x3, x3[:, ::2, :], x3[:, :, :4], x3.transpose(0, 2), x3[1:, :, ::3]]
        for v in views:
            if v.numel():
                off = v.storage_offset()
                _check_cover(_view_plan(v, 4 * off), off, False,
                             (v.contiguous() - off).numpy().ravel())


def test_wide_plans_emulate_with_a_lowered_limit(monkeypatch):
    """The 64-bit plans' arithmetic at a small size: the limit lowered to
    1000 sends these views to the 64-bit route."""
    monkeypatch.setattr(rl, "LIMIT32", 1000)
    flat = np.arange(40 * 64).reshape(40, 64)
    for shift, axis in ((1, 1), (32, 1), (3, 0)):
        p = rl.roll_plan(0, 40, 64, shift, axis)
        assert p.wide == 1
        _check_cover(p, 0, True, np.roll(flat, shift, axis).ravel())
    x = torch.arange(40 * 64).view(40, 64)
    for v in (x[:, 3:], x[:, ::2], x.view(40, 8, 8)[:, ::2, :], x):
        off = v.storage_offset()
        p = _view_plan(v, 4 * off)
        assert p.wide == 1
        _check_cover(p, off, False, (v.contiguous() - off).numpy().ravel())
