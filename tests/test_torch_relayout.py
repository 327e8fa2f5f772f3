"""The launch plans of the relayout kernels, on the CPU.

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
The same for the transpose (``transpose_plan``: tiles walked in grid
strides, the stage's swizzle, 4 x 4 blocks stored as float4s) and the
gather (``gather_cols_plan``: a unit of columns a thread, rows in grid
strides) and the concat (``concat_plan``: units of x in grid strides, each
stored once to every segment, or the scales over blockIdx.y); the CPU
wrappers' empty outputs for empty inputs; and their refusal, before they
branch to the plain version, of what the card refuses (float64 x, x
non-contiguous where the kernel needs it), as
``tests/test_torch_cuda.py::test_probe_wrappers_count_launches_and_check_inputs``
shows on the card.
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


# -- the transpose and the gather ---------------------------------------------------------

TALL = 2129920            # x.view(TALL, 16) of the production x: 66,560 row tiles of 32


@pytest.mark.parametrize("rows, cols, tile, route, grid", [
    # the pool probe's [16, 4096] and [48, 1024]: TR_AREA tiles would be 16, so TR_SMALL ones
    (16, 4096, (64, 16), "vector", 256), (48, 1024, (64, 16), "vector", 64),
    # the production cases, views of x [33280, 1024]: 8320 tiles of 4096 in 2112 blocks
    (PR, PL, (64, 64), "vector", 2112), (64, 532480, (64, 64), "vector", 2112),
    (532480, 64, (64, 64), "vector", 2112), (16, TALL, (16, 256), "vector", 2112),
    (TALL, 16, (256, 16), "vector", 2112),
    # ragged: scalar routes
    (7, 130, (64, 16), "scalar", 9), (5, 5, (64, 16), "scalar", 1),
    (6, 1024, (64, 16), "vector loads", 64), (1024, 6, (64, 16), "vector stores", 16),
    (3000, 1024, (64, 64), "vector", 752), (20, 70000, (32, 128), "vector", 547),
])
def test_transpose_routes(rows, cols, tile, route, grid):
    p = rl.transpose_plan(0, rows, cols)
    assert (p.tr, p.tc) == tile and p.route == f"{tile[0]}x{tile[1]}, {route}, 32-bit"
    assert p.grid == grid and p.threads == tile[0] * tile[1] // 16
    # a storage offset off 16 bytes loses the 16-byte loads only
    assert rl.transpose_plan(4, rows, cols).vec_load == 0
    assert rl.transpose_plan(4, rows, cols).vec_store == p.vec_store


def test_transpose_past_2_31_takes_the_64_bit_route_in_a_small_grid():
    tall = rl.transpose_plan(0, WIDE, 2)
    assert tall.route == "256x16, vector stores, 64-bit" and tall.grid == rl.MAX_BLOCKS
    assert rl.transpose_plan(0, 2, WIDE).route == "16x256, vector loads, 64-bit"
    # x.view(TALL, 16) needs 66,560 tiles of 32 rows: the parent's gridDim.y refused it
    assert -(-TALL // 32) > rl.MAX_GRID_Y
    assert rl.transpose_plan(0, 2 ** 31 // 4096, 4096).wide == 1
    assert rl.transpose_plan(0, 2 ** 31 // 4096 - 1, 4096).wide == 0


@pytest.mark.parametrize("rows, cols, n_idx, width, g, unroll, by", [
    (16, 4096, 1024, 4, 256, 1, 16),        # the pool probe's even positions
    (PR, 4096, 1024, 4, 256, 4, 2112),      # impala_prod_bf16's stage-0 pool, x_pool
    (PR, PL, 1024, 4, 256, 4, 2112),        # a permutation of x's columns
    (7, 130, 3, 1, 4, 1, 1), (5000, 3, 1, 1, 1, 1, 20), (2 ** 20, 3, 1, 1, 1, 4, 2112),
    (3, 17, 1025, 1, 256, 1, 3),
])
def test_gather_routes(rows, cols, n_idx, width, g, unroll, by):
    p = rl.gather_cols_plan(rows, cols, n_idx)
    assert (p.width, p.wide, p.g, p.unroll, p.by) == (width, 0, g, unroll, by), p
    assert p.bx == -(-(n_idx // width) // g)
    assert rl.gather_cols_plan(2, WIDE, 4).route == "float4 stores, 64-bit"
    assert rl.gather_cols_plan(WIDE, 1, 2).route == "scalar stores, 64-bit"


def _swizzle(u, p: rl.TransposePlan):
    w_log2 = (p.tc // 4).bit_length() - 1
    return u ^ (((u >> (w_log2 + 2)) << int(p.tr == 16)) & 7)


TILES = [(64, 16), (16, 256), (32, 128), (64, 64), (128, 32), (256, 16)]  # every tile a plan picks


@pytest.mark.parametrize("tr, tc", TILES)
def test_transpose_stage_swizzle_is_a_bijection_without_bank_conflicts(tr, tc):
    """Every tile shape's swizzle permutes the stage's float4 units, and a
    quarter warp (8 threads) of the loads or of the store phase's reads
    meets 8 different 16-byte bank groups."""
    p = rl.TransposePlan(tr, tc, 1, 1, 0, 1)
    W, T = tc // 4, p.threads
    u = np.arange(4 * T)
    assert np.array_equal(np.sort(_swizzle(u, p)), u)
    for k in range(4):  # loads: thread t's k-th unit is t + k * T
        phys = _swizzle(u[:T] + k * T, p) % 8
        assert all(len(set(phys[q:q + 8])) == 8 for q in range(0, T, 8)), k
    th = np.arange(T)
    a4, b = th % (tr // 4), th // (tr // 4)
    for i in range(4):  # store phase: thread (a4, b) reads unit (4 a4 + i) * W + b
        phys = _swizzle((4 * a4 + i) * W + b, p) % 8
        assert all(len(set(phys[q:q + 8])) == 8 for q in range(0, T, 8)), i


def _emulate_transpose(p: rl.TransposePlan, rows: int, cols: int, x_off: int):
    """(output index, source index) of every element the kernel stores,
    following ``transpose_kernel`` tile by tile: each block's tiles in grid
    strides (q tile rows and rem tiles, with a carry), the loads into the
    swizzled stage, each thread's 4 x 4 block out; asserts every 16-byte
    load and float4 store is aligned and nothing unloaded is stored."""
    tr, tc, T = p.tr, p.tc, p.threads
    W = tc // 4
    tiles_c = -(-cols // tc)
    tiles = -(-rows // tr) * tiles_c
    q, rem = divmod(p.grid, tiles_c)
    u = np.arange(4 * T)
    th = np.arange(T)
    a4, b = th % (tr // 4), th // (tr // 4)
    outs, srcs = [], []
    for block in range(p.grid):
        t, (ti, tj) = block, divmod(block, tiles_c)
        while t < tiles:
            stage = np.full((4 * T, 4), -1, np.int64)
            r, c = ti * tr + u // W, tj * tc + 4 * (u % W)
            for e in range(4):
                ok = (r < rows) & (c + e < cols)
                stage[_swizzle(u[ok], p), e] = r[ok] * cols + c[ok] + e
            if p.vec_load:
                ok = (r < rows) & (c < cols)
                assert ((x_off + r[ok] * cols + c[ok]) % 4 == 0).all()
                assert (c[ok] + 4 <= cols).all()
            v = np.stack([stage[_swizzle((4 * a4 + i) * W + b, p)] for i in range(4)], 1)
            rr, cc = ti * tr + 4 * a4, tj * tc + 4 * b
            for e in range(4):
                oc = cc + e
                if p.vec_store:
                    ok = (oc < cols) & (rr < rows)
                    assert ((oc[ok] * rows + rr[ok]) % 4 == 0).all() and (rr[ok] + 4 <= rows).all()
                for i in range(4):
                    ok = (oc < cols) & (rr + i < rows)
                    outs.append(oc[ok] * rows + rr[ok] + i)
                    srcs.append(v[ok, i, e])
            t += p.grid
            ti, tj = ti + q, tj + rem
            if tj >= tiles_c:
                ti, tj = ti + 1, tj - tiles_c
    out, src = np.concatenate(outs), np.concatenate(srcs)
    assert (src >= 0).all()  # every stored element was loaded
    return out, src


RAGGED = (1, 3, 5, 16, 17, 33, 48, 130)


@pytest.mark.parametrize("rows", RAGGED)
def test_transpose_plans_write_each_output_once(rows, monkeypatch):
    """Ragged shapes, storage offsets 0-3, and the same with 2 SMs and a
    grid of at most 4 blocks: more tiles than the grid holds, so blocks loop
    over tiles."""
    for sms, max_blocks in ((rl.SMS, rl.MAX_BLOCKS), (2, 4)):
        monkeypatch.setattr(rl, "SMS", sms)
        monkeypatch.setattr(rl, "MAX_BLOCKS", max_blocks)
        for cols in RAGGED + ((260,) if sms == 2 else ()):
            want = np.arange(rows * cols).reshape(rows, cols).T.ravel()
            for x_off in (0, 1, 3):
                p = rl.transpose_plan(4 * x_off, rows, cols)
                _check_cover_pairs(_emulate_transpose(p, rows, cols, x_off), want, p)


def _check_cover_pairs(pairs, want, p):
    out, src = pairs
    assert out.size == want.size and np.bincount(out, minlength=want.size).max() == 1, p
    got = np.empty(want.size, np.int64)
    got[out] = src
    assert np.array_equal(got, want), p


def test_transpose_grid_strides_cover_every_tile(monkeypatch):
    """With 2 SMs and a grid of at most 8 blocks: [200, 260] (20 tiles of
    64 x 64), [3000, 16] and [16, 3000] (12 of 256 x 16 and 16 x 256) and
    [130, 1024] (48) loop, with the tile-row carry; and the same in the
    64-bit route's arithmetic, LIMIT32 lowered."""
    monkeypatch.setattr(rl, "SMS", 2)
    monkeypatch.setattr(rl, "MAX_BLOCKS", 8)
    for rows, cols in ((200, 260), (3000, 16), (16, 3000), (130, 1024)):
        for limit in (rl.LIMIT32, 1000):
            monkeypatch.setattr(rl, "LIMIT32", limit)
            p = rl.transpose_plan(0, rows, cols)
            assert p.wide == int(limit == 1000)
            assert p.grid < -(-rows // p.tr) * -(-cols // p.tc), p
            _check_cover_pairs(_emulate_transpose(p, rows, cols, 0),
                               np.arange(rows * cols).reshape(rows, cols).T.ravel(), p)


def _emulate_gather(p: rl.GatherPlan, rows: int, n_idx: int):
    """(output index, (row, column) of idx) of every element
    ``gather_cols_kernel`` stores: thread t of block (bx, by) owns unit
    ``bx * g + t % g`` and rows from ``by * (THREADS // g) + t // g`` in grid
    strides, ``unroll`` at a time; asserts every float4 store is aligned."""
    W, per_block = p.width, rl.THREADS // p.g
    bx, by, t = (a.ravel() for a in np.meshgrid(np.arange(p.bx), np.arange(p.by),
                                                np.arange(rl.THREADS), indexing="ij"))
    j, r = bx * p.g + t % p.g, by * per_block + t // p.g
    live = (j < n_idx // W) & (r < rows)
    j, r = j[live], r[live]
    step = p.by * per_block
    outs, cols = [], []
    while r.size:
        for u in range(p.unroll):
            rr = r + u * step
            ok = rr < rows
            if W == 4:
                assert ((rr[ok] * n_idx + j[ok] * 4) % 4 == 0).all()
            for e in range(W):
                outs.append(rr[ok] * n_idx + j[ok] * W + e)
                cols.append(j[ok] * W + e)
        r = r + p.unroll * step
        j, r = j[r < rows], r[r < rows]
    return np.concatenate(outs), np.concatenate(cols)


@pytest.mark.parametrize("n_idx", [1, 3, 4, 1025])
def test_gather_plans_write_each_output_once(n_idx, monkeypatch):
    """Rows among the ragged sizes and more than the grid holds, with the
    grid cut (MAX_BLOCKS 32) so that threads take UNROLL rows and loop."""
    for max_blocks in (rl.MAX_BLOCKS, 32):
        monkeypatch.setattr(rl, "MAX_BLOCKS", max_blocks)
        for rows in RAGGED + (9000,):
            p = rl.gather_cols_plan(rows, 7, n_idx)
            out, col = _emulate_gather(p, rows, n_idx)
            assert out.size == rows * n_idx
            assert np.bincount(out, minlength=rows * n_idx).max() == 1, p
            assert np.array_equal(out % n_idx, col), p
        assert max_blocks == rl.MAX_BLOCKS or p.unroll == rl.UNROLL


def test_cpu_wrappers_give_empty_outputs_for_empty_inputs():
    idx = torch.tensor([0, 2], dtype=torch.int32)
    assert rl.gather_cols(torch.zeros(0, 5), idx).shape == (0, 2)
    assert rl.gather_cols(torch.zeros(4, 5), idx[:0]).shape == (4, 0)
    assert rl.transpose(torch.zeros(0, 5)).shape == (5, 0)
    assert rl.transpose(torch.zeros(3, 0)).shape == (0, 3)
    assert rl.concat_scaled(torch.zeros(0, 5), (1.0, 2.0)).shape == (0, 5)


# -- the concat ---------------------------------------------------------------------------

PN = PR * PL              # the production x, flat: 34,078,720 floats


@pytest.mark.parametrize("x_addr, n, k, route, grid", [
    (0, R * L, 3, "vector, 32-bit", 128),          # the probe's x [128, 1024]
    (0, PN, 3, "vector, 32-bit", 33280),           # x [33280, 1024], k = 3
    (0, PN, 8, "vector, 32-bit", 33280),           # k = MAX_SCALES
    (4, PN - 1, 3, "scalar, 32-bit", 133120),      # x.view(-1)[1:]
    (0, 2 ** 28 + 4, 8, "vector, 64-bit", 262145),  # k * n past LIMIT32
    (0, 2 ** 28 + 3, 8, "scalar, 64-bit", 1048577),
    (0, 5, 3, "scalar, 32-bit", 1),
])
def test_concat_routes(x_addr, n, k, route, grid):
    p = rl.concat_plan(x_addr, n, k)
    assert (p.route, p.grid) == (route, grid), p


def test_concat_takes_the_vector_route_exactly_where_x_is_aligned_in_float4s():
    for n in range(1, 70):
        for x_addr in range(0, 36, 4):
            for k in (1, 3, 8):
                p = rl.concat_plan(x_addr, n, k)
                assert p.width == (4 if n % 4 == 0 and x_addr % 16 == 0 else 1), (n, x_addr, k)
    assert rl.concat_plan(0, rl.LIMIT32 // 8, 8).wide == 0
    assert rl.concat_plan(0, rl.LIMIT32 // 8 + 1, 8).wide == 1


def _check_concat(p: rl.ConcatPlan, n: int, k: int):
    """Follows ``concat_scaled_kernel`` step by step in its unsigned offsets,
    in units of ``p.width`` floats: thread t of block b takes unit ``j = b *
    CAT_THREADS + t`` (if ``j < units``) and stores it to every segment, a
    segment's offset the last one's plus ``units``.  Asserts that each
    store goes to the segment of its scale at its source unit's place, and
    that every output unit is stored once."""
    with np.errstate(over="ignore"):
        U = np.uint64 if p.wide else np.uint32
        units, T = n // p.width, rl.CAT_THREADS
        assert p.width == 1 or n % 4 == 0
        b, t = (a.ravel() for a in np.meshgrid(np.arange(p.grid), np.arange(T), indexing="ij"))
        j = b.astype(U) * U(T) + t.astype(U)
        j = j[j < U(units)]
        seen = np.zeros((k, units), bool)
        o = j
        for s in range(k):
            assert np.array_equal(o, U(s) * U(units) + j), (p, s)
            seen[s, j.astype(np.int64)] = True
            o = o + U(units)
        assert k * j.size == k * units and seen.all(), p
        assert (p.grid - 1) * T < units  # no block without work


@pytest.mark.parametrize("k", range(1, rl.MAX_SCALES + 1))
def test_concat_plans_write_each_output_once(k):
    """Ragged n (1, 3, 5, 4m +- 1) and aligned ones, at x addresses off 16
    bytes and on them."""
    for n in (1, 3, 4, 5, 7, 8, 9, 63, 64, 65, 255, 256, 257, 511, 512, 513, 1023, 1024, 1025,
              2047, 2048, 2049, 4096, 5000, 131071, 131072):
        for x_addr in (0, 4, 12):
            _check_concat(rl.concat_plan(x_addr, n, k), n, k)


@pytest.mark.parametrize("x_addr, n, k", [(0, R * L, 3), (0, PN, 3), (0, PN, 8),
                                          (4, PN - 1, 3)],
                         ids=["probe", "production k=3", "production k=8", "ragged"])
def test_concat_plans_at_the_probe_and_production_sizes(x_addr, n, k):
    _check_concat(rl.concat_plan(x_addr, n, k), n, k)


def test_concat_wide_plans_emulate_with_a_lowered_limit(monkeypatch):
    """The 64-bit forms' arithmetic at a small size: LIMIT32 lowered to 100
    sends these to the 64-bit route."""
    monkeypatch.setattr(rl, "LIMIT32", 100)
    routes = set()
    for n, x_addr, k in ((1024, 0, 1), (1028, 4, 3), (4096, 0, 8), (3001, 0, 2), (200, 0, 6),
                         (45, 0, 3)):
        p = rl.concat_plan(x_addr, n, k)
        assert p.wide == 1
        routes.add(p.route)
        _check_concat(p, n, k)
    assert routes == {"vector, 64-bit", "scalar, 64-bit"}, routes


def test_concat_plain_and_one_broadcasting_multiply_agree_bit_for_bit():
    """The one PyTorch call timed beside the concat is the same function."""
    from dfd_tpu_torch.probes.torso import concat_library

    x = torch.from_numpy(np.random.RandomState(0).randn(5, 7, 3).astype(np.float32))
    for scales in ((1.0, 2.0, 3.0), (0.1, -3.7, 1e-3, 7.25, 1 / 3, 2.5, -0.0, 9e9)):
        s = torch.tensor(scales, dtype=torch.float32)
        assert torch.equal(concat_library(x, s), rl.concat_scaled_plain(x, scales))


# -- the wrappers refuse on the CPU what the card refuses ---------------------------------

IDX = torch.tensor([0, 2, 3], dtype=torch.int32)
WRAPPERS = {  # (wrapper, plain version, the kernel needs x contiguous)
    "roll": (lambda x: rl.roll(x, 1, 1), lambda x: rl.roll_plain(x, 1, 1), True),
    "strided_copy": (rl.strided_copy, rl.strided_copy_plain, False),
    "gather_cols": (lambda x: rl.gather_cols(x, IDX), lambda x: rl.gather_cols_plain(x, IDX),
                    True),
    "transpose": (rl.transpose, rl.transpose_plain, True),
    "concat_scaled": (lambda x: rl.concat_scaled(x, (1.0, 2.5)),
                      lambda x: rl.concat_scaled_plain(x, (1.0, 2.5)), True),
}


@pytest.mark.parametrize("name", WRAPPERS)
def test_cpu_wrappers_refuse_what_the_card_refuses(name):
    fn, plain, contiguous = WRAPPERS[name]
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 6))  # float64
    with pytest.raises(ValueError, match="x must be float32, got torch.float64"):
        fn(x)
    assert plain(x).dtype == torch.float64
    xt = x.float().t()
    if contiguous:
        with pytest.raises(ValueError, match="x must be contiguous"):
            fn(xt)
    else:
        assert torch.equal(fn(xt), plain(xt))
    assert plain(xt).dtype == torch.float32
    assert torch.equal(fn(x.float()), plain(x.float()))


def test_cpu_wrappers_refuse_integer_x_and_strided_indices():
    x = torch.arange(6).view(2, 3)
    with pytest.raises(ValueError, match="float32"):
        rl.concat_scaled(x, (1.0, 2.5))
    assert rl.concat_scaled_plain(x, (1.0, 2.5)).dtype == torch.float32
    idx = torch.tensor([0, 1, 2, 1], dtype=torch.int32)[::2]
    with pytest.raises(ValueError, match="idx must be contiguous"):
        rl.gather_cols(torch.zeros(2, 3), idx)
