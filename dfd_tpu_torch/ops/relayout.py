"""Data-movement kernels: roll, strided copy, column gather, transpose, scaled concat.

Replaces the Pallas TPU probe kernels of ``tools/probe_pallas_torso.py::main``
(``roll_lanes``, ``roll_sublanes``, ``roll_lanes64``, ``sub_sublane``,
``sub_lane``, ``sub_mid``, ``reshape_split_lanes``, ``concat_sublanes``) and
``tools/probe_pallas_pool.py::main`` (``k_take``, ``k_slice``, ``k_transpose``),
the relayouts a fused IMPALA torso needs (tap shifts, the stride-2 pool
subsample, layout changes):

- :func:`roll`: ``torch.roll`` of a 2-D tensor along one axis;
- :func:`strided_copy`: a contiguous copy of a strided view of up to three
  axes, such as ``x[::2, :]``, ``x[:, ::2]``, ``x3[:, ::2, :]`` or
  ``x.view(128, 16, 64)``.  A contiguous reshape is a view in PyTorch; it is
  still copied here, as the TPU kernel copies it;
- :func:`gather_cols`: ``x[:, idx]`` by an int32 index vector;
- :func:`transpose`: ``x.t()`` made contiguous;
- :func:`concat_scaled`: ``torch.cat([x * s for s in scales], 0)``.

Each wrapper runs its CUDA kernel (``csrc/relayout.cu``) on a CUDA tensor and
its plain PyTorch version (``*_plain``) on a CPU tensor; other devices raise.
Each checks what its kernel needs (float32 ``x``, contiguous where the kernel
reads it so: all but the strided copy; int32 ``idx``) before it branches, so
the CPU refuses, with the same ``ValueError``, what the card refuses; the
plain versions take anything PyTorch takes.  Every output is bit-exact
against the plain version.  ``launches`` on each wrapper counts kernel
launches.  What bounds them on an H100 is bytes: each input read once and
each output written once, at 3.35 TB/s.

The roll and the strided copy run one kernel body over the copy seen as rows
(:func:`rows_plan`): a strided view is collapsed first, so a contiguous view
is one flat row; a roll along lanes is rows of ``cols`` shifted by ``shift``,
along rows one flat row shifted by ``shift * cols``.  The plan picks float4
stores where output rows are 16-byte aligned, float4 loads where the source
is unit-stride and aligned too, 32- or 64-bit offsets, the threads a row and
the grid.  The transpose (:func:`transpose_plan`) walks tiles of x in grid
strides through a two-stage ring in shared memory, with 16-byte loads and
float4 stores where rows are aligned; the gather (:func:`gather_cols_plan`)
gives each thread a fixed unit of output columns, its indices read once, and
walks rows.  The concat (:func:`concat_plan`) reads x once: each thread
loads its unit of x (a float4 where ``n % 4 == 0`` and x is aligned, else
one element) and stores its k products, one to each segment of the output,
which moves exactly the bytes of the bound.  The C entries recompute each
plan and refuse one that differs.
An empty input gives its empty output without a launch.  :func:`empty`
launches an empty kernel: the card's cost of a launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from dfd_tpu_torch.ops import build

MAX_SCALES = 8
THREADS = 256                # a block of the roll and strided copy kernels
UNROLL = 4                   # units of a row a thread takes at once
MAX_BLOCKS = 132 * 16        # the grid at large sizes: 16 blocks an SM, 2-4 waves
MAX_GRID_Y = 65535
LIMIT32 = 2 ** 31 - 4096     # 32-bit offsets below this
SMS = 132
TR_AREA = 4096               # transpose tiles: elements
TR_SMALL = (64, 16)          # the tile where TR_AREA's leave fewer than two an SM
CAT_THREADS = 256            # a concat block


# -- plain PyTorch versions ------------------------------------------------------------


def roll_plain(x: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    return torch.roll(x, shift, axis)


def strided_copy_plain(view: torch.Tensor) -> torch.Tensor:
    return view.clone(memory_format=torch.contiguous_format)


def gather_cols_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(1, idx)


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def concat_scaled_plain(x: torch.Tensor, scales: Sequence[float]) -> torch.Tensor:
    return torch.cat([x * float(s) for s in scales], 0)


# -- the plan of the roll and the strided copy -----------------------------------------


class RowsPlan(NamedTuple):
    """A copy as ``n0 x n1`` rows of ``L`` output elements: row ``i0 * n1 +
    i1`` reads ``x[i0 * s0 + i1 * s1 + src(c) * s2]`` for column c, where
    src(c) is c, or ``(c - k) mod L`` for a roll; then how the kernel runs it
    (``csrc/relayout.cu::rows_plan``, which this mirrors)."""

    n0: int
    n1: int
    L: int
    s0: int
    s1: int
    s2: int
    k: int
    width: int       # 4: float4 stores (L % 4 == 0, or one row); 1: scalar stores
    vec_load: int    # float4 loads: unit stride, every gathered float4 16-byte aligned
    wide: int        # 64-bit offsets: some offset reaches LIMIT32
    g: int           # threads a row, a power of two up to THREADS
    unroll: int      # units a thread takes of a row: 1, or UNROLL where the card is full
    bx: int          # chunks of g * unroll units of a row (gridDim.x)
    by: int          # runs of THREADS // g rows, looped in grid strides (gridDim.y)

    @property
    def launch(self) -> Tuple[int, ...]:
        """The fields the C entry checks, in its argument order."""
        return self.width, self.vec_load, self.wide, self.g, self.unroll, self.bx, self.by

    @property
    def route(self) -> str:
        """"flat" (one row) or "rows"; "vector" (float4 loads and stores),
        "aligned stores" (scalar loads, float4 stores) or "scalar"; 32- or
        64-bit offsets."""
        load = "vector" if self.vec_load else "aligned stores" if self.width == 4 else "scalar"
        return (f"{'flat' if self.n0 * self.n1 == 1 else 'rows'}, {load}, "
                f"{64 if self.wide else 32}-bit")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def rows_plan(n0: int, n1: int, L: int, s0: int, s1: int, s2: int, k: int,
              x_addr: int) -> RowsPlan:
    """The plan of a copy as rows from ``x`` at address ``x_addr`` (see
    :class:`RowsPlan`): float4 stores where output rows are 16-byte aligned,
    float4 loads where every source float4 is too, ``g`` threads a row
    taking one unit each where that needs at most ``MAX_BLOCKS`` blocks (a
    small copy is latency), else ``UNROLL`` each (loads in flight) in a grid
    of about ``MAX_BLOCKS`` blocks, rows looped in grid strides."""
    rows = n0 * n1
    width = 4 if L % 4 == 0 or rows == 1 else 1  # a flat row's short last unit goes by element
    vec_load = int(width == 4 and s2 == 1 and k % 4 == 0 and (k == 0 or L % 4 == 0)
                   and x_addr % 16 == 0 and (n0 == 1 or s0 % 4 == 0) and (n1 == 1 or s1 % 4 == 0))
    reach = (n0 - 1) * s0 + (n1 - 1) * s1 + (L - 1) * s2
    wide = int(rows * L > LIMIT32 or reach >= LIMIT32)
    units = _cdiv(L, width)

    def threads_a_row(unroll: int) -> int:
        g = 1
        while g < THREADS and g * unroll < units:
            g *= 2
        return g

    unroll, g = 1, threads_a_row(1)
    if _cdiv(units, g) * _cdiv(rows * g, THREADS) > MAX_BLOCKS:
        unroll, g = UNROLL, threads_a_row(UNROLL)
    bx = _cdiv(units, g * unroll)
    by = min(_cdiv(rows * g, THREADS), _cdiv(MAX_BLOCKS, bx), MAX_GRID_Y)
    return RowsPlan(n0, n1, L, s0, s1, s2, k, width, vec_load, wide, g, unroll, bx, by)


def roll_plan(x_addr: int, rows: int, cols: int, shift: int, axis: int) -> RowsPlan:
    """The roll of a contiguous ``[rows, cols]`` at ``x_addr`` by ``shift``
    (in ``[0, len)``) along ``axis``: along lanes rows of ``cols``, along
    rows one flat row shifted by whole rows."""
    if axis == 0:
        return rows_plan(1, 1, rows * cols, 0, 0, 1, shift * cols, x_addr)
    return rows_plan(1, rows, cols, 0, cols, 1, shift, x_addr)


def strided_copy_plan(x_addr: int, sizes: Sequence[int], strides: Sequence[int]) -> RowsPlan:
    """The copy of a view of up to three axes (``sizes``, ``strides`` in
    elements, from ``x_addr``) as rows: size-1 axes dropped, an axis merged
    into the next one where its stride is that axis's extent (a contiguous
    view becomes one flat row)."""
    dims = []  # (size, stride), innermost first
    for n, st in zip(reversed(tuple(sizes)), reversed(tuple(strides))):
        if n == 1:
            continue
        if dims and st == dims[-1][0] * dims[-1][1]:
            dims[-1] = (dims[-1][0] * n, dims[-1][1])
        else:
            dims.append((n, st))
    dims += [(1, 1)] if not dims else []
    dims += [(1, 0)] * (3 - len(dims))
    (L, s2), (n1, s1), (n0, s0) = dims
    return rows_plan(n0, n1, L, s0, s1, s2, 0, x_addr)


# -- the plans of the gather and the transpose -----------------------------------------


class GatherPlan(NamedTuple):
    """How the gather kernel runs (``csrc/relayout.cu::gather_cols_plan``,
    which this mirrors, its fields in the C entry's argument order): each
    thread owns one unit of ``width`` output columns and walks rows in grid
    strides, ``unroll`` rows at a time."""

    width: int       # 4: float4 stores of 4 columns (n_idx % 4 == 0); else 1
    wide: int        # 64-bit offsets: rows * cols or rows * n_idx passes LIMIT32
    g: int           # threads a row, a power of two up to THREADS
    unroll: int      # rows a thread takes at once: 1, or UNROLL where the card is full
    bx: int          # chunks of g units (gridDim.x)
    by: int          # runs of THREADS // g rows, looped in grid strides (gridDim.y)

    @property
    def route(self) -> str:
        return (f"{'float4' if self.width == 4 else 'scalar'} stores, "
                f"{64 if self.wide else 32}-bit")


def gather_cols_plan(rows: int, cols: int, n_idx: int) -> GatherPlan:
    """The plan of ``out[r, j] = x[r, idx[j]]`` for ``x [rows, cols]`` and
    ``n_idx`` indices: float4 units where ``n_idx % 4 == 0``, ``g`` threads
    a row, one row a thread where that needs at most ``MAX_BLOCKS`` blocks,
    else ``UNROLL`` at once in a grid of about ``MAX_BLOCKS``."""
    width = 4 if n_idx % 4 == 0 else 1
    wide = int(rows * cols > LIMIT32 or rows * n_idx > LIMIT32)
    units = n_idx // width
    g = 1
    while g < THREADS and g < units:
        g *= 2
    bx = _cdiv(units, g)
    need = _cdiv(rows * g, THREADS)
    unroll = UNROLL if bx * need > MAX_BLOCKS else 1
    return GatherPlan(width, wide, g, unroll, bx, min(need, _cdiv(MAX_BLOCKS, bx), MAX_GRID_Y))


class TransposePlan(NamedTuple):
    """How the transpose kernel runs (``csrc/relayout.cu::transpose_plan``,
    which this mirrors, its fields in the C entry's argument order): tiles
    of ``tr x tc`` elements of x, one block of ``tr * tc // 16`` threads
    walking them in grid strides."""

    tr: int          # a tile's rows of x (16 to 256, a power of two)
    tc: int          # a tile's columns of x: tr * tc = TR_AREA, or TR_SMALL
    vec_load: int    # 16-byte cp.async loads: x's rows 16-byte aligned
    vec_store: int   # float4 stores: out's rows 16-byte aligned (rows % 4 == 0)
    wide: int        # 64-bit offsets: rows * cols passes LIMIT32
    grid: int        # blocks: the tiles, at most MAX_BLOCKS

    @property
    def threads(self) -> int:
        return self.tr * self.tc // 16

    @property
    def route(self) -> str:
        """"vector" (16-byte loads and float4 stores), "vector loads",
        "vector stores" or "scalar"; 32- or 64-bit offsets."""
        load = {(1, 1): "vector", (1, 0): "vector loads", (0, 1): "vector stores",
                (0, 0): "scalar"}[self.vec_load, self.vec_store]
        return f"{self.tr}x{self.tc}, {load}, {64 if self.wide else 32}-bit"


def transpose_plan(x_addr: int, rows: int, cols: int) -> TransposePlan:
    """The plan of ``x.t()`` for a contiguous ``x [rows, cols]`` at
    ``x_addr``: ``TR_AREA`` tiles, 64 x 64 unless x is thinner than that,
    then as thin as x allows (a power of two, at least 16); ``TR_SMALL``
    where those would leave fewer than two tiles an SM; 16-byte loads and
    float4 stores where x's and out's rows are aligned; a grid of the tiles,
    at most ``MAX_BLOCKS`` (4 blocks of 256 threads an SM stay resident, the
    rest start as they end)."""
    tiles = lambda tr, tc: _cdiv(rows, tr) * _cdiv(cols, tc)
    tr = 64
    if rows < 64 or cols < 64:
        thin = 16
        while thin < (rows if rows < 64 else cols):
            thin *= 2
        tr = thin if rows < 64 else TR_AREA // thin
    tc = TR_AREA // tr
    if tiles(tr, tc) < 2 * SMS:
        tr, tc = TR_SMALL
    return TransposePlan(tr, tc, int(cols % 4 == 0 and x_addr % 16 == 0), int(rows % 4 == 0),
                         int(rows * cols > LIMIT32), min(tiles(tr, tc), MAX_BLOCKS))


class ConcatPlan(NamedTuple):
    """How the concat kernel runs (``csrc/relayout.cu::concat_plan``, which
    this mirrors, its fields in the C entry's argument order): each thread
    of a block of ``CAT_THREADS`` owns one unit of ``width`` elements of x,
    loads it and stores its k products; the grid has a thread a unit."""

    width: int       # 4: float4 units (n % 4 == 0, x 16-byte aligned); else 1
    wide: int        # 64-bit offsets: k * n passes LIMIT32
    grid: int        # blocks (gridDim.x)

    @property
    def route(self) -> str:
        """"vector" (float4 loads and stores) or "scalar"; 32- or 64-bit offsets."""
        return f"{'vector' if self.width == 4 else 'scalar'}, {64 if self.wide else 32}-bit"


def concat_plan(x_addr: int, n: int, k: int) -> ConcatPlan:
    """The plan of ``concat([x * s_0, ..., x * s_{k-1}])`` for a contiguous
    x of ``n`` elements at ``x_addr``: float4 units where ``n % 4 == 0`` and
    x is 16-byte aligned, else scalars; 64-bit offsets where ``k * n``
    passes ``LIMIT32``; a thread a unit."""
    width = 4 if n % 4 == 0 and x_addr % 16 == 0 else 1
    return ConcatPlan(width, int(k * n > LIMIT32), _cdiv(n // width, CAT_THREADS))


# -- the kernels -----------------------------------------------------------------------


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _on_cpu(x: torch.Tensor, contiguous: bool = True) -> bool:
    """Checks what the kernel needs of ``x`` on any device, so that the CPU
    refuses what the card does; then whether x lies on the CPU (else it
    must lie on a CUDA device)."""
    _expect(x.dtype == torch.float32, f"x must be float32, got {x.dtype}")
    _expect(not contiguous or x.is_contiguous(), "x must be contiguous")
    if x.device.type == "cpu":
        return True
    _expect(x.device.type == "cuda", f"x must lie on the CPU or a CUDA device, got {x.device}")
    return False


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    lib = build.load("relayout")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (
        ("dfd_roll", [vp, vp, i64, i64, i64, i32] + [i32] * 5 + [i64, i32, vp]),
        ("dfd_strided_copy", [vp, vp] + [i64] * 6 + [i32] * 5 + [i64, i32, vp]),
        ("dfd_empty", [vp]),
        ("dfd_gather_cols", [vp, vp, vp, i64, i64, i64] + [i32] * 4 + [i64, i32, vp]),
        ("dfd_transpose", [vp, vp, i64, i64] + [i32] * 6 + [vp]),
        ("dfd_concat_scaled", [vp, vp, i64, vp] + [i32] * 4 + [vp]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i32
    return lib


def _launch(x: torch.Tensor, name: str, *args) -> None:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.raise_on(getattr(_kernels(), name)(*args, stream), name)


def roll(x: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    """``torch.roll(x, shift, axis)`` of a 2-D float32 x."""
    _expect(x.ndim == 2 and axis in (0, 1, -1, -2), f"a 2-D x and axis 0 or 1 expected, got "
                                                    f"{tuple(x.shape)} and {axis}")
    if _on_cpu(x):
        return roll_plain(x, shift, axis)
    axis %= 2
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rows, cols = x.shape
    shift %= x.shape[axis]
    p = roll_plan(x.data_ptr(), rows, cols, shift, axis)
    _launch(x, "dfd_roll", x.data_ptr(), out.data_ptr(), rows, cols, shift, axis, *p.launch)
    roll.launches += 1
    return out


def strided_copy(view: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``view``, a strided view (1 to 3 axes) of a
    float32 tensor: ``view.clone(memory_format=torch.contiguous_format)``."""
    _expect(1 <= view.ndim <= 3, f"a view of 1 to 3 axes expected, got {tuple(view.shape)}")
    if _on_cpu(view, contiguous=False):
        return strided_copy_plain(view)
    out = torch.empty(view.shape, dtype=torch.float32, device=view.device)
    if out.numel() == 0:
        return out
    pad = 3 - view.ndim
    sizes = (1,) * pad + tuple(view.shape)
    strides = (0,) * pad + tuple(view.stride())
    p = strided_copy_plan(view.data_ptr(), sizes, strides)
    _launch(view, "dfd_strided_copy", view.data_ptr(), out.data_ptr(), *sizes, *strides,
            *p.launch)
    strided_copy.launches += 1
    return out


def gather_cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[:, idx]`` of a 2-D float32 x by a 1-D int32 ``idx``.  On the card
    an index outside ``[0, x.shape[1])`` gives NaN (the plain version raises)."""
    _expect(x.ndim == 2 and idx.ndim == 1, f"x [R, C] and idx [n] expected, got "
                                           f"{tuple(x.shape)} and {tuple(idx.shape)}")
    _expect(idx.dtype == torch.int32, f"idx must be int32, got {idx.dtype}")
    _expect(idx.is_contiguous(), "idx must be contiguous")
    if _on_cpu(x) and idx.device.type == "cpu":
        return gather_cols_plain(x, idx)
    _expect(idx.device == x.device, f"idx must lie on {x.device}, got {idx.device}")
    out = torch.empty((x.shape[0], idx.shape[0]), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    p = gather_cols_plan(*x.shape, idx.shape[0])
    _launch(x, "dfd_gather_cols", x.data_ptr(), idx.data_ptr(), out.data_ptr(), *x.shape,
            idx.shape[0], *p)
    gather_cols.launches += 1
    return out


def transpose(x: torch.Tensor) -> torch.Tensor:
    """``x.t().contiguous()`` of a 2-D float32 x."""
    _expect(x.ndim == 2, f"a 2-D x expected, got {tuple(x.shape)}")
    if _on_cpu(x):
        return transpose_plain(x)
    rows, cols = x.shape
    out = torch.empty((cols, rows), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    p = transpose_plan(x.data_ptr(), rows, cols)
    _launch(x, "dfd_transpose", x.data_ptr(), out.data_ptr(), rows, cols, *p)
    transpose.launches += 1
    return out


def concat_scaled(x: torch.Tensor, scales: Sequence[float]) -> torch.Tensor:
    """``torch.cat([x * s for s in scales], 0)``, at most 8 scales."""
    _expect(1 <= len(scales) <= MAX_SCALES, f"1 to {MAX_SCALES} scales expected, "
                                            f"got {len(scales)}")
    _expect(x.ndim >= 1, "x must have at least one axis")
    if _on_cpu(x):
        return concat_scaled_plain(x, scales)
    out = torch.empty((len(scales) * x.shape[0], *x.shape[1:]), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    host = (ctypes.c_float * len(scales))(*(float(s) for s in scales))
    p = concat_plan(x.data_ptr(), x.numel(), len(scales))
    _launch(x, "dfd_concat_scaled", x.data_ptr(), out.data_ptr(), x.numel(), host, len(scales),
            *p)
    concat_scaled.launches += 1
    return out


def empty(device: torch.device) -> None:
    """Launch an empty kernel (one block of 32 threads) on ``device``'s
    current stream; counted nowhere."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        build.raise_on(_kernels().dfd_empty(stream), "empty")


KERNELS = (roll, strided_copy, gather_cols, transpose, concat_scaled)
for _fn in KERNELS:
    _fn.launches = 0
