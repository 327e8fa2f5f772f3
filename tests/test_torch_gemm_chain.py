"""The launch plan of the Hopper GEMM-chain kernel (``gemm_chain_plan``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``); what
surrounds it is checked here: for every probe case and for ragged shapes
the plan's tiles cover the output exactly once, its clusters have at most
8 blocks and split K into slices that cover it, its shared memory fits a
block, and a shape whose panels cannot fit raises ``ValueError``.
"""

import numpy as np
import pytest

import _torch_port  # noqa: F401  (one torch thread per xdist worker)
from dfd_tpu_torch.ops import gemm_chain as gc
from dfd_tpu_torch.probes import gemm as pgemm
from dfd_tpu_torch.probes import torso as ptorso

PROBE_SHAPES = sorted({c[:3] for c in pgemm.CASES} | {s[1:] for s in ptorso.GEMM_SHAPES}
                      | {(16, 4096, 1024)})
RAGGED = [(1, 1, 1), (37, 61, 23), (5, 13, 1030), (9, 0, 5), (8, 2048, 8), (300, 700, 256),
          (1000, 3, 7), (17, 6000, 3)]


def _check_plan(M, K, N):
    p = gc.gemm_chain_plan(M, K, N)
    bm, bn = 16 * p.wm * p.mt, 8 * p.wn * p.nt
    tiles_m, tiles_n = -(-M // bm), -(-N // bn)
    assert p.blocks == tiles_m * tiles_n * p.cluster
    assert 1 <= p.wm * p.wn * p.wk <= 8 and (p.wm, p.wn, p.mt, p.nt) in gc.WARP_TILES
    assert p.wk in gc.WARP_K and (p.wk == 1 or p.wk <= p.ks // 8)
    assert p.cluster in gc.CLUSTERS and p.cluster <= 8
    # every output element in exactly one tile (the kernel masks what lies past M and N)
    cover = np.zeros((tiles_m * bm, tiles_n * bn), np.int32)
    for tile in range(tiles_m * tiles_n):
        r0, c0 = tile // tiles_n * bm, tile % tiles_n * bn
        cover[r0:r0 + bm, c0:c0 + bn] += 1
    assert (cover == 1).all() and cover.shape[0] - bm < M <= cover.shape[0]
    assert cover.shape[1] - bn < N <= cover.shape[1]
    # the cluster's slices of K: ks a block, a multiple of 8, covering K; each rank's
    # rows of the reduction a whole number
    assert p.ks % 8 == 0 and p.ks * p.cluster >= K and p.ks - 8 < -(-K // p.cluster)
    assert bm % p.cluster == 0
    assert p.smem == gc._plan_smem(bm, bn, p.ks, p.wk, p.cluster) <= gc.SMEM_MAX == 232_448
    return p


@pytest.mark.parametrize("M, K, N", PROBE_SHAPES)
def test_every_probe_case_has_a_plan(M, K, N):
    p = _check_plan(M, K, N)
    # the probes' outputs fill the card where they can: 128 tiles of 16 x 8 or more
    if M * N >= 132 * 16 * 8:
        assert p.blocks >= 64


@pytest.mark.parametrize("M, K, N", RAGGED)
def test_ragged_shapes_have_plans(M, K, N):
    _check_plan(M, K, N)


def test_ordered_and_resident_plans():
    """The ordered route (the 1024-product chain) takes one m16 x n8 tile a
    block with no K split; feed's plan keeps every block on the card at once."""
    assert gc.ordered_route(1024, "acc") and gc.ordered_route(336, "acc_scaled")
    assert not gc.ordered_route(256, "acc") and not gc.ordered_route(4096, "feed")
    p = _check_plan(1024, 144, 16) and gc.gemm_chain_plan(1024, 144, 16, ordered=True)
    assert (p.wm, p.wn, p.wk, p.mt, p.nt, p.cluster) == (1, 1, 1, 1, 1, 1)
    for M, K, N in [(1024, 144, 16), (300, 700, 256), (64, 1500, 40)]:
        p = gc.gemm_chain_plan(M, K, N, resident=True)
        per_sm = min(gc.SMEM_MAX // p.smem, 2048 // (64 + 16 * p.mt * p.nt) // (p.wm * p.wn * p.wk))
        assert p.blocks <= gc.NUM_SMS * per_sm
    with pytest.raises(ValueError, match="resident"):
        gc.gemm_chain_plan(4096, 64, 4096, resident=True)


def test_a_shape_that_cannot_fit_raises():
    with pytest.raises(ValueError, match="do not fit"):
        gc.gemm_chain_plan(16, 40_000, 8)
    with pytest.raises(ValueError, match="M, N > 0"):
        gc.gemm_chain_plan(0, 8, 8)


def test_plan_prefers_a_cluster_only_where_it_pays():
    """The probes' narrow shapes keep one block a tile; panels that exceed a
    block's shared memory (the 512 x 1024 x 512 case, the Sel-GEMM) split K."""
    assert gc.gemm_chain_plan(1024, 144, 16).cluster == 1
    assert gc.gemm_chain_plan(512, 1024, 512).cluster > 1
    assert gc.gemm_chain_plan(16, 4096, 1024).cluster > 1
