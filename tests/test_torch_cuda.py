"""The port's CUDA kernels and trainer on the card, held against the plain
PyTorch versions that the CPU tests hold to the JAX package.

These tests need an NVIDIA card and skip without one.  They import no JAX,
so on a machine with a card and no JAX they run without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: JAX's threefry normal (``normal_kernel``) exact against its plain
version, which calls the same CUDA log1pf and sqrtf and emulates each fused
multiply-add exactly; the counter-hash eps to 1e-5 absolute (libm ulps in log/cos between the kernel
and PyTorch's CUDA functions); the combine's member sum in another order to
relative L2 1e-5; the fused torso kernels to 1e-5 of the output's scale in
f32 (sums of up to 1152 products in another order, each product as three
TF32 ones of split operands: about 22 of f32's 24 bits), the feature block in
bf16 too (the same bf16 operands, sums in another order, on the tensor
cores), the res stage in bf16 to 4e-3 (an f32 intermediate one ulp apart can
round to the neighbouring bf16 value: 1.4e-3 at most at the production
shapes), the
probes' chain in bf16 to 5e-4 (10x the worst seen), and every bf16 result
nearer its bf16 plain version than its f32 one; the trainer's mean reward to rtol
1e-6, since the card's mean of the same integer rewards may round its
division differently.
"""

import ctypes
import math

import pytest
import torch

from dfd_tpu_torch.ops import fused_resblock as fr
from dfd_tpu_torch.ops import perturb as pk

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1, False), (7, 1023, False), (8, 1025, True), (130, 3000, True),
          (2048, 5197, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.parametrize("P, d, anti", SHAPES)
def test_perturb_kernel_matches_plain(cuda, P, d, anti):
    theta = torch.randn(d, device=cuda)
    for sigma in (1.0, 0.05):
        got = pk.perturb(theta, sigma, 9, 4, P, antithetic=anti)
        want = pk.perturb_plain(theta, sigma, 9, 4, P, antithetic=anti)
        torch.cuda.synchronize()
        assert got.shape == (P, d)
        assert (got - want).abs().max().item() <= sigma * 1e-5 + 1e-6


# chip_smoke.py's shapes (mlp_trap, impala_procmaze, impala_prod_bf16 and two
# small ones), then d % 4 of 1, 2 and 3, d < 4, d crossing a chunk boundary
# off a float4 boundary, antithetic pairs with odd P
EXACT_SHAPES = [(2048, 5197, False), (2048, 5197, True), (128, 1_156_139, False),
                (64, 7_872_651, False), (13, 777, False), (7, 1027, True),
                (5, 4097, False), (6, 4098, False), (7, 4099, False), (3, 1, False),
                (4, 2, True), (5, 3, True), (9, 2051, False), (9, 2051, True), (1, 1023, True),
                (11, 3077, True)]


@pytest.mark.parametrize("P, d, anti", EXACT_SHAPES)
def test_perturb_kernel_noise_is_exact(cuda, P, d, anti):
    """eps as the kernel writes it (theta = 0, sigma = 1) equals the plain
    version's bit for bit, every element of every row written."""
    zero = torch.zeros(d, device=cuda)
    got = pk.perturb(zero, 1.0, 0, 7, P, antithetic=anti)
    want = pk.perturb_plain(zero, 1.0, 0, 7, P, antithetic=anti)
    torch.cuda.synchronize()
    assert got.shape == (P, d) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() == 0.0


# beside SHAPES, every combine plan: P = 1; a cluster whose last rank's slice
# is short (1001 draws over 8 ranks of 126); odd P under antithetic with the
# members split over groups and clusters; d < 128; d no multiple of 1024 with
# groups and no cluster; the three trained shapes
COMBINE_SHAPES = SHAPES + [(1, 777, False), (1, 5000, True), (1001, 5197, False),
                           (2049, 5197, True), (9, 100, True), (37, 3000, False),
                           (2048, 5197, True), (128, 1_156_139, False), (64, 7_872_651, False)]


@pytest.mark.parametrize("P, d, anti", COMBINE_SHAPES)
def test_combine_kernel_matches_plain(cuda, P, d, anti):
    coefs = torch.randn(P, device=cuda)
    got = pk.combine(coefs, 9, 4, d, antithetic=anti)
    want = pk.combine_plain(coefs, 9, 4, d, antithetic=anti)
    torch.cuda.synchronize()
    assert ((got - want).norm() / want.norm()).item() <= 1e-5


@pytest.mark.parametrize("P, d, anti", [(2048, 5197, False), (2049, 5197, True),
                                        (64, 7_872_651, False), (13, 777, False)])
def test_combine_kernel_is_deterministic(cuda, P, d, anti):
    """A fixed order of sums: two calls on the same inputs give the same bits."""
    coefs = torch.randn(P, device=cuda)
    first = pk.combine(coefs, 3, 1, d, antithetic=anti)
    assert torch.equal(first, pk.combine(coefs, 3, 1, d, antithetic=anti))


def test_combine_entry_refuses_another_plan(cuda):
    coefs, g = torch.randn(2048, device=cuda), torch.empty(5197, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    lt, mg, cl = pk.combine_plan(2048, 5197)
    for wrong in ((lt * 2, mg // 2, cl), (lt, mg, cl // 2), (256, 1, 1)):
        assert pk._kernels().dfd_combine(coefs.data_ptr(), g.data_ptr(), 2048, 5197, 0, 0, 0,
                                         *wrong, stream) != 0


def test_wrappers_count_launches_and_check_inputs(cuda):
    before = (pk.perturb.launches, pk.combine.launches)
    pk.perturb(torch.zeros(100, device=cuda), 1.0, 0, 0, 4)
    pk.combine(torch.ones(4, device=cuda), 0, 0, 100)
    assert (pk.perturb.launches, pk.combine.launches) == (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="float32"):
        pk.perturb(torch.zeros(100, device=cuda, dtype=torch.float64), 1.0, 0, 0, 4)
    with pytest.raises(ValueError, match="contiguous"):
        pk.combine(torch.ones(8, device=cuda)[::2], 0, 0, 100)


def test_trainer_on_card_matches_cpu(cuda):
    from dfd_tpu_torch.config import TrainConfig
    from dfd_tpu_torch.envs import TrapEnv
    from dfd_tpu_torch.models import DiscreteMLP
    from dfd_tpu_torch.ops import distances
    from dfd_tpu_torch.runners import VectorizedTrainer, make_draws

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig(batch_size=12, learning_rate=0.05, noise_std=0.05, zeta_size=8,
                      max_strategy_history_size=4, random_seed=2, noise_backend="pallas",
                      antithetic=True, normalize_obs=True, obs_stats_update_chance=0.05)
    gen = torch.Generator().manual_seed(0)
    draws = {e: make_draws(gen, 12, 201, 8, TrapEnv(device="cpu")) for e in range(3)}
    gpu, cpu = (
        VectorizedTrainer(DiscreteMLP(2, 9, device=d), TrapEnv(device=d),
                          distances.categorical_tvd, cfg, device=d,
                          draw_source=lambda e: draws[e])
        for d in (cuda, "cpu")
    )
    gpu.state = gpu.state._replace(zeta=cpu.state.zeta.to(cuda))
    gpu.train(3)
    cpu.train(3)
    torch.testing.assert_close(gpu.state.flat.cpu(), cpu.state.flat, rtol=1e-5, atol=1e-6)
    for hg, hc in zip(gpu.reporter.history, cpu.reporter.history):
        assert math.isclose(hg["Noisy Reward"], hc["Noisy Reward"], rel_tol=1e-6)
        assert hg["Cumulative Timesteps"] == hc["Cumulative Timesteps"]


def _fused_args(kind, M, B, ci, co, H, W, dev, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, device=dev, generator=g)
    x = r(M, B, ci, H, W)
    if kind == "res":
        return x, r(M, 4, ci, 9 * ci) / (3 * ci ** 0.5), 0.1 * r(M, 4, ci), \
            0.5 + r(M, 4, ci).abs(), 0.2 * r(M, 4, ci)
    return x, r(M, co, 9 * ci) / (3 * ci ** 0.5), 0.1 * r(M, co), 0.5 + r(M, ci).abs(), \
        0.2 * r(M, ci)


# (M, B, ci, co, H, W, bf16): the flagship's rollout shapes (M = 129 members,
# one frame) and novelty shapes (8 frames) on the f32 route (3xTF32), ragged
# ones (C = 5 and 17, odd H and W), f32 frames that take clusters of 2 and 4
# blocks and tap groups of 3 and 1, production widths in bf16
RES_SHAPES = [(129, 1, 16, 16, 32, 32, False), (129, 1, 32, 32, 16, 16, False),
              (129, 8, 16, 16, 32, 32, False), (129, 8, 32, 32, 16, 16, False),
              (3, 2, 5, 5, 8, 12, False), (3, 2, 5, 5, 9, 13, False),
              (2, 1, 17, 17, 7, 33, False), (2, 1, 16, 16, 40, 40, False),
              (2, 1, 64, 64, 32, 32, False), (2, 1, 32, 32, 24, 24, False),
              (4, 1, 64, 64, 32, 32, True), (4, 1, 128, 128, 16, 16, True)]
FEAT_SHAPES = [(129, 1, 16, 32, 32, 32, False), (129, 1, 32, 32, 16, 16, False),
               (129, 8, 16, 32, 32, 32, False), (129, 8, 32, 32, 16, 16, False),
               (3, 2, 5, 7, 16, 8, False), (3, 1, 5, 7, 9, 13, False),
               (3, 2, 5, 7, 21, 19, False), (2, 1, 3, 20, 40, 24, False),
               (2, 1, 5, 7, 6, 600, False), (2, 1, 64, 128, 32, 32, False),
               (4, 1, 64, 128, 32, 32, True), (4, 1, 128, 128, 16, 16, True)]


def _check_fused(kind, shape, cuda):
    M, B, ci, co, H, W, bf16 = shape
    kernel, plain = ((fr.fused_res_stage, fr.fused_res_stage_plain) if kind == "res"
                     else (fr.fused_feat_pool, fr.fused_feat_pool_plain))
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _fused_args(kind, M, B, ci, co, H, W, cuda)
    cd = torch.bfloat16 if bf16 else None
    got, want = kernel(*args, compute_dtype=cd), plain(*args, compute_dtype=cd)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= (4e-3 if bf16 and kind == "res" else 1e-5) * scale
    if bf16:
        assert err < (got - plain(*args)).abs().max().item()


@pytest.mark.parametrize("kind, shape", [("res", s) for s in RES_SHAPES]
                         + [("feat", s) for s in FEAT_SHAPES])
def test_fused_kernels_match_plain(cuda, kind, shape):
    _check_fused(kind, shape, cuda)


# (M, B, ci, co, H, W) of the bf16 route (the tensor-core kernels):
# impala_prod_bf16's rollout and novelty shapes (M = 65, one frame and 8),
# the card's bf16 reference check's 8/16 channels (stage 0's 3 -> 8 feature
# conv at 32x32 on), and ragged ones: C = 5 and other channels that are no
# multiple of 16, odd H and W, bands that do not divide H (the res stage's
# two row bands, the feature pool's pooled-row bands), a frame of one row
MMA_RES_SHAPES = [(65, 1, 64, 64, 32, 32), (65, 1, 128, 128, 16, 16), (65, 8, 64, 64, 32, 32),
                  (65, 8, 128, 128, 16, 16), (9, 1, 8, 8, 16, 16), (9, 1, 16, 16, 8, 8),
                  (3, 2, 5, 5, 9, 13), (2, 1, 5, 5, 7, 33), (2, 3, 24, 24, 11, 6),
                  (1, 1, 5, 5, 1, 3), (2, 1, 144, 144, 9, 9)]
MMA_FEAT_SHAPES = [(65, 1, 64, 128, 32, 32), (65, 1, 128, 128, 16, 16), (65, 8, 64, 128, 32, 32),
                   (65, 8, 128, 128, 16, 16), (9, 1, 3, 8, 32, 32), (9, 1, 8, 16, 16, 16),
                   (3, 1, 5, 7, 9, 13), (3, 2, 5, 7, 16, 8), (2, 1, 24, 72, 21, 19),
                   (2, 1, 80, 130, 12, 10), (2, 1, 5, 5, 1, 1)]


@pytest.mark.parametrize("kind, shape", [("res", s) for s in MMA_RES_SHAPES]
                         + [("feat", s) for s in MMA_FEAT_SHAPES])
def test_mma_kernels_match_plain(cuda, kind, shape):
    _check_fused(kind, (*shape, True), cuda)


def test_fused_routes_follow_compute_dtype(cuda, monkeypatch):
    """bf16 runs the bf16 tensor-core kernels (fused_resblock_mma.cu), f32 the
    3xTF32 ones (fused_resblock_tf32.cu) and nothing else; each route counts
    only its own launches."""
    from dfd_tpu_torch.ops import build

    assert "fused_resblock" not in build.sources()  # the CUDA-core kernels are gone
    counts = lambda: (fr.fused_res_stage.launches, fr.fused_res_stage.mma_launches,
                      fr.fused_feat_pool.launches, fr.fused_feat_pool.mma_launches)
    calls = []

    def spy(load, prefix):
        lib = load()

        class Spy:
            def __getattr__(self, name):
                fn = getattr(lib, name)
                return lambda *a: calls.append(f"{prefix}.{name}") or fn(*a)
        return Spy()

    tf32, mma = fr._tf32_kernels, fr._mma_kernels
    monkeypatch.setattr(fr, "_tf32_kernels", lambda: spy(tf32, "tf32"))
    monkeypatch.setattr(fr, "_mma_kernels", lambda: spy(mma, "mma"))
    res = _fused_args("res", 2, 1, 8, 8, 16, 16, cuda)
    feat = _fused_args("feat", 2, 1, 8, 16, 16, 16, cuda)
    before = counts()
    fr.fused_res_stage(*res, compute_dtype=torch.bfloat16)
    fr.fused_feat_pool(*feat, compute_dtype=torch.bfloat16)
    assert counts() == (before[0], before[1] + 1, before[2], before[3] + 1)
    assert calls == ["mma.dfd_res_stage_mma", "mma.dfd_feat_pool_mma"]
    fr.fused_res_stage(*res)
    fr.fused_feat_pool(*feat)
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1, before[3] + 1)
    assert calls[2:] == ["tf32.dfd_res_stage_tf32", "tf32.dfd_feat_pool_tf32"]
    # a band no cluster holds goes to the route's tiled form, counted apart
    tiled = lambda: (fr.fused_res_stage.tiled_launches, fr.fused_res_stage.tiled_mma_launches)
    tiled0 = tiled()
    for cd, entry in ((torch.bfloat16, "mma.dfd_res_stage_tiled_mma"),
                      (None, "tf32.dfd_res_stage_tiled_tf32")):
        fr.fused_res_stage(*_fused_args("res", 1, 1, 16, 16, 8, 2000, cuda), compute_dtype=cd)
        assert calls[-1] == entry
    assert tiled() == (tiled0[0] + 1, tiled0[1] + 1)
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1, before[3] + 1)
    # the f32 entry points refuse a plan other than their own
    cluster, band, wt, _ = fr.res_stage_tf32_plan(8, 16, 16)
    x, w, b, s, t = res
    out = torch.empty_like(x)
    ptrs = [v.data_ptr() for v in (x, w, b, s, t, out)]
    stream = torch.cuda.current_stream().cuda_stream
    assert tf32().dfd_res_stage_tf32(*ptrs, 2, 1, 8, 16, 16, cluster, band, 3, stream) != 0
    pb, _, wt, _ = fr.feat_pool_tf32_plan(8, 16, 16, 16)
    x, w, b, s, t = feat
    ptrs = [v.data_ptr() for v in (x, w, b, s, t, out)]
    assert tf32().dfd_feat_pool_tf32(*ptrs, 2, 1, 8, 16, 16, 16, pb + 1, wt, stream) != 0
    # and so do the tiled entry points, in both routes
    plan = fr.res_stage_tiled_plan(8, 16, 16, "tf32")
    x, w, b, s, t = res
    wimg = torch.empty(2 * 4 * fr.tf32_weight_image_floats(8, 8, plan.group), device=cuda)
    ptrs = [v.data_ptr() for v in (x, w, b, s, t, wimg, torch.empty_like(x), out)]
    assert tf32().dfd_res_stage_tiled_tf32(*ptrs, 2, 1, 8, 16, 16, plan.rows + 1, plan.cols, 1,
                                          stream) != 0
    plan = fr.res_stage_tiled_plan(8, 16, 16, "mma")
    wimg = torch.empty(2 * 4 * fr.mma_weight_image_elems(8, 8) // 2, device=cuda)
    ptrs = [v.data_ptr() for v in (x, w, b, s, t, wimg, torch.empty_like(x), out)]
    assert mma().dfd_res_stage_tiled_mma(*ptrs, 2, 1, 8, 16, 16, plan.rows, plan.cols + 1, 1,
                                         stream) != 0
    plan = fr.feat_pool_tiled_plan(8, 16, 16, 16, "mma")
    x, w, b, s, t = feat
    wimg = torch.empty(2 * fr.mma_weight_image_elems(8, 16) // 2, device=cuda)
    ptrs = [v.data_ptr() for v in (x, w, b, s, t, wimg, out)]
    assert mma().dfd_feat_pool_tiled_mma(*ptrs, 2, 1, 8, 16, 16, 16, plan.rows, plan.cols + 1, 1,
                                         stream) != 0


def test_fused_wrappers_count_launches_and_check_inputs(cuda):
    before = (fr.fused_res_stage.launches, fr.fused_feat_pool.launches)
    fr.fused_res_stage(*_fused_args("res", 2, 1, 8, 8, 16, 16, cuda))
    fr.fused_feat_pool(*_fused_args("feat", 2, 1, 8, 16, 16, 16, cuda))
    assert (fr.fused_res_stage.launches, fr.fused_feat_pool.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    x, w, b, s, t = _fused_args("res", 2, 1, 8, 8, 16, 16, cuda)
    with pytest.raises(ValueError, match="float32"):
        fr.fused_res_stage(x.double(), w, b, s, t)
    with pytest.raises(ValueError, match="contiguous"):
        fr.fused_res_stage(x.transpose(3, 4).contiguous().transpose(3, 4), w, b, s, t)
    with pytest.raises(ValueError, match="must lie on"):
        fr.fused_res_stage(x, w.cpu(), b, s, t)
    with pytest.raises(ValueError, match="compute_dtype"):
        fr.fused_res_stage(x, w, b, s, t, compute_dtype=torch.float16)
    assert (fr.fused_res_stage.launches, fr.fused_feat_pool.launches) == (before[0] + 1,
                                                                          before[1] + 1)


def test_impala_trainer_on_card_matches_cpu(cuda):
    """The parity size of tests/test_torch_impala_trainer.py: both fused
    kernels run on the card, their plain versions on the CPU."""
    from dfd_tpu_torch.config import TrainConfig
    from dfd_tpu_torch.envs import ProcMazeEnv
    from dfd_tpu_torch.models import ImpalaPolicy
    from dfd_tpu_torch.ops import distances
    from dfd_tpu_torch.runners import VectorizedTrainer, make_draws

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig(batch_size=8, learning_rate=0.05, noise_std=0.05, zeta_size=4,
                      max_strategy_history_size=4, random_seed=5, noise_backend="pallas")
    gen = torch.Generator().manual_seed(1)
    draws = {e: make_draws(gen, 8, 10, 4, ProcMazeEnv(grid=4, num_levels=20, device="cpu"))
             for e in range(3)}

    def make(d):
        env = ProcMazeEnv(grid=4, scale=8, max_steps=10, num_levels=20, device=d)
        model = ImpalaPolicy(env.obs_shape, 5, channels=(8, 16, 16), hidden=32,
                             conv_impl="fused_feat", device=d)
        return VectorizedTrainer(model, env, distances.categorical_tvd, cfg, device=d,
                                 draw_source=lambda e: draws[e])

    gpu, cpu = make(cuda), make("cpu")
    gpu.state = gpu.state._replace(zeta=cpu.state.zeta.to(cuda))
    before = fr.fused_res_stage.launches
    gpu.train(3)
    cpu.train(3)
    assert fr.fused_res_stage.launches > before
    torch.testing.assert_close(gpu.state.flat.cpu(), cpu.state.flat, rtol=1e-5, atol=1e-6)
    for hg, hc in zip(gpu.reporter.history, cpu.reporter.history):
        assert math.isclose(hg["Noisy Reward"], hc["Noisy Reward"], rel_tol=1e-6)
        assert hg["Cumulative Timesteps"] == hc["Cumulative Timesteps"]



def test_impala_trainer_takes_full_f32_under_high_precision(cuda):
    """A caller's ``set_float32_matmul_precision("high")`` would send the
    f32 IMPALA's fc, LSTM and patches products to TF32; the trainer pins
    full f32, so 2 epochs give the "highest" run's flat, and the caller's
    setting is back afterwards."""
    from dfd_tpu_torch.config import TrainConfig
    from dfd_tpu_torch.envs import ProcMazeEnv
    from dfd_tpu_torch.models import ImpalaPolicy
    from dfd_tpu_torch.ops import distances
    from dfd_tpu_torch.runners import VectorizedTrainer, make_draws

    cfg = TrainConfig(batch_size=8, learning_rate=0.05, noise_std=0.05, zeta_size=4,
                      max_strategy_history_size=4, random_seed=5, noise_backend="pallas")
    gen = torch.Generator().manual_seed(1)
    draws = {e: make_draws(gen, 8, 10, 4, ProcMazeEnv(grid=4, num_levels=20, device="cpu"))
             for e in range(2)}

    def run(precision, zeta=None):
        env = ProcMazeEnv(grid=4, scale=8, max_steps=10, num_levels=20, device=cuda)
        model = ImpalaPolicy(env.obs_shape, 5, channels=(8, 16, 16), hidden=32,
                             conv_impl="fused_feat", device=cuda)
        tr = VectorizedTrainer(model, env, distances.categorical_tvd, cfg, device=cuda,
                               draw_source=lambda e: draws[e])
        if zeta is not None:
            tr.state = tr.state._replace(zeta=zeta)
        zeta0 = tr.state.zeta.clone()
        saved = torch.get_float32_matmul_precision()
        try:
            torch.set_float32_matmul_precision(precision)
            tr.train(2)
            after = torch.get_float32_matmul_precision()
        finally:
            torch.set_float32_matmul_precision(saved)
        assert after == precision
        return tr.state.flat.cpu(), zeta0

    high, zeta0 = run("high")
    highest, _ = run("highest", zeta0)
    torch.testing.assert_close(high, highest, rtol=1e-5, atol=1e-6)


# -- the probes' kernels: gemm_chain, relayout, res_chain ------------------------------


@pytest.mark.parametrize("M, K, N, iters, mode", [
    (1, 1, 1, 1, "acc"), (70, 33, 9, 4, "acc"), (512, 512, 512, 8, "acc"),
    (130, 1000, 70, 3, "acc_scaled"), (16, 27, 4096, 5, "acc_scaled"),
    (1024, 144, 16, 32, "feed"), (70, 33, 129, 4, "feed"),
    # the probes' skinny shapes
    (16, 144, 1024, 16, "acc_scaled"), (1024, 144, 16, 16, "feed"), (8, 128, 128, 16, "acc"),
    # ragged M, K and N (not multiples of 8 or 16), K = 0
    (37, 61, 23, 3, "acc"), (5, 13, 1030, 2, "acc_scaled"), (300, 2000, 64, 2, "acc_scaled"),
    (9, 0, 5, 2, "acc"), (9, 0, 5, 2, "feed"),
    # plans with a K-split cluster (8 blocks; 4 with the 8-warp tiles), feed's among them
    (8, 2048, 8, 3, "acc"), (16, 4096, 1024, 1, "acc"), (300, 700, 256, 2, "feed"),
    (64, 1500, 40, 3, "feed"), (512, 1024, 512, 2, "acc"),
])
def test_gemm_chain_kernel_matches_plain(cuda, M, K, N, iters, mode):
    from dfd_tpu_torch.ops import gemm_chain as gc

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(cuda).manual_seed(M + K + N)
    a = torch.randn(M, K, device=cuda, generator=g)
    b = torch.randn(K, N, device=cuda, generator=g)
    got, want = gc.gemm_chain(a, b, iters, mode), gc.gemm_chain_plain(a, b, iters, mode)
    torch.cuda.synchronize()
    assert got.shape == (M, N)
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


def test_gemm_chain_sel_gemm_keeps_the_even_positions(cuda):
    """The pool probe's Sel-GEMM: x [16, 4096] by the 0/1 [4096, 1024]
    selection of the even (y, x) positions of 64 x 64 equals x[:, idx] to
    1e-5 of the scale (3xTF32 drops lo * lo and rounds lo: not bit-exact)."""
    from dfd_tpu_torch.ops import gemm_chain as gc
    from dfd_tpu_torch.probes.pool import even_positions

    idx = torch.from_numpy(even_positions(64, 64)).long().to(cuda)
    x = torch.randn(16, 4096, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    sel = torch.zeros(4096, 1024, device=cuda)
    sel[idx, torch.arange(1024, device=cuda)] = 1.0
    want = x[:, idx]
    err = (gc.gemm_chain(x, sel, 1) - want).abs().max().item()
    assert gc.gemm_chain_plan(16, 4096, 1024).cluster > 1
    assert err <= 1e-5 * max(1.0, want.abs().max().item()), err


def test_gemm_chain_entry_refuses_another_plan(cuda):
    from dfd_tpu_torch.ops import gemm_chain as gc

    a, b = torch.randn(70, 33, device=cuda), torch.randn(33, 9, device=cuda)
    out, carry = torch.empty(70, 9, device=cuda), torch.empty(2, device=cuda)
    p = gc.gemm_chain_plan(70, 33, 9)
    stream = torch.cuda.current_stream().cuda_stream
    for wrong in (p._replace(cluster=2), p._replace(ks=p.ks + 8), p._replace(nt=p.nt * 2),
                  p._replace(wk=p.wk * 2)):
        assert gc._kernels().dfd_gemm_chain(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), carry.data_ptr(), 70, 33, 9, 1, 0, 1.0,
            wrong.wm, wrong.wn, wrong.wk, wrong.mt, wrong.nt, wrong.cluster, wrong.ks, 0,
            stream) != 0
    # the ordered route takes one tile a block and no cluster
    assert gc._kernels().dfd_gemm_chain(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), carry.data_ptr(), 70, 33, 9, 1, 0, 1.0,
        p.wm, p.wn, p.wk, p.mt, p.nt, 2, p.ks, 1, stream) != 0


def test_relayout_kernels_are_exact(cuda):
    from dfd_tpu_torch.ops import relayout as rl

    for R, L in ((128, 1024), (7, 130), (1, 1)):
        x = torch.randn(R, L, device=cuda)
        for shift, axis in ((1, 1), (1, 0), (64, 1), (-3, 0), (L + 2, 1)):
            assert torch.equal(rl.roll(x, shift, axis), torch.roll(x, shift, axis))
        for view in (x[::2, :], x[:, ::2], x[1:, 3::5], x.t()):
            assert torch.equal(rl.strided_copy(view), view.contiguous())
        assert torch.equal(rl.transpose(x), x.t().contiguous())
        assert torch.equal(rl.concat_scaled(x, (1.0, 2.0, 3.0)), torch.cat([x, 2 * x, 3 * x]))
        idx = torch.randint(0, L, (2 * L + 1,), device=cuda, dtype=torch.int32)
        assert torch.equal(rl.gather_cols(x, idx), x[:, idx.long()])
    x3 = torch.randn(128, 16, 64, device=cuda)
    for view in (x3[:, ::2, :], x3, x3.transpose(0, 2)):
        assert torch.equal(rl.strided_copy(view), view.contiguous())
    out = rl.gather_cols(x, torch.tensor([0, 5], device=cuda, dtype=torch.int32))
    assert torch.isnan(out[:, 1]).all()  # index 5 is outside [0, 1)

    # every route of the roll and the strided copy: storage offsets off 16 bytes, rows of
    # 1, 3 and 5, shifts 1, 4 and L - 1 along lanes, more row runs than gridDim.y holds
    routes = set()

    def roll(x, shift, axis):
        routes.add(rl.roll_plan(x.data_ptr(), *x.shape, shift % x.shape[axis], axis % 2).route)
        assert torch.equal(rl.roll(x, shift, axis), torch.roll(x, shift, axis)), (x.shape, shift)

    def copy(view):
        pad = 3 - view.ndim
        routes.add(rl.strided_copy_plan(view.data_ptr(), (1,) * pad + tuple(view.shape),
                                        (0,) * pad + view.stride()).route)
        assert torch.equal(rl.strided_copy(view), view.contiguous()), (view.shape, view.stride())

    for R, L in ((7, 1), (9, 3), (5, 5), (33, 64), (6, 1030), (300, 1024), (2 ** 20, 1),
                 (2 ** 20, 3), (3000, 16)):
        base = torch.randn(R * L + 3, device=cuda)
        for off in (0, 1, 2, 3):
            x = base[off:off + R * L].view(R, L)
            for shift in {1, 4, L - 1, L + 2}:
                roll(x, shift, 1)
            for shift in {1, R - 1, 4}:
                roll(x, shift, 0)
            for view in (x, x[::2, :], x[:, ::2], x[1:, 3::5], x[:, 1:], x[:, :1], x.t(),
                         x[:1, :].expand(3, L)):
                if view.numel():
                    copy(view)
            if L % 8 == 0:
                y = x.view(R, L // 8, 8)
                for view in (y, y[:, ::2, :], y[:, :, :4], y[1:, :, ::3], y.transpose(0, 2)):
                    copy(view)
    assert routes >= {f"{where}, {load}, 32-bit" for where, load in (
        ("flat", "vector"), ("flat", "aligned stores"), ("rows", "vector"),
        ("rows", "aligned stores"), ("rows", "scalar"))}, routes

    # every route and tile of the transpose: storage offsets off 16 bytes, ragged and skinny
    # shapes, [2129920, 16] (66,560 row tiles of 32: past gridDim.y), grids that loop
    routes = set()
    for R, L in ((16, 4096), (48, 1024), (4096, 16), (7, 130), (5, 5), (6, 1024), (1024, 6),
                 (300, 1024), (33, 4096), (20, 70000), (70000, 20), (2129920, 16),
                 (16, 2129920), (3000, 3001)):
        base = torch.randn(R * L + 3, device=cuda)
        for off in (0, 1, 2, 3):
            x = base[off:off + R * L].view(R, L)
            routes.add(rl.transpose_plan(x.data_ptr(), R, L).route)
            assert torch.equal(rl.transpose(x), x.t().contiguous()), (R, L, off)
    assert {r.split(", ")[1] for r in routes} == {"vector", "vector loads", "vector stores",
                                                  "scalar"}, routes
    assert {r.split(", ")[0] for r in routes} == {"64x16", "16x256", "64x64", "256x16", "32x128",
                                                  "128x32"}, routes
    # every route of the gather: float4 and scalar units, one row a thread or UNROLL, indices
    # outside [0, cols) (NaN), x at an offset off 16 bytes
    routes = set()
    for R, C, n in ((16, 4096, 1024), (7, 130, 3), (9, 17, 1025), (2 ** 20, 3, 1),
                    (600000, 16, 4), (20000, 64, 1024), (33, 64, 8)):
        base = torch.randn(R * C + 1, device=cuda)
        for off in (0, 1):
            x = base[off:off + R * C].view(R, C)
            idx = torch.randint(-2, C + 2, (n,), device=cuda, dtype=torch.int32)
            p = rl.gather_cols_plan(R, C, n)
            routes.add((p.route, p.unroll))
            got = rl.gather_cols(x, idx)
            ok = (idx >= 0) & (idx < C)
            want = torch.where(ok, x[:, idx.clamp(0, C - 1).long()], float("nan"))
            assert torch.equal(got.isnan(), want.isnan()) and torch.equal(
                got.nan_to_num(), want.nan_to_num()), (R, C, n, off)
    assert routes == {(f"{w} stores, 32-bit", u) for w in ("float4", "scalar") for u in (1, 4)}
    # every route of the concat: k = 1, 3 and 8, float4 and scalar units (x.view(-1)[1:],
    # ragged n, a last block part-filled), 1-D and 3-D x
    routes = set()
    for shape in ((1,), (5,), (4096,), (131071,), (128, 1024), (7, 130), (3, 5, 7),
                  (33, 64, 64), (300, 1024), (2 ** 20, 3), (1025, 4096)):
        base = torch.randn(math.prod(shape) + 1, device=cuda)
        for x in (base[:-1].view(shape), base[1:].view(shape), base.view(-1)[1:]):
            for k in (1, 3, 8):
                scales = [0.5 * i - 1.25 for i in range(k)]
                p = rl.concat_plan(x.data_ptr(), x.numel(), k)
                routes.add(p.route)
                assert torch.equal(rl.concat_scaled(x, scales),
                                   torch.cat([x * s for s in scales])), (shape, k, p)
    assert routes == {"vector, 32-bit", "scalar, 32-bit"}, routes
    # empty inputs: empty outputs, no launch
    before = [k.launches for k in rl.KERNELS]
    x = torch.randn(4, 5, device=cuda)
    idx = torch.tensor([0, 2], device=cuda, dtype=torch.int32)
    assert rl.gather_cols(x[:0], idx).shape == (0, 2)
    assert rl.gather_cols(x, idx[:0]).shape == (4, 0)
    assert rl.transpose(x[:0]).shape == (5, 0) and rl.transpose(x[:, :0]).shape == (0, 4)
    assert rl.concat_scaled(x[:0], (1.0, 2.0)).shape == (0, 5)
    torch.cuda.synchronize()
    assert [k.launches for k in rl.KERNELS] == before


def test_relayout_kernels_past_2_31_take_the_64_bit_route(cuda):
    """A [2, 2^30 + 8] tensor (8.6 GB): its last offset passes 2^31.  Each
    output is freed at once, so at most three such tensors are held."""
    from dfd_tpu_torch.ops import relayout as rl

    x = torch.randn(2, 2 ** 30 + 8, device=cuda)
    routes = set()
    for shift, axis in ((1, 1), (2 ** 30 + 7, 1), (1, 0)):
        routes.add(rl.roll_plan(x.data_ptr(), *x.shape, shift, axis).route)
        got = rl.roll(x, shift, axis)
        assert torch.equal(got, torch.roll(x, shift, axis)), (shift, axis)
        del got
    for view in (x[:, 3:], x[:, ::2]):
        routes.add(rl.strided_copy_plan(view.data_ptr(), (1, *view.shape),
                                        (0, *view.stride())).route)
        got = rl.strided_copy(view)
        assert torch.equal(got, view.contiguous())
        del got
    # the transpose to [2^30 + 8, 2] and back, and gathers from x's far end
    tr_routes = set()
    got = rl.transpose(x)
    tr_routes.add(rl.transpose_plan(x.data_ptr(), *x.shape).route)
    assert torch.equal(got, x.t().contiguous())
    tr_routes.add(rl.transpose_plan(got.data_ptr(), *got.shape).route)
    back = rl.transpose(got)
    del got
    assert torch.equal(back, x)
    del back
    for n in (8, 3):
        idx = torch.tensor([0, 2 ** 30 + 7, 5, 2 ** 30, 1, 3, 2 ** 30 + 8, 9][:n], device=cuda,
                           dtype=torch.int32)
        routes.add("gather " + rl.gather_cols_plan(*x.shape, n).route)
        got = rl.gather_cols(x, idx)
        want = x[:, idx.clamp(max=2 ** 30 + 7).long()]
        if n == 8:
            want[:, 6] = float("nan")  # index 2^30 + 8 is outside [0, cols)
        assert torch.equal(got.nan_to_num(), want.nan_to_num()) and torch.equal(
            got.isnan(), want.isnan())
        del got, want
    del x
    torch.cuda.empty_cache()
    assert routes == {"rows, aligned stores, 64-bit", "flat, vector, 64-bit",
                      "rows, scalar, 64-bit", "flat, aligned stores, 64-bit",
                      "gather float4 stores, 64-bit", "gather scalar stores, 64-bit"}, routes
    assert tr_routes == {"16x256, vector loads, 64-bit", "256x16, vector stores, 64-bit"}
    # the concat of 2^28 + 4 floats by 8 scales (8.6 GB out): k * n passes 2^31 - 4096; in
    # float4 units from an aligned x, in scalars from one 4 bytes off; each segment compared
    base = torch.randn(2 ** 28 + 5, device=cuda)
    scales = [1.0, -2.0, 0.5, 3.0, 0.1, -0.25, 7.0, 1e-3]
    routes = set()
    for x in (base[:-1], base[1:]):
        routes.add(rl.concat_plan(x.data_ptr(), x.numel(), 8).route)
        got = rl.concat_scaled(x, scales)
        for i, s in enumerate(scales):
            assert torch.equal(got[i * x.numel():(i + 1) * x.numel()], x * s), (i, routes)
        del got
    del base
    torch.cuda.empty_cache()
    assert routes == {"vector, 64-bit", "scalar, 64-bit"}, routes


def test_relayout_entries_refuse_another_plan(cuda):
    from dfd_tpu_torch.ops import relayout as rl

    x = torch.randn(64, 1024, device=cuda)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    lib = rl._kernels()
    p = rl.roll_plan(x.data_ptr(), 64, 1024, 1, 1)
    v = x[:, ::2]
    q = rl.strided_copy_plan(v.data_ptr(), (1, 64, 512), (0, 1024, 2))
    for i in range(len(p.launch)):
        bad = list(p.launch)
        bad[i] += 1
        assert lib.dfd_roll(x.data_ptr(), out.data_ptr(), 64, 1024, 1, 1, *bad, stream) != 0
        bad = list(q.launch)
        bad[i] += 1
        assert lib.dfd_strided_copy(v.data_ptr(), out.data_ptr(), 1, 64, 512, 0, 1024, 2, *bad,
                                    stream) != 0
    assert lib.dfd_roll(x.data_ptr(), out.data_ptr(), 64, 1024, 1, 1, *p.launch, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, torch.roll(x, 1, 1))
    # the transpose and the gather
    t = rl.transpose_plan(x.data_ptr(), 64, 1024)
    for i in range(len(t)):
        bad = list(t)
        bad[i] += 1
        assert lib.dfd_transpose(x.data_ptr(), out.data_ptr(), 64, 1024, *bad, stream) != 0
    idx = torch.arange(0, 1024, 2, device=cuda, dtype=torch.int32)
    g = rl.gather_cols_plan(64, 1024, 512)
    for i in range(len(g)):
        bad = list(g)
        bad[i] += 1
        assert lib.dfd_gather_cols(x.data_ptr(), idx.data_ptr(), out.data_ptr(), 64, 1024, 512,
                                   *bad, stream) != 0
    # float4 stores to an output off 16 bytes are refused
    assert lib.dfd_transpose(x.data_ptr(), out.data_ptr() + 4, 64, 1024, *t, stream) != 0
    assert lib.dfd_gather_cols(x.data_ptr(), idx.data_ptr(), out.data_ptr() + 4, 64, 1024, 512,
                               *g, stream) != 0
    assert lib.dfd_transpose(x.data_ptr(), out.data_ptr(), 64, 1024, *t, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out.view(1024, 64), x.t())
    # the concat: another plan, or float4 stores to an output off 16 bytes, are refused
    scales = (ctypes.c_float * 3)(1.0, 2.0, 3.0)
    big = torch.empty(3 * x.numel() + 4, device=cuda)
    for n in (x.numel(), x.numel() - 1, 4096):
        c = rl.concat_plan(x.data_ptr(), n, 3)
        for i in range(len(c)):
            bad = list(c)
            bad[i] += 1
            assert lib.dfd_concat_scaled(x.data_ptr(), big.data_ptr(), n, scales, 3, *bad,
                                         stream) != 0
    c = rl.concat_plan(x.data_ptr(), x.numel(), 3)
    assert lib.dfd_concat_scaled(x.data_ptr(), big.data_ptr() + 4, x.numel(), scales, 3, *c,
                                 stream) != 0
    assert lib.dfd_concat_scaled(x.data_ptr(), big.data_ptr(), x.numel(), scales, 3, *c,
                                 stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(big[:-4].view(3 * 64, 1024), torch.cat([x, 2 * x, 3 * x]))


# the probes' shapes (P = 64), then
# every cluster size (1: P = 132, or one row of 6 channels; 2, 4, 8) and split (rows, channels,
# both), ragged bands and channel groups, C no multiple of 4, 8 or 16, warp grids of 2
# x 4 warps, P = 1
RES_CHAIN_SHAPES = [(2, 8, 8, 8), (3, 12, 5, 7), (2, 20, 17, 19), (2, 128, 16, 16),
                    (2, 64, 32, 32), (64, 128, 16, 16), (64, 64, 32, 32), (64, 16, 32, 32),
                    (200, 16, 8, 8), (1, 8, 8, 8), (1, 40, 4, 4), (1, 64, 2, 3), (1, 33, 3, 5),
                    (1, 130, 2, 2), (2, 128, 4, 8), (3, 6, 1, 40), (132, 16, 32, 32)]


def _res_chain_args(P, C, H, W, layout, cuda):
    g = torch.Generator(cuda).manual_seed(C)
    S = H * W
    minor = layout == "channel_minor"
    x = 0.1 * torch.randn((P, S, C) if minor else (P, C, S), device=cuda, generator=g)
    w = torch.randn((P, 4, 9 * C, C) if minor else (P, 4, C, 9 * C), device=cuda, generator=g)
    b = 0.1 * torch.randn(P, 4, C, device=cuda, generator=g)
    return x, w / (3 * C ** 0.5), b


@pytest.mark.parametrize("P, C, H, W", RES_CHAIN_SHAPES)
@pytest.mark.parametrize("layout", ["channel_major", "channel_minor"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_res_chain_kernel_matches_plain(cuda, P, C, H, W, layout, bf16):
    from dfd_tpu_torch.ops import res_chain as rc

    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, b = _res_chain_args(P, C, H, W, layout, cuda)
    cd = torch.bfloat16 if bf16 else None
    got = rc.res_chain(x, w, b, H, W, layout, cd)
    want = rc.res_chain_plain(x, w, b, H, W, layout, cd)
    torch.cuda.synchronize()
    assert got.shape == x.shape
    err = (got - want).abs().max().item()
    assert err <= (5e-4 if bf16 else 1e-5) * max(1.0, want.abs().max().item()), err
    if bf16:
        assert err < (got - rc.res_chain_plain(x, w, b, H, W, layout, None)).abs().max().item()
    # and the same bits again
    assert torch.equal(got, rc.res_chain(x, w, b, H, W, layout, cd))


def test_res_chain_refuses_what_no_plan_fits(cuda):
    from dfd_tpu_torch.ops import res_chain as rc

    x, w, b = _res_chain_args(1, 1024, 8, 8, "channel_major", cuda)
    with pytest.raises(ValueError, match="no res_chain plan"):
        rc.res_chain(x, w, b, 8, 8)
    # the entry point recomputes the plan and refuses another
    x, w, b = _res_chain_args(2, 20, 17, 19, "channel_major", cuda)
    out = torch.empty_like(x)
    p = rc.res_chain_plan(2, 20, 17, 19)
    stream = torch.cuda.current_stream().cuda_stream
    for wrong in (p._replace(rs=p.rs * 2), p._replace(cs=p.cs * 2), p._replace(wt=1),
                  p._replace(nt=p.nt + 1)):
        assert rc._kernels().dfd_res_chain(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                           out.data_ptr(), 2, 4, 20, 17, 19, 0, 0, *wrong[:-1],
                                           stream) != 0


def test_probe_wrappers_count_launches_and_check_inputs(cuda):
    from dfd_tpu_torch.ops import gemm_chain as gc
    from dfd_tpu_torch.ops import relayout as rl
    from dfd_tpu_torch.ops import res_chain as rc

    x = torch.randn(8, 16, device=cuda)
    before = [gc.gemm_chain.launches, rc.res_chain.launches] + [k.launches for k in rl.KERNELS]
    gc.gemm_chain(x, x.t().contiguous(), 2)
    rc.res_chain(torch.randn(1, 2, 9, device=cuda), torch.randn(1, 4, 2, 18, device=cuda),
                 torch.randn(1, 4, 2, device=cuda), 3, 3)
    rl.roll(x, 1, 0), rl.strided_copy(x[:, ::2]), rl.gather_cols(x, torch.zeros(
        3, dtype=torch.int32, device=cuda)), rl.transpose(x), rl.concat_scaled(x, (1.0,))
    after = [gc.gemm_chain.launches, rc.res_chain.launches] + [k.launches for k in rl.KERNELS]
    assert after == [n + 1 for n in before]
    with pytest.raises(ValueError, match="float32"):
        gc.gemm_chain(x.double(), x.t().double(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        rl.transpose(x[:, ::2])
    # the inputs the CPU wrappers refuse (tests/test_torch_relayout.py::
    # test_cpu_wrappers_refuse_what_the_card_refuses) are refused here with the same text
    idx = torch.tensor([0, 2, 3], dtype=torch.int32, device=cuda)
    wrappers = {rl.roll: (lambda v: rl.roll(v, 1, 1), True),
                rl.strided_copy: (rl.strided_copy, False),
                rl.gather_cols: (lambda v: rl.gather_cols(v, idx), True),
                rl.transpose: (rl.transpose, True),
                rl.concat_scaled: (lambda v: rl.concat_scaled(v, (1.0, 2.5)), True)}
    x64 = torch.randn(4, 6, device=cuda, dtype=torch.float64)
    for fn, contiguous in wrappers.values():
        with pytest.raises(ValueError, match="x must be float32, got torch.float64"):
            fn(x64)
        if contiguous:
            with pytest.raises(ValueError, match="x must be contiguous"):
                fn(x64.float().t())
    with pytest.raises(ValueError, match="float32"):
        rl.concat_scaled(torch.arange(6, device=cuda).view(2, 3), (1.0, 2.5))
    with pytest.raises(ValueError, match="idx must be contiguous"):
        rl.gather_cols(x, torch.tensor([0, 1, 2, 1], dtype=torch.int32, device=cuda)[::2])
    with pytest.raises(ValueError, match="CPU or"):
        gc.gemm_chain(x, x.t().cpu().contiguous(), 2)
    with pytest.raises(ValueError, match="compute_dtype"):
        rc.res_chain(torch.randn(1, 2, 9, device=cuda), torch.randn(1, 4, 2, 18, device=cuda),
                     torch.randn(1, 4, 2, device=cuda), 3, 3, compute_dtype=torch.float16)
    after2 = [gc.gemm_chain.launches, rc.res_chain.launches] + [k.launches for k in rl.KERNELS]
    assert after2 == after


# -- JAX's threefry normal: normal_kernel --------------------------------------------------

# (rows, d, antithetic, odd_first): the trained cells' shapes, P = 1, ragged d
# (d % 4 of 1, 2, 3, d < 4), antithetic pairs (odd rows, a block starting on
# an odd member, P = 1 antithetic)
NORMAL_SHAPES = [(2048, 5197, False, False), (2048, 5197, True, False),
                 (128, 1_156_139, False, False), (64, 7_872_651, False, False),
                 (1, 1, False, False), (1, 4097, False, False), (3, 3, False, False),
                 (5, 4, False, False), (5, 1026, False, False), (7, 1027, True, False),
                 (6, 1025, True, True), (1, 9, True, True), (1, 9, True, False),
                 (9, 2048, True, True)]


def _normal_keys(rows, antithetic, odd_first, dev, seed=3, epoch=5):
    from dfd_tpu_torch.core.noise import CounterNoise

    noise = CounterNoise(1, seed, antithetic, device=dev)
    return noise._keys(epoch, int(odd_first), rows)[0]


@pytest.mark.parametrize("rows, d, anti, odd", NORMAL_SHAPES)
def test_normal_kernel_is_exact(cuda, rows, d, anti, odd):
    """eps and theta + sigma * eps bit for bit against normal_plain on the
    card, every element of every row written, theta as the last row."""
    from dfd_tpu_torch.ops import noise as nz

    keys = _normal_keys(rows, anti, odd, cuda)
    theta = torch.randn(d, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    before = nz.normal.launches
    eps, pert = nz.normal(keys, rows, d, antithetic=anti, odd_first=odd, theta=theta,
                          sigma=0.05, theta_row=True)
    torch.cuda.synchronize()
    assert nz.normal.launches == before + 1
    want = nz.normal_plain(keys, rows, d, anti, odd)
    assert eps.shape == (rows, d) and bool(torch.isfinite(eps).all())
    assert torch.equal(eps, want)
    assert torch.equal(pert[:rows], nz.perturbed_plain(want, theta, 0.05))
    assert torch.equal(pert[rows], theta)
    del want, pert
    alone, none = nz.normal(keys, rows, d, antithetic=anti, odd_first=odd)
    assert none is None and torch.equal(alone, eps)


def test_normal_wrapper_skips_empty_work_and_checks_inputs(cuda):
    from dfd_tpu_torch.ops import noise as nz

    keys = _normal_keys(2, False, False, cuda)
    before = nz.normal.launches
    eps, _ = nz.normal(keys, 2, 0)
    _, pert = nz.normal(keys[:0], 0, 5, theta=torch.ones(5, device=cuda), theta_row=True)
    assert nz.normal.launches == before and eps.shape == (2, 0)
    assert torch.equal(pert, torch.ones(1, 5, device=cuda))
    with pytest.raises(ValueError, match="keys must be a contiguous int32"):
        nz.normal(keys.long(), 2, 8)
    with pytest.raises(ValueError, match="theta must be a contiguous float32"):
        nz.normal(keys, 2, 8, theta=torch.zeros(16, device=cuda)[::2])
    with pytest.raises(ValueError, match="theta must be a contiguous float32"):
        nz.normal(keys, 2, 8, theta=torch.zeros(8))
    out = torch.empty(4, 8, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    # the C entry refuses a draw count that does not fit the rows
    assert nz._kernels().dfd_normal(keys.data_ptr(), 0, out.data_ptr(), 0, 8, 4, 2, 0, 0, 0.0,
                                    stream) != 0
    assert nz.normal.launches == before


def test_wrappers_refuse_on_the_card_what_the_cpu_refuses(cuda):
    """The six wrappers of the CPU's refusal test, on CUDA tensors: the same
    ValueError texts, no launch."""
    from dfd_tpu_torch.ops import gemm_chain as gc
    from dfd_tpu_torch.ops import res_chain as rc

    r = lambda *shape: torch.randn(*shape, device=cuda)
    stage = lambda C: (r(1, 1, C, 2, 2), r(1, 4, C, 9 * C), r(1, 4, C), r(1, 4, C), r(1, 4, C))
    feat = lambda co: (r(1, 1, 8, 2, 2), r(1, co, 72), r(1, co), r(1, 8), r(1, 8))
    counts = lambda: (pk.perturb.launches, pk.combine.launches, fr.fused_res_stage.launches,
                      fr.fused_feat_pool.launches, rc.res_chain.launches, gc.gemm_chain.launches)
    before = counts()
    cases = [
        (lambda: pk.perturb(r(40).double(), 0.1, 3, 1, 2), "contiguous 1-D float32"),
        (lambda: pk.combine(r(8)[::2], 3, 1, 40), "contiguous 1-D float32"),
        (lambda: fr.fused_res_stage(*(v.double() for v in stage(4))), "contiguous float32"),
        (lambda: fr.fused_res_stage(*stage(4), compute_dtype=torch.float16), "compute_dtype"),
        (lambda: fr.fused_res_stage(stage(4)[0], r(1, 4, 4, 35), *stage(4)[2:]),
         "w must be"),
        (lambda: fr.fused_feat_pool(*feat(8)[:2], r(1, 9), *feat(8)[3:]), "b must be 1-D"),
        (lambda: rc.res_chain(r(1, 4, 32)[..., ::2], r(1, 1, 4, 36), r(1, 1, 4), 4, 4),
         "contiguous float32"),
        (lambda: rc.res_chain(r(1, 512, 4096), r(1, 1, 512, 4608), r(1, 1, 512), 64, 64),
         "no res_chain plan fits"),
        (lambda: gc.gemm_chain(r(8, 4).t(), r(8, 4), 2), "a must be a contiguous float32"),
        (lambda: gc.gemm_chain(r(1, 65536), r(65536, 1), 2), "do not fit"),
    ]
    for call, what in cases:
        with pytest.raises(ValueError, match=what):
            call()
    assert counts() == before


@pytest.mark.parametrize("kw", [dict(antithetic=True), dict(envs_per_perturbation=3),
                                dict(population_chunk=4, envs_per_perturbation=2),
                                dict(zeta_size=0, eval_every=2)],
                         ids=["jax", "E3", "chunked", "unfused_eval"])
def test_jax_backend_trainer_on_card_matches_cpu(cuda, kw):
    """The default noise backend, E > 1, chunking and the unfused eval
    episode: the card's trainer against the CPU's on the same draws."""
    from dfd_tpu_torch.config import TrainConfig
    from dfd_tpu_torch.envs import TrapEnv
    from dfd_tpu_torch.models import DiscreteMLP
    from dfd_tpu_torch.ops import distances
    from dfd_tpu_torch.ops import noise as nz
    from dfd_tpu_torch.runners import VectorizedTrainer, make_draws

    cfg = TrainConfig(**dict(dict(batch_size=12, learning_rate=0.05, noise_std=0.05,
                                  zeta_size=8, max_strategy_history_size=4, random_seed=2),
                             **kw))
    E, Z = cfg.envs_per_perturbation, cfg.zeta_size
    gen = torch.Generator().manual_seed(0)
    draws = {e: make_draws(gen, 12, 201, Z, TrapEnv(device="cpu"), E)
             for e in range(3)}
    gpu, cpu = (
        VectorizedTrainer(DiscreteMLP(2, 9, device=d), TrapEnv(device=d),
                          distances.categorical_tvd, cfg, device=d,
                          draw_source=lambda e: draws[e])
        for d in (cuda, "cpu")
    )
    gpu.state = gpu.state._replace(zeta=cpu.state.zeta.to(cuda))
    before = nz.normal.launches
    gpu.train(3)
    cpu.train(3)
    chunks = 12 // gpu.chunk
    assert nz.normal.launches - before == 3 * (1 if chunks == 1 else 2 * chunks)
    torch.testing.assert_close(gpu.state.flat.cpu(), cpu.state.flat, rtol=1e-5, atol=1e-6)
    for hg, hc in zip(gpu.reporter.history, cpu.reporter.history):
        assert math.isclose(hg["Noisy Reward"], hc["Noisy Reward"], rel_tol=1e-6)
        assert math.isclose(hg["Policy Reward"], hc["Policy Reward"], rel_tol=1e-6)
        assert hg["Cumulative Timesteps"] == hc["Cumulative Timesteps"]


@pytest.mark.parametrize("kw", [dict(), dict(population_chunk=4, envs_per_perturbation=2),
                                dict(zeta_size=0, eval_every=1)],
                         ids=["whole", "chunked", "unfused_eval"])
def test_jax_backend_epoch_step_makes_no_host_synchronisation(cuda, kw):
    """train_fast's chunks of epochs need an epoch step that never waits for
    the card: one step under PyTorch's sync debug mode set to raise."""
    from dfd_tpu_torch.config import TrainConfig
    from dfd_tpu_torch.envs import TrapEnv
    from dfd_tpu_torch.models import DiscreteMLP
    from dfd_tpu_torch.ops import distances
    from dfd_tpu_torch.runners import VectorizedTrainer

    cfg = TrainConfig(**dict(dict(batch_size=12, learning_rate=0.05, noise_std=0.05,
                                  zeta_size=8, max_strategy_history_size=4, random_seed=2),
                             **kw))
    tr = VectorizedTrainer(DiscreteMLP(2, 9, device=cuda), TrapEnv(device=cuda),
                           distances.categorical_tvd, cfg, device=cuda)
    tr.train(1)
    archive, count = tr._archive_inputs()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = tr._epoch_step(tr.state, archive, count)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.epoch == tr.state.epoch + 1


# -- VBN, AtariCNN, PixelGridEnv, checkpoint and the eval panel on the card --------------


def _bn_close(got, want, rtol=1e-5):
    """BatchNorm statistics under ``utils/closeness.py``'s rule (means
    summed in another order)."""
    from dfd_tpu_torch.utils.closeness import bn_state_mismatch

    faults, _ = bn_state_mismatch(got, want, rtol)
    assert not faults, faults


def test_batchnorm_train_on_card_matches_cpu(cuda):
    from dfd_tpu_torch.models import layers

    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4000, 24, generator=g) * 3 + 1
    p = {"w": torch.rand(1, 24, generator=g) + 0.5, "b": torch.randn(1, 24, generator=g)}
    s = {"mean": torch.randn(24, generator=g), "var": torch.rand(24, generator=g) + 0.1,
         "n": torch.tensor(2.0)}
    y, ns = layers.batchnorm_train(p, s, x)
    on = lambda t: {k: v.to(cuda) for k, v in t.items()}
    y_g, ns_g = layers.batchnorm_train(on(p), on(s), x.to(cuda))
    torch.testing.assert_close(y_g.cpu(), y, rtol=1e-5, atol=1e-5)
    _bn_close({"bn": ns_g}, {"bn": ns})


def _vbn_models():
    from dfd_tpu_torch.models import AtariCNN, DiscreteMLP, ImpalaPolicy

    small = dict(channels=(8, 16, 16), hidden=32)
    return {
        "mlp": (lambda d: DiscreteMLP(2, 9, device=d), (60, 2), False),
        "impala_patches": (lambda d: ImpalaPolicy((3, 32, 32), 5, device=d, **small),
                           (20, 3, 32, 32), True),
        "impala_fused_feat_bf16": (lambda d: ImpalaPolicy(
            (3, 32, 32), 5, conv_impl="fused_feat", compute_dtype=torch.bfloat16, device=d,
            **small), (20, 3, 32, 32), True),
        "atari": (lambda d: AtariCNN((24, 24), 5, in_channels=3, device=d), (20, 3, 24, 24),
                  False),
        "atari_bf16": (lambda d: AtariCNN((24, 24), 5, in_channels=3,
                                          compute_dtype=torch.bfloat16, device=d),
                       (20, 3, 24, 24), False),
    }


@pytest.mark.parametrize("name", list(_vbn_models()))
def test_model_vbn_on_card_matches_cpu(cuda, name):
    """Each model's VBN refresh on the card against the CPU's, on the same
    weights and buffer (IMPALA's with arrival rewards, in f32 whatever its
    compute_dtype, launching no fused kernel).  bf16 AtariCNN: an f32
    intermediate one ulp apart can round to the neighbouring bf16 value, so
    its statistics are held to 2e-3 of their scale."""
    make, shape, recurrent = _vbn_models()[name]
    from dfd_tpu_torch.core.device import full_f32

    models = {d: make(d) for d in ("cpu", cuda)}
    params, state = models["cpu"].init(3)
    flat = models["cpu"].get_flat(params)
    flat = flat + 0.05 * torch.randn(flat.shape, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    buffer = torch.rand(shape, generator=g) * (255 if recurrent else 1)
    rewards = torch.randn(shape[0], generator=g) * 2
    before = (fr.fused_res_stage.launches, fr.fused_feat_pool.launches)
    out = {}
    with full_f32():
        for d, m in models.items():
            st = {k: {n: v.to(d) for n, v in s.items()} for k, s in state.items()}
            out[d] = m.vbn(m.set_flat(flat.to(d)[None]), st, buffer.to(d),
                           rewards=rewards.to(d))
    torch.cuda.synchronize()
    assert (fr.fused_res_stage.launches, fr.fused_feat_pool.launches) == before
    _bn_close(out[cuda], out["cpu"], rtol=2e-3 if name == "atari_bf16" else 1e-5)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_atari_forward_on_card_matches_cpu(cuda, bf16):
    """AtariCNN's probabilities of a population of 3 on the card and the CPU
    (bf16: to 2e-3, the neighbouring-bf16 rounding)."""
    from dfd_tpu_torch.core.device import full_f32
    from dfd_tpu_torch.models import AtariCNN

    cd = torch.bfloat16 if bf16 else None
    models = {d: AtariCNN((64, 64), 5, in_channels=3, compute_dtype=cd, device=d)
              for d in ("cpu", cuda)}
    params, state = models["cpu"].init(0)
    flat = models["cpu"].get_flat(params)
    g = torch.Generator().manual_seed(3)
    flats = flat + 0.05 * torch.randn((3, flat.numel()), generator=g)
    frames = torch.rand(3, 4, 3, 64, 64, generator=g)
    with full_f32():
        want = models["cpu"].apply(models["cpu"].set_flat(flats), state, frames)
        st = {k: {n: v.to(cuda) for n, v in s.items()} for k, s in state.items()}
        got = models[cuda].apply(models[cuda].set_flat(flats.to(cuda)), st, frames.to(cuda))
    torch.testing.assert_close(got.cpu(), want, **(dict(rtol=0, atol=2e-3) if bf16 else
                                                   dict(rtol=1e-5, atol=1e-6)))


def test_pixelgrid_on_card_matches_cpu(cuda):
    """40 steps of 64 episodes: states, frames, rewards and dones equal."""
    from dfd_tpu_torch.envs import PixelGridEnv

    envs = {d: PixelGridEnv(grid=8, scale=8, max_steps=40, intensity=1.0, device=d)
            for d in ("cpu", cuda)}
    g = torch.Generator().manual_seed(0)
    draw = envs["cpu"].sample_reset((64,), g)
    actions = torch.randint(0, 5, (40, 64), generator=g)
    runs = {d: [env.reset(64, draw.to(d))] for d, env in envs.items()}
    for d, env in envs.items():
        state = runs[d][0][0]
        for t in range(40):
            state, obs, rew, done = env.step(state, actions[t].to(d))
            runs[d].append((state, obs, rew, done))
    for a, b in zip(runs["cpu"], runs[cuda]):
        for x, y in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)):
            assert torch.equal(x, y.cpu())


def test_vbn_trainer_on_card_matches_cpu(cuda):
    """The trap MLP with a VBN buffer of 50 on the jax noise backend: flat,
    bn_state and rewards of the card's trainer against the CPU's on the same
    draws, zeta and buffer; one more epoch step makes no host sync."""
    from dfd_tpu_torch.config import TrainConfig
    from dfd_tpu_torch.envs import TrapEnv
    from dfd_tpu_torch.models import DiscreteMLP
    from dfd_tpu_torch.ops import distances
    from dfd_tpu_torch.runners import VectorizedTrainer, make_draws

    cfg = TrainConfig(batch_size=12, learning_rate=0.05, noise_std=0.05, zeta_size=8,
                      max_strategy_history_size=4, random_seed=2, vbn_buffer_size=50)
    gen = torch.Generator().manual_seed(0)
    draws = {e: make_draws(gen, 12, 201, 8, TrapEnv(device="cpu")) for e in range(4)}
    gpu, cpu = (VectorizedTrainer(DiscreteMLP(2, 9, device=d), TrapEnv(device=d),
                                  distances.categorical_tvd, cfg, device=d,
                                  draw_source=lambda e: draws[e]) for d in (cuda, "cpu"))
    gpu.state = gpu.state._replace(zeta=cpu.state.zeta.to(cuda))
    gpu._vbn_buffer = tuple(x.to(cuda) for x in cpu._vbn_buffer)
    gpu.train(3)
    cpu.train(3)
    torch.testing.assert_close(gpu.state.flat.cpu(), cpu.state.flat, rtol=1e-5, atol=1e-6)
    _bn_close(gpu.state.bn_state, cpu.state.bn_state)
    for hg, hc in zip(gpu.reporter.history, cpu.reporter.history):
        assert math.isclose(hg["Noisy Reward"], hc["Noisy Reward"], rel_tol=1e-6)
    gpu.draw_source = gpu._own_draws  # drawn on the card: moving the CPU's draws would wait
    archive, count = gpu._archive_inputs()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = gpu._epoch_step(gpu.state, archive, count)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(state.bn_state["bn1"]["n"]) == 4


def test_checkpoint_on_card_resumes_bit_for_bit(cuda, tmp_path):
    """A CUDA generator's state (a CPU byte tensor) round-trips: the resumed
    run's draws, flat and bn_state equal the unbroken run's bit for bit."""
    from dfd_tpu_torch.config import TrainConfig
    from dfd_tpu_torch.envs import TrapEnv
    from dfd_tpu_torch.models import DiscreteMLP
    from dfd_tpu_torch.ops import distances
    from dfd_tpu_torch.runners import VectorizedTrainer
    from dfd_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    cfg = TrainConfig(batch_size=16, learning_rate=0.05, noise_std=0.05, zeta_size=8,
                      max_strategy_history_size=3, random_seed=1, vbn_buffer_size=30)
    make = lambda: VectorizedTrainer(DiscreteMLP(2, 9, device=cuda), TrapEnv(device=cuda),
                                     distances.categorical_tvd, cfg, device=cuda)
    path = str(tmp_path / "card.npz")
    a = make()
    a.train(2)
    save_checkpoint(path, a)
    a.train(2)
    b = make()
    load_checkpoint(path, b)
    b.train(2)
    assert torch.equal(a.state.flat, b.state.flat)
    for layer in a.state.bn_state:
        for k, v in a.state.bn_state[layer].items():
            assert torch.equal(v, b.state.bn_state[layer][k])
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_eval_panel_on_card_matches_cpu(cuda):
    """The small fused_feat IMPALA's panel of 16 on the card (one torso call
    a step, each launching the f32 fused kernels its stages take) equals the
    CPU trainer's on the card's state, and moves nothing."""
    from dfd_tpu_torch.config import TrainConfig
    from dfd_tpu_torch.core.device import tree_to
    from dfd_tpu_torch.envs import ProcMazeEnv
    from dfd_tpu_torch.models import ImpalaPolicy
    from dfd_tpu_torch.ops import distances
    from dfd_tpu_torch.runners import VectorizedTrainer

    cfg = TrainConfig(batch_size=8, learning_rate=0.05, noise_std=0.05, zeta_size=4,
                      max_strategy_history_size=4, random_seed=4, vbn_buffer_size=10)

    def make(d):
        env = ProcMazeEnv(grid=4, scale=8, max_steps=10, num_levels=50, device=d)
        model = ImpalaPolicy(env.obs_shape, 5, channels=(8, 16, 16), hidden=32,
                             conv_impl="fused_feat", device=d)
        return VectorizedTrainer(model, env, distances.categorical_tvd, cfg, device=d)

    gpu, cpu = make(cuda), make("cpu")
    gpu.train(2)
    cpu.state = tree_to(gpu.state, "cpu")
    res, feat = fr.fused_res_stage.launches, fr.fused_feat_pool.launches
    before = gpu.generator.get_state()
    got = gpu.eval_panel(16, panel_seed=5)
    stages = gpu.model._stages  # at 3x32x32, 8/16/16: the res pair of stage 0, the feat of 1
    per_call = (sum(st.res_fused for st in stages), sum(st.feat_fused for st in stages))
    assert per_call == (1, 1)
    assert (fr.fused_res_stage.launches - res, fr.fused_feat_pool.launches - feat) == (10, 10)
    assert torch.equal(before, gpu.generator.get_state()) and gpu.state.epoch == 2
    assert (got == cpu.eval_panel(16, panel_seed=5)).all()


# -- the swimmer's step kernel and the Gaussian trainer on the card ----------------------


def _rel(got, want) -> float:
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp_min(1)).item()


@pytest.mark.parametrize("n_links, N", [(7, 513), (3, 37), (5, 37), (7, 1)])
def test_swimmer_kernel_matches_plain(cuda, n_links, N):
    """swimmer_step_kernel against swimmer_step_plain from random states
    (angles and velocities in [-1, 1], actions in [-1.5, 1.5]), one launch a
    step: after one step qdot and obs within twice float32's conditioning
    bound cond(M + dt D) 2^-24 (~5e3 at 7 links), q within dt frame_skip of
    it, the reward within 2e-5; after 100 wave-gait steps qdot 1e-3, q 5e-4,
    the reward 1e-4; t and done exact throughout."""
    from dfd_tpu_torch.envs import SwimmerEnv
    from dfd_tpu_torch.ops import swimmer as sw

    env = SwimmerEnv(n_links=n_links, max_steps=100, device=cuda)
    c = env.consts
    g = torch.Generator(cuda).manual_seed(n_links)
    unif = lambda *shape, lim: (torch.rand(*shape, generator=g, device=cuda) * 2 - 1) * lim
    q, qd, a = unif(N, c.ndof, lim=1.0), unif(N, c.ndof, lim=1.0), unif(N, n_links - 1, lim=1.5)
    t = torch.randint(0, 100, (N,), generator=g, device=cuda)
    c64 = c._replace(T=c.T.double(), Aphi=c.Aphi.double(), M0=c.M0.double(), D0=c.D0.double())
    M, D, _ = sw.terms_closed(c64, q.double(), qd.double())
    tol = 2 * torch.linalg.cond(M + c.dt * D).max().item() * 2.0 ** -24
    before = sw.swimmer_step.launches
    got, want = sw.swimmer_step(c, q, qd, t, a), sw.swimmer_step_plain(c, q, qd, t, a)
    assert sw.swimmer_step.launches - before == 1
    assert _rel(got[1], want[1]) <= tol and _rel(got[3], want[3]) <= tol
    assert _rel(got[0], want[0]) <= c.dt * c.frame_skip * tol * max(1.0, want[1].abs().max().item())
    assert (got[4] - want[4]).abs().max().item() <= 2e-5
    assert torch.equal(got[2], want[2]) and torch.equal(got[5], want[5])
    ka = kp = (q, qd, torch.zeros(N, dtype=torch.int64, device=cuda))
    for s in range(100):
        act = torch.sin(0.4 * s + 0.8 * torch.arange(n_links - 1, device=cuda,
                                                      dtype=torch.float32))
        act = act.expand(N, -1).contiguous()
        kk, pp = sw.swimmer_step(c, *ka, act), sw.swimmer_step_plain(c, *kp, act)
        assert torch.equal(kk[2], pp[2]) and torch.equal(kk[5], pp[5])
        ka, kp = kk[:3], pp[:3]
    assert _rel(kk[1], pp[1]) <= 1e-3 and _rel(kk[0], pp[0]) <= 5e-4
    assert (kk[4] - pp[4]).abs().max().item() <= 1e-4 and pp[5].all()


@pytest.mark.parametrize("N", [1, 5, 33, 513])
def test_swimmer_kernel_episode_ignores_its_neighbours(cuda, N):
    """Each of N episodes stepped alone (N = 1, one block) gives the outputs
    it gives among the N, bit for bit, at N that leave the last block with
    fewer episodes than it holds; and 20 more launches on the same inputs
    give the first one's outputs, bit for bit (the only check of the lanes'
    exchanges for races that runs on the card)."""
    from dfd_tpu_torch.envs import SwimmerEnv
    from dfd_tpu_torch.ops import swimmer as sw

    c = SwimmerEnv(device=cuda).consts
    g = torch.Generator(cuda).manual_seed(100 + N)
    unif = lambda *shape, lim: (torch.rand(*shape, generator=g, device=cuda) * 2 - 1) * lim
    ins = (unif(N, c.ndof, lim=1.0), unif(N, c.ndof, lim=1.0),
           torch.randint(0, 100, (N,), generator=g, device=cuda), unif(N, c.n_links - 1, lim=1.5))
    together = sw.swimmer_step(c, *ins)
    alone = [sw.swimmer_step(c, *(x[e:e + 1].contiguous() for x in ins)) for e in range(N)]
    for k, out in enumerate(together):
        assert torch.equal(torch.cat([a[k] for a in alone]), out), k
    for _ in range(20):
        assert all(torch.equal(x, y) for x, y in zip(sw.swimmer_step(c, *ins), together))


def test_swimmer_kernel_reruns_a_substep_its_fast_path_cannot_take(cuda):
    """An episode at rest with straight joints and torques of 1e-25 (its
    right-hand side, and so the numerators of its substitutions, far below
    the 2^-60 that the kernel's branch-free divisions take) has its substeps
    run again on the compiler's division and sqrtf: its velocities and
    observations within the conditioning bound of the plain step's, relative
    to their largest, t and done exact; its neighbours' outputs are those of
    the batch without it, bit for bit."""
    from dfd_tpu_torch.envs import SwimmerEnv
    from dfd_tpu_torch.ops import swimmer as sw

    c = SwimmerEnv(device=cuda).consts
    g = torch.Generator(cuda).manual_seed(3)
    unif = lambda *shape, lim: (torch.rand(*shape, generator=g, device=cuda) * 2 - 1) * lim
    N = 9
    ins = [unif(N, c.ndof, lim=1.0), unif(N, c.ndof, lim=1.0),
           torch.randint(0, 100, (N,), generator=g, device=cuda), unif(N, c.n_links - 1, lim=1.5)]
    calm = sw.swimmer_step(c, *ins)
    ins = [x.clone() for x in ins]
    ins[0][4, 3:], ins[1][4], ins[3][4] = 0.0, 0.0, ins[3][4] * 1e-25
    got, want = sw.swimmer_step(c, *ins), sw.swimmer_step_plain(c, *ins)
    c64 = c._replace(T=c.T.double(), Aphi=c.Aphi.double(), M0=c.M0.double(), D0=c.D0.double())
    M, D, _ = sw.terms_closed(c64, ins[0][4:5].double(), ins[1][4:5].double())
    tol = 2 * torch.linalg.cond(M + c.dt * D).max().item() * 2.0 ** -24
    assert 0 < want[1][4].abs().max().item() < 2.0 ** -60
    rel = lambda x, y: ((x.double() - y.double()).abs().max() / y.double().abs().max()).item()
    assert rel(got[1][4], want[1][4]) <= tol and rel(got[3][4, 7:], want[3][4, 7:]) <= tol
    assert torch.equal(got[2], want[2]) and torch.equal(got[5], want[5])
    rest = [e for e in range(N) if e != 4]
    assert all(torch.equal(x[rest], y[rest]) for x, y in zip(got, calm))


def test_swimmer_wrapper_refuses_on_the_card_what_the_cpu_refuses(cuda):
    """The CPU test's refusals on CUDA tensors, with no launch; an empty
    batch returns without one."""
    from dfd_tpu_torch.envs import SwimmerEnv
    from dfd_tpu_torch.ops import swimmer as sw

    env = SwimmerEnv(n_links=3, device=cuda)
    state, _ = env.reset(4, torch.zeros(4, 8, device=cuda))
    c, a = env.consts, torch.zeros(4, 2, device=cuda)
    before = sw.swimmer_step.launches
    for args, what in [((state.q.double(), state.qdot, state.t, a), "q must be"),
                       ((state.q, state.qdot, state.t.int(), a), "t must be"),
                       ((state.q, state.qdot, state.t, torch.zeros(4, 3, device=cuda)),
                        "action must be"),
                       ((state.q, state.qdot, state.t, a.cpu()), "must lie on q's device")]:
        with pytest.raises(ValueError, match=what):
            sw.swimmer_step(c, *args)
    with pytest.raises(ValueError, match="n_links must be 1 to 64"):
        sw.swimmer_step(c._replace(n_links=65), state.q, state.qdot, state.t, a)
    out = sw.swimmer_step(c, state.q[:0], state.qdot[:0], state.t[:0], a[:0])
    assert sw.swimmer_step.launches == before and out[3].shape == (0, 8)


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_gaussian_trainer_on_card_matches_cpu(cuda, backend):
    """GaussianMLP on SwimmerEnv at P = 8, T = 25, normalized observations,
    3 epochs on the same draws: swimmer_step_kernel T times an epoch; flat,
    the observation statistics and the mean rewards within 1e-4 of the CPU
    trainer's (the swimmer's float32 conditioning; the CPU tests hold the
    CPU trainer to JAX's at the same tolerance)."""
    from dfd_tpu_torch.config import TrainConfig
    from dfd_tpu_torch.envs import SwimmerEnv
    from dfd_tpu_torch.models import GaussianMLP
    from dfd_tpu_torch.ops import distances
    from dfd_tpu_torch.ops import swimmer as sw
    from dfd_tpu_torch.runners import VectorizedTrainer, make_draws

    cfg = TrainConfig(batch_size=8, learning_rate=0.05, noise_std=0.05, zeta_size=4,
                      max_strategy_history_size=4, episode_length=25, random_seed=5,
                      normalize_obs=True, obs_stats_update_chance=0.2, noise_backend=backend)
    gen = torch.Generator().manual_seed(8)
    draws = {e: make_draws(gen, 8, 25, 4, SwimmerEnv(device="cpu")) for e in range(3)}
    gpu, cpu = (VectorizedTrainer(GaussianMLP(16, 6, device=d), SwimmerEnv(device=d),
                                  distances.gaussian_wasserstein_from_strategies, cfg, device=d,
                                  draw_source=lambda e: draws[e]) for d in (cuda, "cpu"))
    gpu.state = gpu.state._replace(zeta=cpu.state.zeta.to(cuda))
    before = sw.swimmer_step.launches
    gpu.train(3)
    cpu.train(3)
    assert sw.swimmer_step.launches - before == 3 * 25
    torch.testing.assert_close(gpu.state.flat.cpu(), cpu.state.flat, rtol=1e-4, atol=1e-6)
    for a, b in zip(gpu.state.obs_stats, cpu.state.obs_stats):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-4 * max(1.0, b.abs().max().item()))
    for hg, hc in zip(gpu.reporter.history, cpu.reporter.history):
        for k in ("Noisy Reward", "Policy Reward"):
            assert math.isclose(hg[k], hc[k], rel_tol=1e-4, abs_tol=1e-5), (k, hg[k], hc[k])
        assert hg["Cumulative Timesteps"] == hc["Cumulative Timesteps"]


# -- the host classes, the sequential topology and the command line on the card ----------


def test_host_env_swimmer_episode_launches_the_kernel_once_a_step(cuda):
    """A HostEnv episode of the 7-link swimmer on the card (n = 1, a grid of
    one block whose one episode runs on a warp): one swimmer_step_kernel
    launch a step, the resets exact, and each step held to the plain step on
    the CPU under the same wave-gait actions (the episode bounds of
    test_swimmer_kernel_matches_plain: observations 1e-3 of their largest,
    the reward 1e-4)."""
    from dfd_tpu_torch.envs import SwimmerEnv
    from dfd_tpu_torch.ops import swimmer as sw
    from dfd_tpu_torch.runners import HostEnv

    gpu, cpu = (HostEnv(SwimmerEnv(max_steps=40, device=d), seed=9) for d in (cuda, "cpu"))
    for episode in range(2):
        go, co = gpu.reset(), cpu.reset()
        assert (go == co).all()
        before, steps, done = sw.swimmer_step.launches, 0, False
        while not done:
            act = [math.sin(0.4 * steps + 0.8 * j) for j in range(6)]
            (go, gr, done, _), (co, cr, cdone, _) = gpu.step(act), cpu.step(act)
            steps += 1
            assert done == cdone
            assert abs(go - co).max() <= 1e-3 * max(1.0, abs(co).max())
            assert abs(gr - cr) <= 1e-4
        assert steps == 40 and sw.swimmer_step.launches - before == steps


def test_counter_noise_sampler_draws_through_normal_kernel(cuda):
    """CounterNoiseSampler on the card: one normal_kernel launch a sample,
    encodings equal to the CPU's, eps within 4e-6 of the CPU's (the CPU's
    libm against CUDA's log1pf and sqrtf: the port's rule for eps), and a
    decode on the card bit for bit the sample."""
    from dfd_tpu_torch.core.noise import CounterNoise, CounterNoiseSampler
    from dfd_tpu_torch.ops import noise as nz

    gpu = CounterNoiseSampler(CounterNoise(5197, 4, device=cuda), id_offset=7)
    cpu = CounterNoiseSampler(CounterNoise(5197, 4, device="cpu"), id_offset=7)
    for epoch in (0, 3):
        gpu.set_epoch(epoch)
        cpu.set_epoch(epoch)
        before = nz.normal.launches
        (ge, geps), (ce, ceps) = gpu.sample(), cpu.sample()
        assert nz.normal.launches - before == 1
        assert ge == ce and abs(geps - ceps).max() <= 4e-6
        assert (gpu.decode(ge) == geps).all()


def test_sequential_trap_runner_on_card_matches_cpu(cuda):
    """SequentialRunner on the trap env, 2 epochs of 10 with evals at 0.3,
    policy and env on the card against the same run on the CPU: equal
    actions and rewards (numpy sampling on probabilities within float32's
    rounding), flat within rtol 1e-5."""
    from dfd_tpu_torch.runners import SequentialRunner
    from dfd_tpu_torch.utils import factory
    from dfd_tpu_torch.utils.metrics import EpochReporter

    runs = []
    for d in (cuda, "cpu"):
        env, model, dist = factory.get_init_data("SimpleTrapEnv-v0", 123, d)
        actions = []
        step = env.step
        env.step = lambda a, step=step, actions=actions: (actions.append(a), step(a))[1]
        r = SequentialRunner(model, env, dist, batch_size=10, zeta_size=16,
                             max_strategy_history_size=16, random_seed=123, eval_prob=0.3,
                             reporter=EpochReporter(quiet=True))
        r.train(2)
        runs.append((r, actions))
    (g, ga), (c, ca) = runs
    assert ga == ca
    for hg, hc in zip(g.reporter.history, c.reporter.history):
        for k in ("Noisy Reward", "Policy Reward", "Cumulative Timesteps", "Omega"):
            assert hg[k] == hc[k], k
    assert abs(g.learner.flat - c.learner.flat).max() <= 1e-5 * abs(c.learner.flat).max()


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_cli_train_on_card_launches_the_noise_kernels(cuda, backend, capsys):
    """``main(["train", ...])`` on the default device (the card): 3 epochs
    launch normal_kernel once an epoch (jax), or perturb and combine once
    each an epoch (pallas)."""
    from dfd_tpu_torch.__main__ import main
    from dfd_tpu_torch.ops import noise as nz
    from dfd_tpu_torch.ops import perturb as pkk

    counts = lambda: (nz.normal.launches, pkk.perturb.launches, pkk.combine.launches)
    before = counts()
    rc = main(["train", "--env", "SimpleTrapEnv-v0", "--epochs", "3", "--batch-size", "16",
               "--zeta-size", "8", "--history-size", "4", "--quiet", "--noise-backend", backend])
    assert rc == 0 and "'Epoch': 3" in capsys.readouterr().out
    got = tuple(a - b for a, b in zip(counts(), before))
    assert got == ((3, 0, 0) if backend == "jax" else (0, 3, 3)), got


def test_native_trap_pool_builds_at_first_use(cuda, tmp_path, monkeypatch):
    """The port's g++ build of runtime/envpool.cc into a fresh build
    directory, loaded and stepped: 201-step episodes end together."""
    import numpy as np

    from dfd_tpu_torch.envs import native_pool

    monkeypatch.setattr(native_pool, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_pool, "_lib", None)
    monkeypatch.delenv("DFD_ENVPOOL_LIB", raising=False)
    pool = native_pool.NativeTrapPool(4)
    assert native_pool.library_path().exists() and native_pool.library_path().parent == tmp_path
    pool.reset_all()
    for _ in range(201):
        _, _, done = pool.step(np.full(4, 5))
    assert done.all()


def test_host_evaluator_on_card_matches_cpu(cuda):
    """BatchedHostEvaluator with DiscreteMLP over two lanes of native trap
    pools (5 + 3 members), horizon 201, on the card against the CPU on the
    same action draws: rewards, timesteps and encodings equal (the trap
    MLP's actions keep their margin at these seeds), entropies within rtol
    1e-5; one normal_kernel launch an evaluation; one read back a
    lane-step."""
    import numpy as np

    from dfd_tpu_torch.core.noise import CounterNoise
    from dfd_tpu_torch.envs.native_pool import NativeTrapPool
    from dfd_tpu_torch.models import DiscreteMLP
    from dfd_tpu_torch.ops import noise as nz
    from dfd_tpu_torch.runners.host_evaluator import BatchedHostEvaluator

    gen = torch.Generator().manual_seed(0)
    u = torch.rand((202, 8, 9), generator=gen)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    draw = lambda t, first, n: gumbel[t, first:first + n]
    out = []
    for d in (cuda, "cpu"):
        model = DiscreteMLP(2, 9, device=d)
        params, state = model.init(0)
        ev = BatchedHostEvaluator(model, [NativeTrapPool(5), NativeTrapPool(3)],
                                  CounterNoise(model.num_params, random_seed=1, device=d),
                                  sigma=0.05, device=d)
        nz.normal.launches = 0
        rets = ev.evaluate_population(model.get_flat(params), state, epoch=2, horizon=201,
                                      action_noise=draw)
        out.append((rets, nz.normal.launches, ev.readbacks))
    (g, g_launch, g_reads), (c, _, _) = out
    assert g_launch == 1 and g_reads == 2 * 201
    for a, b in zip(g, c):
        assert (a.encoded_noise, a.reward, a.timesteps) == (b.encoded_noise, b.reward, b.timesteps)
        assert np.isclose(a.entropy, b.entropy, rtol=1e-5)


def _recorded(d, obs_dim=2, epochs=3, batch=4, seed=17):
    """Counter-noise batches (rets, timesteps, n_delayed, n_discarded) of
    ``epochs`` epochs: ``batch`` fresh returns and one eval a batch, a stale
    one of epoch 0 in epoch 1."""
    import numpy as np

    from dfd_tpu_torch.fd.returns import FDReturn

    rng = np.random.RandomState(seed)
    out, member = [], 1000
    for e in range(epochs):
        rows = []
        for k in range(batch + 1 + (e == 1)):
            member += 1
            tag = 0 if (e == 1 and k == batch + 1) else e
            rows.append(FDReturn(epoch=tag, encoded_noise=f"{tag},{member}",
                                 reward=float(rng.randn() * 10), novelty=float(rng.rand()),
                                 entropy=float(rng.rand()), timesteps=int(rng.randint(10, 200)),
                                 is_eval=k == batch,
                                 eval_states=rng.rand(3, obs_dim).astype(np.float32)
                                 if k == batch else []))
        out.append((rows, sum(r.timesteps for r in rows), int(e == 1), 0))
    return out


class _Replay:
    """A ServerRunner's worker replaying recorded batches."""

    def __init__(self, batches):
        self.batches = batches

    def collect_returns(self, **_kw):
        return self.batches.pop(0)

    def update(self, state):
        pass

    def start(self, address, port):
        return 0

    def stop(self):
        pass


def test_server_runner_on_card_matches_cpu_on_recorded_batches(cuda):
    """A counter-noise ServerRunner on the card decodes each return with one
    normal_kernel launch and ends on the CPU runner's flat (rtol 1e-5:
    normal_kernel against its plain version, bit for bit, so the host sums
    alone differ) after 3 epochs of the same recorded batches."""
    import copy

    import numpy as np

    from dfd_tpu_torch.ops import noise as nz
    from dfd_tpu_torch.runners.server import ServerRunner
    from dfd_tpu_torch.utils.metrics import EpochReporter

    batches = _recorded(5197)
    runs = []
    for d in (cuda, "cpu"):
        r = ServerRunner(batch_size=4, zeta_size=4, max_strategy_history_size=4, random_seed=5,
                         port=0, noise_kind="counter", reporter=EpochReporter(quiet=True),
                         device=d)
        r.worker = _Replay(copy.deepcopy(batches))
        nz.normal.launches = 0
        r.train(max_epochs=3)
        runs.append((r, nz.normal.launches))
    (g, launches), (c, _) = runs
    decoded = sum(not x.is_eval for rows, *_ in batches for x in rows)
    assert launches == decoded == 13
    assert g.learner.discarded_returns == c.learner.discarded_returns == 0
    np.testing.assert_allclose(g.learner.flat, c.learner.flat, rtol=1e-5, atol=1e-7)


def test_slice_window_on_card_matches_cpu(cuda):
    """One slice window on the trap (8 members, dense and in chunks of 4) on
    the card and on the CPU, on the same draws: encodings, rewards and
    timesteps equal, entropies and the Welford delta within rtol 1e-5;
    normal_kernel once a chunk."""
    import numpy as np

    from dfd_tpu_torch.fd.returns import FDState
    from dfd_tpu_torch.models import DiscreteMLP
    from dfd_tpu_torch.ops import noise as nz
    from dfd_tpu_torch.runners.slice_client import SliceClientRunner, make_window_draws

    cfg = dict(noise_kind="counter", env_id="SimpleTrapEnv-v0", random_seed=7, noise_std=0.05,
               normalize_obs=True, obs_stats_update_chance=0.5, max_strategy_history_size=4,
               noise_seed=123)
    model = DiscreteMLP(2, 9, device="cpu")
    params, bn = model.init(3)
    rng = np.random.RandomState(0)
    state = FDState(policy_params=model.serialize(params, bn).numpy().tolist(),
                    strategy_frames=rng.rand(4, 2).astype(np.float32),
                    strategy_history=rng.rand(2, 4, 9).astype(np.float32),
                    obs_stats=[0.3, 0.4, 0.5, 0.6, 4], epoch=2)
    for chunk, n_launch in ((None, 1), (4, 2)):
        out = []
        for d in (cuda, "cpu"):
            r = SliceClientRunner(n_members=8, population_chunk=chunk, device=d,
                                  draw_source=lambda sub, ids: make_window_draws(
                                      torch.Generator().manual_seed(4), 8, 201, r.env))
            r._configure(cfg)
            r._apply_state(state)
            r.windows = 1
            nz.normal.launches = 0
            out.append((r._collect_window(), nz.normal.launches))
        (g, launches), (c, _) = out
        assert launches == n_launch
        for a, b in zip(g, c):
            assert (a.encoded_noise, a.reward, a.timesteps) == (b.encoded_noise, b.reward,
                                                                b.timesteps)
            assert np.isclose(a.entropy, b.entropy, rtol=1e-5)
            np.testing.assert_allclose(a.obs_stats_update, b.obs_stats_update, rtol=1e-5,
                                       atol=1e-6)


def test_thin_client_on_card_trains_against_card_server(cuda):
    """The port's learner and a thin client, both on the card, as threads
    over localhost: 2 epochs, every counter return decoded, both end."""
    import threading
    import time

    import numpy as np

    from dfd_tpu_torch.runners.client import ClientRunner
    from dfd_tpu_torch.runners.server import ServerRunner
    from dfd_tpu_torch.utils.metrics import EpochReporter

    server = ServerRunner(batch_size=3, zeta_size=4, max_strategy_history_size=4,
                          random_seed=31, port=0, noise_kind="counter",
                          reporter=EpochReporter(quiet=True), device=cuda)
    st = threading.Thread(target=lambda: server.train(max_epochs=2), daemon=True)
    st.start()
    while getattr(server, "bound_port", None) is None:
        time.sleep(0.05)
    client = ClientRunner(port=server.bound_port, collect_window_s=0.001, device=cuda)
    ct = threading.Thread(target=lambda: client.run(max_iterations=100, reconnect_attempts=1),
                          daemon=True)
    ct.start()
    st.join(timeout=120)
    client.request_stop()
    ct.join(timeout=30)
    assert not st.is_alive() and not ct.is_alive()
    assert server.learner.discarded_returns == 0 and len(server.reporter.history) == 2
    assert all(np.isfinite(row["Noisy Reward"]) for row in server.reporter.history)


@pytest.mark.parametrize("P, d, anti, first", [(7, 1023, False, 5), (8, 1025, True, 6),
                                               (1024, 5197, False, 1024),
                                               (64, 1_156_139, False, 64)])
def test_perturb_and_combine_from_a_first_member(cuda, P, d, anti, first):
    """A rank's shard: the kernels from member ``first`` against the plain
    versions from there, and against the whole population's rows."""
    flat = torch.randn(d, device=cuda)
    got = pk.perturb(flat, 0.05, 9, 4, P, antithetic=anti, first=first)
    want = pk.perturb_plain(flat, 0.05, 9, 4, P, antithetic=anti, first=first)
    whole = pk.perturb(flat, 0.05, 9, 4, first + P, antithetic=anti)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 0.05 * 1e-5
    assert torch.equal(got, whole[first:])
    coefs = torch.randn(P, device=cuda)
    g = pk.combine(coefs, 9, 4, d, antithetic=anti, first=first)
    gw = pk.combine_plain(coefs, 9, 4, d, antithetic=anti, first=first)
    assert ((g - gw).norm() / gw.norm()).item() <= 1e-5


def test_atari_pipeline_through_host_policy_on_card_matches_cpu(cuda):
    """The deepmind-style pipeline's (84, 84, 4) channels-last frames
    through ``HostPolicy`` with ``AtariCNN((84, 84), 6)`` on the card and on
    the CPU: probabilities within rtol 1e-5, the same greedy actions, and
    the strategy over a zeta of such frames."""
    import numpy as np

    from dfd_tpu_torch.envs.atari_wrappers import wrap_deepmind_style
    from dfd_tpu_torch.models import AtariCNN
    from dfd_tpu_torch.runners import HostPolicy

    class Synthetic:
        def __init__(self):
            self.rng, self.lives = np.random.default_rng(0), 3

        def get_action_meanings(self):
            return ["NOOP", "FIRE", "UP", "DOWN", "LEFT", "RIGHT"]

        def reset(self):
            return self.rng.integers(0, 256, (210, 160, 3), dtype=np.uint8)

        def step(self, a):
            return self.reset(), 1.0, False, {"lives": self.lives}

    env = wrap_deepmind_style(Synthetic(), seed=0)
    frames = [env.reset()] + [env.step(a)[0] for a in (1, 2, 3, 4, 5)]
    policies = [HostPolicy(AtariCNN((84, 84), 6, device=d), seed=3) for d in (cuda, "cpu")]
    for f in frames:
        g, c = (p.forward(f)[0, 0].cpu().numpy() for p in policies)
        np.testing.assert_allclose(g, c, rtol=1e-5, atol=1e-7)
        assert policies[0].get_action(f, True) == policies[1].get_action(f, True)
    zeta = np.stack(frames)
    np.testing.assert_allclose(policies[0].get_strategy(zeta), policies[1].get_strategy(zeta),
                               rtol=1e-5, atol=1e-7)


def test_mesh_of_one_over_nccl_equals_no_mesh(cuda):
    """A one-rank NCCL group on the card: the trainer on its mesh equals the
    trainer without one, bit for bit (every collective a one-rank sum)."""
    import socket

    import torch.distributed as dist

    from dfd_tpu_torch.config import TrainConfig
    from dfd_tpu_torch.envs import TrapEnv
    from dfd_tpu_torch.models import DiscreteMLP
    from dfd_tpu_torch.ops import distances
    from dfd_tpu_torch.parallel import make_pop_mesh
    from dfd_tpu_torch.runners import VectorizedTrainer

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        mesh = make_pop_mesh()
        assert (mesh.size, mesh.group is not None) == (1, True)
        cfg = TrainConfig(batch_size=64, learning_rate=0.05, noise_std=0.05, zeta_size=8,
                          max_strategy_history_size=4, random_seed=7, normalize_obs=True,
                          obs_stats_update_chance=0.1)
        runs = []
        for m in (None, mesh):
            tr = VectorizedTrainer(DiscreteMLP(2, 9), TrapEnv(), distances.categorical_tvd, cfg,
                                   mesh=m)
            tr.train(3)
            runs.append(tr)
        assert torch.equal(runs[0].state.flat, runs[1].state.flat)
    finally:
        dist.destroy_process_group()


# -- every shape the JAX package runs ----------------------------------------------------

# (M, B, ci, co, H, W, bf16) that no cluster plan takes: the 128-pixel f32 flagship's three,
# 192-pixel frames' bf16 res stages (M = 2 and 16), a bf16 feature pool at 192 x 192, more
# than 256 f32 channels, three bf16 groups of 64 (the image's fourth zero), and ragged ones
# (odd H and W, C not a multiple of 4 or 8, tiles that do not divide the frame, a partial
# second group of output channels, W % 4 != 0: the operand by cp.async, the smallest bf16
# feature pool no band fits)
TILED_RES_SHAPES = [(16, 1, 64, 64, 64, 64, False), (16, 1, 128, 128, 32, 32, False),
                    (2, 1, 64, 64, 96, 96, True), (2, 1, 128, 128, 48, 48, True),
                    (16, 1, 64, 64, 96, 96, True), (16, 1, 128, 128, 48, 48, True),
                    (2, 1, 264, 264, 16, 16, False), (1, 1, 160, 160, 24, 24, True),
                    (2, 2, 6, 6, 200, 150, False), (2, 2, 6, 6, 200, 150, True),
                    (2, 1, 5, 5, 37, 601, True), (2, 1, 13, 13, 45, 300, True),
                    (2, 1, 16, 16, 8, 2000, True),
                    (1, 1, 16, 16, 128, 128, False)]
TILED_FEAT_SHAPES = [(16, 1, 64, 128, 64, 64, False), (2, 1, 64, 128, 192, 192, True),
                     (2, 1, 16, 300, 16, 16, False), (2, 2, 6, 20, 61, 1001, False),
                     (2, 2, 6, 20, 61, 1001, True), (2, 1, 13, 70, 15, 333, True),
                     (2, 1, 1, 1, 2, 536, True), (1, 1, 512, 64, 16, 512, True)]


@pytest.mark.parametrize("kind, shape", [("res", s) for s in TILED_RES_SHAPES]
                         + [("feat", s) for s in TILED_FEAT_SHAPES])
def test_tiled_forms_match_plain(cuda, kind, shape):
    """Shapes whose plan is the tiled form's: one launch of it a call
    (counted in ``tiled_launches`` or ``tiled_mma_launches``), within the
    fused kernels' limits of their plain versions."""
    M, B, ci, co, H, W, bf16 = shape
    kernel = fr.fused_res_stage if kind == "res" else fr.fused_feat_pool
    plan = ((fr.res_stage_mma_plan if bf16 else fr.res_stage_tf32_plan)(ci, H, W) if kind == "res"
            else (fr.feat_pool_mma_plan if bf16 else fr.feat_pool_tf32_plan)(ci, co, H, W))
    assert isinstance(plan, fr.TiledPlan)
    attr = "tiled_mma_launches" if bf16 else "tiled_launches"
    before = getattr(kernel, attr)
    _check_fused(kind, shape, cuda)
    assert getattr(kernel, attr) == before + 1


def test_tiled_weight_image_is_kept_until_the_weights_change(cuda):
    """The f32 tiled forms split a weight tensor into its image once and
    keep it while the same tensor comes back unmodified: a second call
    splits nothing and gives the same output; after an in-place change of
    the weights the next call splits them again and matches the plain
    version; another tensor with the same values gets its own image."""
    shape = (2, 1, 16, 16, 128, 128)  # a frame no cluster holds: the tiled form
    M, B, ci, co, H, W = shape
    x, w, b, s, t = _fused_args("res", M, B, ci, co, H, W, cuda)
    assert isinstance(fr.res_stage_tf32_plan(ci, H, W), fr.TiledPlan)
    first = fr.fused_res_stage(x, w, b, s, t)
    key = next(k for k, v in fr._IMAGES.items() if v[0] is w)
    image = fr._IMAGES[key][2].clone()
    torch.testing.assert_close(fr.fused_res_stage(x, w, b, s, t), first, rtol=0, atol=0)
    assert torch.equal(fr._IMAGES[key][2], image)
    w.mul_(0.5)
    got = fr.fused_res_stage(x, w, b, s, t)
    want = fr.fused_res_stage_plain(x, w, b, s, t)
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())
    assert not torch.equal(fr._IMAGES[key][2], image)
    other = w.clone()
    torch.testing.assert_close(fr.fused_res_stage(x, other, b, s, t), got, rtol=0, atol=0)
    assert any(v[0] is other for v in fr._IMAGES.values())


def test_tiled_mma_weight_image_is_kept_until_the_weights_change(cuda):
    """The bf16 tiled forms round a weight tensor into its image once
    (``round_weights_kernel``, the plain version's bits) and keep it while
    the same tensor comes back unmodified: a second call rounds nothing and
    gives the same output; after an in-place change of the weights the next
    call rounds them again and matches the plain version; another tensor
    with the same values gets its own image; the feature pool likewise."""
    for kind, shape in (("res", (2, 1, 64, 64, 96, 96)), ("feat", (2, 1, 8, 16, 2, 536))):
        M, B, ci, co, H, W = shape
        fn, plain = ((fr.fused_res_stage, fr.fused_res_stage_plain) if kind == "res"
                     else (fr.fused_feat_pool, fr.fused_feat_pool_plain))
        x, w, b, s, t = _fused_args(kind, M, B, ci, co, H, W, cuda)
        plan = (fr.res_stage_mma_plan(ci, H, W) if kind == "res"
                else fr.feat_pool_mma_plan(ci, co, H, W))
        assert isinstance(plan, fr.TiledPlan)
        bf16 = torch.bfloat16
        first = fn(x, w, b, s, t, compute_dtype=bf16)
        key = next(k for k, v in fr._IMAGES.items() if v[0] is w)
        assert key[2] == "mma"
        image = fr._IMAGES[key][2].clone()
        want_image = fr.mma_weight_image_plain(w, ci).reshape(-1)
        assert torch.equal(image.view(torch.bfloat16), want_image)
        torch.testing.assert_close(fn(x, w, b, s, t, compute_dtype=bf16), first, rtol=0, atol=0)
        assert torch.equal(fr._IMAGES[key][2], image)
        w.mul_(0.5)
        got = fn(x, w, b, s, t, compute_dtype=bf16)
        want = plain(x, w, b, s, t, bf16)
        tol = 4e-3 if kind == "res" else 1e-5
        assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
        assert not torch.equal(fr._IMAGES[key][2], image)
        other = w.clone()
        torch.testing.assert_close(fn(x, other, b, s, t, compute_dtype=bf16), got, rtol=0,
                                   atol=0)
        assert any(v[0] is other for v in fr._IMAGES.values())


@pytest.mark.parametrize("n_links", [1, 2, 4, 6, 8, 11, 12, 15, 18, 19, 30, 31, 32, 33, 63, 64])
@pytest.mark.parametrize("N", [1, 7, 513])
def test_swimmer_forms_match_plain(cuda, n_links, N):
    """Every link count: the template form up to ``FORM_LINKS``, the run-time
    form past it, one launch of the one its count selects; one step from
    states near the reset's (angles and rates in [-0.1, 0.1]) within twice
    float32's conditioning bound, t and done exact."""
    from dfd_tpu_torch.envs import SwimmerEnv
    from dfd_tpu_torch.ops import swimmer as sw

    c = SwimmerEnv(n_links=n_links, device=cuda).consts
    g = torch.Generator(cuda).manual_seed(n_links)
    unif = lambda *shape, lim: (torch.rand(*shape, generator=g, device=cuda) * 2 - 1) * lim
    q, qd, a = unif(N, c.ndof, lim=0.1), unif(N, c.ndof, lim=0.1), unif(N, n_links - 1, lim=1.5)
    t = torch.randint(0, 100, (N,), generator=g, device=cuda)
    c64 = c._replace(T=c.T.double(), Aphi=c.Aphi.double(), M0=c.M0.double(), D0=c.D0.double())
    M, D, _ = sw.terms_closed(c64, q.double(), qd.double())
    tol = 2 * torch.linalg.cond(M + c.dt * D).max().item() * 2.0 ** -24
    before = (sw.swimmer_step.launches, sw.swimmer_step.dyn_launches)
    got, want = sw.swimmer_step(c, q, qd, t, a), sw.swimmer_step_plain(c, q, qd, t, a)
    dyn = n_links > sw.FORM_LINKS
    assert (sw.swimmer_step.launches - before[0],
            sw.swimmer_step.dyn_launches - before[1]) == ((0, 1) if dyn else (1, 0))
    for k in (0, 1, 3, 4):
        assert _rel(got[k], want[k]) <= tol, k
    assert torch.equal(got[2], want[2]) and torch.equal(got[5], want[5])


@pytest.mark.parametrize("n_links", [12, 15, 18, 19, 30, 31, 33, 63, 64])
def test_swimmer_runtime_form_episode_ignores_its_neighbours(cuda, n_links):
    """The run-time form (four episodes a block, the last of 9 episodes'
    three blocks partly filled): each episode stepped alone gives its
    outputs among the 9, bit for bit, and 20 more launches give the first
    one's."""
    from dfd_tpu_torch.envs import SwimmerEnv
    from dfd_tpu_torch.ops import swimmer as sw

    c = SwimmerEnv(n_links=n_links, device=cuda).consts
    g = torch.Generator(cuda).manual_seed(200 + n_links)
    unif = lambda *shape, lim: (torch.rand(*shape, generator=g, device=cuda) * 2 - 1) * lim
    N = 9
    ins = (unif(N, c.ndof, lim=0.1), unif(N, c.ndof, lim=0.1),
           torch.randint(0, 100, (N,), generator=g, device=cuda), unif(N, n_links - 1, lim=1.5))
    together = sw.swimmer_step(c, *ins)
    alone = [sw.swimmer_step(c, *(x[e:e + 1].contiguous() for x in ins)) for e in range(N)]
    for k, out in enumerate(together):
        assert torch.equal(torch.cat([a[k] for a in alone]), out), k
    for _ in range(20):
        assert all(torch.equal(x, y) for x, y in zip(sw.swimmer_step(c, *ins), together))


@pytest.mark.parametrize("anti", [False, True])
def test_normal_kernel_past_65535_draws_is_exact(cuda, anti):
    """65,537 draws (131,074 rows when antithetic) in one launch, past the
    65,535 of blockIdx.y: bit for bit its plain version."""
    from dfd_tpu_torch.ops import noise as nz

    rows = 131_074 if anti else 65_537
    keys = _normal_keys(rows, anti, False, cuda)
    assert keys.shape[0] == 65_537
    before = nz.normal.launches
    eps, _ = nz.normal(keys, rows, 64, antithetic=anti)
    assert nz.normal.launches == before + 1
    assert torch.equal(eps, nz.normal_plain(keys, rows, 64, anti))


@pytest.mark.parametrize("n_links", [15, 64])
def test_swimmer_runtime_form_reruns_a_substep_its_fast_path_cannot_take(cuda, n_links):
    """The run-time form's ``Range`` check and ``Exact`` rerun, as
    ``test_swimmer_kernel_reruns_a_substep_its_fast_path_cannot_take`` holds
    the template forms': an episode at rest with straight joints and torques
    of 1e-25 among 9 near the reset's; its velocities and observations within
    the conditioning bound of the plain step's, t and done exact, its
    neighbours' outputs those of the batch without it, bit for bit."""
    from dfd_tpu_torch.envs import SwimmerEnv
    from dfd_tpu_torch.ops import swimmer as sw

    c = SwimmerEnv(n_links=n_links, device=cuda).consts
    g = torch.Generator(cuda).manual_seed(300 + n_links)
    unif = lambda *shape, lim: (torch.rand(*shape, generator=g, device=cuda) * 2 - 1) * lim
    N = 9
    ins = [unif(N, c.ndof, lim=0.1), unif(N, c.ndof, lim=0.1),
           torch.randint(0, 100, (N,), generator=g, device=cuda), unif(N, n_links - 1, lim=1.5)]
    before = sw.swimmer_step.dyn_launches
    calm = sw.swimmer_step(c, *ins)
    assert sw.swimmer_step.dyn_launches == before + 1
    ins = [x.clone() for x in ins]
    ins[0][4, 3:], ins[1][4], ins[3][4] = 0.0, 0.0, ins[3][4] * 1e-25
    got, want = sw.swimmer_step(c, *ins), sw.swimmer_step_plain(c, *ins)
    c64 = c._replace(T=c.T.double(), Aphi=c.Aphi.double(), M0=c.M0.double(), D0=c.D0.double())
    M, D, _ = sw.terms_closed(c64, ins[0][4:5].double(), ins[1][4:5].double())
    tol = 2 * torch.linalg.cond(M + c.dt * D).max().item() * 2.0 ** -24
    assert 0 < want[1][4].abs().max().item() < 2.0 ** -60
    rel = lambda x, y: ((x.double() - y.double()).abs().max() / y.double().abs().max()).item()
    v0 = c.ndof - 2  # where the velocities start in the observation
    assert rel(got[1][4], want[1][4]) <= tol and rel(got[3][4, v0:], want[3][4, v0:]) <= tol
    assert torch.equal(got[2], want[2]) and torch.equal(got[5], want[5])
    rest = [e for e in range(N) if e != 4]
    assert all(torch.equal(x[rest], y[rest]) for x, y in zip(got, calm))
