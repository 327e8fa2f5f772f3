// Chains of dependent float32 matrix products in one launch, on Hopper's tensor cores (sm_90a)
// with f32-accurate products (3xTF32), with a plain C interface loaded through ctypes
// (dfd_tpu_torch/ops/gemm_chain.py).
//
// Replaces the Pallas TPU probe kernels tools/probe_pallas_gemm.py::gemm_chain (k_acc, k_feed),
// tools/probe_pallas_torso.py::gemm_chain (k) and the Sel-GEMM k_sel of
// tools/probe_pallas_pool.py: `iters` products of A [M, K] by B [K, N] inside one kernel, so
// that a probe sees the cost of a product in a chain without a launch around each.
//
//   mode 0 (acc):        out = sum over iterations of A B, summed in iteration order;
//   mode 1 (acc_scaled): out = sum over iterations of (A B) * inv, inv = 1 / iters as f32;
//   mode 2 (feed):       y_0 = 0, y_{i+1} = (A * (1 + y_i[0, 0] * 1e-20)) B, out = y_iters.
//
// Products in f32 accuracy on TF32 tensor cores, as fused_resblock_tf32.cu takes them: each
// operand a is split as a = hi + lo, hi = tf32(a), lo = tf32(a - hi) (cvt.rna.tf32.f32), and
// a * b is lo_a * hi_b + hi_a * lo_b + hi_a * hi_b, three mma.sync.m16n8k8 TF32 products, lo * lo
// dropped: about 22 of f32's 24 bits a product.  The tensor cores do not round the sum they
// carry from one mma.sync to the next to nearest, so each of the three products of a k8 step
// goes into a fresh sum of its own; the two small ones are added, then the large one, then the
// step's sum to the f32 total, each by __fadd_rn.
//
// What bounds it on an H100: the products, 2 M K N iters FLOPs at 495 / 3 = 165 TFLOP/s as
// 3xTF32 (67 on the CUDA cores), against (MK + KN + MN) * 4 bytes read or written once.  On
// this card mma.sync.m16n8k8 TF32 takes about 33 cycles and issues at most one every 8.5
// cycles a warp (313 TFLOP/s of TF32 over the card, 104 as 3xTF32: tools/
// torch_gemm_chain_sweep.py), and the probes' chains are narrow: a 1024 x 16 output is 128
// tiles of 16 x 8, one warp each.  So the design spends warps on latency before throughput:
//
// 1. Panels resident for the whole chain.  A block owns a tile of bm x bn outputs and keeps its
//    A panel [bm, ks] and B panel [ks, bn] in shared memory, split once when they are staged
//    into hi and lo TF32 planes in fragment order (a_slot, b_slot): an iteration reads only
//    shared memory, a lane's fragment of a step in one 16-byte load a plane, 512 contiguous
//    bytes a warp.  Staging keeps 8 global loads a thread in flight.
// 2. K split across the block's warps.  wk warps share each m16 x n8 tile set, each a
//    contiguous slice of the block's k8 steps; the slices' partials meet in shared memory and
//    the warps of slice 0 add them in slice order.  A 16 x 8 tile over K = 144 is then 8 warps
//    of 2-3 steps, not one warp of 18.
// 3. K split across a cluster.  Where the panels do not fit a block (the 512 x 1024 x 512 case,
//    the Sel-GEMM's K = 4096), a cluster of 2, 4 or 8 blocks shares a tile, each block a slice of
//    K.  Each iteration every block writes its partial product to shared memory,
//    cluster.sync(), and block r sums rows r * bm / cluster .. of all the partials through
//    distributed shared memory in rank order (loads first, then the sums), then updates its rows
//    of the chain's sum.  The partials have two buffers, so one cluster.sync() an iteration
//    suffices.
// 4. Tiles by a plan.  gemm_chain_plan (gemm_chain.py) and plan_gemm here choose the block's
//    warps (wm x wn x wk), each warp's m16 x n8 tiles (MT x NT) and the cluster by a model of
//    the cycles an iteration takes, fitted to every plan timed at the probes' shapes on an H100
//    (PERF.md).  The entry point refuses a plan that differs from its own.
// 5. The ordered route.  Where the chain's own f32 sum cannot resolve products rounded
//    otherwise than PyTorch's (gemm_chain.py::ordered_route: the 1024-product chain), each
//    product is fmaf over k in order from 0 on the CUDA cores, as cuBLAS takes these narrow
//    shapes; its panels are f32 (A [bm][ks + 4], B transposed), one m16 x n8 tile a warp.
//
// Each iteration computes its products anew: a barrier (__syncthreads or cluster.sync) begins
// it, which the compiler does not move shared loads across, so the loop-invariant product of
// mode acc is not hoisted out of the loop.  In mode feed the dependency is grid-wide: y_i[0, 0]
// lives in the block that owns tile (0, 0) (rank 0 of its cluster, after the reduction), so the
// kernel is launched cooperatively and every iteration starts with cooperative_groups' grid
// sync; the value travels through a two-slot carry in device memory (iteration i writes slot
// i % 2, iteration i + 1 reads it, and the next write to that slot comes after another grid
// sync).  1 + y * 1e-20 rounds to 1 in f32 for |y| < 6e12, so the staged split of A holds at
// every shape the probes use; where the scale is not 1 the block stages A * scale anew (split
// again) before its products.
//
// Arithmetic: the products' sums as above, the K slices' and the cluster's partials and the
// iteration sum by __fadd_rn in a fixed order, the scale and 1 + y * 1e-20 by __fmul_rn /
// __fadd_rn (never contracted).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxSmem = 232448;  // an H100 block's shared memory, bytes
constexpr int kNumSms = 132;

// A launch plan; gemm_chain.py::GemmChainPlan holds the same fields.
struct Plan {
  int wm, wn, wk, mt, nt, cluster, ks, blocks, smem;
  long cost;
};

// (warps along M, warps along N, MT, NT), as gemm_chain.py::WARP_TILES.
constexpr int kWarpTiles[][4] = {{2, 2, 2, 4}, {2, 2, 2, 2}, {1, 1, 1, 4}, {1, 1, 1, 2},
                                 {1, 1, 1, 1}};

long cdiv(long a, long b) { return (a + b - 1) / b; }
long lmin(long a, long b) { return a < b ? a : b; }
long lmax(long a, long b) { return a > b ? a : b; }

long plan_smem(int bm, int bn, int ks, int wk, int cluster) {
  const long red = (long)(wk - 1 + (cluster > 1 ? 2 : 0)) * 4 * bm * (bn + 8);
  return 8L * ((long)bm * ks + (long)ks * bn) + red;
}

// The modelled cycles of one iteration, gemm_chain.py::_plan_cost's; -1 where a block does not
// fit an SM or, resident, the blocks do not fit the card at once.
long plan_cost(int M, int N, int wm, int wn, int wk, int mt, int nt, int cluster, int ks,
               long smem, bool resident) {
  const long warps = wm * wn * wk;
  const long per_sm = lmin(lmin(kMaxSmem / lmax(smem, 1), 2048 / (64 + 16 * mt * nt) / warps),
                           lmin(64 / warps, 32));
  if (per_sm == 0) return -1;
  const long blocks = cdiv(M, 16 * wm * mt) * cdiv(N, 8 * wn * nt) * cluster;
  const long waves = cdiv(blocks, kNumSms * per_sm);
  if (resident && waves > 1) return -1;
  const long w_sm = warps * lmin(per_sm, cdiv(blocks, kNumSms));
  const long steps = cdiv(ks / 8, wk);
  const long latency = steps * (40 + 40 * mt * nt);
  const long through = 3 * w_sm * steps * mt * nt;
  const long fixed = 100 + (wk > 1 ? 200 + 20 * (wk - 1) * mt * nt : 0) + (cluster > 1 ? 800 : 0);
  return waves * (lmax(latency, through) + fixed);
}

// The plan of gemm_chain.py::gemm_chain_plan, in the same integer arithmetic; the ordered
// route takes one m16 x n8 tile a block, no K split and no cluster; a resident plan (feed's)
// puts every block on the card at once.
bool plan_gemm(int M, int K, int N, bool ordered, bool resident, Plan* best) {
  bool found = false;
  for (int cluster = 1; cluster <= (ordered ? 1 : 8); cluster *= 2) {
    const int ks = (int)((cdiv(K, cluster) + 7) / 8 * 8);
    for (const auto& t : kWarpTiles) {
      const int wm = t[0], wn = t[1], mt = t[2], nt = t[3];
      if (ordered && wm * wn * mt * nt != 1) continue;
      for (int wk = 1; wk <= (ordered ? 1 : 8) && wm * wn * wk <= 8; wk *= 2) {
        if (wk > 1 && wk > ks / 8) break;
        const long smem = plan_smem(16 * wm * mt, 8 * wn * nt, ks, wk, cluster);
        const long cost = plan_cost(M, N, wm, wn, wk, mt, nt, cluster, ks, smem, resident);
        if (cost < 0 || smem > kMaxSmem) continue;
        if (!found || cost < best->cost) {
          const long blocks = cdiv(M, 16 * wm * mt) * cdiv(N, 8 * wn * nt) * cluster;
          *best = Plan{wm, wn, wk, mt, nt, cluster, ks, (int)blocks, (int)smem, cost};
          found = true;
        }
      }
    }
  }
  return found;
}

// The panels in fragment order.  A [bm, ks] as hi and lo planes of [bm / 16][ks / 8][32][4]: the
// four values lane l holds of an m16 x k8 fragment (rows g, g + 8, columns tig, tig + 4, with
// g = l / 4, tig = l % 4) side by side, one 16-byte load a plane.  B [ks, bn] as
// [bn / 8][ks / 8][32][4]: lane l's two hi values of a k8 x n8 fragment (rows tig, tig + 4,
// column g), then its two lo values.  A warp's loads are 512 contiguous bytes: no bank
// conflicts.
__device__ __forceinline__ int a_slot(int r, int k, int ksteps) {
  const int lane = (r & 7) * 4 + (k & 3), e = ((r >> 3) & 1) + 2 * ((k >> 2) & 1);
  return (((r >> 4) * ksteps + (k >> 3)) * 32 + lane) * 4 + e;
}

__device__ __forceinline__ int b_slot(int k, int c, int ksteps) {
  const int lane = (c & 7) * 4 + (k & 3);
  return (((c >> 3) * ksteps + (k >> 3)) * 32 + lane) * 4 + ((k >> 2) & 1);
}

constexpr int kStageBatch = 8;  // global loads a thread keeps in flight while staging

// Rows row0 .. row0 + bm - 1 and K columns k0 .. k0 + ks - 1 of A (times scale) into the block's
// panel, zeros past M and past the block's kn columns: split into the hi and lo planes in
// fragment order, or (ordered) as f32 [bm][ks].
template <bool kOrdered>
__device__ void stage_a(uint32_t* as, const float* __restrict__ a, int row0, int k0, int kn,
                        int M, int K, int bm, int ks, float scale) {
  const int n = bm * ks, step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += step * kStageBatch) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * step, r = i / ks, k = i - r * ks;
      v[u] = (i < n && row0 + r < M && k < kn) ? a[(size_t)(row0 + r) * K + k0 + k] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * step, r = i / ks, k = i - r * ks;
      if (i >= n) break;
      const float x = scale != 1.0f ? __fmul_rn(v[u], scale) : v[u];
      if (kOrdered) {
        as[r * (ks + 4) + k] = __float_as_uint(x);  // rows 4 mod 8 words apart: no conflicts
      } else {
        const uint2 h = split(x);
        const int j = a_slot(r, k, ks >> 3);
        as[j] = h.x;
        as[n + j] = h.y;
      }
    }
  }
}

// K rows k0 .. k0 + ks - 1 and columns col0 .. col0 + bn - 1 of B into the block's panel,
// zeros past N and past the block's kn rows: split, in fragment order, or (ordered) as f32
// [ks][bn].
template <bool kOrdered>
__device__ void stage_b(uint32_t* bs, const float* __restrict__ b, int col0, int k0, int kn,
                        int N, int bn, int ks) {
  const int n = ks * bn, step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += step * kStageBatch) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * step, k = i / bn, c = i - k * bn;
      v[u] = (i < n && k < kn && col0 + c < N) ? b[(size_t)(k0 + k) * N + col0 + c] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * step, k = i / bn, c = i - k * bn;
      if (i >= n) break;
      if (kOrdered) {
        bs[c * (ks + 4) + k] = __float_as_uint(v[u]);  // transposed: K contiguous a column
      } else {
        const uint2 h = split(v[u]);
        const int j = b_slot(k, c, ks >> 3);
        bs[j] = h.x;
        bs[j + 2] = h.y;
      }
    }
  }
}

// The product of the warp's MT x NT tiles over k8 steps s_begin .. s_end - 1 of the block's
// panels into y.  ah, al: the hi and lo planes of the warp's first m16 tile, at this lane; bf:
// B's panel at the warp's first n8 tile and this lane; ksteps: the panels' k8 steps.  Each of
// the three products of a tile pair and step (lo hi, hi lo, hi hi) goes into a fresh sum of its
// own on the tensor cores, so no mma.sync waits on another; the two small ones are added first,
// then the large one, then the step's sum to y, each by __fadd_rn and the steps in k order.  KU
// steps are loaded together, so that their loads and products overlap.
template <int MT, int NT>
__device__ __forceinline__ void product(float (&y)[MT][NT][4], const uint4* ah, const uint4* al,
                                        const uint4* bf, int ksteps, int s_begin, int s_end) {
  constexpr int KU = MT * NT >= 4 ? 1 : 4 / (MT * NT);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[m][n][e] = 0.0f;
  for (int s0 = s_begin; s0 < s_end; s0 += KU) {
    uint32_t ahi[KU][MT][4], alo[KU][MT][4], bfr[KU][NT][4];  // bfr: hi0, hi1, lo0, lo1
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const bool live = s0 + u < s_end;  // past the warp's steps: zero fragments, a zero sum
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const uint4 h = live ? ah[(m * ksteps + s0 + u) * 32] : make_uint4(0, 0, 0, 0);
        const uint4 l = live ? al[(m * ksteps + s0 + u) * 32] : make_uint4(0, 0, 0, 0);
        ahi[u][m][0] = h.x, ahi[u][m][1] = h.y, ahi[u][m][2] = h.z, ahi[u][m][3] = h.w;
        alo[u][m][0] = l.x, alo[u][m][1] = l.y, alo[u][m][2] = l.z, alo[u][m][3] = l.w;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint4 v = live ? bf[(n * ksteps + s0 + u) * 32] : make_uint4(0, 0, 0, 0);
        bfr[u][n][0] = v.x, bfr[u][n][1] = v.y, bfr[u][n][2] = v.z, bfr[u][n][3] = v.w;
      }
    }
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      if (s0 + u >= s_end) break;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float lh[4] = {0.f, 0.f, 0.f, 0.f}, hl[4] = {0.f, 0.f, 0.f, 0.f};
          float hh[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(lh, alo[u][m], &bfr[u][n][0]);
          mma_tf32(hl, ahi[u][m], &bfr[u][n][2]);
          mma_tf32(hh, ahi[u][m], &bfr[u][n][0]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[m][n][e] = __fadd_rn(y[m][n][e], __fadd_rn(__fadd_rn(lh[e], hl[e]), hh[e]));
        }
    }
  }
}

// The ordered route's product (one m16 x n8 tile a warp; the panels f32, A [bm][ks + 4] and B
// transposed, [bn][ks + 4]): each of the lane's four outputs (rows g, g + 8; columns 2 tig,
// 2 tig + 1) as fmaf over k in order from 0, on the CUDA cores.  Operands come 4 columns of K
// a load, the next 8 columns' loaded while the current 8 are multiplied.
__device__ __forceinline__ void product_ordered(float (&y)[1][1][4], const float* as,
                                                const float* bs, int ks, int row, int col) {
  const float4* r[4] = {reinterpret_cast<const float4*>(as + row * (ks + 4)),
                        reinterpret_cast<const float4*>(as + (row + 8) * (ks + 4)),
                        reinterpret_cast<const float4*>(bs + col * (ks + 4)),
                        reinterpret_cast<const float4*>(bs + (col + 1) * (ks + 4))};
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float4 cur[4][2], nxt[4][2];
  if (ks > 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) cur[i][0] = r[i][0], cur[i][1] = r[i][1];
  for (int k0 = 0; k0 < ks; k0 += 8) {  // ks is a multiple of 8
    if (k0 + 8 < ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) nxt[i][0] = r[i][k0 / 4 + 2], nxt[i][1] = r[i][k0 / 4 + 3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x0[4] = {cur[0][h].x, cur[0][h].y, cur[0][h].z, cur[0][h].w};
      const float x1[4] = {cur[1][h].x, cur[1][h].y, cur[1][h].z, cur[1][h].w};
      const float w0[4] = {cur[2][h].x, cur[2][h].y, cur[2][h].z, cur[2][h].w};
      const float w1[4] = {cur[3][h].x, cur[3][h].y, cur[3][h].z, cur[3][h].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[0] = fmaf(x0[j], w0[j], s[0]);
        s[1] = fmaf(x0[j], w1[j], s[1]);
        s[2] = fmaf(x1[j], w0[j], s[2]);
        s[3] = fmaf(x1[j], w1[j], s[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) cur[i][0] = nxt[i][0], cur[i][1] = nxt[i][1];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) y[0][0][e] = s[e];
}

template <int kMode>
__device__ __forceinline__ float chain_step(float acc, float y, float inv) {
  if (kMode == 0) return __fadd_rn(acc, y);
  if (kMode == 1) return __fadd_rn(acc, __fmul_rn(y, inv));
  return y;
}

// blockIdx.x = tile * cluster + rank; tile = tile_m * tiles_n + tile_n.  A block of
// 32 * wm * wn * wk threads; warp w takes rows (w % (wm * wn)) / wn * 16 MT and columns
// (w % wn) * 8 NT of the block's tile, and the k8 steps of its K slice w / (wm * wn) (of wk).
// Rank r of a cluster keeps K columns r * ks .. r * ks + ks - 1.
template <int MT, int NT, int kMode, bool kOrdered>
__global__ void __launch_bounds__(256, 1)
gemm_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, float* carry, int M, int K, int N, int iters,
                  float inv, int wn, int wk, int tiles_n, int ks) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int nthreads = blockDim.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wmn = (nthreads >> 5) / wk, wm = wmn / wn, kw = warp / wmn, wt = warp % wmn;
  const int bm = wm * 16 * MT, bn = wn * 8 * NT;
  const int tile = blockIdx.x / cl, row0 = tile / tiles_n * bm, col0 = tile % tiles_n * bn;
  const int k0 = rank * ks, kn = max(0, min(ks, K - k0));
  const int rs = bn + 8, ksteps = ks >> 3;
  uint32_t* const as = reinterpret_cast<uint32_t*>(smem);  // A panel: hi and lo planes of bm * ks
  uint32_t* const bs = as + 2 * bm * ks;                    // B panel: 2 * ks * bn
  float* const part = reinterpret_cast<float*>(bs + 2 * ks * bn);  // [wk - 1][bm][rs]
  float* const red = part + (size_t)(wk - 1) * bm * rs;            // [2][bm][rs], cl > 1

  float scale = 1.0f;  // the scale A is staged with (feed)
  stage_a<kOrdered>(as, a, row0, k0, kn, M, K, bm, ks, scale);
  stage_b<kOrdered>(bs, b, col0, k0, kn, N, bn, ks);

  const int g = lane >> 2, tig = lane & 3;
  const int wr = wt / wn * 16 * MT, wc = wt % wn * 8 * NT;  // the warp's first row, column
  const uint4* ah = reinterpret_cast<const uint4*>(as) + (wr / 16) * ksteps * 32 + lane;
  const uint4* al = ah + bm * ks / 4;
  const uint4* bf = reinterpret_cast<const uint4*>(bs) + (wc / 8) * ksteps * 32 + lane;
  const int s_begin = kw * ksteps / wk, s_end = (kw + 1) * ksteps / wk;  // this warp's k8 steps
  // the chain's sum: the fragments of the warps of K slice 0 (one block a tile) or this
  // thread's elements of the block's rows rank * bm / cl .. (cluster)
  constexpr int kSlice = 2 * MT * NT;  // elements a thread at most, cl >= 2
  float acc[MT][NT][4], acc_s[kSlice];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
#pragma unroll
  for (int q = 0; q < kSlice; ++q) acc_s[q] = 0.0f;
  const int slice_rows = bm / cl, slice0 = rank * slice_rows;
  // where this lane's fragment element (m, n, e) lies in a [bm][rs] buffer
  auto frag_off = [&](int m, int n, int h) { return (wr + m * 16 + g + h * 8) * rs + wc + n * 8 + 2 * tig; };

  for (int it = 0; it < iters; ++it) {
    if (kMode == 2 && it > 0) {
      cg::this_grid().sync();  // y_{it}[0, 0] is in the carry
      const float s = __fadd_rn(1.0f, __fmul_rn(__ldcg(carry + ((it - 1) & 1)), 1e-20f));
      if (s != scale) {  // never at the probes' shapes: split A * s anew
        __syncthreads();
        scale = s;
        stage_a<kOrdered>(as, a, row0, k0, kn, M, K, bm, ks, scale);
      }
    }
    __syncthreads();  // the panels are staged, the partials read; no shared load moves across
    float y[MT][NT][4];
    if constexpr (kOrdered) {
      product_ordered(y, reinterpret_cast<const float*>(as), reinterpret_cast<const float*>(bs),
                      ks, wr + g, wc + 2 * tig);
    } else {
      product<MT, NT>(y, ah, al, bf, ksteps, s_begin, s_end);
    }
    if (wk > 1) {  // the K slices' partials, summed in slice order by the warps of slice 0
      if (kw > 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h)  // rows g, g + 8; columns 2 tig, 2 tig + 1
              *reinterpret_cast<float2*>(part + (size_t)(kw - 1) * bm * rs + frag_off(m, n, h)) =
                  make_float2(y[m][n][2 * h], y[m][n][2 * h + 1]);
      }
      __syncthreads();
      if (kw == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float2 v[7];  // the other slices' partials, loaded together, summed in order
#pragma unroll
              for (int w = 1; w < 8; ++w)
                if (w < wk)
                  v[w - 1] = *reinterpret_cast<const float2*>(
                      part + (size_t)(w - 1) * bm * rs + frag_off(m, n, h));
#pragma unroll
              for (int w = 1; w < 8; ++w)
                if (w < wk) {
                  y[m][n][2 * h] = __fadd_rn(y[m][n][2 * h], v[w - 1].x);
                  y[m][n][2 * h + 1] = __fadd_rn(y[m][n][2 * h + 1], v[w - 1].y);
                }
            }
      }
    }
    if (cl == 1) {
      if (kw == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] = chain_step<kMode>(acc[m][n][e], y[m][n][e], inv);
        if (kMode == 2 && tile == 0 && tid == 0) carry[it & 1] = y[0][0][0];  // row 0, column 0
      }
      continue;
    }
    float* const rb = red + (size_t)(it & 1) * bm * rs;
    if (kw == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(rb + frag_off(m, n, h)) =
                make_float2(y[m][n][2 * h], y[m][n][2 * h + 1]);
    }
    cluster.sync();  // every block's partial of this iteration is in its buffer
#pragma unroll
    for (int q = 0; q < kSlice; ++q) {
      const int i = tid + q * nthreads;
      if (i >= slice_rows * bn) break;
      const int off = (slice0 + i / bn) * rs + i % bn;
      float v[8];  // the ranks' partials, loaded together, then summed in rank order
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = r < cl ? cluster.map_shared_rank(rb, r)[off] : 0.0f;
      float sum = v[0];
#pragma unroll
      for (int r = 1; r < 8; ++r)
        if (r < cl) sum = __fadd_rn(sum, v[r]);
      acc_s[q] = chain_step<kMode>(acc_s[q], sum, inv);
      if (kMode == 2 && tile == 0 && rank == 0 && i == 0) carry[it & 1] = sum;
    }
  }

  if (cl == 1) {
    if (kw > 0) return;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + wr + m * 16 + g + (e >> 1) * 8;
          const int c = col0 + wc + n * 8 + 2 * tig + (e & 1);
          if (r < M && c < N) out[(size_t)r * N + c] = acc[m][n][e];
        }
    return;
  }
#pragma unroll
  for (int q = 0; q < kSlice; ++q) {
    const int i = tid + q * nthreads;
    if (i >= slice_rows * bn) break;
    const int r = row0 + slice0 + i / bn, c = col0 + i % bn;
    if (r < M && c < N) out[(size_t)r * N + c] = acc_s[q];
  }
  cluster.sync();  // no block leaves while another may still read its partials
}

template <int MT, int NT, bool kOrdered = false>
const void* pick(int mode) {
  switch (mode) {
    case 0: return (const void*)gemm_chain_kernel<MT, NT, 0, kOrdered>;
    case 1: return (const void*)gemm_chain_kernel<MT, NT, 1, kOrdered>;
    case 2: return (const void*)gemm_chain_kernel<MT, NT, 2, kOrdered>;
    default: return nullptr;
  }
}

const void* kernel_for(int mt, int nt, int mode, bool ordered) {
  if (ordered) return mt == 1 && nt == 1 ? pick<1, 1, true>(mode) : nullptr;
  if (mt == 2 && nt == 4) return pick<2, 4>(mode);
  if (mt == 2 && nt == 2) return pick<2, 2>(mode);
  if (mt == 1 && nt == 4) return pick<1, 4>(mode);
  if (mt == 1 && nt == 2) return pick<1, 2>(mode);
  if (mt == 1 && nt == 1) return pick<1, 1>(mode);
  return nullptr;
}

}  // namespace

// The plan gemm_chain.py computed: (wm, wn, wk, mt, nt, cluster, ks) and the route (ordered: FMAs
// in k order on the CUDA cores); refused unless it is plan_gemm's.  carry: two floats of scratch, read only in mode 2.  Returns the launch's CUDA
// error (cudaErrorCooperativeLaunchTooLarge where a feed grid cannot be resident at once).
extern "C" int dfd_gemm_chain(const float* a, const float* b, float* out, float* carry, int M,
                              int K, int N, int iters, int mode, float inv, int wm, int wn,
                              int wk, int mt, int nt, int cluster, int ks, int ordered,
                              void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || iters <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  if (!plan_gemm(M, K, N, ordered != 0, mode == 2, &p) || p.wm != wm || p.wn != wn || p.wk != wk || p.mt != mt || p.nt != nt ||
      p.cluster != cluster || p.ks != ks)
    return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_for(mt, nt, mode, ordered != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  int tiles_n = (N + 8 * wn * nt - 1) / (8 * wn * nt);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(32 * wm * wn * wk);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // feed: every block must be resident at once for the grid sync
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = mode == 2 ? 2 : 1;
  void* args[] = {&a, &b, &out, &carry, &M, &K, &N, &iters, &inv, &wn, &wk, &tiles_n, &ks};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
