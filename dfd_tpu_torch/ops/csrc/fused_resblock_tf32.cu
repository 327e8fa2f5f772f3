// Fused IMPALA torso kernels on Hopper's tensor cores (sm_90a) with
// f32-accurate products (3xTF32), with a plain C interface loaded through
// ctypes (dfd_tpu_torch/ops/fused_resblock.py, which routes
// compute_dtype=None here and bfloat16 to fused_resblock_mma.cu).
//
// Replaces the Pallas TPU kernels dfd_tpu/ops/fused_resblock.py::
// fused_res_stage (_stage_kernel) and ::fused_feat_pool (_featpool_kernel)
// in float32:
//
//   dfd_res_stage_tf32:  one stage's two residual blocks.  Four times
//                        h <- conv3x3(relu(h * s_j + t_j)) + b_j, the block
//                        input added back after the second conv of each block.
//   dfd_feat_pool_tf32:  one stage's feature block: y = conv3x3(x * s + t) + b,
//                        then the 3x3 max with -inf off the image, kept at the
//                        even positions (maxpool 3x3, stride 2, padding 1).
//
// Weights arrive per member as float32 in the tap order of
// reorder_conv_weight: w[co][kw * 3 * ci + kh * ci + c] holds the OIHW weight
// w[co, c, kh, kw].
//
// Products in f32 accuracy on TF32 tensor cores (ptx.cuh).  Each f32 operand
// a is split as a = hi + lo, hi = tf32(a) and lo = tf32(a - hi)
// (cvt.rna.tf32.f32; a - hi is exact in f32), and a * b is taken as
// lo_a * hi_b + hi_a * lo_b + hi_a * hi_b: three mma.sync.m16n8k8 TF32
// products into the same f32 sums, lo * lo dropped.  That keeps about 22 of
// f32's 24 bits a product, at a third of the TF32 rate (495 / 3 = 165 TFLOP/s
// against the CUDA cores' 67).
// The arithmetic is explicit here; no library flag (allow_tf32) is involved.
//
// What bounds them on an H100: operations.  At impala_procmaze's rollout
// shapes (M = 129 members, one frame each, 16 ch x 32x32 and 32 ch x 16x16) a
// torso call's two res-stage launches are 4.93 GFLOP, 30 us at 165 TFLOP/s,
// against 49 MB of traffic (15 us).  The CUDA-core kernels this replaces took
// 0.468 ms for them.  The design, that of fused_resblock_mma.cu with f32
// operands:
//
// 1. Implicit GEMM.  Each 3x3 conv is out[co][n] = sum over K = (tap, ci) of
//    W[co][tap, ci] * X[n + shift(tap)][ci], with X a halo-padded activation
//    tile stored position-major ([pos][ci], row stride cs = kp + 4 floats,
//    kp = ci padded to 8 with zero channels), so a tap is an offset of each
//    lane's position.  ldmatrix moves 16-bit elements only: the 32-bit
//    fragments are plain shared loads, and a row stride of 4 mod 8 floats
//    puts the 8 positions x 4 channels of a fragment on 32 distinct banks.
//    Both operands are split into hi and lo in registers as they are loaded;
//    a weight fragment is loaded once for all of the warp's positions.
// 2. Warp tiles for narrow convs.  A warp owns 16 output channels (one m16
//    tile) x up to 128 positions when the conv has 16, else 32 channels (two
//    m16 tiles) x up to 64 positions; the 8 warps spread over the positions
//    (and over channel groups beyond 32), and the positions a warp takes
//    shrink to what the block has, so no warp idles at 32 ch x 16x16.
// 3. The whole stage on chip.  A res-stage block holds every channel of its
//    band of image rows, plus a halo row on each side, in two ping-pong f32
//    buffers: each conv's epilogue writes the next conv's operand,
//    relu(h * s + t), into the other buffer.  At impala_procmaze's shapes a
//    frame fits one block (129 blocks, one wave); where it does not, a
//    cluster of 2, 4 or 8 blocks splits the rows and the halo rows come from
//    the neighbours' buffers through distributed shared memory after a
//    cluster.sync().  Only the f32 block outputs go to device memory.
// 4. Weights one step ahead.  The weights stream through two buffers in
//    groups of 9 taps (a whole conv: the next conv's weights arrive while
//    this one multiplies), or of 3 or 1 taps where a conv's do not fit, by
//    cp.async straight into the layout the fragments read: one barrier a
//    group, no conversion pass.
// 5. The feature pool computes the dense conv outputs behind its band of
//    pooled rows (2 * rows + 1 dense rows) into shared memory, over the
//    buffers the conv is done with when one chunk of positions covers the
//    band, takes the 3x3 maximum and writes only the pooled outputs.  Two
//    blocks share an SM.
//
// The cluster kernels take any C, H and W up to 256 output channels whose
// band fits a block: K is padded with zero channels, output channels past C
// are masked, bands may be ragged (a block may own no rows), positions past a
// chunk's end read a valid address and are dropped.  Every other shape goes
// to the tiled forms at the end of this file (conv_tiled_tf32_kernel), which
// take any C, H and W.  The launch plan (cluster, band and tap group of the
// res stage; pooled rows a block and tap group of the feature pool; the
// tiled forms' tile) is computed by res_plan and feat_plan here, by
// tiled_tf32_plan.cuh's res_plan and feat_plan, and by fused_resblock.py's
// *_tf32_plan; an entry point refuses a plan that differs from its own
// (cudaErrorInvalidValue).
//
// Arithmetic follows the TPU kernel: the affine as two rounded operations
// (__fmul_rn, __fadd_rn, never contracted), then ReLU in the res stage; the
// products summed in f32 (each k8 step's on the tensor cores, the steps'
// sums by __fadd_rn; in another order than the plain version's); the bias
// after the product; the residual after the second conv of each block; -inf
// off the image for the maximum.  Build without --use_fast_math.
//
// Where the time goes: tools/torch_mma_variants.py times the kernels with
// their products, their hi/lo split or their weight copies cut out of this
// source (PERF.md).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "conv_tiled.cuh"
#include "ptx.cuh"
#include "tiled_tf32_plan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // an H100 block's shared memory, bytes
constexpr int kMaxRows = 256;     // output channels a block can take

__host__ __device__ __forceinline__ int pad_to(int n, int m) { return (n + m - 1) / m * m; }
// m16 tiles of a warp: one when the conv has at most 16 output channels
__host__ __device__ __forceinline__ int m_tiles(int co) { return co <= 16 ? 1 : 2; }
// weight rows the warps read: output channels padded to whole warp tiles
__host__ __device__ __forceinline__ int a_rows(int co) { return pad_to(co, 16 * m_tiles(co)); }
__host__ __device__ __forceinline__ int warps_m(int co) { return a_rows(co) / (16 * m_tiles(co)); }
// positions one chunk of the block's warps covers at most
__host__ __device__ __forceinline__ int chunk_cap(int co) {
  return kWarps / warps_m(co) * 8 * (16 / m_tiles(co));
}

__device__ __forceinline__ float affine(float v, float s, float t) {
  return __fadd_rn(__fmul_rn(v, s), t);
}

// Zero n bytes (a multiple of 16) of shared memory from p.
__device__ void zero_smem(void* p, size_t n) {
  int4* q = reinterpret_cast<int4*>(p);
  for (size_t i = threadIdx.x; i < n / 16; i += kThreads) q[i] = make_int4(0, 0, 0, 0);
}

// Rows y_first .. y_first + nrows - 1 of src [C, H, W] as the conv's
// operand: src * s + t, then ReLU if relu, into dst's tile row y - y_first,
// column x + 1, channel c; rows off the image are left as they are (zero).
// A thread takes one position at a time (one division) and walks its
// channels with kBatch loads in flight.
__device__ void stage_operand(float* dst, const float* __restrict__ src,
                              const float* __restrict__ s, const float* __restrict__ t,
                              bool relu, int C, int H, int W, int y_first, int nrows, int tile_w,
                              int cs) {
  constexpr int kBatch = 16;
  const size_t plane = (size_t)H * W;
  for (int pi = threadIdx.x; pi < nrows * W; pi += kThreads) {
    const int r = pi / W, x = pi - r * W, y = y_first + r;
    if (y < 0 || y >= H) continue;
    const float* col = src + (size_t)y * W + x;
    float* d = dst + (r * tile_w + x + 1) * cs;
    for (int c0 = 0; c0 < C; c0 += kBatch) {
      float v[kBatch], sv[kBatch], tv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + u < C ? c0 + u : C - 1;
        v[u] = col[c * plane];
        sv[u] = s[c];
        tv[u] = t[c];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float a = affine(v[u], sv[u], tv[u]);
        if (c0 + u < C) d[c0 + u] = relu ? fmaxf(a, 0.f) : a;
      }
    }
  }
}

// Start copying tap group grp (taps grp * wt .. grp * wt + wt - 1) of `rows`
// weight rows (f32, row stride 9 * ci) into dst[r * csw + tap * kp + c]:
// warps over rows, lanes over the group's values.
__device__ void issue_group(float* dst, const float* __restrict__ w, int ci, int kp, int csw,
                            int rows, int wt, int grp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* src = w + (size_t)grp * wt * ci;
  if ((ci & 3) == 0) {
    const int q = ci / 4;  // 16-byte pieces a tap
    for (int r = warp; r < rows; r += kWarps) {
      for (int i = lane; i < wt * q; i += 32) {
        const int tap = i / q, c = (i - tap * q) * 4;
        cp_async16(dst + r * csw + tap * kp + c, src + (size_t)r * 9 * ci + tap * ci + c);
      }
    }
  } else {
    for (int r = warp; r < rows; r += kWarps) {
      for (int i = lane; i < wt * ci; i += 32) {
        const int tap = i / ci, c = i - tap * ci;
        cp_async4(dst + r * csw + tap * kp + c, src + (size_t)r * 9 * ci + tap * ci + c);
      }
    }
  }
  cp_async_commit();
}

// This warp's place in the block: output rows wm * MT * 16 + [0, MT * 16),
// positions p0 + wn * nt * 8 + [0, nt * 8) of each chunk of nc positions;
// nt is a whole number of group_products' groups of n8 tiles.
struct Warp {
  int wm, wn, nt, nc, chunks;
  bool active;
};

template <int MT>
__device__ __forceinline__ Warp warp_place(int co, int npos) {
  constexpr int kNt = 16 / MT;
  const int warp = threadIdx.x >> 5;
  const int wms = warps_m(co), wns = kWarps / wms;
  Warp p;
  p.wm = warp / wns;
  p.wn = warp % wns;
  p.active = p.wm < wms;
  p.nt = min(kNt, pad_to(max(1, (npos + wns * 8 - 1) / (wns * 8)), 4 / MT));
  p.nc = wns * p.nt * 8;
  p.chunks = (npos + p.nc - 1) / p.nc;
  return p;
}

// Where this lane's B fragments start in the tile (row stride tile_w
// positions, cs floats a position): position p0 + wn * nt * 8 + n * 8 + g,
// dense over rows of W; past npos they read position 0 and are dropped.
template <int MT>
__device__ __forceinline__ void b_offsets(int (&off)[16 / MT], const Warp& wp, int p0, int npos,
                                          int W, int tile_w, int cs) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int n = 0; n < 16 / MT; ++n) {
    int p = p0 + (wp.wn * wp.nt + n) * 8 + g;
    if (p >= npos) p = 0;
    off[n] = ((p / W) * tile_w + p % W) * cs;
  }
}

// The products of one tap group into acc: for the warp's MT m16 tiles and
// nt n8 tiles, acc[mt][n] += sum over the group's taps and kp channels of
// W[row][tap, ci] * tile[pos + shift(tap)][ci], each product as three TF32
// ones.  wg points at this lane's first weight (row wm * MT * 16 + g,
// column tig) in the group's buffer.
//
// The tensor cores do not round the sum they carry from one mma.sync to the
// next to nearest: carried through a 32-channel conv's 108 of them (36 k8
// steps of three), the bias reached 6e-6 of the output's scale on an H100.
// So each k8 step's three products go into a fresh sum, added to acc in f32
// (__fadd_rn): 3e-7 to 8e-7 of the scale since.  The n8 tiles go in groups
// of kG, each of the three passes over a whole group, so kG * MT independent
// products lie between two that depend on each other.
template <int MT>
__device__ __forceinline__ void group_products(float (&acc)[MT][16 / MT][4], const float* tile,
                                               const int (&boff)[16 / MT], int nt,
                                               const float* wg, int csw, int kp, int wt, int t0,
                                               int tile_w, int cs) {
  constexpr int kNt = 16 / MT, kG = 4 / MT;
  const int tig = threadIdx.x & 3;
  for (int tl = 0; tl < wt; ++tl) {
    const int tap = t0 + tl;                                      // tap = kw * 3 + kh
    const float* bt = tile + ((tap % 3) * tile_w + tap / 3) * cs + tig;
    const float* ap = wg + tl * kp;
    for (int k0 = 0; k0 < kp; k0 += 8) {
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // rows g, g + 8; columns tig, tig + 4
          split(ap[(mt * 16 + (e & 1) * 8) * csw + k0 + (e >> 1) * 4], ahi[mt][e], alo[mt][e]);
#pragma unroll
      for (int n0 = 0; n0 < kNt; n0 += kG) {
        if (n0 >= nt) break;
        uint32_t bhi[kG][2], blo[kG][2];
        float part[MT][kG][4];
#pragma unroll
        for (int u = 0; u < kG; ++u) {
          const float* bp = bt + boff[n0 + u] + k0;
          split(bp[0], bhi[u][0], blo[u][0]);
          split(bp[4], bhi[u][1], blo[u][1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mt][u][e] = 0.f;
        }
#pragma unroll
        for (int u = 0; u < kG; ++u)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][u], alo[mt], bhi[u]);
#pragma unroll
        for (int u = 0; u < kG; ++u)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][u], ahi[mt], blo[u]);
#pragma unroll
        for (int u = 0; u < kG; ++u)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][u], ahi[mt], bhi[u]);
#pragma unroll
        for (int u = 0; u < kG; ++u)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][n0 + u][e] = __fadd_rn(acc[mt][n0 + u][e], part[mt][u][e]);
      }
    }
  }
}

size_t res_smem(int C, int W, int band, int wt) {
  const int kp = pad_to(C, 8), cs = kp + 4;
  return 4 * (2 * (size_t)(band + 2) * (W + 2) * cs + 2 * (size_t)a_rows(C) * (wt * kp + 4));
}

// The fewest blocks a frame (1, 2, 4 or 8), then the largest tap group
// (9, 3, 1) whose buffers fit a block.
bool res_plan(int C, int H, int W, int* cluster, int* band, int* wt) {
  if (a_rows(C) > kMaxRows) return false;
  for (int cl = 1; cl <= 8; cl *= 2) {
    const int bd = (H + cl - 1) / cl;
    for (int g = 9; g >= 1; g /= 3) {
      if (res_smem(C, W, bd, g) <= (size_t)kMaxSmem) {
        *cluster = cl;
        *band = bd;
        *wt = g;
        return true;
      }
    }
  }
  return false;
}

// The feature pool's dense map [co][dr][W] f32 overlays the operand and
// weight buffers when one chunk covers the band (the conv is done with them
// before the epilogue writes it), else follows them.
__host__ __device__ __forceinline__ bool dense_overlays(int co, int W, int pb) {
  return (2 * pb + 1) * W <= chunk_cap(co);
}

size_t feat_smem(int ci, int co, int W, int pb, int wt) {
  const int kp = pad_to(ci, 8), cs = kp + 4, dr = 2 * pb + 1;
  const size_t conv =
      4 * ((size_t)(dr + 2) * (W + 2) * cs + 2 * (size_t)a_rows(co) * (wt * kp + 4));
  const size_t dense = 4 * (size_t)co * dr * W;
  return dense_overlays(co, W, pb) ? (conv > dense ? conv : dense) : conv + dense;
}

// The most pooled rows a block (spread evenly over the bands) whose dense
// rows one chunk covers, then the largest tap group that fits; fewer rows
// while nothing fits.
bool feat_plan(int ci, int co, int H, int W, int* pb_out, int* wt) {
  if (a_rows(co) > kMaxRows) return false;
  const int Ho = (H + 1) / 2;
  int pb = min(Ho, max(1, (chunk_cap(co) / W - 1) / 2));
  while (true) {
    const int bands = (Ho + pb - 1) / pb;
    pb = (Ho + bands - 1) / bands;
    for (int g = 9; g >= 1; g /= 3) {
      if (feat_smem(ci, co, W, pb, g) <= (size_t)kMaxSmem) {
        *pb_out = pb;
        *wt = g;
        return true;
      }
    }
    if (pb == 1) return false;
    --pb;
  }
}

// A cluster of `cluster` blocks per (member, frame): blockIdx.x =
// (member * B + frame) * cluster + rank; rank r owns image rows
// [r * band, min(H, (r + 1) * band)).  Weights stream in groups of wt taps.
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
res_stage_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, const float* __restrict__ s,
                      const float* __restrict__ t, float* out, int B, int C, int H, int W,
                      int band, int wt) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kNt = 16 / MT, kE = 4 / MT;  // n8 tiles; those of one residual batch
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int mb = blockIdx.x / (int)cluster.num_blocks(), m = mb / B;
  const int y0 = rank * band;
  const int rows = max(0, min(band, H - y0));
  const int kp = pad_to(C, 8), cs = kp + 4, tile_w = W + 2, csw = wt * kp + 4;
  const size_t row_elems = (size_t)tile_w * cs;
  const size_t tile_elems = (band + 2) * row_elems;
  const size_t wbuf_elems = (size_t)a_rows(C) * csw;
  float* const buf0 = reinterpret_cast<float*>(smem);  // the two ping-pong operand buffers
  float* const buf1 = buf0 + tile_elems;
  float* const wbuf0 = buf1 + tile_elems;               // the two weight-group buffers
  float* const wbuf1 = wbuf0 + wbuf_elems;
  const size_t img = (size_t)C * H * W, plane = (size_t)H * W;
  const float* xin = x + mb * img;
  float* o = out + mb * img;
  const float* wmem = w + (size_t)m * 4 * C * 9 * C;  // conv j's weights at j * 9C^2

  const int npos = rows * W;
  const Warp wp = warp_place<MT>(C, npos);
  const int groups = 9 / wt, ngroups = 4 * wp.chunks * groups;

  zero_smem(smem, 4 * (2 * tile_elems + 2 * wbuf_elems));
  __syncthreads();
  if (ngroups > 0) issue_group(wbuf0, wmem, C, kp, csw, C, wt, 0);
  // conv 0's operand, halo rows included, straight from x
  if (rows > 0)
    stage_operand(buf0, xin, s + (size_t)m * 4 * C, t + (size_t)m * 4 * C, true, C, H, W, y0 - 1,
                  rows + 2, tile_w, cs);

  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int row0 = wp.wm * MT * 16 + g;  // this lane's first output row
  int gi = 0;                            // the weight group in use
  for (int j = 0; j < 4; ++j) {  // conv j of the stage: block j / 2, conv j % 2
    const float* cur = j & 1 ? buf1 : buf0;
    float* nxt = j & 1 ? buf0 : buf1;
    const size_t mj = (size_t)m * 4 + j;
    // this lane's output rows' bias and the next conv's affine (j < 3)
    float bv[MT][2], sv[MT][2], tv[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = min(row0 + mt * 16 + h * 8, C - 1);
        bv[mt][h] = b[mj * C + co];
        sv[mt][h] = j < 3 ? s[(mj + 1) * C + co] : 0.f;
        tv[mt][h] = j < 3 ? t[(mj + 1) * C + co] : 0.f;
      }
    for (int p0 = 0; p0 < npos; p0 += wp.nc) {
      int boff[kNt];
      b_offsets<MT>(boff, wp, p0, npos, W, tile_w, cs);
      float acc[MT][kNt][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < kNt; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
      for (int q = 0; q < groups; ++q, ++gi) {
        cp_async_wait_all();
        __syncthreads();  // group gi has landed; every warp is done with group gi - 1
        if (gi + 1 < ngroups) {
          const int next = gi + 1, nj = next / (wp.chunks * groups);
          issue_group(next & 1 ? wbuf1 : wbuf0, wmem + (size_t)nj * 9 * C * C, C, kp, csw, C, wt,
                      next % groups);
        }
        if (wp.active)
          group_products<MT>(acc, cur, boff, wp.nt, (gi & 1 ? wbuf1 : wbuf0) + row0 * csw + tig,
                             csw, kp, wt, q * wt, tile_w, cs);
      }
      if (!wp.active) continue;
      // the epilogue: lane column tig holds positions 2 * tig and 2 * tig + 1
      // of each n8 tile, rows g and g + 8 of each m16 tile.  The residual
      // (j = 1: the block input, j = 3: block 0's output, which this thread
      // wrote) is loaded kE n8 tiles at a time, every load issued before the
      // first is used: one at a time, each would wait out the memory's latency
      const float* rsrc = j == 1 ? xin : o;
#pragma unroll
      for (int n0 = 0; n0 < kNt; n0 += kE) {
        if (n0 >= wp.nt) break;
        int toff[kE][2], goff[kE][2];
        float res[kE][2][MT][2];
#pragma unroll
        for (int u = 0; u < kE; ++u)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const int p = p0 + (wp.wn * wp.nt + n0 + u) * 8 + 2 * tig + c2;
            const int ly = p / W, xx = p - ly * W;
            toff[u][c2] = p < npos ? ((ly + 1) * tile_w + xx + 1) * cs : -1;
            goff[u][c2] = (y0 + ly) * W + xx;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int co = row0 + mt * 16 + h * 8;
                res[u][c2][mt][h] =
                    (j & 1) && p < npos && co < C ? rsrc[co * plane + goff[u][c2]] : 0.f;
              }
          }
#pragma unroll
        for (int u = 0; u < kE; ++u)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            if (toff[u][c2] < 0) continue;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int co = row0 + mt * 16 + h * 8;
                if (co >= C) continue;
                float v = __fadd_rn(acc[mt][n0 + u][h * 2 + c2], bv[mt][h]);
                if (j & 1) {
                  v = __fadd_rn(res[u][c2][mt][h], v);
                  o[co * plane + goff[u][c2]] = v;
                }
                if (j < 3) nxt[toff[u][c2] + co] = fmaxf(affine(v, sv[mt][h], tv[mt][h]), 0.f);
              }
          }
      }
    }
    if (j < 3) {
      cluster.sync();  // every block's next operand is written
      if (rows > 0) {
        const int n16 = (int)(row_elems * sizeof(float) / 16);
        if (y0 > 0) {  // the top halo: the last row of the block above
          const int4* src = reinterpret_cast<const int4*>(
              cluster.map_shared_rank(nxt, rank - 1) + (size_t)band * row_elems);
          int4* dst = reinterpret_cast<int4*>(nxt);
          for (int i = threadIdx.x; i < n16; i += kThreads) dst[i] = src[i];
        }
        if (y0 + rows < H) {  // the bottom halo: the first row of the block below
          const int4* src =
              reinterpret_cast<const int4*>(cluster.map_shared_rank(nxt, rank + 1) + row_elems);
          int4* dst = reinterpret_cast<int4*>(nxt + (size_t)(rows + 1) * row_elems);
          for (int i = threadIdx.x; i < n16; i += kThreads) dst[i] = src[i];
        }
      }
      __syncthreads();
    }
  }
  cluster.sync();  // no block leaves while a neighbour may still read its buffers
}

// blockIdx.x = member * B + frame, blockIdx.y = band of pb pooled rows.  Two
// blocks an SM, so that one block's staging and pooling overlap the other's
// products.
template <int MT>
__global__ void __launch_bounds__(kThreads, 2)
feat_pool_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, const float* __restrict__ s,
                      const float* __restrict__ t, float* __restrict__ out, int B, int ci,
                      int co_n, int H, int W, int Ho, int Wo, int pb, int wt) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kNt = 16 / MT;
  const int mb = blockIdx.x, m = mb / B;
  const int py0 = blockIdx.y * pb, prow = min(pb, Ho - py0);
  const int kp = pad_to(ci, 8), cs = kp + 4, tile_w = W + 2, csw = wt * kp + 4;
  const int dr = 2 * prow + 1, dy0 = 2 * py0 - 1;  // dense rows dy0 .. dy0 + dr - 1
  const size_t tile_elems = (size_t)(2 * pb + 3) * tile_w * cs;
  const size_t wbuf_elems = (size_t)a_rows(co_n) * csw;
  float* const tile = reinterpret_cast<float*>(smem);
  float* const wbuf0 = tile + tile_elems;
  float* const wbuf1 = wbuf0 + wbuf_elems;
  const bool overlay = dense_overlays(co_n, W, pb);
  float* const sd = overlay ? tile : wbuf1 + wbuf_elems;
  const float* wmem = w + (size_t)m * co_n * 9 * ci;

  const int npos = dr * W;
  const Warp wp = warp_place<MT>(co_n, npos);
  const int groups = 9 / wt, ngroups = wp.chunks * groups;

  zero_smem(smem, 4 * (tile_elems + 2 * wbuf_elems));
  __syncthreads();
  issue_group(wbuf0, wmem, ci, kp, csw, co_n, wt, 0);
  // the operand: tile row r holds image row dy0 - 1 + r
  stage_operand(tile, x + (size_t)mb * ci * H * W, s + (size_t)m * ci, t + (size_t)m * ci, false,
                ci, H, W, dy0 - 1, dr + 2, tile_w, cs);

  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int row0 = wp.wm * MT * 16 + g;
  float bv[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bv[mt][h] = b[(size_t)m * co_n + min(row0 + mt * 16 + h * 8, co_n - 1)];
  int gi = 0;
  for (int p0 = 0; p0 < npos; p0 += wp.nc) {
    int boff[kNt];
    b_offsets<MT>(boff, wp, p0, npos, W, tile_w, cs);
    float acc[MT][kNt][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    for (int q = 0; q < groups; ++q, ++gi) {
      cp_async_wait_all();
      __syncthreads();  // group gi has landed; every warp is done with group gi - 1
      if (gi + 1 < ngroups)
        issue_group((gi + 1) & 1 ? wbuf1 : wbuf0, wmem, ci, kp, csw, co_n, wt, (gi + 1) % groups);
      if (wp.active)
        group_products<MT>(acc, tile, boff, wp.nt, (gi & 1 ? wbuf1 : wbuf0) + row0 * csw + tig,
                           csw, kp, wt, q * wt, tile_w, cs);
    }
    if (overlay) __syncthreads();  // the dense map overwrites the operand and the weights
    if (!wp.active) continue;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      if (n >= wp.nt) continue;
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int p = p0 + (wp.wn * wp.nt + n) * 8 + 2 * tig + c2;
        if (p >= npos) continue;
        const int y = dy0 + p / W;
        const bool inside = y >= 0 && y < H;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = row0 + mt * 16 + h * 8;
            if (k < co_n)
              sd[k * npos + p] = inside ? __fadd_rn(acc[mt][n][h * 2 + c2], bv[mt][h])
                                        : -CUDART_INF_F;
          }
      }
    }
  }
  __syncthreads();
  // the pooled outputs
  for (int i = threadIdx.x; i < co_n * prow * Wo; i += kThreads) {
    const int k = i / (prow * Wo), rem = i - k * prow * Wo, ly = rem / Wo, px = rem - ly * Wo;
    const float* d = sd + k * npos + 2 * ly * W;
    float v = -CUDART_INF_F;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = 2 * px + dx;
        if (xx >= 0 && xx < W) v = fmaxf(v, d[dy * W + xx]);
      }
    }
    out[(((size_t)mb * co_n + k) * Ho + py0 + ly) * Wo + px] = v;
  }
}

// -- the tiled forms ---------------------------------------------------------------
//
// Where no cluster of at most 8 blocks holds a frame's band with all its
// channels, or a conv has more than kMaxRows output channels, each conv runs
// on its own as an implicit GEMM over tiles (conv_tiled_tf32_kernel; the
// plan and the weight image in tiled_tf32_plan.cuh).  A block of 16 warps,
// one an SM, takes a tile of conv outputs x a group of output channels: in
// the res stage 8 x 16 outputs x 64 channels, in the feature pool the 17 x
// 17 dense outputs behind 8 x 8 pooled ones x 32 channels (impala_128px's
// shapes: 512, 256 and 1,024 blocks a launch).  K = 9 ci streams in chunks
// of 16 input channels x all nine taps (K = 144), one barrier a chunk.
//
// What held the earlier tiled forms back (8-channel chunks by cp.async, pool
// tiles of 3 x 65 dense outputs), and what this design does about it
// (PERF.md section 6, measured by tools/torch_mma_variants.py --source tiled
// --stamps):
// - Copies.  74 KB of weights a chunk by cp.async filled the SM's queue of
//   memory requests, and the operand's copies and the transform's shared
//   loads waited behind them (3.5-4 us a chunk).  Now each chunk's weights
//   come by one bulk copy and its operand tile by one tensor-map load (TMA,
//   zero outside the frame), each completing on an mbarrier; only frames
//   with W % 4 != 0 copy the operand by 4-byte cp.async.
// - The 3xTF32 split.  Every operand value is split into TF32 hi and lo
//   once: the weights by split_weights_kernel, once a call, into an image of
//   the ring's layout (tiled_tf32::image_offset; zero past ci and co); the
//   activations as a chunk is transformed (x * s + t, ReLU in the res stage,
//   zero off the frame and past ci), into hi and lo planes.  Both lie in the
//   core-matrix layout of the tensor cores' operands (planes of 4 channels,
//   16 bytes a position or a weight row), so the product loop only loads
//   and multiplies.
// - Overlap.  Chunk k + 1's transform runs in three slices between the tap
//   columns of chunk k's products: on wgmma while they are in flight.
// - Products.  The res stage multiplies on wgmma (m64n72k8 TF32, A the
//   weights and B the planes, both from shared memory): the block's four
//   warpgroups take 2 x 72 halo-padded positions (a tile row and its two
//   halo columns, so a tap is a shift of B's start; 128 of 144 products are
//   kept) x the two k8 halves of each tap.  In its products phase it runs
//   at about the tensor cores' TF32 rate; the same template on mma.sync
//   was 1.12-1.19x slower.  The pool's 32 channels do not fill wgmma's 64
//   rows: it stays on mma.sync, a warp 32 channels x 40 positions, K in
//   halves.
// - The sum.  The tensor cores do not round the sum they carry to nearest
//   (group_products' note): a fresh sum every tap column (9 products) on
//   wgmma and every k8 step in the pool is added to the output's in f32
//   (__fadd_rn), and the K halves' sums are added in a fixed order.
//
// The res stage is four launches after the weights' split
// (dfd_res_stage_tiled_tf32), the feature pool one (dfd_feat_pool_tiled_tf32):
// its dense outputs, -inf off the frame, go to shared memory over the
// buffers, then their 3x3 maxima to device memory; no block needs another's.

namespace tt = tiled_tf32;


// Weights w (member m's conv j [co][9 ci] in tap order at
// w + (m * J + j) * co * 9 ci) as hi and lo into img, conv (m, j)'s image at
// img + (m * J + j) * conv_image_floats: one thread a core-matrix row (4
// channels of one tap of one output channel, read as 16 bytes where ci % 4
// == 0), neighbouring threads on neighbouring rows, so that the image is
// written 16 bytes a thread in order.
__global__ void __launch_bounds__(256)
split_weights_kernel(const float* __restrict__ w, float* __restrict__ img, int MJ, int co, int ci,
                     int group) {
  const int groups = tt::cdiv(co, group), nk = tt::cdiv(ci, tt::kKc);
  const long long conv = tt::conv_image_floats(ci, co, group), half = tt::chunk_floats(group) / 2;
  const long long total = (long long)MJ * groups * nk * 9 * tt::kKq * group;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    long long r = i;
    const int row = int(r % group);
    r /= group;
    const int q = int(r % tt::kKq);
    r /= tt::kKq;
    const int tap = int(r % 9);
    r /= 9;
    const int k = int(r % nk);
    r /= nk;
    const int gi = int(r % groups);
    const long long mj = r / groups;
    const int o = gi * group + row, c0 = k * tt::kKc + 4 * q;
    const float* src = w + (mj * co + o) * 9 * ci + (size_t)tap * ci;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f), hi, lo;
    float* u = &v.x;
    if (o < co && c0 < ci) {
      if ((ci & 3) == 0) {
        v = __ldg(reinterpret_cast<const float4*>(src + c0));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) u[e] = c0 + e < ci ? src[c0 + e] : 0.f;
      }
    }
    float* h = &hi.x;
    float* l = &lo.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t vh, vl;
      split(u[e], vh, vl);
      h[e] = __uint_as_float(vh);
      l[e] = __uint_as_float(vl);
    }
    float* dst = img + mj * conv + tt::image_offset(ci, group, o, tap, c0);
    *reinterpret_cast<float4*>(dst) = hi;
    *reinterpret_cast<float4*>(dst + half) = lo;
  }
}

// One thread starts the bulk copy of a chunk's weight image into wst,
// completing on bar.  Shared memory the block last read by generic loads
// is handed to the copy engine behind a proxy fence.
__device__ void issue_weights(float* wst, const float* wimg, int group, uint64_t* bar) {
  if (threadIdx.x != 0) return;
  fence_proxy_async();
  bulk_copy(wst, wimg, uint32_t(tt::chunk_floats(group) * 4), bar);
}

// The landed chunk as the conv's operand: each value r becomes v = r * s + t
// (then ReLU if relu) on the frame, zero off it, past ci and past the halo
// tile, written as hi(v) and lo(v) into the planes ([2][kKq][pa][4]).  A
// quarter of the threads takes each plane (4 channels, their s and t held
// by TransformPlane), its positions kThreads / kKq apart; the positions go
// in kSlices slices, so that the products of one chunk can interleave the
// transform of the next.
constexpr int kSlices = 3;

struct TransformPlane {
  float s[4], t[4];
  bool in[4];
};

__device__ __forceinline__ TransformPlane transform_plane(const TiledArgs& a, int m, int c0) {
  const int q = threadIdx.x / (tt::kThreads / tt::kKq);
  TransformPlane tp;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = c0 + 4 * q + e;
    tp.in[e] = c < a.ci;
    tp.s[e] = tp.in[e] ? __ldg(a.s + (size_t)m * a.st_ms + c) : 0.f;
    tp.t[e] = tp.in[e] ? __ldg(a.t + (size_t)m * a.st_ms + c) : 0.f;
  }
  return tp;
}

__device__ __forceinline__ void transform_slice(const TiledArgs& a, const TransformPlane& tp,
                                                const float* land, float* planes,
                                                const TileView& v, int slice) {
  constexpr int kStride = tt::kThreads / tt::kKq;
  const int q = threadIdx.x / kStride, cstride = v.rows * v.lw;
  const int per = (v.pa + kSlices - 1) / kSlices, end = min(v.pa, (slice + 1) * per);
  const float* lq = land + 4 * q * cstride + v.dx;
  float4* hq = reinterpret_cast<float4*>(planes) + q * v.pa;
  for (int p = slice * per + threadIdx.x - q * kStride; p < end; p += kStride) {
    const int r = p / v.tile_w, col = p - r * v.tile_w;
    const int y = v.oy - 1 + r, x = v.ox - 1 + col;
    const bool inside = p < v.P && y >= 0 && y < a.H && x >= 0 && x < a.W;
    const float* src = lq + r * v.lw + col;
    float4 hi, lo;
    float* hv = &hi.x;
    float* lv = &lo.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float u = 0.f;
      if (inside && tp.in[e]) {
        u = affine(src[e * cstride], tp.s[e], tp.t[e]);
        if (a.relu) u = fmaxf(u, 0.f);
      }
      uint32_t uh, ul;
      split(u, uh, ul);
      hv[e] = __uint_as_float(uh);
      lv[e] = __uint_as_float(ul);
    }
    hq[p] = hi;
    hq[tt::kKq * v.pa + p] = lo;
  }
}

// One chunk's products on mma.sync into part, a fresh sum every k8 step
// (fewer live registers than a longer one) added to acc: the warp's MT m16
// tiles x NT n8 tiles, its k8 step(s) wk, wk + WK, ... of each tap.  wh and
// wl point at this lane's weight column in the chunk's hi and lo weights;
// b_lane[n] at its position.
template <int MT, int NT, int WK, class Between>
__device__ __forceinline__ void chunk_products_mma(float (&acc)[MT][NT][4], float (&part)[MT][NT][4],
                                                   const uint32_t* wh, const uint32_t* wl,
                                                   const uint32_t* oph, const uint32_t* opl,
                                                   const int (&b_lane)[NT], int wk, int G, int pa,
                                                   int tile_w, Between between) {
  constexpr int NJ = tt::kKc / 8 / WK;
#pragma unroll 1
  for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int tap = kw * 3 + kh, shift = (kh * tile_w + kw) * 4;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = wk + jj * WK;  // the chunk's k8 step: planes 2j and 2j + 1
        uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // rows g, g + 8; columns tig, tig + 4
            const int off = ((tap * tt::kKq + 2 * j + (e >> 1)) * G + mt * 16 + (e & 1) * 8) * 4;
            ahi[mt][e] = wh[off];
            alo[mt][e] = wl[off];
          }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bhi[2], blo[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int off = (2 * j + h) * pa * 4 + b_lane[n] + shift;
            bhi[h] = oph[off];
            blo[h] = opl[off];
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][n], alo[mt], bhi);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][n], ahi[mt], blo);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][n], ahi[mt], bhi);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[mt][n][e] = __fadd_rn(acc[mt][n][e], part[mt][n][e]);
              part[mt][n][e] = 0.f;
            }
      }
    }
    between(kw);
  }
}

// One chunk's products on wgmma: the warpgroup's 64 rows x 72 halo-padded
// positions from n0 on, its k8 step wk of each tap, a fresh sum every tap
// column (three k8 steps, nine products) added to acc; between(kw) runs
// while a tap column's products are in flight.  The weights are A (64 rows,
// [tap][plane][row][4]), the planes B (positions 16 bytes apart), so a tap
// is a shift of B's start.
template <class Between>
__device__ __forceinline__ void chunk_products_wgmma(float (&acc)[1][9][4], float (&part)[1][9][4],
                                                     const float* wst, const float* planes,
                                                     int n0, int wk, int pa, int tile_w,
                                                     Between between) {
  float (&d)[36] = reinterpret_cast<float (&)[36]>(part);
  const int half = int(tt::chunk_floats(tt::kResGroup) / 2);
  const uint32_t lbo_a = tt::kResGroup * 16, lbo_b = pa * 16;
#pragma unroll 1
  for (int kw = 0; kw < 3; ++kw) {
    wgmma_fence();
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int tap = kw * 3 + kh;
      const float* a = wst + (tap * tt::kKq + 2 * wk) * tt::kResGroup * 4;
      const float* b = planes + (2 * wk * pa + n0 + kh * tile_w + kw) * 4;
      const uint64_t ahi = smem_desc(a, lbo_a, 128), alo = smem_desc(a + half, lbo_a, 128);
      const uint64_t bhi = smem_desc(b, lbo_b, 128);
      const uint64_t blo = smem_desc(b + tt::kKq * pa * 4, lbo_b, 128);
      wgmma_n72(d, alo, bhi, kh > 0);
      wgmma_n72(d, ahi, blo, 1);
      wgmma_n72(d, ahi, bhi, 1);
    }
    wgmma_commit();
    between(kw);
    wgmma_wait0();
#pragma unroll
    for (int n = 0; n < 9; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fence_operand(part[0][n][e]);
        acc[0][n][e] = __fadd_rn(acc[0][n][e], part[0][n][e]);
      }
  }
}

// blockIdx.x = (member * B + frame) * ntiles + tile, blockIdx.y = group of
// output channels (64 in the res stage, 32 in the pool).  On mma.sync the
// warps are WM over the group's rows (MT m16 tiles each) x WN over the
// positions (NT n8 tiles each) x WK over each chunk's k8 steps; on wgmma
// (the res stage) the four warpgroups are 2 over the halo-padded positions
// (72 each) x 2 over the k8 steps.  One conv of a res stage (bias, then the
// residual where res is set), or the feature pool's conv and pool (POOL).
//
// Chunk k's operand lands two iterations ahead and is transformed one
// ahead, in slices between the tap columns of chunk k - 1's products (on
// wgmma while they run), its weights land one ahead; one barrier a chunk
// orders them.
template <int MT, int NT, int WK, bool POOL, bool WGMMA>
__global__ void __launch_bounds__(tt::kThreads, 1)
conv_tiled_tf32_kernel(const __grid_constant__ TiledArgs a, const __grid_constant__ CUtensorMap map) {
  constexpr int G = POOL ? tt::kPoolGroup : tt::kResGroup;
  constexpr int WM = WGMMA ? 1 : G / (16 * MT);
  constexpr int WN = WGMMA ? 2 : tt::kThreads / 32 / (WM * WK);
  static_assert(WGMMA ? (MT == 1 && NT == 9 && WK == 2 && !POOL && 2 * 72 == tt::kResHalo)
                      : WM * 16 * MT == G && WN * NT * 8 == (POOL ? tt::kPoolSlots : tt::kResSlots),
                "a block's rows and positions");
  static_assert(WK == 1 || WK * 8 == tt::kThreads / 32, "a K half is 8 warps");
  extern __shared__ __align__(16) unsigned char smem[];
  const int ti = int(blockIdx.x % (unsigned)a.ntiles);
  const size_t mb = blockIdx.x / (unsigned)a.ntiles;
  const int m = int(mb / a.B), tr = ti / a.ntc, tc = ti - tr * a.ntc;
  TileView v;
  v.oy = POOL ? 2 * tr * a.ph - 1 : tr * a.th;  // the tile's first conv output
  v.ox = POOL ? 2 * tc * a.pw - 1 : tc * a.tw;
  v.rows = a.th + 2;
  v.tile_w = a.tw + 2;
  v.P = v.rows * v.tile_w;
  v.pa = tt::plane_positions(POOL, a.th, a.tw);
  v.x0 = a.vec ? (v.ox - 1) & ~3 : v.ox - 1;
  v.lw = a.vec ? tt::landing_width(a.tw) : v.tile_w;
  v.dx = v.ox - 1 - v.x0;
  const int co0 = blockIdx.y * G, npos = a.th * a.tw;
  const size_t wfl = tt::chunk_floats(G), pfl = (size_t)2 * tt::kKc * v.pa,
               lfl = (size_t)tt::kKc * v.rows * tt::landing_width(a.tw);
  // [2][wfl], then [2][pfl], then [2][lfl], from the first 128-byte boundary (the tensor-map
  // loads' alignment)
  float* const wbuf = reinterpret_cast<float*>(smem + (128 - smem_addr(smem) % 128) % 128);
  float* const pbuf = wbuf + 2 * wfl;
  float* const lbuf = pbuf + 2 * pfl;
  const int nk = tt::cdiv(a.ci, tt::kKc);
  const float* wimg = a.w + (size_t)m * a.w_ms + (size_t)blockIdx.y * nk * wfl;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int wk = WK > 1 ? warp / 8 : 0;  // the K half: the warp's top bit in either layout
  const int wn = WGMMA ? (warp / 4) % 2 : warp % WN, wm = WGMMA ? 0 : (warp / WN) % WM;
  const int row0 = WGMMA ? (warp % 4) * 16 + g : wm * 16 * MT + g;  // this lane's first row
  // position slot s of this warp's n8 tile n, column c2: the tile's output
  // s (mma.sync) or the halo-padded row position s (wgmma)
  auto slot = [&](int n, int c2) { return WGMMA ? wn * 72 + n * 8 + 2 * tig + c2
                                                : (wn * NT + n) * 8 + 2 * tig + c2; };
  auto place = [&](int s, int& ly, int& lx) {  // the slot's tile output; false past the tile
    if (WGMMA) {
      const int q = s + v.tile_w + 1;
      ly = q / v.tile_w - 1;
      lx = q - (ly + 1) * v.tile_w - 1;
      return lx >= 0 && lx < a.tw && ly < a.th;
    }
    ly = s / a.tw;
    lx = s - ly * a.tw;
    return s < npos;
  };
  int b_lane[NT];  // mma.sync: this lane's B position (g's) in each n8 tile
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int p = (wn * NT + n) * 8 + g;
    b_lane[n] = (p < npos ? (p / a.tw) * v.tile_w + p % a.tw : 0) * 4 + tig;
  }
  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = part[mt][n][e] = 0.f;

  // chunk k's weights complete on wbar[k & 1], its tensor-map operand on lbar[k & 1]
  __shared__ __align__(8) uint64_t wbar[2], lbar[2];
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&wbar[i], 1);
      mbar_init(&lbar[i], 1);
    }
    fence_mbar_init();
  }
  __syncthreads();  // no thread tests a barrier before it is initialized
  issue_weights(wbuf, wimg, G, &wbar[0]);
  issue_operand<tt::kKc, tt::kThreads>(a, map, lbuf, &lbar[0], mb, 0, v);
  cp_async_commit();
  if (nk > 1) issue_operand<tt::kKc, tt::kThreads>(a, map, lbuf + lfl, &lbar[1], mb, tt::kKc, v);
  cp_async_commit();
  cp_async_wait_all();
  if (a.vec) mbar_wait(&lbar[0], 0);
  __syncthreads();
  {
    const TransformPlane tp = transform_plane(a, m, 0);
    for (int slice = 0; slice < kSlices; ++slice) transform_slice(a, tp, lbuf, pbuf, v, slice);
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait_all();
    if (WGMMA) fence_proxy_async();
    __syncthreads();  // chunk k's planes are in; chunk k + 1 has landed; every warp is done
                      // with chunk k - 1
    if (k + 1 < nk) issue_weights(wbuf + ((k + 1) & 1) * wfl, wimg + (k + 1) * wfl, G,
                                  &wbar[(k + 1) & 1]);
    if (k + 2 < nk)
      issue_operand<tt::kKc, tt::kThreads>(a, map, lbuf + (k & 1) * lfl, &lbar[k & 1], mb,
                                           (k + 2) * tt::kKc, v);
    cp_async_commit();
    // chunk k + 1's transform, a slice after each tap column of chunk k's products
    const bool more = k + 1 < nk;
    const TransformPlane tp = transform_plane(a, m, more ? (k + 1) * tt::kKc : 0);
    auto between = [&](int kw) {
      if (!more) return;
      if (kw == 0 && a.vec) mbar_wait(&lbar[(k + 1) & 1], ((k + 1) >> 1) & 1);
      transform_slice(a, tp, lbuf + ((k + 1) & 1) * lfl, pbuf + ((k + 1) & 1) * pfl, v, kw);
    };
    const float* wst = wbuf + (k & 1) * wfl;
    const float* planes = pbuf + (k & 1) * pfl;
    mbar_wait(&wbar[k & 1], (k >> 1) & 1);  // chunk k's weights are in
    if constexpr (WGMMA) {
      chunk_products_wgmma(acc, part, wst, planes, wn * 72, wk, v.pa, v.tile_w, between);
    } else {
      const uint32_t* wh = reinterpret_cast<const uint32_t*>(wst) + (wm * 16 * MT + g) * 4 + tig;
      const uint32_t* oph = reinterpret_cast<const uint32_t*>(planes);
      chunk_products_mma<MT, NT, WK>(acc, part, wh, wh + wfl / 2, oph, oph + tt::kKq * v.pa * 4,
                                     b_lane, wk, G, v.pa, v.tile_w, between);
    }
  }
  __syncthreads();  // every warp is done with the buffers, which are overlaid below
  // the K halves' sums: the second half's through shared memory (red), then
  // the first half's warps hold the outputs
  constexpr int kRed = WK > 1 ? 8 * MT * NT * 4 * 32 : 0;
  if (WK > 1) {
    float* const red = reinterpret_cast<float*>(smem) + (warp % 8) * (MT * NT * 4 * 32);
    if (wk > 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[((mt * NT + n) * 4 + e) * 32 + lane] = acc[mt][n][e];
    }
    __syncthreads();
    if (!POOL && wk > 0) return;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][n][e] = __fadd_rn(acc[mt][n][e], red[((mt * NT + n) * 4 + e) * 32 + lane]);
  }
  // this lane's outputs: rows row0 + mt * 16 + h * 8 of the group, slots
  // slot(n, c2)
  float bv[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bv[mt][h] = a.b[(size_t)m * a.b_ms + min(co0 + row0 + mt * 16 + h * 8, a.co - 1)];

  if (POOL) {
    float* const sd = reinterpret_cast<float*>(smem) + kRed;  // the dense map [G][npos]
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        int ly, lx;
        if (wk > 0 || !place(slot(n, c2), ly, lx)) continue;
        const int y = v.oy + ly, x = v.ox + lx;
        const bool inside = y >= 0 && y < a.H && x >= 0 && x < a.W;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            sd[(row0 + mt * 16 + h * 8) * npos + ly * a.tw + lx] =
                inside ? __fadd_rn(acc[mt][n][h * 2 + c2], bv[mt][h]) : -CUDART_INF_F;
      }
    __syncthreads();
    const int valid = min(G, a.co - co0), per = a.ph * a.pw;
    for (int i = threadIdx.x; i < valid * per; i += tt::kThreads) {
      const int k = i / per, rem = i - k * per, ly = rem / a.pw, lx = rem - ly * a.pw;
      const int py = tr * a.ph + ly, px = tc * a.pw + lx;
      if (py >= a.Ho || px >= a.Wo) continue;
      const float* d = sd + k * npos + 2 * ly * a.tw + 2 * lx;
      float u = -CUDART_INF_F;
      for (int dy = 0; dy < 3; ++dy)
        for (int dx = 0; dx < 3; ++dx) u = fmaxf(u, d[dy * a.tw + dx]);
      a.out[((mb * a.co + co0 + k) * a.Ho + py) * a.Wo + px] = u;
    }
    return;
  }
  // the epilogue: every residual load issued before the first is used (res
  // may be out: each value is read, then written, by this thread alone)
  const size_t plane = (size_t)a.H * a.W;
  int goff[NT][2];
  float rv[NT][2][MT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c2 = 0; c2 < 2; ++c2) {
      int ly, lx;
      const bool in_tile = place(slot(n, c2), ly, lx);
      const int y = v.oy + ly, x = v.ox + lx;
      goff[n][c2] = in_tile && y < a.H && x < a.W ? y * a.W + x : -1;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int co = co0 + row0 + mt * 16 + h * 8;
          rv[n][c2][mt][h] = a.res != nullptr && goff[n][c2] >= 0 && co < a.co
                                 ? a.res[(mb * a.co + co) * plane + goff[n][c2]]
                                 : 0.f;
        }
    }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c2 = 0; c2 < 2; ++c2) {
      if (goff[n][c2] < 0) continue;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int co = co0 + row0 + mt * 16 + h * 8;
          if (co >= a.co) continue;
          float u = __fadd_rn(acc[mt][n][h * 2 + c2], bv[mt][h]);
          if (a.res != nullptr) u = __fadd_rn(rv[n][c2][mt][h], u);
          a.out[(mb * a.co + co) * plane + goff[n][c2]] = u;
        }
    }
}

cudaError_t allow_smem(const void* kernel, bool* done, int bytes = kMaxSmem) {
  if (*done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = err == cudaSuccess;
  return err;
}

cudaError_t split_weights(const float* w, float* img, int MJ, int co, int ci, int group,
                          cudaStream_t stream) {
  const long long rows =
      (long long)MJ * tt::cdiv(co, group) * tt::cdiv(ci, tt::kKc) * 9 * tt::kKq * group;
  const long long blocks = (rows + 255) / 256 < 132 * 16 ? (rows + 255) / 256 : 132 * 16;
  split_weights_kernel<<<unsigned(blocks), 256, 0, stream>>>(w, img, MJ, co, ci, group);
  return cudaGetLastError();
}

// The res stage's form (wgmma, m64n72 a warpgroup, K halves) or the feature
// pool's (mma.sync, a warp 2 m16 tiles x 5 n8 tiles, K halves).
template <bool POOL>
cudaError_t launch_tiled(const TiledArgs& a, int M, cudaStream_t stream) {
  void (*kernel)(const TiledArgs, const CUtensorMap);
  if constexpr (POOL)
    kernel = &conv_tiled_tf32_kernel<2, 5, 2, true, false>;
  else
    kernel = &conv_tiled_tf32_kernel<1, 9, 2, false, true>;
  static bool smem_set = false;
  cudaError_t err = allow_smem((const void*)kernel, &smem_set, int(tt::kSmemMax));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)M * a.B * a.ntiles;
  const long long groups = tt::cdiv(a.co, POOL ? tt::kPoolGroup : tt::kResGroup);
  if (blocks > 0x7fffffffLL || groups > 65535) return cudaErrorInvalidValue;
  CUtensorMap map = {};
  if (a.vec && (err = operand_map(a, M, tt::landing_width(a.tw), tt::kKc, &map)) != cudaSuccess)
    return err;
  kernel<<<dim3(unsigned(blocks), unsigned(groups)), tt::kThreads,
           size_t(tt::smem_bytes(POOL, a.th, a.tw)), stream>>>(a, map);
  return cudaGetLastError();
}

}  // namespace

// cluster blocks per (member, frame), each owning `band` image rows, weights
// in groups of wt taps: the plan of fused_resblock.res_stage_tf32_plan,
// refused unless it is res_plan's.
extern "C" int dfd_res_stage_tf32(const float* x, const float* w, const float* b, const float* s,
                                  const float* t, float* out, int M, int B, int C, int H, int W,
                                  int cluster, int band, int wt, void* stream) {
  if (M <= 0 || B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  int pc = 0, pband = 0, pwt = 0;
  if (!res_plan(C, H, W, &pc, &pband, &pwt) || pc != cluster || pband != band || pwt != wt)
    return (int)cudaErrorInvalidValue;
  const bool one = m_tiles(C) == 1;
  void (*kernel)(const float*, const float*, const float*, const float*, const float*, float*, int,
                 int, int, int, int, int) =
      one ? &res_stage_tf32_kernel<1> : &res_stage_tf32_kernel<2>;
  static bool smem_set[2] = {false, false};
  cudaError_t err = allow_smem((const void*)kernel, &smem_set[one ? 0 : 1]);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(M * B * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = res_smem(C, W, band, wt);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, w, b, s, t, out, B, C, H, W, band, wt);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// pb pooled rows a block, weights in groups of wt taps: the plan of
// fused_resblock.feat_pool_tf32_plan, refused unless it is feat_plan's.
extern "C" int dfd_feat_pool_tf32(const float* x, const float* w, const float* b, const float* s,
                                  const float* t, float* out, int M, int B, int ci, int co, int H,
                                  int W, int pb, int wt, void* stream) {
  if (M <= 0 || B <= 0 || ci <= 0 || co <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  int ppb = 0, pwt = 0;
  if (!feat_plan(ci, co, H, W, &ppb, &pwt) || ppb != pb || pwt != wt)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const bool one = m_tiles(co) == 1;
  void (*kernel)(const float*, const float*, const float*, const float*, const float*, float*, int,
                 int, int, int, int, int, int, int, int) =
      one ? &feat_pool_tf32_kernel<1> : &feat_pool_tf32_kernel<2>;
  static bool smem_set[2] = {false, false};
  cudaError_t err = allow_smem((const void*)kernel, &smem_set[one ? 0 : 1]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(M * B, (Ho + pb - 1) / pb);
  kernel<<<grid, kThreads, feat_smem(ci, co, W, pb, wt), (cudaStream_t)stream>>>(
      x, w, b, s, t, out, B, ci, co, H, W, Ho, Wo, pb, wt);
  return (int)cudaGetLastError();
}

// The res stage where no cluster holds a band (or C > 256): the four convs'
// weights split into wimg (M * 4 * tiled_tf32::conv_image_floats(C, C, 64)
// floats; unless split is 0, when wimg already holds w's image), then four
// tiled launches of th x tw outputs a block, each conv's
// output in device memory: scratch <- conv0(x); out <- x + conv1(scratch);
// scratch <- conv2(out); out <- out + conv3(scratch).  The block input is
// never overwritten; a conv that adds its residual to out reads and writes
// each value of it on one thread.  The plan is fused_resblock.
// res_stage_tf32_plan's tiled form, refused unless it is tiled_tf32::
// res_plan's.  wimg and scratch ([M, B, C, H, W]) are the caller's.
extern "C" int dfd_res_stage_tiled_tf32(const float* x, const float* w, const float* b,
                                        const float* s, const float* t, float* wimg,
                                        float* scratch, float* out, int M, int B, int C, int H,
                                        int W, int th, int tw, int split, void* stream) {
  if (M <= 0 || B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  int pth = 0, ptw = 0;
  tt::res_plan(H, W, &pth, &ptw);
  if (pth != th || ptw != tw) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = split ? split_weights(w, wimg, M * 4, C, C, tt::kResGroup, st) : cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  const long long conv = tt::conv_image_floats(C, C, tt::kResGroup);
  TiledArgs a = tiled_args(B, C, C, H, W, th, tw, 0, 0);
  a.w_ms = 4 * conv;
  a.b_ms = a.st_ms = 4 * C;
  a.relu = 1;
  const float* in[4] = {x, scratch, out, scratch};
  float* dst[4] = {scratch, out, scratch, out};
  const float* res[4] = {nullptr, x, nullptr, out};
  for (int j = 0; j < 4; ++j) {
    a.in = in[j];
    a.vec = W % 4 == 0 && aligned16(in[j]);
    a.out = dst[j];
    a.res = res[j];
    a.w = wimg + j * conv;
    a.b = b + (size_t)j * C;
    a.s = s + (size_t)j * C;
    a.t = t + (size_t)j * C;
    err = launch_tiled<false>(a, M, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The feature pool where no band of pooled rows fits a block (or co > 256):
// the weights split into wimg (M * tiled_tf32::conv_image_floats(ci, co,
// 32) floats; unless split is 0), then one tiled launch of ph x pw pooled
// outputs a block, refused unless the plan is tiled_tf32::feat_plan's.
extern "C" int dfd_feat_pool_tiled_tf32(const float* x, const float* w, const float* b,
                                        const float* s, const float* t, float* wimg, float* out,
                                        int M, int B, int ci, int co, int H, int W, int ph, int pw,
                                        int split, void* stream) {
  if (M <= 0 || B <= 0 || ci <= 0 || co <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  int pph = 0, ppw = 0;
  tt::feat_plan(H, W, &pph, &ppw);
  if (pph != ph || ppw != pw) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = split ? split_weights(w, wimg, M, co, ci, tt::kPoolGroup, st) : cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  TiledArgs a = tiled_args(B, ci, co, H, W, 2 * ph + 1, 2 * pw + 1, ph, pw);
  a.in = x;
  a.vec = W % 4 == 0 && aligned16(x);
  a.w = wimg;
  a.b = b;
  a.s = s;
  a.t = t;
  a.out = out;
  a.w_ms = tt::conv_image_floats(ci, co, tt::kPoolGroup);
  a.b_ms = co;
  a.st_ms = ci;
  return (int)launch_tiled<true>(a, M, st);
}
