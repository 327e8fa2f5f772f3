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
// tiled forms' tile) is computed by res_plan, feat_plan, tiled_res_plan and
// tiled_feat_plan here and by fused_resblock.py's *_tf32_plan; an entry point
// refuses a plan that differs from its own (cudaErrorInvalidValue).
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
#include <cuda_runtime.h>
#include <math_constants.h>

#include "conv_tiled.cuh"
#include "ptx.cuh"

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
// on its own as an implicit GEMM over tiles (conv_tiled_tf32_kernel): a block
// takes th x tw conv outputs (whole image rows, or part of one where W is
// wider than a chunk of positions) x a group of up to kTiledGroup output channels,
// and streams K = 9 ci through shared memory in chunks of all nine taps x
// kTiledKc input channels, two chunks in flight (cp.async double buffers).
// The operand tile's halo rows and columns come from device memory.  A
// chunk's operand lands raw and is then transformed in place, x * s + t (and
// ReLU in the res stage), zero off the frame and past ci: the prologue the
// cluster kernels apply as they stage.  The products are group_products',
// 3xTF32 with a fresh sum every k8 step, so the arithmetic is the cluster
// kernels' up to the order of the K chunks.
//
// The res stage is four such launches (dfd_res_stage_tiled_tf32, the passes
// of conv_tiled.cuh's res_stage_passes), the feature pool one
// (dfd_feat_pool_tiled_tf32): a block's tile is ph x pw pooled outputs, whose
// (2 ph + 1) x (2 pw + 1) dense conv outputs it computes, -inf off the frame,
// into shared memory over its buffers, then takes their 3x3 maxima; no block
// needs another's.

constexpr int kTiledKc = 8;   // input channels of a chunk: one k8 step a tap
constexpr int kTiledCs = kTiledKc + 4;       // operand floats a position (4 mod 8: no conflicts)
constexpr int kTiledCsw = 9 * kTiledKc + 4;  // weight floats a row

// Shared bytes of a tiled block: two operand and two weight buffers, or the
// dense map that overlays them in the feature pool, whichever is larger.
size_t tiled_smem(int co, int th, int tw, bool pool) {
  const int rows = a_rows(min(co, kTiledGroup));
  const size_t conv =
      4 * (2 * (size_t)(th + 2) * (tw + 2) * kTiledCs + 2 * (size_t)rows * kTiledCsw);
  const size_t dense = pool ? 4 * (size_t)rows * th * tw : 0;
  return conv > dense ? conv : dense;
}

// The res stage's tile: as many whole rows as one chunk of positions covers
// (part of a row where W is wider), fewer rows, then narrower, while the
// buffers do not fit; then spread evenly over the frame.
void tiled_res_plan(int C, int H, int W, int* th, int* tw) {
  const int cap = chunk_cap(min(C, kTiledGroup));
  int w = min(W, cap), h = max(1, min(H, cap / w));
  while (tiled_smem(C, h, w, false) > (size_t)kMaxSmem) {
    if (h > 1) --h;
    else w = max(1, w / 2);
  }
  const int ntr = (H + h - 1) / h, ntc = (W + w - 1) / w;
  *th = (H + ntr - 1) / ntr;
  *tw = (W + ntc - 1) / ntc;
}

// The feature pool's tile of ph x pw pooled outputs: the widest run of
// pooled columns whose dense columns, three dense rows of them, one chunk
// covers, then as many pooled rows as the chunk takes; fewer while the
// buffers do not fit; then spread evenly.
void tiled_feat_plan(int co, int H, int W, int* ph, int* pw) {
  const int cap = chunk_cap(min(co, kTiledGroup)), Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  int c = min(Wo, max(1, (cap / 3 - 1) / 2));
  int r = min(Ho, max(1, (cap / (2 * c + 1) - 1) / 2));
  while (tiled_smem(co, 2 * r + 1, 2 * c + 1, true) > (size_t)kMaxSmem) {
    if (r > 1) --r;
    else c = max(1, c / 2);
  }
  const int ntr = (Ho + r - 1) / r, ntc = (Wo + c - 1) / c;
  *ph = (Ho + ntr - 1) / ntr;
  *pw = (Wo + ntc - 1) / ntc;
}

// The landed operand chunk as the conv's operand, in place: x * s + t (then
// ReLU if relu) on the frame, zero off it and past ci.
__device__ void transform_tiled(const TiledArgs& a, float* tile, int m, int oy, int ox, int c0) {
  const int tile_w = a.tw + 2, npt = (a.th + 2) * tile_w;
  float sv[kTiledKc], tv[kTiledKc];
#pragma unroll
  for (int c = 0; c < kTiledKc; ++c) {
    const int ch = min(c0 + c, a.ci - 1);
    sv[c] = a.s[(size_t)m * a.st_ms + ch];
    tv[c] = a.t[(size_t)m * a.st_ms + ch];
  }
  for (int p = threadIdx.x; p < npt; p += kThreads) {
    const int r = p / tile_w, x = ox - 1 + (p - r * tile_w), y = oy - 1 + r;
    const bool inside = y >= 0 && y < a.H && x >= 0 && x < a.W;
    float* d = tile + p * kTiledCs;
#pragma unroll
    for (int c = 0; c < kTiledKc; ++c) {
      float v = 0.f;
      if (inside && c0 + c < a.ci) {
        v = affine(d[c], sv[c], tv[c]);
        if (a.relu) v = fmaxf(v, 0.f);
      }
      d[c] = v;
    }
  }
}

// blockIdx.x = (member * B + frame) * ntiles + tile, blockIdx.y = group of
// kTiledGroup output channels.  One conv of a res stage (bias, then the residual
// where res is set), or the feature pool's conv and pool (POOL).
template <int MT, bool POOL>
__global__ void __launch_bounds__(kThreads, 2)
conv_tiled_tf32_kernel(const __grid_constant__ TiledArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kNt = 16 / MT, kE = 4 / MT;
  const int ti = int(blockIdx.x % (unsigned)a.ntiles);
  const size_t mb = blockIdx.x / (unsigned)a.ntiles;
  const int m = int(mb / a.B), tr = ti / a.ntc, tc = ti - tr * a.ntc;
  const int oy = POOL ? 2 * tr * a.ph - 1 : tr * a.th;  // the tile's first conv output
  const int ox = POOL ? 2 * tc * a.pw - 1 : tc * a.tw;
  const int co0 = blockIdx.y * kTiledGroup, cog = min(a.co, kTiledGroup), rows = a_rows(cog);
  const int tile_w = a.tw + 2, npos = a.th * a.tw;
  const size_t tile_elems = (size_t)(a.th + 2) * tile_w * kTiledCs;
  float* const tile0 = reinterpret_cast<float*>(smem);
  float* const tile1 = tile0 + tile_elems;
  float* const wb0 = tile1 + tile_elems;
  float* const wb1 = wb0 + (size_t)rows * kTiledCsw;

  const Warp wp = warp_place<MT>(cog, npos);  // one chunk of positions covers the tile
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int row0 = wp.wm * MT * 16 + g;
  int boff[kNt];
  b_offsets<MT>(boff, wp, 0, npos, a.tw, tile_w, kTiledCs);
  float acc[MT][kNt][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  const int nk = (a.ci + kTiledKc - 1) / kTiledKc;
  issue_tiled<kTiledKc, kThreads>(a, tile0, wb0, mb, m, oy, ox, co0, 0, rows);
  for (int k = 0; k < nk; ++k) {
    float* const tl = k & 1 ? tile1 : tile0;
    cp_async_wait_all();
    __syncthreads();  // chunk k has landed; every warp is done with chunk k - 1
    transform_tiled(a, tl, m, oy, ox, k * kTiledKc);
    __syncthreads();
    if (k + 1 < nk)
      issue_tiled<kTiledKc, kThreads>(a, k & 1 ? tile0 : tile1, k & 1 ? wb0 : wb1, mb, m, oy,
                                      ox, co0, (k + 1) * kTiledKc, rows);
    if (wp.active)
      group_products<MT>(acc, tl, boff, wp.nt, (k & 1 ? wb1 : wb0) + row0 * kTiledCsw + tig,
                         kTiledCsw, kTiledKc, 9, 0, tile_w, kTiledCs);
  }
  float bv[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bv[mt][h] = a.b[(size_t)m * a.b_ms + min(co0 + row0 + mt * 16 + h * 8, a.co - 1)];

  if (POOL) {
    __syncthreads();  // the dense map overwrites the buffers
    float* const sd = reinterpret_cast<float*>(smem);
    if (wp.active) {
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        if (n >= wp.nt) continue;
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int p = (wp.wn * wp.nt + n) * 8 + 2 * tig + c2;
          if (p >= npos) continue;
          const int ly = p / a.tw, y = oy + ly, x = ox + p - ly * a.tw;
          const bool inside = y >= 0 && y < a.H && x >= 0 && x < a.W;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int k = row0 + mt * 16 + h * 8;
              if (k < rows)
                sd[k * npos + p] =
                    inside ? __fadd_rn(acc[mt][n][h * 2 + c2], bv[mt][h]) : -CUDART_INF_F;
            }
        }
      }
    }
    __syncthreads();
    const int valid = min(kTiledGroup, a.co - co0), per = a.ph * a.pw;
    for (int i = threadIdx.x; i < valid * per; i += kThreads) {
      const int k = i / per, rem = i - k * per, ly = rem / a.pw, lx = rem - ly * a.pw;
      const int py = tr * a.ph + ly, px = tc * a.pw + lx;
      if (py >= a.Ho || px >= a.Wo) continue;
      const float* d = sd + k * npos + 2 * ly * a.tw + 2 * lx;
      float v = -CUDART_INF_F;
      for (int dy = 0; dy < 3; ++dy)
        for (int dx = 0; dx < 3; ++dx) v = fmaxf(v, d[dy * a.tw + dx]);
      a.out[((mb * a.co + co0 + k) * a.Ho + py) * a.Wo + px] = v;
    }
    return;
  }
  if (!wp.active) return;
  // the epilogue: kE n8 tiles at a time, every residual load issued before
  // the first is used (res may be out: each value is read, then written, by
  // this thread alone)
  const size_t plane = (size_t)a.H * a.W;
#pragma unroll
  for (int n0 = 0; n0 < kNt; n0 += kE) {
    if (n0 >= wp.nt) break;
    int goff[kE][2];
    float rv[kE][2][MT][2];
#pragma unroll
    for (int u = 0; u < kE; ++u)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int p = (wp.wn * wp.nt + n0 + u) * 8 + 2 * tig + c2;
        const int ly = p / a.tw, y = oy + ly, x = ox + p - ly * a.tw;
        goff[u][c2] = p < npos && y < a.H && x < a.W ? y * a.W + x : -1;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int co = co0 + row0 + mt * 16 + h * 8;
            rv[u][c2][mt][h] = a.res != nullptr && goff[u][c2] >= 0 && co < a.co
                                   ? a.res[(mb * a.co + co) * plane + goff[u][c2]]
                                   : 0.f;
          }
      }
#pragma unroll
    for (int u = 0; u < kE; ++u)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        if (goff[u][c2] < 0) continue;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int co = co0 + row0 + mt * 16 + h * 8;
            if (co >= a.co) continue;
            float v = __fadd_rn(acc[mt][n0 + u][h * 2 + c2], bv[mt][h]);
            if (a.res != nullptr) v = __fadd_rn(rv[u][c2][mt][h], v);
            a.out[(mb * a.co + co) * plane + goff[u][c2]] = v;
          }
      }
  }
}

cudaError_t allow_smem(const void* kernel, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  *done = err == cudaSuccess;
  return err;
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

namespace {

template <bool POOL>
cudaError_t launch_tiled(const TiledArgs& a, int M, cudaStream_t stream) {
  const bool one = m_tiles(min(a.co, kTiledGroup)) == 1;
  void (*kernel)(const TiledArgs) =
      one ? &conv_tiled_tf32_kernel<1, POOL> : &conv_tiled_tf32_kernel<2, POOL>;
  static bool smem_set[2] = {false, false};
  cudaError_t err = allow_smem((const void*)kernel, &smem_set[one ? 0 : 1]);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)M * a.B * a.ntiles;
  const long long groups = (a.co + kTiledGroup - 1) / kTiledGroup;
  if (blocks > 0x7fffffffLL || groups > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(unsigned(blocks), unsigned(groups)), kThreads,
           tiled_smem(a.co, a.th, a.tw, POOL), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The res stage where no cluster holds a band (or C > 256): four tiled
// launches of th x tw outputs a block, the plan of
// fused_resblock.res_stage_tf32_plan's tiled form, refused unless it is
// tiled_res_plan's.  scratch is a [M, B, C, H, W] buffer of the caller's.
extern "C" int dfd_res_stage_tiled_tf32(const float* x, const float* w, const float* b,
                                        const float* s, const float* t, float* scratch, float* out,
                                        int M, int B, int C, int H, int W, int th, int tw,
                                        void* stream) {
  if (M <= 0 || B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  int pth = 0, ptw = 0;
  tiled_res_plan(C, H, W, &pth, &ptw);
  if (pth != th || ptw != tw) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)res_stage_passes(tiled_args(B, C, C, H, W, th, tw, 0, 0), x, w, b, s, t, scratch,
                               out, C, [&](const TiledArgs& a) {
                                 return launch_tiled<false>(a, M, st);
                               });
}

// The feature pool where no band of pooled rows fits a block (or co > 256):
// one tiled launch of ph x pw pooled outputs a block, refused unless the
// plan is tiled_feat_plan's.
extern "C" int dfd_feat_pool_tiled_tf32(const float* x, const float* w, const float* b,
                                        const float* s, const float* t, float* out, int M, int B,
                                        int ci, int co, int H, int W, int ph, int pw,
                                        void* stream) {
  if (M <= 0 || B <= 0 || ci <= 0 || co <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  int pph = 0, ppw = 0;
  tiled_feat_plan(co, H, W, &pph, &ppw);
  if (pph != ph || ppw != pw) return (int)cudaErrorInvalidValue;
  TiledArgs a = tiled_args(B, ci, co, H, W, 2 * ph + 1, 2 * pw + 1, ph, pw);
  a.in = x;
  a.w = w;
  a.b = b;
  a.s = s;
  a.t = t;
  a.out = out;
  a.w_ms = (long long)co * 9 * ci;
  a.b_ms = co;
  a.st_ms = ci;
  a.vec = ci % 4 == 0 && aligned16(w);
  return (int)launch_tiled<true>(a, M, (cudaStream_t)stream);
}
