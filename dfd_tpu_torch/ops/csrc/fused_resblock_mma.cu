// Fused IMPALA torso kernels on Hopper's tensor cores (sm_90a), bf16 operands
// with f32 accumulation, with a plain C interface loaded through ctypes
// (dfd_tpu_torch/ops/fused_resblock.py, which routes compute_dtype=bfloat16
// here and float32 to fused_resblock_tf32.cu).
//
// Replaces the Pallas TPU kernels dfd_tpu/ops/fused_resblock.py::
// fused_res_stage (_stage_kernel) and ::fused_feat_pool (_featpool_kernel)
// with compute_dtype=bfloat16:
//
//   dfd_res_stage_mma:  one stage's two residual blocks.  Four times
//                       h <- conv3x3(relu(h * s_j + t_j)) + b_j, the block
//                       input added back after the second conv of each block.
//   dfd_feat_pool_mma:  one stage's feature block: y = conv3x3(x * s + t) + b,
//                       then the 3x3 max with -inf off the image, kept at the
//                       even positions (maxpool 3x3, stride 2, padding 1).
//
// Weights arrive per member as float32 in the tap order of
// reorder_conv_weight: w[co][kw * 3 * ci + kh * ci + c] holds the OIHW weight
// w[co, c, kh, kw].
//
// What bounds them on an H100: bytes.  At impala_prod_bf16's rollout shapes
// (M = 65 members, one frame each, 64 ch x 32x32 and 128 ch x 16x16) a torso
// call's two res-stage launches read 243 MB, 191 MB of it f32 weights: 72.7 us
// at 3.35 TB/s, against 40 us for its 39.4 GFLOP at the bf16 tensor-core rate.
// The CUDA-core kernels these replaced took 7.975 ms for the same call.
// What this design does about their five limits:
//
// 1. Tensor cores.  Each 3x3 conv is an implicit GEMM, out[co][n] =
//    sum over K = (tap, ci) of W[co][tap, ci] * X[n + shift(tap)][ci], through
//    mma.sync.m16n8k16 (bf16 in, f32 sums).  Both operands come from shared
//    memory by ldmatrix: A is the tap's [co][ci] weight tile, B the
//    halo-padded activation tile, stored position-major ([pos][ci], ci
//    contiguous) so that a tap is only an offset of each row address.  No
//    im2col exists anywhere.
// 2. Enough blocks.  The res stage runs a cluster of 2 blocks (4 or 8 when a
//    band would not fit in shared memory) per (member, frame): 130 blocks on
//    the 132 SMs at B = 1.  The feature pool runs blocks over (member, frame,
//    band of pooled rows, group of 64 output channels): 780 and 260 blocks.
// 3. Reuse.  Each conv's operand is written into shared memory once (the
//    res stage's by the previous conv's epilogue), not restaged for every
//    group of 16 output channels (4 times at 64 ch, 8 times at 128 ch
//    before).  Each weight tap is staged once per chunk of positions: twice
//    a conv at 64 ch x 32x32 (two chunks of 256 positions), once at 128 ch
//    x 16x16.  The weights stream a tap at a time by cp.async into an f32
//    staging buffer while the tensor cores multiply the tap before;
//    cp.async cannot convert, so each tap is then rounded to bf16 in shared
//    memory (one pass, shared memory to shared memory).  Loads that feed
//    registers (the activations, the residual) are issued in batches, and
//    no loop divides per element: with one block of 8 warps an SM, latency
//    is what the scalar code pays.
// 4. Intermediates stay on chip.  A res-stage block holds every channel of
//    its band of image rows, plus one halo row on each side, in two
//    ping-pong bf16 buffers.  Each conv's epilogue writes the next conv's
//    operand, bf16(relu(h * s + t)), straight into the other buffer; the halo
//    rows come from the neighbouring blocks' buffers through distributed
//    shared memory (cluster.map_shared_rank) after a cluster.sync().  Only
//    the f32 block outputs go to device memory (out), and the f32 residual is
//    read back from there by the thread that wrote it.
// 5. The feature pool computes the dense conv outputs behind its band of
//    pooled rows (2 * rows + 1 dense rows) into shared memory, over the
//    buffers the conv is done with, takes the 3x3 maximum in the epilogue
//    and writes only the pooled outputs.  Two of its blocks share an SM.
//
// What still holds them back (tools/torch_mma_variants.py, PERF.md): each
// block pulls every f32 weight tap through one staging buffer, one tap in
// flight, and runs its phases (staging, rounding, barriers, epilogue) one
// after another; the products themselves are a small share.
//
// The cluster kernels take any C, H and W whose band fits a block: K is
// padded with zero channels to a multiple of 16, output channels beyond C are
// masked, bands may be ragged (a block may even own no rows), positions past
// a chunk's end read a valid address and are dropped.  Their launch fails
// (cudaErrorInvalidValue) when a band and a weight tap do not fit in a
// block's 227 KB of shared memory even at clusters of 8 (the res stage's f32
// tap alone outgrows it near 180 channels); fused_resblock.py's plans send
// those shapes to the tiled forms at the end of this file
// (conv_tiled_mma_kernel, on wgmma), which take any C, H and W.
//
// Arithmetic follows the TPU kernel: the affine as two rounded operations
// (__fmul_rn, __fadd_rn, never contracted), then ReLU in the res stage; both
// conv operands rounded to bf16 (__float2bfloat16_rn); products summed in
// f32 by the tensor cores (in another order than the plain version's); the
// bias after the product; the residual after the second conv of each block;
// -inf off the image for the maximum.  Build without --use_fast_math.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "conv_tiled.cuh"
#include "ptx.cuh"
#include "tiled_mma_plan.cuh"

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;       // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWarpM = 64;          // a warp's tile: 64 output channels (4 m16 tiles)
constexpr int kWarpN = 32;          //   x 32 positions (4 n8 tiles): 64 f32 sums a thread
constexpr int kFeatGroup = 64;      // feature pool: output channels per block
constexpr int kMaxSmem = 232448;    // an H100 block's shared memory, bytes

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float affine(float v, float s, float t) {
  return __fadd_rn(__fmul_rn(v, s), t);
}

// Rows y_first .. y_first + nrows - 1 of src [C, H, W] as the conv's
// operand: bf16(src * s + t), then ReLU if relu, into dst's tile row
// y - y_first, column x + 1, channel c; rows off the image are left as they
// are (zero).  A thread takes one position at a time (one division) and
// walks its channels with kBatch loads in flight: with one or two blocks of
// 8 warps an SM, a load waited for one at a time costs its full latency.
__device__ void stage_operand(bf16* dst, const float* __restrict__ src,
                              const float* __restrict__ s, const float* __restrict__ t,
                              bool relu, int C, int H, int W, int y_first, int nrows, int tile_w,
                              int cs) {
  constexpr int kBatch = 16;
  const size_t plane = (size_t)H * W;
  for (int pi = threadIdx.x; pi < nrows * W; pi += kThreads) {
    const int r = pi / W, x = pi - r * W, y = y_first + r;
    if (y < 0 || y >= H) continue;
    const float* col = src + (size_t)y * W + x;
    bf16* d = dst + (r * tile_w + x + 1) * cs;
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
      for (int u = 0; u < kBatch; u += 2) {
        float a0 = affine(v[u], sv[u], tv[u]), a1 = affine(v[u + 1], sv[u + 1], tv[u + 1]);
        if (relu) {
          a0 = fmaxf(a0, 0.f);
          a1 = fmaxf(a1, 0.f);
        }
        if (c0 + u + 1 < C)  // channels pairwise, 4-byte aligned: cs and c0 + u are even
          *reinterpret_cast<__nv_bfloat162*>(d + c0 + u) = __floats2bfloat162_rn(a0, a1);
        else if (c0 + u < C)
          d[c0 + u] = __float2bfloat16_rn(a0);
      }
    }
  }
}

// Zero n bytes (a multiple of 16) of shared memory from p.
__device__ void zero_smem(void* p, size_t n) {
  int4* q = reinterpret_cast<int4*>(p);
  for (size_t i = threadIdx.x; i < n / 16; i += kThreads) q[i] = make_int4(0, 0, 0, 0);
}

// Start copying tap `tap` of `rows` weight rows (f32, row stride ldw, the
// tap's ci values at offset tap * ci) into stage[r * ci + c]: warps over
// rows, lanes over columns.
__device__ void issue_tap(float* stage, const float* w, size_t ldw, int ci, int rows, int tap) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* src = w + (size_t)tap * ci;
  for (int r = warp; r < rows; r += kWarps) {
    if ((ci & 3) == 0) {
      for (int c = lane * 4; c < ci; c += 128) cp_async16(stage + r * ci + c, src + r * ldw + c);
    } else {
      for (int c = lane; c < ci; c += 32) cp_async4(stage + r * ci + c, src + r * ldw + c);
    }
  }
  cp_async_commit();
}

// The staged tap, rounded to bf16, into sw[r][c] (row stride csw), zero in
// the padded rows r >= rows and columns c >= ci.
__device__ void convert_tap(bf16* sw, const float* stage, int ci, int rows, int mp, int kp,
                            int csw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < mp; r += kWarps) {
    if ((ci & 3) == 0) {
      for (int c = lane * 4; c < kp; c += 128) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < rows && c < ci) v = *reinterpret_cast<const float4*>(stage + r * ci + c);
        __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
        uint2 u;
        u.x = *reinterpret_cast<uint32_t*>(&lo);
        u.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(sw + r * csw + c) = u;
      }
    } else {
      for (int c = lane; c < kp; c += 32)
        sw[r * csw + c] = __float2bfloat16_rn(r < rows && c < ci ? stage[r * ci + c] : 0.f);
    }
  }
}

// Where this thread's two ldmatrix.x4 row addresses for B start in the tile
// (tile row stride tile_w positions, cs bf16 a position): positions
// p0 + wn * 32 + [0, 32), dense over rows of W; past npos they read
// position 0 and the sums are dropped.
__device__ __forceinline__ void b_offsets(int off[2], int p0, int wn, int npos, int W,
                                          int tile_w, int cs) {
  const int lane = threadIdx.x & 31;
  for (int np = 0; np < 2; ++np) {
    int p = p0 + wn * kWarpN + np * 16 + ((lane >> 4) << 3) + (lane & 7);
    if (p >= npos) p = 0;
    off[np] = ((p / W) * tile_w + p % W) * cs + ((lane >> 3) & 1) * 8;
  }
}

// One chunk of a 3x3 conv as an implicit GEMM.  For this warp's 64 rows
// (m16 tiles below mtiles) and 32 positions, acc[mt][nt] holds
// sum over taps and ci of W[row][tap, ci] * tile[pos + shift(tap)][ci].
// w points at the block's first weight row; rows of them are valid, mp
// (a multiple of 16) are multiplied.  Every thread of the block calls this.
__device__ void conv_chunk(float (&acc)[4][4][4], const bf16* tile, int tile_w, int cs, int kp,
                           const float* w, size_t ldw, int ci, int rows, int mp, bf16* sw,
                           float* stage, const int boff[2], int wm, int mtiles) {
  const int lane = threadIdx.x & 31;
  const int csw = kp + 8;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  __syncthreads();  // sw and stage are free (the previous chunk's taps are consumed)
  issue_tap(stage, w, ldw, ci, rows, 0);
  cp_async_wait_all();
  __syncthreads();
  convert_tap(sw, stage, ci, rows, mp, kp, csw);
  __syncthreads();
  issue_tap(stage, w, ldw, ci, rows, 1);
  for (int tap = 0; tap < 9; ++tap) {
    if (mtiles > 0) {
      const int shift = ((tap % 3) * tile_w + tap / 3) * cs;  // tap = kw * 3 + kh
      const bf16* bp0 = tile + boff[0] + shift;
      const bf16* bp1 = tile + boff[1] + shift;
      const bf16* ap = sw + (wm * kWarpM + (lane & 15)) * csw + (lane >> 4) * 8;
      for (int k0 = 0; k0 < kp; k0 += 16) {
        uint32_t a[4][4], b[2][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          if (mt < mtiles) ldsm_x4(a[mt], ap + mt * 16 * csw + k0);
        ldsm_x4(b[0], bp0 + k0);
        ldsm_x4(b[1], bp1 + k0);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt < mtiles) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the tap is consumed and the next one has landed
    if (tap + 1 < 9) {
      convert_tap(sw, stage, ci, rows, mp, kp, csw);
      __syncthreads();
      if (tap + 2 < 9) issue_tap(stage, w, ldw, ci, rows, tap + 2);
    }
  }
}

// The warp grid of a block whose output rows pad to mp: warps_m x warps_n
// warps of 64 x 32, warps_n * 32 positions a chunk.
struct WarpGrid {
  int wm, wn, mtiles, nc;
};

__device__ __forceinline__ WarpGrid warp_grid(int mp) {
  const int warp = threadIdx.x >> 5;
  const int warps_m = (mp + kWarpM - 1) / kWarpM, warps_n = kWarps / warps_m;
  WarpGrid g;
  g.wm = warp / warps_n;
  g.wn = warp % warps_n;
  const int left = (mp - g.wm * kWarpM) / 16;
  g.mtiles = g.wm < warps_m ? (left < 4 ? left : 4) : 0;
  g.nc = warps_n * kWarpN;
  return g;
}

size_t res_smem(int C, int W, int band) {
  const int kp = pad16(C), cs = kp + 8;
  return 2 * (size_t)(band + 2) * (W + 2) * cs * 2 + (size_t)kp * cs * 2 + (size_t)kp * C * 4;
}

// The feature pool's dense map [mp][dr][W] f32 overlays the operand, weight
// and staging buffers when the block has one chunk of positions (the conv
// is done with them before the epilogue writes it), else follows them.
__host__ __device__ __forceinline__ bool dense_overlays(int W, int pb) {
  return (2 * pb + 1) * W <= kWarps * kWarpN;
}

size_t feat_smem(int ci, int co, int W, int pb) {
  const int kp = pad16(ci), cs = kp + 8, mp = pad16(co) < kFeatGroup ? pad16(co) : kFeatGroup;
  const int dr = 2 * pb + 1;
  const size_t conv =
      (size_t)(dr + 2) * (W + 2) * cs * 2 + (size_t)mp * cs * 2 + (size_t)mp * ci * 4;
  const size_t dense = (size_t)mp * dr * W * 4;
  return dense_overlays(W, pb) ? (conv > dense ? conv : dense) : conv + dense;
}

// A cluster of `cluster` blocks per (member, frame): blockIdx.x =
// (member * B + frame) * cluster + rank; rank r owns image rows
// [r * band, min(H, (r + 1) * band)).
__global__ void __launch_bounds__(kThreads, 1)
res_stage_mma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, const float* __restrict__ s,
                     const float* __restrict__ t, float* out, int B, int C, int H, int W,
                     int band) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int mb = blockIdx.x / (int)cluster.num_blocks(), m = mb / B;
  const int y0 = rank * band;
  const int rows = max(0, min(band, H - y0));
  const int kp = pad16(C), cs = kp + 8, tile_w = W + 2;
  const size_t row_elems = (size_t)tile_w * cs;
  const size_t tile_elems = (band + 2) * row_elems;
  bf16* const buf0 = reinterpret_cast<bf16*>(smem);  // the two ping-pong operand buffers
  bf16* const buf1 = buf0 + tile_elems;
  bf16* sw = buf1 + tile_elems;
  float* stage = reinterpret_cast<float*>(sw + (size_t)kp * cs);
  const size_t img = (size_t)C * H * W;
  const float* xin = x + mb * img;
  float* o = out + mb * img;

  // conv 0's operand, halo rows included, straight from x; zeros elsewhere
  zero_smem(smem, 2 * tile_elems * sizeof(bf16));
  __syncthreads();
  if (rows > 0)
    stage_operand(buf0, xin, s + (size_t)m * 4 * C, t + (size_t)m * 4 * C, true, C, H, W, y0 - 1,
                  rows + 2, tile_w, cs);
  __syncthreads();

  const WarpGrid g = warp_grid(kp);
  const int lane = threadIdx.x & 31, gr = lane >> 2, gc = lane & 3;
  const int npos = rows * W;
  const size_t plane = (size_t)H * W;
  for (int j = 0; j < 4; ++j) {  // conv j of the stage: block j / 2, conv j % 2
    const bf16* cur = j & 1 ? buf1 : buf0;
    bf16* nxt = j & 1 ? buf0 : buf1;
    const size_t mj = (size_t)m * 4 + j;
    const float* bj = b + mj * C;
    const float* sn = s + (mj + 1) * C;  // the next conv's affine (j < 3)
    const float* tn = t + (mj + 1) * C;
    for (int p0 = 0; p0 < npos; p0 += g.nc) {
      int boff[2];
      b_offsets(boff, p0, g.wn, npos, W, tile_w, cs);
      float acc[4][4][4];
      conv_chunk(acc, cur, tile_w, cs, kp, w + mj * C * 9 * C, (size_t)9 * C, C, C, kp, sw, stage,
                 boff, g.wm, g.mtiles);
      // this thread's 8 positions of the chunk (n8 tile nt, column e & 1):
      // the operand's offset in the tile (-1 past npos) and the output's in
      // a channel plane, one division each
      int toff[8], goff[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int p = p0 + g.wn * kWarpN + (q >> 1) * 8 + 2 * gc + (q & 1);
        const int ly = p / W, xx = p - ly * W;
        toff[q] = p < npos ? ((ly + 1) * tile_w + xx + 1) * cs : -1;
        goff[q] = (y0 + ly) * W + xx;
      }
      // the residual (j = 1: the block input, j = 3: block 0's output, which
      // this thread wrote), every load issued before the first is used
      float res[4][4][4];
      if (j & 1) {
        const float* rsrc = j == 1 ? xin : o;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int co = g.wm * kWarpM + mt * 16 + gr + (e >> 1) * 8, q = nt * 2 + (e & 1);
              const bool in = mt < g.mtiles && co < C && toff[q] >= 0;
              res[mt][nt][e] = in ? rsrc[co * plane + goff[q]] : 0.f;
            }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= g.mtiles) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int co = g.wm * kWarpM + mt * 16 + gr + (e >> 1) * 8, q = nt * 2 + (e & 1);
            if (co >= C || toff[q] < 0) continue;
            float v = __fadd_rn(acc[mt][nt][e], bj[co]);
            if (j & 1) {
              v = __fadd_rn(res[mt][nt][e], v);
              o[co * plane + goff[q]] = v;
            }
            if (j < 3) {
              const float a = fmaxf(affine(v, sn[co], tn[co]), 0.f);
              nxt[toff[q] + co] = __float2bfloat16_rn(a);
            }
          }
        }
      }
    }
    if (j < 3) {
      cluster.sync();  // every block's next operand is written
      if (rows > 0) {
        const int n16 = (int)(row_elems * sizeof(bf16) / 16);
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

// blockIdx.x = member * B + frame, blockIdx.y = band of pb pooled rows,
// blockIdx.z = group of kFeatGroup output channels.  Two blocks an SM, so
// that one block's staging and pooling overlap the other's products.
__global__ void __launch_bounds__(kThreads, 2)
feat_pool_mma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, const float* __restrict__ s,
                     const float* __restrict__ t, float* __restrict__ out, int B, int ci,
                     int co_n, int H, int W, int Ho, int Wo, int pb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int mb = blockIdx.x, m = mb / B;
  const int py0 = blockIdx.y * pb, prow = min(pb, Ho - py0);
  const int co0 = blockIdx.z * kFeatGroup, rows = min(kFeatGroup, co_n - co0);
  const int kp = pad16(ci), cs = kp + 8, tile_w = W + 2;
  const int mp = min(kFeatGroup, pad16(co_n));
  const int dr = 2 * prow + 1, dy0 = 2 * py0 - 1;  // dense rows dy0 .. dy0 + dr - 1
  const int dr_max = 2 * pb + 1;
  const size_t tile_elems = (size_t)(dr_max + 2) * tile_w * cs;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  bf16* sw = tile + tile_elems;
  float* stage = reinterpret_cast<float*>(sw + (size_t)mp * cs);
  float* sd = dense_overlays(W, pb) ? reinterpret_cast<float*>(smem) : stage + (size_t)mp * ci;

  // the operand: tile row r holds image row dy0 - 1 + r
  zero_smem(tile, tile_elems * sizeof(bf16));
  __syncthreads();
  const float* xin = x + (size_t)mb * ci * H * W;
  stage_operand(tile, xin, s + (size_t)m * ci, t + (size_t)m * ci, false, ci, H, W, dy0 - 1,
                dr + 2, tile_w, cs);
  __syncthreads();

  const WarpGrid g = warp_grid(mp);
  const int lane = threadIdx.x & 31, gr = lane >> 2, gc = lane & 3;
  const int npos = dr * W;
  const float* wg = w + ((size_t)m * co_n + co0) * 9 * ci;
  const float* bm = b + (size_t)m * co_n + co0;
  for (int p0 = 0; p0 < npos; p0 += g.nc) {
    int boff[2];
    b_offsets(boff, p0, g.wn, npos, W, tile_w, cs);
    float acc[4][4][4];
    conv_chunk(acc, tile, tile_w, cs, kp, wg, (size_t)9 * ci, ci, rows, mp, sw, stage, boff, g.wm,
               g.mtiles);
    // this thread's 8 positions of the chunk: -1 past npos, -2 off the image
    int pos[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int p = p0 + g.wn * kWarpN + (q >> 1) * 8 + 2 * gc + (q & 1);
      const int y = dy0 + p / W;
      pos[q] = p >= npos ? -1 : (y >= 0 && y < H ? p : -2 - p);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt >= g.mtiles) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = g.wm * kWarpM + mt * 16 + gr + (e >> 1) * 8, q = nt * 2 + (e & 1);
          if (k >= rows || pos[q] == -1) continue;
          sd[k * npos + (pos[q] >= 0 ? pos[q] : -2 - pos[q])] =
              pos[q] >= 0 ? __fadd_rn(acc[mt][nt][e], bm[k]) : -CUDART_INF_F;
        }
      }
    }
  }
  __syncthreads();
  // the pooled outputs
  for (int i = threadIdx.x; i < rows * prow * Wo; i += kThreads) {
    const int k = i / (prow * Wo), rem = i - k * prow * Wo, ly = rem / Wo, px = rem - ly * Wo;
    const float* d = sd + k * npos + 2 * ly * W;
    float v = -CUDART_INF_F;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = 2 * px + dx;
        if (xx >= 0 && xx < W) v = fmaxf(v, d[dy * W + xx]);
      }
    }
    out[(((size_t)mb * co_n + co0 + k) * Ho + py0 + ly) * Wo + px] = v;
  }
}

// -- the tiled forms ---------------------------------------------------------------
//
// Where no cluster of at most 8 blocks holds a frame's band with all its
// channels beside a weight tap, each conv runs on its own as an implicit
// GEMM over tiles (conv_tiled_mma_kernel; the plan and the weight image in
// tiled_mma_plan.cuh).  A block of 4 warpgroups, one an SM, takes a tile of
// conv outputs x one group of 64 output channels, or both groups of a conv
// with more than 64 (the two pairs of warpgroups read one operand tile):
// res 64 @ 96x96 tiles of 6 x 96 outputs, res 128 @ 48x48 6 x 48 x 128
// channels, the 192x192 feature pool the 17 x 15 dense outputs behind 8 x 7
// pooled ones x 128 channels.  K = 9 ci streams in chunks of 16 input
// channels x all nine taps, one barrier a chunk.
//
// What held the earlier tiled form back (PERF.md section 6), and what this
// design does about it (measured by tools/torch_mma_variants.py --source
// tiled_mma [--stamps]):
// - Thin tiles.  Tiles of 2 x 96 outputs read and rounded the input 2.04
//   times; the pool computed 6.1 dense outputs a pooled one.  Now each
//   warpgroup's products cover 152 positions of the tile's halo-padded rows
//   (a tile row and its two halo columns, so a tap is a shift of the
//   operand's start), 608 a block: the halo costs 1.36x at 96x96, 1.39x at
//   48x48, and the pool computes 4.55 dense outputs a pooled one.
// - Copies.  The operand came by one 4-byte cp.async a (position, channel)
//   and the f32 weights by cp.async, filling the SM's request queue.  Now
//   each chunk's weights come by one bulk copy from a bf16 image, rounded
//   once a weight tensor by round_weights_kernel in the ring's layout
//   (tiled_mma::image_offset; zero past ci and co), and its operand by
//   tensor-map loads (zero outside the frame), all on mbarriers; only f32
//   frames with W % 4 != 0 copy the operand by 4-byte cp.async.
// - The transform.  The landed tile became bf16 between two barriers while
//   the tensor cores idled.  An f32 operand (the pool, the res stage's first
//   conv) is still transformed (x * s + t, ReLU in the res stage, zero off
//   the frame and past ci) into planes of 8 channels, 16 bytes a position
//   (the core-matrix layout), once the chunk before has its products
//   issued.  The res stage's convs 1-3 need none: each conv's
//   epilogue writes the next one's operand, bf16(relu(v * s + t)), as bf16
//   planes in device memory, which land by tensor map straight into the
//   ring (four slots), and the f32 scratch between the convs is gone.
// - Products.  mma.sync, each warp loading the whole weight chunk by
//   ldmatrix for every tap.  Now wgmma m64n152k16 (bf16, f32 sums), A the
//   weights and B the planes, both from shared memory by descriptor: nine a
//   chunk a warpgroup; on planar operands chunk k's are issued before chunk
//   k - 1's are waited for.  The sum is carried in the accumulators across
//   all of K, as the cluster kernels' mma.sync carries it.
// - The epilogue.  Each thread stored its scattered sums.  Now the sums and
//   bias go to shared memory over the ring, then leave in units of 8
//   channels x 4 positions of a tile row: the residual and the f32 outputs
//   as float4s, the next conv's planes as 16 bytes a position.
//
// The res stage is four launches after the weights' rounding
// (dfd_res_stage_tiled_mma), the feature pool one (dfd_feat_pool_tiled_mma):
// its dense outputs, -inf off the frame, go to shared memory over the
// buffers, then their 3x3 maxima to device memory; no block needs another's.

namespace tmma = tiled_mma;

constexpr int kAcc = tmma::kN / 2;  // f32 sums a thread of a warpgroup holds

// Eight values as bf16 (round to nearest), 16 bytes.
__device__ __forceinline__ uint4 pack_bf16x8(const float (&u)[8]) {
  uint4 o;
  uint32_t* w = &o.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(u[2 * e], u[2 * e + 1]);
    w[e] = *reinterpret_cast<const uint32_t*>(&h2);
  }
  return o;
}

// Weights w (member m's conv j [co][9 ci] in tap order at
// w + (m * J + j) * co * 9 ci) rounded to bf16 into img, conv (m, j)'s image
// at img + (m * J + j) * conv_image_elems: one thread a core-matrix row (8
// channels of one tap of one output channel, read as two float4s where
// ci % 4 == 0), neighbouring threads on neighbouring rows, so that the image
// is written 16 bytes a thread in order.
__global__ void __launch_bounds__(256)
round_weights_kernel(const float* __restrict__ w, bf16* __restrict__ img, int MJ, int co, int ci) {
  const int groups = tmma::image_groups(co), nk = tmma::cdiv(ci, tmma::kKc);
  const long long conv = tmma::conv_image_elems(ci, co);
  const long long total = (long long)MJ * nk * groups * 9 * tmma::kPlanes * tmma::kGroup;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    long long r = i;
    const int row = int(r % tmma::kGroup);
    r /= tmma::kGroup;
    const int q = int(r % tmma::kPlanes);
    r /= tmma::kPlanes;
    const int tap = int(r % 9);
    r /= 9;
    const int g = int(r % groups);
    r /= groups;
    const int k = int(r % nk);
    const long long mj = r / nk;
    const int o = g * tmma::kGroup + row, c0 = k * tmma::kKc + 8 * q;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (o < co && c0 < ci) {
      const float* src = w + (mj * co + o) * 9 * ci + (size_t)tap * ci + c0;
      if ((ci & 3) == 0) {  // a float4 lies wholly below ci or past it
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (c0 + 4 * h >= ci) break;
          const float4 f = __ldg(reinterpret_cast<const float4*>(src) + h);
          v[4 * h] = f.x;
          v[4 * h + 1] = f.y;
          v[4 * h + 2] = f.z;
          v[4 * h + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = c0 + e < ci ? src[e] : 0.f;
      }
    }
    *reinterpret_cast<uint4*>(img + mj * conv + tmma::image_offset(ci, co, o, tap, c0)) =
        pack_bf16x8(v);
  }
}

// The landed chunk c0 .. c0 + 15 as the conv's operand: each value r becomes
// bf16(r * s + t, then ReLU if relu) on the frame, zero off it, past ci and
// past the halo tile, into the planes ([kPlanes][pa][8]).  Half the threads
// take each plane (8 channels, their s and t in registers), a position at a
// time: 8 loads from the landing tile, one 16-byte store.
__device__ __forceinline__ void transform_chunk(const TiledArgs& a, int m, int c0,
                                                const float* land, bf16* planes,
                                                const TileView& v) {
  constexpr int kStride = tmma::kThreads / tmma::kPlanes;
  const int q = threadIdx.x / kStride, cq = c0 + 8 * q, nv = min(8, a.ci - cq);
  float sv[8], tv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sv[e] = e < nv ? __ldg(a.s + (size_t)m * a.st_ms + cq + e) : 0.f;
    tv[e] = e < nv ? __ldg(a.t + (size_t)m * a.st_ms + cq + e) : 0.f;
  }
  const int cstride = v.rows * v.lw;
  const float* lq = land + 8 * q * cstride + v.dx;
  uint4* pq = reinterpret_cast<uint4*>(planes) + (size_t)q * v.pa;
  for (int p = threadIdx.x - q * kStride; p < v.pa; p += kStride) {
    const int r = p / v.tile_w, col = p - r * v.tile_w;
    const int y = v.oy - 1 + r, x = v.ox - 1 + col;
    const bool inside = p < v.P && y >= 0 && y < a.H && x >= 0 && x < a.W;
    const float* src = lq + r * v.lw + col;
    float u[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      u[e] = 0.f;
      if (inside && e < nv) {
        u[e] = affine(src[e * cstride], sv[e], tv[e]);
        if (a.relu) u[e] = fmaxf(u[e], 0.f);
      }
    }
    pq[p] = pack_bf16x8(u);
  }
}

// One thread starts the bulk copy of a chunk's weights (the block's groups)
// into wst, completing on bar.
__device__ __forceinline__ void issue_weights(bf16* wst, const bf16* src, uint32_t bytes,
                                              uint64_t* bar) {
  if (threadIdx.x != 0) return;
  fence_proxy_async();
  bulk_copy(wst, src, bytes, bar);
}

// One thread starts the tensor-map loads of a planar chunk k (the operand's
// planes 2k and 2k + 1 of this frame, each a halo tile of 16-byte positions)
// into planes [2][pa][8], completing on bar: zero off the frame.
__device__ __forceinline__ void issue_planes(const CUtensorMap& map, bf16* planes, uint64_t* bar,
                                             const TileView& v, int plane0) {
  if (threadIdx.x != 0) return;
  mbar_expect_tx(bar, uint32_t(2 * 16 * v.P));
  for (int q = 0; q < tmma::kPlanes; ++q)
    tma_load_4d(planes + (size_t)q * v.pa * 8, &map, 0, v.ox - 1, v.oy - 1, plane0 + q, bar);
}

// One chunk's products, issued and committed: the warpgroup's 64 rows (wst:
// its group's [9 taps][2 planes][64 rows][8]) x 152 halo-padded positions
// from n0 (the planes, positions 16 bytes apart, so a tap is a shift of B's
// start), one k16 step a tap, added to acc.  The caller waits for them.
__device__ __forceinline__ void issue_products(float (&acc)[kAcc], const bf16* wst,
                                               const bf16* planes, int n0, int pa, int tile_w) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {  // tap = kw * 3 + kh
    const int kw = tap / 3, kh = tap % 3;
    const uint64_t ad =
        smem_desc(wst + tap * tmma::kPlanes * tmma::kGroup * 8, tmma::kGroup * 16, 128);
    const uint64_t bd = smem_desc(planes + (n0 + kh * tile_w + kw) * 8, uint32_t(pa) * 16, 128);
    wgmma_bf16_n152(acc, ad, bd, 1);
  }
  wgmma_commit();
}

// N (1 or 4) floats at p.
template <int N>
__device__ __forceinline__ void load_n(float (&d)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    d[0] = f.x;
    d[1] = f.y;
    d[2] = f.z;
    d[3] = f.w;
  } else {
    d[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&d)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  else
    *p = d[0];
}

// The res stage's epilogue from the block's sums in shared memory (sd, rows
// of sstride; snt the next conv's s then t for the block's rows): units of 8
// channels x N neighbouring positions of a tile row (see the kernel).
template <int N>
__device__ __forceinline__ void res_epilogue(const TiledArgs& a, const float* sd,
                                             const float* snt, int rows, int sstride, int valid,
                                             size_t mb, int co0, int oy, int ox) {
  const size_t plane = (size_t)a.H * a.W;
  const int qw = a.tw / N, per = a.th * qw;
  const int units = (valid + 7) / 8 * per, planes_out = tmma::cdiv(a.co, 8);
  for (int u = threadIdx.x; u < units; u += tmma::kThreads) {
    const int q = u / per, rem = u - q * per, ly = rem / qw, lx = (rem - ly * qw) * N;
    const int y = oy + ly, x = ox + lx;
    if (y >= a.H || x >= a.W) continue;  // (N == 4: x < W, both multiples of 4, so x + 3 < W)
    const size_t pos = (size_t)y * a.W + x;
    const int spos = ly * a.tw + lx;
    float t[8][N];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = min(8 * q + e, valid - 1);
      load_n<N>(t[e], sd + r * sstride + spos);
      if (a.res != nullptr) {
        float rv[N];
        load_n<N>(rv, a.res + (mb * a.co + co0 + r) * plane + pos);
#pragma unroll
        for (int i = 0; i < N; ++i) t[e][i] = __fadd_rn(rv[i], t[e][i]);
      }
    }
    if (a.out != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (8 * q + e < valid)
          store_n<N>(a.out + (mb * a.co + co0 + 8 * q + e) * plane + pos, t[e]);
    }
    if (a.pout != nullptr) {
      uint4* const dst =
          reinterpret_cast<uint4*>(a.pout) + (mb * planes_out + co0 / 8 + q) * plane + pos;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int r = 8 * q + e;
          f[e] = r < valid ? fmaxf(affine(t[e][i], snt[r], snt[rows + r]), 0.f) : 0.f;
        }
        dst[i] = pack_bf16x8(f);
      }
    }
  }
}

// blockIdx.x = (member * B + frame) * ntiles + tile, blockIdx.y = the
// block's groups of 64 output channels (two where co > 64).  Warpgroup wg
// multiplies group wg / spans of the block over halo-padded positions
// (wg % spans) * 152 .. + 151, spans = 4 / groups.  One conv of a res stage
// (bias, then the residual where res is set; the f32 outputs where out is
// set, the next conv's operand as bf16 planes where pout is), or the feature
// pool's conv and pool (POOL).
//
// The operand is f32 (PLANAR false: a.in, landed by tensor map, then
// transformed) or the previous conv's bf16 planes (PLANAR: landed by tensor
// map straight into the plane slots).  Chunk k's operand and weights land S
// iterations ahead in ring slot k % S.  f32: the operand is transformed one
// iteration ahead into plane slot k % 2, after chunk k - 1's products are
// issued (an issue waits while the tensor cores' queue is full, so the
// transform overlaps only their last ones); planar: chunk k's products are
// issued before chunk k - 1's are waited for.  One barrier a chunk orders
// them.
template <bool POOL, int S, bool PLANAR>
__global__ void __launch_bounds__(tmma::kThreads, 1)
conv_tiled_mma_kernel(const __grid_constant__ TiledArgs a, const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gb = tmma::block_groups(a.co), spans = 4 / gb;
  const int ti = int(blockIdx.x % (unsigned)a.ntiles);
  const size_t mb = blockIdx.x / (unsigned)a.ntiles;
  const int m = int(mb / a.B), tr = ti / a.ntc, tc = ti - tr * a.ntc;
  TileView v;
  v.oy = POOL ? 2 * tr * a.ph - 1 : tr * a.th;  // the tile's first conv output
  v.ox = POOL ? 2 * tc * a.pw - 1 : tc * a.tw;
  v.rows = a.th + 2;
  v.tile_w = a.tw + 2;
  v.P = v.rows * v.tile_w;
  v.pa = tmma::plane_positions(a.co, a.th, a.tw);
  v.x0 = a.vec ? (v.ox - 1) & ~3 : v.ox - 1;
  v.lw = a.vec ? tmma::landing_width(a.tw) : v.tile_w;
  v.dx = v.ox - 1 - v.x0;
  const int co0 = blockIdx.y * gb * tmma::kGroup, npos = a.th * a.tw;
  const size_t wel = gb * tmma::chunk_elems(), pel = (size_t)tmma::kKc * v.pa,
               lfl = (size_t)tmma::kKc * v.rows * tmma::landing_width(a.tw);
  // [S][wel] bf16, then [PLANAR ? S : 2][pel] bf16, then (f32) [S][lfl] f32, from the first
  // 128-byte boundary (the tensor-map loads' alignment)
  bf16* const wbuf = reinterpret_cast<bf16*>(smem + (128 - smem_addr(smem) % 128) % 128);
  bf16* const pbuf = wbuf + S * wel;
  float* const lbuf = reinterpret_cast<float*>(pbuf + (PLANAR ? S : 2) * pel);
  const int nk = tmma::cdiv(a.ci, tmma::kKc);
  // a chunk's groups of the image
  const size_t kstride = (size_t)tmma::image_groups(a.co) * tmma::chunk_elems();
  const bf16* const wimg =
      reinterpret_cast<const bf16*>(a.w) + (size_t)m * a.w_ms + (size_t)blockIdx.y * wel;
  const int plane0 = int(mb) * tmma::cdiv(a.ci, 8);  // the frame's first operand plane

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int gsel = wg / spans, n0 = (wg % spans) * tmma::kN;
  const int row0 = gsel * tmma::kGroup + (warp & 3) * 16 + (lane >> 2);  // this lane's first row
  const int tig = lane & 3;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // chunk k's weights complete on wbar[k % S], its tensor-map operand on lbar[k % S]
  __shared__ __align__(8) uint64_t wbar[S], lbar[S];
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&wbar[i], 1);
      mbar_init(&lbar[i], 1);
    }
    fence_mbar_init();
  }
  __syncthreads();  // no thread tests a barrier before it is initialized
  for (int i = 0; i < S && i < nk; ++i) {
    issue_weights(wbuf + i * wel, wimg + i * kstride, uint32_t(wel * 2), &wbar[i]);
    if (PLANAR)
      issue_planes(map, pbuf + i * pel, &lbar[i], v, plane0 + 2 * i);
    else
      issue_operand<tmma::kKc, tmma::kThreads>(a, map, lbuf + i * lfl, &lbar[i], mb,
                                               i * tmma::kKc, v);
  }
  if (PLANAR) {
    for (int k = 0; k < nk; ++k) {
      const int slot = k % S;
      mbar_wait(&lbar[slot], (k / S) & 1);  // chunk k's planes and weights are in
      mbar_wait(&wbar[slot], (k / S) & 1);
      issue_products(acc, wbuf + slot * wel + gsel * tmma::chunk_elems(), pbuf + slot * pel, n0,
                     v.pa, v.tile_w);
      wgmma_wait1();  // chunk k - 1's products are done here
#pragma unroll
      for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
      __syncthreads();  // ... and in every warpgroup: its slot takes chunk k - 1 + S
      const int j = k - 1 + S;
      if (k > 0 && j < nk) {
        issue_weights(wbuf + (j % S) * wel, wimg + j * kstride, uint32_t(wel * 2), &wbar[j % S]);
        issue_planes(map, pbuf + (j % S) * pel, &lbar[j % S], v, plane0 + 2 * j);
      }
    }
  } else {
    cp_async_commit();
    cp_async_wait_all();
    if (a.vec) mbar_wait(&lbar[0], 0);
    __syncthreads();
    transform_chunk(a, m, 0, lbuf, pbuf, v);
    for (int k = 0; k < nk; ++k) {
      const int slot = k % S;
      cp_async_wait_all();
      fence_proxy_async();
      __syncthreads();  // chunk k's planes are in; every warpgroup is done with chunk k - 1's
                        // products; landing slot k % S is transformed
      if (k > 0 && k - 1 + S < nk) {
        const int j = k - 1 + S;
        issue_weights(wbuf + (j % S) * wel, wimg + j * kstride, uint32_t(wel * 2), &wbar[j % S]);
      }
      if (k + S < nk)
        issue_operand<tmma::kKc, tmma::kThreads>(a, map, lbuf + slot * lfl, &lbar[slot], mb,
                                                 (k + S) * tmma::kKc, v);
      cp_async_commit();
      mbar_wait(&wbar[slot], (k / S) & 1);  // chunk k's weights are in
      issue_products(acc, wbuf + slot * wel + gsel * tmma::chunk_elems(), pbuf + (k & 1) * pel,
                     n0, v.pa, v.tile_w);
      if (k + 1 < nk) {  // chunk k + 1's transform while chunk k's products run
        const int next = (k + 1) % S;
        if (a.vec) mbar_wait(&lbar[next], ((k + 1) / S) & 1);
        transform_chunk(a, m, (k + 1) * tmma::kKc, lbuf + next * lfl,
                        pbuf + ((k + 1) & 1) * pel, v);
      }
      wgmma_wait0();
#pragma unroll
      for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
    }
  }
  wgmma_wait0();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);

  float bv[2];  // this lane's rows' biases
#pragma unroll
  for (int h = 0; h < 2; ++h)
    bv[h] = a.b[(size_t)m * a.b_ms + min(co0 + row0 + 8 * h, a.co - 1)];
  // the tile output of n8 tile nt's column c2 (this lane's sums 4 nt + 2 h + c2, h the
  // row half): halo-padded position n0 + 8 nt + 2 tig + c2; false past the tile
  auto place = [&](int nt, int c2, int& ly, int& lx) {
    const int s = n0 + 8 * nt + 2 * tig + c2;
    ly = s / v.tile_w;
    lx = s - ly * v.tile_w;
    return lx < a.tw && ly < a.th;
  };
  // the sums plus bias into shared memory over the buffers ([gb * 64][sstride]: the pool's
  // dense map, -inf off the frame), so that the outputs leave in rows
  __syncthreads();  // every warpgroup is done with the buffers
  const int sstride = tmma::stage_stride(npos);
  float* const sd = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int nt = 0; nt < tmma::kN / 8; ++nt)
#pragma unroll
    for (int c2 = 0; c2 < 2; ++c2) {
      int ly, lx;
      if (!place(nt, c2, ly, lx)) continue;
      const int y = v.oy + ly, x = v.ox + lx;
      const bool inside = y >= 0 && y < a.H && x >= 0 && x < a.W;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sd[(row0 + 8 * h) * sstride + ly * a.tw + lx] =
            inside ? __fadd_rn(acc[4 * nt + 2 * h + c2], bv[h]) : -CUDART_INF_F;
    }
  const int valid = min(gb * tmma::kGroup, a.co - co0);
  // the next conv's affine, for the block's rows (res stage, where pout is set)
  float* const snt = sd + gb * tmma::kGroup * sstride;
  const int tid = threadIdx.x, rows = gb * tmma::kGroup;
  if (!POOL && a.pout != nullptr && tid < 2 * rows) {
    const int c = min(co0 + tid % rows, a.co - 1);
    snt[tid] = tid < rows ? a.sn[(size_t)m * a.st_ms + c] : a.tn[(size_t)m * a.st_ms + c];
  }
  __syncthreads();
  if (POOL) {
    const int per = a.ph * a.pw;
    for (int i = threadIdx.x; i < valid * per; i += tmma::kThreads) {
      const int k = i / per, rem = i - k * per, ly = rem / a.pw, lx = rem - ly * a.pw;
      const int py = tr * a.ph + ly, px = tc * a.pw + lx;
      if (py >= a.Ho || px >= a.Wo) continue;
      const float* d = sd + k * sstride + 2 * ly * a.tw + 2 * lx;
      float u = -CUDART_INF_F;
      for (int dy = 0; dy < 3; ++dy)
        for (int dx = 0; dx < 3; ++dx) u = fmaxf(u, d[dy * a.tw + dx]);
      a.out[((mb * a.co + co0 + k) * a.Ho + py) * a.Wo + px] = u;
    }
    return;
  }
  // the res stage's outputs, a unit of 8 channels x 4 neighbouring positions of a tile
  // row (x 1 where the row or the pointers do not take float4s) a thread at a time,
  // neighbouring threads on neighbouring units: v = sums (+ the residual, every load of the
  // unit issued before its first store: res may be out, each value read, then written, by
  // one thread), then out = v in f32 (where out is set), and the next conv's operand
  // bf16(relu(v * sn + tn)), zero past co, as 16 bytes of its planes a position (where
  // pout is)
  const bool vec4 = a.W % 4 == 0 && a.tw % 4 == 0 && (a.out == nullptr || aligned16(a.out)) &&
                    (a.res == nullptr || aligned16(a.res));
  if (vec4)
    res_epilogue<4>(a, sd, snt, rows, sstride, valid, mb, co0, v.oy, v.ox);
  else
    res_epilogue<1>(a, sd, snt, rows, sstride, valid, mb, co0, v.oy, v.ox);
}

cudaError_t allow_smem(const void* kernel, bool* done, int bytes = kMaxSmem) {
  if (*done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = err == cudaSuccess;
  return err;
}

}  // namespace

// cluster blocks per (member, frame), each owning `band` image rows; the
// wrapper picks them (fused_resblock.res_stage_mma_plan).
extern "C" int dfd_res_stage_mma(const float* x, const float* w, const float* b, const float* s,
                                 const float* t, float* out, int M, int B, int C, int H, int W,
                                 int cluster, int band, void* stream) {
  if (M <= 0 || B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const size_t smem = res_smem(C, W, band);
  if (smem > (size_t)kMaxSmem || cluster < 1 || cluster > 8 ||
      (long long)cluster * band < H)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  cudaError_t err = allow_smem((const void*)res_stage_mma_kernel, &smem_set);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(M * B * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, res_stage_mma_kernel, x, w, b, s, t, out, B, C, H, W, band);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// pb pooled rows a block (fused_resblock.feat_pool_mma_plan).
extern "C" int dfd_feat_pool_mma(const float* x, const float* w, const float* b, const float* s,
                                 const float* t, float* out, int M, int B, int ci, int co, int H,
                                 int W, int pb, void* stream) {
  if (M <= 0 || B <= 0 || ci <= 0 || co <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const size_t smem = feat_smem(ci, co, W, pb);
  if (pb < 1 || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  cudaError_t err = allow_smem((const void*)feat_pool_mma_kernel, &smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(M * B, (Ho + pb - 1) / pb, (co + kFeatGroup - 1) / kFeatGroup);
  feat_pool_mma_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x, w, b, s, t, out, B, ci,
                                                                      co, H, W, Ho, Wo, pb);
  return (int)cudaGetLastError();
}

namespace {

// Kernels the tiled entries have launched in this process (dfd_tiled_mma_kernels).
long long g_tiled_kernels = 0;

cudaError_t counted(cudaError_t err) {
  if (err == cudaSuccess) ++g_tiled_kernels;
  return err;
}

cudaError_t round_weights(const float* w, bf16* img, int MJ, int co, int ci, cudaStream_t stream) {
  const long long rows = (long long)MJ * tmma::cdiv(ci, tmma::kKc) * tmma::image_groups(co) * 9 *
                         tmma::kPlanes * tmma::kGroup;
  const long long blocks = (rows + 255) / 256 < 132 * 16 ? (rows + 255) / 256 : 132 * 16;
  round_weights_kernel<<<unsigned(blocks), 256, 0, stream>>>(w, img, MJ, co, ci);
  return counted(cudaGetLastError());
}

// The tensor map of the bf16 planes a.in ([planes][H][W][8], M B ceil(ci / 8)
// planes) whose box is one plane's halo tile of 16-byte positions, zero
// outside.
cudaError_t planes_map(const TiledArgs& a, int M, CUtensorMap* map) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return cudaErrorInvalidValue;
  }
  const cuuint64_t dims[4] = {8, (cuuint64_t)a.W, (cuuint64_t)a.H,
                              (cuuint64_t)M * a.B * tmma::cdiv(a.ci, 8)};
  const cuuint64_t strides[3] = {16, (cuuint64_t)a.W * 16, (cuuint64_t)a.H * a.W * 16};
  const cuuint32_t box[4] = {8, (cuuint32_t)a.tw + 2, (cuuint32_t)a.th + 2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<float*>(a.in), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
                 CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// One tiled launch, its operand f32 (a.in, transformed) or bf16 planes
// (planar), with the ring of slots tiled_mma::stages gives.
template <bool POOL>
cudaError_t launch_tiled(const TiledArgs& a, int M, bool planar, cudaStream_t stream) {
  using Kernel = void (*)(const TiledArgs, const CUtensorMap);
  static const Kernel kernels[3][3] = {
      {&conv_tiled_mma_kernel<POOL, 2, false>, &conv_tiled_mma_kernel<POOL, 3, false>, nullptr},
      {POOL ? nullptr : &conv_tiled_mma_kernel<false, 2, true>,
       POOL ? nullptr : &conv_tiled_mma_kernel<false, 3, true>,
       POOL ? nullptr : &conv_tiled_mma_kernel<false, 4, true>}};
  static bool smem_set[3][3] = {};
  const int stages = tmma::stages(POOL, planar, a.co, a.th, a.tw);
  const Kernel kernel = kernels[planar][stages - 2];
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err =
      allow_smem((const void*)kernel, &smem_set[planar][stages - 2], int(tmma::kSmemMax));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)M * a.B * a.ntiles;
  const long long groups = tmma::image_groups(a.co) / tmma::block_groups(a.co);
  if (blocks > 0x7fffffffLL || groups > 65535) return cudaErrorInvalidValue;
  CUtensorMap map = {};
  if (planar)
    err = planes_map(a, M, &map);
  else if (a.vec)
    err = operand_map(a, M, tmma::landing_width(a.tw), tmma::kKc, &map);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(unsigned(blocks), unsigned(groups)), tmma::kThreads,
           size_t(tmma::smem_bytes(POOL, planar, a.co, a.th, a.tw, stages)), stream>>>(a, map);
  return counted(cudaGetLastError());
}

}  // namespace

// How many kernels the tiled entries have launched (the weights' rounding
// included): a call's count is the difference around it.
extern "C" long long dfd_tiled_mma_kernels() { return g_tiled_kernels; }

// The res stage where no cluster holds a band: the four convs' weights
// rounded into wimg (M * 4 * tiled_mma::conv_image_elems(C, C) bf16 values;
// unless round is 0, when wimg already holds w's image), then four tiled
// launches of th x tw outputs a block, the plan of fused_resblock.
// res_stage_mma_plan's tiled form, refused unless it is tiled_mma::
// res_plan's.  Each conv writes the next one's operand, bf16(relu(v * s +
// t)), as bf16 planes ([M B][ceil(C / 8)][H][W][8]) into one of two buffers
// in scratch (the caller's, 2 M B ceil(C / 8) H W 8 bf16 values), so that
// convs 1-3 land bf16 with no transform: planes A <- conv0(x);
// out <- x + conv1(A), planes B from it; planes A <- conv2(B);
// out <- out + conv3(A).  The block input is never overwritten; a conv that
// adds its residual to out reads and writes each value of it on one thread.
extern "C" int dfd_res_stage_tiled_mma(const float* x, const float* w, const float* b,
                                       const float* s, const float* t, float* wimg,
                                       float* scratch, float* out, int M, int B, int C, int H,
                                       int W, int th, int tw, int round, void* stream) {
  if (M <= 0 || B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  int pth = 0, ptw = 0;
  tmma::res_plan(C, H, W, &pth, &ptw);
  if (pth != th || ptw != tw) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  bf16* const img = reinterpret_cast<bf16*>(wimg);
  cudaError_t err = round ? round_weights(w, img, M * 4, C, C, st) : cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  const long long conv = tmma::conv_image_elems(C, C);
  const size_t pel = (size_t)M * B * tmma::cdiv(C, 8) * H * W * 8;  // one planes buffer
  bf16* const pa = reinterpret_cast<bf16*>(scratch);
  bf16* const pb = pa + pel;
  // conv j's operand, residual, f32 output and the planes it writes for conv j + 1
  const void* in[4] = {x, pa, pb, pa};
  const float* res[4] = {nullptr, x, nullptr, out};
  float* dst[4] = {nullptr, out, nullptr, out};
  void* pout[4] = {pa, pb, pa, nullptr};
  TiledArgs a = tiled_args(B, C, C, H, W, th, tw, 0, 0);
  a.w_ms = 4 * conv;
  a.b_ms = a.st_ms = 4 * C;
  a.relu = 1;
  for (int j = 0; j < 4; ++j) {
    a.in = static_cast<const float*>(in[j]);
    a.vec = j == 0 && W % 4 == 0 && aligned16(x);
    a.res = res[j];
    a.out = dst[j];
    a.pout = pout[j];
    a.w = reinterpret_cast<const float*>(img + j * conv);
    a.b = b + (size_t)j * C;
    a.s = s + (size_t)j * C;
    a.t = t + (size_t)j * C;
    a.sn = s + (size_t)(j < 3 ? j + 1 : j) * C;  // the next conv's affine
    a.tn = t + (size_t)(j < 3 ? j + 1 : j) * C;
    if ((err = launch_tiled<false>(a, M, j > 0, st)) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The feature pool where no band of pooled rows fits a block: the weights
// rounded into wimg (M * tiled_mma::conv_image_elems(ci, co) bf16 values;
// unless round is 0), then one tiled launch of ph x pw pooled outputs a
// block, refused unless the plan is tiled_mma::feat_plan's.
extern "C" int dfd_feat_pool_tiled_mma(const float* x, const float* w, const float* b,
                                       const float* s, const float* t, float* wimg, float* out,
                                       int M, int B, int ci, int co, int H, int W, int ph, int pw,
                                       int round, void* stream) {
  if (M <= 0 || B <= 0 || ci <= 0 || co <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  int pph = 0, ppw = 0;
  tmma::feat_plan(co, H, W, &pph, &ppw);
  if (pph != ph || ppw != pw) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = round ? round_weights(w, reinterpret_cast<bf16*>(wimg), M, co, ci, st)
                          : cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  TiledArgs a = tiled_args(B, ci, co, H, W, 2 * ph + 1, 2 * pw + 1, ph, pw);
  a.in = x;
  a.vec = W % 4 == 0 && aligned16(x);
  a.w = wimg;
  a.b = b;
  a.s = s;
  a.t = t;
  a.out = out;
  a.w_ms = tmma::conv_image_elems(ci, co);
  a.b_ms = co;
  a.st_ms = ci;
  return (int)launch_tiled<true>(a, M, false, st);
}
