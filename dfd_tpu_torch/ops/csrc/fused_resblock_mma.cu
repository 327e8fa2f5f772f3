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
// (conv_tiled_mma_kernel), which take any C, H and W.
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
// GEMM over tiles (conv_tiled_mma_kernel): a block takes th x tw conv
// outputs (whole image rows, or part of one where W is wider than the 256
// positions of its warps) x a group of up to kTiledGroup output channels, and
// streams K = 9 ci in chunks of all nine taps x kTiledKc input channels.  A
// chunk lands by cp.async in f32 (the operand tile with its halo from device
// memory, the group's weights), is rounded into bf16 buffers (the operand as
// bf16(relu(x * s + t)), zero off the frame and past ci: the prologue the
// cluster kernels apply as they stage), and the next chunk's copies start
// before the tensor cores take this one.  The arithmetic is the cluster
// kernels' up to the order of the K chunks: each conv output is summed in
// f32 and stored in f32, and the next conv rounds relu(v * s + t) to bf16 as
// the cluster kernel's epilogue does.
//
// The res stage is four such launches (dfd_res_stage_tiled_mma, the passes
// of conv_tiled.cuh's res_stage_passes), the feature pool one
// (dfd_feat_pool_tiled_mma): a block's tile is ph x pw pooled outputs, whose
// (2 ph + 1) x (2 pw + 1) dense outputs it computes, -inf off the frame, into
// shared memory over its buffers, then takes their 3x3 maxima.

constexpr int kTiledKc = 16;                 // input channels of a chunk: one k16 step a tap
constexpr int kTiledRaw = kTiledKc + 4;      // f32 landing: floats a position
constexpr int kTiledRawW = 9 * kTiledKc + 4; //   and a weight row
constexpr int kTiledCs = kTiledKc + 8;       // bf16 operand: values a position (ldmatrix rows
constexpr int kTiledCsw = 9 * kTiledKc + 8;  //   on distinct banks), and a weight row
constexpr int kTiledCap = kWarps * kWarpN;   // positions a block's warps take at once

__host__ __device__ __forceinline__ int tiled_rows(int co) {
  return pad16(co) < kTiledGroup ? pad16(co) : kTiledGroup;
}

// Shared bytes of a tiled block: the f32 landing buffers and the bf16 ones,
// or the dense map that overlays them in the feature pool, whichever is larger.
size_t tiled_smem(int co, int th, int tw, bool pool) {
  const size_t npt = (size_t)(th + 2) * (tw + 2), rows = tiled_rows(co);
  const size_t conv =
      npt * (4 * kTiledRaw + 2 * kTiledCs) + rows * (4 * kTiledRawW + 2 * kTiledCsw);
  const size_t dense = pool ? 4 * rows * th * tw : 0;
  return conv > dense ? conv : dense;
}

// The res stage's tile: as many whole rows as the warps' positions cover
// (part of a row where W is wider), fewer rows, then narrower, while the
// buffers do not fit; then spread evenly over the frame.
void tiled_res_plan(int C, int H, int W, int* th, int* tw) {
  int w = min(W, kTiledCap), h = max(1, min(H, kTiledCap / w));
  while (tiled_smem(C, h, w, false) > (size_t)kMaxSmem) {
    if (h > 1) --h;
    else w = max(1, w / 2);
  }
  const int ntr = (H + h - 1) / h, ntc = (W + w - 1) / w;
  *th = (H + ntr - 1) / ntr;
  *tw = (W + ntc - 1) / ntc;
}

// The feature pool's tile of ph x pw pooled outputs: the widest run of
// pooled columns whose dense columns, three dense rows of them, the warps
// cover, then as many pooled rows as they take; fewer while the buffers do
// not fit; then spread evenly.
void tiled_feat_plan(int co, int H, int W, int* ph, int* pw) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  int c = min(Wo, max(1, (kTiledCap / 3 - 1) / 2));
  int r = min(Ho, max(1, (kTiledCap / (2 * c + 1) - 1) / 2));
  while (tiled_smem(co, 2 * r + 1, 2 * c + 1, true) > (size_t)kMaxSmem) {
    if (r > 1) --r;
    else c = max(1, c / 2);
  }
  const int ntr = (Ho + r - 1) / r, ntc = (Wo + c - 1) / c;
  *ph = (Ho + ntr - 1) / ntr;
  *pw = (Wo + ntc - 1) / ntc;
}

// The landed chunk in bf16: the operand as bf16(x * s + t, then ReLU if
// relu) on the frame, zero off it and past ci; the weights rounded.
__device__ void round_tiled(const TiledArgs& a, const float* tile, const float* wb, bf16* op,
                            bf16* sw, int m, int oy, int ox, int c0, int rows) {
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
    const float* d = tile + p * kTiledRaw;
    float v[kTiledKc];
#pragma unroll
    for (int c = 0; c < kTiledKc; ++c) {
      v[c] = 0.f;
      if (inside && c0 + c < a.ci) {
        v[c] = affine(d[c], sv[c], tv[c]);
        if (a.relu) v[c] = fmaxf(v[c], 0.f);
      }
    }
#pragma unroll
    for (int c = 0; c < kTiledKc; c += 2)
      *reinterpret_cast<__nv_bfloat162*>(op + p * kTiledCs + c) =
          __floats2bfloat162_rn(v[c], v[c + 1]);
  }
  for (int i = threadIdx.x; i < rows * 9 * kTiledKc / 2; i += kThreads) {
    const int r = i / (9 * kTiledKc / 2), c = (i - r * (9 * kTiledKc / 2)) * 2;
    *reinterpret_cast<__nv_bfloat162*>(sw + r * kTiledCsw + c) =
        __floats2bfloat162_rn(wb[r * kTiledRawW + c], wb[r * kTiledRawW + c + 1]);
  }
}

// blockIdx.x = (member * B + frame) * ntiles + tile, blockIdx.y = group of
// kTiledGroup output channels.  One conv of a res stage (bias, then the
// residual where res is set), or the feature pool's conv and pool (POOL).
template <bool POOL>
__global__ void __launch_bounds__(kThreads, 2)
conv_tiled_mma_kernel(const __grid_constant__ TiledArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ti = int(blockIdx.x % (unsigned)a.ntiles);
  const size_t mb = blockIdx.x / (unsigned)a.ntiles;
  const int m = int(mb / a.B), tr = ti / a.ntc, tc = ti - tr * a.ntc;
  const int oy = POOL ? 2 * tr * a.ph - 1 : tr * a.th;  // the tile's first conv output
  const int ox = POOL ? 2 * tc * a.pw - 1 : tc * a.tw;
  const int co0 = blockIdx.y * kTiledGroup, rows = tiled_rows(a.co);
  const int tile_w = a.tw + 2, npos = a.th * a.tw;
  const size_t npt = (size_t)(a.th + 2) * tile_w;
  float* const tile = reinterpret_cast<float*>(smem);
  float* const wb = tile + npt * kTiledRaw;
  bf16* const op = reinterpret_cast<bf16*>(wb + (size_t)rows * kTiledRawW);
  bf16* const sw = op + npt * kTiledCs;

  const WarpGrid g = warp_grid(rows);  // one warp row: the 256 positions cover the tile
  const int lane = threadIdx.x & 31, gr = lane >> 2, gc = lane & 3;
  int boff[2];
  b_offsets(boff, 0, g.wn, npos, a.tw, tile_w, kTiledCs);
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int nk = (a.ci + kTiledKc - 1) / kTiledKc;
  issue_tiled<kTiledKc, kThreads>(a, tile, wb, mb, m, oy, ox, co0, 0, rows);
  for (int k = 0; k < nk; ++k) {
    cp_async_wait_all();
    __syncthreads();  // chunk k has landed; every warp is done with chunk k - 1
    round_tiled(a, tile, wb, op, sw, m, oy, ox, k * kTiledKc, rows);
    __syncthreads();  // the bf16 buffers are written; the landing ones are free
    if (k + 1 < nk)
      issue_tiled<kTiledKc, kThreads>(a, tile, wb, mb, m, oy, ox, co0, (k + 1) * kTiledKc, rows);
    if (g.mtiles > 0) {
      const bf16* ap = sw + (lane & 15) * kTiledCsw + (lane >> 4) * 8;
      for (int tap = 0; tap < 9; ++tap) {
        const int shift = ((tap % 3) * tile_w + tap / 3) * kTiledCs;  // tap = kw * 3 + kh
        uint32_t af[4][4], bfr[2][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          if (mt < g.mtiles) ldsm_x4(af[mt], ap + mt * 16 * kTiledCsw + tap * kTiledKc);
        ldsm_x4(bfr[0], op + boff[0] + shift);
        ldsm_x4(bfr[1], op + boff[1] + shift);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt < g.mtiles) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2],
                       bfr[nt >> 1][(nt & 1) * 2 + 1]);
          }
        }
      }
    }
  }
  const float* bm = a.b + (size_t)m * a.b_ms + co0;
  const int valid = min(kTiledGroup, a.co - co0);
  // this thread's 8 positions (n8 tile q >> 1, column q & 1): the frame
  // offset, -1 past the tile or off the frame
  int goff[8];
  bool inside[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int p = g.wn * kWarpN + (q >> 1) * 8 + 2 * gc + (q & 1);
    const int ly = p / a.tw, y = oy + ly, x = ox + p - ly * a.tw;
    inside[q] = p < npos && y >= 0 && y < a.H && x >= 0 && x < a.W;
    goff[q] = p < npos ? (inside[q] ? y * a.W + x : -2) : -1;
  }
  if (POOL) {
    __syncthreads();  // the dense map overwrites the buffers
    float* const sd = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt >= g.mtiles) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = mt * 16 + gr + (e >> 1) * 8, q = nt * 2 + (e & 1);
          if (k >= rows || goff[q] == -1) continue;
          const int p = g.wn * kWarpN + (q >> 1) * 8 + 2 * gc + (q & 1);
          sd[k * npos + p] = inside[q] ? __fadd_rn(acc[mt][nt][e], bm[min(k, valid - 1)])
                                       : -CUDART_INF_F;
        }
    }
    __syncthreads();
    const int per = a.ph * a.pw;
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
  // an m16 tile at a time, every residual load of it issued before the first
  // is used (res may be out: each value is read, then written, by this
  // thread alone)
  const size_t plane = (size_t)a.H * a.W;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (mt >= g.mtiles) continue;
    float rv[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = mt * 16 + gr + (e >> 1) * 8, q = nt * 2 + (e & 1);
        const bool in = a.res != nullptr && k < valid && inside[q];
        rv[nt][e] = in ? a.res[(mb * a.co + co0 + k) * plane + goff[q]] : 0.f;
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = mt * 16 + gr + (e >> 1) * 8, q = nt * 2 + (e & 1);
        if (k >= valid || !inside[q]) continue;
        float v = __fadd_rn(acc[mt][nt][e], bm[k]);
        if (a.res != nullptr) v = __fadd_rn(rv[nt][e], v);
        a.out[(mb * a.co + co0 + k) * plane + goff[q]] = v;
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

template <bool POOL>
cudaError_t launch_tiled(const TiledArgs& a, int M, cudaStream_t stream) {
  static bool smem_set = false;
  cudaError_t err = allow_smem((const void*)&conv_tiled_mma_kernel<POOL>, &smem_set);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)M * a.B * a.ntiles;
  const long long groups = (a.co + kTiledGroup - 1) / kTiledGroup;
  if (blocks > 0x7fffffffLL || groups > 65535) return cudaErrorInvalidValue;
  conv_tiled_mma_kernel<POOL><<<dim3(unsigned(blocks), unsigned(groups)), kThreads,
                                tiled_smem(a.co, a.th, a.tw, POOL), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The res stage where no cluster holds a band: four tiled launches of
// th x tw outputs a block, the plan of fused_resblock.res_stage_mma_plan's
// tiled form, refused unless it is tiled_res_plan's.  scratch is a
// [M, B, C, H, W] buffer of the caller's.
extern "C" int dfd_res_stage_tiled_mma(const float* x, const float* w, const float* b,
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

// The feature pool where no band of pooled rows fits a block: one tiled
// launch of ph x pw pooled outputs a block, refused unless the plan is
// tiled_feat_plan's.
extern "C" int dfd_feat_pool_tiled_mma(const float* x, const float* w, const float* b,
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
