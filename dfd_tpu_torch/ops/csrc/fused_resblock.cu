// Fused IMPALA torso kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (dfd_tpu_torch/ops/fused_resblock.py).
//
// Replaces the Pallas TPU kernels dfd_tpu/ops/fused_resblock.py::
// fused_res_stage (_stage_call -> _stage_kernel) and ::fused_feat_pool
// (_featpool_call -> _featpool_kernel), vmapped there over the members; here
// the member and the frame are grid axes.
//
//   dfd_res_stage:  one stage's two residual blocks.  Four times
//                   h <- conv3x3(relu(h * s_j + t_j)) + b_j, the block input
//                   added back after the second conv of each block.
//   dfd_feat_pool:  one stage's feature block: y = conv3x3(x * s + t) + b,
//                   then the 3x3 max with -inf off the image, kept at the
//                   even positions (maxpool 3x3, stride 2, padding 1).
//
// Weights arrive per member in the tap order of reorder_conv_weight:
// w[co][kw * 3 * ci + kh * ci + c] holds the OIHW weight w[co, c, kh, kw].
// Both convs pad with zeros after the affine, as the TPU kernel's masked
// taps do.
//
// These kernels are the float32 route (compute_dtype=None); the bf16 route
// runs on the tensor cores in fused_resblock_mma.cu.  What bounds them on an
// H100: the f32 FMAs.  At impala_procmaze's rollout shapes (M = 129 members,
// one frame each, 16 ch x 32x32 and 32 ch x 16x16) a res stage is
// 4 * C * 9C * H * W = 9.4 M FMAs per member, 2.4 GFLOP a launch, against
// ~22-28 MB of traffic (the per-member weights and one activation in, one
// out): 36 us of f32 issue against 7-8 us of memory.  So the design keeps
// every operand of the inner loop on chip: a tile of the halo-padded input
// (kCiT channels at a time, the affine and ReLU applied as it is staged) and
// the matching weights sit in shared memory, each thread holds kCoT output
// channels of one position in registers, and each input value read from
// shared memory feeds kCoT FMAs (the weights are read as float4 broadcasts).
// No [9C, S] tap matrix exists anywhere: it would be 576 KB at 16 channels
// x 32 x 32, beyond the 227 KB a block can hold.
//
// The res stage runs one block per (member, frame) because each conv needs
// all channels of the previous one.  The four convs' intermediates live in a
// per-(member, frame) scratch in device memory (L2-resident at these sizes),
// with __syncthreads() between convs; the kernel reads the buffers it
// writes, so none of those pointers is __restrict__ (no non-coherent
// loads).  The feature block has one conv, so its blocks split the pooled
// output into 8 x 8 tiles and the output channels into groups of kCoT: a
// block computes the 17 x 17 dense conv outputs behind its tile into shared
// memory, then takes the 3 x 3 maxima, and writes only the pooled outputs.
//
// Arithmetic follows the TPU kernel: the affine as two rounded operations
// (__fmul_rn, __fadd_rn, never contracted), the bias after the product, the
// residual after the second conv, all in f32.  Build without
// --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kCoT = 16;                       // output channels per thread, in registers
constexpr int kCiT = 8;                        // input channels staged per round
constexpr int kResTile = 16;                   // res stage: 16 x 16 positions, one per thread
constexpr int kResThreads = kResTile * kResTile;
constexpr int kPoolTile = 8;                   // feat pool: 8 x 8 pooled outputs per block
constexpr int kDense = 2 * kPoolTile + 1;      // behind them, 17 x 17 dense conv outputs
constexpr int kPoolThreads = 320;              // whole warps covering 17 * 17 = 289

// One TH x TW tile of a 3x3 "same" conv for the kCoT output channels from
// co0, at image position (oy0, ox0) and on: thread i < TH * TW owns the
// position (oy0 + i / TW, ox0 + i % TW) and returns its sums in acc.  The
// input src [ci_n, H, W] is staged as src * s + t, then ReLU if relu, and
// zero off the image; the sums at tile positions off the image are
// meaningless and the caller drops them.  Every thread of the block must
// call this.
template <int TH, int TW>
__device__ void conv_tile(const float* src, int ci_n, int H, int W,
                          const float* __restrict__ s, const float* __restrict__ t, bool relu,
                          const float* __restrict__ w, int co_n, int co0, int oy0, int ox0,
                          float* si, float* sw, float acc[kCoT]) {
  constexpr int PH = TH + 2, PW = TW + 2;
  const int tid = threadIdx.x;
  const int ly = tid / TW, lx = tid % TW;
  const bool owns = tid < TH * TW;
#pragma unroll
  for (int k = 0; k < kCoT; ++k) acc[k] = 0.0f;
  for (int ci0 = 0; ci0 < ci_n; ci0 += kCiT) {
    __syncthreads();  // the previous round's tiles are consumed
    for (int i = tid; i < kCiT * PH * PW; i += blockDim.x) {
      const int c = i / (PH * PW), r = i % (PH * PW);
      const int y = oy0 - 1 + r / PW, x = ox0 - 1 + r % PW, ci = ci0 + c;
      float v = 0.0f;
      if (ci < ci_n && y >= 0 && y < H && x >= 0 && x < W) {
        v = __fadd_rn(__fmul_rn(src[((size_t)ci * H + y) * W + x], s[ci]), t[ci]);
        if (relu) v = fmaxf(v, 0.0f);
      }
      si[i] = v;
    }
    // sw[(c * 9 + kh * 3 + kw) * kCoT + k] = w[co0 + k][kw * 3 * ci_n + kh * ci_n + ci0 + c]
    for (int i = tid; i < kCiT * 9 * kCoT; i += blockDim.x) {
      const int k = i % kCoT, tap = (i / kCoT) % 9, c = i / (9 * kCoT);
      const int co = co0 + k, ci = ci0 + c;
      float v = 0.0f;
      if (co < co_n && ci < ci_n) {
        v = w[(size_t)co * 9 * ci_n + (tap % 3) * 3 * ci_n + (tap / 3) * ci_n + ci];
      }
      sw[i] = v;
    }
    __syncthreads();
    if (owns) {
      for (int c = 0; c < kCiT; ++c) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float v = si[c * PH * PW + (ly + tap / 3) * PW + lx + tap % 3];
          const float4* wv = reinterpret_cast<const float4*>(sw + (c * 9 + tap) * kCoT);
#pragma unroll
          for (int q = 0; q < kCoT / 4; ++q) {
            const float4 wq = wv[q];
            acc[4 * q + 0] = fmaf(v, wq.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(v, wq.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(v, wq.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(v, wq.w, acc[4 * q + 3]);
          }
        }
      }
    }
  }
}

// One block per (member, frame): blockIdx.x = member * B + frame.
__global__ void __launch_bounds__(kResThreads)
res_stage_kernel(const float* x, const float* __restrict__ w, const float* __restrict__ b,
                 const float* __restrict__ s, const float* __restrict__ t, float* out,
                 float* tmp, int B, int C, int H, int W) {
  __shared__ float si[kCiT * (kResTile + 2) * (kResTile + 2)];
  __shared__ __align__(16) float sw[kCiT * 9 * kCoT];
  const int mb = blockIdx.x, m = mb / B;
  const size_t img = (size_t)C * H * W;
  const float* xin = x + mb * img;
  float* o = out + mb * img;
  float* h = tmp + mb * img;
  for (int j = 0; j < 4; ++j) {  // conv j of the stage: block j / 2, conv j % 2
    const bool second = j & 1;
    const float* src = j == 0 ? xin : (second ? h : o);
    float* dst = second ? o : h;
    const float* res = second ? (j == 1 ? xin : o) : nullptr;
    const size_t mj = (size_t)m * 4 + j;
    const float* wj = w + mj * C * 9 * C;
    const float* bj = b + mj * C;
    for (int oy0 = 0; oy0 < H; oy0 += kResTile) {
      for (int ox0 = 0; ox0 < W; ox0 += kResTile) {
        for (int co0 = 0; co0 < C; co0 += kCoT) {
          float acc[kCoT];
          conv_tile<kResTile, kResTile>(src, C, H, W, s + mj * C, t + mj * C, true, wj, C, co0,
                                        oy0, ox0, si, sw, acc);
          const int y = oy0 + threadIdx.x / kResTile, xx = ox0 + threadIdx.x % kResTile;
          if (y < H && xx < W) {
#pragma unroll
            for (int k = 0; k < kCoT; ++k) {
              const int co = co0 + k;
              if (co < C) {
                const size_t p = ((size_t)co * H + y) * W + xx;
                float v = __fadd_rn(acc[k], bj[co]);
                if (res != nullptr) v = __fadd_rn(res[p], v);
                dst[p] = v;
              }
            }
          }
        }
      }
    }
    __syncthreads();  // conv j's outputs are visible before conv j + 1 reads them
  }
}

// blockIdx.x = member * B + frame, blockIdx.y = pooled 8 x 8 tile,
// blockIdx.z = group of kCoT output channels.
__global__ void __launch_bounds__(kPoolThreads)
feat_pool_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, const float* __restrict__ s,
                 const float* __restrict__ t, float* __restrict__ out, int B, int ci_n, int co_n,
                 int H, int W, int Ho, int Wo) {
  __shared__ float si[kCiT * (kDense + 2) * (kDense + 2)];
  __shared__ __align__(16) float sw[kCiT * 9 * kCoT];
  __shared__ float sd[kCoT * kDense * kDense];
  const int mb = blockIdx.x, m = mb / B;
  const int tiles_x = (Wo + kPoolTile - 1) / kPoolTile;
  const int py0 = (blockIdx.y / tiles_x) * kPoolTile, px0 = (blockIdx.y % tiles_x) * kPoolTile;
  const int co0 = blockIdx.z * kCoT;
  // the dense outputs behind the tile: image rows and columns 2 * p0 - 1 on
  const int oy0 = 2 * py0 - 1, ox0 = 2 * px0 - 1;
  float acc[kCoT];
  conv_tile<kDense, kDense>(x + (size_t)mb * ci_n * H * W, ci_n, H, W, s + (size_t)m * ci_n,
                            t + (size_t)m * ci_n, false, w + (size_t)m * co_n * 9 * ci_n, co_n,
                            co0, oy0, ox0, si, sw, acc);
  const int tid = threadIdx.x;
  if (tid < kDense * kDense) {
    const int y = oy0 + tid / kDense, xx = ox0 + tid % kDense;
    const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
#pragma unroll
    for (int k = 0; k < kCoT; ++k) {
      const int co = co0 + k;
      sd[k * kDense * kDense + tid] =
          inside && co < co_n ? __fadd_rn(acc[k], b[(size_t)m * co_n + co]) : -CUDART_INF_F;
    }
  }
  __syncthreads();
  for (int i = tid; i < kCoT * kPoolTile * kPoolTile; i += blockDim.x) {
    const int k = i / (kPoolTile * kPoolTile), r = i % (kPoolTile * kPoolTile);
    const int ly = r / kPoolTile, lx = r % kPoolTile;
    const int py = py0 + ly, px = px0 + lx, co = co0 + k;
    if (py < Ho && px < Wo && co < co_n) {
      const float* d = sd + k * kDense * kDense + 2 * ly * kDense + 2 * lx;
      float v = -CUDART_INF_F;
      for (int dy = 0; dy < 3; ++dy) {
        for (int dx = 0; dx < 3; ++dx) v = fmaxf(v, d[dy * kDense + dx]);
      }
      out[(((size_t)mb * co_n + co) * Ho + py) * Wo + px] = v;
    }
  }
}

}  // namespace

extern "C" int dfd_res_stage(const float* x, const float* w, const float* b, const float* s,
                             const float* t, float* out, float* tmp, int M, int B, int C, int H,
                             int W, void* stream) {
  if (M <= 0 || B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  res_stage_kernel<<<M * B, kResThreads, 0, (cudaStream_t)stream>>>(x, w, b, s, t, out, tmp, B,
                                                                    C, H, W);
  return (int)cudaGetLastError();
}

extern "C" int dfd_feat_pool(const float* x, const float* w, const float* b, const float* s,
                             const float* t, float* out, int M, int B, int ci, int co, int H,
                             int W, void* stream) {
  if (M <= 0 || B <= 0 || ci <= 0 || co <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const dim3 grid(M * B, ((Ho + kPoolTile - 1) / kPoolTile) * ((Wo + kPoolTile - 1) / kPoolTile),
                  (co + kCoT - 1) / kCoT);
  feat_pool_kernel<<<grid, kPoolThreads, 0, (cudaStream_t)stream>>>(x, w, b, s, t, out, B, ci,
                                                                    co, H, W, Ho, Wo);
  return (int)cudaGetLastError();
}
