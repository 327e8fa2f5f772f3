// The TPU probes' fused residual-conv chain for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (dfd_tpu_torch/ops/res_chain.py).
//
// Replaces the Pallas TPU probe kernels tools/probe_pallas_wide.py::probe_stage (make_fused_n,
// make_fused_m) and tools/probe_pallas_pool.py::main (fused_kernel_sq, make_fused_m): for each
// member p, J times (J = 4 in the probes)
//
//     x <- x + 0.25 * relu(W_j . pat(x) + b_j),
//
// pat(x) the [9C, S] taps of the 3 x 3 zero-padded neighbourhood of each position, ordered
// (dx, dy, c) as the probes' build_pat concatenates them (and as reorder_conv_weight orders
// a conv's weights): row dx * 3C + dy * C + c at position (y, x) holds x[c, y + dy - 1,
// x + dx - 1].  Two layouts, one kernel template:
//
//   channel-major (kMinor = false, the probes' "N-major"): x [P, C, S], W [P, J, C, 9C];
//   channel-minor (kMinor = true,  the probes' "M-major"): x [P, S, C], W [P, J, 9C, C];
//
// b [P, J, C] in both, S = H * W.  With bf16 on, both conv operands (the staged x and the
// weights) are rounded to bf16 and the products accumulate in f32, as the probes' bf16 dot
// with preferred_element_type=float32 does.
//
// What bounds it on an H100: the FMAs.  At the wide probe's 128 channels x 16 x 16 and P = 64
// the chain is 19.3 GFLOP, 0.29 ms at 67 TFLOP/s in f32, against 151 MB of per-member
// weights (45 us at 3.35 TB/s); with bf16 operands at the 989 TFLOP/s of the tensor cores the
// bytes would bound it.  This first kernel runs the products on the CUDA cores in f32 for
// both types, the design of the first CUDA-core res-stage kernel of the fused torso (since
// replaced by fused_resblock_tf32.cu): one block per member, since each conv needs
// every channel of the one before; a 16 x 16 tile of positions, one per thread, each thread
// holding 16 output channels in registers; per round, 8 input channels of the halo-padded
// tile and the matching weight slice staged in shared memory (the weights are 2.4 MB a
// member at 128 channels, far past the 227 KB a block may hold, so they stream through in
// these slices); no [9C, S] tap matrix anywhere.  The chain's intermediates ping-pong
// between the output and a scratch in device memory (L2-resident), __syncthreads() between
// convs, and the last conv writes the output; those buffers are read and written by the same
// kernel, so none of their pointers is __restrict__.  Only the staging's index arithmetic
// differs between the layouts.  Tensor cores (mma.sync, wgmma for bf16) are later work.
//
// Arithmetic follows the probes: the bias after the product, relu, then x + 0.25 * y, each
// step rounded (__fadd_rn, __fmul_rn; never contracted).  Build without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCoT = 16;                       // output channels per thread, in registers
constexpr int kCiT = 8;                        // input channels staged per round
constexpr int kTile = 16;                      // 16 x 16 positions, one per thread
constexpr int kThreads = kTile * kTile;
constexpr int kPH = kTile + 2, kPW = kTile + 2;  // the halo-padded tile

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The sums of one kTile x kTile tile of positions from (oy0, ox0) for the kCoT output
// channels from co0: thread i owns (oy0 + i / kTile, ox0 + i % kTile).  src is one member's
// activations and w one conv's weights, both in the kMinor layout.  Sums at positions off
// the image are meaningless and the caller drops them.  Every thread of the block calls it.
template <bool kMinor>
__device__ void conv_tile(const float* src, const float* __restrict__ w, int C, int H, int W,
                          int co0, int oy0, int ox0, bool bf16, float* si, float* sw,
                          float acc[kCoT]) {
  const int tid = threadIdx.x, ly = tid / kTile, lx = tid % kTile;
  const int S = H * W;
#pragma unroll
  for (int k = 0; k < kCoT; ++k) acc[k] = 0.0f;
  for (int ci0 = 0; ci0 < C; ci0 += kCiT) {
    __syncthreads();  // the previous round's tiles are consumed
    // si[c * kPH * kPW + r] = x[ci0 + c] at halo position r; neighbouring threads read
    // neighbouring addresses: positions in channel-major, channels in channel-minor
    for (int i = tid; i < kCiT * kPH * kPW; i += kThreads) {
      const int c = kMinor ? i % kCiT : i / (kPH * kPW);
      const int r = kMinor ? i / kCiT : i % (kPH * kPW);
      const int y = oy0 - 1 + r / kPW, x = ox0 - 1 + r % kPW, ci = ci0 + c;
      float v = 0.0f;
      if (ci < C && y >= 0 && y < H && x >= 0 && x < W) {
        const int s = y * W + x;
        v = kMinor ? src[(size_t)s * C + ci] : src[(size_t)ci * S + s];
        if (bf16) v = round_bf16(v);
      }
      si[c * kPH * kPW + r] = v;
    }
    // sw[(c * 9 + dy * 3 + dx) * kCoT + k] = W[co0 + k][dx * 3C + dy * C + ci0 + c]
    for (int i = tid; i < kCiT * 9 * kCoT; i += kThreads) {
      int c, tap, k;
      if (kMinor) {  // W [9C, C]: output channels adjacent
        k = i % kCoT;
        tap = (i / kCoT) % 9;
        c = i / (9 * kCoT);
      } else {       // W [C, 9C]: input channels adjacent
        c = i % kCiT;
        tap = (i / kCiT) % 9;
        k = i / (9 * kCiT);
      }
      const int co = co0 + k, ci = ci0 + c;
      float v = 0.0f;
      if (co < C && ci < C) {
        const int row = (tap % 3) * 3 * C + (tap / 3) * C + ci;
        v = kMinor ? w[(size_t)row * C + co] : w[(size_t)co * 9 * C + row];
        if (bf16) v = round_bf16(v);
      }
      sw[(c * 9 + tap) * kCoT + k] = v;
    }
    __syncthreads();
    for (int c = 0; c < kCiT; ++c) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float v = si[c * kPH * kPW + (ly + tap / 3) * kPW + lx + tap % 3];
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

// One block per member: blockIdx.x = p.
template <bool kMinor>
__global__ void __launch_bounds__(kThreads)
res_chain_kernel(const float* x, const float* __restrict__ w, const float* __restrict__ b,
                 float* out, float* tmp, int J, int C, int H, int W, int bf16) {
  __shared__ float si[kCiT * kPH * kPW];
  __shared__ __align__(16) float sw[kCiT * 9 * kCoT];
  const int p = blockIdx.x;
  const size_t img = (size_t)C * H * W;
  for (int j = 0; j < J; ++j) {
    // conv j reads what conv j - 1 wrote; the last conv writes out
    float* dst = ((J - 1 - j) % 2 == 0 ? out : tmp) + p * img;
    const float* src = j == 0 ? x + p * img : ((J - j) % 2 == 0 ? out : tmp) + p * img;
    const size_t pj = (size_t)p * J + j;
    const float* wj = w + pj * 9 * C * C;
    const float* bj = b + pj * C;
    for (int oy0 = 0; oy0 < H; oy0 += kTile) {
      for (int ox0 = 0; ox0 < W; ox0 += kTile) {
        for (int co0 = 0; co0 < C; co0 += kCoT) {
          float acc[kCoT];
          conv_tile<kMinor>(src, wj, C, H, W, co0, oy0, ox0, bf16, si, sw, acc);
          const int y = oy0 + threadIdx.x / kTile, xx = ox0 + threadIdx.x % kTile;
          if (y < H && xx < W) {
            const int s = y * W + xx;
#pragma unroll
            for (int k = 0; k < kCoT; ++k) {
              const int co = co0 + k;
              if (co < C) {
                const size_t q = kMinor ? (size_t)s * C + co : (size_t)co * H * W + s;
                const float v = fmaxf(__fadd_rn(acc[k], bj[co]), 0.0f);
                dst[q] = __fadd_rn(src[q], __fmul_rn(v, 0.25f));
              }
            }
          }
        }
      }
    }
    __syncthreads();  // conv j's outputs are visible before conv j + 1 reads them
  }
}

}  // namespace

// x, out, tmp [P, C, S] (channel-major) or [P, S, C] (channel_minor = 1); w [P, J, C, 9C] or
// [P, J, 9C, C]; b [P, J, C].  Returns the launch's CUDA error.
extern "C" int dfd_res_chain(const float* x, const float* w, const float* b, float* out,
                             float* tmp, int P, int J, int C, int H, int W, int channel_minor,
                             int bf16, void* stream) {
  if (P <= 0 || J <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (channel_minor) {
    res_chain_kernel<true><<<P, kThreads, 0, s>>>(x, w, b, out, tmp, J, C, H, W, bf16);
  } else {
    res_chain_kernel<false><<<P, kThreads, 0, s>>>(x, w, b, out, tmp, J, C, H, W, bf16);
  }
  return (int)cudaGetLastError();
}
