// Chains of dependent float32 matrix products in one launch, for Hopper (sm_90a), with a plain
// C interface loaded through ctypes (dfd_tpu_torch/ops/gemm_chain.py).
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
// What bounds it on an H100: the FMAs, 2 M K N iters FLOPs at the 67 TFLOP/s of f32 outside
// the tensor cores (the products are full f32, never TF32), against (MK + KN + MN) * 4 bytes
// read or written once.  The design is the textbook shared-memory tiling: a block of 256
// threads owns a 64 x 64 output tile, each thread a 4 x 4 sub-tile in registers (rows
// ty + 16 i, columns tx + 16 j), and K advances 16 at a time through A and B tiles staged in
// shared memory, so each value read from shared memory feeds 4 FMAs.  Ragged M, K and N are
// masked at staging (zeros) and at the store.  This first version does not overlap a round's
// loads with the previous round's FMAs, so at the probes' shapes (a few blocks, one an SM)
// each 16-deep round waits on its loads and the kernel runs far below the FMA bound
// (PERF.md); keeping the operand panels in shared memory across iterations, as the TPU
// probe keeps them in VMEM, and cp.async or TMA loads are the next steps.
//
// Each iteration restages its tiles after __syncthreads(), a barrier the compiler does not
// move loads across, so the loop-invariant product of mode acc is computed `iters` times and
// not hoisted out of the loop.  In mode feed the dependency is grid-wide: y_i[0, 0] lives in
// the block that owns tile (0, 0), so the kernel is launched cooperatively and every
// iteration starts with cooperative_groups' grid sync; the value travels through a two-slot
// carry in device memory (iteration i writes slot i % 2, iteration i + 1 reads it, and the
// next write to that slot comes after another grid sync).  1 + y * 1e-20 rounds to 1 in f32
// for |y| < 6e12, so the scale is 1 at every shape the probes use, but the kernel applies it.
//
// Arithmetic: the K sum of each product by fmaf in k order, the iteration sum by __fadd_rn,
// the scale and 1 + y * 1e-20 by __fmul_rn / __fadd_rn (never contracted).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 64;                    // output rows and columns per block
constexpr int kDepth = 16;                   // K staged per round
constexpr int kSub = 4;                      // rows and columns per thread
constexpr int kSide = kTile / kSub;          // 16 x 16 threads
constexpr int kThreads = kSide * kSide;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
gemm_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, float* carry, int M, int K, int N, int iters,
                  float inv) {
  __shared__ float as[kDepth][kTile + 4];    // A tile stored k-major: as[k][row]
  __shared__ float bs[kDepth][kTile];
  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.0f;
  }
  for (int it = 0; it < iters; ++it) {
    float scale = 1.0f;
    if (kMode == 2 && it > 0) {
      cg::this_grid().sync();  // y_{it}[0, 0] is in the carry
      scale = __fadd_rn(1.0f, __fmul_rn(__ldcg(carry + ((it - 1) & 1)), 1e-20f));
    }
    float y[kSub][kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
#pragma unroll
      for (int j = 0; j < kSub; ++j) y[i][j] = 0.0f;
    }
    for (int k0 = 0; k0 < K; k0 += kDepth) {
      __syncthreads();  // the previous round's tiles are consumed
      for (int i = tid; i < kTile * kDepth; i += kThreads) {
        const int r = i / kDepth, c = i % kDepth, gr = row0 + r, gc = k0 + c;
        float v = (gr < M && gc < K) ? a[(size_t)gr * K + gc] : 0.0f;
        if (kMode == 2) v = __fmul_rn(v, scale);
        as[c][r] = v;
      }
      for (int i = tid; i < kDepth * kTile; i += kThreads) {
        const int r = i / kTile, c = i % kTile, gr = k0 + r, gc = col0 + c;
        bs[r][c] = (gr < K && gc < N) ? b[(size_t)gr * N + gc] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        float av[kSub], bv[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) av[i] = as[k][ty + kSide * i];
#pragma unroll
        for (int j = 0; j < kSub; ++j) bv[j] = bs[k][tx + kSide * j];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
#pragma unroll
          for (int j = 0; j < kSub; ++j) y[i][j] = fmaf(av[i], bv[j], y[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        if (kMode == 0) acc[i][j] = __fadd_rn(acc[i][j], y[i][j]);
        if (kMode == 1) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(y[i][j], inv));
        if (kMode == 2) acc[i][j] = y[i][j];
      }
    }
    if (kMode == 2 && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) carry[it & 1] = y[0][0];
  }
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = row0 + ty + kSide * i;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int c = col0 + tx + kSide * j;
      if (r < M && c < N) out[(size_t)r * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// carry: two floats of scratch, read only in mode 2.  Returns the launch's CUDA error.
extern "C" int dfd_gemm_chain(const float* a, const float* b, float* out, float* carry, int M,
                              int K, int N, int iters, int mode, float inv, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || iters <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile), block(kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      gemm_chain_kernel<0><<<grid, block, 0, s>>>(a, b, out, carry, M, K, N, iters, inv);
      break;
    case 1:
      gemm_chain_kernel<1><<<grid, block, 0, s>>>(a, b, out, carry, M, K, N, iters, inv);
      break;
    case 2: {
      // every block must be resident at once for the grid sync: a grid larger than the
      // card holds is refused here (cudaErrorCooperativeLaunchTooLarge)
      void* args[] = {&a, &b, &out, &carry, &M, &K, &N, &iters, &inv};
      const cudaError_t err = cudaLaunchCooperativeKernel((const void*)gemm_chain_kernel<2>,
                                                          grid, block, args, 0, s);
      if (err != cudaSuccess) return (int)err;
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
