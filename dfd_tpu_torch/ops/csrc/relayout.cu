// Data-movement kernels for Hopper (sm_90a), with a plain C interface loaded through ctypes
// (dfd_tpu_torch/ops/relayout.py).  All move float32 values and compute nothing else, so
// every output is bit-exact against its PyTorch expression.
//
// Replaces the Pallas TPU probe kernels of tools/probe_pallas_torso.py::main and
// tools/probe_pallas_pool.py::main, which asked what Mosaic can lower for a fused IMPALA
// torso's relayouts:
//
//   dfd_roll:          out = roll(x, shift, axis) of a 2-D x (pltpu.roll on lanes or
//                      sublanes: roll_lanes, roll_sublanes, roll_lanes64);
//   dfd_strided_copy:  out = a contiguous copy of a strided view of up to three axes (the
//                      strided slices x[::2, :], x[:, ::2], x3[:, ::2, :], lax.slice with
//                      stride 2, and the reshape copy [128, 1024] -> [128, 16, 64]);
//   dfd_gather_cols:   out[r, j] = x[r, idx[j]] (k_take: jnp.take on lanes by an int32
//                      index vector); an index outside [0, cols) gives NaN;
//   dfd_transpose:     out = x^T of a 2-D x (k_transpose) through 32 x 32 shared-memory
//                      tiles, padded to 33 columns so that neither the row-wise load nor the
//                      column-wise store has bank conflicts;
//   dfd_concat_scaled: out = concat([x * s_0, x * s_1, ...], axis 0) (concat_sublanes with
//                      scales 1, 2, 3), each product rounded once (__fmul_rn).
//
// What bounds them on an H100: bytes, each input read once and each output written once at
// 3.35 TB/s; they do no arithmetic worth counting.  The element-wise ones run one thread
// per output element in a grid-stride loop, neighbouring threads on neighbouring outputs,
// so every store is coalesced; the roll and the strided copies read with the same stride
// as they write along the last axis where the view allows it.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;         // a grid-stride loop over 16 blocks an SM
constexpr int kTr = 32;                      // transpose tile side
constexpr int kTrRows = 8;                   // transpose block: 32 x 8 threads
constexpr int kMaxScales = 8;

struct Scales {
  float v[kMaxScales];
};

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads)
roll_kernel(const float* __restrict__ x, float* __restrict__ out, long long rows,
            long long cols, long long shift, int axis) {
  const long long n = rows * cols;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long r = i / cols, c = i % cols;
    if (axis == 0) {
      r -= shift;
      if (r < 0) r += rows;
    } else {
      c -= shift;
      if (c < 0) c += cols;
    }
    out[i] = x[r * cols + c];
  }
}

__global__ void __launch_bounds__(kThreads)
strided_copy_kernel(const float* __restrict__ x, float* __restrict__ out, long long n0,
                    long long n1, long long n2, long long s0, long long s1, long long s2) {
  const long long n = n0 * n1 * n2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long i2 = i % n2, i1 = (i / n2) % n1, i0 = i / (n1 * n2);
    out[i] = x[i0 * s0 + i1 * s1 + i2 * s2];
  }
}

__global__ void __launch_bounds__(kThreads)
gather_cols_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   float* __restrict__ out, long long rows, long long cols, long long n_idx) {
  const long long n = rows * n_idx;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / n_idx, j = i % n_idx;
    const int c = idx[j];
    out[i] = (c >= 0 && c < cols) ? x[r * cols + c] : CUDART_NAN_F;
  }
}

// blockIdx.x: tile of x's columns, blockIdx.y: tile of x's rows
__global__ void __launch_bounds__(kTr * kTrRows)
transpose_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int cols) {
  __shared__ float tile[kTr][kTr + 1];
  const int c0 = blockIdx.x * kTr, r0 = blockIdx.y * kTr;
  for (int j = threadIdx.y; j < kTr; j += kTrRows) {
    const int r = r0 + j, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[j][threadIdx.x] = x[(size_t)r * cols + c];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < kTr; j += kTrRows) {
    const int r = c0 + j, c = r0 + threadIdx.x;  // out is [cols, rows]
    if (r < cols && c < rows) out[(size_t)r * rows + c] = tile[threadIdx.x][j];
  }
}

__global__ void __launch_bounds__(kThreads)
concat_scaled_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                     int n_scales, Scales scales) {
  const long long total = n * n_scales;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = __fmul_rn(x[i % n], scales.v[i / n]);
  }
}

}  // namespace

extern "C" int dfd_roll(const float* x, float* out, long long rows, long long cols,
                        long long shift, int axis, void* stream) {
  const long long len = axis == 0 ? rows : cols;
  if (rows <= 0 || cols <= 0 || (axis != 0 && axis != 1) || shift < 0 || shift >= len)
    return (int)cudaErrorInvalidValue;
  roll_kernel<<<blocks_for(rows * cols), kThreads, 0, (cudaStream_t)stream>>>(x, out, rows,
                                                                              cols, shift, axis);
  return (int)cudaGetLastError();
}

extern "C" int dfd_strided_copy(const float* x, float* out, long long n0, long long n1,
                                long long n2, long long s0, long long s1, long long s2,
                                void* stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
  strided_copy_kernel<<<blocks_for(n0 * n1 * n2), kThreads, 0, (cudaStream_t)stream>>>(
      x, out, n0, n1, n2, s0, s1, s2);
  return (int)cudaGetLastError();
}

extern "C" int dfd_gather_cols(const float* x, const int* idx, float* out, long long rows,
                               long long cols, long long n_idx, void* stream) {
  if (rows <= 0 || cols <= 0 || n_idx <= 0) return (int)cudaErrorInvalidValue;
  gather_cols_kernel<<<blocks_for(rows * n_idx), kThreads, 0, (cudaStream_t)stream>>>(
      x, idx, out, rows, cols, n_idx);
  return (int)cudaGetLastError();
}

extern "C" int dfd_transpose(const float* x, float* out, int rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + kTr - 1) / kTr, (rows + kTr - 1) / kTr), block(kTr, kTrRows);
  transpose_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, out, rows, cols);
  return (int)cudaGetLastError();
}

extern "C" int dfd_concat_scaled(const float* x, float* out, long long n, const float* scales,
                                 int n_scales, void* stream) {
  if (n <= 0 || n_scales <= 0 || n_scales > kMaxScales) return (int)cudaErrorInvalidValue;
  Scales s{};
  for (int k = 0; k < n_scales; ++k) s.v[k] = scales[k];  // host memory
  concat_scaled_kernel<<<blocks_for(n * n_scales), kThreads, 0, (cudaStream_t)stream>>>(
      x, out, n, n_scales, s);
  return (int)cudaGetLastError();
}
