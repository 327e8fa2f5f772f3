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
// 3.35 TB/s; they do no arithmetic worth counting.
//
// The roll and the strided copy (redesigned for Hopper) share one body, copy_rows: the copy
// is seen as rows of L output elements, row r = i0 * n1 + i1 reading x[i0 * s0 + i1 * s1 +
// src(c) * s2] for its column c (src(c) = c for a copy; (c - k) mod L for a roll by k).
// The plan (rows_plan, mirrored by relayout.py::rows_plan and refused by the C entries when
// the caller's differs):
//   - A strided view is collapsed first: size-1 axes dropped, an axis merged into the next
//     one where its stride is that axis's extent, so a contiguous view is one flat row and
//     x3[:, ::2, :] is rows of the last axis.  A roll along lanes is rows of cols, shifted
//     by k = shift; along rows it is one flat row shifted by k = shift * cols.
//   - width 4: output rows begin 16-byte aligned (L % 4 == 0, or one flat row, whose last
//     unit may be short and goes element by element) and each thread stores float4s;
//     vec_load also loads float4s, where the source is unit-stride and every element a
//     float4 gathers sits at a 16-byte boundary (x's address, s0, s1, k all multiples of 4
//     floats, and L too for a roll); otherwise four scalar loads feed the aligned store
//     (roll by 1, x[:, ::2]).  width 1 (rows of L % 4 != 0, which begin off 16 bytes):
//     scalar loads and stores, threads on consecutive columns.
//   - A row is walked by g threads (a power of two, at most 256), each taking `unroll` units
//     g apart.  A block holds 256 / g rows; blockIdx.x is a chunk of g * unroll units of a
//     row, blockIdx.y a run of rows, and rows advance in grid strides over gridDim.y (at most
//     65,535).  Where one unit a thread needs no more than kMaxBlocks blocks, unroll is 1 and
//     every unit has its own thread (small copies are latency, not bytes); beyond, unroll
//     is kUnroll, four independent loads in flight before the stores, and the grid stops
//     at about kMaxBlocks blocks, enough to fill the card.
//   - No division in the loop: a thread divides once for its first row's (i0, i1), and only
//     where n0 > 1; then the row's source base moves by fixed increments (the grid stride
//     split into whole runs of n1 on the host), with one carry from i1 into i0.
//   - 32-bit offsets where every offset the view reaches is below 2^31 - 4096; a 64-bit
//     form of the same kernels beyond.
// The element-wise gather and concat run one thread per output element in a grid-stride
// loop, neighbouring threads on neighbouring outputs, so every store is coalesced.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;         // a grid-stride loop over 16 blocks an SM
constexpr int kTr = 32;                      // transpose tile side
constexpr int kTrRows = 8;                   // transpose block: 32 x 8 threads
constexpr int kMaxScales = 8;
constexpr int kUnroll = 4;                   // units of a row a thread takes at once
constexpr int kMaxGridY = 65535;
constexpr long long kLimit32 = (1LL << 31) - 4096;  // the 32-bit forms' offsets stay below

struct Scales {
  float v[kMaxScales];
};

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

// The plan of a copy as rows (see the head of this file).
struct RowsPlan {
  long long n0, n1, L, s0, s1, s2, k;  // n0 x n1 rows of L; strides; the roll's shift
  int width, vec_load, wide, g;       // float4 or scalar units; float4 loads; 64-bit; threads a row
  int unroll;                         // units a thread takes of a row: 1 or kUnroll
  long long bx;                       // chunks of a row (gridDim.x)
  int by;                             // runs of rows (gridDim.y)
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

RowsPlan rows_plan(long long n0, long long n1, long long L, long long s0, long long s1,
                   long long s2, long long k, const float* x) {
  const long long rows = n0 * n1, reach = (n0 - 1) * s0 + (n1 - 1) * s1 + (L - 1) * s2;
  RowsPlan p = {n0, n1, L, s0, s1, s2, k, L % 4 == 0 || rows == 1 ? 4 : 1, 0, 0, 1, 1, 1, 1};
  const bool x_aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_load = p.width == 4 && s2 == 1 && k % 4 == 0 && (k == 0 || L % 4 == 0) && x_aligned &&
               (n0 == 1 || s0 % 4 == 0) && (n1 == 1 || s1 % 4 == 0);
  p.wide = rows * L > kLimit32 || reach >= kLimit32;
  const long long units = cdiv(L, p.width);
  while (p.g < kThreads && p.g < units) p.g *= 2;
  if (cdiv(units, p.g) * cdiv(rows * p.g, kThreads) > kMaxBlocks) {
    p.unroll = kUnroll;
    p.g = 1;
    while (p.g < kThreads && (long long)p.g * kUnroll < units) p.g *= 2;
  }
  p.bx = cdiv(units, (long long)p.g * p.unroll);
  const long long need = cdiv(rows * p.g, kThreads), fill = cdiv(kMaxBlocks, p.bx);
  p.by = (int)(need < fill ? (need < kMaxGridY ? need : kMaxGridY)
                           : (fill < kMaxGridY ? fill : kMaxGridY));
  return p;
}

// A view of up to three axes as rows: size-1 axes dropped, an axis merged into the next
// one where its stride is that axis's extent.
RowsPlan strided_copy_plan(const long long n[3], const long long s[3], const float* x) {
  long long cn[3] = {1, 1, 1}, cs[3] = {1, 0, 0};  // innermost first
  int d = 0;
  for (int i = 2; i >= 0; --i) {
    if (n[i] == 1) continue;
    if (d > 0 && s[i] == cs[d - 1] * cn[d - 1]) {
      cn[d - 1] *= n[i];
    } else {
      cn[d] = n[i];
      cs[d] = s[i];
      ++d;
    }
  }
  return rows_plan(cn[2], cn[1], cn[0], cs[2], cs[1], cs[0], 0, x);
}

template <typename I>
struct Rows {
  I n1, L, s0, s1, s2, k, rows, units;
  I q, rem;  // a grid stride of rows, as q whole runs of n1 and rem more
  int unroll;
};

// out[r, c] = x[i0 * s0 + i1 * s1 + src(c) * s2] for the rows r = i0 * n1 + i1 of this
// thread (see the head of this file); W elements a unit, VL: float4 loads, WRAP: a roll.
template <typename I, int W, bool VL, bool WRAP>
__device__ __forceinline__ void copy_rows(const float* __restrict__ x, float* __restrict__ out,
                                          const Rows<I>& a, int g_log2) {
  using U = typename std::make_unsigned<I>::type;  // offsets: wrap is defined past the end
  const int G = 1 << g_log2;
  const U per_block = kThreads >> g_log2, rows = (U)a.rows, n1 = (U)a.n1;
  U r = (U)blockIdx.y * per_block + (threadIdx.x >> g_log2);
  if (r >= rows) return;
  const U step = (U)gridDim.y * per_block;
  U i1 = r, src = r * (U)a.s1, dst = r * (U)a.L;  // n0 == 1: no division
  if (rows != n1) {
    i1 = r % n1;
    src = r / n1 * (U)a.s0 + i1 * (U)a.s1;
  }
  const U q = (U)a.q, rem = (U)a.rem;
  const U d_src = q * (U)a.s0 + rem * (U)a.s1, carry = (U)a.s0 - n1 * (U)a.s1;
  const U d_dst = step * (U)a.L;
  const I j0 = (I)blockIdx.x * (G * a.unroll) + (I)(threadIdx.x & (G - 1));
  for (; r < rows; r += step) {
    float v[kUnroll][W];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const I j = j0 + u * G;
      if (u < a.unroll && j < a.units) {
        const I c0 = j * W;
        if (VL && c0 + W <= a.L) {
          I c = c0;
          if constexpr (WRAP) {
            c -= a.k;
            if (c < 0) c += a.L;
          }
          const float4 t = __ldg(reinterpret_cast<const float4*>(x + (src + (U)c)));
          v[u][0] = t.x;
          v[u][1] = t.y;
          v[u][2] = t.z;
          v[u][3] = t.w;
        } else {
#pragma unroll
          for (int e = 0; e < W; ++e) {
            I c = c0 + e;
            if (c < a.L) {  // a flat row's short last unit
              if constexpr (WRAP) {
                c -= a.k;
                if (c < 0) c += a.L;
              }
              v[u][e] = __ldg(x + (src + (U)c * (U)a.s2));
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const I j = j0 + u * G;
      if (u < a.unroll && j < a.units) {
        const I c0 = j * W;
        float* o = out + (dst + (U)c0);
        if (W == 4 && c0 + W <= a.L) {
          *reinterpret_cast<float4*>(o) = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
        } else {
#pragma unroll
          for (int e = 0; e < W; ++e) {
            if (c0 + e < a.L) o[e] = v[u][e];
          }
        }
      }
    }
    dst += d_dst;
    src += d_src;
    i1 += rem;
    if (i1 >= n1) {
      i1 -= n1;
      src += carry;
    }
  }
}

template <typename I, int W, bool VL>
__global__ void __launch_bounds__(kThreads)
roll_kernel(const float* __restrict__ x, float* __restrict__ out, Rows<I> a, int g_log2) {
  copy_rows<I, W, VL, true>(x, out, a, g_log2);
}

template <typename I, int W, bool VL>
__global__ void __launch_bounds__(kThreads)
strided_copy_kernel(const float* __restrict__ x, float* __restrict__ out, Rows<I> a,
                    int g_log2) {
  copy_rows<I, W, VL, false>(x, out, a, g_log2);
}

template <bool WRAP, typename I, int W, bool VL>
void launch_form(const float* x, float* out, const RowsPlan& p, cudaStream_t stream) {
  const long long step = (long long)p.by * (kThreads / p.g);
  const Rows<I> a = {(I)p.n1, (I)p.L, (I)p.s0, (I)p.s1, (I)p.s2, (I)p.k, (I)(p.n0 * p.n1),
                     (I)((p.L + W - 1) / W), (I)(step / p.n1), (I)(step % p.n1), p.unroll};
  int g_log2 = 0;
  while ((1 << g_log2) < p.g) ++g_log2;
  const dim3 grid((unsigned)p.bx, (unsigned)p.by);
  if constexpr (WRAP) {
    roll_kernel<I, W, VL><<<grid, kThreads, 0, stream>>>(x, out, a, g_log2);
  } else {
    strided_copy_kernel<I, W, VL><<<grid, kThreads, 0, stream>>>(x, out, a, g_log2);
  }
}

template <bool WRAP, typename I>
void launch_rows(const float* x, float* out, const RowsPlan& p, cudaStream_t stream) {
  if (p.width == 1) {
    launch_form<WRAP, I, 1, false>(x, out, p, stream);
  } else if (p.vec_load) {
    launch_form<WRAP, I, 4, true>(x, out, p, stream);
  } else {
    launch_form<WRAP, I, 4, false>(x, out, p, stream);
  }
}

// Refuses a plan other than rows_plan's, and a float4 route whose output is not 16-byte
// aligned; else launches.
template <bool WRAP>
int run_rows(const float* x, float* out, const RowsPlan& p, int width, int vec_load, int wide,
             int g, int unroll, long long bx, int by, void* stream) {
  if (p.width != width || p.vec_load != vec_load || p.wide != wide || p.g != g ||
      p.unroll != unroll || p.bx != bx || p.by != by || (width == 4 && reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (wide) {
    launch_rows<WRAP, long long>(x, out, p, (cudaStream_t)stream);
  } else {
    launch_rows<WRAP, int>(x, out, p, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

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

// width .. by: the plan of relayout.py::roll_plan, refused unless it is rows_plan's.
extern "C" int dfd_roll(const float* x, float* out, long long rows, long long cols,
                        long long shift, int axis, int width, int vec_load, int wide, int g,
                        int unroll, long long bx, int by, void* stream) {
  const long long len = axis == 0 ? rows : cols;
  if (rows <= 0 || cols <= 0 || (axis != 0 && axis != 1) || shift < 0 || shift >= len)
    return (int)cudaErrorInvalidValue;
  // along rows: one flat row shifted by whole rows; along lanes: rows of cols
  const RowsPlan p = axis == 0 ? rows_plan(1, 1, rows * cols, 0, 0, 1, shift * cols, x)
                               : rows_plan(1, rows, cols, 0, cols, 1, shift, x);
  return run_rows<true>(x, out, p, width, vec_load, wide, g, unroll, bx, by, stream);
}

// width .. by: the plan of relayout.py::strided_copy_plan, refused unless it is rows_plan's.
extern "C" int dfd_strided_copy(const float* x, float* out, long long n0, long long n1,
                                long long n2, long long s0, long long s1, long long s2,
                                int width, int vec_load, int wide, int g, int unroll,
                                long long bx, int by, void* stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0 || s0 < 0 || s1 < 0 || s2 < 0)
    return (int)cudaErrorInvalidValue;
  const long long n[3] = {n0, n1, n2}, s[3] = {s0, s1, s2};
  return run_rows<false>(x, out, strided_copy_plan(n, s, x), width, vec_load, wide, g, unroll,
                         bx, by, stream);
}

// An empty kernel of one block of 32 threads: the card's cost of a launch.
extern "C" int dfd_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
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
