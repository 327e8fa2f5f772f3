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
//   dfd_transpose:     out = x^T of a 2-D x (k_transpose);
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
//
// The transpose (redesigned for Hopper; plan transpose_plan, mirrored by
// relayout.py::transpose_plan and refused by the C entry when the caller's differs):
//   - Tiles of tr x tc = 4096 elements of x, square unless x is skinny: [16, S] takes
//     16 x 256, [S, 16] 256 x 16, so no tile is half empty.  Where that leaves fewer than
//     two tiles an SM (the probes' [16, 4096] and [48, 1024]), a launch's latency decides,
//     and tiles of 64 x 16 were the fastest on an H100 (tools/torch_relayout_variants.py).
//     A block of tr * tc / 16 threads walks the tiles in a linear tile index, in grid
//     strides, so no dimension of the grid limits the shape.  The grid
//     is at most kMaxBlocks: 16 blocks an SM, of which 4 of 256 threads stay resident, so
//     blocks start and end at staggered times (on an H100 a resident grid of 528 reached
//     0.82 of the bytes bound at x [33280, 1024], this one 0.85:
//     tools/torch_relayout_variants.py).
//   - A two-stage ring in shared memory: the next tile's cp.async loads are in flight while
//     the current tile is stored.  Loads are 16-byte cp.async where x's rows are 16-byte
//     aligned (cols % 4 == 0 and x aligned), else 4-byte ones.  Each thread then reads a
//     4 x 4 block of the tile as four float4s, transposes it in registers and stores four
//     float4s to out's rows where they are aligned (rows % 4 == 0), else 16 scalars.
//   - The stage keeps x's layout, its float4 units XOR-swizzled (unit u at u ^ key(u), key
//     from the unit's 4-row group): neither the loads' rows nor the stores' 4 x 4 columns
//     hit one bank group twice in a quarter warp (padding would break float4 alignment).
//   - 32-bit offsets where rows * cols is below 2^31 - 4096; a 64-bit form beyond.
// The gather (redesigned for Hopper; plan gather_cols_plan, mirrored and enforced alike):
//   - Each thread owns one unit of output columns (four where n_idx % 4 == 0, stored as a
//     float4; else one), reads their indices once into registers, and walks rows in grid
//     strides, `unroll` rows at a time: every gathered load of those rows is issued before
//     any store.  No division anywhere: a row's base moves by fixed increments.
//   - g threads a row (a power of two, at most 256) cover a chunk of units (blockIdx.x);
//     runs of rows go over blockIdx.y (at most 65,535) and loop in grid strides.
//   - 32- or 64-bit offsets, as the transpose.
// The concat (redesigned for Hopper; plan concat_plan, mirrored by relayout.py::concat_plan
// and refused by the C entry when the caller's differs) moves exactly the bound's bytes:
//   - x is read once.  Each thread owns one unit of x, a float4 where n % 4 == 0 and x is
//     16-byte aligned (every segment out + s * n then begins aligned too, out being aligned),
//     else one element; it loads it, then stores its k products, one to each segment.  A
//     segment's offset is the last one's plus n: no division anywhere.
//   - A block of kCatThreads for every kCatThreads units: no grid-stride loop.  On an H100 at
//     x [33280, 1024] (tools/torch_relayout_variants.py) a grid of 2,112 blocks looping with
//     4 units a thread was 3-22 % slower, 2 or 4 units a thread 0.4-20 % slower, 128 or 512
//     threads a block within 1.5 %, and at the probe's x [128, 1024] the scales over
//     blockIdx.y (x in L2, k times the blocks) 1-4 % slower.
//   - float4 stores evict-first (st.global.cs): nothing rereads the output (0.3-0.8 % faster
//     there); scalar stores plain (evict-first lost 0.8-2.6 %).
//   - 32-bit offsets where k * n is below 2^31 - 4096; a 64-bit form beyond.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;         // a grid-stride loop over 16 blocks an SM
constexpr int kTrArea = 4096;                // transpose tile: elements
constexpr int kTrSmallRows = 64, kTrSmallCols = 16;  // the tile where kTrArea's leave < 2 an SM
constexpr int kTrThreads = kTrArea / 16;     // a block: one 4 x 4 block of the tile a thread
constexpr int kTrBlocksPerSM = 4;            // resident transpose blocks: <= 64 registers
constexpr int kSMs = 132;
constexpr int kMaxScales = 8;
constexpr int kUnroll = 4;                   // units of a row a thread takes at once
constexpr int kMaxGridY = 65535;
constexpr long long kLimit32 = (1LL << 31) - 4096;  // the 32-bit forms' offsets stay below
constexpr int kCatThreads = 256;             // a concat block

struct Scales {
  float v[kMaxScales];
};

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

// -- cp.async ------------------------------------------------------------------------------

// Wait for every group of this thread's cp.async but the last committed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// -- the gather ----------------------------------------------------------------------------

template <typename I>
struct Gather {
  I rows, cols, n_idx, units;
  int unroll;  // rows a thread takes at once: 1 or kUnroll
};

// out[r, j * W + e] = x[r, idx[j * W + e]] for this thread's unit j, over its rows (see the
// head of this file).
template <typename I, int W>
__global__ void __launch_bounds__(kThreads)
gather_cols_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   float* __restrict__ out, Gather<I> a, int g_log2) {
  using U = typename std::make_unsigned<I>::type;  // offsets: wrap is defined past the end
  const int G = 1 << g_log2;
  const U per_block = kThreads >> g_log2, rows = (U)a.rows;
  const U j = (U)blockIdx.x * G + (threadIdx.x & (G - 1));
  U r = (U)blockIdx.y * per_block + (threadIdx.x >> g_log2);
  if (j >= (U)a.units || r >= rows) return;
  U c[W];
  bool ok[W];
#pragma unroll
  for (int e = 0; e < W; ++e) {
    const int k = __ldg(idx + (j * W + e));
    ok[e] = k >= 0 && (I)k < a.cols;
    c[e] = ok[e] ? (U)k : 0;
  }
  const U step = (U)gridDim.y * per_block, d_src = step * (U)a.cols, d_dst = step * (U)a.n_idx;
  U src = r * (U)a.cols, dst = r * (U)a.n_idx + j * W;
  for (; r < rows; r += a.unroll * step, src += a.unroll * d_src, dst += a.unroll * d_dst) {
    float v[kUnroll][W];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < a.unroll && r + u * step < rows) {
        const float* row = x + (src + u * d_src);
#pragma unroll
        for (int e = 0; e < W; ++e) v[u][e] = ok[e] ? __ldg(row + c[e]) : CUDART_NAN_F;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < a.unroll && r + u * step < rows) {
        float* o = out + (dst + u * d_dst);
        if constexpr (W == 4) {
          *reinterpret_cast<float4*>(o) = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
        } else {
          o[0] = v[u][0];
        }
      }
    }
  }
}

// -- the transpose -------------------------------------------------------------------------

template <typename I>
struct Tr {
  I rows, cols, tiles_c, tiles;  // tiles_c tiles a tile row, tiles in all
  I q, rem;                      // a grid stride of tiles: q tile rows and rem tiles
  int tr_log2, w_log2;           // tr = 2^tr_log2 rows; tc / 4 = 2^w_log2 float4 units
  int key_shift;                 // 1 where tr = 16 (4 row groups spread over 3 key bits)
};

// Where a stage keeps its float4 unit u = row * tc / 4 + b: u ^ key, the key taken from the
// row's 4-row group.  A quarter warp of loads (8 units of a row, or 2 rows of 4 units) and of
// the store phase's reads (one unit of 8 row groups, or of 4 groups in 2 units where tr = 16)
// then meets 8 different bank groups.
__device__ __forceinline__ int swizzle(int u, int w_log2, int key_shift) {
  return u ^ (((u >> (w_log2 + 2)) << key_shift) & 7);
}

// Issue the loads of tile (ti, tj) into the stage st: 4 units a thread, neighbouring threads
// on neighbouring units of a row.
template <typename I, bool VL>
__device__ __forceinline__ void load_tile(const float* __restrict__ x, float4* st,
                                          const Tr<I>& a,
                                          typename std::make_unsigned<I>::type ti,
                                          typename std::make_unsigned<I>::type tj) {
  using U = typename std::make_unsigned<I>::type;
  const U r0 = ti << a.tr_log2, c0 = tj << (a.w_log2 + 2), rows = (U)a.rows, cols = (U)a.cols;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int u = threadIdx.x + k * blockDim.x;
    const U r = r0 + (U)(u >> a.w_log2), c = c0 + 4 * (U)(u & ((1 << a.w_log2) - 1));
    if (r < rows) {
      float* dst = reinterpret_cast<float*>(st + swizzle(u, a.w_log2, a.key_shift));
      const float* src = x + (r * cols + c);
      if constexpr (VL) {
        if (c < cols) cp_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < cols) cp_async4(dst + e, src + e);
        }
      }
    }
  }
}

// Store tile (ti, tj) from the stage st: a thread's 4 x 4 block, x's rows r..r+3 and columns
// c..c+3, read as four float4s and written to out's rows c..c+3 at columns r..r+3;
// neighbouring threads on neighbouring columns of out.
template <typename I, bool VS>
__device__ __forceinline__ void store_tile(float* __restrict__ out, const float4* st,
                                           const Tr<I>& a,
                                           typename std::make_unsigned<I>::type ti,
                                           typename std::make_unsigned<I>::type tj) {
  using U = typename std::make_unsigned<I>::type;
  const int a4 = threadIdx.x & ((1 << (a.tr_log2 - 2)) - 1), b = threadIdx.x >> (a.tr_log2 - 2);
  float v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = st[swizzle(((4 * a4 + i) << a.w_log2) + b, a.w_log2, a.key_shift)];
    v[i][0] = t.x;
    v[i][1] = t.y;
    v[i][2] = t.z;
    v[i][3] = t.w;
  }
  const U rows = (U)a.rows, r = (ti << a.tr_log2) + 4 * (U)a4;
  const U c = (tj << (a.w_log2 + 2)) + 4 * (U)b;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (c + e < (U)a.cols) {
      float* o = out + ((c + e) * rows + r);
      if constexpr (VS) {
        if (r < rows) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0][e], v[1][e], v[2][e], v[3][e]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (r + i < rows) o[i] = v[i][e];
        }
      }
    }
  }
}

// out = x^T through a two-stage ring of tiles (see the head of this file).  VL: 16-byte
// loads; VS: float4 stores.
template <typename I, bool VL, bool VS>
__global__ void __launch_bounds__(kTrThreads, kTrBlocksPerSM)
transpose_kernel(const float* __restrict__ x, float* __restrict__ out, Tr<I> a) {
  using U = typename std::make_unsigned<I>::type;
  extern __shared__ float4 ring[];  // two stages of tr * tc / 4 units
  const int units = 4 * blockDim.x;
  const U tiles_c = (U)a.tiles_c, tiles = (U)a.tiles;
  U t = blockIdx.x, ti = t / tiles_c, tj = t - ti * tiles_c;  // the grid holds <= tiles blocks
  load_tile<I, VL>(x, ring, a, ti, tj);
  cp_async_commit();
  for (int s = 0;; s ^= 1) {
    t += gridDim.x;
    U ni = ti + (U)a.q, nj = tj + (U)a.rem;
    if (nj >= tiles_c) {
      nj -= tiles_c;
      ++ni;
    }
    const bool more = t < tiles;  // the same for every thread of the block
    if (more) load_tile<I, VL>(x, ring + (s ^ 1) * units, a, ni, nj);
    cp_async_commit();
    cp_async_wait_prior();  // this tile's loads have landed
    __syncthreads();
    store_tile<I, VS>(out, ring + s * units, a, ti, tj);
    if (!more) break;
    __syncthreads();  // the stage is read before the loads after next overwrite it
    ti = ni;
    tj = nj;
  }
}

// The plan of a gather (see the head of this file).
struct GatherPlan {
  int width, wide, g, unroll;  // columns a unit; 64-bit offsets; threads a row; rows at once
  long long bx;                // chunks of g units (gridDim.x)
  int by;                      // runs of kThreads / g rows (gridDim.y)
};

GatherPlan gather_cols_plan(long long rows, long long cols, long long n_idx) {
  GatherPlan p = {n_idx % 4 == 0 ? 4 : 1, rows * cols > kLimit32 || rows * n_idx > kLimit32,
                  1, 1, 1, 1};
  const long long units = n_idx / p.width;
  while (p.g < kThreads && p.g < units) p.g *= 2;
  p.bx = cdiv(units, p.g);
  const long long need = cdiv(rows * p.g, kThreads), fill = cdiv(kMaxBlocks, p.bx);
  if (p.bx * need > kMaxBlocks) p.unroll = kUnroll;
  p.by = (int)(need < fill ? (need < kMaxGridY ? need : kMaxGridY)
                           : (fill < kMaxGridY ? fill : kMaxGridY));
  return p;
}

template <typename I, int W>
void launch_gather(const float* x, const int* idx, float* out, long long rows, long long cols,
                   long long n_idx, const GatherPlan& p, cudaStream_t stream) {
  const Gather<I> a = {(I)rows, (I)cols, (I)n_idx, (I)(n_idx / W), p.unroll};
  int g_log2 = 0;
  while ((1 << g_log2) < p.g) ++g_log2;
  gather_cols_kernel<I, W><<<dim3((unsigned)p.bx, (unsigned)p.by), kThreads, 0, stream>>>(
      x, idx, out, a, g_log2);
}

// The plan of a transpose (see the head of this file).
struct TrPlan {
  int tr, tc;                     // the tile: rows x columns of x
  int vec_load, vec_store, wide;  // 16-byte loads; float4 stores; 64-bit offsets
  int grid;                       // blocks, each walking tiles in grid strides
};

TrPlan transpose_plan(long long rows, long long cols, const float* x) {
  TrPlan p = {};
  // 64 x 64 unless x is thinner than that, then as thin as x allows (at least 16)
  if (rows < 64 || cols < 64) {
    int thin = 16;
    while (thin < (rows < 64 ? rows : cols)) thin *= 2;
    p.tr = rows < 64 ? thin : kTrArea / thin;
  } else {
    p.tr = 64;
  }
  p.tc = kTrArea / p.tr;
  long long tiles = cdiv(rows, p.tr) * cdiv(cols, p.tc);
  if (tiles < 2 * kSMs) {  // a launch's latency decides
    p.tr = kTrSmallRows;
    p.tc = kTrSmallCols;
    tiles = cdiv(rows, p.tr) * cdiv(cols, p.tc);
  }
  p.vec_load = cols % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_store = rows % 4 == 0;
  p.wide = rows * cols > kLimit32;
  p.grid = (int)(tiles < kMaxBlocks ? tiles : kMaxBlocks);
  return p;
}

bool differs(const TrPlan& p, const TrPlan& q) {
  return p.tr != q.tr || p.tc != q.tc || p.vec_load != q.vec_load ||
         p.vec_store != q.vec_store || p.wide != q.wide || p.grid != q.grid;
}

template <typename I, bool VL, bool VS>
void launch_transpose_form(const float* x, float* out, long long rows, long long cols,
                           const TrPlan& p, cudaStream_t stream) {
  const long long tiles_c = cdiv(cols, p.tc), tiles = cdiv(rows, p.tr) * tiles_c;
  int tr_log2 = 0, w_log2 = 0;
  while ((1 << tr_log2) < p.tr) ++tr_log2;
  while ((4 << w_log2) < p.tc) ++w_log2;
  const Tr<I> a = {(I)rows, (I)cols, (I)tiles_c, (I)tiles, (I)(p.grid / tiles_c),
                   (I)(p.grid % tiles_c), tr_log2, w_log2, p.tr == 16 ? 1 : 0};
  transpose_kernel<I, VL, VS><<<p.grid, p.tr * p.tc / 16, 2 * p.tr * p.tc * sizeof(float),
                                stream>>>(x, out, a);
}

template <typename I>
void launch_transpose(const float* x, float* out, long long rows, long long cols,
                      const TrPlan& p, cudaStream_t stream) {
  if (p.vec_load && p.vec_store) {
    launch_transpose_form<I, true, true>(x, out, rows, cols, p, stream);
  } else if (p.vec_load) {
    launch_transpose_form<I, true, false>(x, out, rows, cols, p, stream);
  } else if (p.vec_store) {
    launch_transpose_form<I, false, true>(x, out, rows, cols, p, stream);
  } else {
    launch_transpose_form<I, false, false>(x, out, rows, cols, p, stream);
  }
}

// -- the concat ----------------------------------------------------------------------------

template <int W>
struct Vec {
  using T = float;
};
template <>
struct Vec<4> {
  using T = float4;
};

__device__ __forceinline__ float mul(float v, float f) { return __fmul_rn(v, f); }
__device__ __forceinline__ float4 mul(float4 v, float f) {
  return make_float4(__fmul_rn(v.x, f), __fmul_rn(v.y, f), __fmul_rn(v.z, f), __fmul_rn(v.w, f));
}

// The concat's stores: float4s evict-first, scalars plain (see the head of this file).
__device__ __forceinline__ void put(float4* p, float4 v) { __stcs(p, v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

template <typename I>
struct Cat {
  I units;  // x's units of W floats, a segment of out
  int k;    // scales
  Scales s;
};

// out = concat([x * s_0, ..., x * s_{k-1}]) in units of W floats (see the head of this file).
template <typename I, int W>
__global__ void __launch_bounds__(kCatThreads)
concat_scaled_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const __grid_constant__ Cat<I> a) {
  using U = typename std::make_unsigned<I>::type;  // offsets: wrap is defined past the end
  using T = typename Vec<W>::T;
  const U units = (U)a.units, j = (U)blockIdx.x * kCatThreads + threadIdx.x;
  if (j >= units) return;
  const T v = __ldg(reinterpret_cast<const T*>(x) + j);
  T* os = reinterpret_cast<T*>(out);
  U o = j;  // this thread's unit in segment s
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s == a.k) break;
    put(os + o, mul(v, a.s.v[s]));
    o += units;
  }
}

// The plan of a concat (see the head of this file).
struct CatPlan {
  int width, wide;  // floats a unit (4 or 1); 64-bit offsets
  int grid;         // blocks of kCatThreads, a thread a unit
};

CatPlan concat_plan(long long n, int k, const float* x) {
  CatPlan p = {};
  p.width = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? 4 : 1;
  p.wide = (long long)k * n > kLimit32;
  p.grid = (int)cdiv(n / p.width, kCatThreads);
  return p;
}

template <typename I, int W>
void launch_concat(const float* x, float* out, long long n, int k, const Scales& s, int grid,
                   cudaStream_t stream) {
  const Cat<I> a = {(I)(n / W), k, s};
  concat_scaled_kernel<I, W><<<grid, kCatThreads, 0, stream>>>(x, out, a);
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

// width .. by: the plan of relayout.py::gather_cols_plan, refused unless it is
// gather_cols_plan's.  cols may be 0: every index is then outside and gives NaN.
extern "C" int dfd_gather_cols(const float* x, const int* idx, float* out, long long rows,
                               long long cols, long long n_idx, int width, int wide, int g,
                               int unroll, long long bx, int by, void* stream) {
  if (rows <= 0 || cols < 0 || n_idx <= 0) return (int)cudaErrorInvalidValue;
  const GatherPlan p = gather_cols_plan(rows, cols, n_idx);
  if (p.width != width || p.wide != wide || p.g != g || p.unroll != unroll || p.bx != bx ||
      p.by != by || (width == 4 && reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (wide) {
    if (width == 4) launch_gather<long long, 4>(x, idx, out, rows, cols, n_idx, p, s);
    else launch_gather<long long, 1>(x, idx, out, rows, cols, n_idx, p, s);
  } else {
    if (width == 4) launch_gather<int, 4>(x, idx, out, rows, cols, n_idx, p, s);
    else launch_gather<int, 1>(x, idx, out, rows, cols, n_idx, p, s);
  }
  return (int)cudaGetLastError();
}

// tr .. grid: the plan of relayout.py::transpose_plan, refused unless it is transpose_plan's.
extern "C" int dfd_transpose(const float* x, float* out, long long rows, long long cols, int tr,
                             int tc, int vec_load, int vec_store, int wide, int grid,
                             void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const TrPlan p = transpose_plan(rows, cols, x);
  const TrPlan q = {tr, tc, vec_load, vec_store, wide, grid};
  if (differs(p, q) || (vec_store && reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (wide) {
    launch_transpose<long long>(x, out, rows, cols, q, (cudaStream_t)stream);
  } else {
    launch_transpose<int>(x, out, rows, cols, q, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// width .. grid: the plan of relayout.py::concat_plan, refused unless it is concat_plan's.
extern "C" int dfd_concat_scaled(const float* x, float* out, long long n, const float* scales,
                                 int n_scales, int width, int wide, int grid, void* stream) {
  if (n <= 0 || n_scales <= 0 || n_scales > kMaxScales) return (int)cudaErrorInvalidValue;
  const CatPlan p = concat_plan(n, n_scales, x);
  if (p.width != width || p.wide != wide || p.grid != grid ||
      (width == 4 && reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  Scales s{};
  for (int k = 0; k < n_scales; ++k) s.v[k] = scales[k];  // host memory
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide) {
    if (width == 4) launch_concat<long long, 4>(x, out, n, n_scales, s, grid, st);
    else launch_concat<long long, 1>(x, out, n, n_scales, s, grid, st);
  } else {
    if (width == 4) launch_concat<int, 4>(x, out, n, n_scales, s, grid, st);
    else launch_concat<int, 1>(x, out, n, n_scales, s, grid, st);
  }
  return (int)cudaGetLastError();
}
