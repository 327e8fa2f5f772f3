// The TPU probes' fused residual-conv chain on Hopper's tensor cores (sm_90a), with a plain C
// interface loaded through ctypes (dfd_tpu_torch/ops/res_chain.py).
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
// x + dx - 1].  Two layouts:
//
//   channel-major (kMinor = false, the probes' "N-major"): x [P, C, S], W [P, J, C, 9C];
//   channel-minor (kMinor = true,  the probes' "M-major"): x [P, S, C], W [P, J, 9C, C];
//
// b [P, J, C] in both, S = H * W.  With bf16 on, both conv operands (x as the conv reads it and
// the weights) are rounded to bf16 and the products summed in f32, as the probes' bf16 dot with
// preferred_element_type=float32 does; the residual x itself stays f32.
//
// What bounds it on an H100: operations.  At the wide probe's 128 channels x 16 x 16 and P = 64
// a chain is 19.3 GFLOP (0.117 ms as f32-accurate 3xTF32 products at 165 TFLOP/s, 0.0195 ms in
// bf16 at 989) against 151 MB of per-member f32 weights (45 us at 3.35 TB/s).  The first
// CUDA-core kernel of this chain ran one block per member (64 of 132 SMs), every product an f32
// FMA, and the chain's intermediates through device memory.  The design, that of the torso
// kernels (fused_resblock_tf32.cu, fused_resblock_mma.cu):
//
// 1. Tensor cores.  Each conv is an implicit GEMM, out[co][n] = sum over K = (tap, c) of
//    W[co][tap, c] * X[n + shift(tap)][c], through mma.sync: bf16 as m16n8k16 with f32 sums
//    carried by the tensor cores; f32 as 3xTF32 m16n8k8 (each operand split a = hi + lo by
//    cvt.rna.tf32.f32, lo * hi + hi * lo + hi * hi into a fresh sum each k8 step, added to the
//    f32 sum by __fadd_rn), which kept the torso within 8e-7 of the output's scale.  X is a
//    halo-padded tile in shared memory, position-major ([pos][c], row stride ts with ts / 2 or
//    ts 4 mod 32 words, so a fragment's 8 positions x 4 channels fall on distinct banks), so a
//    tap is an offset of each lane's position.  Fragments are plain shared loads: channel-minor
//    weights ([9C, C], K-major) are read with the index swapped, channel-minor x is already the
//    position-major tile.
// 2. Enough blocks.  A cluster of cl = rs * cs blocks a member (1, 2, 4 or 8): rs bands of image
//    rows times cs groups of output channels.  The plan takes the cluster with the least work
//    per block after the waves (ceil(P * cl / 132) / cl: P = 64 gets one full wave of 128
//    blocks or more), then, of its splits that fit, the one that moves the fewest weight bytes
//    (each of the rs bands streams its group's weights whole: the weights are 590 KB a conv at
//    128 channels in f32, far more than the activations), then the fewest blocks.  A channel
//    split needs every channel of the band's operand in each block, so it fits only where the
//    whole tile does (bf16 at 128 x 16 x 16, f32 at 16 channels); the wide probe's f32 128-ch
//    chain takes rows, its 64-ch chains both.
// 3. The whole chain on chip.  Each block holds every channel of its band of rows plus one halo
//    row on each side as the conv's operand, and keeps its own outputs' sums in registers over
//    the whole band (at most 64 a thread), so one buffer serves: after a conv's products a
//    cluster.sync(), then the epilogue writes x_{j+1} over x_j in place in its own tile; under
//    a channel split the block then copies its channels into the other groups' tiles of its
//    band (distributed shared memory, 16 bytes a store), a cluster.sync(), and the halo rows
//    are copied from the neighbouring bands.  The
//    residual is f32: in f32 the tile holds x exactly and the epilogue reads it there; in bf16
//    the tile holds bf16(x) and the f32 x lives in the thread's registers beside its sums.
//    Only the final x goes to device memory.
// 4. Weights one step ahead.  The weights stream by cp.async through two buffers in groups of 9,
//    3 or 1 taps (the largest the plan fits in 227 KB), the next group (the next conv's first
//    one, across a conv's end) in flight while the tensor cores multiply this one; in f32
//    straight into the layout the fragments read, in bf16 as f32 rounded to bf16 as the
//    fragments are loaded.  A ring of three buffers, two groups ahead, was no faster
//    (tools/torch_mma_variants.py, H100 80GB HBM3, 700 W).
//
// Any C, H and W the plan fits: K is padded with zero channels to a multiple of 8 (f32) or 16
// (bf16), output channels past C are masked, bands and channel groups may be ragged (none is
// empty), positions past the band read a valid address and are dropped.  The plan is computed
// by res_chain_plan here and by res_chain.py's res_chain_plan; the entry point refuses a plan
// that differs from its own (cudaErrorInvalidValue), and a shape no plan fits.
//
// Arithmetic follows the probes: the bias after the product, relu, then x + 0.25 * y, each step
// rounded (__fadd_rn, __fmul_rn; never contracted).  Build without --use_fast_math.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // an H100 block's shared memory, bytes
constexpr int kNumSms = 132;
constexpr int kMaxTiles = 16;     // m16 x n8 tiles a warp: 64 f32 sums a thread

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ __forceinline__ int pad_to(int n, int m) { return cdiv(n, m) * m; }

// The launch plan: rs bands of `band` image rows x cs groups of cw output channels a member;
// a warp grid of warps_m x (8 / warps_m) warps, each mt m16 tiles x nt n8 tiles; weights in
// groups of wt taps; smem bytes of dynamic shared memory.
struct Plan {
  int rs, cs, band, cw, wt, mt, warps_m, nt, smem;
};

// Elements of one K step (tf32 k8, bf16 k16), the tile's row stride, its element bytes.
__host__ __device__ __forceinline__ int k_pad(int C, bool bf16) { return pad_to(C, bf16 ? 16 : 8); }
__host__ __device__ __forceinline__ int tile_stride(int C, bool bf16) {
  return k_pad(C, bf16) + (bf16 ? 8 : 4);
}
// A weight buffer's row stride: channel-major [rows][wt * kp + 4]; channel-minor
// [wt * kp][rows + pad], pad 8 (f32: a fragment's 4 k rows x 8 columns on distinct banks) or
// 4 (bf16: its 8 k rows).
__host__ __device__ __forceinline__ int w_stride(int rows, int kp, int wt, bool minor, bool bf16) {
  return minor ? rows + (bf16 ? 4 : 8) : wt * kp + 4;
}

size_t plan_smem(int C, int W, int band, int arows, int wt, bool minor, bool bf16) {
  const int kp = k_pad(C, bf16);
  const size_t tile = (size_t)(band + 2) * (W + 2) * tile_stride(C, bf16) * (bf16 ? 2 : 4);
  const size_t wbuf = (size_t)4 * (minor ? (size_t)wt * kp * w_stride(arows, kp, wt, true, bf16)
                                         : (size_t)arows * w_stride(arows, kp, wt, false, bf16));
  return tile + 2 * wbuf;
}

bool res_chain_plan(int P, int C, int H, int W, bool minor, bool bf16, Plan* out) {
  bool found = false;
  double best_work = 0.0;
  int best_rs = 0;
  for (int cl = 1; cl <= 8; cl *= 2) {
    const double work = (double)cdiv(P * cl, kNumSms) / cl;
    for (int cs = 1; cs <= cl; cs *= 2) {
      const int rs = cl / cs;
      Plan p;
      p.rs = rs;
      p.cs = cs;
      p.band = cdiv(H, rs);
      p.cw = pad_to(cdiv(C, cs), 16);
      if ((rs - 1) * p.band >= H || (cs - 1) * p.cw >= C) continue;  // no empty block
      p.mt = p.cw / 16 < 4 ? p.cw / 16 : 4;
      const int wm = cdiv(p.cw, 16 * p.mt);
      p.warps_m = wm <= 1 ? 1 : wm <= 2 ? 2 : wm <= 4 ? 4 : wm <= 8 ? 8 : 0;
      if (p.warps_m == 0) continue;
      p.nt = cdiv(p.band * W, 8 * (kWarps / p.warps_m));
      if (p.mt * p.nt > kMaxTiles) continue;
      const int arows = 16 * p.mt * p.warps_m;
      p.wt = 0;
      for (int g = 9; g >= 1; g /= 3) {
        const size_t s = plan_smem(C, W, p.band, arows, g, minor, bf16);
        if (s <= (size_t)kMaxSmem) {
          p.wt = g;
          p.smem = (int)s;
          break;
        }
      }
      if (p.wt == 0) continue;
      if (!found || work < best_work || (work == best_work && rs < best_rs)) {
        found = true;
        best_work = work;
        best_rs = rs;
        *out = p;
      }
    }
  }
  return found;
}

// d = a * b + 0: the first of a k8 step's three products starts its fresh sum.
__device__ __forceinline__ void mma_tf32_zero(float d[4], const uint32_t a[4],
                                              const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(lo) in the low half, bf16(hi) in the high half: the lower k of a fragment pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <bool kBf16>
struct Elem;
template <>
struct Elem<false> {
  typedef float T;
  __device__ static float of(float v) { return v; }
};
template <>
struct Elem<true> {
  typedef __nv_bfloat16 T;
  __device__ static __nv_bfloat16 of(float v) { return __float2bfloat16_rn(v); }
};

// Zero n bytes (a multiple of 16) of shared memory from p.
__device__ void zero_smem(void* p, size_t n) {
  int4* q = reinterpret_cast<int4*>(p);
  for (size_t i = threadIdx.x; i < n / 16; i += kThreads) q[i] = make_int4(0, 0, 0, 0);
}

// Start copying tap group grp (taps grp * wt ..) of conv weights wj (one member's conv, in the
// kMinor layout) for output channels co0 .. co0 + nv - 1 into dst: channel-major
// dst[r * ld + tl * kp + c], channel-minor dst[(tl * kp + c) * ld + r].  16-byte copies when C
// is a multiple of 4 (every source row then starts on 16 bytes), else 4-byte ones.
template <bool kMinor>
__device__ void issue_group(float* dst, const float* __restrict__ wj, int C, int kp, int ld,
                            int co0, int nv, int wt, int grp) {
  const int v = (C & 3) == 0 ? 4 : 1;
  const int t0 = grp * wt;
  if (!kMinor) {  // rows of nv output channels, each wt taps of C values
    const int q = C / v, per_row = wt * q;
    for (int i = threadIdx.x; i < nv * per_row; i += kThreads) {
      const int r = i / per_row, rem = i - r * per_row, tl = rem / q, c = (rem - tl * q) * v;
      const float* src = wj + (size_t)(co0 + r) * 9 * C + (t0 + tl) * C + c;
      float* d = dst + r * ld + tl * kp + c;
      if (v == 4) cp_async16(d, src); else cp_async4(d, src);
    }
  } else {        // wt * C rows of K, each nv output channels
    const int q = nv / v;
    for (int i = threadIdx.x; i < wt * C * q; i += kThreads) {
      const int k = i / q, r = (i - k * q) * v, tl = k / C, c = k - tl * C;
      const float* src = wj + (size_t)((t0 + tl) * C + c) * C + co0 + r;
      float* d = dst + (tl * kp + c) * ld + r;
      if (v == 4) cp_async16(d, src); else cp_async4(d, src);
    }
  }
  cp_async_commit();
}

// One tap group's products into acc, 3xTF32.  wl points at this lane's first weight (row
// row0, k tig) of the group's buffer, with strides rs_ (a row) and ks (a k); bt at the tile;
// boff[n] the tile offset of the lane's position of n8 tile n.  The n8 tiles go in groups of
// kG, each of the three passes over a whole group, so 8 independent products lie between two
// that depend on each other.
template <int MT>
__device__ __forceinline__ void products_tf32(float (&acc)[MT][kMaxTiles / MT][4],
                                              const float* tile, const int (&boff)[kMaxTiles / MT],
                                              int nt, const float* wl, int rs_, int ks, int kp,
                                              int wt, int t0, int tile_w, int ts) {
  constexpr int kNt = kMaxTiles / MT, kG = 8 / MT;
  const int tig = threadIdx.x & 3;
  for (int tl = 0; tl < wt; ++tl) {
    const int tap = t0 + tl;  // tap = dx * 3 + dy
    const float* bt = tile + ((tap % 3) * tile_w + tap / 3) * ts + tig;
    const float* wa = wl + tl * kp * ks;
    for (int k0 = 0; k0 < kp; k0 += 8) {
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // rows g, g + 8; k tig, tig + 4
          split(wa[(mt * 16 + (e & 1) * 8) * rs_ + (k0 + (e >> 1) * 4) * ks], ahi[mt][e],
                alo[mt][e]);
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
        }
#pragma unroll
        for (int u = 0; u < kG; ++u)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32_zero(part[mt][u], alo[mt], bhi[u]);
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

// One tap group's products into acc, bf16 operands, the sums carried by the tensor cores.  wl
// points at this lane's first weight (row row0, k 2 * tig); bt at the tile.
template <int MT, bool kMinor>
__device__ __forceinline__ void products_bf16(float (&acc)[MT][kMaxTiles / MT][4],
                                              const __nv_bfloat16* tile,
                                              const int (&boff)[kMaxTiles / MT], int nt,
                                              const float* wl, int rs_, int ks, int kp, int wt,
                                              int t0, int tile_w, int ts) {
  constexpr int kNt = kMaxTiles / MT;
  const int tig = threadIdx.x & 3;
  for (int tl = 0; tl < wt; ++tl) {
    const int tap = t0 + tl;
    const __nv_bfloat16* bt = tile + ((tap % 3) * tile_w + tap / 3) * ts + 2 * tig;
    const float* wa = wl + tl * kp * ks;
    for (int k0 = 0; k0 < kp; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // rows g, g + 8; k 2 tig (+1), 2 tig + 8 (+1)
          const float* q = wa + (mt * 16 + (e & 1) * 8) * rs_ + (k0 + (e >> 1) * 8) * ks;
          if (kMinor) {
            a[mt][e] = pack_bf16(q[0], q[ks]);
          } else {
            const float2 v = *reinterpret_cast<const float2*>(q);
            a[mt][e] = pack_bf16(v.x, v.y);
          }
        }
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        if (n >= nt) break;
        const __nv_bfloat16* bp = bt + boff[n] + k0;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][n], a[mt], b0, b1);
      }
    }
  }
}

// A cluster of rs * cs blocks a member: blockIdx.x = p * cl + rank, rank = ry * cs + gi; the
// block owns image rows [ry * band, min(H, (ry + 1) * band)) and output channels
// [gi * cw, min(C, (gi + 1) * cw)).
template <bool kMinor, bool kBf16, int MT>
__global__ void __launch_bounds__(kThreads, 1)
res_chain_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ out, int J, int C, int H, int W,
                 int cs, int band, int cw, int wt, int warps_m, int nt) {
  typedef typename Elem<kBf16>::T T;
  constexpr int kNt = kMaxTiles / MT;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cl = (int)cluster.num_blocks();
  const int p = blockIdx.x / cl, ry = rank / cs, gi = rank - ry * cs;
  const int y0 = ry * band, rows = min(band, H - y0);
  const int co0 = gi * cw, nv = min(cw, C - co0);
  const int S = H * W, npos = rows * W;
  const int kp = k_pad(C, kBf16), ts = tile_stride(C, kBf16), tile_w = W + 2;
  const int arows = 16 * MT * warps_m, ld = w_stride(arows, kp, wt, kMinor, kBf16);
  const size_t row_elems = (size_t)tile_w * ts, tile_elems = (size_t)(band + 2) * row_elems;
  const size_t wbuf_elems = kMinor ? (size_t)wt * kp * ld : (size_t)arows * ld;
  T* const tile = reinterpret_cast<T*>(smem);
  float* const wbuf0 = reinterpret_cast<float*>(smem + tile_elems * sizeof(T));
  float* const wbuf1 = wbuf0 + wbuf_elems;
  const float* xm = x + (size_t)p * C * S;
  float* om = out + (size_t)p * C * S;
  const float* wm = w + (size_t)p * J * 9 * C * C;  // conv j's weights at j * 9C^2
  const int groups = 9 / wt, ngroups = J * groups;

  zero_smem(smem, tile_elems * sizeof(T) + 2 * wbuf_elems * sizeof(float));
  __syncthreads();
  issue_group<kMinor>(wbuf0, wm, C, kp, ld, co0, nv, wt, 0);
  // conv 0's operand: rows y0 - 1 .. y0 + rows of every channel, straight from x
  // (channel-major: a thread a position, its channels kBatch loads at a time; channel-minor:
  // neighbouring threads on neighbouring channels)
  {
    constexpr int kBatch = 8;
    const int r0 = max(0, y0 - 1), r1 = min(H, y0 + rows + 1), n = (r1 - r0) * W;
    if (kMinor) {
      for (int i = threadIdx.x; i < n * C; i += kThreads) {
        const int q = i / C, c = i - q * C, y = r0 + q / W, xx = q % W;
        tile[((y - y0 + 1) * tile_w + xx + 1) * ts + c] =
            Elem<kBf16>::of(xm[(size_t)(r0 * W + q) * C + c]);
      }
    } else {
      for (int q = threadIdx.x; q < n; q += kThreads) {
        const int y = r0 + q / W, xx = q % W;
        const float* src = xm + (size_t)r0 * W + q;
        T* dst = tile + ((y - y0 + 1) * tile_w + xx + 1) * ts;
        for (int c0 = 0; c0 < C; c0 += kBatch) {
          float v[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) v[u] = c0 + u < C ? src[(size_t)(c0 + u) * S] : 0.f;
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (c0 + u < C) dst[c0 + u] = Elem<kBf16>::of(v[u]);
        }
      }
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int wr = warp / (kWarps / warps_m), wn = warp - wr * (kWarps / warps_m);
  const int row0 = wr * MT * 16 + g;  // this lane's first output row in the group
  // the lane's B positions (top-left of each 3 x 3 window in the tile), past npos position 0
  int boff[kNt];
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
    int q = (wn * nt + n) * 8 + g;
    if (q >= npos) q = 0;
    boff[n] = ((q / W) * tile_w + q % W) * ts;
  }
  // the lane's outputs: position (wn * nt + n) * 8 + 2 tig + c2 (c2 = e & 1), output row
  // row0 + mt * 16 + h * 8 (h = e >> 1) of the group; where = false past npos, else its
  // centre's tile offset and its offset in one channel plane of x
  auto place = [&](int n, int c2, int& to, int& s) -> bool {
    const int q = (wn * nt + n) * 8 + 2 * tig + c2, ly = q / W, xx = q - ly * W;
    to = ((ly + 1) * tile_w + xx + 1) * ts;
    s = (y0 + ly) * W + xx;
    return n < nt && q < npos;
  };
  auto gidx = [&](int co, int s) -> size_t {
    return kMinor ? (size_t)s * C + co : (size_t)co * S + s;
  };
  // bf16: the f32 residual in registers, beside the sums
  float xr[kBf16 ? MT : 1][kBf16 ? kNt : 1][4];
  if (kBf16) {
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        int to, s;
        const bool in = place(n, c2, to, s);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + mt * 16 + h * 8;
            xr[kBf16 ? mt : 0][kBf16 ? n : 0][h * 2 + c2] =
                in && r < nv ? xm[gidx(co0 + r, s)] : 0.f;
          }
      }
  }
  const int wrs = kMinor ? 1 : ld, wks = kMinor ? ld : 1;  // a weight's strides: row, k
  const int lane_w = row0 * wrs + (kBf16 ? 2 * tig : tig) * wks;

  int gq = 0;  // the weight group in use
  for (int j = 0; j < J; ++j) {
    float acc[MT][kNt][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    for (int q = 0; q < groups; ++q, ++gq) {
      cp_async_wait_all();
      __syncthreads();  // group gq has landed; every warp is done with group gq - 1
      if (gq + 1 < ngroups) {
        const int nx = gq + 1;
        issue_group<kMinor>(nx & 1 ? wbuf1 : wbuf0, wm + (size_t)(nx / groups) * 9 * C * C, C,
                            kp, ld, co0, nv, wt, nx % groups);
      }
      const float* wl = (gq & 1 ? wbuf1 : wbuf0) + lane_w;
      if (kBf16)
        products_bf16<MT, kMinor>(acc, reinterpret_cast<const __nv_bfloat16*>(tile), boff, nt,
                                  wl, wrs, wks, kp, wt, q * wt, tile_w, ts);
      else
        products_tf32<MT>(acc, reinterpret_cast<const float*>(tile), boff, nt, wl, wrs, wks, kp,
                          wt, q * wt, tile_w, ts);
    }
    cluster.sync();  // every block of the member is done reading x_j
    const bool last = j + 1 == J;
    float bv[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = min(row0 + mt * 16 + h * 8, nv - 1);
        bv[mt][h] = b[((size_t)p * J + j) * C + co0 + r];
      }
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        int to, s;
        if (!place(n, c2, to, s)) continue;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + mt * 16 + h * 8, e = h * 2 + c2;
            if (r >= nv) continue;
            const int co = co0 + r;
            float& xo = xr[kBf16 ? mt : 0][kBf16 ? n : 0][e];
            if (!kBf16) xo = static_cast<float>(tile[to + co]);
            const float y = fmaxf(__fadd_rn(acc[mt][n][e], bv[mt][h]), 0.f);
            const float xn = __fadd_rn(xo, __fmul_rn(y, 0.25f));
            if (last) {
              om[gidx(co, s)] = xn;
              continue;
            }
            xo = xn;
            tile[to + co] = Elem<kBf16>::of(xn);
          }
      }
    if (last) break;
    if (cs > 1) {  // this block's channels of x_{j+1} into the band's other blocks, 16 bytes a
      __syncthreads();  // store (the slice's padding channels are zero in every tile)
      constexpr int kVec = 16 / sizeof(T);
      const int nq = (nv + kVec - 1) / kVec;
      for (int i = threadIdx.x; i < npos * nq; i += kThreads) {
        const int q = i / nq, c = (i - q * nq) * kVec, ly = q / W, xx = q - ly * W;
        const size_t off = (size_t)((ly + 1) * tile_w + xx + 1) * ts + co0 + c;
        const int4 v = *reinterpret_cast<const int4*>(tile + off);
        for (int k = 0; k < cs; ++k)
          if (k != gi)
            *reinterpret_cast<int4*>(cluster.map_shared_rank(tile, ry * cs + k) + off) = v;
      }
    }
    cluster.sync();  // x_{j+1} is complete in every block's rows
    const int n16 = (int)(row_elems * sizeof(T) / 16);
    if (ry > 0) {  // the top halo: the last row of the band above
      const int4* src = reinterpret_cast<const int4*>(
          cluster.map_shared_rank(tile, rank - cs) + (size_t)band * row_elems);
      int4* dst = reinterpret_cast<int4*>(tile);
      for (int i = threadIdx.x; i < n16; i += kThreads) dst[i] = src[i];
    }
    if (y0 + rows < H) {  // the bottom halo: the first row of the band below
      const int4* src =
          reinterpret_cast<const int4*>(cluster.map_shared_rank(tile, rank + cs) + row_elems);
      int4* dst = reinterpret_cast<int4*>(tile + (size_t)(rows + 1) * row_elems);
      for (int i = threadIdx.x; i < n16; i += kThreads) dst[i] = src[i];
    }
    // the next group's barrier orders these copies before the next conv's products; the
    // next cluster.sync orders the neighbours' reads before anyone's next epilogue writes
  }
}

typedef void (*KernelFn)(const float*, const float*, const float*, float*, int, int, int, int, int,
                         int, int, int, int, int);

template <bool kMinor, bool kBf16>
KernelFn pick(int mt) {
  return mt == 1 ? &res_chain_kernel<kMinor, kBf16, 1>
         : mt == 2 ? &res_chain_kernel<kMinor, kBf16, 2>
                   : &res_chain_kernel<kMinor, kBf16, 4>;
}

}  // namespace

// x, out [P, C, S] (channel-major) or [P, S, C] (channel_minor = 1); w [P, J, C, 9C] or
// [P, J, 9C, C]; b [P, J, C].  The plan (rs .. nt) is res_chain.py's res_chain_plan, refused
// unless it is res_chain_plan's here.  Returns the launch's CUDA error.
extern "C" int dfd_res_chain(const float* x, const float* w, const float* b, float* out, int P,
                             int J, int C, int H, int W, int channel_minor, int bf16, int rs,
                             int cs, int band, int cw, int wt, int mt, int warps_m, int nt,
                             void* stream) {
  if (P <= 0 || J <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  if (!res_chain_plan(P, C, H, W, channel_minor != 0, bf16 != 0, &p) || p.rs != rs ||
      p.cs != cs || p.band != band || p.cw != cw || p.wt != wt || p.mt != mt ||
      p.warps_m != warps_m || p.nt != nt)
    return (int)cudaErrorInvalidValue;
  const int form = (channel_minor ? 2 : 0) + (bf16 ? 1 : 0);
  const KernelFn kernel = form == 0 ? pick<false, false>(mt) : form == 1 ? pick<false, true>(mt)
                        : form == 2 ? pick<true, false>(mt) : pick<true, true>(mt);
  static bool smem_set[4][3] = {};
  bool& done = smem_set[form][mt == 1 ? 0 : mt == 2 ? 1 : 2];
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    done = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P * rs * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = rs * cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, x, w, b, out, J, C, H, W, cs, band, cw, wt, warps_m, nt);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
