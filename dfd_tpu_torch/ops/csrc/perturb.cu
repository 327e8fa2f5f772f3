// Counter-hash perturbation kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (dfd_tpu_torch/ops/perturb.py).
//
// Replaces the Pallas TPU kernels dfd_tpu/ops/perturb.py::pallas_perturb
// (_perturb_kernel) and ::pallas_combine (_combine_kernel).  Both regenerate
// the same standard-normal stream eps[member, j] from an integer hash of
// (seed, epoch, member, chunk_idx, lane), with chunk_idx = j / 1024 and
// lane = j % 1024, so eps never exists in device memory:
//
//   dfd_perturb:  out[i, j] = theta[j] + sigma * eps[i, j]
//   dfd_combine:  g[j]      = sum_i coef[i] * eps[i, j]
//
// Their `_from` forms take the members first .. first + P - 1 of the stream
// (a rank's shard of a population on a mesh); the plain entries start at 0.
//
// What bounds perturb: the bytes.  At impala_prod_bf16's P = 64,
// d = 7,872,651 it writes 2.0 GB of population rows (0.61 ms at 3.35 TB/s)
// against about 36 operations an element (the stream normal's two fmix32
// rounds, logf, cosf and sqrtf, then sigma * z + theta: 0.54 ms at the CUDA
// cores' 33.5 T instructions a second); at mlp_trap's P = 2048, d = 5197 the
// two are about even (13 and 11 us).  What the card issues is more: one stream
// normal is 99.25 SASS instructions on its fast path (counted in combine's
// inner loop of this library by chip_smoke.py from cuobjdump -sass: accurate
// logf and cosf are polynomials, sqrtf an rsqrt and a Newton step, plus the
// hash and two int->float conversions), 1.49 ms at impala_prod_bf16 and 31.5
// us at mlp_trap at one instruction a lane a cycle, so the instruction stream,
// not the bytes, holds perturb and combine (H100 80GB HBM3, 700 W).  Its
// design:
//
// 1. Threads own columns.  A block of 256 threads owns one 1024-lane chunk of
//    j, a thread 4 consecutive j of it, and loops over a slice of the members:
//    theta is read once a slice (its window in registers), and the gy slices
//    of one chunk are neighbouring blocks, so the re-reads come from L2.  The
//    slices are cut only as fine as it takes to give the card some eight
//    waves of blocks (mlp_trap's d = 5197 is 6 chunks; P = 2048 is cut into
//    512 slices of 4 members).
// 2. Keys hoisted.  The (member, chunk) key, two fmix32 rounds, is computed
//    once a block for each member of its slice into shared memory; the lane's
//    lane * golden is computed once a thread.  An element costs the stream
//    normal and the sum.
// 3. Stores vectorized.  Each member row is stored as aligned float4s by
//    streaming stores (__stcs), so the output does not evict theta from L2.
//    Row i starts at float i * d, off a 16-byte boundary by s = i * d mod 4
//    floats when d % 4 != 0, so for row i a thread stores the aligned group
//    j = 4T - s .. 4T - s + 3: its own 4 columns shifted left by s.  Its
//    window of 7 columns (4T - 3 .. 4T + 3) holds every group any shift
//    needs; the first thread of a chunk takes the window's three left columns
//    from the previous chunk's key.  Groups that cross a row's start or end
//    are stored element by element, masked to [0, d).
// 4. Antithetic pairs.  Rows 2m and 2m + 1 share member m's normals with
//    opposite signs: the window's normals are computed once for both rows'
//    groups (at most 7 for 8 values, 4 for 8 when d % 4 == 0).
//
// Combine is bound by its operations (P normals an output and only P + d
// floats moved).  Its design:
//
// 5. Members split across blocks.  A block of 256 threads owns a tile of 4 * lt
//    lanes (inside one chunk) and a slice of the members: lt threads a row,
//    each owning 4 consecutive lanes (4 independent normals a member), times
//    mg = 256 / lt member groups; a cluster of cl blocks splits the tile's
//    members further.  combine_plan halves lt (and doubles mg), then doubles
//    cl, and keeps the plan whose last wave of blocks is least empty:
//    mlp_trap's d = 5197 is 82 tiles of 64 lanes x 16 groups x clusters of 8,
//    656 blocks, one wave; impala_procmaze's d = 1,156,139 would be 1129
//    blocks of 1024 lanes, 1.07 waves, and takes tiles of 128 lanes x 8
//    groups (9033 blocks); impala_prod_bf16's tiles of 512 lanes x 2 groups.
//    Keys and coefficients are hoisted into shared memory 256 members at a
//    time.
// 6. A fixed order of sums, so two calls give the same bits: each thread sums
//    its members in order; the groups' sums are added in group order through
//    shared memory; the cluster's in rank order by rank 0 through distributed
//    shared memory.  One kernel a call, no atomics, no scratch.
// 7. Antithetic pairs.  Members 2m and 2m + 1 share draw m with opposite
//    signs, so draw m is staged once with c[2m] - c[2m + 1] (a lone last
//    member keeps its own coefficient) and its normal computed once.
//
// Arithmetic follows the JAX stream exactly: uint32 arithmetic wraps as on
// the TPU, the uniforms are (bits >> 8) / 2^24 with u1 nudged by 1e-7f, and
// the f32 operations are written with _rn intrinsics so nvcc cannot
// contract them into FMAs.  Build without --use_fast_math: __logf/__cosf
// are far off at these arguments.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 1024;          // the stream's lane period
constexpr int kPerturbThreads = 256;
constexpr int kCombineThreads = 256;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kMul1 = 0x85EBCA6Bu;
constexpr uint32_t kMul2 = 0xC2B2AE35u;
constexpr float kTwoPi = 6.283185307179586f;  // f32(2 pi), as JAX rounds it

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= kMul1;
  x ^= x >> 13;
  x *= kMul2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t member_key(uint32_t base, uint32_t member,
                                               uint32_t chunk_idx) {
  uint32_t key = fmix32(base ^ member * kMul1);
  return fmix32(key ^ chunk_idx * kMul2);
}

// One standard normal of the stream from mix = lane * golden ^ (member key).
__device__ __forceinline__ float normal_of_mix(uint32_t mix) {
  const uint32_t b1 = fmix32(mix ^ 0x1234567u);
  const uint32_t b2 = fmix32(mix ^ 0x89ABCDEu);
  const float scale = 1.0f / 16777216.0f;
  const float u1 = __fadd_rn(__fmul_rn((float)(int)(b1 >> 8), scale), 1e-7f);
  const float u2 = __fmul_rn((float)(int)(b2 >> 8), scale);
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))), cosf(__fmul_rn(kTwoPi, u2)));
}

// One standard normal of the stream at (member key, lane).
__device__ __forceinline__ float stream_normal(uint32_t key, uint32_t lane) {
  return normal_of_mix(lane * kGolden ^ key);
}

// The perturb launch plan: 256 threads a block own one chunk; `slices`
// blocks a chunk (neighbouring block indices) split the members (pairs under
// antithetic) into runs of at most `per` members.
struct PerturbPlan {
  int chunks, slices, per;
};

constexpr int kGroupsPerChunk = kChunk / 4;   // a thread's 4 columns: 256 threads a chunk
constexpr int kMaxPerBlock = 1024;            // members a block's key table holds
constexpr int kTargetBlocks = 8 * 132 * 8;    // about eight waves of 8 blocks on 132 SMs
constexpr int kMinPerBlock = 4;

PerturbPlan perturb_plan(int P, int d, int antithetic) {
  // groups T of 4 columns: for d % 4 != 0 a row's groups are shifted left by
  // up to 3, so one more group covers its end
  const long groups = (d + 3) / 4 + (d % 4 != 0);
  const int members = antithetic ? (P + 1) / 2 : P;
  PerturbPlan p;
  p.chunks = (int)((groups + kGroupsPerChunk - 1) / kGroupsPerChunk);
  long per = ((long)members * p.chunks + kTargetBlocks - 1) / kTargetBlocks;
  per = per < kMinPerBlock ? kMinPerBlock : per;
  per = per > kMaxPerBlock ? kMaxPerBlock : per;
  per = per > members ? members : per;
  p.slices = (int)((members + per - 1) / per);
  p.per = (int)((members + p.slices - 1) / p.slices);  // even runs
  return p;
}

// Row i's values at its aligned group j = jb .. jb + 3 (jb = 4T - S), taken
// from the thread's window (column 4T - 3 + w at w): window index 3 - S + k.
template <int S>
__device__ __forceinline__ void store_group(float* __restrict__ row, long jb, int d,
                                            const float (&th)[7], const float (&z)[7],
                                            float sigma, bool negate) {
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float e = negate ? -z[3 - S + k] : z[3 - S + k];
    v[k] = __fadd_rn(th[3 - S + k], __fmul_rn(sigma, e));
  }
  if (jb >= 0 && jb + 3 < d) {
    __stcs(reinterpret_cast<float4*>(row + jb), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (jb + k >= 0 && jb + k < d) __stcs(row + jb + k, v[k]);
  }
}

__device__ __forceinline__ void store_row(float* __restrict__ out, int i, int d, long T,
                                          const float (&th)[7], const float (&z)[7],
                                          float sigma, bool negate) {
  const int s = ((i & 3) * (d & 3)) & 3;  // (i * d) mod 4: how far row i starts off 16 bytes
  float* row = out + (size_t)i * d;
  const long jb = 4 * T - s;
  switch (s) {
    case 0: store_group<0>(row, jb, d, th, z, sigma, negate); break;
    case 1: store_group<1>(row, jb, d, th, z, sigma, negate); break;
    case 2: store_group<2>(row, jb, d, th, z, sigma, negate); break;
    default: store_group<3>(row, jb, d, th, z, sigma, negate); break;
  }
}

// The window columns row i's group takes: w = 3 - s .. 6 - s.
__device__ __forceinline__ uint32_t window_bits(int i, int d) {
  return 0xFu << (3 - (((i & 3) * (d & 3)) & 3));
}

// blockIdx.x = chunk * slices + slice.  Thread t of chunk c owns columns
// j = 4T .. 4T + 3, T = 256 c + t, and its window 4T - 3 .. 4T + 3.
__global__ void __launch_bounds__(kPerturbThreads)
perturb_kernel(const float* __restrict__ theta, float* __restrict__ out, int P, int d,
               float sigma, uint32_t base, int antithetic, int slices, int per,
               uint32_t draw0) {
  __shared__ uint32_t s_key[kMaxPerBlock], s_prev[kMaxPerBlock];
  const int chunk = blockIdx.x / slices, slice = blockIdx.x - chunk * slices;
  const int members = antithetic ? (P + 1) / 2 : P;
  const int m0 = slice * per, count = min(per, members - m0);
  for (int r = threadIdx.x; r < count; r += kPerturbThreads) {
    const uint32_t key = fmix32(base ^ ((uint32_t)(m0 + r) + draw0) * kMul1);
    s_key[r] = fmix32(key ^ (uint32_t)chunk * kMul2);
    s_prev[r] = fmix32(key ^ (uint32_t)(chunk - 1) * kMul2);  // read by thread 0 only
  }
  __syncthreads();
  const long T = (long)chunk * kGroupsPerChunk + threadIdx.x;
  const long groups = (d + 3) / 4 + (d % 4 != 0);
  if (T >= groups) return;
  // the window: theta (0 off [0, d)) and lane * golden of columns 4T - 3 + w
  float th[7];
  uint32_t lg[7];
#pragma unroll
  for (int w = 0; w < 7; ++w) {
    const long j = 4 * T - 3 + w;
    th[w] = (j >= 0 && j < d) ? __ldg(theta + j) : 0.0f;
    lg[w] = (uint32_t)(j & (kChunk - 1)) * kGolden;
  }
  const bool first = threadIdx.x == 0;  // its window's columns 0-2 lie in the previous chunk
  for (int r = 0; r < count; ++r) {
    const int m = m0 + r;
    const uint32_t key = s_key[r], key_lo = first ? s_prev[r] : key;
    const int i0 = antithetic ? 2 * m : m;
    const bool pair = antithetic && i0 + 1 < P;
    const uint32_t need = window_bits(i0, d) | (pair ? window_bits(i0 + 1, d) : 0u);
    float z[7];
#pragma unroll
    for (int w = 0; w < 7; ++w)
      z[w] = (need >> w) & 1u ? normal_of_mix(lg[w] ^ (w < 3 ? key_lo : key)) : 0.0f;
    store_row(out, i0, d, T, th, z, sigma, false);
    if (pair) store_row(out, i0 + 1, d, T, th, z, sigma, true);
  }
}

// The combine launch plan: lt threads own 4 lanes each of a tile of 4 * lt
// lanes, mg = 256 / lt groups split the block's members, and a cluster of cl
// blocks a tile splits them further.
struct CombinePlan {
  int lt, mg, cl;
};

constexpr long kCombineResident = 132 * 8;  // blocks in flight: eight an SM of 132

// From one group of 256 threads a tile of 1024 lanes, each step halves lt
// (doubling mg), then doubles cl, while each group keeps kMinPerBlock draws
// and the grid has fewer than eight waves; the plan kept is the one whose last
// wave is least empty: the fewest waves a block, ceil(B / R) / B, B blocks
// and R = kCombineResident (compared exactly, as integers).
CombinePlan combine_plan(int P, int d, int antithetic) {
  const long draws = antithetic ? (P + 1) / 2 : P;
  CombinePlan p = {kCombineThreads, 1, 1}, best = p;
  auto blocks = [&](const CombinePlan& q) { return (d + 4L * q.lt - 1) / (4L * q.lt) * q.cl; };
  auto waves = [&](const CombinePlan& q) { return (blocks(q) + kCombineResident - 1) / kCombineResident; };
  while (blocks(p) < 8 * kCombineResident && (long)p.mg * p.cl * 2 * kMinPerBlock <= draws) {
    if (p.lt > 16) {
      p.lt /= 2;
      p.mg *= 2;
    } else if (p.cl < 8) {
      p.cl *= 2;
    } else {
      break;
    }
    if (waves(p) * blocks(best) < waves(best) * blocks(p)) best = p;
  }
  return best;
}

// blockIdx.x = tile * cl + rank.  Thread t owns lanes j = tile * 4 lt + 4 (t %
// lt) .. + 3 and member group t / lt; rank r of the cluster the r-th run of
// the draws (members, or pairs under antithetic).
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ coef, float* __restrict__ g, int P, int d,
               uint32_t base, int antithetic, int lt, int mg, uint32_t draw0) {
  __shared__ float s_coef[kCombineThreads];
  __shared__ uint32_t s_key[kCombineThreads];
  __shared__ float s_part[4 * kCombineThreads];  // [group][4 lt lanes], then the block's sums
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / cl, lanes = 4 * lt;
  const int li = threadIdx.x % lt, grp = threadIdx.x / lt;
  const long j0 = (long)tile * lanes + 4 * li;
  const uint32_t chunk_idx = (uint32_t)(((long)tile * lanes) / kChunk);
  uint32_t lg[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) lg[k] = (uint32_t)((j0 + k) & (kChunk - 1)) * kGolden;
  const int draws = antithetic ? (P + 1) / 2 : P;
  const int per = (draws + cl - 1) / cl, m_lo = rank * per, m_hi = min(draws, m_lo + per);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = m_lo; t0 < m_hi; t0 += kCombineThreads) {
    const int n = min(kCombineThreads, m_hi - t0), m = t0 + threadIdx.x;
    __syncthreads();  // the previous round is consumed
    if (threadIdx.x < n) {
      float c = coef[antithetic ? 2 * m : m];
      if (antithetic && 2 * m + 1 < P) c = __fsub_rn(c, coef[2 * m + 1]);
      s_coef[threadIdx.x] = c;
      s_key[threadIdx.x] = member_key(base, (uint32_t)m + draw0, chunk_idx);
    }
    __syncthreads();
    if (j0 < d) {
      for (int r = grp; r < n; r += mg) {
        const float c = s_coef[r];
        const uint32_t key = s_key[r];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = fmaf(c, normal_of_mix(lg[k] ^ key), acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) s_part[grp * lanes + 4 * li + k] = acc[k];
  __syncthreads();
  // the groups in order; each lane's sum lands in group 0's row
  for (int l = threadIdx.x; l < lanes; l += kCombineThreads) {
    float v = s_part[l];
    for (int q = 1; q < mg; ++q) v = __fadd_rn(v, s_part[q * lanes + l]);
    s_part[l] = v;
  }
  if (cl == 1) {
    __syncthreads();
  } else {
    cluster.sync();  // every block's sums are in its s_part
  }
  if (rank == 0) {  // the cluster's blocks in rank order
    for (int l = threadIdx.x; l < lanes; l += kCombineThreads) {
      const long j = (long)tile * lanes + l;
      if (j >= d) continue;
      float v = s_part[l];
      for (int q = 1; q < cl; ++q) v = __fadd_rn(v, cluster.map_shared_rank(s_part, q)[l]);
      g[j] = v;
    }
  }
  if (cl > 1) cluster.sync();  // no block leaves while rank 0 reads its sums
}

uint32_t key_base(uint32_t seed, uint32_t epoch) { return fmix32(seed * kGolden ^ epoch); }

}  // namespace

// first: the stream's draw that row 0 takes (a member, or a pair under
// antithetic): rows 0 .. P - 1 are the members that start there, so a shard of
// a population perturbs its own rows alone.
extern "C" int dfd_perturb_from(const float* theta, float* out, int P, int d, float sigma,
                                uint32_t seed, uint32_t epoch, int antithetic, uint32_t first,
                                void* stream) {
  if (P <= 0 || d <= 0) return (int)cudaSuccess;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const PerturbPlan p = perturb_plan(P, d, antithetic);
  perturb_kernel<<<p.chunks * p.slices, kPerturbThreads, 0, (cudaStream_t)stream>>>(
      theta, out, P, d, sigma, key_base(seed, epoch), antithetic, p.slices, p.per, first);
  return (int)cudaGetLastError();
}

extern "C" int dfd_perturb(const float* theta, float* out, int P, int d, float sigma,
                           uint32_t seed, uint32_t epoch, int antithetic, void* stream) {
  return dfd_perturb_from(theta, out, P, d, sigma, seed, epoch, antithetic, 0u, stream);
}

// lt, mg, cl: the plan of perturb.combine_plan, refused unless it is
// combine_plan's.  first: the draw that coef[0] weighs, as dfd_perturb_from's.
extern "C" int dfd_combine_from(const float* coef, float* g, int P, int d, uint32_t seed,
                                uint32_t epoch, int antithetic, uint32_t first, int lt, int mg,
                                int cl, void* stream) {
  if (d <= 0) return (int)cudaSuccess;
  const CombinePlan p = combine_plan(P, d, antithetic);
  if (P < 0 || p.lt != lt || p.mg != mg || p.cl != cl) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((d + 4 * lt - 1) / (4 * lt)) * cl);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, combine_kernel, coef, g, P, d,
                                             key_base(seed, epoch), antithetic, lt, mg, first);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int dfd_combine(const float* coef, float* g, int P, int d, uint32_t seed,
                           uint32_t epoch, int antithetic, int lt, int mg, int cl,
                           void* stream) {
  return dfd_combine_from(coef, g, P, d, seed, epoch, antithetic, 0u, lt, mg, cl, stream);
}
