// JAX's counter-keyed standard normal for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (dfd_tpu_torch/ops/noise.py).
//
// Not a Pallas kernel: it replaces XLA's jax.random.normal in
// dfd_tpu/core/noise.py::CounterNoise.generate (the trainer's default
// noise_backend="jax"), bit for bit in the uniform and to the libm's ulp in
// eps (log1pf here, XLA's own log1p on the CPU).  One launch writes, for R
// consecutive members and d lanes,
//
//   eps[r, j]  = sqrt(2) * erf_inv(u(bits(key_r, j)))         (if eps)
//   pert[r, j] = fma(sigma, eps[r, j], theta[j])                (if pert)
//
// with bits = b1 ^ b2 of threefry2x32(key_r, (j >> 32, j & 0xFFFFFFFF)) and
// u = max(lo, f * 2 + lo), f = float((bits >> 9) | 0x3F800000) - 1,
// lo = nextafter(-1, 0); erf_inv in XLA's float32 form (see ops/noise.py).
//
// What bounds it on an H100: the instructions.  At impala_prod_bf16's
// P = 64, d = 7,872,651 it writes eps and the perturbed rows, 4.1 GB (1.22 ms
// at 3.35 TB/s), and computes 504 M normals.  One normal needs about 128.5
// instructions (threefry 73, the uniform 5, erf_inv 17 around CUDA's log1pf
// of 32, the stores and the perturbed row's FMA; counted by
// chip_smoke.py::normal_instructions), 1.93 ms at one instruction a lane a
// cycle.  This kernel's thread path takes 212 an element (124.5 of them
// integer against the 75 of threefry and the uniform) and runs in 3.33 ms,
// 0.58 of that bound (H100 80GB HBM3, 700 W).  The design is the simple one:
//
// 1. A thread owns 4 consecutive lanes of one draw; a block of 256 threads
//    1024 lanes; the grid is (lane blocks, min(draws, 65,535)), and a block
//    takes the draws blockIdx.y, blockIdx.y + gridDim.y, ... in turn, so one
//    launch takes any number of draws.  The draw's key is one broadcast load
//    a thread.
// 2. Row r begins s = (r * d) mod 4 floats past a 16-byte boundary, so a
//    thread takes the lanes 4 * t - s .. 4 * t - s + 3 and stores them as
//    one aligned float4 (eps and pert rows start at the same offsets); the
//    groups that cross a row's ends store element by element, masked.
// 3. Antithetic pairs: draw k feeds rows 2k and 2k + 1 (signs + and -), so
//    each normal is computed once.  The second row's offset differs by d;
//    where d % 4 != 0 it stores element by element.
// 4. Every float operation is written with an _rn intrinsic so nvcc cannot
//    contract or reorder it, and the fused multiply-adds are the ones XLA
//    makes (the polynomial's Horner steps, sigma * eps + theta).  Build
//    without --use_fast_math: log1pf and sqrtf must be the accurate ones,
//    the functions PyTorch's log1p and sqrt call on the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;  // blockIdx.y's bound: more draws loop over it

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k1, uint32_t k2, uint32_t x1,
                                                  uint32_t x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  uint32_t a = x1 + k1, b = x2 + k2;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i % 2 == 0) ? 13 : 17, r1 = (i % 2 == 0) ? 15 : 29;
    const int r2 = (i % 2 == 0) ? 26 : 16, r3 = (i % 2 == 0) ? 6 : 24;
    a += b; b = rotl(b, r0) ^ a;
    a += b; b = rotl(b, r1) ^ a;
    a += b; b = rotl(b, r2) ^ a;
    a += b; b = rotl(b, r3) ^ a;
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
  return a ^ b;
}

// sqrt(2) * erf_inv(u), u the uniform of the bits
__device__ __forceinline__ float normal_of_bits(uint32_t bits) {
  const float lo = -0.99999994f;  // nextafter(-1, 0)
  const float f = __fadd_rn(__uint_as_float((bits >> 9) | 0x3F800000u), -1.0f);
  const float x = fmaxf(lo, __fmaf_rn(f, 2.0f, lo));
  const float w = -log1pf(__fmul_rn(x, -x));
  const bool small = w < 5.0f;
  const float t = small ? __fadd_rn(w, -2.5f) : __fadd_rn(sqrtf(w), -3.0f);
  float p = small ? 2.81022636e-08f : -0.000200214257f;
  p = __fmaf_rn(p, t, small ? 3.43273939e-07f : 0.000100950558f);
  p = __fmaf_rn(p, t, small ? -3.5233877e-06f : 0.00134934322f);
  p = __fmaf_rn(p, t, small ? -4.39150654e-06f : -0.00367342844f);
  p = __fmaf_rn(p, t, small ? 0.00021858087f : 0.00573950773f);
  p = __fmaf_rn(p, t, small ? -0.00125372503f : -0.0076224613f);
  p = __fmaf_rn(p, t, small ? -0.00417768164f : 0.00943887047f);
  p = __fmaf_rn(p, t, small ? 0.246640727f : 1.00167406f);
  p = __fmaf_rn(p, t, small ? 1.50140941f : 2.83297682f);
  const float r = fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000)) : __fmul_rn(p, x);
  return __fmul_rn(1.41421354f, r);
}

struct NormalArgs {
  const uint32_t* keys;  // [draws, 2]
  const float* theta;    // [d], or null
  float* eps;            // [rows, d], or null
  float* pert;           // [rows (+1), d], or null
  long long d;
  int rows;
  int draws;
  int antithetic;
  int odd0;              // antithetic: row 0 is the odd member of its pair
  float sigma;
};

// one row's 4 values at lanes j0 .. j0 + 3, the group aligned when `vec`
__device__ __forceinline__ void store4(float* row, long long j0, long long d, bool vec,
                                       const float (&v)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(row + j0) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long j = j0 + i;
    if (j >= 0 && j < d) row[j] = v[i];
  }
}

__device__ __forceinline__ void store_rows(const NormalArgs& a, long long r, float sign,
                                           long long j0, bool vec, const float (&e)[4],
                                           const float (&th)[4]) {
  float v[4];
  if (a.eps != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = sign * e[i];
    store4(a.eps + r * a.d, j0, a.d, vec, v);
  }
  if (a.pert != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __fmaf_rn(a.sigma, sign * e[i], th[i]);
    store4(a.pert + r * a.d, j0, a.d, vec, v);
  }
}

// One draw's lanes of this thread.
__device__ __forceinline__ void draw_lanes(const NormalArgs& a, int draw) {
  // the draw's rows: one, or an antithetic pair (row -1 / rows: absent)
  long long r0 = draw, r1 = -1;
  float s0 = 1.0f;
  if (a.antithetic) {
    r0 = 2LL * draw - a.odd0;
    r1 = r0 + 1;
    if (r0 < 0) { r0 = r1; s0 = -1.0f; r1 = -1; }
    if (r1 >= a.rows) r1 = -1;
  }
  const int shift = int((r0 * a.d) & 3);
  const long long j0 = 4LL * (blockIdx.x * (long long)kThreads + threadIdx.x) - shift;
  if (j0 >= a.d) return;
  const uint32_t k1 = a.keys[2LL * draw], k2 = a.keys[2LL * draw + 1];
  float e[4], th[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned long long j = (unsigned long long)(j0 + i);
    e[i] = normal_of_bits(threefry_bits(k1, k2, uint32_t(j >> 32), uint32_t(j)));
    th[i] = 0.0f;
    if (a.pert != nullptr && j0 + i >= 0 && j0 + i < a.d) th[i] = a.theta[j0 + i];
  }
  const bool inside = j0 >= 0 && j0 + 3 < a.d;
  store_rows(a, r0, s0, j0, inside, e, th);
  if (r1 >= 0) store_rows(a, r1, -1.0f, j0, inside && (a.d & 3) == 0, e, th);
}

__global__ void __launch_bounds__(kThreads) normal_kernel(const __grid_constant__ NormalArgs a) {
  for (int draw = blockIdx.y; draw < a.draws; draw += gridDim.y) draw_lanes(a, draw);
}

}  // namespace

// The rows' noise and perturbed rows; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue, without launching, for arguments the
// kernel does not take).
extern "C" int dfd_normal(const uint32_t* keys, const float* theta, float* eps, float* pert,
                          long long d, int rows, int draws, int antithetic, int odd0, float sigma,
                          cudaStream_t stream) {
  const int want = antithetic ? (rows + odd0 + 1) / 2 : rows;
  if (d < 1 || rows < 1 || draws != want || (odd0 && !antithetic) ||
      (eps == nullptr && pert == nullptr) || (pert != nullptr && theta == nullptr) ||
      (reinterpret_cast<uintptr_t>(eps) | reinterpret_cast<uintptr_t>(pert)) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const long long groups = (d + 3) / 4 + 1;  // one more for a row's shift
  const long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const NormalArgs args{keys, theta, eps, pert, d, rows, draws, antithetic, odd0, sigma};
  const unsigned grid_y = unsigned(draws < kMaxGridY ? draws : kMaxGridY);
  normal_kernel<<<dim3(unsigned(blocks), grid_y), kThreads, 0, stream>>>(args);
  return cudaGetLastError();
}
