// The PTX wrappers the port's tensor-core and copy kernels share: cp.async
// into shared memory, and the 3xTF32 arithmetic (the cvt.rna hi/lo split and
// the m16n8k8 TF32 product).  Included by fused_resblock_tf32.cu,
// fused_resblock_mma.cu, gemm_chain.cu, res_chain.cu and relayout.cu;
// ops/build.py hashes this header into every library's name, so an edit here
// rebuilds them all.
//
// 3xTF32: each f32 operand a is split as a = hi + lo, hi = tf32(a) and
// lo = tf32(a - hi) (cvt.rna.tf32.f32; a - hi is exact in f32), and a * b is
// taken as lo_a * hi_b + hi_a * lo_b + hi_a * hi_b, lo * lo dropped: about 22
// of f32's 24 bits a product, at a third of the TF32 rate.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// a = hi + lo in two TF32 values; a - hi is exact in f32.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a) & 0xffffe000u;  // the low 13 bits of a TF32 value are zero
  lo = to_tf32(__fsub_rn(a, __uint_as_float(hi)));
}

// The same split as (hi, lo) in one value.
__device__ __forceinline__ uint2 split(float a) {
  uint2 h;
  split(a, h.x, h.y);
  return h;
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
