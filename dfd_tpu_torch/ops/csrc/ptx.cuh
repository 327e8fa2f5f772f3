// The PTX wrappers the port's tensor-core and copy kernels share: cp.async
// into shared memory, Hopper's bulk copies on mbarriers, the 3xTF32
// arithmetic (the cvt.rna hi/lo split and the m16n8k8 TF32 product), and
// Hopper's warpgroup products (wgmma, TF32 and bf16) with their descriptors
// and fences.  Included by fused_resblock_tf32.cu, fused_resblock_mma.cu,
// gemm_chain.cu, res_chain.cu and relayout.cu;
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

// Hopper's bulk copies: the tensor memory accelerator copies bytes (a
// multiple of 16, both addresses 16-byte aligned) from global to shared
// memory and completes them on an mbarrier in shared memory, which a thread
// has armed with the bytes to expect; waiters test the barrier's phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// A tensor map's box at coordinates (x, y, z) (innermost first; outside the
// tensor reads zero) into dst, 128-byte aligned, completing on bar, which
// this thread arms with the box's bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int x, int y, int z,
                                            uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_addr(dst)), "l"(map), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar)) : "memory");
}

// Arms bar with the bytes of the copies about to complete on it (one arrival).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// A 4-d tensor map's box at (x, y, z, w) into dst (16-byte aligned),
// completing on bar, which the caller has armed (mbar_expect_tx) with every
// copy's bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, int x, int y, int z, int w,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_addr(dst)), "l"(map), "r"(x), "r"(y), "r"(z), "r"(w), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Hopper's warpgroup products (sm_90a): a descriptor of an operand tile in
// shared memory in the no-swizzle core-matrix layout (8 rows x 16 bytes,
// rows 16 bytes apart): lbo bytes between the two core matrices of a k8
// step, sbo bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Waits until at most one committed group of this warpgroup's products runs.
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keeps the compiler from moving a read or write of v across a wgmma wait.
__device__ __forceinline__ void fence_operand(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// Orders this thread's generic writes to shared memory before the async
// proxy's (wgmma's) reads of it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x 72] (+)= A[64 x 8] * B[8 x 72] on the tensor cores, A and B TF32 in shared
// memory (descriptors), D f32 in registers; D starts from zero where scale_d is 0.
__device__ __forceinline__ void wgmma_n72(float (&d)[36], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, "
      "%9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35"
      "}, %36, %37, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 152] (+)= A[64 x 16] * B[16 x 152] on the tensor cores, A and B bf16
// in shared memory (descriptors; both K-major: no transpose), D f32 in
// registers; D starts from zero where scale_d is 0.
__device__ __forceinline__ void wgmma_bf16_n152(float (&d)[76], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %78, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75"
      "}, %76, %77, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
