// Warp-level tensor-core and asynchronous-copy primitives for Hopper
// (sm_90a), as inline PTX: cp.async copies into shared memory with zero
// fill, ldmatrix (plain and transposed) and mma.sync m16n8k16 with bf16
// operands and f32 accumulators. Used by flash_backward_mma.cu.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A 16 x 16 (4 registers of 2 bf16): {row g, cols 2t, 2t+1},
//     {row g+8, cols 2t, 2t+1}, {row g, cols 2t+8, 2t+9},
//     {row g+8, cols 2t+8, 2t+9};
//   B 16 x 8 (2 registers): {rows 2t, 2t+1, col g}, {rows 2t+8, 2t+9, col g};
//   C 16 x 8 (4 f32): (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
// The C tiles of two adjacent n-tiles, packed to bf16 pairwise, are the A
// fragment of a 16 x 16 tile (to_a_frags in flash_backward_mma.cu).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace port_kernels {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst, asynchronously; with !valid the
// 16 bytes become zeros and src is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, the same way.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 (16 contiguous bytes) and receives r[i] from matrix i:
// {row g, cols 2t, 2t+1}.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed: r[i] = {rows 2t, 2t+1 of col g}.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to nearest even bf16; lo in the low half (the lower
// column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace port_kernels
