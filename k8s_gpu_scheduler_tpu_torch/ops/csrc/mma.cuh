// Warp-level tensor-core and asynchronous-copy primitives for Hopper
// (sm_90a), as inline PTX: cp.async copies into shared memory with zero
// fill, ldmatrix (plain and transposed) and mma.sync m16n8k16 with bf16
// operands and f32 accumulators; and the warp-tile helpers built on them
// (staging, the two products, the register online softmax, the stores).
// Used by flash_backward_mma.cu (K6, K7), flash_forward_mma.cu (K5),
// paged_prefill_mma.cu (K2) and decode_mma.cu (K1, K3, K4).
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A 16 x 16 (4 registers of 2 bf16): {row g, cols 2t, 2t+1},
//     {row g+8, cols 2t, 2t+1}, {row g, cols 2t+8, 2t+9},
//     {row g+8, cols 2t+8, 2t+9};
//   B 16 x 8 (2 registers): {rows 2t, 2t+1, col g}, {rows 2t+8, 2t+9, col g};
//   C 16 x 8 (4 f32): (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
// The C tiles of two adjacent n-tiles, packed to bf16 pairwise, are the A
// fragment of a 16 x 16 tile (to_a_frags below).
#pragma once

#include <cuda_bf16.h>
#include <math.h>
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

using bf16 = __nv_bfloat16;

// -- Warp tiles ---------------------------------------------------------------
//
// Each warp owns one or more tiles of 16 rows of its block's tile, the M of
// one mma; the thread holds rows lane/4 and lane/4 + 8 of each (the C
// layout above).

// Padded row of a staged tile, in elements (16 bytes over the row).
__host__ __device__ constexpr int ld(int hd) { return hd + 8; }


// acc[t] = A_t B^T for the warp's MT row tiles of 16 (tile t at row 16 t of
// A, A at the warp's first row) against N rows of B, both staged
// [rows][ld(HD)]: acc[t][j] is the 16 x 8 tile of B's rows 8j .. 8j+7.
// Each B fragment loaded by ldmatrix feeds the MT tiles' mma.
template <int HD, int N, int MT>
__device__ __forceinline__ void warp_abt_rows(const bf16* A, const bf16* B,
                                              int lane,
                                              float (&acc)[MT][N / 8][4]) {
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int t = 0; t < MT; ++t)
      ldmatrix_x4(a[t], A + (16 * t + (lane & 15)) * ld(HD) + kk +
                            (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      uint32_t b[4];
      ldmatrix_x4(b, B + (16 * j + (lane & 7) + (lane >> 4) * 8) * ld(HD) +
                         kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        mma_bf16(acc[t][2 * j], a[t], b[0], b[1]);
        mma_bf16(acc[t][2 * j + 1], a[t], b[2], b[3]);
      }
    }
  }
}

// The warp's 16 x HD tile of A (staged [16][ld(HD)]) as HD / 16 A
// fragments, loaded once into registers for products against many B tiles.
template <int HD>
__device__ __forceinline__ void load_a_frags(const bf16* A, int lane,
                                             uint32_t (&a)[HD / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(a[kk], A + (lane & 15) * ld(HD) + 16 * kk + (lane >> 4) * 8);
}

// acc = A B^T for the warp's 16 rows of A held as fragments (load_a_frags)
// against N rows of B staged [N][ld(HD)], as warp_abt_rows lays acc out.
template <int HD, int N>
__device__ __forceinline__ void warp_abt_held(const uint32_t (&a)[HD / 16][4],
                                              const bf16* B, int lane,
                                              float (&acc)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      uint32_t b[4];
      ldmatrix_x4(b, B + (16 * j + (lane & 7) + (lane >> 4) * 8) * ld(HD) +
                         16 * kk + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * j], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * j + 1], a[kk], b[2], b[3]);
    }
}

// acc = A B^T for the warp's 16 rows (one tile of warp_abt_rows).
template <int HD, int N>
__device__ __forceinline__ void warp_abt(const bf16* A, const bf16* B,
                                         int lane, float (&acc)[N / 8][4]) {
  warp_abt_rows<HD, N, 1>(A, B, lane,
                          reinterpret_cast<float(&)[1][N / 8][4]>(acc));
}

// acc[t] += P_t V: P the warp's MT tiles of 16 x K as A fragments in
// registers, V staged [K rows][ld(HD)]; acc[t][j] is the 16 x 8 tile of
// dims 8j .. 8j+7. Each V fragment feeds the MT tiles' mma.
template <int HD, int K, int MT>
__device__ __forceinline__ void warp_pv_rows(const uint32_t (&p)[MT][K / 16][4],
                                             const bf16* V, int lane,
                                             float (&acc)[MT][HD / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, V + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   ld(HD) +
                               16 * j + (lane >> 4) * 8);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        mma_bf16(acc[t][2 * j], p[t][kk], b[0], b[1]);
        mma_bf16(acc[t][2 * j + 1], p[t][kk], b[2], b[3]);
      }
    }
}

// acc += P V for the warp's 16 rows (one tile of warp_pv_rows).
template <int HD, int K>
__device__ __forceinline__ void warp_pv(const uint32_t (&p)[K / 16][4],
                                        const bf16* V, int lane,
                                        float (&acc)[HD / 8][4]) {
  warp_pv_rows<HD, K, 1>(
      reinterpret_cast<const uint32_t(&)[1][K / 16][4]>(p), V, lane,
      reinterpret_cast<float(&)[1][HD / 8][4]>(acc));
}

// The accumulators of a 16 x N tile, each rounded once to bf16, as the A
// fragments of the 16 x N operand of a second product.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&c)[N / 8][4],
                                           uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Writes a 16 x HD accumulator's rows (the thread's rows[0], rows[1]; row
// r at dst + r * stride) times mul, skipping rows at or past n.
template <int HD>
__device__ __forceinline__ void store_tile(bf16* dst, size_t stride,
                                           const int (&rows)[2], int n,
                                           int lane,
                                           const float (&acc)[HD / 8][4],
                                           float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= n) continue;
    bf16* o = dst + static_cast<size_t>(rows[i]) * stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * i] * mul, acc[j][2 * i + 1] * mul);
  }
}

// Rows row0 .. row0+ROWS-1 of one head (row r at src + r * stride) into
// dst [ROWS][ld(HD)] by cp.async from a block of THREADS threads; rows at
// or past n_rows become zeros.
template <int ROWS, int HD, int THREADS>
__device__ __forceinline__ void stage_async(const bf16* __restrict__ src,
                                            size_t stride, int row0,
                                            int n_rows, bf16* dst) {
  constexpr int SEGS = HD / 8;             // 16-byte segments of a row
  static_assert(ROWS * SEGS % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int j = 0; j < ROWS * SEGS / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / SEGS;
    const int sg = i - r * SEGS;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * ld(HD) + sg * 8,
               src + static_cast<size_t>(ok ? row0 + r : 0) * stride + sg * 8,
               ok);
  }
}

// One step of the online softmax over the warp's 16 x N score tile s, in
// registers: s holds raw scores, masked entries -inf; c = log2(e)/sqrt(d).
// Updates the running row maxima m (of the scores times c; the max over
// the quad that shares a row: two shuffles) and the thread's share of the
// row sums l, rescales acc, and leaves p = 2^(s c - m) in s (one FFMA and
// one exp2 an entry), exactly 0 where masked and summed into l in f32
// before any rounding. A row with nothing visible yet keeps m = -inf and
// p = 0, and exp2 never sees -inf - -inf.
template <int N, int HD>
__device__ __forceinline__ void online_softmax(float (&s)[N / 8][4], float c,
                                               float (&m)[2], float (&l)[2],
                                               float (&acc)[HD / 8][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx * c);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m[i] - base);
    m[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], c, -base));
        sum += s[j][e];
      }
    l[i] = l[i] * alpha + sum;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][2 * i] *= alpha;
      acc[j][2 * i + 1] *= alpha;
    }
  }
}

// Ends the online softmax: sums the quad's shares of l, divides the
// thread's rows of acc by their row sum, and returns each row's natural
// log-sum-exp m ln 2 + log l.
template <int HD>
__device__ __forceinline__ void finish_softmax(const float (&m)[2],
                                               float (&l)[2],
                                               float (&acc)[HD / 8][4],
                                               float (&lse)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float den = fmaxf(l[i], 1e-20f);
    const float inv = 1.f / den;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][2 * i] *= inv;
      acc[j][2 * i + 1] *= inv;
    }
    lse[i] = m[i] * 0.6931471805599453f + logf(den);
  }
}

}  // namespace port_kernels
