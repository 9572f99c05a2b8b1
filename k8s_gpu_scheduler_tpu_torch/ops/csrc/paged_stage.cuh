// Staging of 64-row K/V chunks of a paged pool into shared memory by a
// block of 128 threads, for the tensor-core kernels paged_prefill_mma.cu
// (K2) and paged_verify_mma.cu (K3). Row c of a chunk comes from page
// table[c / ps], row c % ps, so a chunk is independent of the page size:
// it may span several pages or end inside one.
//
// bf16 rows go by cp.async straight into the stage (stage_bf16_chunk).
// int8 rows cannot: they are widened to bf16 first, so they go through
// registers (Int8Chunk): loaded before the products of the chunk in
// flight, stored to the next stage after them, so their loads overlap the
// products too. K2 stores them dequantized (value * row scale, rounded to
// bf16); K3 stores the raw values (exact in bf16) and the rows' scales,
// which it applies to the scores and the probabilities.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace port_kernels {

constexpr int kChunkRows = 64;            // K/V rows per chunk
constexpr int kChunkThreads = 128;        // the block that stages a chunk

// bf16 rows c0 .. c0+kChunkRows-1 of one chunk, K and V, into Kd / Vd
// [kChunkRows][ld(HD)] by cp.async; rows at or past c_end become zeros.
// Pool rows come through the entry's table row (row c: page trow[c / ps],
// row c % ps, kv head kvh); with trow null, row c is at kp / vp + c * n_kv
// * HD (K2's tail, kp / vp at the entry's kv head).
template <int HD>
__device__ __forceinline__ void stage_bf16_chunk(
    const bf16* __restrict__ kp, const bf16* __restrict__ vp,
    const int* __restrict__ trow, int ps, int n_kv, int kvh, int c0,
    int c_end, bf16* Kd, bf16* Vd) {
  constexpr int SEGS = HD / 8;            // 16-byte segments of a row
  static_assert(kChunkRows * SEGS % kChunkThreads == 0,
                "whole copies per thread");
#pragma unroll
  for (int j = 0; j < kChunkRows * SEGS / kChunkThreads; ++j) {
    const int i = threadIdx.x + j * kChunkThreads;
    const int r = i / SEGS;
    const int sg = i - r * SEGS;
    const int c = c0 + r;
    const bool ok = c < c_end;
    size_t row = 0;
    if (ok)
      row = trow != nullptr
                ? (static_cast<size_t>(trow[c / ps]) * ps + c % ps) * n_kv +
                      kvh
                : static_cast<size_t>(c) * n_kv;
    cp_async16(Kd + r * ld(HD) + sg * 8, kp + row * HD + sg * 8, ok);
    cp_async16(Vd + r * ld(HD) + sg * 8, vp + row * HD + sg * 8, ok);
  }
}

// One chunk of int8 pool rows in registers, between their load (issued
// before the current chunk's products) and their store to shared memory
// (after them): 16 values and the row's scale per segment.
template <int HD>
struct Int8Chunk {
  static constexpr int SEGS = HD / 16;
  static constexpr int N = kChunkRows * SEGS / kChunkThreads;
  static_assert(kChunkRows * SEGS % kChunkThreads == 0,
                "whole segments per thread");
  uint4 k[N], v[N];
  float ks[N], vs[N];

  // Rows c0 .. c0+kChunkRows-1 through the entry's table row; zeros (and
  // scale 0) at or past c_end.
  __device__ __forceinline__ void load(const int8_t* __restrict__ kp,
                                       const int8_t* __restrict__ vp,
                                       const float* __restrict__ k_scale,
                                       const float* __restrict__ v_scale,
                                       const int* __restrict__ trow, int ps,
                                       int n_kv, int kvh, int c0, int c_end) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kChunkThreads;
      const int r = i / SEGS;
      const int c = c0 + r;
      k[j] = v[j] = make_uint4(0, 0, 0, 0);
      ks[j] = vs[j] = 0.f;
      if (c < c_end) {
        const size_t row =
            (static_cast<size_t>(trow[c / ps]) * ps + c % ps) * n_kv + kvh;
        const int at = (i - r * SEGS) * 16;
        k[j] = *reinterpret_cast<const uint4*>(kp + row * HD + at);
        v[j] = *reinterpret_cast<const uint4*>(vp + row * HD + at);
        ks[j] = k_scale[row];
        vs[j] = v_scale[row];
      }
    }
  }

  // Each value times its row scale in f32, rounded to bf16, into Kd / Vd
  // (K2: the operands dense_prefill_reference builds when it dequantizes
  // to q's dtype).
  __device__ __forceinline__ void store(bf16* Kd, bf16* Vd) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kChunkThreads;
      const int r = i / SEGS;
      const int at = r * ld(HD) + (i - r * SEGS) * 16;
      widen16(Kd + at, k[j], ks[j]);
      widen16(Vd + at, v[j], vs[j]);
    }
  }

  // The raw values as bf16 (exact) into Kd / Vd and each row's scales into
  // Ksc / Vsc [kChunkRows] (K3, which scales scores and probabilities).
  __device__ __forceinline__ void store_raw(bf16* Kd, bf16* Vd, float* Ksc,
                                            float* Vsc) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kChunkThreads;
      const int r = i / SEGS;
      const int sg = i - r * SEGS;
      widen16(Kd + r * ld(HD) + sg * 16, k[j], 1.f);
      widen16(Vd + r * ld(HD) + sg * 16, v[j], 1.f);
      if (sg == 0) {
        Ksc[r] = ks[j];
        Vsc[r] = vs[j];
      }
    }
  }

  __device__ __forceinline__ static void widen16(bf16* dst, uint4 raw,
                                                 float scale) {
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e] = pack_bf16(static_cast<float>(x[2 * e]) * scale,
                       static_cast<float>(x[2 * e + 1]) * scale);
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(dst + 8) = make_uint4(w[4], w[5], w[6], w[7]);
  }
};

}  // namespace port_kernels
