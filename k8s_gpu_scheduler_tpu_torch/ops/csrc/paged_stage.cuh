// Staging of 64-row K/V chunks into shared memory by a block of 128
// threads, for the tensor-core kernels paged_prefill_mma.cu (K2) and
// decode_mma.cu (K1, K3 and K4 in bf16). Where row c of a chunk lies is
// the row source's business (PagedRows, ContiguousRows), so a chunk is
// independent of the page size: it may span several pages or end inside
// one, and a contiguous cache is read the same way.
//
// bf16 rows go by cp.async straight into the stage (stage_bf16_chunk).
// int8 rows cannot: they are widened to bf16 first, so they go through
// registers (Int8Chunk): loaded before the products of the chunk in
// flight, stored to the next stage after them, so their loads overlap the
// products too. K2 stores them dequantized (value * row scale, rounded to
// bf16); K1, K3 and K4 store the raw values (exact in bf16) and the rows'
// scales, which they apply to the scores and the probabilities.
//
// A row the source marks unset (K4's validity bitmap) is never read: its
// copy is a cp.async zero fill (src-size 0) and its int8 values and scales
// are zeros, so a chunk with no set row moves no bytes. The bitmap bytes
// are read a chunk ahead of the copies they predicate (RowFlags), so the
// byte reads never wait in front of the ring.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace port_kernels {

constexpr int kChunkRows = 64;            // K/V rows per chunk
constexpr int kChunkThreads = 128;        // the block that stages a chunk

// Row sources of one (entry, kv head): source(c) is the index of logical
// row c in the [rows][HD] K/V (and the [rows] scales).
//
// Paged: page trow[c / ps], row c % ps of the pool [n_pages, ps, Hkv, HD]
// (K1, K2's cached prefix, K3).
struct PagedRows {
  static constexpr bool kBitmap = false;
  const int* __restrict__ trow;           // the entry's block-table row
  int ps, n_kv, kvh;
  __device__ __forceinline__ size_t operator()(int c) const {
    return (static_cast<size_t>(trow[c / ps]) * ps + c % ps) * n_kv + kvh;
  }
  // Slot b's rows through table [B, n_blocks] (no bitmap).
  __device__ __forceinline__ static PagedRows of(const int* table,
                                                 const uint8_t*, int b,
                                                 int kvh, int ps,
                                                 int n_blocks, int n_kv) {
    return PagedRows{table + static_cast<size_t>(b) * n_blocks, ps, n_kv,
                     kvh};
  }
};

// Contiguous: row c at row0 + c * n_kv (K4's cache [B, S, Hkv, HD], row0
// = b * S * Hkv + kvh; K2's tail, whose pointers sit at its entry and
// head, row0 = 0), with an optional validity bitmap of one byte a row
// (K4; null: every row is set).
struct ContiguousRows {
  static constexpr bool kBitmap = true;
  size_t row0;
  int n_kv;
  const uint8_t* __restrict__ bitmap;     // the entry's [rows] bytes
  __device__ __forceinline__ size_t operator()(int c) const {
    return row0 + static_cast<size_t>(c) * n_kv;
  }
  // Slot b's rows of a cache [B, S, Hkv, HD], one page of S rows a slot
  // (ps = S, no table), and its row of the bitmap [B, S] (or null).
  __device__ __forceinline__ static ContiguousRows of(const int*,
                                                      const uint8_t* bitmap,
                                                      int b, int kvh, int ps,
                                                      int, int n_kv) {
    const size_t row = static_cast<size_t>(b) * ps;
    return ContiguousRows{row * n_kv + kvh, n_kv,
                          bitmap != nullptr ? bitmap + row : nullptr};
  }
};

// Every row set (a source without a bitmap), in RowFlags' place.
struct AllSet {
  __device__ __forceinline__ bool operator()(int) const { return true; }
  __device__ __forceinline__ void store(uint8_t*) const {}
};

// The bitmap bytes of the rows one thread stages in a chunk, the thread's
// j-th copy (i = threadIdx.x + j * kChunkThreads) covering row i / SEGS:
// SEGS is HD / 8 for bf16 copies (stage_bf16_chunk), HD / 16 for int8
// rows (Int8Chunk). load() issues the byte reads; the bytes are used a
// chunk later, when its copies are issued (flags(j)).
template <int SEGS>
struct RowFlags {
  static constexpr int N = kChunkRows * SEGS / kChunkThreads;
  uint8_t f[N];

  __device__ __forceinline__ void load(const uint8_t* __restrict__ bitmap,
                                       int c0, int c_end) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = c0 + (threadIdx.x + j * kChunkThreads) / SEGS;
      f[j] = bitmap == nullptr ? 1 : (c < c_end ? bitmap[c] : 0);
    }
  }
  __device__ __forceinline__ bool operator()(int j) const { return f[j]; }
  // Each row's flag into Ms [kChunkRows] (one thread a row).
  __device__ __forceinline__ void store(uint8_t* Ms) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kChunkThreads;
      if (i % SEGS == 0) Ms[i / SEGS] = f[j];
    }
  }
};

// bf16 rows c0 .. c0+kChunkRows-1 of one chunk, K and V, into Kd / Vd
// [kChunkRows][ld(HD)] by cp.async; rows at or past c_end, and rows whose
// copy set(j) refuses, become zeros and are not read.
template <int HD, typename Rows, typename Set = AllSet>
__device__ __forceinline__ void stage_bf16_chunk(
    const bf16* __restrict__ kp, const bf16* __restrict__ vp,
    const Rows& source, int c0, int c_end, bf16* Kd, bf16* Vd,
    const Set& set = Set()) {
  constexpr int SEGS = HD / 8;            // 16-byte segments of a row
  static_assert(kChunkRows * SEGS % kChunkThreads == 0,
                "whole copies per thread");
#pragma unroll
  for (int j = 0; j < kChunkRows * SEGS / kChunkThreads; ++j) {
    const int i = threadIdx.x + j * kChunkThreads;
    const int r = i / SEGS;
    const int sg = i - r * SEGS;
    const int c = c0 + r;
    const bool ok = c < c_end && set(j);
    const size_t row = ok ? source(c) : 0;
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

  // Rows c0 .. c0+kChunkRows-1 of the source; zeros (and scale 0) at or
  // past c_end and where set(j) refuses the thread's j-th row.
  template <typename Rows, typename Set = AllSet>
  __device__ __forceinline__ void load(const int8_t* __restrict__ kp,
                                       const int8_t* __restrict__ vp,
                                       const float* __restrict__ k_scale,
                                       const float* __restrict__ v_scale,
                                       const Rows& source, int c0, int c_end,
                                       const Set& set = Set()) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kChunkThreads;
      const int r = i / SEGS;
      const int c = c0 + r;
      k[j] = v[j] = make_uint4(0, 0, 0, 0);
      ks[j] = vs[j] = 0.f;
      if (c < c_end && set(j)) {
        const size_t row = source(c);
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
  // Ksc / Vsc [kChunkRows] (K1, K3, K4, which scale scores and
  // probabilities).
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
