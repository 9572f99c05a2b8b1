// Single-window attention in bf16 on Hopper's tensor cores (sm_90a), its
// splits merged across a thread-block cluster: one body for the three
// kernels that attend one window of query rows a slot over a K/V cache.
//
// decode_mma_kernel replaces the Pallas kernels behind
//    k8s_gpu_scheduler_tpu/ops/decode_attention.py
// - paged_verify_attention (_verify_kernel), K3: the speculative verify
//   window, t = 1 + gamma query rows per slot q [B, t, H, hd], row i
//   attending the slot's pool rows col < len + i + 1 through its block
//   table [B, n_blocks];
// - paged_decode_attention (_paged_kernel -> _decode_kernel), K1: one
//   query row per slot q [B, H, hd] over the same pool, col < len;
// - flash_decode_attention (_decode_kernel), K4: one query row per slot
//   over a contiguous cache [B, S, Hkv, hd], col < len and, optionally,
//   the set rows of a validity bitmap [B, S] (the shared-cursor engine's
//   slot windows: every slot writes at one cursor, so most rows under it
//   belong to other requests of the epoch).
// int8 caches carry f32 row scales ([n_pages, ps, Hkv] or [B, S, Hkv]);
// the output is [B, t, H, hd] in bf16. paged_attention.cu sends bf16 q of
// K1 and K3 here, flash_decode.cu bf16 q of K4 (bf16 or int8 caches); f32
// q keeps their CUDA-core kernels (see there).
//
// What bounds it: bytes. Each live K/V row is read once for t*g query
// rows, 4 t g FLOPs a (bf16) K/V element pair: 4 for a decode row at the
// serve width (g 1), 20 for a verify window (t 5). Yet at GQA the CUDA
// cores cannot keep pace with the bytes: at t*g = 20 or 40 (g 4 or 8) that
// is 40-80 FLOPs per K/V byte, 134-268 TFLOP/s at 3.35 TB/s, past the 67
// TFLOP/s of f32 FMA; and a deep cp.async ring keeps more bytes in flight
// than register loads do (K1's CUDA-core body streamed its rows 1.7x slower
// than this ring, PERF.md). So both products run on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 sums, mma.cuh's warp tiles), and
// the design keeps the loads in flight:
//
// - Row stack. Stacked row r of a (slot, kv head) is window token r / g,
//   group head r % g (the JAX kernel's fold), so the g heads of a kv head
//   share every K/V chunk; it attends col < len + r / g + ahead (ahead 1
//   for the verify window, whose own rows sit at len .. len + t - 1; 0 for
//   decode). The stack is cut into groups of 64 rows (grid z), each padded
//   to 16-row tiles. A decode stack (g <= 8 rows) is one tile.
// - Warps split keys as well as rows. Each of the 4 warps owns one 16-row
//   q tile and a share of each K/V chunk's keys: with one tile the 4 warps
//   take 16 keys each, with two tiles 32, with three or four all 64 (one
//   warp idles at three); KW, the ways a chunk is split, is a template
//   parameter the host picks from the stack's first group. So no warp
//   idles at t*g <= 32 or in (48, 64]. The q fragments load once into
//   registers; the accumulator is one 16-row tile a warp.
// - Row sources (paged_stage.cuh): PagedRows reads row c from page
//   table[c / ps], row c % ps (K1, K3), ContiguousRows from row (b S + c)
//   Hkv + kvh of the cache (K4). 64-row chunks, independent of the page
//   size, pass through a cp.async ring, so the next chunks' copies are in
//   flight during a chunk's products: three stages for bf16 caches, two
//   for int8, whose rows go through registers one chunk at a time (loaded
//   before a chunk's products, stored after them as raw values, exact in
//   bf16, with their rows' scales), so that a third stage would only cost
//   occupancy (decode_stages; chosen by a timed call on the card,
//   PERF.md). The q tile is staged in the last stage before that stage's
//   first chunk.
// - Bitmap (K4). A row whose bitmap byte is 0 is never loaded: its copy is
//   a zero fill and its score column is masked to -inf before exp2, so p
//   is exactly 0. The bytes of a chunk are read one chunk ahead of its
//   copies (RowFlags) and kept beside the stage for the masks. A warp whose
//   keys of a chunk are all unset skips the chunk's products, so a chunk
//   with no set row costs no bytes and no products: traffic follows the
//   set rows, not the cursor.
// - int8 arithmetic follows the plain version exactly: Q K^T of the raw
//   rows, each score column times its f32 k_scale after the product; P V
//   of p times v_scale[col], rounded once to bf16, against the raw V rows;
//   the row sum l takes the unscaled p (dense_decode_reference's and
//   dense_verify_reference's factoring). bf16 caches round P once, as K5
//   does.
// - Masks. Only the chunk or chunks that cross a row's bound, and with a
//   bitmap a warp's keys holding an unset row, are masked, to -inf before
//   exp2, so p is exactly 0. A warp whose key share lies wholly past its
//   rows' bounds skips the products.
// - Splits. Split s (grid x) takes the 64-row chunks s, s + ns, s + 2 ns,
//   ... of the columns below the block's furthest bound, so every split
//   gets its share of any window of set rows: at the engine's 576 set rows
//   under cursor 1024 and 3 splits, contiguous ranges of the length left
//   split 0 with no set row. Rows of one (slot, kv head) are Hkv rows
//   apart in a contiguous cache and scattered over pages in a pool, so the
//   interleave costs no locality. The split's blocks form one cluster:
//   each block merges its warps' partials through shared memory, then rank
//   0 merges the splits through distributed shared memory
//   (cluster_merge.cuh) and writes [B, t, H, hd] in bf16 directly: no
//   partial buffers, no second pass, no atomics. Each output is summed in a
//   fixed order: deterministic.
//
// Build: ops/_build.py compiles this file beside the other sources into one
// library; the launch functions return cudaGetLastError().

#include <math.h>

#include <type_traits>

#include "cluster_merge.cuh"
#include "common.cuh"
#include "mma.cuh"
#include "paged_stage.cuh"

namespace port_kernels {
namespace {

constexpr int kVfWarps = 4;
constexpr int kVfThreads = 32 * kVfWarps;
constexpr int kVfQ = 16 * kVfWarps;       // stacked q rows of a block
constexpr int kVfAccLd = 8;               // pad of a merge row (floats)
static_assert(kVfThreads == kChunkThreads, "the block stages the chunks");

// K/V chunks in the cp.async ring.
template <typename PT>
__host__ __device__ constexpr int decode_stages() {
  return IsInt8<PT>::value ? 2 : 3;
}

template <typename PT, int HD, typename Rows>
constexpr size_t decode_smem_bytes() {
  // The ring: K and V stages (the int8 rows' scales, the bitmap's row
  // flags); after the loop it holds the warps' partial rows for the merges.
  constexpr int NS = decode_stages<PT>();
  constexpr size_t ring =
      sizeof(bf16) * 2 * NS * kChunkRows * ld(HD) +
      (IsInt8<PT>::value ? sizeof(float) * 2 * NS * kChunkRows : 0) +
      (Rows::kBitmap ? NS * kChunkRows : 0);
  constexpr size_t merge =
      sizeof(float) * (kVfWarps * 16 * (HD + kVfAccLd) + 4 * kVfWarps * 16);
  return ring > merge ? ring : merge;
}

// grid (n_splits, B * Hkv, ceil(t*g / kVfQ)), cluster (n_splits, 1, 1),
// kVfThreads threads; the warps split each chunk's keys KW ways (KW = 4,
// 2, 1 for 1, 2, 3-4 tiles of 16 rows in the first group). A contiguous
// cache passes ps = S, n_blocks = 1 and no table; null lengths give every
// slot `length`.
template <typename PT, int HD, typename Rows, int KW>
__global__ void __launch_bounds__(kVfThreads)
decode_mma_kernel(const bf16* __restrict__ q, const PT* __restrict__ kp,
                  const PT* __restrict__ vp,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ table,
                  const uint8_t* __restrict__ bitmap,
                  const int* __restrict__ lengths, int length,
                  bf16* __restrict__ out, int t, int n_kv, int g, int ps,
                  int n_blocks, int ahead, float scale_log2) {
  constexpr bool kQuant = IsInt8<PT>::value;
  constexpr int LD = ld(HD);
  constexpr int NS = decode_stages<PT>();
  constexpr int NW = kChunkRows / KW;     // keys per warp per chunk
  constexpr int SEGS = HD / 8;
  // The bitmap bytes of the rows each thread stages (bf16 copies cover
  // HD/8 segments a row, int8 loads HD/16).
  using Flags = std::conditional_t<Rows::kBitmap,
                                   RowFlags<kQuant ? HD / 16 : HD / 8>,
                                   AllSet>;
  extern __shared__ uint4 smem_u4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_u4);
  bf16* Ks = reinterpret_cast<bf16*>(smem);               // [NS][64][LD]
  bf16* Vs = Ks + NS * kChunkRows * LD;                   // [NS][64][LD]
  float* Ksc = reinterpret_cast<float*>(Vs + NS * kChunkRows * LD);
  float* Vsc = Ksc + NS * kChunkRows;                     // [NS][64] (int8)
  uint8_t* Ms = reinterpret_cast<uint8_t*>(
      kQuant ? Vsc + NS * kChunkRows : Ksc);              // [NS][64] flags
  bf16* Qs = Ks + (NS - 1) * kChunkRows * LD;             // [kVfQ][LD]

  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / n_kv;
  const int kvh = bh - b * n_kv;
  const int r0 = blockIdx.z * kVfQ;
  const int rows_blk = min(kVfQ, t * g - r0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int tile = warp / KW;             // the warp's 16-row q tile
  const int share = warp - tile * KW;     // its share of each chunk's keys
  const int n_heads = n_kv * g;
  const int cap = n_blocks * ps;
  // An inactive slot's stale length may sit at capacity: clamp it.
  const int len = min(max(lengths != nullptr ? lengths[b] : length, 0), cap);
  const Rows source = Rows::of(table, bitmap, b, kvh, ps, n_blocks, n_kv);

  // The furthest column any row of the block sees, and the split's chunks
  // of [0, c_end): split, split + n_splits, ...
  const int c_end = min(cap, len + (r0 + rows_blk - 1) / g + ahead);
  const int n_all = (c_end + kChunkRows - 1) / kChunkRows;
  const int n_ch = n_all > split ? (n_all - split + n_splits - 1) / n_splits
                                 : 0;
  auto chunk0 = [&](int ch) { return (split + ch * n_splits) * kChunkRows; };

  // q row of stacked row gr: token gr / g, head kvh * g + gr % g.
  auto q_row = [&](int gr) {
    const int tok = gr / g;
    return (static_cast<size_t>(b) * t + tok) * n_heads + kvh * g +
           (gr - tok * g);
  };
  // Chunk ch into stage st, its bitmap bytes (read a chunk ahead into
  // `flags`) beside it: bf16 rows by cp.async; int8 rows into `held`,
  // stored to the stage by store_held() after the products of the chunk in
  // flight.
  Flags flags;
  auto load_flags = [&](int ch) {
    if constexpr (Rows::kBitmap)
      flags.load(source.bitmap, chunk0(ch), c_end);
  };
  Int8Chunk<HD> held;
  int held_st = -1;
  auto stage = [&](int ch, int st) {
    const int c0 = chunk0(ch);
    flags.store(Ms + st * kChunkRows);
    if constexpr (kQuant) {
      held.load(kp, vp, k_scale, v_scale, source, c0, c_end, flags);
      held_st = st;
    } else {
      stage_bf16_chunk<HD>(kp, vp, source, c0, c_end,
                           Ks + st * kChunkRows * LD,
                           Vs + st * kChunkRows * LD, flags);
    }
  };
  auto store_held = [&]() {
    if constexpr (kQuant) {
      if (held_st >= 0) {
        held.store_raw(Ks + held_st * kChunkRows * LD,
                       Vs + held_st * kChunkRows * LD,
                       Ksc + held_st * kChunkRows, Vsc + held_st * kChunkRows);
        held_st = -1;
      }
    }
  };

  // Group 0: the q tile and chunk 0; then chunks 1 .. NS-2.
#pragma unroll
  for (int j = 0; j < kVfQ * SEGS / kVfThreads; ++j) {
    const int i = threadIdx.x + j * kVfThreads;
    const int rr = i / SEGS;
    const int sg = i - rr * SEGS;
    const bool ok = rr < rows_blk;
    cp_async16(Qs + rr * LD + sg * 8,
               q + (ok ? q_row(r0 + rr) : 0) * HD + sg * 8, ok);
  }
#pragma unroll
  for (int ch = 0; ch < NS - 1; ++ch) {
    if (ch < n_ch) {
      load_flags(ch);
      stage(ch, ch);
    }
    store_held();
    cp_async_commit();
  }
  if (NS - 1 < n_ch) load_flags(NS - 1);
  cp_async_wait<NS - 2>();
  __syncthreads();
  uint32_t qf[HD / 16][4];
  load_a_frags<HD>(Qs + 16 * tile * LD, lane, qf);

  const bool live = 16 * tile < rows_blk;
  const int rw0 = r0 + 16 * tile;         // the warp's first stacked row
  const int rw_last = min(rw0 + 16, r0 + rows_blk) - 1;
  // Columns each of the thread's two rows sees (a padding row as the
  // block's last), and the least and most of the warp's rows.
  int hi_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    hi_row[i] =
        min(cap, len + min(rw0 + (lane >> 2) + 8 * i, rw_last) / g + ahead);
  const int hi_least = min(cap, len + rw0 / g + ahead);
  const int hi_most = min(cap, len + rw_last / g + ahead);

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int ch = 0; ch < n_ch; ++ch) {
    __syncthreads();                      // the stage refilled next is read
    if (ch + NS - 1 < n_ch) {
      stage(ch + NS - 1, (ch + NS - 1) % NS);
      if (ch + NS < n_ch) load_flags(ch + NS);
    }
    cp_async_commit();
    cp_async_wait<NS - 1>();              // chunk ch has landed
    __syncthreads();
    const int st = ch % NS;
    const int k0 = chunk0(ch) + share * NW;
    const int cq = 2 * (lane & 3);        // the thread's first column
    // The thread's columns' flags; a warp with none set skips the chunk.
    bool keep[NW / 8][2];
    bool all_set = true, any_set = true;
    if constexpr (Rows::kBitmap) {
      const uint8_t* mw = Ms + st * kChunkRows + share * NW + cq;
      bool any = false;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          keep[j][e] = mw[8 * j + e] != 0;
          any = any || keep[j][e];
          all_set = all_set && keep[j][e];
        }
      any_set = __any_sync(0xffffffffu, any);
      all_set = __all_sync(0xffffffffu, all_set);
    }
    if (live && k0 < hi_most && any_set) {
      float s[NW / 8][4];
      warp_abt_held<HD, NW>(qf, Ks + (st * kChunkRows + share * NW) * LD,
                            lane, s);
      if constexpr (kQuant) {
        const float* ksc = Ksc + st * kChunkRows + share * NW + cq;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= ksc[8 * j + (e & 1)];
      }
      if (k0 + NW > hi_least || !all_set) {
#pragma unroll
        for (int j = 0; j < NW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bool masked = k0 + cq + 8 * j + (e & 1) >= hi_row[e >> 1];
            if constexpr (Rows::kBitmap) masked = masked || !keep[j][e & 1];
            if (masked) s[j][e] = -INFINITY;
          }
      }
      online_softmax<NW, HD>(s, scale_log2, m, l, acc);
      if constexpr (kQuant) {
        const float* vsc = Vsc + st * kChunkRows + share * NW + cq;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= vsc[8 * j + (e & 1)];
      }
      uint32_t p[NW / 16][4];
      to_a_frags<NW>(s, p);
      warp_pv<HD, NW>(p, Vs + (st * kChunkRows + share * NW) * LD, lane, acc);
    }
    store_held();
  }

  // The warps' partial rows into the ring, now free.
  cp_async_wait<0>();
  __syncthreads();
  constexpr int ALD = HD + kVfAccLd;
  float* Pacc = reinterpret_cast<float*>(smem);           // [4][16][ALD]
  float* Pm = Pacc + kVfWarps * 16 * ALD;                  // [4][16]
  float* Pl = Pm + kVfWarps * 16;                          // [4][16]
  float* Bm = Pl + kVfWarps * 16;                          // [kVfQ]
  float* Bl = Bm + kVfQ;                                   // [kVfQ]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    float* dst = Pacc + r * ALD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    if ((lane & 3) == 0) {
      Pm[r] = m[i];
      Pl[r] = l[i];
    }
  }
  __syncthreads();
  // The KW warps of each tile merge into the tile's first warp's rows (in
  // place: each element is read and written by one thread), with the
  // merged m and l in Bm / Bl.
  for (int i = threadIdx.x; i < rows_blk * (HD / 4); i += kVfThreads) {
    const int r = i / (HD / 4);
    const int d = (i - r * (HD / 4)) * 4;
    const int base = (r / 16) * KW * 16 + r % 16;         // warp w0's row
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < KW; ++w) mx = fmaxf(mx, Pm[base + 16 * w]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const float mw = Pm[base + 16 * w];
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      const float4 x =
          *reinterpret_cast<const float4*>(Pacc + (base + 16 * w) * ALD + d);
      a.x += wt * x.x;
      a.y += wt * x.y;
      a.z += wt * x.z;
      a.w += wt * x.w;
      lsum += wt * Pl[base + 16 * w];
    }
    *reinterpret_cast<float4*>(Pacc + base * ALD + d) = a;
    if (d == 0) {
      Bm[r] = mx;
      Bl[r] = lsum;
    }
  }
  cluster_merge_rows<HD, true, bf16>(
      rows_blk, Bm, Bl,
      [&](int r) { return Pacc + ((r / 16) * KW * 16 + r % 16) * ALD; },
      [&](int r) { return out + q_row(r0 + r) * HD; });
}

template <typename PT, int HD, typename Rows, int KW>
cudaError_t launch_decode_mma(const void* q, const void* k, const void* v,
                              const void* ks, const void* vs,
                              const void* table, const void* bitmap,
                              const void* lengths, int length, void* out,
                              int B, int t, int H, int Hkv, int ps,
                              int n_blocks, int n_splits, int ahead,
                              float scale, cudaStream_t stream) {
  const int g = H / Hkv;
  if (n_splits < 1 || n_splits > kMaxSplits) return cudaErrorInvalidValue;
  const dim3 grid(n_splits, B * Hkv, (t * g + kVfQ - 1) / kVfQ);
  const size_t smem = decode_smem_bytes<PT, HD, Rows>();
  auto* kernel = decode_mma_kernel<PT, HD, Rows, KW>;
  static bool configured = false, fits = false;
  cudaError_t err = allow_smem(kernel, smem, configured);
  if (err == cudaSuccess)
    err = check_cluster_fits(kernel, kVfThreads, smem, fits);
  if (err != cudaSuccess) return err;
  return launch_cluster(
      kernel, grid, kVfThreads, smem, stream, static_cast<const bf16*>(q),
      static_cast<const PT*>(k), static_cast<const PT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(table), static_cast<const uint8_t*>(bitmap),
      static_cast<const int*>(lengths), length, static_cast<bf16*>(out), t,
      Hkv, g, ps, n_blocks, ahead, scale * 1.4426950408889634f);
}

// KW from the tiles of the stack's first 64-row group.
template <typename PT, int HD>
cudaError_t launch_paged_mma(int tg, const void* q, const void* k,
                             const void* v, const void* ks, const void* vs,
                             const void* table, const void* lengths,
                             void* out, int B, int t, int H, int Hkv, int ps,
                             int n_blocks, int n_splits, int ahead,
                             float scale, cudaStream_t stream) {
#define PAGED_MMA(KW)                                                       \
  return launch_decode_mma<PT, HD, PagedRows, KW>(                          \
      q, k, v, ks, vs, table, nullptr, lengths, 0, out, B, t, H, Hkv, ps,   \
      n_blocks, n_splits, ahead, scale, stream)
  switch (((tg < kVfQ ? tg : kVfQ) + 15) / 16) {
    case 1: PAGED_MMA(4);
    case 2: PAGED_MMA(2);
    default: PAGED_MMA(1);
  }
#undef PAGED_MMA
}

}  // namespace

// K3 (ahead 1) and K1 (t 1, ahead 0) for bf16 q (bf16 or int8 pages),
// called from paged_attention.cu's launchers; head dims other than 64 and
// 128 are refused.
cudaError_t paged_window_bf16(const void* q, const void* k, const void* v,
                              const void* ks, const void* vs,
                              const void* table, const void* lengths,
                              void* out, int B, int t, int H, int Hkv, int hd,
                              int ps, int n_blocks, int n_splits, int ahead,
                              int kv_int8, float scale, cudaStream_t stream) {
#define WINDOW_MMA(PT, HD)                                                   \
  return launch_paged_mma<PT, HD>(t * (H / Hkv), q, k, v, ks, vs, table,     \
                                  lengths, out, B, t, H, Hkv, ps, n_blocks,  \
                                  n_splits, ahead, scale, stream)
  if (hd == 64) {
    if (kv_int8) WINDOW_MMA(int8_t, 64);
    WINDOW_MMA(bf16, 64);
  }
  if (hd == 128) {
    if (kv_int8) WINDOW_MMA(int8_t, 128);
    WINDOW_MMA(bf16, 128);
  }
#undef WINDOW_MMA
  return cudaErrorInvalidValue;
}

// K4 for bf16 q (bf16 or int8 caches), called from flash_decode.cu's
// launcher (null lengths: every slot's is `length`): a decode row of g <= 8
// heads is one tile (KW 4); head dims other than 64 and 128 are refused.
cudaError_t flash_decode_bf16(const void* q, const void* k, const void* v,
                              const void* ks, const void* vs,
                              const void* bitmap, const void* lengths,
                              int length, void* out, int B, int H, int Hkv,
                              int hd, int S, int n_splits, int kv_int8,
                              float scale, cudaStream_t stream) {
  if (H / Hkv > 16) return cudaErrorInvalidValue;
#define K4_MMA(PT, HD)                                                       \
  return launch_decode_mma<PT, HD, ContiguousRows, 4>(                       \
      q, k, v, ks, vs, nullptr, bitmap, lengths, length, out, B, 1, H, Hkv,  \
      S, 1, n_splits, 0, scale, stream)
  if (hd == 64) {
    if (kv_int8) K4_MMA(int8_t, 64);
    K4_MMA(bf16, 64);
  }
  if (hd == 128) {
    if (kv_int8) K4_MMA(int8_t, 128);
    K4_MMA(bf16, 128);
  }
#undef K4_MMA
  return cudaErrorInvalidValue;
}

}  // namespace port_kernels

// The dynamic shared memory launch_decode_mma requests for int8 or bf16
// pages, PagedRows (K1, K3) or ContiguousRows (K4); -1 for a head dim that
// is not instantiated. Read-only: the smem audit (analysis/smem.py) holds
// its mirror to it.
extern "C" long long decode_mma_smem_bytes(int kv_int8, int hd,
                                           int contiguous) {
  using namespace port_kernels;
#define DECODE_SMEM(PT, HD)                                                  \
  return static_cast<long long>(                                             \
      contiguous ? decode_smem_bytes<PT, HD, ContiguousRows>()               \
                 : decode_smem_bytes<PT, HD, PagedRows>())
  if (hd == 64) {
    if (kv_int8) DECODE_SMEM(int8_t, 64);
    DECODE_SMEM(bf16, 64);
  }
  if (hd == 128) {
    if (kv_int8) DECODE_SMEM(int8_t, 128);
    DECODE_SMEM(bf16, 128);
  }
#undef DECODE_SMEM
  return -1;
}
