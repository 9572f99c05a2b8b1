// Paged multi-query verify attention in bf16 on Hopper's tensor cores
// (sm_90a), its splits merged across a thread-block cluster.
//
// K3 paged_verify_mma_kernel replaces the Pallas kernel behind
//    k8s_gpu_scheduler_tpu/ops/decode_attention.py paged_verify_attention
//    (_verify_kernel): the speculative verify window, t = 1 + gamma query
//    rows per slot q [B, t, H, hd], row i attending the slot's pool rows
//    col < len + i + 1 through its block table [B, n_blocks] (int8 pages
//    carry f32 row scales [n_pages, ps, Hkv]), out [B, t, H, hd] in bf16.
// paged_attention.cu sends bf16 q here (bf16 or int8 pages); f32 q keeps
// its CUDA-core kernel paged_verify_kernel (see there).
//
// What bounds it: bytes. Each live K/V row is read once for t*g query
// rows, 4 t g FLOPs a (bf16) K/V element pair: 20 at the serve width (t 5,
// g 1), 0.0074 ms of bytes against far less of operations. Yet at GQA the
// CUDA cores cannot keep pace with the bytes: at t*g = 20 or 40 (g 4 or 8)
// that is 40-80 FLOPs per K/V byte, 134-268 TFLOP/s at 3.35 TB/s, past the
// 67 TFLOP/s of f32 FMA. So both products run on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 sums, mma.cuh's warp tiles), and
// the design keeps the loads in flight:
//
// - Row stack. Stacked row r of a (slot, kv head) is window token r / g,
//   group head r % g (the JAX kernel's fold), so the g heads of a kv head
//   share every K/V chunk; it attends col < len + r / g + 1. The stack is
//   cut into groups of 64 rows (grid z), each padded to 16-row tiles.
// - Warps split keys as well as rows. Each of the 4 warps owns one 16-row
//   q tile and a share of each K/V chunk's keys: with one tile the 4 warps
//   take 16 keys each, with two tiles 32, with three or four all 64 (one
//   warp idles at three). So no warp idles at t*g <= 32 or in (48, 64],
//   where the old CUDA-core kernel left three of four idle at the serve
//   width. The q fragments load once into registers; the accumulator is one
//   16-row tile a warp.
// - K/V staging. 64-row chunks independent of the page size (row c from
//   page table[c / ps], row c % ps; paged_stage.cuh, shared with K2) pass
//   through a cp.async ring, so the next chunks' copies are in flight
//   during a chunk's products: three stages for bf16 pools, two for int8,
//   whose rows go through registers one chunk at a time (loaded before a
//   chunk's products, stored after them as raw values, exact in bf16, with
//   their rows' scales), so that a third stage would only cost occupancy
//   (verify_stages; chosen by a timed call on the card, PERF.md). The q
//   tile is staged in the last stage before that stage's first chunk.
// - int8 arithmetic follows the plain version exactly: Q K^T of the raw
//   rows, each score column times its f32 k_scale after the product; P V
//   of p times v_scale[col], rounded once to bf16, against the raw V rows;
//   the row sum l takes the unscaled p (dense_verify_reference's factoring).
//   bf16 pools round P once, as K5 does.
// - Masks. Only the chunk or chunks that cross a row's bound (or the
//   split's end) are masked, to -inf before exp2, so p is exactly 0. A warp
//   whose key share lies wholly past its rows' bounds skips the products.
// - Splits. Split s (grid x) covers logical pages [s*pps, (s+1)*pps) of
//   the slot's live pages ceil((len + t) / ps), as K1's do, so the SMs fill
//   at any batch. The split's blocks form one cluster: each block merges
//   its warps' partials through shared memory, then rank 0 merges the
//   splits through distributed shared memory (cluster_merge.cuh) and writes
//   [B, t, H, hd] in bf16 directly: no partial buffers, no second pass, no
//   atomics. Each output is summed in a fixed order: deterministic.
//
// Build: ops/_build.py compiles this file beside the other sources into one
// library; the launch function returns cudaGetLastError().

#include <math.h>

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
__host__ __device__ constexpr int verify_stages() {
  return IsInt8<PT>::value ? 2 : 3;
}

template <typename PT, int HD>
constexpr size_t verify_smem_bytes() {
  // The ring: K and V stages (and the int8 rows' scales); after the loop
  // it holds the warps' partial rows for the merges.
  constexpr int NS = verify_stages<PT>();
  constexpr size_t ring =
      sizeof(bf16) * 2 * NS * kChunkRows * ld(HD) +
      (IsInt8<PT>::value ? sizeof(float) * 2 * NS * kChunkRows : 0);
  constexpr size_t merge =
      sizeof(float) * (kVfWarps * 16 * (HD + kVfAccLd) + 4 * kVfWarps * 16);
  return ring > merge ? ring : merge;
}

// One block's row group, its warps splitting each chunk's keys KW ways
// (KW = 4, 2, 1 for 1, 2, 3-4 tiles of 16 rows).
template <typename PT, int HD, int KW>
__device__ __forceinline__ void verify_rows(
    const bf16* __restrict__ q, const PT* __restrict__ kp,
    const PT* __restrict__ vp, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ trow,
    bf16* __restrict__ out, unsigned char* smem, int b, int kvh, int t,
    int n_kv, int g, int ps, int n_blocks, int len, int r0, int rows_blk,
    float scale_log2) {
  constexpr bool kQuant = IsInt8<PT>::value;
  constexpr int LD = ld(HD);
  constexpr int NS = verify_stages<PT>();
  constexpr int NW = kChunkRows / KW;     // keys per warp per chunk
  constexpr int SEGS = HD / 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem);               // [NS][64][LD]
  bf16* Vs = Ks + NS * kChunkRows * LD;                   // [NS][64][LD]
  float* Ksc = reinterpret_cast<float*>(Vs + NS * kChunkRows * LD);
  float* Vsc = Ksc + NS * kChunkRows;                     // [NS][64] each
  bf16* Qs = Ks + (NS - 1) * kChunkRows * LD;             // [kVfQ][LD]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int tile = warp / KW;             // the warp's 16-row q tile
  const int share = warp - tile * KW;     // its share of each chunk's keys
  const int n_heads = n_kv * g;
  const int rows_total = t * g;

  // The split's columns, and the furthest any row of the block sees.
  const int cap = n_blocks * ps;
  const int pages_live = min((len + t + ps - 1) / ps, n_blocks);
  const int pps = (pages_live + gridDim.x - 1) / gridDim.x;
  const int p0 = blockIdx.x * pps;
  const int c_lo = p0 * ps;
  const int split_hi = min(min(p0 + pps, pages_live) * ps, cap);
  const int c_end = min(split_hi, len + (r0 + rows_blk - 1) / g + 1);
  const int n_ch =
      c_end > c_lo ? (c_end - c_lo + kChunkRows - 1) / kChunkRows : 0;

  // q row of stacked row gr: token gr / g, head kvh * g + gr % g.
  auto q_row = [&](int gr) {
    const int tok = gr / g;
    return (static_cast<size_t>(b) * t + tok) * n_heads + kvh * g +
           (gr - tok * g);
  };
  // Chunk ch into stage st: bf16 rows by cp.async; int8 rows into `held`,
  // stored to the stage by store_held() after the products of the chunk in
  // flight.
  Int8Chunk<HD> held;
  int held_st = -1;
  auto stage = [&](int ch, int st) {
    const int c0 = c_lo + ch * kChunkRows;
    if constexpr (kQuant) {
      held.load(kp, vp, k_scale, v_scale, trow, ps, n_kv, kvh, c0, c_end);
      held_st = st;
    } else {
      stage_bf16_chunk<HD>(kp, vp, trow, ps, n_kv, kvh, c0, c_end,
                           Ks + st * kChunkRows * LD,
                           Vs + st * kChunkRows * LD);
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
    if (ch < n_ch) stage(ch, ch);
    store_held();
    cp_async_commit();
  }
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
    hi_row[i] = min(split_hi,
                    len + min(rw0 + (lane >> 2) + 8 * i, rw_last) / g + 1);
  const int hi_least = min(split_hi, len + rw0 / g + 1);
  const int hi_most = min(split_hi, len + rw_last / g + 1);

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int ch = 0; ch < n_ch; ++ch) {
    __syncthreads();                      // the stage refilled next is read
    if (ch + NS - 1 < n_ch) stage(ch + NS - 1, (ch + NS - 1) % NS);
    cp_async_commit();
    cp_async_wait<NS - 1>();              // chunk ch has landed
    __syncthreads();
    const int st = ch % NS;
    const int k0 = c_lo + ch * kChunkRows + share * NW;
    if (live && k0 < hi_most) {
      float s[NW / 8][4];
      warp_abt_held<HD, NW>(qf, Ks + (st * kChunkRows + share * NW) * LD,
                            lane, s);
      const int cq = 2 * (lane & 3);      // the thread's first column
      if constexpr (kQuant) {
        const float* ksc = Ksc + st * kChunkRows + share * NW + cq;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= ksc[8 * j + (e & 1)];
      }
      if (k0 + NW > hi_least) {
#pragma unroll
        for (int j = 0; j < NW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + cq + 8 * j + (e & 1) >= hi_row[e >> 1])
              s[j][e] = -INFINITY;
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

// grid (n_splits, B * Hkv, ceil(t*g / kVfQ)), cluster (n_splits, 1, 1),
// kVfThreads threads.
template <typename PT, int HD>
__global__ void __launch_bounds__(kVfThreads)
paged_verify_mma_kernel(const bf16* __restrict__ q, const PT* __restrict__ kp,
                        const PT* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths,
                        bf16* __restrict__ out, int t, int n_kv, int g,
                        int ps, int n_blocks, float scale_log2) {
  extern __shared__ uint4 smem_u4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_u4);
  const int bh = blockIdx.y;
  const int b = bh / n_kv;
  const int kvh = bh - b * n_kv;
  const int r0 = blockIdx.z * kVfQ;
  const int rows_blk = min(kVfQ, t * g - r0);
  // An inactive slot's stale length may sit at capacity: clamp it.
  const int len = min(max(lengths[b], 0), n_blocks * ps);
  const int* trow = table + static_cast<size_t>(b) * n_blocks;
#define K3_ROWS(KW)                                                         \
  verify_rows<PT, HD, KW>(q, kp, vp, ks, vs, trow, out, smem, b, kvh, t,   \
                          n_kv, g, ps, n_blocks, len, r0, rows_blk,         \
                          scale_log2)
  switch ((rows_blk + 15) / 16) {
    case 1: K3_ROWS(4); break;
    case 2: K3_ROWS(2); break;
    default: K3_ROWS(1); break;
  }
#undef K3_ROWS
}

template <typename PT, int HD>
cudaError_t launch_verify_mma(const void* q, const void* k, const void* v,
                              const void* ks, const void* vs,
                              const void* table, const void* lengths,
                              void* out, int B, int t, int H, int Hkv, int ps,
                              int n_blocks, int n_splits, float scale,
                              cudaStream_t stream) {
  const int g = H / Hkv;
  if (n_splits < 1 || n_splits > kMaxSplits) return cudaErrorInvalidValue;
  const dim3 grid(n_splits, B * Hkv, (t * g + kVfQ - 1) / kVfQ);
  const size_t smem = verify_smem_bytes<PT, HD>();
  static bool configured = false, fits = false;
  cudaError_t err =
      allow_smem(paged_verify_mma_kernel<PT, HD>, smem, configured);
  if (err == cudaSuccess)
    err = check_cluster_fits(paged_verify_mma_kernel<PT, HD>, kVfThreads,
                             smem, fits);
  if (err != cudaSuccess) return err;
  return launch_cluster(
      paged_verify_mma_kernel<PT, HD>, grid, kVfThreads, smem, stream,
      static_cast<const bf16*>(q), static_cast<const PT*>(k),
      static_cast<const PT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<bf16*>(out), t, Hkv, g,
      ps, n_blocks, scale * 1.4426950408889634f);
}

}  // namespace

// K3 for bf16 q (bf16 or int8 pages), called from paged_attention.cu's
// launcher; head dims other than 64 and 128 are refused.
cudaError_t paged_verify_bf16(const void* q, const void* k, const void* v,
                              const void* ks, const void* vs,
                              const void* table, const void* lengths,
                              void* out, int B, int t, int H, int Hkv, int hd,
                              int ps, int n_blocks, int n_splits, int kv_int8,
                              float scale, cudaStream_t stream) {
#define K3_MMA(PT, HD)                                                       \
  return launch_verify_mma<PT, HD>(q, k, v, ks, vs, table, lengths, out, B,  \
                                   t, H, Hkv, ps, n_blocks, n_splits, scale, \
                                   stream)
  if (hd == 64) {
    if (kv_int8) K3_MMA(int8_t, 64);
    K3_MMA(bf16, 64);
  }
  if (hd == 128) {
    if (kv_int8) K3_MMA(int8_t, 128);
    K3_MMA(bf16, 128);
  }
#undef K3_MMA
  return cudaErrorInvalidValue;
}

}  // namespace port_kernels
