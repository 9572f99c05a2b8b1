// Paged prefix-prefill attention in bf16 on Hopper's tensor cores (sm_90a).
//
// K2 paged_prefill_mma_kernel replaces the Pallas kernel behind
//    k8s_gpu_scheduler_tpu/ops/decode_attention.py paged_prefill_attention
//    (_prefill_kernel): the tail window q [M, tb, H, hd] attends over each
//    entry's cached prefix, read from the page pool [n_pages, ps, Hkv, hd]
//    through prefix_table [M, hb] (column c visible iff c < hit_len; int8
//    pages dequantized by their f32 row scales [n_pages, ps, Hkv]), then
//    over the tail's own K/V [M, tb, Hkv, hd], causally.
// paged_attention.cu sends bf16 q here (bf16 or int8 pages); f32 q keeps
// its CUDA-core kernel paged_prefill_kernel (see there).
//
// What bounds it: operations. A (entry, kv head) pair does tb*g query rows
// against hit_len + tb keys, 4 hd FLOPs a visible (q, k) pair; at the
// serving shapes (tb 512, hits up to 512 rows) that is tens to hundreds of
// FLOPs a byte of K/V read, so both products run on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 sums) with mma.cuh's warp tiles:
//
// - Grid (ceil(tb*g / 64), Hkv, M), 4 warps of 16 rows. Stacked row r of
//   the (entry, kv head) is tail token r / g, group head r % g (the JAX
//   kernel's fold), so the g heads of a kv head share every K/V chunk.
//   The q tile is staged once by cp.async, zero past tb*g.
// - K/V pass in 64-row chunks, independent of the page size: prefix row c
//   comes from page table[c / ps], row c % ps, so pages of 8 to 256 rows
//   all work. The prefix is walked up to ceil(hit / 64) chunks, then the
//   tail up to the tile's last token. bf16 rows are staged by cp.async
//   into a two-stage ring (zero past the chunk's end), so the next chunk's
//   copy is in flight during the current chunk's products. int8 rows go
//   through registers: loaded before the current chunk's products, then
//   each value times its row scale in f32, rounded to bf16 and stored to
//   the next stage after them (the operands dense_prefill_reference builds
//   when it dequantizes to q's dtype), so their loads overlap the products
//   too. Both staging paths live in paged_stage.cuh, shared with K1, K3
//   and K4.
// - S = Q K^T and O += P V on mma.sync, the online softmax in registers
//   (online_softmax: rows lane/4 and lane/4 + 8, quad shuffles, f32 p into
//   the row sum, P rounded once to bf16 as the A fragments of P V).
// - Masks: only the prefix chunk holding hit (column c >= hit) and the
//   tail chunks that cross the warp's tokens (column > token) are masked,
//   to -inf, so p is exactly 0 and exp2 never sees a masked score. Every
//   tail row sees tail column 0, so no stored row is fully masked. A warp
//   whose 16 rows all lie past tb*g, or all before a tail chunk's first
//   column, skips that chunk's products.
// - Each output element is summed by one thread in a fixed order, with no
//   atomics: the kernel is deterministic.
//
// Build: ops/_build.py compiles this file beside the other sources into one
// library; the launch function returns cudaGetLastError().

#include <math.h>

#include "common.cuh"
#include "mma.cuh"
#include "paged_stage.cuh"

namespace port_kernels {
namespace {

constexpr int kPfWarps = 4;               // 64 stacked q rows a block
constexpr int kPfThreads = 32 * kPfWarps;
constexpr int kPfQ = 16 * kPfWarps;
constexpr int kPfK = kChunkRows;          // K/V rows per chunk
static_assert(kPfThreads == kChunkThreads, "the block stages the chunks");

template <int HD>
constexpr size_t prefill_smem_bytes() {
  return sizeof(bf16) * (kPfQ + 4 * kPfK) * ld(HD);
}

// grid (ceil(tb*g / kPfQ), Hkv, M), kPfThreads threads. Warp w owns
// stacked rows r0 + 16w .. r0 + 16w + 15 of the block's tile.
template <typename PT, int HD>
__global__ void __launch_bounds__(kPfThreads)
paged_prefill_mma_kernel(const bf16* __restrict__ q, const PT* __restrict__ kp,
                         const PT* __restrict__ vp,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ table,
                         const int* __restrict__ hit_lens,
                         const bf16* __restrict__ tk,
                         const bf16* __restrict__ tv, bf16* __restrict__ out,
                         int tb, int n_kv, int g, int ps, int hb,
                         float scale_log2) {
  constexpr int LD = ld(HD);
  constexpr int NK = kPfK / 8;
  constexpr int SEGS = HD / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);           // [kPfQ][LD]
  bf16* Ks = Qs + kPfQ * LD;                              // [2][kPfK][LD]
  bf16* Vs = Ks + 2 * kPfK * LD;                          // [2][kPfK][LD]

  const int kvh = blockIdx.y;
  const int ent = blockIdx.z;
  const int n_heads = n_kv * g;
  const int rows_total = tb * g;
  const int r0 = blockIdx.x * kPfQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int hit = min(max(hit_lens[ent], 0), hb * ps);
  const int tok_hi = (min(r0 + kPfQ, rows_total) - 1) / g;
  const int n_pre = (hit + kPfK - 1) / kPfK;
  const int n_all = n_pre + (tok_hi + 1 + kPfK - 1) / kPfK;
  const int* trow = table + static_cast<size_t>(ent) * hb;
  const size_t tail_off =
      (static_cast<size_t>(ent) * tb * n_kv + kvh) * HD;
  // q row of stacked row gr: token gr / g, head kvh * g + gr % g.
  auto q_row = [&](int gr) {
    const int tok = gr / g;
    return (static_cast<size_t>(ent) * tb + tok) * n_heads + kvh * g +
           (gr - tok * g);
  };
  // Chunk ch into stage st: bf16 rows by cp.async; int8 pool rows into
  // `held`, stored to the stage by store_held() after the products of the
  // chunk in flight.
  Int8Chunk<HD> held;
  bf16* held_at = nullptr;
  auto stage = [&](int ch, int st) {
    bf16* Kd = Ks + st * kPfK * LD;
    bf16* Vd = Vs + st * kPfK * LD;
    if (ch >= n_pre) {
      stage_bf16_chunk<HD>(tk + tail_off, tv + tail_off,
                           ContiguousRows{0, n_kv, nullptr},
                           (ch - n_pre) * kPfK, tok_hi + 1, Kd, Vd);
    } else if constexpr (IsInt8<PT>::value) {
      held.load(kp, vp, ks, vs, PagedRows{trow, ps, n_kv, kvh}, ch * kPfK,
                hit);
      held_at = Kd;
    } else {
      stage_bf16_chunk<HD>(kp, vp, PagedRows{trow, ps, n_kv, kvh},
                           ch * kPfK, hit, Kd, Vd);
    }
  };
  auto store_held = [&]() {
    if (held_at != nullptr) {
      held.store(held_at, held_at + 2 * kPfK * LD);
      held_at = nullptr;
    }
  };

#pragma unroll
  for (int j = 0; j < kPfQ * SEGS / kPfThreads; ++j) {
    const int i = threadIdx.x + j * kPfThreads;
    const int rr = i / SEGS;
    const int sg = i - rr * SEGS;
    const bool ok = r0 + rr < rows_total;
    cp_async16(Qs + rr * LD + sg * 8, q + (ok ? q_row(r0 + rr) : 0) * HD +
                                          sg * 8, ok);
  }
  stage(0, 0);
  store_held();
  cp_async_commit();

  const int rw0 = r0 + 16 * warp;        // the warp's first stacked row
  const int rows[2] = {rw0 + (lane >> 2), rw0 + (lane >> 2) + 8};
  const int toks[2] = {rows[0] / g, rows[1] / g};
  const int tok_lo = rw0 / g;             // the warp's first token
  const int tok_last = (min(rw0 + 16, rows_total) - 1) / g;
  const bf16* Qw = Qs + 16 * warp * LD;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int ch = 0; ch < n_all; ++ch) {
    __syncthreads();                      // the stage refilled next is read
    if (ch + 1 < n_all) stage(ch + 1, (ch + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();                   // chunk ch (and q) have landed
    __syncthreads();
    const bool tail = ch >= n_pre;
    const int c0 = (tail ? ch - n_pre : ch) * kPfK;
    // Rows past tb*g, or a tail chunk wholly after the warp's tokens.
    if (rw0 >= rows_total || (tail && c0 > tok_last)) {
      store_held();
      continue;
    }
    const bf16* Kt = Ks + (ch & 1) * kPfK * LD;
    const bf16* Vt = Vs + (ch & 1) * kPfK * LD;
    float s[NK][4];
    warp_abt<HD, kPfK>(Qw, Kt, lane, s);
    if (tail ? c0 + kPfK - 1 > tok_lo : c0 + kPfK > hit) {
      const int col0 = c0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = col0 + 8 * j + (e & 1);
          if (tail ? col > toks[e >> 1] : col >= hit) s[j][e] = -INFINITY;
        }
    }
    online_softmax<kPfK, HD>(s, scale_log2, m, l, acc);
    uint32_t p[kPfK / 16][4];
    to_a_frags<kPfK>(s, p);
    warp_pv<HD, kPfK>(p, Vt, lane, acc);
    store_held();
  }

  float row_lse[2];
  finish_softmax<HD>(m, l, acc, row_lse);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= rows_total) continue;
    bf16* o = out + q_row(rows[i]) * HD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

template <typename PT, int HD>
cudaError_t launch_prefill_mma(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs,
                               const void* table, const void* hits,
                               const void* tk, const void* tv, void* out,
                               int M, int tb, int H, int Hkv, int ps, int hb,
                               float scale, cudaStream_t stream) {
  const int g = H / Hkv;
  const dim3 grid((tb * g + kPfQ - 1) / kPfQ, Hkv, M);
  const size_t smem = prefill_smem_bytes<HD>();
  static bool configured = false;
  const cudaError_t err =
      allow_smem(paged_prefill_mma_kernel<PT, HD>, smem, configured);
  if (err != cudaSuccess) return err;
  paged_prefill_mma_kernel<PT, HD><<<grid, kPfThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const PT*>(k),
      static_cast<const PT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(hits), static_cast<const bf16*>(tk),
      static_cast<const bf16*>(tv), static_cast<bf16*>(out), tb, Hkv, g, ps,
      hb, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// K2 for bf16 q (bf16 or int8 pages), called from paged_attention.cu's
// launcher; head dims other than 64 and 128 are refused.
cudaError_t paged_prefill_bf16(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs,
                               const void* table, const void* hits,
                               const void* tk, const void* tv, void* out,
                               int M, int tb, int H, int Hkv, int hd, int ps,
                               int hb, int kv_int8, float scale,
                               cudaStream_t stream) {
#define K2_MMA(PT, HD)                                                       \
  return launch_prefill_mma<PT, HD>(q, k, v, ks, vs, table, hits, tk, tv,   \
                                    out, M, tb, H, Hkv, ps, hb, scale, stream)
  if (hd == 64) {
    if (kv_int8) K2_MMA(int8_t, 64);
    K2_MMA(bf16, 64);
  }
  if (hd == 128) {
    if (kv_int8) K2_MMA(int8_t, 128);
    K2_MMA(bf16, 128);
  }
#undef K2_MMA
  return cudaErrorInvalidValue;
}

}  // namespace port_kernels

// The dynamic shared memory launch_prefill_mma requests (the same for bf16
// and int8 pages); -1 for a head dim that is not instantiated. Read-only:
// the smem audit (analysis/smem.py) holds its mirror to it.
extern "C" long long paged_prefill_mma_smem_bytes(int kv_int8, int hd) {
  (void)kv_int8;
  if (hd == 64) return port_kernels::prefill_smem_bytes<64>();
  if (hd == 128) return port_kernels::prefill_smem_bytes<128>();
  return -1;
}
