// Paged attention kernels for the serving engine, for Hopper (sm_90a).
//
// K1 paged_decode_kernel (f32 q; bf16 q: decode_mma.cu) replaces the
//    Pallas kernel behind
//    k8s_gpu_scheduler_tpu/ops/decode_attention.py paged_decode_attention
//    (_paged_kernel -> _decode_kernel): one query row per slot against a
//    shared page pool through a block table, masked to col < length.
// K2 paged_prefill_kernel (f32 q; bf16 q: paged_prefill_mma.cu) replaces
//    the Pallas kernel behind
//    k8s_gpu_scheduler_tpu/ops/decode_attention.py paged_prefill_attention
//    (_prefill_kernel): the prefix-cache tail prefill, cached prefix pages
//    (fully visible below hit_len) then the tail's own K/V (causal).
// K3 paged_verify_kernel (f32 q; bf16 q: decode_mma.cu) replaces the
//    Pallas kernel behind
//    k8s_gpu_scheduler_tpu/ops/decode_attention.py paged_verify_attention
//    (_verify_kernel): the speculative verify window, t = 1 + gamma query
//    rows per slot, row i masked to col < length + i + 1.
//
// What bounds them on an H100 and what the design does about it:
//
// K1 is bound by bytes: every live K/V row is read once and used for g
//    query heads, about g*4 flops per byte in bf16, far below the ~295
//    flops/byte where the tensor cores would be the limit. bf16 q runs on
//    the tensor-core body it shares with K3 and K4 (decode_mma.cu), whose
//    cp.async ring keeps more rows in flight than register loads do. f32
//    q runs here, on the CUDA cores in f32 (the JAX kernel's numerics; the
//    tensor cores would round f32 operands). It reads each row once and
//    never more: one block per (slot, kv head, split) keeps the g query
//    heads of the group in registers and streams the group's rows with
//    16-byte loads (8 elements per lane, hd/8 lanes per row, several rows
//    in flight per warp). Pages past ceil(len/ps)
//    are never touched, so traffic is O(length), and int8 pages are
//    dequantized in registers. The split count fills the 132 SMs when
//    slots x kv heads alone would not. The splits of one (slot, kv head)
//    are one thread-block cluster: each block merges its row groups in
//    shared memory, then rank 0 merges the splits by log-sum-exp through
//    distributed shared memory (cluster_merge.cuh) and writes [B, H, hd].
//    The JAX package merged them in XLA; here no partial buffer, second
//    pass or atomic is needed.
// K2 does tb*g query rows against hit_len + tb keys per (entry, kv head):
//    at the serving shapes that is tens of flops per byte, so it is bound
//    by operations. bf16 q runs on the tensor cores (paged_prefill_mma.cu).
//    f32 q runs here, on the CUDA cores in f32 (the JAX kernel's numerics;
//    the tensor cores would round f32 operands): one block per (entry, kv
//    head, 32-row q tile) stages the q tile once, then streams 32-row K/V
//    chunks (prefix through the table, then the tail up to the tile's last
//    token) through shared memory, where all 32 q rows reuse them. The
//    tile replaces the TPU's PREFILL_MAX_Q_ROWS cap: any tb works.
// K3 has t*g query rows per (slot, kv head): 5 at the serve width (g 1,
//    gamma 4), 40 at g 8. bf16 q runs on the tensor cores (decode_mma.cu,
//    which says why). f32 q runs here, on the CUDA
//    cores in f32 (the JAX kernel's numerics): K2's tiling, 32 q rows
//    staged in shared memory, each live page's K/V streamed once through a
//    32-row shared tile that every q row of the tile reuses, f32 online
//    softmax per row. K1's split over the live pages, ceil((len + t) /
//    ps), keeps the SMs busy, and the splits merge across the cluster as
//    K1's do. Warps whose 8 rows all lie past t*g skip the arithmetic.
//
// Numerics follow the JAX kernels: scores, softmax statistics and the PV
// accumulator in f32, int8 rows dequantized (value * row scale) on load,
// masked columns contribute exactly zero, a fully masked row yields zero,
// and the output is cast to q's dtype (round to nearest even for bf16).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -c, linked with the other sources into one
//        library (ops/_build.py). Plain C interface for ctypes; each launch
//        function returns cudaGetLastError().

#include <atomic>
#include <math.h>

#include "cluster_merge.cuh"
#include "common.cuh"

namespace port_kernels {

std::atomic<int> g_first_use{0};
void note_first_use() { g_first_use.fetch_add(1, std::memory_order_relaxed); }

// K2 for bf16 q, on the tensor cores (paged_prefill_mma.cu).
cudaError_t paged_prefill_bf16(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs,
                               const void* table, const void* hits,
                               const void* tk, const void* tv, void* out,
                               int M, int tb, int H, int Hkv, int hd, int ps,
                               int hb, int kv_int8, float scale,
                               cudaStream_t stream);

// K1 (t 1, ahead 0) and K3 (ahead 1) for bf16 q, on the tensor cores
// (decode_mma.cu): window row i attends col < length + i + ahead.
cudaError_t paged_window_bf16(const void* q, const void* k, const void* v,
                              const void* ks, const void* vs,
                              const void* table, const void* lengths,
                              void* out, int B, int t, int H, int Hkv, int hd,
                              int ps, int n_blocks, int n_splits, int ahead,
                              int kv_int8, float scale, cudaStream_t stream);

}  // namespace port_kernels

namespace {

using namespace port_kernels;

constexpr int kThreads = 128;

// Dims sg*8..sg*8+7 of K and V at logical row c of one slot, read through
// its block-table row and dequantized (value * row scale) for int8 pools.
template <typename PT, int HD>
__device__ __forceinline__ void load_paged_kv8(
    const PT* __restrict__ kp, const PT* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ trow, int c, int ps, int n_kv, int kvh, int sg,
    float (&k8)[8], float (&v8)[8]) {
  const int page = trow[c / ps];
  const size_t row = (static_cast<size_t>(page) * ps + (c % ps)) * n_kv + kvh;
  load8(kp + row * HD + sg * 8, k8);
  load8(vp + row * HD + sg * 8, v8);
  if (IsInt8<PT>::value) {
    const float a = ks[row];
    const float s = vs[row];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      k8[e] *= a;
      v8[e] *= s;
    }
  }
}

// -- K1: paged decode (f32 q) --------------------------------------------------
//
// grid (n_splits, B * Hkv), cluster (n_splits, 1, 1), 128 threads. A key
// row is read by hd/8 lanes (8 dims each); a warp covers 32/(hd/8) rows
// per step and the block NG = 4 * that many row groups. Each row group
// keeps its own running (m, l, acc) for the g heads; the groups merge
// through shared memory at the end, then the splits across the cluster.
// Split s covers logical pages [s*pps, (s+1)*pps) of the slot's live
// pages, pps = ceil(live pages / n_splits): the splits share the live
// length, not the table width, so a short slot in a long table still
// spreads over every split.
template <typename KT, int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const KT* __restrict__ kp,
                    const KT* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int n_kv, int ps, int n_blocks, float scale) {
  constexpr bool kQuant = IsInt8<KT>::value;
  constexpr int LPR = HD / 8;             // lanes per key row
  constexpr int RPW = 32 / LPR;           // key rows per warp step
  constexpr int NG = (kThreads / 32) * RPW;
  constexpr int U = G <= 2 ? 4 : 2;       // row steps in flight per lane

  __shared__ float sm_m[NG][G];
  __shared__ float sm_l[NG][G];
  __shared__ float sm_acc[NG][G][HD];
  __shared__ __align__(16) float mg_acc[G][HD];   // the block's merged rows
  __shared__ float mg_m[G], mg_l[G];

  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / n_kv;
  const int kvh = bh - b * n_kv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane / LPR;
  const int seg = lane - sub * LPR;
  const int grp = warp * RPW + sub;
  const int n_heads = n_kv * G;

  int len = lengths[b];
  len = min(max(len, 0), n_blocks * ps);
  const int pages_live = (len + ps - 1) / ps;
  const int pps = (pages_live + n_splits - 1) / n_splits;
  const int p0 = split * pps;
  const int p1 = min(p0 + pps, pages_live);
  const int row_lo = p0 * ps;
  const int row_hi = min(p1 * ps, len);   // <= row_lo: nothing to read

  float qv[G][8];
#pragma unroll
  for (int h = 0; h < G; ++h)
    load8(q + (static_cast<size_t>(b) * n_heads + kvh * G + h) * HD + seg * 8,
          qv[h]);

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[h][e] = 0.f;
  }

  const int* trow = table + static_cast<size_t>(b) * n_blocks;
  // Every lane of a warp runs the same number of steps (the shuffles
  // below need the whole warp); rows past row_hi are loaded as nothing
  // and skipped in the update.
  for (int base = row_lo + warp * RPW; base < row_hi; base += NG * U) {
    float kf[U][8], vf[U][8];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + u * NG + sub;
      valid[u] = c < row_hi;
      if (valid[u]) {
        const int page = trow[c / ps];
        const size_t row =
            (static_cast<size_t>(page) * ps + (c % ps)) * n_kv + kvh;
        load8(kp + row * HD + seg * 8, kf[u]);
        load8(vp + row * HD + seg * 8, vf[u]);
        if (kQuant) {
          const float a = ks[row];
          const float s = vs[row];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            kf[u][e] *= a;
            vf[u][e] *= s;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d += qv[h][e] * kf[u][e];
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        if (valid[u]) {
          const float s = d * scale;
          const float mn = fmaxf(m[h], s);
          const float alpha = expf(m[h] - mn);
          const float p = expf(s - mn);
          l[h] = l[h] * alpha + p;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[h][e] = acc[h][e] * alpha + p * vf[u][e];
          m[h] = mn;
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (seg == 0) {
      sm_m[grp][h] = m[h];
      sm_l[grp][h] = l[h];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sm_acc[grp][h][seg * 8 + e] = acc[h][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int h = i / HD;
    const int d = i - h * HD;
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < NG; ++r) mx = fmaxf(mx, sm_m[r][h]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int r = 0; r < NG; ++r) {
      const float w = expf(sm_m[r][h] - mx);
      a += w * sm_acc[r][h][d];
      lsum += w * sm_l[r][h];
    }
    mg_acc[h][d] = a;
    if (d == 0) {
      mg_m[h] = mx;
      mg_l[h] = lsum;
    }
  }
  cluster_merge_rows<HD, false, float>(
      G, mg_m, mg_l, [&](int h) { return &mg_acc[h][0]; },
      [&](int h) {
        return out + (static_cast<size_t>(b) * n_heads + kvh * G + h) * HD;
      });
}

// -- K2: prefix-attention prefill ---------------------------------------------
//
// grid (ceil(tb*g / 32), Hkv, M), 128 threads; q row r of the (entry, kv
// head) stack is tail token r / g, group head r % g. Thread t owns q row
// t / 4 of the tile; the four threads of a row split its score columns
// (col = t%4 + 4k) and its output dims (d = t%4 + 4j).
constexpr int kQRows = 32;
constexpr int kKRows = 32;

template <int HD>
constexpr int prefill_smem_floats() {
  return kQRows * (HD + 1) + kKRows * (HD + 1) + kKRows * HD +
         kQRows * (kKRows + 1);
}

// One 32-column chunk of the online softmax of the tile's 32 q rows (K2,
// K3): thread (r, quad) scores columns quad + 4k (k < 8) of row r from Qs
// and Ks, gives the columns vis[] rules out exactly zero weight (never
// exp(s - m) of a masked score: a row whose bound has not reached this
// chunk keeps m at -1e30, where that would be 1), updates the row's
// running (m, l) through the quad's shuffles and adds P·V into acc
// (output dims quad + 4j). Every lane of the warp must call it.
template <int HD>
__device__ __forceinline__ void attend_chunk(
    const float* Qs, const float* Ks, const float* Vs, float* Ps,
    const bool (&vis)[8], float scale, int r, int quad, float& mrow,
    float& lrow, float (&acc)[HD / 4]) {
  constexpr int HDP = HD + 1;
  constexpr int KCP = kKRows + 1;
  float s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float qd = Qs[r * HDP + d];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] += qd * Ks[(quad + 4 * k) * HDP + d];
  }
  float cmax = kNegInf;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s[k] = vis[k] ? s[k] * scale : kNegInf;
    cmax = fmaxf(cmax, s[k]);
  }
  cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
  cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 2));
  const float mn = fmaxf(mrow, cmax);
  const float alpha = expf(mrow - mn);
  float psum = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float p = vis[k] ? expf(s[k] - mn) : 0.f;
    Ps[r * KCP + quad + 4 * k] = p;
    psum += p;
  }
  psum += __shfl_xor_sync(0xffffffffu, psum, 1);
  psum += __shfl_xor_sync(0xffffffffu, psum, 2);
  lrow = lrow * alpha + psum;
  mrow = mn;
  __syncwarp();                           // the row's P is one quad's work
#pragma unroll
  for (int j = 0; j < HD / 4; ++j) acc[j] *= alpha;
#pragma unroll 4
  for (int c = 0; c < kKRows; ++c) {
    const float p = Ps[r * KCP + c];
#pragma unroll
    for (int j = 0; j < HD / 4; ++j) acc[j] += p * Vs[c * HD + quad + 4 * j];
  }
}

// Stages one tile's q rows in Qs (zeros past rows_total): q row gr of the
// (entry, kv head) stack is token gr / g, group head gr % g, at q +
// ((ent * n_tok + token) * n_heads + kvh * g + head) * HD.
template <int HD>
__device__ __forceinline__ void stage_q_tile(const float* __restrict__ q,
                                             float* Qs, int ent, int n_tok,
                                             int n_heads, int kvh, int g,
                                             int r0, int rows_total) {
  constexpr int HDP = HD + 1;
  constexpr int SEGS = HD / 8;
  for (int i = threadIdx.x; i < kQRows * SEGS; i += kThreads) {
    const int rr = i / SEGS;
    const int sg = i - rr * SEGS;
    const int gr = r0 + rr;
    float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (gr < rows_total) {
      const int tok = gr / g;
      const int j = gr - tok * g;
      load8(q + ((static_cast<size_t>(ent) * n_tok + tok) * n_heads +
                 kvh * g + j) * HD + sg * 8, v8);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) Qs[rr * HDP + sg * 8 + e] = v8[e];
  }
}

template <typename PT, int HD>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const float* __restrict__ q, const PT* __restrict__ kp,
                     const PT* __restrict__ vp, const float* __restrict__ ks,
                     const float* __restrict__ vs,
                     const int* __restrict__ table,
                     const int* __restrict__ hit_lens,
                     const float* __restrict__ tk,
                     const float* __restrict__ tv, float* __restrict__ out,
                     int tb, int n_kv, int g, int ps,
                     int hb, float scale) {
  constexpr int HDP = HD + 1;             // padded rows: no bank conflicts
  constexpr int SEGS = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kQRows][HDP]
  float* Ks = Qs + kQRows * HDP;          // [kKRows][HDP]
  float* Vs = Ks + kKRows * HDP;          // [kKRows][HD]
  float* Ps = Vs + kKRows * HD;           // [kQRows][kKRows + 1]

  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int ent = blockIdx.z;
  const int n_heads = n_kv * g;
  const int rows_total = tb * g;
  const int r0 = tile * kQRows;
  const int t = threadIdx.x;
  const int r = t >> 2;
  const int quad = t & 3;
  const int grow = r0 + r;
  const bool row_ok = grow < rows_total;
  const int my_tok = row_ok ? grow / g : tb;
  const int tok_hi = (min(r0 + kQRows, rows_total) - 1) / g;
  const int hit = min(max(hit_lens[ent], 0), hb * ps);

  stage_q_tile<HD>(q, Qs, ent, tb, n_heads, kvh, g, r0, rows_total);

  float mrow = kNegInf, lrow = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int j = 0; j < HD / 4; ++j) acc[j] = 0.f;

  const int n_pre = (hit + kKRows - 1) / kKRows;
  const int tail_len = tok_hi + 1;        // tail cols this tile can see
  const int n_all = n_pre + (tail_len + kKRows - 1) / kKRows;
  const int* trow = table + static_cast<size_t>(ent) * hb;

  for (int ch = 0; ch < n_all; ++ch) {
    const bool prefix = ch < n_pre;
    const int c0 = (prefix ? ch : ch - n_pre) * kKRows;
    const int c_end = prefix ? hit : tail_len;
    __syncthreads();                      // last chunk's readers are done
    for (int i = t; i < kKRows * SEGS; i += kThreads) {
      const int kr = i / SEGS;
      const int sg = i - kr * SEGS;
      const int c = c0 + kr;
      float k8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (c < c_end) {
        if (prefix) {
          load_paged_kv8<PT, HD>(kp, vp, ks, vs, trow, c, ps, n_kv, kvh, sg,
                                 k8, v8);
        } else {
          const size_t row =
              (static_cast<size_t>(ent) * tb + c) * n_kv + kvh;
          load8(tk + row * HD + sg * 8, k8);
          load8(tv + row * HD + sg * 8, v8);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        Ks[kr * HDP + sg * 8 + e] = k8[e];
        Vs[kr * HD + sg * 8 + e] = v8[e];
      }
    }
    __syncthreads();
    bool vis[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + quad + 4 * k;
      vis[k] = c < c_end && (prefix || c <= my_tok);
    }
    attend_chunk<HD>(Qs, Ks, Vs, Ps, vis, scale, r, quad, mrow, lrow, acc);
  }

  if (row_ok) {
    const int j = grow - my_tok * g;
    float* o = out + ((static_cast<size_t>(ent) * tb + my_tok) * n_heads +
                   kvh * g + j) * HD;
    const float den = fmaxf(lrow, 1e-20f);
#pragma unroll
    for (int jj = 0; jj < HD / 4; ++jj) store1(o + quad + 4 * jj, acc[jj] / den);
  }
}

// -- K3: multi-query verify ---------------------------------------------------
//
// grid (n_splits, B * Hkv, ceil(t*g / 32)), cluster (n_splits, 1, 1), 128
// threads, thread layout as K2. q row r of the (slot, kv head) stack is
// window token r / g, group head r % g, and attends cols < len + r / g +
// 1, len the slot's committed rows (clamped to the table: an inactive
// slot's stale length may sit at capacity). Split s covers logical pages
// [s*pps, (s+1)*pps) of the slot's live pages ceil((len + t) / ps), as
// K1's splits do, and its unnormalised (acc, m, l) rows merge across the
// cluster; an empty split's (0, -1e30, 0) drops out.
template <typename PT, int HD>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const float* __restrict__ q, const PT* __restrict__ kp,
                    const PT* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int t, int n_kv, int g, int ps, int n_blocks,
                    float scale) {
  constexpr int HDP = HD + 1;
  constexpr int SEGS = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kQRows][HDP]
  float* Ks = Qs + kQRows * HDP;          // [kKRows][HDP]
  float* Vs = Ks + kKRows * HDP;          // [kKRows][HD]
  float* Ps = Vs + kKRows * HD;           // [kQRows][kKRows + 1]

  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int bh = blockIdx.y;
  const int tile = blockIdx.z;
  const int b = bh / n_kv;
  const int kvh = bh - b * n_kv;
  const int rows_total = t * g;
  const int r0 = tile * kQRows;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int quad = tid & 3;
  const int grow = r0 + r;
  const bool row_ok = grow < rows_total;
  const bool warp_live = r0 + (tid >> 5) * 8 < rows_total;
  const int tok_hi = (min(r0 + kQRows, rows_total) - 1) / g;
  const int my_tok = row_ok ? grow / g : tok_hi;

  const int cap = n_blocks * ps;
  const int len = min(max(lengths[b], 0), cap);
  const int pages_live = min((len + t + ps - 1) / ps, n_blocks);
  const int pps = (pages_live + n_splits - 1) / n_splits;
  const int p0 = split * pps;
  const int p1 = min(p0 + pps, pages_live);
  const int c_lo = p0 * ps;
  // The tile's furthest visible column + 1, and this row's.
  const int c_hi = min(min(p1 * ps, len + tok_hi + 1), cap);
  const int my_hi = min(len + my_tok + 1, c_hi);

  stage_q_tile<HD>(q, Qs, b, t, n_kv * g, kvh, g, r0, rows_total);

  float mrow = kNegInf, lrow = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int j = 0; j < HD / 4; ++j) acc[j] = 0.f;

  const int* trow = table + static_cast<size_t>(b) * n_blocks;
  for (int c0 = c_lo; c0 < c_hi; c0 += kKRows) {
    __syncthreads();                      // last chunk's readers are done
    for (int i = tid; i < kKRows * SEGS; i += kThreads) {
      const int kr = i / SEGS;
      const int sg = i - kr * SEGS;
      const int c = c0 + kr;
      float k8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (c < c_hi)
        load_paged_kv8<PT, HD>(kp, vp, ks, vs, trow, c, ps, n_kv, kvh, sg,
                               k8, v8);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        Ks[kr * HDP + sg * 8 + e] = k8[e];
        Vs[kr * HD + sg * 8 + e] = v8[e];
      }
    }
    __syncthreads();
    if (warp_live) {                      // warp-uniform: shuffles are safe
      bool vis[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) vis[k] = c0 + quad + 4 * k < my_hi;
      attend_chunk<HD>(Qs, Ks, Vs, Ps, vis, scale, r, quad, mrow, lrow, acc);
    }
  }

  // The tile's rows, unnormalised, into the free K/V tiles; then the
  // splits merge across the cluster.
  __syncthreads();
  constexpr int ALD = HD + 4;
  float* Racc = Ks;                       // [kQRows][ALD]
  float* Rm = Ps;                         // [kQRows]
  float* Rl = Ps + kQRows;                // [kQRows]
#pragma unroll
  for (int jj = 0; jj < HD / 4; ++jj) Racc[r * ALD + quad + 4 * jj] = acc[jj];
  if (quad == 0) {
    Rm[r] = mrow;
    Rl[r] = lrow;
  }
  cluster_merge_rows<HD, false, float>(
      min(kQRows, rows_total - r0), Rm, Rl,
      [&](int rr) { return Racc + rr * ALD; },
      [&](int rr) {
        const int tok = (r0 + rr) / g;
        return out + ((static_cast<size_t>(b) * t + tok) * (n_kv * g) +
                      kvh * g + (r0 + rr - tok * g)) * HD;
      });
}

// -- host-side dispatch -------------------------------------------------------

inline float softmax_scale(int hd) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
}

template <typename KT, int HD>
cudaError_t launch_decode(int g, const void* q, const void* k, const void* v,
                          const void* ks, const void* vs, const void* table,
                          const void* lengths, void* out, int B, int Hkv,
                          int ps, int n_blocks, int n_splits,
                          cudaStream_t stream) {
  if (n_splits < 1 || n_splits > kMaxSplits) return cudaErrorInvalidValue;
  const dim3 grid(n_splits, B * Hkv);
#define K1_LAUNCH(GV)                                                       \
  {                                                                         \
    static bool fits = false;                                               \
    const cudaError_t err = check_cluster_fits(                             \
        paged_decode_kernel<KT, HD, GV>, kThreads, 0, fits);                \
    if (err != cudaSuccess) return err;                                     \
    return launch_cluster(                                                  \
        paged_decode_kernel<KT, HD, GV>, grid, kThreads, 0, stream,         \
        static_cast<const float*>(q), static_cast<const KT*>(k),            \
        static_cast<const KT*>(v), static_cast<const float*>(ks),           \
        static_cast<const float*>(vs), static_cast<const int*>(table),      \
        static_cast<const int*>(lengths), static_cast<float*>(out), Hkv,    \
        ps, n_blocks, softmax_scale(HD));                                   \
  }
  switch (g) {
    case 1: K1_LAUNCH(1)
    case 2: K1_LAUNCH(2)
    case 4: K1_LAUNCH(4)
    case 8: K1_LAUNCH(8)
    default: return cudaErrorInvalidValue;
  }
#undef K1_LAUNCH
}

// f32 q only: bf16 q goes to the tensor-core kernel (paged_prefill_mma.cu).
template <typename PT, int HD>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* table,
                           const void* hits, const void* tk, const void* tv,
                           void* out, int M, int tb, int H, int Hkv, int ps,
                           int hb, cudaStream_t stream) {
  const int g = H / Hkv;
  const dim3 grid((tb * g + kQRows - 1) / kQRows, Hkv, M);
  const size_t smem = sizeof(float) * prefill_smem_floats<HD>();
  static bool configured = false;         // once per instantiation
  if (!configured) {
    note_first_use();
    const cudaError_t err = cudaFuncSetAttribute(
        paged_prefill_kernel<PT, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  paged_prefill_kernel<PT, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const PT*>(k),
      static_cast<const PT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(hits), static_cast<const float*>(tk),
      static_cast<const float*>(tv), static_cast<float*>(out), tb, Hkv, g, ps,
      hb, softmax_scale(HD));
  return cudaGetLastError();
}

// f32 q only: bf16 q goes to the tensor-core kernel (decode_mma.cu).
template <typename PT, int HD>
cudaError_t launch_verify(const void* q, const void* k, const void* v,
                          const void* ks, const void* vs, const void* table,
                          const void* lengths, void* out, int B, int t, int H,
                          int Hkv, int ps, int n_blocks, int n_splits,
                          cudaStream_t stream) {
  const int g = H / Hkv;
  if (n_splits < 1 || n_splits > kMaxSplits) return cudaErrorInvalidValue;
  const dim3 grid(n_splits, B * Hkv, (t * g + kQRows - 1) / kQRows);
  const size_t smem = sizeof(float) * prefill_smem_floats<HD>();
  static bool configured = false, fits = false;  // once per instantiation
  cudaError_t err = allow_smem(paged_verify_kernel<PT, HD>, smem, configured);
  if (err == cudaSuccess)
    err = check_cluster_fits(paged_verify_kernel<PT, HD>, kThreads, smem,
                             fits);
  if (err != cudaSuccess) return err;
  return launch_cluster(
      paged_verify_kernel<PT, HD>, grid, kThreads, smem, stream,
      static_cast<const float*>(q), static_cast<const PT*>(k),
      static_cast<const PT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(out), t, Hkv, g,
      ps, n_blocks, softmax_scale(HD));
}

}  // namespace

extern "C" {

// q [B, H, hd]; k/v [n_pages, ps, Hkv, hd]; ks/vs [n_pages, ps, Hkv, 1]
// f32 (int8 pools only, else null); table [B, n_blocks] i32; lengths [B]
// i32 -> out [B, H, hd] in q's dtype; n_splits in 1 .. kMaxSplits, each a
// block of one cluster. bf16 q goes to the tensor-core kernel
// (decode_mma.cu), f32 q to the CUDA-core one.
int paged_decode_attention_launch(const void* q, const void* k, const void* v,
                                  const void* ks, const void* vs,
                                  const void* table, const void* lengths,
                                  void* out, int B, int H, int Hkv, int hd,
                                  int ps, int n_blocks, int n_splits,
                                  int q_bf16, int kv_int8, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return port_kernels::paged_window_bf16(q, k, v, ks, vs, table, lengths,
                                           out, B, 1, H, Hkv, hd, ps,
                                           n_blocks, n_splits, 0, kv_int8,
                                           softmax_scale(hd), st);
#define K1_ARGS H / Hkv, q, k, v, ks, vs, table, lengths, out, B, Hkv, ps, \
                n_blocks, n_splits, st
  if (hd == 64)
    return kv_int8 ? launch_decode<int8_t, 64>(K1_ARGS)
                   : launch_decode<float, 64>(K1_ARGS);
  if (hd == 128)
    return kv_int8 ? launch_decode<int8_t, 128>(K1_ARGS)
                   : launch_decode<float, 128>(K1_ARGS);
#undef K1_ARGS
  return cudaErrorInvalidValue;
}

// q [M, tb, H, hd]; k/v/ks/vs as above; table [M, hb] i32; hits [M] i32;
// tail k/v [M, tb, Hkv, hd] in q's dtype -> out [M, tb, H, hd]. bf16 q
// goes to the tensor-core kernel (paged_prefill_mma.cu), f32 q to the
// CUDA-core one.
int paged_prefill_attention_launch(const void* q, const void* k, const void* v,
                                   const void* ks, const void* vs,
                                   const void* table, const void* hits,
                                   const void* tk, const void* tv, void* out,
                                   int M, int tb, int H, int Hkv, int hd,
                                   int ps, int hb, int q_bf16, int kv_int8,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return port_kernels::paged_prefill_bf16(q, k, v, ks, vs, table, hits, tk,
                                            tv, out, M, tb, H, Hkv, hd, ps,
                                            hb, kv_int8, softmax_scale(hd),
                                            st);
#define K2_ARGS q, k, v, ks, vs, table, hits, tk, tv, out, M, tb, H, Hkv, ps, \
                hb, st
  if (hd == 64)
    return kv_int8 ? launch_prefill<int8_t, 64>(K2_ARGS)
                   : launch_prefill<float, 64>(K2_ARGS);
  if (hd == 128)
    return kv_int8 ? launch_prefill<int8_t, 128>(K2_ARGS)
                   : launch_prefill<float, 128>(K2_ARGS);
#undef K2_ARGS
  return cudaErrorInvalidValue;
}

// q [B, t, H, hd]; k/v/ks/vs as above; table [B, n_blocks] i32; lengths
// [B] i32 (committed rows before the window) -> out [B, t, H, hd] in q's
// dtype; n_splits as K1's. bf16 q goes to the tensor-core kernel
// (decode_mma.cu), f32 q to the CUDA-core one.
int paged_verify_attention_launch(const void* q, const void* k, const void* v,
                                  const void* ks, const void* vs,
                                  const void* table, const void* lengths,
                                  void* out, int B, int t, int H, int Hkv,
                                  int hd, int ps, int n_blocks, int n_splits,
                                  int q_bf16, int kv_int8, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return port_kernels::paged_window_bf16(q, k, v, ks, vs, table, lengths,
                                           out, B, t, H, Hkv, hd, ps,
                                           n_blocks, n_splits, 1, kv_int8,
                                           softmax_scale(hd), st);
#define K3_ARGS q, k, v, ks, vs, table, lengths, out, B, t, H, Hkv, ps, \
                n_blocks, n_splits, st
  if (hd == 64)
    return kv_int8 ? launch_verify<int8_t, 64>(K3_ARGS)
                   : launch_verify<float, 64>(K3_ARGS);
  if (hd == 128)
    return kv_int8 ? launch_verify<int8_t, 128>(K3_ARGS)
                   : launch_verify<float, 128>(K3_ARGS);
#undef K3_ARGS
  return cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// First-use configurations run so far (note_first_use), library-wide.
int port_first_use_configs(void) {
  return port_kernels::g_first_use.load(std::memory_order_relaxed);
}

// The dynamic shared memory the f32 launchers request: kernel 1 (K1, none:
// its merge arrays are static), 2 (K2) or 3 (K3); -1 for a head dim that is
// not instantiated. Read-only: the smem audit (analysis/smem.py) holds its
// mirror to it.
long long paged_attention_smem_bytes(int kernel, int kv_int8, int hd) {
  (void)kv_int8;                        // the f32 tiles hold no pool rows
  if (hd != 64 && hd != 128) return -1;
  if (kernel == 1) return 0;
  if (kernel != 2 && kernel != 3) return -1;
  return static_cast<long long>(sizeof(float)) *
         (hd == 64 ? prefill_smem_floats<64>() : prefill_smem_floats<128>());
}

}  // extern "C"
