// Flash attention backward in bf16 on Hopper's tensor cores (sm_90a).
//
// K6 flash_bwd_dq_mma_kernel replaces the dq kernel of
//    k8s_gpu_scheduler_tpu/ops/flash_attention.py _flash_backward
//    (_flash_bwd_dq_kernel): dq_i = scale * sum_j ds_ij k_j with
//    ds_ij = p_ij (do_i . v_j - D_i), p = exp(s - lse), and D_i = do_i . o_i
//    computed here and written out for K7.
// K7 flash_bwd_dkv_mma_kernel replaces the dk/dv kernel of _flash_backward
//    (_flash_bwd_dkv_kernel): dv_j = sum_i p_ij do_i and dk_j = scale *
//    sum_i ds_ij q_i, summed over the g query heads of a kv head inside the
//    block (the JAX package repeated K/V per head and summed outside).
// flash_attention.cu sends bf16 inputs here; f32 inputs keep its CUDA-core
// kernels (see there).
//
// What bounds them: operations. At train-8b (B 8, T 2048, H 32, Hkv 8, hd
// 128, causal) K6 does 3 products and K7 4 over the 2.1 million visible
// (q, k) pairs of each head, 2 hd FLOPs a pair and product: 412.5 and 550
// GFLOP against some 100 MB of inputs and outputs, thousands of FLOPs a
// byte.
// So every product runs on the tensor cores, with f32 sums:
//
// - Operands stay bf16 in shared memory, rows padded by 16 bytes so the
//   eight rows an ldmatrix phase reads fall in distinct banks. Tiles are
//   staged by cp.async 16-byte copies into a two-stage ring (K6: the K/V
//   tiles; K7: the Q/dO tiles with their lse/D rows), so the next tile's
//   copy is in flight during the current tile's products. Rows past T are
//   zero-filled by the copy itself.
// - Each of the 4 warps owns 16 rows of the block's tile, the M of one
//   mma.sync m16n8k16: K6 computes S = Q K^T and dP = dO V^T with its q
//   rows as M, K7 computes S^T = K Q^T and dP^T = V dO^T with its k rows as
//   M. Fragments come from ldmatrix; operands used transposed (K in
//   dq = dS K, Q and dO in K7's dk, dv) from ldmatrix.trans.
// - P = exp(S scale - lse) and dS = P (dP - D) are computed in f32 from the
//   accumulators. Masked entries (above the diagonal, past T) are exactly
//   0: their scores are set to -inf first, only in the tiles on the
//   diagonal or at T's edge (the other tiles skip the mask). Then P and dS
//   are rounded once to bf16 and fed, still in registers, as the A
//   fragments of the second products: dq += dS K (K6), dv += P^T dO and
//   dk += dS^T Q (K7). That rounding is the only change to the numerics
//   against the f32 kernels; every sum stays f32.
// - Work split: K6 one block per (head, batch, 64-row q tile) looping over
//   32-row k tiles up to the diagonal; K7 one block per (kv head, batch,
//   64-row k tile) looping over the g query heads and their q tiles from
//   the diagonal on (64 rows at hd 128, 32 at hd 64). dk and dv stay in
//   registers as f32 accumulators beside the score tiles. A warp of K7
//   whose 16 keys all lie after a q tile skips its products. The tile
//   index is the grid's slowest dimension, heaviest first (K6's last q
//   tiles, K7's first k tiles), so the long blocks start early.
// - Tile sizes are those that timed fastest among the variants tried on
//   the H100 (4 or 8 warps; 16, 32 or 64 k rows in K6; 16 to 64 q rows in
//   K7): K6's 32-row k tiles fit three blocks an SM (168 registers, 70 KB
//   at hd 128); K7 at hd 128 takes 254 registers without spilling, two
//   blocks an SM.
// - Each output element is summed by one thread in a fixed order, with no
//   atomics: both kernels are deterministic.
//
// Build: ops/_build.py compiles this file beside the other sources into one
// library; the launch functions return cudaGetLastError().

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace port_kernels {
namespace {

// Each warp owns 16 rows of its block's tile (the M of one mma).
constexpr int kDqWarps = 4;              // K6: 64 q rows a block
constexpr int kDqThreads = 32 * kDqWarps;
constexpr int kDqQ = 16 * kDqWarps;
constexpr int kDqK = 32;                 // K6: k rows per step
constexpr int kDkvWarps = 4;             // K7: 64 k rows a block
constexpr int kDkvThreads = 32 * kDkvWarps;
constexpr int kDkvK = 16 * kDkvWarps;

// K7: q rows per step.
template <int HD>
__host__ __device__ constexpr int dkv_q() {
  return HD == 128 ? 64 : 32;
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (2 * kDqQ + 4 * kDqK) * ld(HD) +
         sizeof(float) * 2 * kDqQ;
}
template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * (2 * kDkvK + 4 * dkv_q<HD>()) * ld(HD) +
         sizeof(float) * 4 * dkv_q<HD>();
}

// Entries row0 .. row0+ROWS-1 of an f32 row into dst, zeros past n_rows.
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage_floats(const float* __restrict__ src,
                                             int row0, int n_rows,
                                             float* dst) {
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    const bool ok = row0 + r < n_rows;
    cp_async4(dst + r, src + (ok ? row0 + r : 0), ok);
  }
}

__device__ __forceinline__ bool visible(int row, int col, int n, int causal) {
  return col < n && row < n && (!causal || col <= row);
}

// -- K6: dq -----------------------------------------------------------------
//
// grid (H, B, ceil(T / kDqQ)), kDqThreads threads; block z takes q tile
// gridDim.z - 1 - z. Warp w owns q rows 16w .. 16w+15 of the tile; the
// thread's rows are 16w + lane/4 and that + 8.
template <int HD>
__global__ void __launch_bounds__(kDqThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ out,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse, bf16* __restrict__ dq,
                        float* __restrict__ delta, int n, int n_heads,
                        int n_kv, int causal, float scale) {
  constexpr int LD = ld(HD);
  constexpr int NK = kDqK / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);           // [kDqQ][LD]
  bf16* dOs = Qs + kDqQ * LD;                             // [kDqQ][LD]
  bf16* Ks = dOs + kDqQ * LD;                             // [2][kDqK][LD]
  bf16* Vs = Ks + 2 * kDqK * LD;                          // [2][kDqK][LD]
  float* Ls = reinterpret_cast<float*>(Vs + 2 * kDqK * LD);  // [kDqQ]
  float* Ds = Ls + kDqQ;                                  // [kDqQ]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kDqQ;
  const int kvh = h / (n_heads / n_kv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const size_t q_stride = static_cast<size_t>(n_heads) * HD;
  const size_t kv_stride = static_cast<size_t>(n_kv) * HD;
  const size_t q_off = (static_cast<size_t>(b) * n * n_heads + h) * HD;
  const bf16* kb = k + (static_cast<size_t>(b) * n * n_kv + kvh) * HD;
  const bf16* vb = v + (static_cast<size_t>(b) * n * n_kv + kvh) * HD;
  const size_t bh = static_cast<size_t>(b) * n_heads + h;
  const int k_end = causal ? min(n, q0 + kDqQ) : n;
  const int n_tiles = (k_end + kDqK - 1) / kDqK;

  stage_async<kDqQ, HD, kDqThreads>(q + q_off, q_stride, q0, n, Qs);
  stage_async<kDqQ, HD, kDqThreads>(dout + q_off, q_stride, q0, n, dOs);
  stage_async<kDqK, HD, kDqThreads>(kb, kv_stride, 0, n, Ks);
  stage_async<kDqK, HD, kDqThreads>(vb, kv_stride, 0, n, Vs);
  cp_async_commit();

  // D_i = do_i . o_i in f32 from device memory while the copies fly, 8
  // lanes a row; written to delta for K7.
  {
    const int tx = threadIdx.x & 7;
    for (int r = threadIdx.x / 8; r < kDqQ; r += kDqThreads / 8) {
      const bool ok = q0 + r < n;
      float part = 0.f;
      if (ok) {
        const size_t at = q_off + static_cast<size_t>(q0 + r) * q_stride;
#pragma unroll
        for (int c = 8 * tx; c < HD; c += 64) {
          float a[8], o[8];
          load8(dout + at + c, a);
          load8(out + at + c, o);
#pragma unroll
          for (int e = 0; e < 8; ++e) part += a[e] * o[e];
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      if (tx == 0) {
        Ds[r] = part;
        Ls[r] = ok ? lse[bh * n + q0 + r] : 0.f;
        if (ok) delta[bh * n + q0 + r] = part;
      }
    }
  }
  __syncthreads();
  const int r0 = 16 * warp + (lane >> 2);   // the thread's rows r0, r0 + 8
  const int qw0 = q0 + 16 * warp;            // the warp's first row
  const int rows[2] = {q0 + r0, q0 + r0 + 8};
  const float L[2] = {Ls[r0], Ls[r0 + 8]};
  const float D[2] = {Ds[r0], Ds[r0 + 8]};
  const bf16* Qw = Qs + 16 * warp * LD;
  const bf16* dOw = dOs + 16 * warp * LD;

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    __syncthreads();                      // the stage refilled next is read
    if (it + 1 < n_tiles) {
      const int s = (it + 1) & 1;
      stage_async<kDqK, HD, kDqThreads>(kb, kv_stride, (it + 1) * kDqK, n,
                                        Ks + s * kDqK * LD);
      stage_async<kDqK, HD, kDqThreads>(vb, kv_stride, (it + 1) * kDqK, n,
                                        Vs + s * kDqK * LD);
    }
    cp_async_commit();
    cp_async_wait<1>();                   // tile it has landed
    __syncthreads();
    const bf16* Kt = Ks + (it & 1) * kDqK * LD;
    const bf16* Vt = Vs + (it & 1) * kDqK * LD;
    float s[NK][4], dp[NK][4];
    warp_abt<HD, kDqK>(Qw, Kt, lane, s);
    warp_abt<HD, kDqK>(dOw, Vt, lane, dp);
    // Only tiles on the diagonal or at T's edge have masked entries: their
    // scores become -inf, so that p below is exactly 0.
    const int last_key = (it + 1) * kDqK - 1;
    if (last_key >= n || qw0 + 15 >= n || (causal && last_key > qw0)) {
      const int col0 = it * kDqK + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(rows[e >> 1], col0 + 8 * j + (e & 1), n, causal))
            s[j][e] = -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] * scale - L[e >> 1]);
        s[j][e] = p * (dp[j][e] - D[e >> 1]);                 // dS
      }
    uint32_t ds[kDqK / 16][4];
    to_a_frags<kDqK>(s, ds);
    warp_pv<HD, kDqK>(ds, Kt, lane, acc);
  }

  store_tile<HD>(dq + static_cast<size_t>(b) * n * q_stride + h * HD,
                 q_stride, rows, n, lane, acc, scale);
}

// -- K7: dk and dv ------------------------------------------------------------
//
// grid (Hkv, B, ceil(T / kDkvK)), kDkvThreads threads. Warp w owns k
// rows 16w .. 16w+15 of the block's tile; the thread's rows are 16w +
// lane/4 and that + 8. Step `it` takes query head kvh*g + it / per_head
// and its q tile it % per_head (from the diagonal on when causal).
template <int HD>
__global__ void __launch_bounds__(kDkvThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n,
                         int n_heads, int n_kv, int causal, float scale) {
  constexpr int LD = ld(HD);
  constexpr int BQ = dkv_q<HD>();
  constexpr int NQ = BQ / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_u4);           // [kDkvK][LD]
  bf16* Vs = Ks + kDkvK * LD;                             // [kDkvK][LD]
  bf16* Qs = Vs + kDkvK * LD;                             // [2][BQ][LD]
  bf16* dOs = Qs + 2 * BQ * LD;                           // [2][BQ][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // [2][BQ]
  float* Ds = Ls + 2 * BQ;                                // [2][BQ]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kDkvK;
  const int g = n_heads / n_kv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const size_t q_stride = static_cast<size_t>(n_heads) * HD;
  const size_t kv_stride = static_cast<size_t>(n_kv) * HD;
  const size_t kv_off = (static_cast<size_t>(b) * n * n_kv + kvh) * HD;
  const int q_start = causal ? (k0 / BQ) * BQ : 0;
  const int per_head = (n - q_start + BQ - 1) / BQ;
  const int n_steps = g * per_head;

  auto stage = [&](int it, int s) {
    const int h = kvh * g + it / per_head;
    const int q0 = q_start + (it % per_head) * BQ;
    const size_t q_off = (static_cast<size_t>(b) * n * n_heads + h) * HD;
    const size_t bh = static_cast<size_t>(b) * n_heads + h;
    stage_async<BQ, HD, kDkvThreads>(q + q_off, q_stride, q0, n,
                                     Qs + s * BQ * LD);
    stage_async<BQ, HD, kDkvThreads>(dout + q_off, q_stride, q0, n,
                                     dOs + s * BQ * LD);
    stage_floats<BQ, kDkvThreads>(lse + bh * n, q0, n, Ls + s * BQ);
    stage_floats<BQ, kDkvThreads>(delta + bh * n, q0, n, Ds + s * BQ);
  };
  stage_async<kDkvK, HD, kDkvThreads>(k + kv_off, kv_stride, k0, n, Ks);
  stage_async<kDkvK, HD, kDkvThreads>(v + kv_off, kv_stride, k0, n, Vs);
  stage(0, 0);
  cp_async_commit();

  const int kw0 = k0 + 16 * warp;         // the warp's first key
  const int rows[2] = {kw0 + (lane >> 2), kw0 + (lane >> 2) + 8};
  const bf16* Kw = Ks + 16 * warp * LD;
  const bf16* Vw = Vs + 16 * warp * LD;
  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int it = 0; it < n_steps; ++it) {
    __syncthreads();                      // the stage refilled next is read
    if (it + 1 < n_steps) stage(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();                   // step it's tiles have landed
    __syncthreads();
    const int q0 = q_start + (it % per_head) * BQ;
    // Keys past T, or (causal) all after the tile's last query: nothing.
    if (kw0 >= n || (causal && q0 + BQ - 1 < kw0)) continue;
    const int buf = it & 1;
    const bf16* Qt = Qs + buf * BQ * LD;
    const bf16* dOt = dOs + buf * BQ * LD;
    const float* Lt = Ls + buf * BQ;
    const float* Dt = Ds + buf * BQ;
    float s[NQ][4], dp[NQ][4];
    warp_abt<HD, BQ>(Kw, Qt, lane, s);    // S^T: keys x queries
    warp_abt<HD, BQ>(Vw, dOt, lane, dp);  // dP^T
    // Only tiles on the diagonal or at T's edge have masked entries: their
    // scores become -inf, so that p below is exactly 0.
    if (kw0 + 15 >= n || q0 + BQ - 1 >= n || (causal && kw0 + 15 > q0)) {
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(q0 + 8 * j + 2 * (lane & 3) + (e & 1), rows[e >> 1], n,
                       causal))
            s[j][e] = -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(Lt + c);
      const float2 d2 = *reinterpret_cast<const float2*>(Dt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] * scale - ((e & 1) ? l2.y : l2.x));
        dp[j][e] = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));  // dS^T
        s[j][e] = p;                                          // P^T
      }
    }
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    to_a_frags<BQ>(s, pa);
    to_a_frags<BQ>(dp, dsa);
    warp_pv<HD, BQ>(pa, dOt, lane, dv_acc);
    warp_pv<HD, BQ>(dsa, Qt, lane, dk_acc);
  }

  const size_t o = static_cast<size_t>(b) * n * kv_stride + kvh * HD;
  store_tile<HD>(dk + o, kv_stride, rows, n, lane, dk_acc, scale);
  store_tile<HD>(dv + o, kv_stride, rows, n, lane, dv_acc, 1.f);
}

template <int HD>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* out, const void* dout, const void* lse,
                          void* dq, void* delta, int B, int n, int H, int Hkv,
                          int causal, float scale, cudaStream_t stream) {
  const dim3 grid(H, B, (n + kDqQ - 1) / kDqQ);
  const size_t smem = dq_smem_bytes<HD>();
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_bwd_dq_mma_kernel<HD>, smem, configured);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma_kernel<HD><<<grid, kDqThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<bf16*>(dq), static_cast<float*>(delta), n, H, Hkv, causal,
      scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int B, int n,
                           int H, int Hkv, int causal, float scale,
                           cudaStream_t stream) {
  const dim3 grid(Hkv, B, (n + kDkvK - 1) / kDkvK);
  const size_t smem = dkv_smem_bytes<HD>();
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_bwd_dkv_mma_kernel<HD>, smem, configured);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_mma_kernel<HD><<<grid, kDkvThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, H, Hkv, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// K6 and K7 for bf16 inputs, called from flash_attention.cu's launchers;
// head dims other than 64 and 128 are refused.
cudaError_t flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, void* dq, void* delta, int B,
                              int n, int H, int Hkv, int hd, int causal,
                              float scale, cudaStream_t stream) {
  if (hd == 64)
    return launch_dq_mma<64>(q, k, v, out, dout, lse, dq, delta, B, n, H, Hkv,
                             causal, scale, stream);
  if (hd == 128)
    return launch_dq_mma<128>(q, k, v, out, dout, lse, dq, delta, B, n, H,
                              Hkv, causal, scale, stream);
  return cudaErrorInvalidValue;
}

cudaError_t flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv, int B,
                               int n, int H, int Hkv, int hd, int causal,
                               float scale, cudaStream_t stream) {
  if (hd == 64)
    return launch_dkv_mma<64>(q, k, v, dout, lse, delta, dk, dv, B, n, H, Hkv,
                              causal, scale, stream);
  if (hd == 128)
    return launch_dkv_mma<128>(q, k, v, dout, lse, delta, dk, dv, B, n, H,
                               Hkv, causal, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace port_kernels

// The dynamic shared memory launch_dq_mma (kernel 6) or launch_dkv_mma
// (kernel 7) requests; -1 for a head dim that is not instantiated.
// Read-only: the smem audit (analysis/smem.py) holds its mirror to it.
extern "C" long long flash_backward_mma_smem_bytes(int kernel, int hd) {
  using namespace port_kernels;
  if (hd != 64 && hd != 128) return -1;
  if (kernel == 6)
    return hd == 64 ? dq_smem_bytes<64>() : dq_smem_bytes<128>();
  if (kernel == 7)
    return hd == 64 ? dkv_smem_bytes<64>() : dkv_smem_bytes<128>();
  return -1;
}
