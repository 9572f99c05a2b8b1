// Flash attention forward in bf16 on Hopper's tensor cores (sm_90a).
//
// K5 flash_fwd_mma_kernel replaces the Pallas kernel behind
//    k8s_gpu_scheduler_tpu/ops/flash_attention.py _flash_forward
//    (_flash_fwd_kernel): causal or full O = softmax(Q K^T / sqrt(d)) V with
//    GQA (query head h reads kv head h / g), writing out [B, T, H, hd] in
//    q's dtype and, in training, lse [B*H, T] f32.
// flash_attention.cu sends bf16 inputs here; f32 inputs keep its CUDA-core
// kernel flash_fwd_kernel (see there).
//
// What bounds it: operations. At train-8b (B 8, T 2048, H 32, Hkv 8, hd
// 128, causal) it does two products over the 537 million visible (q, k)
// pairs, 2 hd FLOPs a pair and product: 275 GFLOP against some 100 MB of
// inputs and outputs, thousands of FLOPs a byte. So both products run on
// the tensor cores (mma.sync m16n8k16, bf16 operands, f32 sums), with the
// warp tiles of mma.cuh that K6 and K7 use:
//
// - One block per (head, batch, 128-row q tile), the tile index the grid's
//   slowest dimension and the heaviest (last) q tiles first; 4 warps, each
//   owning 32 q rows: two tiles of 16, the M of one mma, so every K and V
//   fragment a warp loads by ldmatrix feeds two mma (warp_abt_rows,
//   warp_pv_rows): half the shared-memory ldmatrix traffic per mma of one
//   tile a warp, which timed slower on the H100.
// - The Q tile is staged once by cp.async; K/V tiles of fwd_k rows (32 at
//   hd 128, 64 at hd 64: the faster of 32 and 64 that does not spill) pass
//   through a two-stage cp.async ring, so the next tile's copy is in flight
//   during the current tile's products. Rows are padded by 16 bytes
//   (ldmatrix phases hit distinct banks); rows past T are zero-filled by
//   the copy and never stored.
// - S = Q K^T lands in registers (warp_abt). The online softmax runs there:
//   each thread holds rows lane/4 and lane/4 + 8, a row's maximum and sum
//   are two shuffles over its quad, the f32 p goes into the row sum before
//   any rounding (so lse = m + log l comes from f32 p and meets the f32
//   tolerance), and the mask (-inf, so p is exactly 0) is applied only on
//   the diagonal tile and at T's edge. A warp whose rows all lie before a
//   k tile (causal) skips it.
// - P is rounded once to bf16 and fed from registers as the A fragments of
//   O += P V (to_a_frags, warp_pv with V through ldmatrix.trans). That
//   rounding is the only change to the numerics against the f32 kernel;
//   every sum stays f32.
// - O is divided by l and stored (store_tile); lse is written once per row.
// - Every output element is summed by one thread in a fixed order, with no
//   atomics: the kernel is deterministic, so a remat recompute reproduces
//   the forward bit for bit.
//
// Build: ops/_build.py compiles this file beside the other sources into one
// library; the launch function returns cudaGetLastError().

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace port_kernels {
namespace {

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdTiles = 2;              // 16-row tiles a warp
constexpr int kFwdQ = 16 * kFwdTiles * kFwdWarps;   // 128 q rows a block

// K/V rows per step: the faster of 32 and 64 on the H100 that does not
// spill (64 spills 56 B at hd 128).
template <int HD>
__host__ __device__ constexpr int fwd_k() {
  return HD == 128 ? 32 : 64;
}

template <int HD>
constexpr size_t fwd_smem_bytes() {
  return sizeof(bf16) * (kFwdQ + 4 * fwd_k<HD>()) * ld(HD);
}

// grid (H, B, ceil(T / kFwdQ)), kFwdThreads threads; block z takes q tile
// gridDim.z - 1 - z. Warp w owns q rows 32w .. 32w+31 of the tile, as tile
// t of 16 rows from 32w + 16t.
template <int HD>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int n, int n_heads, int n_kv,
                     int causal, float scale_log2) {
  constexpr int LD = ld(HD);
  constexpr int KT = fwd_k<HD>();
  constexpr int NK = KT / 8;
  constexpr int MT = kFwdTiles;
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);           // [kFwdQ][LD]
  bf16* Ks = Qs + kFwdQ * LD;                             // [2][KT][LD]
  bf16* Vs = Ks + 2 * KT * LD;                            // [2][KT][LD]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kFwdQ;
  const int kvh = h / (n_heads / n_kv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const size_t q_stride = static_cast<size_t>(n_heads) * HD;
  const size_t kv_stride = static_cast<size_t>(n_kv) * HD;
  const size_t q_off = static_cast<size_t>(b) * n * q_stride + h * HD;
  const bf16* kb = k + (static_cast<size_t>(b) * n * n_kv + kvh) * HD;
  const bf16* vb = v + (static_cast<size_t>(b) * n * n_kv + kvh) * HD;
  const int k_end = causal ? min(n, q0 + kFwdQ) : n;
  const int n_tiles = (k_end + KT - 1) / KT;

  stage_async<kFwdQ, HD, kFwdThreads>(q + q_off, q_stride, q0, n, Qs);
  stage_async<KT, HD, kFwdThreads>(kb, kv_stride, 0, n, Ks);
  stage_async<KT, HD, kFwdThreads>(vb, kv_stride, 0, n, Vs);
  cp_async_commit();

  const int qw0 = q0 + 16 * MT * warp;      // the warp's first row
  const int qw_last = qw0 + 16 * MT - 1;
  int rows[MT][2];
  float m[MT][2], l[MT][2], acc[MT][HD / 8][4];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    rows[t][0] = qw0 + 16 * t + (lane >> 2);
    rows[t][1] = rows[t][0] + 8;
    m[t][0] = m[t][1] = -INFINITY;
    l[t][0] = l[t][1] = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
  }
  const bf16* Qw = Qs + 16 * MT * warp * LD;

  for (int it = 0; it < n_tiles; ++it) {
    __syncthreads();                      // the stage refilled next is read
    if (it + 1 < n_tiles) {
      const int s = (it + 1) & 1;
      stage_async<KT, HD, kFwdThreads>(kb, kv_stride, (it + 1) * KT, n,
                                       Ks + s * KT * LD);
      stage_async<KT, HD, kFwdThreads>(vb, kv_stride, (it + 1) * KT, n,
                                       Vs + s * KT * LD);
    }
    cp_async_commit();
    cp_async_wait<1>();                   // tile it (and Q) have landed
    __syncthreads();
    const int k0 = it * KT;
    // Rows past T, or (causal) all before the tile's first key: nothing.
    if (qw0 >= n || (causal && k0 > qw_last)) continue;
    const bf16* Kt = Ks + (it & 1) * KT * LD;
    const bf16* Vt = Vs + (it & 1) * KT * LD;
    float s[MT][NK][4];
    warp_abt_rows<HD, KT, MT>(Qw, Kt, lane, s);
    // Only the diagonal tiles and the tile at T's edge have masked entries.
    if (k0 + KT > n || (causal && k0 + KT - 1 > qw0)) {
      const int col0 = k0 + 2 * (lane & 3);
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = col0 + 8 * j + (e & 1);
            if (col >= n || (causal && col > rows[t][e >> 1]))
              s[t][j][e] = -INFINITY;
          }
    }
    uint32_t p[MT][KT / 16][4];
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      online_softmax<KT, HD>(s[t], scale_log2, m[t], l[t], acc[t]);
      to_a_frags<KT>(s[t], p[t]);
    }
    warp_pv_rows<HD, KT, MT>(p, Vt, lane, acc);
  }

  const size_t bh = static_cast<size_t>(b) * n_heads + h;
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    float row_lse[2];
    finish_softmax<HD>(m[t], l[t], acc[t], row_lse);
    store_tile<HD>(out + static_cast<size_t>(b) * n * q_stride + h * HD,
                   q_stride, rows[t], n, lane, acc[t], 1.f);
    if (lse != nullptr && (lane & 3) == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (rows[t][i] < n) lse[bh * n + rows[t][i]] = row_lse[i];
  }
}

template <int HD>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int n, int H, int Hkv,
                           int causal, float scale, cudaStream_t stream) {
  const dim3 grid(H, B, (n + kFwdQ - 1) / kFwdQ);
  const size_t smem = fwd_smem_bytes<HD>();
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_fwd_mma_kernel<HD>, smem, configured);
  if (err != cudaSuccess) return err;
  flash_fwd_mma_kernel<HD><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), n, H, Hkv, causal,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// K5 for bf16 inputs, called from flash_attention.cu's launcher; head dims
// other than 64 and 128 are refused.
cudaError_t flash_fwd_bf16(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int n, int H, int Hkv,
                           int hd, int causal, float scale,
                           cudaStream_t stream) {
  if (hd == 64)
    return launch_fwd_mma<64>(q, k, v, out, lse, B, n, H, Hkv, causal, scale,
                              stream);
  if (hd == 128)
    return launch_fwd_mma<128>(q, k, v, out, lse, B, n, H, Hkv, causal,
                               scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace port_kernels

// The dynamic shared memory launch_fwd_mma requests; -1 for a head dim
// that is not instantiated. Read-only: the smem audit (analysis/smem.py)
// holds its mirror to it.
extern "C" long long flash_forward_mma_smem_bytes(int hd) {
  if (hd == 64) return port_kernels::fwd_smem_bytes<64>();
  if (hd == 128) return port_kernels::fwd_smem_bytes<128>();
  return -1;
}
