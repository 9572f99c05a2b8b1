// Flash-decode attention over a contiguous KV cache, for Hopper (sm_90a).
//
// K4 replaces the Pallas kernel behind
//    k8s_gpu_scheduler_tpu/ops/decode_attention.py flash_decode_attention
//    (_decode_kernel): one query row per slot against a contiguous cache
//    [B, S, Hkv, hd], masked to col < length and, optionally, to the set
//    rows of a validity bitmap [B, S] (the shared-cursor engine's slot
//    windows: every slot writes at one cursor, so most rows under the
//    cursor belong to other requests of the epoch).
//
// bf16 q runs on the tensor-core body K4 shares with K1 and K3
// (decode_mma.cu, which says why), reading the cache through its
// contiguous row source. f32 q runs here, flash_decode_kernel, on the CUDA
// cores in f32: the JAX kernel's numerics, which the tensor cores would
// round. It is bound by bytes: every attendable K/V row is read once and
// used for the g query heads of its group. One block per (slot, kv head,
// split) keeps the g heads in registers and streams the rows with 16-byte
// loads (8 elements per lane, hd/8 lanes per row, several rows in flight
// per warp); int8 rows are dequantized in registers. Row r of slot b, kv
// head h sits at ((b*S + r)*Hkv + h)*hd: no table, and no blocking of S
// (the TPU kernel needed a power-of-two block that divides S; here any S
// works and the loop ends at the length). A row whose bitmap byte is 0 is
// never loaded, and a warp whose rows of a step are all unset skips the
// step. The split count fills the 132 SMs when slots x kv heads alone
// would not; split s covers rows [s*rps, (s+1)*rps) of the slot's live
// rows (< length, not S). The splits of one (slot, kv head) are one
// thread-block cluster: each block merges its row groups in shared memory,
// then rank 0 merges the splits by log-sum-exp through distributed shared
// memory (cluster_merge.cuh) and writes [B, H, hd]. The JAX package merged
// them in XLA; here no partial buffer, second pass or atomic is needed.
//
// Numerics follow the JAX kernel: scores, softmax statistics and the PV
// accumulator in f32, int8 rows dequantized (value * row scale) on load,
// masked columns contribute exactly zero (they never enter the running
// max or sum, so a step with no set row leaves them untouched), and a
// fully masked row yields zeros.
//
// Build: ops/_build.py compiles this file beside the other sources into one
//        library (plain C interface for ctypes); the launch function
//        returns cudaGetLastError().

#include <math.h>

#include "cluster_merge.cuh"
#include "common.cuh"

namespace port_kernels {

// K4 for bf16 q, on the tensor cores (decode_mma.cu).
cudaError_t flash_decode_bf16(const void* q, const void* k, const void* v,
                              const void* ks, const void* vs,
                              const void* bitmap, const void* lengths,
                              int length, void* out, int B, int H, int Hkv,
                              int hd, int S, int n_splits, int kv_int8,
                              float scale, cudaStream_t stream);

}  // namespace port_kernels

namespace {

using namespace port_kernels;

constexpr int kThreads = 128;

// grid (n_splits, B * Hkv), cluster (n_splits, 1, 1), 128 threads. A key
// row is read by hd/8 lanes (8 dims each); a warp covers 32/(hd/8) rows per
// step and the block NG = 4 * that many row groups. Each row group keeps
// its own running (m, l, acc) for the g heads; the groups merge through
// shared memory, then the splits across the cluster. Split s covers rows
// [s*rps, (s+1)*rps) of the slot's live rows, rps = ceil(length /
// n_splits); null lengths give every slot `length`. f32 q (f32 or int8
// caches).
template <typename KT, int HD, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const KT* __restrict__ kc,
                    const KT* __restrict__ vc, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const uint8_t* __restrict__ bitmap,
                    const int* __restrict__ lengths, int length,
                    float* __restrict__ out, int n_kv, int S, float scale) {
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

  const int len = min(max(lengths != nullptr ? lengths[b] : length, 0), S);
  const int rps = (len + n_splits - 1) / n_splits;
  const int row_lo = split * rps;
  const int row_hi = min(row_lo + rps, len);   // <= row_lo: nothing to read

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

  const size_t slot_row0 = static_cast<size_t>(b) * S;
  const uint8_t* bm = bitmap ? bitmap + slot_row0 : nullptr;
  // Every lane of a warp runs the same number of steps and takes the same
  // branch around a step (the shuffles below need the whole warp); rows
  // past row_hi or unset in the bitmap are loaded as nothing and skipped
  // in the update.
  for (int base = row_lo + warp * RPW; base < row_hi; base += NG * U) {
    bool valid[U];
    bool any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + u * NG + sub;
      valid[u] = c < row_hi && (bm == nullptr || bm[c] != 0);
      any = any || valid[u];
    }
    if (!__any_sync(0xffffffffu, any)) continue;
    float kf[U][8], vf[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (valid[u]) {
        const size_t row =
            (slot_row0 + (base + u * NG + sub)) * n_kv + kvh;
        load8(kc + row * HD + seg * 8, kf[u]);
        load8(vc + row * HD + seg * 8, vf[u]);
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

template <typename KT, int HD>
cudaError_t launch_flash_decode(int g, const void* q, const void* k,
                                const void* v, const void* ks, const void* vs,
                                const void* bitmap, const void* lengths,
                                int length, void* out, int B, int Hkv, int S,
                                int n_splits, cudaStream_t stream) {
  if (n_splits < 1 || n_splits > kMaxSplits) return cudaErrorInvalidValue;
  const dim3 grid(n_splits, B * Hkv);
  const float scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
#define K4_LAUNCH(GV)                                                       \
  {                                                                         \
    static bool fits = false;                                               \
    const cudaError_t err = check_cluster_fits(                             \
        flash_decode_kernel<KT, HD, GV>, kThreads, 0, fits);                \
    if (err != cudaSuccess) return err;                                     \
    return launch_cluster(                                                  \
        flash_decode_kernel<KT, HD, GV>, grid, kThreads, 0, stream,         \
        static_cast<const float*>(q), static_cast<const KT*>(k),            \
        static_cast<const KT*>(v), static_cast<const float*>(ks),           \
        static_cast<const float*>(vs), static_cast<const uint8_t*>(bitmap), \
        static_cast<const int*>(lengths), length, static_cast<float*>(out), \
        Hkv, S, scale);                                                     \
  }
  switch (g) {
    case 1: K4_LAUNCH(1)
    case 2: K4_LAUNCH(2)
    case 4: K4_LAUNCH(4)
    case 8: K4_LAUNCH(8)
    default: return cudaErrorInvalidValue;
  }
#undef K4_LAUNCH
}

}  // namespace

extern "C" {

// q [B, H, hd]; k/v [B, S, Hkv, hd]; ks/vs [B, S, Hkv, 1] f32 (int8 caches
// only, else null); bitmap [B, S], one byte per row (0 = masked), or null;
// lengths [B] i32, or null and every slot's length `length` -> out [B, H,
// hd] in q's dtype; n_splits in 1 ..
// kMaxSplits, each a block of one cluster. bf16 q goes to the tensor-core
// kernel (decode_mma.cu), f32 q to the CUDA-core one.
int flash_decode_attention_launch(const void* q, const void* k, const void* v,
                                  const void* ks, const void* vs,
                                  const void* bitmap, const void* lengths,
                                  int length, void* out, int B, int H,
                                  int Hkv, int hd, int S, int n_splits,
                                  int q_bf16, int kv_int8, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return port_kernels::flash_decode_bf16(
        q, k, v, ks, vs, bitmap, lengths, length, out, B, H, Hkv, hd, S,
        n_splits,
        kv_int8, static_cast<float>(1.0 / sqrt(static_cast<double>(hd))),
        st);
#define K4_ARGS H / Hkv, q, k, v, ks, vs, bitmap, lengths, length, out, B, \
                Hkv, S, n_splits, st
  if (hd == 64)
    return kv_int8 ? launch_flash_decode<int8_t, 64>(K4_ARGS)
                   : launch_flash_decode<float, 64>(K4_ARGS);
  if (hd == 128)
    return kv_int8 ? launch_flash_decode<int8_t, 128>(K4_ARGS)
                   : launch_flash_decode<float, 128>(K4_ARGS);
#undef K4_ARGS
  return cudaErrorInvalidValue;
}

// The dynamic shared memory the f32 launcher requests: none (its merge
// arrays are static); -1 for a head dim that is not instantiated.
// Read-only: the smem audit (analysis/smem.py) holds its mirror to it.
long long flash_decode_smem_bytes(int kv_int8, int hd) {
  (void)kv_int8;
  return hd == 64 || hd == 128 ? 0 : -1;
}

}  // extern "C"
