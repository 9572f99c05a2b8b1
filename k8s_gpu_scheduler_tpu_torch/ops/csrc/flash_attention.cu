// Flash attention for training, for Hopper (sm_90a), for f32 inputs: the
// forward (K5) and both backward kernels (K6, K7). bf16 launches go to the
// tensor-core kernels of flash_forward_mma.cu and flash_backward_mma.cu.
//
// K5 flash_fwd_kernel replaces the Pallas kernel behind
//    k8s_gpu_scheduler_tpu/ops/flash_attention.py _flash_forward
//    (_flash_fwd_kernel): causal or full attention with an online softmax,
//    writing out [B, T, H, hd] and (training) lse [B*H, T] f32.
// K6 flash_bwd_dq_kernel replaces the dq kernel of _flash_backward
//    (_flash_bwd_dq_kernel): dq_i = scale * sum_j p_ij (do_i.v_j - D_i) k_j
//    with p = exp(s - lse) and D_i = do_i.o_i computed here (and written
//    out for K7).
// K7 flash_bwd_dkv_kernel replaces the dk/dv kernel of _flash_backward
//    (_flash_bwd_dkv_kernel): dv_j = sum_i p_ij do_i and dk_j = scale *
//    sum_i ds_ij q_i, summed over the g query heads of a kv head inside the
//    kernel (the JAX package repeated K/V per head and summed the groups
//    outside).
//
// What bounds them on an H100 and what the design does about it:
//
// At the training shapes (T 2048, hd 128) each kernel does 2-4 products of
// T*T/2*hd multiply-adds per head against T*hd elements read per head:
// hundreds of flops per byte, so they are bound by operations. The kernels
// here run the products in f32 on the CUDA cores (the JAX kernels'
// numerics), from shared memory, with register tiles: a block of 128
// threads is 16 row groups x 8 lanes; a thread holds a 4 x 4 (K5, K6) or
// 2 x 8 (K7) tile of the score matrix and reads its operands as float4,
// and a row's 8 lanes are 8 consecutive lanes of one warp, so row maxima
// and sums are three shuffles. Rows are padded by 4 floats in shared
// memory so the 8 lanes of a quarter warp hit distinct banks. Tiles wholly
// above the diagonal are never visited: K5 and K6 stop their k loop at the
// q tile's last row, K7 starts its q loop at the k tile's first row, and
// K5 launches its heaviest (last) q tiles first.
//
// f32 stays on the CUDA cores on purpose: tensor cores would take f32
// operands as TF32 (10 mantissa bits) or bf16, and f32 training on the
// card is held to the CPU's losses at 1e-5 relative and replayed bit for
// bit. bf16 operands lose nothing on the bf16 tensor cores, so bf16 runs
// there (flash_forward_mma.cu, flash_backward_mma.cu).
//
// Numerics: scores, softmax statistics and every accumulator in f32;
// masked entries (above the diagonal, past T) get exactly zero
// probability, never exp(s - lse) of a masked score; each output element is
// summed by one thread in a fixed order, with no atomics, so every kernel
// is deterministic (a remat recompute of K5 reproduces its forward bit for
// bit) and K7's GQA sum is too. T needs no block multiple: rows past T
// load as zeros and are never stored.
//
// Build: ops/_build.py compiles this file beside the other sources into
//        one library (plain C interface for ctypes); each launch function
//        returns cudaGetLastError().

#include <math.h>

#include "common.cuh"

namespace port_kernels {

// K5 for bf16 inputs, on the tensor cores (flash_forward_mma.cu).
cudaError_t flash_fwd_bf16(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int n, int H, int Hkv,
                           int hd, int causal, float scale,
                           cudaStream_t stream);
// K6 and K7 for bf16 inputs, on the tensor cores (flash_backward_mma.cu).
cudaError_t flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, void* dq, void* delta, int B,
                              int n, int H, int Hkv, int hd, int causal,
                              float scale, cudaStream_t stream);
cudaError_t flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv, int B,
                               int n, int H, int Hkv, int hd, int causal,
                               float scale, cudaStream_t stream);

}  // namespace port_kernels

namespace {

using namespace port_kernels;

constexpr int kThreads = 128;   // 16 row groups (ty) x 8 lanes (tx)
constexpr int kRowGroups = 16;
constexpr int kLanes = 8;

// Tiles: q rows x k rows per step.
constexpr int kFwdQ = 64, kFwdK = 32;    // K5
constexpr int kDqQ = 64, kDqK = 32;      // K6
constexpr int kDkvK = 32, kDkvQ = 64;    // K7

// Padded row of a staged [rows][hd] tile, and of a score tile.
__host__ __device__ constexpr int ld(int hd) { return hd + 4; }
__host__ __device__ constexpr int pld(int cols) { return cols + 8; }

template <int HD>
__host__ __device__ constexpr int fwd_smem_floats() {
  return (kFwdQ + 2 * kFwdK) * ld(HD) + kFwdQ * pld(kFwdK);
}
template <int HD>
__host__ __device__ constexpr int dq_smem_floats() {
  return (2 * kDqQ + 2 * kDqK) * ld(HD) + kDqQ * pld(kDqK);
}
template <int HD>
__host__ __device__ constexpr int dkv_smem_floats() {
  return (2 * kDkvK + 2 * kDkvQ) * ld(HD) + 2 * kDkvK * pld(kDkvQ) +
         2 * kDkvQ;
}

// Rows row0 .. row0+ROWS-1 of one head, row r at src + r * stride, into
// the f32 tile dst [ROWS][ld(HD)]; rows at or past n_rows become zeros.
template <int HD, int ROWS>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           size_t stride, int row0,
                                           int n_rows, float* dst) {
  constexpr int SEGS = HD / 8;
  for (int i = threadIdx.x; i < ROWS * SEGS; i += kThreads) {
    const int r = i / SEGS;
    const int sg = i - r * SEGS;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n_rows)
      load8(src + static_cast<size_t>(row0 + r) * stride + sg * 8, v);
    float4* d = reinterpret_cast<float4*>(dst + r * ld(HD) + sg * 8);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// s[i][j] = A[ty + 16 i] . B[tx + 8 j] over HD dims, A and B staged tiles.
template <int R, int C, int HD>
__device__ __forceinline__ void tile_dot(const float* __restrict__ A,
                                         const float* __restrict__ Bm, int ty,
                                         int tx, float (&s)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[R], b[C];
#pragma unroll
    for (int i = 0; i < R; ++i)
      a[i] = *reinterpret_cast<const float4*>(
          A + (ty + kRowGroups * i) * ld(HD) + d);
#pragma unroll
    for (int j = 0; j < C; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bm + (tx + kLanes * j) * ld(HD) +
                                              d);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) {
        s[i][j] += a[i].x * b[j].x;
        s[i][j] += a[i].y * b[j].y;
        s[i][j] += a[i].z * b[j].z;
        s[i][j] += a[i].w * b[j].w;
      }
  }
}

// acc[i][4 jj + e] += sum_c P[ty + 16 i][c] * V[c][4 tx + 32 jj + e]: the
// thread's rows of a P tile (row stride p_ld) times a staged tile V. The
// thread's output dims are 4 tx + 32 jj + e (jj < HD/32, e < 4).
template <int R, int NC, int HD>
__device__ __forceinline__ void tile_accum(const float* __restrict__ P,
                                           int p_ld,
                                           const float* __restrict__ V,
                                           int ty, int tx,
                                           float (&acc)[R][HD / 8]) {
  constexpr int J = HD / 32;
#pragma unroll 2
  for (int c = 0; c < NC; c += 4) {
    float4 p[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + kRowGroups * i) * p_ld +
                                              c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const float4 v = *reinterpret_cast<const float4*>(
            V + (c + cc) * ld(HD) + 4 * tx + 32 * jj);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float pc = cc == 0 ? p[i].x
                           : cc == 1 ? p[i].y
                           : cc == 2 ? p[i].z
                                     : p[i].w;
          acc[i][4 * jj + 0] += pc * v.x;
          acc[i][4 * jj + 1] += pc * v.y;
          acc[i][4 * jj + 2] += pc * v.z;
          acc[i][4 * jj + 3] += pc * v.w;
        }
      }
    }
  }
}

// Sum (or max) over the 8 lanes of a row: consecutive lanes of one warp.
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  return v;
}

__device__ __forceinline__ bool visible(int row, int col, int n, int causal) {
  return col < n && row < n && (!causal || col <= row);
}

// Writes the thread's dims of one output row: v[4 jj + e] * mul at dims
// 4 tx + 32 jj + e.
template <int HD>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[HD / 8],
                                          int tx, float mul) {
#pragma unroll
  for (int jj = 0; jj < HD / 32; ++jj)
    store4(dst + 4 * tx + 32 * jj, v[4 * jj] * mul, v[4 * jj + 1] * mul,
           v[4 * jj + 2] * mul, v[4 * jj + 3] * mul);
}

// -- K5: forward ----------------------------------------------------------------
//
// grid (ceil(T / 64), H, B), 128 threads; block x takes q tile n - 1 - x.
// Thread (ty, tx) owns q rows ty + 16 i (i < 4), score columns tx + 8 j
// (j < 4) of each 32-row k tile, and output dims 4 tx + 32 jj + e. Each
// lane keeps its share of the row sum l; the 8 shares add up at the end.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int n, int n_heads, int n_kv,
                 int causal, float scale) {
  constexpr int R = kFwdQ / kRowGroups;
  constexpr int C = kFwdK / kLanes;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);     // [kFwdQ][ld]
  float* Ks = Qs + kFwdQ * ld(HD);                    // [kFwdK][ld]
  float* Vs = Ks + kFwdK * ld(HD);                    // [kFwdK][ld]
  float* Ps = Vs + kFwdK * ld(HD);                    // [kFwdQ][pld]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int tx = threadIdx.x & (kLanes - 1);
  const int ty = threadIdx.x / kLanes;
  const size_t q_stride = static_cast<size_t>(n_heads) * HD;
  const size_t kv_stride = static_cast<size_t>(n_kv) * HD;
  const float* kb = k + (static_cast<size_t>(b) * n * n_kv + kvh) * HD;
  const float* vb = v + (static_cast<size_t>(b) * n * n_kv + kvh) * HD;

  stage_rows<HD, kFwdQ>(q + (static_cast<size_t>(b) * n * n_heads + h) * HD,
                           q_stride, q0, n, Qs);

  float m[R], l[R], acc[R][HD / 8];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < HD / 8; ++e) acc[i][e] = 0.f;
  }

  const int k_end = causal ? min(n, q0 + kFwdQ) : n;
  for (int k0 = 0; k0 < k_end; k0 += kFwdK) {
    __syncthreads();                      // last tile's readers are done
    stage_rows<HD, kFwdK>(kb, kv_stride, k0, n, Ks);
    stage_rows<HD, kFwdK>(vb, kv_stride, k0, n, Vs);
    __syncthreads();
    float s[R][C];
    tile_dot<R, C, HD>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + kRowGroups * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        s[i][j] *= scale;
        if (visible(row, k0 + tx + kLanes * j, n, causal))
          mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - mn);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int col = k0 + tx + kLanes * j;
        const float p = visible(row, col, n, causal) ? expf(s[i][j] - mn)
                                                     : 0.f;
        Ps[(ty + kRowGroups * i) * pld(kFwdK) + tx + kLanes * j] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + psum;
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < HD / 8; ++e) acc[i][e] *= alpha;
    }
    __syncwarp();                         // a row's P is its warp's work
    tile_accum<R, kFwdK, HD>(Ps, pld(kFwdK), Vs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + kRowGroups * i;
    const float den = fmaxf(row_sum(l[i]), 1e-20f);
    if (row < n) {
      float* o = out + ((static_cast<size_t>(b) * n + row) * n_heads + h) * HD;
#pragma unroll
      for (int jj = 0; jj < HD / 32; ++jj)
        store4(o + 4 * tx + 32 * jj, acc[i][4 * jj] / den,
               acc[i][4 * jj + 1] / den, acc[i][4 * jj + 2] / den,
               acc[i][4 * jj + 3] / den);
      if (lse != nullptr && tx == 0)
        lse[(static_cast<size_t>(b) * n_heads + h) * n + row] =
            m[i] + logf(den);
    }
  }
}

// -- K6: backward, dq -----------------------------------------------------------
//
// grid (ceil(T / 64), H, B), 128 threads, the thread layout of K5. The
// block first computes D_i = do_i . o_i for its 64 rows (o staged where
// the K/V tiles go later) and writes it to delta [B*H, T] for K7.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ out,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    float* __restrict__ delta, int n, int n_heads, int n_kv,
                    int causal, float scale) {
  constexpr int R = kDqQ / kRowGroups;
  constexpr int C = kDqK / kLanes;
  static_assert(2 * kDqK >= kDqQ, "o is staged over the K/V tiles");
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);     // [kDqQ][ld]
  float* dOs = Qs + kDqQ * ld(HD);                    // [kDqQ][ld]
  float* Ks = dOs + kDqQ * ld(HD);                    // [kDqK][ld]
  float* Vs = Ks + kDqK * ld(HD);                     // [kDqK][ld]
  float* Ps = Vs + kDqK * ld(HD);                     // [kDqQ][pld]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int tx = threadIdx.x & (kLanes - 1);
  const int ty = threadIdx.x / kLanes;
  const size_t q_stride = static_cast<size_t>(n_heads) * HD;
  const size_t kv_stride = static_cast<size_t>(n_kv) * HD;
  const size_t q_off = (static_cast<size_t>(b) * n * n_heads + h) * HD;
  const float* kb = k + (static_cast<size_t>(b) * n * n_kv + kvh) * HD;
  const float* vb = v + (static_cast<size_t>(b) * n * n_kv + kvh) * HD;
  const size_t bh = static_cast<size_t>(b) * n_heads + h;

  stage_rows<HD, kDqQ>(q + q_off, q_stride, q0, n, Qs);
  stage_rows<HD, kDqQ>(dout + q_off, q_stride, q0, n, dOs);
  stage_rows<HD, kDqQ>(out + q_off, q_stride, q0, n, Ks);   // o
  __syncthreads();

  float D[R], L[R], acc[R][HD / 8];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + kRowGroups * i;
    float part = 0.f;
#pragma unroll
    for (int jj = 0; jj < HD / 32; ++jj) {
      const float4 a = *reinterpret_cast<const float4*>(
          dOs + r * ld(HD) + 4 * tx + 32 * jj);
      const float4 o = *reinterpret_cast<const float4*>(
          Ks + r * ld(HD) + 4 * tx + 32 * jj);
      part += a.x * o.x + a.y * o.y + a.z * o.z + a.w * o.w;
    }
    D[i] = row_sum(part);
    const bool ok = q0 + r < n;
    L[i] = ok ? lse[bh * n + q0 + r] : 0.f;
    if (ok && tx == 0) delta[bh * n + q0 + r] = D[i];
#pragma unroll
    for (int e = 0; e < HD / 8; ++e) acc[i][e] = 0.f;
  }

  const int k_end = causal ? min(n, q0 + kDqQ) : n;
  for (int k0 = 0; k0 < k_end; k0 += kDqK) {
    __syncthreads();                      // o / the last tile is consumed
    stage_rows<HD, kDqK>(kb, kv_stride, k0, n, Ks);
    stage_rows<HD, kDqK>(vb, kv_stride, k0, n, Vs);
    __syncthreads();
    float s[R][C], dp[R][C];
    tile_dot<R, C, HD>(Qs, Ks, ty, tx, s);
    tile_dot<R, C, HD>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + kRowGroups * i;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float p = visible(row, k0 + tx + kLanes * j, n, causal)
                            ? expf(s[i][j] * scale - L[i])
                            : 0.f;
        Ps[(ty + kRowGroups * i) * pld(kDqK) + tx + kLanes * j] =
            p * (dp[i][j] - D[i]);
      }
    }
    __syncwarp();
    tile_accum<R, kDqK, HD>(Ps, pld(kDqK), Ks, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + kRowGroups * i;
    if (row < n)
      store_row<HD>(dq + ((static_cast<size_t>(b) * n + row) * n_heads + h) *
                                HD,
                       acc[i], tx, scale);
  }
}

// -- K7: backward, dk and dv ------------------------------------------------------
//
// grid (ceil(T / 32), Hkv, B), 128 threads. Thread (ty, tx) owns k rows
// ty + 16 i (i < 2), q columns tx + 8 j (j < 8) of each 64-row q tile, and
// output dims 4 tx + 32 jj + e. The loops run over the g query heads of
// the kv head and, for each, the q tiles from the k tile's first row on
// (causal) or all of them; P^T and dS^T go through shared memory.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int n, int n_heads, int n_kv,
                     int causal, float scale) {
  constexpr int R = kDkvK / kRowGroups;
  constexpr int C = kDkvQ / kLanes;
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);     // [kDkvK][ld]
  float* Vs = Ks + kDkvK * ld(HD);                    // [kDkvK][ld]
  float* Qs = Vs + kDkvK * ld(HD);                    // [kDkvQ][ld]
  float* dOs = Qs + kDkvQ * ld(HD);                   // [kDkvQ][ld]
  float* Pt = dOs + kDkvQ * ld(HD);                   // [kDkvK][pld]
  float* dSt = Pt + kDkvK * pld(kDkvQ);               // [kDkvK][pld]
  float* Ls = dSt + kDkvK * pld(kDkvQ);               // [kDkvQ]
  float* Ds = Ls + kDkvQ;                             // [kDkvQ]

  const int k0 = blockIdx.x * kDkvK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = n_heads / n_kv;
  const int tx = threadIdx.x & (kLanes - 1);
  const int ty = threadIdx.x / kLanes;
  const size_t q_stride = static_cast<size_t>(n_heads) * HD;
  const size_t kv_stride = static_cast<size_t>(n_kv) * HD;
  const size_t kv_off = (static_cast<size_t>(b) * n * n_kv + kvh) * HD;

  stage_rows<HD, kDkvK>(k + kv_off, kv_stride, k0, n, Ks);
  stage_rows<HD, kDkvK>(v + kv_off, kv_stride, k0, n, Vs);

  float dk_acc[R][HD / 8], dv_acc[R][HD / 8];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < HD / 8; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int q_start = causal ? (k0 / kDkvQ) * kDkvQ : 0;
  for (int j = 0; j < g; ++j) {
    const int h = kvh * g + j;
    const size_t q_off = (static_cast<size_t>(b) * n * n_heads + h) * HD;
    const size_t bh = static_cast<size_t>(b) * n_heads + h;
    for (int q0 = q_start; q0 < n; q0 += kDkvQ) {
      __syncthreads();                    // the last q tile is consumed
      stage_rows<HD, kDkvQ>(q + q_off, q_stride, q0, n, Qs);
      stage_rows<HD, kDkvQ>(dout + q_off, q_stride, q0, n, dOs);
      for (int r = threadIdx.x; r < kDkvQ; r += kThreads) {
        const bool ok = q0 + r < n;
        Ls[r] = ok ? lse[bh * n + q0 + r] : 0.f;
        Ds[r] = ok ? delta[bh * n + q0 + r] : 0.f;
      }
      __syncthreads();
      float st[R][C], dpt[R][C];
      tile_dot<R, C, HD>(Ks, Qs, ty, tx, st);
      tile_dot<R, C, HD>(Vs, dOs, ty, tx, dpt);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int krow = k0 + ty + kRowGroups * i;
#pragma unroll
        for (int jq = 0; jq < C; ++jq) {
          const int c = tx + kLanes * jq;
          const float p = visible(q0 + c, krow, n, causal)
                              ? expf(st[i][jq] * scale - Ls[c])
                              : 0.f;
          const int at = (ty + kRowGroups * i) * pld(kDkvQ) + c;
          Pt[at] = p;
          dSt[at] = p * (dpt[i][jq] - Ds[c]);
        }
      }
      __syncwarp();
      tile_accum<R, kDkvQ, HD>(Pt, pld(kDkvQ), dOs, ty, tx, dv_acc);
      tile_accum<R, kDkvQ, HD>(dSt, pld(kDkvQ), Qs, ty, tx, dk_acc);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int krow = k0 + ty + kRowGroups * i;
    if (krow < n) {
      const size_t o = ((static_cast<size_t>(b) * n + krow) * n_kv + kvh) * HD;
      store_row<HD>(dk + o, dk_acc[i], tx, scale);
      store_row<HD>(dv + o, dv_acc[i], tx, 1.f);
    }
  }
}

// -- host-side dispatch -------------------------------------------------------

inline float softmax_scale(int hd) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
}

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       void* lse, int B, int n, int H, int Hkv, int causal,
                       cudaStream_t stream) {
  const dim3 grid((n + kFwdQ - 1) / kFwdQ, H, B);
  const size_t smem = sizeof(float) * fwd_smem_floats<HD>();
  static bool configured = false;
  const cudaError_t err = allow_smem(flash_fwd_kernel<HD>, smem, configured);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), n, H, Hkv, causal, softmax_scale(HD));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* out, const void* dout, const void* lse,
                      void* dq, void* delta, int B, int n, int H, int Hkv,
                      int causal, cudaStream_t stream) {
  const dim3 grid((n + kDqQ - 1) / kDqQ, H, B);
  const size_t smem = sizeof(float) * dq_smem_floats<HD>();
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_bwd_dq_kernel<HD>, smem, configured);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dq), static_cast<float*>(delta), n, H, Hkv, causal,
      softmax_scale(HD));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int n, int H, int Hkv,
                       int causal, cudaStream_t stream) {
  const dim3 grid((n + kDkvK - 1) / kDkvK, Hkv, B);
  const size_t smem = sizeof(float) * dkv_smem_floats<HD>();
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_bwd_dkv_kernel<HD>, smem, configured);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), n, H, Hkv, causal,
      softmax_scale(HD));
  return cudaGetLastError();
}

}  // namespace

// The f32 instantiation for hd; other head dims are refused.
#define F32_DISPATCH(LAUNCH, ...)                                         \
  do {                                                                    \
    if (hd == 64) return LAUNCH<64>(__VA_ARGS__);                         \
    if (hd == 128) return LAUNCH<128>(__VA_ARGS__);                       \
    return cudaErrorInvalidValue;                                         \
  } while (0)

// bf16 goes to the tensor-core kernels (flash_forward_mma.cu,
// flash_backward_mma.cu), f32 to the CUDA-core kernels above.
extern "C" {

// q [B, T, H, hd]; k/v [B, T, Hkv, hd], q's dtype -> out [B, T, H, hd],
// lse [B*H, T] f32 (null: not written).
int flash_forward_launch(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int T, int H, int Hkv,
                         int hd, int causal, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return port_kernels::flash_fwd_bf16(q, k, v, out, lse, B, T, H, Hkv, hd,
                                        causal, softmax_scale(hd), st);
  F32_DISPATCH(launch_fwd, q, k, v, out, lse, B, T, H, Hkv, causal, st);
}

// q/out/dout [B, T, H, hd]; k/v [B, T, Hkv, hd]; lse [B*H, T] f32 ->
// dq [B, T, H, hd], delta [B*H, T] f32 (rowsum(dout * out), for K7).
int flash_backward_dq_launch(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, void* dq, void* delta, int B,
                             int T, int H, int Hkv, int hd, int causal,
                             int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return port_kernels::flash_bwd_dq_bf16(q, k, v, out, dout, lse, dq, delta,
                                           B, T, H, Hkv, hd, causal,
                                           softmax_scale(hd), st);
  F32_DISPATCH(launch_dq, q, k, v, out, dout, lse, dq, delta, B, T, H, Hkv,
               causal, st);
}

// q/dout [B, T, H, hd]; k/v [B, T, Hkv, hd]; lse, delta [B*H, T] f32 ->
// dk, dv [B, T, Hkv, hd], summed over each kv head's g query heads.
int flash_backward_dkv_launch(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int T, int H, int Hkv, int hd, int causal,
                              int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return port_kernels::flash_bwd_dkv_bf16(q, k, v, dout, lse, delta, dk, dv,
                                            B, T, H, Hkv, hd, causal,
                                            softmax_scale(hd), st);
  F32_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, B, T, H, Hkv,
               causal, st);
}

// The dynamic shared memory the f32 launch_fwd (kernel 5), launch_dq (6) or
// launch_dkv (7) requests; -1 for a head dim that is not instantiated.
// Read-only: the smem audit (analysis/smem.py) holds its mirror to it.
long long flash_attention_smem_bytes(int kernel, int hd) {
  if (hd != 64 && hd != 128) return -1;
  const bool h64 = hd == 64;
  long long floats = -1;
  if (kernel == 5)
    floats = h64 ? fwd_smem_floats<64>() : fwd_smem_floats<128>();
  if (kernel == 6)
    floats = h64 ? dq_smem_floats<64>() : dq_smem_floats<128>();
  if (kernel == 7)
    floats = h64 ? dkv_smem_floats<64>() : dkv_smem_floats<128>();
  return floats < 0 ? -1 : static_cast<long long>(sizeof(float)) * floats;
}

}  // extern "C"
