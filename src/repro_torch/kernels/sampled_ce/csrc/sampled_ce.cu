// Shared-negative sampled-softmax cross-entropy for Hopper (sm_90a),
// forward and backward, plain C interface.
//
// Replaces the TPU kernels of the JAX package's
// `kernels/sampled_ce/sampled_ce.py`: `_kernel` (`sampled_ce`) and
// `_bwd_dh_kernel` / `_bwd_dne_kernel` (`sampled_ce_bwd`), which the
// reference vmaps over the batch. Here the batch is an axis of the grids.
// Sequence b has S tokens with hidden rows h_t [D] (fp32), positive rows
// pe_t and positive ids p_t, and M shared negatives: rows ne_j, ids n_j and
// proposal log-probs lq_j. Rows are fp32 or bf16 (the class table's native
// dtype), converted to fp32 when loaded. For token t:
//   corr_tj = h_t · ne_j − (ln M + lq_j),  NEG_INF where n_j == p_t
//   lse_t   = logsumexp(pos_t, corr_tj over entries with corr > NEG_INF/2),
//             pos_t = h_t · pe_t
//   loss_t  = lse_t − pos_t
// and, for an upstream gradient g_t, with w_tj = exp(corr_tj − lse_t) on
// valid entries (else 0) and p_t = exp(pos_t − lse_t):
//   dh_t  = g_t (Σ_j w_tj ne_j + (p_t − 1) pe_t)     dpe_t = g_t (p_t − 1) h_t
//   dne_j = Σ_t g_t w_tj h_t                          dlq_j = −Σ_t g_t w_tj
//
// What bounds it on the card: operations. At llama3.2-1b width (B = 4,
// S = 256, M = 1024, D = 2048, fp32 rows) the forward's logit product is
// 4.3 GFLOP against ~50 MB of inputs, and the backward's three products
// (the logits again, w . ne and (g w)^T . h) 12.9 GFLOP against ~70 MB.
// Their fp32-level holds (1e-4) rule out one TF32 product, which misses
// them by ~7x; 3xTF32 (`../../common/tf32x3.cuh`, a third of the 495
// TFLOP/s TF32 rate) meets them, so the products bound the function at
// 165 TFLOP/s: 0.026 ms forward, 0.078 ms backward.
//
// The forward (`fwd_kernel`) is the first version, right and simple:
//   - 256 threads compute a 64 x 64 logit tile (token rows x negative
//     rows) as a shared-memory-tiled fp32 FMA product over D in 32-wide
//     chunks (`logit_tile`); each thread owns a 4 x 4 micro-tile (rows
//     ty + 16 i, columns tx + 16 j) and sums in ascending d;
//   - it folds each tile into a per-row online logsumexp (row max and sum
//     by xor-shuffles inside the 16 lanes that share a row), drops entries
//     at or below NEG_INF_THRESHOLD as `_kernel` does, and joins the
//     positive at the end.
// No tensor cores and no split of M: at S = 256 its grid is S/64 . B = 16
// CTAs, most SMs idle. It is the next kernel to redesign.
//
// The backward is three GEMM-shaped passes on 3xTF32 `mma.sync` tiles
// (64 x 64 per CTA, four warps of 32 x 32), each operand staged by 16-byte
// cp.async double buffering (plain loads where D is not a multiple of the
// 16-byte vector), grids of hundreds of CTAs:
//   W   (`bwd_w_kernel`, grid (M/64, S/64, B); 256 CTAs at llama 4 x 256):
//       the logit tile h . ne^T over D, then W_tj = g_t exp(corr_tj -
//       lse_t) on valid entries, 0 on collisions, entries at or below
//       NEG_INF_THRESHOLD and the padding, into a workspace [B, Sp, Mp]
//       (S and M rounded up to 64); the CTAs of the first negative tile
//       also form c_t = g_t (p_t - 1) from the per-token dot h_t . pe_t;
//   dh  (`bwd_dh_kernel`, grid (D/64, S/64, B); 512 CTAs): dh = W . NE +
//       c pe and dpe = c h, walking M in ascending order;
//   dne (`bwd_dne_kernel`, grid (D/64, M/64, B); 2 048 CTAs): dne =
//       W^T . H, walking S in ascending order; the CTAs of the first D tile
//       also sum dlq = -sum_t W_tj in the same ascending order.
// Every output element has exactly one owner thread, and every sum runs in
// a fixed order: no atomics, so the backward repeats bit for bit. Ragged
// S, M and D are masked in the kernels (zero-filled loads, a zero-padded
// W, unwritten rows); nothing is padded on the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../../common/tf32x3.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float NEG_INF_THRESHOLD = 0.5f * NEG_INF;
constexpr int TILE = 64;               // token rows and negative rows per tile
constexpr int DK = 32;                 // depth of one logit-product chunk
constexpr int PAD = TILE + 1;          // row stride of the shared tiles
constexpr int THREADS = 256;           // 16 × 16, each a 4 × 4 micro-tile
constexpr int MICRO = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared memory of the forward's CTA: the logit product's operand chunks.
struct Smem {
  float a[DK][PAD];                    // token rows, transposed: a[k][row]
  float b[DK][PAD];                    // negative rows, transposed
  float row_m[TILE];
  float row_l[TILE];
};

// Sum / max over the 16 lanes that share a micro-tile row (lanes that
// differ in tx = lane % 16). Every lane ends with the same bits.
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// acc[i][j] = A[ty + 16 i] · B[tx + 16 j] over D, for row-major A [na, D]
// (fp32) and B [nb, D] (T); rows past na / nb read as zeros.
template <typename T>
__device__ __forceinline__ void logit_tile(const float* __restrict__ A,
                                           int na, const T* __restrict__ B,
                                           int nb, int D, Smem& sm,
                                           float (&acc)[MICRO][MICRO]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += DK) {
    for (int idx = tid; idx < TILE * DK; idx += THREADS) {
      const int r = idx / DK, k = idx % DK, d = d0 + k;
      sm.a[k][r] = (r < na && d < D) ? A[(size_t)r * D + d] : 0.f;
      sm.b[k][r] = (r < nb && d < D) ? to_f(B[(size_t)r * D + d])
                                            : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < DK; ++k) {
      float av[MICRO], bv[MICRO];
#pragma unroll
      for (int i = 0; i < MICRO; ++i) av[i] = sm.a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < MICRO; ++j) bv[j] = sm.b[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int j = 0; j < MICRO; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// h · pe for one row, by one warp: a lane-strided FMA chain and an xor
// butterfly (every lane ends with the same bits).
template <typename T>
__device__ __forceinline__ float row_dot(const float* __restrict__ h,
                                         const T* __restrict__ pe, int D,
                                         int lane) {
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(h[d], to_f(pe[d]), acc);
  return warp_sum(acc);
}

// Corrected, masked logits of one tile: column j0 + tx + 16 j of the
// negatives against token rows ty + 16 i (whose positive ids are pid[i]).
__device__ __forceinline__ void correct_tile(
    float (&acc)[MICRO][MICRO], const float* __restrict__ lq,
    const int64_t* __restrict__ nid, int j0, int M, float log_m,
    const int64_t (&pid)[MICRO]) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int j = 0; j < MICRO; ++j) {
    const int c = j0 + tx + 16 * j;
    const bool live = c < M;
    const float shift = live ? log_m + lq[c] : 0.f;
    const int64_t id = live ? nid[c] : -1;
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      acc[i][j] = (!live || id == pid[i]) ? NEG_INF : acc[i][j] - shift;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ h, const T* __restrict__ pe,
           const T* __restrict__ ne, const float* __restrict__ log_q,
           const int64_t* __restrict__ neg_ids,
           const int64_t* __restrict__ pos_ids, float* __restrict__ loss,
           float* __restrict__ lse_out, int S, int M, int D, float log_m) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y, t0 = blockIdx.x * TILE;
  const int nh = min(TILE, S - t0);
  const float* hb = h + ((size_t)b * S + t0) * D;
  const float* lq = log_q + (size_t)b * M;
  const int64_t* nid = neg_ids + (size_t)b * M;
  int64_t pid[MICRO];
  float m[MICRO], l[MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int r = ty + 16 * i;
    pid[i] = r < nh ? pos_ids[(size_t)b * S + t0 + r] : -2;
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  for (int j0 = 0; j0 < M; j0 += TILE) {
    float acc[MICRO][MICRO];
    logit_tile<T>(hb, nh, ne + ((size_t)b * M + j0) * D, min(TILE, M - j0),
                  D, sm, acc);
    correct_tile(acc, lq, nid, j0, M, log_m, pid);
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      float mt = acc[i][0];
#pragma unroll
      for (int j = 1; j < MICRO; ++j) mt = fmaxf(mt, acc[i][j]);
      const float m_new = fmaxf(m[i], row_max16(mt));
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < MICRO; ++j)
        s += acc[i][j] > NEG_INF_THRESHOLD ? expf(acc[i][j] - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + row_sum16(s);
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      sm.row_m[ty + 16 * i] = m[i];
      sm.row_l[ty + 16 * i] = l[i];
    }
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < nh; r += THREADS / 32) {
    const size_t row = (size_t)b * S + t0 + r;
    const float pos = row_dot<T>(h + row * D, pe + row * D, D, lane);
    const float mr = sm.row_m[r];
    const float m_fin = fmaxf(mr, pos);
    const float l_fin = sm.row_l[r] * expf(mr - m_fin) + expf(pos - m_fin);
    const float lse = logf(fmaxf(l_fin, 1e-30f)) + m_fin;
    if (lane == 0) {
      loss[row] = lse - pos;
      lse_out[row] = lse;
    }
  }
}

// ------------------------------------------------------------- backward
using tf32x3::acc_col;
using tf32x3::acc_row;
using tf32x3::cp_async_commit;
using tf32x3::pipeline;
using tf32x3::product;
using tf32x3::stage;

constexpr int BT = 128;                // threads of a backward CTA: 2 x 2 warps
constexpr int BK = 32;                 // depth of one staged slab
// Row strides of the staged slabs (elements), free of bank conflicts for
// the fragments' reads: along a row of 32 (fp32 36, bf16 40), down a
// column of 64 (72 for both).
template <typename T>
constexpr int ALONG = sizeof(T) == 4 ? BK + 4 : BK + 8;
constexpr int DOWN = TILE + 8;

// W: the [64 tokens x 64 negatives] tile (blockIdx.y, blockIdx.x) of
// sequence blockIdx.z: w_out[b, t, j] = g_t exp(corr_tj - lse_t), else 0;
// blockIdx.x == 0 also writes cpos[b, t] = g_t (exp(pos_t - lse_t) - 1).
template <typename T, bool VEC>
__global__ void __launch_bounds__(BT)
bwd_w_kernel(const float* __restrict__ grad, const float* __restrict__ h,
             const T* __restrict__ pe, const T* __restrict__ ne,
             const float* __restrict__ log_q,
             const int64_t* __restrict__ neg_ids,
             const int64_t* __restrict__ pos_ids,
             const float* __restrict__ lse, float* __restrict__ w_out,
             float* __restrict__ cpos, int S, int M, int D, int Sp, int Mp,
             float log_m) {
  constexpr int HS = ALONG<float>, NS = ALONG<T>;
  __shared__ __align__(16) float hs[2][TILE][HS];
  __shared__ __align__(16) T ns[2][TILE][NS];
  const int tid = threadIdx.x, warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int b = blockIdx.z, t0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const float* hb = h + ((size_t)b * S + t0) * D;
  const T* nb = ne + ((size_t)b * M + j0) * D;
  float acc[2][4][4];
  tf32x3::zero(acc);
  pipeline(
      (D + BK - 1) / BK,
      [&](int kk, int buf) {
        stage<float, TILE, BK, HS, BT, VEC>(&hs[buf][0][0], hb, D, 0, S - t0,
                                            kk * BK, D);
        stage<T, TILE, BK, NS, BT, VEC>(&ns[buf][0][0], nb, D, 0, M - j0,
                                        kk * BK, D);
        cp_async_commit();
      },
      [&](int, int buf) {
        const float* a = &hs[buf][32 * wm][0];
        const T* bm = &ns[buf][32 * wn][0];
        product(acc, 0, BK, [&](int r, int k) { return a[r * HS + k]; },
                [&](int k, int c) { return to_f(bm[c * NS + k]); });
      });
  const float* lq = log_q + (size_t)b * M;
  const int64_t* nid = neg_ids + (size_t)b * M;
  float* wo = w_out + ((size_t)b * Sp + t0) * Mp + j0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 32 * wm + 16 * mi + acc_row(2 * half), t = t0 + r;
      const bool live = t < S;
      const size_t row = (size_t)b * S + t;
      const int64_t pid = live ? pos_ids[row] : -2;
      const float ls = live ? lse[row] : 0.f, gt = live ? grad[row] : 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 32 * wn + 8 * ni + acc_col(e), j = j0 + c;
          float wv = 0.f;
          if (live && j < M && nid[j] != pid) {
            const float corr = acc[mi][ni][2 * half + e] - (log_m + lq[j]);
            if (corr > NEG_INF_THRESHOLD) wv = gt * expf(corr - ls);
          }
          wo[(size_t)r * Mp + c] = wv;
        }
    }
  if (blockIdx.x == 0) {
    const int lane = tid & 31;
    for (int r = warp; r < min(TILE, S - t0); r += BT / 32) {
      const size_t row = (size_t)b * S + t0 + r;
      const float pos = row_dot<T>(h + row * D, pe + row * D, D, lane);
      if (lane == 0) cpos[row] = grad[row] * (expf(pos - lse[row]) - 1.f);
    }
  }
}

// dh, dpe: the [64 tokens x 64 columns] tile (blockIdx.y, blockIdx.x) of
// sequence blockIdx.z: dh = W . NE + c pe, dpe = c h, over M ascending.
template <typename T, bool VEC>
__global__ void __launch_bounds__(BT)
bwd_dh_kernel(const float* __restrict__ h, const T* __restrict__ pe,
              const T* __restrict__ ne, const float* __restrict__ w_in,
              const float* __restrict__ cpos, float* __restrict__ dh,
              float* __restrict__ dpe, int S, int M, int D, int Sp, int Mp) {
  constexpr int WS = ALONG<float>;
  __shared__ __align__(16) float ws[2][TILE][WS];
  __shared__ __align__(16) T ns[2][BK][DOWN];
  const int tid = threadIdx.x, warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int b = blockIdx.z, t0 = blockIdx.y * TILE, d0 = blockIdx.x * TILE;
  const float* wb = w_in + ((size_t)b * Sp + t0) * Mp;
  const T* nb = ne + (size_t)b * M * D;
  float acc[2][4][4];
  tf32x3::zero(acc);
  pipeline(
      Mp / BK,
      [&](int kk, int buf) {
        stage<float, TILE, BK, WS, BT, true>(&ws[buf][0][0], wb, Mp, 0, TILE,
                                             kk * BK, Mp);
        stage<T, BK, TILE, DOWN, BT, VEC>(&ns[buf][0][0], nb, D, kk * BK, M,
                                          d0, D);
        cp_async_commit();
      },
      [&](int, int buf) {
        const float* a = &ws[buf][32 * wm][0];
        const T* bm = &ns[buf][0][32 * wn];
        product(acc, 0, BK, [&](int r, int k) { return a[r * WS + k]; },
                [&](int k, int c) { return to_f(bm[k * DOWN + c]); });
      });
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + 32 * wm + 16 * mi + acc_row(2 * half);
      if (t >= S) continue;
      const size_t row = (size_t)b * S + t;
      const float c = cpos[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = d0 + 32 * wn + 8 * ni + acc_col(e);
          if (d >= D) continue;
          const size_t idx = row * D + d;
          dh[idx] = acc[mi][ni][2 * half + e] + c * to_f(pe[idx]);
          dpe[idx] = c * h[idx];
        }
    }
}

// dne, dlq: the [64 negatives x 64 columns] tile (blockIdx.y, blockIdx.x)
// of sequence blockIdx.z: dne = W^T . H over S ascending; blockIdx.x == 0
// also writes dlq = -sum_t W in the same order.
template <bool VEC>
__global__ void __launch_bounds__(BT)
bwd_dne_kernel(const float* __restrict__ h, const float* __restrict__ w_in,
               float* __restrict__ dne, float* __restrict__ dlq, int S, int M,
               int D, int Sp, int Mp) {
  __shared__ __align__(16) float ws[2][BK][DOWN];
  __shared__ __align__(16) float hs[2][BK][DOWN];
  const int tid = threadIdx.x, warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int b = blockIdx.z, j0 = blockIdx.y * TILE, d0 = blockIdx.x * TILE;
  const float* wb = w_in + (size_t)b * Sp * Mp;
  const float* hb = h + (size_t)b * S * D;
  const bool sums = blockIdx.x == 0 && tid < TILE;
  float lq_acc = 0.f;                  // column tid's sum_t W, ascending t
  float acc[2][4][4];
  tf32x3::zero(acc);
  pipeline(
      Sp / BK,
      [&](int kk, int buf) {
        stage<float, BK, TILE, DOWN, BT, true>(&ws[buf][0][0], wb, Mp,
                                               kk * BK, Sp, j0, Mp);
        stage<float, BK, TILE, DOWN, BT, VEC>(&hs[buf][0][0], hb, D, kk * BK,
                                              S, d0, D);
        cp_async_commit();
      },
      [&](int, int buf) {
        const float* a = &ws[buf][0][32 * wm];
        const float* bm = &hs[buf][0][32 * wn];
        product(acc, 0, BK, [&](int r, int k) { return a[k * DOWN + r]; },
                [&](int k, int c) { return bm[k * DOWN + c]; });
        if (sums)
          for (int k = 0; k < BK; ++k) lq_acc += ws[buf][k][tid];
      });
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = j0 + 32 * wm + 16 * mi + acc_row(2 * half);
      if (j >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = d0 + 32 * wn + 8 * ni + acc_col(e);
          if (d < D)
            dne[((size_t)b * M + j) * D + d] = acc[mi][ni][2 * half + e];
        }
    }
  if (sums && j0 + tid < M) dlq[(size_t)b * M + j0 + tid] = -lq_acc;
}

float log_num_neg(int M) { return (float)log((double)M); }

template <typename T>
int fwd(const float* h, const void* pe, const void* ne, const float* log_q,
        const int64_t* neg_ids, const int64_t* pos_ids, float* loss,
        float* lse, int B, int S, int M, int D, cudaStream_t stream) {
  const dim3 grid((S + TILE - 1) / TILE, B);
  fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      h, static_cast<const T*>(pe), static_cast<const T*>(ne), log_q,
      neg_ids, pos_ids, loss, lse, S, M, D, log_num_neg(M));
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int bwd(const float* g, const float* h, const void* pe, const void* ne,
        const float* log_q, const int64_t* neg_ids, const int64_t* pos_ids,
        const float* lse, float* dh, float* dpe, float* dne, float* dlq,
        float* w, float* cpos, int B, int S, int M, int D,
        cudaStream_t stream) {
  const int Sp = (S + TILE - 1) / TILE * TILE;
  const int Mp = (M + TILE - 1) / TILE * TILE;
  const int Dt = (D + TILE - 1) / TILE;
  const T* pe_t = static_cast<const T*>(pe);
  const T* ne_t = static_cast<const T*>(ne);
  if (S > 0) {
    bwd_w_kernel<T, VEC><<<dim3(Mp / TILE, Sp / TILE, B), BT, 0, stream>>>(
        g, h, pe_t, ne_t, log_q, neg_ids, pos_ids, lse, w, cpos, S, M, D, Sp,
        Mp, log_num_neg(M));
    int err = (int)cudaGetLastError();
    if (err) return err;
    bwd_dh_kernel<T, VEC><<<dim3(Dt, Sp / TILE, B), BT, 0, stream>>>(
        h, pe_t, ne_t, w, cpos, dh, dpe, S, M, D, Sp, Mp);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  bwd_dne_kernel<VEC><<<dim3(Dt, Mp / TILE, B), BT, 0, stream>>>(
      h, w, dne, dlq, S, M, D, Sp, Mp);
  return (int)cudaGetLastError();
}

}  // namespace

// All launches are on `stream`; nothing is allocated and nothing waits.
// Each returns cudaGetLastError() after its launches (0 on success).
// Operands are contiguous, with M >= 1: h [B, S, D] fp32; pe [B, S, D] and
// ne [B, M, D] in one row dtype (rows_bf16: 0 = fp32, 1 = bf16); log_q
// [B, M] fp32; neg_ids [B, M] and pos_ids [B, S] int64; g, lse [B, S] fp32.
extern "C" int sampled_ce_fwd_launch(const float* h, const void* pe,
                                     const void* ne, const float* log_q,
                                     const int64_t* neg_ids,
                                     const int64_t* pos_ids, float* loss,
                                     float* lse, int B, int S, int M, int D,
                                     int rows_bf16, void* stream) {
  if (B < 0 || S < 0 || M < 1 || D < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return rows_bf16
             ? fwd<__nv_bfloat16>(h, pe, ne, log_q, neg_ids, pos_ids, loss,
                                  lse, B, S, M, D, s)
             : fwd<float>(h, pe, ne, log_q, neg_ids, pos_ids, loss, lse, B, S,
                          M, D, s);
}

// Writes dh, dpe [B, S, D], dne [B, M, D] and dlq [B, M], all fp32: three
// kernels, W, then dh/dpe and dne/dlq from it. Workspaces, fp32: w
// [B, Sp, Mp] (S and M rounded up to 64) and cpos [B, S]. vec = 1 when D
// is a multiple of the 16-byte vector of the row dtype and h, pe and ne
// are 16-byte aligned.
extern "C" int sampled_ce_bwd_launch(const float* g, const float* h,
                                     const void* pe, const void* ne,
                                     const float* log_q,
                                     const int64_t* neg_ids,
                                     const int64_t* pos_ids, const float* lse,
                                     float* dh, float* dpe, float* dne,
                                     float* dlq, float* w, float* cpos, int B,
                                     int S, int M, int D, int rows_bf16,
                                     int vec, void* stream) {
  if (B < 0 || S < 0 || M < 1 || D < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto bf16, auto v) {
    using T = std::conditional_t<decltype(bf16)::value, __nv_bfloat16, float>;
    return bwd<T, decltype(v)::value>(g, h, pe, ne, log_q, neg_ids, pos_ids,
                                      lse, dh, dpe, dne, dlq, w, cpos, B, S,
                                      M, D, s);
  };
  using Yes = std::true_type;
  using No = std::false_type;
  if (rows_bf16) return vec ? run(Yes{}, Yes{}) : run(Yes{}, No{});
  return vec ? run(No{}, Yes{}) : run(No{}, No{});
}
