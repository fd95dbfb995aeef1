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
// the backward's by 4-14x; 3xTF32 (`../../common/tf32x3.cuh`, a third of
// the 495 TFLOP/s TF32 rate) meets them, so the products bound the
// function at 165 TFLOP/s: 0.026 ms forward, 0.078 ms backward.
//
// Every pass is a GEMM-shaped grid of 64 x 64 tiles per CTA (four warps of
// 32 x 32) on 3xTF32 `mma.sync`, each operand staged by 16-byte cp.async
// double buffering (plain loads where D is not a multiple of the 16-byte
// vector): grids of hundreds of CTAs (256 at llama 4 x 256 for the logit
// tiles). The logit tile h . ne^T over D is one routine (`logit_tile`),
// called by the forward's partials and by the backward's W pass, so the
// forward's lse and the backward's W see the same logits, bit for bit.
//
// The forward is two kernels:
//   partials (`fwd_part_kernel`, grid (M/64, S/64, B)): the logit tile,
//       corrected and masked as `_kernel` does (collisions and padding to
//       NEG_INF; entries at or below NEG_INF_THRESHOLD count as zero
//       mass), then per token row the tile's max m and its sum l of
//       exp(corr - m), each over the row's 64 columns in a fixed order
//       (the four lanes of a quad, then the two warps that hold the row's
//       halves), into a workspace part [B, S, M/64] of (m, l) pairs; the
//       CTAs of the first negative tile also write pos_t = h_t . pe_t;
//   merge (`fwd_merge_kernel`, one thread per token): the row's partials
//       in ascending tile order, by the online rule of `_kernel`, then the
//       positive joined last. An all-masked tile is (NEG_INF, 0) and adds
//       exactly nothing; a token whose negatives all collide ends with
//       lse == pos bit for bit, loss exactly 0.
// The backward is three passes:
//   W   (`bwd_w_kernel`, grid (M/64, S/64, B)): the logit tile, then W_tj =
//       g_t exp(corr_tj - lse_t) on valid entries, 0 on collisions, entries
//       at or below NEG_INF_THRESHOLD and the padding, into a workspace
//       [B, Sp, Mp] (S and M rounded up to 64); the CTAs of the first
//       negative tile also form c_t = g_t (p_t - 1) from h_t . pe_t;
//   dh  (`bwd_dh_kernel`, grid (D/64, S/64, B); 512 CTAs): dh = W . NE +
//       c pe and dpe = c h, walking M in ascending order;
//   dne (`bwd_dne_kernel`, grid (D/64, M/64, B); 2 048 CTAs): dne =
//       W^T . H, walking S in ascending order; the CTAs of the first D tile
//       also sum dlq = -sum_t W_tj in the same ascending order.
// Every output element has exactly one owner thread, and every sum runs in
// a fixed order that depends on neither B nor S nor a token's tile: no
// atomics, so forward and backward repeat bit for bit, and a sequence's
// results are the same alone or in a batch. Ragged S, M and D are masked
// in the kernels (zero-filled loads, a zero-padded W, unwritten rows);
// nothing is padded on the host.
//
// Quantized mode (the TPU kernels' `quantized` branch, DESIGN §12): the
// gathered rows pe and ne are int8 or fp8-e4m3 with fp32 scales per row,
// [B, S] and [B, M]. The rows are staged as they are (1 byte an element:
// 16-byte cp.async chunks of 16 elements where D is a multiple of 16), and
// every element is dequantized in registers as it leaves shared memory,
// x = float(q) · s, the reference's `ne * ns` before the dot, so the
// 3xTF32 split takes the dequantized fp32 value. A tile's negative scales
// are staged in shared memory beside it (the logit tile: its 64 columns'
// scales; the dh pass: each 32-deep slab's). pos_t and dh's c·pe use the
// dequantized positive row. dpe = c h and dne = W^T H never read a row:
// they are the scale-unaware gradients that the straight-through
// estimator hands to the master rows.
//
// Partial mode (the TPU kernels' `include_pos=False`, the vocab-parallel
// head's shard of the loss): the negatives are this shard's (a negative
// it does not own comes as a zero-weight row, lq = +1e30, so its corrected
// logit is NEG_INF), p_t is the local positive on its owner and -1
// elsewhere, used only to mask collisions, and there are no positive rows
// (pe and psc are null). The forward's merge ends without the positive:
// loss = lse = the negatives-only lse, NEG_INF for a token with no valid
// entry. The backward reads that partial lse; the W pass writes no c_t,
// the dh pass writes dh = W . NE alone (no dpe), and dne/dlq are as in
// the full mode. ln M is the global negative count `num_neg`.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../../common/tf32x3.cuh"

namespace {

using tf32x3::acc_col;
using tf32x3::acc_row;
using tf32x3::cp_async_commit;
using tf32x3::pipeline;
using tf32x3::product;
using tf32x3::stage;

constexpr float NEG_INF = -1e30f;
constexpr float NEG_INF_THRESHOLD = 0.5f * NEG_INF;
constexpr int TILE = 64;               // token rows and negative rows per tile
constexpr int BT = 128;                // threads of a tile CTA: 2 x 2 warps
constexpr int BK = 32;                 // depth of one staged slab
constexpr int MERGE_THREADS = 256;
// Row strides of the staged slabs (elements), free of bank conflicts for
// the fragments' reads: along a row of 32 (fp32 36, bf16 40; 1-byte rows
// 48, the least 16-byte multiple past 32), down a column of 64 (72 for
// fp32 and bf16, 80 for 1-byte rows).
template <typename T>
constexpr int ALONG = sizeof(T) == 4   ? BK + 4
                      : sizeof(T) == 2 ? BK + 8
                                       : BK + 16;
constexpr int DOWN = TILE + 8;
template <typename T>
constexpr int DOWN_OF = sizeof(T) == 1 ? TILE + 16 : DOWN;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return (float)x; }

// 1-byte rows are the quantized mode's: each carries an fp32 scale.
template <typename T>
constexpr bool kQuant = sizeof(T) == 1;

// A row element as fp32: dequantized (times its row's scale s) in the
// quantized mode; s is not read else.
template <typename T>
__device__ __forceinline__ float deq(T x, float s) {
  if constexpr (kQuant<T>) {
    return to_f(x) * s;
  } else {
    return to_f(x);
  }
}

// The scale of row `row` of `scale` in the quantized mode, else 1.
template <typename T>
__device__ __forceinline__ float scale_of(const float* __restrict__ scale,
                                          size_t row) {
  if constexpr (kQuant<T>) {
    return scale[row];
  } else {
    return 1.f;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// h · pe for one row, by one warp: a lane-strided FMA chain and an xor
// butterfly (every lane ends with the same bits); s the row's scale in the
// quantized mode.
template <typename T>
__device__ __forceinline__ float row_dot(const float* __restrict__ h,
                                         const T* __restrict__ pe, float s,
                                         int D, int lane) {
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(h[d], deq(pe[d], s), acc);
  return warp_sum(acc);
}

// The logits h_t . ne_j of the [64 tokens x 64 negatives] tile
// (blockIdx.y, blockIdx.x) of sequence blockIdx.z, over D in 3xTF32:
// acc[mi][ni][i] of warp (wm, wn) holds token row 32 wm + 16 mi +
// acc_row(i) and negative column 32 wn + 8 ni + acc_col(i) of the tile.
// Rows past S and M read as zeros. nsc: the negatives' scales [B, M] in
// the quantized mode (the tile's staged in shared memory; null else).
// Ends with a barrier.
template <typename T, bool VEC>
__device__ __forceinline__ void logit_tile(const float* __restrict__ h,
                                           const T* __restrict__ ne,
                                           const float* __restrict__ nsc,
                                           int S, int M, int D,
                                           float (&acc)[2][4][4]) {
  constexpr int HS = ALONG<float>, NS = ALONG<T>;
  __shared__ __align__(16) float hs[2][TILE][HS];
  __shared__ __align__(16) T ns[2][TILE][NS];
  __shared__ float sc[TILE];                // the tile's negative scales
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  const int b = blockIdx.z, t0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const float* hb = h + ((size_t)b * S + t0) * D;
  const T* nb = ne + ((size_t)b * M + j0) * D;
  if constexpr (kQuant<T>) {                // published by the first barrier
    for (int i = threadIdx.x; i < TILE; i += BT)
      sc[i] = j0 + i < M ? nsc[(size_t)b * M + j0 + i] : 0.f;
  }
  const float* scw = &sc[32 * wn];
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
                [&](int k, int c) { return deq(bm[c * NS + k], scw[c]); });
      });
}

// corr_tj from the logit x: NEG_INF for a dead token row, a column past M
// or a collision (n_j == p_t), else x - (ln M + lq_j).
__device__ __forceinline__ float corrected(float x, bool live, int j, int M,
                                           const int64_t* __restrict__ nid,
                                           int64_t pid,
                                           const float* __restrict__ lq,
                                           float log_m) {
  return live && j < M && nid[j] != pid ? x - (log_m + lq[j]) : NEG_INF;
}

// Forward, pass 1: the tile (blockIdx.y, blockIdx.x) of sequence
// blockIdx.z. Per token row t < S: m = max_j corr_tj and l = sum_j
// exp(corr_tj - m) over the valid entries (corr > NEG_INF_THRESHOLD) of the
// tile's 64 columns, into part[b, t, blockIdx.x]; blockIdx.x == 0 also
// writes pos[b, t] = h_t . pe_t.
template <typename T, bool VEC>
__global__ void __launch_bounds__(BT)
fwd_part_kernel(const float* __restrict__ h, const T* __restrict__ pe,
                const T* __restrict__ ne, const float* __restrict__ psc,
                const float* __restrict__ nsc,
                const float* __restrict__ log_q,
                const int64_t* __restrict__ neg_ids,
                const int64_t* __restrict__ pos_ids,
                float2* __restrict__ part, float* __restrict__ pos, int S,
                int M, int D, float log_m, int include_pos) {
  __shared__ float red_m[2][TILE];     // per row, the max of each warp's half
  __shared__ float red_l[2][TILE];     // ... and its sum
  const int tid = threadIdx.x, warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int lane = tid & 31;
  const int b = blockIdx.z, t0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  float acc[2][4][4];
  logit_tile<T, VEC>(h, ne, nsc, S, M, D, acc);
  const float* lq = log_q + (size_t)b * M;
  const int64_t* nid = neg_ids + (size_t)b * M;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 32 * wm + 16 * mi + acc_row(2 * half), t = t0 + r;
      const bool live = t < S;
      const int64_t pid = live ? pos_ids[(size_t)b * S + t] : -2;
      float m = NEG_INF;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = acc[mi][ni][2 * half + e];
          x = corrected(x, live, j0 + 32 * wn + 8 * ni + acc_col(e), M, nid,
                        pid, lq, log_m);
          m = fmaxf(m, x);
        }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if ((lane & 3) == 0) red_m[wn][r] = m;
    }
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 32 * wm + 16 * mi + acc_row(2 * half);
      const float m = fmaxf(red_m[0][r], red_m[1][r]);
      float l = 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[mi][ni][2 * half + e];
          l += x > NEG_INF_THRESHOLD ? expf(x - m) : 0.f;
        }
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if ((lane & 3) == 0) red_l[wn][r] = l;
    }
  __syncthreads();
  const int nt = (M + TILE - 1) / TILE;
  if (tid < TILE && t0 + tid < S)
    part[((size_t)b * S + t0 + tid) * nt + blockIdx.x] =
        make_float2(fmaxf(red_m[0][tid], red_m[1][tid]),
                    red_l[0][tid] + red_l[1][tid]);
  if (blockIdx.x == 0 && include_pos) {
    for (int r = warp; r < min(TILE, S - t0); r += BT / 32) {
      const size_t row = (size_t)b * S + t0 + r;
      const float p = row_dot<T>(h + row * D, pe + row * D,
                                 scale_of<T>(psc, row), D, lane);
      if (lane == 0) pos[row] = p;
    }
  }
}

// Forward, pass 2: token idx = b S + t merges its nt partials in ascending
// tile order (the online logsumexp of `_kernel`), then joins the positive
// as `_kernel`'s `_finish` does (the partial mode: no positive).
__global__ void __launch_bounds__(MERGE_THREADS)
fwd_merge_kernel(const float2* __restrict__ part,
                 const float* __restrict__ pos, float* __restrict__ loss,
                 float* __restrict__ lse_out, int n, int nt,
                 int include_pos) {
  const int idx = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (idx >= n) return;
  const float2* p = part + (size_t)idx * nt;
  float m = NEG_INF, l = 0.f;
  for (int k = 0; k < nt; ++k) {
    const float2 q = p[k];
    const float m_new = fmaxf(m, q.x);
    l = l * expf(m - m_new) + q.y * expf(q.x - m_new);
    m = m_new;
  }
  if (!include_pos) {
    const float lse = logf(fmaxf(l, 1e-30f)) + m;
    loss[idx] = lse;
    lse_out[idx] = lse;
    return;
  }
  const float ps = pos[idx];
  const float m_fin = fmaxf(m, ps);
  const float l_fin = l * expf(m - m_fin) + expf(ps - m_fin);
  const float lse = logf(fmaxf(l_fin, 1e-30f)) + m_fin;
  loss[idx] = lse - ps;
  lse_out[idx] = lse;
}

// ------------------------------------------------------------- backward
// W: the [64 tokens x 64 negatives] tile (blockIdx.y, blockIdx.x) of
// sequence blockIdx.z: w_out[b, t, j] = g_t exp(corr_tj - lse_t), else 0;
// blockIdx.x == 0 also writes cpos[b, t] = g_t (exp(pos_t - lse_t) - 1).
template <typename T, bool VEC>
__global__ void __launch_bounds__(BT)
bwd_w_kernel(const float* __restrict__ grad, const float* __restrict__ h,
             const T* __restrict__ pe, const T* __restrict__ ne,
             const float* __restrict__ psc, const float* __restrict__ nsc,
             const float* __restrict__ log_q,
             const int64_t* __restrict__ neg_ids,
             const int64_t* __restrict__ pos_ids,
             const float* __restrict__ lse, float* __restrict__ w_out,
             float* __restrict__ cpos, int S, int M, int D, int Sp, int Mp,
             float log_m, int include_pos) {
  const int tid = threadIdx.x, warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int b = blockIdx.z, t0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  float acc[2][4][4];
  logit_tile<T, VEC>(h, ne, nsc, S, M, D, acc);
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
          const int c = 32 * wn + 8 * ni + acc_col(e);
          const float corr = corrected(acc[mi][ni][2 * half + e], live,
                                       j0 + c, M, nid, pid, lq, log_m);
          wo[(size_t)r * Mp + c] =
              corr > NEG_INF_THRESHOLD ? gt * expf(corr - ls) : 0.f;
        }
    }
  if (blockIdx.x == 0 && include_pos) {
    const int lane = tid & 31;
    for (int r = warp; r < min(TILE, S - t0); r += BT / 32) {
      const size_t row = (size_t)b * S + t0 + r;
      const float pos = row_dot<T>(h + row * D, pe + row * D,
                                   scale_of<T>(psc, row), D, lane);
      if (lane == 0) cpos[row] = grad[row] * (expf(pos - lse[row]) - 1.f);
    }
  }
}

// dh, dpe: the [64 tokens x 64 columns] tile (blockIdx.y, blockIdx.x) of
// sequence blockIdx.z: dh = W . NE + c pe, dpe = c h, over M ascending
// (rows dequantized in the quantized mode: each slab's 32 negative scales
// staged beside it); the partial mode: dh = W . NE, no dpe.
template <typename T, bool VEC>
__global__ void __launch_bounds__(BT)
bwd_dh_kernel(const float* __restrict__ h, const T* __restrict__ pe,
              const T* __restrict__ ne, const float* __restrict__ psc,
              const float* __restrict__ nsc, const float* __restrict__ w_in,
              const float* __restrict__ cpos, float* __restrict__ dh,
              float* __restrict__ dpe, int S, int M, int D, int Sp, int Mp,
              int include_pos) {
  constexpr int WS = ALONG<float>, NDOWN = DOWN_OF<T>;
  __shared__ __align__(16) float ws[2][TILE][WS];
  __shared__ __align__(16) T ns[2][BK][NDOWN];
  __shared__ float scs[2][BK];              // a slab's negative scales
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
        stage<T, BK, TILE, NDOWN, BT, VEC>(&ns[buf][0][0], nb, D, kk * BK,
                                           M, d0, D);
        if constexpr (kQuant<T>) {
          if (tid < BK) {
            const int j = kk * BK + tid;
            scs[buf][tid] = j < M ? nsc[(size_t)b * M + j] : 0.f;
          }
        }
        cp_async_commit();
      },
      [&](int, int buf) {
        const float* a = &ws[buf][32 * wm][0];
        const T* bm = &ns[buf][0][32 * wn];
        const float* sk = scs[buf];
        product(acc, 0, BK, [&](int r, int k) { return a[r * WS + k]; },
                [&](int k, int c) { return deq(bm[k * NDOWN + c], sk[k]); });
      });
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + 32 * wm + 16 * mi + acc_row(2 * half);
      if (t >= S) continue;
      const size_t row = (size_t)b * S + t;
      const float c = include_pos ? cpos[row] : 0.f;
      const float ps = include_pos ? scale_of<T>(psc, row) : 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = d0 + 32 * wn + 8 * ni + acc_col(e);
          if (d >= D) continue;
          const size_t idx = row * D + d;
          if (include_pos) {
            dh[idx] = acc[mi][ni][2 * half + e] + c * deq(pe[idx], ps);
            dpe[idx] = c * h[idx];
          } else {
            dh[idx] = acc[mi][ni][2 * half + e];
          }
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

// ln of the correction's negative count: `num_neg` (the global M of the
// partial mode) where given (> 0), else M.
float log_num_neg(int M, int num_neg) {
  return (float)log((double)(num_neg > 0 ? num_neg : M));
}

template <typename T, bool VEC>
int fwd(const float* h, const void* pe, const void* ne, const float* psc,
        const float* nsc, const float* log_q, const int64_t* neg_ids,
        const int64_t* pos_ids, float* loss, float* lse, float2* part,
        float* pos, int B, int S, int M, int D, int include_pos, int num_neg,
        cudaStream_t stream) {
  const int nt = (M + TILE - 1) / TILE;
  fwd_part_kernel<T, VEC>
      <<<dim3(nt, (S + TILE - 1) / TILE, B), BT, 0, stream>>>(
          h, static_cast<const T*>(pe), static_cast<const T*>(ne), psc, nsc,
          log_q, neg_ids, pos_ids, part, pos, S, M, D,
          log_num_neg(M, num_neg), include_pos);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int n = B * S;
  fwd_merge_kernel<<<(n + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS,
                     0, stream>>>(part, pos, loss, lse, n, nt, include_pos);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int bwd(const float* g, const float* h, const void* pe, const void* ne,
        const float* psc, const float* nsc, const float* log_q,
        const int64_t* neg_ids, const int64_t* pos_ids, const float* lse,
        float* dh, float* dpe, float* dne, float* dlq, float* w, float* cpos,
        int B, int S, int M, int D, int include_pos, int num_neg,
        cudaStream_t stream) {
  const int Sp = (S + TILE - 1) / TILE * TILE;
  const int Mp = (M + TILE - 1) / TILE * TILE;
  const int Dt = (D + TILE - 1) / TILE;
  const T* pe_t = static_cast<const T*>(pe);
  const T* ne_t = static_cast<const T*>(ne);
  if (S > 0) {
    bwd_w_kernel<T, VEC><<<dim3(Mp / TILE, Sp / TILE, B), BT, 0, stream>>>(
        g, h, pe_t, ne_t, psc, nsc, log_q, neg_ids, pos_ids, lse, w, cpos, S,
        M, D, Sp, Mp, log_num_neg(M, num_neg), include_pos);
    int err = (int)cudaGetLastError();
    if (err) return err;
    bwd_dh_kernel<T, VEC><<<dim3(Dt, Sp / TILE, B), BT, 0, stream>>>(
        h, pe_t, ne_t, psc, nsc, w, cpos, dh, dpe, S, M, D, Sp, Mp,
        include_pos);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  bwd_dne_kernel<VEC><<<dim3(Dt, Mp / TILE, B), BT, 0, stream>>>(
      h, w, dne, dlq, S, M, D, Sp, Mp);
  return (int)cudaGetLastError();
}

// The row type of `rows_kind` (0 = fp32, 1 = bf16, 2 = int8, 3 = fp8-e4m3)
// and `vec`: calls f(T{}, std::integral_constant<bool, vec>{}).
template <typename F>
int by_rows(int rows_kind, int vec, F&& f) {
  using Yes = std::true_type;
  using No = std::false_type;
  switch (rows_kind) {
    case 0:
      return vec ? f(float{}, Yes{}) : f(float{}, No{});
    case 1:
      return vec ? f(__nv_bfloat16{}, Yes{}) : f(__nv_bfloat16{}, No{});
    case 2:
      return vec ? f(int8_t{}, Yes{}) : f(int8_t{}, No{});
    case 3:
      return vec ? f(__nv_fp8_e4m3{}, Yes{}) : f(__nv_fp8_e4m3{}, No{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// All launches are on `stream`; nothing is allocated and nothing waits.
// Each returns cudaGetLastError() after its launches (0 on success).
// Operands are contiguous, with M >= 1: h [B, S, D] fp32; pe [B, S, D] and
// ne [B, M, D] in one row dtype (rows_kind: 0 = fp32, 1 = bf16, and the
// quantized mode's 2 = int8, 3 = fp8-e4m3, whose row scales are psc
// [B, S] and nsc [B, M] fp32, null else); log_q [B, M] fp32; neg_ids
// [B, M] and pos_ids [B, S] int64; g, lse [B, S] fp32. vec = 1 when D is a
// multiple of the 16-byte vector of the row dtype and h, pe and ne are
// 16-byte aligned. include_pos = 0: the partial mode (pe and psc null,
// pos_ids local or -1; loss = lse = the negatives-only lse; the backward
// takes that lse and writes no dpe, which is null). num_neg: the M of
// ln(M·q), 0 for this call's M.

// Writes loss and lse [B, S] fp32: two kernels, the partials, then their
// merge. Workspaces, fp32: part [B, S, ceil(M / 64)] (m, l) pairs, 8-byte
// aligned, and pos [B, S].
extern "C" int sampled_ce_fwd_launch(const float* h, const void* pe,
                                     const void* ne, const float* psc,
                                     const float* nsc, const float* log_q,
                                     const int64_t* neg_ids,
                                     const int64_t* pos_ids, float* loss,
                                     float* lse, float* part, float* pos,
                                     int B, int S, int M, int D,
                                     int rows_kind, int vec, int include_pos,
                                     int num_neg, void* stream) {
  include_pos = include_pos ? 1 : 0;
  // the positive rows and scales: given in the full mode, null in the
  // partial mode (an empty S may pass null either way)
  if (B < 0 || S < 0 || M < 1 || D < 1 || B > 65535 || rows_kind < 0 ||
      rows_kind > 3 || (rows_kind >= 2) != (nsc != nullptr) ||
      (S > 0 && ((include_pos && rows_kind >= 2) != (psc != nullptr) ||
                 (include_pos != 0) != (pe != nullptr))) ||
      num_neg < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  float2* p = reinterpret_cast<float2*>(part);
  return by_rows(rows_kind, vec, [&](auto t, auto v) {
    return fwd<decltype(t), decltype(v)::value>(h, pe, ne, psc, nsc, log_q,
                                                neg_ids, pos_ids, loss, lse,
                                                p, pos, B, S, M, D,
                                                include_pos, num_neg, s);
  });
}

// Writes dh, dpe [B, S, D], dne [B, M, D] and dlq [B, M], all fp32: three
// kernels, W, then dh/dpe and dne/dlq from it. Workspaces, fp32: w
// [B, Sp, Mp] (S and M rounded up to 64) and cpos [B, S].
extern "C" int sampled_ce_bwd_launch(const float* g, const float* h,
                                     const void* pe, const void* ne,
                                     const float* psc, const float* nsc,
                                     const float* log_q,
                                     const int64_t* neg_ids,
                                     const int64_t* pos_ids, const float* lse,
                                     float* dh, float* dpe, float* dne,
                                     float* dlq, float* w, float* cpos, int B,
                                     int S, int M, int D, int rows_kind,
                                     int vec, int include_pos, int num_neg,
                                     void* stream) {
  include_pos = include_pos ? 1 : 0;
  if (B < 0 || S < 0 || M < 1 || D < 1 || B > 65535 || rows_kind < 0 ||
      rows_kind > 3 || (rows_kind >= 2) != (nsc != nullptr) ||
      (S > 0 && ((include_pos && rows_kind >= 2) != (psc != nullptr) ||
                 (include_pos != 0) != (pe != nullptr) ||
                 (include_pos != 0) != (dpe != nullptr))) ||
      num_neg < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return by_rows(rows_kind, vec, [&](auto t, auto v) {
    return bwd<decltype(t), decltype(v)::value>(
        g, h, pe, ne, psc, nsc, log_q, neg_ids, pos_ids, lse, dh, dpe, dne,
        dlq, w, cpos, B, S, M, D, include_pos, num_neg, s);
  });
}
