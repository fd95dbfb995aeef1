// Shared-negative sampled-softmax cross-entropy for Hopper (sm_90a),
// forward and backward, plain C interface.
//
// Replaces the TPU kernels of the JAX package's
// `kernels/sampled_ce/sampled_ce.py`: `_kernel` (`sampled_ce`) and
// `_bwd_dh_kernel` / `_bwd_dne_kernel` (`sampled_ce_bwd`), which the
// reference vmaps over the batch. Here the batch is the grid's y axis.
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
// 4.3 GFLOP against ~50 MB of inputs, about 85 FLOP per byte — above the
// card's fp32 ratio (67 TFLOP/s over 3.35 TB/s = 20), so the bound is the
// fp32 FMA rate, and the backward's four products (17 GFLOP) likewise.
// This first version is right and simple: CUDA-core fp32 FMA, no tensor
// cores and no TF32 (so it holds 1e-4 against the plain version), and no
// split of M at small S, which leaves most SMs idle at S = 256
// (S/64 · B = 16 CTAs for the forward). wgmma on bf16 rows, TMA rings and
// an M split are later work.
//
// Design:
//   - 256 threads compute a 64 × 64 logit tile (token rows × negative
//     rows) as a shared-memory-tiled FMA product over D in 32-wide chunks;
//     each thread owns a 4 × 4 micro-tile (rows ty + 16 i, columns
//     tx + 16 j) and sums in ascending d;
//   - the forward folds each tile into a per-row online logsumexp (row max
//     and sum by xor-shuffles inside the 16 lanes that share a row), drops
//     entries at or below NEG_INF_THRESHOLD as `_kernel` does, and joins
//     the positive at the end;
//   - `dh` owns a block of 64 tokens, recomputes w tile by tile, and adds
//     w · ne into its own dh rows (a read-modify-write of rows no other CTA
//     touches), then applies g and the positive terms and writes dpe;
//   - `dne` owns a block of 64 negatives, walks the sequence's token blocks
//     in ascending order, and adds (g·w)ᵀ · h into its own dne rows and
//     −Σ g·w into its dlq entries.
// Every output row has exactly one owner CTA, which walks its loops in a
// fixed order, and every sum runs in a fixed order: no atomics, so the
// backward repeats bit for bit. Ragged S, M and D are masked in the
// kernels (zero-filled loads, masked entries, unwritten rows); nothing is
// padded on the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// Shared memory of one CTA. The logit product's operand chunks (a, b) and
// the accumulation's row chunk (x) are never live at once.
struct Smem {
  union {
    struct {
      float a[DK][PAD];                // token rows, transposed: a[k][row]
      float b[DK][PAD];                // negative rows, transposed
    } prod;
    float x[TILE][PAD];                // x[k][col]: rows being accumulated
  } u;
  float p[TILE][PAD];                  // coefficients p[out row][k]
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
      sm.u.prod.a[k][r] = (r < na && d < D) ? A[(size_t)r * D + d] : 0.f;
      sm.u.prod.b[k][r] = (r < nb && d < D) ? to_f(B[(size_t)r * D + d])
                                            : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < DK; ++k) {
      float av[MICRO], bv[MICRO];
#pragma unroll
      for (int i = 0; i < MICRO; ++i) av[i] = sm.u.prod.a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < MICRO; ++j) bv[j] = sm.u.prod.b[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int j = 0; j < MICRO; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// out[r, :] (+)= Σ_k sm.p[r][k] · X[k, :] for r < n_out, k < TILE, with X
// row-major [nx, D] (T), rows past nx read as zeros (sm.p must be 0 there
// or finite). `first`: out is written, not read. Sums in ascending k after
// the previous value: a fixed order. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void accumulate_rows(float* __restrict__ out,
                                                int n_out,
                                                const T* __restrict__ X,
                                                int nx, int D, bool first,
                                                Smem& sm) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int c0 = 0; c0 < D; c0 += TILE) {
    for (int idx = tid; idx < TILE * TILE; idx += THREADS) {
      const int k = idx / TILE, c = idx % TILE, d = c0 + c;
      sm.u.x[k][c] = (k < nx && d < D) ? to_f(X[(size_t)k * D + d]) : 0.f;
    }
    __syncthreads();
    float acc[MICRO][MICRO];
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < MICRO; ++j) {
        const int d = c0 + tx + 16 * j;
        acc[i][j] = (!first && r < n_out && d < D) ? out[(size_t)r * D + d]
                                                   : 0.f;
      }
    }
#pragma unroll 8
    for (int k = 0; k < TILE; ++k) {
      float pv[MICRO], xv[MICRO];
#pragma unroll
      for (int i = 0; i < MICRO; ++i) pv[i] = sm.p[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < MICRO; ++j) xv[j] = sm.u.x[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int j = 0; j < MICRO; ++j)
          acc[i][j] = fmaf(pv[i], xv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < MICRO; ++j) {
        const int d = c0 + tx + 16 * j;
        if (r < n_out && d < D) out[(size_t)r * D + d] = acc[i][j];
      }
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dh_kernel(const float* __restrict__ g, const float* __restrict__ h,
              const T* __restrict__ pe, const T* __restrict__ ne,
              const float* __restrict__ log_q,
              const int64_t* __restrict__ neg_ids,
              const int64_t* __restrict__ pos_ids,
              const float* __restrict__ lse_in, float* __restrict__ dh,
              float* __restrict__ dpe, int S, int M, int D, float log_m) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y, t0 = blockIdx.x * TILE;
  const int nh = min(TILE, S - t0);
  const size_t row0 = (size_t)b * S + t0;
  const float* hb = h + row0 * D;
  const float* lq = log_q + (size_t)b * M;
  const int64_t* nid = neg_ids + (size_t)b * M;
  int64_t pid[MICRO];
  float lse[MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int r = ty + 16 * i;
    pid[i] = r < nh ? pos_ids[row0 + r] : -2;
    lse[i] = r < nh ? lse_in[row0 + r] : 0.f;
  }
  // Σ_j w_tj ne_j into the CTA's own dh rows, negative block by block.
  for (int j0 = 0; j0 < M; j0 += TILE) {
    float acc[MICRO][MICRO];
    const int nn = min(TILE, M - j0);
    const T* nb = ne + ((size_t)b * M + j0) * D;
    logit_tile<T>(hb, nh, nb, nn, D, sm, acc);
    correct_tile(acc, lq, nid, j0, M, log_m, pid);
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < MICRO; ++j) {
        const bool valid = r < nh && acc[i][j] > NEG_INF_THRESHOLD;
        sm.p[r][tx + 16 * j] = valid ? expf(acc[i][j] - lse[i]) : 0.f;
      }
    }
    __syncthreads();
    accumulate_rows<T>(dh + row0 * D, nh, nb, nn, D, j0 == 0, sm);
  }
  // The positive terms: one warp per row, in place over the sum above.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < nh; r += THREADS / 32) {
    const size_t row = row0 + r;
    const float* hr = h + row * D;
    const T* per = pe + row * D;
    const float c = expf(row_dot<T>(hr, per, D, lane) - lse_in[row]) - 1.f;
    const float gr = g[row];
    for (int d = lane; d < D; d += 32) {
      dh[row * D + d] = gr * (dh[row * D + d] + c * to_f(per[d]));
      dpe[row * D + d] = gr * c * hr[d];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dne_kernel(const float* __restrict__ g, const float* __restrict__ h,
               const T* __restrict__ ne, const float* __restrict__ log_q,
               const int64_t* __restrict__ neg_ids,
               const int64_t* __restrict__ pos_ids,
               const float* __restrict__ lse_in, float* __restrict__ dne,
               float* __restrict__ dlq, int S, int M, int D, float log_m) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y, j0 = blockIdx.x * TILE;
  const int nn = min(TILE, M - j0);
  const T* nb = ne + ((size_t)b * M + j0) * D;
  const float* lq = log_q + (size_t)b * M;
  const int64_t* nid = neg_ids + (size_t)b * M;
  float* out = dne + ((size_t)b * M + j0) * D;
  float lq_acc = 0.f;                  // thread c < TILE: column c's −Σ g·w
  for (int t0 = 0; t0 < S; t0 += TILE) {
    const int nh = min(TILE, S - t0);
    const size_t row0 = (size_t)b * S + t0;
    int64_t pid[MICRO];
    float lse[MICRO], gt[MICRO];
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int r = ty + 16 * i;
      pid[i] = r < nh ? pos_ids[row0 + r] : -2;
      lse[i] = r < nh ? lse_in[row0 + r] : 0.f;
      gt[i] = r < nh ? g[row0 + r] : 0.f;
    }
    float acc[MICRO][MICRO];
    logit_tile<T>(h + row0 * D, nh, nb, nn, D, sm, acc);
    correct_tile(acc, lq, nid, j0, M, log_m, pid);
    // p[negative][token] = g_t w_tj: the transpose of the tile.
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < MICRO; ++j) {
        const bool valid = r < nh && acc[i][j] > NEG_INF_THRESHOLD;
        sm.p[tx + 16 * j][r] = valid ? gt[i] * expf(acc[i][j] - lse[i]) : 0.f;
      }
    }
    __syncthreads();
    if (tid < TILE) {
      float s = 0.f;
      for (int r = 0; r < TILE; ++r) s += sm.p[tid][r];
      lq_acc += -s;
    }
    accumulate_rows<float>(out, nn, h + row0 * D, nh, D, t0 == 0, sm);
  }
  if (S == 0) {                        // no token: the gradients are zero
    for (int idx = tid; idx < nn * D; idx += THREADS) out[idx] = 0.f;
  }
  if (tid < nn) dlq[(size_t)b * M + j0 + tid] = lq_acc;
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

template <typename T>
int bwd(const float* g, const float* h, const void* pe, const void* ne,
        const float* log_q, const int64_t* neg_ids, const int64_t* pos_ids,
        const float* lse, float* dh, float* dpe, float* dne, float* dlq,
        int B, int S, int M, int D, cudaStream_t stream) {
  const float log_m = log_num_neg(M);
  if (S > 0) {
    const dim3 grid((S + TILE - 1) / TILE, B);
    bwd_dh_kernel<T><<<grid, THREADS, 0, stream>>>(
        g, h, static_cast<const T*>(pe), static_cast<const T*>(ne), log_q,
        neg_ids, pos_ids, lse, dh, dpe, S, M, D, log_m);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const dim3 grid((M + TILE - 1) / TILE, B);
  bwd_dne_kernel<T><<<grid, THREADS, 0, stream>>>(
      g, h, static_cast<const T*>(ne), log_q, neg_ids, pos_ids, lse, dne, dlq,
      S, M, D, log_m);
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

// Writes dh, dpe [B, S, D], dne [B, M, D] and dlq [B, M], all fp32: two
// kernels, `dh` (token blocks) then `dne` (negative blocks).
extern "C" int sampled_ce_bwd_launch(const float* g, const float* h,
                                     const void* pe, const void* ne,
                                     const float* log_q,
                                     const int64_t* neg_ids,
                                     const int64_t* pos_ids, const float* lse,
                                     float* dh, float* dpe, float* dne,
                                     float* dlq, int B, int S, int M, int D,
                                     int rows_bf16, void* stream) {
  if (B < 0 || S < 0 || M < 1 || D < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return rows_bf16
             ? bwd<__nv_bfloat16>(g, h, pe, ne, log_q, neg_ids, pos_ids, lse,
                                  dh, dpe, dne, dlq, B, S, M, D, s)
             : bwd<float>(g, h, pe, ne, log_q, neg_ids, pos_ids, lse, dh, dpe,
                          dne, dlq, B, S, M, D, s);
}
