// Per-token sampled-softmax cross-entropy for Hopper (sm_90a), forward and
// backward, plain C interface.
//
// Replaces the TPU kernels `kernels/sampled_ce/per_token.py::_fwd_kernel`
// (`sampled_ce_pt`) and `::_bwd_kernel` (`sampled_ce_pt_bwd`) of the JAX
// package. For token t with hidden row h_t [D] (fp32), positive id p_t and
// M negatives n_tj with proposal log-probs lq_tj, over a class table
// E [V, D] kept in its native dtype (fp32 or bf16):
//   pos    = h_t · E[p_t]
//   corr_j = h_t · E[n_tj] − (ln M + lq_tj),  NEG_INF where n_tj == p_t
//   lse    = logsumexp(pos, corr_j over the columns with corr_j > NEG_INF/2)
//   loss   = lse − pos
// and for an upstream gradient g_t:
//   w_j  = exp(corr_j − lse) on valid columns, else 0;  p_pos = exp(pos − lse)
//   dlq  = −g w_j
//   dh   = g (p_pos − 1) E[p_t] + Σ_j g w_j E[n_tj]
//   dE[v] = Σ over every occurrence of v (as a negative or a positive) of
//           its coefficient (g w_j, or g (p_pos − 1)) times h of its token.
//
// What bounds it on the card: bytes. Each token gathers M + 1 random rows
// of the table (at paper-lm: T = 1024, M = 20, D = 200 fp32, about 17 MB;
// at llama width: M = 64, D = 2048 bf16, about 270 MB) and does 2·(M+1)·D
// FLOPs per token on them — about one FLOP per byte, far below the card's
// ratio; the backward also writes the dense d(table) [V, D] fp32 (8 MB at
// paper-lm, 1.05 GB at llama width, where that write is most of the
// bound). The design keeps the [T, M, D] gather and the [T, M] logits out
// of device memory and keeps many row loads in flight:
//   - one warp per token row, WARPS rows per CTA; lanes split D into
//     16-byte vectors (4 fp32 or 8 bf16, converted to fp32 in registers;
//     a scalar path when D or the pointers do not allow vectors);
//   - negatives go in groups of JG = 8: all lanes issue the 8 rows' loads
//     before their FMAs, so 8 gathers per lane are in flight;
//   - a dot is a lane-partial FMA chain in ascending d, then an xor-butterfly
//     warp sum; the online (m, l) logsumexp folds the groups in ascending j.
//     So a row's bits depend on nothing but the row: not on T, not on its
//     block. That is what makes a train step replay bit-exact.
//   - padding and ragged T / M are masked in the kernel, never padded on
//     the host.
//
// The backward is one C call: a memset of the row counts and four kernels,
// with every scratch array in one workspace, and no host work between
// them. The TPU kernel scatters dE with an awaited read-modify-write per
// row, race-free only because a TPU grid runs in order; Hopper CTAs run
// concurrently, and fp32 atomics would make the sum depend on launch order.
// So each table row is summed by one owner in a fixed order:
//   (a) `bwd_rows_kernel`: one warp per token recomputes the logits with
//       the forward's routines, writes dlq, dh and the per-occurrence
//       coefficients coef [T, M+1] (column M is the positive), and counts
//       each occurrence's row with an integer atomicAdd. It gathers the
//       token's rows twice (logits, then dh); the second gather mostly
//       hits L2. Staging them in shared memory once was measured and not
//       kept: a few µs faster from a cold L2, slower where one row is
//       shared by many tokens (PERF.md §6);
//   (b) `occ_scan_kernel`, one CTA: seg [V+1], the exclusive prefix sum of
//       the counts;
//   (c) `occ_place_kernel`: each occurrence into its row's segment of
//       `order`, at a slot taken by an integer atomicSub on the count — the
//       right occurrences, in an order that can change from run to run;
//   (d) `dtab_kernel`, 8 rows per CTA (rows b, b + G, ..., so that
//       neighbouring hot ids fall to different CTAs), writes every row of
//       dtab once (zeros for a row never drawn) as Σ coef·h over its
//       occurrences in ascending occurrence index:
//       a segment of at most 32 is ranked by its warp with shuffles and
//       summed in one FMA chain per element; a longer one is sorted by the
//       CTA through a bitmap of occurrence indices and cut into
//       p = min(8, ceil(L / 64)) runs of consecutive ranks, one warp each,
//       the runs' sums then added in rank order (p = 1, one chain, up to
//       L = 64), so a hot row's sum runs on up to 8 warps, not one.
//   The atomics are on integers only, and every float sum has an order
//   fixed by the ids alone: the result is bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float NEG_INF_THRESHOLD = 0.5f * NEG_INF;
constexpr int WARPS = 4;                    // token (or table) rows per CTA
constexpr int THREADS = 32 * WARPS;
constexpr int JG = 8;                       // negatives per group
constexpr int MAX_SMEM = 227 * 1024;        // dynamic shared memory per CTA
constexpr int MAX_M = MAX_SMEM / (4 * WARPS);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// VEC consecutive elements starting at p, as fp32. VEC is 1, or the number
// of elements in 16 bytes (4 fp32, 8 bf16) with p 16-byte aligned.
template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
      out[i] = v.x;
      out[i + 1] = v.y;
      out[i + 2] = v.z;
      out[i + 3] = v.w;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p,
                                     float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = __bfloat162float(p[0]);
  } else {
    static_assert(VEC == 8, "bf16 vectors are 8 elements (16 bytes)");
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(b[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  // xor butterfly: every lane ends with the same bits (a + b == b + a).
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// h · E[row], full fp32, the same order for every caller.
template <typename T, int VEC>
__device__ __forceinline__ float row_dot(const float* hrow, const T* erow,
                                         int D, int lane) {
  float acc = 0.f;
  for (int base = lane * VEC; base < D; base += 32 * VEC) {
    float hv[VEC], ev[VEC];
    load<VEC>(hrow + base, hv);
    load<VEC>(erow + base, ev);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc = fmaf(hv[e], ev[e], acc);
  }
  return warp_sum(acc);
}

// Corrected logits of negatives j0 .. j0+JG-1 of token t; NEG_INF for a
// column past M and for a collision with the positive.
template <typename T, int VEC>
__device__ __forceinline__ void group_corr(
    const float* hrow, const T* __restrict__ table,
    const float* __restrict__ lq_row, const int64_t* __restrict__ id_row,
    int64_t pid, int j0, int M, int D, float log_m, int lane,
    float (&corr)[JG]) {
  int64_t rid[JG];
  float acc[JG];
#pragma unroll
  for (int k = 0; k < JG; ++k) {
    rid[k] = (j0 + k < M) ? id_row[j0 + k] : pid;  // dead columns: a real row
    acc[k] = 0.f;
  }
  for (int base = lane * VEC; base < D; base += 32 * VEC) {
    float hv[VEC];
    load<VEC>(hrow + base, hv);
    float ev[JG][VEC];
#pragma unroll
    for (int k = 0; k < JG; ++k) load<VEC>(table + rid[k] * D + base, ev[k]);
#pragma unroll
    for (int k = 0; k < JG; ++k) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[k] = fmaf(hv[e], ev[k][e], acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < JG; ++k) {
    const float dot = warp_sum(acc[k]);
    const bool live = j0 + k < M;
    const float c = live ? dot - (log_m + lq_row[j0 + k]) : NEG_INF;
    corr[k] = (rid[k] == pid) ? NEG_INF : c;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ h, const T* __restrict__ table,
           const float* __restrict__ log_q, const int64_t* __restrict__ neg_ids,
           const int64_t* __restrict__ pos_ids, float* __restrict__ loss,
           float* __restrict__ lse_out, int nT, int D, int M, float log_m) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * WARPS + threadIdx.x / 32;
  if (t >= nT) return;                      // the whole warp leaves together
  const float* hrow = h + (size_t)t * D;
  const int64_t pid = pos_ids[t];
  const float pos = row_dot<T, VEC>(hrow, table + pid * D, D, lane);
  const float* lq_row = log_q + (size_t)t * M;
  const int64_t* id_row = neg_ids + (size_t)t * M;
  float m = NEG_INF, l = 0.f;
  for (int j0 = 0; j0 < M; j0 += JG) {
    float corr[JG];
    group_corr<T, VEC>(hrow, table, lq_row, id_row, pid, j0, M, D, log_m,
                       lane, corr);
    float m_new = m;
#pragma unroll
    for (int k = 0; k < JG; ++k) m_new = fmaxf(m_new, corr[k]);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < JG; ++k) {
      s += corr[k] > NEG_INF_THRESHOLD ? expf(corr[k] - m_new) : 0.f;
    }
    l = l * expf(m - m_new) + s;
    m = m_new;
  }
  const float m_fin = fmaxf(m, pos);
  const float l_fin = l * expf(m - m_fin) + expf(pos - m_fin);
  const float lse = logf(fmaxf(l_fin, 1e-30f)) + m_fin;
  if (lane == 0) {
    loss[t] = lse - pos;
    lse_out[t] = lse;
  }
}

// ------------------------------------------------------------- backward
// One warp per token: the logits again (`row_dot`, `group_corr`: the
// forward's bits), then dlq, dh and the coefficients coef [T, M+1] of the
// d(table) sum (column M: the positive); and the count of every
// occurrence's row, by integer atomics (the counts come out the same in
// any order).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
bwd_rows_kernel(const float* __restrict__ g, const float* __restrict__ h,
                const T* __restrict__ table, const float* __restrict__ log_q,
                const int64_t* __restrict__ neg_ids,
                const int64_t* __restrict__ pos_ids,
                const float* __restrict__ lse_in, float* __restrict__ dh,
                float* __restrict__ dlq, float* __restrict__ coef,
                int* __restrict__ cnt, int nT, int D, int M, float log_m) {
  extern __shared__ float smem[];           // [WARPS][M]: g·w_j per column
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x * WARPS + warp;
  if (t >= nT) return;                      // the whole warp leaves together
  float* cw = smem + (size_t)warp * M;
  const float* hrow = h + (size_t)t * D;
  const int64_t pid = pos_ids[t];
  const T* prow = table + pid * D;
  const float* lq_row = log_q + (size_t)t * M;
  const int64_t* id_row = neg_ids + (size_t)t * M;
  for (int j = lane; j <= M; j += 32)
    atomicAdd(cnt + (j < M ? id_row[j] : pid), 1);
  const float gt = g[t], lse = lse_in[t];
  const float pos = row_dot<T, VEC>(hrow, prow, D, lane);
  const float cpos = gt * (expf(pos - lse) - 1.f);
  for (int j0 = 0; j0 < M; j0 += JG) {
    float corr[JG];
    group_corr<T, VEC>(hrow, table, lq_row, id_row, pid, j0, M, D, log_m,
                       lane, corr);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < JG; ++k) {
        const int j = j0 + k;
        if (j < M) {
          const float w =
              corr[k] > NEG_INF_THRESHOLD ? expf(corr[k] - lse) : 0.f;
          const float c = gt * w;
          cw[j] = c;
          dlq[(size_t)t * M + j] = -c;
          coef[(size_t)t * (M + 1) + j] = c;
        }
      }
    }
  }
  if (lane == 0) coef[(size_t)t * (M + 1) + M] = cpos;
  __syncwarp();
  // dh: positive first, then the negatives in ascending j.
  for (int base = lane * VEC; base < D; base += 32 * VEC) {
    float acc[VEC], ev[VEC];
    load<VEC>(prow + base, ev);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = cpos * ev[e];
    for (int j0 = 0; j0 < M; j0 += JG) {
      float er[JG][VEC];
      float c[JG];
#pragma unroll
      for (int k = 0; k < JG; ++k) {
        const bool live = j0 + k < M;
        c[k] = live ? cw[j0 + k] : 0.f;
        const int64_t rid = live ? id_row[j0 + k] : pid;
        load<VEC>(table + rid * D + base, er[k]);
      }
#pragma unroll
      for (int k = 0; k < JG; ++k) {
        if (j0 + k < M) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(c[k], er[k][e], acc[e]);
        }
      }
    }
    store<VEC>(dh + (size_t)t * D + base, acc);
  }
}

constexpr int SCAN_THREADS = 1024;

// Exclusive scan of a block's ints (every thread gets its prefix); `total`
// gets the sum. `scratch`: NW ints of shared memory.
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int x, int* scratch,
                                                    int* total) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = x;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, s);
    if (lane >= s) inc += y;
  }
  __syncthreads();                          // scratch may be in use
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NW ? scratch[lane] : 0;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, s);
      if (lane >= s) w += y;
    }
    if (lane < NW) scratch[lane] = w;       // inclusive warp totals
  }
  __syncthreads();
  *total = scratch[NW - 1];
  return inc - x + (warp > 0 ? scratch[warp - 1] : 0);
}

// One block: seg [V+1], the exclusive prefix sum of the row counts; each
// thread scans a contiguous run of rows.
__global__ void __launch_bounds__(SCAN_THREADS)
occ_scan_kernel(const int* __restrict__ cnt, int* __restrict__ seg, int V) {
  __shared__ int scratch[SCAN_THREADS / 32];
  const int per = (V + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(V, (int)threadIdx.x * per), hi = min(V, lo + per);
  int run = 0;
  for (int v = lo; v < hi; ++v) run += cnt[v];
  int total;
  run = block_exclusive_scan<SCAN_THREADS>(run, scratch, &total);
  for (int v = lo; v < hi; ++v) {
    seg[v] = run;
    run += cnt[v];
  }
  if (threadIdx.x == 0) seg[V] = total;
}

// Each occurrence o = t·(M+1) + j (j = M: the positive) into its row's
// segment of `order`, at a slot taken by an integer atomic: the segment
// holds the right occurrences in an order that may change from run to run;
// `dtab_kernel` sums them in ascending o.
__global__ void __launch_bounds__(THREADS)
occ_place_kernel(const int64_t* __restrict__ neg_ids,
                 const int64_t* __restrict__ pos_ids, int* __restrict__ cnt,
                 const int* __restrict__ seg, int* __restrict__ order,
                 int nocc, int M) {
  const int o = blockIdx.x * THREADS + threadIdx.x;
  if (o >= nocc) return;
  const int t = o / (M + 1), j = o - t * (M + 1);
  const int64_t v = j < M ? neg_ids[(size_t)t * M + j] : pos_ids[t];
  order[seg[v] + atomicSub(cnt + v, 1) - 1] = o;
}

constexpr int DT_WARPS = 8;                 // table rows per dtab block
constexpr int DT_THREADS = 32 * DT_WARPS;
constexpr int SHORT = 32;                   // a warp sorts a segment this long
constexpr int PIECE = 64;                   // ranks per warp of a long segment
constexpr int BM_WORDS = 4096;              // the bitmap window: 131 072 bits

// acc += Σ coef[o] · h[o / M1][base ..] over o = occ[p], p in [p0, p1), in
// ascending p: one FMA chain per element.
template <int VEC>
__device__ __forceinline__ void sum_occurrences(
    const int* occ, int p0, int p1, const float* __restrict__ coef,
    const float* __restrict__ h, int D, int M1, int base, float (&acc)[VEC]) {
  for (int p = p0; p < p1; ++p) {
    const int o = occ[p];
    const float c = coef[o];
    float hv[VEC];
    load<VEC>(h + (size_t)(o / M1) * D + base, hv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = fmaf(c, hv[e], acc[e]);
  }
}

// d(table): row v = Σ coef[o] · h[o / (M+1)] over its occurrences o in
// ascending o; zeros for a row never drawn. Block b takes the DT_WARPS rows
// b, b + G, b + 2G, ... (G blocks), so that the hottest rows of a Zipf
// vocabulary, whose ids are neighbours, fall to different blocks.
// A segment of at most SHORT: its warp ranks the occurrences with
// shuffles and sums them in one FMA chain per element. A longer one: the
// block sorts it through a bitmap of occurrence indices (integer atomicOr,
// then a prefix of popcounts), into `sorted`; then min(DT_WARPS,
// ceil(L / PIECE)) warps each sum a run of consecutive ranks and the runs
// are added in rank order. Each row is written once, in
// an order fixed by its length alone: bitwise repeatable.
template <int VEC>
__global__ void __launch_bounds__(DT_THREADS)
dtab_kernel(const float* __restrict__ h, const float* __restrict__ coef,
            const int* __restrict__ order, const int* __restrict__ seg,
            int* __restrict__ sorted, float* __restrict__ dtab, int V, int D,
            int M1, int nocc) {
  __shared__ int srt[DT_WARPS][SHORT];
  __shared__ unsigned bm[BM_WORDS];
  __shared__ int scratch[DT_WARPS];
  __shared__ __align__(16) float part[DT_WARPS][32 * VEC];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tid = threadIdx.x;
  {
    const int v = blockIdx.x + warp * gridDim.x;
    const int o0 = v < V ? seg[v] : 0;
    const int len = v < V ? seg[v + 1] - o0 : SHORT + 1;
    if (len <= SHORT) {
      const int o = lane < len ? order[o0 + lane] : 0x7fffffff;
      int rank = 0;
      for (int k = 0; k < len; ++k)
        rank += __shfl_sync(0xffffffffu, o, k) < o;
      if (lane < len) srt[warp][rank] = o;
      __syncwarp();
      float* out = dtab + (size_t)v * D;
      for (int base = lane * VEC; base < D; base += 32 * VEC) {
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
        sum_occurrences<VEC>(srt[warp], 0, len, coef, h, D, M1, base, acc);
        store<VEC>(out + base, acc);
      }
    }
  }
  for (int w = 0; w < DT_WARPS; ++w) {      // the long rows
    const int v = blockIdx.x + w * gridDim.x;
    if (v >= V) break;                      // the same in every thread
    const int o0 = seg[v], len = seg[v + 1] - o0;
    if (len <= SHORT) continue;             // the same in every thread
    int done = 0;                           // ranks placed in `sorted`
    for (int win = 0; win < nocc; win += 32 * BM_WORDS) {
      const int words = min(BM_WORDS, (nocc - win + 31) / 32);
      __syncthreads();
      for (int i = tid; i < words; i += DT_THREADS) bm[i] = 0u;
      __syncthreads();
      for (int i = tid; i < len; i += DT_THREADS) {
        const int o = order[o0 + i] - win;
        if (o >= 0 && o < 32 * words) atomicOr(bm + (o >> 5), 1u << (o & 31));
      }
      __syncthreads();
      const int per = (words + DT_THREADS - 1) / DT_THREADS;
      const int w0 = min(words, tid * per), w1 = min(words, w0 + per);
      int mine = 0;
      for (int i = w0; i < w1; ++i) mine += __popc(bm[i]);
      int total;
      int r = done + block_exclusive_scan<DT_THREADS>(mine, scratch, &total);
      for (int i = w0; i < w1; ++i) {
        for (unsigned bits = bm[i]; bits; bits &= bits - 1)
          sorted[o0 + r++] = win + 32 * i + __ffs(bits) - 1;
      }
      done += total;
    }
    __syncthreads();                        // `sorted` written, in the block
    const int pieces = min(DT_WARPS, (len + PIECE - 1) / PIECE);
    const int run = (len + pieces - 1) / pieces;
    const int r0 = warp * run, r1 = min(len, r0 + run);
    for (int db = 0; db < D; db += 32 * VEC) {
      if (warp < pieces) {
        const int base = db + lane * VEC;
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
        if (base < D) {
          sum_occurrences<VEC>(sorted + o0, r0, r1, coef, h, D, M1, base,
                               acc);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) part[warp][lane * VEC + e] = acc[e];
      }
      __syncthreads();
      if (tid < 32 * VEC && db + tid < D) {
        float s = part[0][tid];
        for (int k = 1; k < pieces; ++k) s += part[k][tid];
        dtab[(size_t)v * D + db + tid] = s;
      }
      __syncthreads();
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

float log_num_neg(int M) { return (float)log((double)(M > 0 ? M : 1)); }

template <typename T, int VEC>
int fwd(const float* h, const void* table, const float* log_q,
        const int64_t* neg_ids, const int64_t* pos_ids, float* loss,
        float* lse, int nT, int D, int M, cudaStream_t stream) {
  fwd_kernel<T, VEC><<<(nT + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      h, static_cast<const T*>(table), log_q, neg_ids, pos_ids, loss, lse, nT,
      D, M, log_num_neg(M));
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int bwd_rows(const float* g, const float* h, const void* table,
             const float* log_q, const int64_t* neg_ids,
             const int64_t* pos_ids, const float* lse, float* dh, float* dlq,
             float* coef, int* cnt, int nT, int D, int M,
             cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * M * sizeof(float);
  const int err = set_smem((const void*)bwd_rows_kernel<T, VEC>, smem);
  if (err) return err;
  bwd_rows_kernel<T, VEC><<<(nT + WARPS - 1) / WARPS, THREADS, smem, stream>>>(
      g, h, static_cast<const T*>(table), log_q, neg_ids, pos_ids, lse, dh,
      dlq, coef, cnt, nT, D, M, log_num_neg(M));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sampled_ce_pt_max_m() { return MAX_M; }

// All launches are on `stream`; nothing is allocated and nothing waits.
// Returns cudaGetLastError() after the launches (0 on success).
// table_bf16: 0 = fp32 table, 1 = bf16 table. vec: 1 = 16-byte vector
// loads (D a multiple of 4 (fp32) or 8 (bf16) and 16-byte aligned rows).
extern "C" int sampled_ce_pt_fwd_launch(const float* h, const void* table,
                                        const float* log_q,
                                        const int64_t* neg_ids,
                                        const int64_t* pos_ids, float* loss,
                                        float* lse, int nT, int D, int M,
                                        int table_bf16, int vec,
                                        void* stream) {
  if (nT < 0 || D < 1 || M < 0 || M > MAX_M) return (int)cudaErrorInvalidValue;
  if (nT == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (table_bf16) {
    return vec ? fwd<__nv_bfloat16, 8>(h, table, log_q, neg_ids, pos_ids,
                                       loss, lse, nT, D, M, s)
               : fwd<__nv_bfloat16, 1>(h, table, log_q, neg_ids, pos_ids,
                                       loss, lse, nT, D, M, s);
  }
  return vec ? fwd<float, 4>(h, table, log_q, neg_ids, pos_ids, loss, lse, nT,
                             D, M, s)
             : fwd<float, 1>(h, table, log_q, neg_ids, pos_ids, loss, lse, nT,
                             D, M, s);
}

// The backward in one call: a memset and four kernels on `stream`, nothing
// allocated, nothing waited for. ws: 4 * (3 * T(M+1) + 2 * V + 1) bytes,
// 4-byte aligned: coef [T(M+1)] fp32, the row counts cnt [V], the segment
// offsets seg [V+1], the placed occurrences order [T(M+1)] and the sorted
// long segments sorted [T(M+1)], int32. table_bf16: 0 = fp32 table, 1 =
// bf16. vec: 16-byte vectors over h, the table and dh. vec_tab: 16-byte
// vectors over h and dtab (D % 4 == 0, aligned). Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int sampled_ce_pt_bwd_launch(
    const float* g, const float* h, const void* table, const float* log_q,
    const int64_t* neg_ids, const int64_t* pos_ids, const float* lse,
    float* dh, float* dlq, float* dtab, void* ws, int nT, int D, int M,
    int V, int table_bf16, int vec, int vec_tab, void* stream) {
  const long long nocc = (long long)nT * (M + 1);
  if (nT < 0 || D < 1 || M < 0 || M > MAX_M || V < 1 || nocc >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (nT == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  float* coef = static_cast<float*>(ws);
  int* cnt = reinterpret_cast<int*>(coef + nocc);
  int* seg = cnt + V;
  int* order = seg + V + 1;
  int* sorted = order + nocc;
  cudaError_t e = cudaMemsetAsync(cnt, 0, (size_t)V * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  int err;
  if (table_bf16) {
    err = vec ? bwd_rows<__nv_bfloat16, 8>(g, h, table, log_q, neg_ids,
                                           pos_ids, lse, dh, dlq, coef, cnt,
                                           nT, D, M, s)
              : bwd_rows<__nv_bfloat16, 1>(g, h, table, log_q, neg_ids,
                                           pos_ids, lse, dh, dlq, coef, cnt,
                                           nT, D, M, s);
  } else {
    err = vec ? bwd_rows<float, 4>(g, h, table, log_q, neg_ids, pos_ids, lse,
                                   dh, dlq, coef, cnt, nT, D, M, s)
              : bwd_rows<float, 1>(g, h, table, log_q, neg_ids, pos_ids, lse,
                                   dh, dlq, coef, cnt, nT, D, M, s);
  }
  if (err) return err;
  occ_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(cnt, seg, V);
  occ_place_kernel<<<(unsigned)((nocc + THREADS - 1) / THREADS), THREADS, 0,
                     s>>>(neg_ids, pos_ids, cnt, seg, order, (int)nocc, M);
  const dim3 grid((V + DT_WARPS - 1) / DT_WARPS);
  if (vec_tab) {
    dtab_kernel<4><<<grid, DT_THREADS, 0, s>>>(h, coef, order, seg, sorted,
                                               dtab, V, D, M + 1, (int)nocc);
  } else {
    dtab_kernel<1><<<grid, DT_THREADS, 0, s>>>(h, coef, order, seg, sorted,
                                               dtab, V, D, M + 1, (int)nocc);
  }
  return (int)cudaGetLastError();
}
