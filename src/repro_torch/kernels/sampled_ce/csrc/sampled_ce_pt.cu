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
// ratio. The design keeps the [T, M, D] gather and the [T, M] logits out of
// device memory and keeps many row loads in flight:
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
// The backward has no races. The TPU kernel scatters dE with an awaited
// read-modify-write per row, race-free only because a TPU grid runs in
// order; Hopper CTAs run concurrently, and fp32 atomics would make the sum
// depend on launch order. So:
//   (a) `bwd_rows`: one warp per token recomputes the logits, writes dlq,
//       dh and the per-occurrence coefficients coef [T, M+1] (column M is
//       the positive);
//   (b) `dtab`: the host sorts the occurrence ids stably by row id and finds
//       each row's segment; one warp per table row sums coef·h over its
//       occurrences in sorted order and writes the row (zeros for a row
//       never drawn). Every row is written once, by one warp, in a fixed
//       order: the result is bitwise repeatable.

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

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
bwd_rows_kernel(const float* __restrict__ g, const float* __restrict__ h,
                const T* __restrict__ table, const float* __restrict__ log_q,
                const int64_t* __restrict__ neg_ids,
                const int64_t* __restrict__ pos_ids,
                const float* __restrict__ lse_in, float* __restrict__ dh,
                float* __restrict__ dlq, float* __restrict__ coef, int nT,
                int D, int M, float log_m) {
  extern __shared__ float smem[];           // [WARPS][M]: g·w_j per column
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x * WARPS + warp;
  if (t >= nT) return;
  float* cw = smem + (size_t)warp * M;
  const float* hrow = h + (size_t)t * D;
  const int64_t pid = pos_ids[t];
  const T* prow = table + pid * D;
  const float* lq_row = log_q + (size_t)t * M;
  const int64_t* id_row = neg_ids + (size_t)t * M;
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

// One warp per table row v: dE[v] = Σ_o coef[occ_o] · h[token(occ_o)] over
// the occurrences o in [seg[v], seg[v+1]) of the sorted order.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
dtab_kernel(const float* __restrict__ h, const float* __restrict__ coef,
            const int64_t* __restrict__ order, const int64_t* __restrict__ seg,
            float* __restrict__ dtab, int V, int D, int M1) {
  const int lane = threadIdx.x % 32;
  const int64_t v = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= V) return;
  const int64_t o0 = seg[v], o1 = seg[v + 1];
  float* out = dtab + v * D;
  for (int base = lane * VEC; base < D; base += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int64_t o = o0; o < o1; ++o) {
      const int64_t occ = order[o];
      const float c = coef[occ];
      float hv[VEC];
      load<VEC>(h + (occ / M1) * D + base, hv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(c, hv[e], acc[e]);
    }
    store<VEC>(out + base, acc);
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
             float* coef, int nT, int D, int M, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * M * sizeof(float);
  const int err = set_smem((const void*)bwd_rows_kernel<T, VEC>, smem);
  if (err) return err;
  bwd_rows_kernel<T, VEC><<<(nT + WARPS - 1) / WARPS, THREADS, smem, stream>>>(
      g, h, static_cast<const T*>(table), log_q, neg_ids, pos_ids, lse, dh,
      dlq, coef, nT, D, M, log_num_neg(M));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sampled_ce_pt_max_m() { return MAX_M; }

// All launches are on `stream`; nothing is allocated and nothing waits.
// Each returns cudaGetLastError() after its launch (0 on success).
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

extern "C" int sampled_ce_pt_bwd_rows_launch(
    const float* g, const float* h, const void* table, const float* log_q,
    const int64_t* neg_ids, const int64_t* pos_ids, const float* lse,
    float* dh, float* dlq, float* coef, int nT, int D, int M, int table_bf16,
    int vec, void* stream) {
  if (nT < 0 || D < 1 || M < 0 || M > MAX_M) return (int)cudaErrorInvalidValue;
  if (nT == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (table_bf16) {
    return vec ? bwd_rows<__nv_bfloat16, 8>(g, h, table, log_q, neg_ids,
                                            pos_ids, lse, dh, dlq, coef, nT,
                                            D, M, s)
               : bwd_rows<__nv_bfloat16, 1>(g, h, table, log_q, neg_ids,
                                            pos_ids, lse, dh, dlq, coef, nT,
                                            D, M, s);
  }
  return vec ? bwd_rows<float, 4>(g, h, table, log_q, neg_ids, pos_ids, lse,
                                  dh, dlq, coef, nT, D, M, s)
             : bwd_rows<float, 1>(g, h, table, log_q, neg_ids, pos_ids, lse,
                                  dh, dlq, coef, nT, D, M, s);
}

// h [T, D] fp32; coef [T, M+1]; order: occurrence indices (into coef)
// sorted stably by row id; seg [V+1]: row v's occurrences are
// order[seg[v] .. seg[v+1]). Writes every row of dtab [V, D] fp32.
extern "C" int sampled_ce_pt_dtab_launch(const float* h, const float* coef,
                                         const int64_t* order,
                                         const int64_t* seg, float* dtab,
                                         int V, int D, int M, int vec,
                                         void* stream) {
  if (V < 0 || D < 1 || M < 0) return (int)cudaErrorInvalidValue;
  if (V == 0) return 0;
  const dim3 grid((V + WARPS - 1) / WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    dtab_kernel<4><<<grid, THREADS, 0, s>>>(h, coef, order, seg, dtab, V, D,
                                            M + 1);
  } else {
    dtab_kernel<1><<<grid, THREADS, 0, s>>>(h, coef, order, seg, dtab, V, D,
                                            M + 1);
  }
  return (int)cudaGetLastError();
}
