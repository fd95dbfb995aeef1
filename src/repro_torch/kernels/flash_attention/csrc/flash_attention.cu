// Causal / windowed GQA flash-attention forward for Hopper (sm_90a), plain
// C interface.
//
// Replaces the TPU kernel `kernels/flash_attention/flash_attention.py::
// _kernel` of the JAX package (:25, and its `pallas_call` at :85), and
// computes what the chunked online-softmax path `_flash_fwd` of
// `models/attention.py` (:98-144) computes. Inputs in the model's own
// layout, read with strides and never transposed (the Pallas wrapper's
// three transposes to [B, H, S, hd] are extra copies through device
// memory):
//   q [B, Sq, H, hd], k / v [B, Sk, KV, hd], fp32 or bf16 alike, hd <= 128;
//   query head h reads kv head h / (H / KV).
// Scores are (q * hd^-0.5 in fp32) . k^T, the scale applied to q before
// the dot as the reference does. The mask keeps
//   kj <= qi + q_offset            (causal)
//   kj >  qi + q_offset - window   (when a window is given)
// and sets every other score to NEG_INF = -1e30. The online softmax
// carries (acc, m, l) in fp32 and writes
//   out = acc / max(l, 1e-30)           in q's dtype, [B, Sq, H, hd]
//   lse = m + log(max(l, 1e-30))        fp32, [B, H, Sq]
// (lse views as the reference's [B, KV, G, Sq], since h = kv * G + g).
//
// Design. One CTA of 256 threads per (b, h, block of BQ = 64 query rows),
// grid (Sq / 64, B * H), the last query block first (causal blocks there
// have the most work). The CTA stages its 64 query rows, scaled, in shared
// memory as fp32, then walks kv blocks of BK = 64 keys in ascending
// order; each block's K (transposed, Kt[d][j]) and V are staged as fp32:
// 2 x 64 x 128 x 4 B = 64 KB at hd = 128. Thread (ty, tx) of a 16 x 16
// grid owns query rows 4*ty .. 4*ty + 3: it computes their scores at the
// columns tx + 16*j (j < 4) with fp32 FMAs in ascending d, reduces each
// row's max and sum over the 16 lanes of its half-warp with a xor
// butterfly (every lane ends with the same bits), writes p to shared
// memory, and accumulates p . V for its rows at the output columns
// tx + 16*c (c < HDP / 16) in ascending key order. A query row's acc of up
// to 128 floats is thus spread over 16 threads. expf and logf, and no
// fast math.
//
// Skipping is exact. A CTA visits only the kv blocks in which at least
// one of its rows has an allowed key (a block wholly above the diagonal,
// or wholly before the window, is skipped), unless one of its rows has no
// allowed key at all, in which case it visits every block, as the
// reference does. Why nothing changes: a block whose scores are all
// NEG_INF for a row that has already seen an allowed key leaves m as it
// is, so alpha = 1 and p = exp(-1e30 - m) = 0 in fp32; a row that has
// not yet seen one gets p = 1 from it, which the first allowed key wipes
// with alpha = exp(-1e30 - m) = 0. A row with no allowed key anywhere
// ends, as in the reference, with the mean of V over all keys and
// lse = -1e30 + log(Sk), which is -1e30 in fp32.
//
// No atomics: every output row is written by one CTA in a fixed order of
// operations, so the kernel repeats bit for bit, and a row's result
// depends on its (b, h) and its 64-row block only, never on the batch.
//
// What bounds it. Causal attention at llama3.2-1b's prefill shape (B = 4,
// S = 4096, H = 32, KV = 8, hd = 64) needs about 1.07e9 unmasked scores
// at 4 * hd operations each (the q.k dot and the p.v update, a
// multiply-add counted as two) plus one exp: 2.75e11 operations against
// 0.17 GB of q, k, v, out and lse. It is bound by operations: 0.28 ms at
// the 989 TFLOP/s of bf16 on the tensor cores, the card's rate for its
// bf16 inputs. This kernel runs its products on fp32 FMAs instead, whose
// own floor is 4.1 ms at the 67 TFLOP/s of fp32 outside the tensor cores,
// and it feeds them from shared memory (two shared loads for every four
// FMAs), so the shared-memory pipe, not the FMA rate, sets its pace. The
// tensor cores (wgmma on bf16 tiles, TMA loads, K/V shared across a GQA
// group) are the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                      // query rows per CTA
constexpr int BK = 64;                      // keys per kv block
constexpr int THREADS = 256;                // 16 x 16 threads
constexpr int RPT = 4;                      // query rows per thread
constexpr int CPT = 4;                      // score columns per thread
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(BQ == 16 * RPT && BK == 16 * CPT, "16 x 16 thread grid");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);               // round to nearest even
}

// Shared-memory row strides (floats). Qs and Ps rows are padded so the two
// half-warps of a warp (rows 4 apart) read different banks; Kt rows by one
// so the transposing store of a K row is free of bank conflicts.
template <int HDP> struct Smem {
  static constexpr int QS = HDP + 4;        // Qs [BQ][QS]
  static constexpr int KS = BK + 1;         // Kt [HDP][KS]
  static constexpr int VS = HDP;            // Vs [BK][VS]
  static constexpr int PS = BK + 4;         // Ps [BQ][PS]
  static constexpr int FLOATS = BQ * QS + HDP * KS + BK * VS + BQ * PS;
  static constexpr int BYTES = FLOATS * 4;
};

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int h, int kvh,
                 int hd, float scale, int causal, int has_window, int window,
                 int q_offset) {
  using S = Smem<HDP>;
  constexpr int NC = HDP / 16;              // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Kt = Qs + BQ * S::QS;
  float* Vs = Kt + HDP * S::KS;
  float* Ps = Vs + BK * S::VS;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int kv_head = head / (h / kvh);
  const int64_t q_row = (int64_t)h * hd;    // elements between positions
  const int64_t k_row = (int64_t)kvh * hd;
  const T* qp = q + ((int64_t)b * sq + q0) * q_row + (int64_t)head * hd;
  const T* kp = k + (int64_t)b * sk * k_row + (int64_t)kv_head * hd;
  const T* vp = v + (int64_t)b * sk * k_row + (int64_t)kv_head * hd;

  for (int i = tid; i < BQ * HDP; i += THREADS) {
    const int r = i / HDP, d = i % HDP;
    Qs[r * S::QS + d] = d < hd ? to_f32(qp[r * q_row + d]) * scale : 0.f;
  }

  // The kv blocks this CTA visits (see "Skipping is exact" above). The
  // allowed keys of row qi are lo(qi) .. hi(qi); every thread computes the
  // same range.
  int lo_min = sk, hi_max = -1;
  bool any_empty = false;
  for (int r = 0; r < BQ; ++r) {
    const int qi = q0 + r + q_offset;
    const int hi = causal ? min(sk - 1, qi) : sk - 1;
    const int lo = has_window ? max(0, qi - window + 1) : 0;
    if (lo > hi) {
      any_empty = true;
    } else {
      lo_min = min(lo_min, lo);
      hi_max = max(hi_max, hi);
    }
  }
  const int kb_begin = any_empty ? 0 : lo_min / BK;
  const int kb_end = any_empty ? sk / BK : hi_max / BK + 1;

  float m[RPT], l[RPT], acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();                        // Qs staged / last block done
    for (int i = tid; i < BK * HDP; i += THREADS) {
      const int j = i / HDP, d = i % HDP;
      float kx = 0.f, vx = 0.f;
      if (d < hd) {
        const int64_t off = (int64_t)(k0 + j) * k_row + d;
        kx = to_f32(kp[off]);
        vx = to_f32(vp[off]);
      }
      Kt[d * S::KS + j] = kx;
      Vs[j * S::VS + d] = vx;
    }
    __syncthreads();

    // scores of rows 4*ty + i at columns tx + 16*j, ascending d
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      float a[RPT], bk[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = Qs[(ty * RPT + i) * S::QS + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) bk[j] = Kt[d * S::KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // mask, online softmax update, p into shared memory
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qi = q0 + ty * RPT + i + q_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = (!causal || kj <= qi) &&
                        (!has_window || kj > qi - window);
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        Ps[(ty * RPT + i) * S::PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += p . V, ascending key order
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[RPT], vv[NC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) p[i] = Ps[(ty * RPT + i) * S::PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * S::VS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    const float lc = fmaxf(l[i], 1e-30f);
    T* op = out + ((int64_t)b * sq + q0 + r) * q_row + (int64_t)head * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) op[d] = from_f32<T>(acc[i][c] / lc);
    }
    if (tx == 0)
      lse[((int64_t)b * h + head) * sq + q0 + r] = m[i] + logf(lc);
  }
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int sq, int sk, int h, int kvh, int hd,
                   float scale, int causal, int has_window, int window,
                   int q_offset, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<HDP>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(sq / BQ, b * h);
  flash_fwd_kernel<T, HDP><<<grid, THREADS, Smem<HDP>::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk, h, kvh,
      hd, scale, causal, has_window, window, q_offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per CTA and keys per kv block: Sq and Sk must be multiples of it.
int flash_attention_block() { return BQ; }

int flash_attention_max_hd() { return 128; }

// q [B, Sq, H, hd], k / v [B, Sk, KV, hd], contiguous, fp32 (is_bf16 = 0)
// or bf16 (1) alike; out like q; lse [B, H, Sq] fp32. Returns
// cudaGetLastError() after the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, float* lse, int b, int sq, int sk, int h,
                        int kvh, int hd, float scale, int causal,
                        int has_window, int window, int q_offset, int is_bf16,
                        cudaStream_t stream) {
  cudaError_t err;
  if (is_bf16) {
    err = hd <= 64
        ? launch<__nv_bfloat16, 64>(q, k, v, out, lse, b, sq, sk, h, kvh, hd,
                                    scale, causal, has_window, window,
                                    q_offset, stream)
        : launch<__nv_bfloat16, 128>(q, k, v, out, lse, b, sq, sk, h, kvh,
                                     hd, scale, causal, has_window, window,
                                     q_offset, stream);
  } else {
    err = hd <= 64
        ? launch<float, 64>(q, k, v, out, lse, b, sq, sk, h, kvh, hd, scale,
                            causal, has_window, window, q_offset, stream)
        : launch<float, 128>(q, k, v, out, lse, b, sq, sk, h, kvh, hd, scale,
                             causal, has_window, window, q_offset, stream);
  }
  return static_cast<int>(err);
}

}  // extern "C"
