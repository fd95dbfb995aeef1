// Backward of the MIDX proposal tables for Hopper (sm_90a), plain C
// interface.
//
// It replaces no TPU kernel. The JAX package's backward of the tables
// (`kernels/midx_probs/ops.py::_tables_bwd` and `_tables_q_bwd`) recomputes
// the forward through the jnp oracle and lets XLA differentiate it, fused
// into the training step. Eager PyTorch has no such fusion: the same
// recompute is a dozen host-issued ops on top of the forward kernel, so the
// port runs the closed form of that VJP here instead, from the forward's
// own outputs. Per query row t, with the cotangents g1, g2, g3 [T, K] of
// s1, s2, logψ and g4 [T] of lse (`kernels/midx_probs/ref.py::
// midx_probs_bwd_ref` is the same closed form in torch ops):
//   p1  = exp(s1 + logψ − lse),  ds1 = g1 + g4·p1,  a = g3 + g4·p1
//   c2  = max_k s2,  e = exp(s2 − c2),  ψ[k1] = Σ_k2 C[k1, k2]·e[k2]
//   r   = a / ψ, 0 where ψ < 1e-30 (the gradient of the forward's
//         max(ψ, 1e-30): an unused stage-1 codeword, a zero row of C)
//   ds2 = g2 + e ⊙ (r·C) + [s2 = c2]·(Σ_{ψ < 1e-30} a) / #[s2 = c2]
//   dz  = RQ: ds1·C1 + ds2·C2 (two K-long sums, added), PQ: [ds1·C1 | ds2·C2]
// The last term of ds2 is the shift's path: logψ = log(max(ψ, 1e-30)) + c2
// depends on c2 directly, and through e; the two cancel exactly where ψ is
// at or above the floor, and a floored row keeps the direct one, which the
// max sends to its argmax (split evenly between ties, as torch's amax and
// jnp.max do). ψ is recomputed from s2 with the forward kernel's own FMA
// chain, so it is the forward's ψ bit for bit. In the quantized mode
// (int8 / fp8-e4m3 codebooks, [K] fp32 scales) ds1 and ds2 are multiplied
// by their scales before the product, and the codebooks are converted to
// fp32 as they are staged, as the forward's partials do.
//
// What bounds it on the card. At paper-lm's training step (T = 1024,
// D = 200, K = 32) it reads six [T, K] fp32 tensors (s1, s2, logψ and
// their cotangents) and writes dz [T, D]: ~1.7 MB, ~0.5 µs at 3.35 TB/s;
// it does ~30 MFLOP, most of it dz's products (~0.45 µs at 67 TFLOP/s).
// At decode (T = 4, D = 2048, K = 64) it reads both codebooks, 1 MB. So
// at the shapes the port runs it is bound by its launch and the host's
// issue of it, and by bytes well above them.
// Design: one launch, no workspace. CTA (i, j) owns rows 16i.. and the
// 64-column slice j of the codeword width: it loads its slice of both
// codebooks into registers first (in flight while it works), stages the
// counts in shared memory, derives ds1 and ds2 of its rows (a warp a row,
// lane l owning codewords l and l + 32) into shared memory, then reuses
// the counts' shared memory for the codebook slice and writes its block of
// dz. Each CTA of a row block derives the same ds (K² FMAs a row, cheap
// beside the launch) rather than a second launch handing them over. So a
// decode wave's codebook reads spread over ceil(Dc / 64) CTAs, as the
// forward's do.
// Determinism. No atomics: every output element has one owner, and every
// sum is a fixed chain (ψ and r·C in ascending k, dz in ascending k, the
// two books' sums added last). A row's outputs depend on its own inputs
// alone, whatever T is, so batched == solo and replays are bitwise.
// ds1 and ds2 are written out (by the slice-0 CTAs) only when the caller
// asks, for d(codebooks) = dsᵀ·z, a product the reference leaves to XLA
// outside any kernel and the wrapper leaves to torch.matmul.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 64;                    // largest codebook size
constexpr int DS = 64;                      // columns of one slice
constexpr int TR = 16;                      // query rows of a CTA
constexpr int THREADS = 256;                // 8 warps of 2 rows
constexpr int WARPS = THREADS / 32;
constexpr int V4 = DS / 4;                  // float4 columns of a slice row
constexpr int CNT_LOADS = KMAX * KMAX / THREADS;
constexpr int CB_LOADS = 2 * KMAX * DS / THREADS;
static_assert(KMAX * (KMAX + 1) <= 2 * KMAX * DS,
              "the counts fit the codebook slices' shared memory");
static_assert(TR * V4 == THREADS, "a thread a (row, float4 column) of dz");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return (float)x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// Rows blockIdx.x·TR.. of dz, over columns blockIdx.y·DS.. of each half
// (PQ) or of the whole row (RQ). C: the codebooks' element type. sc1 and
// sc2: the [K] scales in the quantized mode, null else. ds1_out and
// ds2_out: null, or [T, K] for d(codebooks).
template <typename C>
__global__ void __launch_bounds__(THREADS)
midx_bwd_kernel(const float* __restrict__ s1, const float* __restrict__ s2,
                const float* __restrict__ lpsi, const float* __restrict__ lse,
                const float* __restrict__ g1, const float* __restrict__ g2,
                const float* __restrict__ g3, const float* __restrict__ g4,
                const C* __restrict__ cb1, const C* __restrict__ cb2,
                const float* __restrict__ counts,
                const float* __restrict__ sc1, const float* __restrict__ sc2,
                float* __restrict__ dz, float* __restrict__ ds1_out,
                float* __restrict__ ds2_out, int T, int D, int K, int split,
                int vec) {
  // the counts [KMAX][KMAX + 1] first, then the two codebook slices
  __shared__ __align__(16) float u[2 * KMAX * DS];
  __shared__ float dss[2][TR][KMAX];        // ds1, ds2 of the CTA's rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * TR, d0 = blockIdx.y * DS;
  const int dc = split ? D / 2 : D;         // codeword width
  C cv[CB_LOADS];
#pragma unroll
  for (int i = 0; i < CB_LOADS; ++i) {      // in flight through the ds work
    const int idx = tid + i * THREADS, book = idx / (KMAX * DS);
    const int k = idx / DS % KMAX, c = idx % DS;
    cv[i] = k < K && d0 + c < dc ? (book ? cb2 : cb1)[(size_t)k * dc + d0 + c]
                                 : C{};
  }
  float* cnt = u;                           // [k1][k2] at k1 (KMAX + 1) + k2
  float cn[CNT_LOADS];
#pragma unroll
  for (int i = 0; i < CNT_LOADS; ++i) {
    const int e = tid + i * THREADS;
    cn[i] = e < K * K ? counts[e] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < CNT_LOADS; ++i) {
    const int e = tid + i * THREADS;
    if (e < K * K) cnt[e / K * (KMAX + 1) + e % K] = cn[i];
  }
  __syncthreads();
  bool own[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) own[c] = lane + 32 * c < K;
  for (int r = warp; r < TR; r += WARPS) {  // a warp a row
    const int t = t0 + r;
    if (t >= T) break;                      // dz skips these rows
    const size_t o = (size_t)t * K;
    const float l = lse[t], g = g4[t];
    float x2[2], e[2], d1[2], a[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k = lane + 32 * c;
      x2[c] = own[c] ? s2[o + k] : -INFINITY;
      const float gp = own[c] ? g * expf(s1[o + k] + lpsi[o + k] - l) : 0.f;
      d1[c] = own[c] ? g1[o + k] + gp : 0.f;
      a[c] = own[c] ? g3[o + k] + gp : 0.f;
    }
    const float c2 = warp_max(fmaxf(x2[0], x2[1]));
#pragma unroll
    for (int c = 0; c < 2; ++c) e[c] = own[c] ? expf(x2[c] - c2) : 0.f;
    // ψ[k1] as the forward's chain (ascending k2, one FMA each), then r
    float rr[2], floored = 0.f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k1 = lane + 32 * c;
      float psi = 0.f;
      for (int k2 = 0; k2 < K; ++k2) {
        const float ek = __shfl_sync(0xffffffffu, k2 < 32 ? e[0] : e[1],
                                     k2 & 31);
        psi = fmaf(ek, cnt[k1 * (KMAX + 1) + k2], psi);
      }
      const bool low = own[c] && psi < 1e-30f;
      rr[c] = own[c] && !low ? a[c] / psi : 0.f;
      if (low) floored += a[c];
    }
    // the floored rows' share of the shift's path, to the argmax of s2
    floored = warp_sum(floored);
    const int ties =
        __popc(__ballot_sync(0xffffffffu, own[0] && x2[0] == c2)) +
        __popc(__ballot_sync(0xffffffffu, own[1] && x2[1] == c2));
    const float shift = floored / (float)ties;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k = lane + 32 * c;
      float rc = 0.f;                       // (r·C)[k], ascending k1
      for (int k1 = 0; k1 < K; ++k1) {
        const float rk = __shfl_sync(0xffffffffu, k1 < 32 ? rr[0] : rr[1],
                                     k1 & 31);
        rc = fmaf(rk, cnt[k1 * (KMAX + 1) + k], rc);
      }
      if (!own[c]) continue;
      float d2 = g2[o + k] + e[c] * rc;
      if (x2[c] == c2) d2 += shift;
      float dd1 = d1[c];
      if (sc1 != nullptr) {                 // quantized: d(z · qᵀ) = ds · s
        dd1 *= sc1[k];
        d2 *= sc2[k];
      }
      if (ds1_out != nullptr && blockIdx.y == 0) {
        ds1_out[o + k] = dd1;
        ds2_out[o + k] = d2;
      }
      dss[0][r][k] = dd1;
      dss[1][r][k] = d2;
    }
  }
  __syncthreads();                          // done with the counts
  float* cs = u;                            // [book][k][DS]
#pragma unroll
  for (int i = 0; i < CB_LOADS; ++i) cs[tid + i * THREADS] = to_f(cv[i]);
  __syncthreads();
  // dz: a thread a (row, float4 column) of each half (PQ) or of the row
  const int halves = split ? 2 : 1;
  for (int task = tid; task < halves * TR * V4; task += THREADS) {
    const int q = task / (TR * V4), r = task / V4 % TR, c = 4 * (task % V4);
    const int t = t0 + r;
    if (t >= T || d0 + c >= dc) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = split ? q : 0; b < (split ? q + 1 : 2); ++b) {
      float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* row = cs + b * KMAX * DS + c;
      for (int k = 0; k < K; ++k) {
        const float w = dss[b][r][k];
        const float4 v = *reinterpret_cast<const float4*>(row + k * DS);
        part.x = fmaf(w, v.x, part.x);
        part.y = fmaf(w, v.y, part.y);
        part.z = fmaf(w, v.z, part.z);
        part.w = fmaf(w, v.w, part.w);
      }
      acc.x += part.x;                      // RQ: the two books' sums added
      acc.y += part.y;
      acc.z += part.z;
      acc.w += part.w;
    }
    float* out = dz + (size_t)t * D + q * dc + d0 + c;
    if (vec && d0 + c + 3 < dc) {
      *reinterpret_cast<float4*>(out) = acc;
    } else {
      const float v[4] = {acc.x, acc.y, acc.z, acc.w};
      for (int j = 0; j < 4 && d0 + c + j < dc; ++j) out[j] = v[j];
    }
  }
}

template <typename C>
void launch(const float* s1, const float* s2, const float* lpsi,
            const float* lse, const float* g1, const float* g2,
            const float* g3, const float* g4, const void* cb1,
            const void* cb2, const float* counts, const float* sc1,
            const float* sc2, float* dz, float* ds1, float* ds2, int T,
            int D, int K, int split, int vec, dim3 grid, cudaStream_t s) {
  midx_bwd_kernel<C><<<grid, THREADS, 0, s>>>(
      s1, s2, lpsi, lse, g1, g2, g3, g4, static_cast<const C*>(cb1),
      static_cast<const C*>(cb2), counts, sc1, sc2, dz, ds1, ds2, T, D, K,
      split, vec);
}

}  // namespace

extern "C" int midx_probs_bwd_max_k() { return KMAX; }

// Launches on `stream`; allocates nothing and does not synchronise.
// Returns cudaGetLastError() after the launch (0 on success). s1, s2, lpsi,
// g1, g2, g3 [T, K], lse and g4 [T], counts [K, K], dz [T, D], all fp32;
// cb1 / cb2 [K, D/2] (PQ, split = 1) or [K, D] (RQ). cb_kind: 0 = fp32
// codebooks (sc1 and sc2 null), 1 = int8, 2 = fp8-e4m3 (sc1 and sc2 the
// [K] fp32 scales). ds1 and ds2: both null, or [T, K] fp32 outputs.
extern "C" int midx_probs_bwd_launch(
    const float* s1, const float* s2, const float* lpsi, const float* lse,
    const float* g1, const float* g2, const float* g3, const float* g4,
    const void* cb1, const void* cb2, const float* counts, const float* sc1,
    const float* sc2, float* dz, float* ds1, float* ds2, int T, int D, int K,
    int split, int cb_kind, void* stream) {
  if (K < 1 || K > KMAX || T < 0 || D < 1 || (split && D % 2) ||
      cb_kind < 0 || cb_kind > 2 || (cb_kind > 0) != (sc1 != nullptr) ||
      (sc1 == nullptr) != (sc2 == nullptr) ||
      (ds1 == nullptr) != (ds2 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return 0;
  const int dc = split ? D / 2 : D;
  const int vec = dc % 4 == 0 && D % 4 == 0 && (uintptr_t)dz % 16 == 0;
  const dim3 grid((T + TR - 1) / TR, (dc + DS - 1) / DS);
  cudaStream_t s = (cudaStream_t)stream;
  if (cb_kind == 1) {
    launch<int8_t>(s1, s2, lpsi, lse, g1, g2, g3, g4, cb1, cb2, counts, sc1,
                   sc2, dz, ds1, ds2, T, D, K, split, vec, grid, s);
  } else if (cb_kind == 2) {
    launch<__nv_fp8_e4m3>(s1, s2, lpsi, lse, g1, g2, g3, g4, cb1, cb2,
                          counts, sc1, sc2, dz, ds1, ds2, T, D, K, split,
                          vec, grid, s);
  } else {
    launch<float>(s1, s2, lpsi, lse, g1, g2, g3, g4, cb1, cb2, counts, sc1,
                  sc2, dz, ds1, ds2, T, D, K, split, vec, grid, s);
  }
  return (int)cudaGetLastError();
}
