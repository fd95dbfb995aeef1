// Fused MIDX proposal tables for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `kernels/midx_probs/midx_probs.py::_kernel` of the
// JAX package. Per query row t (z [T, D] fp32) it computes, in the order of
// operations of `kernels/midx_probs/ref.py` (the port's plain version):
//   s1 = z1 · C1ᵀ, s2 = z2 · C2ᵀ      PQ: z1/z2 are the halves of z, RQ: z
//   c2 = max_k s2
//   ψ[k1] = Σ_k2 counts[k1, k2] · exp(s2[k2] − c2)
//   logψ = log(max(ψ, 1e-30)) + c2
//   lse  = logsumexp_k1(s1 + logψ)   (max-shifted)
// and writes s1, s2, logψ [T, K] and lse [T], all fp32.
//
// What bounds it on the card. At decode (T = 8 slots, D = 2048, K = 64, RQ)
// the call reads both codebooks (2·64·2048·4 B = 1 MB) and z, and does about
// 4.2 MFLOP: it is bound by bytes and, at one or two CTAs, by latency; the
// FLOPs are negligible. The TPU kernel kept both codebooks resident in VMEM
// for the whole grid; 1 MB of fp32 codebooks does not fit the 227 KB of
// shared memory a Hopper CTA has, so this kernel streams them. Measured on
// an H100, this first version is far from that bound: one CTA per 16 rows
// leaves a decode wave on a single SM, whose shared-memory load rate (two
// operand loads per FMA) then sets the time.
//
// Design (simple and right first; wgmma/TMA and more CTAs at tiny T are
// later work):
//   - one CTA of 256 threads per block of TB = 16 query rows; the ragged
//     edge (t >= T) is masked in the kernel, T is never padded;
//   - a loop over D in chunks of DC = 32 stages the z chunk(s) and both
//     codebook chunks in shared memory (row stride DC + 1: no bank
//     conflicts across codewords);
//   - each thread owns up to 4 (row, codeword) outputs of s1 and of s2 and
//     accumulates them in fp32 registers with FMA (no TF32), always in
//     ascending d, so a row's result does not depend on T or on its block;
//   - after the loop the [K, K] counts tile reuses the staging area; ψ is a
//     sequential K-long FMA per (row, k1), and the row max and logsumexp
//     are warp reductions.
// Supports K <= 64 (the wrapper checks).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TB = 16;                      // query rows per CTA
constexpr int DC = 32;                      // D chunk per staging step
constexpr int KMAX = 64;                    // largest codebook size
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = (TB * KMAX + THREADS - 1) / THREADS;  // outputs/thread
constexpr int LD = DC + 1;                  // padded row stride
constexpr int STAGE = 2 * TB * LD + 2 * KMAX * LD;
static_assert(KMAX * (KMAX + 1) <= STAGE,
              "the counts tile must fit the staging area it reuses");

__global__ void __launch_bounds__(THREADS)
midx_probs_kernel(const float* __restrict__ z, const float* __restrict__ cb1,
                  const float* __restrict__ cb2,
                  const float* __restrict__ counts,
                  float* __restrict__ s1_out, float* __restrict__ s2_out,
                  float* __restrict__ lpsi_out, float* __restrict__ lse_out,
                  int T, int D, int K, int split) {
  __shared__ float stage[STAGE];
  __shared__ float s1s[TB][KMAX];
  __shared__ float s2s[TB][KMAX];           // s2, then exp(s2 - c2)
  __shared__ float l1s[TB][KMAX];           // s1 + logψ
  __shared__ float c2s[TB];

  float* z1s = stage;                       // [TB][LD]
  float* z2s = stage + TB * LD;             // [TB][LD] (PQ only)
  float* cb1s = stage + 2 * TB * LD;        // [KMAX][LD]
  float* cb2s = cb1s + KMAX * LD;           // [KMAX][LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t0 = blockIdx.x * TB;
  const int dc = split ? D / 2 : D;         // codeword width
  const int nout = TB * K;
  const float* zq2 = split ? z2s : z1s;

  float acc1[PER];
  float acc2[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    acc1[i] = 0.f;
    acc2[i] = 0.f;
  }

  for (int d0 = 0; d0 < dc; d0 += DC) {
    for (int e = tid; e < TB * DC; e += THREADS) {
      const int r = e / DC, d = e % DC;
      const int t = t0 + r, dd = d0 + d;
      const bool ok = t < T && dd < dc;
      z1s[r * LD + d] = ok ? z[(size_t)t * D + dd] : 0.f;
      if (split) z2s[r * LD + d] = ok ? z[(size_t)t * D + dc + dd] : 0.f;
    }
    for (int e = tid; e < K * DC; e += THREADS) {
      const int k = e / DC, d = e % DC;
      const int dd = d0 + d;
      const bool ok = dd < dc;
      cb1s[k * LD + d] = ok ? cb1[(size_t)k * dc + dd] : 0.f;
      cb2s[k * LD + d] = ok ? cb2[(size_t)k * dc + dd] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int o = tid + i * THREADS;
      if (o < nout) {
        const int r = o / K, k = o % K;
        const float* za = z1s + r * LD;
        const float* zb = zq2 + r * LD;
        const float* ca = cb1s + k * LD;
        const float* cb = cb2s + k * LD;
        float a1 = acc1[i], a2 = acc2[i];
#pragma unroll 8
        for (int d = 0; d < DC; ++d) {
          a1 = fmaf(za[d], ca[d], a1);
          a2 = fmaf(zb[d], cb[d], a2);
        }
        acc1[i] = a1;
        acc2[i] = a2;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int o = tid + i * THREADS;
    if (o < nout) {
      s1s[o / K][o % K] = acc1[i];
      s2s[o / K][o % K] = acc2[i];
    }
  }
  float* cnt = stage;                       // [K][K + 1], staging is free
  for (int e = tid; e < K * K; e += THREADS) {
    cnt[(e / K) * (K + 1) + e % K] = counts[e];
  }
  __syncthreads();

  for (int r = warp; r < TB; r += WARPS) {  // c2 = row max of s2
    float m = -INFINITY;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, s2s[r][k]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
    }
    if (lane == 0) c2s[r] = m;
  }
  __syncthreads();

  for (int o = tid; o < nout; o += THREADS) {
    const int r = o / K, k = o % K;
    const int t = t0 + r;
    const float v2 = s2s[r][k];
    if (t < T) {
      s1_out[(size_t)t * K + k] = s1s[r][k];
      s2_out[(size_t)t * K + k] = v2;
    }
    s2s[r][k] = expf(v2 - c2s[r]);          // same thread, same element
  }
  __syncthreads();

  for (int o = tid; o < nout; o += THREADS) {
    const int r = o / K, k1 = o % K;
    const float* crow = cnt + k1 * (K + 1);
    float psi = 0.f;
    for (int k2 = 0; k2 < K; ++k2) psi = fmaf(s2s[r][k2], crow[k2], psi);
    const float lp = logf(fmaxf(psi, 1e-30f)) + c2s[r];
    const int t = t0 + r;
    if (t < T) lpsi_out[(size_t)t * K + k1] = lp;
    l1s[r][k1] = s1s[r][k1] + lp;
  }
  __syncthreads();

  for (int r = warp; r < TB; r += WARPS) {  // lse = logsumexp(s1 + logψ)
    float m = -INFINITY;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, l1s[r][k]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
    }
    float acc = 0.f;
    for (int k = lane; k < K; k += 32) acc += expf(l1s[r][k] - m);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, s);
    }
    if (lane == 0 && t0 + r < T) lse_out[t0 + r] = logf(acc) + m;
  }
}

}  // namespace

extern "C" int midx_probs_max_k() { return KMAX; }

// Launches on `stream`; allocates nothing and does not synchronise.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int midx_probs_launch(const float* z, const float* cb1,
                                 const float* cb2, const float* counts,
                                 float* s1, float* s2, float* lpsi,
                                 float* lse, int T, int D, int K, int split,
                                 void* stream) {
  if (K < 1 || K > KMAX || T < 0 || D < 1 || (split && D % 2)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return 0;
  const dim3 grid((T + TB - 1) / TB);
  midx_probs_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      z, cb1, cb2, counts, s1, s2, lpsi, lse, T, D, K, split);
  return (int)cudaGetLastError();
}
