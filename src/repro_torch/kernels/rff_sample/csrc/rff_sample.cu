// Fused RFF Gumbel-top-m sampling for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `kernels/rff_sample/rff_sample.py::_kernel` of the
// JAX package (and its `pallas_call` in `rff_sample`). For query rows
// phi_z [T, R2] and class features phi_c [N, R2], fp32, it draws m classes
// per row from softmax(logits) with
//   logits[t, n] = log max(phi_z[t] . phi_c[n], 1e-8)
// by Gumbel-max: draw d of row t is the column n that maximises
//   logits[t, n] + g,  g = -log(-log u),  u from the counter hash of
//   (seeds[t], t_ids[t], d, n)       (`kernels/rff_sample/ref.py`)
// and, among equal maxima, the minimum column. It writes ids [T, m] int32
// and log_q [T, m] = logits[t, id] - lse[t], lse over the N columns in the
// reference's form m_run + log max(l_run, 1e-30) (`ops.py:58`).
//
// What bounds it on the card. The function is a T*m*N Gumbel evaluation
// (a hash round, an int-to-float and two logs each) over a phi_c of
// N x R2 fp32 that it reads once: at the serving shape (T = 4, m = 64,
// N = 128 256, R2 = 64) 33 M evaluations against 33 MB, at the pooled
// training shape (m = 1024) 525 M evaluations against the same bytes. So
// it is bound by operations, the logs and the integer hash, never by
// bytes; the dot (2*R2 per (t, n)) is small beside them.
//
// Why a second pass. The TPU kernel walks the class axis as the innermost,
// sequential grid dimension and carries the running argmax and the running
// logsumexp across it in its output blocks. Hopper's blocks run in no
// order, so nothing can be carried from one to the next. Here:
//   - `rff_partial_kernel`, grid (row groups of TB = 8 rows, column chunks
//     of NC = 256): a block computes its chunk's logits once into shared
//     memory (phi_c staged in coalesced 16-wide feature slices, one column
//     per thread, fp32 FMA in ascending feature order), each row's partial
//     (max, sum of exp) for the logsumexp, then walks every (row, draw)
//     pair, one warp per pair: each lane scans its columns in ascending
//     order with a strict > (the first maximum), and a xor butterfly keeps
//     the larger value, the smaller column on a tie. It writes one partial
//     (max, column, unperturbed logit) per (chunk, row, draw);
//   - `rff_merge_kernel`, one thread per (row, draw): folds the partials
//     in ascending chunk order with a strict >, which keeps the earlier
//     chunk on a tie and so reproduces the minimum-column rule, and folds
//     the chunks' (max, sum) into the row's logsumexp in the same order.
// No atomics and no order that depends on scheduling: the kernel repeats
// bit for bit, and a row's result depends on nothing but that row (the
// chunks are fixed by N), so a batch of rows draws what each row draws
// alone. A block of 4 rows per chunk gives the serving shape 501 blocks
// on the 132 SMs, where one block per row would give it 4.
//
// The hash runs in uint32_t: the multiplies wrap and >> is logical, which
// is what the reference's int32 arithmetic with shift_right_logical does.
// The first two of its three rounds depend on (t) and (t, d) only and are
// hoisted; the third runs per (t, d, n). logf, not __logf, and no fast
// math: the draws match the plain version's up to an ulp of log and the
// dot's order, which moves only a near-tie. Supports R2 <= 256.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TB = 8;                       // query rows per block
constexpr int NC = 256;                     // class columns per block
constexpr int THREADS = 256;                // one column per thread
constexpr int WARPS = THREADS / 32;
constexpr int KS = 16;                      // phi_c feature slice per step
constexpr int R2MAX = 256;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(NC == THREADS, "the logits stage gives each thread a column");
static_assert(TB <= WARPS, "the logsumexp stage gives each row a warp");

// The reference's int32 constants as uint32 bit patterns
// (`kernels/rff_sample/ref.py`: _C_T, _C_J, _C_N, _M1, _M2).
constexpr uint32_t C_T = 0x9E3779B1u;
constexpr uint32_t C_J = 0x85D61277u;
constexpr uint32_t C_N = 0xC2B2AE3Du;
constexpr uint32_t M1 = 0x7FEB352Du;
constexpr uint32_t M2 = 0x846C268Bu;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= M1;
  x ^= x >> 15;
  x *= M2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
rff_partial_kernel(const float* __restrict__ phi_z,
                   const float* __restrict__ phi_c,
                   const long long* __restrict__ seeds,
                   const long long* __restrict__ t_ids,
                   float* __restrict__ pmax, int* __restrict__ pcol,
                   float* __restrict__ pscore, float* __restrict__ lmax,
                   float* __restrict__ lsum, int T, int N, int R2, int m) {
  __shared__ float zs[TB][R2MAX];
  __shared__ float cs[NC][KS + 1];          // odd stride: no bank conflicts
  __shared__ float lg[TB][NC];
  __shared__ uint32_t h1s[TB];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t0 = blockIdx.x * TB;
  const int chunk = blockIdx.y;
  const int c0 = chunk * NC;
  const int rows = min(TB, T - t0);
  const int cols = min(NC, N - c0);

  for (int e = tid; e < TB * R2; e += THREADS) {
    const int r = e / R2, k = e % R2;
    zs[r][k] = r < rows ? phi_z[(size_t)(t0 + r) * R2 + k] : 0.f;
  }
  if (tid < rows) {
    const uint32_t seed = (uint32_t)seeds[t0 + tid];
    const uint32_t t = (uint32_t)t_ids[t0 + tid];
    h1s[tid] = mix(seed ^ (t * C_T));
  }

  // logits of this chunk: thread tid owns column c0 + tid for every row
  float acc[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < R2; k0 += KS) {
    __syncthreads();
    for (int e = tid; e < NC * KS; e += THREADS) {
      const int c = e / KS, k = e % KS;
      cs[c][k] = (c < cols && k0 + k < R2)
                     ? phi_c[(size_t)(c0 + c) * R2 + k0 + k] : 0.f;
    }
    __syncthreads();
    const int kn = min(KS, R2 - k0);
    for (int k = 0; k < kn; ++k) {
      const float c = cs[tid][k];
#pragma unroll
      for (int r = 0; r < TB; ++r) acc[r] = fmaf(zs[r][k0 + k], c, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    float l = NEG_INF;
    if (r < rows && tid < cols) {
      const float s = acc[r];
      l = logf((s >= 1e-8f || s != s) ? s : 1e-8f);   // NaN propagates
    }
    lg[r][tid] = l;
  }
  __syncthreads();

  // the chunk's partial logsumexp of each row: (max, sum of exp(l - max))
  if (warp < rows) {
    float mx = NEG_INF;
    for (int c = lane; c < cols; c += 32) mx = fmaxf(mx, lg[warp][c]);
    mx = warp_max(mx);
    float sm = 0.f;
    for (int c = lane; c < cols; c += 32) sm += expf(lg[warp][c] - mx);
    sm = warp_sum(sm);
    if (lane == 0) {
      lmax[(size_t)chunk * T + t0 + warp] = mx;
      lsum[(size_t)chunk * T + t0 + warp] = sm;
    }
  }

  // one warp per (row, draw): the chunk's Gumbel argmax
  const int pairs = rows * m;
  for (int p = warp; p < pairs; p += WARPS) {
    const int r = p / m;
    const int d = p - r * m;
    const uint32_t h2 = mix(h1s[r] ^ ((uint32_t)d * C_J));
    float best = NEG_INF;
    int bcol = 0x7fffffff;
    float bscore = NEG_INF;
    for (int c = lane; c < cols; c += 32) {
      const int n = c0 + c;
      const uint32_t h = mix(h2 ^ ((uint32_t)n * C_N));
      const float u = (float)(h >> 8) * (1.0f / 16777216.0f)
                      + (1.0f / 33554432.0f);
      const float g = -logf(-logf(u));
      const float l = lg[r][c];
      const float v = l + g;
      if (v > best) {
        best = v;
        bcol = n;
        bscore = l;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, off);
      const int oc = __shfl_xor_sync(FULL, bcol, off);
      const float os = __shfl_xor_sync(FULL, bscore, off);
      if (ob > best || (ob == best && oc < bcol)) {
        best = ob;
        bcol = oc;
        bscore = os;
      }
    }
    if (lane == 0) {
      const size_t o = ((size_t)chunk * T + t0 + r) * m + d;
      pmax[o] = best;
      pcol[o] = bcol;
      pscore[o] = bscore;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
rff_merge_kernel(const float* __restrict__ pmax, const int* __restrict__ pcol,
                 const float* __restrict__ pscore,
                 const float* __restrict__ lmax,
                 const float* __restrict__ lsum, int* __restrict__ ids,
                 float* __restrict__ log_q, int T, int m, int chunks) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= T * m) return;
  const int t = i / m;
  const int d = i - t * m;
  float best = NEG_INF;
  int col = 0;
  float score = NEG_INF;
  for (int c = 0; c < chunks; ++c) {
    const size_t o = ((size_t)c * T + t) * m + d;
    const float v = pmax[o];
    if (v > best) {                         // strict: the earlier chunk wins
      best = v;
      col = pcol[o];
      score = pscore[o];
    }
  }
  float m_run = NEG_INF, l_run = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const float mc = lmax[(size_t)c * T + t];
    const float lc = lsum[(size_t)c * T + t];
    const float mn = fmaxf(m_run, mc);
    l_run = l_run * expf(m_run - mn) + lc * expf(mc - mn);
    m_run = mn;
  }
  ids[i] = col;
  log_q[i] = score - (m_run + logf(fmaxf(l_run, 1e-30f)));
}

}  // namespace

extern "C" int rff_sample_max_r2() { return R2MAX; }
extern "C" int rff_sample_chunk() { return NC; }

// Launches both kernels on `stream`; allocates nothing and does not
// synchronise. The partials are [chunks, T, m] (pmax, pcol, pscore) and
// [chunks, T] (lmax, lsum), chunks = ceil(N / rff_sample_chunk()).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int rff_sample_launch(const float* phi_z, const float* phi_c,
                                 const long long* seeds,
                                 const long long* t_ids, int* ids,
                                 float* log_q, float* pmax, int* pcol,
                                 float* pscore, float* lmax, float* lsum,
                                 int T, int N, int R2, int m, void* stream) {
  if (T < 0 || N < 1 || R2 < 1 || R2 > R2MAX || m < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0 || m == 0) return 0;
  const int chunks = (N + NC - 1) / NC;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((T + TB - 1) / TB, chunks);
  rff_partial_kernel<<<grid, THREADS, 0, s>>>(phi_z, phi_c, seeds, t_ids,
                                               pmax, pcol, pscore, lmax, lsum,
                                               T, N, R2, m);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)(((long long)T * m + THREADS - 1) / THREADS);
  rff_merge_kernel<<<blocks, THREADS, 0, s>>>(pmax, pcol, pscore, lmax, lsum,
                                              ids, log_q, T, m, chunks);
  return (int)cudaGetLastError();
}
