// Fused RFF Gumbel-top-m sampling for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `kernels/rff_sample/rff_sample.py::_kernel` of the
// JAX package (and its `pallas_call` in `rff_sample`). For query rows
// phi_z [T, R2] and class features phi_c [N, R2], fp32, it draws m classes
// per row from softmax(logits) with
//   logits[t, n] = log s[t, n],  s = max(phi_z[t] . phi_c[n], 1e-8)
// by Gumbel-max: draw d of row t is the column n that maximises
//   logits[t, n] + g,  g = -log E,  E = -log u,  u from the counter hash of
//   (seeds[t], t_ids[t], d, n)       (`kernels/rff_sample/ref.py`)
// and, among equal maxima, the minimum column. It writes ids [T, m] int32
// and log_q [T, m] = logits[t, id] - lse[t], lse = log sum_n s[t, n].
//
// What bounds it on the card: operations. The function is T*m*N Gumbel
// evaluations (a hash round, a uniform, a log and a compare each) over a
// phi_c of N x R2 fp32 that it reads once: at the serving shape (T = 4,
// m = 64, N = 128 256, R2 = 64) 33 M evaluations against 33 MB, at the
// pooled training shape (m = 1024) 525 M against the same bytes. The dot
// (2*R2 per (t, n)) is small beside them. So the design spends as few
// instructions per evaluation as it can and keeps every SM busy:
//   - one thread per (row, draw) walks a chunk of NCH = 512 columns in
//     ascending order, from tiles of NT = 128 scores staged in shared
//     memory, keeping its best (s, E, column) in registers: no per-draw
//     reduction across threads;
//   - log s + g = log(s / E), so the argmax of the perturbed logit is the
//     argmax of s / E, compared as s * E_best > s_best * E (strict: the
//     first maximum). In real arithmetic this is the same argmax; in fp32
//     it can reorder only candidates a few ulps apart, near-ties of the
//     perturbed values. The chunk winner's perturbed value log s - log E is
//     formed once, in the plain version's form, for the merge;
//   - most columns need no log at all: a column can win only if u exceeds
//     exp(-s * E_best / s_best), which `consider` tests with integer bits
//     and ex2.approx, on the permissive side, 8 columns at a time (their
//     hashes independent of each other); the accurate logf and the exact
//     compare run only for the columns that pass. The result is the exact
//     compare's on every column, bit for bit;
//   - lse needs no log per column: lse = log sum s, each row's sum of a
//     chunk reduced in the block;
//   - the pairs of a block follow m alone: for m >= 128, 128 draws of one
//     row; else every draw of floor(128 / m) rows (at most 16). The grid is
//     (row blocks, chunks, draw groups): the serving shape launches 502
//     blocks, paper-lm per-token training (T = 1024, m = 20) 3 420.
//
// Why a second pass. The TPU kernel walks the class axis as the innermost,
// sequential grid dimension and carries the running argmax and the running
// logsumexp across it in its output blocks. Hopper's blocks run in no
// order, so nothing can be carried from one to the next. A call launches
// two kernels:
//   - `rff_part_kernel` writes one partial (perturbed value, column, logit)
//     per (chunk, row, draw) and each row's sum of s per chunk, into one
//     workspace;
//   - `rff_merge_kernel`, a warp per (row, draw), folds the chunks' partials:
//     each lane over chunks lane, lane + 32, ... in ascending order with a
//     strict >, then a xor butterfly that keeps the larger value and, on a
//     tie, the smaller column; the row's chunk sums are folded once per
//     block of 8 draws in the same fixed order.
// Determinism: no atomics and no order that depends on scheduling, so the
// kernel repeats bit for bit. The chunks, the scan order inside a chunk and
// the merge's order depend on N alone, and a row's arithmetic never meets
// another row's, so a batch of rows draws what each row draws alone.
//
// The hash runs in uint32_t: the multiplies wrap and >> is logical, which
// is what the reference's int32 arithmetic with shift_right_logical does.
// The first two of its three rounds depend on (t) and (t, d) only and are
// hoisted; the third runs per (t, d, n). logf, not __logf, and no fast
// math in the exact compare (ex2.approx only in the filter, inside its
// margin): the draws match the plain version's up to an ulp of log and the
// dot's order, which moves only a near-tie. Supports R2 <= 256 and sums of
// s within fp32's range.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;                // (row, draw) pairs per block
constexpr int WARPS = THREADS / 32;
constexpr int NT = 128;                     // columns per staged tile
constexpr int NCH = 512;                    // columns per chunk
constexpr int G = 8;                        // columns filtered together
constexpr int KS = 16;                      // phi_c feature slice per step
constexpr int R2MAX = 256;
constexpr int TBMAX = 16;                   // rows per block at most
constexpr int SV = NT + 4;                  // score row stride: 16-byte rows
constexpr int MERGE_WARPS = 8;              // draws per merge block
constexpr unsigned FULL = 0xffffffffu;
static_assert(NT == THREADS, "the dot gives each thread one column");
static_assert(NCH % NT == 0, "a chunk is whole tiles");
static_assert(NT % G == 0 && G % 4 == 0, "a tile is whole filter groups");

// The reference's int32 constants as uint32 bit patterns
// (`kernels/rff_sample/ref.py`: _C_T, _C_J, _C_N, _M1, _M2).
constexpr uint32_t C_T = 0x9E3779B1u;
constexpr uint32_t C_J = 0x85D61277u;
constexpr uint32_t C_N = 0xC2B2AE3Du;
constexpr uint32_t M1 = 0x7FEB352Du;
constexpr uint32_t M2 = 0x846C268Bu;

// One partial of a (chunk, row, draw): the winner's perturbed value, its
// column and its logit. 16 bytes, so a warp writes 512 contiguous bytes.
struct __align__(16) Part {
  float v;
  int col;
  float l;
  float pad;
};

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= M1;
  x ^= x >> 15;
  x *= M2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// The launch geometry, from N and m alone: rows and draws per block of the
// partials, the chunks, the draw groups and the merge's blocks.
struct Grid {
  int tb, dpb;
  long long chunks, groups, merge_blocks;
};

inline Grid grid_of(int N, int m) {
  Grid g;
  if (m >= THREADS) {
    g.tb = 1;
    g.dpb = THREADS;
  } else {
    g.dpb = m > 0 ? m : 1;
    g.tb = THREADS / g.dpb < TBMAX ? THREADS / g.dpb : TBMAX;
  }
  g.chunks = (N + NCH - 1) / NCH;
  g.groups = (m + g.dpb - 1) / g.dpb;
  g.merge_blocks = (m + MERGE_WARPS - 1) / MERGE_WARPS;
  return g;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// The filter's slope: log2(e) with a margin of 2e-6 over the roundings of
// E_best / s_best, of s * slope and of logf; and a margin of 2^-16 in the
// exponent over ex2.approx's error.
constexpr float SLOPE = 1.4426950408889634f * (1.0f + 2e-6f);
constexpr float FILTER_C = 1.0f / 65536.0f;

// Gumbel evaluations of columns n0 .. n0 + K - 1 (scores s) against the
// running best (s, E, column), in ascending order. A column can beat the
// best only if s / E > s_best / E_best, i.e. u > exp(-s * E_best / s_best);
// the filter tests that with a bound of u from the hash's top bits and
// ex2.approx, both on the permissive side of their margins, so it lets
// through every column the exact test would take and the logf and the
// exact test run only for those (rare: a new running maximum). rho =
// SLOPE * E_best / s_best, updated on each win; a filter taken with an
// older, larger rho is only more permissive. The results are those of the
// exact test on every column, bit for bit.
template <int K>
__device__ __forceinline__ void consider(uint32_t h2, int n0,
                                         const float (&s)[K], float& bs,
                                         float& be, int& bc, float& rho) {
  uint32_t hh[K];
  bool pass[K];
  bool any = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    hh[k] = mix(h2 ^ ((uint32_t)(n0 + k) * C_N));
    // u <= 1.m - (1 - 2^-22), 1.m the hash's top 23 bits
    const float ub = __uint_as_float(0x3F800000u | (hh[k] >> 9))
                     - 0.99999976158142089844f;
    pass[k] = ub > ex2_approx(fmaf(-s[k], rho, -FILTER_C));
    any |= pass[k];
  }
  if (!any) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (pass[k]) {
      const float u = (float)(hh[k] >> 8) * (1.0f / 16777216.0f)
                      + (1.0f / 33554432.0f);
      const float e = -logf(u);
      if (__fmul_rn(s[k], be) > __fmul_rn(bs, e)) {
        bs = s[k];
        be = e;
        bc = n0 + k;
        rho = __fdiv_rn(be, bs) * SLOPE;
      }
    }
  }
}

// TBT: rows the dot computes, the power of two >= the block's rows.
template <int TBT>
__global__ void __launch_bounds__(THREADS)
rff_part_kernel(const float* __restrict__ phi_z,
                const float* __restrict__ phi_c,
                const long long* __restrict__ seeds,
                const long long* __restrict__ t_ids, Part* __restrict__ part,
                float* __restrict__ psum, int T, int N, int R2, int m,
                int tb, int dpb) {
  __shared__ float zs[TBT][R2MAX];
  __shared__ float cs[NT][KS + 1];          // odd stride: no bank conflicts
  __shared__ __align__(16) float sv[TBT][SV];
  __shared__ float red[WARPS][TBT];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int t0 = blockIdx.x * tb;
  const int chunk = blockIdx.y;
  const int rows = min(tb, T - t0);
  for (int e = tid; e < TBT * R2; e += THREADS) {
    const int r = e / R2, k = e % R2;
    zs[r][k] = r < rows ? phi_z[(size_t)(t0 + r) * R2 + k] : 0.f;
  }

  // this thread's pair: row r of the block, draw d
  const int r = tid / dpb;
  const int d = blockIdx.z * dpb + (tid - r * dpb);
  const bool live = tid < tb * dpb && r < rows && d < m;
  uint32_t h2 = 0;
  if (live) {
    const uint32_t seed = (uint32_t)seeds[t0 + r];
    const uint32_t t = (uint32_t)t_ids[t0 + r];
    h2 = mix(mix(seed ^ (t * C_T)) ^ ((uint32_t)d * C_J));
  }
  float bs = 0.f, be = 1.f;                 // any s > 0 beats (0, 1)
  float rho = INFINITY;                     // the filter's SLOPE * be / bs
  int bc = chunk * NCH;
  float rsum[TBT];
#pragma unroll
  for (int q = 0; q < TBT; ++q) rsum[q] = 0.f;

  for (int tile = 0; tile < NCH / NT; ++tile) {
    const int n0 = chunk * NCH + tile * NT;
    if (n0 >= N) break;                     // the same in every thread
    const int cols = min(NT, N - n0);
    float acc[TBT];
#pragma unroll
    for (int q = 0; q < TBT; ++q) acc[q] = 0.f;
    for (int k0 = 0; k0 < R2; k0 += KS) {
      __syncthreads();
      for (int e = tid; e < NT * KS; e += THREADS) {
        const int c = e / KS, k = e % KS;
        cs[c][k] = (c < cols && k0 + k < R2)
                       ? phi_c[(size_t)(n0 + c) * R2 + k0 + k] : 0.f;
      }
      __syncthreads();
      const int kn = min(KS, R2 - k0);
      for (int k = 0; k < kn; ++k) {
        const float c = cs[tid][k];
#pragma unroll
        for (int q = 0; q < TBT; ++q) acc[q] = fmaf(zs[q][k0 + k], c, acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < TBT; ++q) {
      float s = 0.f;
      if (tid < cols) {
        s = (acc[q] >= 1e-8f || acc[q] != acc[q]) ? acc[q] : 1e-8f;
        rsum[q] += s;                       // ascending tiles
      }
      sv[q][tid] = s;
    }
    __syncthreads();
    if (live) {
      const float* srow = sv[r];
      int c = 0;
      if (cols == NT) {
#pragma unroll 1
        for (; c < NT; c += G) {
          float sg[G];
#pragma unroll
          for (int k = 0; k < G; k += 4) {
            const float4 s4 = *reinterpret_cast<const float4*>(srow + c + k);
            sg[k] = s4.x;
            sg[k + 1] = s4.y;
            sg[k + 2] = s4.z;
            sg[k + 3] = s4.w;
          }
          consider<G>(h2, n0 + c, sg, bs, be, bc, rho);
        }
      }
      for (; c < cols; ++c) {
        const float sc[1] = {srow[c]};
        consider<1>(h2, n0 + c, sc, bs, be, bc, rho);
      }
    }
  }
  if (live) {
    const float l = logf(bs);
    const float g = -logf(be);
    Part p;
    p.v = l + g;
    p.col = bc;
    p.l = l;
    p.pad = 0.f;
    part[((size_t)chunk * T + t0 + r) * m + d] = p;
  }
  if (blockIdx.z == 0) {                    // the row sums, once per chunk
#pragma unroll
    for (int q = 0; q < TBT; ++q) {
      const float s = warp_sum(rsum[q]);
      if (lane == 0) red[warp][q] = s;
    }
    __syncthreads();
    if (tid < rows) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w][tid];
      psum[(size_t)chunk * T + t0 + tid] = s;
    }
  }
}

// Grid (T, draw blocks of MERGE_WARPS); a warp per (row, draw).
__global__ void __launch_bounds__(MERGE_WARPS * 32)
rff_merge_kernel(const Part* __restrict__ part, const float* __restrict__ psum,
                 int* __restrict__ ids, float* __restrict__ log_q, int T,
                 int m, int chunks) {
  __shared__ float lse_s;
  const int t = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    float s = 0.f;
    for (int c = lane; c < chunks; c += 32) s += psum[(size_t)c * T + t];
    s = warp_sum(s);
    if (lane == 0) lse_s = logf(s);
  }
  __syncthreads();
  const int d = blockIdx.y * MERGE_WARPS + warp;
  if (d >= m) return;
  float bv = -INFINITY, bl = 0.f;
  int bc = 0x7fffffff;
  for (int c = lane; c < chunks; c += 32) {
    const Part p = part[((size_t)c * T + t) * m + d];
    if (p.v > bv || (p.v == bv && p.col < bc)) {
      bv = p.v;
      bc = p.col;
      bl = p.l;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, off);
    const int oc = __shfl_xor_sync(FULL, bc, off);
    const float ol = __shfl_xor_sync(FULL, bl, off);
    if (ov > bv || (ov == bv && oc < bc)) {
      bv = ov;
      bc = oc;
      bl = ol;
    }
  }
  if (lane == 0) {
    ids[(size_t)t * m + d] = bc == 0x7fffffff ? 0 : bc;
    log_q[(size_t)t * m + d] = bl - lse_s;
  }
}

// Bytes of the workspace of a call (T, N, m): the partials [chunks, T, m]
// of 16 bytes, then the row sums [chunks, T] fp32, chunks = ceil(N / NCH);
// -1 where the kernels do not take the sizes (a grid dimension past 65535,
// T * m past 2^31).
long long workspace_bytes(int T, int N, int m) {
  if (T < 0 || N < 1 || m < 0 || (long long)T * m >= (1LL << 31)) return -1;
  const Grid g = grid_of(N, m);
  if (g.chunks > 65535 || g.groups > 65535 || g.merge_blocks > 65535) {
    return -1;
  }
  return g.chunks * T *
         ((long long)sizeof(Part) * m + (long long)sizeof(float));
}

}  // namespace

extern "C" int rff_sample_max_r2() { return R2MAX; }

extern "C" long long rff_sample_workspace_bytes(int T, int N, int m) {
  return workspace_bytes(T, N, m);
}

// Launches both kernels on `stream`; allocates nothing and does not
// synchronise. ws: `rff_sample_workspace_bytes(T, N, m)` bytes, 16-byte
// aligned. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int rff_sample_launch(const float* phi_z, const float* phi_c,
                                 const long long* seeds,
                                 const long long* t_ids, int* ids,
                                 float* log_q, void* ws, int T, int N, int R2,
                                 int m, void* stream) {
  if (R2 < 1 || R2 > R2MAX || workspace_bytes(T, N, m) < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0 || m == 0) return 0;
  const Grid g = grid_of(N, m);
  Part* part = static_cast<Part*>(ws);
  float* psum = reinterpret_cast<float*>(part + g.chunks * T * (long long)m);
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((T + g.tb - 1) / g.tb, (unsigned)g.chunks,
                  (unsigned)g.groups);
  const auto part_kernel = g.tb == 1   ? rff_part_kernel<1>
                           : g.tb == 2 ? rff_part_kernel<2>
                           : g.tb <= 4 ? rff_part_kernel<4>
                           : g.tb <= 8 ? rff_part_kernel<8>
                                       : rff_part_kernel<16>;
  part_kernel<<<grid, THREADS, 0, s>>>(phi_z, phi_c, seeds, t_ids, part, psum,
                                       T, N, R2, m, g.tb, g.dpb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rff_merge_kernel<<<dim3(T, (unsigned)g.merge_blocks), MERGE_WARPS * 32, 0,
                     s>>>(part, psum, ids, log_q, T, m, (int)g.chunks);
  return (int)cudaGetLastError();
}
