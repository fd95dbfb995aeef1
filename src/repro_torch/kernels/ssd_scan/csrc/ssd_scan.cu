// Chunked SSD scan (mamba2's core) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `kernels/ssd_scan/ssd_scan.py::_kernel` of the
// JAX package (:24, its `pallas_call` at :74), and computes the chunk body
// of `models/mamba2.py::apply_mamba2` (:102-119). Inputs and outputs in the
// model's own layout, read and written with strides, never transposed (the
// Pallas wrapper transposes x, adt and dt to [B, H, S, ...] and y back):
//   x [Bt, S, H, P]; B, C [Bt, S, N], shared by all heads; adt = a*dt and
//   dt [Bt, S, H]; all fp32, P <= 64, N <= 128, S a multiple of the chunk
//   Q (any Q >= 1).
//   y [Bt, S, H, P] and h_last [Bt, H, N, P], fp32.
// Per (b, h) and chunk of Q rows, with the carry h [N, P] starting at 0:
//   cum = prefix sum of adt over the chunk;  CB = C . B^T
//   y   = (CB o L) . (dt x) + e^cum o (C . h),  L = tril(e^(cum_i - cum_j))
//   h'  = e^cum_Q h + B^T . (e^(cum_Q - cum) o dt x)
// The Pallas kernel writes only y; this one also writes h_last, the carry
// that `apply_mamba2(return_state=True)` returns for decode.
//
// Design. One CTA of 256 threads per (b, h), grid Bt * H: the TPU's
// sequential chunk grid axis is a loop inside the CTA, and the carry h
// (32 KB at N = 128, P = 64) stays in shared memory across chunks. A chunk
// is walked in tiles of 64 rows, since its [Q, Q] score block does not fit
// a CTA at Q = 256 (256 KB of fp32):
//  1. thread 0 forms cum for the chunk, one fixed sequential sum (in
//     double, rounded to fp32 per row), into a global workspace;
//  2. for each query tile of 64 rows: C_i and cum_i are staged; the thread
//     (ty, tx) of a 16 x 16 grid owns rows 4 ty .. 4 ty + 3 and columns
//     tx + 16 c (c < 4) of the output. It forms y2 = e^cum_i (C_i . h),
//     then walks the key tiles up to the diagonal in ascending order: B_j,
//     dt_j x_j and cum_j staged; the 64 x 64 scores
//     (C_i . B_j) * e^(cum_i - cum_j) written to shared memory for j <= i
//     and 0 above the diagonal and past the chunk's end, by SELECT: the
//     exponential of a masked entry is never formed (above the diagonal
//     cum_i - cum_j > 0 can overflow to inf, and inf * 0 is NaN); then
//     y1 += scores . (dt_j x_j). It writes y = y1 + y2;
//  3. the state update walks the key tiles again: thread (ty, tx) owns
//     rows ty + 16 r (r < 8) of h and its columns tx + 16 c, sums
//     B_j^T (e^(cum_Q - cum_j) dt_j x_j) in ascending j, and writes
//     e^cum_Q h + that sum back to shared memory.
// Ragged tiles (Q not a multiple of 64, e.g. a 13-token prompt) are staged
// as zeros past the chunk's end and never written. expf, no fast math.
//
// No atomics: every output element is written by one thread in a fixed
// order of operations, so the kernel repeats bit for bit, and a row's
// result depends on its (b, h) only, never on Bt or the schedule.
//
// What bounds it. At mamba2-370m's training shape (Bt = 4, S = 1024,
// H = 32, P = 64, N = 128, Q = 256) the function needs about 6.5 GFLOP
// (the causal half of the intra-chunk products, C . h and the state
// update; CB once per (b, chunk), being shared by the heads) against about
// 76 MB of inputs and outputs: it is bound by operations, 0.1 ms at the
// 67 TFLOP/s of fp32 outside the tensor cores. This kernel recomputes CB
// for every head (its own overhead, not the function's), runs its products
// on fp32 FMAs fed from shared memory (two shared loads for every four
// FMAs, so the shared-memory pipe sets its pace), and has one CTA, eight
// warps, per SM. wgmma on the chunk products, TMA loads and a split of a
// chunk's query tiles across CTAs are the later redesign.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;                // 16 x 16 threads
constexpr int TILE = 64;                    // rows per query / key tile
constexpr int NMAX = 128;                   // state size N
constexpr int PMAX = 64;                    // head dim P
constexpr int RPT = 4;                      // output rows per thread
constexpr int CPT = 4;                      // output columns per thread
constexpr int HR = NMAX / 16;               // h rows per thread (state update)
static_assert(TILE == 16 * RPT && PMAX == 16 * CPT, "16 x 16 thread grid");

// Shared-memory row strides (floats). C and B rows are padded by one so the
// score loop's reads of B at rows tx + 16 c fall in distinct banks; score
// rows by four so the two half-warps of a warp (rows 4 apart) do too.
constexpr int CS = NMAX + 1;                // Cs, Bs [TILE][CS]
constexpr int XS = PMAX;                    // Xs [TILE][XS]
constexpr int PS = TILE + 4;                // Ps [TILE][PS]
constexpr int SMEM_FLOATS = NMAX * PMAX + 2 * TILE * CS + TILE * XS
                            + TILE * PS + 2 * TILE;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ adt,
                const float* __restrict__ dt, float* __restrict__ y,
                float* __restrict__ h_last, float* __restrict__ cum, int s,
                int nh, int p, int n, int q) {
  extern __shared__ float smem[];
  float* Hs = smem;                         // [NMAX][PMAX] the carry
  float* Cs = Hs + NMAX * PMAX;             // [TILE][CS] C of the query tile
  float* Bs = Cs + TILE * CS;               // [TILE][CS] B of the key tile
  float* Xs = Bs + TILE * CS;               // [TILE][XS] dt x (times seg)
  float* Ps = Xs + TILE * XS;               // [TILE][PS] masked scores
  float* Cq = Ps + TILE * PS;               // [TILE] cum of the query tile
  float* Ck = Cq + TILE;                    // [TILE] cum of the key tile

  const int bh = blockIdx.x;
  const int b = bh / nh, head = bh % nh;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t xrow = (int64_t)nh * p;     // x / y stride between tokens
  const float* xb = x + (int64_t)b * s * xrow + (int64_t)head * p;
  float* yb = y + (int64_t)b * s * xrow + (int64_t)head * p;
  const float* bb = bm + (int64_t)b * s * n;
  const float* cb = cm + (int64_t)b * s * n;
  const float* ab = adt + (int64_t)b * s * nh + head;    // stride nh
  const float* db = dt + (int64_t)b * s * nh + head;
  float* cg = cum + (int64_t)bh * s;

  for (int e = tid; e < NMAX * PMAX; e += THREADS) Hs[e] = 0.f;

  const int ntiles = (q + TILE - 1) / TILE;
  for (int t0 = 0; t0 < s; t0 += q) {
    // 1. cum over the chunk, in one fixed order.
    if (tid == 0) {
      double run = 0.0;
      for (int t = 0; t < q; ++t) {
        run += (double)ab[(int64_t)(t0 + t) * nh];
        cg[t0 + t] = (float)run;
      }
    }
    __syncthreads();
    const float cum_last = cg[t0 + q - 1];

    // 2. y, one query tile at a time.
    for (int qt = 0; qt < ntiles; ++qt) {
      const int i0 = qt * TILE;
      for (int e = tid; e < TILE * n; e += THREADS) {
        const int r = e / n, k = e - r * n;
        Cs[r * CS + k] = i0 + r < q ? cb[(int64_t)(t0 + i0 + r) * n + k]
                                    : 0.f;
      }
      if (tid < TILE) Cq[tid] = i0 + tid < q ? cg[t0 + i0 + tid] : 0.f;
      __syncthreads();

      float y1[RPT][CPT], y2[RPT][CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) y1[r][c] = y2[r][c] = 0.f;
      // y2 = e^cum_i (C_i . h), the products in ascending k
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        float cv[RPT], hv[CPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) cv[r] = Cs[(ty * RPT + r) * CS + k];
#pragma unroll
        for (int c = 0; c < CPT; ++c) hv[c] = Hs[k * PMAX + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) y2[r][c] = fmaf(cv[r], hv[c], y2[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float e = expf(Cq[ty * RPT + r]);
#pragma unroll
        for (int c = 0; c < CPT; ++c) y2[r][c] = e * y2[r][c];
      }

      // y1: key tiles up to the diagonal, ascending
      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * TILE;
        const int jn = min(TILE, q - j0);
        __syncthreads();                    // Bs, Xs, Ps free again
        for (int e = tid; e < TILE * n; e += THREADS) {
          const int r = e / n, k = e - r * n;
          Bs[r * CS + k] = r < jn ? bb[(int64_t)(t0 + j0 + r) * n + k] : 0.f;
        }
        for (int e = tid; e < TILE * p; e += THREADS) {
          const int r = e / p, c = e - r * p;
          const int64_t t = t0 + j0 + r;
          Xs[r * XS + c] = r < jn ? xb[t * xrow + c] * db[t * nh] : 0.f;
        }
        if (tid < TILE) Ck[tid] = tid < jn ? cg[t0 + j0 + tid] : 0.f;
        __syncthreads();
        float sc[RPT][CPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) sc[r][c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          float cv[RPT], bv[CPT];
#pragma unroll
          for (int r = 0; r < RPT; ++r) cv[r] = Cs[(ty * RPT + r) * CS + k];
#pragma unroll
          for (int c = 0; c < CPT; ++c) bv[c] = Bs[(tx + 16 * c) * CS + k];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < CPT; ++c)
              sc[r][c] = fmaf(cv[r], bv[c], sc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int li = ty * RPT + r, i = i0 + li;
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int lj = tx + 16 * c, j = j0 + lj;
            float v = 0.f;
            if (j <= i && i < q && lj < jn)
              v = sc[r][c] * expf(Cq[li] - Ck[lj]);
            Ps[li * PS + lj] = v;
          }
        }
        __syncthreads();
        for (int j = 0; j < jn; ++j) {
          float pv[RPT], xv[CPT];
#pragma unroll
          for (int r = 0; r < RPT; ++r) pv[r] = Ps[(ty * RPT + r) * PS + j];
#pragma unroll
          for (int c = 0; c < CPT; ++c) xv[c] = Xs[j * XS + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < CPT; ++c)
              y1[r][c] = fmaf(pv[r], xv[c], y1[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = i0 + ty * RPT + r;
        if (i >= q) continue;
        float* yr = yb + (int64_t)(t0 + i) * xrow;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = tx + 16 * c;
          if (col < p) yr[col] = y1[r][c] + y2[r][c];
        }
      }
      __syncthreads();                      // Cs, Cq free again
    }

    // 3. h' = e^cum_Q h + sum_j B_j^T (e^(cum_Q - cum_j) dt_j x_j)
    float sh[HR][CPT];
#pragma unroll
    for (int r = 0; r < HR; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) sh[r][c] = 0.f;
    for (int kt = 0; kt < ntiles; ++kt) {
      const int j0 = kt * TILE;
      const int jn = min(TILE, q - j0);
      __syncthreads();
      for (int e = tid; e < TILE * n; e += THREADS) {
        const int r = e / n, k = e - r * n;
        Bs[r * CS + k] = r < jn ? bb[(int64_t)(t0 + j0 + r) * n + k] : 0.f;
      }
      for (int e = tid; e < TILE * p; e += THREADS) {
        const int r = e / p, c = e - r * p;
        const int64_t t = t0 + j0 + r;
        float w = 0.f;
        if (r < jn)
          w = xb[t * xrow + c] * db[t * nh] * expf(cum_last - cg[t]);
        Xs[r * XS + c] = w;
      }
      __syncthreads();
      for (int j = 0; j < jn; ++j) {
        float bv[HR], xv[CPT];
#pragma unroll
        for (int r = 0; r < HR; ++r) bv[r] = Bs[j * CS + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < CPT; ++c) xv[c] = Xs[j * XS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < HR; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) sh[r][c] = fmaf(bv[r], xv[c], sh[r][c]);
      }
    }
    const float decay = expf(cum_last);
#pragma unroll
    for (int r = 0; r < HR; ++r) {
      const int k = ty + 16 * r;
      if (k >= n) continue;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + 16 * c;
        if (col < p) Hs[k * PMAX + col] = decay * Hs[k * PMAX + col] + sh[r][c];
      }
    }
    __syncthreads();
  }

  float* hb = h_last + (int64_t)bh * n * p;
  for (int e = tid; e < n * p; e += THREADS) {
    const int k = e / p, c = e - k * p;
    hb[e] = Hs[k * PMAX + c];
  }
}

}  // namespace

extern "C" {

// The largest state size N and head dim P the kernel takes.
int ssd_scan_max_n() { return NMAX; }

int ssd_scan_max_p() { return PMAX; }

// x [Bt, S, H, P], bm / cm [Bt, S, N], adt / dt [Bt, S, H], contiguous fp32;
// y like x, h_last [Bt, H, N, P]; cum a [Bt * H, S] fp32 workspace. S a
// multiple of q >= 1, N <= 128, P <= 64. Returns cudaGetLastError() after
// the launch.
int ssd_scan_fwd(const float* x, const float* bm, const float* cm,
                 const float* adt, const float* dt, float* y, float* h_last,
                 float* cum, int bt, int s, int nh, int p, int n, int q,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<<<bt * nh, THREADS, SMEM_BYTES, stream>>>(
      x, bm, cm, adt, dt, y, h_last, cum, s, nh, p, n, q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
