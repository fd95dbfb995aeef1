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
// Per (b, h) and chunk c of Q rows, with the carry h [N, P] starting at 0:
//   cum = prefix sum of adt over the chunk;  CB = C . B^T
//   y   = (CB o L) . (dt x) + e^cum o (C . h_c),  L = tril(e^(cum_i - cum_j))
//   s_c = B^T . (e^(cum_Q - cum) o dt x);  h_(c+1) = e^cum_Q h_c + s_c
// The Pallas kernel writes only y; this one also writes h_last, the carry
// that `apply_mamba2(return_state=True)` returns for decode.
//
// What bounds the function. At mamba2-370m's training shape (Bt = 4,
// S = 1024, H = 32, P = 64, N = 128, Q = 256) it needs about 6.6 GFLOP of
// matrix products (C.B once per (b, chunk), shared by the heads; the causal
// half of (CB o L).(dt x); B^T.w; C.h) and some 0.1 G of elementwise work,
// against about 76 MB of inputs and outputs (0.023 ms at 3.35 TB/s). The
// products must hold 1e-4 of fp32, which one TF32 product misses; 3xTF32
// (`../../common/tf32x3.cuh`) meets it at a third of the TF32 rate, 165
// TFLOP/s: about 0.040 ms, so operations bound it.
//
// Design: the plain version's own staging (`ref.py`: each chunk's terms in
// one batched pass, then the carry chunk by chunk), four kernels whose
// grids fill the card, every product a 3xTF32 `mma.sync` tile:
//  A. `ssd_prep_kernel`, per (b, chunk): CB on the causal 64 x 64 tiles
//     only, once for all heads, into a workspace [Bt, nc, Qp, Qp] (Qp = Q
//     rounded up to 64; zeros past Q), which stays in L2 for the heads
//     that read it; one more CTA per (b, chunk) forms cum, one thread per
//     head, one fixed sequential fp64 sum rounded to fp32 per row, into
//     [Bt, H, S].
//  B. `ssd_state_kernel`, per (b, h, chunk) and half of the state rows:
//     s_c = B^T . w as a [64, 64] tile over the chunk's rows, with
//     e^(cum_Q - cum_j) dt_j folded into the B^T operand, into a workspace
//     [Bt, H, nc, N, 64].
//  C. `ssd_carry_kernel`, per (b, h) and state element: h_c in ascending
//     c, written over s_c in place (the state each chunk starts from), and
//     h_last.
//  D. `ssd_out_kernel`, per (b, h, chunk, 64-row query tile), heaviest
//     tiles first, eight warps of 16 rows x 32 columns: one cp.async
//     double-buffered pipeline runs y = e^cum_i (C_i . h_c) in slabs of 32
//     state rows (skipped for c = 0, where h_c = 0), then the key tiles
//     j <= i in ascending order: the A operand CB_ij e^(cum_i - cum_j) dt_j
//     is formed in fp32 on the CUDA cores as it is loaded, by SELECT on the
//     diagonal tile (zero above it and past the chunk's end; the
//     exponential of a masked entry is never used: above the diagonal
//     cum_i - cum_j > 0 can overflow to inf, and inf * 0 is NaN), times
//     the raw x tile.
// Grids at 4 x 1024, Q = 256: 176, 1 024, 4 096 and 2 048 CTAs. Ragged edges
// (Q not a multiple of 64, N or P below the tile) are zero-filled when
// staged and never written; loads are 16-byte cp.async where P and N are
// multiples of 4 (the VEC instances), plain loads otherwise. The decays of
// D's products use __expf (ex2.approx of x log2 e): for the arguments whose
// terms matter (x > -20) its error, ~1e-6 relative, is 1% of the hold, and
// it is two ops (a multiply and one MUFU) where expf is a dozen; expf
// everywhere else.
//
// No atomics: every output element has one owner thread, and every sum a
// fixed order (the products' k-steps in ascending order, the key tiles
// ascending, the carry ascending in c), so the kernels repeat bit for bit,
// and a row's result depends on its (b, h) only, never on Bt or the
// schedule.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/tf32x3.cuh"

namespace {

using tf32x3::acc_col;
using tf32x3::acc_row;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::pipeline;
using tf32x3::product;
using tf32x3::stage;

constexpr int TILE = 64;                  // rows of a query / key tile
constexpr int NMAX = 128;                 // state size N
constexpr int PMAX = 64;                  // head dim P; the state's row width
constexpr int KS = 32;                    // chunk rows per slab of stage B
// Shared-memory row strides (floats), chosen so that the fragments' reads
// are free of bank conflicts: a stride of 4 mod 32 where the fragment reads
// along a row (lanes g = 0..7 on rows, t = 0..3 on columns), 8 mod 32 where
// it reads down a column.
constexpr int CS = NMAX + 4;              // C and B rows, read along rows
constexpr int BS = TILE + 8;              // B columns read down (B^T)
constexpr int XS = PMAX + 8;              // x and h rows, read down columns
constexpr int PS = TILE + 4;              // CB tile, read along rows

constexpr int PREP_THREADS = 128, STATE_THREADS = 128, CARRY_THREADS = 256,
              OUT_THREADS = 256;
constexpr int PREP_SMEM = 2 * TILE * CS * 4;
constexpr int STATE_SMEM = 2 * (KS * (BS + XS) + KS) * 4;
// D's stages share two buffers: a key tile (the CB tile [TILE][PS] and x
// rows [TILE][XS]) or a slab of KS state rows for y2 (C columns
// [TILE][KS + 4] and state rows [KS][XS]).
constexpr int KEY_FLOATS = TILE * PS + TILE * XS;
constexpr int Y2_CS = KS + 4;
static_assert(TILE * Y2_CS + KS * XS <= KEY_FLOATS, "y2 slab fits a buffer");
constexpr int OUT_SMEM = (2 * KEY_FLOATS + 5 * TILE) * 4;

// A. CB on the causal tiles (blockIdx.x < nt (nt + 1) / 2), or cum (the
// last blockIdx.x), for (b, chunk) = blockIdx.y.
template <bool VEC>
__global__ void __launch_bounds__(PREP_THREADS)
ssd_prep_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ adt, float* __restrict__ cum,
                float* __restrict__ cbw, int s, int nh, int n, int q) {
  const int nc = s / q, nt = (q + TILE - 1) / TILE, qp = nt * TILE;
  const int bc = blockIdx.y, b = bc / nc, t0 = (bc - b * nc) * q;
  const int ntc = nt * (nt + 1) / 2;
  extern __shared__ __align__(16) float smem[];
  if ((int)blockIdx.x == ntc) {           // cum: adt staged in slabs of rows
    const int slab = (2 * TILE * CS) / (nh < PREP_THREADS ? nh : PREP_THREADS);
    const float* a = adt + ((int64_t)b * s + t0) * nh;
    for (int h0 = 0; h0 < nh; h0 += PREP_THREADS) {
      const int hn = min(PREP_THREADS, nh - h0), h = h0 + threadIdx.x;
      float* out = cum + ((int64_t)b * nh + h) * s + t0;
      double run = 0.0;
      for (int r0 = 0; r0 < q; r0 += slab) {
        const int rn = min(slab, q - r0);
        __syncthreads();
        for (int e = threadIdx.x; e < rn * hn; e += PREP_THREADS) {
          const int r = e / hn;
          smem[e] = a[(int64_t)(r0 + r) * nh + h0 + e - r * hn];
        }
        __syncthreads();
        if (threadIdx.x < hn) {
#pragma unroll 8
          for (int r = 0; r < rn; ++r) {
            run += (double)smem[r * hn + threadIdx.x];
            out[r0 + r] = (float)run;
          }
        }
      }
    }
    return;
  }
  int qi = 0;                             // tile (qi, kj), kj <= qi
  while ((qi + 1) * (qi + 2) / 2 <= (int)blockIdx.x) ++qi;
  const int kj = blockIdx.x - qi * (qi + 1) / 2;
  float* cs = smem;                       // [TILE][CS] C rows of the tile
  float* bs = cs + TILE * CS;             // [TILE][CS] B rows
  const int64_t row0 = (int64_t)b * s + t0;
  stage<float, TILE, NMAX, CS, PREP_THREADS, VEC>(cs, cm + row0 * n, n,
                                                  qi * TILE, q, 0, n);
  stage<float, TILE, NMAX, CS, PREP_THREADS, VEC>(bs, bm + row0 * n, n,
                                                  kj * TILE, q, 0, n);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int w = threadIdx.x >> 5;
  const float* ca = cs + 16 * w * CS;
  float acc[1][8][4];
  tf32x3::zero(acc);
  product(acc, 0, n, [&](int r, int k) { return ca[r * CS + k]; },
          [&](int k, int c) { return bs[c * CS + k]; });
  float* out = cbw + ((int64_t)bc * qp + qi * TILE + 16 * w) * qp + kj * TILE;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[acc_row(i) * qp + 8 * ni + acc_col(i)] = acc[0][ni][i];
}

// B. Rows 64 half .. +64 of s_c [N, 64] for (b, h, chunk) = blockIdx.x / 2,
// half = blockIdx.x % 2; four warps of 32 state rows x 32 columns each, the
// chunk's rows in slabs of KS, double buffered.
template <bool VEC>
__global__ void __launch_bounds__(STATE_THREADS)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                 const float* __restrict__ dt, const float* __restrict__ cum,
                 float* __restrict__ sw, int s, int nh, int p, int n, int q) {
  extern __shared__ __align__(16) float smem[];
  float* bsm = smem;                      // [2][KS][BS] B rows, 64 columns
  float* xsm = bsm + 2 * KS * BS;         // [2][KS][XS] x rows
  float* coef = xsm + 2 * KS * XS;        // [2][KS] e^(cum_Q - cum_j) dt_j
  const int n0 = TILE * (blockIdx.x & 1);
  if (n0 >= n) return;
  const int nc = s / q, bhc = blockIdx.x >> 1, bh = bhc / nc;
  const int b = bh / nh, h = bh - b * nh, t0 = (bhc - bh * nc) * q;
  const int tid = threadIdx.x, wm = tid >> 6, wn = (tid >> 5) & 1;
  const int64_t ld = (int64_t)nh * p;
  const float* bb = bm + ((int64_t)b * s + t0) * n;
  const float* xb = x + ((int64_t)b * s + t0) * ld + (int64_t)h * p;
  const float* cg = cum + (int64_t)bh * s + t0;
  const float* db = dt + ((int64_t)b * s + t0) * nh + h;
  const float cum_last = cg[q - 1];
  float acc[2][4][4];
  tf32x3::zero(acc);
  pipeline(
      (q + KS - 1) / KS,
      [&](int kk, int buf) {
        const int j0 = kk * KS;
        stage<float, KS, TILE, BS, STATE_THREADS, VEC>(bsm + buf * KS * BS,
                                                       bb, n, j0, q, n0, n);
        stage<float, KS, PMAX, XS, STATE_THREADS, VEC>(xsm + buf * KS * XS,
                                                       xb, ld, j0, q, 0, p);
        if (tid < KS) {
          const int j = j0 + tid;
          coef[buf * KS + tid] =
              j < q ? expf(cum_last - cg[j]) * db[(int64_t)j * nh] : 0.f;
        }
        cp_async_commit();
      },
      [&](int, int buf) {
        if (n0 + 32 * wm >= n) return;
        const float* bt = bsm + buf * KS * BS + 32 * wm;
        const float* xt = xsm + buf * KS * XS + 32 * wn;
        const float* cf = coef + buf * KS;
        product(acc, 0, KS,
                [&](int r, int k) { return bt[k * BS + r] * cf[k]; },
                [&](int k, int c) { return xt[k * XS + c]; });
      });
  float* out = sw + (int64_t)bhc * n * PMAX;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = n0 + 32 * wm + 16 * mi + acc_row(i);
        if (r < n)
          out[r * PMAX + 32 * wn + 8 * ni + acc_col(i)] = acc[mi][ni][i];
      }
}

// C. The carry, one thread per (b, h) and four state elements: s_c is
// replaced by the state chunk c starts from; h_last gets the state after
// the last chunk.
__global__ void __launch_bounds__(CARRY_THREADS)
ssd_carry_kernel(const float* __restrict__ cum, float* __restrict__ sw,
                 float* __restrict__ h_last, int s, int p, int n, int q) {
  const int per = n * PMAX / 4;           // float4s of one state
  const int blocks = (per + CARRY_THREADS - 1) / CARRY_THREADS;
  const int bh = blockIdx.x / blocks;
  const int e = (blockIdx.x - bh * blocks) * CARRY_THREADS + threadIdx.x;
  if (e >= per) return;
  const int nc = s / q;
  float4* base = reinterpret_cast<float4*>(sw) + (int64_t)bh * nc * per + e;
  const float* cg = cum + (int64_t)bh * s + q - 1;
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const float4 v = base[(int64_t)c * per];
    const float d = expf(cg[(int64_t)c * q]);
    base[(int64_t)c * per] = hv;
    hv = make_float4(d * hv.x + v.x, d * hv.y + v.y, d * hv.z + v.z,
                     d * hv.w + v.w);
  }
  const int r = 4 * e / PMAX, col = 4 * e - r * PMAX;
  float* out = h_last + ((int64_t)bh * n + r) * p + col;
  const float vals[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < p) out[i] = vals[i];
}

// D. y for the query tile (nt - 1 - blockIdx.x) of head blockIdx.y and
// (b, chunk) blockIdx.z; eight warps of 16 query rows x 32 columns. The
// stages run through one double-buffered pipeline: for c > 0 the slabs of
// y2 = C_i . h_c over the state rows (scaled by e^cum_i after the last),
// then the key tiles kt = 0 .. qt.
template <bool VEC>
__global__ void __launch_bounds__(OUT_THREADS)
ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ cm,
               const float* __restrict__ dt, const float* __restrict__ cum,
               const float* __restrict__ cbw, const float* __restrict__ sw,
               float* __restrict__ y, int s, int nh, int p, int n, int q) {
  extern __shared__ __align__(16) float smem[];   // [2][KEY_FLOATS] buffers
  float* cq = smem + 2 * KEY_FLOATS;      // [TILE] cum of the query rows
  float* ck = cq + TILE;                  // [2][TILE] cum of the key rows
  float* kd = ck + 2 * TILE;              // [2][TILE] dt of the key rows
  const int nc = s / q, nt = (q + TILE - 1) / TILE, qp = nt * TILE;
  const int qt = nt - 1 - blockIdx.x, h = blockIdx.y, bc = blockIdx.z;
  const int b = bc / nc, c = bc - b * nc, bh = b * nh + h;
  const int t0 = c * q, i0 = qt * TILE;
  const int tid = threadIdx.x, w = tid >> 6, wc = 32 * ((tid >> 5) & 1);
  const int64_t ld = (int64_t)nh * p;
  const float* cg = cum + (int64_t)bh * s + t0;
  if (tid < TILE) cq[tid] = i0 + tid < q ? cg[i0 + tid] : 0.f;
  const float* cqw = cq + 16 * w;
  const float* cb = cm + ((int64_t)b * s + t0) * n;
  const float* hc = sw + ((int64_t)bh * nc + c) * n * PMAX;
  const float* xb = x + ((int64_t)b * s + t0) * ld + (int64_t)h * p;
  const float* db = dt + ((int64_t)b * s + t0) * nh + h;
  const float* cbt = cbw + ((int64_t)bc * qp + i0) * qp;
  const int ny2 = c > 0 ? (n + KS - 1) / KS : 0;  // h_0 = 0: no y2
  float acc[1][4][4];
  tf32x3::zero(acc);
  pipeline(
      ny2 + qt + 1,
      [&](int kk, int buf) {
        float* kb = smem + buf * KEY_FLOATS;
        if (kk < ny2) {                   // C_i[:, k0 .. +KS), h_c[k0 .. +KS]
          const int k0 = kk * KS;
          stage<float, TILE, KS, Y2_CS, OUT_THREADS, VEC>(kb, cb, n, i0, q,
                                                          k0, n);
          stage<float, KS, PMAX, XS, OUT_THREADS, true>(
              kb + TILE * Y2_CS, hc, PMAX, k0, n, 0, PMAX);
        } else {                          // key tile kt: CB_ij, x_j, cum_j, dt_j
          const int j0 = (kk - ny2) * TILE;
          stage<float, TILE, TILE, PS, OUT_THREADS, true>(kb, cbt, qp, 0,
                                                          TILE, j0, qp);
          stage<float, TILE, PMAX, XS, OUT_THREADS, VEC>(kb + TILE * PS, xb,
                                                         ld, j0, q, 0, p);
          if (tid < TILE) {
            const int j = j0 + tid;
            ck[buf * TILE + tid] = j < q ? cg[j] : 0.f;
            kd[buf * TILE + tid] = j < q ? db[(int64_t)j * nh] : 0.f;
          }
        }
        cp_async_commit();
      },
      [&](int kk, int buf) {
        const float* kb = smem + buf * KEY_FLOATS;
        if (kk < ny2) {
          const float* ca = kb + 16 * w * Y2_CS;
          const float* hs = kb + TILE * Y2_CS + wc;
          product(acc, 0, KS, [&](int r, int k) { return ca[r * Y2_CS + k]; },
                  [&](int k, int col) { return hs[k * XS + col]; });
          if (kk == ny2 - 1) {
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[0][ni][i] *= expf(cqw[acc_row(i)]);
          }
          return;
        }
        const float* pa = kb + 16 * w * PS;
        const float* xt = kb + TILE * PS + wc;
        const float* kc = ck + buf * TILE;
        const float* kdt = kd + buf * TILE;
        auto x_op = [&](int k, int col) { return xt[k * XS + col]; };
        if (kk - ny2 < qt) {              // wholly below the diagonal
          product(acc, 0, TILE,
                  [&](int r, int j) {
                    return pa[r * PS + j] * (__expf(cqw[r] - kc[j]) * kdt[j]);
                  },
                  x_op);
        } else {                          // the diagonal tile: select j <= i
          const int li0 = 16 * w, lim = q - i0;
          product(acc, 0, li0 + 16,
                  [&](int r, int j) {
                    const int li = li0 + r;
                    return j <= li && li < lim
                               ? pa[r * PS + j] *
                                     (__expf(cqw[r] - kc[j]) * kdt[j])
                               : 0.f;
                  },
                  x_op);
        }
      });
  float* yb = y + ((int64_t)b * s + t0) * ld + (int64_t)h * p;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int li = 16 * w + acc_row(i), col = wc + 8 * ni + acc_col(i);
      if (i0 + li < q && col < p)
        yb[(int64_t)(i0 + li) * ld + col] = acc[0][ni][i];
    }
}

template <bool VEC>
int launch(const float* x, const float* bm, const float* cm, const float* adt,
           const float* dt, float* y, float* h_last, float* cum, float* cbw,
           float* sw, int bt, int s, int nh, int p, int n, int q,
           cudaStream_t stream) {
  static uint64_t ready = 0;  // devices whose dynamic smem limits are raised
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(ready >> dev & 1)) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_prep_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        PREP_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_state_kernel<VEC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 STATE_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_out_kernel<VEC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 OUT_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready |= uint64_t{1} << dev;
  }
  const int nc = s / q, nt = (q + TILE - 1) / TILE;
  ssd_prep_kernel<VEC><<<dim3(nt * (nt + 1) / 2 + 1, bt * nc), PREP_THREADS,
                         PREP_SMEM, stream>>>(bm, cm, adt, cum, cbw, s, nh, n,
                                              q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_kernel<VEC><<<2 * bt * nh * nc, STATE_THREADS, STATE_SMEM,
                          stream>>>(
      x, bm, dt, cum, sw, s, nh, p, n, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n * PMAX / 4 + CARRY_THREADS - 1) / CARRY_THREADS;
  ssd_carry_kernel<<<bt * nh * blocks, CARRY_THREADS, 0, stream>>>(
      cum, sw, h_last, s, p, n, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_out_kernel<VEC><<<dim3(nt, nh, bt * nc), OUT_THREADS, OUT_SMEM,
                        stream>>>(x, cm, dt, cum, cbw, sw, y, s, nh, p, n, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest state size N and head dim P the kernels take.
int ssd_scan_max_n() { return NMAX; }

int ssd_scan_max_p() { return PMAX; }

// x [Bt, S, H, P], bm / cm [Bt, S, N], adt / dt [Bt, S, H], contiguous fp32;
// y like x, h_last [Bt, H, N, P]. Workspaces, fp32, 16-byte aligned: cum
// [Bt, H, S], cbw [Bt, S / q, Qp, Qp] with Qp = q rounded up to 64, sw
// [Bt, H, S / q, N, 64].
// S a multiple of q >= 1, N <= 128, P <= 64; vec = 1 when P and N are
// multiples of 4 and x, bm and cm are 16-byte aligned. Four launches on
// `stream`; returns the first cudaError (0 on success).
int ssd_scan_fwd(const float* x, const float* bm, const float* cm,
                 const float* adt, const float* dt, float* y, float* h_last,
                 float* cum, float* cbw, float* sw, int bt, int s, int nh,
                 int p, int n, int q, int vec, cudaStream_t stream) {
  return vec ? launch<true>(x, bm, cm, adt, dt, y, h_last, cum, cbw, sw, bt,
                            s, nh, p, n, q, stream)
             : launch<false>(x, bm, cm, adt, dt, y, h_last, cum, cbw, sw, bt,
                             s, nh, p, n, q, stream);
}

}  // extern "C"
