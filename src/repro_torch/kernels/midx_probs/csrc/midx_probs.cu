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
// What bounds it on the card. At decode (T = 4 slots, D = 2048, K = 64, RQ)
// the call reads both codebooks (2·64·2048·4 B = 1 MB) and z, and does about
// 2 MFLOP: it is bound by bytes (0.3 µs at 3.35 TB/s), and in practice by
// how many SMs share the reading and by the launch latency; at training
// (T = 1024, D = 200, K = 32) by its FLOPs. The TPU kernel kept both
// codebooks resident in VMEM for the whole grid; 1 MB of fp32 codebooks
// does not fit a Hopper CTA's 227 KB of shared memory, and one CTA per
// block of rows left a decode wave's reading to a single SM.
//
// Design: two kernels, with the depth of the products split into fixed
// slices.
//   - partials (`midx_part_kernel`, grid (T/16, slices)): CTA (i, j) reads
//     slice j (64 columns) of both codebooks and of the rows of z once,
//     with 16-byte loads (plain loads where the widths or pointers do not
//     allow them), into shared memory, and each thread accumulates 2 rows
//     x 2 codewords of s1 and of s2 in registers over the slice, in
//     ascending d (fp32 FMA, float4 shared reads: 8 FMA a read), into a
//     workspace part [slices, T, 2K]. At llama decode that is 32 CTAs each
//     reading 32 KB, where one SM read 1 MB;
//   - finish (`midx_finish_kernel`, one warp per row): the row's partials
//     summed in ascending slice order, then c2, ψ (a K-long FMA chain per
//     k1, counts staged in shared memory), logψ and lse (warp reductions).
// Why the order of sums keeps serving's guarantees. The slices are 64
// columns wide and their number, ceil(Dc / 64), follows the codeword width
// alone, never T: in a decode wave T is the number of live slots, which
// differs between the batched run and the solo replay, and a slicing that
// followed T would change a row's order of sums. Every other sum is the
// row's own, in a fixed order. So a row's outputs are the same bits
// whatever T is and whichever tile holds it: batched == solo, and bitwise
// replay. The count is decided here alone (`midx_probs_slices`, which the
// wrapper asks to size the workspace). Supports K <= 64 (the wrapper
// checks).
//
// Quantized mode (the TPU kernel's `quantized` branch, DESIGN §12): the
// codebooks are int8 or fp8-e4m3 [K, Dc] with [K] fp32 per-codeword
// scales. The partials read the 1-byte codewords and convert them to fp32
// in registers on their way to shared memory (a 16-byte load carries 16
// codebook elements where Dc is a multiple of 16, an 8-byte load 8 where
// it is a multiple of 8, e.g. paper-lm's Dc = 200; plain loads else), so
// the products and the slicing are the fp32 mode's. The finish multiplies
// s1 and s2 by the scales after the ascending-slice sum and before c2:
// the plain version's order, (z · qᵀ) · s. At llama decode the codebook
// reads shrink from 1 MB to 256 KB; a row's bits still follow D alone.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KMAX = 64;                    // largest codebook size
constexpr int DS = 64;                      // columns of one slice
constexpr int LDS = DS + 4;                 // shared row stride: 16-byte
                                            // rows, conflict-free float4 reads
constexpr int TR = 16;                      // query rows of a partials CTA
constexpr int THREADS = 256;                // 8 warps of 2 rows
constexpr int RW = TR / (THREADS / 32);     // rows of a warp
constexpr int FR = 8;                       // rows of a finish CTA, a warp each
constexpr int V4 = DS / 4;                  // float4 columns of a slice row
// counts entries of the finish's staging, per thread
constexpr int CNT_LOADS = KMAX * KMAX / (FR * 32);
static_assert(TR * V4 == THREADS && KMAX * KMAX % (FR * 32) == 0,
              "the staging loops assume these sizes");

__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        bool ok) {
  return ok ? *reinterpret_cast<const float4*>(p)
            : make_float4(0.f, 0.f, 0.f, 0.f);
}

// A codebook element as fp32: fp32 as is, int8 and fp8-e4m3 exactly.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return (float)x; }

// EC consecutive codebook elements, EC·sizeof(C) = 16 or 8 bytes, as one
// load (zeros where !ok), and their conversion to fp32.
template <typename C, int EC>
struct CbChunk {
  using Raw = typename std::conditional<EC * sizeof(C) == 16, uint4,
                                        uint2>::type;
  static_assert(EC * sizeof(C) == 16 || EC * sizeof(C) == 8,
                "a codebook load is 16 or 8 bytes");
  Raw raw;
  __device__ __forceinline__ void load(const C* __restrict__ p, bool ok) {
    if (ok) {
      raw = *reinterpret_cast<const Raw*>(p);
    } else {
      raw = Raw{};
    }
  }
  __device__ __forceinline__ void store(float* dst) const {
    const C* e = reinterpret_cast<const C*>(&raw);
#pragma unroll
    for (int i = 0; i < EC; i += 4) {
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(to_f(e[i]), to_f(e[i + 1]), to_f(e[i + 2]),
                      to_f(e[i + 3]));
    }
  }
};

// Slice blockIdx.y of the rows blockIdx.x of z against both codebooks:
// part[slice, t, k] = Σ_d z1[t, d] C1[k, d], part[slice, t, K + k] = Σ_d
// z2[t, d] C2[k, d], over the slice's columns d in ascending order. C: the
// codebooks' element type (fp32, or int8 / fp8 in the quantized mode),
// converted to fp32 as it is staged. EC > 0: vector global loads, EC
// codebook elements (16 or 8 bytes) a load and float4 loads of z (Dc a
// multiple of EC, D of 4, aligned pointers); EC = 0: plain loads. Every
// route stages the same shared tiles, zeros past T, K and Dc, so all give
// the same bits.
template <typename C, int EC>
__global__ void __launch_bounds__(THREADS)
midx_part_kernel(const float* __restrict__ z, const C* __restrict__ cb1,
                 const C* __restrict__ cb2, float* __restrict__ part,
                 int T, int D, int K, int split) {
  __shared__ __align__(16) float cs[2][KMAX][LDS];   // C1, C2 slices
  __shared__ __align__(16) float zs[2][TR][LDS];     // z1, z2 (PQ) slices
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * TR, d0 = blockIdx.y * DS;
  const int dc = split ? D / 2 : D;         // codeword width
  if constexpr (EC > 0) {
    constexpr int CR = DS / EC;             // loads of a slice row
    constexpr int CB_LOADS = 2 * KMAX * CR / THREADS;
    static_assert(2 * KMAX * CR % THREADS == 0, "whole loads per thread");
    CbChunk<C, EC> v[CB_LOADS];
#pragma unroll
    for (int i = 0; i < CB_LOADS; ++i) {    // every load in flight at once
      const int idx = tid + i * THREADS, book = idx / (KMAX * CR);
      const int k = idx / CR % KMAX, c = EC * (idx % CR);
      v[i].load((book ? cb2 : cb1) + (size_t)k * dc + d0 + c,
                k < K && d0 + c < dc);
    }
    float4 w[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = tid / V4, c = 4 * (tid % V4), t = t0 + r;
      w[q] = load4(z + (size_t)t * D + q * dc + d0 + c,
                   (q == 0 || split) && t < T && d0 + c < dc);
    }
#pragma unroll
    for (int i = 0; i < CB_LOADS; ++i) {
      const int idx = tid + i * THREADS, book = idx / (KMAX * CR);
      v[i].store(&cs[book][idx / CR % KMAX][EC * (idx % CR)]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
      *reinterpret_cast<float4*>(&zs[q][tid / V4][4 * (tid % V4)]) = w[q];
  } else {
    for (int idx = tid; idx < 2 * KMAX * DS; idx += THREADS) {
      const int book = idx / (KMAX * DS), k = idx / DS % KMAX, c = idx % DS;
      const bool ok = k < K && d0 + c < dc;
      cs[book][k][c] =
          ok ? to_f((book ? cb2 : cb1)[(size_t)k * dc + d0 + c]) : 0.f;
    }
    for (int idx = tid; idx < 2 * TR * DS; idx += THREADS) {
      const int q = idx / (TR * DS), r = idx / DS % TR, c = idx % DS;
      const int t = t0 + r;
      const bool ok = (q == 0 || split) && t < T && d0 + c < dc;
      zs[q][r][c] = ok ? z[(size_t)t * D + q * dc + d0 + c] : 0.f;
    }
  }
  __syncthreads();
  const int r0 = warp * RW;
  if (t0 + r0 >= T) return;                 // no live row in this warp
  const int zq2 = split ? 1 : 0;
  float a1[RW][2] = {}, a2[RW][2] = {};
#pragma unroll
  for (int d = 0; d < DS; d += 4) {
    float4 c1[2], c2[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      c1[c] = *reinterpret_cast<const float4*>(&cs[0][lane + 32 * c][d]);
      c2[c] = *reinterpret_cast<const float4*>(&cs[1][lane + 32 * c][d]);
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float4 x1 = *reinterpret_cast<const float4*>(&zs[0][r0 + r][d]);
      const float4 x2 = *reinterpret_cast<const float4*>(&zs[zq2][r0 + r][d]);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        a1[r][c] = fmaf(x1.x, c1[c].x, a1[r][c]);
        a1[r][c] = fmaf(x1.y, c1[c].y, a1[r][c]);
        a1[r][c] = fmaf(x1.z, c1[c].z, a1[r][c]);
        a1[r][c] = fmaf(x1.w, c1[c].w, a1[r][c]);
        a2[r][c] = fmaf(x2.x, c2[c].x, a2[r][c]);
        a2[r][c] = fmaf(x2.y, c2[c].y, a2[r][c]);
        a2[r][c] = fmaf(x2.z, c2[c].z, a2[r][c]);
        a2[r][c] = fmaf(x2.w, c2[c].w, a2[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int t = t0 + r0 + r;
    if (t >= T) continue;
    float* out = part + ((size_t)blockIdx.y * T + t) * 2 * K;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k = lane + 32 * c;
      if (k < K) {
        out[k] = a1[r][c];
        out[K + k] = a2[r][c];
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

// Row t = blockIdx.x FR + warp: s1, s2 as the sums of its `slices`
// partials in ascending slice order (times the codewords' scales sc1, sc2
// in the quantized mode; null pointers else), then c2, ψ, logψ and lse.
// Lane l owns codewords l and l + 32.
__global__ void __launch_bounds__(FR * 32)
midx_finish_kernel(const float* __restrict__ part,
                   const float* __restrict__ counts,
                   const float* __restrict__ sc1,
                   const float* __restrict__ sc2,
                   float* __restrict__ s1_out, float* __restrict__ s2_out,
                   float* __restrict__ lpsi_out, float* __restrict__ lse_out,
                   int T, int K, int slices) {
  __shared__ float cnt[KMAX][KMAX + 1];
  __shared__ float e2s[FR][KMAX];           // exp(s2 - c2) of each warp's row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float cv[CNT_LOADS];
#pragma unroll
  for (int i = 0; i < CNT_LOADS; ++i) {     // every load in flight at once
    const int e = tid + i * FR * 32;
    cv[i] = e < K * K ? counts[e] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < CNT_LOADS; ++i) {
    const int e = tid + i * FR * 32;
    if (e < K * K) cnt[e / K][e % K] = cv[i];
  }
  __syncthreads();
  const int t = blockIdx.x * FR + warp;
  if (t >= T) return;
  bool own[2];
  float s1[2] = {}, s2[2] = {};
#pragma unroll
  for (int c = 0; c < 2; ++c) own[c] = lane + 32 * c < K;
#pragma unroll 16
  for (int j = 0; j < slices; ++j) {        // 16 slices' loads in flight
    const float* p = part + ((size_t)j * T + t) * 2 * K;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (own[c]) {
        s1[c] += p[lane + 32 * c];
        s2[c] += p[K + lane + 32 * c];
      }
    }
  }
  if (sc1 != nullptr) {                     // quantized: (z · qᵀ) · s
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (own[c]) {
        s1[c] *= sc1[lane + 32 * c];
        s2[c] *= sc2[lane + 32 * c];
      }
    }
  }
  float c2 = -INFINITY;
#pragma unroll
  for (int c = 0; c < 2; ++c)
    if (own[c]) c2 = fmaxf(c2, s2[c]);
  c2 = warp_max(c2);
#pragma unroll
  for (int c = 0; c < 2; ++c)
    if (own[c]) e2s[warp][lane + 32 * c] = expf(s2[c] - c2);
  __syncwarp();
  float l1[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (!own[c]) continue;
    const int k1 = lane + 32 * c;
    float psi = 0.f;
    for (int k2 = 0; k2 < K; ++k2) psi = fmaf(e2s[warp][k2], cnt[k1][k2], psi);
    const float lp = logf(fmaxf(psi, 1e-30f)) + c2;
    const size_t o = (size_t)t * K + k1;
    s1_out[o] = s1[c];
    s2_out[o] = s2[c];
    lpsi_out[o] = lp;
    l1[c] = s1[c] + lp;
  }
  const float m = warp_max(fmaxf(l1[0], l1[1]));
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < 2; ++c)
    if (own[c]) acc += expf(l1[c] - m);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) lse_out[t] = logf(acc) + m;
}

template <typename C, int EC>
void launch_part(const float* z, const void* cb1, const void* cb2,
                 float* part, int T, int D, int K, int split, dim3 grid,
                 cudaStream_t s) {
  midx_part_kernel<C, EC><<<grid, THREADS, 0, s>>>(
      z, static_cast<const C*>(cb1), static_cast<const C*>(cb2), part, T, D,
      K, split);
}

// The partials of 1-byte codebooks: 16-byte loads where Dc is a multiple
// of 16 and the codebooks 16-byte aligned, 8-byte loads where Dc is a
// multiple of 8 and they are 8-byte aligned, else plain loads.
template <typename C>
void launch_part_bytes(const float* z, const void* cb1, const void* cb2,
                       float* part, int T, int D, int K, int split, int dc,
                       bool zvec, dim3 grid, cudaStream_t s) {
  const uintptr_t a = (uintptr_t)cb1 | (uintptr_t)cb2;
  if (zvec && dc % 16 == 0 && a % 16 == 0)
    launch_part<C, 16>(z, cb1, cb2, part, T, D, K, split, grid, s);
  else if (zvec && dc % 8 == 0 && a % 8 == 0)
    launch_part<C, 8>(z, cb1, cb2, part, T, D, K, split, grid, s);
  else
    launch_part<C, 0>(z, cb1, cb2, part, T, D, K, split, grid, s);
}

}  // namespace

extern "C" int midx_probs_max_k() { return KMAX; }

// The number of slices of a row's products: ceil(Dc / 64), Dc = D/2 (PQ) or
// D (RQ). It takes no T, so a row's order of sums is the same in a batched
// decode wave and in its solo replay.
extern "C" int midx_probs_slices(int D, int split) {
  return ((split ? D / 2 : D) + DS - 1) / DS;
}

// Launches on `stream`; allocates nothing and does not synchronise.
// Returns cudaGetLastError() after the launches (0 on success). part is
// the workspace [midx_probs_slices(D, split), T, 2K] fp32. cb_kind: 0 =
// fp32 codebooks (sc1 and sc2 null), 1 = int8, 2 = fp8-e4m3 (the quantized
// mode: sc1 and sc2 the [K] fp32 scales). fp32 partials take 16-byte loads
// where Dc and D are multiples of 4 and z, cb1 and cb2 are 16-byte
// aligned, else plain loads (the same bits); 1-byte codebooks as
// `launch_part_bytes` says.
extern "C" int midx_probs_launch(const float* z, const void* cb1,
                                 const void* cb2, const float* counts,
                                 const float* sc1, const float* sc2,
                                 float* s1, float* s2, float* lpsi,
                                 float* lse, float* part, int T, int D,
                                 int K, int split, int cb_kind,
                                 void* stream) {
  if (K < 1 || K > KMAX || T < 0 || D < 1 || (split && D % 2) ||
      cb_kind < 0 || cb_kind > 2 || (cb_kind > 0) != (sc1 != nullptr) ||
      (sc1 == nullptr) != (sc2 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return 0;
  const int dc = split ? D / 2 : D, slices = midx_probs_slices(D, split);
  const bool zvec = dc % 4 == 0 && D % 4 == 0 && (uintptr_t)z % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((T + TR - 1) / TR, slices);
  if (cb_kind == 1) {
    launch_part_bytes<int8_t>(z, cb1, cb2, part, T, D, K, split, dc, zvec,
                              grid, s);
  } else if (cb_kind == 2) {
    launch_part_bytes<__nv_fp8_e4m3>(z, cb1, cb2, part, T, D, K, split, dc,
                                     zvec, grid, s);
  } else if (zvec && ((uintptr_t)cb1 | (uintptr_t)cb2) % 16 == 0) {
    launch_part<float, 4>(z, cb1, cb2, part, T, D, K, split, grid, s);
  } else {
    launch_part<float, 0>(z, cb1, cb2, part, T, D, K, split, grid, s);
  }
  const int err = (int)cudaGetLastError();
  if (err) return err;
  midx_finish_kernel<<<(T + FR - 1) / FR, FR * 32, 0, s>>>(
      part, counts, sc1, sc2, s1, s2, lpsi, lse, T, K, slices);
  return (int)cudaGetLastError();
}
