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
// The forward: what bounds it on this card. It reads, per token, M + 1
// random table rows, h and M ids and log q, and writes two floats: at
// paper-lm (T = 1024, M = 20, D = 200 fp32) about 7 MB of distinct bytes,
// ~2 µs at 3.35 TB/s, for 2·(M+1)·D FLOPs a token — one FLOP per byte, so
// bytes, not operations. At that size the card is never near its memory
// rate: a call is a few round trips to memory, and what costs is how many
// of them run one after the other. The first design (a warp per token, the
// rows read in dependent rounds: the positive's, then groups of 8
// negatives, each in ceil(D / (32·VEC)) rounds) made about 8 of them a
// token at paper-lm and 72 at llama width (M = 64, D = 2048 bf16, where a
// token's 65 rows are 266 KB and the call ~270 MB of gathers: there the
// memory rate does bound it).
//
// How the design answers that (`fwd_ring_kernel`, one CTA of FW warps a
// token): warp 0 loads the token's ids, log q and positive id in one round
// trip into shared memory; then all of the token's rows that fit go into
// shared memory in one flight, on mbarriers: h and the positive's row on
// one, the negatives in groups of JG = 8, a group to a stage of a ring of
// up to MAX_NS stages, each on its own. At paper-lm the whole token (h and
// 21 rows, 18 KB) is one flight and all 1024 CTAs fit on the card at once;
// at llama width three stages (96 KB, two CTAs an SM) keep groups in flight
// while a group's dots run, and the CTA refills a stage as soon as every
// warp is done with it (the only CTA barrier in the loop). Dead columns
// past M load nothing. The FW warps share a group's dots (a warp a row),
// put the corrected logits in shared memory, and warp 0 folds them at the
// end. Two ways to copy a row, measured on the card (PERF.md §6): rows of
// 2 KB and more go by one bulk copy each (`cp.async.bulk`, the TMA),
// which keeps the most bytes in flight (1.3× the other way at llama
// width); shorter rows go by 16-byte `cp.async.ca` copies from every
// thread, through L1, so that a row many tokens of an SM draw (a frequent
// class) comes from L2 once an SM: bulk copies of one hot 800-byte row
// from every CTA queue on the same L2 lines (2× slower with one hot row
// at paper-lm). Where D and the pointers allow no 16-byte copies, or a
// stage does not fit in shared memory, the first design runs (`fwd_kernel`,
// plain loads).
//
// Why the bits are the first design's: only where a row comes from
// changes. Every dot keeps `row_dot`'s lane mapping and FMA order (lane l
// takes elements l·VEC + k·32·VEC in ascending k, a fixed FMA chain inside
// each vector, then `warp_sum`'s xor butterfly), reading the same values
// from shared memory instead of global memory; the corrected logits are
// the same expressions; and both kernels fold through the same routines
// (`fold_group`: online (m, l) over groups of 8 in ascending j, then
// `finish_lse` with the positive). So a token's loss and lse depend on
// nothing but the token (not on T, not on its CTA, not on the copy route),
// and the backward, which recomputes the logits with `row_dot` and
// `group_corr`, reads the same lse as before.
//
// The backward: what bounds it is bytes too (it also writes the dense
// d(table) [V, D] fp32: 8 MB at paper-lm, 1.05 GB at llama width, where
// that write is most of the bound). It keeps the [T, M, D] gather and the
// [T, M] logits out of device memory and keeps many row loads in flight:
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
//       L = 64), so a hot row's sum runs on up to 8 warps, not one; each
//       warp first compacts its run to the occurrences of nonzero weight
//       (a zero weight adds nothing, so the bits stay the full chain's).
//   The atomics are on integers only, and every float sum has an order
//   fixed by the ids alone: the result is bitwise repeatable.
//
// Quantized mode (the TPU kernels' `quantized` branch, DESIGN §12): the
// table is int8 or fp8-e4m3 [V, D] with a [V] fp32 per-row scale, and a
// row is dequantized in registers as it is read, e = float(q) · s, before
// its products (the plain version's `rows · s`, then the dot). A row's
// scale is read with its id: by `group_corr` beside the row's loads, and
// in the ring by every thread while the first flight of row copies is in
// the air (one load a column into shared memory, then a CTA barrier
// before the first dot). A 1-byte row goes in 8-byte vectors (8 elements,
// D a multiple of 8; a scalar path else). Copy routes of the ring for
// 1-byte rows: a row of 2 KB or more whose length is a multiple of 16
// (llama width, D = 2048: exactly 2 KB) goes by one TMA bulk copy; a
// shorter row a multiple of 16 by 16-byte `cp.async.ca`; a row that is a
// multiple of 8 bytes only (paper-lm, D = 200: 200 B) by 8-byte
// `cp.async.ca` pieces, as a bulk copy needs 16-byte sizes. The backward
// dequantizes for its logits and dh the same way; d(table) stays
// scale-unaware (Σ coef · h, written unscaled into the master's fp32
// [V, D] gradient): under the straight-through estimator that is the
// master rows' gradient.
//
// Partial mode (the TPU kernels' `include_pos=False`, the vocab-parallel
// head's shard of the loss): the table is this shard's rows, a negative
// the shard does not own comes clipped to local row 0 with lq = +1e30 (so
// its corrected logit is NEG_INF and its weight 0), and p_t is the local
// positive on its owner and -1 elsewhere, used only to mask collisions.
// The positive never joins: the forward writes the negatives-only lse
// (loss = lse; NEG_INF for a token with no valid column), the backward
// reads that partial lse, writes no positive coefficient (coef has M
// columns a token, not M + 1), starts dh at zero and never reads row p_t.
// ln M is the global negative count `num_neg`, not the shard's M. The
// clipped negatives are occurrences of row 0 of coefficient 0: row 0 is a
// hot segment of about T·M·(R−1)/R entries, ordered like any other, so
// d(table) stays bitwise repeatable; `sum_occurrences` skips the reads of
// h for zero coefficients, which add exactly nothing (the same bits).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return (float)x; }

// 1-byte rows are the quantized mode's: they carry a per-row scale.
template <typename T>
constexpr bool kQuant = sizeof(T) == 1;

// A row's scale: its entry of `scale` in the quantized mode, else 1 (and
// never read).
template <typename T>
__device__ __forceinline__ float row_scale(const float* __restrict__ scale,
                                           int64_t id) {
  if constexpr (kQuant<T>) {
    return __ldg(scale + id);
  } else {
    return 1.f;
  }
}

// 8 one-byte elements (an 8-byte word) as fp32.
template <typename T>
__device__ __forceinline__ void bytes8(uint2 v, float (&out)[8]) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = to_f(e[i]);
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

template <int VEC, typename T>
__device__ __forceinline__
    typename std::enable_if<sizeof(T) == 1>::type
    load(const T* p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_f(p[0]);
  } else {
    static_assert(VEC == 8, "1-byte vectors are 8 elements (8 bytes)");
    bytes8<T>(__ldg(reinterpret_cast<const uint2*>(p)), out);
  }
}

// A row's VEC elements, dequantized in the quantized mode (· s).
template <int VEC, typename T>
__device__ __forceinline__ void load_row(const T* p, float s,
                                         float (&out)[VEC]) {
  load<VEC>(p, out);
  if constexpr (kQuant<T>) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] *= s;
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

// h · E[row], full fp32, the same order for every caller; s: the row's
// scale (the quantized mode).
template <typename T, int VEC>
__device__ __forceinline__ float row_dot(const float* hrow, const T* erow,
                                         float s, int D, int lane) {
  float acc = 0.f;
  for (int base = lane * VEC; base < D; base += 32 * VEC) {
    float hv[VEC], ev[VEC];
    load<VEC>(hrow + base, hv);
    load_row<VEC>(erow + base, s, ev);
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
    const float* __restrict__ scale, const float* __restrict__ lq_row,
    const int64_t* __restrict__ id_row, int64_t pid, int j0, int M, int D,
    float log_m, int lane, float (&corr)[JG]) {
  int64_t rid[JG];
  float acc[JG], sc[JG];
  const int64_t dead = pid >= 0 ? pid : 0;  // partial mode: pid may be -1
#pragma unroll
  for (int k = 0; k < JG; ++k) {
    rid[k] = (j0 + k < M) ? id_row[j0 + k] : dead;  // dead columns: a real row
    acc[k] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < JG; ++k) sc[k] = row_scale<T>(scale, rid[k]);
  for (int base = lane * VEC; base < D; base += 32 * VEC) {
    float hv[VEC];
    load<VEC>(hrow + base, hv);
    float ev[JG][VEC];
#pragma unroll
    for (int k = 0; k < JG; ++k)
      load_row<VEC>(table + rid[k] * D + base, sc[k], ev[k]);
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

// The online logsumexp over one group of JG corrected logits, in ascending
// k. Both forward kernels fold through it (and `finish_lse`), so they
// give the same bits.
__device__ __forceinline__ void fold_group(float& m, float& l,
                                           const float (&corr)[JG]) {
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

// The positive folded last: lse over the positive and the groups' (m, l).
__device__ __forceinline__ float finish_lse(float m, float l, float pos) {
  const float m_fin = fmaxf(m, pos);
  const float l_fin = l * expf(m - m_fin) + expf(pos - m_fin);
  return logf(fmaxf(l_fin, 1e-30f)) + m_fin;
}

// Partial mode: the negatives-only lse from the groups' (m, l); NEG_INF
// when no column was valid (m = NEG_INF, l = 0).
__device__ __forceinline__ float partial_lse(float m, float l) {
  return logf(fmaxf(l, 1e-30f)) + m;
}

// The plain-load route: one warp per token, the rows read in rounds from
// global memory. Runs where the ring cannot (no 16-byte copies, or a stage
// too large for shared memory).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ h, const T* __restrict__ table,
           const float* __restrict__ scale,
           const float* __restrict__ log_q, const int64_t* __restrict__ neg_ids,
           const int64_t* __restrict__ pos_ids, float* __restrict__ loss,
           float* __restrict__ lse_out, int nT, int D, int M, float log_m,
           int include_pos) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * WARPS + threadIdx.x / 32;
  if (t >= nT) return;                      // the whole warp leaves together
  const float* hrow = h + (size_t)t * D;
  const int64_t pid = pos_ids[t];
  const float pos = include_pos
                        ? row_dot<T, VEC>(hrow, table + pid * D,
                                          row_scale<T>(scale, pid), D, lane)
                        : 0.f;
  const float* lq_row = log_q + (size_t)t * M;
  const int64_t* id_row = neg_ids + (size_t)t * M;
  float m = NEG_INF, l = 0.f;
  for (int j0 = 0; j0 < M; j0 += JG) {
    float corr[JG];
    group_corr<T, VEC>(hrow, table, scale, lq_row, id_row, pid, j0, M, D,
                       log_m, lane, corr);
    fold_group(m, l, corr);
  }
  const float lse = include_pos ? finish_lse(m, l, pos) : partial_lse(m, l);
  if (lane == 0) {
    loss[t] = include_pos ? lse - pos : lse;
    lse_out[t] = lse;
  }
}

// ------------------------------------------------- the forward's ring
constexpr int FW = 4;                       // warps per token (ring route)
constexpr int FTHREADS = 32 * FW;
constexpr int MAX_NS = 8;                   // stages: M = 64 in one flight
constexpr int RING_BUDGET = 110 * 1024;     // shared memory a CTA aims at:
                                            // two CTAs an SM at llama width
constexpr int BULK_ROW_BYTES = 2048;        // rows this long go by the TMA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile("{\n\t.reg .pred p;\n\t"
               "WAIT_%=:\n\t"
               "mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n\t"
               "@!p bra WAIT_%=;\n\t}"
               ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// P (16 or 8) bytes from global `src` to shared `dst`, both P-byte
// aligned, through L1 (`.ca`): a row that many tokens of an SM draw is
// fetched from L2 once.
template <int P>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(P == 16 || P == 8, "cp.async.ca copies 16 or 8 bytes here");
  if constexpr (P == 16) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;"
                 ::"r"(smem_u32(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                 ::"r"(smem_u32(dst)), "l"(src) : "memory");
  }
}

// This thread's arrival on `bar` once all its earlier cp.async copies have
// landed (each of the CTA's threads arrives once a phase).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];"
               ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// The one arrival a bulk-copy phase waits for, besides its bytes (release:
// the thread's shared-memory writes before it are seen by the waiters).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.shared.b64 st, [%0];\n\t}"
               ::"r"(smem_u32(bar)) : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both 16-byte
// aligned) by the TMA; completes its bytes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The CTA copies `n` rows of `cpr` P-byte chunks, row r from src(r) to
// dst + r·cpr·P, a chunk a thread in turn.
template <int P, typename Src>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int n, int cpr,
                                          Src src) {
  const int step_r = FTHREADS / cpr, step_q = FTHREADS % cpr;
  int r = threadIdx.x / cpr, q = threadIdx.x % cpr;
  while (r < n) {
    cp_async<P>(dst + ((size_t)r * cpr + q) * P,
                reinterpret_cast<const unsigned char*>(src(r)) +
                    (size_t)q * P);
    r += step_r;
    q += step_q;
    if (q >= cpr) {
      q -= cpr;
      ++r;
    }
  }
}

// How the ring copies a row: a TMA bulk copy, or `cp.async.ca` pieces of
// 16 or 8 bytes.
constexpr int ROUTE_BULK = 0;

// One phase of `bar`: rows r < n of `rowb` bytes from src(r) to dst +
// r·rowb. ROUTE_BULK: a bulk copy (TMA) a row from warp 0's lanes, the
// bytes counted on the barrier; else ROUTE-byte cp.async copies from
// every thread.
template <int ROUTE, typename Src>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int n,
                                           int rowb, Src src,
                                           uint64_t* bar) {
  if constexpr (ROUTE == ROUTE_BULK) {
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) mbar_expect_tx(bar, (uint32_t)(n * rowb));
      __syncwarp();
      for (int r = threadIdx.x; r < n; r += 32)
        bulk_copy(dst + (size_t)r * rowb, src(r), (uint32_t)rowb, bar);
      __syncwarp();
      if (threadIdx.x == 0) mbar_arrive(bar);
    }
  } else {
    copy_rows<ROUTE>(dst, n, rowb / ROUTE, src);
    cp_async_arrive(bar);
  }
}

template <int VEC>
__device__ __forceinline__ void load_smem(const float* p, float (&out)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    out[i] = v.x;
    out[i + 1] = v.y;
    out[i + 2] = v.z;
    out[i + 3] = v.w;
  }
}

template <int VEC>
__device__ __forceinline__ void load_smem(const __nv_bfloat16* p,
                                          float (&out)[VEC]) {
  static_assert(VEC == 8, "bf16 vectors are 8 elements (16 bytes)");
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int VEC, typename T>
__device__ __forceinline__
    typename std::enable_if<sizeof(T) == 1>::type
    load_smem(const T* p, float (&out)[VEC]) {
  static_assert(VEC == 8, "1-byte vectors are 8 elements (8 bytes)");
  bytes8<T>(*reinterpret_cast<const uint2*>(p), out);
}

// `row_dot` on rows staged in shared memory: the same lane mapping, FMA
// chain (dequantized as `load_row` does) and butterfly, so the same bits.
template <typename T, int VEC>
__device__ __forceinline__ float smem_dot(const float* hs, const T* row,
                                          float s, int D, int lane) {
  float acc = 0.f;
  for (int base = lane * VEC; base < D; base += 32 * VEC) {
    float hv[VEC], ev[VEC];
    load_smem<VEC>(hs + base, hv);
    load_smem<VEC>(row + base, ev);
    if constexpr (kQuant<T>) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) ev[e] *= s;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc = fmaf(hv[e], ev[e], acc);
  }
  return warp_sum(acc);
}

// The ring's shared memory (dynamic), every piece on a boundary of its
// route's copy (D·elem is a multiple of 16, or of 8 for 1-byte rows): h
// [D] fp32, the positive's row, ns stages of JG rows, then per column
// j < M its id, ln M + lq_j, a collision flag, its corrected logit and,
// in the quantized mode, its row's scale.
template <typename T>
size_t ring_bytes(int D, int M, int ns) {
  return (size_t)D * sizeof(float) + (size_t)(1 + ns * JG) * D * sizeof(T) +
         (size_t)M * (sizeof(int64_t) + (kQuant<T> ? 4 : 3) * sizeof(float));
}

// One CTA per token (see the header): the ids in one round trip, then all
// the rows that fit in one flight of copies on mbarriers (ROUTE_BULK: a
// bulk copy a row; else ROUTE-byte cp.async), a group of JG to a stage; the
// FW warps share the dots (a warp a row); a stage is refilled once every
// warp is done with it; warp 0 folds in the first design's order.
template <typename T, int VEC, int ROUTE>
__global__ void __launch_bounds__(FTHREADS)
fwd_ring_kernel(const float* __restrict__ h, const T* __restrict__ table,
                const float* __restrict__ scale,
                const float* __restrict__ log_q,
                const int64_t* __restrict__ neg_ids,
                const int64_t* __restrict__ pos_ids, float* __restrict__ loss,
                float* __restrict__ lse_out, int D, int M, int ns,
                float log_m, int include_pos) {
  __shared__ uint64_t bar[MAX_NS + 1];      // a barrier a stage; the last:
                                            // h and the positive's row
  __shared__ int64_t pid_s;
  __shared__ float pos_s, psc_s;            // the positive's logit, scale
  constexpr bool BULK = ROUTE == ROUTE_BULK;
  extern __shared__ __align__(16) unsigned char ring[];
  float* hs = reinterpret_cast<float*>(ring);
  T* prow = reinterpret_cast<T*>(hs + D);
  T* stage = prow + D;                      // [ns][JG][D]
  int64_t* ids = reinterpret_cast<int64_t*>(stage + (size_t)ns * JG * D);
  float* sub = reinterpret_cast<float*>(ids + M);
  int* hit = reinterpret_cast<int*>(sub + M);
  float* corr = reinterpret_cast<float*>(hit + M);
  float* scs = corr + M;                    // the rows' scales (quantized)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t t = blockIdx.x;
  const int G = (M + JG - 1) / JG;
  if (warp == 0) {                          // the ids and pid: one round trip
    const int64_t pid = pos_ids[t];
    const float* lq_row = log_q + t * M;
    const int64_t* id_row = neg_ids + t * M;
#pragma unroll 2
    for (int j = lane; j < M; j += 32) {
      const int64_t id = id_row[j];
      const float lq = lq_row[j];
      ids[j] = id;
      sub[j] = log_m + lq;
      hit[j] = id == pid;
    }
    if (lane == 0) {
      pid_s = pid;
      for (int i = 0; i <= MAX_NS; ++i) mbar_init(&bar[i], BULK ? 1 : FTHREADS);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  const int64_t pid = pid_s;
  // the first flight: h and the positive's row (none in the partial
  // mode), then groups 0 .. ns-1
  const int rowb = D * (int)sizeof(T);
  if constexpr (BULK) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar[MAX_NS],
                     (uint32_t)(D * 4 + (include_pos ? rowb : 0)));
      bulk_copy(hs, h + t * D, (uint32_t)D * 4, &bar[MAX_NS]);
      if (include_pos)
        bulk_copy(prow, table + pid * D, (uint32_t)rowb, &bar[MAX_NS]);
      mbar_arrive(&bar[MAX_NS]);
    }
  } else {
    copy_rows<16>(reinterpret_cast<unsigned char*>(hs), 1, D / 4,
                  [&](int) { return h + t * D; });
    if (include_pos)
      copy_rows<ROUTE>(reinterpret_cast<unsigned char*>(prow), 1,
                       rowb / ROUTE, [&](int) { return table + pid * D; });
    cp_async_arrive(&bar[MAX_NS]);
  }
  for (int g = 0; g < min(G, ns); ++g) {
    stage_rows<ROUTE>(
        reinterpret_cast<unsigned char*>(stage + (size_t)g * JG * D),
        min(JG, M - g * JG), rowb,
        [&](int r) { return table + ids[g * JG + r] * D; }, &bar[g]);
  }
  if constexpr (kQuant<T>) {                // the scales, while rows fly
    for (int j = threadIdx.x; j < M; j += FTHREADS)
      scs[j] = __ldg(scale + ids[j]);
    if (threadIdx.x == 0 && include_pos) psc_s = __ldg(scale + pid);
    __syncthreads();
  }
  mbar_wait(&bar[MAX_NS], 0);
  if (warp == FW - 1 && include_pos) {
    const float pos = smem_dot<T, VEC>(hs, prow, psc_s, D, lane);
    if (lane == 0) pos_s = pos;
  }
  for (int g = 0; g < G; ++g) {
    const int s = g % ns, j0 = g * JG;
    mbar_wait(&bar[s], (uint32_t)(g / ns) & 1u);
    T* st = stage + (size_t)s * JG * D;
    for (int k = warp; k < min(JG, M - j0); k += FW) {
      const float dot = smem_dot<T, VEC>(hs, st + (size_t)k * D,
                                         kQuant<T> ? scs[j0 + k] : 1.f, D,
                                         lane);
      if (lane == 0) corr[j0 + k] = hit[j0 + k] ? NEG_INF : dot - sub[j0 + k];
    }
    const int next = g + ns;
    if (next < G) {                         // refill stage s with group next
      __syncthreads();
      stage_rows<ROUTE>(
          reinterpret_cast<unsigned char*>(st), min(JG, M - next * JG), rowb,
          [&](int r) { return table + ids[next * JG + r] * D; }, &bar[s]);
    }
  }
  __syncthreads();                          // every logit and pos_s written
  if (warp == 0) {
    float m = NEG_INF, l = 0.f;
    for (int j0 = 0; j0 < M; j0 += JG) {
      float c[JG];
#pragma unroll
      for (int k = 0; k < JG; ++k) c[k] = j0 + k < M ? corr[j0 + k] : NEG_INF;
      fold_group(m, l, c);
    }
    const float pos = include_pos ? pos_s : 0.f;
    const float lse = include_pos ? finish_lse(m, l, pos) : partial_lse(m, l);
    if (lane == 0) {
      loss[t] = include_pos ? lse - pos : lse;
      lse_out[t] = lse;
    }
  }
}

// ------------------------------------------------------------- backward
// One warp per token: the logits again (`row_dot`, `group_corr`: the
// forward's bits), then dlq, dh and the coefficients coef [T, M1] of the
// d(table) sum (M1 = M + 1, column M the positive; M1 = M in the partial
// mode, which has no positive column); and the count of every
// occurrence's row, by integer atomics (the counts come out the same in
// any order).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
bwd_rows_kernel(const float* __restrict__ g, const float* __restrict__ h,
                const T* __restrict__ table, const float* __restrict__ scale,
                const float* __restrict__ log_q,
                const int64_t* __restrict__ neg_ids,
                const int64_t* __restrict__ pos_ids,
                const float* __restrict__ lse_in, float* __restrict__ dh,
                float* __restrict__ dlq, float* __restrict__ coef,
                int* __restrict__ cnt, int nT, int D, int M, float log_m,
                int include_pos) {
  extern __shared__ float smem[];           // [WARPS][M]: g·w_j per column
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x * WARPS + warp;
  if (t >= nT) return;                      // the whole warp leaves together
  float* cw = smem + (size_t)warp * M;
  const float* hrow = h + (size_t)t * D;
  const int64_t pid = pos_ids[t];
  const int64_t dead = pid >= 0 ? pid : 0;  // a real row for dead columns
  const int M1 = M + (include_pos ? 1 : 0);
  const T* prow = table + dead * D;
  const float* lq_row = log_q + (size_t)t * M;
  const int64_t* id_row = neg_ids + (size_t)t * M;
  for (int j = lane; j < M1; j += 32)
    atomicAdd(cnt + (j < M ? id_row[j] : pid), 1);
  const float gt = g[t], lse = lse_in[t];
  const float psc = include_pos ? row_scale<T>(scale, pid) : 0.f;
  const float pos =
      include_pos ? row_dot<T, VEC>(hrow, prow, psc, D, lane) : 0.f;
  const float cpos = include_pos ? gt * (expf(pos - lse) - 1.f) : 0.f;
  for (int j0 = 0; j0 < M; j0 += JG) {
    float corr[JG];
    group_corr<T, VEC>(hrow, table, scale, lq_row, id_row, pid, j0, M, D,
                       log_m, lane, corr);
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
          coef[(size_t)t * M1 + j] = c;
        }
      }
    }
  }
  if (lane == 0 && include_pos) coef[(size_t)t * M1 + M] = cpos;
  __syncwarp();
  // dh: positive first (zero in the partial mode), then the negatives in
  // ascending j (rows dequantized in the quantized mode).
  for (int base = lane * VEC; base < D; base += 32 * VEC) {
    float acc[VEC];
    if (include_pos) {
      float ev[VEC];
      load_row<VEC>(prow + base, psc, ev);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = cpos * ev[e];
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    }
    for (int j0 = 0; j0 < M; j0 += JG) {
      float er[JG][VEC];
      float c[JG];
#pragma unroll
      for (int k = 0; k < JG; ++k) {
        const bool live = j0 + k < M;
        c[k] = live ? cw[j0 + k] : 0.f;
        const int64_t rid = live ? id_row[j0 + k] : dead;
        load_row<VEC>(table + rid * D + base, row_scale<T>(scale, rid),
                      er[k]);
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

// Each occurrence o = t·M1 + j (j = M: the positive) into its row's
// segment of `order`, at a slot taken by an integer atomic: the segment
// holds the right occurrences in an order that may change from run to run;
// `dtab_kernel` sums them in ascending o.
__global__ void __launch_bounds__(THREADS)
occ_place_kernel(const int64_t* __restrict__ neg_ids,
                 const int64_t* __restrict__ pos_ids, int* __restrict__ cnt,
                 const int* __restrict__ seg, int* __restrict__ order,
                 int nocc, int M, int M1) {
  const int o = blockIdx.x * THREADS + threadIdx.x;
  if (o >= nocc) return;
  const int t = o / M1, j = o - t * M1;
  const int64_t v = j < M ? neg_ids[(size_t)t * M + j] : pos_ids[t];
  order[seg[v] + atomicSub(cnt + v, 1) - 1] = o;
}

constexpr int DT_WARPS = 8;                 // table rows per dtab block
constexpr int DT_THREADS = 32 * DT_WARPS;
constexpr int SHORT = 32;                   // a warp sorts a segment this long
constexpr int PIECE = 64;                   // ranks per warp of a long segment
constexpr int BM_WORDS = 4096;              // the bitmap window: 131 072 bits

// acc += Σ coef[o] · h[o / M1][base ..] over o = occ[p], p in [p0, p1), in
// ascending p: one FMA chain per element. An occurrence of weight 0 (a
// masked collision, or a negative another vocab shard owns, clipped to
// row 0) is skipped without reading its h: fmaf(±0, h, acc) == acc for a
// finite h, as acc starts at +0 and a sum in round-to-nearest never
// becomes −0, so the bits are those of the full chain. This keeps the
// partial mode's row 0, a segment of about T·M·(R−1)/R such entries, from
// reading a row of h for each.
template <int VEC>
__device__ __forceinline__ void sum_occurrences(
    const int* occ, int p0, int p1, const float* __restrict__ coef,
    const float* __restrict__ h, int D, int M1, int base, float (&acc)[VEC]) {
  for (int p = p0; p < p1; ++p) {
    const int o = occ[p];
    const float c = coef[o];
    if (c == 0.f) continue;
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
    // each warp compacts its run in place to the occurrences of nonzero
    // weight, in rank order (a ballot a 32-entry chunk): the zero-weight
    // ones add nothing (`sum_occurrences`), and the run's bounds stay
    // those of the full segment, so the bits are unchanged; the column
    // loop below then reads no index or weight of a zero occurrence.
    int kept = 0;
    if (warp < pieces) {
      int* mine = sorted + o0 + r0;
      for (int b = 0; b < r1 - r0; b += 32) {
        const int p = b + lane;
        const int o = p < r1 - r0 ? mine[p] : 0;
        const bool nz = p < r1 - r0 && coef[o] != 0.f;
        const unsigned mask = __ballot_sync(0xffffffffu, nz);
        if (nz) mine[kept + __popc(mask & ((1u << lane) - 1u))] = o;
        kept += __popc(mask);
      }
      __syncwarp();
    }
    for (int db = 0; db < D; db += 32 * VEC) {
      if (warp < pieces) {
        const int base = db + lane * VEC;
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
        if (base < D) {
          sum_occurrences<VEC>(sorted + o0 + r0, 0, kept, coef, h, D, M1,
                               base, acc);
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

// ln of the correction's negative count: `num_neg` (the global M of the
// partial mode) where given (> 0), else M.
float log_num_neg(int M, int num_neg = 0) {
  const int n = num_neg > 0 ? num_neg : M;
  return (float)log((double)(n > 0 ? n : 1));
}

// The ring's stage count for (D, M): all of a token's groups where they fit
// in RING_BUDGET (at most MAX_NS), else as many as fit, at least one; 0
// where one stage does not fit in a CTA's shared memory.
template <typename T>
int ring_stages(int D, int M) {
  const int groups = (M + JG - 1) / JG;
  int ns = std::max(1, std::min(MAX_NS, groups));
  while (ns > 1 && ring_bytes<T>(D, M, ns) > RING_BUDGET) --ns;
  return ring_bytes<T>(D, M, ns) <= MAX_SMEM - 1024 ? ns : 0;
}

template <typename T, int VEC, int ROUTE>
int ring(const float* h, const void* table, const float* scale,
         const float* log_q, const int64_t* neg_ids, const int64_t* pos_ids,
         float* loss, float* lse, int nT, int D, int M, int ns, float log_m,
         int include_pos, size_t smem, cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;       // the attribute, raised once
  if (smem > smem_set) {
    const int err =
        set_smem((const void*)fwd_ring_kernel<T, VEC, ROUTE>, smem);
    if (err) return err;
    smem_set = smem;
  }
  fwd_ring_kernel<T, VEC, ROUTE><<<nT, FTHREADS, smem, stream>>>(
      h, static_cast<const T*>(table), scale, log_q, neg_ids, pos_ids, loss,
      lse, D, M, ns, log_m, include_pos);
  return (int)cudaGetLastError();
}

// The ring's copy route for rows of `rowb` bytes (a multiple of 16, or of
// 8 for 1-byte rows): the TMA from 2 KB where the length is a multiple of
// 16, else cp.async pieces of 16 bytes where it allows them, else of 8.
inline int ring_route(size_t rowb) {
  if (rowb % 16 != 0) return 8;
  return rowb >= BULK_ROW_BYTES ? ROUTE_BULK : 16;
}

template <typename T, int VEC>
int fwd(const float* h, const void* table, const float* scale,
        const float* log_q, const int64_t* neg_ids, const int64_t* pos_ids,
        float* loss, float* lse, int nT, int D, int M, int include_pos,
        int num_neg, cudaStream_t stream) {
  const float log_m = log_num_neg(M, num_neg);
  if constexpr (VEC > 1) {
    const int ns = ring_stages<T>(D, M);
    if (ns > 0) {
      const size_t smem = ring_bytes<T>(D, M, ns);
      switch (ring_route((size_t)D * sizeof(T))) {
        case ROUTE_BULK:
          return ring<T, VEC, ROUTE_BULK>(h, table, scale, log_q, neg_ids,
                                          pos_ids, loss, lse, nT, D, M, ns,
                                          log_m, include_pos, smem, stream);
        case 16:
          return ring<T, VEC, 16>(h, table, scale, log_q, neg_ids, pos_ids,
                                  loss, lse, nT, D, M, ns, log_m,
                                  include_pos, smem, stream);
        default:
          if constexpr (kQuant<T>) {
            return ring<T, VEC, 8>(h, table, scale, log_q, neg_ids, pos_ids,
                                   loss, lse, nT, D, M, ns, log_m,
                                   include_pos, smem, stream);
          }
          break;
      }
    }
  }
  fwd_kernel<T, VEC><<<(nT + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      h, static_cast<const T*>(table), scale, log_q, neg_ids, pos_ids, loss,
      lse, nT, D, M, log_m, include_pos);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int bwd_rows(const float* g, const float* h, const void* table,
             const float* scale, const float* log_q, const int64_t* neg_ids,
             const int64_t* pos_ids, const float* lse, float* dh, float* dlq,
             float* coef, int* cnt, int nT, int D, int M, int include_pos,
             int num_neg, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * M * sizeof(float);
  const int err = set_smem((const void*)bwd_rows_kernel<T, VEC>, smem);
  if (err) return err;
  bwd_rows_kernel<T, VEC><<<(nT + WARPS - 1) / WARPS, THREADS, smem, stream>>>(
      g, h, static_cast<const T*>(table), scale, log_q, neg_ids, pos_ids,
      lse, dh, dlq, coef, cnt, nT, D, M, log_num_neg(M, num_neg),
      include_pos);
  return (int)cudaGetLastError();
}

// The row type of `table_kind`, with its vector width where `vec`
// (16 bytes: 4 fp32 or 8 bf16; 8 bytes: 8 int8 / fp8), else 1: calls
// f.template operator()<T, VEC>().
enum TableKind { K_F32 = 0, K_BF16 = 1, K_I8 = 2, K_FP8 = 3 };

struct FwdCall {
  const float *h;
  const void* table;
  const float *scale, *log_q;
  const int64_t *neg_ids, *pos_ids;
  float *loss, *lse;
  int nT, D, M, include_pos, num_neg;
  cudaStream_t s;
  template <typename T, int VEC>
  int operator()() const {
    return fwd<T, VEC>(h, table, scale, log_q, neg_ids, pos_ids, loss, lse,
                       nT, D, M, include_pos, num_neg, s);
  }
};

struct BwdRowsCall {
  const float *g, *h;
  const void* table;
  const float *scale, *log_q;
  const int64_t *neg_ids, *pos_ids;
  const float* lse;
  float *dh, *dlq, *coef;
  int* cnt;
  int nT, D, M, include_pos, num_neg;
  cudaStream_t s;
  template <typename T, int VEC>
  int operator()() const {
    return bwd_rows<T, VEC>(g, h, table, scale, log_q, neg_ids, pos_ids, lse,
                            dh, dlq, coef, cnt, nT, D, M, include_pos,
                            num_neg, s);
  }
};

template <typename F>
int by_table(int table_kind, int vec, const F& f) {
  switch (table_kind) {
    case K_F32:
      return vec ? f.template operator()<float, 4>()
                 : f.template operator()<float, 1>();
    case K_BF16:
      return vec ? f.template operator()<__nv_bfloat16, 8>()
                 : f.template operator()<__nv_bfloat16, 1>();
    case K_I8:
      return vec ? f.template operator()<int8_t, 8>()
                 : f.template operator()<int8_t, 1>();
    case K_FP8:
      return vec ? f.template operator()<__nv_fp8_e4m3, 8>()
                 : f.template operator()<__nv_fp8_e4m3, 1>();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int sampled_ce_pt_max_m() { return MAX_M; }

// All launches are on `stream`; nothing is allocated and nothing waits.
// Returns cudaGetLastError() after the launches (0 on success).
// table_kind: 0 = fp32, 1 = bf16, 2 = int8, 3 = fp8-e4m3 table; the last
// two are the quantized mode, `scale` the [V] fp32 row scales (null
// else). vec: 1 = vector loads (D a multiple of 4 (fp32) or 8 (the
// others) and 16-byte aligned rows). include_pos: 1 = the full loss, 0 =
// the partial mode (pos_ids local or -1, only masking collisions; loss =
// lse = the negatives-only lse). num_neg: the M of ln(M·q), 0 for this
// call's M.
extern "C" int sampled_ce_pt_fwd_launch(const float* h, const void* table,
                                        const float* scale,
                                        const float* log_q,
                                        const int64_t* neg_ids,
                                        const int64_t* pos_ids, float* loss,
                                        float* lse, int nT, int D, int M,
                                        int table_kind, int vec,
                                        int include_pos, int num_neg,
                                        void* stream) {
  if (nT < 0 || D < 1 || M < 0 || M > MAX_M || table_kind < K_F32 ||
      table_kind > K_FP8 || (table_kind >= K_I8) != (scale != nullptr) ||
      num_neg < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (nT == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return by_table(table_kind, vec,
                  FwdCall{h, table, scale, log_q, neg_ids, pos_ids, loss, lse,
                          nT, D, M, include_pos ? 1 : 0, num_neg, s});
}

// The backward in one call: a memset and four kernels on `stream`, nothing
// allocated, nothing waited for. With M1 = M + 1 (M in the partial mode,
// include_pos = 0), ws: 4 * (3 * T·M1 + 2 * V + 1) bytes, 4-byte aligned:
// coef [T·M1] fp32, the row counts cnt [V], the segment offsets seg
// [V+1], the placed occurrences order [T·M1] and the sorted long segments
// sorted [T·M1], int32. table_kind, scale, include_pos and num_neg as the
// forward's; in the partial mode lse is the forward's partial lse. vec:
// vectors over h, the table and dh. vec_tab: 16-byte vectors over h and
// dtab (D % 4 == 0, aligned). Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int sampled_ce_pt_bwd_launch(
    const float* g, const float* h, const void* table, const float* scale,
    const float* log_q, const int64_t* neg_ids, const int64_t* pos_ids,
    const float* lse, float* dh, float* dlq, float* dtab, void* ws, int nT,
    int D, int M, int V, int table_kind, int vec, int vec_tab,
    int include_pos, int num_neg, void* stream) {
  include_pos = include_pos ? 1 : 0;
  const int M1 = M + include_pos;
  const long long nocc = (long long)nT * M1;
  if (nT < 0 || D < 1 || M < 0 || M > MAX_M || V < 1 || nocc >= (1LL << 31) ||
      table_kind < K_F32 || table_kind > K_FP8 ||
      (table_kind >= K_I8) != (scale != nullptr) || num_neg < 0) {
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
  const int err = by_table(table_kind, vec,
                           BwdRowsCall{g, h, table, scale, log_q, neg_ids,
                                       pos_ids, lse, dh, dlq, coef, cnt, nT,
                                       D, M, include_pos, num_neg, s});
  if (err) return err;
  occ_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(cnt, seg, V);
  if (nocc > 0)
    occ_place_kernel<<<(unsigned)((nocc + THREADS - 1) / THREADS), THREADS,
                       0, s>>>(neg_ids, pos_ids, cnt, seg, order, (int)nocc,
                               M, M1);
  const dim3 grid((V + DT_WARPS - 1) / DT_WARPS);
  if (vec_tab) {
    dtab_kernel<4><<<grid, DT_THREADS, 0, s>>>(h, coef, order, seg, sorted,
                                               dtab, V, D, M1, (int)nocc);
  } else {
    dtab_kernel<1><<<grid, DT_THREADS, 0, s>>>(h, coef, order, seg, sorted,
                                               dtab, V, D, M1, (int)nocc);
  }
  return (int)cudaGetLastError();
}
