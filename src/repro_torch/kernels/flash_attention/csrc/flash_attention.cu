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
// Scores are (q . k^T) * hd^-0.5 with fp32 sums. The mask keeps
//   kj <= qi + q_offset            (causal)
//   kj >  qi + q_offset - window   (when a window is given)
// and sets every other score to NEG_INF = -1e30. The online softmax
// carries (acc, m, l) in fp32 and writes
//   out = acc / max(l, 1e-30)           in q's dtype, [B, Sq, H, hd]
//   lse = m + log(max(l, 1e-30))        fp32, [B, H, Sq]
// (lse views as the reference's [B, KV, G, Sq], since h = kv * G + g).
// Sq and Sk are multiples of 128 (`flash_attention_block`).
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
// depends on its (b, h) and its query block only, never on the batch.
//
// What bounds it. Causal attention at llama3.2-1b's prefill shape (B = 4,
// S = 4096, H = 32, KV = 8, hd = 64) needs about 1.07e9 unmasked scores
// at 4 * hd operations each (the q.k dot and the p.v update, a
// multiply-add counted as two) plus one exp: 2.75e11 operations against
// 0.17 GB of q, k, v, out and lse. It is bound by operations: 0.279 ms at
// the 989 TFLOP/s of bf16 on the tensor cores. The bf16 route below does
// P.V twice (p split in two bf16 terms, see "Precision of p"), 6 * hd
// tensor-core operations a score where the function needs 4 * hd, and
// computes the causal diagonal's 128 x 128 tiles whole: its own floor is
// about 0.43 ms at that rate.
//
// The bf16 route (`hopper::flash_fwd_wgmma_kernel`). One CTA of 384
// threads per (b, h, block of 128 query rows), grid (Sq / 128, B * H), the
// last query block first (causal blocks there have the most work).
//   - Warps 0-3 and 4-7 are two consumer warpgroups; warpgroup w owns
//     query rows 64w .. 64w + 63 of the block. Warps 8-11 are the
//     producer warpgroup, which gives its registers to the consumers
//     (`setmaxnreg`: 40 each for it, 232 for theirs). The 128 rows are of
//     one head, not 64 rows of each of two heads of a GQA group: one code
//     path then takes every H / KV the wrapper accepts (G = 1 included),
//     both ways a K/V tile in shared memory serves 128 rows, and the
//     group's other heads find the same K/V tile in L2 (all of one
//     sequence's K and V are 8 MB at S = 4096).
//   - Loads. q, k and v tiles land in shared memory in the 128-byte
//     swizzled layout that `wgmma` reads: 64-column (128-byte) slabs of
//     [rows][64] bf16, each 16-byte chunk c of row r at chunk c ^ (r % 8).
//     Where hd is a multiple of 8 and the tensors 16-byte aligned, one
//     producer thread copies them with TMA (4-D tensor maps over [B, S,
//     heads, hd] with the tensors' own strides; columns past hd arrive as
//     zeros), completing a transaction-count mbarrier. Otherwise (hd = 50:
//     its 100-byte head stride is no multiple of 16) the producer
//     warpgroup copies them with plain loads into the same layout, fences
//     them to the async proxy and arrives on the same barriers. K and V
//     stream through a ring of STAGES = 3 stages: the producer refills a
//     stage once both warpgroups have released it ("empty" barrier, 256
//     arrivals), so tiles j + 1 and j + 2 load while tile j is computed.
//   - S = Q . K^T: `wgmma.m64n{BK}k16.f32.bf16.bf16`, both operands
//     K-major in shared memory (no transposed copy of K), fp32
//     accumulators in registers; BK = 128 keys at hd <= 64, 64 at
//     hd = 128 (registers). The scale multiplies the fp32 scores, never
//     q: q rounded to bf16 after scaling would move a score by up to
//     2^-9 |s|, more than the lse hold takes.
//   - The online softmax runs in registers on the accumulator fragment,
//     in the log2 domain: masked raw scores set by select to MASK = -2^100
//     (skipped for tiles the mask leaves whole), the row max over the 4
//     threads of a row (xor shuffles, every lane the same bits), then
//     m = max(m, max * scale log2 e), alpha = 2^(m_old - m) and
//     p = 2^(s * scale log2 e - m) with one FMA and `ex2.approx` (relative
//     error about 2^-22), all fp32. MASK * scale log2 e is exact, so a row
//     that has seen no allowed key gets p = 2^0 = 1 from a masked score,
//     and alpha = 0 at its first allowed key, as with NEG_INF above; lse
//     = m ln 2 + log(l), or NEG_INF + log(l) for such a row. l sums the
//     fp32 p per thread; the 4 partial sums are added once at the end.
//   - O += P . V: A from registers (the S fragment's layout is the A
//     fragment's, element for element), V MN-major in shared memory as
//     loaded ([keys][hd], the transpose bit), one m64n64k16 per 64 output
//     columns and 16 keys.
//   - Precision of p. The plain version keeps p in fp32. One rounding of
//     p to bf16 (relative error 2^-9) moves out by about 1e-3 of its
//     size, above the bf16 hold of 2^-7 |plain| + 1e-5 where out is near
//     0 (tests/test_torch_flash_attention.py::
//     test_pv_rounding_meets_the_bf16_hold: 108x the hold). So p is split,
//     p_hi = bf16(p), p_lo = bf16(p - p_hi), and both go through the
//     tensor cores against the same V tile (V is exact in bf16): about
//     2^-17 of relative error, for 1.5x the tensor work of one rounding.
//   - The two consumer warpgroups run unsynchronized: one's softmax
//     overlaps the other's products where the scheduler finds it. Turns
//     on named barriers (one warpgroup's products while the other's
//     softmax, "ping-pong") measured slower at B = 4, S = 4096.
//   - Epilogue: out = acc / max(l, 1e-30) rounded to bf16 from registers,
//     lse by the first thread of each row.
//   - A wait on an mbarrier that does not complete within about 2 s
//     traps, so a broken pipeline fails its launch instead of hanging.
//
// The fp32 route (`simt::flash_fwd_kernel`) keeps the first
// port's SIMT body: 64 query rows per CTA, fp32 FMAs from shared memory.
// It is right, and no main path sends fp32 (the model runs bf16), so it
// was not redesigned.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- fp32 route
// One CTA of 256 threads per (b, h, block of BQ = 64 query rows), grid
// (Sq / 64, B * H). The CTA stages its 64 query rows, scaled, in shared
// memory as fp32, then walks kv blocks of BK = 64 keys in ascending
// order; each block's K (transposed, Kt[d][j]) and V are staged as fp32.
// Thread (ty, tx) of a 16 x 16 grid owns query rows 4*ty .. 4*ty + 3: it
// computes their scores at the columns tx + 16*j (j < 4) with fp32 FMAs
// in ascending d, reduces each row's max and sum over the 16 lanes of its
// half-warp with a xor butterfly, writes p to shared memory, and
// accumulates p . V for its rows at the output columns tx + 16*c in
// ascending key order. Its scores scale q in fp32 before the dot, as the
// plain version does.
// The kv blocks [begin, end) of `bk` keys that the query rows qi = qi0 ..
// qi0 + rows - 1 visit (see "Skipping is exact" above). The allowed keys
// of row qi are lo(qi) .. hi(qi). Each lane of a warp takes every 32nd row
// and the warp reduces, so every thread ends with the same range; a whole
// warp must call it.
__device__ __forceinline__ void kv_blocks(int qi0, int rows, int bk, int sk,
                                          int causal, int has_window,
                                          int window, int& begin, int& end) {
  int lo_min = sk, hi_max = -1;
  unsigned any_empty = 0;
  for (int r = threadIdx.x & 31; r < rows; r += 32) {
    const int qi = qi0 + r;
    const int hi = causal ? min(sk - 1, qi) : sk - 1;
    const int lo = has_window ? max(0, qi - window + 1) : 0;
    if (lo > hi) {
      any_empty = 1;
    } else {
      lo_min = min(lo_min, lo);
      hi_max = max(hi_max, hi);
    }
  }
  lo_min = __reduce_min_sync(FULL, lo_min);
  hi_max = __reduce_max_sync(FULL, hi_max);
  any_empty = __reduce_or_sync(FULL, any_empty);
  begin = any_empty ? 0 : lo_min / bk;
  end = any_empty ? sk / bk : hi_max / bk + 1;
}

namespace simt {

constexpr int BQ = 64;                      // query rows per CTA
constexpr int BK = 64;                      // keys per kv block
constexpr int THREADS = 256;                // 16 x 16 threads
constexpr int RPT = 4;                      // query rows per thread
constexpr int CPT = 4;                      // score columns per thread
static_assert(BQ == 16 * RPT && BK == 16 * CPT, "16 x 16 thread grid");

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

template <int HDP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
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
  const float* qp = q + ((int64_t)b * sq + q0) * q_row + (int64_t)head * hd;
  const float* kp = k + (int64_t)b * sk * k_row + (int64_t)kv_head * hd;
  const float* vp = v + (int64_t)b * sk * k_row + (int64_t)kv_head * hd;

  for (int i = tid; i < BQ * HDP; i += THREADS) {
    const int r = i / HDP, d = i % HDP;
    Qs[r * S::QS + d] = d < hd ? qp[r * q_row + d] * scale : 0.f;
  }

  int kb_begin, kb_end;
  kv_blocks(q0 + q_offset, BQ, BK, sk, causal, has_window, window, kb_begin,
            kb_end);

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
        kx = kp[off];
        vx = vp[off];
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
    float* op = out + ((int64_t)b * sq + q0 + r) * q_row + (int64_t)head * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) op[d] = acc[i][c] / lc;
    }
    if (tx == 0)
      lse[((int64_t)b * h + head) * sq + q0 + r] = m[i] + logf(lc);
  }
}


template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int sq, int sk, int h, int kvh, int hd,
                   float scale, int causal, int has_window, int window,
                   int q_offset, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HDP>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(sq / BQ, b * h);
  flash_fwd_kernel<HDP><<<grid, THREADS, Smem<HDP>::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, sq, sk, h,
      kvh, hd, scale, causal, has_window, window, q_offset);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------- bf16 route
namespace hopper {

constexpr int BQ = 128;                     // query rows per CTA
constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int THREADS = CONSUMERS + 128;    // and one producer warpgroup
constexpr int STAGES = 3;                   // K/V ring depth
constexpr long long WAIT_LIMIT = 4ll << 30;  // cycles, about 2 s
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK = -0x1p100f;            // a masked raw score
constexpr float LN2 = 0.6931471805599453f;

// Shared memory: Q [HALVES][BQ][64], then STAGES x (K, V) [HALVES][BK][64],
// bf16 in 128-byte swizzled rows, then the mbarriers (Q, full[STAGES],
// empty[STAGES]). Every tile starts on a 1024-byte boundary, the swizzle
// pattern's period.
template <int HDP> struct Cfg {
  static constexpr int BK = HDP == 64 ? 128 : 64;   // keys per kv block
  static constexpr int HALVES = HDP / 64;           // 64-column slabs
  static constexpr int NS = BK / 2;                 // S floats per thread
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int T_BYTES = BK * HDP * 2;      // one K or V tile
  static constexpr int STAGE_BYTES = 2 * T_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;        // room to align the base
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > WAIT_LIMIT) __trap();
}

// One TMA box of a 4-D tensor map into shared memory, completing `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A [ROWS][HDP] bf16 tile from global memory (row stride `stride`
// elements, columns past hd as zeros) into the swizzled layout TMA would
// write, by the 128 threads of the producer warpgroup (`t` = 0 .. 127),
// then fenced for wgmma.
template <int ROWS, int HDP>
__device__ __forceinline__ void load_tile(uint8_t* dst,
                                          const uint16_t* __restrict__ src,
                                          int64_t stride, int hd, int t) {
#pragma unroll 2
  for (int i = t; i < ROWS * HDP; i += 128) {
    const int r = i / HDP, c = i % HDP, cc = c & 63;
    const uint16_t x = c < hd ? src[r * stride + c] : uint16_t(0);
    *reinterpret_cast<uint16_t*>(
        dst + (c >> 6) * ROWS * 128 + r * 128
        + ((((cc >> 3) ^ (r & 7)) << 4) | ((cc & 7) << 1))) = x;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset `lbo` (between 64-element slabs of an
// MN-major operand; unused for K-major), stride byte offset 1024 (between
// 8-row groups), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of the registers across the
// asynchronous wgmma that owns them.
template <int N> __device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A and B K-major in shared
// memory (128-byte swizzle); the first k step overwrites D (scale_d = 0).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared
// memory (128-byte swizzle); the first k step overwrites D (scale_d = 0).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (the accumulator
// layout, as bf16 pairs), B MN-major in shared memory (transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p in two bf16 pairs: hi = bf16(p), lo = bf16(p - hi) (`x0` in the low
// half, the A fragment's order).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h2);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = *reinterpret_cast<const uint32_t*>(&l2);
}

// Columns c, c + 1 of one output row, those below hd.
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int c, int hd,
                                           float x0, float x1) {
  if (c + 1 < hd && !(hd & 1)) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) =
        __floats2bfloat162_rn(x0, x1);
  } else {
    if (c < hd) row[c] = __float2bfloat16(x0);
    if (c + 1 < hd) row[c + 1] = __float2bfloat16(x1);
  }
}

template <int HDP, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const uint16_t* __restrict__ q,
                       const uint16_t* __restrict__ k,
                       const uint16_t* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int sq, int sk, int h,
                       int kvh, int hd, float scale, int causal,
                       int has_window, int window, int q_offset) {
  using C = Cfg<HDP>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t bar_q = base + C::BAR_OFF;
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + STAGES + s); };
  auto k_tile = [&](int s) { return C::Q_BYTES + s * C::STAGE_BYTES; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int kv_head = head / (h / kvh);
  int kb_begin, kb_end;
  kv_blocks(q0 + q_offset, BQ, BK, sk, causal, has_window, window, kb_begin,
            kb_end);
  const int n_blocks = kb_end - kb_begin;

  if (tid == 0) {
    mbar_init(bar_q, TMA ? 1 : 128);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), TMA ? 1 : 128);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ---- producer: Q once, then K and V block by block into the ring.
    // It gives up registers to the consumers (128 x 40 + 256 x 232 is
    // the 384 x 168 the launch holds).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if constexpr (TMA) {
      if (tid == CONSUMERS) {
        mbar_expect_tx(bar_q, C::Q_BYTES);
        for (int c = 0; c < C::HALVES; ++c)
          tma_load(base + c * BQ * 128, &map_q, bar_q, 64 * c, head, q0, b);
        for (int it = 0; it < n_blocks; ++it) {
          const int s = it % STAGES, k0 = (kb_begin + it) * BK;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), C::STAGE_BYTES);
          const uint32_t kt = base + k_tile(s);
          for (int c = 0; c < C::HALVES; ++c) {
            tma_load(kt + c * BK * 128, &map_k, full(s), 64 * c, kv_head, k0,
                     b);
            tma_load(kt + C::T_BYTES + c * BK * 128, &map_v, full(s), 64 * c,
                     kv_head, k0, b);
          }
        }
      }
    } else {
      const int t = tid - CONSUMERS;
      const int64_t q_row = (int64_t)h * hd, k_row = (int64_t)kvh * hd;
      load_tile<BQ, HDP>(
          smem, q + ((int64_t)b * sq + q0) * q_row + (int64_t)head * hd,
          q_row, hd, t);
      mbar_arrive(bar_q);
      const int64_t kv_off = (int64_t)b * sk * k_row + (int64_t)kv_head * hd;
      for (int it = 0; it < n_blocks; ++it) {
        const int s = it % STAGES;
        const int64_t off = kv_off + (int64_t)(kb_begin + it) * BK * k_row;
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        load_tile<BK, HDP>(smem + k_tile(s), k + off, k_row, hd, t);
        load_tile<BK, HDP>(smem + k_tile(s) + C::T_BYTES, v + off, k_row, hd,
                           t);
        mbar_arrive(full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the block;
    // this thread rows r0 and r0 + 8, columns 8 j + 2 t4 + {0, 1} of each
    // n8 chunk j of the accumulators.
    const int wg = warp >> 2, t4 = lane & 3;
    const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);
    const int qi0 = q0 + r0 + q_offset, qi1 = qi0 + 8;
    const int qmin = q0 + 64 * wg + q_offset, qmax = qmin + 63;
    const uint32_t q_tile = base + wg * 64 * 128;
    // A masked score's place in the log2 domain, MASK * scale2 exactly
    // (MASK is a power of two): every masked score of a row that has seen
    // no allowed key yet equals m then, and gets p = 2^0 = 1.
    const float scale2 = scale * LOG2E, masked = MASK * scale2;

    float o[C::HALVES][32];
#pragma unroll
    for (int nh = 0; nh < C::HALVES; ++nh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nh][i] = 0.f;
    float m0 = masked, m1 = masked, l0 = 0.f, l1 = 0.f;

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_blocks; ++it) {
      const int s = it % STAGES, k0 = (kb_begin + it) * BK;
      const uint32_t kt = base + k_tile(s), vt = kt + C::T_BYTES;
      mbar_wait(full(s), (it / STAGES) & 1);

      // S = Q . K^T, 16 columns of hd per step
      float sc[C::NS];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint64_t da =
            sw128_desc(q_tile + (kk >> 2) * BQ * 128 + (kk & 3) * 32, 0);
        const uint64_t db =
            sw128_desc(kt + (kk >> 2) * BK * 128 + (kk & 3) * 32, 0);
        if constexpr (BK == 128) wgmma_ss_n128(sc, da, db, kk > 0);
        else wgmma_ss_n64(sc, da, db, kk > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(sc);

      // mask the raw scores by select where the tile is not whole (to
      // MASK, whose product with scale2 is exact), then the row max over
      // the 4 threads of a row; scale2 > 0 commutes with the max
      float mx0 = MASK, mx1 = MASK;
      if ((!causal || k0 + BK - 1 <= qmin)
          && (!has_window || k0 > qmax - window)) {
#pragma unroll
        for (int i = 0; i < C::NS; i += 4) {
          mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
        }
      } else {
        // column 8 j + e of this thread's keys k0 + 2 t4 + ... is allowed
        // for row qi when lo <= 8 j + e <= hi (limits clamped to [-1, BK])
        const int64_t kb = k0 + 2 * t4;
        auto lim = [&](int64_t x) {
          return (int)(x < -1 ? -1 : (x > BK ? BK : x));
        };
        const int hi0 = causal ? lim(qi0 - kb) : BK;
        const int hi1 = causal ? lim(qi1 - kb) : BK;
        const int lo0 = has_window ? lim((int64_t)qi0 - window + 1 - kb) : -1;
        const int lo1 = has_window ? lim((int64_t)qi1 - window + 1 - kb) : -1;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + e;
            float& x0 = sc[4 * j + e];
            float& x1 = sc[4 * j + 2 + e];
            x0 = c > hi0 || c < lo0 ? MASK : x0;
            x1 = c > hi1 || c < lo1 ? MASK : x1;
            mx0 = fmaxf(mx0, x0);
            mx1 = fmaxf(mx1, x1);
          }
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, x));
      }

      // online softmax update in fp32, in the log2 domain:
      // p = 2^(s scale log2 e - m) = e^(s scale - m ln 2)
      const float mn0 = fmaxf(m0, mx0 * scale2);
      const float mn1 = fmaxf(m1, mx1 * scale2);
      const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int i = 0; i < C::NS; i += 4)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[i + e] = ex2(fmaf(sc[i + e], scale2, -mn0));
          sc[i + 2 + e] = ex2(fmaf(sc[i + 2 + e], scale2, -mn1));
          ls0 += sc[i + e];
          ls1 += sc[i + 2 + e];
        }
      l0 = l0 * al0 + ls0;
      l1 = l1 * al1 + ls1;
#pragma unroll
      for (int nh = 0; nh < C::HALVES; ++nh)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[nh][4 * j] *= al0;
          o[nh][4 * j + 1] *= al0;
          o[nh][4 * j + 2] *= al1;
          o[nh][4 * j + 3] *= al1;
        }

      // O += P_hi . V + P_lo . V, 16 keys per step: A fragment register rr
      // of step kk holds S chunk 2 kk + rr / 2, row r0 (rr even) or r0 + 8.
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int i = 4 * (2 * kk + (rr >> 1)) + 2 * (rr & 1);
          split_bf16(sc[i], sc[i + 1], ph[kk][rr], pl[kk][rr]);
        }
#pragma unroll
      for (int nh = 0; nh < C::HALVES; ++nh) pin(o[nh]);
      wg_fence();
#pragma unroll
      for (int nh = 0; nh < C::HALVES; ++nh)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs_n64(o[nh], ph[kk],
                       sw128_desc(vt + nh * BK * 128 + kk * 2048, BK * 128));
#pragma unroll
      for (int nh = 0; nh < C::HALVES; ++nh)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs_n64(o[nh], pl[kk],
                       sw128_desc(vt + nh * BK * 128 + kk * 2048, BK * 128));
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int nh = 0; nh < C::HALVES; ++nh) pin(o[nh]);
      mbar_arrive(empty(s));
    }

    // epilogue: the 4 partial sums of l, then out and lse
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(FULL, l0, x);
      l1 += __shfl_xor_sync(FULL, l1, x);
    }
    const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
    const int64_t q_row = (int64_t)h * hd;
    __nv_bfloat16* row0 =
        out + ((int64_t)b * sq + q0 + r0) * q_row + (int64_t)head * hd;
    __nv_bfloat16* row1 = row0 + 8 * q_row;
#pragma unroll
    for (int nh = 0; nh < C::HALVES; ++nh)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * nh + 8 * j + 2 * t4;
        store_pair(row0, c, hd, o[nh][4 * j] / lc0, o[nh][4 * j + 1] / lc0);
        store_pair(row1, c, hd, o[nh][4 * j + 2] / lc1, o[nh][4 * j + 3] / lc1);
      }
    if (t4 == 0) {   // m back to the natural log; no allowed key: NEG_INF
      float* lp = lse + ((int64_t)b * h + head) * sq + q0 + r0;
      lp[0] = (m0 == masked ? NEG_INF : m0 * LN2) + logf(lc0);
      lp[8] = (m1 == masked ? NEG_INF : m1 * LN2) + logf(lc1);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point (the library does not link libcuda).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess
        || found != cudaDriverEntryPointSuccess)
      return EncodeTiled(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-D map over a [B, S, heads, hd] bf16 tensor with its own strides
// (innermost first: hd, heads, S, B), box 64 x 1 x rows x 1, 128-byte
// swizzle; columns past hd arrive as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads,
              int hd, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)s * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP, bool TMA>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int sq, int sk, int h, int kvh, int hd,
                   float scale, int causal, int has_window, int window,
                   int q_offset, cudaStream_t stream) {
  using C = Cfg<HDP>;
  const auto kernel = flash_fwd_wgmma_kernel<HDP, TMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::ALLOC);
  if (err != cudaSuccess) return err;
  CUtensorMap mq{}, mk{}, mv{};
  if (TMA && !(make_map(&mq, q, b, sq, h, hd, BQ)
               && make_map(&mk, k, b, sk, kvh, hd, C::BK)
               && make_map(&mv, v, b, sk, kvh, hd, C::BK)))
    return cudaErrorInvalidValue;
  dim3 grid(sq / BQ, b * h);
  kernel<<<grid, THREADS, C::ALLOC, stream>>>(
      mq, mk, mv, static_cast<const uint16_t*>(q),
      static_cast<const uint16_t*>(k), static_cast<const uint16_t*>(v),
      static_cast<__nv_bfloat16*>(out), lse, sq, sk, h, kvh, hd, scale,
      causal, has_window, window, q_offset);
  return cudaGetLastError();
}

// TMA where every global stride is a multiple of 16 bytes (hd % 8 == 0)
// and q, k and v start on 16-byte boundaries; plain loads otherwise.
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int b, int sq, int sk, int h,
                        int kvh, int hd, float scale, int causal,
                        int has_window, int window, int q_offset,
                        cudaStream_t stream) {
  const bool tma = hd % 8 == 0
      && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
           | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  auto go = [&](auto fn) {
    return fn(q, k, v, out, lse, b, sq, sk, h, kvh, hd, scale, causal,
              has_window, window, q_offset, stream);
  };
  if (hd <= 64) return tma ? go(launch<64, true>) : go(launch<64, false>);
  return tma ? go(launch<128, true>) : go(launch<128, false>);
}

}  // namespace hopper
}  // namespace

extern "C" {

// Rows per CTA of the bf16 route and keys per kv block (128, or 64 at
// hd > 64); the fp32 route's 64 divides it. Sq and Sk must be multiples
// of it.
int flash_attention_block() { return hopper::BQ; }

int flash_attention_max_hd() { return 128; }

// q [B, Sq, H, hd], k / v [B, Sk, KV, hd], contiguous, fp32 (is_bf16 = 0)
// or bf16 (1) alike; out like q; lse [B, H, Sq] fp32. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue if a TMA
// tensor map could not be made).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, float* lse, int b, int sq, int sk, int h,
                        int kvh, int hd, float scale, int causal,
                        int has_window, int window, int q_offset, int is_bf16,
                        cudaStream_t stream) {
  cudaError_t err;
  if (is_bf16) {
    err = hopper::launch_bf16(q, k, v, out, lse, b, sq, sk, h, kvh, hd, scale,
                              causal, has_window, window, q_offset, stream);
  } else {
    err = hd <= 64
        ? simt::launch<64>(q, k, v, out, lse, b, sq, sk, h, kvh, hd, scale,
                           causal, has_window, window, q_offset, stream)
        : simt::launch<128>(q, k, v, out, lse, b, sq, sk, h, kvh, hd, scale,
                            causal, has_window, window, q_offset, stream);
  }
  return static_cast<int>(err);
}

}  // extern "C"
