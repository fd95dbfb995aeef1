// 3xTF32 products on Hopper's tensor cores, and the cp.async staging that
// feeds them. Shared by the port's kernels whose fp32 products must hold
// 1e-4 of their plain fp32 versions (`ssd_scan/csrc/ssd_scan.cu`, the
// shared-negative forward and backward in `sampled_ce/csrc/sampled_ce.cu`);
// each includes this header by a path relative to itself.
//
// Why three products. One TF32 product (10-bit mantissa operands) misses
// those holds by 4-50x (`tests/test_torch_ssd_scan.py` and
// `tests/test_torch_sampled_ce_shared.py::
// test_tf32x3_products_meet_the_hold` emulate it on the CPU). Splitting
// each fp32 operand into a TF32 `big` part and the TF32 part of the
// remainder (`small`), and summing small*big + big*small + big*big with
// fp32 accumulation, leaves an error of order 2^-21 relative per product,
// inside the holds by 5x or more. The small*small term is dropped. The two
// small terms are issued before big*big, so they accumulate while they are
// small against the running sum.
//
// Why slabs. The tensor core adds each product into its fp32 accumulator
// with truncation, not rounding to nearest: an error of up to an ulp of the
// running sum per mma, of one sign while the sum keeps its sign. Over a
// long reduction (three mma per k-step, 768 at D = 2048) that bias grew
// past the sampled CE's hold on the card. So `product` lets the tensor core
// accumulate over one slab of 32 only, from zero, and adds each slab's sum
// into the caller's fp32 accumulator on the CUDA cores (`fold`, rounded to
// nearest): the truncation is then an ulp of a 32-term partial sum, and
// the slabs' errors, of random signs, no longer add up.
//
// Fragments are those of `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.
// f32`: lane = 4 g + t (g = lane >> 2, t = lane & 3); A (16 x 8, row) holds
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8, col) holds
// (k = t, n = g), (t + 4, g); the accumulator holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1). `mma.sync` rather than `wgmma`: wgmma takes
// TF32 operands only K-major from shared memory, and most of these
// products reduce along an operand's rows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x = big + small: big is x rounded to TF32 (to nearest, ties away from 0,
// as cvt.rna.tf32.f32 rounds, but by two integer ops on the bits: the cvt
// is a longer sequence on sm_90a, and a split runs for every operand
// element a warp reads), small = x - big exactly, passed as fp32, of which
// the tensor core reads the TF32 part: the error left is below 2^-21 |x|.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Accumulator coordinates of element i (0..3) of a fragment, in the
// fragment's own 16 x 8 tile.
__device__ __forceinline__ int acc_row(int i) {
  return ((threadIdx.x & 31) >> 2) + (i >= 2 ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int i) {
  return 2 * (threadIdx.x & 3) + (i & 1);
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.f;
}

// acc += part, rounded to nearest on the CUDA cores.
template <int MT, int NT>
__device__ __forceinline__ void fold(float (&acc)[MT][NT][4],
                                     const float (&part)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] += part[mi][ni][i];
}

// The k-step [k0, k0 + 8) for a warp tile of MT x NT fragments (16 MT rows,
// 8 NT columns): acc[mi][ni] += A[16 mi .. +16, k0 .. +8) . B[k0 .. +8,
// 8 ni .. +8) in 3xTF32. a(r, k) returns the fp32 operand at warp-tile row
// r and depth k, b(k, c) at depth k and warp-tile column c. The three
// passes run over all fragments in turn, so that consecutive mma are
// independent.
template <int MT, int NT, class LoadA, class LoadB>
__device__ __forceinline__ void step(float (&acc)[MT][NT][4], int k0,
                                     LoadA a, LoadB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = k0 + (lane & 3);
  uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    split(a(16 * mi + g, t), ab[mi][0], as[mi][0]);
    split(a(16 * mi + g + 8, t), ab[mi][1], as[mi][1]);
    split(a(16 * mi + g, t + 4), ab[mi][2], as[mi][2]);
    split(a(16 * mi + g + 8, t + 4), ab[mi][3], as[mi][3]);
  }
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    split(b(t, 8 * ni + g), bb[ni][0], bs[ni][0]);
    split(b(t + 4, 8 * ni + g), bb[ni][1], bs[ni][1]);
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      mma(acc[mi][ni], as[mi], bb[ni][0], bb[ni][1]);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      mma(acc[mi][ni], ab[mi], bs[ni][0], bs[ni][1]);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      mma(acc[mi][ni], ab[mi], bb[ni][0], bb[ni][1]);
}

constexpr int SLAB = 32;                  // depth a tensor-core sum spans

// acc += A[:, k_begin .. k_end) . B[k_begin .. k_end, :] for the warp tile,
// in ascending slabs of SLAB (k_begin a multiple of 8; depths up to the next
// multiple of 8 past k_end must read as zeros or finite values times zero).
// Each slab sums on the tensor cores from zero and is folded into acc.
template <int MT, int NT, class LoadA, class LoadB>
__device__ __forceinline__ void product(float (&acc)[MT][NT][4], int k_begin,
                                        int k_end, LoadA a, LoadB b) {
  for (int kb = k_begin; kb < k_end; kb += SLAB) {
    float part[MT][NT][4];
    zero(part);
#pragma unroll
    for (int k0 = kb; k0 < kb + SLAB; k0 += 8)
      if (k0 < k_end) step(part, k0, a, b);
    fold(acc, part);
  }
}

// ---------------------------------------------------------------- cp.async
// 16 bytes from global to shared; bytes past `src_bytes` (0..16) are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Runs `compute(kk, buf)` on stage kk = 0 .. nk - 1 after `issue(kk, buf)`
// has staged it into buffer buf = kk & 1 (issue commits one cp.async
// group), the next stage's loads in flight while the current one is used.
// One barrier a stage: it publishes stage kk and frees the buffer of stage
// kk - 1, which the next issue refills. (Three and four buffers measured no
// faster on the card: the products, not the loads, set the pace.)
template <class Issue, class Compute>
__device__ __forceinline__ void pipeline(int nk, Issue issue,
                                         Compute compute) {
  if (nk > 0) issue(0, 0);
  for (int kk = 0; kk < nk; ++kk) {
    cp_async_wait<0>();
    __syncthreads();
    if (kk + 1 < nk) issue(kk + 1, (kk + 1) & 1);
    compute(kk, kk & 1);
  }
  __syncthreads();                        // the buffers are free again
}

// Stage a ROWS x COLS tile of a row-major matrix (`ld` elements a row) into
// shared memory with row stride STRIDE: element (r, c) gets
// src[(r0 + r) ld + c0 + c] where r0 + r < rmax and c0 + c < cmax, else 0.
// VEC: 16-byte cp.async chunks, completed by cp_async_wait (ld and c0
// multiples of 16 / sizeof(T), src 16-byte aligned); else plain loads,
// complete when this returns. Either way a barrier must follow before the
// tile is read.
template <typename T, int ROWS, int COLS, int STRIDE, int THREADS, bool VEC>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int64_t ld, int r0, int rmax, int c0,
                                      int cmax) {
  constexpr int E = 16 / sizeof(T);
  static_assert(COLS % E == 0 && (STRIDE * sizeof(T)) % 16 == 0,
                "16-byte rows");
  if constexpr (VEC) {
    constexpr int CH = COLS / E;
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
      const int r = idx / CH, c = (idx - r * CH) * E;
      const int gr = r0 + r, gc = c0 + c;
      const int n = gr < rmax ? min(E, max(0, cmax - gc)) : 0;
      cp_async16(dst + r * STRIDE + c,
                 n > 0 ? src + (int64_t)gr * ld + gc : src,
                 n * (int)sizeof(T));
    }
  } else {                     // not unrolled: its loads would hold registers
#pragma unroll 1
    for (int idx = threadIdx.x; idx < ROWS * COLS; idx += THREADS) {
      const int r = idx / COLS, c = idx - r * COLS;
      const int gr = r0 + r, gc = c0 + c;
      dst[r * STRIDE + c] = gr < rmax && gc < cmax
                                ? src[(int64_t)gr * ld + gc]
                                : static_cast<T>(0.f);
    }
  }
}

}  // namespace tf32x3
