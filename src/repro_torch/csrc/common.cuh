// Shared building blocks of the port's hand-written Hopper kernels.
//
// The generic tile (TM x TN x TK below) serves the generic paths of
// sr_matmul.cu and outer_accum.cu, which take the operands the TMA
// cannot describe (gemm_sm90.cuh holds the TMA + wgmma building blocks
// that the bf16 products of the main path, decode_fused.cu's included,
// run on): a 32 x 32
// output tile per 128-thread block, the reduction walked in 64-deep
// steps inside the block (Hopper has no sequential grid axis, so the
// loop takes the place of the TPU grid's innermost counter), bf16
// operand tiles staged in shared memory with every element outside the
// matrix zero-filled (a ragged edge of M, N or K never reads past an
// operand), and the product run on the tensor cores through WMMA
// fragments (mma.sync, bf16 in, f32 accumulate).  The f32 accumulator
// lives in registers across the whole reduction.
//
// sr_bf16_bits is the stochastic-rounding epilogue, kept as a device
// function of its own so sr_matmul, outer_accum, sr_round and the sm90
// mainloop share one bit-exact SR.
//
// f32 operands (the fp32 precision preset) take sgemm_sm90.cuh's
// mainloop.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace rt {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int TM = 32;            // output rows per block
constexpr int TN = 32;            // output columns per block
constexpr int TK = 64;            // reduction depth per step
constexpr int THREADS = 128;      // 4 warps, one 16 x 16 fragment each
constexpr int LDA = TK + 8;       // A tile [TM][TK] (bf16; +8 skews banks)
constexpr int LDB_ROW = TN + 8;   // B tile stored [TK][TN]
constexpr int LDB_COL = TK + 8;   // B tile stored [TN][TK] (B read as B^T)
constexpr int LDC = TN + 4;       // f32 accumulator tile [TM][TN]

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

// f32 -> bf16 bits with stochastic rounding from the low 16 bits of r:
// (bits(acc) + (r & 0xFFFF)) >> 16.  A non-finite value takes the plain
// cast: inf truncates exactly, NaN becomes the canonical quiet NaN with
// its sign (the reference's pattern, bit for bit).
__device__ __forceinline__ uint16_t sr_bf16_bits(float acc, uint32_t r) {
  const uint32_t u = __float_as_uint(acc);
  if (isnan(acc)) return (uint16_t)(((u >> 16) & 0x8000u) | 0x7FC0u);
  if (isinf(acc)) return (uint16_t)(u >> 16);
  return (uint16_t)((u + (r & 0xFFFFu)) >> 16);
}

// Copy the ROWS x COLS tile at (r0, c0) of a row-major bf16 matrix g
// (nrows x ncols, leading dimension ld) into shared memory s (leading
// dimension LDS), zero-filling everything outside the matrix.  vec says
// 16-byte loads are legal: g 16-byte aligned, ld % 8 == 0, c0 % 8 == 0.
template <int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* __restrict__ g,
                                          int ld, int r0, int c0, int nrows,
                                          int ncols, bool vec) {
  constexpr int CPR = COLS / 8;   // 8-element chunks per row
  for (int ch = threadIdx.x; ch < ROWS * CPR; ch += blockDim.x) {
    const int r = ch / CPR, c = (ch % CPR) * 8;
    const int gr = r0 + r, gc = c0 + c;
    bf16* dst = s + r * LDS + c;
    if (vec && gr < nrows && gc + 8 <= ncols) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(g + (size_t)gr * ld + gc);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool ok = gr < nrows && gc + e < ncols;
        dst[e] = ok ? g[(size_t)gr * ld + gc + e] : f2bf(0.f);
      }
    }
  }
}

// total += part elementwise (fragments of one type share their layout),
// in f32 with round-to-nearest.  The tensor cores' own accumulation
// rounds less carefully than IEEE f32; summing each TK step's partial
// product in a fresh fragment and adding it here keeps that error to
// one step's worth instead of growing with K (the tied LM head's BP
// reduces over K = 151936).
__device__ __forceinline__ void promote(AccFrag& total, const AccFrag& part) {
#pragma unroll
  for (int i = 0; i < total.num_elements; ++i) total.x[i] += part.x[i];
}

// acc += A[ar:ar+16, :TK] . B[:TK, bc:bc+16] for one staged step.
// B_COL: the B tile is stored [TN][TK] (the transposed read of B(N, K)).
template <bool B_COL>
__device__ __forceinline__ void mma_step(AccFrag& acc, const bf16* As,
                                         const bf16* Bs, int ar, int bc) {
#pragma unroll
  for (int kk = 0; kk < TK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, As + ar * LDA + kk, LDA);
    if constexpr (B_COL) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, Bs + bc * LDB_COL + kk, LDB_COL);
      wmma::mma_sync(acc, fa, fb, acc);
    } else {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, Bs + kk * LDB_ROW + bc, LDB_ROW);
      wmma::mma_sync(acc, fa, fb, acc);
    }
  }
}

// The largest e < n with f(e) <= v, for f nondecreasing (f(0) <= v).
template <typename F>
__device__ __forceinline__ int last_at_most(int n, int v, F f) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (f(mid) <= v)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// Write one output element: f32 as is, or its SR-bf16 bits from rbits[o].
__device__ __forceinline__ void store_out(void* out,
                                          const uint32_t* __restrict__ rbits,
                                          size_t o, float v, int sr) {
  if (sr)
    reinterpret_cast<uint16_t*>(out)[o] = sr_bf16_bits(v, rbits[o]);
  else
    reinterpret_cast<float*>(out)[o] = v;
}

}  // namespace rt
