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
// f32 operands (the fp32 precision preset) take a SIMT path on the same
// 32 x 32 output tile: f32 operand tiles staged in shared memory as
// [k][m] and [k][n] with zero fill outside the matrix, each thread
// owning column t % 32 of rows t / 32 + 4 i, fmaf in full f32 (no TF32).
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

// ---- SIMT f32 path ---------------------------------------------------------

constexpr int LDF = TM + 1;               // f32 tiles [TK][TM] / [TK][TN]
constexpr int F_ROWS = TM * TN / THREADS; // outputs per thread (8)
constexpr int F_STRIDE = THREADS / TN;    // row stride between them (4)
static_assert(TM == TN, "the f32 tiles share one leading dimension");

// Copy the ROWS x COLS tile at (r0, c0) of a row-major f32 matrix g
// (nrows x ncols, leading dimension ld) into s (leading dimension LDF),
// as s[r][c], or as s[c][r] when TRANS; zero outside the matrix.  Global
// reads are coalesced along c; LDF is odd, so a transposed store does
// not conflict on shared-memory banks.
template <int ROWS, int COLS, bool TRANS>
__device__ __forceinline__ void load_tile_f32(float* s,
                                              const float* __restrict__ g,
                                              int ld, int r0, int c0,
                                              int nrows, int ncols) {
  for (int e = threadIdx.x; e < ROWS * COLS; e += blockDim.x) {
    const int r = e / COLS, c = e % COLS;
    const int gr = r0 + r, gc = c0 + c;
    const float v = (gr < nrows && gc < ncols) ? g[(size_t)gr * ld + gc] : 0.f;
    if (TRANS)
      s[c * LDF + r] = v;
    else
      s[r * LDF + c] = v;
  }
}

// acc[i] += sum_k As[k][row_i] * Bs[k][col] for one staged TK step, with
// As [TK][TM] and Bs [TK][TN]; row_i = t / TN + F_STRIDE * i, col = t % TN.
__device__ __forceinline__ void fma_step(float (&acc)[F_ROWS],
                                         const float* As, const float* Bs) {
  const int c = threadIdx.x % TN, r0 = threadIdx.x / TN;
#pragma unroll 8
  for (int k = 0; k < TK; ++k) {
    const float b = Bs[k * LDF + c];
#pragma unroll
    for (int i = 0; i < F_ROWS; ++i)
      acc[i] = fmaf(As[k * LDF + r0 + F_STRIDE * i], b, acc[i]);
  }
}

}  // namespace rt
