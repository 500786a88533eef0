// sr_matmul: bf16 GEMM with f32 accumulation and an optional fused
// stochastic-rounding (SR) bf16 writeback — the PE's MAC array (§3.3).
//
// Replaces the TPU kernel repro/kernels/sr_matmul.py::sr_matmul
// (pl.pallas_call at sr_matmul.py:96, body _mm_kernel), whose (i, j, l)
// grid kept an f32 tile resident in VMEM across the reduction l.  On the
// H100 the l counter becomes the loop inside each block, and where the
// (i, j) tiles alone cannot fill the card, a deterministic split of l
// over blockIdx.z.
//
// Two paths for bf16 operands, chosen by the wrapper from shapes and
// strides (kernels/sr_matmul.py::plan), never by a failed launch:
//
// - sm90: the TMA + wgmma mainloop of gemm_sm90.cuh — A K-major, B
//   N-major (B(K, N)) or K-major (trans_b, B(N, K)); its header says
//   what bounds each role (PREFILL, FF, BP) and what the design does.
// - generic: operands TMA cannot describe (a base pointer that is not
//   16-byte aligned, a row stride that is not a multiple of 16 bytes).
//   A 128-thread block per 32 x 32 output tile, WMMA 16x16x16 fragments
//   from zero-filled shared-memory tiles, one 64-deep step per loop trip
//   with each step's partial product promoted into an f32 sum
//   (common.cuh); trans_b stages B tiles [n][k] and reads them
//   column-major, so no transposed copy exists in memory.
//
// Training runs it in two roles: FF (A = activations, B = W) and BP
// (dX = dY . W^T, B = W read through trans_b; for the tied LM head
// dX = g . table with K = vocab = 151936, the longest reduction of the
// step).  The fp32 precision preset gives it f32 operands, which take
// the f32 mainloop of sgemm_sm90.cuh (fmaf on the CUDA cores, no TF32,
// deterministic split-K; its header says what bounds it and how it is
// tiled) — the TPU kernel accepts f32 operands too.
//
// A MoE model runs it BATCHED: each expert table's PREFILL, FF and BP
// product over all E experts as one launch (the TPU kernel under
// jax.vmap): sr_matmul_batched_bf16 for bf16 operands
// (gemm_sm90_batched.cuh: only each expert's live rows, the caller's
// dtype out through a TMA store), sr_matmul_batched_f32 for f32 ones
// (the fp32 preset; sgemm_sm90_batched.cuh: only each expert's live
// rows, over sgemm_sm90.cuh's mainloop).
#include "common.cuh"
#include "gemm_sm90.cuh"
#include "gemm_sm90_batched.cuh"
#include "sgemm_sm90.cuh"
#include "sgemm_sm90_batched.cuh"

namespace rt {

template <bool TRANS_B>
__global__ void __launch_bounds__(THREADS)
    sr_matmul_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                     const uint32_t* __restrict__ rbits, void* __restrict__ out,
                     int M, int N, int K, int lda, int ldb, int sr, int vec_a,
                     int vec_b) {
  __shared__ __align__(128) bf16 As[TM * LDA];
  __shared__ __align__(128) bf16 Bs[TRANS_B ? TN * LDB_COL : TK * LDB_ROW];
  __shared__ __align__(128) float Cs[TM * LDC];

  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int warp = threadIdx.x / 32;
  const int ar = (warp / 2) * 16, bc = (warp % 2) * 16;

  AccFrag acc, part;
  wmma::fill_fragment(acc, 0.f);
  for (int k0 = 0; k0 < K; k0 += TK) {
    load_tile<TM, TK, LDA>(As, A, lda, m0, k0, M, K, vec_a);
    if constexpr (TRANS_B)
      load_tile<TN, TK, LDB_COL>(Bs, B, ldb, n0, k0, N, K, vec_b);
    else
      load_tile<TK, TN, LDB_ROW>(Bs, B, ldb, k0, n0, K, N, vec_b);
    __syncthreads();
    wmma::fill_fragment(part, 0.f);
    mma_step<TRANS_B>(part, As, Bs, ar, bc);
    promote(acc, part);
    __syncthreads();
  }
  wmma::store_matrix_sync(Cs + ar * LDC + bc, acc, LDC, wmma::mem_row_major);
  __syncthreads();

  for (int e = threadIdx.x; e < TM * TN; e += blockDim.x) {
    const int r = e / TN, c = e % TN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const float v = Cs[r * LDC + c];
    const size_t o = (size_t)gm * N + gn;
    if (sr)
      reinterpret_cast<uint16_t*>(out)[o] = sr_bf16_bits(v, rbits[o]);
    else
      reinterpret_cast<float*>(out)[o] = v;
  }
}

}  // namespace rt

// out(M, N) = A(M, K) . B(K, N), or A . B^T for B(N, K) with trans_b;
// lda / ldb are the operands' row strides in elements.  out is f32
// without SR, bf16 (SR from rbits, uint32 M x N) with it.  path 1 runs
// the sm90 mainloop with the plan's bn, splits and kb_per_split (ws:
// splits x M x N f32 when splits > 1), path 0 the generic WMMA kernel.
// The grid (grid_x, grid_y) comes from the caller's loop nest
// (core/pmag.matmul_nest) over the path's tiles.  Launches on `stream`;
// returns cudaGetLastError() or a gemm_sm90.cuh ERR_ code.
extern "C" int sr_matmul_bf16(const void* a, const void* b, const void* rbits,
                              void* out, void* ws, int M, int N, int K,
                              int lda, int ldb, int trans_b, int sr, int path,
                              int bn, int splits, int kb_per_split,
                              int grid_x, int grid_y, void* stream) {
  using namespace rt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    float* W = static_cast<float*>(ws);
#define RT_SM90(BN, B_MN)                                                   \
  return sm90::run<BN, false, B_MN>(a, b, rbits, out, W, M, N, K, lda, ldb, \
                                    1.0f, sr, splits, kb_per_split, grid_x, \
                                    grid_y, st)
    if (bn == 128) {
      if (trans_b) RT_SM90(128, false);
      RT_SM90(128, true);
    }
    if (trans_b) RT_SM90(64, false);
    RT_SM90(64, true);
#undef RT_SM90
  }
  const dim3 grid(grid_x, grid_y);
  const int vec_a = aligned16(a) && lda % 8 == 0;
  const int vec_b = aligned16(b) && ldb % 8 == 0;
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  const uint32_t* R = static_cast<const uint32_t*>(rbits);
  if (trans_b)
    sr_matmul_kernel<true><<<grid, THREADS, 0, st>>>(
        A, B, R, out, M, N, K, lda, ldb, sr, vec_a, vec_b);
  else
    sr_matmul_kernel<false><<<grid, THREADS, 0, st>>>(
        A, B, R, out, M, N, K, lda, ldb, sr, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

// out[e] = A[e] . B[e] for the E experts of a MoE table, in ONE launch
// of gemm_sm90_batched.cuh's kernel: A (E, M, K), B (E, K, N) or
// (E, N, K) with trans_b, out (E, M, N) f32, or bf16 (rounded to nearest
// even) with out_bf16; each contiguous and 16-byte aligned, K and N
// multiples of 8 (16-byte rows for the TMA loads and stores).  rows
// (E,) int32 on the device, or null: the rows of A[e] at or past rows[e]
// are zero, so only A[e]'s live row tiles are computed and the rest of
// out[e] is written as zeros (the same result).  The plan's bn, splits
// and kb_per_split and the grid (grid_x, grid_y) are one expert's
// (M, N, K); ws holds splits x E x M x N f32 when splits > 1.  No SR: no
// serving or training word rounds this output.  Returns
// cudaGetLastError(), a gemm_sm90.cuh ERR_ code, or
// cudaErrorInvalidValue for a shape or plan that is not its own.
extern "C" int sr_matmul_batched_bf16(const void* a, const void* b,
                                      void* out, void* ws, const void* rows,
                                      int E, int M, int N, int K,
                                      int trans_b, int out_bf16, int bn,
                                      int splits, int kb_per_split,
                                      int grid_x, int grid_y, void* stream) {
  using namespace rt::sm90;
  if (!batched_plan_ok(E, M, N, K, bn, splits, kb_per_split, grid_x, grid_y,
                       ws) ||
      K % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* W = static_cast<float*>(ws);
  const int* R = static_cast<const int*>(rows);
#define RT_SM90_E(BN, B_MN, OUT)                                           \
  return run_batched<BN, false, B_MN, OUT>(a, b, nullptr, out, W, R, M, N, \
                                           K, 1.0f, splits, kb_per_split, \
                                           grid_x, grid_y, st, E)
#define RT_SM90_E_OUT(BN, B_MN)     \
  if (out_bf16) RT_SM90_E(BN, B_MN, OUT_BF16); \
  RT_SM90_E(BN, B_MN, OUT_F32)
  if (bn == 128) {
    if (trans_b) {
      RT_SM90_E_OUT(128, false);
    }
    RT_SM90_E_OUT(128, true);
  }
  if (trans_b) {
    RT_SM90_E_OUT(64, false);
  }
  RT_SM90_E_OUT(64, true);
#undef RT_SM90_E_OUT
#undef RT_SM90_E
}

// The host's share of an sm90 call of sr_matmul_bf16 (same arguments):
// encode its two TMA maps and return, with no launch.  chip_smoke.py
// times it.  Returns 0 or a gemm_sm90.cuh ERR_ code.
extern "C" int sr_matmul_sm90_maps(const void* a, const void* b, int M,
                                   int N, int K, int lda, int ldb,
                                   int trans_b, int bn) {
  using namespace rt::sm90;
  CUtensorMap ma, mb;
  if (bn == 128)
    return trans_b ? make_maps<128, false, false>(&ma, &mb, a, b, M, N, K,
                                                  lda, ldb)
                   : make_maps<128, false, true>(&ma, &mb, a, b, M, N, K,
                                                 lda, ldb);
  return trans_b
             ? make_maps<64, false, false>(&ma, &mb, a, b, M, N, K, lda, ldb)
             : make_maps<64, false, true>(&ma, &mb, a, b, M, N, K, lda, ldb);
}

// The same product for f32 A and B (the fp32 preset): sgemm_sm90.cuh's
// mainloop with the plan's splits and kb_per_split (ws:
// splits x M x N f32 partials, then grid_x * grid_y zeroed int32
// counters, when splits > 1).  lda / ldb are the operands' row strides
// in elements.  Returns cudaGetLastError().
extern "C" int sr_matmul_f32(const void* a, const void* b, const void* rbits,
                             void* out, void* ws, int M, int N, int K,
                             int lda, int ldb, int trans_b, int sr,
                             int splits, int kb_per_split, int grid_x,
                             int grid_y, void* stream) {
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* W = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (trans_b)
    return rt::sgemm::run<false, false>(A, B, rbits, out, W, M, N, K, lda,
                                        ldb, 1.0f, sr, splits, kb_per_split,
                                        grid_x, grid_y, st);
  return rt::sgemm::run<false, true>(A, B, rbits, out, W, M, N, K, lda, ldb,
                                     1.0f, sr, splits, kb_per_split, grid_x,
                                     grid_y, st);
}

// out[e] = A[e] . B[e] for the E experts of a MoE table with f32
// operands (the fp32 preset), in ONE launch of sgemm_sm90_batched.cuh's
// kernel: A (E, M, K), B (E, K, N) or (E, N, K) with trans_b,
// out (E, M, N) f32, each contiguous.  rows (E,) int32 on the device, or
// null: the rows of A[e] at or past rows[e] are zero, so only A[e]'s
// live row tiles are computed and the rest of out[e] is written as zeros
// (the same result).  The plan's splits and kb_per_split and the grid
// (grid_x, grid_y) are one expert's (M, N, K) from
// kernels/sr_matmul.py::f32_plan; ws holds splits x E x M x N f32
// partials, then E x grid_x x grid_y zeroed int32 counters, when
// splits > 1.  No SR.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or plan that is not its own.
extern "C" int sr_matmul_batched_f32(const void* a, const void* b,
                                     void* out, void* ws, const void* rows,
                                     int E, int M, int N, int K, int trans_b,
                                     int splits, int kb_per_split,
                                     int grid_x, int grid_y, void* stream) {
  using namespace rt::sgemm;
  if (!batched_plan_ok(E, M, N, K, splits, kb_per_split, grid_x, grid_y,
                       ws))
    return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  const int* R = static_cast<const int*>(rows);
  float* O = static_cast<float*>(out);
  float* W = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (trans_b)
    return run_batched<false, false>(A, B, R, O, W, M, N, K, 1.0f, splits,
                                     kb_per_split, grid_x, grid_y, E, st);
  return run_batched<false, true>(A, B, R, O, W, M, N, K, 1.0f, splits,
                                  kb_per_split, grid_x, grid_y, E, st);
}
