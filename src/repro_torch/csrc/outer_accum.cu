// outer_accum: the FC weight update dW(D, F) = scale * X(T, D)^T . dY(T, F)
// with an optional fused stochastic-rounding (SR) bf16 writeback — the
// UP phase of every weight op (paper §3.2, Fig 8).
//
// Replaces the TPU kernel repro/kernels/outer_accum.py::outer_accum
// (pl.pallas_call at outer_accum.py:80, body _outer_kernel), whose
// (i, j, l) grid kept an f32 (bd, bf) tile in VMEM across the token
// reduction l, read X transposed through its BlockSpec wiring and
// masked the ragged token tail of both operands (t_rem).  On the H100
// the token reduction is the loop inside each block, X is read
// transposed by wiring (A = X^T never exists in memory), the ragged
// tail is zero-filled on load, and the scale and the SR writeback
// (sr_bf16_bits, common.cuh) run once, in the epilogue: dW makes one
// pass to device memory.
//
// Two paths for bf16 operands, chosen by the wrapper from shapes and
// strides (kernels/sr_matmul.py::plan), never by a failed launch:
//
// - sm90: the TMA + wgmma mainloop of gemm_sm90.cuh with A M-major (X's
//   (T, D) boxes, read through wgmma's transpose bit) and B N-major
//   (dY's (T, F) boxes).  At a training step's layer shapes (T = 1024)
//   the product is bound by the tensor cores; the tied head's UP
//   (T = 256, D = 151936, F = 896) by bytes: reading the SR bits and
//   writing the bf16 dW, which the epilogue does in 8-byte pairs.
// - generic: operands TMA cannot describe (base not 16-byte aligned, row
//   stride not a multiple of 16 bytes).  One 128-thread block per
//   32 x 32 tile of dW walks all T tokens in 64-deep steps, X staged as
//   [t][d] and loaded as a col_major matrix_a WMMA fragment, each step's
//   partial product promoted into an f32 sum (common.cuh).
//
// A MoE table's UP (the TPU kernel under jax.vmap,
// repro/engine/dispatch.py:220-229: one pallas_call with an expert axis
// in its grid, each expert's SR bits from its own key) is ONE launch of
// gemm_sm90_batched.cuh's kernel (outer_accum_batched_bf16): X (E, T, D)
// and dY (E, T, F) read through 3-D TMA maps, whose boxes clip to one
// expert, so a token box past T reads zeros and never the next expert's
// rows; each expert's reduction stops at its live tokens; dW[e] and its
// SR bits sit at e x D x F and move through TMA.  Granite's tables
// (E = 32, T = 1024, about 256 tokens an expert live, D x F = 1024 x
// 512) are bound by bytes: the bits 64 MB and the bf16 dW 32 a table,
// beside the live rows of X and dY.
//
// f32 operands (the fp32 preset) take the f32 mainloop of
// sgemm_sm90.cuh with A M-major (X's rows copied as they lie) and B
// N-major: fmaf on the CUDA cores, no TF32, the scale and SR writeback
// in its epilogue.  A MoE table's f32 UP is one launch of
// sgemm_sm90_batched.cuh's kernel (outer_accum_batched_f32):
// each expert's X, dY and dW a contiguous block of its own, the token
// loop stopped at each expert's live count, no SR (an f32 weight is not
// rounded).
#include "common.cuh"
#include "gemm_sm90.cuh"
#include "gemm_sm90_batched.cuh"
#include "sgemm_sm90.cuh"
#include "sgemm_sm90_batched.cuh"

namespace rt {

constexpr int LDX = TM + 8;   // X tile stored [TK][TM] (bf16; +8 skews banks)

__global__ void __launch_bounds__(THREADS)
    outer_accum_kernel(const bf16* __restrict__ X, const bf16* __restrict__ Y,
                       const uint32_t* __restrict__ rbits,
                       void* __restrict__ out, int T, int D, int F,
                       int ldx, int ldy, float scale, int sr, int vec_x,
                       int vec_y) {
  __shared__ __align__(128) bf16 Xs[TK * LDX];       // [t][d]
  __shared__ __align__(128) bf16 Ys[TK * LDB_ROW];   // [t][f]
  __shared__ __align__(128) float Cs[TM * LDC];

  const int d0 = blockIdx.y * TM, f0 = blockIdx.x * TN;
  const int warp = threadIdx.x / 32;
  const int ar = (warp / 2) * 16, bc = (warp % 2) * 16;

  AccFrag acc, part;
  wmma::fill_fragment(acc, 0.f);
  for (int t0 = 0; t0 < T; t0 += TK) {
    load_tile<TK, TM, LDX>(Xs, X, ldx, t0, d0, T, D, vec_x);
    load_tile<TK, TN, LDB_ROW>(Ys, Y, ldy, t0, f0, T, F, vec_y);
    __syncthreads();
    wmma::fill_fragment(part, 0.f);
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      // A = X^T: element (d, t) sits at Xs[t][d] — column-major A
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, Xs + kk * LDX + ar, LDX);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, Ys + kk * LDB_ROW + bc, LDB_ROW);
      wmma::mma_sync(part, fa, fb, part);
    }
    promote(acc, part);
    __syncthreads();
  }
  wmma::store_matrix_sync(Cs + ar * LDC + bc, acc, LDC, wmma::mem_row_major);
  __syncthreads();

  for (int e = threadIdx.x; e < TM * TN; e += blockDim.x) {
    const int r = e / TN, c = e % TN;
    const int gd = d0 + r, gf = f0 + c;
    if (gd < D && gf < F)
      store_out(out, rbits, (size_t)gd * F + gf, Cs[r * LDC + c] * scale, sr);
  }
}

}  // namespace rt

// out(D, F) = scale * x(T, D)^T . dy(T, F): f32 without SR, bf16 (SR
// from rbits, uint32 D x F) with it.  x and dy have row strides ldx, ldy
// (elements).  f32 selects the f32 operand path (sgemm_sm90.cuh, ws:
// splits x D x F f32 partials, then grid_x * grid_y zeroed int32
// counters, when splits > 1); else both are bf16: path 1 runs the sm90
// mainloop with the plan's bn (ws: splits x D x F f32 when splits > 1),
// path 0 the generic WMMA kernel.  The plan gives splits and
// kb_per_split, and the grid (grid_x, grid_y) comes from the caller's
// loop nest over the path's tiles.  Launches on `stream`; returns
// cudaGetLastError() or a gemm_sm90.cuh ERR_ code.
extern "C" int outer_accum(const void* x, const void* dy, const void* rbits,
                           void* out, void* ws, int T, int D, int F,
                           int ldx, int ldy, float scale, int sr, int f32,
                           int path, int bn, int splits, int kb_per_split,
                           int grid_x, int grid_y, void* stream) {
  using namespace rt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* R = static_cast<const uint32_t*>(rbits);
  if (f32)
    return sgemm::run<true, true>(
        static_cast<const float*>(x), static_cast<const float*>(dy), rbits,
        out, static_cast<float*>(ws), D, F, T, ldx, ldy, scale, sr, splits,
        kb_per_split, grid_x, grid_y, st);
  if (path == 1) {
    float* W = static_cast<float*>(ws);
    if (bn == 128)
      return sm90::run<128, true, true>(x, dy, rbits, out, W, D, F, T, ldx,
                                        ldy, scale, sr, splits, kb_per_split,
                                        grid_x, grid_y, st);
    return sm90::run<64, true, true>(x, dy, rbits, out, W, D, F, T, ldx, ldy,
                                     scale, sr, splits, kb_per_split, grid_x,
                                     grid_y, st);
  }
  const int vec_x = aligned16(x) && ldx % 8 == 0;
  const int vec_y = aligned16(dy) && ldy % 8 == 0;
  outer_accum_kernel<<<dim3(grid_x, grid_y), THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), R, out, T,
      D, F, ldx, ldy, scale, sr, vec_x, vec_y);
  return static_cast<int>(cudaGetLastError());
}

// dW[e] (D, F) = scale * x[e](T, D)^T . dy[e](T, F) for the E experts of
// a MoE table in ONE launch of gemm_sm90_batched.cuh's kernel (A
// M-major): x (E, T, D) and dy (E, T, F) bf16, contiguous and 16-byte
// aligned, D and F multiples of 8; out (E, D, F) f32 without SR, bf16
// with it (rbits uint32 (E, D, F), each expert's at its own offset).
// rows (E,) int32 on the device, or null: the tokens of x[e] and dy[e]
// at or past rows[e] are zero, so each tile's reduction stops at
// ceil(rows[e] / 64) token blocks (the same result).  The plan (bn,
// splits, kb_per_split) and the grid (grid_x, grid_y) are one expert's
// (D, F, T) from kernels/sr_matmul.py::plan; ws holds splits x E x D x F
// f32 when splits > 1, and splitk_reduce_batched then sums the splits in
// order and applies the scale and the SR.  Returns cudaGetLastError(), a
// gemm_sm90.cuh ERR_ code, or cudaErrorInvalidValue for a shape or plan
// that is not its own.
extern "C" int outer_accum_batched_bf16(const void* x, const void* dy,
                                        const void* rbits, void* out,
                                        void* ws, const void* rows, int E,
                                        int T, int D, int F, float scale,
                                        int sr, int bn, int splits,
                                        int kb_per_split, int grid_x,
                                        int grid_y, void* stream) {
  using namespace rt::sm90;
  if (!batched_plan_ok(E, D, F, T, bn, splits, kb_per_split, grid_x, grid_y,
                       ws) ||
      D % 8 != 0 || (sr && rbits == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* W = static_cast<float*>(ws);
  const int* R = static_cast<const int*>(rows);
#define RT_UP_E(BN, OUT)                                                  \
  return run_batched<BN, true, true, OUT>(x, dy, rbits, out, W, R, D, F, T, \
                                          scale, splits, kb_per_split,     \
                                          grid_x, grid_y, st, E)
  if (bn == 128) {
    if (sr) RT_UP_E(128, OUT_SR);
    RT_UP_E(128, OUT_F32);
  }
  if (sr) RT_UP_E(64, OUT_SR);
  RT_UP_E(64, OUT_F32);
#undef RT_UP_E
}

// dW[e] (D, F) = scale * x[e](T, D)^T . dy[e](T, F) for the E experts of
// a MoE table with f32 operands (the fp32 preset), in ONE launch of
// sgemm_sm90_batched.cuh's kernel (A M-major, B N-major):
// x (E, T, D) and dy (E, T, F) contiguous, out (E, D, F) f32, no SR.
// rows (E,) int32 on the device, or null: the tokens of x[e] and dy[e]
// at or past rows[e] are zero, so each tile's reduction stops at
// ceil(rows[e] / 16) token blocks (the same result; an expert with no
// live token gets dW[e] = 0).  The plan (splits, kb_per_split) and the
// grid (grid_x, grid_y) are one expert's (D, F, T) from
// kernels/sr_matmul.py::f32_plan; ws holds splits x E x D x F f32
// partials, then E x grid_x x grid_y zeroed int32 counters, when
// splits > 1.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a shape or plan that is not its own.
extern "C" int outer_accum_batched_f32(const void* x, const void* dy,
                                       void* out, void* ws, const void* rows,
                                       int E, int T, int D, int F,
                                       float scale, int splits,
                                       int kb_per_split, int grid_x,
                                       int grid_y, void* stream) {
  using namespace rt::sgemm;
  if (!batched_plan_ok(E, D, F, T, splits, kb_per_split, grid_x, grid_y,
                       ws))
    return (int)cudaErrorInvalidValue;
  return run_batched<true, true>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const int*>(rows), static_cast<float*>(out),
      static_cast<float*>(ws), D, F, T, scale, splits, kb_per_split, grid_x,
      grid_y, E, static_cast<cudaStream_t>(stream));
}
