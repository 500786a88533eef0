// selective_scan: Mamba's selective state-space recurrence over S tokens
// for every (batch row b, channel d) of the inner width di:
//
//   h_t[n] = exp(dt_t A[n]) h_{t-1}[n] + (dt_t x_t) B_t[n]
//   y_t    = sum_n C_t[n] h_t[n] + D x_t
//
// with a per-(b, d) state of N f32 values, per-token step dt (f32, after
// the softplus), per-token B_t and C_t shared by every channel of a row,
// and per-channel A (N values, negative) and D.
//
// Replaces no TPU kernel: the reference runs this recurrence as a
// lax.scan of jnp ops (repro/models/ssm.py::selective_scan), which XLA
// compiles into a loop of fused elementwise ops.  On the card a token
// loop of torch ops launches about six kernels a token and layer (a
// 32-token PREFILL chunk of jamba's seven Mamba layers: ~1300), so the
// hot path gets a kernel of its own.
//
// What bounds it on the H100: per token and channel ~5 N flops and an
// exp per state value on 10-12 bytes of x, dt and y; per token and row
// 2 N values of B and C; the state (N f32 a channel) read and written
// once a call.  A DECODE step (S = 1, 32 rows of di 8192) moves the
// state's 2 x 16.8 MB: bound by bytes, 0.010 ms at 3.35 TB/s.  A
// PREFILL chunk of one row (S = 32) moves 2.6 MB: its floor is a
// launch and a serial chain of 32 tokens a thread.
//
// Design (a simple kernel that is right first):
//
// 1. One thread a (b, d) channel keeps its N state values, A[d, :] and
//    D[d] in registers for the whole call; a block holds NT consecutive
//    channels of one row b (grid (ceil(di / NT), B)), so a warp's x, dt
//    and y accesses of a token are coalesced.
// 2. B_t and C_t are the same for every channel of a row: the block
//    stages a tile of TILE tokens' B and C (2 x TILE x N f32) in shared
//    memory, two barriers a tile, none a token.
// 3. x is read as bf16 or f32 (converted on load: bf16 -> f32 is exact)
//    and dt as f32, in place; y is written in f32.  The final state goes
//    to s_out, on the rows `active` selects when it is given (s_out may
//    be s_in: each thread reads its state before it writes it).
// 4. Every product and sum is rounded as the plain version rounds it
//    (__fmul_rn / __fadd_rn: no contraction into an fma), the y sum over
//    n in order n = 0 .. N-1; only the exp and that sum's f32 rounding
//    differ from the plain version (which takes both in f64).  A token's
//    arithmetic depends on nothing but its own inputs and the carried
//    state, so a chunk of S tokens and S single-token calls give the
//    same bits, and two calls give the same bits.
//
// Alternatives not taken: splitting the N state values of a channel
// over several threads (a warp shuffle per token for y), and staging x
// and dt by cp.async; both are work for a later change, measured
// against this one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;      // channels (threads) a block
constexpr int TILE = 32;    // tokens whose B and C a block stages at once

struct Args {
  const void* x;            // (B, S, di) bf16 or f32
  const float* dt;          // (B, S, di)
  const float* A;           // (di, N)
  const float* Bm;          // (B, S, N)
  const float* Cm;          // (B, S, N)
  const float* D;           // (di,)
  const float* s_in;        // (B, di, N) or null (zeros)
  float* s_out;             // (B, di, N)
  float* y;                 // (B, S, di)
  const int* active;        // (B,) or null (every row)
  int S;
  int di;
};

template <bool BF>
__device__ __forceinline__ float load_x(const void* x, int64_t i) {
  if constexpr (BF) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  } else {
    return static_cast<const float*>(x)[i];
  }
}

template <int N, bool BF>
__global__ void __launch_bounds__(NT)
selective_scan_kernel(const Args a) {
  __shared__ float sb[TILE][N];
  __shared__ float sc[TILE][N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * NT + threadIdx.x;
  const bool live = d < a.di;
  float h[N], A[N];
  float Dd = 0.f;
  if (live) {
    const int64_t so = ((int64_t)b * a.di + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      A[n] = a.A[(int64_t)d * N + n];
      h[n] = a.s_in ? a.s_in[so + n] : 0.f;
    }
    Dd = a.D[d];
  }
  for (int t0 = 0; t0 < a.S; t0 += TILE) {
    const int T = min(TILE, a.S - t0);
    __syncthreads();                  // the previous tile is consumed
    for (int i = threadIdx.x; i < T * N; i += NT) {
      const int64_t g = ((int64_t)b * a.S + t0) * N + i;
      sb[i / N][i % N] = a.Bm[g];
      sc[i / N][i % N] = a.Cm[g];
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < T; ++t) {
      const int64_t o = ((int64_t)b * a.S + t0 + t) * a.di + d;
      const float xv = load_x<BF>(a.x, o);
      const float dtv = a.dt[o];
      const float dx = __fmul_rn(dtv, xv);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float dA = expf(__fmul_rn(dtv, A[n]));
        h[n] = __fadd_rn(__fmul_rn(dA, h[n]), __fmul_rn(dx, sb[t][n]));
        acc = __fadd_rn(acc, __fmul_rn(h[n], sc[t][n]));
      }
      a.y[o] = __fadd_rn(acc, __fmul_rn(xv, Dd));
    }
  }
  if (live && (a.active == nullptr || a.active[b] != 0)) {
    const int64_t so = ((int64_t)b * a.di + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) a.s_out[so + n] = h[n];
  }
}

template <int N>
cudaError_t launch(const Args& a, int B, int x_bf16, cudaStream_t st) {
  const dim3 grid((a.di + NT - 1) / NT, B);
  if (x_bf16) {
    selective_scan_kernel<N, true><<<grid, NT, 0, st>>>(a);
  } else {
    selective_scan_kernel<N, false><<<grid, NT, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// x: bf16 (x_bf16 = 1) or f32; dt, A, Bm, Cm, D, the states and y: f32;
// active: int32; s_in and active may be null.  N is 4, 8 or 16.
// Returns the launch's cudaGetLastError(), or cudaErrorInvalidValue for
// a shape it does not take.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* A, const void* Bm,
                                     const void* Cm, const void* D,
                                     const void* s_in, void* s_out, void* y,
                                     const void* active, int B, int S,
                                     int di, int N, int x_bf16,
                                     void* stream) {
  if (B < 1 || S < 1 || di < 1 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x, static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const float*>(Bm),
               static_cast<const float*>(Cm), static_cast<const float*>(D),
               static_cast<const float*>(s_in), static_cast<float*>(s_out),
               static_cast<float*>(y), static_cast<const int*>(active), S,
               di};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return (int)launch<4>(a, B, x_bf16, st);
    case 8: return (int)launch<8>(a, B, x_bf16, st);
    case 16: return (int)launch<16>(a, B, x_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
