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
// What bounds it on the H100 (jamba: di 8192, N 16; the bounds are
// launch/bench_selective_scan.py::bound_ms):
// - A DECODE step (S = 1, 32 rows) is the state's bytes: 2 x 16.8 MB
//   read and written once, 0.011 ms at 3.35 TB/s; its arithmetic is
//   nothing.  The kernel has to keep many whole, coalesced lines of the
//   (B, di, N) state in flight: few registers, many threads an SM.
// - A PREFILL chunk of one row (S = 32) moves 2.6 MB (0.0013 ms), but
//   each channel is a serial chain of 32 tokens, so its time is the
//   token loop's instructions at the few warps one row gives (di x N / 4
//   threads: under 8 warps an SM), after a launch and one round trip for
//   the state and the tile.
// - A long chunk (S = 512; training's 4 x 256) is one exp a state value
//   and token: 67 M exps at the SFU's 16 a clock per SM take 0.016 ms,
//   against 44 MB of x, dt, B, C and y (0.013 ms).  The accurate expf is
//   eight instructions, one of them on the SFU, so the token loop's
//   instructions (about 75 a token and lane) bound it, not the SFU.
//
// Design (from kernels/selective_scan.py::selective_scan_plan, whose
// lanes, channels and tile are this entry's arguments):
//
// 1. A channel's N states are split over L = N / 4 lanes of one warp,
//    four consecutive states a lane held as one float4, so a warp's loads
//    and stores of the state and of A are 512 contiguous bytes of their
//    (B, di, N) and (di, N) layouts.  A block holds CH consecutive
//    channels of one row b (CH x L threads, whole warps; grid
//    (ceil(di / CH), B)).  (A state a lane, L = N, was measured too: it
//    issues four shuffle adds a state and token for y and loses at every
//    shape, so it was not kept.)
// 2. y = sum_n C[n] h[n] is a balanced pairwise tree over n in its
//    natural order: a lane sums its four products pairwise, then the L
//    lanes combine by __shfl_xor_sync with masks 1, 2, .., L/2.  Every
//    lane ends with the same bits (an f32 add is commutative).
// 3. A tile of T tokens' x (converted to f32: bf16 -> f32 is exact) and
//    dt for the block's channels, and their B and C, are staged in shared
//    memory: each thread loads its share of the tile (at most KP values of
//    each, every load issued before any is stored, coalesced), stores it,
//    and a barrier follows.  A channel's L lanes read one x and dt there,
//    and its lane 0 writes y there; the tile's y leaves by coalesced
//    stores after a second barrier.  Where S spans several tiles (MULTI),
//    the next tile's loads are issued into registers before a tile's
//    tokens and stored after them, so their latency hides under the
//    compute; where one tile holds the call, those registers are not
//    spent, and a DECODE step (one value a thread: K = 1) keeps 32, so
//    eight blocks of 256 fit an SM.
// 4. Tokens go U = 4 at a time: their exps and dx B_t, which do not
//    depend on h, are issued first (head), so h's chain is one multiply
//    and one add a token (tail); the U tokens' shuffle trees are
//    independent and interleave.  A tile's last T mod U tokens go one at
//    a time with the same arithmetic.  (U = 8, and a software pipeline
//    issuing one group's head with the previous group's tail, were
//    measured no faster and slower.)
// 5. Every product and sum is rounded as the plain version rounds it
//    (__fmul_rn / __fadd_rn: no contraction into an fma), with the
//    accurate expf, so h is bit for bit what one thread a channel with
//    the same operations computes; only the exp and y's f32 tree differ
//    from the plain version (which takes both in f64).  A token's
//    arithmetic depends on nothing but its own inputs and the carried
//    state, so a chunk of S tokens and S single-token calls give the same
//    bits, and two calls give the same bits, whatever block and tile the
//    plan gives each call.
// 6. The final state goes to s_out, on the rows `active` selects when it
//    is given (s_out may be s_in: each thread reads its states before it
//    writes them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 4;              // consecutive states a lane (a float4)
constexpr int U = 4;              // tokens a step of the unrolled loop
constexpr int MAX_THREADS = 256;  // a block's, as the plan caps them
constexpr int MAX_SMEM = 48 * 1024;
constexpr int KP = 8;             // a thread's share of a tile's x, dt, B, C

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
  int ch;                   // channels a block
  int tile;                 // tokens staged at once
};

template <bool BF>
__device__ __forceinline__ float load_x(const void* x, int64_t i) {
  if constexpr (BF) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  } else {
    return static_cast<const float*>(x)[i];
  }
}

// sum_p c[p] h[p] over a lane's four states, as a balanced pairwise tree
__device__ __forceinline__ float lane_sum(const float4& h, const float4& c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(h.x, c.x), __fmul_rn(h.y, c.y)),
                   __fadd_rn(__fmul_rn(h.z, c.z), __fmul_rn(h.w, c.w)));
}

__device__ __forceinline__ float4 exp_dt_a(float dtv, const float4& A) {
  return make_float4(expf(__fmul_rn(dtv, A.x)), expf(__fmul_rn(dtv, A.y)),
                     expf(__fmul_rn(dtv, A.z)), expf(__fmul_rn(dtv, A.w)));
}

// h = dA h + bx, each product and sum rounded on its own
__device__ __forceinline__ void update(float4& h, const float4& dA,
                                       const float4& bx) {
  h.x = __fadd_rn(__fmul_rn(dA.x, h.x), bx.x);
  h.y = __fadd_rn(__fmul_rn(dA.y, h.y), bx.y);
  h.z = __fadd_rn(__fmul_rn(dA.z, h.z), bx.z);
  h.w = __fadd_rn(__fmul_rn(dA.w, h.w), bx.w);
}

// What M tokens from t of the staged tile need before h: x, and each
// state's exp(dt A) and dx B.  None of it depends on h.
template <int M>
struct Group {
  float xv[M];
  float4 dA[M], bx[M];
};

template <int N, int M>
__device__ __forceinline__ void head(const float* sb, const float* sx,
                                     const float* sdt, int t, int ch, int c,
                                     int n0, const float4& A, Group<M>& g) {
#pragma unroll
  for (int k = 0; k < M; ++k) {
    g.xv[k] = sx[(t + k) * ch + c];
    const float dtv = sdt[(t + k) * ch + c];
    const float dx = __fmul_rn(dtv, g.xv[k]);
    const float4 bv = *reinterpret_cast<const float4*>(sb + (t + k) * N + n0);
    g.dA[k] = exp_dt_a(dtv, A);
    g.bx[k] = make_float4(__fmul_rn(dx, bv.x), __fmul_rn(dx, bv.y),
                          __fmul_rn(dx, bv.z), __fmul_rn(dx, bv.w));
  }
}

// The M tokens' h chain, then their M shuffle trees; lane 0 of the
// channel writes y.
template <int N, int M>
__device__ __forceinline__ void tail(const float* sc, float* sy, int t,
                                     int ch, int c, int n0, bool lane0,
                                     const Group<M>& g, float4& h, float Dd) {
  constexpr int L = N / P;
  float v[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float4 cv = *reinterpret_cast<const float4*>(sc + (t + k) * N + n0);
    update(h, g.dA[k], g.bx[k]);
    v[k] = lane_sum(h, cv);
  }
#pragma unroll
  for (int m = 1; m < L; m <<= 1) {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      v[k] = __fadd_rn(v[k], __shfl_xor_sync(0xffffffffu, v[k], m));
    }
  }
  if (lane0) {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      sy[(t + k) * ch + c] = __fadd_rn(v[k], __fmul_rn(g.xv[k], Dd));
    }
  }
}

// Tokens 0 .. T - 1 of the staged tile, in groups of U (GROUPS), then
// the T mod U left one at a time.  Every token's arithmetic is the same
// either way.
template <int N, bool GROUPS>
__device__ __forceinline__ void tile_tokens(const float* sb, const float* sc,
                                            const float* sx, const float* sdt,
                                            float* sy, int T, int ch, int c,
                                            int n0, bool lane0,
                                            const float4& A, float4& h,
                                            float Dd) {
  int t = 0;
  if constexpr (GROUPS) {
    for (; t + U <= T; t += U) {
      Group<U> g;
      head<N, U>(sb, sx, sdt, t, ch, c, n0, A, g);
      tail<N, U>(sc, sy, t, ch, c, n0, lane0, g, h, Dd);
    }
  }
  for (; t < T; ++t) {
    Group<1> g;
    head<N, 1>(sb, sx, sdt, t, ch, c, n0, A, g);
    tail<N, 1>(sc, sy, t, ch, c, n0, lane0, g, h, Dd);
  }
}

// A thread's share of a tile, held in registers between its loads and
// its stores to shared memory: elements threadIdx.x + k * blockDim.x
// (k < K) of the tile's B and C (T x N) and of its x and dt (T x ch).
// With blockDim.x = ch x L, the x and dt ones are one channel's, cx =
// threadIdx.x % ch, at tokens tx + k L, tx = threadIdx.x / ch.
template <int K>
struct Fetched {
  float b[K], c[K], x[K], dt[K];
};

// Load tokens t0 .. t0 + T - 1 (every load issued before any is used);
// a dead channel's x and dt are zeros.
template <int N, bool BF, int K>
__device__ __forceinline__ void fetch(const Args& a, Fetched<K>& f, int b,
                                      int d0, int cx, int tx, int t0,
                                      int T) {
  constexpr int L = N / P;
  const int nt = blockDim.x;
  const int64_t g = ((int64_t)b * a.S + t0) * N + threadIdx.x;
  const int64_t o = ((int64_t)b * a.S + t0 + tx) * a.di + d0 + cx;
  const int64_t step = (int64_t)L * a.di;
  const bool dl = d0 + cx < a.di;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool bc = threadIdx.x + k * nt < T * N;
    f.b[k] = bc ? a.Bm[g + k * nt] : 0.f;
    f.c[k] = bc ? a.Cm[g + k * nt] : 0.f;
    const bool xd = dl && tx + k * L < T;
    f.x[k] = xd ? load_x<BF>(a.x, o + k * step) : 0.f;
    f.dt[k] = xd ? a.dt[o + k * step] : 0.f;
  }
}

template <int N, int K>
__device__ __forceinline__ void commit(const Args& a, const Fetched<K>& f,
                                       float* sb, float* sc, float* sx,
                                       float* sdt, int T) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < T * N) {
      sb[i] = f.b[k];
      sc[i] = f.c[k];
    }
    if (i < T * a.ch) {
      sx[i] = f.x[k];
      sdt[i] = f.dt[k];
    }
  }
}

// Write tokens t0 .. t0 + T - 1 of y from the staged tile.
__device__ __forceinline__ void unstage(const Args& a, const float* sy,
                                        int b, int d0, int t0, int T) {
  for (int i = threadIdx.x; i < T * a.ch; i += blockDim.x) {
    const int t = i / a.ch, d = d0 + i % a.ch;
    if (d < a.di) a.y[((int64_t)b * a.S + t0 + t) * a.di + d] = sy[i];
  }
}

// grid (ceil(di / ch), B), ch x N / 4 threads; dynamic shared memory
// tile x (2 N + 3 ch) floats: B, C, then x, dt, y.  K: a thread's share
// of a tile (KP, or 1 for a DECODE step, whose registers then stay few
// enough for eight blocks of 256 an SM).  MULTI: S spans more than one
// tile, and the next tile's loads fly while one is computed (their
// registers are not spent where one tile holds the call).
template <int N, bool BF, int K, bool MULTI>
__global__ void __launch_bounds__(MAX_THREADS)
selective_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int L = N / P;
  const int T0 = a.tile;
  float* sb = smem;
  float* sc = sb + T0 * N;
  float* sx = sc + T0 * N;
  float* sdt = sx + T0 * a.ch;
  float* sy = sdt + T0 * a.ch;
  const int b = blockIdx.y;
  const int c = threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const int n0 = lane * P;
  const int d0 = blockIdx.x * a.ch;
  const int d = d0 + c;
  const bool live = d < a.di;
  // a dead channel's lanes run the loop on zeros: every lane of the warp
  // takes part in the shuffles
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f), A = h;
  float Dd = 0.f;
  const int64_t so = ((int64_t)b * a.di + d) * N + n0;
  if (live) {
    A = *reinterpret_cast<const float4*>(a.A + (int64_t)d * N + n0);
    if (a.s_in) h = *reinterpret_cast<const float4*>(a.s_in + so);
    Dd = a.D[d];
  }
  Fetched<K> f;
  const int cx = threadIdx.x % a.ch, tx = threadIdx.x / a.ch;
  fetch<N, BF, K>(a, f, b, d0, cx, tx, 0, min(T0, a.S));
  commit<N, K>(a, f, sb, sc, sx, sdt, min(T0, a.S));
  __syncthreads();
  for (int t0 = 0; t0 < a.S; t0 += T0) {
    const int T = min(T0, a.S - t0);
    const int T1 = min(T0, a.S - t0 - T0);   // the next tile's, if any
    if constexpr (MULTI) {
      if (T1 > 0) fetch<N, BF, K>(a, f, b, d0, cx, tx, t0 + T0, T1);
    }
    tile_tokens<N, (K > 1)>(sb, sc, sx, sdt, sy, T, a.ch, c, n0, lane == 0,
                            A, h, Dd);
    __syncthreads();                  // the tile is consumed, y is in sy
    unstage(a, sy, b, d0, t0, T);
    if constexpr (MULTI) {
      if (T1 > 0) commit<N, K>(a, f, sb, sc, sx, sdt, T1);
    }
    __syncthreads();                  // sy is written out, the next tile in
  }
  if (live && (a.active == nullptr || a.active[b] != 0)) {
    *reinterpret_cast<float4*>(a.s_out + so) = h;
  }
}

int smem_bytes(int N, int ch, int tile) {
  return tile * (2 * N + 3 * ch) * (int)sizeof(float);
}

template <int N, bool BF>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  const dim3 grid((a.di + a.ch - 1) / a.ch, B);
  const int threads = a.ch * (N / P);
  const int smem = smem_bytes(N, a.ch, a.tile);
  const bool one = a.tile * N <= threads && a.tile * a.ch <= threads;
  if (a.S > a.tile) {
    selective_scan_kernel<N, BF, KP, true><<<grid, threads, smem, st>>>(a);
  } else if (one) {
    selective_scan_kernel<N, BF, 1, false><<<grid, threads, smem, st>>>(a);
  } else {
    selective_scan_kernel<N, BF, KP, false><<<grid, threads, smem, st>>>(a);
  }
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_n(const Args& a, int B, int x_bf16, cudaStream_t st) {
  return x_bf16 ? launch<N, true>(a, B, st) : launch<N, false>(a, B, st);
}

}  // namespace

// x: bf16 (x_bf16 = 1) or f32; dt, A, Bm, Cm, D, the states and y: f32;
// A and the states 16-byte aligned; active: int32; s_in and active may
// be null.  N is 4, 8 or 16; lanes (a channel's: N / 4), ch (channels a
// block) and tile (tokens staged at once) are selective_scan_plan's.
// Returns the launch's cudaGetLastError(), or cudaErrorInvalidValue for
// a shape or plan it does not take.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* A, const void* Bm,
                                     const void* Cm, const void* D,
                                     const void* s_in, void* s_out, void* y,
                                     const void* active, int B, int S,
                                     int di, int N, int x_bf16, int lanes,
                                     int ch, int tile, void* stream) {
  const bool n_ok = N == 4 || N == 8 || N == 16;
  const int threads = ch * lanes;
  if (B < 1 || S < 1 || di < 1 || B > 65535 || !n_ok || lanes * P != N ||
      ch < 1 || threads > MAX_THREADS || threads % 32 != 0 || tile < 1 ||
      tile * ch > KP * threads || tile * N > KP * threads ||
      smem_bytes(N, ch, tile) > MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x, static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const float*>(Bm),
               static_cast<const float*>(Cm), static_cast<const float*>(D),
               static_cast<const float*>(s_in), static_cast<float*>(s_out),
               static_cast<float*>(y), static_cast<const int*>(active), S,
               di, ch, tile};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return (int)launch_n<4>(a, B, x_bf16, st);
    case 8: return (int)launch_n<8>(a, B, x_bf16, st);
    default: return (int)launch_n<16>(a, B, x_bf16, st);
  }
}
