// selective_scan_bwd: the gradient of Mamba's selective scan
// (csrc/selective_scan.cu) from a zero state, for every (batch row b,
// channel d) of the inner width di, given dy = dL/dy.  With
// a_t[n] = exp(dt_t A[n]), h_t = a_t h_{t-1} + (dt_t x_t) B_t and
// G_t = dL/dh_t, running t from S - 1 down to 0 (G_S = 0):
//
//   G_t    = C_t dy_t + a_{t+1} G_{t+1}
//   dx_t   = dt_t sum_n G_t[n] B_t[n] + D dy_t
//   ddt_t  = sum_n G_t[n] (A[n] a_t[n] h_{t-1}[n] + x_t B_t[n])
//   dB_t   = sum_d G_t dt_t x_t            dC_t = sum_d dy_t h_t
//   dA     = sum_{b,t} G_t dt_t a_t h_{t-1}
//   dD     = sum_{b,t} dy_t x_t
//
// Replaces no TPU kernel: the reference lets XLA differentiate the
// lax.scan of repro/models/ssm.py::selective_scan (re-materialised every
// 64 tokens).  On the card a token loop of torch ops would launch some
// thirty kernels a token and layer, so training's backward gets a
// kernel of its own, as the forward did.
//
// What bounds it on the H100 (jamba training: B 4, S 256, di 8192,
// N 16): the function reads x, dt and dy and writes dx and ddt, 151 MB
// at 3.35 TB/s, 0.045 ms; it needs 18 f32 operations a state value and
// token, with a_t h_{t-1} and sum_n G B each computed once (2.42 GFLOP,
// 0.036 ms at 67 TFLOP/s), and one exp (134 M at the SFU's 16 a clock
// per SM, 0.032 ms), so the bytes bind.  This first kernel
// also writes and reads the state at every tile's start (65 MB each way)
// and walks the tokens three times (the forward to find those states,
// a tile's recompute, the walk back), so its instructions, not its
// bytes, set its time.
//
// Design (kernels/selective_scan.py::selective_scan_bwd_plan gives the
// lanes, channels and tile; grid (ceil(di / ch), B)):
//
// 1. The forward's layout: a channel's N states over L = N / 4 lanes, a
//    float4 a lane, CH consecutive channels of one row b a block (CH x L
//    threads).  A tile of T tokens' x (bf16 converted on load: exact),
//    dt, dy, B and C is staged in shared memory by coalesced loads.
// 2. Pass 1 walks the block's channels forward from zeros over all but
//    the last tile, with the forward's arithmetic (__fmul_rn / __fadd_rn,
//    the accurate expf), and stores the state at the start of every tile
//    after the first (global scratch `starts`, (B, tiles - 1, di, N)).
// 3. Pass 2 takes the tiles last to first: it recomputes the tile's
//    h_{t-1} from its start state into shared memory (each thread's own
//    float4s), then walks the tile back with G in registers.  a_t is
//    recomputed from dt and A, never divided out of h: under strong
//    decay exp(dt A) underflows to 0.  a_{t+1} carries over from the
//    token after, across tiles too.
// 4. dx and ddt are sums over a channel's n: each lane's four products,
//    then shuffles over its L lanes; lane 0 writes them.  dA and dD sum
//    over t in registers; each row b's sum is written apart
//    (`part_ad`).  dB and dC sum over every channel: a token's terms go
//    to shared memory, and after the walk each (token, n) of the tile is
//    summed over the block's channels in order into `part_bc` (2, B, S,
//    blocks, N).  A second kernel then sums part_bc over the blocks and
//    part_ad over b, each in a fixed order: no atomics, so two calls give
//    the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 4;                  // consecutive states a lane (a float4)
constexpr int MAX_THREADS = 256;      // a block's, as the plan caps them
constexpr int MAX_SMEM = 232448;      // a block's dynamic shared memory
constexpr int REDUCE_THREADS = 256;
constexpr int MAX_DEVICES = 16;

struct Args {
  const void* x;            // (B, S, di) bf16 or f32
  const float* dt;          // (B, S, di)
  const float* A;           // (di, N)
  const float* Bm;          // (B, S, N)
  const float* Cm;          // (B, S, N)
  const float* D;           // (di,)
  const float* dy;          // (B, S, di)
  float* dx;                // (B, S, di)
  float* ddt;               // (B, S, di)
  float* starts;            // (B, tiles - 1, di, N): h at tiles 1 ..
  float* part_bc;           // (2, B, S, blocks, N): dB's, then dC's
  float* part_ad;           // (B, di * (N + 1)): dA's (di, N), dD's (di)
  int B;
  int S;
  int di;
  int ch;                   // channels a block
  int tile;                 // tokens a tile
  int blocks;               // blocks over di
  int tiles;                // ceil(S / tile)
};

template <bool BF>
__device__ __forceinline__ float load_x(const void* x, int64_t i) {
  if constexpr (BF) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  } else {
    return static_cast<const float*>(x)[i];
  }
}

// the forward's exp(dt A) and h = a h + bx, each product and sum
// rounded on its own (csrc/selective_scan.cu), so h has its bits
__device__ __forceinline__ float4 exp_dt_a(float dtv, const float4& A) {
  return make_float4(expf(__fmul_rn(dtv, A.x)), expf(__fmul_rn(dtv, A.y)),
                     expf(__fmul_rn(dtv, A.z)), expf(__fmul_rn(dtv, A.w)));
}

__device__ __forceinline__ float4 step(const float4& h, const float4& a,
                                       float dxv, const float4& bv) {
  return make_float4(
      __fadd_rn(__fmul_rn(a.x, h.x), __fmul_rn(dxv, bv.x)),
      __fadd_rn(__fmul_rn(a.y, h.y), __fmul_rn(dxv, bv.y)),
      __fadd_rn(__fmul_rn(a.z, h.z), __fmul_rn(dxv, bv.z)),
      __fadd_rn(__fmul_rn(a.w, h.w), __fmul_rn(dxv, bv.w)));
}

// Stage tokens t0 .. t0 + T - 1: x and dt (and dy with GRADS) for the
// block's channels ([t][c]; a dead channel's are zeros), B (and C with
// GRADS) ([t][n]).
template <int N, bool BF, bool GRADS>
__device__ __forceinline__ void stage(const Args& a, int b, int d0, int t0,
                                      int T, float* sx, float* sdt,
                                      float* sdy, float* sb, float* sc) {
  for (int i = threadIdx.x; i < T * a.ch; i += blockDim.x) {
    const int t = i / a.ch, d = d0 + i % a.ch;
    const bool live = d < a.di;
    const int64_t o = ((int64_t)b * a.S + t0 + t) * a.di + d;
    sx[i] = live ? load_x<BF>(a.x, o) : 0.f;
    sdt[i] = live ? a.dt[o] : 0.f;
    if constexpr (GRADS) sdy[i] = live ? a.dy[o] : 0.f;
  }
  const int64_t g = ((int64_t)b * a.S + t0) * N;
  for (int i = threadIdx.x; i < T * N; i += blockDim.x) {
    sb[i] = a.Bm[g + i];
    if constexpr (GRADS) sc[i] = a.Cm[g + i];
  }
}

int smem_bytes(int N, int ch, int tile) {
  return tile * (3 * ch + 2 * N + 3 * N * ch) * (int)sizeof(float);
}

// grid (blocks, B), ch x N / 4 threads; dynamic shared memory (floats):
// h_{t-1} (tile x threads float4s), the dB / dC terms (tile x ch x 2N),
// x, dt, dy (tile x ch each), B, C (tile x N each).
template <int N, bool BF>
__global__ void __launch_bounds__(MAX_THREADS, 2)
selective_scan_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int L = N / P;
  const int T0 = a.tile, ch = a.ch, nt = blockDim.x;
  float4* shp = reinterpret_cast<float4*>(smem);
  float* sbc = smem + 4 * T0 * nt;
  float* sx = sbc + 2 * N * T0 * ch;
  float* sdt = sx + T0 * ch;
  float* sdy = sdt + T0 * ch;
  float* sb = sdy + T0 * ch;
  float* sc = sb + T0 * N;
  const int b = blockIdx.y;
  const int c = threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const int n0 = lane * P;
  const int d0 = blockIdx.x * ch;
  const int d = d0 + c;
  const bool live = d < a.di;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // a dead channel's lanes run on zeros (x, dt, dy staged as 0): every
  // lane of the warp takes part in the shuffles, and its terms are 0
  float4 A = zero;
  float Dd = 0.f;
  if (live) {
    A = *reinterpret_cast<const float4*>(a.A + (int64_t)d * N + n0);
    Dd = a.D[d];
  }
  auto start = [&](int k) {
    return a.starts + (((int64_t)b * (a.tiles - 1) + k - 1) * a.di + d) * N
        + n0;
  };

  // pass 1: the state at the start of tiles 1 .. tiles - 1
  float4 h = zero;
  for (int k = 0; k + 1 < a.tiles; ++k) {
    const int t0 = k * T0;
    stage<N, BF, false>(a, b, d0, t0, T0, sx, sdt, sdy, sb, sc);
    __syncthreads();
    for (int t = 0; t < T0; ++t) {
      const float dtv = sdt[t * ch + c];
      const float4 bv = *reinterpret_cast<const float4*>(sb + t * N + n0);
      h = step(h, exp_dt_a(dtv, A), __fmul_rn(dtv, sx[t * ch + c]), bv);
    }
    if (live) *reinterpret_cast<float4*>(start(k + 1)) = h;
    __syncthreads();                  // the tile is consumed
  }

  // pass 2: the tiles last to first, each recomputed, then walked back
  float4 G = zero, a_next = zero, dA = zero;
  float dD = 0.f;
  for (int k = a.tiles - 1; k >= 0; --k) {
    const int t0 = k * T0;
    const int T = min(T0, a.S - t0);
    stage<N, BF, true>(a, b, d0, t0, T, sx, sdt, sdy, sb, sc);
    __syncthreads();
    h = (k > 0 && live) ? *reinterpret_cast<const float4*>(start(k)) : zero;
    for (int t = 0; t < T; ++t) {
      shp[t * nt + threadIdx.x] = h;
      const float dtv = sdt[t * ch + c];
      const float4 bv = *reinterpret_cast<const float4*>(sb + t * N + n0);
      h = step(h, exp_dt_a(dtv, A), __fmul_rn(dtv, sx[t * ch + c]), bv);
    }
    for (int t = T - 1; t >= 0; --t) {
      const float xv = sx[t * ch + c];
      const float dtv = sdt[t * ch + c];
      const float dyv = sdy[t * ch + c];
      const float4 bv = *reinterpret_cast<const float4*>(sb + t * N + n0);
      const float4 cv = *reinterpret_cast<const float4*>(sc + t * N + n0);
      const float4 hp = shp[t * nt + threadIdx.x];
      const float4 av = exp_dt_a(dtv, A);
      const float dxv = __fmul_rn(dtv, xv);
      const float4 ht = step(hp, av, dxv, bv);
      G.x = a_next.x * G.x + cv.x * dyv;
      G.y = a_next.y * G.y + cv.y * dyv;
      G.z = a_next.z * G.z + cv.z * dyv;
      G.w = a_next.w * G.w + cv.w * dyv;
      float gb = (G.x * bv.x + G.y * bv.y) + (G.z * bv.z + G.w * bv.w);
      float gd = (G.x * (A.x * av.x * hp.x + xv * bv.x)
                  + G.y * (A.y * av.y * hp.y + xv * bv.y))
                 + (G.z * (A.z * av.z * hp.z + xv * bv.z)
                    + G.w * (A.w * av.w * hp.w + xv * bv.w));
#pragma unroll
      for (int m = 1; m < L; m <<= 1) {
        gb += __shfl_xor_sync(0xffffffffu, gb, m);
        gd += __shfl_xor_sync(0xffffffffu, gd, m);
      }
      if (lane == 0 && live) {
        const int64_t o = ((int64_t)b * a.S + t0 + t) * a.di + d;
        a.dx[o] = dtv * gb + Dd * dyv;
        a.ddt[o] = gd;
      }
      dA.x += G.x * dtv * av.x * hp.x;
      dA.y += G.y * dtv * av.y * hp.y;
      dA.z += G.z * dtv * av.z * hp.z;
      dA.w += G.w * dtv * av.w * hp.w;
      dD += dyv * xv;
      float* bc = sbc + (t * ch + c) * 2 * N + n0;
      *reinterpret_cast<float4*>(bc) =
          make_float4(G.x * dxv, G.y * dxv, G.z * dxv, G.w * dxv);
      *reinterpret_cast<float4*>(bc + N) =
          make_float4(ht.x * dyv, ht.y * dyv, ht.z * dyv, ht.w * dyv);
      a_next = av;
    }
    __syncthreads();                  // the tile's dB and dC terms are in
    // each (token, j) of the tile summed over the block's channels in
    // order: j < N is dB's n, j >= N dC's
    for (int i = threadIdx.x; i < T * 2 * N; i += nt) {
      const int t = i / (2 * N), j = i % (2 * N);
      const float* col = sbc + t * ch * 2 * N + j;
      float s = 0.f;
      for (int cc = 0; cc < ch; ++cc) s += col[cc * 2 * N];
      a.part_bc[((((int64_t)(j / N) * a.B + b) * a.S + t0 + t) * a.blocks
                 + blockIdx.x) * N + j % N] = s;
    }
    __syncthreads();                  // before the next tile overwrites it
  }
  if (live) {
    float* pa = a.part_ad + (int64_t)b * a.di * (N + 1);
    float* pd = pa + (int64_t)d * N + n0;
    pd[0] = dA.x;
    pd[1] = dA.y;
    pd[2] = dA.z;
    pd[3] = dA.w;
    if (lane == 0) pa[(int64_t)a.di * N + d] = dD;
  }
}

// out[o, j] = sum_k in[o, k, j], k in order: one thread an output
__global__ void __launch_bounds__(REDUCE_THREADS)
selective_scan_bwd_reduce(const float* in, float* out, int outer, int K,
                          int inner) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)outer * inner) return;
  const int64_t o = i / inner, j = i % inner;
  const float* p = in + o * K * inner + j;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += p[(int64_t)k * inner];
  out[i] = s;
}

cudaError_t reduce(const float* in, float* out, int outer, int K, int inner,
                   cudaStream_t st) {
  const int64_t n = (int64_t)outer * inner;
  const int grid = (int)((n + REDUCE_THREADS - 1) / REDUCE_THREADS);
  selective_scan_bwd_reduce<<<grid, REDUCE_THREADS, 0, st>>>(in, out, outer,
                                                             K, inner);
  return cudaGetLastError();
}

template <int N, bool BF>
cudaError_t launch(const Args& a, float* bc, float* ad, cudaStream_t st) {
  auto kern = selective_scan_bwd_kernel<N, BF>;
  const int smem = smem_bytes(N, a.ch, a.tile);
  cudaError_t e;
  if (smem > (48 << 10)) {            // the attribute, once a device and
    static int smem_set[MAX_DEVICES] = {};   // size (not inside a graph
    int dev = 0;                             // capture after a first call)
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= MAX_DEVICES || smem_set[dev] < smem) {
      e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return e;
      if (dev < MAX_DEVICES) smem_set[dev] = smem;
    }
  }
  kern<<<dim3(a.blocks, a.B), a.ch * (N / P), smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = reduce(a.part_bc, bc, 2 * a.B * a.S, a.blocks, N, st);
  if (e != cudaSuccess) return e;
  return reduce(a.part_ad, ad, 1, a.B, a.di * (N + 1), st);
}

template <int N>
cudaError_t launch_n(const Args& a, float* bc, float* ad, int x_bf16,
                     cudaStream_t st) {
  return x_bf16 ? launch<N, true>(a, bc, ad, st)
                : launch<N, false>(a, bc, ad, st);
}

}  // namespace

// x: bf16 (x_bf16 = 1) or f32; every other tensor f32; A 16-byte
// aligned.  dx, ddt: (B, S, di); starts: (B, max(tiles - 1, 1), di, N)
// scratch; part_bc: (2, B, S, blocks, N) and part_ad: (B, di (N + 1))
// scratch; bc: (2, B, S, N) gets dB then dC, ad: (di (N + 1)) gets dA
// (di, N) then dD.  N is 4, 8 or 16; lanes (N / 4), ch (channels a
// block) and tile are selective_scan_bwd_plan's.  Returns the launches'
// cudaGetLastError(), or cudaErrorInvalidValue for a shape or plan it
// does not take.
extern "C" int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* dy, void* dx, void* ddt,
    void* starts, void* part_bc, void* part_ad, void* bc, void* ad, int B,
    int S, int di, int N, int x_bf16, int lanes, int ch, int tile,
    void* stream) {
  const bool n_ok = N == 4 || N == 8 || N == 16;
  const int threads = ch * lanes;
  if (B < 1 || S < 1 || di < 1 || B > 65535 || !n_ok || lanes * P != N ||
      ch < 1 || ch % 4 != 0 || threads > MAX_THREADS || threads % 32 != 0 ||
      tile < 1 || tile > S || smem_bytes(N, ch, tile) > MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (di + ch - 1) / ch;
  const Args a{x, static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const float*>(Bm),
               static_cast<const float*>(Cm), static_cast<const float*>(D),
               static_cast<const float*>(dy), static_cast<float*>(dx),
               static_cast<float*>(ddt), static_cast<float*>(starts),
               static_cast<float*>(part_bc), static_cast<float*>(part_ad), B,
               S, di, ch, tile, blocks, (S + tile - 1) / tile};
  float* bcp = static_cast<float*>(bc);
  float* adp = static_cast<float*>(ad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return (int)launch_n<4>(a, bcp, adp, x_bf16, st);
    case 8: return (int)launch_n<8>(a, bcp, adp, x_bf16, st);
    default: return (int)launch_n<16>(a, bcp, adp, x_bf16, st);
  }
}
