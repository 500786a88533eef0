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
// N 16): the function reads x, dt and dy and writes dx and ddt, 152 MB
// at 3.35 TB/s, 0.045 ms; it needs 18 f32 operations a state value and
// token (2.42 GFLOP, 0.036 ms at 67 TFLOP/s) and one exp (134 M at the
// SFU's 16 a clock per SM, 0.032 ms), so the bytes bind.  A kernel has
// to find h_{t-1} again in reverse order without dividing by a_t (which
// underflows to 0 under strong decay), so it walks the tokens forward
// more than once: here three exps a state value and token (the
// start-state pass, the walk to the tile starts, the recompute), about
// 0.1 ms of the SFU, under the instructions issued around them (counted
// from the code: some 40 a state value and token, most of them the walk
// back's products and sums and the shuffles of the sums over channels
// and states), so issue, not bytes, sets its time
// (launch/ablate_selective_scan_bwd.py splits it).
//
// Design (kernels/selective_scan.py::selective_scan_bwd_plan gives the
// lanes and the chunk; CH channels a block and T tokens a tile are this
// file's constants, so every shared-memory offset is one too):
//
// 1. The forward's layout: a channel's N states over L = N / 4 lanes, a
//    float4 a lane, CH = 64 consecutive channels of one row b a block
//    (64 L threads: 256 at N 16, four blocks and 32 warps an SM at 64
//    registers a thread).
// 2. The start states in parallel over the tokens: the recurrence is
//    linear, so a first kernel (selective_scan_bwd_ends, grid (blocks,
//    chunks - 1, B)) walks each chunk of `chunk` tokens but the last from
//    zeros, and stores its local end state h_loc and its decay product
//    P = prod_t a_t = exp(A sum_t dt_t) (`ends`).  The main kernel's
//    threads combine them in chunk order, h_start(k + 1) = P_k
//    h_start(k) + h_loc(k) (nothing divides; a product that underflows
//    is the right answer), and keep each chunk's true start in place of
//    its h_loc.
// 3. The main kernel (grid (blocks, B)) takes steps, each on one staged
//    tile of T tokens: a chunk's walk steps carry h from the chunk's
//    start to the start of each of its tiles (kept in shared memory,
//    each thread its own slots), then its tile steps take the tiles last
//    to first: a tile's a_t and h_{t-1} are recomputed into registers
//    (unrolled: two float4s a token) and walked back with G in
//    registers, reusing them, so the walk back computes no exp.  The
//    chunks go last to first, so G carries over from chunk to chunk.
// 4. Staging: a tile's x, dt, dy, B and C reach a ring of SLOTS slots by
//    cp.async (16-byte copies dealt out over the warps where di is a
//    multiple of 8, a value a copy otherwise), SLOTS - 1 steps ahead of
//    their use, one barrier a step.  (Copies by one thread through the
//    copy engine and an mbarrier a slot were measured no faster.)
// 5. exp(dt A) is ex2.approx(dt (A log2 e)), A scaled once a channel:
//    one multiply and one MUFU instruction (the accurate expf, about
//    eight instructions, measured 0.1 ms slower at 4 x 256).  h
//    then differs from the forward's in its last bits, within every gate
//    against the plain version; ddt's A sum is taken over the scaled A
//    and scaled back.
// 6. dx and ddt are sums over a channel's n: each lane's four products,
//    then one shuffle round that leaves dx's partial on even lanes and
//    ddt's on odd ones and (N = 16) one more; lanes 0 and 1 write them.
//    dA and dD sum over t in registers; each row b's sum is written
//    apart (`part_ad`).  dB and dC sum over every channel: a token's
//    four dC terms a lane are summed over the warp's channels during the
//    recompute, its four dB terms during the walk back, each by two
//    halving rounds of shuffles (each keeps one half and adds the
//    partner's other) and one more round, so one lane of each pair holds
//    one state's sum; the warps' sums go through shared memory (two
//    buffers) and are summed over the block's warps in order into
//    `part_bc` (2, B, S, blocks, N) at the next step.  A second kernel
//    sums part_bc over the blocks and part_ad over b, each in a fixed
//    order: no atomics, so two calls give the same bits.  (Keeping each
//    lane's states in a lane-dependent order, so that the halving rounds
//    need no selects, was measured slower: B and C then have to be
//    staged, or reordered, in four orders.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 4;                  // consecutive states a lane (a float4)
constexpr int T = 4;                  // tokens a tile, held in registers
constexpr int CH = 64;                // channels a block
constexpr int MAX_THREADS = 256;      // a block's (CH x N / 4 at N = 16)
constexpr int MIN_BLOCKS = 4;         // blocks an SM at N = 16: 64 registers
constexpr int MAX_SMEM = 56 * 1024;   // a block's shared memory, at most
constexpr int SLOTS = 4;              // staged tiles: a step's, the next 3
constexpr int REDUCE_THREADS = 256;
constexpr int MAX_DEVICES = 16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A block at N states: L lanes a channel, NT threads, W warps, each
// thread E of a tile's dt (dy, x) copies; a staged tile's floats: dt and
// dy ([t][c]), x ([t][c], bf16 packed in the first half), B and C
// ([t][n]).
template <int N>
struct Geo {
  static constexpr int L = N / P;
  static constexpr int NT = CH * L;
  static constexpr int W = NT / 32;
  static constexpr int E = T / L;
  static constexpr int DT = 0, DY = T * CH, X = 2 * T * CH, BB = 3 * T * CH,
                       CC = 3 * T * CH + T * N, SLOT = 3 * T * CH + 2 * T * N;
};

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
  float* ends;              // (2, B, chunks - 1, di, N): h_loc (then the
                            // next chunk's true start), P
  float* part_bc;           // (2, B, S, blocks, N): dB's, then dC's
  float* part_ad;           // (B, di * (N + 1)): dA's (di, N), dD's (di)
  int B;
  int S;
  int di;
  int chunk;                // tokens a chunk, a multiple of T
  int blocks;               // blocks over di
  int chunks;               // ceil(S / chunk)
  int vec;                  // di % 8 == 0, x, dt, dy, B, C on 16 bytes
};

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared; with src_bytes 0 they read as zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 16 bytes global -> shared; with src_bytes 0 they read as zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// A as the exp takes it: times log2 e
__device__ __forceinline__ float4 exp_scale(const float4& A) {
  return make_float4(A.x * LOG2E, A.y * LOG2E, A.z * LOG2E, A.w * LOG2E);
}

// exp(v ln 2), v a scaled exponent
__device__ __forceinline__ float exp_of(float v) { return ex2(v); }

// a_t = exp(dt A) from the scaled A
__device__ __forceinline__ float4 decay(float dtv, const float4& A2) {
  return make_float4(exp_of(dtv * A2.x), exp_of(dtv * A2.y),
                     exp_of(dtv * A2.z), exp_of(dtv * A2.w));
}

// h = a h + u b
__device__ __forceinline__ float4 update(const float4& a, const float4& h,
                                         float u, const float4& bv) {
  return make_float4(fmaf(a.x, h.x, u * bv.x), fmaf(a.y, h.y, u * bv.y),
                     fmaf(a.z, h.z, u * bv.z), fmaf(a.w, h.w, u * bv.w));
}

// x of token i, channel c of a staged tile
template <int N, bool BF>
__device__ __forceinline__ float staged_x(const float* sl, int i, int c) {
  if constexpr (BF) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
        sl + Geo<N>::X)[i * CH + c]);
  } else {
    return sl[Geo<N>::X + i * CH + c];
  }
}

// Issue the copies of tokens t0 .. t0 + T - 1 into slot `sl`: dt, x and
// B, and dy and C with GRADS; tokens past S and dead channels read as
// zeros.  Where a.vec (di a multiple of 8, x, dt, dy, B and C on 16
// bytes: a block's channels of a token are whole 16-byte pieces, each all
// live or all dead), the tile is a list of 16-byte copies (dt's T x CH /
// 4, dy's, x's T x CH / 4 (f32) or / 8 (bf16), B's and C's T x N / 4)
// dealt out over the threads, whole warps to an array; else a thread
// copies tokens ts + r L (r < E) of channel d0 + cs apart (4 bytes;
// bf16 x by plain loads) and element threadIdx.x of B and C.
template <int N, bool BF, bool GRADS>
__device__ __forceinline__ void stage(const Args& a, float* sl, int b, int d0,
                                      int t0) {
  using G = Geo<N>;
  const int64_t row = (int64_t)b * a.S + t0;   // the tile's first token
  if (a.vec) {
    constexpr int XE = BF ? 8 : 4;             // x's values a copy
    constexpr int QD = T * CH / 4, QX = T * CH / XE, QB = T * N / 4;
    constexpr int R0 = QD, R1 = R0 + (GRADS ? QD : 0), R2 = R1 + QX,
                  R3 = R2 + QB, R4 = R3 + (GRADS ? QB : 0);
    for (int q = threadIdx.x; q < R4; q += G::NT) {
      if (q < R1) {                   // dt, dy: [t][CH] floats
        const bool is_dt = q < R0;
        const int i = is_dt ? q : q - R0;
        const int t = i / (CH / 4), c = (i % (CH / 4)) * 4;
        const bool in = t0 + t < a.S && d0 + c < a.di;
        const float* g = is_dt ? a.dt : a.dy;
        cp_async16(sl + (is_dt ? G::DT : G::DY) + t * CH + c,
                   in ? g + (row + t) * a.di + d0 + c : g, in ? 16 : 0);
      } else if (q < R2) {            // x: [t][CH] in its own type
        const int i = q - R1;
        const int t = i / (CH / XE), c = (i % (CH / XE)) * XE;
        const bool in = t0 + t < a.S && d0 + c < a.di;
        const char* g = static_cast<const char*>(a.x);
        cp_async16(reinterpret_cast<char*>(sl + G::X)
                       + (t * CH + c) * (16 / XE),
                   in ? g + ((row + t) * a.di + d0 + c) * (16 / XE) : g,
                   in ? 16 : 0);
      } else {                        // B, C: [t][N]
        const bool is_b = q < R3;
        const int i = is_b ? q - R2 : q - R3;
        const bool in = t0 + i * 4 / N < a.S;
        const float* g = is_b ? a.Bm : a.Cm;
        cp_async16(sl + (is_b ? G::BB : G::CC) + i * 4,
                   in ? g + row * N + i * 4 : g, in ? 16 : 0);
      }
    }
    return;
  }
  const int cs = threadIdx.x % CH, ts = threadIdx.x / CH;
  const bool live = d0 + cs < a.di;
  const int64_t base = row * a.di + d0 + cs;
#pragma unroll
  for (int r = 0; r < G::E; ++r) {
    const int t = ts + r * G::L;
    const bool in = live && t0 + t < a.S;
    const int64_t o = in ? base + (int64_t)t * a.di : 0;
    const int i = threadIdx.x + r * G::NT;
    cp_async4(sl + G::DT + i, a.dt + o, in ? 4 : 0);
    if constexpr (GRADS) cp_async4(sl + G::DY + i, a.dy + o, in ? 4 : 0);
    if constexpr (BF) {
      reinterpret_cast<__nv_bfloat16*>(sl + G::X)[i] =
          in ? static_cast<const __nv_bfloat16*>(a.x)[o]
             : __float2bfloat16(0.f);
    } else {
      cp_async4(sl + G::X + i, static_cast<const float*>(a.x) + o,
                in ? 4 : 0);
    }
  }
  if (threadIdx.x < T * N) {
    const bool in = t0 + (int)threadIdx.x / N < a.S;
    const int64_t o = in ? row * N + threadIdx.x : 0;
    cp_async4(sl + G::BB + threadIdx.x, a.Bm + o, in ? 4 : 0);
    if constexpr (GRADS) {
      cp_async4(sl + G::CC + threadIdx.x, a.Cm + o, in ? 4 : 0);
    }
  }
}

// h carried over a staged tile's T tokens; with `dts`, their dt summed
template <int N, bool BF>
__device__ __forceinline__ void walk(const float* sl, int c, int n0,
                                     const float4& A2, float4& h,
                                     float* dts = nullptr) {
  using G = Geo<N>;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const float dtv = sl[G::DT + i * CH + c];
    const float4 bv =
        *reinterpret_cast<const float4*>(sl + G::BB + i * N + n0);
    h = update(decay(dtv, A2), h, dtv * staged_x<N, BF>(sl, i, c), bv);
    if (dts) *dts += dtv;
  }
}

// v: a lane's terms of dB (or dC) at its four states.  Halved over the
// lane bits 4 and 3 (channels of the warp), each round keeping the half
// its bit selects and adding the partner's other half, then summed over
// the channel bits below; v[0] is then the term of state 4 (lane % L) +
// ((lane >> 3) & 3) summed over the warp's channels, in a fixed order,
// on the lanes whose bit 2 is 0 (and their partners).
template <int N>
__device__ __forceinline__ void bc_sums(float (&v)[4], int lane32) {
  constexpr int L = N / P;
#pragma unroll
  for (int m = 16, h = 2; m >= 8; m >>= 1, h >>= 1) {
    const bool up = lane32 & m;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? v[i] : v[i + h];
      const float keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
#pragma unroll
  for (int m = 4; m >= L; m >>= 1) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
  }
}

// grid (blocks, chunks - 1, B), CH x N / 4 threads: chunk k's tokens
// (staged at once, T at a time) walked from zeros; its end state and
// decay product exp(A sum_t dt_t) to `ends`.  Dynamic shared memory: the
// chunk's chunk / T slots.
template <int N, bool BF>
__global__ void __launch_bounds__(Geo<N>::NT)
selective_scan_bwd_ends(const Args a) {
  using G = Geo<N>;
  extern __shared__ __align__(16) float smem[];
  const int tiles = a.chunk / T;
  const int c = threadIdx.x / G::L, n0 = (threadIdx.x % G::L) * P;
  const int d0 = blockIdx.x * CH, d = d0 + c;
  const int k = blockIdx.y, b = blockIdx.z;
  for (int j = 0; j < tiles; ++j) {
    stage<N, BF, false>(a, smem + j * G::SLOT, b, d0, k * a.chunk + j * T);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (d >= a.di) return;
  const float4 A2 = exp_scale(
      __ldg(reinterpret_cast<const float4*>(a.A + (int64_t)d * N + n0)));
  float4 h = zero4();
  float dts = 0.f;
  for (int j = 0; j < tiles; ++j) {
    walk<N, BF>(smem + j * G::SLOT, c, n0, A2, h, &dts);
  }
  float* e = a.ends + (((int64_t)b * (a.chunks - 1) + k) * a.di + d) * N + n0;
  *reinterpret_cast<float4*>(e) = h;
  *reinterpret_cast<float4*>(e + (int64_t)a.B * (a.chunks - 1) * a.di * N) =
      decay(dts, A2);
}

int ends_smem_bytes(int N, int chunk) {
  return (chunk / T) * T * (3 * CH + 2 * N) * (int)sizeof(float);
}

int smem_bytes(int N, int chunk) {
  const int threads = CH * (N / P);
  return threads * (16 * (chunk / T) + 8 * T)
         + SLOTS * T * (3 * CH + 2 * N) * (int)sizeof(float);
}

// A tile step: the tile's a_t and h_{t-1} recomputed into registers from
// its start h (each token's dC terms summed over the warp on the way),
// then walked back with G.  aG: a_{t+1} G_{t+1} carried in and out.
// red: this tile's warp sums, at this lane's place.
template <int N, bool BF>
__device__ __forceinline__ void tile_step(
    const Args& a, const float* sl, float4 h, float* red, int t0, int b,
    int d, bool live, int c, int lane, int lane32, const float4& A2,
    float Dd, float4& aG, float4& dA, float& dD) {
  using G = Geo<N>;
  const int n0 = lane * P;
  const bool put = (lane32 & 4) == 0;
  float4 hs[T], as[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const float dtv = sl[G::DT + i * CH + c];
    const float dyv = sl[G::DY + i * CH + c];
    const float4 bv =
        *reinterpret_cast<const float4*>(sl + G::BB + i * N + n0);
    hs[i] = h;
    as[i] = decay(dtv, A2);
    h = update(as[i], h, dtv * staged_x<N, BF>(sl, i, c), bv);
    float v[4] = {h.x * dyv, h.y * dyv, h.z * dyv, h.w * dyv};
    bc_sums<N>(v, lane32);
    if (put) red[i * G::W * 32 + 16] = v[0];
  }
  const int64_t o0 = ((int64_t)b * a.S + t0) * a.di + d;
#pragma unroll
  for (int i = T - 1; i >= 0; --i) {
    const float dtv = sl[G::DT + i * CH + c];
    const float xv = staged_x<N, BF>(sl, i, c);
    const float dyv = sl[G::DY + i * CH + c];
    const float4 bv =
        *reinterpret_cast<const float4*>(sl + G::BB + i * N + n0);
    const float4 cv =
        *reinterpret_cast<const float4*>(sl + G::CC + i * N + n0);
    const float u = dtv * xv;
    const float4 Gt = make_float4(fmaf(cv.x, dyv, aG.x), fmaf(cv.y, dyv, aG.y),
                                  fmaf(cv.z, dyv, aG.z),
                                  fmaf(cv.w, dyv, aG.w));
    aG = make_float4(as[i].x * Gt.x, as[i].y * Gt.y, as[i].z * Gt.z,
                     as[i].w * Gt.w);
    const float4 q = make_float4(aG.x * hs[i].x, aG.y * hs[i].y,
                                 aG.z * hs[i].z, aG.w * hs[i].w);
    const float gb = fmaf(Gt.w, bv.w, fmaf(Gt.z, bv.z,
                          fmaf(Gt.y, bv.y, Gt.x * bv.x)));
    const float ga = fmaf(A2.w, q.w, fmaf(A2.z, q.z,
                          fmaf(A2.y, q.y, A2.x * q.x)));
    const float gd = fmaf(ga, LN2, xv * gb);
    dA = make_float4(fmaf(dtv, q.x, dA.x), fmaf(dtv, q.y, dA.y),
                     fmaf(dtv, q.z, dA.z), fmaf(dtv, q.w, dA.w));
    dD = fmaf(dyv, xv, dD);
    // dx's sum over n on even lanes, ddt's on odd ones
    const bool in = live && t0 + i < a.S;
    const int64_t o = o0 + (int64_t)i * a.di;
    if constexpr (G::L > 1) {
      const bool odd = lane & 1;
      float r = (odd ? gd : gb)
                + __shfl_xor_sync(0xffffffffu, odd ? gb : gd, 1);
      if constexpr (G::L > 2) r += __shfl_xor_sync(0xffffffffu, r, 2);
      float* out = odd ? a.ddt : a.dx;
      const float val = odd ? r : fmaf(dtv, r, Dd * dyv);
      if (in && lane < 2) out[o] = val;
    } else if (in) {
      a.dx[o] = fmaf(dtv, gb, Dd * dyv);
      a.ddt[o] = gd;
    }
    float v[4] = {Gt.x * u, Gt.y * u, Gt.z * u, Gt.w * u};
    bc_sums<N>(v, lane32);
    if (put) red[i * G::W * 32] = v[0];
  }
}

// grid (blocks, B), CH x N / 4 threads.  Dynamic shared memory: each
// thread's state at the start of each tile of a chunk (chunk / T float4s
// a thread), two buffers of the warps' dB / dC sums (T x W x 32 floats
// each), SLOTS staged tiles.
//
// The block takes steps, each on one staged tile: a chunk's walk steps
// (tiles 0 .. last - 1, forward), then its tile steps (last .. 0), the
// chunks last to first.  Each step waits for its tile, issues the copies
// of the step SLOTS - 1 ahead (one barrier a step), then computes; a
// tile step's warp sums are summed over the warps at the next step.
template <int N, bool BF>
__global__ void
__launch_bounds__(Geo<N>::NT, MIN_BLOCKS * MAX_THREADS / Geo<N>::NT)
selective_scan_bwd_kernel(const Args a) {
  using G = Geo<N>;
  extern __shared__ __align__(16) float smem[];
  float4* sts = reinterpret_cast<float4*>(smem);
  float* sred = smem + 4 * (a.chunk / T) * G::NT;
  float* sslot = sred + 2 * T * G::NT;
  const int b = blockIdx.y;
  const int c = threadIdx.x / G::L, lane = threadIdx.x % G::L;
  const int lane32 = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n0 = lane * P;
  const int d0 = blockIdx.x * CH, d = d0 + c;
  const bool live = d < a.di;
  auto ntl = [&](int k) {              // tiles of chunk k
    return (min(a.chunk, a.S - k * a.chunk) + T - 1) / T;
  };
  // step q of chunk k (n tiles): q < n - 1 walks tile q, q = n - 1 + i
  // takes tile n - 1 - i.  (ik, iq): the next step to stage.
  int ik = a.chunks - 1, iq = 0;
  auto issue = [&](int s) {
    if (ik >= 0) {
      const int n = ntl(ik);
      float* sl = sslot + (s % SLOTS) * G::SLOT;
      if (iq >= n - 1) {
        stage<N, BF, true>(a, sl, b, d0, ik * a.chunk + (2 * n - 2 - iq) * T);
      } else {
        stage<N, BF, false>(a, sl, b, d0, ik * a.chunk + iq * T);
      }
      if (++iq == 2 * n - 1) {
        --ik;
        iq = 0;
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < SLOTS - 1; ++s) issue(s);

  // a dead channel's lanes run on zeros: every lane of the warp takes
  // part in the shuffles, and its terms are 0
  float4 A2 = zero4();
  float Dd = 0.f;
  if (live) {
    A2 = exp_scale(
        __ldg(reinterpret_cast<const float4*>(a.A + (int64_t)d * N + n0)));
    Dd = __ldg(a.D + d);
  }
  // every chunk's true start, in chunk order, in place of its h_loc
  const int64_t es = (int64_t)a.di * N;
  float* hk = a.ends + ((int64_t)b * (a.chunks - 1) * a.di + d) * N + n0;
  if (live) {
    const int64_t to_p = (int64_t)a.B * (a.chunks - 1) * es;
    float4 h = zero4();
    for (int k = 0; k + 1 < a.chunks; ++k) {
      const float4 hl = *reinterpret_cast<const float4*>(hk + k * es);
      const float4 pk = *reinterpret_cast<const float4*>(hk + to_p + k * es);
      h = make_float4(fmaf(pk.x, h.x, hl.x), fmaf(pk.y, h.y, hl.y),
                      fmaf(pk.z, h.z, hl.z), fmaf(pk.w, h.w, hl.w));
      *reinterpret_cast<float4*>(hk + k * es) = h;
    }
  }

  float4 aG = zero4(), dA = zero4();  // aG: a_{t+1} G_{t+1}
  float dD = 0.f;
  int buf = 0, pend_t0 = -1;
  // this lane's place among a token's warp sums
  const int place = warp * 32 + ((lane32 >> 3) << 2) + (lane32 & 3);
  auto sum_warps = [&]() {
    // each (token, term, n) of the tile summed over the warps in order;
    // its warp sum sits at 16 term + 4 (n % 4) + n / 4
    const int o = threadIdx.x;
    if (o < T * 2 * N) {
      const int i = o / (2 * N), j = o % (2 * N), n = j % N;
      const float* col = sred + (buf ^ 1) * T * G::NT + i * G::W * 32
                         + (j / N) * 16 + (n & 3) * 4 + (n >> 2);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < G::W; ++w) sum += col[w * 32];
      if (pend_t0 + i < a.S) {
        a.part_bc[((((int64_t)(j / N) * a.B + b) * a.S + pend_t0 + i)
                   * a.blocks + blockIdx.x) * N + n] = sum;
      }
    }
    pend_t0 = -1;
  };
  for (int s = 0, k = a.chunks - 1, q = 0; k >= 0; ++s) {
    cp_async_wait<SLOTS - 2>();
    __syncthreads();                  // this step's tile is in; step s - 1
                                      // is done with its slot
    if (pend_t0 >= 0) sum_warps();
    issue(s + SLOTS - 1);
    const int n = ntl(k);
    const float* sl = sslot + (s % SLOTS) * G::SLOT;
    if (q == 0) {                     // the chunk's start
      sts[threadIdx.x] =
          (k > 0 && live) ? *reinterpret_cast<const float4*>(hk + (k - 1) * es)
                          : zero4();
    }
    if (q < n - 1) {                  // walk: the next tile's start
      float4 h = sts[q * G::NT + threadIdx.x];
      walk<N, BF>(sl, c, n0, A2, h);
      sts[(q + 1) * G::NT + threadIdx.x] = h;
    } else {                          // recompute, then walk back
      const int j = 2 * n - 2 - q, t0 = k * a.chunk + j * T;
      tile_step<N, BF>(a, sl, sts[j * G::NT + threadIdx.x],
                       sred + buf * T * G::NT + place, t0, b, d, live, c,
                       lane, lane32, A2, Dd, aG, dA, dD);
      pend_t0 = t0;
      buf ^= 1;
    }
    if (++q == 2 * n - 1) {
      --k;
      q = 0;
    }
  }
  __syncthreads();                    // the last tile's warp sums are in
  sum_warps();
  if (live) {
    float* pa = a.part_ad + (int64_t)b * a.di * (N + 1);
    *reinterpret_cast<float4*>(pa + (int64_t)d * N + n0) = dA;
    if (lane == 0) pa[(int64_t)a.di * N + d] = dD;
  }
}

// bc[o, n] = sum_k part_bc[o, k, n] over the blocks k, then ad[j] =
// sum_b part_ad[b, j] over the rows, each in order: one thread an output
template <int N>
__global__ void __launch_bounds__(REDUCE_THREADS)
selective_scan_bwd_reduce(const Args a, float* bc, float* ad) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nbc = (int64_t)2 * a.B * a.S * N;
  const int64_t nad = (int64_t)a.di * (N + 1);
  float s = 0.f;
  if (i < nbc) {
    const float* p = a.part_bc + (i / N) * a.blocks * N + i % N;
#pragma unroll 8
    for (int k = 0; k < a.blocks; ++k) s += p[(int64_t)k * N];
    bc[i] = s;
  } else if (i < nbc + nad) {
    const float* p = a.part_ad + (i - nbc);
    for (int k = 0; k < a.B; ++k) s += p[k * nad];
    ad[i - nbc] = s;
  }
}

// A kernel's dynamic shared memory above 48 KB: its attribute, set once a
// device and size (so not inside a graph capture after a first call);
// `set`: the kernel's own table of the sizes set
cudaError_t allow_smem(const void* kern, int smem, int* set) {
  if (smem <= (48 << 10)) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && set[dev] >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess && dev < MAX_DEVICES) set[dev] = smem;
  return e;
}

template <int N, bool BF>
cudaError_t launch_ends(const Args& a, cudaStream_t st) {
  auto kern = selective_scan_bwd_ends<N, BF>;
  const int smem = ends_smem_bytes(N, a.chunk);
  static int set[MAX_DEVICES] = {};
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), smem, set);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.blocks, a.chunks - 1, a.B), Geo<N>::NT, smem, st>>>(a);
  return cudaGetLastError();
}

template <int N, bool BF>
cudaError_t launch_main(const Args& a, cudaStream_t st) {
  auto kern = selective_scan_bwd_kernel<N, BF>;
  const int smem = smem_bytes(N, a.chunk);
  static int set[MAX_DEVICES] = {};
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), smem, set);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.blocks, a.B), Geo<N>::NT, smem, st>>>(a);
  return cudaGetLastError();
}

template <int N>
cudaError_t reduce_launch(const Args& a, float* bc, float* ad,
                          cudaStream_t st) {
  const int64_t n = (int64_t)2 * a.B * a.S * N + (int64_t)a.di * (N + 1);
  const int grid = (int)((n + REDUCE_THREADS - 1) / REDUCE_THREADS);
  selective_scan_bwd_reduce<N><<<grid, REDUCE_THREADS, 0, st>>>(a, bc, ad);
  return cudaGetLastError();
}

template <int N, bool BF>
cudaError_t launch(const Args& a, float* bc, float* ad, cudaStream_t st) {
  cudaError_t e;
  if (a.chunks > 1) {
    e = launch_ends<N, BF>(a, st);
    if (e != cudaSuccess) return e;
  }
  e = launch_main<N, BF>(a, st);
  if (e != cudaSuccess) return e;
  e = reduce_launch<N>(a, bc, ad, st);
  if (e != cudaSuccess) return e;
  return cudaSuccess;
}

template <int N>
cudaError_t launch_n(const Args& a, float* bc, float* ad, int x_bf16,
                     cudaStream_t st) {
  return x_bf16 ? launch<N, true>(a, bc, ad, st)
                : launch<N, false>(a, bc, ad, st);
}

}  // namespace

// x: bf16 (x_bf16 = 1) or f32; every other tensor f32; A 16-byte
// aligned.  dx, ddt: (B, S, di); ends: (2, B, max(chunks - 1, 1), di, N)
// scratch; part_bc: (2, B, S, blocks, N) and part_ad: (B, di (N + 1))
// scratch; bc: (2, B, S, N) gets dB then dC, ad: (di (N + 1)) gets dA
// (di, N) then dD.  N is 4, 8 or 16; lanes (N / 4), ch (channels a
// block: CH) and chunk (tokens a chunk, a multiple of T) are
// selective_scan_bwd_plan's.  Returns the launches' cudaGetLastError(),
// or cudaErrorInvalidValue for a shape or plan it does not take.
extern "C" int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* dy, void* dx, void* ddt,
    void* ends, void* part_bc, void* part_ad, void* bc, void* ad, int B,
    int S, int di, int N, int x_bf16, int lanes, int ch, int chunk,
    void* stream) {
  const bool n_ok = N == 4 || N == 8 || N == 16;
  if (B < 1 || S < 1 || di < 1 || B > 65535 || !n_ok || lanes * P != N ||
      ch != CH || chunk < T || chunk % T != 0 ||
      (S + chunk - 1) / chunk > 65536 || smem_bytes(N, chunk) > MAX_SMEM ||
      ends_smem_bytes(N, chunk) > 227 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (di + CH - 1) / CH;
  const Args a{x, static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const float*>(Bm),
               static_cast<const float*>(Cm), static_cast<const float*>(D),
               static_cast<const float*>(dy), static_cast<float*>(dx),
               static_cast<float*>(ddt), static_cast<float*>(ends),
               static_cast<float*>(part_bc), static_cast<float*>(part_ad), B,
               S, di, chunk, blocks, (S + chunk - 1) / chunk,
               di % 8 == 0 &&
                   ((uintptr_t)x | (uintptr_t)dt | (uintptr_t)dy |
                    (uintptr_t)Bm | (uintptr_t)Cm) % 16 == 0};
  float* bcp = static_cast<float*>(bc);
  float* adp = static_cast<float*>(ad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return (int)launch_n<4>(a, bcp, adp, x_bf16, st);
    case 8: return (int)launch_n<8>(a, bcp, adp, x_bf16, st);
    default: return (int)launch_n<16>(a, bcp, adp, x_bf16, st);
  }
}
