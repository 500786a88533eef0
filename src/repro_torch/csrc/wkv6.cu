// wkv6: the RWKV6 (Finch) recurrence over S tokens for every (batch, head):
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t
//
// with a per-(b, h) hd x hd f32 state S (row i: key index, column j:
// value index), per-token decay w_t in (0, 1) and the first-token bonus u.
//
// Replaces the TPU kernel repro/kernels/wkv6.py::wkv6 (pl.pallas_call at
// wkv6.py:98, body _wkv6_kernel).  The TPU kernel turns the recurrence
// into three MXU matmuls per 64-token chunk (the chunked linear-attention
// identity, decay ratios in log space clamped at +-80) and carries the
// state across a sequential grid axis, starting from zeros.  Its clamp
// gives wrong answers under strong decay (two tokens far apart on either
// side of the chunk midpoint both clamp, and their product becomes 1
// instead of ~0), and its sums run in an order that depends on the chunk
// length.  Serving needs what it lacks: a carried initial state (every
// PREFILL chunk and every DECODE step continues a request's state),
// S = 1 and S not divisible by 64, and the same bits from a chunk as
// from its tokens one call at a time.  So this is the exact token-serial
// recurrence in f32.
//
// What bounds it on the H100: per token and head ~4 hd^2 flops on ~5 hd
// input values, and the hd^2 state read and written once a call.  A
// DECODE step (S = 1, B*H = 1024 heads) is bound by the state's bytes
// (2 x 16 KB a head).  A PREFILL chunk (S = 32, one request, B*H = 32)
// moves 0.3 MB: its floor is latency — one launch, one round trip to
// device memory — and a short serial compute tail.
//
// Design:
//
// 1. The state is split by value columns.  Block (b, h, cb) owns columns
//    c0 .. c0 + CW - 1 of head (b, h)'s state.  Each y column sums over
//    the rows only, so the split needs no cross-block reduction.  Thread
//    (g, q) owns CV columns c0 + CV q .. of rows 4g .. 4g + 3 in
//    registers for the whole call: NG = hd / 4 row groups x CW / CV
//    column threads.  kernels/wkv6.py::wkv6_plan picks one of two
//    layouts from the shape:
//    - a chunk: CW = 16, CV = 1, so the serial token loop runs on many
//      threads: a one-slot chunk at hd 64 is 32 heads x 4 blocks of 256
//      threads = 128 blocks, one wave of 132 SMs;
//    - a DECODE step with a head for every SM (S = 1, B*H >= 132): one
//      block a head, CW = hd, CV = 4, each state row read and written
//      as float4s, so many bytes are in flight (32 slots: 1024 blocks of
//      256 threads).  16-column blocks with one column a thread leave
//      too few there (4096 blocks of four 4-byte loads a thread: 0.0193
//      ms cold in L2 against this layout's 0.0122, H100 SXM at 700 W,
//      chip_smoke.py's phase_wkv6).
//    A warp covers whole 32-byte sectors of the state rows (CW / CV
//    threads x CV x 4 bytes, c0 a multiple of 16), read once at the
//    start and written once at the end.
// 2. The chunk is staged on chip before the recurrence.  cp.async
//    (16 bytes, L2 only) copies r, k, w (all hd rows) and v (the block's
//    CW columns) of a tile of T <= 32 tokens into shared memory; a
//    longer S runs in tiles with two stages, tile i + 2 in flight while
//    tile i computes.  The state slice and u load while the first copies
//    fly, so a one-tile chunk pays one memory latency, not one a token.
// 3. No block barrier per token.  The only serial chain is
//    st = fma(w, st, kv); each thread writes its token's y partial (its
//    four rows) to shared memory and runs on.  After a tile, one barrier,
//    then the partials of each (token, column) are summed over the NG
//    row groups in order g = 0 .. NG - 1 and y is written coalesced,
//    once a tile.  Two barriers a tile; none a token.
// 4. r, k and v are read as bf16 or f32 (one type for the three) and
//    converted on load from shared memory: bf16 -> f32 is exact, so the
//    result is bit-identical to converting first.  w, u and the state
//    are f32.  The serving path passes the bf16 projections in place.
//
// Every sum's order is fixed by hd alone (a column's four rows of a
// group in order, then the NG groups in order): it depends on neither
// S, B, the tile, the column split nor CV, so a chunk of S tokens and S
// single-token calls give the same bits, on either layout.
//
// Alternatives not taken: the y reduction is a shared-memory sum in
// fixed order rather than warp shuffles (a warp holds two row groups of
// 16 columns, so a shuffle tree would only save the first of 16 adds);
// and the state is written after the last tile's y sum — written right
// after the last token, before that barrier, a DECODE step measured
// slower (0.0130–0.0131 ms cold against 0.0122–0.0128, same card).
//
// Layout: r, k, v, w, y are (B, S, H, hd) (the model's layout; the TPU
// kernel's (BH, S, hd) fold is H = 1), u is (H, hd) shared over b, or
// (B, H, hd) per b (u_per_b); the state is (B, H, hd, hd) f32.  y is f32.
// s_in == nullptr starts from zeros; s_out may equal s_in (in place);
// active (B,) int32, when given, skips the state write of rows b with
// active[b] == 0 (their y is still computed).  Every pointer is 16-byte
// aligned (the wrapper checks).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RPG = 4;            // state rows a thread owns: one float4
constexpr int MAX_DEVICES = 16;

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s_in;
  float* s_out;
  float* y;
  const int* active;
  int H, S, T, u_per_b;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// `rows` rows of BYTES (a multiple of 16) from global rows `stride` bytes
// apart into consecutive shared rows, 16 bytes a copy, NT threads.
template <int BYTES, int NT>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const unsigned char* src,
                                           size_t stride, int rows,
                                           int tid) {
  constexpr int PER = BYTES / 16;
  static_assert(PER * 16 == BYTES, "rows must be whole 16-byte chunks");
  for (int q = tid; q < rows * PER; q += NT) {
    const int row = q / PER, col = q - row * PER;
    cp_async16(dst + row * BYTES + 16 * col, src + row * stride + 16 * col);
  }
}

// Four consecutive values at element `i` of a row (shared memory, or the
// state in device memory), as f32.
template <bool BF>
__device__ __forceinline__ float4 quad(const unsigned char* s, int i) {
  if constexpr (BF) {
    const uint2 p = *reinterpret_cast<const uint2*>(s + 2 * i);
    return make_float4(__uint_as_float(p.x << 16),
                       __uint_as_float(p.x & 0xffff0000u),
                       __uint_as_float(p.y << 16),
                       __uint_as_float(p.y & 0xffff0000u));
  } else {
    return *reinterpret_cast<const float4*>(s + 4 * i);
  }
}

template <bool BF>
__device__ __forceinline__ float one(const unsigned char* s, int i) {
  if constexpr (BF) {
    return __uint_as_float(
        uint32_t(*reinterpret_cast<const uint16_t*>(s + 2 * i)) << 16);
  } else {
    return *reinterpret_cast<const float*>(s + 4 * i);
  }
}

// Shared memory a launch needs: `stages` token tiles of r, k, w, v, then
// the tile's y partials.  ES: bytes of an r / k / v element.
__host__ __device__ constexpr int smem_need(int hd, int cw, int es, int t,
                                            int stages) {
  return stages * t * (2 * hd * es + 4 * hd + cw * es) +
         t * (hd / RPG) * cw * 4;
}

// CV consecutive values at element `i` of a row, as f32.
template <int CV, bool BF>
__device__ __forceinline__ void load_cols(const unsigned char* s, int i,
                                          float (&out)[CV]) {
  if constexpr (CV == 4) {
    const float4 q = quad<BF>(s, i);
    out[0] = q.x, out[1] = q.y, out[2] = q.z, out[3] = q.w;
  } else {
    static_assert(CV == 1, "a thread owns 1 or 4 columns");
    out[0] = one<BF>(s, i);
  }
}

template <int CV>
__device__ __forceinline__ void store_cols(float* dst, const float (&x)[CV]) {
  if constexpr (CV == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  else
    dst[0] = x[0];
}

// Blocks of 256 and 128 threads keep 64 registers a thread, so four or
// eight fit an SM (a DECODE step's state loads need them in flight);
// smaller blocks, hd 16's, may take more.  At 64 the hd-64 DECODE
// layout with bf16 r, k, v spills 4 bytes; 80 registers (three blocks
// an SM) spill none but measured slower: 0.0128-0.0130 ms cold in L2
// against 0.0122-0.0126 (H100 SXM at 700 W, chip_smoke.py's phase_wkv6).
constexpr int min_blocks(int nt) { return 1024 / nt < 8 ? 1024 / nt : 8; }

// HD: head size; CW: state columns a block; CV: columns a thread (1, or
// 4 for the one-block-a-head DECODE plan: float4 state loads); BF: bf16
// r, k, v.
template <int HD, int CW, int CV, bool BF>
__global__ void __launch_bounds__(HD / RPG * (CW / CV),
                                  min_blocks(HD / RPG * (CW / CV)))
wkv6_kernel(Args a) {
  constexpr int NG = HD / RPG;        // row groups
  constexpr int NQ = CW / CV;         // column threads
  constexpr int NT = NG * NQ;         // threads
  constexpr int NCB = HD / CW;        // column blocks a head
  constexpr int ES = BF ? 2 : 4;      // bytes of an r / k / v element
  constexpr int RB = HD * ES, WB = HD * 4, VB = CW * ES;  // bytes a token
  static_assert(VB % 16 == 0, "a block's v columns are whole 16 bytes");
  // tokens unrolled: the one-block-a-head plan runs one token a call
  constexpr int UNROLL = CV == 4 ? 1 : 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int H = a.H, S = a.S, T = a.T;
  const int bh = blockIdx.x / NCB, c0 = (blockIdx.x % NCB) * CW;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, c = CV * (tid % NQ), g = tid / NQ;
  const int ntiles = (S + T - 1) / T;
  const int stage_bytes = T * (2 * RB + WB + VB);
  float* part = reinterpret_cast<float*>(smem + (ntiles > 1 ? 2 : 1) *
                                                    stage_bytes);
  const size_t tok = (size_t)H * HD;                  // elements a token
  const size_t base = ((size_t)b * S * H + h) * HD;   // token 0 of (b, h)

  auto issue = [&](int tile, int stage) {
    const int t0 = tile * T, n = min(T, S - t0);
    unsigned char* d = smem + stage * stage_bytes;
    const size_t off = base + (size_t)t0 * tok;
    stage_rows<RB, NT>(d, static_cast<const unsigned char*>(a.r) + off * ES,
                       tok * ES, n, tid);
    stage_rows<RB, NT>(d + T * RB,
                       static_cast<const unsigned char*>(a.k) + off * ES,
                       tok * ES, n, tid);
    stage_rows<WB, NT>(d + 2 * T * RB,
                       reinterpret_cast<const unsigned char*>(a.w + off),
                       tok * 4, n, tid);
    stage_rows<VB, NT>(
        d + 2 * T * RB + T * WB,
        static_cast<const unsigned char*>(a.v) + (off + c0) * ES, tok * ES,
        n, tid);
    cp_async_commit();
  };
  issue(0, 0);
  if (ntiles > 1) issue(1, 1);

  // u and the state slice load while the copies fly
  const float4 uq = *reinterpret_cast<const float4*>(
      a.u + ((size_t)(a.u_per_b ? b : 0) * H + h) * HD + RPG * g);
  const float uu[RPG] = {uq.x, uq.y, uq.z, uq.w};
  const size_t s_off = (size_t)bh * HD * HD + (size_t)RPG * g * HD + c0 + c;
  float st[RPG][CV];
#pragma unroll
  for (int i = 0; i < RPG; ++i) {
    if (a.s_in) {
      load_cols<CV, false>(
          reinterpret_cast<const unsigned char*>(a.s_in + s_off + i * HD), 0,
          st[i]);
    } else {
#pragma unroll
      for (int j = 0; j < CV; ++j) st[i][j] = 0.f;
    }
  }

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int t0 = it * T, n = min(T, S - t0);
    const unsigned char* rs = smem + (it & 1) * stage_bytes;
    const unsigned char* ks = rs + T * RB;
    const unsigned char* ws = ks + T * RB;
    const unsigned char* vs = ws + T * WB;
#pragma unroll UNROLL
    for (int t = 0; t < n; ++t) {
      const float4 rq = quad<BF>(rs, t * HD + RPG * g);
      const float4 kq = quad<BF>(ks, t * HD + RPG * g);
      const float4 wq = quad<false>(ws, t * HD + RPG * g);
      float vc[CV];
      load_cols<CV, BF>(vs, t * CW + c, vc);
      const float rr[RPG] = {rq.x, rq.y, rq.z, rq.w};
      const float kk[RPG] = {kq.x, kq.y, kq.z, kq.w};
      const float ww[RPG] = {wq.x, wq.y, wq.z, wq.w};
      float acc[CV];
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        acc[j] = 0.f;
#pragma unroll
        for (int i = 0; i < RPG; ++i) {
          const float kv = kk[i] * vc[j];
          acc[j] = fmaf(rr[i], fmaf(uu[i], kv, st[i][j]), acc[j]);
          st[i][j] = fmaf(ww[i], st[i][j], kv);
        }
      }
      store_cols<CV>(part + (t * NG + g) * CW + c, acc);
    }
    __syncthreads();
    // this stage is free: the tile after next goes into it
    if (it + 2 < ntiles) issue(it + 2, it & 1);
    for (int o = tid; o < n * CW; o += NT) {
      const int t = o / CW, cc = o % CW;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NG; ++q) s += part[(t * NG + q) * CW + cc];
      a.y[base + (size_t)(t0 + t) * tok + c0 + cc] = s;
    }
  }
  if (a.active && !a.active[b]) return;
#pragma unroll
  for (int i = 0; i < RPG; ++i) store_cols<CV>(a.s_out + s_off + i * HD, st[i]);
}

template <int HD, int CW, int CV, bool BF>
cudaError_t launch(const Args& a, int B, int smem, cudaStream_t st) {
  constexpr int NT = HD / RPG * (CW / CV);
  auto kern = wkv6_kernel<HD, CW, CV, BF>;
  if (smem > (48 << 10)) {            // the attribute, once a device
    static int smem_set[MAX_DEVICES] = {};   // per instantiation
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= MAX_DEVICES || smem_set[dev] < smem) {
      e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return e;
      if (dev < MAX_DEVICES) smem_set[dev] = smem;
    }
  }
  kern<<<B * a.H * (HD / CW), NT, smem, st>>>(a);
  return cudaGetLastError();
}

template <int HD, int CW, int CV>
cudaError_t by_type(const Args& a, int B, int bf, int smem, cudaStream_t st) {
  return bf ? launch<HD, CW, CV, true>(a, B, smem, st)
            : launch<HD, CW, CV, false>(a, B, smem, st);
}

// (cols, cv): (16, 1), or (hd, 4) for hd 32 and 64
template <int HD>
cudaError_t by_cols(const Args& a, int B, int cw, int cv, int bf, int smem,
                    cudaStream_t st) {
  if (cv == 1 && cw == 16) return by_type<HD, 16, 1>(a, B, bf, smem, st);
  if constexpr (HD >= 32) {
    if (cv == 4 && cw == HD) return by_type<HD, HD, 4>(a, B, bf, smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// r, k, v: bf16 (rkv_bf16 = 1) or f32; w, u, state, y: f32; active:
// int32; s_in and active may be null.  hd is 16, 32 or 64; cols, cv
// ((16, 1) or (hd, 4)) and tile come from kernels/wkv6.py::wkv6_plan.
// Returns the launch's cudaGetLastError(), or cudaErrorInvalidValue for
// an hd, cols, cv or tile it does not take.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s_in,
                           void* s_out, void* y, const void* active, int B,
                           int H, int S, int hd, int u_per_b, int rkv_bf16,
                           int cols, int cv, int tile, void* stream) {
  if (tile < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const int smem =
      smem_need(hd, cols, rkv_bf16 ? 2 : 4, tile, S > tile ? 2 : 1);
  const Args a{r, k, v, static_cast<const float*>(w),
               static_cast<const float*>(u), static_cast<const float*>(s_in),
               static_cast<float*>(s_out), static_cast<float*>(y),
               static_cast<const int*>(active), H, S, tile, u_per_b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)by_cols<16>(a, B, cols, cv, rkv_bf16, smem, st);
    case 32: return (int)by_cols<32>(a, B, cols, cv, rkv_bf16, smem, st);
    case 64: return (int)by_cols<64>(a, B, cols, cv, rkv_bf16, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
