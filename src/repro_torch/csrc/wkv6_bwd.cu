// wkv6_bwd: the gradient of the RWKV6 (Finch) recurrence of wkv6.cu,
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t,      S_0 = 0,
//
// given dy = dL/dy, for every (batch, head).  With G_t = dL/dS_t (G_S = 0;
// training reads no final state), running t from S down to 1:
//
//   G_{t-1} = diag(w_t) G_t + r_t (x) dy_t
//   dr_t[i] = sum_j (S_{t-1}[i][j] + u_i k_t[i] v_t[j]) dy_t[j]
//   dk_t[i] = sum_j (G_t[i][j] + u_i r_t[i] dy_t[j]) v_t[j]
//   dv_t[j] = sum_i (G_t[i][j] + u_i r_t[i] dy_t[j]) k_t[i]
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]   = sum_t r_t[i] k_t[i] sum_j v_t[j] dy_t[j]   (per b here)
//
// Replaces no TPU kernel: the TPU kernel repro/kernels/wkv6.py::wkv6 has
// no backward, and the reference trains by letting XLA differentiate the
// lax.scan of repro/models/ssm.py::wkv6_scan (re-materialised every 64
// tokens).  In the port, autograd through the plain recurrence would be
// ~10 torch ops a token in each direction, for each layer, and would keep
// a (B, H, hd, hd) state a token; this kernel is one launch a layer.
//
// What bounds it on the H100: the gradient needs 14 hd^2 f32 operations a
// token and head (one forward recompute of the state, 3; the G update, 3;
// the dr, dk, dv and dw sums, 2 each; the u terms are rank-1, O(hd)) on
// ~6 hd values in and 4 hd out, so by operations (training shape B=4,
// S=256, H=32, hd=64: 1.88 GFLOP, 0.028 ms at 67 TFLOP/s f32; ~63 MB,
// 0.019 ms at 3.35 TB/s).  This design does more than that: a second
// forward pass (pass A, then each tile's recompute) and the u terms
// folded into the hd^2 loop.  Its serial chain is two passes over S
// tokens on one block a head.
//
// Design (simple and deterministic first):
//
// 1. One block a (b, h) owns the whole hd x hd state and its gradient in
//    registers: thread (g, q) holds rows 4g .. 4g + 3 and columns
//    4q .. 4q + 3 (16 values of each), hd^2 / 16 threads (256 at hd 64).
//    No sum crosses a block, so there are no atomics: two calls give
//    the same bits.  At B*H = 128 the grid is one wave of 132 SMs.
// 2. Pass A runs the recurrence forward and writes the state at the start
//    of every tile of T = 8 tokens after the first to global scratch
//    ((ceil(S/T) - 1) x 16 KB a head at hd 64).
// 3. Pass B walks the tiles in reverse.  For a tile it stages r, k, v, w
//    and dy (converted to f32) in shared memory, reloads the tile's
//    starting state, recomputes the tile's T states S_{t-1} into shared
//    memory (T x hd^2 f32: 128 KB at hd 64; each thread reads back only
//    what it wrote), then runs the reverse recurrence token by token.
// 4. Sums over value columns (dr, dk, dw, du) reduce over the hd / 4
//    threads of a row group with a butterfly of warp shuffles; dv's sum
//    over key rows reduces over the row groups of a warp by shuffles,
//    then over the warps in shared memory in warp order after the tile.
//    Every order is fixed by hd alone.  Outputs are written coalesced
//    once a tile.
//
// Layout: r, k, v, w, dy, dr, dk, dv, dw are (B, S, H, hd); r, k, v bf16
// (rkv_bf16 = 1) or f32, the rest f32; u is (H, hd); du (B, H, hd) per-b
// partials; bounds (B * H, max(ceil(S / T) - 1, 1), hd * hd) scratch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RPG = 4;            // state rows a thread
constexpr int CPG = 4;            // state columns a thread
constexpr int T = 8;              // tokens a tile (kernels/wkv6.py BWD_TILE)
constexpr int NIN = 5;            // staged inputs: r, k, v, w, dy
constexpr int MAX_DEVICES = 16;

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* dy;
  float* dr;
  float* dk;
  float* dv;
  float* dw;
  float* du;
  float* bounds;
  int H, S;
};

template <bool BF>
__device__ __forceinline__ float load_rkv(const void* p, size_t i) {
  if constexpr (BF) {
    return __uint_as_float(
        uint32_t(static_cast<const uint16_t*>(p)[i]) << 16);
  } else {
    return static_cast<const float*>(p)[i];
  }
}

__host__ __device__ constexpr int n_threads(int hd) {
  return (hd / RPG) * (hd / CPG);
}

__host__ __device__ constexpr int n_warps(int hd) {
  return n_threads(hd) >= 32 ? n_threads(hd) / 32 : 1;
}

// Shared memory (floats): the staged inputs, the tile's states, the row
// sums (dr, dk, dw) and dv's per-warp partials.
__host__ __device__ constexpr int smem_floats(int hd) {
  return NIN * T * hd + T * hd * hd + 3 * T * hd + T * n_warps(hd) * hd;
}

// The butterfly over `width` lanes (a power of two): every lane ends with
// the same sum, in an order fixed by width.
template <int WIDTH>
__device__ __forceinline__ float lane_sum(float x, unsigned mask) {
#pragma unroll
  for (int off = WIDTH / 2; off >= 1; off /= 2)
    x += __shfl_xor_sync(mask, x, off);
  return x;
}

template <int HD, bool BF>
__global__ void __launch_bounds__(n_threads(HD), 1) wkv6_bwd_kernel(Args a) {
  constexpr int NQ = HD / CPG;          // column groups (lanes of a row group)
  constexpr int NT = n_threads(HD);
  constexpr int NW = n_warps(HD);
  constexpr int WL = NT < 32 ? NT : 32;  // lanes of a warp in use
  constexpr unsigned MASK = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
  constexpr int HH = HD * HD;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                      // [NIN][T][HD]
  float* stash = xs + NIN * T * HD;      // [T][16][NT]
  float* rows = stash + T * HH;          // [3][T][HD]: dr, dk, dw
  float* dvp = rows + 3 * T * HD;        // [T][NW][HD]
  float* rs = xs;
  float* ks = xs + T * HD;
  float* vs = xs + 2 * T * HD;
  float* ws = xs + 3 * T * HD;
  float* dys = xs + 4 * T * HD;

  const int H = a.H, S = a.S;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, q = tid % NQ, g = tid / NQ;
  const int lane = tid % 32, warp = tid / 32;
  const int i0 = RPG * g, j0 = CPG * q;
  const int ntiles = (S + T - 1) / T;
  const size_t tok = (size_t)H * HD;                  // elements a token
  const size_t base = ((size_t)b * S * H + h) * HD;   // token 0 of (b, h)
  float* bnd = a.bounds + (size_t)bh * (ntiles > 1 ? ntiles - 1 : 1) * HH;

  // n tokens of k, v, w (and with `all`, r and dy) from token t0 into
  // shared memory as f32
  auto stage = [&](int t0, int n, bool all) {
    for (int o = tid; o < n * HD; o += NT) {
      const int t = o / HD, c = o - t * HD;
      const size_t idx = base + (size_t)(t0 + t) * tok + c;
      ks[t * HD + c] = load_rkv<BF>(a.k, idx);
      vs[t * HD + c] = load_rkv<BF>(a.v, idx);
      ws[t * HD + c] = a.w[idx];
      if (all) {
        rs[t * HD + c] = load_rkv<BF>(a.r, idx);
        dys[t * HD + c] = a.dy[idx];
      }
    }
  };
  // one token of the forward recurrence on this thread's 16 values
  auto advance = [&](float (&st)[RPG][CPG], int t) {
    float kk[RPG], ww[RPG], vv[CPG];
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      kk[i] = ks[t * HD + i0 + i];
      ww[i] = ws[t * HD + i0 + i];
    }
#pragma unroll
    for (int j = 0; j < CPG; ++j) vv[j] = vs[t * HD + j0 + j];
#pragma unroll
    for (int i = 0; i < RPG; ++i)
#pragma unroll
      for (int j = 0; j < CPG; ++j)
        st[i][j] = fmaf(ww[i], st[i][j], kk[i] * vv[j]);
  };

  // Pass A: the state at the start of tiles 1 .. ntiles - 1
  float st[RPG][CPG];
#pragma unroll
  for (int i = 0; i < RPG; ++i)
#pragma unroll
    for (int j = 0; j < CPG; ++j) st[i][j] = 0.f;
  for (int it = 0; it + 1 < ntiles; ++it) {
    __syncthreads();
    stage(it * T, T, false);
    __syncthreads();
    for (int t = 0; t < T; ++t) advance(st, t);
    float* dst = bnd + (size_t)it * HH;
#pragma unroll
    for (int i = 0; i < RPG; ++i)
#pragma unroll
      for (int j = 0; j < CPG; ++j) dst[(i * CPG + j) * NT + tid] = st[i][j];
  }

  // Pass B: the tiles in reverse
  float uu[RPG];
#pragma unroll
  for (int i = 0; i < RPG; ++i) uu[i] = a.u[(size_t)h * HD + i0 + i];
  float gr[RPG][CPG], du_acc[RPG];
#pragma unroll
  for (int i = 0; i < RPG; ++i) {
    du_acc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPG; ++j) gr[i][j] = 0.f;
  }
  for (int it = ntiles - 1; it >= 0; --it) {
    const int t0 = it * T, n = min(T, S - t0);
    __syncthreads();                     // the last tile's reads are done
    stage(t0, n, true);
    // the tile's starting state (pass A wrote it with these threads)
#pragma unroll
    for (int i = 0; i < RPG; ++i)
#pragma unroll
      for (int j = 0; j < CPG; ++j)
        st[i][j] = it == 0 ? 0.f
                           : bnd[(size_t)(it - 1) * HH + (i * CPG + j) * NT +
                                 tid];
    __syncthreads();
    for (int t = 0; t < n; ++t) {
#pragma unroll
      for (int i = 0; i < RPG; ++i)
#pragma unroll
        for (int j = 0; j < CPG; ++j)
          stash[(t * 16 + i * CPG + j) * NT + tid] = st[i][j];
      advance(st, t);
    }
    for (int t = n - 1; t >= 0; --t) {
      float rr[RPG], kk[RPG], ww[RPG], vv[CPG], dd[CPG];
#pragma unroll
      for (int i = 0; i < RPG; ++i) {
        rr[i] = rs[t * HD + i0 + i];
        kk[i] = ks[t * HD + i0 + i];
        ww[i] = ws[t * HD + i0 + i];
      }
#pragma unroll
      for (int j = 0; j < CPG; ++j) {
        vv[j] = vs[t * HD + j0 + j];
        dd[j] = dys[t * HD + j0 + j];
      }
      float vdy = 0.f;
#pragma unroll
      for (int j = 0; j < CPG; ++j) vdy = fmaf(vv[j], dd[j], vdy);
      float drp[RPG], dkp[RPG], dwp[RPG], dvq[CPG];
#pragma unroll
      for (int j = 0; j < CPG; ++j) dvq[j] = 0.f;
#pragma unroll
      for (int i = 0; i < RPG; ++i) {
        const float uk = uu[i] * kk[i], ur = uu[i] * rr[i];
        drp[i] = dkp[i] = dwp[i] = 0.f;
#pragma unroll
        for (int j = 0; j < CPG; ++j) {
          const float sp = stash[(t * 16 + i * CPG + j) * NT + tid];
          drp[i] = fmaf(fmaf(uk, vv[j], sp), dd[j], drp[i]);
          const float ag = fmaf(ur, dd[j], gr[i][j]);
          dkp[i] = fmaf(ag, vv[j], dkp[i]);
          dvq[j] = fmaf(ag, kk[i], dvq[j]);
          dwp[i] = fmaf(gr[i][j], sp, dwp[i]);
          gr[i][j] = fmaf(ww[i], gr[i][j], rr[i] * dd[j]);
        }
        du_acc[i] = fmaf(rr[i] * kk[i], vdy, du_acc[i]);
      }
      // row sums over the NQ lanes of the row group
      float rsum[3 * RPG];
#pragma unroll
      for (int i = 0; i < RPG; ++i) {
        rsum[i] = lane_sum<NQ>(drp[i], MASK);
        rsum[RPG + i] = lane_sum<NQ>(dkp[i], MASK);
        rsum[2 * RPG + i] = lane_sum<NQ>(dwp[i], MASK);
      }
#pragma unroll
      for (int x = 0; x < 3 * RPG; ++x)
        if (x % NQ == q)
          rows[((x / RPG) * T + t) * HD + i0 + x % RPG] = rsum[x];
      // column sums over the row groups of the warp, then per warp
#pragma unroll
      for (int j = 0; j < CPG; ++j) {
#pragma unroll
        for (int off = NQ; off < WL; off *= 2)
          dvq[j] += __shfl_xor_sync(MASK, dvq[j], off);
      }
      if (lane < NQ) {
#pragma unroll
        for (int j = 0; j < CPG; ++j)
          dvp[(t * NW + warp) * HD + j0 + j] = dvq[j];
      }
    }
    __syncthreads();
    for (int o = tid; o < n * HD; o += NT) {
      const int t = o / HD, c = o - t * HD;
      const size_t idx = base + (size_t)(t0 + t) * tok + c;
      a.dr[idx] = rows[(0 * T + t) * HD + c];
      a.dk[idx] = rows[(1 * T + t) * HD + c];
      a.dw[idx] = rows[(2 * T + t) * HD + c];
      float s = 0.f;
#pragma unroll
      for (int wp = 0; wp < NW; ++wp) s += dvp[(t * NW + wp) * HD + c];
      a.dv[idx] = s;
    }
  }
  float dus[RPG];
#pragma unroll
  for (int i = 0; i < RPG; ++i) dus[i] = lane_sum<NQ>(du_acc[i], MASK);
  if (q == 0) {
#pragma unroll
    for (int i = 0; i < RPG; ++i) a.du[(size_t)bh * HD + i0 + i] = dus[i];
  }
}

template <int HD, bool BF>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  auto kern = wkv6_bwd_kernel<HD, BF>;
  const int smem = smem_floats(HD) * 4;
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
  kern<<<B * a.H, n_threads(HD), smem, st>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t by_type(const Args& a, int B, int bf, cudaStream_t st) {
  return bf ? launch<HD, true>(a, B, st) : launch<HD, false>(a, B, st);
}

}  // namespace

// Pointers as in the layout above, every tensor contiguous.  hd is 16, 32
// or 64.  Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for an hd or S it does not take.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* dy,
                               void* dr, void* dk, void* dv, void* dw,
                               void* du, void* bounds, int B, int H, int S,
                               int hd, int rkv_bf16, void* stream) {
  if (S < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Args a{r,
               k,
               v,
               static_cast<const float*>(w),
               static_cast<const float*>(u),
               static_cast<const float*>(dy),
               static_cast<float*>(dr),
               static_cast<float*>(dk),
               static_cast<float*>(dv),
               static_cast<float*>(dw),
               static_cast<float*>(du),
               static_cast<float*>(bounds),
               H,
               S};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)by_type<16>(a, B, rkv_bf16, st);
    case 32: return (int)by_type<32>(a, B, rkv_bf16, st);
    case 64: return (int)by_type<64>(a, B, rkv_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
