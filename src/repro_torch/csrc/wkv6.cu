// wkv6: the RWKV6 (Finch) recurrence over S tokens for every (batch, head):
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t
//
// with a per-(b, h) hd x hd f32 state S, per-token decay w_t in (0, 1)
// and the first-token bonus u.
//
// Replaces the TPU kernel repro/kernels/wkv6.py::wkv6 (pl.pallas_call at
// wkv6.py:98, body _wkv6_kernel).  The TPU kernel turns the recurrence
// into three MXU matmuls per 64-token chunk (the chunked linear-attention
// identity, decay ratios in log space clamped at +-80) and carries the
// state across a sequential grid axis, starting from zeros.  Serving
// needs what it lacks: a carried initial state (every PREFILL chunk and
// every DECODE step continues a request's state), S = 1 (a decode step)
// and S not divisible by 64 (a prompt's tail chunk).
//
// What bounds it on the H100: per token and head it does ~4 hd^2 flops
// on ~5 hd floats of input, and it must read and write the hd^2 state
// once per call.  A DECODE step (S = 1, B*H = 1024 heads) is bound by
// the state's bytes (2 x 16 KB per head); a PREFILL chunk (S = 32, one
// request, B*H = 32) is bound by the token-serial dependence, not by
// bytes or flops.  The design therefore walks the tokens in order inside
// one block per (b, h) — Hopper has no sequential grid axis, and at
// these chunk lengths the chunked identity's three products would not
// pay for their setup — with the state in REGISTERS for the whole call:
// 256 threads, thread (g, c) owning column c of rows g*RPG .. g*RPG+RPG-1
// (RPG = hd^2 / 256), so the state is read once and written once, with
// coalesced rows.  Per token the block stages r, k, v, w in shared
// memory (the next token's values are fetched into registers while this
// token computes), each thread updates its RPG state entries and its
// partial of y's column, and a fixed-order sum over the hd / RPG groups
// gives y.  The order of every sum is independent of S, so a chunk of
// S tokens and S single-token calls give the same bits.
//
// Layout: r, k, v, w, y are (B, S, H, hd) f32 (the model's layout; the
// TPU kernel's (BH, S, hd) fold is H = 1), u is (H, hd) shared over b,
// or (B, H, hd) per b (u_per_b); the state is (B, H, hd, hd) f32.
// s_in == nullptr starts from zeros; s_out may equal s_in (in place);
// active (B,) int32, when given, skips the state write of rows b with
// active[b] == 0 (their y is still computed).
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

template <int HD>
__global__ void __launch_bounds__(NT)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s_in, float* s_out,
            float* __restrict__ y, const int* __restrict__ active, int H,
            int S, int u_per_b) {
  constexpr int NG = NT / HD;          // row groups
  constexpr int RPG = HD / NG;         // state rows per thread
  static_assert(NG * RPG == HD, "hd must divide 256 / hd groups evenly");
  __shared__ float in_s[4][HD];        // r, k, v, w of the current token
  __shared__ float u_s[HD];
  __shared__ float part[NG][HD];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, c = tid % HD, g = tid / HD;
  // thread tid < 4 HD stages element j of input `which` of every token
  const int which = tid / HD, j = tid % HD;
  const bool stager = tid < 4 * HD;
  const float* src = which == 0 ? r : which == 1 ? k : which == 2 ? v : w;
  auto tok = [&](int t) { return ((size_t)(b * S + t) * H + h) * HD + j; };

  if (tid < HD) u_s[tid] = u[((size_t)(u_per_b ? b : 0) * H + h) * HD + tid];
  float st[RPG];
  const size_t s_off = (size_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < RPG; ++i)
    st[i] = s_in ? s_in[s_off + (size_t)(g * RPG + i) * HD + c] : 0.f;
  float nxt = (stager && S > 0) ? src[tok(0)] : 0.f;

  for (int t = 0; t < S; ++t) {
    if (stager) in_s[which][j] = nxt;
    __syncthreads();
    if (stager && t + 1 < S) nxt = src[tok(t + 1)];
    const float vc = in_s[2][c];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      const int row = g * RPG + i;
      const float kv = in_s[1][row] * vc;
      acc = fmaf(in_s[0][row], fmaf(u_s[row], kv, st[i]), acc);
      st[i] = fmaf(in_s[3][row], st[i], kv);
    }
    part[g][c] = acc;
    __syncthreads();
    if (tid < HD) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NG; ++q) s += part[q][tid];
      y[((size_t)(b * S + t) * H + h) * HD + tid] = s;
    }
  }
  if (active && !active[b]) return;
#pragma unroll
  for (int i = 0; i < RPG; ++i)
    s_out[s_off + (size_t)(g * RPG + i) * HD + c] = st[i];
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s_in,
                   float* s_out, float* y, const int* active, int B, int H,
                   int S, int u_per_b, cudaStream_t st) {
  wkv6_kernel<HD><<<B * H, NT, 0, st>>>(r, k, v, w, u, s_in, s_out, y,
                                        active, H, S, u_per_b);
  return cudaGetLastError();
}

}  // namespace

// All pointers are device pointers to contiguous f32 (active: int32);
// s_in and active may be null.  hd is 16, 32 or 64.  Returns the
// launch's cudaGetLastError() (cudaErrorInvalidValue for another hd).
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s_in,
                        void* s_out, void* y, const void* active, int B,
                        int H, int S, int hd, int u_per_b, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int* act = static_cast<const int*>(active);
  float* so = static_cast<float*>(s_out);
  float* yo = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)launch<16>(f(r), f(k), f(v), f(w), f(u), f(s_in), so,
                                    yo, act, B, H, S, u_per_b, st);
    case 32: return (int)launch<32>(f(r), f(k), f(v), f(w), f(u), f(s_in), so,
                                    yo, act, B, H, S, u_per_b, st);
    case 64: return (int)launch<64>(f(r), f(k), f(v), f(w), f(u), f(s_in), so,
                                    yo, act, B, H, S, u_per_b, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
