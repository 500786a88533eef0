// wkv6_bwd: the gradient of the RWKV6 (Finch) recurrence of wkv6.cu,
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t,      S_0 = 0,
//
// given dy = dL/dy, for every (batch, head).  With G_t = dL/dS_t (G_S = 0;
// training reads no final state), running t from S down to 1:
//
//   G_{t-1} = diag(w_t) G_t + r_t (x) dy_t
//   dr_t[i] = sum_j S_{t-1}[i][j] dy_t[j] + u_i k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j]      + u_i r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_t[i][j] k_t[i]      + (sum_i u_i r_t[i] k_t[i]) dy_t[j]
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]   = sum_t r_t[i] k_t[i] (v_t . dy_t)             (per b here)
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
// 0.019 ms at 3.35 TB/s).  A head is a serial chain of S tokens, so one
// SM works on one head (B*H = 128 heads on 132 SMs).  No tensor cores:
// the gate holds every output within 1e-4 of its largest value, which
// TF32 or bf16 products do not keep.  The work stays in f32 FMAs.
//
// What bounds this design: the SM's shared-memory pipe, which delivers
// 128 bytes a cycle to the lanes of loads and shuffles alike (a warp's
// 16-byte load is 512 bytes to its lanes, however few addresses they
// share).  With 4 state values a thread, every thread needs its row's
// r, k, w and its 4 columns' v, dy each token, and sends 3 row sums and
// 4 column sums out: a warp's reverse step loads for 9 cycles, shuffles
// 6 times and stores 1.5 times (its sums reduce with the next token's),
// and 1.25 forward steps load for 4 cycles each, ~22 cycles a
// warp-token, ~700 a token for the 32 warps of a head: ~0.09 ms at the
// training shape for pass B's walk, against the 14 hd^2 bound's 0.028.
// Latency is hidden by 32 warps.  (A chunked form with explicit decay products
// within a chunk, which needs no ratios of w, moves ~20% fewer bytes in
// its walk, but its chunk sums and output assembly cost as much again at
// this thread count.)
//
// Design:
//
// 1. Many threads on a head.  One block a (b, h) of hd^2 / 4 threads
//    (1024 at hd 64: 32 warps on the SM, 8 a scheduler, where the
//    previous design had 256 threads holding 16 values each): thread
//    (i, q) holds state row i, columns 4q .. 4q + 3, of S and of G in
//    registers.  A warp covers 8 rows x 16 columns, so its v and dy are
//    64 bytes a token, and what leaves it a token is 3 x 8 row sums and
//    16 column sums.  At 1024 threads a thread has 64 registers, so a
//    tile's states are recomputed 4 tokens at a time (SUB).
// 2. The sums of two tokens reduce together, transposed: the row sums
//    (dr, dk, dw over j) of the pair over the 4 lanes of a row in 5
//    shuffles (6 one token at a time), then over the hd / 16 column
//    blocks in shared memory; dv's column sums of the pair over the
//    warp's 8 rows in 7 shuffles (8), then over the hd / 8 row blocks.
//    Every lane stores a pair's sums in 3 stores (4); a token's partials
//    lie 16 banks off the next's, so the pair's stores do not conflict.
//    Every order is fixed by hd: no atomics, two calls give the same
//    bits.
// 3. The u terms are rank-1 and stay out of the hd^2 loop: a warp a
//    token sums v.dy and sum_i u_i r_i k_i, and the threads that write a
//    tile's outputs add u_i k_i (v.dy), u_i r_i (v.dy) and (sum u r k)
//    dy_j, and sum du, once an output.
// 4. Staging by cp.async (16 bytes a copy; tokens past S zero-filled,
//    which leaves G = 0 through them), waited on a phase after it was
//    issued.  Pass A keeps two tiles of TA = 4 T tokens in flight in a
//    ring of three, one block barrier a TA tokens.  In pass B the staged
//    tiles (r, k, v, w, dy as they come, three) and starting states
//    (three) rotate with the token sums and output partials (two each),
//    so a tile costs one block barrier: tile it walks back while tile
//    it - 1 is copied in and tile it + 1's outputs are summed and
//    written, on threads spread over the warps.
// 5. Pass A runs the recurrence forward from the staged k, v, w read in
//    place (bf16 converted on load) and writes the state at the start of
//    every tile after the first to global scratch (thread-major float4s,
//    (ceil(S/T) - 1) x hd^2 floats a head).  Pass B walks a tile back in
//    two halves from its starting state: 4 tokens forward, then the next
//    4 states into registers and 4 tokens back; then the first half the
//    same way.  The walk is unrolled over the tile, so its shared memory
//    offsets are constants; the states never go through shared memory.
//
// Layout: r, k, v, w, dy, dr, dk, dv, dw are (B, S, H, hd); r, k, v bf16
// (rkv_bf16 = 1) or f32, the rest f32; u is (H, hd); du (B, H, hd) per-b
// partials; bounds (B * H, max(ceil(S / T) - 1, 1), hd * hd) scratch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CPT = 4;            // state columns a thread (of one row)
constexpr int WR = 8;             // state rows a warp
constexpr int WC = 16;            // state columns a warp (4 lanes a row)
constexpr int T = 8;              // tokens a tile (kernels/wkv6.py BWD_TILE)
constexpr int SUB = 4;            // tokens of states a thread keeps
constexpr int TA = 4 * T;         // tokens a pass-A tile
static_assert(SUB % 2 == 0 && T % SUB == 0, "the walk goes in token pairs");
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

__host__ __device__ constexpr int n_threads(int hd) { return hd * hd / CPT; }

// Shared memory, bytes (kernels/wkv6.py::wkv6_bwd_plan sizes it alike),
// the larger of the two passes'.  Pass B: three staged tiles of r, k, v,
// w, dy at 4 bytes a value whatever r, k, v's type; three tiles' starting
// states; two tiles' token sums {v.dy, sum u r k}; two tiles of output
// partials.  Pass A, in the same memory before it: a ring of three
// TA-token tiles of k, v, w (sized at 4 bytes a value).
__host__ __device__ constexpr int raw_bytes(int hd) { return 5 * T * hd * 4; }
// a tile's partials: [T][RSTR] row sums {dr, dk, dw} a column block of 16,
// then [T][CSTR] dv a row block of 8; a token's stride is 16 banks off a
// multiple of 32, so a token pair's stores do not conflict
__host__ __device__ constexpr int pad16(int n) {
  return n + (48 - n % 32) % 32;
}
__host__ __device__ constexpr int rstride(int hd) {
  return pad16(3 * (hd / WC) * hd);
}
__host__ __device__ constexpr int cstride(int hd) {
  return pad16((hd / WR) * hd);
}
__host__ __device__ constexpr int part_floats(int hd) {
  return T * (rstride(hd) + cstride(hd));
}
__host__ __device__ constexpr int pass_a_bytes(int hd) {
  return 3 * 3 * TA * hd * 4;
}
__host__ __device__ constexpr int pass_b_bytes(int hd) {
  return 3 * raw_bytes(hd) + 3 * hd * hd * 4 + 2 * T * 8 +
         2 * part_floats(hd) * 4;
}
__host__ __device__ constexpr int smem_bytes(int hd) {
  return pass_a_bytes(hd) > pass_b_bytes(hd) ? pass_a_bytes(hd)
                                             : pass_b_bytes(hd);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with src_bytes 0 the 16 bytes read as zero.
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// element o of a staged r, k or v array as f32
template <bool BF>
__device__ __forceinline__ float rkv_at(const unsigned char* p, int o) {
  if constexpr (BF) {
    return __uint_as_float(
        uint32_t(reinterpret_cast<const uint16_t*>(p)[o]) << 16);
  } else {
    return reinterpret_cast<const float*>(p)[o];
  }
}

// elements o .. o + 3 (o % 4 == 0) of a staged r, k or v array as f32
template <bool BF>
__device__ __forceinline__ float4 rkv4_at(const unsigned char* p, int o) {
  if constexpr (BF) {
    const uint2 x = *reinterpret_cast<const uint2*>(p + 2 * o);
    return make_float4(__uint_as_float(x.x << 16),
                       __uint_as_float(x.x & 0xffff0000u),
                       __uint_as_float(x.y << 16),
                       __uint_as_float(x.y & 0xffff0000u));
  } else {
    return *reinterpret_cast<const float4*>(p + 4 * o);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// one token of the forward recurrence on 4 values of a row: s = w s + k v
__device__ __forceinline__ void advance(float (&s)[CPT], float k, float w,
                                        float4 v) {
  s[0] = fmaf(w, s[0], k * v.x);
  s[1] = fmaf(w, s[1], k * v.y);
  s[2] = fmaf(w, s[2], k * v.z);
  s[3] = fmaf(w, s[3], k * v.w);
}

template <int HD, bool BF>
__global__ void __launch_bounds__(n_threads(HD), 1) wkv6_bwd_kernel(Args a) {
  constexpr int NT = n_threads(HD);
  constexpr int NCB = HD / WC, NRB = HD / WR;   // column, row blocks
  constexpr int ESZ = BF ? 2 : 4;               // bytes of r, k, v
  constexpr int TH = T * HD;                    // values of a tile's array
  constexpr int RAW = raw_bytes(HD), PART = part_floats(HD);
  constexpr int RSTR = rstride(HD), CSTR = cstride(HD);
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* raw = smem;                           // [3][RAW]
  float4* sbnd = reinterpret_cast<float4*>(raw + 3 * RAW);      // [3][NT]
  float2* scal = reinterpret_cast<float2*>(sbnd + 3 * NT);      // [2][T]
  float* part = reinterpret_cast<float*>(scal + 2 * T);         // [2][PART]

  const int H = a.H, S = a.S;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rb = warp / NCB, cb = warp % NCB;
  const int ql = lane % (WC / CPT);               // the lane's place in a row
  const int i = rb * WR + lane / (WC / CPT);      // the thread's state row
  const int j0 = cb * WC + ql * CPT;              // its first column
  const int ntiles = (S + T - 1) / T;
  const size_t tok = (size_t)H * HD;                  // elements a token
  const size_t base = ((size_t)b * S * H + h) * HD;   // token 0 of (b, h)
  float4* bnd = reinterpret_cast<float4*>(a.bounds) +
                (size_t)bh * (ntiles > 1 ? ntiles - 1 : 1) * NT;

  // Staging: tt tokens of the arrays `arrs` (ESZ bytes a value for r,
  // k, v, 4 for w, dy) are copies of 16 bytes, array after array, copy c
  // on thread c % NT, into [array][tt][HD x 4 B].  A thread's copies are
  // fixed by tid, so their offsets are worked out once and a tile adds
  // its first token; tokens past S read as zero.
  constexpr int CR = HD * ESZ / 16, CF = HD / 4;   // copies a token
  struct Copy {
    const char* src;   // the copy's source at token 0 (null: none)
    int dst, t;        // its byte offset in a buffer; its token
  };
  // copy m of this thread among a tile of tt tokens of the arrays
  // arrs[x] (n[x] copies, esz[x] bytes a value; n[x] = 0: not staged)
  auto copy_of = [&](int m, const void* const (&arrs)[5], const int (&n)[5],
                     const int (&esz)[5], int tt) {
    Copy cp{nullptr, 0, 0};
    int c = tid + m * NT;
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      if (cp.src == nullptr && c >= 0 && c < n[x]) {
        const int per = HD * esz[x] / 16;
        const int t = c / per, o = (c % per) * 16;
        cp.src = static_cast<const char*>(arrs[x]) +
                 (base + (size_t)t * tok) * esz[x] + o;
        cp.dst = x * tt * HD * 4 + t * HD * esz[x] + o;
        cp.t = t;
      }
      c -= n[x];
    }
    return cp;
  };
  // (destinations below rkv_end hold r, k or v)
  auto stage = [&](const Copy& cp, int t0, unsigned char* buf, int rkv_end) {
    if (cp.src == nullptr) return;
    const bool in = t0 + cp.t < S;
    const int esz = cp.dst < rkv_end ? ESZ : 4;
    cp_async16(buf + cp.dst, in ? cp.src + (size_t)t0 * tok * esz : cp.src,
               in ? 16 : 0);
  };

  // Pass A: the state at the start of tiles 1 .. ntiles - 1, token by
  // token from the staged k, v, w read in place, in tiles of TA tokens
  // (a ring of three, two in flight: one barrier a TA tokens)
  {
    constexpr int NCA = (2 * TA * CR + TA * CF + NT - 1) / NT;
    constexpr int ABUF = 3 * TA * HD * 4;
    const void* arrs[5] = {a.k, a.v, a.w, nullptr, nullptr};
    const int n[5] = {TA * CR, TA * CR, TA * CF, 0, 0};
    const int esz[5] = {ESZ, ESZ, 4, 4, 4};
    Copy cpa[NCA];
#pragma unroll
    for (int m = 0; m < NCA; ++m) cpa[m] = copy_of(m, arrs, n, esz, TA);
    const int na = ntiles - 1;                     // states to write
    const int nta = (na * T + TA - 1) / TA;        // pass-A tiles
    float s[CPT] = {0.f, 0.f, 0.f, 0.f};
    auto stage_a = [&](int ia) {
#pragma unroll
      for (int m = 0; m < NCA; ++m)
        stage(cpa[m], ia * TA, smem + (ia % 3) * ABUF, 2 * TA * HD * 4);
    };
    if (nta > 0) stage_a(0);
    cp_async_commit();
    if (nta > 1) stage_a(1);
    cp_async_commit();
    for (int ia = 0; ia < nta; ++ia) {
      cp_async_wait<1>();
      __syncthreads();                 // tile ia landed; tile ia - 1 read
      if (ia + 2 < nta) stage_a(ia + 2);
      cp_async_commit();
      const unsigned char* kk = smem + (ia % 3) * ABUF;
      const unsigned char* vv = kk + TA * HD * 4;
      const float* ws = reinterpret_cast<const float*>(vv + TA * HD * 4);
#pragma unroll
      for (int g = 0; g < TA / T; ++g) {
        const int it = ia * (TA / T) + g;
        if (it < na) {
#pragma unroll
          for (int t = 0; t < T; ++t) {
            const int o = (g * T + t) * HD;
            advance(s, rkv_at<BF>(kk, o + i), ws[o + i],
                    rkv4_at<BF>(vv, o + j0));
          }
          bnd[(size_t)it * NT + tid] = make_float4(s[0], s[1], s[2], s[3]);
        }
      }
    }
    cp_async_wait<0>();
  }

  // Pass B: the tiles in reverse.  Tile it's r, k, v, w, dy are in
  // raw[it % 3] (each [T][HD]), its starting state in sbnd[it % 3], its
  // token sums in scal[it % 2], its output partials in part[it % 2].
  constexpr int NCP = (3 * T * CR + 2 * T * CF + NT - 1) / NT;
  Copy cpb[NCP];
  {
    const void* arrs[5] = {a.r, a.k, a.v, a.w, a.dy};
    const int n[5] = {T * CR, T * CR, T * CR, T * CF, T * CF};
    const int esz[5] = {ESZ, ESZ, ESZ, 4, 4};
#pragma unroll
    for (int m = 0; m < NCP; ++m) cpb[m] = copy_of(m, arrs, n, esz, T);
  }
  auto stage_b = [&](int it) {
#pragma unroll
    for (int m = 0; m < NCP; ++m)
      stage(cpb[m], it * T, raw + (it % 3) * RAW, 3 * TH * 4);
    if (it > 0)
      cp_async16(sbnd + (it % 3) * NT + tid, bnd + (size_t)(it - 1) * NT + tid,
                 16);
  };
  // the token sums v.dy and sum_i u_i r_i k_i, a warp a token
  const float u_lo = lane < HD ? a.u[(size_t)h * HD + lane] : 0.f;
  const float u_hi = lane + 32 < HD ? a.u[(size_t)h * HD + lane + 32] : 0.f;
  auto sums = [&](int it) {
    const unsigned char* buf = raw + (it % 3) * RAW;
    const float* dd = reinterpret_cast<const float*>(buf + 4 * TH * 4);
    for (int t = (warp + NT / 32 - NT / 128) % (NT / 32); t < T; t += NT / 32) {
      float vdy = 0.f, urk = 0.f;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int e = lane + 32 * x, o = t * HD + e;
        if (e < HD) {
          vdy = fmaf(rkv_at<BF>(buf + 2 * TH * 4, o), dd[o], vdy);
          urk = fmaf((x ? u_hi : u_lo) * rkv_at<BF>(buf, o),
                     rkv_at<BF>(buf + TH * 4, o), urk);
        }
      }
      vdy = warp_sum(vdy);
      urk = warp_sum(urk);
      if (lane == 0) scal[(it & 1) * T + t] = make_float2(vdy, urk);
    }
  };
  // tile it back from its starting state into part[it % 2]
  float g[CPT] = {0.f, 0.f, 0.f, 0.f};
  auto walk = [&](int it) {
    const unsigned char* buf = raw + (it % 3) * RAW;
    const unsigned char* rr = buf + i * ESZ;              // [T][HD] rows
    const unsigned char* kk = buf + TH * 4 + i * ESZ;
    const unsigned char* vv = buf + 2 * TH * 4 + j0 * ESZ;  // columns
    const float* ws = reinterpret_cast<const float*>(buf + 3 * TH * 4) + i;
    const float* dys = reinterpret_cast<const float*>(buf + 4 * TH * 4) + j0;
    float* ps = part + (it & 1) * PART;
    const bool l1 = lane & 2, l0 = lane & 1;     // a row's 4 lanes
    const bool c1 = lane & 4, c0 = lane & 8, c2 = lane & 16;
    // a token pair's sums land as: row sums on lane (l1, l0) for the
    // pair's token l1, dr (l0 = 0) or dk (l0 = 1), and dw (l0 = 0); dv on
    // lane c1's token, column j0 + 2 c0 + c2
    float* rs = ps + (cb * HD + i) * 3 + l0 - l1 * RSTR;  // [T][RSTR]
    float* cs = ps + T * RSTR + rb * HD + j0 + 2 * c0 + c2 - c1 * CSTR;
    const float4 s0 = it > 0 ? sbnd[(it % 3) * NT + tid]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    auto fwd = [&](float (&s)[CPT], int t) {
      advance(s, rkv_at<BF>(kk, t * HD), ws[t * HD], rkv4_at<BF>(vv, t * HD));
    };
#pragma unroll
    for (int sb = T / SUB - 1; sb >= 0; --sb) {
      float st[SUB][CPT];
      st[0][0] = s0.x;
      st[0][1] = s0.y;
      st[0][2] = s0.z;
      st[0][3] = s0.w;
#pragma unroll
      for (int t = 0; t < sb * SUB; ++t) fwd(st[0], t);
#pragma unroll
      for (int x = 1; x < SUB; ++x) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) st[x][j] = st[x - 1][j];
        fwd(st[x], sb * SUB + x - 1);
      }
      // tokens in pairs (t, t - 1), back: their sums reduce together
#pragma unroll
      for (int x = SUB - 1; x > 0; x -= 2) {
        float pr[2], pk[2], pw[2], pv[2][CPT];
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int t = sb * SUB + x - y;
          const float* sp = st[x - y];
          const float kt = rkv_at<BF>(kk, t * HD), rt = rkv_at<BF>(rr, t * HD);
          const float wt = ws[t * HD];
          const float4 v = rkv4_at<BF>(vv, t * HD);
          const float4 d = *reinterpret_cast<const float4*>(dys + t * HD);
          const float vv4[CPT] = {v.x, v.y, v.z, v.w};
          const float dd[CPT] = {d.x, d.y, d.z, d.w};
          pr[y] = pk[y] = pw[y] = 0.f;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            pr[y] = fmaf(sp[j], dd[j], pr[y]);
            pk[y] = fmaf(g[j], vv4[j], pk[y]);
            pw[y] = fmaf(g[j], sp[j], pw[y]);
            pv[y][j] = g[j] * kt;
            g[j] = fmaf(wt, g[j], rt * dd[j]);
          }
        }
        // row sums over the row's 4 lanes, transposed: lanes l1 keep
        // token 1's, then lanes l0 keep dk, and both dw
        const float r2 = (l1 ? pr[1] : pr[0]) +
                         __shfl_xor_sync(FULL, l1 ? pr[0] : pr[1], 2);
        const float k2 = (l1 ? pk[1] : pk[0]) +
                         __shfl_xor_sync(FULL, l1 ? pk[0] : pk[1], 2);
        const float w2 = (l1 ? pw[1] : pw[0]) +
                         __shfl_xor_sync(FULL, l1 ? pw[0] : pw[1], 2);
        const float rk =
            (l0 ? k2 : r2) + __shfl_xor_sync(FULL, l0 ? r2 : k2, 1);
        const float ww = w2 + __shfl_xor_sync(FULL, w2, 1);
        const int t = sb * SUB + x;
        rs[t * RSTR] = rk;
        if (!l0) rs[t * RSTR + 2] = ww;
        // dv's column sums over the warp's 8 rows, transposed: lanes c1
        // keep token 1's, then c0 columns 2, 3, then c2 the odd column
        float e[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          e[j] = (c1 ? pv[1][j] : pv[0][j]) +
                 __shfl_xor_sync(FULL, c1 ? pv[0][j] : pv[1][j], 4);
        const float f0 = (c0 ? e[2] : e[0]) +
                         __shfl_xor_sync(FULL, c0 ? e[0] : e[2], 8);
        const float f1 = (c0 ? e[3] : e[1]) +
                         __shfl_xor_sync(FULL, c0 ? e[1] : e[3], 8);
        cs[t * CSTR] =
            (c2 ? f1 : f0) + __shfl_xor_sync(FULL, c2 ? f0 : f1, 16);
      }
    }
  };
  // tile it's outputs from part[it % 2] in fixed order, with the u terms;
  // du's share of this thread's column (tid % hd: NT % hd == 0)
  float du = 0.f;
  const float uc = a.u[(size_t)h * HD + tid % HD];
  auto epilogue = [&](int it) {
    const int t0 = it * T, n = min(T, S - t0);
    const unsigned char* buf = raw + (it % 3) * RAW;
    const float* dys = reinterpret_cast<const float*>(buf + 4 * TH * 4);
    const float2* sc = scal + (it & 1) * T;
    const float* rs = part + (it & 1) * PART;
    const float* cs = rs + T * RSTR;
    for (int o = (tid + NT / 2) % NT; o < n * HD; o += NT) {
      const int t = o / HD, c = o - t * HD;
      const float kt = rkv_at<BF>(buf + TH * 4, o), rt = rkv_at<BF>(buf, o);
      const float2 tsum = sc[t];                   // v.dy, sum u r k
      float out[3];
#pragma unroll
      for (int kind = 0; kind < 3; ++kind) {
        float s = 0.f;
#pragma unroll
        for (int cbk = 0; cbk < NCB; ++cbk)
          s += rs[t * RSTR + (cbk * HD + c) * 3 + kind];
        out[kind] = s;
      }
      float sv = 0.f;
#pragma unroll
      for (int rbk = 0; rbk < NRB; ++rbk) sv += cs[t * CSTR + rbk * HD + c];
      const size_t idx = base + (size_t)(t0 + t) * tok + c;
      a.dr[idx] = fmaf(uc * kt, tsum.x, out[0]);
      a.dk[idx] = fmaf(uc * rt, tsum.x, out[1]);
      a.dw[idx] = out[2];
      a.dv[idx] = fmaf(tsum.y, dys[o], sv);
      du = fmaf(rt * kt, tsum.x, du);
    }
  };

  __syncthreads();                       // pass A is done with the buffers
  const int last = ntiles - 1;
  stage_b(last);
  cp_async_commit();
  for (int it = last; it >= 0; --it) {
    cp_async_wait<0>();
    __syncthreads();       // tile it staged; tile it + 1's sums and
                           // partials written; tile it + 2 summed out
    if (it > 0) stage_b(it - 1);
    cp_async_commit();
    sums(it);
    if (it < last) epilogue(it + 1);
    walk(it);
  }
  __syncthreads();
  epilogue(0);
  // du: each column's partials in order
  float* dup = reinterpret_cast<float*>(sbnd);
  dup[tid] = du;
  __syncthreads();
  if (tid < HD) {
    float s = 0.f;
    for (int o = tid; o < NT; o += HD) s += dup[o];
    a.du[(size_t)bh * HD + tid] = s;
  }
}

template <int HD, bool BF>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  auto kern = wkv6_bwd_kernel<HD, BF>;
  constexpr int smem = smem_bytes(HD);
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

// Pointers as in the layout above, every tensor contiguous and 16-byte
// aligned.  hd is 16, 32 or 64; threads, tile and smem are
// kernels/wkv6.py::wkv6_bwd_plan's and must be this file's (hd * hd / 4,
// T, smem_bytes(hd)).  Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or plan it does not take.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* dy,
                               void* dr, void* dk, void* dv, void* dw,
                               void* du, void* bounds, int B, int H, int S,
                               int hd, int rkv_bf16, int threads, int tile,
                               int smem, void* stream) {
  if (S < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if ((hd != 16 && hd != 32 && hd != 64) || threads != n_threads(hd) ||
      tile != T || smem != smem_bytes(hd))
    return (int)cudaErrorInvalidValue;
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
    default: return (int)by_type<64>(a, B, rkv_bf16, st);
  }
}
