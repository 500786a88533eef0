// fused_attn_unit and fused_ffn: the fused DECODE words for B arena rows.
//
// Replaces two TPU kernels of repro/kernels/decode_fused.py:
//   fused_attn_unit (pl.pallas_call at decode_fused.py:272, body
//     _attn_unit_kernel): one decode step of one attention layer — norm1,
//     QKV, RoPE, KV append, GQA attention, o-projection, residual, and
//     the FF block with its residual;
//   fused_ffn (pl.pallas_call at decode_fused.py:315, body _ffn_kernel):
//     norm2 + FF + residual alone, for units whose mixer stays per-op
//     (rwkv6's recurrence).
// The TPU grid was (B,): one program per arena row, each re-reading every
// weight of the layer.
//
// What bounds them on the H100.  A decode step at B <= 32 rows does at
// most 64 flops per weight byte, far below the ~295 at which the tensor
// cores become the limit: each word is bound by reading its weights once
// (qwen2-0.5b: 30 MB a layer; rwkv6-1.6b's FF: 59 MB) and, for
// attention, each row's K/V cache.  Streaming that at the card's rate
// needs many blocks with many bytes in flight; and since each launch's
// work is a few microseconds, the gaps between launches count as much.
//
// The design:
//
// - Weight products (QKV, o, FF up/gate, FF down) run on the TMA + wgmma
//   building blocks of gemm_sm90.cuh: a 6-stage shared-memory ring filled
//   by TMA from one producer warp, one consumer warpgroup issuing
//   m64nNk16 wgmma with the (at most 32, or 64) rows as the M side and
//   64 weight columns (128 when gated: the gate box at n and the up box
//   at f + n share one wgmma) as N.  A block owns one (column tile, split
//   of K, 64-row tile); the split count comes from (N, K) alone
//   (kernels/decode_fused.py::gemm_plan): enough splits that the blocks
//   number at least SPLIT_BLOCKS (100) — qwen2's o-projection is 14
//   column tiles, rwkv6's down-projection 32.
// - The split reduction is deterministic (no float atomics: two calls
//   give the same bits, and since the splits never depend on B, a row's
//   result does not either).  The FF products reduce in the launch: every
//   block writes its f32 partial tile, counts itself on the tile's
//   integer counter, and the block that arrives last sums the partials
//   in split order and applies the epilogue.  QKV and the o-projection
//   only write their partials (raw<P>): the attention sums a row's q, k
//   and v columns itself, and one block per row sums the o-projection's
//   row, adds the residual and computes norm2 in the same pass.
// - Epilogues, in the TPU kernel's cast order: QKV sums + f32 bias,
//   rounded to bf16; o / down sums rounded to bf16, then added to the
//   bf16 residual; the gated activation of the full f32 gate and up sums
//   (swiglu, geglu) or the plain one (relu^2, gelu), rounded once.
// - The norm runs once per row (one block a row, the row in registers),
//   writing the bf16 normalised rows that the next product's TMA reads as
//   A; norm1 also zeroes the call's split counters.
// - Attention is split over the cache positions (flash-decoding): one
//   block per (position split of 64, KV head, row).  Its K and V rows
//   arrive by cp.async into padded shared memory; the scores of its G
//   query heads run on the tensor cores (mma.sync m16n8k16, bf16 q and k
//   in, f32 sums); exp(s - m_i) stays f32 for PV on the CUDA cores; it
//   writes the f32 partials m_i, l_i and o_i = sum exp(s - m_i) v.  The
//   last block of a (row, KV head) merges them in split order, o = sum
//   exp(m_i - m) o_i / max(sum exp(m_i - m) l_i, 1e-30).  A split whose
//   positions are all masked has m_i = -1e30 and weight exp(-1e30 - m) =
//   0.  The current ring slot is read from this step's new key and
//   value, never from the cache, so no block depends on another's
//   append; only active rows append.
// - Launches overlap (programmatic dependent launch): every launch after
//   a call's first starts while the one before it finishes, and streams
//   what no launch of the call writes — its first weight stages, the K/V
//   rows, the norm's input and vectors — before it waits.
//
// Launches: fused_attn_unit 7 (norm1, QKV, attention, o, the residual
// with norm2, FF in, FF out; 5 without the FF), fused_ffn 3 (norm2, FF
// in, FF out); each entry counts the launches it makes for its caller.  Kernel names carry the word (template argument W: 0
// fused_attn_unit, 1 fused_ffn) and the product or pass, so a trace
// tells them apart from sr_matmul's and outer_accum's gemm_sm90 launches
// and from each other.
#include <utility>

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace rt {
namespace decode {

using sm90::BK;
using sm90::MN_BLOCK;

constexpr int ROWS = 64;                  // rows of one wgmma tile
constexpr int A_BYTES = ROWS * BK * 2;    // one A stage (8 KB)
constexpr int GEMM_THREADS = 128 + 32;    // one consumer warpgroup + producer
constexpr int ATTN_THREADS = 128;
constexpr int ATTN_SPLIT = 64;            // cache positions per block
constexpr int NORM_THREADS = 512;
constexpr int NORM_PAIRS = 8;             // bf16 pairs a norm thread holds
constexpr int MAXG = 16;                  // query heads per KV head
constexpr int MERGE = 4;                  // splits a merge thread loads at once
constexpr float NEG = -1e30f;

// the weight products; the template argument of gemm_kernel
enum Product { QKV = 0, OPROJ = 1, FFN_GATED = 2, FFN_IN = 3, FFN_OUT = 4 };
enum { ACT_SWIGLU = 0, ACT_GEGLU = 1, ACT_GELU = 2, ACT_RELU_SQ = 3 };

// The workspace layout, int64 fields in this order: mirrors
// kernels/decode_fused.py::LAYOUT_FIELDS.  Offsets are in bytes.
enum Layout {
  L_SP_QKV, L_SP_O, L_SP_IN, L_SP_OUT, L_ATTN_NSPLIT,
  L_H1, L_O, L_X1, L_H2, L_H, L_ATTN, L_PART, L_CNT,
  L_CNT_IN, L_CNT_OUT, L_CNT_ATTN, L_N_CNT, L_FIELDS
};

// An optional vector, f32 or bf16; absent: the neutral value.
struct Vec {
  const void* p;
  int bf;
  __device__ __forceinline__ float at(int i, float neutral) const {
    if (p == nullptr) return neutral;
    return bf ? bf2f(static_cast<const bf16*>(p)[i])
              : static_cast<const float*>(p)[i];
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// The consumer warpgroup's own barrier (the producer warp has returned).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// Programmatic dependent launch: every launch after a call's first one
// may start while the launch before it finishes.  launch_dependents lets
// the next launch start; wait blocks until the previous launch has
// completed and its writes are visible (a no-op for a launch made
// without the attribute).  Before its wait a launch only reads what no
// launch of the call writes (weights, the KV cache) and writes nothing
// to global memory.
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// 16 bytes global -> shared, asynchronously (L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---- norm ------------------------------------------------------------------

// Sum over the block's NORM_THREADS threads in a fixed order.
__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NORM_THREADS / 32; ++w) r += red[w];
  return r;
}

// Row b = blockIdx.x of a decode word, one block a row, the row held in
// registers (d <= 2 NORM_PAIRS NORM_THREADS, even).  With R (after the
// o-projection): the row becomes x1 = bf16(x + bf16(sum of the o
// product's f32 partials, split order 0..splits-1)), written to x1_out.
// Then, unless kind is 0, out[b] = bf16(norm(row) * scale + bias) in f32:
// rmsnorm (kind 1) x * rsqrt(mean(x^2) + 1e-6), layernorm (kind 2)
// (x - mu) * rsqrt(var + 1e-5).  Also zeroes the call's n_cnt split
// counters.
template <int W, int R>
__global__ void __launch_bounds__(NORM_THREADS)
    norm_kernel(const bf16* __restrict__ x, const float* __restrict__ part,
                int splits, bf16* __restrict__ x1_out, Vec scale, Vec bias,
                bf16* __restrict__ out, int d, int kind,
                int* __restrict__ counters, int n_cnt) {
  __shared__ float red[NORM_THREADS / 32];
  griddep_launch();
  // x (the call's input) and the norm's vectors: no launch of the call
  // writes them, so they are read before the previous launch finishes
  const size_t r0 = (size_t)blockIdx.x * d;
  const __nv_bfloat162* row = reinterpret_cast<const __nv_bfloat162*>(x + r0);
  const int pairs = d / 2;
  float2 v[NORM_PAIRS], sc[NORM_PAIRS], bi[NORM_PAIRS];
#pragma unroll
  for (int i = 0; i < NORM_PAIRS; ++i) {
    const int k = threadIdx.x + NORM_THREADS * i;
    const bool ok = k < pairs;
    v[i] = ok ? __bfloat1622float2(row[k]) : make_float2(0.f, 0.f);
    sc[i] = ok ? make_float2(scale.at(2 * k, 1.f), scale.at(2 * k + 1, 1.f))
               : make_float2(1.f, 1.f);
    bi[i] = ok ? make_float2(bias.at(2 * k, 0.f), bias.at(2 * k + 1, 0.f))
               : make_float2(0.f, 0.f);
  }
  griddep_wait();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_cnt;
       i += gridDim.x * blockDim.x)
    counters[i] = 0;
  if constexpr (R) {
    const size_t plane = (size_t)gridDim.x * d;
    float2 acc[NORM_PAIRS];
#pragma unroll
    for (int i = 0; i < NORM_PAIRS; ++i) acc[i] = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < splits; ++sp) {
#pragma unroll
      for (int i = 0; i < NORM_PAIRS; ++i) {
        const int k = threadIdx.x + NORM_THREADS * i;
        if (k >= pairs) continue;
        const float2 u = __ldcg(reinterpret_cast<const float2*>(
            part + sp * plane + r0 + 2 * k));
        if (sp == 0) {
          acc[i] = u;
        } else {
          acc[i].x += u.x;
          acc[i].y += u.y;
        }
      }
    }
    __nv_bfloat162* xo = reinterpret_cast<__nv_bfloat162*>(x1_out + r0);
#pragma unroll
    for (int i = 0; i < NORM_PAIRS; ++i) {
      const int k = threadIdx.x + NORM_THREADS * i;
      if (k >= pairs) continue;
      const __nv_bfloat162 x1 = __floats2bfloat162_rn(
          v[i].x + bf2f(f2bf(acc[i].x)), v[i].y + bf2f(f2bf(acc[i].y)));
      xo[k] = x1;
      v[i] = __bfloat1622float2(x1);
    }
  }
  if (kind == 0) return;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NORM_PAIRS; ++i) s += v[i].x + v[i].y;
  const float mu = kind == 2 ? block_sum(s, red) / d : 0.f;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NORM_PAIRS; ++i) {
    if (threadIdx.x + NORM_THREADS * i < pairs) {
      const float a = v[i].x - mu, b = v[i].y - mu;
      q += a * a + b * b;
    }
  }
  const float rs = rsqrtf(block_sum(q, red) / d + (kind == 1 ? 1e-6f : 1e-5f));
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + r0);
#pragma unroll
  for (int i = 0; i < NORM_PAIRS; ++i) {
    const int k = threadIdx.x + NORM_THREADS * i;
    if (k >= pairs) continue;
    const float y0 = __fmul_rn(v[i].x - mu, rs), y1 = __fmul_rn(v[i].y - mu, rs);
    o[k] = __floats2bfloat162_rn(
        __fadd_rn(__fmul_rn(y0, sc[i].x), bi[i].x),
        __fadd_rn(__fmul_rn(y1, sc[i].y), bi[i].y));
  }
}

// ---- weight products -------------------------------------------------------

struct Gemm {
  int M, N, K;          // out (M, N) = A (M, K) . W[:, cols]; gated: N = f
  int up_off;           // gated: the up half's first column (f)
  int kb, splits;       // k-blocks of K and the splits over them
  int a_rows;           // rows of an A box: 32 when M <= 32, else 64
  const bf16* resid;    // FFN_OUT: (M, N)
  int act;              // ACT_*
  bf16* out;            // (M, N)
  float* part;          // (splits, M, NB N) f32 partials (QKV, OPROJ, or
                        // splits > 1)
  int* counters;        // splits > 1: one per (column tile, row tile)
};

// QKV's and the o-projection's partials are summed by the launch after
// them (the attention, and the residual + norm2 pass), which needs whole
// heads and whole rows: these products only write their partials.
template <int P>
__host__ __device__ constexpr bool raw() { return P == QKV || P == OPROJ; }

template <int P>
__host__ __device__ constexpr int boxes() { return P == FFN_GATED ? 2 : 1; }

// Ring depth of a weight product: 6 stages (16 KB each, 24 KB when
// gated).
constexpr int STAGES = 6;

template <int P>
__host__ __device__ constexpr int gemm_smem() {
  return STAGES * (A_BYTES + boxes<P>() * MN_BLOCK) + 2 * STAGES * 8 + 16 +
         1024;
}

// The epilogue for columns c, c + 1 of row r from the f32 sums (a: the
// product, or the gate half; u: the up half).
template <int P>
__device__ __forceinline__ void finish(const Gemm& p, int r, int c, float a0,
                                       float a1, float u0, float u1) {
  static_assert(!raw<P>(), "a raw product has no epilogue");
  float v0, v1;
  if constexpr (P == FFN_OUT) {
    const __nv_bfloat162 rr = *reinterpret_cast<const __nv_bfloat162*>(
        p.resid + (size_t)r * p.N + c);
    v0 = __low2float(rr) + bf2f(f2bf(a0));
    v1 = __high2float(rr) + bf2f(f2bf(a1));
  } else if constexpr (P == FFN_GATED) {
    if (p.act == ACT_SWIGLU) {
      v0 = a0 / (1.f + expf(-a0)) * u0;
      v1 = a1 / (1.f + expf(-a1)) * u1;
    } else {
      v0 = gelu_tanh(a0) * u0;
      v1 = gelu_tanh(a1) * u1;
    }
  } else {
    if (p.act == ACT_GELU) {
      v0 = gelu_tanh(a0);
      v1 = gelu_tanh(a1);
    } else {
      const float t0 = fmaxf(a0, 0.f), t1 = fmaxf(a1, 0.f);
      v0 = t0 * t0;
      v1 = t1 * t1;
    }
  }
  *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)r * p.N + c) =
      __floats2bfloat162_rn(v0, v1);
}

// The last block of a split tile: sum the splits' partials of rows
// m0..m0+RR-1 in split order 0..splits-1 and apply the epilogue.  Thread
// t owns the float4 chunks q = t + 128 i (row q / 16, columns 4 (q % 16)
// ..+3); the loads of G splits are in flight together.
template <int P, int RR>
__device__ __forceinline__ void reduce_finish(const Gemm& p, int t, int m0,
                                              int n0) {
  constexpr int NB = boxes<P>();
  constexpr int CH = RR * 16 / 128;
  constexpr int G = 16 / (CH * NB) > 0 ? 16 / (CH * NB) : 1;
  const size_t width = (size_t)NB * p.N, plane = (size_t)p.M * width;
  float4 sum[CH][NB];
  for (int s0 = 0; s0 < p.splits; s0 += G) {
    float4 v[G][CH][NB];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int q = t + 128 * i, r = m0 + q / 16, c = n0 + 4 * (q % 16);
        const bool ok = s0 + g < p.splits && r < p.M && c < p.N;
#pragma unroll
        for (int b = 0; b < NB; ++b)
          v[g][i][b] = ok ? __ldcg(reinterpret_cast<const float4*>(
                                p.part + (s0 + g) * plane + r * width +
                                b * p.N + c))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (s0 + g >= p.splits) break;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float4 u = v[g][i][b];
          float4& a = sum[i][b];
          if (s0 + g == 0) {
            a = u;
          } else {
            a.x += u.x;
            a.y += u.y;
            a.z += u.z;
            a.w += u.w;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int q = t + 128 * i, r = m0 + q / 16, c = n0 + 4 * (q % 16);
    if (r >= p.M || c >= p.N) continue;
    const float4 a = sum[i][0], u = sum[i][NB - 1];
    finish<P>(p, r, c, a.x, a.y, u.x, u.y);
    finish<P>(p, r, c + 2, a.z, a.w, u.z, u.w);
  }
}

// One block: column tile blockIdx.x (64 columns, and the same 64 of the
// up half when gated), split blockIdx.y of K, rows 64 blockIdx.z...+63.
// Warps 0-3 are the consumer warpgroup, warp 4 the producer.
template <int W, int P>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b, const Gemm p) {
  constexpr int NB = boxes<P>();
  constexpr int BN = 64 * NB;
  constexpr int NACC = BN / 2;
  constexpr int B_BYTES = NB * MN_BLOCK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = smem;
  uint8_t* sb = smem + STAGES * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * B_BYTES);
  uint64_t* empty = full + STAGES;
  int* last = reinterpret_cast<int*>(empty + STAGES);

  const int n0 = blockIdx.x * 64, z = blockIdx.y, m0 = blockIdx.z * ROWS;
  const int kb0 = (int)((long long)z * p.kb / p.splits);
  const int nk = (int)((long long)(z + 1) * p.kb / p.splits) - kb0;

  griddep_launch();
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 32 == 4) {
    // producer: one thread keeps the ring full.  The weights do not
    // depend on the launch before this one: the first stages' weight
    // boxes are requested before waiting for it, A's after.
    if (threadIdx.x % 32 != 0) return;
    sm90::tma_prefetch(&tma_a);
    sm90::tma_prefetch(&tma_b);
    const int tx = p.a_rows * BK * 2 + B_BYTES;
    auto load_b = [&](int s, int k0) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        sm90::tma_load(sb + s * B_BYTES + j * MN_BLOCK, &tma_b, &full[s],
                       n0 + j * p.up_off, k0);
    };
    const int pre = nk < STAGES ? nk : STAGES;
    for (int i = 0; i < pre; ++i) {
      sm90::mbar_expect_tx(&full[i], tx);
      load_b(i, (kb0 + i) * BK);
    }
    griddep_wait();
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES, round = i / STAGES;
      const int k0 = (kb0 + i) * BK;
      if (round > 0) {
        sm90::mbar_wait(&empty[s], (round - 1) & 1);
        sm90::mbar_expect_tx(&full[s], tx);
        load_b(s, k0);
      }
      sm90::tma_load(sa + s * A_BYTES, &tma_a, &full[s], k0, m0);
    }
    return;
  }

  // consumers: one k-block's wgmma group in flight while the next is
  // issued; a stage is released once its group has completed
  const int t = threadIdx.x;
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
  int pending = -1;
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    sm90::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t a_base = sm90::smem_u32(sa + s * A_BYTES);
    const uint32_t b_base = sm90::smem_u32(sb + s * B_BYTES);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::wgmma_step<BN, 0, 1>(
          acc, sm90::gmma_desc(a_base + kk * 32, 16, 1024),
          sm90::gmma_desc(b_base + kk * 2048, MN_BLOCK, 1024),
          (kk > 0 || i > 0) ? 1 : 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(acc);
    if (pending >= 0) sm90::mbar_arrive(&empty[pending]);
    pending = s;
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  griddep_wait();   // the residual, the partials and the counters below

  // accumulator layout of m64nBN: element 4j + 2h + e of thread t sits at
  // row 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4) + e;
  // columns 64.. (j >= 8) are the up half when gated
  const int row0 = m0 + 16 * (t / 32) + (t % 32) / 4;
  const int col0 = n0 + 2 * (t % 4);
  if (!raw<P>() && p.splits == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h, c = col0 + 8 * j, e = 4 * j + 2 * h;
        if (r >= p.M || c >= p.N) continue;
        if constexpr (NB == 2)
          finish<P>(p, r, c, acc[e], acc[e + 1], acc[e + 32], acc[e + 33]);
        else if constexpr (!raw<P>())
          finish<P>(p, r, c, acc[e], acc[e + 1], 0.f, 0.f);
      }
    }
    return;
  }

  // this split's raw partial; the last block of the tile sums all of them
  // in split order (a raw product leaves that to the next launch)
  const size_t width = (size_t)NB * p.N;
  const size_t plane = (size_t)p.M * width;
  float* mine = p.part + (size_t)z * plane;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h, c = col0 + 8 * (j % 8), e = 4 * j + 2 * h;
      if (r < p.M && c < p.N)
        *reinterpret_cast<float2*>(mine + r * width + (j / 8) * p.N + c) =
            make_float2(acc[e], acc[e + 1]);
    }
  }
  if constexpr (raw<P>()) return;
  __threadfence();
  consumers_sync();
  if (t == 0) {
    const int done = atomicAdd(&p.counters[blockIdx.z * gridDim.x + blockIdx.x], 1);
    *last = done == p.splits - 1;
  }
  consumers_sync();
  if (!*last) return;
  __threadfence();
  if constexpr (!raw<P>()) {
    if (p.a_rows == 32)
      reduce_finish<P, 32>(p, t, m0, n0);
    else
      reduce_finish<P, ROWS>(p, t, m0, n0);
  }
}

// ---- attention -------------------------------------------------------------

struct Attn {
  const float* qkv; int qn;         // (splits, B, qn) f32 partials of QKV
  int qkv_splits;                   // qn = (H + 2K) hd
  Vec qkv_bias;                     // (qn), or null
  bf16* ck; bf16* cv; int* cpos;    // (B, S, K, hd) x2, (B, S) arena rows
  const int* pos;                   // (B,) absolute position
  const void* active;               // (B,) bool or int32; null: every row
  int active_i32;
  float* part;                      // nsplit > 1: (B, K, nsplit, part_stride)
  int* counters;                    // nsplit > 1: (B, K)
  bf16* o;                          // (B, H hd) attention output
  int H, K, hd, S, window, nsplit;  // window <= 0: none
  float theta, scale;
};

__device__ __forceinline__ bool row_active(const Attn& p, int b) {
  if (p.active == nullptr) return true;
  return p.active_i32 ? static_cast<const int*>(p.active)[b] != 0
                      : static_cast<const uint8_t*>(p.active)[b] != 0;
}

// K, V and query tile rows: hd bf16 and 16 bytes of padding, so the
// tensor-core fragment loads of 8 rows hit 8 different bank groups
__host__ __device__ constexpr int kv_ld(int hd) { return hd + 8; }

// Floats of one split's partials: o_i (G hd), then m_i and l_i (G each),
// padded to 16 bytes so that every o_i is float4-aligned.
__host__ __device__ constexpr int part_stride(int G, int hd) {
  return G * hd + (2 * G + 3) / 4 * 4;
}

// PV: a thread owns 4 consecutive dims of the head and every nparts-th
// position of the split
__host__ __device__ constexpr int pv_parts(int hd) {
  return ATTN_THREADS * 4 / hd;
}

// Two bf16 at p (4-byte aligned) as one 32-bit register.
__device__ __forceinline__ uint32_t ld_b32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += A . B for one m16n8k16 tile: A 16 x 16 bf16 (row-major fragment
// a0..a3), B 16 x 8 bf16 (column-major fragment b0, b1), c f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16 pair packed in a 32-bit word -> two f32 (exact)
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

size_t attn_smem_bytes(int G, int hd) {
  const int nparts = pv_parts(hd);
  return (2 * ATTN_SPLIT + 16) * sizeof(bf16) * (size_t)kv_ld(hd) +
         sizeof(float) * ((size_t)(G + 2) * hd + hd + (size_t)G * ATTN_SPLIT +
                          (size_t)nparts * G * hd + 2 * MAXG) +
         sizeof(int) * ATTN_SPLIT;
}

// Block (split, KV head kh, row b): positions split * ATTN_SPLIT ..+63,
// for the G <= GT query heads of KV head kh (GT a power of two, the
// template argument: the per-head loops are unrolled over GT).
template <int GT>
__global__ void __launch_bounds__(ATTN_THREADS) attn_kernel(const Attn p) {
  extern __shared__ __align__(16) uint8_t attn_smem[];
  __shared__ int is_last;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = p.H / p.K, hd = p.hd, half = hd / 2, S = p.S;
  const int s0 = split * ATTN_SPLIT, n = min(ATTN_SPLIT, S - s0);
  const int nparts = pv_parts(hd), ld = kv_ld(hd);
  bf16* kt = reinterpret_cast<bf16*>(attn_smem);   // [ATTN_SPLIT][ld]
  bf16* vt = kt + ATTN_SPLIT * ld;                 // [ATTN_SPLIT][ld]
  float* q_s = reinterpret_cast<float*>(vt + ATTN_SPLIT * ld);
  // q_s [G][hd] queries, then the new key k1 [hd] and value v1 [hd]:
  // projected (bf16 values), then the queries and key roped
  float* k1 = q_s + G * hd;
  float* v1 = k1 + hd;
  float* rope = v1 + hd;                 // [hd]: cos, sin of the half freqs
  float* sc = rope + hd;                 // [G][ATTN_SPLIT] scores, then exp
  float* pv = sc + G * ATTN_SPLIT;       // [nparts][G][hd] PV partials
  float* m_s = pv + nparts * G * hd;     // [MAXG]
  float* l_s = m_s + MAXG;               // [MAXG]
  int* kp_s = reinterpret_cast<int*>(l_s + MAXG);  // [ATTN_SPLIT] positions
  bf16* qb = reinterpret_cast<bf16*>(kp_s + ATTN_SPLIT);  // [16][ldq]
  const int ldq = kv_ld(hd);

  // before the previous launch (QKV) has finished: what no launch of the
  // call writes before this one — the split's cached K and V rows (in
  // flight meanwhile), their positions, this row's position and the RoPE
  // table
  griddep_launch();
  {
    const int cpr = hd / 8;              // 16-byte chunks a row
    const size_t row0 = ((size_t)(b * S + s0) * p.K + kh) * hd;
    const size_t pstride = (size_t)p.K * hd;
    for (int c = tid; c < 2 * n * cpr; c += ATTN_THREADS) {
      const int which = c / (n * cpr), rem = c % (n * cpr);
      const int jj = rem / cpr, ch = rem % cpr;
      const bf16* src = (which ? p.cv : p.ck) + row0 + jj * pstride + ch * 8;
      cp_async16((which ? vt : kt) + jj * ld + ch * 8, src);
    }
  }
  const int pp = p.pos[b];
  const int slot = ((pp % S) + S) % S;
  const bool act = row_active(p, b);
  for (int jj = tid; jj < n; jj += ATTN_THREADS)
    kp_s[jj] = s0 + jj == slot ? pp : p.cpos[b * S + s0 + jj];
  // the QKV bias of this block's columns
  const int nq = G * hd;
  auto qkv_col = [&](int e) {
    return e < nq ? kh * nq + e
                  : (e < nq + hd ? p.H * hd : (p.H + p.K - 1) * hd) +
                        kh * hd + (e - nq);
  };
  for (int e = tid; e < nq + 2 * hd; e += ATTN_THREADS)
    q_s[e] = p.qkv_bias.at(qkv_col(e), 0.f);
  // RoPE in f32 at pp, freqs = 1 / theta^(2i/hd)
  for (int j = tid; j < half; j += ATTN_THREADS) {
    const float ang =
        (float)pp * (1.f / powf(p.theta, 2.f * (float)j / (float)hd));
    rope[j] = cosf(ang);
    rope[half + j] = sinf(ang);
  }
  griddep_wait();

  // this row's q (G heads), k and v columns of the QKV product: its
  // partials summed in split order, + bias, rounded to bf16
  __syncthreads();
  {
    const size_t plane = (size_t)gridDim.z * p.qn;
    for (int e = 4 * tid; e < nq + 2 * hd; e += 4 * ATTN_THREADS) {
      const float* src = p.qkv + (size_t)b * p.qn + qkv_col(e);
      float4 a = __ldcg(reinterpret_cast<const float4*>(src));
#pragma unroll 4
      for (int sp = 1; sp < p.qkv_splits; ++sp) {
        const float4 u = __ldcg(reinterpret_cast<const float4*>(src + sp * plane));
        a.x += u.x;
        a.y += u.y;
        a.z += u.z;
        a.w += u.w;
      }
      q_s[e] = bf2f(f2bf(a.x + q_s[e]));
      q_s[e + 1] = bf2f(f2bf(a.y + q_s[e + 1]));
      q_s[e + 2] = bf2f(f2bf(a.z + q_s[e + 2]));
      q_s[e + 3] = bf2f(f2bf(a.w + q_s[e + 3]));
    }
  }
  __syncthreads();
  // RoPE of the G queries and the key (k1 follows the queries in q_s),
  // rounded back to bf16
  for (int e = tid; e < (G + 1) * half; e += ATTN_THREADS) {
    const int which = e / half, j = e % half;
    float* h = q_s + which * hd;
    const float x1 = h[j], x2 = h[j + half], c = rope[j], sn = rope[half + j];
    h[j] = bf2f(f2bf(x1 * c - x2 * sn));
    h[j + half] = bf2f(f2bf(x1 * sn + x2 * c));
  }
  cp_async_wait_all();
  __syncthreads();

  // the current ring slot holds this step's new key and value: in the
  // tile for every row, and in the cache (appended by the block whose
  // split holds it) on active rows only — an inactive arena row keeps
  // its cache exactly
  if (slot >= s0 && slot < s0 + n) {
    const int js = slot - s0;
    const size_t off = ((size_t)(b * S + slot) * p.K + kh) * hd;
    for (int i = tid; i < hd; i += ATTN_THREADS) {
      const bf16 kb = f2bf(k1[i]), vb = f2bf(v1[i]);
      kt[js * ld + i] = kb;
      vt[js * ld + i] = vb;
      if (act) {
        p.ck[off + i] = kb;
        p.cv[off + i] = vb;
      }
    }
    if (act && kh == 0 && tid == 0) p.cpos[b * S + slot] = pp;
  }
  __syncthreads();

  // scores on the tensor cores: warp w takes positions 16 w..16 w + 15,
  // mma.sync m16n8k16 (bf16 in, f32 sums) of the queries (bf16 values,
  // heads padded to 16 rows) against the K tile; masked scores -1e30
  for (int e = tid; e < 16 * hd; e += ATTN_THREADS) {
    const int g = e / hd, i = e % hd;
    qb[g * ldq + i] = f2bf(g < G ? q_s[g * hd + i] : 0.f);
  }
  __syncthreads();
  {
    const int gid = lane / 4, tig = lane % 4, j0 = warp * 16;
    float c[2][4] = {};
    for (int k0 = 0; k0 < hd; k0 += 16) {
      const bf16* qa = qb + gid * ldq + k0 + 2 * tig;
      const uint32_t a0 = ld_b32(qa), a1 = ld_b32(qa + 8 * ldq),
                     a2 = ld_b32(qa + 8), a3 = ld_b32(qa + 8 * ldq + 8);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const bf16* kb = kt + (j0 + 8 * t + gid) * ld + k0 + 2 * tig;
        mma_bf16(c[t], a0, a1, a2, a3, ld_b32(kb), ld_b32(kb + 8));
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = gid + 8 * (e / 2), jj = j0 + 8 * t + 2 * tig + e % 2;
        if (g >= G || jj >= n) continue;
        const int kp = kp_s[jj];
        const bool valid = kp >= 0 && kp <= pp &&
                           (p.window <= 0 || pp - kp < p.window);
        sc[g * ATTN_SPLIT + jj] = valid ? c[t][e] * p.scale : NEG;
      }
    }
  }
  __syncthreads();

  // per query head (a warp each): m_i = max, exp(s - m_i) kept in f32,
  // l_i = sum.  A split with no valid position has m_i = -1e30.
  for (int g = warp; g < G; g += ATTN_THREADS / 32) {
    float* sg = sc + g * ATTN_SPLIT;
    float mx = -INFINITY;
    for (int jj = lane; jj < n; jj += 32) mx = fmaxf(mx, sg[jj]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int jj = lane; jj < n; jj += 32) {
      const float e = expf(sg[jj] - mx);
      sg[jj] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  // PV: thread (part, 4 dims i..i+3) sums positions jj = part (mod
  // nparts) for all G heads; each weight exp(s - m_i) feeds 4 FMAs
  {
    const int i = 4 * (tid % (hd / 4)), pr = tid / (hd / 4);
    float4 acc[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int jj = pr; jj < n; jj += nparts) {
      const uint2 raw = *reinterpret_cast<const uint2*>(vt + jj * ld + i);
      const float v0 = bf_lo(raw.x), v1_ = bf_hi(raw.x), v2 = bf_lo(raw.y),
                  v3 = bf_hi(raw.y);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g < G) {
          const float w = sc[g * ATTN_SPLIT + jj];
          acc[g].x += w * v0;
          acc[g].y += w * v1_;
          acc[g].z += w * v2;
          acc[g].w += w * v3;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g)
      if (g < G)
        *reinterpret_cast<float4*>(pv + (pr * G + g) * hd + i) = acc[g];
  }
  __syncthreads();

  const size_t out_row = (size_t)b * (p.H * hd) + (size_t)kh * G * hd;
  if (p.nsplit == 1) {
    for (int e = tid; e < G * hd; e += ATTN_THREADS) {
      const int g = e / hd, i = e % hd;
      float s = 0.f;
      for (int pr = 0; pr < nparts; ++pr) s += pv[(pr * G + g) * hd + i];
      p.o[out_row + e] = f2bf(s / fmaxf(l_s[g], 1e-30f));
    }
    return;
  }

  // this split's partials (o_i, then m_i and l_i per head) ...
  const size_t stride = part_stride(G, hd);
  float* base = p.part + (size_t)(b * p.K + kh) * p.nsplit * stride;
  float* mine = base + split * stride;
  for (int e = tid; e < G * hd; e += ATTN_THREADS) {
    const int g = e / hd, i = e % hd;
    float s = 0.f;
    for (int pr = 0; pr < nparts; ++pr) s += pv[(pr * G + g) * hd + i];
    mine[e] = s;
  }
  if (tid < G) {
    mine[G * hd + tid] = m_s[tid];
    mine[G * hd + G + tid] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(&p.counters[b * p.K + kh], 1) == p.nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // ... merged by the last block of (row, KV head), in split order: a
  // thread takes 4 outputs of one head and loads o_i, m_i and l_i of
  // MERGE splits at a time; o = sum exp(m_i - m) o_i / max(sum exp(m_i -
  // m) l_i, 1e-30), the sums so far rescaled to each chunk's running max
  for (int e = 4 * tid; e < G * hd; e += 4 * ATTN_THREADS) {
    const int g = e / hd;
    float m = -INFINITY, den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < p.nsplit; c0 += MERGE) {
      float mi[MERGE], li[MERGE];
      float4 oi[MERGE];
#pragma unroll
      for (int u = 0; u < MERGE; ++u) {
        const float* q = base + (size_t)(c0 + u) * stride;
        const bool ok = c0 + u < p.nsplit;
        mi[u] = ok ? __ldcg(q + G * hd + g) : -INFINITY;
        li[u] = ok ? __ldcg(q + G * hd + G + g) : 0.f;
        oi[u] = ok ? __ldcg(reinterpret_cast<const float4*>(q + e))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float mc = m;
#pragma unroll
      for (int u = 0; u < MERGE; ++u) mc = fmaxf(mc, mi[u]);
      const float r = expf(m - mc);       // 0 before the first chunk
      den *= r;
      num.x *= r;
      num.y *= r;
      num.z *= r;
      num.w *= r;
#pragma unroll
      for (int u = 0; u < MERGE; ++u) {
        if (c0 + u >= p.nsplit) break;
        const float w = expf(mi[u] - mc);
        num.x += w * oi[u].x;
        num.y += w * oi[u].y;
        num.z += w * oi[u].z;
        num.w += w * oi[u].w;
        den += w * li[u];
      }
      m = mc;
    }
    const float l = fmaxf(den, 1e-30f);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(p.o + out_row + e);
    dst[0] = __floats2bfloat162_rn(num.x / l, num.y / l);
    dst[1] = __floats2bfloat162_rn(num.z / l, num.w / l);
  }
}

// ---- host side -------------------------------------------------------------

// Opt `kern` into `smem` bytes of dynamic shared memory on the current
// device, once per (kernel, device, size): the attribute is a per-device
// property of the kernel.  Returns a cudaError_t.
int opt_in(const void* kern, int smem) {
  struct Entry { const void* kern; int dev, bytes; };
  static Entry seen[64];
  static int n_seen = 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kern == kern && seen[i].dev == dev && seen[i].bytes >= smem)
      return 0;
  err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == 0 && n_seen < 64) seen[n_seen++] = {kern, dev, smem};
  return err;
}

// Launch `kern` on `st` with `smem` bytes of dynamic shared memory; with
// `pdl` it may start while the previous launch on the stream finishes
// (the kernel waits with griddep_wait).  Adds one to *launched when the
// launch is made.  Returns cudaGetLastError().
template <typename... Params, typename... Args>
int launch(int* launched, void (*kern)(Params...), dim3 grid, int threads,
           int smem, bool pdl, cudaStream_t st, Args&&... args) {
  if (smem > 48 * 1024) {
    const int err = opt_in(reinterpret_cast<const void*>(kern), smem);
    if (err != 0) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern,
                                           std::forward<Args>(args)...);
  const int err = (int)(e != cudaSuccess ? e : cudaGetLastError());
  if (err == 0) ++*launched;
  return err;
}

// One weight product: out = epilogue(A (M, K) . W[:, cols]) with W
// (K, wcols) row-major; grid (column tiles, splits, row tiles).
template <int W, int P>
int gemm(int* launched, const void* a, const void* w, int wcols, Gemm g,
         cudaStream_t st) {
  CUtensorMap ma, mb;
  g.a_rows = g.M <= 32 ? 32 : ROWS;
  int err = sm90::make_map(&ma, a, g.M, g.K, g.K, g.a_rows);
  if (err != 0) return err;
  if ((err = sm90::make_map(&mb, w, g.K, wcols, wcols, 64)) != 0) return err;
  g.kb = (g.K + BK - 1) / BK;
  const dim3 grid((g.N + 63) / 64, g.splits, (g.M + ROWS - 1) / ROWS);
  return launch(launched, gemm_kernel<W, P>, grid, GEMM_THREADS,
                gemm_smem<P>(), true, st, ma, mb, g);
}

struct Word {
  uint8_t* ws;
  const long long* L;
  template <typename T>
  T* at(int field) const { return reinterpret_cast<T*>(ws + L[field]); }
  int* counters(int field) const { return at<int>(L_CNT) + L[field]; }
};

// cnt_field: the layout field of the product's counters, or -1 (a raw
// product keeps none)
Gemm gemm_args(int M, int N, int K, int splits, void* out, const Word& w,
               int cnt_field) {
  Gemm g{};
  g.M = M;
  g.N = N;
  g.K = K;
  g.splits = splits;
  g.out = static_cast<bf16*>(out);
  g.part = w.at<float>(L_PART);
  g.counters = cnt_field < 0 ? nullptr : w.counters(cnt_field);
  return g;
}

// FF in + activation, FF out + residual: y = x + FF(h2) for the
// normalised rows h2.
template <int W>
int ffn(int* launched, const void* x, const bf16* h2, const void* w_in,
        const void* w_out, void* y, const Word& w, int B, int d, int f,
        int act, cudaStream_t st) {
  bf16* h = w.at<bf16>(L_H);
  const bool gated = act == ACT_SWIGLU || act == ACT_GEGLU;
  Gemm g = gemm_args(B, f, d, (int)w.L[L_SP_IN], h, w, L_CNT_IN);
  g.act = act;
  g.up_off = f;
  int err = gated ? gemm<W, FFN_GATED>(launched, h2, w_in, 2 * f, g, st)
                  : gemm<W, FFN_IN>(launched, h2, w_in, f, g, st);
  if (err != 0) return err;
  Gemm g2 = gemm_args(B, d, f, (int)w.L[L_SP_OUT], y, w, L_CNT_OUT);
  g2.resid = static_cast<const bf16*>(x);
  return gemm<W, FFN_OUT>(launched, h, w_out, d, g2, st);
}

}  // namespace decode
}  // namespace rt

// One fused decode step of one attention unit for B arena rows.  bf16,
// contiguous: x (B, d); ck/cv (B, S, K, hd); weights qkv_w (d, qn),
// o_w (H hd, d), w_in (d, 2f | f), w_out (f, d); y (B, d).  cpos (B, S)
// int32 and the caches are updated in place on active rows; pos (B,)
// int32; active (B,) bool (active_i32 0) or int32 (1), or null for every
// row.  The vectors n1s, n1b, n2s, n2b (d) and qkv_b (qn) may be null
// (neutral: scale 1, bias 0); bit i of vec_bf16 says vector i (in that
// order) is bf16, else f32.  ws is the workspace and L its layout
// (kernels/decode_fused.py::decode_plan).  norm_kind 1 rmsnorm / 2
// layernorm; act 0 swiglu, 1 geglu, 2 gelu, 3 relu_sq; window <= 0 for
// none.  Adds one to *launched for each kernel launch it makes.  Returns
// 0, the first failed launch's cudaError_t, or a gemm_sm90.cuh ERR_ code.
extern "C" int fused_attn_unit_bf16(
    const void* x, void* ck, void* cv, void* cpos, const void* pos,
    const void* active, int active_i32, const void* n1s, const void* n1b,
    const void* qkv_w, const void* qkv_b, const void* o_w, const void* n2s,
    const void* n2b, const void* w_in, const void* w_out, void* y, void* ws,
    const long long* layout, int vec_bf16, int B, int d, int H, int K,
    int hd, int S, int f, int window, int norm_kind, int act, int with_ffn,
    float theta, void* stream, int* launched) {
  using namespace rt::decode;
  using rt::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Word w{static_cast<uint8_t*>(ws), layout};
  auto vec = [&](const void* p, int i) { return Vec{p, (vec_bf16 >> i) & 1}; };
  const bf16* xb = static_cast<const bf16*>(x);
  const int qn = (H + 2 * K) * hd;
  bf16* h1 = w.at<bf16>(L_H1);
  bf16* ob = w.at<bf16>(L_O);
  float* part = w.at<float>(L_PART);

  // 1. norm1, zeroing every counter of the call; the call's first launch
  // waits for all that came before it on the stream
  int err = launch(launched, norm_kernel<0, 0>, dim3(B), NORM_THREADS, 0,
                   false, st, xb, nullptr, 0, nullptr, vec(n1s, 0),
                   vec(n1b, 1), h1, d, norm_kind, w.at<int>(L_CNT),
                   (int)layout[L_N_CNT]);
  if (err != 0) return err;

  // 2. QKV, its f32 partials
  const int sp_qkv = (int)layout[L_SP_QKV];
  Gemm g1 = gemm_args(B, qn, d, sp_qkv, nullptr, w, -1);
  if ((err = gemm<0, QKV>(launched, h1, qkv_w, qn, g1, st)) != 0)
    return err;

  // 3. QKV's sum + bias, RoPE, append, attention split over the positions
  Attn a{};
  a.qkv = part;
  a.qn = qn;
  a.qkv_splits = sp_qkv;
  a.qkv_bias = vec(qkv_b, 4);
  a.ck = static_cast<bf16*>(ck);
  a.cv = static_cast<bf16*>(cv);
  a.cpos = static_cast<int*>(cpos);
  a.pos = static_cast<const int*>(pos);
  a.active = active;
  a.active_i32 = active_i32;
  a.part = w.at<float>(L_ATTN);
  a.counters = w.counters(L_CNT_ATTN);
  a.o = ob;
  a.H = H;
  a.K = K;
  a.hd = hd;
  a.S = S;
  a.window = window;
  a.nsplit = (int)layout[L_ATTN_NSPLIT];
  a.theta = theta;
  a.scale = 1.f / sqrtf((float)hd);
  const int G = H / K;
  auto attn = G <= 1 ? attn_kernel<1> : G <= 2 ? attn_kernel<2>
            : G <= 4 ? attn_kernel<4> : G <= 8 ? attn_kernel<8>
            : attn_kernel<MAXG>;
  err = launch(launched, attn, dim3(a.nsplit, K, B), ATTN_THREADS,
               (int)attn_smem_bytes(G, hd), true, st, a);
  if (err != 0) return err;

  // 4. o-projection, its f32 partials
  const int sp_o = (int)layout[L_SP_O];
  Gemm g3 = gemm_args(B, d, H * hd, sp_o, nullptr, w, -1);
  if ((err = gemm<0, OPROJ>(launched, ob, o_w, d, g3, st)) != 0)
    return err;

  // 5. x1 = x + o (the partials summed per row), then norm2 of x1 (only
  // the residual without the FF: x1 is y)
  bf16* x1 = with_ffn ? w.at<bf16>(L_X1) : static_cast<bf16*>(y);
  bf16* h2 = w.at<bf16>(L_H2);
  err = launch(launched, norm_kernel<0, 1>, dim3(B), NORM_THREADS, 0, true,
               st, xb, static_cast<const float*>(part), sp_o, x1,
               vec(n2s, 2), vec(n2b, 3), h2, d, with_ffn ? norm_kind : 0,
               nullptr, 0);
  if (err != 0 || !with_ffn) return err;

  // 6., 7. FF in, FF out
  return ffn<0>(launched, x1, h2, w_in, w_out, y, w, B, d, f, act, st);
}

// norm2 + FF + residual alone for B rows: y = x + FF(norm(x)).  x (B, d),
// w_in (d, 2f | f), w_out (f, d), y (B, d) bf16; n2s / n2b (d) null, f32
// or bf16 (bits 0, 1 of vec_bf16); ws and its layout as above.  Adds
// one to *launched for each kernel launch it makes.  Returns 0, the
// first failed launch's cudaError_t, or a gemm_sm90.cuh ERR_ code.
extern "C" int fused_ffn_bf16(const void* x, const void* n2s, const void* n2b,
                              const void* w_in, const void* w_out, void* y,
                              void* ws, const long long* layout, int vec_bf16,
                              int B, int d, int f, int norm_kind, int act,
                              void* stream, int* launched) {
  using namespace rt::decode;
  using rt::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Word w{static_cast<uint8_t*>(ws), layout};
  bf16* h2 = w.at<bf16>(L_H2);
  // norm2 is the call's first launch (it zeroes the counters): it waits
  // for all that came before it on the stream
  int err = launch(launched, norm_kernel<1, 0>, dim3(B), NORM_THREADS, 0,
                   false, st, static_cast<const bf16*>(x), nullptr, 0,
                   nullptr, Vec{n2s, vec_bf16 & 1},
                   Vec{n2b, (vec_bf16 >> 1) & 1}, h2, d, norm_kind,
                   w.at<int>(L_CNT), (int)layout[L_N_CNT]);
  if (err != 0) return err;
  return ffn<1>(launched, x, h2, w_in, w_out, y, w, B, d, f, act, st);
}
