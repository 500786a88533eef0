// The f32 GEMM mainloop shared by sr_matmul and outer_accum: f32
// operands (the fp32 precision preset), f32 fmaf on the CUDA cores — no
// TF32, no tensor cores — and a deterministic split-K.
//
// It serves the f32 operands of two TPU kernels:
// repro/kernels/sr_matmul.py::sr_matmul (FF and BP of training under
// fp32) and repro/kernels/outer_accum.py::outer_accum (UP, dW = scale *
// X^T dY).  Every role reads its operands where they lie, through the
// majorness template parameters, with no transposed copy in memory:
//
//   A K-major  — FF, BP: A(M, K) row-major;
//   A M-major  — UP: A = X^T for X(T, D) row-major;
//   B N-major  — FF (W is (K, N)), the tied head's BP (table (V, d)) and
//                UP (dY(T, F));
//   B K-major  — trans_b: BP of the layers and the tied head's FF.
//
// What bounds it on the H100: every f32 product of a training step is
// bound by the CUDA cores' f32 rate (67 TFLOP/s), a hundred or more
// flops per byte.  A SIMT kernel reaches that rate only if each fmaf
// costs well under one shared-memory load and every warp has
// independent work while its loads are in flight.  The design:
//
// - Block tile 128 x 128, BK = 16, 256 threads, two blocks an SM.  Each
//   thread keeps an 8 x 8 tile of the output in registers as 2 x 2
//   sub-tiles of 4 x 4: per k it reads 8 A and 8 B
//   values as four float4 loads from shared memory and issues 64 fmaf.
//   A warp owns a 64 x 32 region, its lanes 8 rows by 4 columns of
//   sub-tiles, so the float4 loads of a quarter warp hit distinct banks
//   or broadcast.
// - Both operands are staged in shared memory as [k][m] and [k][n], rows
//   padded by 4 floats.  An operand already laid out that way (A
//   M-major, B N-major) is copied with 16-byte cp.async (4-byte where
//   its rows are not 16-byte aligned) into a ring of STAGES stages; a
//   K-major operand is read with float4 global loads into registers one
//   tile ahead and transposed on its store to shared memory, while the
//   current tile is computed.  One __syncthreads per 16-deep step.
//   Ragged M, N and K read as zero (cp.async's zero fill; masked loads).
// - Split-K where the output tiles alone cannot fill the card (the tied
//   head's BP: 2 x 7 tiles over K = 151936; the 896-wide layer
//   products).  The split count comes from (M, N, K) alone
//   (kernels/sr_matmul.py::f32_plan), never from the device.  Each split
//   writes its raw partial tile to a workspace; the block that finishes
//   a tile last — it learns so from an integer counter per tile, with no
//   float atomics — sums the partials in split order 0..splits-1 and
//   runs the epilogue.  Two calls give the same bits.
// - Epilogue: out = acc * scale as f32 with float4 stores, or its SR-bf16
//   bits from rbits (sr_bf16_bits, common.cuh) with 8-byte stores: the
//   plain SR cast of the kernel's own f32 result, bit for bit.
// - The batched form (a MoE expert table's E products in one launch)
//   is sgemm_sm90_batched.cuh's, on this file's tile mainloop and
//   epilogue.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace rt {
namespace sgemm {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BK = 16;        // reduction depth per stage
constexpr int NT = 256;       // threads: 8 warps of 64 x 32 outputs
constexpr int STAGES = 4;     // shared-memory ring depth
constexpr int PAD = 4;        // floats of padding per staged row
constexpr int LDA = BM + PAD; // A staged [k][m]
constexpr int LDB = BN + PAD; // B staged [k][n]
constexpr int SMEM_BYTES = STAGES * BK * (LDA + LDB) * 4;

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past `src_bytes` (0..16) read as zero.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; zero when src_bytes is 0.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
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

// ---- operand staging -------------------------------------------------------

// An operand stored [k][mn] (row k at g + k * ld): copy the BK x W tile
// at (k0, mn0) to s[k][mn] (row stride LDS) with cp.async.  vec: g is
// 16-byte aligned and ld % 4 == 0.
template <int W, int LDS, int NT>
__device__ __forceinline__ void copy_mn_tile(float* s,
                                             const float* __restrict__ g,
                                             int ld, int k0, int mn0, int K,
                                             int MN, bool vec) {
  constexpr int CPR = W / 4;   // 16-byte chunks per staged row
#pragma unroll
  for (int j = 0; j < BK * CPR / NT; ++j) {
    const int ch = threadIdx.x + NT * j;
    const int kr = ch / CPR, c = (ch % CPR) * 4;
    const int gk = k0 + kr, gm = mn0 + c;
    float* dst = s + kr * LDS + c;
    const bool row_ok = gk < K;
    if (vec) {
      const int n = row_ok ? max(0, min(4, MN - gm)) : 0;
      cp_async16(dst, n > 0 ? g + (size_t)gk * ld + gm : g, 4 * n);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && gm + e < MN;
        cp_async4(dst + e, ok ? g + (size_t)gk * ld + gm + e : g, ok ? 4 : 0);
      }
    }
  }
}

// An operand stored [mn][k] (row mn at g + mn * ld): the W x BK tile at
// (mn0, k0) in registers, as float4 runs along k (zero outside the
// matrix).  Thread t holds chunks t + NT j: row ch / 4, k (ch % 4) * 4.
// vec: g is 16-byte aligned and ld % 4 == 0.
template <int W, int NT>
struct KTile {
  static constexpr int CH = W * BK / 4 / NT;
  float4 v[CH];

  __device__ __forceinline__ void load(const float* __restrict__ g, int ld,
                                       int mn0, int k0, int MN, int K,
                                       bool vec) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int ch = threadIdx.x + NT * j;
      const int r = mn0 + ch / 4, k = k0 + (ch % 4) * 4;
      const float* p = g + (size_t)r * ld + k;
      if (vec && r < MN && k + 4 <= K) {
        v[j] = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        v[j].x = r < MN && k < K ? __ldg(p) : 0.f;
        v[j].y = r < MN && k + 1 < K ? __ldg(p + 1) : 0.f;
        v[j].z = r < MN && k + 2 < K ? __ldg(p + 2) : 0.f;
        v[j].w = r < MN && k + 3 < K ? __ldg(p + 3) : 0.f;
      }
    }
  }

  // transposed into s[k][mn] (row stride LDS)
  template <int LDS>
  __device__ __forceinline__ void store(float* s) const {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int ch = threadIdx.x + NT * j;
      float* d = s + ((ch % 4) * 4) * LDS + ch / 4;
      d[0] = v[j].x;
      d[LDS] = v[j].y;
      d[2 * LDS] = v[j].z;
      d[3 * LDS] = v[j].w;
    }
  }
};

// Empty stand-in for an operand that takes cp.async.
struct NoTile {
  __device__ __forceinline__ void load(const float*, int, int, int, int, int,
                                       bool) {}
  template <int LDS>
  __device__ __forceinline__ void store(float*) const {}
};

// ---- epilogue --------------------------------------------------------------

// Store 4 values at columns c..c+3 of element offset o: f32, or SR-bf16
// bits from rbits.  n: how many of them lie inside the matrix; vec: o is
// a multiple of 4 and the pointers allow 16-byte (f32, rbits) and
// 8-byte (bf16) accesses.
__device__ __forceinline__ void store4(void* out,
                                       const uint32_t* __restrict__ rbits,
                                       size_t o, float4 v, int n, int sr,
                                       bool vec) {
  if (vec && n == 4) {
    if (sr) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(rbits + o));
      const uint32_t lo = sr_bf16_bits(v.x, r.x) |
                          ((uint32_t)sr_bf16_bits(v.y, r.y) << 16);
      const uint32_t hi = sr_bf16_bits(v.z, r.z) |
                          ((uint32_t)sr_bf16_bits(v.w, r.w) << 16);
      *reinterpret_cast<uint2*>(reinterpret_cast<uint16_t*>(out) + o) =
          make_uint2(lo, hi);
    } else {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + o) = v;
    }
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) store_out(out, rbits, o + i, e[i], sr);
}

__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// ---- one tile ---------------------------------------------------------------

// A tile's place in its product: the operands (one expert's), the tile's
// corner (m0, n0) and its k-blocks kb0 .. kb0 + nk - 1.
struct TileAt {
  const float* a;
  const float* b;
  int m0, n0, kb0, nk;
};

// acc = this thread's 8 x 8 outputs of the BM x BN tile at (at.m0,
// at.n0) of A . B, summed over at's k-blocks through the ring
// (As [STAGES][BK][LDA], Bs [STAGES][BK][LDB]; RA,
// RB: the K-major operands' register tiles, NoTile for an operand that
// takes cp.async).  Warp w owns rows 64 (w % 2) .. + 63 and columns
// 32 (w / 2) .. + 31 of the tile; lane l the 4 x 4 sub-tiles at rows
// + 4 (l / 4) + {0, 32}, columns + 4 (l % 4) + {0, 16}: acc[r][4 h + e]
// sits at row m0 + tile_row(r), column n0 + tile_col(h) + e.  Every
// cp.async of the tile has landed when it returns.
__device__ __forceinline__ int tile_row(int r) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % 2) * 64 + (lane / 4) * 4 + (r % 4) + 32 * (r / 4);
}
__device__ __forceinline__ int tile_col(int h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / 2) * 32 + (lane % 4) * 4 + 16 * h;
}

template <bool A_MN, bool B_MN, class RA, class RB>
__device__ __forceinline__ void tile_product(
    float (&acc)[8][8], float* As, float* Bs, const TileAt& at, int lda,
    int ldb, int M, int N, int K, bool vec_a, bool vec_b) {
  RA ra;
  RB rb;
  auto issue_copies = [&](int i) {   // cp.async of k-block kb0 + i
    const int st = i % STAGES, k0 = (at.kb0 + i) * BK;
    if constexpr (A_MN)
      copy_mn_tile<BM, LDA, NT>(As + st * BK * LDA, at.a, lda, k0, at.m0, K,
                                M, vec_a);
    if constexpr (B_MN)
      copy_mn_tile<BN, LDB, NT>(Bs + st * BK * LDB, at.b, ldb, k0, at.n0, K,
                                N, vec_b);
  };
  auto load_regs = [&](int i) {
    const int k0 = (at.kb0 + i) * BK;
    ra.load(at.a, lda, at.m0, k0, M, K, vec_a);
    rb.load(at.b, ldb, at.n0, k0, N, K, vec_b);
  };
  auto store_regs = [&](int i) {
    const int st = i % STAGES;
    ra.template store<LDA>(As + st * BK * LDA);
    rb.template store<LDB>(Bs + st * BK * LDB);
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < at.nk) issue_copies(i);
    cp_async_commit();
  }
  if (at.nk > 0) {
    load_regs(0);
    store_regs(0);
  }

  const int am = tile_row(0), bn = tile_col(0);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int i = 0; i < at.nk; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < at.nk) issue_copies(i + STAGES - 1);
    cp_async_commit();
    if (i + 1 < at.nk) load_regs(i + 1);
    const float* as = As + (i % STAGES) * BK * LDA + am;
    const float* bs = Bs + (i % STAGES) * BK * LDB + bn;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * LDA);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * LDA + 32);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * LDB);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * LDB + 16);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    if (i + 1 < at.nk) store_regs(i + 1);
  }
  cp_async_wait<0>();
}

// The tile's output: out[eo + gm * N + gn] = acc * scale (f32, or SR-bf16
// bits from rbits at the same offset); with splits > 1 the raw partial
// of split z into ws instead (splits x E x M x N partials, expert e's at
// e x M x N, then the tile counters), and the block that finishes the
// tile last (counter `ctr`, as it learns from an integer atomic, with no
// float atomics) sums every split's partial in split order 0..splits-1
// and writes the output.  is_last: an int in shared memory.
__device__ __forceinline__ void tile_epilogue(
    const float (&acc)[8][8], void* out, const uint32_t* __restrict__ rbits,
    float* __restrict__ ws, int* is_last, int M, int N, int m0, int n0,
    int z, int e, int E, int splits, int ctr, float scale, int sr,
    bool vec_out) {
  const size_t eo = (size_t)e * M * N;   // this expert's output block
  const bool split = splits > 1;
  float* part = split ? ws + ((size_t)z * E + e) * M * N : nullptr;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gm = m0 + tile_row(r);
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + tile_col(h);
      if (gn >= N) continue;
      const float4 v = make_float4(acc[r][4 * h], acc[r][4 * h + 1],
                                   acc[r][4 * h + 2], acc[r][4 * h + 3]);
      const size_t o = (size_t)gm * N + gn;
      if (split)
        store4(part, nullptr, o, v, min(4, N - gn), 0, vec_out);
      else
        store4(out, rbits, eo + o, scaled(v, scale), min(4, N - gn), sr,
               vec_out);
    }
  }
  if (!split) return;

  // the last block of the tile sums every split's partial, in order
  int* counters = reinterpret_cast<int*>(ws + (size_t)splits * E * M * N);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *is_last = atomicAdd(&counters[ctr], 1) == splits - 1;
  __syncthreads();
  if (!*is_last) return;
  __threadfence();
  const size_t sstride = (size_t)E * M * N;   // split s's partials at s * it
  const float* wp = ws + eo;                  // this expert's split-0 partial
  for (int q = threadIdx.x; q < BM * BN / 4; q += NT) {
    const int gm = m0 + q / (BN / 4), gn = n0 + (q % (BN / 4)) * 4;
    if (gm >= M || gn >= N) continue;
    const size_t o = (size_t)gm * N + gn;
    const int n = min(4, N - gn);
    float4 v;
    if (vec_out) {
      v = __ldcg(reinterpret_cast<const float4*>(wp + o));
      for (int s = 1; s < splits; ++s) {
        const float4 u =
            __ldcg(reinterpret_cast<const float4*>(wp + s * sstride + o));
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
    } else {
      float e4[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < n; ++c) {
        e4[c] = __ldcg(wp + o + c);
        for (int s = 1; s < splits; ++s)
          e4[c] += __ldcg(wp + s * sstride + o + c);
      }
      v = make_float4(e4[0], e4[1], e4[2], e4[3]);
    }
    store4(out, rbits, eo + o, scaled(v, scale), n, sr, vec_out);
  }
}

// ---- the kernel ------------------------------------------------------------

// out(M, N) = scale * A . B (see the header for the layouts), over the
// tile space (grid_x column tiles, grid_y row tiles, splits); block
// (x, y, z) computes tile (x, y) over k-blocks z * kb_per_split onward.
// With m_fast the row tiles of one column tile are neighbours in launch
// order (B's tile is then read from memory once while A stays in L2).
// ws: splits x M x N f32 partials, then grid_x * grid_y int32 counters,
// zeroed by the caller (splits > 1 only).
template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(NT, 2)
    sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 const uint32_t* __restrict__ rbits, void* __restrict__ out,
                 float* __restrict__ ws, int M, int N, int K, int lda,
                 int ldb, int grid_x, int grid_y, int splits,
                 int kb_per_split, int m_fast, float scale, int sr,
                 int vec_a, int vec_b, int vec_out) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // [STAGES][BK][LDA]
  float* Bs = As + STAGES * BK * LDA;            // [STAGES][BK][LDB]
  __shared__ int is_last;

  int tx = blockIdx.x, ty = blockIdx.y;
  if (m_fast) {
    const int t = blockIdx.y * gridDim.x + blockIdx.x;
    tx = t / grid_y;
    ty = t % grid_y;
  }
  const int z = blockIdx.z;
  const int k_blocks = (K + BK - 1) / BK;
  const int kb0 = z * kb_per_split;
  const int nk = max(0, min(kb_per_split, k_blocks - kb0));
  // the K-major operands' register tiles (one tile ahead)
  using ATile = typename std::conditional<A_MN, NoTile, KTile<BM, NT>>::type;
  using BTile = typename std::conditional<B_MN, NoTile, KTile<BN, NT>>::type;
  float acc[8][8];
  const TileAt at{A, B, ty * BM, tx * BN, kb0, nk};
  tile_product<A_MN, B_MN, ATile, BTile>(acc, As, Bs, at, lda, ldb, M, N, K,
                                         vec_a, vec_b);
  tile_epilogue(acc, out, rbits, ws, &is_last, M, N, ty * BM, tx * BN, z, 0,
                1, splits, ty * grid_x + tx, scale, sr, vec_out);
}

// ---- host side -------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

// One f32 GEMM.  A is (M, K) row-major with row stride lda (A_MN: A =
// X^T for X (K, M), row stride lda); B is (K, N) with row stride ldb
// (B_MN) or (N, K).  The tile space (grid_x, grid_y, splits) and
// kb_per_split come from the caller's plan; ws as sgemm_kernel's.
// Returns 0 or a cudaError_t.
template <bool A_MN, bool B_MN>
int run(const float* a, const float* b, const void* rbits, void* out,
        float* ws, int M, int N, int K, int lda, int ldb, float scale,
        int sr, int splits, int kb_per_split, int grid_x, int grid_y,
        cudaStream_t stream) {
  auto kern = sgemm_kernel<A_MN, B_MN>;
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  static bool smem_set[MAX_DEVICES] = {};   // per instantiation
  if (dev >= MAX_DEVICES || !smem_set[dev]) {
    err = static_cast<int>(cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kern),
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
    if (err != 0) return err;
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
  const int vec_a = aligned16(a) && lda % 4 == 0;
  const int vec_b = aligned16(b) && ldb % 4 == 0;
  const int vec_out = N % 4 == 0 && aligned16(out) && aligned16(rbits) &&
                      aligned16(ws);
  // row tiles fastest when all of A (at most 8 MB) stays in L2
  const int m_fast = grid_y > 1 && (size_t)M * K * 4 <= ((size_t)8 << 20);
  kern<<<dim3(grid_x, grid_y, splits), NT, SMEM_BYTES, stream>>>(
      a, b, static_cast<const uint32_t*>(rbits), out, ws, M, N, K, lda, ldb,
      grid_x, grid_y, splits, kb_per_split, m_fast, scale, sr, vec_a, vec_b,
      vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgemm
}  // namespace rt
