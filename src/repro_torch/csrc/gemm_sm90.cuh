// The Hopper GEMM mainloop shared by sr_matmul and outer_accum (bf16
// operands): TMA loads into a multi-stage shared-memory ring guarded by
// mbarriers, wgmma on bf16 with f32 accumulation in registers, and a
// deterministic split-K.
//
// It serves two TPU kernels: repro/kernels/sr_matmul.py::sr_matmul (the
// MAC array: PREFILL, and FF / BP of training) and
// repro/kernels/outer_accum.py::outer_accum (UP, dW = scale * X^T dY).
// Their batched mode over a MoE expert table (the TPU kernels under
// jax.vmap) is gemm_sm90_batched.cuh, built from the pieces here.
// Every role reads its operands where they lie, through the majorness
// template parameters, with no transposed copy:
//
//   A K-major  — FF, BP, PREFILL: A(M, K) row-major;
//   A M-major  — UP: A = X^T for X(T, D) row-major, read through wgmma's
//                transpose bit (16-bit types only);
//   B N-major  — FF (W is (K, N)) and the tied head's BP (the table
//                (V, d) used as (K, N));
//   B K-major  — trans_b: BP of the layers and the tied head's FF.
//
// What bounds each role on the H100, and what the design does:
//
// - PREFILL (M = 32 rows) and the tied head's UP are bound by bytes: the
//   weights (PREFILL) or the SR bits and the bf16 dW (head UP).  One
//   producer warp keeps the ring's TMA loads in flight per block so the
//   copy engine, not the threads, streams the operand; the blocks are
//   persistent (one per SM, walking the output tiles), so the next
//   tile's loads overlap this tile's epilogue; where the output tiles
//   alone cannot fill the 132 SMs (N = 896 is 14 column tiles of 64),
//   the reduction is split.
// - The layer products of training (M = 1024) are bound by the tensor
//   cores: two consumer warpgroups each issue m64nBNk16 wgmma on a
//   128 x BN tile straight from the swizzled shared-memory ring.
// - The tied head's BP (M = 256, N = 896, K = 151936) is bound by
//   reading the 272 MB table; its 7 x 2 output tiles of 128 x 128 need
//   18 splits to stream it from every SM.
//
// Tiles: BM = 128 (two consumer warpgroups of 64 rows), BN = 64 or 128,
// BK = 64 (one 128-byte swizzle row of bf16), a ring of STAGES = 5.
// Every tile is 1024-byte aligned in shared memory with the 128-byte
// swizzle that both the TMA box and the wgmma descriptor name.  The TMA's
// out-of-bounds zero fill handles ragged M, N and K; the store of a
// ragged M / N edge is masked.
//
// Accumulation: wgmma accumulates in f32 registers across the whole
// split; the split bounds each sum's length (the tied head's BP sums
// 151936 terms in 18 splits of about 8.4k).
//
// Split-K: a plan with splits > 1 writes each split's f32 partial tile
// to a workspace [splits, M, N]; splitk_reduce then sums the splits in
// the fixed order 0..splits-1 and applies the scale and the SR
// writeback.  No float atomics: two calls on the same input give the
// same bits, and the split count depends on the plan (N, K, layout),
// never on M, so a row's result does not depend on how many rows share
// the call.
//
// Epilogue: out = acc * scale as f32, or its SR-bf16 bits from the
// caller's rbits (sr_bf16_bits, common.cuh) — the arithmetic of the
// generic WMMA kernels, bit for bit.  All of a tile's SR-bits loads are
// in flight before its first store.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace rt {
namespace sm90 {

constexpr int BM = 128;             // output rows per block
constexpr int BK = 64;              // reduction depth per stage
constexpr int STAGES = 5;           // shared-memory ring depth
constexpr int CONSUMER_WGS = 2;     // consumer warpgroups, 64 rows each
constexpr int CONSUMERS = 128 * CONSUMER_WGS;
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int A_BYTES = BM * BK * 2;      // one A stage (16 KB)
constexpr int MN_BLOCK = 64 * BK * 2;     // one 64-wide MN-major box (8 KB)

// Error codes of the host side (the C entry points return them; every
// other nonzero value is a cudaError_t).
constexpr int ERR_NO_ENCODER = -1;  // cuTensorMapEncodeTiled unavailable
constexpr int ERR_ENCODE = -2;      // a tensor map was refused

template <int BN>
__host__ __device__ constexpr int b_bytes() { return BN * BK * 2; }

template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * (A_BYTES + b_bytes<BN>()) + 2 * STAGES * 8 + 1024;
}

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the phase of `bar` with the given parity has completed.  A
// wait that cannot complete (a fault in the ring's bookkeeping) traps
// after ~2^34 cycles (seconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One 2-D TMA box into shared memory; completion is counted in bytes on
// `bar`.  c0 indexes the innermost (contiguous) dimension.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The same box of matrix c2 of a 3-D map (c2 outermost): the box is
// clipped to that matrix, so it never reads across into the next one.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  For a K-major
// tile (rows of 64 K values, 128 bytes each) the stride between 8-row
// groups is SBO = 1024 and LBO is unused; for an MN-major tile (rows of
// 64 M or N values, one per k) SBO = 1024 is the stride between 8-k
// groups and LBO the stride between 64-wide MN blocks.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register reads or writes of d across
// the asynchronous wgmma boundary.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B for one k16 step of a 64-row slab: da, db shared-memory
// descriptors, TA / TB the transpose bits (1 = MN-major), scale_d 0
// starts a fresh sum.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (BN == 128)
    wgmma_m64n128<TA, TB>(d, da, db, scale_d);
  else
    wgmma_m64n64<TA, TB>(d, da, db, scale_d);
}

// Store the pair (v0, v1) at columns c, c + 1 of element offset o: f32,
// or SR-bf16 bits from rbits.  pair: c + 1 is inside the matrix; vec:
// o is even and the pointers allow 8-byte (f32 / rbits) accesses.
__device__ __forceinline__ void store_pair(void* out,
                                           const uint32_t* __restrict__ rbits,
                                           size_t o, float v0, float v1,
                                           bool pair, int sr, bool vec) {
  if (pair && vec) {
    if (sr) {
      const uint2 r = *reinterpret_cast<const uint2*>(rbits + o);
      const uint32_t lo = sr_bf16_bits(v0, r.x), hi = sr_bf16_bits(v1, r.y);
      *reinterpret_cast<uint32_t*>(reinterpret_cast<uint16_t*>(out) + o) =
          lo | (hi << 16);
    } else {
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) =
          make_float2(v0, v1);
    }
    return;
  }
  store_out(out, rbits, o, v0, sr);
  if (pair) store_out(out, rbits, o + 1, v1, sr);
}

// Tile `tile` of the (grid_x, grid_y, splits) space as (column tile, row
// tile, split).  Column tiles run fastest, so the blocks in flight share
// A's rows; with m_fast the row tiles do (when all of A is small enough
// to stay in L2, every B tile is then read from memory once).
struct TileCoord {
  int x, y, z;
};
__device__ __forceinline__ TileCoord tile_coord(int tile, int grid_x,
                                                int grid_y, int m_fast) {
  const int xy = tile % (grid_x * grid_y), z = tile / (grid_x * grid_y);
  if (m_fast) return {xy / grid_y, xy % grid_y, z};
  return {xy % grid_x, xy / grid_x, z};
}

// out(M, N) = scale * A . B, persistent: block b walks the output tiles
// b, b + gridDim.x, ... of the (grid_x, grid_y, splits) tile space (the
// caller's loop nest, in tile_coord's order), so the producer loads the
// next tile while the consumers store this one.  a_rows (32, 64 or 128)
// is how many rows of an A tile are loaded: a matrix of at most 32 or 64
// rows loads only those (rows past M feed only output rows that are
// never stored, and each output row depends on its own A row alone).
// THREADS threads: warps 0-7 are the two consumer warpgroups, warp 8 the
// producer.
template <int BN, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b,
                const uint32_t* __restrict__ rbits, void* __restrict__ out,
                float* __restrict__ ws, int M, int N, int K, int grid_x,
                int grid_y, int splits, int kb_per_split,
                int m_fast, int a_rows, float scale, int sr, int vec) {
  constexpr int B_BYTES = b_bytes<BN>();
  constexpr int NACC = BN / 2;   // f32 accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = smem;
  uint8_t* sb = smem + STAGES * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * B_BYTES);
  uint64_t* empty = full + STAGES;

  const int k_blocks = (K + BK - 1) / BK;
  const int tiles = grid_x * grid_y * splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // both roles walk the same (tile, k-block) sequence; `it` counts the
  // k-blocks so far, giving the ring stage and the barrier phase
  const int warp = threadIdx.x / 32;
  if (warp == CONSUMER_WGS * 4) {
    // producer: one thread keeps the ring full
    if (threadIdx.x % 32 != 0) return;
    tma_prefetch(&tma_a);
    tma_prefetch(&tma_b);
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const TileCoord tc = tile_coord(tile, grid_x, grid_y, m_fast);
      const int n0 = tc.x * BN, m0 = tc.y * BM;
      const int kb0 = tc.z * kb_per_split;
      const int nk = min(kb_per_split, k_blocks - kb0);
      for (int i = 0; i < nk; ++i, ++it) {
        const int s = it % STAGES, round = it / STAGES;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        uint8_t* a_dst = sa + s * A_BYTES;
        uint8_t* b_dst = sb + s * B_BYTES;
        const int k0 = (kb0 + i) * BK;
        mbar_expect_tx(&full[s], a_rows * BK * 2 + B_BYTES);
        if constexpr (A_MN) {
          for (int j = 0; j < a_rows / 64; ++j)
            tma_load(a_dst + j * MN_BLOCK, &tma_a, &full[s], m0 + 64 * j,
                     k0);
        } else {
          tma_load(a_dst, &tma_a, &full[s], k0, m0);
        }
        if constexpr (B_MN) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(b_dst + j * MN_BLOCK, &tma_b, &full[s], n0 + 64 * j,
                     k0);
        } else {
          tma_load(b_dst, &tma_b, &full[s], k0, n0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of each tile
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileCoord tc = tile_coord(tile, grid_x, grid_y, m_fast);
    const int n0 = tc.x * BN, m0 = tc.y * BM, z = tc.z;
    const int nk = min(kb_per_split, k_blocks - z * kb_per_split);
    const bool active = m0 + 64 * wg < M;
    float acc[NACC];
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

    // one k-block's wgmma group stays in flight while the next is
    // issued; a stage is released once its group has completed
    int pending = -1;
    for (int i = 0; i < nk; ++i, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      if (active) {
        // A: this warpgroup's 64 rows (K-major: 64 rows of 128 bytes;
        // M-major: the wg-th 64-wide box); k16 step kk advances 32 bytes
        // along a K-major row or 16 rows (2048 bytes) of an MN-major box
        const uint32_t a_base = smem_u32(sa + s * A_BYTES) + wg * MN_BLOCK;
        const uint32_t b_base = smem_u32(sb + s * B_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da =
              A_MN ? gmma_desc(a_base + kk * 2048, MN_BLOCK, 1024)
                   : gmma_desc(a_base + kk * 32, 16, 1024);
          const uint64_t db =
              B_MN ? gmma_desc(b_base + kk * 2048, MN_BLOCK, 1024)
                   : gmma_desc(b_base + kk * 32, 16, 1024);
          wgmma_step<BN, A_MN ? 1 : 0, B_MN ? 1 : 0>(
              acc, da, db, (kk > 0 || i > 0) ? 1 : 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
      }
      if (pending >= 0) mbar_arrive(&empty[pending]);
      pending = s;
    }
    if (active) {
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (pending >= 0) mbar_arrive(&empty[pending]);
    if (!active) continue;
    // epilogue straight from the accumulator.  Its layout in m64nBN:
    // element 4j + 2h + e of thread t sits at row
    // 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4) + e.
    const int row0 = m0 + 64 * wg + 16 * (t / 32) + (t % 32) / 4;
    const int col0 = n0 + 2 * (t % 4);
    if (splits > 1) {
      // the raw partial of split z (splitk_reduce scales it)
      float* part_out =
          ws + (size_t)z * M * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h, c = col0 + 8 * j;
          if (r < M && c < N)
            store_pair(part_out, nullptr, (size_t)r * N + c,
                       acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], c + 1 < N,
                       0, vec);
        }
      }
    } else if (sr && vec) {
      // SR from 8-byte rbits pairs: every load of the tile is issued
      // before its first store, so they overlap instead of queueing (the
      // tied head's UP is bound by these bytes)
      uint2 rb[BN / 8][2];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h, c = col0 + 8 * j;
          rb[j][h] = (r < M && c < N)
                         ? __ldg(reinterpret_cast<const uint2*>(
                               rbits + (size_t)r * N + c))
                         : make_uint2(0u, 0u);
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h, c = col0 + 8 * j;
          if (r >= M || c >= N) continue;
          const int e = 4 * j + 2 * h;
          const uint32_t lo = sr_bf16_bits(acc[e] * scale, rb[j][h].x);
          const uint32_t hi = sr_bf16_bits(acc[e + 1] * scale, rb[j][h].y);
          *reinterpret_cast<uint32_t*>(reinterpret_cast<uint16_t*>(out) +
                                       (size_t)r * N + c) =
              lo | (hi << 16);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h, c = col0 + 8 * j;
          if (r < M && c < N)
            store_pair(out, rbits, (size_t)r * N + c,
                       acc[4 * j + 2 * h] * scale,
                       acc[4 * j + 2 * h + 1] * scale, c + 1 < N, sr, vec);
        }
      }
    }
  }
}

// out[i] = scale * (ws[0][i] + ws[1][i] + ... + ws[splits-1][i]), summed
// in that order, as f32 or SR-bf16 bits from rbits.  A_MN only names
// the caller in a profile (sr_matmul false, outer_accum true).
template <bool A_MN>
__global__ void __launch_bounds__(256)
    splitk_reduce(const float* __restrict__ ws,
                  const uint32_t* __restrict__ rbits, void* __restrict__ out,
                  size_t mn, int splits, float scale, int sr) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v += ws[(size_t)s * mn + i];
    store_out(out, rbits, i, v * scale, sr);
  }
}

// ---- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched once through the CUDA runtime
// (the library is not linked against libcuda itself).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int MAX_DEVICES = 64;   // per-device caches below

// The SM count of device `dev` (the persistent grid's size), read once
// per device.
inline int sm_count(int dev) {
  static int n[MAX_DEVICES] = {};
  int c = dev < MAX_DEVICES ? n[dev] : 0;
  if (c == 0) {
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    if (c <= 0) c = 132;
    if (dev < MAX_DEVICES) n[dev] = c;
  }
  return c;
}

// cuTensorMapEncodeTiled needs a current context on the calling thread.
// The runtime makes the primary context current lazily, at a thread's
// first call that needs it; a thread whose first CUDA work is an encode
// has none, and the encode is refused.  PyTorch's autograd worker is
// such a thread when a backward begins with one of these products and
// the caching allocator serves its output without a cudaMalloc (seen on
// the H100: a MoE table's BP refused, the same call on the main thread
// taken).  The device is the one that holds the operand at `base`, not
// the thread's current one (device 0 on a fresh thread): cudaSetDevice
// makes its primary context current whenever this thread has not made
// it current yet or another device is current now.
inline int ensure_context(const void* base) {
  thread_local int made = -1;
  cudaPointerAttributes attr;
  int err = static_cast<int>(cudaPointerGetAttributes(&attr, base));
  if (err != 0) return err;
  int cur = -1;
  err = static_cast<int>(cudaGetDevice(&cur));
  if (err != 0) return err;
  if (made == attr.device && cur == attr.device) return 0;
  err = static_cast<int>(cudaSetDevice(attr.device));
  made = err == 0 ? attr.device : -1;
  return err;
}

// A TMA map of the row-major matrix at `base` (rows x cols of `type`,
// `elem` bytes each, row stride ld elements, ld * elem a multiple of 16)
// with box_cols x box_rows boxes (box_cols * elem = 128 bytes) and the
// 128-byte swizzle; out-of-bounds elements read as zero and are not
// written.  depth > 0: a 3-D map of `depth` such matrices, rows * ld
// elements apart (boxes of one matrix each).  Encoding is pure host work
// of well under a microsecond (chip_smoke.py times it), so every call
// encodes its maps afresh.
inline int encode_map(CUtensorMap* map, const void* base,
                      CUtensorMapDataType type, int elem, int rows, int cols,
                      int ld, int box_cols, int box_rows, int depth = 0) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  if (const int err = ensure_context(base)) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)(depth > 0 ? depth : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * elem,
                                 (cuuint64_t)rows * ld * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, type, depth > 0 ? 3 : 2,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// The same for a bf16 operand, in boxes of BK (one 128-byte row) x
// box_rows.
inline int make_map(CUtensorMap* map, const void* base, int rows, int cols,
                    int ld, int box_rows, int depth = 0) {
  return encode_map(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows,
                    cols, ld, BK, box_rows, depth);
}

// How many rows of an A tile are loaded (see gemm_kernel's a_rows).
template <bool A_MN>
inline int a_box_rows(int M) {
  return M <= 32 && !A_MN ? 32 : M <= 64 ? 64 : BM;
}

// The two TMA maps of one GEMM (operands as in run; depth > 0: 3-D maps
// of `depth` matrices each).  Returns 0 or an ERR_ code.
template <int BN, bool A_MN, bool B_MN>
int make_maps(CUtensorMap* ma, CUtensorMap* mb, const void* a, const void* b,
              int M, int N, int K, int lda, int ldb, int depth = 0) {
  const int err = A_MN ? make_map(ma, a, K, M, lda, 64, depth)
                       : make_map(ma, a, M, K, lda, a_box_rows<A_MN>(M),
                                  depth);
  if (err != 0) return err;
  return B_MN ? make_map(mb, b, K, N, ldb, 64, depth)
              : make_map(mb, b, N, K, ldb, BN, depth);
}

// One GEMM through the mainloop.  A is (M, K) row-major with row stride
// lda (A_MN: A = X^T for X (K, M), row stride lda); B is (K, N) with row
// stride ldb (B_MN) or (N, K) (K-major).  The tile space is
// (grid_x, grid_y, splits) with kb_per_split k-blocks per split, walked
// by min(tiles, SMs) persistent blocks; ws holds splits x M x N f32
// when splits > 1.  Returns 0, a cudaError_t or one of the ERR_ codes.
template <int BN, bool A_MN, bool B_MN>
int run(const void* a, const void* b, const void* rbits, void* out,
        float* ws, int M, int N, int K, int lda, int ldb, float scale,
        int sr, int splits, int kb_per_split, int grid_x, int grid_y,
        cudaStream_t stream) {
  CUtensorMap ma, mb;
  int err = make_maps<BN, A_MN, B_MN>(&ma, &mb, a, b, M, N, K, lda, ldb);
  if (err != 0) return err;
  auto kern = gemm_kernel<BN, A_MN, B_MN>;
  constexpr int smem = smem_bytes<BN>();
  // the shared-memory opt-in is a per-device property of the kernel
  int dev = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  static bool smem_set[MAX_DEVICES] = {};   // per instantiation
  if (dev >= MAX_DEVICES || !smem_set[dev]) {
    err = static_cast<int>(cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kern),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err != 0) return err;
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
  const uint32_t* R = static_cast<const uint32_t*>(rbits);
  const int vec = N % 2 == 0 && ((uintptr_t)rbits & 7u) == 0;
  const int tiles = grid_x * grid_y * splits;
  const int sms = sm_count(dev);
  const int a_rows = a_box_rows<A_MN>(M);
  const int blocks = tiles < sms ? tiles : sms;
  // row tiles fastest when all of A (at most 8 MB) stays in L2
  const int m_fast = grid_y > 1 && (size_t)M * K * 2 <= ((size_t)8 << 20);
  kern<<<blocks, THREADS, smem, stream>>>(ma, mb, R, out, ws, M, N, K,
                                          grid_x, grid_y, splits,
                                          kb_per_split, m_fast, a_rows,
                                          scale, sr, vec);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits <= 1) return err;
  const size_t mn = (size_t)M * N;
  const int rblocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  splitk_reduce<A_MN><<<rblocks, 256, 0, stream>>>(ws, R, out, mn, splits,
                                                   scale, sr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace rt
