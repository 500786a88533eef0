// The BATCHED form of the Hopper GEMM (gemm_sm90.cuh's building blocks):
// a MoE expert table's product over all E experts in ONE launch, the
// TPU kernels sr_matmul and outer_accum under jax.vmap (one pallas_call
// with an expert axis in its grid; repro/engine/dispatch.py:198-199,
// :220-229).
//
//   K-major A (sr_matmul_batched): out[e] (M, N) = A[e] (M, K) . B[e] —
//     PREFILL, FF, BP (B (E, K, N) N-major, or (E, N, K) with trans_b);
//   M-major A (outer_accum_batched): dW[e] (D, F) = scale X[e]^T dY[e]
//     for X (E, T, D), dY (E, T, F) — UP, read through wgmma's transpose
//     bit (A = X^T never exists in memory).
//
// What bounds it on the H100, and what the design does:
//
// - Live rows.  A dropless MoE buffer gives every expert C = T rows
//   (granite training: C = 1024, about 256 of them real); the rows past
//   an expert's kept count are zero.  The caller passes that count,
//   rows[e] (int32 on the device, read by every block into shared
//   memory; null: every row live).  FF, BP and PREFILL walk only the row
//   tiles with m0 < rows[e] through TMA and wgmma: the persistent blocks
//   take the live tiles of all experts first, numbered through a prefix
//   over the per-expert tile counts (so the SMs share them evenly), then
//   write zeros over each expert's dead row tiles with plain 16-byte
//   stores (no TMA load, no wgmma; the output is every element of
//   (E, M, N), and a dead row must read 0, never garbage that silu or
//   the UP's partial token blocks would turn into NaN).  The UP's
//   reduction runs over the tokens, so each tile's k-loop stops at
//   ceil(rows[e] / BK) token blocks (the split bounds stay over T: a
//   split past the count adds zeros, and the plan, hence the SR bits,
//   depends on the shape alone).  The result is still exactly A[e].B[e]
//   when those rows are zero: a skipped block of +0 products can only
//   change the sign of a zero sum.
// - The output leaves once, in the caller's dtype.  FF, BP and PREFILL
//   write f32 or bf16 (rounded to nearest even from the f32
//   accumulator, bit for bit the f32 result's .to(bfloat16)); the UP
//   f32, or bf16 with SR from the caller's bits.  Granite's FF / BP are
//   bound by bytes once the dead rows go: the weights, the live rows of
//   A and the bf16 out.
// - The epilogue runs beside the tensor cores.  Each consumer warpgroup
//   writes its 64 rows of the tile into its own shared-memory staging
//   buffer in the TMA's 128-byte swizzle (conflict-free for the
//   accumulator's fragment layout), and one thread sends them out as
//   TMA stores through a 3-D map over (E, M, N), whose box clips to the
//   expert; the warpgroup then goes on to the next tile's wgmma while
//   the store drains (it waits for the store to have read the buffer
//   only before it writes the buffer again).  The UP's SR bits arrive
//   by TMA too: the producer loads the tile's (BM, BN) box of bits into
//   shared memory during the tile's mainloop, and the consumers read
//   them into registers first thing in the epilogue and give the buffer
//   back, so the next tile's bits load during this tile's rounding and
//   stores and the next mainloop.  Measured slower on granite's UP: a
//   TMA prefetch of the next tile's bits into L2; two buffers of bits
//   (the ring cut to three stages: the UP's mainloop is bound by its
//   loads from L2 and needs the stages); the bits loaded from device
//   memory straight into registers; the staging written over the bits
//   (five stages).  One block runs per SM; the two consumer warpgroups
//   share a 128-row tile (cooperative, not ping-pong: a ping-pong
//   schedule needs a second accumulator or half-height tiles, which
//   re-read B from L2 twice as often).
//
// Shared memory (the budget, 232448 bytes a block): the ring (5 stages
// of 32 KB at BN 128; 4 for the SR UP), the out staging (BM x BN of the
// out dtype: 32 KB bf16, 64 KB f32), the SR bits (BM x BN uint32, 64 KB,
// SR only), the barriers and the per-expert table (MAX_EXPERTS + 1
// ints).  The largest, f32 out at BN 128, takes 231524 bytes.
//
// Split-K (plans with splits > 1, small tables with a long reduction)
// writes raw f32 partials to ws [splits, E, M, N] from registers;
// splitk_reduce_batched then sums them in split order, applies the scale
// and writes the out dtype (zeros over the dead row tiles, which the
// K-major kernel does not visit under a split).  No float atomics: two
// calls give the same bits.
#pragma once

#include "gemm_sm90.cuh"

namespace rt {
namespace sm90 {

// the output's kind: f32, bf16 rounded to nearest even, bf16 with SR
constexpr int OUT_F32 = 0, OUT_BF16 = 1, OUT_SR = 2;
constexpr int MAX_EXPERTS = 256;     // the per-expert table's size
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may use
constexpr int BOX_BYTES = 64 * 128;  // one staged box: 64 rows of 128 bytes

template <int OUT>
__host__ __device__ constexpr int out_bytes() {
  return OUT == OUT_F32 ? 4 : 2;
}
template <int OUT>
__host__ __device__ constexpr int ring_stages() {
  return OUT == OUT_SR ? 4 : STAGES;
}
// the ring, the out staging, the SR bits, the barriers, the per-expert
// table, the alignment slack
template <int BN, int OUT>
__host__ __device__ constexpr int batched_smem_bytes() {
  return ring_stages<OUT>() * (A_BYTES + b_bytes<BN>()) +
         BM * BN * out_bytes<OUT>() + (OUT == OUT_SR ? BM * BN * 4 : 0) +
         (2 * ring_stages<OUT>() + 2) * 8 + (MAX_EXPERTS + 1) * 4 + 1024;
}
static_assert(batched_smem_bytes<128, OUT_F32>() <= SMEM_LIMIT,
              "f32 staging does not fit beside the ring");
static_assert(batched_smem_bytes<128, OUT_SR>() <= SMEM_LIMIT,
              "SR bits and staging do not fit beside the ring");

// ---- PTX wrappers: TMA stores, bulk groups, named barriers -----------------

// A box of shared memory to (c0, c1) of matrix c2 of a 3-D map;
// completion is tracked by this thread's bulk groups.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// this thread's stores have read their shared memory (it may be rewritten)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// this thread's stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// the generic proxy's shared-memory writes become visible to the TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// a barrier over one consumer warpgroup (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// Byte offset of byte b of row r in a staged tile: 128-byte rows, 64 to a
// box, boxes side by side along the row (b / 128), each in the 128-byte
// swizzle the TMA map names (16-byte chunk index XOR row % 8).
__device__ __forceinline__ uint32_t swizzled(int r, int b) {
  return (b >> 7) * BOX_BYTES + r * 128 +
         ((((b & 127) >> 4) ^ (r & 7)) << 4) + (b & 15);
}

// One tile of the batched walk: column tile x, row tile y, split z of
// expert e; nk k-blocks from kb0; dead: a K-major row tile past the
// expert's live rows (zeros, no loads).
struct BTile {
  int x, y, z, e, kb0, nk;
  bool dead;
};

// Tile `tile` of the walk.  K-major (tab: the prefix of live tiles,
// tab[experts] their total): the live tiles of every expert, each
// expert's (x, y, z) in tile_coord's order over its live row tiles,
// then (splits == 1) every expert's dead row tiles, x fastest.  M-major
// (tab: each expert's live k-blocks): every tile of tile_coord's space
// with the expert outermost, its k-loop cut at the live k-blocks.
template <bool A_MN>
__device__ __forceinline__ BTile batched_tile(const int* tab, int tile,
                                              int grid_x, int grid_y,
                                              int splits, int experts,
                                              int k_blocks, int kb_per_split,
                                              int m_fast) {
  BTile b;
  b.dead = false;
  if constexpr (A_MN) {
    const int per_e = grid_x * grid_y * splits;
    b.e = tile / per_e;
    const TileCoord tc = tile_coord(tile % per_e, grid_x, grid_y, m_fast);
    b.x = tc.x;
    b.y = tc.y;
    b.z = tc.z;
    b.kb0 = b.z * kb_per_split;
    b.nk = max(0, min(kb_per_split, tab[b.e] - b.kb0));
    return b;
  } else {
    const int live = tab[experts];
    if (tile < live) {
      b.e = last_at_most(experts, tile, [&](int e) { return tab[e]; });
      const int ly = (tab[b.e + 1] - tab[b.e]) / (grid_x * splits);
      const TileCoord tc = tile_coord(tile - tab[b.e], grid_x, ly, m_fast);
      b.x = tc.x;
      b.y = tc.y;
      b.z = tc.z;
      b.kb0 = b.z * kb_per_split;
      b.nk = min(kb_per_split, k_blocks - b.kb0);
      return b;
    }
    // dead tiles before expert e's: e * grid_x * grid_y - tab[e]
    const int d = tile - live, g = grid_x * grid_y;
    b.e = last_at_most(experts, d, [&](int e) { return e * g - tab[e]; });
    const int local = d - (b.e * g - tab[b.e]);
    b.y = (tab[b.e + 1] - tab[b.e]) / grid_x + local / grid_x;
    b.x = local % grid_x;
    b.z = b.kb0 = b.nk = 0;
    b.dead = true;
    return b;
  }
}

// out = A . B over the experts' live rows, persistent: block b walks the
// tiles b, b + gridDim.x, ... of batched_tile's order, the producer
// loading the next tile while the consumers finish this one.  tma_a,
// tma_b: the operands' 3-D maps; tma_out: out (E, M, N) in the OUT
// dtype (boxes of 64 rows x 128 bytes, 128-byte swizzle); tma_bits: the
// SR bits (E, M, N) uint32 (OUT_SR); neither is read under a split,
// which writes ws instead.  rows: (experts,) int32 or null.  THREADS
// threads: warps 0-7 the two consumer warpgroups, warp 8 the producer.
template <int BN, bool A_MN, bool B_MN, int OUT>
__global__ void __launch_bounds__(THREADS, 1)
    batched_kernel(const __grid_constant__ CUtensorMap tma_a,
                   const __grid_constant__ CUtensorMap tma_b,
                   const __grid_constant__ CUtensorMap tma_out,
                   const __grid_constant__ CUtensorMap tma_bits,
                   const int* __restrict__ rows, void* __restrict__ out,
                   float* __restrict__ ws, int M, int N, int K, int grid_x,
                   int grid_y, int splits, int experts, int kb_per_split,
                   int m_fast, int a_rows, float scale) {
  constexpr int S = ring_stages<OUT>();
  constexpr int B_BYTES = b_bytes<BN>();
  constexpr int NACC = BN / 2;
  constexpr int OB = out_bytes<OUT>();
  constexpr bool SR = OUT == OUT_SR;
  constexpr int HALF_OUT = 64 * BN * OB;   // one warpgroup's staged rows
  constexpr int HALF_BITS = 64 * BN * 4;   // one warpgroup's SR bits
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = smem;
  uint8_t* sb = sa + S * A_BYTES;
  uint8_t* so = sb + S * B_BYTES;   // the out staging, two warpgroup halves
  uint8_t* sbits = so + 2 * HALF_OUT;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(sbits + (SR ? 2 * HALF_BITS : 0));
  uint64_t* empty = full + S;
  uint64_t* bits_full = empty + S;
  uint64_t* bits_empty = bits_full + 1;
  int* tab = reinterpret_cast<int*>(bits_empty + 1);

  const int k_blocks = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(bits_full, 1);
    mbar_init(bits_empty, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the per-expert table, from rows (null: every row live)
  if constexpr (A_MN) {
    for (int e = threadIdx.x; e < experts; e += blockDim.x) {
      const int r = rows ? min(max(rows[e], 0), K) : K;
      tab[e] = (r + BK - 1) / BK;
    }
  } else if (warp == 0) {
    // warp 0 scans the live tile counts: 8 experts a lane
    constexpr int PER = MAX_EXPERTS / 32;
    const int lane = threadIdx.x, per_y = grid_x * splits;
    int v[PER], sum = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = lane * PER + j;
      const int r = e < experts ? (rows ? min(max(rows[e], 0), M) : M) : 0;
      v[j] = min(grid_y, (r + BM - 1) / BM) * per_y;
      sum += v[j];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += n;
    }
    int run = incl - sum;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = lane * PER + j;
      if (e < experts) tab[e] = run;
      run += v[j];
    }
    if (lane == 31) tab[experts] = incl;
  }
  __syncthreads();

  // the UP visits every tile; K-major the live ones, and without a split
  // the dead ones after them
  const int tiles = A_MN ? grid_x * grid_y * splits * experts
                    : splits > 1 ? tab[experts]
                                 : grid_x * grid_y * experts;
  auto tile_at = [&](int tile) {
    return batched_tile<A_MN>(tab, tile, grid_x, grid_y, splits, experts,
                              k_blocks, kb_per_split, m_fast);
  };
  const bool staged = splits == 1;   // the TMA-store epilogue (no split)

  // both roles walk the same (tile, k-block) sequence; `it` counts the
  // k-blocks so far (the ring stage and its phase), `bt` the SR tiles
  // (the bits buffer's phase)
  if (warp == CONSUMER_WGS * 4) {
    // producer: one thread keeps the ring full
    if (threadIdx.x % 32 != 0) return;
    tma_prefetch(&tma_a);
    tma_prefetch(&tma_b);
    if (SR && staged) tma_prefetch(&tma_bits);
    int it = 0, bt = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const BTile tc = tile_at(tile);
      if (tc.dead) continue;
      const int n0 = tc.x * BN, m0 = tc.y * BM;
      // the tile's bits: once its first loads are in flight (or at
      // once, for an expert with no live token block), after the
      // consumers have read the last tile's; its 64-row halves inside
      // M, its 32-column boxes inside N
      auto load_bits = [&]() {
        if (bt > 0) mbar_wait(bits_empty, (bt - 1) & 1);
        const int halves = m0 + 64 < M ? 2 : 1;
        const int cols = min(BN / 32, (N - n0 + 31) / 32);
        mbar_expect_tx(bits_full, halves * cols * BOX_BYTES);
        for (int h = 0; h < halves; ++h)
          for (int j = 0; j < cols; ++j)
            tma_load_3d(sbits + h * HALF_BITS + j * BOX_BYTES, &tma_bits,
                        bits_full, n0 + 32 * j, m0 + 64 * h, tc.e);
        ++bt;
      };
      const int bits_at = min(tc.nk, S) - 1;
      if (SR && staged && tc.nk == 0) load_bits();
      for (int i = 0; i < tc.nk; ++i, ++it) {
        const int s = it % S, round = it / S;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        uint8_t* a_dst = sa + s * A_BYTES;
        uint8_t* b_dst = sb + s * B_BYTES;
        const int k0 = (tc.kb0 + i) * BK;
        mbar_expect_tx(&full[s], a_rows * BK * 2 + B_BYTES);
        if constexpr (A_MN) {
          for (int j = 0; j < a_rows / 64; ++j)
            tma_load_3d(a_dst + j * MN_BLOCK, &tma_a, &full[s], m0 + 64 * j,
                        k0, tc.e);
        } else {
          tma_load_3d(a_dst, &tma_a, &full[s], k0, m0, tc.e);
        }
        if constexpr (B_MN) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_3d(b_dst + j * MN_BLOCK, &tma_b, &full[s], n0 + 64 * j,
                        k0, tc.e);
        } else {
          tma_load_3d(b_dst, &tma_b, &full[s], k0, n0, tc.e);
        }
        if (SR && staged && i == bits_at) load_bits();
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of each tile
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  // this thread's accumulator rows and columns (m64nBN layout: element
  // 4j + 2h + e sits at row 16 (t / 32) + (t % 32) / 4 + 8 h, column
  // 8 j + 2 (t % 4) + e of the warpgroup's 64 x BN)
  const int lrow = 16 * (t / 32) + (t % 32) / 4;
  const int lcol = 2 * (t % 4);
  uint8_t* stage = so + wg * HALF_OUT;
  int it = 0, bt = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const BTile tc = tile_at(tile);
    const int n0 = tc.x * BN, m0 = tc.y * BM;
    const int r0 = m0 + 64 * wg;
    const bool active = r0 < M;
    if (tc.dead) {
      // zeros over this warpgroup's rows of a dead tile, 16 bytes a store
      constexpr int CH = 16 / OB, CPR = BN / CH;
      if (active)
        for (int i = t; i < 64 * CPR; i += 128) {
          const int r = r0 + i / CPR, c = n0 + (i % CPR) * CH;
          if (r < M && c < N)
            *reinterpret_cast<uint4*>(
                static_cast<uint8_t*>(out) +
                ((size_t)tc.e * M * N + (size_t)r * N + c) * OB) =
                make_uint4(0u, 0u, 0u, 0u);
        }
      continue;
    }
    float acc[NACC];
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

    // one k-block's wgmma group stays in flight while the next is
    // issued; a stage is released once its group has completed
    int pending = -1;
    for (int i = 0; i < tc.nk; ++i, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      if (active) {
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

    if (!staged) {
      // the raw partial of split z (splitk_reduce_batched scales it)
      if (!active) continue;
      float* part = ws + ((size_t)tc.z * experts + tc.e) * M * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + lrow + 8 * h, c = n0 + 8 * j + lcol;
          if (r < M && c < N)
            *reinterpret_cast<float2*>(part + (size_t)r * N + c) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      continue;
    }

    // the staged tile leaves by TMA stores (box by box, each inside N)
    auto store_tile = [&](const uint8_t* src) {
      constexpr int BOX_COLS = 128 / OB;
#pragma unroll
      for (int j = 0; j < BN / BOX_COLS; ++j)
        if (n0 + j * BOX_COLS < N)
          tma_store_3d(&tma_out, src + j * BOX_BYTES, n0 + j * BOX_COLS, r0,
                       tc.e);
      bulk_commit();
    };
    // SR: this thread's bits into registers, then the buffer goes back
    // to the producer for the next tile's
    uint2 rb[SR ? BN / 8 : 1][2];
    if constexpr (SR) {
      mbar_wait(bits_full, bt & 1);
      ++bt;
      if (active) {
        const uint8_t* bits = sbits + wg * HALF_BITS;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            rb[j][h] = *reinterpret_cast<const uint2*>(
                bits + swizzled(lrow + 8 * h, (8 * j + lcol) * 4));
      }
      mbar_arrive(bits_empty);
    }
    if (!active) continue;
    // the staging buffer is free once this warpgroup's last store has
    // read it
    if (t == 0) bulk_wait_read();
    wg_sync(1 + wg);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = acc[4 * j + 2 * h] * scale;
        const float v1 = acc[4 * j + 2 * h + 1] * scale;
        uint8_t* dst = stage + swizzled(lrow + 8 * h, (8 * j + lcol) * OB);
        if constexpr (OUT == OUT_F32)
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        else if constexpr (OUT == OUT_BF16)
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(dst) =
              (uint32_t)sr_bf16_bits(v0, rb[j][h].x) |
              ((uint32_t)sr_bf16_bits(v1, rb[j][h].y) << 16);
      }
    }
    fence_proxy_async();
    wg_sync(1 + wg);
    if (t == 0) store_tile(stage);
  }
  if (t == 0) bulk_wait();
}

// out[i] = scale * (ws[0][i] + ... + ws[splits-1][i]) over (E, M, N),
// summed in that order, in the OUT dtype (SR from rbits).  rows
// (K-major only; null otherwise): the elements past an expert's live
// row tiles, which the split kernel did not visit, are 0.  A_MN only
// names the caller in a profile (sr_matmul false, outer_accum true).
template <bool A_MN, int OUT>
__global__ void __launch_bounds__(256)
    splitk_reduce_batched(const float* __restrict__ ws,
                          const uint32_t* __restrict__ rbits,
                          void* __restrict__ out,
                          const int* __restrict__ rows, size_t mn, int M,
                          int N, int splits, float scale) {
  const size_t per = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    bool live = true;
    if (rows != nullptr) {
      const int r = (int)((i % per) / N);
      const int n = min(max(rows[i / per], 0), M);
      live = r < (n + BM - 1) / BM * BM;
    }
    float v = 0.f;
    if (live) {
      v = ws[i];
      for (int s = 1; s < splits; ++s) v += ws[(size_t)s * mn + i];
    }
    v *= scale;
    if constexpr (OUT == OUT_F32)
      reinterpret_cast<float*>(out)[i] = v;
    else if constexpr (OUT == OUT_BF16)
      reinterpret_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);
    else
      reinterpret_cast<uint16_t*>(out)[i] = sr_bf16_bits(v, rbits[i]);
  }
}

// ---- host side -------------------------------------------------------------

// A batched call's plan against its shape (cudaErrorInvalidValue from
// the C entries otherwise): E experts of (M, N, K) with N a multiple of
// 8 (16-byte rows of out and of B, for the TMA), bn 64 or 128,
// the grid of one expert's tiles, splits x kb_per_split covering K's
// blocks with none empty, and ws for a split.
inline bool batched_plan_ok(int E, int M, int N, int K, int bn, int splits,
                            int kb_per_split, int grid_x, int grid_y,
                            const void* ws) {
  const int k_blocks = (K + BK - 1) / BK;
  return E >= 1 && E <= MAX_EXPERTS && M >= 1 && N >= 1 && K >= 1 &&
         N % 8 == 0 && (bn == 64 || bn == 128) &&
         grid_x == (N + bn - 1) / bn && grid_y == (M + BM - 1) / BM &&
         splits >= 1 && kb_per_split >= 1 &&
         (long long)splits * kb_per_split >= k_blocks &&
         (long long)(splits - 1) * kb_per_split < k_blocks &&
         (splits == 1 || ws != nullptr);
}

// One batched product (see batched_kernel): a, b the operands as 3-D
// stacks (A_MN: X (E, K, M); else A (E, M, K); B (E, K, N) with B_MN,
// else (E, N, K)), out (E, M, N) in the OUT dtype, rbits (E, M, N)
// uint32 (OUT_SR), rows (E,) int32 or null, ws splits x E x M x N f32
// for a split.  The plan as batched_plan_ok checks it.  Returns 0, a
// cudaError_t or one of the ERR_ codes.
template <int BN, bool A_MN, bool B_MN, int OUT>
int run_batched(const void* a, const void* b, const void* rbits, void* out,
                float* ws, const int* rows, int M, int N, int K, float scale,
                int splits, int kb_per_split, int grid_x, int grid_y,
                cudaStream_t stream, int experts) {
  CUtensorMap ma, mb, mo, mr;
  int err = make_maps<BN, A_MN, B_MN>(&ma, &mb, a, b, M, N, K, A_MN ? M : K,
                                      B_MN ? N : K, experts);
  if (err != 0) return err;
  mo = mr = ma;   // placeholders: a split reads neither
  if (splits == 1) {
    err = OUT == OUT_F32
              ? encode_map(&mo, out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M,
                           N, N, 32, 64, experts)
              : encode_map(&mo, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M,
                           N, N, 64, 64, experts);
    if (err == 0 && OUT == OUT_SR)
      err = encode_map(&mr, rbits, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, M, N,
                       N, 32, 64, experts);
    if (err != 0) return err;
  }
  auto kern = batched_kernel<BN, A_MN, B_MN, OUT>;
  constexpr int smem = batched_smem_bytes<BN, OUT>();
  int dev = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  // the kernel whose shared-memory opt-in is set, per device: keyed by
  // its stub, because a template's function-local static is one object
  // in every library of the process that instantiates it (GNU unique
  // symbols), while each library registers its own kernel
  // (launch/ablate_experts.py loads several builds of this kernel)
  static const void* smem_set[MAX_DEVICES] = {};
  const void* fn = reinterpret_cast<const void*>(kern);
  if (dev >= MAX_DEVICES || smem_set[dev] != fn) {
    err = static_cast<int>(cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err != 0) return err;
    if (dev < MAX_DEVICES) smem_set[dev] = fn;
  }
  const int tiles = grid_x * grid_y * splits * experts;   // at most
  const int sms = sm_count(dev);
  const int blocks = tiles < sms ? tiles : sms;
  // row tiles fastest when one expert's A (at most 8 MB) stays in L2
  const int m_fast = grid_y > 1 && (size_t)M * K * 2 <= ((size_t)8 << 20);
  kern<<<blocks, THREADS, smem, stream>>>(
      ma, mb, mo, mr, rows, out, ws, M, N, K, grid_x, grid_y, splits,
      experts, kb_per_split, m_fast, a_box_rows<A_MN>(M), scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits <= 1) return err;
  const size_t mn = (size_t)experts * M * N;
  const int rblocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  splitk_reduce_batched<A_MN, OUT><<<rblocks, 256, 0, stream>>>(
      ws, static_cast<const uint32_t*>(rbits), out, A_MN ? nullptr : rows,
      mn, M, N, splits, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace rt
