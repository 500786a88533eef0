// The BATCHED form of the f32 GEMM (sgemm_sm90.cuh's tile mainloop and
// epilogue): a MoE expert table's product over all E experts in ONE
// launch for f32 operands (the fp32 preset), the TPU kernels sr_matmul
// and outer_accum under jax.vmap (one pallas_call with an expert axis in
// its grid; repro/engine/dispatch.py:199, :220-225):
//
//   A K-major (sr_matmul_batched_f32): out[e] (M, N) = A[e] (M, K) . B[e]
//     — FF (B (E, K, N) N-major) and BP (trans_b: B (E, N, K) K-major);
//   A M-major (outer_accum_batched_f32): dW[e] (D, F) = scale X[e]^T dY[e]
//     for X (E, T, D), dY (E, T, F) — UP (A = X^T never exists in memory:
//     X's rows are staged as they lie).
//
// The fp32 preset's arithmetic: f32 fmaf on the CUDA cores, no TF32 and
// no tensor cores.  Each output element is one fmaf chain over its
// split's k in order, whatever tile, unit or block computes it, so the
// walk below can follow the data without changing a bit.
//
// What bounds it on the H100, and what the design does:
//
// - Live rows.  A dropless MoE buffer gives every expert C = T rows
//   (granite training: C = 1024, about 256 of them real); the rows past
//   an expert's kept count are zero.  The caller passes that count,
//   rows[e] (int32 on the device; null: every row live).  FF and BP compute only the row tiles with
//   m0 < rows[e] and write zeros over the rest (the output is every
//   element of (E, M, N), which the caller allocates uninitialised; a
//   dead row must read 0).  The UP's reduction runs over the tokens, so
//   each tile's k-loop stops at ceil(rows[e] / BK) k-blocks (the split
//   bounds stay over T: a split past the count adds nothing, and the
//   plan depends on the shape alone).  The result is exactly the all-live
//   kernel's when those rows are zero: a skipped block of +0 products can
//   only change the sign of a zero sum.
// - Balance without a host sync.  The live work lies on the device, so
//   the grid holds a block for every unit an all-live call could have
//   (the shape alone).  Every block reads rows into shared memory and
//   numbers the units of all experts the same way (batched_unit):
//   K-major, the live tiles' splits through a prefix over the experts'
//   live tile counts, then the dead tiles (one unit of zeros each);
//   M-major, every tile's splits, the experts ordered by their live
//   k-blocks, most first.  Block b takes unit b, and the blocks past the
//   live count exit at once.  The hardware hands blocks to the SMs in
//   index order as slots free up, so the live units start first, the
//   longest UP units first (granite's fp32 training step: 16.3 ms of UP
//   a step so ordered, 21.4 ms in the experts' own order; a router
//   whose counts lie within 20% of each other shows no difference), and
//   the dead tiles' zeros fill in behind, in the live work's tail; a
//   unit's splits are neighbours, and an expert's row tiles of one
//   column tile too (they share B's panel in L2).  Numbered from the
//   shape alone instead (in the experts' own order, or row tile by row
//   tile over them), the dead tiles sit among the live ones and their
//   zeros cut into the live work: granite's fp32 training step spends
//   more on FF / BP so (launch/ablate_experts.py, PERF.md).
//   The round loop below (round r takes unit r * gridDim.x plus the
//   block's index, every odd round backward) never runs a second round,
//   since the grid has a block for every unit.  It stays for the
//   registers it leaves the body: written without it, the body spilled
//   44-64 bytes and ran 5-8% slower; as a plain grid-stride loop, the
//   UP got 124 registers, not 126, and ran slower (PERF.md).
// - The mainloop is sgemm_sm90.cuh's: a 128 x 128 tile, 8 x 8 outputs a
//   thread from four float4 shared-memory loads a k, a cp.async ring of
//   four 16-deep stages, the K-major operands (FF's A, both of BP's)
//   through registers one k-block ahead, two blocks an SM, one
//   __syncthreads a k-block.  It needs all 128 registers, and a unit's
//   numbers come from shared-memory lookups, which (unlike a 2-D tile's
//   blockIdx arithmetic) cannot be recomputed for free: the unit lives
//   in shared memory, and only what the k-loop reads (the expert's
//   operands, the corner, the k-blocks) is copied into registers.  With
//   the whole unit in registers an all-live call took 3-8% longer than
//   the kernel that computed every row, and the UP spilled; with the
//   k-loop reading shared memory, FF took 4% longer.  PERF.md lists the
//   mainloop designs tried and their times.
// - Split-K as the 2-D kernel's (deterministic, counters per expert
//   tile, the last block sums the partials in split order): ws holds
//   splits x E x M x N partials, then E x grid_y x grid_x zeroed int32
//   counters.  No SR: an f32 weight is not rounded.
#pragma once

#include "sgemm_sm90.cuh"

namespace rt {
namespace sgemm {

constexpr int MAX_EXPERTS = 256;   // the per-expert tables' size

// One unit of the walk: tile (x, y) of expert e, split z over nk
// k-blocks from kb0; dead: a K-major row tile past the expert's live
// rows (zeros, no loads).
struct Unit {
  int e, x, y, z, kb0, nk;
  bool dead;
};

// Unit u of the walk.  K-major (tab: the prefix of the experts' live
// tiles, tab[experts] their total): the live tiles' splits, z fastest,
// then an expert's live row tiles, then its column tiles; after them
// every expert's dead tiles, x fastest.  M-major (tab: each expert's
// live k-blocks; order: the experts by them, most first): every tile's
// splits, z fastest, then the row tiles, then the column tiles, expert
// by expert in that order.
template <bool A_MN>
__device__ __forceinline__ Unit batched_unit(const int* tab,
                                             const int* order, int u,
                                             int grid_x, int grid_y,
                                             int splits, int experts,
                                             int k_blocks,
                                             int kb_per_split) {
  Unit w;
  w.dead = false;
  if constexpr (A_MN) {
    const int per_e = grid_x * grid_y * splits;
    const int q = u / per_e, local = u - q * per_e, t = local / splits;
    w.e = order[q];
    w.z = local - t * splits;
    w.y = t % grid_y;
    w.x = t / grid_y;
    w.kb0 = w.z * kb_per_split;
    w.nk = max(0, min(kb_per_split, tab[w.e] - w.kb0));
    return w;
  } else {
    const int live = tab[experts] * splits;
    if (u < live) {
      const int t = u / splits;
      w.z = u - t * splits;
      w.e = last_at_most(experts, t, [&](int e) { return tab[e]; });
      const int ly = (tab[w.e + 1] - tab[w.e]) / grid_x;
      const int local = t - tab[w.e];
      w.y = local % ly;
      w.x = local / ly;
      w.kb0 = w.z * kb_per_split;
      w.nk = min(kb_per_split, k_blocks - w.kb0);
      return w;
    }
    // dead tiles before expert e's: e * grid_x * grid_y - tab[e]
    const int d = u - live, g = grid_x * grid_y;
    w.e = last_at_most(experts, d, [&](int e) { return e * g - tab[e]; });
    const int local = d - (w.e * g - tab[w.e]);
    w.y = (tab[w.e + 1] - tab[w.e]) / grid_x + local / grid_x;
    w.x = local % grid_x;
    w.z = w.kb0 = w.nk = 0;
    w.dead = true;
    return w;
  }
}

// out[e] = scale * A[e] . B[e] over the experts' live rows, unit u of
// batched_unit in block u: A (E, M, K) or, A_MN, X (E, K, M); B (E, K,
// N) with B_MN, else (E, N, K); out (E, M, N); rows (experts,) int32 or
// null; ws as the header says (splits > 1 only).
template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(NT, 2)
    sgemm_batched_kernel(const float* __restrict__ A,
                         const float* __restrict__ B,
                         const int* __restrict__ rows,
                         float* __restrict__ out, float* __restrict__ ws,
                         int M, int N, int K, int grid_x, int grid_y,
                         int splits, int kb_per_split, int experts,
                         float scale, int vec_a, int vec_b, int vec_out) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // [STAGES][BK][LDA]
  float* Bs = As + STAGES * BK * LDA;          // [STAGES][BK][LDB]
  __shared__ int tab[MAX_EXPERTS + 1];
  __shared__ int order[A_MN ? MAX_EXPERTS : 1];
  __shared__ int is_last;

  const int k_blocks = (K + BK - 1) / BK;
  // the per-expert tables, from rows (null: every row live)
  if constexpr (A_MN) {
    for (int e = threadIdx.x; e < experts; e += NT) {
      const int r = rows ? min(max(rows[e], 0), K) : K;
      tab[e] = (r + BK - 1) / BK;
    }
    __syncthreads();
    // the experts by live k-blocks, most first (ties by index)
    for (int e = threadIdx.x; e < experts; e += NT) {
      const int v = tab[e];
      int rank = 0;
      for (int j = 0; j < experts; ++j)
        rank += tab[j] > v || (tab[j] == v && j < e);
      order[rank] = e;
    }
  } else if (threadIdx.x < 32) {
    // warp 0 scans the live tile counts: 8 experts a lane
    constexpr int PER = MAX_EXPERTS / 32;
    const int lane = threadIdx.x;
    int v[PER], sum = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = lane * PER + j;
      const int r = e < experts ? (rows ? min(max(rows[e], 0), M) : M) : 0;
      v[j] = min(grid_y, (r + BM - 1) / BM) * grid_x;
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

  const int units = A_MN ? experts * grid_x * grid_y * splits
                         : tab[experts] * splits +
                               experts * grid_x * grid_y - tab[experts];
  const int G = gridDim.x;
  using ATile = typename std::conditional<A_MN, NoTile, KTile<BM, NT>>::type;
  using BTile = typename std::conditional<B_MN, NoTile, KTile<BN, NT>>::type;
  // the current unit, in shared memory: thread 0 numbers it; its expert
  // and tile, which only the epilogue needs, hold no register across
  // the k-loop (which needs all 128)
  __shared__ Unit cur;
  __shared__ TileAt at;
  for (int round = 0;; ++round) {
    const int u =
        round * G + (round & 1 ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
    if (u >= units) break;   // u only grows with the round
    __syncthreads();   // the last unit's reads of the ring and of cur are done
    if (threadIdx.x == 0) {
      cur = batched_unit<A_MN>(tab, order, u, grid_x, grid_y, splits,
                               experts, k_blocks, kb_per_split);
      at = {A + (size_t)cur.e * M * K, B + (size_t)cur.e * K * N,
            cur.y * BM, cur.x * BN, cur.kb0, cur.nk};
    }
    __syncthreads();
    if (cur.dead) {
      // zeros over a dead tile, 16 bytes a store where they fit
      const size_t eo = (size_t)cur.e * M * N;
      for (int q = threadIdx.x; q < BM * BN / 4; q += NT) {
        const int gm = at.m0 + q / (BN / 4), gn = at.n0 + (q % (BN / 4)) * 4;
        if (gm < M && gn < N)
          store4(out, nullptr, eo + (size_t)gm * N + gn,
                 make_float4(0.f, 0.f, 0.f, 0.f), min(4, N - gn), 0,
                 vec_out);
      }
      continue;
    }
    float acc[8][8];
    // the k-loop's operands, corner and k-blocks in registers (read from
    // shared memory again after each of its barriers, they cost FF 4%)
    tile_product<A_MN, B_MN, ATile, BTile>(acc, As, Bs, TileAt(at),
                                           A_MN ? M : K, B_MN ? N : K, M, N,
                                           K, vec_a, vec_b);
    tile_epilogue(acc, out, nullptr, ws, &is_last, M, N, at.m0, at.n0, cur.z,
                  cur.e, experts, splits,
                  (cur.e * grid_y + cur.y) * grid_x + cur.x, scale, 0,
                  vec_out);
  }
}

// ---- host side -------------------------------------------------------------

// Whether (splits, kb_per_split, grid_x, grid_y) is the plan of one
// expert's (M, N, K) over this kernel's tiles, as
// kernels/sr_matmul.py::f32_plan gives it, with a workspace where it
// splits: the batched C entries refuse any other.
inline bool batched_plan_ok(int E, int M, int N, int K, int splits,
                            int kb_per_split, int grid_x, int grid_y,
                            const void* ws) {
  const int k_blocks = (K + BK - 1) / BK;
  return E >= 1 && E <= MAX_EXPERTS && M >= 1 && N >= 1 && K >= 1 &&
         splits >= 1 && kb_per_split >= 1 &&
         grid_x == (N + BN - 1) / BN && grid_y == (M + BM - 1) / BM &&
         (long long)splits * kb_per_split >= k_blocks &&
         (long long)(splits - 1) * kb_per_split < k_blocks &&
         (long long)E * grid_x * grid_y * splits < (1LL << 31) &&
         (splits == 1 || ws != nullptr);
}

// One batched product (see sgemm_batched_kernel) over contiguous
// operands, the plan as batched_plan_ok checks it: a block for every
// unit of an all-live call.  Returns 0 or a cudaError_t.
template <bool A_MN, bool B_MN>
int run_batched(const float* a, const float* b, const int* rows, float* out,
                float* ws, int M, int N, int K, float scale, int splits,
                int kb_per_split, int grid_x, int grid_y, int experts,
                cudaStream_t stream) {
  auto kern = sgemm_batched_kernel<A_MN, B_MN>;
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  // the kernel whose shared-memory opt-in is set, per device: keyed by
  // its stub (a template's function-local static is one object in every
  // library of the process that instantiates it, while each library
  // registers its own kernel: launch/ablate_experts.py loads several)
  static const void* smem_set[MAX_DEVICES] = {};
  const void* fn = reinterpret_cast<const void*>(kern);
  if (dev >= MAX_DEVICES || smem_set[dev] != fn) {
    err = static_cast<int>(cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
    if (err != 0) return err;
    if (dev < MAX_DEVICES) smem_set[dev] = fn;
  }
  // a block for every unit of an all-live call
  const int blocks = experts * grid_x * grid_y * splits;
  // an expert's operands start 16-byte aligned when its blocks hold a
  // multiple of 4 floats (its output's do whenever N % 4 == 0)
  const int vec_a = aligned16(a) && (A_MN ? M : K) % 4 == 0 &&
                    (size_t)M * K % 4 == 0;
  const int vec_b = aligned16(b) && (B_MN ? N : K) % 4 == 0 &&
                    (size_t)K * N % 4 == 0;
  const int vec_out = N % 4 == 0 && aligned16(out) && aligned16(ws);
  kern<<<blocks, NT, SMEM_BYTES, stream>>>(
      a, b, rows, out, ws, M, N, K, grid_x, grid_y, splits, kb_per_split,
      experts, scale, vec_a, vec_b, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgemm
}  // namespace rt
