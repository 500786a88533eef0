// fused_attn_unit: one decode step of one attention layer (norm1, QKV,
// RoPE, KV append, GQA attention, o-projection, residual, and the FF
// block with its residual) for all B arena rows.
//
// Replaces the TPU kernel repro/kernels/decode_fused.py::fused_attn_unit
// (pl.pallas_call at decode_fused.py:272, body _attn_unit_kernel).  The
// TPU grid was (B,): one program per arena row, each re-reading every
// weight of the layer.  At B = 32 that reads the layer's ~30 MB of
// weights 32 times.
//
// What bounds it on the H100: a decode step does 2 flops per weight byte
// per row, so even at B = 32 it is bound by reading the layer's weights
// (and the row's K/V) from device memory.  The design therefore splits
// the WEIGHT COLUMNS across blocks and keeps all B rows (up to 32 per
// block row) in every block, so each weight byte is read once per step.
// The product runs on the tensor cores (WMMA, f32 accumulate) with the
// 32 rows as the M side.  The (B, *) intermediates are small and pass
// through device memory (L2) between launches.
//
// Five launches per layer (three when with_ffn is false), none of them a
// library kernel:
//   1. norm1 (computed per block from the raw rows) + QKV + bias -> qkv
//   2. attention, one block per (row, KV head): RoPE of the G query heads
//      and the new key, the ring-slot K/V/pos append (active rows only),
//      GQA scores with the mask, softmax with exp kept in f32, PV, / l
//   3. o-projection + residual -> x1 (or y when with_ffn is false)
//   4. norm2 (per block) + gate/up (paired column tiles) + activation -> h
//   5. down-projection + residual -> y
// Fusing them into one persistent launch is later work (PERF.md).
//
// fused_ffn is launches 4 and 5 alone: norm2 + FF + residual for units
// whose mixer stays per-op (rwkv6's recurrence).  It replaces the TPU
// kernel repro/kernels/decode_fused.py::fused_ffn (pl.pallas_call at
// decode_fused.py:315, body _ffn_kernel), whose (B,) grid again re-read
// the layer's FF weights once per row.  It is bound by those weights'
// bytes (rwkv6-1.6b: 2 x 2048 x 7168 bf16 = 58.7 MB per layer), and
// keeps the same split: weight columns across blocks, all rows in each.
// Cast order, as the TPU kernel's: the norm result in bf16, the
// activation of the f32 product rounded once to bf16, the
// down-projection accumulated in f32 and rounded to bf16 before the
// bf16 residual add.
#include "common.cuh"

namespace rt {

enum { EPI_BIAS = 0, EPI_RESID = 1, EPI_GATED = 2, EPI_ACT = 3 };
enum { ACT_SWIGLU = 0, ACT_GEGLU = 1, ACT_GELU = 2, ACT_RELU_SQ = 3 };
constexpr int MAXG = 16;   // query heads per KV head the attention takes

struct RowGemm {
  const bf16* A; int lda;          // (B, Kd) input rows
  const bf16* W; int ldw;          // (Kd, ldw) row-major weights
  int B, Kd, N;                    // output (B, N); gated: N = f
  int up_off;                      // gated: column of the up half (f)
  int norm;                        // 0 none, 1 rmsnorm, 2 layernorm on A
  const float* nscale;             // (Kd) norm scale
  const float* nbias;              // (Kd) norm bias
  const float* bias;               // (N) EPI_BIAS
  const bf16* resid;               // (B, N) EPI_RESID
  int act;                         // ACT_*
  bf16* out;                       // (B, N)
  int vec_a, vec_w;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// Per-row norm statistics of the block's rows: mean (layernorm) and
// 1/sqrt(var + eps) — rmsnorm: mean(x^2) + 1e-6, layernorm: 1e-5.
__device__ void row_stats(const RowGemm& p, int b0, float* mu_s, float* rs_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < TM; r += blockDim.x / 32) {
    const int gb = b0 + r;
    float mu = 0.f, rs = 0.f;
    if (gb < p.B) {
      const bf16* row = p.A + (size_t)gb * p.lda;
      if (p.norm == 2) {
        float s = 0.f;
        for (int k = lane; k < p.Kd; k += 32) s += bf2f(row[k]);
        mu = warp_sum(s) / p.Kd;
      }
      float q = 0.f;
      for (int k = lane; k < p.Kd; k += 32) {
        const float v = bf2f(row[k]) - mu;
        q += v * v;
      }
      rs = rsqrtf(warp_sum(q) / p.Kd + (p.norm == 1 ? 1e-6f : 1e-5f));
    }
    if (lane == 0) { mu_s[r] = mu; rs_s[r] = rs; }
  }
}

// out[b, n] for the block's 32 rows x 32 columns: A (normalised on the
// fly when p.norm) . W[:, n0:n0+32] (and W[:, up_off+n0:...] when gated)
// with f32 accumulation over the whole Kd, then the epilogue.
template <int EPI>
__global__ void __launch_bounds__(THREADS) row_gemm_kernel(RowGemm p) {
  constexpr bool GATED = EPI == EPI_GATED;
  __shared__ __align__(128) bf16 As[TM * LDA];
  __shared__ __align__(128) bf16 Ws[TK * LDB_ROW];
  __shared__ __align__(128) bf16 Us[GATED ? TK * LDB_ROW : 8];
  __shared__ __align__(128) float Cs[TM * LDC];
  __shared__ __align__(128) float Cu[GATED ? TM * LDC : 4];
  __shared__ float mu_s[TM], rs_s[TM];

  const int b0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int warp = threadIdx.x / 32;
  const int ar = (warp / 2) * 16, bc = (warp % 2) * 16;
  if (p.norm) row_stats(p, b0, mu_s, rs_s);
  __syncthreads();

  AccFrag acc, accu;
  wmma::fill_fragment(acc, 0.f);
  wmma::fill_fragment(accu, 0.f);
  for (int k0 = 0; k0 < p.Kd; k0 += TK) {
    load_tile<TM, TK, LDA>(As, p.A, p.lda, b0, k0, p.B, p.Kd, p.vec_a);
    load_tile<TK, TN, LDB_ROW>(Ws, p.W, p.ldw, k0, n0, p.Kd, p.N, p.vec_w);
    if constexpr (GATED)
      load_tile<TK, TN, LDB_ROW>(Us, p.W + p.up_off, p.ldw, k0, n0, p.Kd,
                                 p.N, p.vec_w);
    __syncthreads();
    if (p.norm) {
      for (int e = threadIdx.x; e < TM * TK; e += blockDim.x) {
        const int r = e / TK, c = e % TK;
        const int gb = b0 + r, gk = k0 + c;
        if (gb >= p.B || gk >= p.Kd) continue;
        float y = (bf2f(As[r * LDA + c]) - mu_s[r]) * rs_s[r];
        y = y * p.nscale[gk] + p.nbias[gk];
        As[r * LDA + c] = f2bf(y);
      }
      __syncthreads();
    }
    mma_step<false>(acc, As, Ws, ar, bc);
    if constexpr (GATED) mma_step<false>(accu, As, Us, ar, bc);
    __syncthreads();
  }
  wmma::store_matrix_sync(Cs + ar * LDC + bc, acc, LDC, wmma::mem_row_major);
  if constexpr (GATED)
    wmma::store_matrix_sync(Cu + ar * LDC + bc, accu, LDC, wmma::mem_row_major);
  __syncthreads();

  for (int e = threadIdx.x; e < TM * TN; e += blockDim.x) {
    const int r = e / TN, c = e % TN;
    const int gb = b0 + r, gn = n0 + c;
    if (gb >= p.B || gn >= p.N) continue;
    const size_t o = (size_t)gb * p.N + gn;
    const float a = Cs[r * LDC + c];
    float v;
    if constexpr (EPI == EPI_BIAS) {
      v = a + p.bias[gn];
    } else if constexpr (EPI == EPI_RESID) {
      v = bf2f(p.resid[o]) + bf2f(f2bf(a));
    } else if constexpr (EPI == EPI_GATED) {
      const float u = Cu[r * LDC + c];
      const float g = p.act == ACT_SWIGLU ? a / (1.f + expf(-a)) : gelu_tanh(a);
      v = g * u;
    } else {
      if (p.act == ACT_GELU) {
        v = gelu_tanh(a);
      } else {
        const float t = fmaxf(a, 0.f);
        v = t * t;
      }
    }
    p.out[o] = f2bf(v);
  }
}

struct Attn {
  const bf16* qkv; int qn;          // (B, (H + 2K) hd) projected rows
  bf16* ck; bf16* cv; int* cpos;    // (B, S, K, hd) x2, (B, S) arena rows
  const int* pos;                   // (B,) absolute position
  const int* active;                // (B,) 1 = append into the row
  bf16* o;                          // (B, H hd) attention output
  int H, K, hd, S, window;          // window <= 0: none
  float theta, scale;
};

// Block-wide reduction over 128 threads; every thread gets the result.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x / 32); ++w)
    r = MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(THREADS) attn_decode_kernel(Attn p) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x, kh = blockIdx.y, tid = threadIdx.x;
  const int G = p.H / p.K, hd = p.hd, half = hd / 2, S = p.S;
  float* q_s = sm;                       // [G][hd]
  float* k1 = q_s + G * hd;              // [hd] roped new key
  float* v1 = k1 + hd;                   // [hd] new value
  float* sc = v1 + hd;                   // [G][S] scores, then exp
  const int nparts = blockDim.x / hd;
  float* part = sc + G * S;              // [nparts][G][hd] PV partials
  float* red = part + nparts * G * hd;   // [32] reduction scratch
  float* m_s = red + 32;                 // [MAXG]
  float* l_s = m_s + MAXG;               // [MAXG]

  const int pp = p.pos[b];
  const int slot = ((pp % S) + S) % S;
  const bf16* row = p.qkv + (size_t)b * p.qn;

  // RoPE in f32 at pp, freqs = 1 / theta^(2i/hd), rounded back to bf16
  for (int e = tid; e < (G + 1) * half; e += blockDim.x) {
    const int which = e / half, j = e % half;
    const bf16* src = which < G ? row + (kh * G + which) * hd
                                : row + (p.H + kh) * hd;
    const float x1 = bf2f(src[j]), x2 = bf2f(src[j + half]);
    const float freq = 1.f / powf(p.theta, 2.f * (float)j / (float)hd);
    const float ang = (float)pp * freq;
    const float c = cosf(ang), s = sinf(ang);
    const float y1 = bf2f(f2bf(x1 * c - x2 * s));
    const float y2 = bf2f(f2bf(x1 * s + x2 * c));
    float* dst = which < G ? q_s + which * hd : k1;
    dst[j] = y1;
    dst[j + half] = y2;
  }
  for (int i = tid; i < hd; i += blockDim.x)
    v1[i] = bf2f(row[(p.H + p.K + kh) * hd + i]);
  __syncthreads();

  // append into ring slot pp % S — active rows only, so an inactive arena
  // row keeps its cache exactly (the reference restores it afterwards)
  const size_t slot_off = ((size_t)(b * S + slot) * p.K + kh) * hd;
  if (p.active[b]) {
    for (int i = tid; i < hd; i += blockDim.x) {
      p.ck[slot_off + i] = f2bf(k1[i]);
      p.cv[slot_off + i] = f2bf(v1[i]);
    }
    if (kh == 0 && tid == 0) p.cpos[b * S + slot] = pp;
  }

  // scores: the current slot is read from shared memory (its position is
  // pp), so no block depends on another block's append
  for (int j = tid; j < S; j += blockDim.x) {
    const int kp = j == slot ? pp : p.cpos[b * S + j];
    const bool valid = kp >= 0 && kp <= pp && (p.window <= 0 || pp - kp < p.window);
    float dot[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
    const bf16* kr = p.ck + ((size_t)(b * S + j) * p.K + kh) * hd;
    for (int i = 0; i < hd; i += 8) {
      float kv[8];
      if (j == slot) {
#pragma unroll
        for (int t = 0; t < 8; ++t) kv[t] = k1[i + t];
      } else {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + i);
        const bf16* h8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int t = 0; t < 8; ++t) kv[t] = bf2f(h8[t]);
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
#pragma unroll
          for (int t = 0; t < 8; ++t) dot[g] += q_s[g * hd + i + t] * kv[t];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) sc[g * S + j] = valid ? dot[g] * p.scale : -1e30f;
  }
  __syncthreads();

  // softmax pieces: m = max, exp(s - m) kept in f32, l = sum
  for (int g = 0; g < G; ++g) {
    float mx = -INFINITY;
    for (int j = tid; j < S; j += blockDim.x) mx = fmaxf(mx, sc[g * S + j]);
    mx = block_reduce<true>(mx, red);
    float sum = 0.f;
    for (int j = tid; j < S; j += blockDim.x) {
      const float e = expf(sc[g * S + j] - mx);
      sc[g * S + j] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, red);
    if (tid == 0) { m_s[g] = mx; l_s[g] = sum; }
  }
  __syncthreads();

  // PV: thread (part, i) sums positions j = part (mod nparts) for all G
  {
    const int i = tid % hd, pr = tid / hd;
    float acc[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
    if (pr < nparts) {
      for (int j = pr; j < S; j += nparts) {
        const float vv = j == slot ? v1[i]
            : bf2f(p.cv[((size_t)(b * S + j) * p.K + kh) * hd + i]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) acc[g] += sc[g * S + j] * vv;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) part[(pr * G + g) * hd + i] = acc[g];
    }
  }
  __syncthreads();
  for (int e = tid; e < G * hd; e += blockDim.x) {
    const int g = e / hd, i = e % hd;
    float s = 0.f;
    for (int pr = 0; pr < nparts; ++pr) s += part[(pr * G + g) * hd + i];
    s = s / fmaxf(l_s[g], 1e-30f);
    p.o[(size_t)b * (p.H * hd) + (kh * G + g) * hd + i] = f2bf(s);
  }
}

size_t attn_smem_bytes(int G, int hd, int S) {
  const int nparts = THREADS / hd;
  return sizeof(float) * ((size_t)G * hd + 2 * hd + (size_t)G * S
                          + (size_t)nparts * G * hd + 32 + 2 * MAXG);
}

template <int EPI>
cudaError_t launch_gemm(const RowGemm& p, cudaStream_t st) {
  const dim3 grid((p.N + TN - 1) / TN, (p.B + TM - 1) / TM);
  row_gemm_kernel<EPI><<<grid, THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

RowGemm gemm_args(const void* A, int lda, const void* W, int ldw, int B,
                  int Kd, int N, void* out) {
  RowGemm p{};
  p.A = static_cast<const bf16*>(A);
  p.lda = lda;
  p.W = static_cast<const bf16*>(W);
  p.ldw = ldw;
  p.B = B;
  p.Kd = Kd;
  p.N = N;
  p.out = static_cast<bf16*>(out);
  p.vec_a = aligned16(A) && lda % 8 == 0;
  p.vec_w = aligned16(W) && ldw % 8 == 0;
  return p;
}

// Launches 4 and 5: norm(x) (. gate/up, or up) + activation -> h_buf;
// h . w_out + x -> y.
cudaError_t ffn_launches(const void* x, const void* n2s, const void* n2b,
                         const void* w_in, const void* w_out, void* h_buf,
                         void* y, int B, int d, int f, int norm_kind, int act,
                         cudaStream_t st) {
  const bool gated = act == ACT_SWIGLU || act == ACT_GEGLU;
  RowGemm g4 = gemm_args(x, d, w_in, gated ? 2 * f : f, B, d, f, h_buf);
  g4.norm = norm_kind;
  g4.nscale = static_cast<const float*>(n2s);
  g4.nbias = static_cast<const float*>(n2b);
  g4.act = act;
  g4.up_off = gated ? f : 0;
  g4.vec_w = g4.vec_w && f % 8 == 0;
  cudaError_t err = gated ? launch_gemm<EPI_GATED>(g4, st)
                          : launch_gemm<EPI_ACT>(g4, st);
  if (err != cudaSuccess) return err;
  RowGemm g5 = gemm_args(h_buf, f, w_out, d, B, f, d, y);
  g5.resid = static_cast<const bf16*>(x);
  return launch_gemm<EPI_RESID>(g5, st);
}

}  // namespace rt

// One fused decode step of one attention unit for B arena rows.  All
// tensors contiguous; bf16 unless noted: x (B, d); ck/cv (B, S, K, hd);
// cpos (B, S) int32, updated in place on active rows; pos, active (B,)
// int32; n1s/n1b/n2s/n2b (d) f32; qkv_w (d, qn); qkv_b (qn) f32;
// o_w (H hd, d); w_in (d, 2f | f); w_out (f, d); scratch qkv_buf (B, qn),
// o_buf (B, H hd), x1_buf (B, d), h_buf (B, f); output y (B, d).
// norm_kind 1 rmsnorm / 2 layernorm; act: 0 swiglu, 1 geglu, 2 gelu,
// 3 relu_sq; window <= 0 for none.  Returns cudaGetLastError() of the
// first launch that failed, else of the last.
extern "C" int fused_attn_unit_bf16(
    const void* x, void* ck, void* cv, void* cpos, const void* pos,
    const void* active, const void* n1s, const void* n1b, const void* qkv_w,
    const void* qkv_b, const void* o_w, const void* n2s, const void* n2b,
    const void* w_in, const void* w_out, void* qkv_buf, void* o_buf,
    void* x1_buf, void* h_buf, void* y, int B, int d, int H, int K, int hd,
    int S, int f, int window, int norm_kind, int act, int with_ffn,
    float theta, void* stream) {
  using namespace rt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int qn = (H + 2 * K) * hd;
  cudaError_t err;

  // 1. norm1 + QKV + bias
  RowGemm g1 = gemm_args(x, d, qkv_w, qn, B, d, qn, qkv_buf);
  g1.norm = norm_kind;
  g1.nscale = static_cast<const float*>(n1s);
  g1.nbias = static_cast<const float*>(n1b);
  g1.bias = static_cast<const float*>(qkv_b);
  if ((err = launch_gemm<EPI_BIAS>(g1, st)) != cudaSuccess) return (int)err;

  // 2. RoPE + append + attention
  Attn a{};
  a.qkv = static_cast<const bf16*>(qkv_buf);
  a.qn = qn;
  a.ck = static_cast<bf16*>(ck);
  a.cv = static_cast<bf16*>(cv);
  a.cpos = static_cast<int*>(cpos);
  a.pos = static_cast<const int*>(pos);
  a.active = static_cast<const int*>(active);
  a.o = static_cast<bf16*>(o_buf);
  a.H = H; a.K = K; a.hd = hd; a.S = S; a.window = window;
  a.theta = theta;
  a.scale = 1.f / sqrtf((float)hd);
  const size_t smem = attn_smem_bytes(H / K, hd, S);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(attn_decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  attn_decode_kernel<<<dim3(B, K), THREADS, smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // 3. o-projection + residual
  RowGemm g3 = gemm_args(o_buf, H * hd, o_w, d, B, H * hd, d,
                         with_ffn ? x1_buf : y);
  g3.resid = static_cast<const bf16*>(x);
  if ((err = launch_gemm<EPI_RESID>(g3, st)) != cudaSuccess) return (int)err;
  if (!with_ffn) return (int)cudaSuccess;

  // 4. + 5.
  return (int)ffn_launches(x1_buf, n2s, n2b, w_in, w_out, h_buf, y, B, d, f,
                           norm_kind, act, st);
}

// norm2 + FF + residual alone for B rows: y = x + FF(norm(x)).  x (B, d),
// w_in (d, 2f | f), w_out (f, d), scratch h_buf (B, f), y (B, d) bf16;
// n2s/n2b (d) f32.  Returns cudaGetLastError() of the first launch that
// failed, else of the last.
extern "C" int fused_ffn_bf16(const void* x, const void* n2s, const void* n2b,
                              const void* w_in, const void* w_out,
                              void* h_buf, void* y, int B, int d, int f,
                              int norm_kind, int act, void* stream) {
  return (int)rt::ffn_launches(x, n2s, n2b, w_in, w_out, h_buf, y, B, d, f,
                               norm_kind, act,
                               static_cast<cudaStream_t>(stream));
}
