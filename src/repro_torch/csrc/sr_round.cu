// sr_round: elementwise f32 -> bf16 stochastic rounding from explicit
// random bits — the paper's SR writeback of persistent state (Fig 11):
// add the low 16 bits of rbits below the bf16 mantissa and truncate;
// a non-finite value takes the plain cast.
//
// Replaces the TPU kernel repro/kernels/sr_round.py::sr_round
// (pl.pallas_call at sr_round.py:36, body _sr_round_kernel), a (256, 256)
// block grid over an (M, N) array.  On the port it is the optimizer's
// per-leaf SR writeback of params and moments, so it takes any
// contiguous leaf viewed flat: a grid-stride loop over n elements, four
// per thread step when the pointers allow 16-byte loads.  The rounding
// itself is common.cuh's sr_bf16_bits, the epilogue sr_matmul and
// outer_accum use, so all three round bit for bit alike.
//
// What bounds it on the H100: memory.  Each element reads 4 + 4 bytes
// and writes 2, with one integer add and shift; at a 209M-element leaf
// that is 2.1 GB, 0.62 ms at 3.35 TB/s.
#include "common.cuh"

namespace rt {

__global__ void sr_round_kernel(const float* __restrict__ x,
                                const uint32_t* __restrict__ rbits,
                                uint16_t* __restrict__ out, long long n,
                                int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const long long n4 = n / 4;
    for (; i < n4; i += stride) {
      const float4 v = reinterpret_cast<const float4*>(x)[i];
      const uint4 r = reinterpret_cast<const uint4*>(rbits)[i];
      ushort4 o;
      o.x = sr_bf16_bits(v.x, r.x);
      o.y = sr_bf16_bits(v.y, r.y);
      o.z = sr_bf16_bits(v.z, r.z);
      o.w = sr_bf16_bits(v.w, r.w);
      reinterpret_cast<ushort4*>(out)[i] = o;
    }
    return;
  }
  for (; i < n; i += stride) out[i] = sr_bf16_bits(x[i], rbits[i]);
}

}  // namespace rt

// out[i] = SR-bf16(x[i]) with the low 16 bits of rbits[i], i < n.  vec4
// is decided here: n % 4 == 0 and every pointer 16-byte aligned (out
// 8-byte).  `blocks` x 256 threads stride over the array.  One launch
// on `stream`; returns cudaGetLastError().
extern "C" int sr_round(const void* x, const void* rbits, void* out,
                        long long n, int blocks, void* stream) {
  using namespace rt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = n % 4 == 0 && aligned16(x) && aligned16(rbits) &&
                  ((uintptr_t)out & 7u) == 0;
  sr_round_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(rbits),
      static_cast<uint16_t*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}
