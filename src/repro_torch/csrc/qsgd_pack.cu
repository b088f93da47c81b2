// QSGD bucketed stochastic quantization + bit-packing.
//
// Replaces the Pallas TPU kernel src/repro/kernels/qsgd_pack/kernel.py
// (qsgd_pack_pallas / _kernel). For each row (a QSGD bucket of Bq entries):
//   sigma = L2 norm (l2) or max |x| (max)
//   level = clip(floor(|x| / sigma * s + rand * 2^-32), 0, s), s = 2^(bits-1)-1
//   code  = sign(x) * level + s   (code s for every entry of a sigma == 0 row)
// and code j of each word sits at bit j * bits of its u32.
//
// Bound: bytes. x and rand are read once (8 bytes an entry), the packed
// codes written once (bits/8 bytes an entry).
//
// Design: one block per row. Pass 1 reduces sigma (per-thread partials,
// warp shuffles, one shared-memory step). Pass 2 gives each thread whole
// words: it loads vpw = 32/bits consecutive x and rand values as float4 /
// uint4 and ORs their codes into one word; the row is still in L1/L2 from
// pass 1. Every float operation is an explicit round-to-nearest intrinsic
// (the library is also built with -fmad=false), so no multiply-add is
// contracted and a level is the one the reference computes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr float kU32ToUnit = 2.3283064365386963e-10f;  // 2^-32

__device__ __forceinline__ float combine(float a, float b, bool max_mode) {
  return max_mode ? fmaxf(a, b) : __fadd_rn(a, b);
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
qsgd_pack_kernel(const float* __restrict__ x, const uint32_t* __restrict__ rnd,
                 uint32_t* __restrict__ packed, float* __restrict__ scale,
                 int bq, int max_mode_flag) {
  constexpr int VPW = 32 / BITS;
  constexpr int S = (1 << (BITS - 1)) - 1;
  const bool max_mode = max_mode_flag != 0;
  const long long row = blockIdx.x;
  const float* xr = x + row * bq;
  const uint32_t* rr = rnd + row * bq;
  const int words = bq / VPW;

  float acc = 0.0f;
  for (int i = threadIdx.x; i < bq; i += kThreads) {
    const float a = xr[i];
    acc = combine(acc, max_mode ? fabsf(a) : __fmul_rn(a, a), max_mode);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = combine(acc, __shfl_xor_sync(kFull, acc, off), max_mode);

  __shared__ float part[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? part[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = combine(acc, __shfl_xor_sync(kFull, acc, off), max_mode);
    if (lane == 0) part[0] = max_mode ? acc : __fsqrt_rn(acc);
  }
  __syncthreads();
  const float sigma = part[0];
  if (threadIdx.x == 0) scale[row] = sigma;
  const bool live = sigma > 0.0f;
  const float safe = live ? sigma : 1.0f;

  for (int w = threadIdx.x; w < words; w += kThreads) {
    float xs[VPW];
    uint32_t rs[VPW];
    const float4* x4 = reinterpret_cast<const float4*>(xr + w * VPW);
    const uint4* r4 = reinterpret_cast<const uint4*>(rr + w * VPW);
#pragma unroll
    for (int q = 0; q < VPW / 4; ++q) {
      const float4 a = x4[q];
      const uint4 u = r4[q];
      xs[4 * q] = a.x; xs[4 * q + 1] = a.y; xs[4 * q + 2] = a.z; xs[4 * q + 3] = a.w;
      rs[4 * q] = u.x; rs[4 * q + 1] = u.y; rs[4 * q + 2] = u.z; rs[4 * q + 3] = u.w;
    }
    uint32_t word = 0u;
#pragma unroll
    for (int j = 0; j < VPW; ++j) {
      const float a = xs[j];
      const float u = __fmul_rn(__uint2float_rn(rs[j]), kU32ToUnit);
      float lv = floorf(__fadd_rn(__fmul_rn(__fdiv_rn(fabsf(a), safe), (float)S), u));
      lv = fminf(fmaxf(lv, 0.0f), (float)S);
      const int level = (int)lv;
      const int code = live ? (a < 0.0f ? -level : level) + S : S;
      word |= (uint32_t)code << (j * BITS);
    }
    packed[row * words + w] = word;
  }
}

}  // namespace

extern "C" int qsgd_pack_f32(const float* x, const uint32_t* rnd,
                             uint32_t* packed, float* scale, long long nb,
                             int bq, int bits, int max_mode,
                             cudaStream_t stream) {
  if (nb <= 0) return (int)cudaSuccess;
  if ((bits != 2 && bits != 4 && bits != 8) || bq <= 0 ||
      bq % (32 / bits) != 0 || bq % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nb);
  switch (bits) {
    case 2:
      qsgd_pack_kernel<2><<<grid, kThreads, 0, stream>>>(x, rnd, packed, scale, bq, max_mode);
      break;
    case 4:
      qsgd_pack_kernel<4><<<grid, kThreads, 0, stream>>>(x, rnd, packed, scale, bq, max_mode);
      break;
    case 8:
      qsgd_pack_kernel<8><<<grid, kThreads, 0, stream>>>(x, rnd, packed, scale, bq, max_mode);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
