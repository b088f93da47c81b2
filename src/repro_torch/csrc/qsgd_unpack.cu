// QSGD unpack + dequantize: the inverse of qsgd_pack.
//
// Replaces the Pallas TPU kernel src/repro/kernels/qsgd_unpack/kernel.py
// (qsgd_unpack_pallas / _kernel). Entry j of word w of row r is
//   (((packed[r, w] >> (j * bits)) & mask) - s) * (sigma[r] * fl(1/s)).
// The reference writes code / s * sigma; XLA folds the division by the
// constant s into a multiply by its f32 reciprocal and reassociates it with
// sigma, and that compiled arithmetic is what the port reproduces bit for
// bit (the plain version in kernels/qsgd_unpack/ref.py does the same).
//
// Bound: bytes. The packed words are read once (bits/8 bytes an entry), the
// f32 output written once (4 bytes an entry).
//
// Design: elementwise, one thread a word; each thread writes its 32/bits
// outputs as float4 stores, so a warp stores contiguous 32 * 4 * (32/bits)
// bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int BITS>
__global__ void __launch_bounds__(kThreads)
qsgd_unpack_kernel(const uint32_t* __restrict__ packed,
                   const float* __restrict__ scale, float* __restrict__ out,
                   long long total_words, int words) {
  constexpr int VPW = 32 / BITS;
  constexpr int S = (1 << (BITS - 1)) - 1;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total_words) return;
  const float step = __fmul_rn(scale[i / words], 1.0f / (float)S);
  const uint32_t word = packed[i];
  float4* o4 = reinterpret_cast<float4*>(out + i * VPW);
#pragma unroll
  for (int q = 0; q < VPW / 4; ++q) {
    float v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = 4 * q + t;
      const int code = (int)((word >> (j * BITS)) & MASK) - S;
      v[t] = __fmul_rn((float)code, step);
    }
    o4[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace

extern "C" int qsgd_unpack_f32(const uint32_t* packed, const float* scale,
                               float* out, long long nb, int words, int bits,
                               cudaStream_t stream) {
  if (nb <= 0) return (int)cudaSuccess;
  if (words <= 0) return (int)cudaErrorInvalidValue;
  const long long total = nb * (long long)words;
  const dim3 grid((unsigned)((total + kThreads - 1) / kThreads));
  switch (bits) {
    case 2:
      qsgd_unpack_kernel<2><<<grid, kThreads, 0, stream>>>(packed, scale, out, total, words);
      break;
    case 4:
      qsgd_unpack_kernel<4><<<grid, kThreads, 0, stream>>>(packed, scale, out, total, words);
      break;
    case 8:
      qsgd_unpack_kernel<8><<<grid, kThreads, 0, stream>>>(packed, scale, out, total, words);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
