// Per-bucket top-k selection with the fused error-feedback residual.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bucket_topk/kernel.py
// (bucket_topk_pallas / _kernel). For each row of x (nb, B):
//   lidx: the k positions of largest |x|, ties to the lower index, ascending
//   val:  x at those positions
//   res:  x with those positions set to +0.0
//
// Bound: bytes. Each row is read once (B floats) and res written once
// (B floats); val/lidx add 8k bytes. The selection is k warp-wide argmax
// rounds on registers, so the kernel stays near the memory roofline while
// k << B.
//
// Design: one warp per row. Lane l holds elements j*32 + l (j < B/32), so
// every load and store of the warp is 128 contiguous bytes. Each round
// reduces a 64-bit key (|x| bits << 32 | ~index) with a warp max: a larger
// magnitude wins, and on equal magnitudes the lower index wins, which is
// the oracle's tie rule. |x| has its sign bit clear, so its bit pattern
// orders like the value. The selected mask is compacted with a ballot and a
// popcount prefix per column j, which yields lidx in ascending order with
// no sort.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

template <int VPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bucket_topk_kernel(const float* __restrict__ x, float* __restrict__ val,
                   int32_t* __restrict__ lidx, float* __restrict__ res,
                   long long nb, int k) {
  constexpr int B = VPL * 32;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= nb) return;  // uniform over the warp

  const float* xr = x + row * B;
  float v[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) v[j] = xr[j * 32 + lane];

  unsigned sel = 0u;  // bit j: element j*32 + lane is selected
  for (int r = 0; r < k; ++r) {
    unsigned long long best = 0ull;  // below every real key
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(fabsf(v[j])) << 32) |
          (unsigned long long)(~(unsigned)(j * 32 + lane));
      if (!((sel >> j) & 1u) && key > best) best = key;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFull, best, off);
      if (other > best) best = other;
    }
    const unsigned idx = ~(unsigned)(best & 0xffffffffull);
    if ((int)(idx & 31u) == lane) sel |= 1u << (idx >> 5);
  }

  float* resr = res + row * B;
  float* valr = val + row * k;
  int32_t* lidxr = lidx + row * k;
  const unsigned below = (1u << lane) - 1u;
  int base = 0;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const bool s = (sel >> j) & 1u;
    const unsigned ballot = __ballot_sync(kFull, s);
    if (s) {
      const int pos = base + __popc(ballot & below);
      valr[pos] = v[j];
      lidxr[pos] = j * 32 + lane;
    }
    base += __popc(ballot);
    resr[j * 32 + lane] = s ? 0.0f : v[j];
  }
}

}  // namespace

extern "C" int bucket_topk_f32(const float* x, float* val, int32_t* lidx,
                               float* res, long long nb, int b, int k,
                               cudaStream_t stream) {
  if (nb <= 0) return (int)cudaSuccess;
  if (k < 1 || k > b) return (int)cudaErrorInvalidValue;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((unsigned)((nb + kWarpsPerBlock - 1) / kWarpsPerBlock));
  switch (b) {
    case 128:
      bucket_topk_kernel<4><<<grid, block, 0, stream>>>(x, val, lidx, res, nb, k);
      break;
    case 256:
      bucket_topk_kernel<8><<<grid, block, 0, stream>>>(x, val, lidx, res, nb, k);
      break;
    case 512:
      bucket_topk_kernel<16><<<grid, block, 0, stream>>>(x, val, lidx, res, nb, k);
      break;
    case 1024:
      bucket_topk_kernel<32><<<grid, block, 0, stream>>>(x, val, lidx, res, nb, k);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
