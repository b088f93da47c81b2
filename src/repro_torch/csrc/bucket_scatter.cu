// Densify bucket-uniform sparse streams: out[r, lidx[r, j]] += val[r, j].
//
// Replaces the Pallas TPU kernel src/repro/kernels/bucket_scatter/kernel.py
// (bucket_scatter_pallas / _kernel), which builds a one-hot (TB, k, B)
// tensor and contracts it because a serialized scatter is slow on the TPU.
// On Hopper the scatter is direct.
//
// Bound: bytes. The output (nb, B) f32 is written once; the inputs add
// 8k bytes a row. The adds are k shared-memory updates a row.
//
// Design: a block owns a tile of rows held in shared memory. The tile is
// zeroed, one thread per row applies its k adds in j order (so duplicate
// indices sum in the oracle's order; indices outside [0, B) are dropped),
// and the tile leaves in one coalesced float4 store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 8192;  // 32 KB of shared memory a block

__global__ void __launch_bounds__(kThreads)
bucket_scatter_kernel(const int32_t* __restrict__ lidx,
                      const float* __restrict__ val, float* __restrict__ out,
                      long long nb, int k, int b, int rows_per_block) {
  __shared__ float4 tile4[kTileFloats / 4];
  float* tile = reinterpret_cast<float*>(tile4);

  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long left = nb - row0;
  const int nrows = left < rows_per_block ? (int)left : rows_per_block;
  const int n4 = nrows * b / 4;

  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < n4; i += kThreads) tile4[i] = zero;
  __syncthreads();

  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    const int32_t* li = lidx + (row0 + r) * k;
    const float* vi = val + (row0 + r) * k;
    float* t = tile + r * b;
    for (int j = 0; j < k; ++j) {
      const int c = li[j];
      if (c >= 0 && c < b) t[c] = __fadd_rn(t[c], vi[j]);
    }
  }
  __syncthreads();

  float4* o4 = reinterpret_cast<float4*>(out + row0 * b);
  for (int i = threadIdx.x; i < n4; i += kThreads) o4[i] = tile4[i];
}

}  // namespace

extern "C" int bucket_scatter_f32(const int32_t* lidx, const float* val,
                                  float* out, long long nb, int k, int b,
                                  cudaStream_t stream) {
  if (nb <= 0) return (int)cudaSuccess;
  if (k < 1 || b < 4 || b % 4 != 0 || b > kTileFloats)
    return (int)cudaErrorInvalidValue;
  const int rows_per_block = kTileFloats / b;
  const dim3 grid((unsigned)((nb + rows_per_block - 1) / rows_per_block));
  bucket_scatter_kernel<<<grid, kThreads, 0, stream>>>(lidx, val, out, nb, k, b,
                                                       rows_per_block);
  return (int)cudaGetLastError();
}
