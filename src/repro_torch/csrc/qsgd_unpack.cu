// QSGD unpack + dequantize, grouped over buckets, writing DSAR's reduced
// buffers in their final layout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/qsgd_unpack/kernel.py
// (qsgd_unpack_pallas / _kernel) together with the passes the reference's
// stacked executor (src/repro/comm/executor.py, reduce_buckets_spmd) runs
// after it: the permute back from (p_pod, p_data, rows, shard) to
// (p_pod, rows, p_data*shard), the sum over pods and the mean scale.
//
// For every segment (one bucket), flat entry
//   e = ((pod*p_data + rank)*rows + row)*shard + j,   QSGD row e / bq,
// (or, in a row-major segment, e = ((pod*rows + row)*p_data + rank)*shard
// + j: the layout the per-rank executor's allgather receives, already the
// output's order)
// decodes to code(e) * (sigma[e / bq] * fl(1/s)) with
// code = ((word >> shift) & mask) - s, and
//   out[row, rank*shard + j] = (0 + the pods' values, ascending) * mean.
// The reference writes code / s * sigma; XLA folds the division by the
// constant s into a multiply by its f32 reciprocal and reassociates it with
// sigma, and that compiled arithmetic is what the port reproduces bit for
// bit: every multiply and add is an explicit _rn intrinsic and the library
// is built with -fmad=false (kernels/qsgd_unpack/ref.py does the same ops).
// shard % bq == 0, so a QSGD row never crosses an output row.
//
// Bound: bytes. Packed codes are read once (bits/8 bytes an entry), sigma
// once a QSGD row, and the f32 output written once; the fused layout adds no
// bytes, and the passes it replaces wrote every reduced byte three more times.
//
// Design:
// - Launches. One launch covers up to kMaxSegs buckets (all 26 of lm-100m);
//   their descriptors travel by value in a __grid_constant__ parameter, so
//   there is no descriptor table in device memory and no copy to the device
//   per step. A block finds its bucket by a binary search over the
//   descriptors' first-block prefix. (The earlier form, one launch a
//   bucket, took 0.816 ms a step at lm-100m on H100 80GB HBM3 at 700 W,
//   measured by chip_smoke.py, mostly host cost of the 26 launches.)
// - Work. A warp takes one tile of up to kTileWords words of one output QSGD
//   row (row, rank, jq); the row's position comes from the segment's
//   geometry by 32-bit divisions once a warp, not a 64-bit division a thread.
//   For each pod the warp stages the tile's words in shared memory with one
//   16-byte load a lane (32-bit loads when a QSGD row is not a whole number
//   of 16-byte groups), then each lane decodes float4 slots from it.
// - Stores. Lane l writes slots l, l + 32, ...: one warp store instruction
//   covers 512 contiguous bytes, with the streaming hint (__stcs), since the
//   output is not read again by this kernel.
#include <cuda_runtime.h>
#include <stdint.h>

// One bucket as the host describes it (mirrored by kernels/qsgd_unpack/kernel.py).
struct QsgdUnpackSeg {
  const uint32_t* packed;  // (p_pod*p_data*rows*shard/bq, bq*bits/32) codes
  const float* scale;      // (p_pod*p_data*rows*shard/bq,) sigma a QSGD row
  float* out;              // (rows, p_data*shard)
  int p_pod, p_data, rows, shard, bq;
  float mean;
  int row_major;           // codes laid out (p_pod, rows, p_data, shard)
};

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileWords = 128;   // one 16-byte load a lane
constexpr int kMaxSegs = 48;      // keeps Params under the 4 KB parameter limit

struct Seg {                      // the kernel's view of one bucket
  const uint32_t* packed;
  const float* scale;
  float* out;
  int p_pod, rows, nbq;
  int upr;                        // output QSGD rows an output row: p_data*nbq
  int qstride;                    // QSGD rows a pod: p_data*rows*nbq
  int bq, words, tiles, tasks;    // tasks = rows*upr*tiles, one a warp
  float mean;
  int row_major;
};

struct Params {
  int nseg;
  int first_block[kMaxSegs + 1];
  Seg seg[kMaxSegs];
};
static_assert(sizeof(Params) <= 4096, "kernel parameters over 4 KB");

template <int BITS>
__global__ void __launch_bounds__(kThreads)
qsgd_unpack_grouped_kernel(const __grid_constant__ Params p) {
  constexpr int VPW = 32 / BITS;                 // codes a word
  constexpr int SPW = VPW / 4;                   // float4 slots a word
  constexpr int SLOTS = kTileWords * SPW / 32;   // slots a lane, full tile
  constexpr int S = (1 << (BITS - 1)) - 1;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  __shared__ uint4 stage[kWarps][kTileWords / 4];

  // the bucket of this block: the last s with first_block[s] <= blockIdx.x
  int lo = 0, hi = p.nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.first_block[mid] <= (int)blockIdx.x) lo = mid; else hi = mid - 1;
  }
  const Seg& g = p.seg[lo];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int task = ((int)blockIdx.x - p.first_block[lo]) * kWarps + warp;
  if (task >= g.tasks) return;                   // the whole warp leaves

  const int unit = task / g.tiles;               // output QSGD row, in order
  const int tile = task - unit * g.tiles;
  const int row = unit / g.upr;
  const int rq = unit - row * g.upr;             // rank*nbq + jq
  const int rank = rq / g.nbq;
  const int jq = rq - rank * g.nbq;
  const long long q0 =
      g.row_major ? unit : ((long long)rank * g.rows + row) * g.nbq + jq;
  const int w0 = tile * kTileWords;
  const int tw = min(kTileWords, g.words - w0);  // words in this tile
  const int ts = tw * SPW;                       // float4 slots in it
  const bool vec = (g.words & 3) == 0;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(stage[warp]);

  float4 acc[SLOTS];                             // the pod sum starts at +0,
#pragma unroll                                   // as the plain version's does
  for (int k = 0; k < SLOTS; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int pod = 0; pod < g.p_pod; ++pod) {
    const long long q = q0 + (long long)pod * g.qstride;
    const uint32_t* src = g.packed + q * g.words + w0;
    if (pod > 0) __syncwarp();                   // last pod's words are read
    if (vec) {
      if (lane < (tw >> 2))
        stage[warp][lane] = __ldcs(reinterpret_cast<const uint4*>(src) + lane);
    } else {
      uint32_t* dst = reinterpret_cast<uint32_t*>(stage[warp]);
      for (int i = lane; i < tw; i += 32) dst[i] = __ldcs(src + i);
    }
    __syncwarp();
    const float step = __fmul_rn(__ldg(g.scale + q), 1.0f / (float)S);
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int f = k * 32 + lane;
      if (f < ts) {
        const uint32_t w = sw[f / SPW] >> ((f % SPW) * 4 * BITS);
        float v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          v[t] = __fmul_rn((float)((int)((w >> (t * BITS)) & MASK) - S), step);
        acc[k].x = __fadd_rn(acc[k].x, v[0]);
        acc[k].y = __fadd_rn(acc[k].y, v[1]);
        acc[k].z = __fadd_rn(acc[k].z, v[2]);
        acc[k].w = __fadd_rn(acc[k].w, v[3]);
      }
    }
  }
  float4* out4 = reinterpret_cast<float4*>(g.out + (long long)unit * g.bq) +
                 w0 * SPW;
  const float m = g.mean;
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int f = k * 32 + lane;
    if (f < ts)
      __stcs(out4 + f, make_float4(__fmul_rn(acc[k].x, m), __fmul_rn(acc[k].y, m),
                                   __fmul_rn(acc[k].z, m), __fmul_rn(acc[k].w, m)));
  }
}

int launch(Params& p, int n, long long blocks, int bits, cudaStream_t stream,
           int* launched) {
  if (n == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.nseg = n;
  p.first_block[n] = (int)blocks;
  const dim3 grid((unsigned)blocks);
  switch (bits) {
    case 2: qsgd_unpack_grouped_kernel<2><<<grid, kThreads, 0, stream>>>(p); break;
    case 4: qsgd_unpack_grouped_kernel<4><<<grid, kThreads, 0, stream>>>(p); break;
    case 8: qsgd_unpack_grouped_kernel<8><<<grid, kThreads, 0, stream>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  ++*launched;
  return (int)cudaGetLastError();
}

}  // namespace

// Unpacks nseg buckets, kMaxSegs non-empty ones to a launch, and sets
// *launched to the number of kernels launched. Returns a CUDA error code.
extern "C" int qsgd_unpack_grouped_f32(const QsgdUnpackSeg* segs, int nseg,
                                       int bits, cudaStream_t stream,
                                       int* launched) {
  *launched = 0;
  if (nseg < 0 || (bits != 2 && bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  const int vpw = 32 / bits;
  Params p;
  int n = 0;
  long long blocks = 0;
  for (int i = 0; i < nseg; ++i) {
    const QsgdUnpackSeg& s = segs[i];
    if (s.p_pod < 1 || s.p_data < 1 || s.rows < 0 || s.shard < 0 ||
        s.bq < 1 || s.bq % vpw || s.shard % s.bq)
      return (int)cudaErrorInvalidValue;
    const long long nbq = s.shard / s.bq;
    const long long words = s.bq / vpw;
    const long long tiles = (words + kTileWords - 1) / kTileWords;
    const long long units = (long long)s.rows * s.p_data * nbq;
    if ((long long)s.p_pod * units * s.bq > 0x7fffffffLL ||
        units * tiles > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    if (units == 0) continue;
    Seg& g = p.seg[n];
    g.packed = s.packed;
    g.scale = s.scale;
    g.out = s.out;
    g.p_pod = s.p_pod;
    g.rows = s.rows;
    g.nbq = (int)nbq;
    g.upr = s.p_data * (int)nbq;
    g.qstride = (int)units;
    g.bq = s.bq;
    g.words = (int)words;
    g.tiles = (int)tiles;
    g.tasks = (int)(units * tiles);
    g.mean = s.mean;
    g.row_major = s.row_major;
    p.first_block[n] = (int)blocks;
    blocks += (g.tasks + kWarps - 1) / kWarps;
    if (++n == kMaxSegs) {
      const int rc = launch(p, n, blocks, bits, stream, launched);
      if (rc != (int)cudaSuccess) return rc;
      n = 0;
      blocks = 0;
    }
  }
  return launch(p, n, blocks, bits, stream, launched);
}
