// QSGD bucketed stochastic quantization + bit-packing, grouped over buckets,
// reading each bucket's QSGD rows where they lie in the summed buffer.
//
// Replaces the Pallas TPU kernel src/repro/kernels/qsgd_pack/kernel.py
// (qsgd_pack_pallas / _kernel), together with the copy the reference's
// stacked executor makes before it (src/repro/comm/executor.py,
// reduce_buckets_spmd: the transpose(0, 2, 1, 3) of the (p_pod, rows,
// p_data*shard) pod sums into (p_pod, p_data, rows, shard) QSGD rows).
// For each QSGD row (Bq entries):
//   sigma = L2 norm (l2) or max |x| (max)
//   level = clip(floor(|x| / sigma * s + rand * 2^-32), 0, s), s = 2^(bits-1)-1
//   code  = sign(x) * level + s   (code s for every entry of a sigma == 0 row)
// and code j of each word sits at bit j * bits of its u32.
//
// Layout: QSGD row q = ((pod*p_data + rank)*rows + row)*(shard/bq) + jq of
// a segment starts at x[((pod*rows + row)*p_data + rank)*shard + jq*bq]
// (the (p_pod, rows, p_data*shard) sum read in the reference's transposed
// order, with no copy; with p_pod = p_data = 1 that is x[q*bq], the
// single-bucket and per-rank forms' contiguous rows). Its rounding
// bits are rand[q*bq ...] and its codes go to packed[q] and scale[q]: the
// layout kernels/qsgd_unpack reads.
//
// Bound: bytes. x and rand are read once (8 bytes an entry), the packed
// codes written once (bits/8 bytes an entry) and sigma once a row.
//
// Design:
// - Launches. One launch covers up to kMaxSegs buckets; their descriptors
//   travel by value in a __grid_constant__ parameter and a block finds its
//   bucket by a binary search over the first-block prefix (as
//   csrc/qsgd_unpack.cu does). (The earlier form, one launch a bucket on a
//   contiguous copy, took 1.262 ms a step at lm-100m with the host, 0.832
//   device alone, on H100 80GB HBM3 at 700 W, measured by chip_smoke.py.)
// - Work. A warp owns one QSGD row. Lane l loads float4 slots l, l + 32, ...
//   of x and of rand (512 contiguous bytes a warp instruction), all of a
//   1024-entry tile before the first is used, and keeps them in registers:
//   sigma is a per-lane sum (or max) and a warp shuffle reduction, then the
//   codes come from the registers, with no second read. A word's codes
//   span 32/bits entries, 1 to 4 adjacent lanes' slots: each lane ORs its
//   own codes at their bit positions and the lanes of a word OR theirs
//   together by shuffles; the word's first lane stores it. Rows longer than
//   a tile read x twice (the later tiles again for the codes).
// - Every float operation is an explicit round-to-nearest intrinsic (the
//   library is also built with -fmad=false), so no multiply-add is
//   contracted and a level is the one the reference computes. A zero entry
//   skips the division (its quotient is +0 either way): the IEEE division
//   runs its slow path for a zero dividend, and a DSAR sum of top-k streams
//   is mostly zeros (at lm-100m at most 4 x 8 of every 512 entries are
//   nonzero).
#include <cuda_runtime.h>
#include <stdint.h>

// One bucket as the host describes it (mirrored by kernels/qsgd_pack/kernel.py).
struct QsgdPackSeg {
  const float* x;          // p_pod*rows*p_data*shard f32, the summed buffer
  const uint32_t* rand;    // the same count of u32, in QSGD-row order
  uint32_t* packed;        // (nq, bq*bits/32), nq = p_pod*p_data*rows*shard/bq
  float* scale;            // (nq,)
  int p_pod, p_data, rows, shard, bq;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 8;                      // float4 slots a lane a tile
constexpr int kTile = 32 * kSlots * 4;         // 1024 entries
constexpr int kMaxSegs = 48;                   // keeps Params under 4 KB
constexpr float kU32ToUnit = 2.3283064365386963e-10f;  // 2^-32

struct Seg {                                   // the kernel's view of one bucket
  const float* x;
  const uint32_t* rand;
  uint32_t* packed;
  float* scale;
  int rows, p_data, shard, nbq, bq, nq;
};

struct Params {
  int nseg;
  int max_mode;
  int first_block[kMaxSegs + 1];
  Seg seg[kMaxSegs];
};
static_assert(sizeof(Params) <= 4096, "kernel parameters over 4 KB");

__device__ __forceinline__ float combine(float a, float b, bool max_mode) {
  return max_mode ? fmaxf(a, b) : __fadd_rn(a, b);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ uint4 ld4u(const uint32_t* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

// The codes of one float4 slot, at their bit positions in its word.
template <int BITS>
__device__ __forceinline__ uint32_t slot_bits(float4 a, uint4 u, int slot,
                                              bool live, float safe) {
  constexpr int S = (1 << (BITS - 1)) - 1;
  constexpr int SPW = 32 / BITS / 4;           // float4 slots a word
  const float xs[4] = {a.x, a.y, a.z, a.w};
  const uint32_t rs[4] = {u.x, u.y, u.z, u.w};
  uint32_t bits = 0u;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float v = __fmul_rn(__uint2float_rn(rs[t]), kU32ToUnit);
    // |x| / sigma; a zero quotient without the division, whose IEEE
    // sequence takes its slow path for a zero dividend (most entries of a
    // sum of top-k streams)
    const float a = fabsf(xs[t]);
    const float qt = a == 0.0f ? 0.0f : __fdiv_rn(a == 0.0f ? 1.0f : a, safe);
    float lv = floorf(__fadd_rn(__fmul_rn(qt, (float)S), v));
    lv = fminf(fmaxf(lv, 0.0f), (float)S);
    const int level = (int)lv;
    const int code = live ? (xs[t] < 0.0f ? -level : level) + S : S;
    bits |= (uint32_t)code << (((slot % SPW) * 4 + t) * BITS);
  }
  return bits;
}

// OR a word's bits across its lanes, and store it from the word's first lane.
template <int BITS>
__device__ __forceinline__ void store_word(uint32_t bits, int slot, int n4,
                                           uint32_t* packed, int lane) {
  constexpr int SPW = 32 / BITS / 4;
#pragma unroll
  for (int off = 1; off < SPW; off <<= 1)
    bits |= __shfl_xor_sync(kFull, bits, off);
  if (slot < n4 && lane % SPW == 0) packed[slot / SPW] = bits;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
qsgd_pack_grouped_kernel(const __grid_constant__ Params p) {
  // the bucket of this block: the last s with first_block[s] <= blockIdx.x
  int lo = 0, hi = p.nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.first_block[mid] <= (int)blockIdx.x) lo = mid; else hi = mid - 1;
  }
  const Seg& g = p.seg[lo];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = ((int)blockIdx.x - p.first_block[lo]) * kWarps + warp;
  if (q >= g.nq) return;                       // the whole warp leaves
  const bool max_mode = p.max_mode != 0;

  const int jq = q % g.nbq;                    // the row's first entry in x
  int t = q / g.nbq;
  const int row = t % g.rows;
  t /= g.rows;
  const int rank = t % g.p_data;
  const int pod = t / g.p_data;
  const long long off =
      (((long long)pod * g.rows + row) * g.p_data + rank) * g.shard +
      (long long)jq * g.bq;
  const float* xr = g.x + off;
  const uint32_t* rr = g.rand + (long long)q * g.bq;
  uint32_t* pr = g.packed + (long long)q * (g.bq / (32 / BITS));
  const int n4 = g.bq >> 2;                    // float4 slots in the row

  float4 xs[kSlots];
  uint4 rs[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int f = i * 32 + lane;
    if (f < n4) {
      xs[i] = ld4(xr + 4 * f);
      rs[i] = ld4u(rr + 4 * f);
    } else {
      xs[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      rs[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const float4 a = xs[i];
    if (max_mode) {
      acc = fmaxf(fmaxf(acc, fmaxf(fabsf(a.x), fabsf(a.y))),
                  fmaxf(fabsf(a.z), fabsf(a.w)));
    } else {
      acc = __fadd_rn(acc, __fmul_rn(a.x, a.x));
      acc = __fadd_rn(acc, __fmul_rn(a.y, a.y));
      acc = __fadd_rn(acc, __fmul_rn(a.z, a.z));
      acc = __fadd_rn(acc, __fmul_rn(a.w, a.w));
    }
  }
  for (int f0 = kTile / 4; f0 < n4; f0 += kTile / 4) {   // rows over a tile
    for (int f = f0 + lane; f < min(n4, f0 + kTile / 4); f += 32) {
      const float4 a = ld4(xr + 4 * f);
      if (max_mode) {
        acc = fmaxf(fmaxf(acc, fmaxf(fabsf(a.x), fabsf(a.y))),
                    fmaxf(fabsf(a.z), fabsf(a.w)));
      } else {
        acc = __fadd_rn(acc, __fmul_rn(a.x, a.x));
        acc = __fadd_rn(acc, __fmul_rn(a.y, a.y));
        acc = __fadd_rn(acc, __fmul_rn(a.z, a.z));
        acc = __fadd_rn(acc, __fmul_rn(a.w, a.w));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = combine(acc, __shfl_xor_sync(kFull, acc, o), max_mode);
  const float sigma = max_mode ? acc : __fsqrt_rn(acc);
  if (lane == 0) g.scale[q] = sigma;
  const bool live = sigma > 0.0f;
  const float safe = live ? sigma : 1.0f;

#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int f = i * 32 + lane;
    const uint32_t bits = f < n4 ? slot_bits<BITS>(xs[i], rs[i], f, live, safe)
                                 : 0u;
    store_word<BITS>(bits, f, n4, pr, lane);
  }
  for (int f0 = kTile / 4; f0 < n4; f0 += 32) {          // rows over a tile
    const int f = f0 + lane;
    uint32_t bits = 0u;
    if (f < n4)
      bits = slot_bits<BITS>(ld4(xr + 4 * f), ld4u(rr + 4 * f), f, live, safe);
    store_word<BITS>(bits, f, n4, pr, lane);
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
    case 2: qsgd_pack_grouped_kernel<2><<<grid, kThreads, 0, stream>>>(p); break;
    case 4: qsgd_pack_grouped_kernel<4><<<grid, kThreads, 0, stream>>>(p); break;
    case 8: qsgd_pack_grouped_kernel<8><<<grid, kThreads, 0, stream>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  ++*launched;
  return (int)cudaGetLastError();
}

}  // namespace

// Packs nseg buckets, kMaxSegs non-empty ones to a launch, and sets
// *launched to the number of kernels launched. Returns a CUDA error code.
extern "C" int qsgd_pack_grouped_f32(const QsgdPackSeg* segs, int nseg,
                                     int bits, int max_mode,
                                     cudaStream_t stream, int* launched) {
  *launched = 0;
  if (nseg < 0 || (bits != 2 && bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  const int vpw = 32 / bits;
  Params p;
  p.max_mode = max_mode;
  int n = 0;
  long long blocks = 0;
  for (int i = 0; i < nseg; ++i) {
    const QsgdPackSeg& s = segs[i];
    if (s.p_pod < 1 || s.p_data < 1 || s.rows < 0 || s.shard < 0 ||
        s.bq < 4 || s.bq % vpw || s.bq % 4 || s.shard % s.bq)
      return (int)cudaErrorInvalidValue;
    const long long nq =
        (long long)s.p_pod * s.p_data * s.rows * (s.shard / s.bq);
    if (nq > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (nq == 0) continue;
    Seg& g = p.seg[n];
    g.x = s.x;
    g.rand = s.rand;
    g.packed = s.packed;
    g.scale = s.scale;
    g.rows = s.rows;
    g.p_data = s.p_data;
    g.shard = s.shard;
    g.nbq = s.shard / s.bq;
    g.bq = s.bq;
    g.nq = (int)nq;
    p.first_block[n] = (int)blocks;
    blocks += (nq + kWarps - 1) / kWarps;
    if (++n == kMaxSegs) {
      const int rc = launch(p, n, blocks, bits, stream, launched);
      if (rc != (int)cudaSuccess) return rc;
      n = 0;
      blocks = 0;
    }
  }
  return launch(p, n, blocks, bits, stream, launched);
}
