// Per-bucket top-k selection with the fused error-feedback residual.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bucket_topk/kernel.py
// (bucket_topk_pallas / _kernel). For each row of x (nb, B):
//   lidx: the k positions of largest |x|, ties to the lower index, ascending
//   val:  x at those positions
//   res:  x with those positions set to +0.0
//
// Bound: bytes. Each row is read once (B floats) and res written once
// (B floats); val/lidx add 8k bytes. The selection's cost does not grow
// with k, so the kernel stays near the memory roofline at every k.
//
// Design: one warp per row, the row in registers. Lane l holds elements
// j*32 + l (j < B/32), so every load and store of the warp is 128
// contiguous bytes. The key of an element is the bit pattern of |x|: 31
// bits that, with the sign bit clear, order like the magnitude (denormals
// and infinities included). The selection does no float arithmetic at all;
// it moves and compares bit patterns.
//
// Selection is a radix select of the threshold T, the k-th largest key, in
// at most four digit passes whatever k is (the Pallas kernel runs k argmax
// rounds a row, one after another). Pass p counts, in a
// 256-bin histogram private to the warp in shared memory (1 KB), digit p
// (key bits 30-23, 22-15, 14-7, 6-0) of every key whose higher bits equal
// the prefix found so far. A suffix sum over the bins (8 a lane, then
// across the lanes) finds the digit whose bin holds the k-th key from the
// top. When that bin holds exactly the keys still needed, the remaining
// passes are skipped: every key in it is taken.
//
// Every key above the final bin is selected, and of the keys inside it
// the `need` lowest-indexed: a ballot per column j and a popcount prefix
// give each one its rank in index order, with no sort. So ties go to the
// lower index, as in the plain version's stable sort; k == B, all-zero
// rows (+0.0 and -0.0 both have key 0) and rows of one magnitude need no
// special case. The same pass compacts the selected mask with a ballot and
// a popcount prefix per column, which gives lidx in ascending order, and
// writes res.
//
// Pass 1's digit is the exponent, which Gaussian gradients concentrate in
// a few bins, so lanes of one instruction often add to one bin. The
// shared-memory unit serialises those conflicts; aggregating each group
// with __match_any_sync into one atomic measured no faster (up to 10 %
// slower at B = 1024, PERF.md), so plain atomics stay.
//
// B takes every multiple of 128 up to 8192 (bucket_scatter's limit too).
// Up to B = 1024 the warp above holds the row in registers, B/32 keys a
// lane (warp_select<VPL>). Above 1024 a row no longer fits a warp's
// registers, and block_select gives it a block of 256 threads and holds it
// in shared memory (32 KB at 8192): the same digit passes on one
// block-wide 256-bin histogram, whose suffix sum runs by shuffles in each
// warp and across the 8 warps' totals, and the same tie rule. The
// selection walks the row in chunks of 256 keys in index order; inside a
// chunk a key's rank among the tied keys (and its place among the selected
// ones) is its warp's ballot prefix plus the counts of the lower warps of
// the chunk plus those of every earlier chunk. It is the first, simple
// form of the large-B path: one row a block, one pass over shared memory a
// digit.
//
// Two entry points share the selection:
// - bucket_topk_f32: the rows of one (nb, B) tensor x, one launch.
// - bucket_topk_ef_grouped_f32: error feedback fused in, grouped over the
//   EF buckets of one packed group buffer (the stacked executor, one call
//   a fusion group). A descriptor a bucket (BucketTopkEfSeg) names its
//   residual r (L, rows, cols), its gradient slice g inside the packed
//   (L, rows, group cols) buffer (rank and row strides: a bucket's
//   columns are contiguous only within a row), the new residual and the
//   bucket's val/lidx in the step's stream buffers. Each B-wide row loads
//   r and g and adds them in registers, r + g with one IEEE round to
//   nearest (__fadd_rn, the add of the executor's `res + seg`, so the same
//   bits); the sum is the row the selection takes, and is never stored.
//   One launch covers up to kMaxEfSegs buckets of one B; their descriptors
//   travel by value in a __grid_constant__ parameter, and a block finds its
//   bucket by a binary search over the descriptors' first-block prefix (as
//   csrc/qsgd_unpack.cu does). Bound: bytes, 12 an element (r and g read,
//   r' written) against the unfused pair's 20 (the add's 12, then 8).
#include <cuda_runtime.h>
#include <stdint.h>

// One EF bucket of a grouped call as the host describes it (mirrored by
// kernels/bucket_topk/kernel.py).
struct BucketTopkEfSeg {
  const float* res;        // (l, rows, cols) contiguous: the residual r
  const float* grad;       // element (i, r, c) at grad[i*rank_stride +
                           //   r*row_stride + c]: the gradient slice g
  float* res_out;          // (l, rows, cols): r + g, the selected entries +0
  float* val;              // (l, rows, cols/b, k)
  int32_t* lidx;           // (l, rows, cols/b, k)
  long long rank_stride;   // floats
  long long row_stride;    // floats
  int l, rows, cols, k, b;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kAbs = 0x7fffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kBins = 256;
constexpr int kPasses = 4;
constexpr int kBlockThreads = kWarpsPerBlock * 32;
constexpr int kMaxWarpB = 1024;
constexpr int kMaxB = 8192;
constexpr int kMaxEfSegs = 48;   // keeps EfParams under the 4 KB limit

// The selection of one row held by a warp: key[j] is the |x| bits of
// element j*32 + lane and bit j of neg its sign. Writes val/lidx (k each)
// and res (the row, the selected entries +0). hist: the warp's 256 bins.
template <int VPL>
__device__ __forceinline__ void warp_select(const uint32_t (&key)[VPL],
                                            uint32_t neg, uint32_t* hist,
                                            int lane, int k,
                                            uint32_t* __restrict__ valr,
                                            int32_t* __restrict__ lidxr,
                                            uint32_t* __restrict__ resr) {
  uint4* my_bins = reinterpret_cast<uint4*>(hist) + 2 * lane;  // 8*lane..+7
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  my_bins[0] = zero;
  my_bins[1] = zero;
  __syncwarp();

  uint32_t prefix = 0u;          // the digits found so far
  uint32_t need = (uint32_t)k;   // keys still to take inside the prefix's bin
  int low = 31;                  // bits below `low` are not decided yet
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int shift = p == kPasses - 1 ? 0 : 23 - 8 * p;
    const uint32_t digit_mask = (1u << (low - shift)) - 1u;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (p == 0) {
        atomicAdd(&hist[key[j] >> shift], 1u);
      } else if ((key[j] >> low) == (prefix >> low)) {
        atomicAdd(&hist[(key[j] >> shift) & digit_mask], 1u);
      }
    }
    __syncwarp();
    const uint4 lo4 = my_bins[0], hi4 = my_bins[1];
    const uint32_t c[8] = {lo4.x, lo4.y, lo4.z, lo4.w,
                           hi4.x, hi4.y, hi4.z, hi4.w};
    uint32_t mine = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) mine += c[i];
    uint32_t incl = mine;  // keys in this lane's bins and every higher lane's
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t t = __shfl_down_sync(kFull, incl, off);
      if (lane + off < 32) incl += t;
    }
    // incl falls as the lane grows: the last lane with incl >= need holds
    // the bin of the need-th key from the top
    const int owner = 31 - __clz(__ballot_sync(kFull, incl >= need));
    uint32_t above = incl - mine, bin = 0u, count = 0u;
    bool found = false;
#pragma unroll
    for (int i = 7; i >= 0; --i) {
      if (!found) {
        if (above + c[i] >= need) {
          found = true;
          bin = i;
          count = c[i];
        } else {
          above += c[i];
        }
      }
    }
    bin = __shfl_sync(kFull, 8u * lane + bin, owner);
    above = __shfl_sync(kFull, above, owner);
    count = __shfl_sync(kFull, count, owner);
    __syncwarp();  // every lane has read its bins
    my_bins[0] = zero;
    my_bins[1] = zero;
    __syncwarp();
    need -= above;
    prefix |= bin << shift;
    low = shift;
    if (count == need) break;  // the bin holds exactly the keys still needed
  }

  // keys above the bin are taken; inside it the `need` lowest indices
  const uint32_t top = prefix | ((1u << low) - 1u);
  const unsigned below = (1u << lane) - 1u;
  uint32_t taken = 0u, tied = 0u;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const bool in_bin = (key[j] >> low) == (prefix >> low);
    const unsigned tie = __ballot_sync(kFull, in_bin);
    const bool s = key[j] > top ||
                   (in_bin && tied + __popc(tie & below) < need);
    tied += __popc(tie);
    const unsigned sel = __ballot_sync(kFull, s);
    const uint32_t bits = key[j] | (((neg >> j) & 1u) << 31);
    if (s) {
      const int pos = taken + __popc(sel & below);
      valr[pos] = bits;
      lidxr[pos] = j * 32 + lane;
    }
    taken += __popc(sel);
    resr[j * 32 + lane] = s ? 0u : bits;
  }
}

// The selection of one row of b bits held in shared memory (row_s) by a
// block of kBlockThreads; the same outputs as warp_select.
__device__ __forceinline__ void block_select(const uint32_t* row_s, int b,
                                             int k,
                                             uint32_t* __restrict__ valr,
                                             int32_t* __restrict__ lidxr,
                                             uint32_t* __restrict__ resr) {
  __shared__ uint32_t hist[kBins];
  __shared__ uint32_t warp_count[kWarpsPerBlock];
  __shared__ uint32_t warp_count2[kWarpsPerBlock];
  __shared__ uint32_t found[3];  // the bin, keys above it, keys in it
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  uint32_t prefix = 0u;          // the digits found so far
  uint32_t need = (uint32_t)k;   // keys still to take inside the prefix's bin
  int low = 31;                  // bits below `low` are not decided yet
  for (int p = 0; p < kPasses; ++p) {
    const int shift = p == kPasses - 1 ? 0 : 23 - 8 * p;
    const uint32_t digit_mask = (1u << (low - shift)) - 1u;
    hist[t] = 0u;
    __syncthreads();  // the bins are zero and the row is loaded
    for (int i = t; i < b; i += kBlockThreads) {
      const uint32_t key = row_s[i] & kAbs;
      if ((key >> low) == (prefix >> low))
        atomicAdd(&hist[(key >> shift) & digit_mask], 1u);
    }
    __syncthreads();
    // incl: keys in bin t and every higher bin
    const uint32_t c = hist[t];
    uint32_t incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t v = __shfl_down_sync(kFull, incl, off);
      if (lane + off < 32) incl += v;
    }
    if (lane == 0) warp_count[warp] = incl;
    __syncthreads();
    for (int w = warp + 1; w < kWarpsPerBlock; ++w) incl += warp_count[w];
    // incl falls as the bin grows: exactly one bin reaches `need` while
    // the bins above it do not
    if (incl >= need && incl - c < need) {
      found[0] = (uint32_t)t;
      found[1] = incl - c;
      found[2] = c;
    }
    __syncthreads();
    need -= found[1];
    prefix |= found[0] << shift;
    low = shift;
    if (found[2] == need) break;  // the bin holds exactly the keys still needed
  }

  // keys above the bin are taken; inside it the `need` lowest indices
  const uint32_t top = prefix | ((1u << low) - 1u);
  const unsigned below = (1u << lane) - 1u;
  uint32_t tied = 0u, taken = 0u;  // in the chunks before this one
  for (int base = 0; base < b; base += kBlockThreads) {
    const int i = base + t;
    const bool live = i < b;     // whole warps: b is a multiple of 128
    const uint32_t bits = live ? row_s[i] : 0u;
    const uint32_t key = bits & kAbs;
    const bool in_bin = live && (key >> low) == (prefix >> low);
    const unsigned tie = __ballot_sync(kFull, in_bin);
    if (lane == 0) warp_count[warp] = __popc(tie);
    __syncthreads();
    uint32_t tie_before = tied, tie_chunk = 0u;
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      const uint32_t n = warp_count[w];
      tie_before += w < warp ? n : 0u;
      tie_chunk += n;
    }
    const bool s = live && (key > top ||
                            (in_bin && tie_before + __popc(tie & below) < need));
    const unsigned sel = __ballot_sync(kFull, s);
    if (lane == 0) warp_count2[warp] = __popc(sel);
    __syncthreads();
    uint32_t sel_before = taken, sel_chunk = 0u;
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      const uint32_t n = warp_count2[w];
      sel_before += w < warp ? n : 0u;
      sel_chunk += n;
    }
    if (s) {
      const uint32_t pos = sel_before + __popc(sel & below);
      valr[pos] = bits;
      lidxr[pos] = i;
    }
    if (live) resr[i] = s ? 0u : bits;
    tied += tie_chunk;
    taken += sel_chunk;
    __syncthreads();  // the counts are read before the next chunk's
  }
}

template <int VPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bucket_topk_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ val,
                   int32_t* __restrict__ lidx, uint32_t* __restrict__ res,
                   long long nb, int k) {
  constexpr int B = VPL * 32;
  __shared__ __align__(16) uint32_t hist_block[kWarpsPerBlock][kBins];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= nb) return;  // uniform over the warp

  const uint32_t* xr = x + row * B;
  uint32_t key[VPL];
  uint32_t neg = 0u;  // bit j: element j*32 + lane has its sign bit set
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const uint32_t bits = xr[j * 32 + lane];
    key[j] = bits & kAbs;
    neg |= (bits >> 31) << j;
  }
  warp_select<VPL>(key, neg, hist_block[warp], lane, k, val + row * k,
                   lidx + row * k, res + row * B);
}

__global__ void __launch_bounds__(kBlockThreads)
bucket_topk_block_kernel(const uint32_t* __restrict__ x,
                         uint32_t* __restrict__ val,
                         int32_t* __restrict__ lidx,
                         uint32_t* __restrict__ res, int b, int k) {
  extern __shared__ __align__(16) uint32_t row_s[];  // the row's bits, B words
  const long long row = blockIdx.x;
  const uint4* xr4 = reinterpret_cast<const uint4*>(x + row * b);
  uint4* row4 = reinterpret_cast<uint4*>(row_s);
  for (int i = threadIdx.x; i < b / 4; i += kBlockThreads) row4[i] = xr4[i];
  block_select(row_s, b, k, val + row * k, lidx + row * k, res + row * b);
}

// ------------------------------------------------------------ grouped EF

struct EfSeg {                   // the kernel's view of one EF bucket
  const float* res;
  const float* grad;
  uint32_t* res_out;
  uint32_t* val;
  int32_t* lidx;
  long long rank_stride, row_stride;
  int per_rank;                  // B-wide rows a rank: rows * m
  int m;                         // B-wide rows a canonical row: cols / b
  int nrows;                     // l * per_rank
  int k;
};

struct EfParams {
  int nseg;
  int first_block[kMaxEfSegs + 1];
  EfSeg seg[kMaxEfSegs];
};
static_assert(sizeof(EfParams) <= 4096, "kernel parameters over 4 KB");

// the bucket of this block: the last s with first_block[s] <= blockIdx.x
__device__ __forceinline__ int find_seg(const EfParams& p) {
  int lo = 0, hi = p.nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.first_block[mid] <= (int)blockIdx.x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Offset in floats of bucket row q's gradient inside the group buffer:
// q = (rank * rows + row) * m + c, the row order of the residual.
__device__ __forceinline__ long long grad_offset(const EfSeg& g, int q,
                                                 int b) {
  const int rank = q / g.per_rank;
  const int rem = q - rank * g.per_rank;
  const int row = rem / g.m;
  const int c = rem - row * g.m;
  return rank * g.rank_stride + row * g.row_stride + (long long)c * b;
}

template <int VPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bucket_topk_ef_grouped_kernel(const __grid_constant__ EfParams p) {
  constexpr int B = VPL * 32;
  __shared__ __align__(16) uint32_t hist_block[kWarpsPerBlock][kBins];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = find_seg(p);
  const EfSeg& g = p.seg[s];
  const int q = ((int)blockIdx.x - p.first_block[s]) * kWarpsPerBlock + warp;
  if (q >= g.nrows) return;  // uniform over the warp

  const float* rr = g.res + (long long)q * B;
  const float* gr = g.grad + grad_offset(g, q, B);
  uint32_t key[VPL];
  uint32_t neg = 0u;  // bit j: element j*32 + lane has its sign bit set
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const uint32_t bits =
        __float_as_uint(__fadd_rn(rr[j * 32 + lane], gr[j * 32 + lane]));
    key[j] = bits & kAbs;
    neg |= (bits >> 31) << j;
  }
  warp_select<VPL>(key, neg, hist_block[warp], lane, g.k,
                   g.val + (long long)q * g.k, g.lidx + (long long)q * g.k,
                   g.res_out + (long long)q * B);
}

__global__ void __launch_bounds__(kBlockThreads)
bucket_topk_ef_grouped_block_kernel(const __grid_constant__ EfParams p,
                                    int b) {
  extern __shared__ __align__(16) uint32_t row_s[];  // r + g's bits, B words
  const int s = find_seg(p);
  const EfSeg& g = p.seg[s];
  const int q = (int)blockIdx.x - p.first_block[s];  // one row a block
  const float4* r4 = reinterpret_cast<const float4*>(g.res + (long long)q * b);
  const float4* g4 =
      reinterpret_cast<const float4*>(g.grad + grad_offset(g, q, b));
  uint4* row4 = reinterpret_cast<uint4*>(row_s);
  for (int i = threadIdx.x; i < b / 4; i += kBlockThreads) {
    const float4 a = r4[i], d = g4[i];
    row4[i] = make_uint4(__float_as_uint(__fadd_rn(a.x, d.x)),
                         __float_as_uint(__fadd_rn(a.y, d.y)),
                         __float_as_uint(__fadd_rn(a.z, d.z)),
                         __float_as_uint(__fadd_rn(a.w, d.w)));
  }
  block_select(row_s, b, g.k, g.val + (long long)q * g.k,
               g.lidx + (long long)q * g.k, g.res_out + (long long)q * b);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0u;
}

int launch_ef(EfParams& p, int n, long long blocks, int b,
              cudaStream_t stream, int* launched) {
  if (n == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.nseg = n;
  p.first_block[n] = (int)blocks;
  const dim3 grid((unsigned)blocks);
  if (b > kMaxWarpB) {
    bucket_topk_ef_grouped_block_kernel<<<grid, kBlockThreads,
                                          b * sizeof(uint32_t), stream>>>(p, b);
  } else {
    const dim3 block(kWarpsPerBlock * 32);
#define TOPK_EF_WARP(VPL)                                                   \
  case VPL:                                                                 \
    bucket_topk_ef_grouped_kernel<VPL><<<grid, block, 0, stream>>>(p);      \
    break;
    switch (b / 32) {
      TOPK_EF_WARP(4) TOPK_EF_WARP(8) TOPK_EF_WARP(12) TOPK_EF_WARP(16)
      TOPK_EF_WARP(20) TOPK_EF_WARP(24) TOPK_EF_WARP(28) TOPK_EF_WARP(32)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef TOPK_EF_WARP
  }
  ++*launched;
  return (int)cudaGetLastError();
}

}  // namespace

// x (nb, b) -> val (nb, k), lidx (nb, k), res (nb, b). b is a multiple of
// 128 up to 8192 and 1 <= k <= b; returns a CUDA error code.
extern "C" int bucket_topk_f32(const float* x, float* val, int32_t* lidx,
                               float* res, long long nb, int b, int k,
                               cudaStream_t stream) {
  if (nb <= 0) return (int)cudaSuccess;
  if (k < 1 || k > b || b < 128 || b % 128 || b > kMaxB)
    return (int)cudaErrorInvalidValue;
  const uint32_t* xu = reinterpret_cast<const uint32_t*>(x);
  uint32_t* vu = reinterpret_cast<uint32_t*>(val);
  uint32_t* ru = reinterpret_cast<uint32_t*>(res);
  if (b > kMaxWarpB) {
    if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    bucket_topk_block_kernel<<<(unsigned)nb, kBlockThreads,
                               b * sizeof(uint32_t), stream>>>(xu, vu, lidx,
                                                               ru, b, k);
    return (int)cudaGetLastError();
  }
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((unsigned)((nb + kWarpsPerBlock - 1) / kWarpsPerBlock));
#define TOPK_WARP(VPL)                                                      \
  case VPL:                                                                 \
    bucket_topk_kernel<VPL><<<grid, block, 0, stream>>>(xu, vu, lidx, ru,   \
                                                        nb, k);             \
    break;
  switch (b / 32) {
    TOPK_WARP(4) TOPK_WARP(8) TOPK_WARP(12) TOPK_WARP(16)
    TOPK_WARP(20) TOPK_WARP(24) TOPK_WARP(28) TOPK_WARP(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TOPK_WARP
  return (int)cudaGetLastError();
}

// The fused EF add + TopK of nseg buckets (see the top of the file), up to
// kMaxEfSegs non-empty ones of one b to a launch; sets *launched to the
// number of kernels launched. Every descriptor is checked before the first
// launch. Returns a CUDA error code.
extern "C" int bucket_topk_ef_grouped_f32(const BucketTopkEfSeg* segs,
                                          int nseg, cudaStream_t stream,
                                          int* launched) {
  *launched = 0;
  if (nseg < 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nseg; ++i) {
    const BucketTopkEfSeg& s = segs[i];
    if (s.b < 128 || s.b % 128 || s.b > kMaxB || s.k < 1 || s.k > s.b ||
        s.l < 0 || s.rows < 0 || s.cols < 0 || s.cols % s.b ||
        s.rank_stride < 0 || s.row_stride < 0 ||
        (long long)s.l * s.rows * (s.cols / s.b) > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    // the large-B path loads float4: every row of r and g on 16 bytes
    if (s.b > kMaxWarpB && (s.rank_stride % 4 || s.row_stride % 4 ||
                            !aligned16(s.res) || !aligned16(s.grad)))
      return (int)cudaErrorInvalidValue;
  }
  EfParams p;
  int n = 0, b = 0;
  long long blocks = 0;
  for (int i = 0; i < nseg; ++i) {
    const BucketTopkEfSeg& s = segs[i];
    const int m = s.cols / s.b;
    const long long nrows = (long long)s.l * s.rows * m;
    if (nrows == 0) continue;
    if (n > 0 && s.b != b) {  // one b a launch
      const int rc = launch_ef(p, n, blocks, b, stream, launched);
      if (rc != (int)cudaSuccess) return rc;
      n = 0;
      blocks = 0;
    }
    b = s.b;
    EfSeg& g = p.seg[n];
    g.res = s.res;
    g.grad = s.grad;
    g.res_out = reinterpret_cast<uint32_t*>(s.res_out);
    g.val = reinterpret_cast<uint32_t*>(s.val);
    g.lidx = s.lidx;
    g.rank_stride = s.rank_stride;
    g.row_stride = s.row_stride;
    g.per_rank = s.rows * m;
    g.m = m;
    g.nrows = (int)nrows;
    g.k = s.k;
    p.first_block[n] = (int)blocks;
    blocks += b > kMaxWarpB ? nrows
                            : (nrows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (++n == kMaxEfSegs) {
      const int rc = launch_ef(p, n, blocks, b, stream, launched);
      if (rc != (int)cudaSuccess) return rc;
      n = 0;
      blocks = 0;
    }
  }
  return launch_ef(p, n, blocks, b, stream, launched);
}
