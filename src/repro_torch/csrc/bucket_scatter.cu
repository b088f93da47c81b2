// Densify bucket-uniform sparse streams and sum them in source order,
// grouped over buckets: for every segment (one bucket of a step),
//   out[g, r, c] = ((d_0 + d_1) + d_2) + ... + d_{S-1},
//   d_s[c]       = 0 + val[g, s, r, j] + ... over the j with lidx[g, s, r, j]
//                  == c, in j order,
// lidx/val (G, S, nb, k), out (G, nb, B). Indices outside [0, B) (the
// sentinels, negative ones) are dropped. S = 1 is the single-source
// densify.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bucket_scatter/kernel.py
// (bucket_scatter_pallas / _kernel), which builds a one-hot (TB, k, B)
// tensor and contracts it because a serialized scatter is slow on the TPU,
// together with the sum over ranks that the reference runs after it
// (src/repro/comm/executor.py reduce_buckets_spmd: dens.reshape(...)
// .sum(axis=1); core/allreduce.py: the owner's sum of its p sources). On
// Hopper the scatter is direct, and the (G, S, nb, B) stack of densified
// sources is never written.
//
// Bound: bytes. The output (G, nb, B) f32 is written once; the inputs add
// 8 bytes an entry, read once. The adds are one shared-memory update an
// entry.
//
// Exactness: the result is bit-equal to densifying each source (one
// scatter-add a j, in j order) and summing the sources in order, for every
// input, duplicates included. A source's entries are first summed per
// column (d_s, from +0, in j order) and only then added into the row, once a
// column: adding them into the row one by one would give (d + v_a) + v_b
// where the plain version gives d + (v_a + v_b). Adding a source's +0 at an
// untouched column changes nothing (the row never holds -0), so untouched
// columns are skipped.
//
// Design:
// - Launches. One launch covers up to kMaxSegs buckets (all 26 of
//   lm-100m); their descriptors travel by value in a __grid_constant__
//   parameter, and a block finds its bucket by a binary search over the
//   descriptors' first-block prefix (as csrc/qsgd_unpack.cu does).
// - Work. A warp owns kRowsPerWarp output rows in turn: a B-float row in
//   shared memory, zeroed, then the S sources' k-wide rows applied in
//   order, then one coalesced float4 store with the streaming hint
//   (__stcs). The entries go 32 lanes a chunk: with k <= 32 a chunk holds
//   32/k whole sources (lane l: entry l % k of source l / k), with k > 32
//   a source spans k/32 chunks. The loads of the next kBatch chunks (the
//   next row's, at a row's end) are in flight while the current ones are
//   applied, so a row seldom waits for global memory.
// - Adds. Where no two entries of a chunk share a column (each lane finds
//   its own lane id in a shared-memory tag row) or, with k > 32, a
//   source's valid indices rise strictly (every top-k stream; a shuffle
//   compare), every lane adds its value straight into the row. Otherwise
//   __match_any_sync groups the lanes of one column, and the lowest lane
//   sums the group in lane order: each source's part from +0, added into
//   the row in source order; with k > 32 onto the source's per-column sum
//   in a scratch row, which after the source's last chunk moves into the
//   row once a column (the first group of the column adds it and zeroes
//   the scratch, a later one adds +0). The common case needs no
//   __match_any_sync, the costliest instruction of the step.
// - Shared memory: per warp the row, the tag or scratch row (B floats
//   each) and a 32-float stage for the group sums; the host picks the
//   warps a block (1 to 8) so that a block stays within kSmemBudget.
#include <cuda_runtime.h>
#include <stdint.h>

// One bucket as the host describes it (mirrored by
// kernels/bucket_scatter/kernel.py).
struct BucketScatterSumSeg {
  const int32_t* lidx;  // (g, s, nb, k)
  const float* val;     // (g, s, nb, k)
  float* out;           // (g, nb, b)
  int g, s, nb, k, b;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kBatch = 4;             // chunks whose loads are in flight
constexpr int kRowsPerWarp = 2;
constexpr int kMinBlocks = 4;         // 64 registers a thread: 32 warps an SM
constexpr int kMaxSegs = 64;          // keeps Params under the 4 KB limit
constexpr int kMaxB = 8192;
constexpr int kSmemBudget = 96 * 1024;

struct Seg {                          // the kernel's view of one bucket
  const int32_t* lidx;
  const float* val;
  float* out;
  int s, nb, k, b, rows;              // rows = g * nb
};

struct Params {
  int nseg;
  int wpb;                            // warps a block
  int warp_floats;                    // shared floats a warp
  int first_block[kMaxSegs + 1];
  Seg seg[kMaxSegs];
};
static_assert(sizeof(Params) <= 4096, "kernel parameters over 4 KB");

// A row's entries in chunks of 32 lanes. k <= 32 ("flat"): chunk t holds
// spc = 32/k whole sources, lane l entry l % k of source t*spc + l/k.
// k > 32: chunk t is entries (t % nch)*32 + lane of source t / nch. A
// batch is bs chunks, whole sources when a source has at most kBatch
// chunks.
struct Geometry {
  int b, k, nb, S, spc, nch, steps, bs;
  bool flat;
};

__device__ __forceinline__ void load_batch(const Seg& g, const Geometry& q,
                                           int row, int t0, int lane,
                                           int (&cs)[kBatch],
                                           float (&vs)[kBatch]) {
  const int gi = row / q.nb;
  const long long src0 = ((long long)gi * q.S * q.nb + (row - gi * q.nb)) * q.k;
  const long long src_stride = (long long)q.nb * q.k;
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int t = t0 + i;
    int s, j;
    if (q.flat) {
      s = t * q.spc + lane / q.k;
      j = lane < q.spc * q.k ? lane % q.k : q.k;
    } else {
      s = t / q.nch;
      j = (t - s * q.nch) * 32 + lane;
    }
    cs[i] = -1;
    vs[i] = 0.0f;
    if (i < q.bs && t < q.steps && s < q.S && j < q.k) {
      const long long e = src0 + s * src_stride + j;
      cs[i] = __ldg(g.lidx + e);
      vs[i] = __ldg(g.val + e);
    }
  }
}

// The general step: group the lanes of each column (__match_any_sync);
// the group's lowest lane sums its values in lane (j) order, from +0 into
// the row when the source is one chunk, else onto the source's per-column
// sum in the scratch row. Returns whether this lane led a group.
// the lane order of a flat chunk is (source, j): the group's lanes of one
// source are summed from +0 and each source's sum is added into the row in
// source order
__device__ __forceinline__ bool match_step(int c, float v, const Geometry& q,
                                           float* row, float* scr,
                                           float* stage, int lane) {
  const bool ok = (unsigned)c < (unsigned)q.b;
  const unsigned peers = __match_any_sync(kFull, ok ? c : -1 - lane);
  stage[lane] = v;
  __syncwarp();
  const bool lead = ok && (peers & ((1u << lane) - 1u)) == 0u;
  if (lead) {
    if (q.flat) {
      float t = row[c], d = 0.0f;
      int src = lane / q.k;
      for (unsigned m = peers; m; m &= m - 1u) {
        const int l = __ffs(m) - 1;
        if (l / q.k != src) {                     // the next source
          t = __fadd_rn(t, d);
          d = 0.0f;
          src = l / q.k;
        }
        d = __fadd_rn(d, stage[l]);
      }
      row[c] = __fadd_rn(t, d);
    } else {
      float t = scr[c];
      for (unsigned m = peers; m; m &= m - 1u)
        t = __fadd_rn(t, stage[__ffs(m) - 1]);
      scr[c] = t;
    }
  }
  __syncwarp();
  return lead;
}

// A source's per-column sums move into the row once a column: the first
// group of the column adds it and zeroes the scratch, a later one adds +0.
__device__ __forceinline__ void finish_chunk(int c, bool lead, float* row,
                                             float* scr) {
  if (lead) {
    row[c] = __fadd_rn(row[c], scr[c]);
    scr[c] = 0.0f;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
bucket_scatter_sum_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];

  // the bucket of this block: the last s with first_block[s] <= blockIdx.x
  int lo = 0, hi = p.nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.first_block[mid] <= (int)blockIdx.x) lo = mid; else hi = mid - 1;
  }
  const Seg& g = p.seg[lo];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this warp's rows: row0, row0 + wpb, ... (kRowsPerWarp of them)
  const int row0 =
      ((int)blockIdx.x - p.first_block[lo]) * p.wpb * kRowsPerWarp + warp;
  if (row0 >= g.rows) return;                     // the whole warp leaves
  const int row_end = min(g.rows, row0 + p.wpb * kRowsPerWarp);

  Geometry q;
  q.b = g.b;
  q.k = g.k;
  q.nb = g.nb;
  q.S = g.s;
  q.flat = g.k <= 32;
  q.spc = q.flat ? 32 / g.k : 1;
  q.nch = (g.k + 31) >> 5;
  q.steps = q.flat ? (q.S + q.spc - 1) / q.spc : q.S * q.nch;
  const bool cached = q.nch <= kBatch;            // a source in one batch
  q.bs = cached ? kBatch / q.nch * q.nch : kBatch;

  const int b4 = q.b >> 2;
  float* smem = reinterpret_cast<float*>(smem4) + warp * p.warp_floats;
  float* acc = smem;                              // the output row
  float* scr = smem + q.b;                        // scratch, when nch > 1
  int* tag = reinterpret_cast<int*>(scr);         // column owners, when flat
  float* stage = smem + p.warp_floats - 32;
  float4* acc4 = reinterpret_cast<float4*>(acc);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!q.flat) {
    float4* scr4 = reinterpret_cast<float4*>(scr);
    for (int i = lane; i < b4; i += 32) scr4[i] = zero;
  }

  // the batches of this warp's rows in order, the next one's loads in
  // flight while the current one is applied
  int cs[kBatch], nc[kBatch];
  float vs[kBatch], nv[kBatch];
  int row = row0, t0 = 0;
  load_batch(g, q, row, t0, lane, cs, vs);
  while (true) {
    int nrow = row, nt0 = t0 + q.bs;
    if (nt0 >= q.steps) {
      nrow = row + p.wpb;
      nt0 = 0;
    }
    if (nrow < row_end) load_batch(g, q, nrow, nt0, lane, nc, nv);
    if (t0 == 0) {
      for (int i = lane; i < b4; i += 32) acc4[i] = zero;
      __syncwarp();
    }
    bool fast = false;
    unsigned led = 0u;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int t = t0 + i;
      if (i >= q.bs || t >= q.steps) break;       // warp-uniform
      if (q.flat) {
        // Columns that no two lanes of the chunk share (each lane finds
        // its own tag) go straight into the row; otherwise the groups.
        const int c = cs[i];
        const bool ok = (unsigned)c < (unsigned)q.b;
        if (ok) tag[c] = lane;
        __syncwarp();
        const bool shared = ok && tag[c] != lane;
        if (!__any_sync(kFull, shared)) {
          if (ok) acc[c] = __fadd_rn(acc[c], vs[i]);
          __syncwarp();
        } else {
          match_step(c, vs[i], q, acc, scr, stage, lane);
        }
        continue;
      }
      const int ch = t % q.nch;
      if (ch == 0 && cached) {
        // A source whose valid indices rise strictly (every top-k stream)
        // touches each column once: its entries go straight into the row.
        bool bad = false;
#pragma unroll
        for (int i2 = i; i2 < kBatch; ++i2) {
          if (i2 < i + q.nch) {
            const int c = cs[i2];
            const int j = (i2 - i) * 32 + lane;
            const int up = __shfl_down_sync(kFull, c, 1);
            int first = 0;                        // the next chunk's first
            if (i2 + 1 < i + q.nch)
              first = __shfl_sync(kFull, cs[min(i2 + 1, kBatch - 1)], 0);
            if (j < q.k) {
              bad |= (unsigned)c >= (unsigned)q.b;
              if (j + 1 < q.k) bad |= c >= (lane < 31 ? up : first);
            }
          }
        }
        fast = !__any_sync(kFull, bad);
      }
      if (fast) {
        const int c = cs[i];
        if ((unsigned)c < (unsigned)q.b) acc[c] = __fadd_rn(acc[c], vs[i]);
        if (ch == q.nch - 1) __syncwarp();        // before the next source
        continue;
      }
      if (match_step(cs[i], vs[i], q, acc, scr, stage, lane))
        led |= 1u << i;
      if (ch == q.nch - 1) {                      // the source is complete
        if (cached) {
#pragma unroll
          for (int i2 = 0; i2 < kBatch; ++i2)
            if (i2 <= i && i2 > i - q.nch)
              finish_chunk(cs[i2], (led >> i2) & 1u, acc, scr);
        } else {                                  // reload its columns
          const int s = t / q.nch;
          const int gi = row / q.nb;
          const long long e0 =
              (((long long)gi * q.S + s) * q.nb + (row - gi * q.nb)) * q.k;
          for (int c2 = 0; c2 < q.nch; ++c2) {
            const int j = c2 * 32 + lane;
            const int c = j < q.k ? __ldg(g.lidx + e0 + j) : -1;
            const bool ok = (unsigned)c < (unsigned)q.b;
            const unsigned peers =
                __match_any_sync(kFull, ok ? c : -1 - lane);
            finish_chunk(c, ok && (peers & ((1u << lane) - 1u)) == 0u, acc,
                         scr);
          }
        }
      }
    }
    if (t0 + q.bs >= q.steps) {                   // the row is complete
      float4* o4 = reinterpret_cast<float4*>(g.out + (long long)row * q.b);
      for (int i = lane; i < b4; i += 32) __stcs(o4 + i, acc4[i]);
      __syncwarp();
    }
    if (nrow >= row_end) break;
    row = nrow;
    t0 = nt0;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      cs[i] = nc[i];
      vs[i] = nv[i];
    }
  }
}

int launch(Params& p, int n, long long blocks, size_t smem,
           cudaStream_t stream, int* launched) {
  if (n == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.nseg = n;
  p.first_block[n] = (int)blocks;
  bucket_scatter_sum_kernel<<<(unsigned)blocks, 32 * p.wpb, smem, stream>>>(p);
  ++*launched;
  return (int)cudaGetLastError();
}

}  // namespace

// Densifies and sums nseg buckets, kMaxSegs non-empty ones to a launch, and
// sets *launched to the number of kernels launched. Returns a CUDA error
// code.
extern "C" int bucket_scatter_sum_grouped_f32(const BucketScatterSumSeg* segs,
                                              int nseg, cudaStream_t stream,
                                              int* launched) {
  *launched = 0;
  if (nseg < 0) return (int)cudaErrorInvalidValue;
  int bmax = 4;
  for (int i = 0; i < nseg; ++i) {
    const BucketScatterSumSeg& s = segs[i];
    if (s.g < 0 || s.s < 1 || s.nb < 0 || s.k < 1 || s.b < 4 || s.b % 4 ||
        s.b > kMaxB || (long long)s.g * s.nb > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    if ((long long)s.g * s.nb == 0) continue;
    if (s.b > bmax) bmax = s.b;
  }
  const int warp_floats = 2 * bmax + 32;   // the row, scratch or tags, stage
  const size_t warp_bytes = (size_t)warp_floats * sizeof(float);
  int wpb = (int)(kSmemBudget / warp_bytes);
  wpb = wpb < 1 ? 1 : (wpb > kMaxWarps ? kMaxWarps : wpb);
  const size_t smem = wpb * warp_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bucket_scatter_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Params p;
  p.wpb = wpb;
  p.warp_floats = warp_floats;
  int n = 0;
  long long blocks = 0;
  for (int i = 0; i < nseg; ++i) {
    const BucketScatterSumSeg& s = segs[i];
    const int rows = s.g * s.nb;
    if (rows == 0) continue;
    Seg& g = p.seg[n];
    g.lidx = s.lidx;
    g.val = s.val;
    g.out = s.out;
    g.s = s.s;
    g.nb = s.nb;
    g.k = s.k;
    g.b = s.b;
    g.rows = rows;
    p.first_block[n] = (int)blocks;
    blocks += (rows + wpb * kRowsPerWarp - 1) / (wpb * kRowsPerWarp);
    if (++n == kMaxSegs) {
      const int rc = launch(p, n, blocks, smem, stream, launched);
      if (rc != (int)cudaSuccess) return rc;
      n = 0;
      blocks = 0;
    }
  }
  return launch(p, n, blocks, smem, stream, launched);
}
