// Exact per-column top-k of the push state for Hopper (sm_90a), K5.
//
//   for every column j of p [n_rows + 1, s] (row n_rows, the phantom, left
//   out): the k largest p[v, j], descending, equal values in ascending v;
//   scores[j, i] = p[ids[j, i], j], the bits as they lie in p.
//
// No Pallas kernel is replaced: the JAX package runs `lax.top_k` over the
// transposed state (pprx/retrieve/topk.py), which XLA lowers itself. The
// eager port ran `torch.topk(p[:-1].T, k)`: a copy of p in the other layout
// (15.26 GiB at 8M x 512), then the library's selection over the copy.
//
// Bound: bytes. One read of p, 4 n_rows s bytes (16.38 GB at retrieve's
// 8,000,001 x 512: 4.89 ms at 3.35 TB/s); the rest is a small share of that.
//
// Order: each value maps to a 64-bit rank, its float's order-preserving key
// in the high half (-0 taken as +0, every NaN above +inf, as torch's sort
// orders them) and the row's bitwise complement in the low half, so that a
// lower row ranks higher among equal values. Ranks are distinct: the top k
// of a column are its k largest ranks, with no ties left to break.
//
// Design: a threshold a column, then one filtering pass over p.
//   sample  rows 0, stride, 2 stride, ... (m of them; the wrapper's plan):
//           their ranks, transposed into each column's list (buf), through
//           shared-memory tiles, so reads and writes are both contiguous;
//   seed    a block a column: theta = the k-th largest rank of the sample.
//           The k-th largest of any subset of a column is at most the
//           column's own k-th largest, so every one of the column's top k
//           ranks >= theta;
//   filter  one streaming read of p in its own layout (16 bytes a lane where
//           s allows, the rows of a warp step side by side as in K3): each
//           rank >= its column's theta takes a slot of the column's list by
//           an integer atomic (cnt counts every one, also past the list's
//           capacity `cap`). With a random-like sample, about k * stride
//           ranks a column pass (the plan sizes cap well above that). The
//           test is a float compare against theta's value, held in
//           registers for a lane's columns; rows are compared only where a
//           value equals it, in rows up to the highest of those columns'
//           theta rows. A cold push's p is mostly zeros (at 8M x 512 about
//           3,600 nonzeros a column), so theta is often a zero: the zeros
//           of the first rows pass, the later ones fail one compare;
//   finish  a block a column. Where cnt <= cap, the list holds every rank
//           >= theta, so the top k are its k largest: an MSD radix select
//           (11-bit digits, histograms in shared memory) finds the k-th,
//           the ranks at or above it are gathered and sorted in shared
//           memory (bitonic), in chunks of kChunk output positions for a
//           large k. Where cnt > cap (a sample far from random, or a tie at
//           the k-th position), the cap ranks the list holds are a subset
//           of the column's: their k-th largest is a higher threshold, and
//           the block collects its column again from p alone (a strided
//           read of one column), until the list holds every rank at or
//           above its threshold. Each such pass drops at least cap - k ranks (the plan
//           keeps cap > k wherever cap < n_rows), so the loop ends, and the
//           answer is exact whatever the data.
// The list's order depends on the atomics, the answer only on the ranks:
// two runs give the same bits. The sample and the collected candidates are
// the only other memory: s * cap * 8 bytes.
//
// counts (int64 [4], on the device, never reset here): calls, extra column
// passes, candidates kept by the filter summed over the columns, most kept
// by one column.
//
// Plain C interface, loaded with ctypes: every launch goes on the caller's
// stream, allocates nothing, and the function returns the first non-zero
// cudaGetLastError() of its four launches.

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;          // sample and filter blocks
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kSelectThreads = 512;    // seed and finish: a block a column
constexpr int kDigit = 11;             // radix select digit (the last 9 bits)
constexpr int kBins = 1 << kDigit;
constexpr int kListCap = 4096;         // ranks a select holds in shared memory
constexpr int kChunk = 2048;           // output positions sorted at once
constexpr int kAhead = 8;              // loads a thread keeps in flight in collect
constexpr int kTile = 32;              // sample: rows by columns of a tile
// a column's count a cache line of its own: a sparse state's first rows
// keep a candidate in every column at once, and 4-byte counters side by
// side would put all of those atomics on a few lines of L2
constexpr int kCntStride = 32;

enum { kCalls = 0, kExtra = 1, kKept = 2, kMost = 3 };

__device__ __forceinline__ u64 rank_of(float x, long long row) {
  unsigned u = __float_as_uint(x);
  u = u == 0x80000000u ? 0u : u;  // -0 ranks as +0
  unsigned key = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  key = x != x ? 0xffffffffu : key;  // NaN above +inf
  return (static_cast<u64>(key) << 32) | ~static_cast<unsigned>(row);
}

__device__ __forceinline__ unsigned row_of(u64 rank) { return ~static_cast<unsigned>(rank); }

// The float whose key is the rank's high half (+0 for -0, a NaN for NaN).
__device__ __forceinline__ float value_of(u64 rank) {
  const unsigned key = static_cast<unsigned>(rank >> 32);
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// rank_of(x, row) >= the rank of (value t, row tr), without forming the
// rank: float compares, and the rows where the values are equal (+0 equals
// -0, as their ranks do).
__device__ __forceinline__ bool at_or_above(float x, long long row, float t, unsigned tr) {
  if (x < t) return false;
  if (x == t) return row <= tr;
  if (x > t) return true;
  return x != x && (t == t || row <= tr);  // a NaN on either side
}

template <int VEC>
__device__ __forceinline__ void load_once(const float* src, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(src));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = __ldcs(src);
  }
}

// A select's shared memory (41 KB of the 48 a block may hold statically).
struct Select {
  int hist[kBins];
  u64 list[kListCap];
  int len;
  int bin;
  long long above;
  int count;
  unsigned long long total;
};

// Each lane of the warp with `hit` appends v to sm.list: one atomic a warp.
__device__ __forceinline__ void append(Select& sm, u64 v, bool hit) {
  const unsigned hits = __ballot_sync(kFull, hit);
  if (hits == 0) return;
  const int lane = threadIdx.x & (kWarp - 1);
  const int leader = __ffs(hits) - 1;
  int at = 0;
  if (lane == leader) at = atomicAdd(&sm.len, __popc(hits));
  at = __shfl_sync(kFull, at, leader);
  if (hit) sm.list[at + __popc(hits & ((1u << lane) - 1))] = v;
}

// Warp 0: the bin that holds the need-th largest of the histogram's values,
// how many lie in the bins above it, and its own count.
__device__ void pick(Select& sm, int bins, long long need) {
  const int lane = threadIdx.x;
  const int per = bins / kWarp;
  const int lo = lane * per;
  long long sum = 0;
  for (int d = 0; d < per; ++d) sum += sm.hist[lo + d];
  long long suf = sum;  // this lane's bins and every higher lane's
  for (int o = 1; o < kWarp; o <<= 1) {
    const long long t = __shfl_down_sync(kFull, suf, o);
    if (lane + o < kWarp) suf += t;
  }
  long long acc = suf - sum;
  if (suf >= need && acc < need) {
    for (int d = lo + per - 1; d >= lo; --d) {
      const int h = sm.hist[d];
      if (acc + h >= need) {
        sm.bin = d;
        sm.above = acc;
        sm.count = h;
        break;
      }
      acc += h;
    }
  }
}

// The whole block: the need-th largest of the n distinct ranks src[0, n)
// (1 <= need <= n). An MSD radix select: each digit a histogram of the ranks
// that share the digits fixed so far. Once those fit kListCap, the pass
// that counts the next digit also copies them into shared memory, and the
// later digits read them there.
__device__ u64 kth_largest(const u64* src, long long n, long long need, Select& sm) {
  u64 prefix = 0;
  int fixed = 0;
  bool copy = false;
  const u64* cur = src;
  long long cur_n = n;
  while (true) {
    const int width = 64 - fixed < kDigit ? 64 - fixed : kDigit;
    const int shift = 64 - fixed - width;
    const int bins = 1 << width;
    __syncthreads();  // the last pass's readers of sm are done
    for (int b = threadIdx.x; b < bins; b += blockDim.x) sm.hist[b] = 0;
    if (threadIdx.x == 0) sm.len = 0;
    __syncthreads();
    // a warp's lanes on one bin add once (a sparse column's zeros share
    // every digit of the key); the loop's bound is the same for a warp
    const int lane = threadIdx.x & (kWarp - 1);
    for (long long base = threadIdx.x - lane; base < cur_n; base += blockDim.x) {
      const long long i = base + lane;
      u64 v = 0;
      int bin = -1;
      if (i < cur_n) {
        v = cur[i];
        if (fixed == 0 || (v >> (64 - fixed)) == (prefix >> (64 - fixed))) {
          bin = static_cast<int>((v >> shift) & (bins - 1));
        }
      }
      const unsigned same = __match_any_sync(kFull, bin);
      if (bin >= 0 && lane == __ffs(same) - 1) atomicAdd(&sm.hist[bin], __popc(same));
      if (copy) append(sm, v, bin >= 0);
    }
    __syncthreads();
    if (threadIdx.x < kWarp) pick(sm, bins, need);
    __syncthreads();
    need -= sm.above;
    prefix |= static_cast<u64>(sm.bin) << shift;
    fixed += width;
    if (fixed == 64) return prefix;
    if (copy) {
      cur = sm.list;
      cur_n = sm.len;
      copy = false;
    } else if (cur == src && sm.count <= kListCap) {
      copy = true;
    }
  }
}

// Descending bitonic sort of a[0, n), n a power of two, by the whole block.
__device__ void sort_desc(u64* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const u64 x = a[lo], y = a[hi];
        if ((x < y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The whole block: every rank >= t of column j, read from p alone, into
// list (the first cap of them; their count is returned).
__device__ long long collect(const float* __restrict__ p, long long n_rows, int s, int j, u64 t,
                             u64* list, long long cap, Select& sm) {
  __syncthreads();
  if (threadIdx.x == 0) sm.total = 0;
  __syncthreads();
  const long long step = static_cast<long long>(blockDim.x) * kAhead;
  for (long long r0 = threadIdx.x; r0 < n_rows; r0 += step) {
    float x[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const long long r = r0 + static_cast<long long>(a) * blockDim.x;
      x[a] = r < n_rows ? __ldcs(p + r * s + j) : 0.f;
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const long long r = r0 + static_cast<long long>(a) * blockDim.x;
      const u64 v = rank_of(x[a], r);
      if (r < n_rows && v >= t) {
        const u64 slot = atomicAdd(&sm.total, 1ull);
        if (slot < static_cast<u64>(cap)) list[slot] = v;
      }
    }
  }
  __syncthreads();
  return static_cast<long long>(sm.total);
}

__global__ void __launch_bounds__(kThreads)
    sample_kernel(const float* __restrict__ p, int s, long long stride, long long m,
                  u64* __restrict__ buf, long long cap) {
  __shared__ u64 tile[kTile][kTile + 1];
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  const long long tiles_j = (s + kTile - 1) / kTile;
  const long long tiles = (m + kTile - 1) / kTile * tiles_j;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long i0 = t / tiles_j * kTile;
    const int j0 = static_cast<int>(t % tiles_j) * kTile;
    for (int r = ty; r < kTile; r += kWarpsPerBlock) {
      const long long i = i0 + r;
      const int j = j0 + tx;
      if (i < m && j < s) tile[tx][r] = rank_of(p[i * stride * s + j], i * stride);
    }
    __syncthreads();
    for (int c = ty; c < kTile; c += kWarpsPerBlock) {
      const long long i = i0 + tx;
      const int j = j0 + c;
      if (i < m && j < s) buf[j * cap + i] = tile[c][tx];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kSelectThreads)
    seed_kernel(int s, int k, long long m, const u64* __restrict__ buf, long long cap,
                u64* __restrict__ theta, unsigned* __restrict__ cnt,
                unsigned long long* __restrict__ counts) {
  __shared__ Select sm;
  for (int j = blockIdx.x; j < s; j += gridDim.x) {
    const u64 t = kth_largest(buf + j * cap, m, k, sm);
    if (threadIdx.x == 0) {
      theta[j] = t;
      cnt[static_cast<long long>(j) * kCntStride] = 0;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(counts + kCalls, 1ull);
}

// Rows in warp steps as K3 walks them (rowpass.cu): a warp step covers
// kWarp / lanes rows, a group of `lanes` lanes a row. A lane's columns are
// walked C column steps at a time (at s = 512 all of them at once), each
// column's threshold held in registers while the warps of the grid stride
// over the rows; a warp loads U row steps of those columns before it
// compares any.
template <int VEC, int U, int C>
__global__ void __launch_bounds__(kThreads)
    filter_kernel(const float* __restrict__ p, long long n_rows, int s, int lanes,
                  const u64* __restrict__ theta, unsigned* __restrict__ cnt,
                  u64* __restrict__ buf, long long cap) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int sub = lane / lanes;
  const int own = lane & (lanes - 1);
  const int rows_per_step = kWarp / lanes;
  const long long rows_per_warp = static_cast<long long>(rows_per_step) * U;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  const int col_step = lanes * VEC;
  for (int j0 = own * VEC; j0 < s; j0 += col_step * C) {
    // each column's threshold value; past the highest of their rows, a value
    // equal to its column's cannot rank at or above it
    float t[C][VEC];
    long long low = -1;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int j = j0 + c * col_step + e;
        const u64 th = j < s ? theta[j] : ~0ull;
        t[c][e] = value_of(th);
        low = max(low, static_cast<long long>(row_of(th)));
      }
    }
    for (long long base = warp * rows_per_warp; base < n_rows; base += n_warps * rows_per_warp) {
      long long v[U], at[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        v[u] = base + u * rows_per_step + sub;
        at[u] = v[u] < n_rows ? v[u] : n_rows - 1;  // past the end: read, keep nothing
      }
      float x[U][C][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = j0 + c * col_step;
          if (j < s) load_once(p + at[u] * s + j, x[u][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c * col_step;
        if (j >= s) continue;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (v[u] >= n_rows) continue;
          const bool may_tie = v[u] <= low;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float xv = x[u][c][e], tv = t[c][e];
            // most of a column: below its threshold, or equal to it past low
            if (xv <= tv && !(may_tie && xv == tv)) continue;
            // equal to it at a low row, or a NaN on either side
            if (!(xv > tv) && !at_or_above(xv, v[u], tv, row_of(__ldg(theta + j + e)))) continue;
            const unsigned slot =
                atomicAdd(cnt + static_cast<long long>(j + e) * kCntStride, 1u);
            if (slot < cap) buf[(j + e) * cap + slot] = rank_of(xv, v[u]);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kSelectThreads)
    finish_kernel(const float* __restrict__ p, long long n_rows, int s, int k,
                  u64* __restrict__ buf, long long cap, const unsigned* __restrict__ cnt,
                  float* __restrict__ scores, long long* __restrict__ ids,
                  unsigned long long* __restrict__ counts) {
  __shared__ Select sm;
  for (int j = blockIdx.x; j < s; j += gridDim.x) {
    u64* list = buf + j * cap;
    const long long kept = cnt[static_cast<long long>(j) * kCntStride];
    long long n = kept;
    unsigned long long passes = 0;
    while (n > cap) {  // the list holds cap of the n ranks >= theta
      n = collect(p, n_rows, s, j, kth_largest(list, cap, k, sm), list, cap, sm);
      ++passes;
    }
    // the list holds every rank >= theta: the top k are its k largest
    u64 hi = 0;
    for (long long pos0 = 0; pos0 < k; pos0 += kChunk) {
      const int len = static_cast<int>(k - pos0 < kChunk ? k - pos0 : kChunk);
      const u64 t = kth_largest(list, n, pos0 + len, sm);
      __syncthreads();
      if (threadIdx.x == 0) sm.len = 0;
      __syncthreads();
      const int lane = threadIdx.x & (kWarp - 1);
      for (long long base = threadIdx.x - lane; base < n; base += blockDim.x) {
        const u64 v = base + lane < n ? list[base + lane] : 0;  // ranks are > 0
        append(sm, v, v >= t && (pos0 == 0 || v < hi));
      }
      int width = 1;
      while (width < len) width <<= 1;
      for (int i = len + threadIdx.x; i < width; i += blockDim.x) sm.list[i] = 0;  // ranks are > 0
      __syncthreads();
      sort_desc(sm.list, width);
      for (int i = threadIdx.x; i < len; i += blockDim.x) {
        const unsigned row = row_of(sm.list[i]);
        const long long at = static_cast<long long>(j) * k + pos0 + i;
        ids[at] = row;
        scores[at] = p[static_cast<long long>(row) * s + j];
      }
      hi = t;
    }
    if (threadIdx.x == 0) {
      atomicAdd(counts + kExtra, passes);
      atomicAdd(counts + kKept, static_cast<unsigned long long>(kept));
      atomicMax(counts + kMost, static_cast<unsigned long long>(kept));
    }
  }
}

// Blocks of one wave at most (the occupancy calculator's count, found at a
// kernel's first launch, times the SMs), fewer where there is less work.
template <auto Kernel>
int wave(int threads) {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads, 0);
    blocks = (per_sm > 0 ? per_sm : 1) * n_sm;
  }
  return blocks;
}

template <auto Kernel, typename... Args>
int launch(long long wanted, int threads, cudaStream_t stream, Args... args) {
  const long long most = wave<Kernel>(threads);
  const int blocks = static_cast<int>(wanted < most ? (wanted > 0 ? wanted : 1) : most);
  Kernel<<<blocks, threads, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, int U, int C>
int filter(cudaStream_t stream, const float* p, long long n_rows, int s, int lanes,
           const u64* theta, unsigned* cnt, u64* buf, long long cap) {
  const long long steps = (n_rows + (kWarp / lanes) * U - 1) / ((kWarp / lanes) * U);
  return launch<filter_kernel<VEC, U, C>>((steps + kWarpsPerBlock - 1) / kWarpsPerBlock, kThreads,
                                          stream, p, n_rows, s, lanes, theta, cnt, buf, cap);
}

}  // namespace

extern "C" {

// p: f32 [n_rows + 1, s], contiguous, 16-byte aligned where vec is 4; k in
// [1, n_rows]; rows 0, stride, ..., (m - 1) stride sampled, k <= m <= cap;
// cap <= n_rows, and cap > k where cap < n_rows; vec 4 (s a multiple of 4)
// or 1, lanes a power of two up to 32 (segsum.lanes_for); buf: u64 [s, cap];
// cnt: u32 [s * kCntStride]; theta: u64 [s]; scores: f32 [s, k]; ids: int64
// [s, k]; counts: int64 [4].
int pprx_topk_f32(const float* p, long long n_rows, int s, int k, long long stride, long long m,
                  long long cap, int vec, int lanes, void* buf, void* cnt, void* theta,
                  float* scores, long long* ids, long long* counts, void* stream_ptr) {
  auto* st = static_cast<cudaStream_t>(stream_ptr);
  auto* b = static_cast<u64*>(buf);
  auto* c = static_cast<unsigned*>(cnt);
  auto* th = static_cast<u64*>(theta);
  auto* cn = reinterpret_cast<unsigned long long*>(counts);
  const long long tiles = (m + kTile - 1) / kTile * ((s + kTile - 1) / kTile);
  int err = launch<sample_kernel>(tiles, kThreads, st, p, s, stride, m, b, cap);
  if (err == 0) err = launch<seed_kernel>(s, kSelectThreads, st, s, k, m, b, cap, th, c, cn);
  if (err == 0) {
    // a row's column steps: several at once (U = 2 rows of C = 4) where a
    // row has four or more, else more rows at once (U = 8)
    const bool wide = (s + lanes * vec - 1) / (lanes * vec) >= 4;
    if (vec == 4) {
      err = wide ? filter<4, 2, 4>(st, p, n_rows, s, lanes, th, c, b, cap)
                 : filter<4, 8, 1>(st, p, n_rows, s, lanes, th, c, b, cap);
    } else {
      err = wide ? filter<1, 2, 4>(st, p, n_rows, s, lanes, th, c, b, cap)
                 : filter<1, 8, 1>(st, p, n_rows, s, lanes, th, c, b, cap);
    }
  }
  if (err == 0) {
    err = launch<finish_kernel>(s, kSelectThreads, st, p, n_rows, s, k, b, cap, c, scores, ids,
                                cn);
  }
  return err;
}

}  // extern "C"
