// Delivery-sorted segment sum for Hopper (sm_90a), two entries:
//
//   segsum_add:         rin[w, :] += sum_{j in [row_off[w], row_off[w+1])} contribs[j, :]
//   segsum_gather_add:  rin[w, :] += sum_{j in [row_off[w], row_off[w+1])} table[gat[j], :]
//
// Both take an optional per-row scale (f32 [R], or null): with it the row's
// sum is multiplied by row_scale[w] before it is added. Reverse push needs
// this: the reference multiplies every edge's contribution by
// inv_deg[d_sca[j]] before its kernel (pprx/engine/wl2.py:256-274), and
// d_sca[j] is the output row, so that is one factor per row on the row's
// sum.
//
// Replaces the Pallas TPU kernel pprx/engine/segsum.py `_segsum_kernel`
// (launched by `segsum_add`, segsum.py:184) and, in the second entry, the
// gather its callers ran before it (`segsum_add(r2, moving[kg.d_gat], ...)`,
// pprx/engine/wl2.py:237-238). The edges are already sorted by destination
// row, so row w's contributions are one contiguous range.
//
// Bound: bytes. Every contribution is read once and rin is read and written
// once: 0.25 flop per byte, no reuse. The roofline is the memory rate.
//
// Design, two launches on the caller's stream:
//
// 1. `segsum_chunks_kernel`: the work is split by edges, not by rows. A warp
//    owns one chunk of consecutive edges of [row_off[0], row_off[R]),
//    whatever rows they fall in, so a hub row of tens of thousands of edges
//    is as many equal pieces on as many warps. The chunk is 256 edges for a
//    window-sized edge array and is halved, down to 64, for a shorter one
//    (`chunk_for` in the wrapper, pprx_torch/engine/segsum.py, which passes
//    it down), so that a fresh view or a compact round still spreads
//    over every SM. The warp finds its first row by a 32-way search in
//    row_off (each lane probes one position, a ballot counts), then walks
//    its edges with lanes over the S columns (16-byte loads for f32, 8-byte
//    for bf16 when S % 4 == 0). Loads go out kUnroll edges at a time
//    whatever rows they belong to, and the f32 accumulator is flushed at
//    each row boundary. A row that lies wholly
//    inside the chunk has one owner and is added into rin directly. Only the
//    chunk's first and last row can be shared with neighbouring chunks:
//    their partial sums go to scratch[chunk, 0, :] (the row began before the
//    chunk) or scratch[chunk, 1, :] (it began inside and runs past the end).
// 2. `segsum_spans_kernel`: one warp per chunk boundary. The warp whose
//    chunk holds the start of a row that crosses the boundary adds that
//    row's partials in chunk order (slot 1 of its own chunk, then slot 0 of
//    each later chunk the row reaches) into rin. The partials were just
//    written, and the loads go out kSpanUnroll at a time, independent of
//    each other, so a hub's few hundred partials cost a few L2 round trips,
//    not one per partial. It reads only slots that pass 1 wrote.
//
// The scale is applied where a row's sum meets rin, and only there: at the
// flush of a row that lies wholly inside a chunk (pass 1), and once on the
// sum of a spanning row's partials (pass 2). The partials themselves stay
// unscaled. SCALED is a template flag, so a call without a scale runs the
// code it ran before the flag existed.
//
// No atomics: every rin row has one writer per launch and every sum has a
// fixed order, so two runs on the same inputs give the same bits.
//
// The gather entry shares all of this; only the load address differs
// (table + gat[j] * S instead of contribs + j * S). A warp reads its chunk's
// indices 32 at a time, coalesced, one block ahead of the rows it is
// summing, and hands them out by shuffle.
//
// A state whose S columns fewer than 32 lanes cover (S < 65 in 16-byte
// loads, S < 17 otherwise) takes the narrow kernels further down, with
// several edges per warp step; the TPU kernel ran such states by padding
// its lanes to 128, which is not carried over. The wrapper chooses
// (`layout_for`): the wide kernels below are what every wider state runs.
//
// What of Hopper this uses: 132 SMs kept busy to the end by the edge split,
// 16-byte read-only loads with many warps in flight, the 50 MB L2 for the
// offsets, the partials and (gather entry) the table. What it does not:
// tensor cores (the TPU kernel summed by one-hot matmul because the MXU was
// the way to reduce there; here the sum is bound by bytes), and TMA: an
// unfused chunk is one contiguous chunk x S tile that `cp.async.bulk` with
// an mbarrier ring could fetch, but direct loads are kept unless they leave
// the kernel under half of its bound (see PERF.md for the times).
//
// Plain C interface, loaded with ctypes: the launches go on the caller's
// stream, allocate nothing (the wrapper passes the scratch), and the
// function returns the first non-zero cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Tunables of the wide kernels (the chunk sizes are `CHUNK_WIDE` in the
// wrapper). Swept in turns within one run on an H100 80GB HBM3 at 700 W
// (variants built with these constants changed), R=200,001 rows, S=128; ms
// for segsum_add / segsum_gather_add on 2.0M power-law sorted edges (a
// window scan) and on 320k (a full fresh view), f32 then bf16:
//
//   most, fewest edges per chunk;     2.0M edges                   320k edges
//   chunks wanted; warps; unroll      f32            bf16          f32            bf16
//   256, 64, 4096, 8, 4  (kept)   0.463 / 0.375  0.314 / 0.291  0.144 / 0.162  0.123 / 0.123
//   256, 256, 4096, 8, 4          0.464 / 0.375  (as kept)      0.202 / 0.219  not run
//                                 (0.543 in one of its two turns)
//   128, 64, 4096, 8, 4           0.491 / 0.406  0.332 / 0.299  0.144 / 0.162  0.123 / 0.123
//   512, 64, 2048, 4, 4           0.450 / 0.363  0.291 / 0.272  0.147 / 0.151  0.139 / 0.147
//   256, 128, 4096, 8, 4          (as kept)      (as kept)      0.148 / 0.149  not run
//   256, 32, 8192, 8, 4           0.491 / 0.406  not run        0.164 / 0.164  not run
//   256, 64, 4096, 4, 4           0.458 / 0.380  not run        0.150 / 0.152  not run
//   256, 64, 4096, 8, 8           0.463 / 0.432  0.307 / 0.279  0.166 / 0.179  0.150 / 0.154
//   256, 64, 4096, 8, 2           0.466 / 0.417  not run        0.142 / 0.136  not run
//
// The chunk: 256 against 128 is 0.03 ms at 2.0M edges; 512 gains another
// 0.012 ms there, and earlier runs (same card and limit) had 64 slower than
// 128 by 0.06 ms. A short edge array is the reverse: at 256 its 1,250
// chunks leave two thirds of the card's warp slots empty while each warp
// walks its edges batch after batch (0.202 ms for a sixth of the edges), so
// the chunk is halved until the array gives 4096 chunks, about one for each
// warp the card holds at once (32 a SM at 64 registers a thread); 32 edges
// a chunk is past the point where the per-chunk search and the partials
// pay. The unroll: 4 loads in flight serve both types (8 is 0.012 ms faster
// for bf16 at 2.0M edges and 0.03 ms slower at 320k, and a scan round makes
// one call of each size; 16 was slower everywhere in an earlier run). The
// headline stream's rate does not tell these variants apart; its refine, 68
// scan rounds, is 139-146 ms with the per-call chunk against 148-157 ms at
// a fixed 256.

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;           // loads in flight per lane; divides 32
constexpr int kSpanUnroll = 8;
// narrow layout: steps whose loads go out together, and partials in flight
// per group in the second pass
constexpr int kNarrowUnroll = 4;
constexpr int kSpanNarrowUnroll = 2;

static_assert(kUnroll > 0 && kWarp % kUnroll == 0, "unroll must divide 32");
static_assert(kNarrowUnroll > 0 && (kNarrowUnroll & (kNarrowUnroll - 1)) == 0 &&
                  kNarrowUnroll <= kWarp,
              "narrow unroll: a power of two up to 32");

// Load VEC consecutive columns of one edge row as f32.
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct Vec<float, 1> {
  __device__ static void load(const float* p, float* out) { out[0] = __ldg(p); }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    const float2 fa = __bfloat1622float2(a);
    const float2 fb = __bfloat1622float2(b);
    out[0] = fa.x; out[1] = fa.y; out[2] = fb.x; out[3] = fb.y;
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    out[0] = __bfloat162float(p[0]);
  }
};

// VEC f32 columns of rin or of the scratch (16-byte accesses at VEC == 4;
// the wrapper checks the alignment).
template <int VEC>
struct Cols;

template <>
struct Cols<4> {
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Cols<1> {
  __device__ static void load(const float* p, float* out) { out[0] = *p; }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};

// rin row w += acc, or += row_scale[w] * acc (every lane reads the same
// factor: one broadcast load).
template <int VEC, bool SCALED>
__device__ void add_into(float* rin, const float* __restrict__ row_scale, int w,
                         int s, int c, const float* acc) {
  float* p = rin + static_cast<long long>(w) * s + c;
  float cur[VEC];
  Cols<VEC>::load(p, cur);
  if constexpr (SCALED) {
    const float sc = __ldg(row_scale + w);
#pragma unroll
    for (int k = 0; k < VEC; ++k) cur[k] += sc * acc[k];
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) cur[k] += acc[k];
  }
  Cols<VEC>::store(p, cur);
}

// The row that holds edge e: the w with row_off[w] <= e < row_off[w + 1].
// Needs row_off[0] <= e < row_off[n_rows]; the whole warp calls it together.
// Each step probes 32 positions, one per lane, and keeps the 1/33 of the
// range that holds the answer: 4 steps for 200k rows. `lo` is a row known to
// begin at or before e (0 where nothing is known).
__device__ int find_row(const int* __restrict__ row_off, int lo, int n_rows, long long e,
                        int lane) {
  int hi = n_rows;  // row_off[lo] <= e < row_off[hi]
  while (hi - lo > 1) {
    const int stride = (hi - lo + kWarp) / (kWarp + 1);
    const long long idx = lo + static_cast<long long>(lane + 1) * stride;
    const bool le = idx < hi && __ldg(row_off + idx) <= e;
    const int cnt = __popc(__ballot_sync(kFull, le));
    const long long nlo = lo + static_cast<long long>(cnt) * stride;
    if (nlo + stride < hi) hi = static_cast<int>(nlo + stride);
    lo = static_cast<int>(nlo);
  }
  return lo;
}

// Pass 1: one warp per chunk of `chunk` edges.
template <typename T, typename I, int VEC, bool GATHER, bool SCALED>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segsum_chunks_kernel(float* __restrict__ rin, const T* __restrict__ src,
                     const I* __restrict__ gat, const int* __restrict__ row_off,
                     const float* __restrict__ row_scale,
                     float* __restrict__ scratch, int n_rows, int s, int chunk_edges) {
  const int lane = threadIdx.x % kWarp;
  const long long chunk =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const long long e0 = __ldg(row_off);
  const long long e1 = __ldg(row_off + n_rows);
  const long long e_lo = e0 + chunk * chunk_edges;
  if (e_lo >= e1) return;
  const long long e_hi = e_lo + chunk_edges < e1 ? e_lo + chunk_edges : e1;
  const int w0 = find_row(row_off, 0, n_rows, e_lo, lane);
  const bool head0 = __ldg(row_off + w0) < e_lo;  // row w0 began in an earlier chunk
  float* part = scratch + chunk * 2 * s;

  // every lane runs every iteration (the shuffles below need the whole
  // warp); lanes past the last column only skip their loads and stores
  for (int c0 = 0; c0 < s; c0 += kWarp * VEC) {
    const int c = c0 + lane * VEC;
    const bool active = c < s;
    int w = w0;
    bool head = head0;
    long long row_end = __ldg(row_off + w + 1);
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

    I g = 0, g_next = 0;
    if constexpr (GATHER) {
      if (e_lo + lane < e_hi) g_next = __ldg(gat + e_lo + lane);
    }
    for (long long eb = e_lo; eb < e_hi; eb += kWarp) {
      if constexpr (GATHER) {
        // the next 32 indices are fetched while these 32 rows are summed
        g = g_next;
        g_next = 0;
        if (eb + kWarp + lane < e_hi) g_next = __ldg(gat + eb + kWarp + lane);
      }
#pragma unroll 1
      for (int j0 = 0; j0 < kWarp && eb + j0 < e_hi; j0 += kUnroll) {
        float v[kUnroll][VEC];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long e = eb + j0 + u;
          long long row = e;
          if constexpr (GATHER) {
            row = static_cast<long long>(__shfl_sync(kFull, g, j0 + u));
          }
          if (active && e < e_hi) {
            Vec<T, VEC>::load(src + row * s + c, v[u]);
          } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long e = eb + j0 + u;
          if (e < e_hi) {
            if (e == row_end) {
              // row w is complete inside this chunk
              if (active) {
                if (head) Cols<VEC>::store(part + c, acc);
                else add_into<VEC, SCALED>(rin, row_scale, w, s, c, acc);
              }
              head = false;
#pragma unroll
              for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
              // edge e's row: the next one, or past a run of empty rows,
              // which is searched for and not walked (a sparse delivery
              // leaves runs of 1e5 empty rows, a walk of milliseconds)
              ++w;
              row_end = __ldg(row_off + w + 1);
              if (row_end <= e) {
                w = find_row(row_off, 0, n_rows, e, lane);
                row_end = __ldg(row_off + w + 1);
              }
            }
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] += v[u][k];
          }
        }
      }
    }
    // the chunk's last row: shared if it began before the chunk or runs past
    // it, and then its partial is stored unscaled (pass 2 scales the sum)
    if (active) {
      if (head) Cols<VEC>::store(part + c, acc);
      else if (row_end > e_hi) Cols<VEC>::store(part + s + c, acc);
      else add_into<VEC, SCALED>(rin, row_scale, w, s, c, acc);
    }
  }
}

// Pass 2: one warp per chunk boundary; boundary b lies between chunks b and
// b + 1, at edge row_off[0] + (b + 1) * chunk_edges.
template <int VEC, bool SCALED>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segsum_spans_kernel(float* __restrict__ rin, const int* __restrict__ row_off,
                    const float* __restrict__ row_scale,
                    const float* __restrict__ scratch, int n_rows, int s,
                    int chunk_edges) {
  const int lane = threadIdx.x % kWarp;
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const long long e0 = __ldg(row_off);
  const long long e1 = __ldg(row_off + n_rows);
  const long long x = e0 + (b + 1) * chunk_edges;
  if (x >= e1) return;
  const int w = find_row(row_off, 0, n_rows, x, lane);
  const long long start = __ldg(row_off + w);
  // no row crosses here, or the crossing row began before chunk b and the
  // warp of its first chunk adds it
  if (start >= x || start < x - chunk_edges) return;
  const long long last = (__ldg(row_off + w + 1) - 1 - e0) / chunk_edges;  // > b
  for (int c = lane * VEC; c < s; c += kWarp * VEC) {
    float acc[VEC];
    Cols<VEC>::load(scratch + (b * 2 + 1) * s + c, acc);
    for (long long j = b + 1; j <= last; j += kSpanUnroll) {
      float v[kSpanUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kSpanUnroll; ++u) {
        if (j + u <= last) {
          Cols<VEC>::load(scratch + (j + u) * 2 * s + c, v[u]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSpanUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += v[u][k];
      }
    }
    // the one place a spanning row is scaled: on the sum of its partials
    add_into<VEC, SCALED>(rin, row_scale, w, s, c, acc);
  }
}

// ---- The narrow layout: a state of S columns that G < 32 lanes cover ----
//
// Lanes over columns alone would leave 32 - G lanes of every warp idle (30
// of 32 at S=8). Here a warp's lanes form 32 / G groups of G lanes, and in
// one step group q loads edge eb + q: a step covers 32 / G consecutive
// edges (for the unfused entry one contiguous run of bytes), and with the
// same number of loads in flight a warp has 32 / G times the bytes under
// way. The chunk, the partials and the second launch are as above.
//
// Rows: the warp takes its chunk 32 edges at a time. Each lane finds the
// row of one of the 32 (a binary search in row_off between the row of the
// block's first edge and the row of the chunk's last, which the warp looks
// up once: a few probes that hit L1, none inside a hub row), and the
// block's steps read their groups' rows by shuffle, as they read the
// gather indices. The loads of the block's first steps go out before the
// search.
//
// Sums: within a step the groups' values are added by an inclusive scan
// over groups keyed by row (log2(32 / G) shuffle steps; rows are ascending,
// so equal rows are neighbours). The last group of each row's run holds the
// run's sum. A run that another row follows within the step is complete and
// its group adds it to rin, or stores it as the head partial, in parallel
// with the other groups. The run of the step's last edge stays open: every
// group keeps a copy (`acc`, `acc_row`), the next step's first group adds
// it to its edge before the scan if the row goes on, or flushes it if not.
// The order of the additions is a function of row_off, S and the chunk
// alone: no atomics, and two runs give the same bits, as above.
//
// Edge positions and table rows are 32-bit here (row_off is int32; the
// wrapper refuses a table of 2^31 rows): with 64-bit positions the build
// before ran S=8's window at 30-33 us against 28-30 (two calls on the same
// card and limit).
//
// Sweep of the chunk (chip_smoke.py phase 3, `*_ms_by_chunk`: the wrapper's
// `chunk_for` replaced by each forced chunk; H100 80GB HBM3 at 700 W; device
// time in us, all variants in turns, twice; f32 / bf16 sources). S=8:
// R=100,001, with the row scale, 1.0M sorted power-law edges and a fresh view
// of 80k; S=16: R=200,001, no scale, 2.0M edges and a fresh view of 160k:
//
//   chunk   S=8 1.0M add      gather        80k add       gather
//   32      52.8 / 50.7   52.0 / 52.5   11.1 / 11.1   11.4 / 11.6
//   64      38.3 / 36.0   37.3 / 37.9   12.2 / 12.3   12.8 / 13.2
//   128     33.4 / 31.0   33.1 / 33.7   15.9 / 15.9   17.0 / 17.5
//   256     29.9 / 27.5   28.3 / 29.2   24.1 / 24.3   26.5 / 28.0
//   512     38.3 / 31.2   35.3 / 37.9   42.1 / 42.2   46.9 / 49.5
//   chunk   S=16 2.0M add     gather        160k add      gather
//   32     138.4 / 129.8 135.3 / 122.1  16.5 / 16.7   16.9 / 16.9
//   64     102.7 / 93.1   93.8 / 89.3   16.8 / 17.1   17.6 / 17.8
//   128     88.5 / 79.8   78.5 / 76.2   20.9 / 21.3   22.3 / 22.5
//   256     87.9 / 81.0   78.2 / 74.3   33.1 / 33.7   35.3 / 36.0
//   512     85.1 / 81.0   78.3 / 76.1   59.5 / 60.2   64.1 / 65.3
//
// A short array's time is one warp's walk (it doubles with the chunk), so it
// takes the fewest edges per chunk; a window-sized one wants 256, where the
// two row searches a chunk and its partials are spread over more edges, and
// at S=8 loses again at 512, where the card's warp slots are no longer
// filled (S=16's 2.0M edges are flat from 128 to 512). So `CHUNK_NARROW` in
// the wrapper is (256, 64, 2048): the same ladder as the wide kernels',
// halved while the array gives fewer than 2048 chunks and not 4096, so that
// 1.0M edges keep 256. 32 edges a chunk gain a tenth at S=8's fresh view
// and nothing at S=16's: not taken. The unroll (steps whose loads go out
// together; builds with the constant changed, same timer, chunk 256 at the
// window and 64 at the fresh view, f32): 2 / 4 / 8 give 32.8 / 32.7 / 32.6
// (add) and 30.4 / 30.2 / 30.3 (gather) at S=8's window, where a block has
// two steps and all three load them together; 93.6 / 90.3 / 90.3 and 86.5 /
// 80.9 / 81.3 at S=16's; 17.3 / 17.0 / 17.0 at its fresh view. 4 is kept.
//
// Tried and dropped: the other narrow form, in which each group of G lanes
// walks its own stretch of the chunk with the wide kernel's per-row logic
// (no scan, no carry; a pair of partials per group, so 32 / G times the
// partials and boundaries for the second launch, which stayed as it is
// here; each lane reads its group's gather index itself). Built as a
// variant of this file and run through the same phase 3 functions in turns
// with this form, same card; us at its best stretch per group of those
// swept (4 to 256 edges), f32 / bf16, against this form at its own chunk:
//
//   S=8 1.0M    add 46.6 / 40.8 (32 a group)   against 29.9 / 27.5
//               gather 43.9 / 44.7 (32)        against 28.3 / 29.2
//   S=8 80k     add 19.4 / 19.4 (8)            against 12.2 / 12.3
//               gather 19.8 / 20.0 (8)         against 12.8 / 13.2
//   S=16 2.0M   add 101.8 / 89.6 (64)          against 87.9 / 81.0
//               gather 79.9 / 73.8 (64)        against 78.2 / 74.3
//   S=16 160k   add 26.4 / 25.9 (8)            against 16.8 / 17.1
//               gather 27.8 / 26.6 (8)         against 17.6 / 17.8
//
// It loses by a half at S=8 and at both fresh views (a group's walk is a
// chain of dependent loads a sixteenth or an eighth as wide as a warp's,
// and a short stretch pays a row search and a pair of partials for a few
// edges), by a sixth at S=16's unfused window, and ties its fused window.

// A complete sum of row w meets rin, or is the head partial of its chunk
// (rin_c and part point at this lane's columns).
template <int VEC, bool SCALED>
__device__ void flush_row(float* rin_c, const float* __restrict__ row_scale, float* part,
                          int head_row, int w, int s, const float* sum) {
  if (w == head_row) Cols<VEC>::store(part, sum);
  else add_into<VEC, SCALED>(rin_c, row_scale, w, s, 0, sum);
}

// Pass 1, narrow: one warp per chunk, G lanes per edge.
template <typename T, typename I, int VEC, int G, bool GATHER, bool SCALED>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segsum_chunks_narrow_kernel(float* __restrict__ rin, const T* __restrict__ src,
                            const I* __restrict__ gat, const int* __restrict__ row_off,
                            const float* __restrict__ row_scale,
                            float* __restrict__ scratch, int n_rows, int s,
                            int chunk_edges) {
  constexpr int kEdges = kWarp / G;  // edges per step; a block of 32 edges is G steps
  constexpr int kBatch = G < kNarrowUnroll ? G : kNarrowUnroll;  // steps loaded together
  const int lane = threadIdx.x % kWarp;
  const int q = lane / G;            // this lane's group
  const int c = (lane % G) * VEC;    // and its columns
  const bool active = c < s;
  const long long chunk =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int e1 = __ldg(row_off + n_rows);
  if (__ldg(row_off) + chunk * chunk_edges >= e1) return;
  // edge positions fit 32 bits (row_off is int32); so must the table's rows
  const int e_lo = static_cast<int>(__ldg(row_off) + chunk * chunk_edges);
  const int e_hi = e1 - e_lo > chunk_edges ? e_lo + chunk_edges : e1;
  const int w0 = find_row(row_off, 0, n_rows, e_lo, lane);
  const int w_last = find_row(row_off, w0, n_rows, e_hi - 1, lane);
  // the row whose sum here is a head partial: w0 if it began in an earlier chunk
  const int head_row = __ldg(row_off + w0) < e_lo ? w0 : -1;
  float* part = scratch + chunk * 2 * s + c;
  const T* src_c = src + c;
  float* rin_c = rin + c;

  float acc[VEC];  // the open row's sum so far, a copy in every group
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  int acc_row = w0;
  int w_blk = w0;  // the row of the block's first edge, or one before it
  int w_mine = w0;
  int g = 0, g_next = 0;
  if constexpr (GATHER) {
    if (e_lo + lane < e_hi) g_next = static_cast<int>(__ldg(gat + e_lo + lane));
  }
  for (int eb = e_lo; eb < e_hi; eb += kWarp) {
    if constexpr (GATHER) {
      g = g_next;
      g_next = 0;
      if (eb + kWarp + lane < e_hi) g_next = static_cast<int>(__ldg(gat + eb + kWarp + lane));
    }
#pragma unroll 1
    for (int j0 = 0; j0 < G && eb + j0 * kEdges < e_hi; j0 += kBatch) {
      float v[kBatch][VEC];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = (j0 + u) * kEdges + q;  // this group's edge within the block
        int row = eb + idx;
        const bool here = active && row < e_hi;
        if constexpr (GATHER) row = __shfl_sync(kFull, g, idx);
        if (here) {
          Vec<T, VEC>::load(src_c + static_cast<long long>(row) * s, v[u]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
        }
      }
      if (j0 == 0) {
        // the row of edge eb + lane (of the chunk's last edge past the end):
        // the w in [w_blk, w_last] with row_off[w] <= e < row_off[w + 1];
        // every lane takes the same number of probes
        const int e_mine = eb + lane < e_hi ? eb + lane : e_hi - 1;
        int lo = w_blk, hi = w_last;
        for (int n = w_last - w_blk + 1; n > 1; n = (n + 1) / 2) {
          const int mid = (lo + hi + 1) / 2;
          if (__ldg(row_off + mid) <= e_mine) lo = mid;
          else hi = mid - 1;
        }
        w_mine = lo;
        w_blk = __shfl_sync(kFull, w_mine, kWarp - 1);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e_step = eb + (j0 + u) * kEdges;
        if (e_step >= e_hi) break;  // the whole warp leaves together
        int r = __shfl_sync(kFull, w_mine, (j0 + u) * kEdges + q);
        if (e_step + q >= e_hi) r = -1;  // no edge: its zeros join no row
        if (q == 0) {
          if (r == acc_row) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) v[u][k] += acc[k];
          } else if (active) {
            // the open row ended with the step before
            flush_row<VEC, SCALED>(rin_c, row_scale, part, head_row, acc_row, s, acc);
          }
        }
#pragma unroll
        for (int d = G; d < kWarp; d *= 2) {
          const int r_up = __shfl_up_sync(kFull, r, d);
          float up[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) up[k] = __shfl_up_sync(kFull, v[u][k], d);
          if (lane >= d && r_up == r) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) v[u][k] += up[k];
          }
        }
        const int n_here = e_hi - e_step < kEdges ? e_hi - e_step : kEdges;
        const int r_down = __shfl_down_sync(kFull, r, G);
        if (active && q < n_here - 1 && r_down != r) {
          // another row follows within the step: this run is its row's last
          flush_row<VEC, SCALED>(rin_c, row_scale, part, head_row, r, s, v[u]);
        }
        // the step's last edge leaves its row open
        const int last = (n_here - 1) * G;
        acc_row = __shfl_sync(kFull, r, last);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = __shfl_sync(kFull, v[u][k], last + lane % G);
      }
    }
  }
  // the chunk's last row: shared if it began before the chunk or runs past
  // it, and then its partial is stored unscaled (pass 2 scales the sum)
  if (q == 0 && active) {
    if (acc_row != head_row && __ldg(row_off + acc_row + 1) > e_hi) {
      Cols<VEC>::store(part + s, acc);
    } else {
      flush_row<VEC, SCALED>(rin_c, row_scale, part, head_row, acc_row, s, acc);
    }
  }
}

// Pass 2, narrow: one warp per chunk boundary as above; the crossing row's
// partials go round the warp's 32 / G groups (group q takes every
// (32 / G)-th from the q-th on, in chunk order) and the groups' sums are
// added in a fixed tree.
template <int VEC, int G, bool SCALED>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segsum_spans_narrow_kernel(float* __restrict__ rin, const int* __restrict__ row_off,
                           const float* __restrict__ row_scale,
                           const float* __restrict__ scratch, int n_rows, int s,
                           int chunk_edges) {
  constexpr int kGroups = kWarp / G;
  const int lane = threadIdx.x % kWarp;
  const int q = lane / G;
  const int c = (lane % G) * VEC;
  const bool active = c < s;
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const long long e0 = __ldg(row_off);
  const long long e1 = __ldg(row_off + n_rows);
  const long long x = e0 + (b + 1) * chunk_edges;
  if (x >= e1) return;
  const int w = find_row(row_off, 0, n_rows, x, lane);
  const long long start = __ldg(row_off + w);
  if (start >= x || start < x - chunk_edges) return;
  const long long last = (__ldg(row_off + w + 1) - 1 - e0) / chunk_edges;  // > b
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  if (active) {
    if (q == 0) Cols<VEC>::load(scratch + (b * 2 + 1) * s + c, acc);
    for (long long j = b + 1 + q; j <= last; j += kGroups * kSpanNarrowUnroll) {
      float v[kSpanNarrowUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kSpanNarrowUnroll; ++u) {
        if (j + u * kGroups <= last) {
          Cols<VEC>::load(scratch + (j + u * kGroups) * 2 * s + c, v[u]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSpanNarrowUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += v[u][k];
      }
    }
  }
#pragma unroll
  for (int d = kWarp / 2; d >= G; d /= 2) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += __shfl_down_sync(kFull, acc[k], d);
  }
  // the one place a spanning row is scaled: on the sum of its partials
  if (q == 0 && active) add_into<VEC, SCALED>(rin, row_scale, w, s, c, acc);
}

int grid_for(long long warps) {
  return static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// Both launches at one vector width and G lanes per edge (32: lanes over
// columns alone, the wide kernels), with or without the scale.
template <typename T, typename I, int VEC, int G, bool GATHER, bool SCALED>
int launch_as(float* rin, const T* src, const I* gat, const int* row_off,
              const float* row_scale, float* scratch, int n_rows, int s,
              long long chunks, int chunk, cudaStream_t st) {
  const int threads = kWarp * kWarpsPerBlock;
  if constexpr (G == kWarp) {
    segsum_chunks_kernel<T, I, VEC, GATHER, SCALED><<<grid_for(chunks), threads, 0, st>>>(
        rin, src, gat, row_off, row_scale, scratch, n_rows, s, chunk);
  } else {
    segsum_chunks_narrow_kernel<T, I, VEC, G, GATHER, SCALED>
        <<<grid_for(chunks), threads, 0, st>>>(rin, src, gat, row_off, row_scale, scratch,
                                               n_rows, s, chunk);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || chunks < 2) return err;
  if constexpr (G == kWarp) {
    segsum_spans_kernel<VEC, SCALED><<<grid_for(chunks - 1), threads, 0, st>>>(
        rin, row_off, row_scale, scratch, n_rows, s, chunk);
  } else {
    segsum_spans_narrow_kernel<VEC, G, SCALED><<<grid_for(chunks - 1), threads, 0, st>>>(
        rin, row_off, row_scale, scratch, n_rows, s, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I, int VEC, bool GATHER, bool SCALED>
int launch_lanes(float* rin, const T* src, const I* gat, const int* row_off,
                 const float* row_scale, float* scratch, int n_rows, int s,
                 long long chunks, int chunk, int lanes, cudaStream_t st) {
#define PPRX_SEGSUM_LANES(G)                                                             \
  case G:                                                                                \
    return launch_as<T, I, VEC, G, GATHER, SCALED>(rin, src, gat, row_off, row_scale,    \
                                                   scratch, n_rows, s, chunks, chunk, st)
  switch (lanes) {
    PPRX_SEGSUM_LANES(1);
    PPRX_SEGSUM_LANES(2);
    PPRX_SEGSUM_LANES(4);
    PPRX_SEGSUM_LANES(8);
    PPRX_SEGSUM_LANES(16);
    PPRX_SEGSUM_LANES(32);
  }
#undef PPRX_SEGSUM_LANES
  return static_cast<int>(cudaErrorInvalidValue);
}

// Both launches. n_edges is the length of the edge array (contribs rows or
// gat entries): the range [row_off[0], row_off[R]) lies inside it, so
// ceil(n_edges / chunk) chunks cover it and the surplus warps return at
// once. scratch holds that many [2, s] f32 partials. The layout is the
// caller's (pprx_torch/engine/segsum.py `layout_for`, which also sizes the
// scratch): chunk edges per warp, vec columns per lane (4 needs s % 4 ==
// 0), lanes per edge (a power of two; under 32 only where lanes * vec
// covers s). row_scale is null for a plain sum.
template <typename T, typename I, bool GATHER>
int launch(float* rin, const T* src, const I* gat, const int* row_off,
           const float* row_scale, float* scratch, int n_rows, int s,
           long long n_edges, int chunk, int vec, int lanes, void* stream) {
  if (n_rows <= 0 || n_edges <= 0 || s <= 0) return 0;
  if (chunk <= 0 || (vec != 1 && vec != 4) || s % vec != 0 ||
      (lanes < kWarp && lanes * vec < s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = (n_edges + chunk - 1) / chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row_scale != nullptr) {
    return vec == 4 ? launch_lanes<T, I, 4, GATHER, true>(rin, src, gat, row_off, row_scale,
                                                          scratch, n_rows, s, chunks, chunk,
                                                          lanes, st)
                    : launch_lanes<T, I, 1, GATHER, true>(rin, src, gat, row_off, row_scale,
                                                          scratch, n_rows, s, chunks, chunk,
                                                          lanes, st);
  }
  return vec == 4 ? launch_lanes<T, I, 4, GATHER, false>(rin, src, gat, row_off, nullptr,
                                                         scratch, n_rows, s, chunks, chunk,
                                                         lanes, st)
                  : launch_lanes<T, I, 1, GATHER, false>(rin, src, gat, row_off, nullptr,
                                                         scratch, n_rows, s, chunks, chunk,
                                                         lanes, st);
}

}  // namespace

extern "C" {

// Every entry below takes row_scale, f32 [n_rows] or null for a plain sum,
// and the layout: chunk, vec, lanes (see `launch`).

int pprx_segsum_add_f32(float* rin, const float* contribs, const int* row_off,
                        const float* row_scale, float* scratch, int n_rows, int s,
                        long long n_edges, int chunk, int vec, int lanes, void* stream) {
  return launch<float, int, false>(rin, contribs, nullptr, row_off, row_scale,
                                   scratch, n_rows, s, n_edges, chunk, vec, lanes, stream);
}

int pprx_segsum_add_bf16(float* rin, const void* contribs, const int* row_off,
                         const float* row_scale, float* scratch, int n_rows, int s,
                         long long n_edges, int chunk, int vec, int lanes, void* stream) {
  return launch<__nv_bfloat16, int, false>(
      rin, static_cast<const __nv_bfloat16*>(contribs), nullptr, row_off,
      row_scale, scratch, n_rows, s, n_edges, chunk, vec, lanes, stream);
}

int pprx_segsum_gather_add_f32_i32(float* rin, const float* table, const int* gat,
                                   const int* row_off, const float* row_scale,
                                   float* scratch, int n_rows, int s, long long n_edges,
                                   int chunk, int vec, int lanes, void* stream) {
  return launch<float, int, true>(rin, table, gat, row_off, row_scale, scratch,
                                  n_rows, s, n_edges, chunk, vec, lanes, stream);
}

int pprx_segsum_gather_add_f32_i64(float* rin, const float* table,
                                   const long long* gat, const int* row_off,
                                   const float* row_scale, float* scratch,
                                   int n_rows, int s, long long n_edges, int chunk,
                                   int vec, int lanes, void* stream) {
  return launch<float, long long, true>(rin, table, gat, row_off, row_scale, scratch,
                                        n_rows, s, n_edges, chunk, vec, lanes, stream);
}

int pprx_segsum_gather_add_bf16_i32(float* rin, const void* table, const int* gat,
                                    const int* row_off, const float* row_scale,
                                    float* scratch, int n_rows, int s, long long n_edges,
                                    int chunk, int vec, int lanes, void* stream) {
  return launch<__nv_bfloat16, int, true>(
      rin, static_cast<const __nv_bfloat16*>(table), gat, row_off, row_scale,
      scratch, n_rows, s, n_edges, chunk, vec, lanes, stream);
}

int pprx_segsum_gather_add_bf16_i64(float* rin, const void* table,
                                    const long long* gat, const int* row_off,
                                    const float* row_scale, float* scratch,
                                    int n_rows, int s, long long n_edges, int chunk,
                                    int vec, int lanes, void* stream) {
  return launch<__nv_bfloat16, long long, true>(
      rin, static_cast<const __nv_bfloat16*>(table), gat, row_off, row_scale,
      scratch, n_rows, s, n_edges, chunk, vec, lanes, stream);
}

}  // extern "C"
