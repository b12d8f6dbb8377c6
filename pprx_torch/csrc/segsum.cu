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
//    (`chunk_for`), so that a fresh view or a compact round still spreads
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

// Tunables. Swept in turns within one run on an H100 80GB HBM3 at 700 W
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
constexpr int kChunkMax = 256;       // most edges per warp; a multiple of 32
constexpr int kChunkMin = 64;        // fewest edges per warp, for short edge arrays
constexpr int kChunksWanted = 4096;  // chunks below which the chunk is halved
constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;           // loads in flight per lane; divides 32
constexpr int kSpanUnroll = 8;

static_assert(kChunkMin > 0 && kChunkMin % kWarp == 0 && kChunkMax >= kChunkMin &&
                  (kChunkMax / kChunkMin & (kChunkMax / kChunkMin - 1)) == 0 &&
                  kChunkMax % kChunkMin == 0,
              "chunk sizes: multiples of 32, the largest a power of two times the smallest");

static_assert(kUnroll > 0 && kWarp % kUnroll == 0, "unroll must divide 32");

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
// range that holds the answer: 4 steps for 200k rows.
__device__ int find_row(const int* __restrict__ row_off, int n_rows, long long e,
                        int lane) {
  int lo = 0, hi = n_rows;  // row_off[lo] <= e < row_off[hi]
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
  const int w0 = find_row(row_off, n_rows, e_lo, lane);
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
                w = find_row(row_off, n_rows, e, lane);
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
  const int w = find_row(row_off, n_rows, x, lane);
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

int grid_for(long long warps) {
  return static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// Edges per chunk for an edge array of n_edges: the largest of kChunkMax,
// kChunkMax / 2, ... kChunkMin that still cuts it into kChunksWanted pieces
// (about one per warp the card holds at once), so that a short call (a
// fresh view, a compact round) spreads as wide as a window scan does. A
// function of n_edges alone: the same inputs are always cut the same way.
int chunk_for(long long n_edges) {
  int c = kChunkMax;
  while (c > kChunkMin && n_edges / c < kChunksWanted) c /= 2;
  return c;
}

// Both launches at one vector width, with or without the scale.
template <typename T, typename I, int VEC, bool GATHER, bool SCALED>
int launch_as(float* rin, const T* src, const I* gat, const int* row_off,
              const float* row_scale, float* scratch, int n_rows, int s,
              long long chunks, int chunk, cudaStream_t st) {
  const int threads = kWarp * kWarpsPerBlock;
  segsum_chunks_kernel<T, I, VEC, GATHER, SCALED><<<grid_for(chunks), threads, 0, st>>>(
      rin, src, gat, row_off, row_scale, scratch, n_rows, s, chunk);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || chunks < 2) return err;
  segsum_spans_kernel<VEC, SCALED><<<grid_for(chunks - 1), threads, 0, st>>>(
      rin, row_off, row_scale, scratch, n_rows, s, chunk);
  return static_cast<int>(cudaGetLastError());
}

// Both launches. n_edges is the length of the edge array (contribs rows or
// gat entries): the range [row_off[0], row_off[R]) lies inside it, so
// ceil(n_edges / chunk) chunks cover it and the surplus warps return at
// once. scratch holds that many [2, s] f32 partials. chunk is the edges per
// chunk the caller sized the scratch for: chunk_for(n_edges), or another
// value where a test wants a given split. row_scale is null for a plain sum.
template <typename T, typename I, bool GATHER>
int launch(float* rin, const T* src, const I* gat, const int* row_off,
           const float* row_scale, float* scratch, int n_rows, int s,
           long long n_edges, int chunk, void* stream) {
  if (n_rows <= 0 || n_edges <= 0 || s <= 0) return 0;
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (n_edges + chunk - 1) / chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = s % 4 == 0;
  if (row_scale != nullptr) {
    return vec4 ? launch_as<T, I, 4, GATHER, true>(rin, src, gat, row_off, row_scale,
                                                   scratch, n_rows, s, chunks, chunk, st)
                : launch_as<T, I, 1, GATHER, true>(rin, src, gat, row_off, row_scale,
                                                   scratch, n_rows, s, chunks, chunk, st);
  }
  return vec4 ? launch_as<T, I, 4, GATHER, false>(rin, src, gat, row_off, nullptr,
                                                  scratch, n_rows, s, chunks, chunk, st)
              : launch_as<T, I, 1, GATHER, false>(rin, src, gat, row_off, nullptr,
                                                  scratch, n_rows, s, chunks, chunk, st);
}

}  // namespace

extern "C" {

// Edges per chunk for an edge array of n_edges: the wrapper sizes the
// scratch as [ceil(n_edges / chunk), 2, s] f32 and passes the chunk on.
int pprx_segsum_chunk(long long n_edges) { return chunk_for(n_edges); }

// Every entry below takes row_scale, f32 [n_rows] or null for a plain sum.

int pprx_segsum_add_f32(float* rin, const float* contribs, const int* row_off,
                        const float* row_scale, float* scratch, int n_rows, int s,
                        long long n_edges, int chunk, void* stream) {
  return launch<float, int, false>(rin, contribs, nullptr, row_off, row_scale,
                                   scratch, n_rows, s, n_edges, chunk, stream);
}

int pprx_segsum_add_bf16(float* rin, const void* contribs, const int* row_off,
                         const float* row_scale, float* scratch, int n_rows, int s,
                         long long n_edges, int chunk, void* stream) {
  return launch<__nv_bfloat16, int, false>(
      rin, static_cast<const __nv_bfloat16*>(contribs), nullptr, row_off,
      row_scale, scratch, n_rows, s, n_edges, chunk, stream);
}

int pprx_segsum_gather_add_f32_i32(float* rin, const float* table, const int* gat,
                                   const int* row_off, const float* row_scale,
                                   float* scratch, int n_rows, int s,
                                   long long n_edges, int chunk, void* stream) {
  return launch<float, int, true>(rin, table, gat, row_off, row_scale, scratch,
                                  n_rows, s, n_edges, chunk, stream);
}

int pprx_segsum_gather_add_f32_i64(float* rin, const float* table,
                                   const long long* gat, const int* row_off,
                                   const float* row_scale, float* scratch,
                                   int n_rows, int s, long long n_edges, int chunk,
                                   void* stream) {
  return launch<float, long long, true>(rin, table, gat, row_off, row_scale,
                                        scratch, n_rows, s, n_edges, chunk, stream);
}

int pprx_segsum_gather_add_bf16_i32(float* rin, const void* table, const int* gat,
                                    const int* row_off, const float* row_scale,
                                    float* scratch, int n_rows, int s,
                                    long long n_edges, int chunk, void* stream) {
  return launch<__nv_bfloat16, int, true>(
      rin, static_cast<const __nv_bfloat16*>(table), gat, row_off, row_scale,
      scratch, n_rows, s, n_edges, chunk, stream);
}

int pprx_segsum_gather_add_bf16_i64(float* rin, const void* table,
                                    const long long* gat, const int* row_off,
                                    const float* row_scale, float* scratch,
                                    int n_rows, int s, long long n_edges, int chunk,
                                    void* stream) {
  return launch<__nv_bfloat16, long long, true>(
      rin, static_cast<const __nv_bfloat16*>(table), gat, row_off, row_scale,
      scratch, n_rows, s, n_edges, chunk, stream);
}

}  // extern "C"
