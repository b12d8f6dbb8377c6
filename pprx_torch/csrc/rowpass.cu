// Row passes over the [N+1, S] push state for Hopper (sm_90a), four entries:
//
//   scan_pass (K2): a scan round's elementwise work, in place, for every row v
//     th = eps * max(deg[v], 1) (forward) or eps (reverse)
//     a  = |r| > th,   m = a ? r : 0
//     p += (deg[v] == 0) ? m : alpha * m;   r -= m
//     moving = ((1 - alpha) * m) * (1 / max(deg[v], 1))        (forward)
//            = (deg[v] == 0) ? beta * m : (1 - alpha) * m      (reverse)
//     counts[0] += sum a;  forward: counts[1] += sum a * deg[v]
//     row_act[v] = sum over the row of a (where row_act is given)
//   frontier_rows (K3): the post-delivery rescan, reading r once
//     any[v] = some |r[v, j]| > th;  counts += (sum any, sum any * row_len,
//     sum any * f_len)
//   corr_forward, corr_reverse: a slide's corrections' row work
//     (pprx_torch/engine/update.py) on the rows of a list, the batch's
//     source rows padded with the phantom row n, whose entries are skipped:
//     forward  r[u] += p[u] * c_r[u] (one fma);  p[u] *= c_p[u]
//     reverse  x = diff[i] / max(deg_new[u], 1), or p[u] where deg_new[u] == 0;
//              x -= rowsum[u] / max(d0[u], 1);  x -= p[u] * (d0[u] == 0);
//              r[u] += x * beta       (u = rows[i]; diff [T, S] in list order)
//
// No Pallas kernel is replaced: on the TPU this work was XLA's fusion of
// `dense_round_sorted` (pprx/engine/wl2.py:177-290, its activity mask,
// mass, p2, r2, moving and counts) and of the rescan after a delivery
// (pprx/engine/wl2.py:506-516 and :639-649). Eager torch runs each of those
// ops as a pass over the state of its own; here each is one pass.
//
// Bound: bytes; a handful of f32 operations an element. At the headline
// ((N+1) * S = 25,600,128 elements):
//   K2 reads r and p and writes r, p and moving: 512.8 MB with f32 moving,
//      about 0.153 ms at 3.35 TB/s; 461.6 MB with bf16 moving, 0.138 ms;
//   K3 reads r, and deg, row_len and f_len, and writes one byte a row:
//      about 105 MB, 0.031 ms.
// At S=8 and S=16 (configs 3 and 2) both are at the launch floor, about
// 0.004 ms of device time. The corrections' passes move T listed rows (at
// the stream cells, b = 160,000: T = 320,000 entries, ~222k of them real):
// forward reads and writes r and p, 4 * 4 S bytes a row; reverse reads
// diff, rowsum, p and r and writes r, 5 * 4 S bytes a row.
//
// Why they are kernels: in torch the list's rows are gathered into a
// [T, S] block, updated, and written back by index_copy_, whose padding
// entries all write the phantom row: ~100k writers of one row, which cost
// more than the rest of the work (0.53 ms a write-back at the stream cells
// on an H100). Here a padding entry writes nothing, and a listed row is
// read and written where it lies.
//
// Design: a group of lanes owns a row. Each lane moves 16 bytes of f32 at
// a time (4 columns) where S is a multiple of 4, and one column at a time
// otherwise; the group is the least power of two of lanes that covers the
// row, at most a warp, and a wider row goes round the group again (S=128:
// one warp a row; S=16: four lanes; S=8: two). So a warp step reads 512
// consecutive bytes of each of r and p at every width that is a multiple
// of 4. A row's own count (row_act, any) is a shuffle inside its group.
// K2 moves one row step a warp at a time; K3 loads U row steps at once
// before it reduces any (see frontier_rows_kernel). A launch is one wave at
// most: as many blocks as the card holds at once, whose warps stride over
// the row steps, so no second, partial wave of blocks runs at the end.
// The whole-state counts are integers: each block sums its rows and adds
// its sums with one 64-bit integer atomic each, so they are exact and the
// same on every run. Every other output is elementwise: two runs on the
// same inputs give the same bits.
//
// The same bits as the plain version (pprx_torch/engine/rowpass.py,
// `scan_pass_plain`, the torch code it replaces): every product, sum and
// difference is one rounded f32 operation written with the _rn intrinsics,
// so that nvcc contracts none of them into an FMA, in the order torch
// evaluates them; the wrapper passes the constants as torch rounds its
// Python scalars (float32 of alpha, of 1 - alpha, of (1 - alpha) / alpha,
// of eps); torch's `1.0 / x` is reciprocal(x) * 1, so the inverse degree is
// __fdiv_rn(1, max(deg, 1)); bf16 is round to nearest even.
//
// Plain C interface, loaded with ctypes: the launch goes on the caller's
// stream, allocates nothing (the wrapper zeroes `counts` and allocates every
// output), and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;

template <int VEC>
__device__ __forceinline__ void load(const float* src, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = *src;
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* dst, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *dst = x[0];
  }
}

// Data read once (K3's r): a streaming load, evict-first in L1 and L2
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

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// bf16 moving: round to nearest even; 4 columns are one 8-byte store
template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* dst, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(bf16_bits(x[0]) | (bf16_bits(x[1]) << 16),
                                                bf16_bits(x[2]) | (bf16_bits(x[3]) << 16));
  } else {
    *dst = __float2bfloat16_rn(x[0]);
  }
}

struct Consts {
  float eps, alpha, one_minus_alpha, beta;
};

// Sums of a block's threads, added into counts[0..K) by thread 0: one
// integer atomic a count and block.
template <int K>
__device__ __forceinline__ void add_counts(long long (&acc)[K], unsigned long long* counts) {
  __shared__ long long part[K][kWarpsPerBlock];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    for (int o = kWarp / 2; o > 0; o >>= 1) acc[k] += __shfl_xor_sync(kFull, acc[k], o);
    if (lane == 0) part[k][warp] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      long long sum = 0;
      for (int w = 0; w < kWarpsPerBlock; ++w) sum += part[k][w];
      if (sum != 0) atomicAdd(counts + k, static_cast<unsigned long long>(sum));
    }
  }
}

// Rows are walked in warp steps: a warp step covers kWarp / lanes
// consecutive rows, one to each group of `lanes` lanes, and the warps of the
// grid stride over the steps. The loop bound is the same for every lane of
// a warp, so the shuffles after a row always see the whole warp.
template <int VEC, typename MT, bool FORWARD>
__global__ void __launch_bounds__(kThreads)
    scan_pass_kernel(float* __restrict__ p, float* __restrict__ r, const int* __restrict__ deg,
                     MT* __restrict__ moving, unsigned long long* __restrict__ counts,
                     int* __restrict__ row_act, long long n_rows, int s, int lanes, Consts c) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int sub = lane / lanes;
  const int own = lane & (lanes - 1);
  const int rows_per_step = kWarp / lanes;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  long long acc[2] = {0, 0};
  for (long long base = warp * rows_per_step; base < n_rows; base += n_warps * rows_per_step) {
    const long long v = base + sub;
    int cnt = 0;
    int d = 0;
    if (v < n_rows) {
      d = deg[v];
      const float df = __int2float_rn(d > 1 ? d : 1);
      const float th = FORWARD ? __fmul_rn(c.eps, df) : c.eps;
      const float inv = __fdiv_rn(1.f, df);
      const bool dangling = d == 0;
      const long long row = v * s;
      for (int j = own * VEC; j < s; j += lanes * VEC) {
        float rr[VEC], pp[VEC], mv[VEC];
        load(r + row + j, rr);
        load(p + row + j, pp);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const bool a = fabsf(rr[e]) > th;
          const float m = a ? rr[e] : 0.f;
          cnt += a;
          pp[e] = __fadd_rn(pp[e], dangling ? m : __fmul_rn(c.alpha, m));
          rr[e] = __fsub_rn(rr[e], m);
          if (FORWARD) {
            mv[e] = __fmul_rn(__fmul_rn(c.one_minus_alpha, m), inv);
          } else {
            mv[e] = dangling ? __fmul_rn(c.beta, m) : __fmul_rn(c.one_minus_alpha, m);
          }
        }
        store(r + row + j, rr);
        store(p + row + j, pp);
        store(moving + row + j, mv);
      }
    }
    for (int o = lanes / 2; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
    if (v < n_rows && own == 0) {
      if (row_act != nullptr) row_act[v] = cnt;
      acc[0] += cnt;
      if (FORWARD) acc[1] += static_cast<long long>(cnt) * d;
    }
  }
  add_counts<2>(acc, counts);
}

// K3's design. Its first form walked one row a warp step: it loaded the row
// (at S=128 512 bytes, one 16-byte load a lane), reduced it, and only then
// loaded the two lengths of a row it found active, a second round trip,
// before it moved to its next row: 0.0658 ms forward and 0.0572 reverse at
// the headline on an H100 80GB HBM3 at 700 W, against a byte bound of 0.031
// ms (48-54%). This form was chosen by CUDA-event timings of its variants,
// without a profiler's counters: each warp issues the loads of U row steps
// at once, with their deg, row_len and f_len beside them, all independent
// of each other, and reduces only then. The threshold test is
// max_j |r[v, j]| > th, which is any_j |r[v, j]| > th (a NaN passes
// neither), so the loop over a row's columns waits on no deg. The lengths
// are read for every row, active or not: 8 bytes a row against a row's 4 *
// S. r is read once, by streaming loads. U (kRowsInFlight) = 2 was the
// fastest of 1, 2, 4 and 8 at S=128 and S=16, level with 4 at S=8: each
// step of U takes registers, so resident warps, and U = 4 and 8 lost more to
// that than they gained in loads a warp keeps in flight; capping the
// registers by launch bounds to hold more blocks an SM spilled and was
// slower (PERF.md keeps the sweep). (A producer warp streaming tiles through
// shared memory with bulk copies would keep as many bytes in flight, but
// adds a handshake for data read once and reduced to one bit.)
constexpr int kRowsInFlight = 2;

template <int VEC, bool FORWARD>
__global__ void __launch_bounds__(kThreads)
    frontier_rows_kernel(const float* __restrict__ r, const int* __restrict__ deg,
                         const int* __restrict__ row_len, const int* __restrict__ f_len,
                         unsigned char* __restrict__ any, unsigned long long* __restrict__ counts,
                         long long n_rows, int s, int lanes, float eps) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int sub = lane / lanes;
  const int own = lane & (lanes - 1);
  const int rows_per_step = kWarp / lanes;
  constexpr int U = kRowsInFlight;
  const long long rows_per_warp = static_cast<long long>(rows_per_step) * U;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  long long acc[3] = {0, 0, 0};
  for (long long base = warp * rows_per_warp; base < n_rows; base += n_warps * rows_per_warp) {
    long long v[U], at[U];
    int d[U], len[U], flen[U];
    float top[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = base + u * rows_per_step + sub;
      // a row past the end reads the last row and writes nothing
      at[u] = v[u] < n_rows ? v[u] : n_rows - 1;
      d[u] = FORWARD ? deg[at[u]] : 0;
      len[u] = row_len[at[u]];
      flen[u] = f_len[at[u]];
      top[u] = 0.f;
    }
    for (int j = own * VEC; j < s; j += lanes * VEC) {
      float rr[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) load_once(r + at[u] * s + j, rr[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) top[u] = fmaxf(top[u], fabsf(rr[u][e]));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int o = lanes / 2; o > 0; o >>= 1)
        top[u] = fmaxf(top[u], __shfl_xor_sync(kFull, top[u], o));
      const float th = FORWARD ? __fmul_rn(eps, __int2float_rn(d[u] > 1 ? d[u] : 1)) : eps;
      const bool hit = top[u] > th;
      if (v[u] < n_rows && own == 0) {
        any[v[u]] = static_cast<unsigned char>(hit);
        if (hit) {
          acc[0] += 1;
          acc[1] += len[u];
          acc[2] += flen[u];
        }
      }
    }
  }
  add_counts<3>(acc, counts);
}

// The corrections' row work: list entries are walked as K2 walks rows (a
// group of lanes an entry, warp steps over the grid), each entry's row read
// and written where it lies; an entry that names the phantom row (u >= n)
// is skipped. The arithmetic is the plain version's (rowpass.py,
// `corr_forward_plain`, `corr_reverse_plain`) op for op, as torch's kernels
// round it: addcmul's a + value * b * c is one fma (value * b is exact at
// value 1 or -1), held bit for bit on the card; addcdiv's a + value * (b /
// c) rounds the quotient first; add is one rounded sum.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    corr_forward_kernel(float* __restrict__ r, float* __restrict__ p,
                        const long long* __restrict__ rows, const float* __restrict__ c_r,
                        const float* __restrict__ c_p, long long t, long long n, int s,
                        int lanes) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int sub = lane / lanes;
  const int own = lane & (lanes - 1);
  const int per_step = kWarp / lanes;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (long long base = warp * per_step; base < t; base += n_warps * per_step) {
    const long long i = base + sub;
    const long long u = i < t ? rows[i] : n;
    if (u >= n) continue;
    const float cr = c_r[u];
    const float cp = c_p[u];
    const long long row = u * s;
    for (int j = own * VEC; j < s; j += lanes * VEC) {
      float rr[VEC], pp[VEC];
      load(r + row + j, rr);
      load(p + row + j, pp);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        rr[e] = __fmaf_rn(pp[e], cr, rr[e]);
        pp[e] = __fmul_rn(pp[e], cp);
      }
      store(r + row + j, rr);
      store(p + row + j, pp);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    corr_reverse_kernel(float* __restrict__ r, const float* __restrict__ p,
                        const float* __restrict__ rowsum, const float* __restrict__ diff,
                        const long long* __restrict__ rows, const int* __restrict__ deg_new,
                        const int* __restrict__ d0, long long t, long long n, int s, int lanes,
                        float beta) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int sub = lane / lanes;
  const int own = lane & (lanes - 1);
  const int per_step = kWarp / lanes;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (long long base = warp * per_step; base < t; base += n_warps * per_step) {
    const long long i = base + sub;
    const long long u = i < t ? rows[i] : n;
    if (u >= n) continue;
    const int dn = deg_new[u];
    const int dz = d0[u];
    const float dnf = __int2float_rn(dn > 1 ? dn : 1);
    const float d0f = __int2float_rn(dz > 1 ? dz : 1);
    const float z = dz == 0 ? 1.f : 0.f;
    const long long row = u * s;
    const long long at = i * s;
    for (int j = own * VEC; j < s; j += lanes * VEC) {
      float x[VEC], rs[VEC], pp[VEC], rr[VEC];
      load(diff + at + j, x);
      load(rowsum + row + j, rs);
      load(p + row + j, pp);
      load(r + row + j, rr);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = dn == 0 ? pp[e] : __fdiv_rn(x[e], dnf);
        v = __fsub_rn(v, __fdiv_rn(rs[e], d0f));
        v = __fmaf_rn(-pp[e], z, v);
        rr[e] = __fadd_rn(rr[e], __fmul_rn(v, beta));
      }
      store(r + row + j, rr);
    }
  }
}

// One launch on the caller's stream, of at most one wave: as many blocks as
// the card holds at once (the occupancy calculator's count, found at a
// kernel's first launch, times the SMs), each striding over the rows the
// wave leaves; a state with fewer row steps gets fewer blocks.
template <auto Kernel, typename... Args>
int launch(int wanted, void* stream, Args... args) {
  static int wave = 0;
  if (wave == 0) {
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, 0);
    wave = (per_sm > 0 ? per_sm : 1) * n_sm;
  }
  const int blocks = wanted < wave ? wanted : wave;
  Kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, typename MT>
int scan_pass_vec(int forward, int wanted, void* stream, float* p, float* r, const int* deg,
              MT* moving, long long* counts, int* row_act, long long n_rows, int s, int lanes,
              Consts c) {
  auto* cnt = reinterpret_cast<unsigned long long*>(counts);
  return forward ? launch<scan_pass_kernel<VEC, MT, true>>(wanted, stream, p, r, deg, moving,
                                                           cnt, row_act, n_rows, s, lanes, c)
                 : launch<scan_pass_kernel<VEC, MT, false>>(wanted, stream, p, r, deg, moving,
                                                            cnt, row_act, n_rows, s, lanes, c);
}

template <typename MT>
int scan_pass(float* p, float* r, const int* deg, MT* moving, long long* counts, int* row_act,
              long long n_rows, int s, int vec, int lanes, int blocks, int forward, Consts c,
              void* stream) {
  return vec == 4 ? scan_pass_vec<4, MT>(forward, blocks, stream, p, r, deg, moving, counts,
                                         row_act, n_rows, s, lanes, c)
                  : scan_pass_vec<1, MT>(forward, blocks, stream, p, r, deg, moving, counts,
                                         row_act, n_rows, s, lanes, c);
}

template <int VEC>
int frontier_rows_vec(int forward, int wanted, void* stream, const float* r, const int* deg,
                  const int* row_len, const int* f_len, void* any, long long* counts,
                  long long n_rows, int s, int lanes, float eps) {
  auto* a = static_cast<unsigned char*>(any);
  auto* cnt = reinterpret_cast<unsigned long long*>(counts);
  return forward ? launch<frontier_rows_kernel<VEC, true>>(wanted, stream, r, deg, row_len, f_len,
                                                           a, cnt, n_rows, s, lanes, eps)
                 : launch<frontier_rows_kernel<VEC, false>>(wanted, stream, r, deg, row_len,
                                                            f_len, a, cnt, n_rows, s, lanes, eps);
}

}  // namespace

extern "C" {

// The corrections' passes: r, p (and rowsum): f32 [n + 1, s]; diff: f32 [t,
// s]; rows: int64 [t]; c_r, c_p: f32 [n + 1]; deg_new, d0: int32 [n + 1];
// vec, lanes and blocks as for K2, over the t list entries.

int pprx_corr_forward(float* r, float* p, const long long* rows, const float* c_r,
                      const float* c_p, long long t, long long n, int s, int vec, int lanes,
                      int blocks, void* stream) {
  return vec == 4 ? launch<corr_forward_kernel<4>>(blocks, stream, r, p, rows, c_r, c_p, t, n,
                                                   s, lanes)
                  : launch<corr_forward_kernel<1>>(blocks, stream, r, p, rows, c_r, c_p, t, n,
                                                   s, lanes);
}

int pprx_corr_reverse(float* r, const float* p, const float* rowsum, const float* diff,
                      const long long* rows, const int* deg_new, const int* d0, long long t,
                      long long n, int s, int vec, int lanes, int blocks, float beta,
                      void* stream) {
  return vec == 4 ? launch<corr_reverse_kernel<4>>(blocks, stream, r, p, rowsum, diff, rows,
                                                   deg_new, d0, t, n, s, lanes, beta)
                  : launch<corr_reverse_kernel<1>>(blocks, stream, r, p, rowsum, diff, rows,
                                                   deg_new, d0, t, n, s, lanes, beta);
}

// p, r: f32 [n_rows, s]; deg: int32 [n_rows]; moving: [n_rows, s] f32 or
// bf16; counts: int64 [2]; row_act: int32 [n_rows] or null. vec is 4 (s a
// multiple of 4, 16-byte-aligned rows) or 1; lanes a power of two up to 32;
// blocks: the row steps over the block's warps (one wave at most runs).

int pprx_scan_pass_f32(float* p, float* r, const int* deg, float* moving, long long* counts,
                       int* row_act, long long n_rows, int s, int vec, int lanes, int blocks,
                       int forward, float eps, float alpha, float one_minus_alpha, float beta,
                       void* stream) {
  return scan_pass<float>(p, r, deg, moving, counts, row_act, n_rows, s, vec, lanes, blocks,
                          forward, Consts{eps, alpha, one_minus_alpha, beta}, stream);
}

int pprx_scan_pass_bf16(float* p, float* r, const int* deg, void* moving, long long* counts,
                        int* row_act, long long n_rows, int s, int vec, int lanes, int blocks,
                        int forward, float eps, float alpha, float one_minus_alpha, float beta,
                        void* stream) {
  return scan_pass<__nv_bfloat16>(p, r, deg, static_cast<__nv_bfloat16*>(moving), counts,
                                  row_act, n_rows, s, vec, lanes, blocks, forward,
                                  Consts{eps, alpha, one_minus_alpha, beta}, stream);
}

// r: f32 [n_rows, s]; deg, row_len, f_len: int32 [n_rows]; any: bool
// [n_rows]; counts: int64 [3]; blocks as for K2 (a warp takes
// kRowsInFlight of those row steps at once, so it launches that many times
// fewer).
int pprx_frontier_rows(const float* r, const int* deg, const int* row_len, const int* f_len,
                       void* any, long long* counts, long long n_rows, int s, int vec,
                       int lanes, int blocks, int forward, float eps, void* stream) {
  const int wanted = (blocks + kRowsInFlight - 1) / kRowsInFlight;
  return vec == 4 ? frontier_rows_vec<4>(forward, wanted, stream, r, deg, row_len, f_len, any,
                                         counts, n_rows, s, lanes, eps)
                  : frontier_rows_vec<1>(forward, wanted, stream, r, deg, row_len, f_len, any,
                                         counts, n_rows, s, lanes, eps);
}

}  // extern "C"
