// K4: the convergence loops' control on the card (sm_90a), the
// compact-frontier loops of the wl2 engine and of the sharded wl engine in a
// world of one shard, the dense loop of the dense engine and of the sharded
// dense engine in that world, that world's memory-proportional loop (wlp),
// and the hybrid engine's two loops, and the CUDA graph that runs a whole
// loop:
//
//   [prologue] -> prime -> WHILE { turn -> SWITCH { tier_0 | ... | tier_k-1
//                                                 | scan -> after_scan -> IF { stats } } }
//
// or, under the dense rule, one arm: WHILE { turn -> SWITCH { round } };
// under the proportional rule, no stats:
// WHILE { turn -> SWITCH { tier_0 | ... | tier_k-1 | drain | rescan } };
// under the hybrid rule, no stats: WHILE { turn -> SWITCH { tier_0 | ... |
// tier_k-1 | scan_0 | ... | scan_ks-1 | dense | count } }.
//
// Each body of the SWITCH holds a child graph, a clone of the branch that
// the port captured with torch (a compact tier, the scan round), and the
// scan's body also its stats under an IF; the prologue (a slide's, or a
// seed's first count) is a child graph likewise. The three control steps
// work on the loop's carry, a small int64 array:
//   prime       the loop's start from the first list's counts;
//   turn        the last round's tally, where one is pending (its
//               statistics, the next round's counts, the branch's execution
//               count, whether the loop goes on), then, where the loop goes
//               on, the next round's branch: a compact tier (the count of
//               lower tiers whose capacities the counts miss) or the scan,
//               logged with the counts it read. Where the loop ends it gives
//               the SWITCH k + 1, past its last arm, and the SWITCH runs
//               nothing;
//   after_scan  whether a scan's next-frontier stats run (not after a heavy
//               scan, nor where no round follows).
// A loop of R >= 1 rounds runs R + 1 turns: one K4 node a tier round, two a
// scan round (under the hybrid rule one, and a turn more for each count);
// a loop that prime stops runs none. The table's rule field
// picks the sharded engine's loop: its first round always runs, and its
// heavy test reads ewr, the counts' sixth slot, where wl2's reads the edge
// work ew (pprx/dist/wl.py:911-917, 1023). Or the dense engine's
// (pprx/engine/push.py:94-119): prime reads the first active count, the
// reference's n0, and a turn tallies the round's active pairs and edge
// pushes and goes on while the round found an active pair, as the
// reference's cond does; no tiers, no stats. Or the proportional loop
// (pprx/dist/wl.py:1177-1214): a pending carry (the counts' sixth slot,
// kept in the carry's kPend) takes the drain, else a valid list its tier
// and an invalid one the rescan; a turn tallies the round's count (its
// active pairs; a drain's, whether it left a list) and goes on while that
// or the pending carry is not zero. Or the hybrid engine's loops
// (pprx/engine/sparse.py:457-586): a valid list whose counts fit the top
// tier takes its tier; any other round is a scan, whose arm is chosen from
// the exact frontier's rows and edges (kXn, kXf; kXn -1 where a worklist
// round left bounds only, and then the count arm, which pushes nothing and
// is not a round, runs first): the smallest scan tier that holds them where
// the reference's worth test holds, else the dense scan. Each step does what
// its plain
// step in pprx_torch/engine/loop.py does, on the same slots, and sets the
// graph's conditions with cudaGraphSetConditional: prime the WHILE's, turn
// the SWITCH's (the branch's number) and the WHILE's, after_scan the stats
// IF's. A SWITCH node (CUDA 12.8) takes one node's evaluation a round where
// a chain of IF nodes, one a branch, takes k + 1.
//
// No Pallas kernel is replaced. K4 is the counterpart of the reference's
// on-device control flow, the lax.while_loop at pprx/engine/wl2.py:687
// with its lax.switch over the tiers (:617) and lax.cond over worklist or
// scan (:657) and over a scan's stats (:662), of the sharded engine's at
// pprx/dist/wl.py:1025 with its lax.switch over the tiers and the dense
// round (:995) and lax.cond over the dense round's stats (:954) and
// with its lax.switch over the tiers, the drain and the rescan (:1214), and
// of the dense engines' at pprx/engine/push.py:118 and
// pprx/dist/sharded.py:398, and of the hybrid engine's at
// pprx/engine/sparse.py:554 (its lax.cond over worklist or scan at :520,
// its lax.switch over the tiers at :505 and over the scan tiers and the
// dense round at :193-201) and :585.
//
// What bounds K4 on this card is latency, not bytes: a step moves about
// 600 bytes (2e-7 ms at 3.35 TB/s), and a kernel node inside a graph costs
// about a microsecond however little it does. The design cuts both the
// nodes and each node's time beyond that floor:
// - the tally of a round and the decision of the next are one kernel, so a
//   tier round runs one K4 node, not two. The decision stays at the body's
//   start, in the same run of the body as the SWITCH that reads it: a turn
//   at the body's end would need the SWITCH's value to survive from one run
//   of the body to the next, which a handle reset at each run
//   (cudaGraphCondAssignDefault) does not promise;
// - a step runs as one warp. The lanes load the carry's head (32 slots,
//   256 bytes, a slot a lane) and the counts in one coalesced access into
//   shared memory; one lane runs the step on that copy, where each of its
//   twenty-odd reads costs shared memory's latency instead of a round trip
//   to L2 (a one-thread step on the carry in device memory interleaves its
//   reads with its writes, and the compiler, not knowing they do not alias,
//   issues them one after another), and sets the conditions; then the warp
//   stores the head back in one access. That lane stores the round log's
//   few values itself: a store does not stall it.
//
// The flight recorder's stamp (pprx_torch/trace.py) lives here too, beside the
// loop graph that places two of them: one thread reads %globaltimer (the
// card's nanosecond clock) and writes it with a tag id into the next slot of
// a ring of stamps, int64 [2 + 2 * slots]: the count of stamps ever written,
// the ring's slots, then (tag, ns) pairs, stamp i at slot i % slots. A call
// site launches it on its stream, so a capture records it as a kernel node;
// the loop graph adds one before its prologue and one after its WHILE. A
// second form writes one stamp into pinned host memory (stamp_slot).
//
// Plain C interface, loaded with ctypes (pprx_torch/engine/loop.py): every
// entry returns a cudaError_t, 0 on success, and allocates nothing on the
// card; a launch goes on the caller's stream.

#include <cuda_runtime.h>

#include <new>

#if CUDART_VERSION < 12080
#error "the loop graph's SWITCH node needs the CUDA 12.8 runtime or later"
#endif

namespace {

using i64 = long long;

// the carry's slots: loop.py's CN .. HEAD (a CPU test holds the two alike)
enum Slot : int {
  kCn = 0, kFed = 1, kFre = 2, kOk = 3, kNa = 4, kEw = 5,
  kRounds = 6, kMaxRounds = 7, kC0ok = 8,
  kPushes = 9, kEdgePushes = 10, kWlRounds = 11,
  kScansCand = 12, kScansFed = 13, kScansLiv = 14, kStatsReads = 15,
  kBranch = 16, kHeavy = 17, kStats = 18, kGo = 19,
  kExecs = 20, kPending = 30, kPend = 31,
  kHead = 32,
  // the hybrid rule's exact frontier rows and edges, in the stats-skip's slots
  kXn = 17, kXf = 18,
};

constexpr int kMaxTiers = 8;
constexpr int kMaxBranches = kMaxTiers + 2;
constexpr int kLogW = 8;  // branch, ok, cn, fed, fre, na, the heavy count, stats
constexpr int kLogCap = 1024;
constexpr i64 kBig = (1LL << 31) / 2 - 1;

// the counts' slot of the sharded rule's heavy test: loop.py's EWR; the
// proportional rule's pending carry takes it (loop.py's N_PEND)
constexpr int kEwr = 5;
constexpr int kMaxCounts = kEwr + 1;
// the hybrid rule's first list's validity on the device (loop.py's C0V)
constexpr int kC0v = kEwr;

// a step's lanes: one a slot of the carry's head
constexpr int kWarp = 32;
static_assert(kHead == kWarp, "a warp loads the carry's head, a slot a lane");

// the steps, as pprx_loop_step numbers them
constexpr int kPrime = 0, kTurn = 1, kAfterScan = 2;

// the rules a table's kRule names: loop.py's WL2, SHARDED, DENSE,
// PROPORTIONAL, HYBRID
enum Rule : int { kWl2 = 0, kSharded = 1, kDense = 2, kProportional = 3, kHybrid = 4 };

// the table of a tier ladder: loop.py's T_TIERS .. TAB
enum Tab : int {
  kTiers = 0, kHeavyEw = 1, kRule = 2,
  kW = 3, kE = kW + kMaxTiers, kG = kE + kMaxTiers, kEmit = kG + kMaxTiers,
  // the hybrid rule's scan tiers (rows, edges), their number, the overlay's
  // and the window's capacities
  kF = kEmit + kMaxTiers, kSE = kF + kMaxTiers, kScans = kSE + kMaxTiers, kOv = kScans + 1,
  kWin = kOv + 1,
  kTabLen = kWin + 1,
};

struct Table {
  i64 v[kTabLen];
};

// The conditions a step sets; `live` is 0 where a step runs outside a
// loop graph (K4 held to its plain steps), and then it sets none.
struct Handles {
  cudaGraphConditionalHandle loop, branch, stats;  // WHILE, SWITCH, IF
  int live;
};

__device__ __forceinline__ void set_cond(const Handles& h, cudaGraphConditionalHandle c,
                                         unsigned v) {
  if (h.live) cudaGraphSetConditional(c, v);
}

__device__ __forceinline__ i64* log_row(i64* log, i64 rnd) {
  return rnd < kLogCap ? log + rnd * kLogW : nullptr;
}

// the counts' slot the heavy test reads: ew, or ewr under the sharded rule
__device__ __forceinline__ int heavy_at(const Table& t) {
  return t.v[kRule] == kSharded ? kEwr : 4;
}

// the counts a step reads: the heavy count's slot and those below; under
// the proportional rule the pending carry's, under the hybrid rule the
// list's validity
__device__ __forceinline__ int n_counts(const Table& t) {
  return t.v[kRule] == kProportional || t.v[kRule] == kHybrid ? kEwr + 1 : heavy_at(t) + 1;
}

// the SWITCH's arms: the tiers and the scan (under the dense rule the round;
// under the proportional rule the tiers, the drain and the rescan; under
// the hybrid rule the tiers, the scan tiers, the dense scan and the count)
__host__ __device__ __forceinline__ int n_arms(const Table& t) {
  if (t.v[kRule] == kHybrid) return static_cast<int>(t.v[kTiers] + t.v[kScans]) + 2;
  return static_cast<int>(t.v[kTiers]) + 1 + (t.v[kRule] == kProportional);
}

// The steps, run by one lane on the shared copies of the carry's head `c`
// and the round's counts `n`; `log` is the carry's round log, in place.

__device__ void prime(i64* c, const i64* n, const Table& t, const Handles& h) {
  const i64 max_rounds = c[kMaxRounds], c0ok = c[kC0ok];
  for (int i = 0; i < kHead; ++i) c[i] = 0;
  c[kMaxRounds] = max_rounds;
  c[kC0ok] = c0ok;
  if (t.v[kRule] == kDense) {
    c[kNa] = n[3];  // the first active count: no round from a converged state
  } else if (t.v[kRule] == kHybrid) {
    // the list's counts and its validity on the device
    c[kCn] = n[0];
    c[kFed] = n[1];
    c[kFre] = n[2];
    c[kOk] = c0ok != 0 && n[kC0v] != 0;
    if (c[kOk]) {
      c[kNa] = c[kCn] > 0;
      c[kXn] = -1;
    } else if (c0ok == 0) {  // no list: the prologue counted the state
      c[kXn] = n[3];
      c[kXf] = n[4];
      c[kNa] = n[3];
    } else {  // a list that overflowed its buffer: a count first
      c[kNa] = 1;
      c[kXn] = -1;
    }
  } else if (t.v[kRule] == kProportional) {
    // the first round runs whatever the list; a carry the corrections
    // left is pending
    c[kCn] = n[0];
    c[kFed] = n[1];
    c[kFre] = n[2];
    c[kOk] = c0ok != 0;
    c[kPend] = n[kEwr];
    c[kNa] = 1;
  } else {
    c[kCn] = n[0];
    c[kFed] = n[1];
    c[kFre] = n[2];
    c[kOk] = c0ok != 0;
    // zero candidates in a valid list means zero active rows; the sharded
    // rule runs the first round whatever the list
    c[kNa] = c[kOk] && t.v[kRule] == kWl2 ? (c[kCn] > 0) : 1;
  }
  c[kGo] = c[kNa] > 0 && 0 < max_rounds;
  set_cond(h, h.loop, c[kGo]);
}

// the round's statistics and the next round's counts, from the round's
// (with a scan's stats where they ran)
// the hybrid rule's tally: a count's exact frontier (before any round from
// a list that is not valid, the prime's count), or a round's statistics and
// the next round's counts
__device__ void tally_hybrid(i64* c, const i64* n, i64* log, const Table& t) {
  const int k = static_cast<int>(t.v[kTiers]);
  const int count = n_arms(t) - 1;
  const i64 b = c[kBranch], na = n[3], ew = n[4];
  const i64 rnd = c[kRounds];
  c[kExecs + b] += 1;
  if (b == count) {
    c[kXn] = n[3];
    c[kXf] = n[4];
    if (rnd == 0 && !c[kOk]) {
      c[kNa] = n[3];
      c[kGo] = n[3] > 0;
    }
    return;
  }
  const i64 w_top = k ? t.v[kW + k - 1] : 0;
  if (b < k) {  // a tier that marked more rows than its own w cut its list
    const i64 cn2 = n[0] <= t.v[kEmit + b] ? n[0] : w_top + 1;
    c[kCn] = cn2;
    c[kFed] = n[1];
    c[kFre] = n[2];
    c[kOk] = cn2 <= w_top;
    c[kXn] = -1;
    c[kWlRounds] += 1;
  } else {
    if (k) {  // the reasons, on the counts that sent the round to a scan
      c[kScansCand] += !c[kOk] || c[kCn] > w_top;
      c[kScansFed] += c[kFed] > t.v[kE + k - 1];
      c[kScansLiv] += c[kFre] > t.v[kG + k - 1];
    }
    c[kCn] = n[0];
    c[kFed] = n[1];
    c[kFre] = n[2];
    c[kOk] = k > 0 && n[0] <= w_top;
    c[kXn] = n[0];
    c[kXf] = n[1];
  }
  if (i64* row = log_row(log, rnd)) row[5] = na;
  c[kRounds] = rnd + 1;
  c[kPushes] += na;
  c[kEdgePushes] += ew;
  c[kNa] = na;
  c[kEw] = ew;
  c[kGo] = na > 0 && c[kRounds] < c[kMaxRounds];
}

__device__ void tally(i64* c, const i64* n, i64* log, const Table& t) {
  const int k = static_cast<int>(t.v[kTiers]);
  const i64 b = c[kBranch], na = n[3], ew = n[4];
  const i64 rnd = c[kRounds];
  if (t.v[kRule] == kHybrid) {
    tally_hybrid(c, n, log, t);
    return;
  }
  if (t.v[kRule] == kProportional) {
    // a drain pushes nothing: its count is whether it left a list, and it
    // keeps the list's validity; the log keeps the pending carry that the
    // round's decision read
    const bool drain = b == k;
    const i64 pend = n[kEwr];
    const i64 work = (drain ? n[0] > 0 : na) + (pend > 0);
    if (i64* row = log_row(log, rnd)) {
      row[5] = na;
      row[6] = c[kPend];
      row[7] = 0;
    }
    c[kRounds] = rnd + 1;
    c[kPushes] += na;
    c[kEdgePushes] += ew;
    c[kWlRounds] += 1;
    c[kExecs + b] += 1;
    c[kCn] = n[0];
    c[kFed] = n[1];
    c[kFre] = n[2];
    c[kNa] = na;
    c[kEw] = ew;
    if (!drain) c[kOk] = 1;
    c[kPend] = pend;
    c[kGo] = work > 0 && c[kRounds] < c[kMaxRounds];
    return;
  }
  i64 cn2, fed2, fre2, ok2;
  if (t.v[kRule] == kDense) {  // no list: the counts stay as prime left them
    cn2 = c[kCn];
    fed2 = c[kFed];
    fre2 = c[kFre];
    ok2 = c[kOk];
  } else if (b < k) {
    cn2 = n[0];
    fed2 = n[1];
    fre2 = n[2];
    ok2 = cn2 <= t.v[kEmit + b];
  } else {
    if (c[kStats]) {
      cn2 = n[0];
      fed2 = n[1];
      fre2 = n[2];
      c[kStatsReads] += 1;
    } else {
      cn2 = fed2 = fre2 = 0;
    }
    ok2 = 1;
    if (c[kHeavy]) {  // the successor round is another scan
      cn2 = fed2 = fre2 = kBig;
      ok2 = 0;
    }
    c[kScansCand] += !c[kOk];
    c[kScansFed] += c[kFed] > t.v[kE + k - 1];
    c[kScansLiv] += c[kFre] > t.v[kG + k - 1];
  }
  if (i64* row = log_row(log, rnd)) {
    row[5] = na;
    row[6] = n[heavy_at(t)];
    row[7] = c[kStats];
  }
  c[kRounds] = rnd + 1;
  c[kPushes] += na;
  c[kEdgePushes] += ew;
  c[kWlRounds] += b < k;
  c[kExecs + b] += 1;
  c[kExecs + k + 1] += c[kStats];
  c[kCn] = cn2;
  c[kFed] = fed2;
  c[kFre] = fre2;
  c[kOk] = ok2;
  c[kNa] = na;
  c[kEw] = ew;
  c[kGo] = na > 0 && c[kRounds] < c[kMaxRounds];
}

// the round's branch, logged with the counts it read
__device__ int decide(i64* c, i64* log, const Table& t) {
  const int k = static_cast<int>(t.v[kTiers]);
  const i64 ok = c[kOk], cn = c[kCn], fed = c[kFed], fre = c[kFre];
  const bool prop = t.v[kRule] == kProportional;
  // the tier that holds the counts: the count of lower tiers they miss
  const auto tier = [&] {
    int i = 0;
    for (int j = 0; j < k - 1; ++j)
      i += !(cn <= t.v[kW + j] && fed <= t.v[kE + j] && fre <= t.v[kG + j]);
    return i;
  };
  int b;
  if (t.v[kRule] == kHybrid) {
    // a worklist tier where the list is valid and fits the top one; else a
    // scan, from the exact frontier: counted first where it is not known,
    // then the smallest scan tier that holds it where the sparse round is
    // worth it, else the dense scan
    const i64 xn = c[kXn], xf = c[kXf];
    const int ks = static_cast<int>(t.v[kScans]);
    if (k && ok && cn <= t.v[kW + k - 1] && fed <= t.v[kE + k - 1] && fre <= t.v[kG + k - 1]) {
      b = tier();
    } else if (xn < 0) {
      b = k + ks + 1;
    } else {
      int i = 0;
      for (int j = 0; j < ks; ++j) i += !(xn <= t.v[kF + j] && xf <= t.v[kSE + j]);
      const bool worth = (xf + t.v[kOv]) * 2 <= t.v[kWin];
      b = worth && i < ks ? k + i : k + ks;
    }
    c[kBranch] = b;
    if (i64* row = log_row(log, c[kRounds])) {
      row[0] = b;
      row[1] = ok;
      row[2] = cn;
      row[3] = fed;
      row[4] = fre;
      row[5] = 0;
      row[6] = xn;
      row[7] = xf;
    }
    return b;
  }
  if (prop)  // a pending carry drains, a valid list takes its tier (the top
             // one covers any frontier), an invalid one rescans
    b = c[kPend] > 0 ? k : ok ? tier() : k + 1;
  else if (t.v[kRule] != kDense && ok && cn <= t.v[kW + k - 1] && fed <= t.v[kE + k - 1] &&
           fre <= t.v[kG + k - 1])
    b = tier();
  else
    b = k;  // the scan; under the dense rule (k = 0) the round
  c[kBranch] = b;
  c[kHeavy] = 0;
  c[kStats] = 0;
  if (i64* row = log_row(log, c[kRounds])) {
    row[0] = b;
    row[1] = ok;
    row[2] = cn;
    row[3] = fed;
    row[4] = fre;
    row[5] = row[7] = 0;
    row[6] = prop ? c[kPend] : 0;
  }
  return b;
}

__device__ void turn(i64* c, const i64* n, i64* log, const Table& t, const Handles& h) {
  if (c[kPending]) tally(c, n, log, t);
  // where the loop ends, a value past the SWITCH's arms: it runs none
  const int arm = c[kGo] ? decide(c, log, t) : n_arms(t);
  c[kPending] = c[kGo];
  set_cond(h, h.branch, arm);
  set_cond(h, h.loop, c[kGo]);
}

__device__ void after_scan(i64* c, const i64* n, const Table& t, const Handles& h) {
  const int k = static_cast<int>(t.v[kTiers]);
  bool stats = false;
  if (c[kBranch] == k) {
    const i64 na = n[3];
    const bool heavy = n[heavy_at(t)] > t.v[kHeavyEw];
    stats = !heavy && na > 0 && c[kRounds] + 1 < c[kMaxRounds];
    c[kHeavy] = heavy;
  }
  c[kStats] = stats;
  set_cond(h, h.stats, stats);
}

// A step as one warp: the head and the counts into shared memory, a slot a
// lane, the step on lane 0, the head back.
template <int kStep>
__global__ void __launch_bounds__(kWarp)
    k4(i64* __restrict__ carry, const i64* __restrict__ counts, const Table t, const Handles h) {
  __shared__ i64 c[kHead];
  __shared__ i64 n[kMaxCounts];
  const int lane = threadIdx.x;
  c[lane] = carry[lane];
  if (lane < n_counts(t)) n[lane] = counts[lane];
  __syncwarp();
  if (lane == 0) {
    if constexpr (kStep == kPrime)
      prime(c, n, t, h);
    else if constexpr (kStep == kTurn)
      turn(c, n, carry + kHead, t, h);
    else
      after_scan(c, n, t, h);
  }
  __syncwarp();
  carry[lane] = c[lane];
}

using Kernel = void (*)(i64*, const i64*, Table, Handles);

// One stamp: the clock, then the slot. The ring's count takes an atomic add
// so that stamps from two streams never share a slot.
__global__ void __launch_bounds__(1) stamp(i64* __restrict__ ring, i64 tag) {
  i64 now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const auto i = atomicAdd(reinterpret_cast<unsigned long long*>(ring), 1ULL);
  i64* slot = ring + 2 + 2 * static_cast<i64>(i % static_cast<unsigned long long>(ring[1]));
  slot[0] = tag;
  slot[1] = now;
}

// One stamp into a slot of two int64 (tag, ns) in mapped host memory: the
// loop's last stamp, after the carry's copy, which the host reads as soon as
// the read's event has fired.
__global__ void __launch_bounds__(1) stamp_slot(i64* __restrict__ slot, i64 tag) {
  i64 now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  slot[0] = tag;
  slot[1] = now;
}

// a stamp as a kernel node of one thread after `dep` (none where it is null)
cudaError_t add_stamp(cudaGraphNode_t* node, cudaGraph_t g, const cudaGraphNode_t* dep, i64* ring,
                      i64 tag) {
  cudaKernelNodeParams p = {};
  void* args[] = {&ring, &tag};
  p.func = reinterpret_cast<void*>(stamp);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, g, dep, dep ? 1 : 0, &p);
}

Table table_of(const i64* tab) {
  Table t;
  for (int i = 0; i < kTabLen; ++i) t.v[i] = tab[i];
  return t;
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t g, const cudaGraphNode_t* dep,
                     cudaGraphNodeParams* p) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, g, dep, nullptr, dep ? 1 : 0, p);
#else
  return cudaGraphAddNode(node, g, dep, dep ? 1 : 0, p);
#endif
}

// a K4 step as a kernel node of one warp after `dep` (none where it is null)
cudaError_t add_step(cudaGraphNode_t* node, cudaGraph_t g, const cudaGraphNode_t* dep, Kernel fn,
                     i64* carry, const i64* counts, const Table& t, const Handles& h) {
  cudaKernelNodeParams p = {};
  void* args[] = {&carry, &counts, const_cast<Table*>(&t), const_cast<Handles*>(&h)};
  p.func = reinterpret_cast<void*>(fn);
  p.gridDim = dim3(1);
  p.blockDim = dim3(kWarp);
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, g, dep, dep ? 1 : 0, &p);
}

// a conditional node of `type` on `h` with `size` bodies after `dep`; the
// bodies' graphs in `bodies`
cudaError_t add_cond(cudaGraphNode_t* node, cudaGraph_t g, const cudaGraphNode_t* dep,
                     cudaGraphConditionalHandle h, int type, unsigned size,
                     cudaGraph_t* bodies) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = static_cast<decltype(p.conditional.type)>(type);
  p.conditional.size = size;
  const cudaError_t e = add_node(node, g, dep, &p);
  if (e == cudaSuccess)
    for (unsigned i = 0; i < size; ++i) bodies[i] = p.conditional.phGraph_out[i];
  return e;
}

struct Loop {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  ~Loop() {
    if (exec) cudaGraphExecDestroy(exec);
    if (graph) cudaGraphDestroy(graph);
  }
};

// `ring` gets a stamp of `tags[0]` before the prologue and one of `tags[1]`
// after the WHILE
cudaError_t build(Loop* L, cudaGraph_t prologue, cudaGraph_t const* branches, int n_branches,
                  i64* carry, const i64* counts, const Table& t, i64* ring, const i64* tags) {
  const int k = static_cast<int>(t.v[kTiers]);
  // the dense rule: no tiers, one arm (the round) and no stats; the
  // proportional rule: k + 2 arms (the tiers, the drain, the rescan) and no
  // stats; the hybrid rule: the tiers, the scan tiers, the dense scan and
  // the count, no stats
  const bool dense = t.v[kRule] == kDense, prop = t.v[kRule] == kProportional;
  const bool hybrid = t.v[kRule] == kHybrid;
  const int arms = n_arms(t);
  if (hybrid ? (k < 0 || k > kMaxTiers || t.v[kScans] < 1 || t.v[kScans] > kMaxTiers ||
                arms > kMaxBranches || n_branches != arms)
      : dense ? (k != 0 || n_branches != 1)
              : (k < 1 || k > kMaxTiers || n_branches != k + 2))
    return cudaErrorInvalidValue;
  int driver = 0;
  cudaError_t e = cudaDriverGetVersion(&driver);
  if (e != cudaSuccess) return e;
  if (driver < 12080) return cudaErrorNotSupported;  // no SWITCH node
  if ((e = cudaGraphCreate(&L->graph, 0))) return e;
  cudaGraphNode_t last, node, inner;
  if ((e = add_stamp(&last, L->graph, nullptr, ring, tags[0]))) return e;
  if (prologue) {
    if ((e = cudaGraphAddChildGraphNode(&node, L->graph, &last, 1, prologue))) return e;
    last = node;
  }
  Handles h = {};
  h.live = 1;
  // every condition is reset to 0 at each run of the graph that holds it;
  // prime sets the WHILE's before the loop, turn the SWITCH's and the
  // WHILE's in each run of the body, before the SWITCH, and after_scan the
  // stats IF's before that IF
  if ((e = cudaGraphConditionalHandleCreate(&h.loop, L->graph, 0, cudaGraphCondAssignDefault)))
    return e;
  if ((e = add_step(&node, L->graph, &last, k4<kPrime>, carry, counts, t, h))) return e;
  last = node;
  cudaGraph_t body, bodies[kMaxBranches], stats;
  if ((e = add_cond(&node, L->graph, &last, h.loop, cudaGraphCondTypeWhile, 1, &body)))
    return e;
  if ((e = add_stamp(&last, L->graph, &node, ring, tags[1]))) return e;
  // the SWITCH's handle belongs to the WHILE's body, the stats IF's to the
  // scan's arm: each to the graph that holds its node
  if ((e = cudaGraphConditionalHandleCreate(&h.branch, body, 0, cudaGraphCondAssignDefault)))
    return e;
  if ((e = add_step(&last, body, nullptr, k4<kTurn>, carry, counts, t, h))) return e;
  if ((e = add_cond(&node, body, &last, h.branch, cudaGraphCondTypeSwitch, arms, bodies)))
    return e;
  // the tiers, then the scan (the dense round; the drain and the rescan;
  // the scan tiers, the dense scan and the count)
  for (int i = 0; i < arms; ++i)
    if ((e = cudaGraphAddChildGraphNode(&inner, bodies[i], nullptr, 0, branches[i]))) return e;
  if (dense || prop || hybrid) return cudaGraphInstantiate(&L->exec, L->graph, 0);
  // the scan's arm goes on: after_scan, then the stats under an IF
  if ((e = cudaGraphConditionalHandleCreate(&h.stats, bodies[k], 0, cudaGraphCondAssignDefault)))
    return e;
  cudaGraphNode_t after;
  if ((e = add_step(&after, bodies[k], &inner, k4<kAfterScan>, carry, counts, t, h))) return e;
  if ((e = add_cond(&node, bodies[k], &after, h.stats, cudaGraphCondTypeIf, 1, &stats))) return e;
  if ((e = cudaGraphAddChildGraphNode(&inner, stats, nullptr, 0, branches[k + 1]))) return e;
  return cudaGraphInstantiate(&L->exec, L->graph, 0);
}

}  // namespace

extern "C" {

// One step (0 prime, 1 turn, 2 after_scan) on `carry` with no graph around
// it: it writes the carry and sets no condition. `tab` is the
// table on the host (kTabLen values).
int pprx_loop_step(int which, i64* carry, const i64* counts, const i64* tab, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Table t = table_of(tab);
  switch (which) {
    case kPrime: k4<kPrime><<<1, kWarp, 0, s>>>(carry, counts, t, Handles{}); break;
    case kTurn: k4<kTurn><<<1, kWarp, 0, s>>>(carry, counts, t, Handles{}); break;
    case kAfterScan: k4<kAfterScan><<<1, kWarp, 0, s>>>(carry, counts, t, Handles{}); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Build and instantiate a loop graph: `prologue` (a cudaGraph_t or null),
// `branches` the k tiers', the scan's and the stats' cudaGraph_t (k + 2;
// under the dense rule the round's alone; under the proportional rule the k
// tiers', the drain's and the rescan's; under the hybrid rule the k tiers',
// the ks scan tiers', the dense scan's and the count's), each cloned into the
// graph;
// `carry` and `counts` device pointers, `tab` the table on the host;
// `ring` a ring of stamps on the card and `tags` the head's and the end's
// tag ids on the host.
// `*out` gets the loop's handle for pprx_loop_launch and pprx_loop_free.
int pprx_loop_build(void* prologue, void* const* branches, int n_branches, i64* carry,
                    const i64* counts, const i64* tab, i64* ring, const i64* tags, void** out) {
  Loop* L = new (std::nothrow) Loop;
  if (L == nullptr) return cudaErrorMemoryAllocation;
  const cudaError_t e = build(L, static_cast<cudaGraph_t>(prologue),
                              reinterpret_cast<cudaGraph_t const*>(branches), n_branches, carry,
                              counts, table_of(tab), ring, tags);
  if (e != cudaSuccess) {
    delete L;
    return e;
  }
  *out = L;
  return cudaSuccess;
}

// One stamp into `ring` on `stream` (the recorder's eager stamps, and
// every stamp a capture records).
int pprx_stamp(i64* ring, i64 tag, void* stream) {
  stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(ring, tag);
  return cudaGetLastError();
}

// One stamp into `host`, two int64 of pinned host memory, on `stream`.
int pprx_stamp_host(void* host, i64 tag, void* stream) {
  void* dev = nullptr;
  const cudaError_t e = cudaHostGetDevicePointer(&dev, host, 0);
  if (e != cudaSuccess) return e;
  stamp_slot<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<i64*>(dev), tag);
  return cudaGetLastError();
}

int pprx_loop_launch(void* loop, void* stream) {
  const cudaError_t e =
      cudaGraphLaunch(static_cast<Loop*>(loop)->exec, static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? e : cudaGetLastError();
}

int pprx_loop_free(void* loop) {
  delete static_cast<Loop*>(loop);
  return cudaSuccess;
}

// The driver's and the runtime's CUDA versions (e.g. 12090 for 12.9).
int pprx_loop_versions(int* out) {
  const cudaError_t e = cudaDriverGetVersion(&out[0]);
  return e != cudaSuccess ? e : cudaRuntimeGetVersion(&out[1]);
}

}  // extern "C"
