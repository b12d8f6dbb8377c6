// K4: the compact-frontier convergence loops' control on the card (sm_90a),
// the wl2 engine's and the sharded wl engine's in a world of one shard, and
// the CUDA graph that runs a whole loop:
//
//   [prologue] -> prime -> WHILE { decide -> SWITCH { tier_0 | ... | tier_k-1
//                                    | scan -> after_scan -> IF { stats } }
//                                  -> tally }
//
// Each body of the SWITCH holds a child graph, a clone of the branch that
// the port captured with torch (a compact tier, the scan round), and the
// scan's body also its stats under an IF; the prologue (a slide's, or a
// seed's first count) is a child graph likewise. The four control
// steps are one-thread kernels on the loop's carry, a small int64 array:
//   prime       the loop's start from the first list's counts;
//   decide      the round's branch: a compact tier (the count of lower tiers
//               whose capacities the counts miss) or the scan; logs the
//               counts it read;
//   after_scan  whether a scan's next-frontier stats run (not after a heavy
//               scan, nor where no round follows);
//   tally       the round's statistics, the next round's counts, the
//               branch's execution count, and whether the loop goes on.
// The table's rule field picks the sharded engine's loop: its first round
// always runs, and its heavy test reads ewr, the counts' sixth slot, where
// wl2's reads the edge work ew (pprx/dist/wl.py:911-917, 1023).
// Each does what its plain step in pprx_torch/engine/loop.py does, on the
// same slots, and sets the graph's conditions with cudaGraphSetConditional:
// prime and tally the WHILE's, decide the SWITCH's (the branch's number),
// after_scan the stats IF's. A SWITCH node (CUDA 12.8) takes one node's
// evaluation a round where a chain of IF nodes, one a branch, takes k + 1:
// on the card each conditional node costs a few microseconds of the round.
//
// No Pallas kernel is replaced. K4 is the counterpart of the reference's
// on-device control flow, the lax.while_loop at pprx/engine/wl2.py:687
// with its lax.switch over the tiers (:617) and lax.cond over worklist or
// scan (:657) and over a scan's stats (:662), and of the sharded engine's
// at pprx/dist/wl.py:1025 with its lax.switch over the tiers and the
// dense round (:995) and lax.cond over the dense round's stats (:954). Its
// bound is the launch floor: a step reads and writes a few hundred bytes;
// what the design saves is the host's read of the counts and the next
// launch each round, which the whole loop in one graph replaces by one
// launch and one read.
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
  kExecs = 20,
  kHead = 32,
};

constexpr int kMaxTiers = 8;
constexpr int kLogW = 8;  // branch, ok, cn, fed, fre, na, the heavy count, stats
constexpr int kLogCap = 1024;
constexpr i64 kBig = (1LL << 31) / 2 - 1;

// the counts' slot of the sharded rule's heavy test: loop.py's EWR
constexpr int kEwr = 5;

// the table of a tier ladder: loop.py's T_TIERS .. TAB
enum Tab : int {
  kTiers = 0, kHeavyEw = 1, kRule = 2,
  kW = 3, kE = kW + kMaxTiers, kG = kE + kMaxTiers, kEmit = kG + kMaxTiers,
  kTabLen = kEmit + kMaxTiers,
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

__device__ __forceinline__ i64* log_row(i64* c, i64 rnd) {
  return rnd < kLogCap ? c + kHead + rnd * kLogW : nullptr;
}

// the counts' slot the heavy test reads: ew, or ewr under the sharded rule
__device__ __forceinline__ int heavy_at(const Table& t) { return t.v[kRule] ? kEwr : 4; }

__global__ void k4_prime(i64* c, const i64* counts, Table t, Handles h) {
  const i64 max_rounds = c[kMaxRounds], c0ok = c[kC0ok];
  for (int i = 0; i < kHead; ++i) c[i] = 0;
  c[kMaxRounds] = max_rounds;
  c[kC0ok] = c0ok;
  c[kCn] = counts[0];
  c[kFed] = counts[1];
  c[kFre] = counts[2];
  c[kOk] = c0ok != 0;
  // zero candidates in a valid list means zero active rows; the sharded
  // rule runs the first round whatever the list
  c[kNa] = c[kOk] && !t.v[kRule] ? (c[kCn] > 0) : 1;
  c[kGo] = c[kNa] > 0 && 0 < max_rounds;
  set_cond(h, h.loop, c[kGo]);
}

__global__ void k4_decide(i64* c, const i64*, Table t, Handles h) {
  const int k = static_cast<int>(t.v[kTiers]);
  const i64 ok = c[kOk], cn = c[kCn], fed = c[kFed], fre = c[kFre];
  int b = k;  // the scan
  if (ok && cn <= t.v[kW + k - 1] && fed <= t.v[kE + k - 1] && fre <= t.v[kG + k - 1]) {
    b = 0;
    for (int i = 0; i < k - 1; ++i)
      b += !(cn <= t.v[kW + i] && fed <= t.v[kE + i] && fre <= t.v[kG + i]);
  }
  c[kBranch] = b;
  c[kHeavy] = 0;
  c[kStats] = 0;
  if (i64* row = log_row(c, c[kRounds])) {
    row[0] = b;
    row[1] = ok;
    row[2] = cn;
    row[3] = fed;
    row[4] = fre;
    row[5] = row[6] = row[7] = 0;
  }
  set_cond(h, h.branch, b);
}

__global__ void k4_after_scan(i64* c, const i64* counts, Table t, Handles h) {
  const int k = static_cast<int>(t.v[kTiers]);
  bool stats = false;
  if (c[kBranch] == k) {
    const i64 na = counts[3];
    const bool heavy = counts[heavy_at(t)] > t.v[kHeavyEw];
    stats = !heavy && na > 0 && c[kRounds] + 1 < c[kMaxRounds];
    c[kHeavy] = heavy;
  }
  c[kStats] = stats;
  set_cond(h, h.stats, stats);
}

__global__ void k4_tally(i64* c, const i64* counts, Table t, Handles h) {
  const int k = static_cast<int>(t.v[kTiers]);
  const i64 b = c[kBranch], na = counts[3], ew = counts[4];
  i64 cn2, fed2, fre2, ok2;
  if (b < k) {
    cn2 = counts[0];
    fed2 = counts[1];
    fre2 = counts[2];
    ok2 = cn2 <= t.v[kEmit + b];
  } else {
    if (c[kStats]) {
      cn2 = counts[0];
      fed2 = counts[1];
      fre2 = counts[2];
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
  const i64 rnd = c[kRounds];
  if (i64* row = log_row(c, rnd)) {
    row[5] = na;
    row[6] = counts[heavy_at(t)];
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
  set_cond(h, h.loop, c[kGo]);
}

using Step = void (*)(i64*, const i64*, Table, Handles);

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

// a K4 step as a kernel node after `dep` (none where it is null)
cudaError_t add_step(cudaGraphNode_t* node, cudaGraph_t g, const cudaGraphNode_t* dep, Step fn,
                     i64* carry, const i64* counts, const Table& t, const Handles& h) {
  cudaKernelNodeParams p = {};
  void* args[] = {&carry, &counts, const_cast<Table*>(&t), const_cast<Handles*>(&h)};
  p.func = reinterpret_cast<void*>(fn);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
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

cudaError_t build(Loop* L, cudaGraph_t prologue, cudaGraph_t const* branches, int n_branches,
                  i64* carry, const i64* counts, const Table& t) {
  const int k = static_cast<int>(t.v[kTiers]);
  if (k < 1 || k > kMaxTiers || n_branches != k + 2) return cudaErrorInvalidValue;
  int driver = 0;
  cudaError_t e = cudaDriverGetVersion(&driver);
  if (e != cudaSuccess) return e;
  if (driver < 12080) return cudaErrorNotSupported;  // no SWITCH node
  if ((e = cudaGraphCreate(&L->graph, 0))) return e;
  cudaGraphNode_t last = nullptr, node, inner;
  if (prologue && (e = cudaGraphAddChildGraphNode(&last, L->graph, nullptr, 0, prologue)))
    return e;
  Handles h = {};
  h.live = 1;
  // every condition is reset to 0 at each launch; prime sets the WHILE's
  // before the loop, and decide and after_scan set theirs before their nodes
  if ((e = cudaGraphConditionalHandleCreate(&h.loop, L->graph, 0, cudaGraphCondAssignDefault)))
    return e;
  if ((e = add_step(&node, L->graph, last ? &last : nullptr, k4_prime, carry, counts, t, h)))
    return e;
  last = node;
  cudaGraph_t body, arms[kMaxTiers + 1], stats;
  if ((e = add_cond(&node, L->graph, &last, h.loop, cudaGraphCondTypeWhile, 1, &body)))
    return e;
  // the SWITCH's handle belongs to the WHILE's body, the stats IF's to the
  // scan's arm: each to the graph that holds its node
  if ((e = cudaGraphConditionalHandleCreate(&h.branch, body, 0, cudaGraphCondAssignDefault)))
    return e;
  if ((e = add_step(&last, body, nullptr, k4_decide, carry, counts, t, h))) return e;
  if ((e = add_cond(&node, body, &last, h.branch, cudaGraphCondTypeSwitch, k + 1, arms)))
    return e;
  last = node;
  for (int i = 0; i <= k; ++i)  // the tiers, then the scan
    if ((e = cudaGraphAddChildGraphNode(&inner, arms[i], nullptr, 0, branches[i]))) return e;
  // the scan's arm goes on: after_scan, then the stats under an IF
  if ((e = cudaGraphConditionalHandleCreate(&h.stats, arms[k], 0, cudaGraphCondAssignDefault)))
    return e;
  cudaGraphNode_t after;
  if ((e = add_step(&after, arms[k], &inner, k4_after_scan, carry, counts, t, h))) return e;
  if ((e = add_cond(&node, arms[k], &after, h.stats, cudaGraphCondTypeIf, 1, &stats))) return e;
  if ((e = cudaGraphAddChildGraphNode(&inner, stats, nullptr, 0, branches[k + 1]))) return e;
  if ((e = add_step(&node, body, &last, k4_tally, carry, counts, t, h))) return e;
  return cudaGraphInstantiate(&L->exec, L->graph, 0);
}

}  // namespace

extern "C" {

// One step (0 prime, 1 decide, 2 after_scan, 3 tally) on `carry` with no
// graph around it: it writes the carry and sets no condition. `tab` is the
// table on the host (kTabLen values).
int pprx_loop_step(int which, i64* carry, const i64* counts, const i64* tab, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Table t = table_of(tab);
  switch (which) {
    case 0: k4_prime<<<1, 1, 0, s>>>(carry, counts, t, Handles{}); break;
    case 1: k4_decide<<<1, 1, 0, s>>>(carry, counts, t, Handles{}); break;
    case 2: k4_after_scan<<<1, 1, 0, s>>>(carry, counts, t, Handles{}); break;
    case 3: k4_tally<<<1, 1, 0, s>>>(carry, counts, t, Handles{}); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Build and instantiate a loop graph: `prologue` (a cudaGraph_t or null),
// `branches` the k tiers', the scan's and the stats' cudaGraph_t (k + 2),
// each cloned into the graph; `carry` and `counts` device pointers, `tab`
// the table on the host. `*out` gets the loop's handle for
// pprx_loop_launch and pprx_loop_free.
int pprx_loop_build(void* prologue, void* const* branches, int n_branches, i64* carry,
                    const i64* counts, const i64* tab, void** out) {
  Loop* L = new (std::nothrow) Loop;
  if (L == nullptr) return cudaErrorMemoryAllocation;
  const cudaError_t e = build(L, static_cast<cudaGraph_t>(prologue),
                              reinterpret_cast<cudaGraph_t const*>(branches), n_branches, carry,
                              counts, table_of(tab));
  if (e != cudaSuccess) {
    delete L;
    return e;
  }
  *out = L;
  return cudaSuccess;
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
