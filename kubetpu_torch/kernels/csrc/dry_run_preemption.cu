// dry_run_preemption: the preemption victim search over every node at once,
// then the choice of one node (kernel B9).
//
// Replaces kubetpu/ops/preemption.py:186 dry_run_preemption (jit): :63
// select_victims_node vmapped over the node axis (eligibility by priority,
// fit with every eligible victim removed, a PDB-violation scan in
// importance order, then a reprieve scan), gated by the caller's potential
// mask, and :156 pick_node, the lexicographic refinement of
// pickOneNodeForPreemption. The plain PyTorch version is
// kubetpu_torch/ops/preemption.py dry_run_preemption_plain.
//
// Bound: memory. Each input byte is read once in principle: the (N, K)
// victim slots with their (N, K, R) requests, (N, K, Kp) ports and (N, K, D)
// PDB flags, the node rows, and the (N, K) victims written back; the
// arithmetic per slot is a handful of integer compares. At the main path's
// shapes (N = 5120, K = 8) that is about 2 MB, under a microsecond at the
// card's bandwidth, so the kernel is launch-latency bound in practice.
//
// Design (simple first): launch 1 runs one thread per node. The thread
// keeps its node's running state (requests, port counts, the PDB budgets,
// its slot order and violation flags) in global scratch laid out
// (column, node), so neighbouring threads touch neighbouring words; the
// scratch is sized from R, Kp, K and D as given, so no size is capped. The
// two sorts of select_victims_node are insertion sorts with a strict
// comparison, which keep equal keys in slot order as the reference's stable
// lax.sort does. The stats pick_node reads go to an (4, N) scratch. Launch 2
// is one block that reduces over nodes the key (-n_pdb, -max_prio,
// -sum_prio, -n_victims, earliest_start, -index): its maximum is
// pick_node's refinement followed by its first candidate, and -1 stands for
// no node when no node is ok.
#include <cstdint>
#include <cuda_runtime.h>

// Mirror of DryRunArgs in kubetpu_torch/kernels/__init__.py: every field is
// 8 bytes wide.
struct DryRunArgs {
  const int64_t* pod_req;      // (R,) the preemptor's requests
  const uint8_t* wants_conf;   // (Kp,) triples the preemptor conflicts with
  const uint8_t* potential;    // (N,) nodes whose failure is resolvable
  const int64_t* alloc;        // (N, R)
  const int64_t* requested;    // (N, R)
  const int32_t* pod_count;    // (N,)
  const int32_t* allowed;      // (N,)
  const int32_t* port_counts;  // (N, Kp)
  const uint8_t* v_valid;      // (N, K)
  const int64_t* v_prio;       // (N, K)
  const int64_t* v_start;      // (N, K)
  const int64_t* v_req;        // (N, K, R)
  const int8_t* v_ports;       // (N, K, Kp)
  const uint8_t* v_pdb;        // (N, K, D)
  const int64_t* pdb_allowed;  // (D,)
  int32_t* node_idx;           // () the chosen node, -1 = none
  uint8_t* victims;            // (N, K)
  uint8_t* ok;                 // (N,)
  int64_t* n_pdb;              // (N,)
  int64_t* stats;              // (4, N) scratch: max_prio, sum_prio, n_victims, earliest
  int32_t* order;              // (K, N) scratch: slot order
  uint8_t* violating;          // (K, N) scratch
  int64_t* budget;             // (D, N) scratch: each node's copy of the PDB budgets
  int64_t* req_s;              // (R, N) scratch: running requests
  int32_t* ports_s;            // (Kp, N) scratch: running port counts
  int64_t pod_prio, N, K, R, Kp, D;
};

namespace {

constexpr int kNodeThreads = 128;
constexpr int kPickThreads = 1024;
constexpr int64_t kI64Min = -(1LL << 62);  // the reference's I64_MIN
constexpr int64_t kI64Max = 1LL << 62;     // I64_MAX
constexpr int64_t kPrioOffset = 1LL << 31; // PRIO_OFFSET

struct Node {
  const DryRunArgs& a;
  int64_t n;

  __device__ bool eligible(int64_t k) const {
    const int64_t i = n * a.K + k;
    return a.v_valid[i] && a.v_prio[i] < a.pod_prio;
  }
  __device__ int64_t imp_key(int64_t k) const {
    return eligible(k) ? -a.v_prio[n * a.K + k] : kI64Max;
  }
  __device__ int64_t start(int64_t k) const { return a.v_start[n * a.K + k]; }

  // _fits against the running state, with slot `k` added back (k < 0: none)
  __device__ bool fits(int64_t cnt, int64_t k) const {
    const int64_t N = a.N, R = a.R, Kp = a.Kp;
    for (int64_t r = 0; r < R; ++r) {
      const int64_t q = a.pod_req[r];
      const int64_t used = a.req_s[r * N + n] + (k >= 0 ? a.v_req[(n * a.K + k) * R + r] : 0);
      if (q != 0 && q > a.alloc[n * R + r] - used) return false;
    }
    if (!(cnt + (k >= 0 ? 1 : 0) + 1 <= (int64_t)a.allowed[n])) return false;
    for (int64_t l = 0; l < Kp; ++l) {
      if (!a.wants_conf[l]) continue;
      const int32_t c =
          a.ports_s[l * N + n] + (k >= 0 ? (int32_t)a.v_ports[(n * a.K + k) * Kp + l] : 0);
      if (c > 0) return false;
    }
    return true;
  }

  // insertion sort of the slots by `greater` (strict: equal keys keep slot
  // order, as a stable sort)
  template <typename Greater>
  __device__ void sort_slots(Greater greater) const {
    const int64_t N = a.N, K = a.K;
    for (int64_t i = 0; i < K; ++i) a.order[i * N + n] = (int32_t)i;
    for (int64_t i = 1; i < K; ++i) {
      const int32_t x = a.order[i * N + n];
      int64_t j = i - 1;
      while (j >= 0 && greater(a.order[j * N + n], x)) {
        a.order[(j + 1) * N + n] = a.order[j * N + n];
        --j;
      }
      a.order[(j + 1) * N + n] = x;
    }
  }
};

__global__ void __launch_bounds__(kNodeThreads)
dry_run_nodes(DryRunArgs a) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t N = a.N, K = a.K, R = a.R, Kp = a.Kp, D = a.D;
  if (n >= N) return;
  const Node node{a, n};

  // state with every eligible victim removed
  bool has_eligible = false;
  int64_t n_elig = 0;
  for (int64_t r = 0; r < R; ++r) a.req_s[r * N + n] = a.requested[n * R + r];
  for (int64_t l = 0; l < Kp; ++l) a.ports_s[l * N + n] = a.port_counts[n * Kp + l];
  for (int64_t k = 0; k < K; ++k) {
    a.victims[n * K + k] = 0;
    if (!node.eligible(k)) continue;
    has_eligible = true;
    ++n_elig;
    for (int64_t r = 0; r < R; ++r) a.req_s[r * N + n] -= a.v_req[(n * K + k) * R + r];
    for (int64_t l = 0; l < Kp; ++l) a.ports_s[l * N + n] -= a.v_ports[(n * K + k) * Kp + l];
  }
  int64_t cnt = (int64_t)a.pod_count[n] - n_elig;
  const bool fits_base = node.fits(cnt, -1);

  // importance order: priority desc, start asc; ineligible slots last
  node.sort_slots([&](int32_t x, int32_t y) {
    const int64_t kx = node.imp_key(x), ky = node.imp_key(y);
    return kx > ky || (kx == ky && node.start(x) > node.start(y));
  });

  // PDB violation flags, walking importance order
  for (int64_t d = 0; d < D; ++d) a.budget[d * N + n] = a.pdb_allowed[d];
  for (int64_t i = 0; i < K; ++i) {
    const int32_t k = a.order[i * N + n];
    bool viol = false;
    if (node.eligible(k)) {
      for (int64_t d = 0; d < D; ++d) {
        if (!a.v_pdb[(n * K + k) * D + d]) continue;
        a.budget[d * N + n] -= 1;
        if (a.budget[d * N + n] < 0) viol = true;
      }
    }
    a.violating[(int64_t)k * N + n] = viol;
  }

  // reprieve order: violating group first, then importance within group
  auto grp = [&](int32_t k) -> int64_t {
    if (!node.eligible(k)) return 2;
    return a.violating[(int64_t)k * N + n] ? 0 : 1;
  };
  node.sort_slots([&](int32_t x, int32_t y) {
    const int64_t gx = grp(x), gy = grp(y);
    if (gx != gy) return gx > gy;
    const int64_t kx = node.imp_key(x), ky = node.imp_key(y);
    return kx > ky || (kx == ky && node.start(x) > node.start(y));
  });

  // reprieve: a victim stays on the node iff the preemptor still fits
  int64_t n_viol = 0, n_victims = 0;
  for (int64_t i = 0; i < K; ++i) {
    const int32_t k = a.order[i * N + n];
    if (!node.eligible(k)) continue;  // never a victim, never reprieved
    if (node.fits(cnt, k)) {
      for (int64_t r = 0; r < R; ++r) a.req_s[r * N + n] += a.v_req[(n * K + k) * R + r];
      cnt += 1;
      for (int64_t l = 0; l < Kp; ++l) a.ports_s[l * N + n] += a.v_ports[(n * K + k) * Kp + l];
    } else {
      a.victims[n * K + k] = 1;
      ++n_victims;
      if (a.violating[(int64_t)k * N + n]) ++n_viol;
    }
  }

  int64_t max_prio = kI64Min, sum_prio = 0;
  for (int64_t k = 0; k < K; ++k) {
    if (!a.victims[n * K + k]) continue;
    const int64_t pr = a.v_prio[n * K + k];
    max_prio = pr > max_prio ? pr : max_prio;
    sum_prio += pr + kPrioOffset;
  }
  int64_t earliest = kI64Max;
  for (int64_t k = 0; k < K; ++k) {
    if (!a.victims[n * K + k] || a.v_prio[n * K + k] != max_prio) continue;
    const int64_t s = node.start(k);
    earliest = s < earliest ? s : earliest;
  }
  a.ok[n] = has_eligible && fits_base && n_victims > 0 && a.potential[n];
  a.n_pdb[n] = n_viol;
  a.stats[0 * N + n] = max_prio;
  a.stats[1 * N + n] = sum_prio;
  a.stats[2 * N + n] = n_victims;
  a.stats[3 * N + n] = earliest;
}

// a candidate node for pick_node; idx < 0 = none
struct Cand {
  int64_t pdb, maxp, sump, nv, early, idx;
};

// x better than y: fewer PDB violations, lower highest priority, lower sum,
// fewer victims, later earliest start, lower index
__device__ __forceinline__ bool better(const Cand& x, const Cand& y) {
  if (x.idx < 0) return false;
  if (y.idx < 0) return true;
  if (x.pdb != y.pdb) return x.pdb < y.pdb;
  if (x.maxp != y.maxp) return x.maxp < y.maxp;
  if (x.sump != y.sump) return x.sump < y.sump;
  if (x.nv != y.nv) return x.nv < y.nv;
  if (x.early != y.early) return x.early > y.early;
  return x.idx < y.idx;
}

__device__ __forceinline__ Cand shfl_down(const Cand& c, int off) {
  return Cand{__shfl_down_sync(0xffffffffu, c.pdb, off),
              __shfl_down_sync(0xffffffffu, c.maxp, off),
              __shfl_down_sync(0xffffffffu, c.sump, off),
              __shfl_down_sync(0xffffffffu, c.nv, off),
              __shfl_down_sync(0xffffffffu, c.early, off),
              __shfl_down_sync(0xffffffffu, c.idx, off)};
}

__device__ __forceinline__ Cand warp_best(Cand c) {
  for (int off = 16; off > 0; off >>= 1) {
    const Cand o = shfl_down(c, off);
    if (better(o, c)) c = o;
  }
  return c;
}

__global__ void __launch_bounds__(kPickThreads, 1)
dry_run_pick(DryRunArgs a) {
  __shared__ Cand s[kPickThreads / 32];
  const int64_t N = a.N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Cand best{0, 0, 0, 0, 0, -1};
  for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
    if (!a.ok[n]) continue;
    const Cand c{a.n_pdb[n], a.stats[n], a.stats[N + n], a.stats[2 * N + n],
                 a.stats[3 * N + n], n};
    if (better(c, best)) best = c;
  }
  best = warp_best(best);
  if (lane == 0) s[warp] = best;
  __syncthreads();
  if (warp == 0) {
    Cand c = lane < (int)(blockDim.x >> 5) ? s[lane] : Cand{0, 0, 0, 0, 0, -1};
    c = warp_best(c);
    if (lane == 0) *a.node_idx = (int32_t)c.idx;
  }
}

// One shard's dry run, for the cross-shard pick (mirror of PickShard in
// kubetpu_torch/kernels/__init__.py; 8-byte fields)
struct PickShard {
  const int32_t* node_idx;  // () the shard's first best node, local, -1 = none
  const int64_t* n_pdb;     // (N,)
  const int64_t* stats;     // (4, N): max_prio, sum_prio, n_victims, earliest
  int64_t N;
  int64_t offset;           // global index of the shard's first node
};

// Kernel K3 (the dry run under a node mesh): one warp, lane h reads shard
// h's best node and its five keys (through peer pointers for other cards)
// and the warp keeps the best by pick_node's order with -global index, so
// the first node of the global refinement wins.
struct PickSet {
  PickShard sh[8];
};

__global__ void dry_run_shard_pick(const __grid_constant__ PickSet set, int64_t G, int32_t* out) {
  const int lane = threadIdx.x;
  Cand c{0, 0, 0, 0, 0, -1};
  if (lane < G) {
    const PickShard& s = set.sh[lane];
    const int64_t n = *(const volatile int32_t*)s.node_idx;
    if (n >= 0) {
      const volatile int64_t* st = s.stats;
      c = Cand{((const volatile int64_t*)s.n_pdb)[n], st[n], st[s.N + n], st[2 * s.N + n],
               st[3 * s.N + n], s.offset + n};
    }
  }
  c = warp_best(c);
  if (lane == 0) *out = (int32_t)c.idx;
}

}  // namespace

// Launches kernel K3 on `stream` over the G (<= 8) entries of `shards`
// (host memory); every shard's dry run must be complete (the caller orders
// the streams). *out receives the global node, -1 for none. Returns the
// cudaError_t of the launch.
extern "C" int kt_dry_run_shard_pick(const void* shards, int64_t G, void* out, void* stream) {
  if (G <= 0 || G > 8) return (int)cudaErrorInvalidValue;
  PickSet set{};
  const PickShard* in = static_cast<const PickShard*>(shards);
  for (int64_t g = 0; g < G; ++g) set.sh[g] = in[g];
  dry_run_shard_pick<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      set, G, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_dry_run_preemption_pick_size() { return (int64_t)sizeof(PickShard); }

// Launches the per-node search and the pick on `stream`. Every output and
// scratch buffer is written whole by the kernels. Returns the cudaError_t of
// the launches (0 = both were accepted).
extern "C" int kt_dry_run_preemption(const DryRunArgs* args, void* stream) {
  const DryRunArgs a = *args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.N > 0) {
    dry_run_nodes<<<(unsigned)((a.N + kNodeThreads - 1) / kNodeThreads), kNodeThreads, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dry_run_pick<<<1, kPickThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_dry_run_preemption_args_size() { return (int64_t)sizeof(DryRunArgs); }

extern "C" const char* kt_dry_run_preemption_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
