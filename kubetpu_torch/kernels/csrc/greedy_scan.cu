// greedy_scan: the greedy assignment of a batch, pods one at a time against
// the running node state, on the device.
//
// Replaces kubetpu/assign/greedy.py:107 greedy_assign_device (jit): a
// lax.scan over the pods whose every step re-runs the Filter+Score
// composition for one pod against the carried state, takes the FIRST
// max-score feasible node (greedy.py:17-20) and applies a one-hot update.
// XLA ran the scan as one program; eager PyTorch would pay ~40 launches a
// step, so the loop over pods lives here, inside one launch.
//
// Bound: latency. The work that needs the whole card, every (pod, node)
// pair's filter verdict and base score, is done before the scan by
// filter_score over all SMs; the scan is P sequential steps. Design: ONE
// persistent block of 1024 threads. Thread t owns nodes t, t+1024, ...: it
// alone reads and writes those nodes' running requested / nonzero /
// pod_count / node_ports rows and their `touched` flag (global memory), so
// the state needs no atomics and no fences. A node no earlier pod of the
// batch landed on still has the batch's starting state, so its verdict and
// base score for pod p are exactly filter_score's mask0[p, n] and
// base0[p, n]; only touched nodes are recomputed (score_common.cuh). The
// extender webhook's mask and score depend on the pod and node alone, so
// mask0 and base0 carry them for untouched nodes, and pair_feasible and
// base_score apply them when a touched node is recomputed.
//
// InterPodAffinity breaks that reuse rule: one assignment adds to the
// carried (RA, D) sums at a whole topology domain, which moves the affinity
// verdict and score of every node in that domain (on a one-zone cluster,
// every node). So filter_score's mask0 leaves the affinity filter out, and
// each step evaluates the affinity filter and raw score of every node
// afresh from the running sums (O(slots) gathers a node); only the
// resource terms of untouched nodes are reused. The sums and their per-row
// totals (for the self-affinity escape) live in global memory, written by
// one thread per row after each step's argmax and read by all threads
// after a block barrier.
//
// PodTopologySpread breaks it the same way: one assignment adds one match
// to a whole domain, which moves the skew verdict of every node in it and
// the global minMatch every verdict reads, and the score's `size` (domains
// holding a scored node) moves with each step's feasible set. So the
// start mask leaves the spread filter out too, and with a spread leaf the
// scan carries the (S, N) counts (the final state's slot 4) and their
// (S, D+1) domain sums in global memory: after each argmax one thread per
// signature adds the pod's match at the chosen node to both, and before
// each step the block reduces every signature's minMatch afresh (hard
// constraints only). Each step then stores every node's verdict in an
// (N,) scratch row, derives each soft slot's size from it (a domain
// bitmap, popcounts, a block sum), and folds the rounded spread raw's min
// and max into the normalize reduction.
//
// Per step: (1) when node-affinity, taint or affinity-score rows are
// present, the block reduces the normalize inputs over the feasible nodes
// (masked_normalize divides by the max over feasible nodes only, and the
// affinity normalize by the feasible max - min; that set shrinks as
// capacity fills); (2) each thread scores its feasible nodes and keeps its
// best by the key (score, -index); the block reduces that key, which keeps
// the reference's first maximum; (3) the owner of the chosen node applies
// the resource update and marks it touched, and thread r adds the pod's
// increment to affinity row r at the chosen node's domain
// (greedy.py:157-168). One block uses one of the card's 132 SMs: spreading
// the node axis over a thread-block cluster is later work (ROADMAP).
//
// Under a node mesh (kernel K1, kubetpu/parallel/mesh.py:234
// sharded_greedy) the scan runs as G blocks, one a node shard: G blocks of
// one cooperative launch for G logical shards on one card (co-resident, so
// their spin waits cannot deadlock), or one block a card, each on its
// card's stream. Each block scans its own N / G rows and exchanges with its
// peers at every reduction over nodes (scan_loop.cuh, exchange.cuh). G = 1
// is the unsharded kernel above, with no exchange compiled in.
// kt_shard_argmax (kernel K4, kubetpu/parallel/mesh.py:327
// measure_collective_wall's argmax) is the exchange alone: each shard's
// first argmax of an int64 vector, then the pick by (value, -index), run
// `reps` times to time one round trip.
//
// Nominations (the final state's slot 6, a.nom_active): filter_score's
// mask0 charges every nomination; when a step assigns a nomination's own
// pod, that nomination stops charging (greedy.py:170-175) and its
// nominated node is marked touched, so later pods recompute that node's
// verdict against the live nominations.
#include "scan_loop.cuh"

namespace {

constexpr int kThreads = kt::kThreads;

// kPA: the batch has affinity rows; kSP: it has a spread leaf (see
// scan_loop.cuh)
template <bool kPA, bool kSP, bool kDRA>
__global__ void __launch_bounds__(kThreads, 1)
greedy_scan_kernel(ScoreArgs a, const uint8_t* mask0, const int64_t* base0, uint8_t* touched,
                   int32_t* assignments, int64_t* req, int64_t* nz, int32_t* pc,
                   uint8_t* ports, int64_t* pa_sums, int64_t* row_total, int32_t* sp_counts,
                   uint8_t* ok_buf) {
  kt::scan_loop<kPA, kSP, kDRA>(a, kt::NoHypothesis{}, kt::NoExchange{}, mask0, base0,
                                touched, assignments,
                                req, nz, pc, ports, pa_sums, row_total, sp_counts, ok_buf);
}

// the instantiation for a batch with (kDRA) or without the DRA leaf
template <bool kPA, bool kSP>
auto scan_for(bool dra) {
  return dra ? greedy_scan_kernel<kPA, kSP, true> : greedy_scan_kernel<kPA, kSP, false>;
}

// One shard of a sharded scan: its arguments and buffers (mirror of
// ScanShard in kubetpu_torch/kernels/__init__.py; 8-byte fields)
struct ScanShard {
  ScoreArgs a;
  const uint8_t* mask0;
  const int64_t* base0;
  uint8_t* touched;
  int32_t* assignments;
  int64_t* req;
  int64_t* nz;
  int32_t* pc;
  uint8_t* ports;
  int64_t* pa_sums;
  int64_t* row_total;
  int32_t* sp_counts;
  uint8_t* ok_buf;
  int64_t offset;  // global index of the shard's first node
  int64_t g;       // shard index
};

// Every shard's entry, passed by value: block b reads entry b in place
// (__grid_constant__), so its arguments stay in the parameter space the
// unsharded kernel reads them from, not copied into registers or shared
// memory. (8 entries: the parameter takes 6.5 KB, which needs CUDA 12.1.)
struct ShardSet {
  ScanShard sh[8];
};

template <bool kPA, bool kSP, bool kDRA>
__global__ void __launch_bounds__(kThreads, 1)
sharded_scan_kernel(const __grid_constant__ ShardSet s, const __grid_constant__ Exchange x) {
  __shared__ int s_flag, s_win;
  __shared__ int64_t s_red[kt::kNorm];
  const ScanShard& me = s.sh[blockIdx.x];
  const kt::MeshShard m{kt::Xchg{&x, me.g, 0}, me.offset, &s_flag, &s_win, s_red};
  kt::scan_loop<kPA, kSP, kDRA>(me.a, kt::NoHypothesis{}, m, me.mask0, me.base0, me.touched,
                                me.assignments, me.req, me.nz, me.pc, me.ports, me.pa_sums,
                                me.row_total, me.sp_counts, me.ok_buf);
}

using ShardedScan = void (*)(const ShardSet, const Exchange);

template <bool kPA, bool kSP>
ShardedScan sharded_for(bool dra) {
  return dra ? sharded_scan_kernel<kPA, kSP, true> : sharded_scan_kernel<kPA, kSP, false>;
}

// One shard of the argmax probe (mirror of ArgmaxShard)
struct ArgmaxShard {
  const int64_t* vals;  // (n,)
  int64_t n;
  int64_t offset;
  int64_t g;
  int64_t* out;         // () the global argmax, -1 when n is 0 everywhere
};

struct ArgmaxSet {
  ArgmaxShard sh[8];
};

__global__ void __launch_bounds__(kThreads, 1)
shard_argmax_kernel(const __grid_constant__ ArgmaxSet set, const __grid_constant__ Exchange x,
                    int64_t reps) {
  __shared__ int s_flag, s_win;
  __shared__ int64_t s_x[33], s_y[33];
  const ArgmaxShard& s = set.sh[blockIdx.x];
  kt::Xchg e{&x, s.g, 0};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t bs = 0, bn = -1;
  for (int64_t n = threadIdx.x; n < s.n; n += kThreads)
    if (kt::better(s.vals[n], n, bs, bn)) {
      bs = s.vals[n];
      bn = n;
    }
  kt::warp_best(bs, bn);
  if (lane == 0) {
    s_x[warp] = bs;
    s_y[warp] = bn;
  }
  __syncthreads();
  if (warp == 0) {
    int64_t v = s_x[lane], n = s_y[lane];
    kt::warp_best(v, n);
    if (lane == 0) {
      s_x[32] = v;
      s_y[32] = n >= 0 ? n + s.offset : -1;
    }
  }
  __syncthreads();
  for (int64_t r = 0; r < reps; ++r) {
    if (threadIdx.x == 0) {
      e.mine()[0] = s_x[32];
      e.mine()[1] = s_y[32];
    }
    if (!kt::xchg_pick(e, &s_win, &s_flag)) return;
  }
  if (threadIdx.x == 0) *s.out = s_win >= 0 ? kt::xchg_payload(e, s_win)[1] : -1;
}

// launch `kernel` with `args` as G blocks: one cooperative launch when
// `cooperative` (G shards on one card), else one plain block
cudaError_t launch_shards(const void* kernel, void** args, int64_t G, int cooperative,
                          int64_t smem, cudaStream_t stream) {
  if (cooperative)
    return cudaLaunchCooperativeKernel(kernel, dim3((unsigned)G), dim3(kThreads), args,
                                       (size_t)smem, stream);
  return cudaLaunchKernel(kernel, dim3(1), dim3(kThreads), args, (size_t)smem, stream);
}

}  // namespace

// Launches the sharded scan (kernel K1) on `stream`: with `cooperative`,
// G blocks over the G entries of `shards` (host memory, G <= 8 shards on
// this card); else one block for the one entry of `shards` (this card's
// shard of a mesh of cards, whose other blocks run on the other cards). `x` is
// the exchange; a timeout sets *x.error. Each shard's buffers are as
// kt_greedy_scan's, its assignments the global indices. Returns the
// cudaError_t of the launch.
extern "C" int kt_sharded_scan(const void* shards, const Exchange* x, int64_t G,
                               int cooperative, int pa, int sp, int dra, int64_t smem,
                               void* stream) {
  if (G <= 0) return 0;
  if ((cooperative ? G : 1) > 8) return (int)cudaErrorInvalidValue;
  ShardedScan kernel = pa ? (sp ? sharded_for<true, true>(dra) : sharded_for<true, false>(dra))
                          : (sp ? sharded_for<false, true>(dra) : sharded_for<false, false>(dra));
  // `shards` is host memory holding the launch's entries
  ShardSet set{};
  const ScanShard* in = static_cast<const ScanShard*>(shards);
  for (int64_t g = 0; g < (cooperative ? G : 1); ++g) set.sh[g] = in[g];
  Exchange xv = *x;
  void* args[] = {&set, &xv};
  cudaError_t err = launch_shards((const void*)kernel, args, G, cooperative, smem,
                                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launches the argmax probe (kernel K4), as kt_sharded_scan launches the
// scan (`shards` in host memory); `reps` exchanges of the same pick.
extern "C" int kt_shard_argmax(const void* shards, const Exchange* x, int64_t G,
                               int cooperative, int64_t reps, void* stream) {
  if (G <= 0) return 0;
  if ((cooperative ? G : 1) > 8) return (int)cudaErrorInvalidValue;
  ArgmaxSet set{};
  const ArgmaxShard* in = static_cast<const ArgmaxShard*>(shards);
  for (int64_t g = 0; g < (cooperative ? G : 1); ++g) set.sh[g] = in[g];
  Exchange xv = *x;
  void* args[] = {&set, &xv, &reps};
  cudaError_t err = launch_shards((const void*)shard_argmax_kernel, args, G, cooperative, 0,
                                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Lets the current device read `peer`'s memory (idempotent). Returns the
// cudaError_t (0 = enabled, or already enabled).
extern "C" int kt_enable_peer_access(int peer) {
  cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return (int)err;
}

extern "C" int64_t kt_greedy_scan_shard_size() { return (int64_t)sizeof(ScanShard); }
extern "C" int64_t kt_greedy_scan_exchange_size() { return (int64_t)sizeof(Exchange); }
extern "C" int64_t kt_greedy_scan_argmax_size() { return (int64_t)sizeof(ArgmaxShard); }

// Launches the scan on `stream`. mask0 and base0 are filter_score's (P, N)
// mask (without the affinity and spread filters) and base score of the
// same batch; `touched` is (N,) scratch. With affinity rows, pa_sums (RA,
// D) receives the final sums and row_total (RA,) is scratch; both are null
// without. With a spread leaf, sp_counts (S, N) receives the final counts
// and ok_buf (N,) is scratch, as are a.sp_sums, a.sp_min_match and
// a.sp_bits; both are null without. With nominations a.nom_active (G,)
// holds the live nominations, all set on entry (filter_score's mask0 was
// computed so), and is cleared in place as their pods are assigned. `smem`
// is the dynamic shared memory in bytes (at most 40 KiB). The outputs are
// written whole by the kernel.
// Returns the cudaError_t of the launch (0 = accepted).
extern "C" int kt_greedy_scan(const ScoreArgs* args, const void* mask0, const void* base0,
                              void* touched, void* assignments, void* req, void* nz, void* pc,
                              void* ports, void* pa_sums, void* row_total, void* sp_counts,
                              void* ok_buf, int64_t smem, void* stream) {
  const ScoreArgs a = *args;
  if (a.N == 0 && a.P == 0) return 0;
  const bool pa = pa_sums != nullptr, sp = sp_counts != nullptr, dra = a.dra_raw != nullptr;
  auto kernel = pa ? (sp ? scan_for<true, true>(dra) : scan_for<true, false>(dra))
                   : (sp ? scan_for<false, true>(dra) : scan_for<false, false>(dra));
  kernel<<<1, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint8_t*>(mask0), static_cast<const int64_t*>(base0),
      static_cast<uint8_t*>(touched), static_cast<int32_t*>(assignments),
      static_cast<int64_t*>(req), static_cast<int64_t*>(nz), static_cast<int32_t*>(pc),
      static_cast<uint8_t*>(ports), static_cast<int64_t*>(pa_sums),
      static_cast<int64_t*>(row_total), static_cast<int32_t*>(sp_counts),
      static_cast<uint8_t*>(ok_buf));
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_greedy_scan_args_size() { return (int64_t)sizeof(ScoreArgs); }

extern "C" const char* kt_greedy_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
