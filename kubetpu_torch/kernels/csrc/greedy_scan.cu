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
// filter_score over all SMs; the scan is P sequential steps, each as long
// as its critical path (scan_loop.cuh says how the loop keeps memory loads
// and repeated work off it). Design: ONE persistent block of 512 threads.
// Thread t owns nodes t, t+512, ... (at most 32): it alone reads and
// writes those nodes' running requested / nonzero / pod_count / node_ports
// rows (global memory) and keeps their touched flags in its registers, so
// the state needs no fences (its updates are atomics only so that no load
// of the old row waits on the step). A node no earlier pod of the
// batch landed on still has the batch's starting state, so its verdict and
// base score for pod p are exactly filter_score's mask0[p, n] and
// base0[p, n]; only touched nodes are recomputed (score_common.cuh), and
// only when the pod's own inputs or the node changed since the last
// recompute. The extender webhook's mask and score depend on the pod and
// node alone, so mask0 and base0 carry them for untouched nodes, and
// pair_feasible and base_score apply them when a touched node is
// recomputed (every step: extender rows differ from pod to pod).
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
// Per step: (1) each thread takes its nodes' verdicts and base scores once
// and, when node-affinity, taint or affinity-score rows are present, the
// block reduces the normalize inputs over the feasible nodes
// (masked_normalize divides by the max over feasible nodes only, and the
// affinity normalize by the feasible max - min; that set shrinks as
// capacity fills); (2) each thread scores its feasible nodes and keeps its
// best by the key (score, -index); the block reduces that key, which keeps
// the reference's first maximum; (3) the owner of the chosen node applies
// the resource update and marks it touched, and thread r adds the pod's
// increment to affinity row r at the chosen node's domain
// (greedy.py:157-168). One block uses one of the card's 132 SMs: splitting
// the node axis over more SMs did not shorten a step (K1 below pays the
// step's waits on every shard), so the block stays one.
//
// Under a node mesh (kernel K1, kubetpu/parallel/mesh.py:234
// sharded_greedy) the scan runs as G blocks, one a node shard: G blocks of
// one cooperative launch for G logical shards on one card (co-resident, so
// their spin waits cannot deadlock), or one block a card, each on its
// card's stream. Each block scans its own N / G rows and exchanges with its
// peers at every reduction over nodes (scan_loop.cuh, exchange.cuh). G = 1
// is the unsharded kernel above, with no exchange compiled in. A node mesh
// is a pods x nodes grid of one pod row: on a grid of PG rows (kernel K7,
// tiled_scan_kernel below, which also runs K1) the NG column blocks scan
// the pod rows in turn, each row's pods from its tiles.
// kt_shard_argmax (kernel K4, kubetpu/parallel/mesh.py:327
// measure_collective_wall's argmax) is the exchange alone: each shard's
// first argmax of an int64 vector, then the pick by (value, -index), run
// `reps` times to time one round trip.
//
// Nominations (the final state's slot 6, a.nom_active): filter_score's
// mask0 charges every nomination; when a step assigns a nomination's own
// pod, that nomination stops charging (greedy.py:170-175) and its
// nominated node is marked touched by its owner (the releasing thread
// lists the node in shared memory; after the step's barrier each owner
// takes the listed nodes it owns), so later pods recompute that node's
// verdict against the live nominations.
#include "scan_loop.cuh"

namespace {

constexpr int kThreads = kt::kThreads;
// the argmax probe's block: 32 warps, whose partials lanes 0-31 of warp 0
// reduce
constexpr int kArgmaxThreads = 1024;

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

// One tile of a sharded scan: its arguments and buffers (mirror of
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
  int64_t offset;  // global index of the tile's first node
};

// Every tile's entry, passed by value: a block reads its entries in place
// (__grid_constant__), so its arguments stay in the parameter space the
// unsharded kernel reads them from, not copied into registers or shared
// memory. (8 entries: the parameter takes 6.5 KB, which needs CUDA 12.1.)
struct ShardSet {
  ScanShard sh[8];
};

// Kernel K7, the scan over a pods x nodes grid (kubetpu/parallel/mesh.py:234
// sharded_greedy with a "pods" axis), and kernel K1, the same over a node
// mesh, the grid of one pod row (sharded_greedy without one): the PG x NG
// tiles' entries, tile (i, j) at i * NG + j. Block j scans node column j:
// pod row after pod row, it runs scan_loop over row i's pods with tile (i,
// j)'s arguments (its pods' leaves, its filter_score rows), exchanging with
// the other columns' blocks at every reduction over nodes. Every entry of a column names the
// same running buffers (the column's one copy of its rows, touched flags,
// affinity sums, spread counts and sums, live nominations), so the state
// carries from one pod row to the next, and so does the exchange count.
// `col` is the one column this launch runs (a block a card), or -1 for NG
// blocks of one cooperative launch. kRows: PG > 1. One pod row (a node
// mesh) compiles to one segment with no row loop: on one pod row the row
// loop, with its runtime `carry`, measured ~11% slower on an H100.
template <bool kPA, bool kSP, bool kDRA, bool kRows>
__global__ void __launch_bounds__(kThreads, 1)
tiled_scan_kernel(const __grid_constant__ ShardSet s, const __grid_constant__ Exchange x,
                  int64_t PG, int64_t NG, int64_t col) {
  __shared__ int s_flag, s_win;
  __shared__ int64_t s_red[kt::kNorm];
  const int64_t j = col >= 0 ? col : (int64_t)blockIdx.x;
  kt::Xchg e{&x, j, 0};
  const kt::MeshShard m{&e, s.sh[j].offset, &s_flag, &s_win, s_red};
  if constexpr (!kRows) {
    const ScanShard& me = s.sh[j];
    kt::scan_loop<kPA, kSP, kDRA>(me.a, kt::NoHypothesis{}, m, me.mask0, me.base0, me.touched,
                                  me.assignments, me.req, me.nz, me.pc, me.ports, me.pa_sums,
                                  me.row_total, me.sp_counts, me.ok_buf);
  } else {
    if (threadIdx.x == 0) s_flag = 1;
    __syncthreads();
    for (int64_t i = 0; i < PG; ++i) {
      const ScanShard& me = s.sh[i * NG + j];
      kt::scan_loop<kPA, kSP, kDRA>(me.a, kt::NoHypothesis{}, m, me.mask0, me.base0,
                                    me.touched, me.assignments, me.req, me.nz, me.pc, me.ports,
                                    me.pa_sums, me.row_total, me.sp_counts, me.ok_buf, i > 0);
      __syncthreads();
      if (!s_flag) return;  // an exchange ran past its budget
    }
  }
}

using TiledScan = void (*)(const ShardSet, const Exchange, int64_t, int64_t, int64_t);

template <bool kPA, bool kSP, bool kRows>
TiledScan tiled_rows(bool dra) {
  return dra ? tiled_scan_kernel<kPA, kSP, true, kRows>
             : tiled_scan_kernel<kPA, kSP, false, kRows>;
}

template <bool kPA, bool kSP>
TiledScan tiled_for(bool dra, bool rows) {
  return rows ? tiled_rows<kPA, kSP, true>(dra) : tiled_rows<kPA, kSP, false>(dra);
}

// One shard of the argmax probe (mirror of ArgmaxShard)
struct ArgmaxShard {
  const int64_t* vals;  // (n,)
  int64_t n;
  int64_t offset;
  int64_t g;
  int64_t* out;         // (2,) the global argmax (-1 when n is 0 everywhere),
                        // then 1 if an exchange on this card timed out, else 0
};

struct ArgmaxSet {
  ArgmaxShard sh[8];
};

__global__ void __launch_bounds__(kArgmaxThreads, 1)
shard_argmax_kernel(const __grid_constant__ ArgmaxSet set, const __grid_constant__ Exchange x,
                    int64_t reps) {
  __shared__ int s_flag, s_win;
  __shared__ int64_t s_x[33], s_y[33];
  const ArgmaxShard& s = set.sh[blockIdx.x];
  kt::Xchg e{&x, s.g, 0};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t bs = 0, bn = -1;
  for (int64_t n = threadIdx.x; n < s.n; n += kArgmaxThreads)
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
  bool ok = true;
  for (int64_t r = 0; r < reps && ok; ++r) {
    if (threadIdx.x == 0) {
      e.mine()[0] = s_x[32];
      e.mine()[1] = s_y[32];
    }
    ok = kt::xchg_pick(e, &s_win, &s_flag);
  }
  // the pick and the card's error word in one output, so that the host
  // reads both with one copy. A block that finished every exchange saw
  // every peer publish each one, so no peer can time out after it: its
  // error word is final here.
  if (threadIdx.x == 0) {
    s.out[0] = ok && s_win >= 0 ? kt::xchg_payload(e, s_win)[1] : -1;
    s.out[1] = ok ? (int64_t)(*(const volatile int32_t*)x.error != 0) : 1;
  }
}

// let `kernel` take `smem` bytes of dynamic shared memory (past the 48 KiB
// a launch gets without asking)
cudaError_t allow_smem(const void* kernel, int64_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// launch `kernel` with `args` as G blocks of `threads`: one cooperative
// launch when `cooperative` (G shards or node columns on one card), else
// one plain block
cudaError_t launch_shards(const void* kernel, void** args, int64_t G, int cooperative,
                          int threads, int64_t smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (cooperative)
    return cudaLaunchCooperativeKernel(kernel, dim3((unsigned)G), dim3(threads), args,
                                       (size_t)smem, stream);
  return cudaLaunchKernel(kernel, dim3(1), dim3(threads), args, (size_t)smem, stream);
}

}  // namespace

// Launches the grid's scan (kernel K7; K1 when PG is 1) on `stream`:
// `shards` (host memory) holds the PG * NG tiles' entries (at most 8), tile
// (i, j) at i * NG + j; with `cooperative`, NG blocks of one cooperative
// launch, one a node column on this card (co-resident, so their spin waits
// cannot deadlock); else one block for column `col` (this card's column of
// pod row 0; the other rows' entries are read through peer pointers). Each
// tile's buffers are as kt_greedy_scan's, its assignments the global
// indices. `x` is the exchange of the NG columns; a timeout sets *x.error.
// Returns the cudaError_t of the launch.
extern "C" int kt_tiled_scan(const void* shards, const Exchange* x, int64_t PG, int64_t NG,
                             int cooperative, int64_t col, int pa, int sp, int dra, int64_t smem,
                             void* stream) {
  if (PG <= 0 || NG <= 0) return 0;
  if (PG * NG > 8) return (int)cudaErrorInvalidValue;
  const ScanShard* in = static_cast<const ScanShard*>(shards);
  for (int64_t t = 0; t < PG * NG; ++t)
    if (in[t].a.N > kt::kMaxNodes) return (int)cudaErrorInvalidValue;
  const bool rows = PG > 1;
  TiledScan kernel = pa ? (sp ? tiled_for<true, true>(dra, rows)
                              : tiled_for<true, false>(dra, rows))
                        : (sp ? tiled_for<false, true>(dra, rows)
                              : tiled_for<false, false>(dra, rows));
  ShardSet set{};
  for (int64_t t = 0; t < PG * NG; ++t) set.sh[t] = in[t];
  Exchange xv = *x;
  int64_t c = cooperative ? -1 : col;
  void* args[] = {&set, &xv, &PG, &NG, &c};
  cudaError_t err = launch_shards((const void*)kernel, args, NG, cooperative, kThreads, smem,
                                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launches the argmax probe (kernel K4) on `stream`: with `cooperative`, G
// blocks over the G entries of `shards` (host memory, G <= 8 shards on this
// card); else one block for the one entry of `shards` (this card's shard of
// a mesh of cards). `reps` exchanges of the same pick. Each block writes
// its `out` (the pick, and its card's timeout flag) and nothing else. With
// `host_out` (pinned host memory, two int64), the entry then copies the
// first entry's `out` there and waits for `stream`: the launch and the
// host's read in one call (only where no other card's launch must follow).
extern "C" int kt_shard_argmax(const void* shards, const Exchange* x, int64_t G,
                               int cooperative, int64_t reps, void* host_out, void* stream) {
  if (G <= 0) return 0;
  if ((cooperative ? G : 1) > 8) return (int)cudaErrorInvalidValue;
  ArgmaxSet set{};
  const ArgmaxShard* in = static_cast<const ArgmaxShard*>(shards);
  for (int64_t g = 0; g < (cooperative ? G : 1); ++g) set.sh[g] = in[g];
  Exchange xv = *x;
  void* args[] = {&set, &xv, &reps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_shards((const void*)shard_argmax_kernel, args, G, cooperative,
                                  kArgmaxThreads, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || host_out == nullptr) return (int)err;
  err = cudaMemcpyAsync(host_out, in[0].out, 2 * sizeof(int64_t), cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamSynchronize(s);
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
// is the dynamic shared memory in bytes (scan_loop.cuh scan_smem: the N
// base scores, the staged pods and params, the spread weights and bitmap;
// at most 232,448 bytes less the static arrays). The outputs are written
// whole by the kernel. N may not exceed kt::kMaxNodes.
// Returns the cudaError_t of the launch (0 = accepted).
extern "C" int kt_greedy_scan(const ScoreArgs* args, const void* mask0, const void* base0,
                              void* touched, void* assignments, void* req, void* nz, void* pc,
                              void* ports, void* pa_sums, void* row_total, void* sp_counts,
                              void* ok_buf, int64_t smem, void* stream) {
  const ScoreArgs a = *args;
  if (a.N == 0 && a.P == 0) return 0;
  if (a.N > kt::kMaxNodes) return (int)cudaErrorInvalidValue;
  const bool pa = pa_sums != nullptr, sp = sp_counts != nullptr, dra = a.dra_raw != nullptr;
  auto kernel = pa ? (sp ? scan_for<true, true>(dra) : scan_for<true, false>(dra))
                   : (sp ? scan_for<false, true>(dra) : scan_for<false, false>(dra));
  const cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
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
