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
// Nominations (the final state's slot 6, a.nom_active): filter_score's
// mask0 charges every nomination; when a step assigns a nomination's own
// pod, that nomination stops charging (greedy.py:170-175) and its
// nominated node is marked touched, so later pods recompute that node's
// verdict against the live nominations.
#include "score_common.cuh"

namespace {

constexpr int kThreads = 1024;

// (score, node) with node < 0 meaning "none"; better = higher score, then
// lower node index
__device__ __forceinline__ bool better(int64_t s, int64_t n, int64_t bs, int64_t bn) {
  if (n < 0) return false;
  if (bn < 0) return true;
  return s > bs || (s == bs && n < bn);
}

__device__ __forceinline__ void warp_best(int64_t& s, int64_t& n) {
  for (int off = 16; off > 0; off >>= 1) {
    int64_t os = __shfl_down_sync(0xffffffffu, s, off);
    int64_t on = __shfl_down_sync(0xffffffffu, n, off);
    if (better(os, on, s, n)) {
      s = os;
      n = on;
    }
  }
}

// kPA: the batch has affinity rows; kSP: it has a spread leaf. The kernel
// is built four times, so that a batch without them runs code with no
// affinity or spread branches at all. Dynamic shared memory (kSP only):
// sp_C doubles of slot weights, then the domain bitmap when a.sp_bits is
// null.
template <bool kPA, bool kSP>
__global__ void __launch_bounds__(kThreads, 1)
greedy_scan_kernel(ScoreArgs a, const uint8_t* mask0, const int64_t* base0, uint8_t* touched,
                   int32_t* assignments, int64_t* req, int64_t* nz, int32_t* pc,
                   uint8_t* ports, int64_t* pa_sums, int64_t* row_total, int32_t* sp_counts,
                   uint8_t* ok_buf) {
  __shared__ int64_t s_m[kt::kNorm][33];
  __shared__ int64_t s_x[33];
  __shared__ int64_t s_y[33];
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int64_t N = a.N, R = a.R, K = a.K;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (!kPA) a.w_interpod = 0;
  if (!kSP) {
    a.w_spread = 0;
    a.sp_filter = 0;
  }
  const bool pa = kPA;
  const bool pa_filter = kPA && a.pa_filter;
  const bool nom = a.nom_node != nullptr && a.G > 0;
  const int64_t S = a.sp_S, D1 = a.sp_D + 1;
  double* weight = reinterpret_cast<double*>(s_dyn);
  uint32_t* bits = a.sp_bits != nullptr
                       ? a.sp_bits
                       : reinterpret_cast<uint32_t*>(s_dyn + a.sp_C * sizeof(double));

  // the running state starts as the batch's node state (owner rows only)
  for (int64_t n = tid; n < N; n += kThreads) {
    for (int64_t r = 0; r < R; ++r) {
      req[n * R + r] = a.requested[n * R + r];
      nz[n * R + r] = a.nonzero_requested[n * R + r];
    }
    pc[n] = a.pod_count[n];
    for (int64_t k = 0; k < K; ++k) ports[n * K + k] = a.node_ports[n * K + k];
    touched[n] = 0;
  }
  if (pa) {
    for (int64_t i = tid; i < a.pa_R * a.pa_D; i += kThreads) pa_sums[i] = a.pa_sums[i];
    kt::pa_row_totals(a, a.pa_sums, row_total, tid, kThreads);
    __syncthreads();
  }
  if constexpr (kSP) {
    // the running counts start as the batch's, their domain sums from them
    for (int64_t i = tid; i < S * N; i += kThreads) sp_counts[i] = a.sp_counts[i];
    for (int64_t i = tid; i < S * D1; i += kThreads) a.sp_sums[i] = 0;
    __syncthreads();
    kt::sp_accumulate(a, sp_counts, a.sp_sums, 0, 1);
    __syncthreads();
  }

  const bool na_tt = a.na_raw != nullptr || a.tt_raw != nullptr;
  const bool normalize = na_tt || a.w_interpod;
  for (int64_t p = 0; p < a.P; ++p) {
    const uint8_t* m0 = mask0 + p * N;
    const int64_t* b0 = base0 + p * N;
    const int64_t row = na_tt ? (int64_t)a.score_sig[p] * N : 0;
    const bool escape = pa_filter && kt::pa_escape(a, row_total, p);
    const bool sp_score = kSP && a.w_spread && kt::sp_any_soft(a, p);
    // the pair's verdict against the running state
    auto feasible = [&](int64_t n) {
      bool ok = touched[n] ? kt::pair_feasible(a, p, n, req, pc, ports) : m0[n];
      if (ok && pa_filter) ok = kt::pa_feasible(a, pa_sums, escape, p, n);
      if (kSP && ok && a.sp_filter) ok = kt::sp_feasible(a, a.sp_sums, a.sp_min_match, p, n);
      return ok;
    };
    // the rounded spread raw of a feasible node, -1 when it is not scored
    auto spread_raw = [&](int64_t n) {
      return kt::sp_scored_raw(a, sp_score, sp_counts, a.sp_sums, weight, p, n);
    };
    if constexpr (kSP) {
      // (0) every signature's minMatch against the running sums, then
      // every node's verdict and each soft slot's size
      if (a.sp_filter) {
        for (int64_t sg = 0; sg < S; ++sg) {
          const int64_t mm = kt::sp_min_over_domains(a, a.sp_sums, sg, s_x);
          if (tid == 0) a.sp_min_match[sg] = mm;
        }
        __syncthreads();
      }
      for (int64_t n = tid; n < N; n += kThreads) ok_buf[n] = feasible(n);
      __syncthreads();
      if (sp_score) kt::sp_weights(a, p, ok_buf, bits, weight, s_x);
    }
    // (1) the normalize inputs over the feasible nodes
    int64_t mx[kt::kNorm];
    kt::init_norm(mx);
    if (normalize || sp_score) {
      for (int64_t n = tid; n < N; n += kThreads) {
        if (!(kSP ? ok_buf[n] : feasible(n))) continue;
        const int64_t pa_r = a.w_interpod ? kt::pa_raw(a, pa_sums, p, n) : 0;
        kt::fold_norm(a, row, n, pa_r, spread_raw(n), mx);
      }
      kt::block_max_norm(a, sp_score, mx, s_m);
    }
    // (2) best feasible node of this thread, then of the block
    int64_t best_s = 0, best_n = -1;
    for (int64_t n = tid; n < N; n += kThreads) {
      if (!(kSP ? ok_buf[n] : feasible(n))) continue;
      int64_t s = touched[n] ? kt::base_score(a, p, n, req, nz) : b0[n];
      if (normalize || sp_score) {
        const int64_t pa_r = a.w_interpod ? kt::pa_raw(a, pa_sums, p, n) : 0;
        s += kt::norm_terms(a, row, n, true, pa_r, spread_raw(n), mx);
      }
      if (better(s, n, best_s, best_n)) {
        best_s = s;
        best_n = n;
      }
    }
    warp_best(best_s, best_n);
    if (lane == 0) {
      s_x[warp] = best_s;
      s_y[warp] = best_n;
    }
    __syncthreads();
    if (warp == 0) {
      int64_t s = s_x[lane], n = s_y[lane];  // kThreads / 32 == 32 warps
      warp_best(s, n);
      if (lane == 0) {
        s_y[32] = n;
        assignments[p] = (int32_t)n;  // -1 when no node is feasible
      }
    }
    __syncthreads();
    // (3) the owner of the chosen node assumes the pod onto it
    const int64_t chosen = s_y[32];
    if (chosen >= 0 && chosen % kThreads == tid) {
      for (int64_t r = 0; r < R; ++r) {
        req[chosen * R + r] += a.requests[p * R + r];
        nz[chosen * R + r] += a.nonzero_requests[p * R + r];
      }
      pc[chosen] += 1;
      for (int64_t k = 0; k < K; ++k)
        ports[chosen * K + k] = ports[chosen * K + k] | a.pod_ports[p * K + k];
      touched[chosen] = 1;
    }
    if (pa) {
      // interpodaffinity updateWithPod: row r at the chosen node's domain
      if (chosen >= 0) {
        for (int64_t r = tid; r < a.pa_R; r += kThreads) {
          const int32_t dom = a.pa_node_domain[r * N + chosen];
          if (dom < 0) continue;
          const int64_t inc = a.pa_update[p * a.pa_R + r];
          pa_sums[r * a.pa_D + dom] += inc;
          row_total[r] += inc;
        }
      }
    }
    if constexpr (kSP) {
      // spread updateWithPod (filtering.go:181): +1 at the chosen node in
      // every signature the pod matches and the node is eligible for
      if (chosen >= 0) {
        for (int64_t sg = tid; sg < S; sg += kThreads) {
          if (!a.sp_pod_match_sig[p * S + sg] || !a.sp_eligible[sg * N + chosen]) continue;
          sp_counts[sg * N + chosen] += 1;
          const int32_t dom = a.sp_node_domain[sg * N + chosen];
          a.sp_sums[sg * D1 + (dom >= 0 ? dom : a.sp_D)] += 1;
        }
      }
    }
    if (nom && chosen >= 0) {
      // assume deletes the nomination (schedule_one.go:307)
      for (int64_t g = tid; g < a.G; g += kThreads) {
        if (a.nom_pod_idx[g] != p || !a.nom_active[g]) continue;
        a.nom_active[g] = 0;
        if (a.nom_node[g] >= 0) touched[a.nom_node[g]] = 1;
      }
    }
    if (pa || kSP || nom) __syncthreads();
  }
}

}  // namespace

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
  const bool pa = pa_sums != nullptr, sp = sp_counts != nullptr;
  auto kernel = pa ? (sp ? greedy_scan_kernel<true, true> : greedy_scan_kernel<true, false>)
                   : (sp ? greedy_scan_kernel<false, true> : greedy_scan_kernel<false, false>);
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
