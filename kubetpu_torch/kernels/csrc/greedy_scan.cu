// greedy_scan: the greedy assignment of a batch, pods one at a time against
// the running node state, on the device.
//
// Replaces kubetpu/assign/greedy.py:106 greedy_assign_device (jit): a
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
// base0[p, n]; only touched nodes are recomputed (score_common.cuh). Per
// step: (1) when node-affinity or taint rows are present, the block
// reduces their maxima over the feasible nodes (masked_normalize divides
// by the max over feasible nodes only, and that set shrinks as capacity
// fills); (2) each thread scores its feasible nodes and keeps its best by
// the key (score, -index); the block reduces that key, which keeps the
// reference's first maximum; (3) the owner of the chosen node applies the
// update and marks it touched. One block uses one of the card's 132 SMs:
// spreading the node axis over a thread-block cluster is later work
// (ROADMAP).
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

__global__ void __launch_bounds__(kThreads, 1)
greedy_scan_kernel(ScoreArgs a, const uint8_t* mask0, const int64_t* base0, uint8_t* touched,
                   int32_t* assignments, int64_t* req, int64_t* nz, int32_t* pc,
                   uint8_t* ports) {
  __shared__ int64_t s_x[33];
  __shared__ int64_t s_y[33];
  const int64_t N = a.N, R = a.R, K = a.K;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

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

  const bool normalize = a.na_raw != nullptr || a.tt_raw != nullptr;
  for (int64_t p = 0; p < a.P; ++p) {
    const uint8_t* m0 = mask0 + p * N;
    const int64_t* b0 = base0 + p * N;
    // (1) feasible maxima of the node-affinity and taint raw rows
    int64_t mx_na = 0, mx_tt = 0;
    const int64_t row = normalize ? (int64_t)a.score_sig[p] * N : 0;
    if (normalize) {
      for (int64_t n = tid; n < N; n += kThreads) {
        const bool ok = touched[n] ? kt::pair_feasible(a, p, n, req, pc, ports) : m0[n];
        if (!ok) continue;
        if (a.na_raw != nullptr) mx_na = kt::imax(mx_na, a.na_raw[row + n]);
        if (a.tt_raw != nullptr) mx_tt = kt::imax(mx_tt, a.tt_raw[row + n]);
      }
      kt::block_max2(mx_na, mx_tt, s_x, s_y);
    }
    // (2) best feasible node of this thread, then of the block
    int64_t best_s = 0, best_n = -1;
    for (int64_t n = tid; n < N; n += kThreads) {
      const bool t = touched[n];
      if (!(t ? kt::pair_feasible(a, p, n, req, pc, ports) : m0[n])) continue;
      int64_t s = t ? kt::base_score(a, p, n, req, nz) : b0[n];
      if (normalize) {
        const int64_t na = a.na_raw != nullptr ? a.na_raw[row + n] : 0;
        const int64_t tt = a.tt_raw != nullptr ? a.tt_raw[row + n] : 0;
        s += kt::normalized_terms(a, na, tt, mx_na, mx_tt);
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
  }
}

}  // namespace

// Launches the scan on `stream`. mask0 and base0 are filter_score's (P, N)
// mask and base score of the same batch; `touched` is (N,) scratch. The
// outputs are written whole by the kernel. Returns the cudaError_t of the
// launch (0 = accepted).
extern "C" int kt_greedy_scan(const ScoreArgs* args, const void* mask0, const void* base0,
                              void* touched, void* assignments, void* req, void* nz, void* pc,
                              void* ports, void* stream) {
  const ScoreArgs a = *args;
  if (a.N == 0 && a.P == 0) return 0;
  greedy_scan_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint8_t*>(mask0), static_cast<const int64_t*>(base0),
      static_cast<uint8_t*>(touched), static_cast<int32_t*>(assignments),
      static_cast<int64_t*>(req), static_cast<int64_t*>(nz), static_cast<int32_t*>(pc),
      static_cast<uint8_t*>(ports));
  return (int)cudaGetLastError();
}

extern "C" const char* kt_greedy_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
