// filter_score: the one-shot Filter+Score of a batch, every pod against the
// same node state: the (P, N) mask, the (P, N) int64 base score (fit,
// balanced and image terms, weighted) and, when asked for, the (P, N) int64
// total (base plus the normalized node-affinity and taint terms).
//
// Replaces kubetpu/framework/runtime.py:1578 filter_score_batch (jit), i.e.
// :1471 feasible_and_scores with :1363 filter_components and :1356
// masked_normalize, which XLA fused into one device program. On the main
// path it is the parallel half of the greedy engine: greedy_scan reads its
// mask and base score for every node that no earlier pod of the batch
// landed on, and recomputes only the nodes that changed.
//
// Bound: memory. Per pair the kernel reads a few int64 node rows that stay
// in L2 across the pod axis; what must reach device memory is the (P, N)
// outputs (9 bytes a pair, 17 with the total), so the least time is those
// bytes over the card's bandwidth. Design: launch (a) is one thread per
// pair on a 2-D grid (x = nodes, y = pods), so neighbouring threads touch
// neighbouring node rows and the writes coalesce; launch (b), only when
// the total is asked for, is one block per pod that reduces the feasible
// maximum of the node-affinity and taint raw rows and writes the total.
#include "score_common.cuh"

namespace {

constexpr int kPairThreads = 256;
constexpr int kRowThreads = 512;

__global__ void filter_score_pairs(ScoreArgs a, uint8_t* mask, int64_t* base) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t p = blockIdx.y;
  if (n >= a.N) return;
  const bool ok = kt::pair_feasible(a, p, n, a.requested, a.pod_count, a.node_ports);
  mask[p * a.N + n] = ok;
  base[p * a.N + n] = kt::base_score(a, p, n, a.requested, a.nonzero_requested);
}

__global__ void filter_score_normalize(ScoreArgs a, const uint8_t* mask, const int64_t* base,
                                       int64_t* total) {
  __shared__ int64_t s_na[33];
  __shared__ int64_t s_tt[33];
  const int64_t p = blockIdx.x;
  const int64_t N = a.N;
  const bool normalize = a.na_raw != nullptr || a.tt_raw != nullptr;
  const int64_t row = normalize ? (int64_t)a.score_sig[p] * N : 0;
  const uint8_t* m = mask + p * N;
  int64_t mx_na = 0, mx_tt = 0;
  if (normalize) {
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      if (!m[n]) continue;
      if (a.na_raw != nullptr) mx_na = kt::imax(mx_na, a.na_raw[row + n]);
      if (a.tt_raw != nullptr) mx_tt = kt::imax(mx_tt, a.tt_raw[row + n]);
    }
    kt::block_max2(mx_na, mx_tt, s_na, s_tt);
  }
  for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
    int64_t s = base[p * N + n];
    if (normalize) {
      const bool ok = m[n];
      const int64_t na = (ok && a.na_raw != nullptr) ? a.na_raw[row + n] : 0;
      const int64_t tt = (ok && a.tt_raw != nullptr) ? a.tt_raw[row + n] : 0;
      s += kt::normalized_terms(a, na, tt, mx_na, mx_tt);
    }
    total[p * N + n] = s;
  }
}

}  // namespace

// Launches pass (a), and pass (b) when `total` is not null, on `stream`.
// Returns the cudaError_t of the launches (0 = all were accepted); the
// caller raises on anything else.
extern "C" int kt_filter_score(const ScoreArgs* args, void* mask, void* base, void* total,
                               void* stream) {
  const ScoreArgs a = *args;
  if (a.P == 0 || a.N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)((a.N + kPairThreads - 1) / kPairThreads), (unsigned)a.P);
  filter_score_pairs<<<grid, kPairThreads, 0, s>>>(a, static_cast<uint8_t*>(mask),
                                                   static_cast<int64_t*>(base));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || total == nullptr) return (int)err;
  filter_score_normalize<<<(unsigned)a.P, kRowThreads, 0, s>>>(
      a, static_cast<const uint8_t*>(mask), static_cast<const int64_t*>(base),
      static_cast<int64_t*>(total));
  return (int)cudaGetLastError();
}

extern "C" const char* kt_filter_score_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
