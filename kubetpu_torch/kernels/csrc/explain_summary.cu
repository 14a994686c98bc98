// explain_summary: the flight recorder's per-pod breakdown of one cycle,
// reduced on the device so the host fetches a few KB, not (P, N) tensors.
//
// Replaces kubetpu/sched/flightrecorder.py:92 _explain_kernel (jit): against
// the cycle-start batch, runtime.filter_components(...)[:5] and
// feasible_and_scores, reduced per pod to the feasible count, each present
// component's rejection count over valid nodes, the top 3 (score, node)
// pairs by three masked first-max passes, and the score of the pod's actual
// assignment.
//
// It runs right after a filter_score launch (want_total, dynamic) on the
// same batch and argument struct: that launch's mask and total are inputs
// here, and its pre-launches (score_prelaunch.cuh) left the spread domain
// sums, minMatch and the affinity row totals in the struct's scratch, which
// the spread and affinity verdicts below read.
//
// Bound: memory. The least time is reading the (P, N) mask and total once
// (9 bytes a pair) and the node block; the outputs are 40 bytes a pod.
// Design: one block per pod, its threads striding the node axis. Pass one
// recomputes the five component verdicts of each pair (the pair function's
// helpers: pair_static, pair_fit, pair_ports, sp_feasible, pa_feasible, so
// they are the filter_score verdicts' exact parts) and sums the counts,
// block-reduced. Then three argmax passes over
// (mask & valid ? total : -2^62), each excluding the nodes already picked,
// reduce the key (score, -index), which keeps the first maximum as
// torch.argmax and jnp.argmax do: a row with fewer than three feasible
// nodes repeats node 0 at -2^62, as the reference's does.
#include "score_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTop = 3;
constexpr int64_t kNeg = -(1LL << 62);

// (score, node): higher score, then lower node index; node < 0 is "none"
__device__ __forceinline__ bool better(int64_t s, int64_t n, int64_t bs, int64_t bn) {
  if (n < 0) return false;
  if (bn < 0) return true;
  return s > bs || (s == bs && n < bn);
}

// reduce (s, n) by `better` over the block; every thread gets the result
__device__ __forceinline__ void block_best(int64_t& s, int64_t& n, int64_t* sv, int64_t* sn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t os = __shfl_down_sync(0xffffffffu, s, off);
    const int64_t on = __shfl_down_sync(0xffffffffu, n, off);
    if (better(os, on, s, n)) {
      s = os;
      n = on;
    }
  }
  if (lane == 0) {
    sv[warp] = s;
    sn[warp] = n;
  }
  __syncthreads();
  if (warp == 0) {
    int64_t x = lane < nwarps ? sv[lane] : 0, y = lane < nwarps ? sn[lane] : -1;
    for (int off = 16; off > 0; off >>= 1) {
      const int64_t os = __shfl_down_sync(0xffffffffu, x, off);
      const int64_t on = __shfl_down_sync(0xffffffffu, y, off);
      if (better(os, on, x, y)) {
        x = os;
        y = on;
      }
    }
    if (lane == 0) {
      sv[32] = x;
      sn[32] = y;
    }
  }
  __syncthreads();
  s = sv[32];
  n = sn[32];
  __syncthreads();
}

// comp_flags: bit c set when component c (static, fit, ports_ok,
// spread_ok, pa_ok) is present; reject is (5, P), rows of absent
// components untouched. top_vals / top_idx are (P, k), k <= 3.
__global__ void __launch_bounds__(kThreads)
explain_summary_kernel(ScoreArgs a, const uint8_t* mask, const int64_t* total,
                       const int32_t* idx, int comp_flags, int k, int32_t* feasible,
                       int32_t* reject, int64_t* top_vals, int32_t* top_idx, int64_t* win) {
  __shared__ int64_t s_v[33];
  __shared__ int64_t s_n[33];
  const int64_t p = blockIdx.x;
  const int64_t N = a.N, P = a.P;
  const uint8_t* m = mask + p * N;
  const int64_t* tot = total + p * N;
  const bool pa_on = (comp_flags >> 4) & 1;
  const bool escape = pa_on && kt::pa_escape(a, a.pa_row_total, p);
  const int64_t G = kt::nomination_slots(a);
  int64_t feas = 0, rej[5] = {0, 0, 0, 0, 0};
  for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
    if (!a.node_valid[n]) continue;
    feas += m[n] != 0;
    const int64_t charged = kt::nominated_count(a, p, n, G);
    if (!kt::pair_static(a, p, n)) rej[0] += 1;
    if ((comp_flags >> 1) & 1)
      rej[1] += !kt::pair_fit(a, p, n, a.requested, a.pod_count, charged, G);
    if ((comp_flags >> 2) & 1) rej[2] += !kt::pair_ports(a, p, n, a.node_ports, charged, G);
    if ((comp_flags >> 3) & 1)
      rej[3] += !kt::sp_feasible(a, a.sp_sums, a.sp_min_match, p, n);
    if (pa_on) rej[4] += !kt::pa_feasible(a, a.pa_sums, escape, p, n);
  }
  feas = kt::block_reduce(feas, kt::SumOp(), 0, s_v);
  if (threadIdx.x == 0) feasible[p] = (int32_t)feas;
  for (int c = 0; c < 5; ++c) {
    if (!((comp_flags >> c) & 1)) continue;
    const int64_t r = kt::block_reduce(rej[c], kt::SumOp(), 0, s_v);
    if (threadIdx.x == 0) reject[c * P + p] = (int32_t)r;
  }
  int64_t picked[kTop] = {-1, -1, -1};
  for (int j = 0; j < k; ++j) {
    int64_t bs = 0, bn = -1;
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      int64_t v = (m[n] && a.node_valid[n]) ? tot[n] : kNeg;
      for (int q = 0; q < j; ++q)
        if (picked[q] == n) v = kNeg;
      if (better(v, n, bs, bn)) {
        bs = v;
        bn = n;
      }
    }
    block_best(bs, bn, s_v, s_n);
    picked[j] = bn;
    if (threadIdx.x == 0) {
      top_vals[p * k + j] = bs;
      top_idx[p * k + j] = (int32_t)bn;
    }
  }
  if (threadIdx.x == 0) {
    const int64_t j = idx[p] > 0 ? idx[p] : 0;
    win[p] = tot[j];
  }
}

}  // namespace

// Launches the summary on `stream`, one block per pod. mask and total are
// filter_score's (P, N) outputs on the same batch and argument struct
// (launched just before, with its pre-launches); idx (P,) int32 the
// engine's assignments (-1 = none). Returns the cudaError_t of the launch
// (0 = accepted).
extern "C" int kt_explain_summary(const ScoreArgs* args, const void* mask, const void* total,
                                  const void* idx, int comp_flags, int k, void* feasible,
                                  void* reject, void* top_vals, void* top_idx, void* win,
                                  void* stream) {
  const ScoreArgs a = *args;
  if (a.P == 0 || a.N == 0) return 0;
  explain_summary_kernel<<<(unsigned)a.P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint8_t*>(mask), static_cast<const int64_t*>(total),
      static_cast<const int32_t*>(idx), comp_flags, k, static_cast<int32_t*>(feasible),
      static_cast<int32_t*>(reject), static_cast<int64_t*>(top_vals),
      static_cast<int32_t*>(top_idx), static_cast<int64_t*>(win));
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_explain_summary_args_size() { return (int64_t)sizeof(ScoreArgs); }

extern "C" const char* kt_explain_summary_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
