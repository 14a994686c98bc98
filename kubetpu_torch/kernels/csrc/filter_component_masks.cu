// filter_component_masks: the per-plugin Filter masks of a batch, un-ANDed:
// static (node and pod valid, the static row), NodeResourcesFit, NodePorts,
// PodTopologySpread and InterPodAffinity, each a (P, N) bool mask.
//
// Replaces kubetpu/sched/flightrecorder.py:146 _explain_masks_kernel (jit of
// runtime.filter_components(...)[:5]) and the filter_components calls of
// the extender bridge's filter and preempt verbs
// (kubetpu/bridge/server.py:170-173, :283-284). Fit charges every live
// nomination (the flags in a.nom_active).
//
// Bound: memory, the (P, N) masks written (1 byte a pair for each present
// component). Design: the pre-launches of score_prelaunch.cuh (the spread
// domain sums and minMatch, the affinity row totals), then one thread per
// pair on a 2-D grid (x = nodes, y = pods), as filter_score's pair launch,
// computing each present component with the pair function's helpers and
// writing it; an absent component's pointer is null and is not written.
#include "score_common.cuh"
#include "score_prelaunch.cuh"

namespace {

constexpr int kPairThreads = 256;

__global__ void component_masks_kernel(ScoreArgs a, uint8_t* st, uint8_t* fit, uint8_t* ports,
                                       uint8_t* spread, uint8_t* pa) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t p = blockIdx.y;
  if (n >= a.N) return;
  const int64_t i = p * a.N + n;
  st[i] = kt::pair_static(a, p, n);
  if (fit != nullptr || ports != nullptr) {
    const int64_t G = kt::nomination_slots(a);
    const int64_t charged = kt::nominated_count(a, p, n, G);
    if (fit != nullptr) fit[i] = kt::pair_fit(a, p, n, a.requested, a.pod_count, charged, G);
    if (ports != nullptr) ports[i] = kt::pair_ports(a, p, n, a.node_ports, charged, G);
  }
  if (spread != nullptr) spread[i] = kt::sp_feasible(a, a.sp_sums, a.sp_min_match, p, n);
  if (pa != nullptr)
    pa[i] = kt::pa_feasible(a, a.pa_sums, kt::pa_escape(a, a.pa_row_total, p), p, n);
}

}  // namespace

// Launches the pre-launches the present spread and affinity masks need,
// then the pair launch, on `stream`. `st` (P, N) is always written; `fit`,
// `ports`, `spread`, `pa` only when not null. Returns the cudaError_t of
// the launches (0 = all were accepted).
extern "C" int kt_filter_component_masks(const ScoreArgs* args, void* st, void* fit,
                                         void* ports, void* spread, void* pa, void* stream) {
  ScoreArgs a = *args;
  if (a.P == 0 || a.N == 0) return 0;
  a.w_interpod = 0;
  a.w_spread = 0;
  a.sp_filter = spread != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = kt::prelaunch(a, pa != nullptr, spread != nullptr, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((a.N + kPairThreads - 1) / kPairThreads), (unsigned)a.P);
  component_masks_kernel<<<grid, kPairThreads, 0, s>>>(
      a, static_cast<uint8_t*>(st), static_cast<uint8_t*>(fit), static_cast<uint8_t*>(ports),
      static_cast<uint8_t*>(spread), static_cast<uint8_t*>(pa));
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_filter_component_masks_args_size() { return (int64_t)sizeof(ScoreArgs); }

extern "C" const char* kt_filter_component_masks_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
