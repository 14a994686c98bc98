// filter_component_masks: the per-plugin Filter verdicts of the pod rows a
// caller asks for, un-ANDed and packed: bit c of byte (u, n) is component
// c's verdict for requested row u at node n, in runtime.filter_components'
// order (static: node and pod valid, the static row; NodeResourcesFit;
// NodePorts; PodTopologySpread; InterPodAffinity). An absent component's
// bit is 0.
//
// Replaces kubetpu/sched/flightrecorder.py:146 _explain_masks_kernel (jit of
// runtime.filter_components(...)[:5]) and the filter_components calls of
// the extender bridge's filter and preempt verbs
// (kubetpu/bridge/server.py:170-173, :283-284). Fit charges every live
// nomination (the flags in a.nom_active). The callers read few rows: the
// recorder its unschedulable pods', the bridge row 0.
//
// Bound: memory, the (U, N) bytes written and the node rows read once.
// Design: the pre-launches of score_prelaunch.cuh that the present
// components need (the spread domain sums and minMatch, the affinity row
// totals), then one launch over (node tile, class) blocks. The requested
// rows are grouped by pod class on the host (runtime.POD_CLASS_KEY covers
// every pod leaf the pair function reads, so the rows of a class are
// equal): block (x, y) computes class y's representative against the
// nodes of tile x once, one byte a node into shared memory (neighbouring
// threads on neighbouring nodes), then writes the tile to every requested
// row of the class, 16 bytes a thread a store.
#include "score_common.cuh"
#include "score_prelaunch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxTile = 2048;

// the requested rows by class: class j's representative pod is reps[j] and
// its output rows are pos[start[j] .. start[j + 1]); a null plan means class
// j is pod first + j, written to row j (j < U)
struct Plan {
  const int32_t* reps;   // (C,)
  const int32_t* start;  // (C + 1,)
  const int32_t* pos;    // (U,)
};

__global__ void __launch_bounds__(kThreads, 1)
    component_bits(ScoreArgs a, Plan plan, int64_t C, int64_t first, int comp_flags,
                   int64_t TW, uint8_t* out) {
  __shared__ __align__(16) uint8_t s_bits[kMaxTile];
  const int64_t N = a.N;
  const int64_t n0 = (int64_t)blockIdx.x * TW;
  const int64_t width = n0 + TW < N ? TW : N - n0;
  const bool fit_on = (comp_flags >> 1) & 1, ports_on = (comp_flags >> 2) & 1;
  const bool sp_on = (comp_flags >> 3) & 1, pa_on = (comp_flags >> 4) & 1;
  const int64_t G = kt::nomination_slots(a);
  const int64_t chunks = (width + 15) / 16;
  for (int64_t c = blockIdx.y; c < C; c += gridDim.y) {
    const int64_t p = plan.reps == nullptr ? first + c : (int64_t)plan.reps[c];
    const bool escape = pa_on && kt::pa_escape(a, a.pa_row_total, p);
    for (int64_t i = threadIdx.x; i < width; i += kThreads) {
      const int64_t n = n0 + i;
      uint8_t v = kt::pair_static(a, p, n);
      if (fit_on || ports_on) {
        const int64_t charged = kt::nominated_count(a, p, n, G);
        if (fit_on)
          v |= (uint8_t)kt::pair_fit(a, p, n, a.requested, a.pod_count, charged, G) << 1;
        if (ports_on) v |= (uint8_t)kt::pair_ports(a, p, n, a.node_ports, charged, G) << 2;
      }
      if (sp_on) v |= (uint8_t)kt::sp_feasible(a, a.sp_sums, a.sp_min_match, p, n) << 3;
      if (pa_on) v |= (uint8_t)kt::pa_feasible(a, a.pa_sums, escape, p, n) << 4;
      s_bits[i] = v;
    }
    __syncthreads();
    const int64_t r0 = plan.reps == nullptr ? c : plan.start[c];
    const int64_t rows = plan.reps == nullptr ? 1 : plan.start[c + 1] - r0;
    for (int64_t e = threadIdx.x; e < rows * chunks; e += kThreads) {
      const int64_t u = plan.reps == nullptr ? c : (int64_t)plan.pos[r0 + e / chunks];
      const int64_t k = e % chunks;
      uint8_t* dst = out + u * N + n0 + 16 * k;
      if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && 16 * k + 16 <= width) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(s_bits + 16 * k);
      } else {
        const int64_t hi = 16 * k + 16 < width ? 16 : width - 16 * k;
        for (int64_t j = 0; j < hi; ++j) dst[j] = s_bits[16 * k + j];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches the pre-launches the present spread and affinity components
// need, then the bits launch, on `stream`. comp_flags bit c set when
// component c is present. The plan (see Plan) is plan_len int32 words on
// the host, reps then start then pos, copied to `plan_dev` first (null:
// class j is pod first + j, row j, and C = U); out (U, N) uint8, 16-byte
// aligned; TW the tile width in nodes, a multiple of 16 up to 2048.
// Returns the cudaError_t of the copy and launches (0 = all were accepted).
extern "C" int kt_filter_component_masks(const ScoreArgs* args, const void* plan_host,
                                         int64_t plan_len, void* plan_dev, int64_t C, int64_t U,
                                         int64_t first, int comp_flags, int64_t TW, void* out,
                                         void* stream) {
  ScoreArgs a = *args;
  if (U == 0 || a.N == 0) return 0;
  if (C <= 0 || TW <= 0 || TW % 16 != 0 || TW > kMaxTile ||
      (plan_host == nullptr && (C != U || first < 0 || first + U > a.P)) ||
      (plan_host != nullptr && plan_len != 2 * C + 1 + U))
    return (int)cudaErrorInvalidValue;
  const int pa = (comp_flags >> 4) & 1, sp = (comp_flags >> 3) & 1;
  a.w_interpod = 0;
  a.w_spread = 0;
  a.sp_filter = sp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan plan{nullptr, nullptr, nullptr};
  if (plan_host != nullptr) {
    cudaError_t err = cudaMemcpyAsync(plan_dev, plan_host, 4 * plan_len,
                                      cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return (int)err;
    const auto* w = static_cast<const int32_t*>(plan_dev);
    plan = Plan{w, w + C, w + 2 * C + 1};
  }
  cudaError_t err = kt::prelaunch(a, pa, sp, s);
  if (err != cudaSuccess) return (int)err;
  const int64_t T = (a.N + TW - 1) / TW;
  if (T > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const unsigned gy = (unsigned)(C < 65535 ? C : 65535);
  component_bits<<<dim3((unsigned)T, gy), kThreads, 0, s>>>(
      a, plan, C, first, comp_flags, TW, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_filter_component_masks_args_size() { return (int64_t)sizeof(ScoreArgs); }

extern "C" const char* kt_filter_component_masks_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
