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
// Pod classes: every output of a pod depends on the pod only through its
// class (runtime.py POD_CLASS_KEY; the pods of a class are equal in every
// pod-indexed input), except `win`, which reads the class's total at the
// pod's own assignment. So the work runs on the C class representatives
// (reps; every pod its own class when reps is null) and never on (P, N)
// rows:
//   (0), (0s)  filter_score's pre-launches (score_prelaunch.cuh): the
//              affinity row totals, the spread domain sums and minMatch;
//   (a)        filter_score's pair pass (kt::pair_pass) of each class's
//              representative into a (C, N) mask and base scratch, in
//              64-thread blocks so that one class's nodes spread over SMs;
//   (b)        filter_score's normalize pass (kt::normalize_pass) of each
//              class, writing the (C, N) total over the base in place;
//   (e)        one block a (class, node tile): each thread walks its nodes
//              once, and for each valid one takes the feasible bit, the five
//              component verdicts through the pair function's helpers
//              (pair_static, pair_fit, pair_ports, sp_feasible, pa_feasible:
//              the filter's exact parts) and, when feasible, offers its total
//              to a top-3 list of (score, node) kept best first; the counts
//              and lists merge by warp shuffles, then across the block, into
//              one 64-byte partial a tile. The last block of a class (an
//              atomic ticket) merges the class's partials into its summary
//              and writes it to every pod of the class, with each pod's win.
// The top-3 order is (higher score, then lower node), a total order on
// distinct nodes, so a merge in any grouping gives the three masked
// first-max passes' answer; a slot left empty (fewer than three feasible
// nodes) is (-2^62, node 0), which is what those passes give there.
//
// Bound: the pair work on C x N pairs (the float64 of the total) and the
// bytes of the (C, N) rows written and read back once, the node block read
// once, 40 bytes a pod written; on one class (SchedulingBasic) the five
// launches are latency.
#include "filter_pass.cuh"
#include "score_prelaunch.cuh"

namespace {

constexpr int kPairThreads = 64;
constexpr int kRowThreads = 512;
constexpr int kClassRowThreads = 1024;
constexpr int kFewClasses = 132;
constexpr int kTileThreads = 128;
constexpr int kWarps = kTileThreads / 32;
constexpr int kTop = 3;
// pods a thread of a class's last block writes at a time
constexpr int kPods = 4;
constexpr int64_t kNeg = -(1LL << 62);

// a tile's (and, merged, a class's) counts and top 3; idx -1 is an empty slot
struct Partial {
  int32_t feas;
  int32_t rej[5];
  int64_t val[kTop];
  int32_t idx[kTop];
  int32_t pad;
};
static_assert(sizeof(Partial) == 64, "a partial is 64 bytes");

__device__ __forceinline__ int64_t rep_of_class(const int32_t* reps, int64_t c) {
  return reps == nullptr ? c : (int64_t)reps[c];
}

// (score, node) before (bs, bn) in the top-3 order; node < 0 is empty
__device__ __forceinline__ bool better(int64_t s, int32_t n, int64_t bs, int32_t bn) {
  if (n < 0) return false;
  if (bn < 0) return true;
  return s > bs || (s == bs && n < bn);
}

struct Top3 {
  int64_t v[kTop];
  int32_t i[kTop];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < kTop; ++j) {
      v[j] = kNeg;
      i[j] = -1;
    }
  }

  __device__ __forceinline__ void push(int64_t s, int32_t n) {
    if (!better(s, n, v[2], i[2])) return;
    if (!better(s, n, v[1], i[1])) {
      v[2] = s;
      i[2] = n;
    } else {
      v[2] = v[1];
      i[2] = i[1];
      if (better(s, n, v[0], i[0])) {
        v[1] = v[0];
        i[1] = i[0];
        v[0] = s;
        i[0] = n;
      } else {
        v[1] = s;
        i[1] = n;
      }
    }
  }
};

// Every thread's counts (feas, rej[5]) and list merged over the block;
// thread 0 holds the result. s: kWarps partials of shared scratch.
__device__ __forceinline__ void block_merge(int32_t* cnt, Top3& top, Partial* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 6; ++c) cnt[c] += __shfl_down_sync(0xffffffffu, cnt[c], off);
    int64_t ov[kTop];
    int32_t oi[kTop];
#pragma unroll
    for (int j = 0; j < kTop; ++j) {
      ov[j] = __shfl_down_sync(0xffffffffu, top.v[j], off);
      oi[j] = __shfl_down_sync(0xffffffffu, top.i[j], off);
    }
#pragma unroll
    for (int j = 0; j < kTop; ++j) top.push(ov[j], oi[j]);
  }
  if (lane == 0) {
    s[warp].feas = cnt[0];
#pragma unroll
    for (int c = 0; c < 5; ++c) s[warp].rej[c] = cnt[c + 1];
#pragma unroll
    for (int j = 0; j < kTop; ++j) {
      s[warp].val[j] = top.v[j];
      s[warp].idx[j] = top.i[j];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      cnt[0] += s[w].feas;
#pragma unroll
      for (int c = 0; c < 5; ++c) cnt[c + 1] += s[w].rej[c];
#pragma unroll
      for (int j = 0; j < kTop; ++j) top.push(s[w].val[j], s[w].idx[j]);
    }
  }
}

// pass (a): class y's representative against nodes of block x, into row y
__global__ void class_pairs(ScoreArgs a, const int32_t* reps, uint8_t* mask, int64_t* base, int with_pa) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t c = blockIdx.y;
  if (n >= a.N) return;
  kt::pair_pass(a, rep_of_class(reps, c), n, with_pa, 0, mask + c * a.N + n,
                base + c * a.N + n);
}

// pass (b): class x's total over its base row, in place
__global__ void __launch_bounds__(1024)
    class_normalize(ScoreArgs a, const int32_t* reps, const uint8_t* mask, int64_t* total) {
  __shared__ int64_t s_m[kt::kNorm][33];
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int64_t c = blockIdx.x, N = a.N;
  kt::normalize_pass(a, rep_of_class(reps, c), mask + c * N, total + c * N, total + c * N, 0,
                     nullptr, nullptr, nullptr, s_dyn, s_m);
}

struct Outputs {
  int32_t* feasible;  // (P,)
  int32_t* reject;    // (5, P), rows of absent components untouched
  int64_t* top_vals;  // (P, k)
  int32_t* top_idx;   // (P, k)
  int64_t* win;       // (P,)
};

// pass (e): block (x, y) takes class y's nodes [x TW, x TW + TW)
__global__ void __launch_bounds__(kTileThreads)
    explain_tiles(ScoreArgs a, const int32_t* reps, const int32_t* class_of, int64_t TW,
                  const uint8_t* mask, const int64_t* total, const int32_t* idx, int comp_flags,
                  int k, Partial* parts, unsigned int* tickets, Outputs out) {
  __shared__ Partial s_part[kWarps];
  __shared__ bool s_last;
  const int64_t c = blockIdx.y, t = blockIdx.x, T = gridDim.x, N = a.N, P = a.P;
  const int64_t p = rep_of_class(reps, c);
  const uint8_t* m = mask + c * N;
  const int64_t* tot = total + c * N;
  const bool pa_on = (comp_flags >> 4) & 1;
  const bool escape = pa_on && kt::pa_escape(a, a.pa_row_total, p);
  const int64_t G = kt::nomination_slots(a);
  int32_t cnt[6] = {0, 0, 0, 0, 0, 0};
  Top3 top;
  top.clear();
  const int64_t hi = (t + 1) * TW < N ? (t + 1) * TW : N;
  for (int64_t n = t * TW + threadIdx.x; n < hi; n += blockDim.x) {
    if (!a.node_valid[n]) continue;
    const bool f = m[n];
    cnt[0] += f;
    const int64_t charged = kt::nominated_count(a, p, n, G);
    cnt[1] += !kt::pair_static(a, p, n);
    if ((comp_flags >> 1) & 1)
      cnt[2] += !kt::pair_fit(a, p, n, a.requested, a.pod_count, charged, G);
    if ((comp_flags >> 2) & 1) cnt[3] += !kt::pair_ports(a, p, n, a.node_ports, charged, G);
    if ((comp_flags >> 3) & 1) cnt[4] += !kt::sp_feasible(a, a.sp_sums, a.sp_min_match, p, n);
    if (pa_on) cnt[5] += !kt::pa_feasible(a, a.pa_sums, escape, p, n);
    if (f && tot[n] > kNeg) top.push(tot[n], (int32_t)n);
  }
  block_merge(cnt, top, s_part);
  if (threadIdx.x == 0) {
    Partial& w = parts[c * T + t];
    w.feas = cnt[0];
    for (int q = 0; q < 5; ++q) w.rej[q] = cnt[q + 1];
    for (int j = 0; j < kTop; ++j) {
      w.val[j] = top.v[j];
      w.idx[j] = top.i[j];
    }
    __threadfence();
    s_last = atomicAdd(tickets + c, 1u) == (unsigned int)(T - 1);
  }
  __syncthreads();
  if (!s_last) return;
  // the class's last block: every tile's partial is written and fenced
  __threadfence();
  for (int q = 0; q < 6; ++q) cnt[q] = 0;
  top.clear();
  for (int64_t u = threadIdx.x; u < T; u += blockDim.x) {
    const Partial* w = parts + c * T + u;
    cnt[0] += __ldcg(&w->feas);
    for (int q = 0; q < 5; ++q) cnt[q + 1] += __ldcg(&w->rej[q]);
    for (int j = 0; j < kTop; ++j)
      top.push((int64_t)__ldcg(reinterpret_cast<const long long*>(&w->val[j])),
               __ldcg(&w->idx[j]));
  }
  __syncthreads();
  block_merge(cnt, top, s_part);
  __shared__ Partial s_sum;
  if (threadIdx.x == 0) {
    s_sum.feas = cnt[0];
    for (int q = 0; q < 5; ++q) s_sum.rej[q] = cnt[q + 1];
    for (int j = 0; j < kTop; ++j) {
      s_sum.val[j] = top.i[j] < 0 ? kNeg : top.v[j];
      s_sum.idx[j] = top.i[j] < 0 ? 0 : top.i[j];
    }
  }
  __syncthreads();
  // the pods of class c (pod c alone without classes), kPods a thread at
  // a time: their class and assignment loads, then their win loads, are
  // issued together before any store
  const int64_t first = class_of == nullptr ? c : 0;
  const int64_t last = class_of == nullptr ? c + 1 : P;
  for (int64_t q0 = first + threadIdx.x; q0 < last; q0 += kPods * blockDim.x) {
    bool mine[kPods];
    int64_t at[kPods];
#pragma unroll
    for (int u = 0; u < kPods; ++u) {
      const int64_t q = q0 + u * blockDim.x;
      mine[u] = q < last && (class_of == nullptr || class_of[q] == c);
      at[u] = mine[u] && idx[q] > 0 ? idx[q] : 0;
    }
    int64_t wv[kPods];
#pragma unroll
    for (int u = 0; u < kPods; ++u) wv[u] = mine[u] ? tot[at[u]] : 0;
#pragma unroll
    for (int u = 0; u < kPods; ++u) {
      if (!mine[u]) continue;
      const int64_t q = q0 + u * blockDim.x;
      out.feasible[q] = s_sum.feas;
      for (int r = 0; r < 5; ++r)
        if ((comp_flags >> r) & 1) out.reject[r * P + q] = s_sum.rej[r];
      for (int j = 0; j < k; ++j) {
        out.top_vals[q * k + j] = s_sum.val[j];
        out.top_idx[q * k + j] = s_sum.idx[j];
      }
      out.win[q] = wv[u];
    }
  }
}

}  // namespace

// The scratch of kt_explain_summary: the (C, N) mask, the (C, N) int64
// base and total, C x T partials and C tickets, each from a 16-byte
// boundary. kubetpu_torch.kernels._explain_scratch mirrors it.
static int64_t r16(int64_t x) { return (x + 15) / 16 * 16; }

// Launches the summary on `stream`: (0s) and (0) as filter_score's dynamic
// launch does, then (a), (b) and (e) on the C classes. reps (C,) int32 the
// classes' representatives and class_of (P,) int32 each pod's class, both
// null when every pod is its own class (C = P); idx (P,) int32 the
// engine's assignments (-1 = none); comp_flags bit c set when component c
// (static, fit, ports_ok, spread_ok, pa_ok) is present; k = min(3, N); TW
// the tile width in nodes; scratch as laid out above; smem pass (b)'s
// dynamic shared memory. feasible (P,), reject (5, P), top_idx (P, k)
// int32, top_vals (P, k) and win (P,) int64. Returns the cudaError_t of
// the launches (0 = all were accepted).
extern "C" int kt_explain_summary(const ScoreArgs* args, const void* reps, const void* class_of,
                                  int64_t C, const void* idx, int comp_flags, int k, int64_t TW,
                                  void* scratch, int64_t smem, void* feasible, void* reject,
                                  void* top_vals, void* top_idx, void* win, void* stream) {
  ScoreArgs a = *args;
  const int pa = a.pa_node_domain != nullptr;
  if (!pa) a.w_interpod = 0;
  const int sp = a.sp_node_domain != nullptr;
  if (!sp) {
    a.sp_filter = 0;
    a.w_spread = 0;
  }
  if (a.P == 0 || a.N == 0) return 0;
  if (C <= 0 || C > a.P || TW <= 0 || (reps == nullptr) != (class_of == nullptr) ||
      (reps == nullptr && C != a.P))
    return (int)cudaErrorInvalidValue;
  const int64_t N = a.N, T = (N + TW - 1) / TW;
  if (T > 0x7fffffff || C > 65535) return (int)cudaErrorInvalidValue;
  auto* base = static_cast<unsigned char*>(scratch);
  auto* mask = base;
  auto* total = reinterpret_cast<int64_t*>(base + r16(C * N));
  auto* parts = reinterpret_cast<Partial*>(base + r16(C * N) + r16(8 * C * N));
  auto* tickets =
      reinterpret_cast<unsigned int*>(base + r16(C * N) + r16(8 * C * N) + r16(64 * C * T));
  const auto* r = static_cast<const int32_t*>(reps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(tickets, 0, 4 * C, s);
  if (err != cudaSuccess) return (int)err;
  err = kt::prelaunch(a, pa, sp, s);
  if (err != cudaSuccess) return (int)err;
  class_pairs<<<dim3((unsigned)((N + kPairThreads - 1) / kPairThreads), (unsigned)C),
                kPairThreads, 0, s>>>(a, r, mask, total, pa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  class_normalize<<<(unsigned)C, C < kFewClasses ? kClassRowThreads : kRowThreads, (size_t)smem,
                    s>>>(a, r, mask, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Outputs out{static_cast<int32_t*>(feasible), static_cast<int32_t*>(reject),
                    static_cast<int64_t*>(top_vals), static_cast<int32_t*>(top_idx),
                    static_cast<int64_t*>(win)};
  explain_tiles<<<dim3((unsigned)T, (unsigned)C), kTileThreads, 0, s>>>(
      a, r, static_cast<const int32_t*>(class_of), TW, mask, total,
      static_cast<const int32_t*>(idx), comp_flags, k, parts, tickets, out);
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_explain_summary_args_size() { return (int64_t)sizeof(ScoreArgs); }

extern "C" const char* kt_explain_summary_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
