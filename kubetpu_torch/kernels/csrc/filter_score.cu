// filter_score: the one-shot Filter+Score of a batch, every pod against the
// same node state: the (P, N) mask, the (P, N) int64 base score (fit,
// balanced and image terms, weighted) and, when asked for, the (P, N) int64
// total (base plus the normalized node-affinity, taint, InterPodAffinity
// PodTopologySpread and DynamicResources terms).
//
// Replaces kubetpu/framework/runtime.py:1578 filter_score_batch (jit), i.e.
// :1471 feasible_and_scores with :1363 filter_components and :1356
// masked_normalize, and the vmapped kubetpu/ops/podaffinity.py:32
// affinity_filter_pod / :75 affinity_score_pod and kubetpu/ops/spread.py:40
// spread_filter_pod / :69 spread_score_pod (with :32 _domain_sums) inside
// them, which XLA fused into one device program. On the main path it is the parallel half
// of both engines: greedy_scan reads its mask (without the affinity
// filter, which moves with every assignment) and base score for every node
// that no earlier pod of the batch landed on; each batched round scores the
// whole batch with it against the round's state. The scan's start mask
// leaves out the affinity and spread filters, which move with every
// assignment.
//
// Bound: memory. Per pair the kernel reads a few int64 node rows and the
// pod's affinity slots, which stay in L2 across the pod axis; what must
// reach device memory is the (P, N) outputs (9 bytes a pair, 17 with the
// total), so the least time is those bytes over the card's bandwidth.
// Design (launches (0) and (0s) live in score_prelaunch.cuh, which
// filter_component_masks.cu shares): launch (0), only with affinity rows, sums each (RA, D) row over
// its domains (the self-affinity escape reads the total); launch (0s),
// only with a spread leaf, is one block per signature that sums its
// counts over eligible nodes into the (S, D+1) domain sums (slot D is
// domain -1's bucket) and reduces its minMatch over present domains;
// launch (a) is one thread per pair on a 2-D grid (x = nodes, y = pods),
// so neighbouring threads touch neighbouring node rows and the writes
// coalesce; launch (b), only when the total is asked for, is one block per
// pod that reduces the feasible maxima of the node-affinity and taint raw
// rows, the feasible min and max of the affinity raw score and, for a
// spread-scored pod, each soft slot's domain count `size` (a bitmap over
// the domains, in shared memory when it fits, else in global scratch) and
// the scored min and max of the rounded spread raw, and writes the total.
//
// With extender leaves the webhook's mask joins launch (a)'s verdict and its
// score the base, so launch (b)'s maxima run over the shrunk feasible set.
//
// Potential mode (the preemption evaluator's _potential_mask,
// kubetpu/framework/preemption.py:124, on a one-pod view): launch (a)
// writes, for each node, "every victim-independent filter passes (static
// row, PodTopologySpread, InterPodAffinity) and NodeResourcesFit or
// NodePorts fails" against the state given, and no score. The extender
// leaves play no part in it, as in the reference's filter_components.
#include "score_common.cuh"
#include "score_prelaunch.cuh"

namespace {

constexpr int kPairThreads = 256;
constexpr int kRowThreads = 512;

__global__ void filter_score_pairs(ScoreArgs a, uint8_t* mask, int64_t* base, int with_pa,
                                   int potential) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t p = blockIdx.y;
  if (n >= a.N) return;
  // the victim-independent filters first, then (normal mode) the
  // dependent ones
  bool ok = kt::pair_static(a, p, n);
  if (!potential && ok)
    ok = kt::pair_extender(a, p, n) &&
         kt::pair_dependent(a, p, n, a.requested, a.pod_count, a.node_ports);
  if (ok && with_pa && a.pa_filter)
    ok = kt::pa_feasible(a, a.pa_sums, kt::pa_escape(a, a.pa_row_total, p), p, n);
  if (ok && a.sp_filter) ok = kt::sp_feasible(a, a.sp_sums, a.sp_min_match, p, n);
  if (potential) {
    mask[p * a.N + n] =
        ok && !kt::pair_dependent(a, p, n, a.requested, a.pod_count, a.node_ports);
    return;
  }
  mask[p * a.N + n] = ok;
  base[p * a.N + n] = kt::base_score(a, p, n, a.requested, a.nonzero_requested);
}

// dynamic shared memory: C doubles of slot weights, then the domain bitmap
// when a.sp_bits is null. `phase` 0: the whole pass. Over a node mesh (each
// shard's rows), three passes with the shards' partials combined between
// them: 1 writes this shard's spread-scored counts and domain bitmaps
// (sc_buf (P,), bits_buf (P, C * W)); 2 takes the combined ones and writes
// this shard's normalize maxima (mx_buf (P, kNorm)); 3 takes the combined
// maxima and writes the total.
__global__ void filter_score_normalize(ScoreArgs a, const uint8_t* mask, const int64_t* base,
                                       int64_t* total, int phase, int64_t* sc_buf,
                                       int64_t* bits_buf, int64_t* mx_buf) {
  __shared__ int64_t s_m[kt::kNorm][33];
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int64_t p = blockIdx.x;
  const int64_t N = a.N;
  const bool sp_score = a.w_spread && kt::sp_any_soft(a, p);
  const bool normalize = a.na_raw != nullptr || a.tt_raw != nullptr || a.w_interpod ||
                         sp_score || a.dra_raw != nullptr;
  const int64_t row =
      (a.na_raw != nullptr || a.tt_raw != nullptr) ? (int64_t)a.score_sig[p] * N : 0;
  const int64_t drow = kt::dra_row(a, p);
  const uint8_t* m = mask + p * N;
  const int64_t CW = a.sp_C * ((a.sp_D + 31) / 32);
  double* weight = reinterpret_cast<double*>(s_dyn);
  if (phase == 1) {
    if (sp_score) kt::sp_partials(a, p, m, sc_buf + p, bits_buf + p * CW, s_m[0]);
    return;
  }
  if (sp_score) {
    if (phase == 0) {
      uint32_t* bits = a.sp_bits != nullptr
                           ? a.sp_bits + p * ((a.sp_D + 31) / 32)
                           : reinterpret_cast<uint32_t*>(s_dyn + a.sp_C * sizeof(double));
      kt::sp_weights(a, p, m, bits, weight, s_m[0]);
    } else {
      kt::sp_weights_given(a, p, sc_buf[p], bits_buf + p * CW, weight, s_m[0]);
    }
  }
  int64_t mx[kt::kNorm];
  kt::init_norm(mx);
  if (normalize && phase != 3) {
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      if (!m[n]) continue;
      const int64_t pa_r = a.w_interpod ? kt::pa_raw(a, a.pa_sums, p, n) : 0;
      kt::fold_norm(a, row, drow, n, pa_r,
                    kt::sp_scored_raw(a, sp_score, a.sp_counts, a.sp_sums, weight, p, n), mx);
    }
    kt::block_max_norm(a, sp_score, mx, s_m);
  }
  if (phase == 2) {
    if (threadIdx.x == 0)
      for (int i = 0; i < kt::kNorm; ++i) mx_buf[p * kt::kNorm + i] = mx[i];
    return;
  }
  if (phase == 3)
    for (int i = 0; i < kt::kNorm; ++i) mx[i] = mx_buf[p * kt::kNorm + i];
  for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
    int64_t s = base[p * N + n];
    if (normalize) {
      const bool ok = m[n];
      const int64_t pa_r = (ok && a.w_interpod) ? kt::pa_raw(a, a.pa_sums, p, n) : 0;
      const int64_t sp =
          ok ? kt::sp_scored_raw(a, sp_score, a.sp_counts, a.sp_sums, weight, p, n) : -1;
      s += kt::norm_terms(a, row, drow, n, ok, pa_r, sp, mx);
    }
    total[p * N + n] = s;
  }
}

}  // namespace

// Launches pass (0) when `dynamic` and the batch has affinity rows, pass
// (0s) when `dynamic` and the batch has a spread leaf, pass (a), and pass
// (b) when `total` is not null, on `stream`. Without `dynamic` the mask
// leaves out the InterPodAffinity and PodTopologySpread filters, the ones
// that move with each assignment (greedy_scan evaluates them per step).
// With `potential` the mask is the potential mode's (see above; `dynamic`
// is implied, `base` and `total` are not written and may be null).
// `smem` is pass (b)'s dynamic shared memory in bytes (at most 40 KiB).
// Returns the cudaError_t of the launches (0 = all were accepted); the
// caller raises on anything else.
extern "C" int kt_filter_score(const ScoreArgs* args, void* mask, void* base, void* total,
                               int dynamic, int potential, int64_t smem, void* stream) {
  ScoreArgs a = *args;
  if (potential) {
    dynamic = 1;
    total = nullptr;
    a.w_interpod = 0;
    a.w_spread = 0;
    a.ext_mask = nullptr;
    a.ext_score = nullptr;
  }
  const int pa = dynamic && a.pa_node_domain != nullptr;
  if (!pa) a.w_interpod = 0;
  const int sp = dynamic && a.sp_node_domain != nullptr;
  if (!sp) {
    a.sp_filter = 0;
    a.w_spread = 0;
  }
  if (a.P == 0 || a.N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = kt::prelaunch(a, pa, sp, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((a.N + kPairThreads - 1) / kPairThreads), (unsigned)a.P);
  filter_score_pairs<<<grid, kPairThreads, 0, s>>>(a, static_cast<uint8_t*>(mask),
                                                   static_cast<int64_t*>(base), pa, potential);
  err = cudaGetLastError();
  if (err != cudaSuccess || total == nullptr) return (int)err;
  filter_score_normalize<<<(unsigned)a.P, kRowThreads, (size_t)smem, s>>>(
      a, static_cast<const uint8_t*>(mask), static_cast<const int64_t*>(base),
      static_cast<int64_t*>(total), 0, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// The sharded filter_score of one node shard (kernel K2's first half; the
// batch's node rows are the shard's, its spread counts and bitmaps the
// shard's own). `step` 0: the shard's partial spread domain sums into
// a.sp_sums (the mesh sums them into every shard's a.sp_sums); 1: minMatch
// from the summed sums, the affinity row totals and pass (a), mask and base
// with every filter; 2, 3, 4: the normalize pass's phases 1, 2, 3
// (filter_score_normalize; sc (P,), bits (P, C * ceil(D / 32)) and mx (P,
// kNorm) int64 are combined over the shards between them). Returns the
// cudaError_t of the launches.
extern "C" int kt_filter_score_shard(const ScoreArgs* args, void* mask, void* base, void* total,
                                     int step, void* sc, void* bits, void* mx, int64_t smem,
                                     void* stream) {
  ScoreArgs a = *args;
  const int pa = a.pa_node_domain != nullptr;
  if (!pa) a.w_interpod = 0;
  const int sp = a.sp_node_domain != nullptr;
  if (!sp) {
    a.sp_filter = 0;
    a.w_spread = 0;
  }
  if (a.P == 0 || a.N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (step == 0) {
    if (sp && (a.sp_filter || a.w_spread) && a.sp_S > 0)
      kt::prelaunch_spread_sums<<<(unsigned)a.sp_S, kt::kPreRowThreads, 0, s>>>(a, 1);
    return (int)cudaGetLastError();
  }
  if (step == 1) {
    err = kt::prelaunch(a, pa, sp, s, 2);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((a.N + kPairThreads - 1) / kPairThreads), (unsigned)a.P);
    filter_score_pairs<<<grid, kPairThreads, 0, s>>>(a, static_cast<uint8_t*>(mask),
                                                     static_cast<int64_t*>(base), pa, 0);
    return (int)cudaGetLastError();
  }
  if (step < 2 || step > 4) return (int)cudaErrorInvalidValue;
  filter_score_normalize<<<(unsigned)a.P, kRowThreads, (size_t)smem, s>>>(
      a, static_cast<const uint8_t*>(mask), static_cast<const int64_t*>(base),
      static_cast<int64_t*>(total), step - 1, static_cast<int64_t*>(sc),
      static_cast<int64_t*>(bits), static_cast<int64_t*>(mx));
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_filter_score_args_size() { return (int64_t)sizeof(ScoreArgs); }

extern "C" const char* kt_filter_score_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
