// Filter verdict and raw plugin scores of ONE (pod, node) pair, shared by
// the filter_score, greedy_scan and batched_round kernels so they cannot
// drift apart.
//
// Replaces, fused per pair, the jitted jnp compositions of the JAX package:
//   kubetpu/ops/filters.py:22 resource_fit_mask (+ :76 the single-pod form)
//     and :43 resource_fit_mask_nominated (the nominator's reservations:
//     the requests and a pod slot of every live nomination whose gate
//     admits the pod, charged at its nominated node)
//   kubetpu/framework/runtime.py:1412 the NodePorts conflict contraction,
//     with :1422-1443 the nominated pods' host ports
//   kubetpu/ops/scores.py:53 / :82 / :121 the three fit strategies
//     (+ :101 _trunc_div, :108 broken_linear, :21 _weighted_mean)
//   kubetpu/ops/scores.py:174 balanced_allocation_score (+ :156 _balanced_std)
//   kubetpu/ops/scores.py:215 default_normalize, :227 image_locality_score
//   kubetpu/ops/podaffinity.py:24 _slot_counts, :32 affinity_filter_pod,
//     :75 affinity_score_pod (InterPodAffinity: gathers from the carried
//     (R, D) sums at the node's domain, and the min-max normalize in f64)
//   kubetpu/ops/spread.py:32 _domain_sums, :40 spread_filter_pod, :69
//     spread_score_pod (PodTopologySpread: per-signature domain sums of the
//     carried (S, N) counts, the skew verdict against minMatch, and the
//     log-weighted raw score with its normalize)
//   kubetpu/framework/runtime.py:1509-1512 and :1571-1574 the extender
//     terms: the webhook's (P, N) mask joins the Filter verdict (so every
//     normalize runs over the shrunk feasible set) and its pre-weighted
//     (P, N) score is added to the total (int64 sums are exact, so adding
//     it with the base terms equals the reference's adding it last)
//   kubetpu/framework/runtime.py:1563-1570 the DynamicResources score
//     term: the pod's prioritized-list raw row, gathered by its signature
//     from the (S5, N) table, DefaultNormalizeScore over the feasible set
//     (as the node-affinity term), weighted by w_dra
//
// Exactness: every integer is int64 as in the reference (which runs with
// jax x64). `//` in the reference floors; C++ `/` truncates, so floordiv()
// is used wherever the reference floors. The balanced score is float64 with
// explicitly rounded intrinsics (__dadd_rn, __dmul_rn, __ddiv_rn,
// __dsqrt_rn): no fused multiply-add can change a rounding, and the sums
// over R run in index order, as the plain PyTorch version's loop does. The
// affinity normalize, 100 * (raw - min) / (max - min) truncated to int64, is
// float64 through the same intrinsics. The spread raw score is
// cnt * log(size + 2) + (maxSkew - 1) as a rounded multiply then a rounded
// add (__dmul_rn, __dadd_rn), summed over the pod's slots in slot order, and
// rounded half to even (__double2ll_rn, as jnp.round / torch.round; not
// round() or llround(), which round half away from zero). log() of a double
// is libdevice's, the same function torch's CUDA log calls.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Mirror of ScoreArgs in kubetpu_torch/kernels/__init__.py: every field is
// 8 bytes wide, so the layout has no padding to disagree about.
struct ScoreArgs {
  // node block, N rows
  const int64_t* alloc;              // (N, R)
  const int64_t* requested;          // (N, R) exact
  const int64_t* nonzero_requested;  // (N, R) scoring view
  const int32_t* pod_count;          // (N,)
  const int32_t* allowed_pods;       // (N,)
  const uint8_t* node_valid;         // (N,)
  const uint8_t* node_ports;         // (N, K)
  // pod block, P rows
  const int64_t* requests;           // (P, R) exact
  const int64_t* nonzero_requests;   // (P, R)
  const uint8_t* pod_valid;          // (P,)
  const uint8_t* pod_ports;          // (P, K)
  const uint8_t* port_conflict;      // (K, K)
  // signature-compressed static rows; a null pointer = leaf absent
  const uint8_t* static_mask;        // (S, N)
  const int32_t* static_sig;         // (P,)
  const int64_t* na_raw;             // (S2, N), null when unweighted
  const int64_t* tt_raw;             // (S2, N), null when unweighted
  const int32_t* score_sig;          // (P,)
  const int64_t* img_sums;           // (S3, N), null when unweighted
  const int32_t* img_sig;            // (P,)
  const int32_t* img_count;          // (P,)
  // fit_w[R], bal_w[R], is_scalar[R], shape_x[B], shape_y[B]
  const int64_t* params;
  int64_t P, N, R, K, B;
  int64_t strategy;                  // 0 least, 1 most, 2 requested-to-capacity
  int64_t w_fit, w_balanced, w_na, w_taint, w_image;
  int64_t filter_fit, filter_ports;
  // InterPodAffinity rows (kubetpu_torch.framework.runtime.PodAffinityDevice);
  // pa_node_domain is null when the batch has no podaffinity leaf
  const int32_t* pa_node_domain;     // (RA, N), -1 = key absent
  const uint8_t* pa_has_key;         // (RA, N)
  const int64_t* pa_sums;            // (RA, D) the sums the verdict reads
  int64_t* pa_row_total;             // (RA,) scratch: sum over D of pa_sums
  const int64_t* pa_update;          // (P, RA)
  const int32_t* pa_fa_rows;         // (P, CA), -1 = unused slot
  const uint8_t* pa_fa_self;         // (P,)
  const int32_t* pa_ra_rows;         // (P, CR)
  const int32_t* pa_ea_rows;         // (P, CE)
  const int32_t* pa_score_rows;      // (P, CS)
  const int64_t* pa_score_vals;      // (P, CS)
  int64_t pa_R, pa_D, pa_CA, pa_CR, pa_CE, pa_CS;
  int64_t pa_filter;                 // filter_interpod and has_filter_work
  int64_t w_interpod;                // 0 unless w_interpod and has_score_work
  // PodTopologySpread (kubetpu_torch.framework.runtime.SpreadDevice);
  // sp_node_domain is null when the batch has no spread leaf
  const uint8_t* sp_eligible;        // (S, N)
  const int32_t* sp_node_domain;     // (S, N), -1 = not a counted domain
  const uint8_t* sp_has_key;         // (S, N)
  const uint8_t* sp_domain_present;  // (S, D)
  const int32_t* sp_num_domains;     // (S,)
  const uint8_t* sp_is_hostname;     // (S,)
  const int32_t* sp_counts;          // (S, N) the counts the verdicts read
  int64_t* sp_sums;                  // (S, D+1) scratch: domain sums; D = -1's bucket
  int64_t* sp_min_match;             // (S,) scratch: min sum over present domains
  const int32_t* sp_sig_idx;         // (P, C), -1 = unused slot
  const int8_t* sp_action;           // (P, C) 0 DoNotSchedule, 1 ScheduleAnyway
  const int32_t* sp_max_skew;        // (P, C)
  const int32_t* sp_min_domains;     // (P, C)
  const int32_t* sp_self_match;      // (P, C)
  const uint8_t* sp_pod_match_sig;   // (P, S)
  const uint8_t* sp_ignored;         // (P, N)
  uint32_t* sp_bits;                 // domain bitmaps in global memory, null
                                     // when they fit in shared memory
  int64_t sp_S, sp_D, sp_C;
  int64_t sp_filter;                 // filter_spread and has_hard
  int64_t w_spread;                  // 0 unless w_spread and has_soft
  // nominator reservations (kubetpu_torch.framework.runtime.DeviceBatch's
  // nominated_* leaves); nom_node is null without nominations
  const int32_t* nom_node;           // (G,) nominated node, -1 = none
  const int64_t* nom_req;            // (G, R)
  const uint8_t* nom_gate;           // (P, G) nomination g charges pod p
  const uint8_t* nom_ports;          // (G, K), null when absent
  const int32_t* nom_pod_idx;        // (G,) the nominee's batch index, -1 = none
  uint8_t* nom_active;               // (G,) the nominations still charged;
                                     // the engines clear a nominee's entry
                                     // when they assign it
  int64_t G;
  // extender webhook verdicts (DeviceBatch.extender_mask / extender_score);
  // both null without extenders
  const uint8_t* ext_mask;           // (P, N)
  const int64_t* ext_score;          // (P, N) weight * 10 * raw, pre-scaled
  // DynamicResources prioritized-list raw rows (DeviceBatch.dra_score_raw /
  // dra_score_sig); dra_raw is null without the leaf or when w_dra is 0
  const int64_t* dra_raw;            // (S5, N)
  const int32_t* dra_sig;            // (P,)
  int64_t w_dra;
};

namespace kt {

constexpr int64_t kMaxNodeScore = 100;
constexpr int kNorm = 7;                     // values fold_norm reduces
constexpr int64_t kBig = 2147483647;         // spread.py's _BIG (int32 max)

// floor division for b > 0 (the reference's `//`), with one division
// (the remainder from the quotient)
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a < 0 && q * b != a) ? q - 1 : q;
}

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// Go's truncating division, as kubetpu/ops/scores.py:101 _trunc_div writes it
__device__ __forceinline__ int64_t trunc_div(int64_t a, int64_t b) {
  int64_t ab = a < 0 ? -a : a;
  int64_t bb = b < 0 ? -b : b;
  int64_t q = ab / (bb > 1 ? bb : 1);
  return ((a < 0) != (b < 0)) ? -q : q;
}

// helper.BuildBrokenLinearFunction over the bracket (xs strictly increasing)
__device__ __forceinline__ int64_t broken_linear(int64_t p, const int64_t* xs,
                                                 const int64_t* ys, int64_t B) {
  int64_t idx = 0;  // first i with xs[i] >= p (searchsorted, side="left")
  while (idx < B && xs[idx] < p) ++idx;
  if (idx == 0) return ys[0];
  if (idx >= B) return ys[B - 1];
  int64_t x0 = xs[idx - 1], y0 = ys[idx - 1], x1 = xs[idx], y1 = ys[idx];
  return y0 + trunc_div((y1 - y0) * (p - x0), x1 - x0);
}

// Pod p's own inputs as the pair function reads them: straight from the
// batch's (P, ·) leaves. The greedy scan reads the same values from a copy
// it staged in shared memory (scan_loop.cuh StagedPod, the same members).
// The (P, N) and (P, G) leaves (extender terms, nomination gates) are read
// at row `p` in both.
struct PodAt {
  const ScoreArgs& a;
  int64_t p;
  __device__ __forceinline__ int64_t req(int64_t r) const { return a.requests[p * a.R + r]; }
  __device__ __forceinline__ int64_t nzr(int64_t r) const {
    return a.nonzero_requests[p * a.R + r];
  }
  __device__ __forceinline__ bool port(int64_t k) const { return a.pod_ports[p * a.K + k]; }
  __device__ __forceinline__ bool valid() const { return a.pod_valid[p]; }
  // offsets of the pod's rows in the signature tables (read only when the
  // table is present)
  __device__ __forceinline__ int64_t static_row() const {
    return (int64_t)a.static_sig[p] * a.N;
  }
  __device__ __forceinline__ int64_t img_row() const { return (int64_t)a.img_sig[p] * a.N; }
  __device__ __forceinline__ int64_t img_count() const { return a.img_count[p]; }
  __device__ __forceinline__ const int64_t* params() const { return a.params; }
};

// the victim-independent static verdict: node and pod valid, static row
template <class Q>
__device__ __forceinline__ bool pair_static_of(const ScoreArgs& a, const Q& q, int64_t n) {
  if (!a.node_valid[n] || !q.valid()) return false;
  return a.static_mask == nullptr || a.static_mask[q.static_row() + n];
}

__device__ __forceinline__ bool pair_static(const ScoreArgs& a, int64_t p, int64_t n) {
  return pair_static_of(a, PodAt{a, p}, n);
}

// nomination g is charged to pod p at node n: its gate admits p, it is
// still live, and n is its nominated node
__device__ __forceinline__ bool nominated_here(const ScoreArgs& a, int64_t p, int64_t n,
                                               int64_t g) {
  return a.nom_gate[p * a.G + g] && a.nom_active[g] && a.nom_node[g] == n;
}

// does any of pod q's triples conflict with triple row `ports` (K,)?
template <class Q>
__device__ __forceinline__ bool ports_conflict(const ScoreArgs& a, const Q& q,
                                               const uint8_t* ports) {
  const int64_t K = a.K;
  for (int64_t k = 0; k < K; ++k) {
    if (!q.port(k)) continue;
    for (int64_t l = 0; l < K; ++l)
      if (a.port_conflict[k * K + l] && ports[l]) return true;
  }
  return false;
}

// the number of nomination slots (0 without nominations)
__device__ __forceinline__ int64_t nomination_slots(const ScoreArgs& a) {
  return a.nom_node != nullptr ? a.G : 0;
}

// the number of live nominations at node n that pod p must make room for,
// among the first G slots
__device__ __forceinline__ int64_t nominated_count(const ScoreArgs& a, int64_t p, int64_t n,
                                                   int64_t G) {
  int64_t charged = 0;
  for (int64_t g = 0; g < G; ++g) charged += nominated_here(a, p, n, g);
  return charged;
}

// NodeResourcesFit against the node state given, with the `charged` live
// nominations at node n (of the first G slots) charged (integer sums: the
// reference's f64 contraction of integers below 2^53 is exact)
template <class Q>
__device__ __forceinline__ bool pair_fit_of(const ScoreArgs& a, const Q& pod, int64_t n,
                                            const int64_t* req_state, const int32_t* pc_state,
                                            int64_t charged, int64_t G) {
  const int64_t R = a.R;
  if (!(pc_state[n] + 1 + charged <= a.allowed_pods[n])) return false;
  for (int64_t r = 0; r < R; ++r) {
    const int64_t q = pod.req(r);
    if (q == 0) continue;
    int64_t extra = 0;
    if (charged)
      for (int64_t g = 0; g < G; ++g)
        if (nominated_here(a, pod.p, n, g)) extra += a.nom_req[g * R + r];
    if (q > a.alloc[n * R + r] - req_state[n * R + r] - extra) return false;
  }
  return true;
}

__device__ __forceinline__ bool pair_fit(const ScoreArgs& a, int64_t p, int64_t n,
                                         const int64_t* req_state, const int32_t* pc_state,
                                         int64_t charged, int64_t G) {
  return pair_fit_of(a, PodAt{a, p}, n, req_state, pc_state, charged, G);
}

// NodePorts against the in-use triples given, and the host ports of the
// `charged` live nominations at node n (of the first G slots)
template <class Q>
__device__ __forceinline__ bool pair_ports_of(const ScoreArgs& a, const Q& q, int64_t n,
                                              const uint8_t* ports_state, int64_t charged,
                                              int64_t G) {
  if (ports_conflict(a, q, ports_state + n * a.K)) return false;
  if (charged && a.nom_ports != nullptr)
    for (int64_t g = 0; g < G; ++g)
      if (nominated_here(a, q.p, n, g) && ports_conflict(a, q, a.nom_ports + g * a.K))
        return false;
  return true;
}

__device__ __forceinline__ bool pair_ports(const ScoreArgs& a, int64_t p, int64_t n,
                                           const uint8_t* ports_state, int64_t charged,
                                           int64_t G) {
  return pair_ports_of(a, PodAt{a, p}, n, ports_state, charged, G);
}

// the victim-dependent verdict: NodeResourcesFit and NodePorts against the
// node state given (the batch's, or an engine's running state), with the
// reservations of the live nominations at node n charged
template <class Q>
__device__ __forceinline__ bool pair_dependent_of(const ScoreArgs& a, const Q& q, int64_t n,
                                                  const int64_t* req_state,
                                                  const int32_t* pc_state,
                                                  const uint8_t* ports_state) {
  const int64_t G = nomination_slots(a);
  const int64_t charged = nominated_count(a, q.p, n, G);
  if (a.filter_fit && !pair_fit_of(a, q, n, req_state, pc_state, charged, G)) return false;
  if (a.filter_ports && !pair_ports_of(a, q, n, ports_state, charged, G)) return false;
  return true;
}

__device__ __forceinline__ bool pair_dependent(const ScoreArgs& a, int64_t p, int64_t n,
                                               const int64_t* req_state,
                                               const int32_t* pc_state,
                                               const uint8_t* ports_state) {
  return pair_dependent_of(a, PodAt{a, p}, n, req_state, pc_state, ports_state);
}

// the extender webhook's verdict of the pair (true without extenders); it
// depends on the pod and node only, never on the running state
__device__ __forceinline__ bool pair_extender(const ScoreArgs& a, int64_t p, int64_t n) {
  return a.ext_mask == nullptr || a.ext_mask[p * a.N + n];
}

// Filter: static row AND the extender verdict AND NodeResourcesFit AND
// NodePorts, against the node state given (the batch's, or the greedy
// scan's running state)
template <class Q>
__device__ __forceinline__ bool pair_feasible_of(const ScoreArgs& a, const Q& q, int64_t n,
                                                 const int64_t* req_state,
                                                 const int32_t* pc_state,
                                                 const uint8_t* ports_state) {
  return pair_static_of(a, q, n) && pair_extender(a, q.p, n) &&
         pair_dependent_of(a, q, n, req_state, pc_state, ports_state);
}

__device__ __forceinline__ bool pair_feasible(const ScoreArgs& a, int64_t p, int64_t n,
                                              const int64_t* req_state,
                                              const int32_t* pc_state,
                                              const uint8_t* ports_state) {
  return pair_feasible_of(a, PodAt{a, p}, n, req_state, pc_state, ports_state);
}

// pair_feasible_of's verdict with its tests evaluated without an early
// return, so that the node's rows load together rather than one behind
// each test (the greedy scan's recompute of one touched node, a latency
// every step waits for). It decides as pair_feasible_of: the same tests,
// ANDed.
template <class Q>
__device__ __forceinline__ bool pair_feasible_eager(const ScoreArgs& a, const Q& q, int64_t n,
                                                    const int64_t* req_state,
                                                    const int32_t* pc_state,
                                                    const uint8_t* ports_state) {
  const int64_t R = a.R, G = nomination_slots(a);
  bool ok = a.node_valid[n] && q.valid();
  if (a.static_mask != nullptr) ok &= a.static_mask[q.static_row() + n] != 0;
  ok &= pair_extender(a, q.p, n);
  const int64_t charged = nominated_count(a, q.p, n, G);
  if (a.filter_fit) {
    ok &= pc_state[n] + 1 + charged <= a.allowed_pods[n];
    for (int64_t r = 0; r < R; ++r) {
      const int64_t v = q.req(r);
      int64_t extra = 0;
      if (charged)
        for (int64_t g = 0; g < G; ++g)
          if (nominated_here(a, q.p, n, g)) extra += a.nom_req[g * R + r];
      ok &= v == 0 || v <= a.alloc[n * R + r] - req_state[n * R + r] - extra;
    }
  }
  if (a.filter_ports) ok &= pair_ports_of(a, q, n, ports_state, charged, G);
  return ok;
}

// resource r's term of the NodeResourcesFit score on a node with
// allocatable `cap` and running nonzero requests `nzv`: its per-resource
// score, and in w its weight, 0 when the resource takes no part
template <class Q>
__device__ __forceinline__ int64_t fit_term_v(const ScoreArgs& a, const Q& q, int64_t r,
                                              int64_t cap, int64_t nzv, int64_t& w) {
  const int64_t R = a.R, B = a.B;
  const int64_t* scal = q.params() + 2 * R;
  const int64_t* xs = q.params() + 3 * R;
  const int64_t* ys = xs + B;
  w = q.params()[r];
  int64_t pn = q.nzr(r);
  int64_t reqd = nzv + pn;
  int64_t safe = imax(cap, 1);
  int64_t per;
  if (a.strategy == 0) {
    per = (cap > 0 && reqd <= cap) ? floordiv((cap - reqd) * kMaxNodeScore, safe) : 0;
  } else if (a.strategy == 1) {
    per = cap > 0 ? floordiv(imin(reqd, cap) * kMaxNodeScore, safe) : 0;
  } else {
    int64_t util = (cap > 0 && reqd <= cap) ? floordiv(reqd * kMaxNodeScore, safe)
                                            : kMaxNodeScore;
    per = broken_linear(util, xs, ys, B);
  }
  bool part = w > 0 && cap > 0 && (!scal[r] || pn > 0);
  if (a.strategy == 2) part = part && per > 0;
  if (!part) w = 0;
  return per;
}

// fit_term_v of node n's row r
template <class Q>
__device__ __forceinline__ int64_t fit_term(const ScoreArgs& a, const Q& q, int64_t n, int64_t r,
                                            const int64_t* nz_state, int64_t& w) {
  return fit_term_v(a, q, r, a.alloc[n * a.R + r], nz_state[n * a.R + r], w);
}

// the fit score from the sums over the taking-part resources
__device__ __forceinline__ int64_t fit_finish(const ScoreArgs& a, int64_t num, int64_t den) {
  if (den <= 0) return 0;
  if (a.strategy == 2) return floordiv(2 * num + den, imax(2 * den, 1));
  return floordiv(num, imax(den, 1));
}

// NodeResourcesFit score under the profile's strategy (no NormalizeScore)
template <class Q>
__device__ __forceinline__ int64_t fit_score(const ScoreArgs& a, const Q& q, int64_t n,
                                             const int64_t* nz_state) {
  int64_t num = 0, den = 0;
  for (int64_t r = 0; r < a.R; ++r) {
    int64_t w;
    const int64_t per = fit_term(a, q, n, r, nz_state, w);
    if (w) {
      num += per * w;
      den += w;
    }
  }
  return fit_finish(a, num, den);
}

// min(requested / max(allocatable, 1), 1) in float64, of resource r with
// allocatable `capv` and running requested `reqv`
template <class Q>
__device__ __forceinline__ double balanced_frac_v(const Q& q, int64_t r, int64_t capv,
                                                  int64_t reqv, bool with_pod) {
  double cap = (double)capv;
  double safe = fmax(cap, 1.0);
  int64_t v = reqv + (with_pod ? q.req(r) : 0);
  return fmin(__ddiv_rn((double)v, safe), 1.0);
}

template <class Q>
__device__ __forceinline__ double balanced_frac(const ScoreArgs& a, const Q& q, int64_t n,
                                                int64_t r, const int64_t* req_state,
                                                bool with_pod) {
  return balanced_frac_v(q, r, a.alloc[n * a.R + r], req_state[n * a.R + r], with_pod);
}

template <class Q>
__device__ __forceinline__ bool balanced_present_v(const ScoreArgs& a, const Q& q, int64_t r,
                                                   int64_t cap) {
  const int64_t R = a.R;
  const int64_t* bw = q.params() + R;
  const int64_t* scal = q.params() + 2 * R;
  return bw[r] > 0 && cap > 0 && (!scal[r] || q.req(r) > 0);
}

template <class Q>
__device__ __forceinline__ bool balanced_present(const ScoreArgs& a, const Q& q, int64_t n,
                                                 int64_t r) {
  return balanced_present_v(a, q, r, a.alloc[n * a.R + r]);
}

// resources whose balanced fractions a pair keeps in registers (the rest,
// past the first kFracs, are recomputed where read)
constexpr int kFracs = 4;

// one side's sums in resource order: the count and total of the present
// fractions, then their squared and absolute deviations from the mean
struct BalancedSums {
  int64_t cnt = 0;
  double total = 0.0, sq = 0.0, absdev = 0.0;
};

__device__ __forceinline__ void balanced_dev(BalancedSums& b, double f, double mean) {
  const double d = __dadd_rn(f, -mean);
  b.sq = __dadd_rn(b.sq, __dmul_rn(d, d));
  b.absdev = __dadd_rn(b.absdev, fabs(d));
}

// int64((1 - std(fractions)) * 100), the case split of _balanced_std
__device__ __forceinline__ int64_t balanced_std_score(const BalancedSums& b, double denom) {
  double std_dev = 0.0;
  if (b.cnt == 2) std_dev = __dmul_rn(b.absdev, 0.5);  // exactly absdev / 2
  else if (b.cnt > 2) std_dev = __dsqrt_rn(__ddiv_rn(b.sq, denom));
  return (int64_t)__dmul_rn(__dadd_rn(1.0, -std_dev), (double)kMaxNodeScore);
}

// both sides of the balanced score, the pod added (w) and not (o): each
// fraction is taken once, and the two sides' divisions are independent,
// so that they overlap; every sum runs in resource order, as in
// _balanced_std
template <class Q>
__device__ __forceinline__ void balanced_sides(const ScoreArgs& a, const Q& q, int64_t n,
                                               const int64_t* req_state, int64_t& w_side,
                                               int64_t& o_side) {
  const int64_t R = a.R;
  bool pr[kFracs];
  double fw[kFracs], fo[kFracs];
#pragma unroll
  for (int r = 0; r < kFracs; ++r) {
    pr[r] = r < R && balanced_present(a, q, n, r);
    fw[r] = pr[r] ? balanced_frac(a, q, n, r, req_state, true) : 0.0;
    fo[r] = pr[r] ? balanced_frac(a, q, n, r, req_state, false) : 0.0;
  }
  BalancedSums w, o;
#pragma unroll
  for (int r = 0; r < kFracs; ++r) {
    if (!pr[r]) continue;
    ++w.cnt;
    w.total = __dadd_rn(w.total, fw[r]);
    o.total = __dadd_rn(o.total, fo[r]);
  }
  for (int64_t r = kFracs; r < R; ++r) {
    if (!balanced_present(a, q, n, r)) continue;
    ++w.cnt;
    w.total = __dadd_rn(w.total, balanced_frac(a, q, n, r, req_state, true));
    o.total = __dadd_rn(o.total, balanced_frac(a, q, n, r, req_state, false));
  }
  o.cnt = w.cnt;
  const double denom = (double)imax(w.cnt, 1);
  const double mw = __ddiv_rn(w.total, denom), mo = __ddiv_rn(o.total, denom);
#pragma unroll
  for (int r = 0; r < kFracs; ++r) {
    if (!pr[r]) continue;
    balanced_dev(w, fw[r], mw);
    balanced_dev(o, fo[r], mo);
  }
  for (int64_t r = kFracs; r < R; ++r) {
    if (!balanced_present(a, q, n, r)) continue;
    balanced_dev(w, balanced_frac(a, q, n, r, req_state, true), mw);
    balanced_dev(o, balanced_frac(a, q, n, r, req_state, false), mo);
  }
  w_side = balanced_std_score(w, denom);
  o_side = balanced_std_score(o, denom);
}

// a pod that requests none of the balanced resources is not scored (0)
template <class Q>
__device__ __forceinline__ bool balanced_best_effort(const ScoreArgs& a, const Q& q) {
  const int64_t* bw = q.params() + a.R;
  bool best_effort = true;
  for (int64_t r = 0; r < a.R; ++r)
    if (q.req(r) != 0 && bw[r] != 0) best_effort = false;
  return best_effort;
}

__device__ __forceinline__ int64_t balanced_finish(int64_t with_pod, int64_t without_pod) {
  return kMaxNodeScore / 2 + floordiv(kMaxNodeScore / 2 + with_pod - without_pod, 2);
}

// NodeResourcesBalancedAllocation
template <class Q>
__device__ __forceinline__ int64_t balanced_score(const ScoreArgs& a, const Q& q, int64_t n,
                                                  const int64_t* req_state) {
  if (balanced_best_effort(a, q)) return 0;
  int64_t with_pod, without_pod;
  balanced_sides(a, q, n, req_state, with_pod, without_pod);
  return balanced_finish(with_pod, without_pod);
}

// ImageLocality
template <class Q>
__device__ __forceinline__ int64_t image_score(const ScoreArgs& a, const Q& q, int64_t n) {
  const int64_t min_t = 23LL * 1024 * 1024;
  const int64_t max_c = 1000LL * 1024 * 1024;
  int64_t s = a.img_sums[q.img_row() + n];
  int64_t max_t = max_c * q.img_count();
  s = imin(imax(s, min_t), imax(max_t, min_t));
  return floordiv(kMaxNodeScore * (s - min_t), imax(max_t - min_t, 1));
}

// The weighted scores that need no normalization over nodes: fit, balanced
// and image locality, and the extender score. Plugin sums are int64 and
// exact, so adding the normalized node-affinity and taint terms afterwards
// gives the reference's total whatever the order.
template <class Q>
__device__ __forceinline__ int64_t base_score_of(const ScoreArgs& a, const Q& q, int64_t n,
                                                 const int64_t* req_state,
                                                 const int64_t* nz_state) {
  int64_t total = 0;
  if (a.w_fit) total += a.w_fit * fit_score(a, q, n, nz_state);
  if (a.w_balanced) total += a.w_balanced * balanced_score(a, q, n, req_state);
  if (a.img_sums != nullptr) total += a.w_image * image_score(a, q, n);
  if (a.ext_score != nullptr) total += a.ext_score[q.p * a.N + n];
  return total;
}

__device__ __forceinline__ int64_t base_score(const ScoreArgs& a, int64_t p, int64_t n,
                                              const int64_t* req_state,
                                              const int64_t* nz_state) {
  return base_score_of(a, PodAt{a, p}, n, req_state, nz_state);
}

// base_score_of taken by the 32 lanes of a warp together (every lane
// calls it with the same pair and gets the score; R <= 32): lane r takes
// resource r's fit term and balanced fractions, all their divisions
// started before any sum, and every lane then sums them in resource order,
// as base_score_of does (the greedy scan's recompute of the node a step
// changed, which the next step waits for). Lane r < R gives node n's
// resource r: its allocatable `cap`, running requested `reqv` and nonzero
// `nzv`; base_score_warp reads them from the rows.
template <class Q>
__device__ __forceinline__ int64_t base_score_warp_v(const ScoreArgs& a, const Q& q, int64_t n,
                                                     int64_t cap, int64_t reqv, int64_t nzv) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int R = (int)a.R;
  int64_t w = 0, per = 0;
  if (a.w_fit && lane < R) per = fit_term_v(a, q, lane, cap, nzv, w);
  const bool balanced = a.w_balanced && !balanced_best_effort(a, q);
  const bool present = balanced && lane < R && balanced_present_v(a, q, lane, cap);
  const double fw = present ? balanced_frac_v(q, lane, cap, reqv, true) : 0.0;
  const double fo = present ? balanced_frac_v(q, lane, cap, reqv, false) : 0.0;
  int64_t total = 0;
  if (a.w_fit) {
    int64_t num = 0, den = 0;
    for (int r = 0; r < R; ++r) {
      const int64_t wr = __shfl_sync(all, w, r), pr = __shfl_sync(all, per, r);
      if (wr) {
        num += pr * wr;
        den += wr;
      }
    }
    total += a.w_fit * fit_finish(a, num, den);
  }
  if (balanced) {
    BalancedSums sw, so;
    for (int r = 0; r < R; ++r) {
      if (!__shfl_sync(all, (int)present, r)) continue;
      ++sw.cnt;
      sw.total = __dadd_rn(sw.total, __shfl_sync(all, fw, r));
      so.total = __dadd_rn(so.total, __shfl_sync(all, fo, r));
    }
    so.cnt = sw.cnt;
    const double denom = (double)imax(sw.cnt, 1);
    const double mw = __ddiv_rn(sw.total, denom), mo = __ddiv_rn(so.total, denom);
    for (int r = 0; r < R; ++r) {
      if (!__shfl_sync(all, (int)present, r)) continue;
      balanced_dev(sw, __shfl_sync(all, fw, r), mw);
      balanced_dev(so, __shfl_sync(all, fo, r), mo);
    }
    total += a.w_balanced *
             balanced_finish(balanced_std_score(sw, denom), balanced_std_score(so, denom));
  }
  if (a.img_sums != nullptr) total += a.w_image * image_score(a, q, n);
  if (a.ext_score != nullptr) total += a.ext_score[q.p * a.N + n];
  return total;
}

template <class Q>
__device__ __forceinline__ int64_t base_score_warp(const ScoreArgs& a, const Q& q, int64_t n,
                                                   const int64_t* req_state,
                                                   const int64_t* nz_state) {
  const int64_t r = threadIdx.x & 31;
  const bool mine = r < a.R;
  return base_score_warp_v(a, q, n, mine ? a.alloc[n * a.R + r] : 0,
                           mine ? req_state[n * a.R + r] : 0, mine ? nz_state[n * a.R + r] : 0);
}

// DefaultNormalizeScore of one masked raw value against the row maximum
__device__ __forceinline__ int64_t normalize(int64_t v, int64_t mx, bool reverse) {
  int64_t s = mx > 0 ? floordiv(kMaxNodeScore * v, imax(mx, 1)) : 0;
  return reverse ? kMaxNodeScore - s : s;
}

// the row offset of pod p's DRA raw row (0 without the leaf)
__device__ __forceinline__ int64_t dra_row(const ScoreArgs& a, int64_t p) {
  return a.dra_raw != nullptr ? (int64_t)a.dra_sig[p] * a.N : 0;
}

// the node-affinity and taint terms of a pair whose masked raws are known
__device__ __forceinline__ int64_t normalized_terms(const ScoreArgs& a, int64_t na_m,
                                                    int64_t tt_m, int64_t mx_na,
                                                    int64_t mx_tt) {
  int64_t total = 0;
  if (a.na_raw != nullptr) total += a.w_na * normalize(na_m, mx_na, false);
  if (a.tt_raw != nullptr) total += a.w_taint * normalize(tt_m, mx_tt, true);
  return total;
}

// ---- InterPodAffinity (kubetpu/ops/podaffinity.py) ----------------------

// count at node n's domain for row r (0 where the node lacks the row's key)
__device__ __forceinline__ int64_t pa_count(const ScoreArgs& a, const int64_t* sums,
                                            int64_t r, int64_t n) {
  const int32_t dom = a.pa_node_domain[r * a.N + n];
  return dom >= 0 ? sums[r * a.pa_D + dom] : 0;
}

// the self-affinity escape of pod p (filtering.go:414): no pod anywhere
// matches its required-affinity rows, and the pod matches its own terms.
// row_total[r] is the sum over all domains of the sums row r.
__device__ __forceinline__ bool pa_escape(const ScoreArgs& a, const int64_t* row_total,
                                          int64_t p) {
  int64_t set_total = 0;
  for (int64_t c = 0; c < a.pa_CA; ++c) {
    const int32_t rid = a.pa_fa_rows[p * a.pa_CA + c];
    if (rid >= 0) set_total += row_total[rid];
  }
  return set_total == 0 && a.pa_fa_self[p];
}

// InterPodAffinity Filter of one pair against the sums given
__device__ __forceinline__ bool pa_feasible(const ScoreArgs& a, const int64_t* sums,
                                            bool escape, int64_t p, int64_t n) {
  // incoming required affinity (satisfyPodAffinity)
  bool any_fa = false, keys_ok = true, pods_exist = true;
  for (int64_t c = 0; c < a.pa_CA; ++c) {
    const int32_t rid = a.pa_fa_rows[p * a.pa_CA + c];
    if (rid < 0) continue;
    any_fa = true;
    keys_ok = keys_ok && a.pa_has_key[rid * a.N + n];
    pods_exist = pods_exist && pa_count(a, sums, rid, n) > 0;
  }
  if (any_fa && !(keys_ok && (pods_exist || escape))) return false;
  // incoming required anti-affinity (satisfyPodAntiAffinity)
  for (int64_t c = 0; c < a.pa_CR; ++c) {
    const int32_t rid = a.pa_ra_rows[p * a.pa_CR + c];
    if (rid >= 0 && a.pa_has_key[rid * a.N + n] && pa_count(a, sums, rid, n) > 0)
      return false;
  }
  // existing pods' anti-affinity (satisfyExistingPodsAntiAffinity)
  for (int64_t c = 0; c < a.pa_CE; ++c) {
    const int32_t rid = a.pa_ea_rows[p * a.pa_CE + c];
    if (rid >= 0 && pa_count(a, sums, rid, n) > 0) return false;
  }
  return true;
}

// InterPodAffinity raw score of one pair: sum of weight * count, int64
__device__ __forceinline__ int64_t pa_raw(const ScoreArgs& a, const int64_t* sums,
                                          int64_t p, int64_t n) {
  int64_t raw = 0;
  for (int64_t c = 0; c < a.pa_CS; ++c) {
    const int32_t rid = a.pa_score_rows[p * a.pa_CS + c];
    if (rid >= 0) raw += a.pa_score_vals[p * a.pa_CS + c] * pa_count(a, sums, rid, n);
  }
  return raw;
}

// min-max normalize of a feasible pair's raw score against the feasible
// row's min and max: int64(100 * (raw - mn) / (mx - mn)), 0 when equal
__device__ __forceinline__ int64_t pa_normalize(int64_t raw, int64_t mn, int64_t mx) {
  const int64_t diff = mx - mn;
  if (diff <= 0) return 0;
  const double f = __ddiv_rn(__dmul_rn((double)kMaxNodeScore, __ll2double_rn(raw - mn)),
                             __ll2double_rn(diff));
  return (int64_t)f;
}

// ---- PodTopologySpread (kubetpu/ops/spread.py) -------------------------

// any ScheduleAnyway slot: a pod without one Skips the score (scoring.go:149)
__device__ __forceinline__ bool sp_any_soft(const ScoreArgs& a, int64_t p) {
  for (int64_t c = 0; c < a.sp_C; ++c)
    if (a.sp_sig_idx[p * a.sp_C + c] >= 0 && a.sp_action[p * a.sp_C + c] == 1) return true;
  return false;
}

// matchNum of node n for signature s: its domain's sum, 0 for domain -1
__device__ __forceinline__ int64_t sp_match(const ScoreArgs& a, const int64_t* sums,
                                            int64_t s, int64_t n) {
  const int32_t dom = a.sp_node_domain[s * a.N + n];
  return dom >= 0 ? sums[s * (a.sp_D + 1) + dom] : 0;
}

// the hard-constraint verdict of a pair (spread_filter_pod): every
// DoNotSchedule slot needs the node to carry its key and
// matchNum + selfMatch - minMatch <= maxSkew, where minMatch is 0 when the
// signature counts fewer domains than the slot's minDomains. int64 throughout.
__device__ __forceinline__ bool sp_feasible(const ScoreArgs& a, const int64_t* sums,
                                            const int64_t* min_match, int64_t p, int64_t n) {
  const int64_t C = a.sp_C;
  for (int64_t c = 0; c < C; ++c) {
    const int32_t sid = a.sp_sig_idx[p * C + c];
    if (sid < 0 || a.sp_action[p * C + c] != 0) continue;
    if (!a.sp_has_key[sid * a.N + n]) return false;
    const int64_t mm =
        a.sp_num_domains[sid] < a.sp_min_domains[p * C + c] ? 0 : min_match[sid];
    if (sp_match(a, sums, sid, n) + a.sp_self_match[p * C + c] - mm > a.sp_max_skew[p * C + c])
      return false;
  }
  return true;
}

// the rounded raw spread score of a pair: over the pod's ScheduleAnyway
// slots in order, cnt * weight[c] + (maxSkew - 1) where the node carries
// the key; cnt is the node's own count for a hostname signature (not gated
// by eligibility, scoring.go:217), else its domain's sum. Rounded half to
// even.
__device__ __forceinline__ int64_t sp_raw(const ScoreArgs& a, const int32_t* counts,
                                          const int64_t* sums, const double* weight,
                                          int64_t p, int64_t n) {
  const int64_t C = a.sp_C;
  double raw = 0.0;
  for (int64_t c = 0; c < C; ++c) {
    const int32_t sid = a.sp_sig_idx[p * C + c];
    if (sid < 0 || a.sp_action[p * C + c] != 1 || !a.sp_has_key[sid * a.N + n]) continue;
    const int64_t cnt =
        a.sp_is_hostname[sid] ? (int64_t)counts[sid * a.N + n] : sp_match(a, sums, sid, n);
    const double contrib =
        __dadd_rn(__dmul_rn(__ll2double_rn(cnt), weight[c]),
                  __dadd_rn(__ll2double_rn(a.sp_max_skew[p * C + c]), -1.0));
    raw = __dadd_rn(raw, contrib);
  }
  return __double2ll_rn(raw);
}

// the rounded spread raw of a feasible pair when the pod is spread-scored
// (sp_score) and the node not ignored, else -1, which fold_norm and
// norm_terms skip
__device__ __forceinline__ int64_t sp_scored_raw(const ScoreArgs& a, bool sp_score,
                                                 const int32_t* counts, const int64_t* sums,
                                                 const double* weight, int64_t p, int64_t n) {
  if (!sp_score || a.sp_ignored[p * a.N + n]) return -1;
  return sp_raw(a, counts, sums, weight, p, n);
}

// NormalizeScore (scoring.go:229) of a scored pair's rounded raw s against
// the scored nodes' min and max; only called for scored pairs, where
// max + min - s cannot wrap
__device__ __forceinline__ int64_t sp_normalize(int64_t s, int64_t mn, int64_t mx) {
  if (mx == 0) return kMaxNodeScore;
  return floordiv(kMaxNodeScore * (mx + mn - s), mx);
}

// block-wide reduction helpers (blockDim.x a multiple of 32, <= 1024)
struct MaxOp {
  __device__ int64_t operator()(int64_t x, int64_t y) const { return x > y ? x : y; }
};
struct MinOp {
  __device__ int64_t operator()(int64_t x, int64_t y) const { return x < y ? x : y; }
};
struct SumOp {
  // wrapping add (uint64 arithmetic, as the reference's uint64 hash)
  __device__ int64_t operator()(int64_t x, int64_t y) const {
    return (int64_t)((unsigned long long)x + (unsigned long long)y);
  }
};

// reduce v over the block with op; every thread gets the result.
// s holds 33 values; ident is the op's identity.
template <typename Op>
__device__ __forceinline__ int64_t block_reduce(int64_t v, Op op, int64_t ident, int64_t* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) s[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int64_t x = lane < nwarps ? s[lane] : ident;
    for (int off = 16; off > 0; off >>= 1) x = op(x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) s[32] = x;
  }
  __syncthreads();
  const int64_t out = s[32];
  __syncthreads();
  return out;
}

__device__ __forceinline__ int64_t warp_max(int64_t v) {
  for (int off = 16; off > 0; off >>= 1) v = imax(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// max of two values over the block; every thread gets the results
__device__ __forceinline__ void block_max2(int64_t& x, int64_t& y, int64_t* sx, int64_t* sy) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  x = warp_max(x);
  y = warp_max(y);
  if (lane == 0) {
    sx[warp] = x;
    sy[warp] = y;
  }
  __syncthreads();
  if (warp == 0) {
    int64_t vx = lane < nwarps ? sx[lane] : 0;
    int64_t vy = lane < nwarps ? sy[lane] : 0;
    vx = warp_max(vx);
    vy = warp_max(vy);
    if (lane == 0) {
      sx[32] = vx;
      sy[32] = vy;
    }
  }
  __syncthreads();
  x = sx[32];
  y = sy[32];
}

// max of three values over the block; every thread gets the results
__device__ __forceinline__ void block_max3(int64_t& x, int64_t& y, int64_t& z, int64_t* sx,
                                           int64_t* sy, int64_t* sz) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  x = warp_max(x);
  y = warp_max(y);
  z = warp_max(z);
  if (lane == 0) {
    sx[warp] = x;
    sy[warp] = y;
    sz[warp] = z;
  }
  __syncthreads();
  if (warp == 0) {
    int64_t vx = lane < nwarps ? sx[lane] : 0;
    int64_t vy = lane < nwarps ? sy[lane] : 0;
    int64_t vz = lane < nwarps ? sz[lane] : 0;
    vx = warp_max(vx);
    vy = warp_max(vy);
    vz = warp_max(vz);
    if (lane == 0) {
      sx[32] = vx;
      sy[32] = vy;
      sz[32] = vz;
    }
  }
  __syncthreads();
  x = sx[32];
  y = sy[32];
  z = sz[32];
}

// max of K values over the block; s holds K x 33 int64. Every thread gets
// the results.
template <int K>
__device__ __forceinline__ void block_maxk(int64_t (&v)[kNorm], int64_t (*s)[33]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int i = 0; i < K; ++i) {
    v[i] = warp_max(v[i]);
    if (lane == 0) s[i][warp] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
    for (int i = 0; i < K; ++i) {
      int64_t x = lane < nwarps ? s[i][lane] : INT64_MIN;
      x = warp_max(x);
      if (lane == 0) s[i][32] = x;
    }
  }
  __syncthreads();
  for (int i = 0; i < K; ++i) v[i] = s[i][32];
}

// the reduction of fold_norm's maxima over the block: the node-affinity and
// taint maxima always (the cheap two-value form when nothing else
// normalizes), the affinity pair with affinity score rows, the spread pair
// when the pod is spread-scored (sp_score), and the DRA maximum only when
// the batch has the DRA leaf (without it the reductions are those of a
// batch before the term existed)
__device__ __forceinline__ void block_max_norm(const ScoreArgs& a, bool sp_score,
                                               int64_t (&m)[kNorm], int64_t (*s)[33]) {
  const bool dra = a.dra_raw != nullptr;
  if (sp_score) {
    if (dra)
      block_maxk<7>(m, s);
    else
      block_maxk<6>(m, s);
  } else if (a.w_interpod) {
    if (dra)
      block_maxk<7>(m, s);
    else
      block_maxk<4>(m, s);
  } else if (dra) {
    block_max3(m[0], m[1], m[6], s[0], s[1], s[6]);
  } else {
    block_max2(m[0], m[1], s[0], s[1]);
  }
}

// the normalize inputs of one pair that passed Filter, folded into the
// running maxima: node-affinity and taint raws (row: the pod's offset into
// their table), the affinity raw's max and its negated min, (when sp >= 0,
// i.e. the pair is spread-scored) the rounded spread raw's max and negated
// min, and the DRA raw (drow: the pod's offset into its table), so that all
// seven reduce by max
__device__ __forceinline__ void fold_norm_vals(const ScoreArgs& a, int64_t na, int64_t tt,
                                               int64_t dra, int64_t pa_r, int64_t sp,
                                               int64_t (&m)[kNorm]) {
  if (a.na_raw != nullptr) m[0] = imax(m[0], na);
  if (a.tt_raw != nullptr) m[1] = imax(m[1], tt);
  if (a.dra_raw != nullptr) m[6] = imax(m[6], dra);
  if (a.w_interpod) {
    m[2] = imax(m[2], pa_r);
    m[3] = imax(m[3], -pa_r);
  }
  if (sp >= 0) {
    m[4] = imax(m[4], sp);
    m[5] = imax(m[5], -sp);
  }
}

// a pair's node-affinity, taint and DRA raws (0 where the table is absent)
struct NormRaws {
  int64_t na = 0, tt = 0, dra = 0;
};

__device__ __forceinline__ NormRaws norm_raws(const ScoreArgs& a, int64_t row, int64_t drow,
                                              int64_t n) {
  NormRaws v;
  if (a.na_raw != nullptr) v.na = a.na_raw[row + n];
  if (a.tt_raw != nullptr) v.tt = a.tt_raw[row + n];
  if (a.dra_raw != nullptr) v.dra = a.dra_raw[drow + n];
  return v;
}

// fold_norm_vals of the pair's raws read from their tables
__device__ __forceinline__ void fold_norm(const ScoreArgs& a, int64_t row, int64_t drow,
                                          int64_t n, int64_t pa_r, int64_t sp,
                                          int64_t (&m)[kNorm]) {
  const NormRaws v = norm_raws(a, row, drow, n);
  fold_norm_vals(a, v.na, v.tt, v.dra, pa_r, sp, m);
}

// start values of fold_norm's maxima: the node-affinity, taint, spread and
// DRA maxima start at 0 (the reference's masked max), the affinity ones at
// the most negative value, and the spread minimum at int64 max (negated)
__device__ __forceinline__ void init_norm(int64_t (&m)[kNorm]) {
  m[0] = 0;
  m[1] = 0;
  m[2] = INT64_MIN;
  m[3] = INT64_MIN;
  m[4] = 0;
  m[5] = -INT64_MAX;
  m[6] = 0;
}

// the normalized terms of a pair given the reduced maxima. An infeasible
// pair (ok false) still gets the node-affinity, taint and DRA terms of a
// zero raw, as masked_normalize gives it; its affinity term is 0. sp is the
// pair's rounded spread raw when it is spread-scored, else -1 (term 0).
__device__ __forceinline__ int64_t norm_terms_vals(const ScoreArgs& a, const NormRaws& v, bool ok,
                                                   int64_t pa_r, int64_t sp,
                                                   const int64_t (&m)[kNorm]) {
  int64_t s = normalized_terms(a, ok ? v.na : 0, ok ? v.tt : 0, m[0], m[1]);
  if (ok && a.w_interpod) s += a.w_interpod * pa_normalize(pa_r, -m[3], m[2]);
  if (ok && sp >= 0) s += a.w_spread * sp_normalize(sp, -m[5], m[4]);
  if (a.dra_raw != nullptr) s += a.w_dra * normalize(ok ? v.dra : 0, m[6], false);
  return s;
}

// norm_terms_vals of the pair's raws read from their tables (read only for
// a feasible pair)
__device__ __forceinline__ int64_t norm_terms(const ScoreArgs& a, int64_t row, int64_t drow,
                                              int64_t n, bool ok, int64_t pa_r, int64_t sp,
                                              const int64_t (&m)[kNorm]) {
  const NormRaws v = ok ? norm_raws(a, row, drow, n) : NormRaws{};
  return norm_terms_vals(a, v, ok, pa_r, sp, m);
}

// sum over D of each affinity sums row, one row per thread of the grid
__device__ __forceinline__ void pa_row_totals(const ScoreArgs& a, const int64_t* sums,
                                              int64_t* row_total, int64_t first,
                                              int64_t stride) {
  for (int64_t r = first; r < a.pa_R; r += stride) {
    int64_t t = 0;
    for (int64_t d = 0; d < a.pa_D; ++d) t += sums[r * a.pa_D + d];
    row_total[r] = t;
  }
}

// ---- PodTopologySpread, block-wide parts ----------------------------------
// Every thread of the block must call these (they hold barriers).

// per-signature domain sums of `counts` over eligible nodes (slot D takes
// domain -1) for signatures s0, s0 + sstride, ...; sums must be zero
// before. Integer atomics: the order of the adds does not change the sums.
__device__ __forceinline__ void sp_accumulate(const ScoreArgs& a, const int32_t* counts,
                                              int64_t* sums, int64_t s0, int64_t sstride) {
  const int64_t N = a.N, D1 = a.sp_D + 1;
  for (int64_t s = s0; s < a.sp_S; s += sstride) {
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      const int32_t c = counts[s * N + n];
      if (c == 0 || !a.sp_eligible[s * N + n]) continue;
      const int32_t dom = a.sp_node_domain[s * N + n];
      atomicAdd(reinterpret_cast<unsigned long long*>(sums + s * D1 + (dom >= 0 ? dom : a.sp_D)),
                (unsigned long long)(int64_t)c);
    }
  }
}

// minMatch of signature s: the least sum over its present (counted)
// domains, kBig when none is present
__device__ __forceinline__ int64_t sp_min_over_domains(const ScoreArgs& a, const int64_t* sums,
                                                       int64_t s, int64_t* red) {
  const int64_t D = a.sp_D;
  int64_t v = -kBig;
  for (int64_t d = threadIdx.x; d < D; d += blockDim.x)
    if (a.sp_domain_present[s * D + d]) v = imax(v, -sums[s * (D + 1) + d]);
  return -block_reduce(v, MaxOp(), -kBig, red);
}

// OR the domain bit of every scored node (ok[n] and not ig[n]) of
// signature sid into `bits`: the lanes of a warp that hit one bitmap word
// OR their bits first, and one of them adds them with one atomic (the
// zones of a zone constraint are a word or two: per-node atomics on one
// word serialized a warp 32 ways). Every thread of the block calls it.
__device__ __forceinline__ void set_domain_bits(const ScoreArgs& a, int32_t sid,
                                                const uint8_t* ok, const uint8_t* ig,
                                                uint32_t* bits) {
  const int64_t N = a.N;
  const int lane = threadIdx.x & 31;
  for (int64_t base = 0; base < N; base += blockDim.x) {
    const int64_t n = base + threadIdx.x;
    int32_t dom = -1;
    if (n < N && ok[n] && !ig[n]) dom = a.sp_node_domain[sid * N + n];
    const unsigned on = __ballot_sync(0xffffffffu, dom >= 0);
    if (dom < 0) continue;
    const unsigned peers = __match_any_sync(on, dom >> 5);
    const unsigned word = __reduce_or_sync(peers, 1u << (dom & 31));
    if (lane == __ffs(peers) - 1) atomicOr(bits + (dom >> 5), word);
  }
}

// weight[c] = log(size + 2) for each ScheduleAnyway slot of pod p (0 for
// the others), where size counts the domains (d < D) that hold a scored
// node (ok[n] and not ignored), or the scored nodes themselves for a
// hostname signature (initPreScoreState). bits holds ceil(D / 32) words.
// weight is shared memory, written by thread 0; read after the barrier.
__device__ __forceinline__ void sp_weights(const ScoreArgs& a, int64_t p, const uint8_t* ok,
                                           uint32_t* bits, double* weight, int64_t* red) {
  const int64_t N = a.N, C = a.sp_C, W = (a.sp_D + 31) / 32;
  const uint8_t* ig = a.sp_ignored + p * N;
  int64_t scored = 0;
  for (int64_t n = threadIdx.x; n < N; n += blockDim.x) scored += ok[n] && !ig[n];
  scored = block_reduce(scored, SumOp(), 0, red);
  for (int64_t c = 0; c < C; ++c) {
    const int32_t sid = a.sp_sig_idx[p * C + c];
    if (sid < 0 || a.sp_action[p * C + c] != 1) {
      if (threadIdx.x == 0) weight[c] = 0.0;
      continue;
    }
    int64_t size = scored;
    if (!a.sp_is_hostname[sid]) {
      for (int64_t w = threadIdx.x; w < W; w += blockDim.x) bits[w] = 0;
      __syncthreads();
      set_domain_bits(a, sid, ok, ig, bits);
      __syncthreads();
      int64_t cnt = 0;
      for (int64_t w = threadIdx.x; w < W; w += blockDim.x) cnt += __popc(bits[w]);
      size = block_reduce(cnt, SumOp(), 0, red);
    }
    if (threadIdx.x == 0) weight[c] = log(__dadd_rn(__ll2double_rn(size), 2.0));
  }
  __syncthreads();
}

// ---- PodTopologySpread over a node mesh (filter_score's sharded phases) ---

// This shard's part of sp_weights for pod p: its scored-node count into
// *out_sc and, for each ScheduleAnyway slot whose signature is not
// hostname, its domain bitmap into out_bits + c * W (ceil(D / 32) int64
// words, each holding 32 bits), zero elsewhere. The shards' counts sum and
// their bitmaps OR (the mesh's combine) before sp_weights_given.
__device__ __forceinline__ void sp_partials(const ScoreArgs& a, int64_t p, const uint8_t* ok,
                                            int64_t* out_sc, int64_t* out_bits, int64_t* red) {
  const int64_t N = a.N, C = a.sp_C, W = (a.sp_D + 31) / 32;
  const uint8_t* ig = a.sp_ignored + p * N;
  int64_t scored = 0;
  for (int64_t n = threadIdx.x; n < N; n += blockDim.x) scored += ok[n] && !ig[n];
  scored = block_reduce(scored, SumOp(), 0, red);
  if (threadIdx.x == 0) *out_sc = scored;
  for (int64_t i = threadIdx.x; i < C * W; i += blockDim.x) out_bits[i] = 0;
  __syncthreads();
  for (int64_t c = 0; c < C; ++c) {
    const int32_t sid = a.sp_sig_idx[p * C + c];
    if (sid < 0 || a.sp_action[p * C + c] != 1 || a.sp_is_hostname[sid]) continue;
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      if (!ok[n] || ig[n]) continue;
      const int32_t dom = a.sp_node_domain[sid * N + n];
      if (dom >= 0)
        atomicOr(reinterpret_cast<unsigned long long*>(out_bits + c * W + (dom >> 5)),
                 1ull << (dom & 31));
    }
  }
  __syncthreads();
}

// sp_weights from the mesh's combined scored count `sc` and bitmaps `bits`
// (sp_partials' layout)
__device__ __forceinline__ void sp_weights_given(const ScoreArgs& a, int64_t p, int64_t sc,
                                                 const int64_t* bits, double* weight,
                                                 int64_t* red) {
  const int64_t C = a.sp_C, W = (a.sp_D + 31) / 32;
  for (int64_t c = 0; c < C; ++c) {
    const int32_t sid = a.sp_sig_idx[p * C + c];
    if (sid < 0 || a.sp_action[p * C + c] != 1) {
      if (threadIdx.x == 0) weight[c] = 0.0;
      continue;
    }
    int64_t size = sc;
    if (!a.sp_is_hostname[sid]) {
      int64_t cnt = 0;
      for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
        cnt += __popcll((unsigned long long)bits[c * W + w]);
      size = block_reduce(cnt, SumOp(), 0, red);
    }
    if (threadIdx.x == 0) weight[c] = log(__dadd_rn(__ll2double_rn(size), 2.0));
  }
  __syncthreads();
}

}  // namespace kt
