// Filter verdict and raw plugin scores of ONE (pod, node) pair, shared by
// the filter_score, greedy_scan and batched_round kernels so they cannot
// drift apart.
//
// Replaces, fused per pair, the jitted jnp compositions of the JAX package:
//   kubetpu/ops/filters.py:22 resource_fit_mask (+ :76 the single-pod form)
//   kubetpu/framework/runtime.py:1412 the NodePorts conflict contraction
//   kubetpu/ops/scores.py:53 / :82 / :121 the three fit strategies
//     (+ :101 _trunc_div, :108 broken_linear, :21 _weighted_mean)
//   kubetpu/ops/scores.py:174 balanced_allocation_score (+ :156 _balanced_std)
//   kubetpu/ops/scores.py:215 default_normalize, :227 image_locality_score
//   kubetpu/ops/podaffinity.py:24 _slot_counts, :32 affinity_filter_pod,
//     :75 affinity_score_pod (InterPodAffinity: gathers from the carried
//     (R, D) sums at the node's domain, and the min-max normalize in f64)
//
// Exactness: every integer is int64 as in the reference (which runs with
// jax x64). `//` in the reference floors; C++ `/` truncates, so floordiv()
// is used wherever the reference floors. The balanced score is float64 with
// explicitly rounded intrinsics (__dadd_rn, __dmul_rn, __ddiv_rn,
// __dsqrt_rn): no fused multiply-add can change a rounding, and the sums
// over R run in index order, as the plain PyTorch version's loop does. The
// affinity normalize, 100 * (raw - min) / (max - min) truncated to int64, is
// float64 through the same intrinsics.
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
};

namespace kt {

constexpr int64_t kMaxNodeScore = 100;

// floor division for b > 0 (the reference's `//`)
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
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

// Filter: static row AND NodeResourcesFit AND NodePorts, against the node
// state given (the batch's, or the greedy scan's running state)
__device__ __forceinline__ bool pair_feasible(const ScoreArgs& a, int64_t p, int64_t n,
                                              const int64_t* req_state,
                                              const int32_t* pc_state,
                                              const uint8_t* ports_state) {
  if (!a.node_valid[n] || !a.pod_valid[p]) return false;
  if (a.static_mask != nullptr &&
      !a.static_mask[(int64_t)a.static_sig[p] * a.N + n])
    return false;
  const int64_t R = a.R;
  if (a.filter_fit) {
    if (!(pc_state[n] + 1 <= a.allowed_pods[n])) return false;
    for (int64_t r = 0; r < R; ++r) {
      int64_t q = a.requests[p * R + r];
      if (q != 0 && q > a.alloc[n * R + r] - req_state[n * R + r]) return false;
    }
  }
  if (a.filter_ports) {
    const int64_t K = a.K;
    for (int64_t k = 0; k < K; ++k) {
      if (!a.pod_ports[p * K + k]) continue;
      for (int64_t l = 0; l < K; ++l)
        if (a.port_conflict[k * K + l] && ports_state[n * K + l]) return false;
    }
  }
  return true;
}

// NodeResourcesFit score under the profile's strategy (no NormalizeScore)
__device__ __forceinline__ int64_t fit_score(const ScoreArgs& a, int64_t p, int64_t n,
                                             const int64_t* nz_state) {
  const int64_t R = a.R, B = a.B;
  const int64_t* fw = a.params;
  const int64_t* scal = a.params + 2 * R;
  const int64_t* xs = a.params + 3 * R;
  const int64_t* ys = xs + B;
  int64_t num = 0, den = 0;
  for (int64_t r = 0; r < R; ++r) {
    int64_t w = fw[r];
    int64_t cap = a.alloc[n * R + r];
    int64_t pn = a.nonzero_requests[p * R + r];
    int64_t reqd = nz_state[n * R + r] + pn;
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
    if (part) {
      num += per * w;
      den += w;
    }
  }
  if (den <= 0) return 0;
  if (a.strategy == 2) return floordiv(2 * num + den, imax(2 * den, 1));
  return floordiv(num, imax(den, 1));
}

// min(requested / max(allocatable, 1), 1) in float64
__device__ __forceinline__ double balanced_frac(const ScoreArgs& a, int64_t p, int64_t n,
                                                int64_t r, const int64_t* req_state,
                                                bool with_pod) {
  const int64_t R = a.R;
  double cap = (double)a.alloc[n * R + r];
  double safe = fmax(cap, 1.0);
  int64_t v = req_state[n * R + r] + (with_pod ? a.requests[p * R + r] : 0);
  return fmin(__ddiv_rn((double)v, safe), 1.0);
}

__device__ __forceinline__ bool balanced_present(const ScoreArgs& a, int64_t p, int64_t n,
                                                 int64_t r) {
  const int64_t R = a.R;
  const int64_t* bw = a.params + R;
  const int64_t* scal = a.params + 2 * R;
  return bw[r] > 0 && a.alloc[n * R + r] > 0 && (!scal[r] || a.requests[p * R + r] > 0);
}

// int64((1 - std(fractions)) * 100), the case split of _balanced_std
__device__ __forceinline__ int64_t balanced_side(const ScoreArgs& a, int64_t p, int64_t n,
                                                 const int64_t* req_state, bool with_pod) {
  const int64_t R = a.R;
  int64_t cnt = 0;
  double total = 0.0;
  for (int64_t r = 0; r < R; ++r) {
    if (!balanced_present(a, p, n, r)) continue;
    ++cnt;
    total = __dadd_rn(total, balanced_frac(a, p, n, r, req_state, with_pod));
  }
  double denom = (double)imax(cnt, 1);
  double mean = __ddiv_rn(total, denom);
  double sq = 0.0, absdev = 0.0;
  for (int64_t r = 0; r < R; ++r) {
    if (!balanced_present(a, p, n, r)) continue;
    double d = __dadd_rn(balanced_frac(a, p, n, r, req_state, with_pod), -mean);
    sq = __dadd_rn(sq, __dmul_rn(d, d));
    absdev = __dadd_rn(absdev, fabs(d));
  }
  double std_dev = 0.0;
  if (cnt == 2) std_dev = __ddiv_rn(absdev, 2.0);
  else if (cnt > 2) std_dev = __dsqrt_rn(__ddiv_rn(sq, denom));
  return (int64_t)__dmul_rn(__dadd_rn(1.0, -std_dev), (double)kMaxNodeScore);
}

// NodeResourcesBalancedAllocation
__device__ __forceinline__ int64_t balanced_score(const ScoreArgs& a, int64_t p, int64_t n,
                                                  const int64_t* req_state) {
  const int64_t R = a.R;
  const int64_t* bw = a.params + R;
  bool best_effort = true;
  for (int64_t r = 0; r < R; ++r)
    if (a.requests[p * R + r] != 0 && bw[r] != 0) best_effort = false;
  if (best_effort) return 0;
  int64_t with_pod = balanced_side(a, p, n, req_state, true);
  int64_t without_pod = balanced_side(a, p, n, req_state, false);
  return kMaxNodeScore / 2 + floordiv(kMaxNodeScore / 2 + with_pod - without_pod, 2);
}

// ImageLocality
__device__ __forceinline__ int64_t image_score(const ScoreArgs& a, int64_t p, int64_t n) {
  const int64_t min_t = 23LL * 1024 * 1024;
  const int64_t max_c = 1000LL * 1024 * 1024;
  int64_t s = a.img_sums[(int64_t)a.img_sig[p] * a.N + n];
  int64_t max_t = max_c * (int64_t)a.img_count[p];
  s = imin(imax(s, min_t), imax(max_t, min_t));
  return floordiv(kMaxNodeScore * (s - min_t), imax(max_t - min_t, 1));
}

// The weighted scores that need no normalization over nodes: fit, balanced
// and image locality. Plugin sums are int64 and exact, so adding the
// normalized node-affinity and taint terms afterwards gives the
// reference's total whatever the order.
__device__ __forceinline__ int64_t base_score(const ScoreArgs& a, int64_t p, int64_t n,
                                              const int64_t* req_state,
                                              const int64_t* nz_state) {
  int64_t total = 0;
  if (a.w_fit) total += a.w_fit * fit_score(a, p, n, nz_state);
  if (a.w_balanced) total += a.w_balanced * balanced_score(a, p, n, req_state);
  if (a.img_sums != nullptr) total += a.w_image * image_score(a, p, n);
  return total;
}

// DefaultNormalizeScore of one masked raw value against the row maximum
__device__ __forceinline__ int64_t normalize(int64_t v, int64_t mx, bool reverse) {
  int64_t s = mx > 0 ? floordiv(kMaxNodeScore * v, imax(mx, 1)) : 0;
  return reverse ? kMaxNodeScore - s : s;
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

// block-wide reduction helpers (blockDim.x a multiple of 32, <= 1024)
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

// max of four values over the block; s holds 4 x 33 int64. Every thread
// gets the results.
__device__ __forceinline__ void block_max4(int64_t (&v)[4], int64_t (*s)[33]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int i = 0; i < 4; ++i) {
    v[i] = warp_max(v[i]);
    if (lane == 0) s[i][warp] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
    for (int i = 0; i < 4; ++i) {
      int64_t x = lane < nwarps ? s[i][lane] : INT64_MIN;
      x = warp_max(x);
      if (lane == 0) s[i][32] = x;
    }
  }
  __syncthreads();
  for (int i = 0; i < 4; ++i) v[i] = s[i][32];
}

// block_max4 over fold_norm's maxima; without affinity score rows only the
// node-affinity and taint maxima are reduced (the cheaper two-value form)
__device__ __forceinline__ void block_max_norm(const ScoreArgs& a, int64_t (&m)[4],
                                               int64_t (*s)[33]) {
  if (a.w_interpod)
    block_max4(m, s);
  else
    block_max2(m[0], m[1], s[0], s[1]);
}

// the normalize inputs of one pair that passed Filter, folded into the
// running maxima: node-affinity and taint raws, the affinity raw's max and
// its negated min (so that all four reduce by max)
__device__ __forceinline__ void fold_norm(const ScoreArgs& a, int64_t row, int64_t n,
                                          int64_t pa_r, int64_t (&m)[4]) {
  if (a.na_raw != nullptr) m[0] = imax(m[0], a.na_raw[row + n]);
  if (a.tt_raw != nullptr) m[1] = imax(m[1], a.tt_raw[row + n]);
  if (a.w_interpod) {
    m[2] = imax(m[2], pa_r);
    m[3] = imax(m[3], -pa_r);
  }
}

// start values of fold_norm's maxima: the node-affinity and taint maxima
// start at 0 (masked_normalize zeroes infeasible raws), the affinity ones at
// the most negative value
__device__ __forceinline__ void init_norm(int64_t (&m)[4]) {
  m[0] = 0;
  m[1] = 0;
  m[2] = INT64_MIN;
  m[3] = INT64_MIN;
}

// the normalized terms of a pair given the reduced maxima. An infeasible
// pair (ok false) still gets the node-affinity and taint terms of a zero
// raw, as masked_normalize gives it; its affinity term is 0.
__device__ __forceinline__ int64_t norm_terms(const ScoreArgs& a, int64_t row, int64_t n,
                                              bool ok, int64_t pa_r, const int64_t (&m)[4]) {
  const int64_t na = (ok && a.na_raw != nullptr) ? a.na_raw[row + n] : 0;
  const int64_t tt = (ok && a.tt_raw != nullptr) ? a.tt_raw[row + n] : 0;
  int64_t s = normalized_terms(a, na, tt, m[0], m[1]);
  if (ok && a.w_interpod) s += a.w_interpod * pa_normalize(pa_r, -m[3], m[2]);
  return s;
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

}  // namespace kt
