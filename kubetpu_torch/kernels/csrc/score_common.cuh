// Filter verdict and raw plugin scores of ONE (pod, node) pair, shared by
// the filter_score and greedy_scan kernels so the two cannot drift apart.
//
// Replaces, fused per pair, the jitted jnp compositions of the JAX package:
//   kubetpu/ops/filters.py:22 resource_fit_mask (+ :76 the single-pod form)
//   kubetpu/framework/runtime.py:1412 the NodePorts conflict contraction
//   kubetpu/ops/scores.py:53 / :82 / :121 the three fit strategies
//     (+ :101 _trunc_div, :108 broken_linear, :21 _weighted_mean)
//   kubetpu/ops/scores.py:174 balanced_allocation_score (+ :156 _balanced_std)
//   kubetpu/ops/scores.py:215 default_normalize, :227 image_locality_score
//
// Exactness: every integer is int64 as in the reference (which runs with
// jax x64). `//` in the reference floors; C++ `/` truncates, so floordiv()
// is used wherever the reference floors. The balanced score is float64 with
// explicitly rounded intrinsics (__dadd_rn, __dmul_rn, __ddiv_rn,
// __dsqrt_rn): no fused multiply-add can change a rounding, and the sums
// over R run in index order, as the plain PyTorch version's loop does.
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

}  // namespace kt
