// The two per-pod passes of filter_score, as device functions: the pair
// verdict with its base score (filter_score's pass (a)) and the normalize
// pass of one pod (pass (b), block-wide). filter_score.cu launches them as
// kernels of their own; the packing and batched solves (packing_round.cu,
// batched_round.cu) run them inside their one launch a solve, on each pod
// class's first pod, so that all compute the same verdicts and totals by
// the same code.
#pragma once

#include "score_common.cuh"

namespace kt {

// One pair's verdict into *mask_out and (normal mode) its base score into
// *base_out: the victim-independent filters first, then (normal mode) the
// dependent ones; with_pa: the InterPodAffinity filter runs (the batch has
// affinity rows and its sums are current). Potential mode (the preemption
// evaluator's mask): "every victim-independent filter passes and
// NodeResourcesFit or NodePorts fails", and no score.
__device__ __forceinline__ void pair_pass(const ScoreArgs& a, int64_t p, int64_t n, int with_pa,
                                          int potential, uint8_t* mask_out, int64_t* base_out) {
  bool ok = pair_static(a, p, n);
  if (!potential && ok)
    ok = pair_extender(a, p, n) && pair_dependent(a, p, n, a.requested, a.pod_count, a.node_ports);
  if (ok && with_pa && a.pa_filter)
    ok = pa_feasible(a, a.pa_sums, pa_escape(a, a.pa_row_total, p), p, n);
  if (ok && a.sp_filter) ok = sp_feasible(a, a.sp_sums, a.sp_min_match, p, n);
  if (potential) {
    *mask_out = ok && !pair_dependent(a, p, n, a.requested, a.pod_count, a.node_ports);
    return;
  }
  *mask_out = ok;
  *base_out = base_score(a, p, n, a.requested, a.nonzero_requested);
}

// The normalize pass of pod p, block-wide (every thread calls it): m, base
// and total are p's (N,) rows (total may be base: each element is read
// before it is written, by the same thread). `phase` 0: the whole pass.
// Over a node mesh, three phases with the shards' partials combined between
// them: 1 writes this shard's spread-scored count into *sc and its domain
// bitmaps into bits (C * ceil(D / 32) int64); 2 takes the combined ones
// from *sc / bits and writes this shard's normalize maxima into mx (kNorm);
// 3 takes the combined maxima from mx and writes the total. Phase 0 keeps
// its domain bitmap in shared memory after the weights, or in a.sp_bits
// (p's row) when that is not null. s_dyn: the block's dynamic shared
// memory (C doubles of slot weights, then the bitmap); s_m: kNorm rows of
// 33 int64 of shared scratch.
__device__ __forceinline__ void normalize_pass(const ScoreArgs& a, int64_t p, const uint8_t* m,
                                               const int64_t* base, int64_t* total, int phase,
                                               int64_t* sc, int64_t* bits, int64_t* mx,
                                               unsigned char* s_dyn, int64_t (*s_m)[33]) {
  const int64_t N = a.N;
  const bool sp_score = a.w_spread && sp_any_soft(a, p);
  const bool normalize = a.na_raw != nullptr || a.tt_raw != nullptr || a.w_interpod ||
                         sp_score || a.dra_raw != nullptr;
  const int64_t row =
      (a.na_raw != nullptr || a.tt_raw != nullptr) ? (int64_t)a.score_sig[p] * N : 0;
  const int64_t drow = dra_row(a, p);
  double* weight = reinterpret_cast<double*>(s_dyn);
  if (phase == 1) {
    if (sp_score) sp_partials(a, p, m, sc, bits, s_m[0]);
    return;
  }
  if (sp_score) {
    if (phase == 0) {
      uint32_t* bitmap = a.sp_bits != nullptr
                             ? a.sp_bits + p * ((a.sp_D + 31) / 32)
                             : reinterpret_cast<uint32_t*>(s_dyn + a.sp_C * sizeof(double));
      sp_weights(a, p, m, bitmap, weight, s_m[0]);
    } else {
      sp_weights_given(a, p, *sc, bits, weight, s_m[0]);
    }
  }
  int64_t mv[kNorm];
  init_norm(mv);
  if (normalize && phase != 3) {
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      if (!m[n]) continue;
      const int64_t pa_r = a.w_interpod ? pa_raw(a, a.pa_sums, p, n) : 0;
      fold_norm(a, row, drow, n, pa_r,
                sp_scored_raw(a, sp_score, a.sp_counts, a.sp_sums, weight, p, n), mv);
    }
    block_max_norm(a, sp_score, mv, s_m);
  }
  if (phase == 2) {
    if (threadIdx.x == 0)
      for (int i = 0; i < kNorm; ++i) mx[i] = mv[i];
    return;
  }
  if (phase == 3)
    for (int i = 0; i < kNorm; ++i) mv[i] = mx[i];
  for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
    int64_t s = base[n];
    if (normalize) {
      const bool ok = m[n];
      const int64_t pa_r = (ok && a.w_interpod) ? pa_raw(a, a.pa_sums, p, n) : 0;
      const int64_t sp =
          ok ? sp_scored_raw(a, sp_score, a.sp_counts, a.sp_sums, weight, p, n) : -1;
      s += norm_terms(a, row, drow, n, ok, pa_r, sp, mv);
    }
    total[n] = s;
  }
}

}  // namespace kt
