// The per-batch pre-launches that every pair verdict of the dynamic filters
// reads, shared by filter_score.cu and filter_component_masks.cu (each
// library compiles its own copy):
//   (0)  only with affinity rows: each (RA, D) sums row summed over its
//        domains (the self-affinity escape reads the total), one thread a
//        row;
//   (0s) only with a spread leaf whose filter or score is on: one block per
//        signature sums its counts over eligible nodes into the (S, D+1)
//        domain sums (slot D is domain -1's bucket) and reduces its
//        minMatch over present domains.
// Both write the ScoreArgs scratch (pa_row_total; sp_sums, sp_min_match).
#pragma once

#include "score_common.cuh"

namespace kt {

constexpr int kPreRowThreads = 512;
constexpr int kPreTotalThreads = 256;

__global__ void prelaunch_row_totals(ScoreArgs a) {
  pa_row_totals(a, a.pa_sums, a.pa_row_total,
                (int64_t)blockIdx.x * blockDim.x + threadIdx.x,
                (int64_t)gridDim.x * blockDim.x);
}

// mode 0: the domain sums and minMatch; 1 (a node shard's step before its
// sums are summed over the mesh): the sums of its own nodes only; 2 (after
// that): minMatch from the sums as they stand
__global__ void prelaunch_spread_sums(ScoreArgs a, int mode) {
  __shared__ int64_t s_red[33];
  const int64_t s = blockIdx.x, D1 = a.sp_D + 1;
  if (mode != 2) {
    for (int64_t d = threadIdx.x; d < D1; d += blockDim.x) a.sp_sums[s * D1 + d] = 0;
    __syncthreads();
    sp_accumulate(a, a.sp_counts, a.sp_sums, s, a.sp_S);
    __syncthreads();
  }
  if (mode == 1) return;
  const int64_t mm = sp_min_over_domains(a, a.sp_sums, s, s_red);
  if (threadIdx.x == 0) a.sp_min_match[s] = mm;
}

// Launch (0s) when `sp` and the spread filter or score is on, and (0) when
// `pa`, on stream s. `spread_mode` is (0s)'s mode (prelaunch_spread_sums).
// Returns the first launch error (cudaSuccess = none).
inline cudaError_t prelaunch(const ScoreArgs& a, int pa, int sp, cudaStream_t s,
                             int spread_mode = 0) {
  if (sp && (a.sp_filter || a.w_spread) && a.sp_S > 0) {
    prelaunch_spread_sums<<<(unsigned)a.sp_S, kPreRowThreads, 0, s>>>(a, spread_mode);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (pa && a.pa_R > 0) {
    prelaunch_row_totals<<<(unsigned)((a.pa_R + kPreTotalThreads - 1) / kPreTotalThreads),
                           kPreTotalThreads, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace kt
