// packing_round: the packing engine's solve on the card, one round a launch
// after filter_score has scored the whole batch against the round's state.
//
// Replaces kubetpu/assign/packing.py:259 packing_assign_device (jit, a
// lax.while_loop of rounds), with :146 _banded_tie_choice, :187
// _priority_order and :198 _accept_packed, and, fused into the node pass and
// the epilogue, kubetpu/ops/topology.py:64 slice_occupancy (B12). XLA ran
// each round as one program. Here:
//   packing_start (kt_packing_start), one block, once a solve: each pod's
//       admission rank (a bitonic sort of (-priority, pod) keys), its
//       coupled flag (host ports, a spread signature or an affinity
//       update), and lam * decay.
//   Each round (kt_packing_round), after filter_score:
//   (a) round_nodes, one block over the nodes: slice_occupancy's busy flag
//       of every slice from the current requested rows, then each node's
//       penalty alpha*closed + beta*emptiness + lam + bias (+ the slice
//       terms).
//   (b) round_pod_stats, one block per pod: over the pod's feasible row,
//       the largest |score|, then the best utility, then the tie count at
//       utility >= best - band and the group hash (the wrapping sum of the
//       tie row's per-node weights, xor best << 1, in unsigned arithmetic).
//   (c) round_rank, one block: the rank of each pod within its hash group
//       in queue order (a bitonic sort of (hash, pod)); r = rank mod ties.
//   (d) round_pick, one block per pod: the (r+1)-th tie column.
//   (e) round_accept, one block: sorts (node, admission rank); in each
//       node's segment the inclusive prefix sums of the requests and the
//       1-based count are held to the node's free resources and pod room
//       (when the profile filters on NodeResourcesFit), every chooser
//       counting, rejected ones too; at most one coupled pod a segment;
//       then the dual ascent lam = clip(lam + step * log1p(overflow), 0,
//       alpha * cap_frac) on every node, the first rejection in admission
//       order, finalize, and the commit of every admitted pod.
//   packing_end (kt_packing_end), one block, once a solve: the
//       equalization prices over the start state's node utilities, the
//       nodes used, and the objective with the slices newly opened
//       (slice_occupancy at the start and at the end).
//
// Bound: latency. The work that needs the whole card is filter_score's;
// a round adds five short launches, P blocks at most, and the host reads
// two flags a round (progress, any pod still active). Several pods land on
// one node in a round, so the commit updates the state with integer
// atomics (requested, nonzero, pod count, spread counts, affinity sums):
// integer sums do not depend on their order. A port bit is only ever set
// to 1, a nomination only cleared. No float is accumulated by atomics: the
// overflow counts are int32 atomics, and the objective's float sums are
// block reductions in a fixed order. P <= 1024: one thread per pod in the
// sorting blocks.
//
// Under a node mesh (kernel K5, kubetpu/parallel/mesh.py:369
// sharded_packing) every shard runs the same steps on its own N / G rows
// (kt_packing_tile, one step a launch), and the host combines the shards'
// partials between the steps (kt_shard_combine in batched_round.cu), at
// the points where a round reduces over nodes: the slice occupancy (a
// slice's nodes may span shards), the row maximum of |score| (as its
// float bits: |score| >= 0, so they order as the floats do and the max is
// exact), the best utility, the tie counts (their sum and each shard's
// prefix, for the pick) and the wrapping sums of the tie weights of the
// GLOBAL node indices (the xor with best << 1 once, after the sum), the
// choice, the admissions, the affinity increments, and at the end the
// marginal utility (float min), whether any node was used, the nodes used
// and the fragmentation (a float sum, added in shard order). The closed-
// node bias uses the GLOBAL node index (offset + n). The admission order,
// coupled flags and every pod-indexed vector are replicated: each shard
// computes them alike.
//
// On a pods x nodes grid (kernel K8, sharded_packing with pod_axis="pods")
// tile (i, j) holds pod row i's P / PG pods against node column j's rows,
// and every tile runs the same steps (kt_packing_tile). The per-pod
// statistics (row maximum, best utility, ties, hashes, the pick) are the
// tile's own pods' and combine over the pod row's columns; the host then
// joins the rows' best, hash and tie count in pod order (the combine's
// GATHER), so the rank runs over every pod in queue order. The start, the
// admissions, the dual ascent, the commit and the end read `full`: the
// tile's node column with every pod's pod-major leaves. Every tile of a
// column admits and commits every pod of that column into its own copy of
// the column's rows and duals, so the copies stay equal down the pod rows;
// the end's partials combine over each pod row's columns, so a column
// counts once. On one pod row `full` is the tile itself, the joined
// vectors are the row's combined statistics in place, and the launches are
// kernel K5's: no kernel loops over pod rows or reads their count.
//
// Float32 rounding: the reference's arithmetic runs through XLA on the
// CPU, which fuses a multiply into the add that takes it (FMA). This file
// rounds each step as the plain version (kubetpu_torch/assign/packing.py)
// does, which follows XLA: __fmaf_rn where XLA fuses, __fmul_rn / __fadd_rn
// / __fdiv_rn elsewhere (built with -fmad=false, so nothing else fuses).
// The score converts with __ll2float_rn, the utility rounds half to even
// with __float2ll_rn (as jnp.round; never roundf). log1p of the integer
// overflow count is XLA's own float32 log of k + 1 (a Cephes polynomial,
// its multiply-adds fused), not log1pf: the two differ at some counts.
#include "score_common.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kSortThreads = 1024;
constexpr int64_t kI64Min = -(1LL << 62);  // the reference's I64_MIN
constexpr float kUtilScale = 1048576.0f;    // 2^20

// the PackingWeights tensor's index order
enum { kScore, kPrio, kAlpha, kBeta, kStep, kDecay, kBand, kCapFrac, kSliceFrag, kSliceAlign };

using kt::block_reduce;
using kt::MaxOp;
using kt::MinOp;
using kt::SumOp;

__device__ __forceinline__ int64_t tie_weight(int64_t n) {
  return (n * 2654435761LL + 1) & 0xFFFFFFFFLL;
}

// float block reductions in a fixed order (warp tree, then the warps');
// every thread gets the result. s holds 33 floats.
struct FMin {
  __device__ float operator()(float x, float y) const { return fminf(x, y); }
};
struct FSum {
  __device__ float operator()(float x, float y) const { return __fadd_rn(x, y); }
};

template <typename Op>
__device__ __forceinline__ float block_reduce_f(float v, Op op, float ident, float* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) s[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < nwarps ? s[lane] : ident;
    for (int off = 16; off > 0; off >>= 1) x = op(x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) s[32] = x;
  }
  __syncthreads();
  const float out = s[32];
  __syncthreads();
  return out;
}

// jnp.log1p of a whole-number count k >= 0, as XLA's CPU backend computes
// it: 0 at 0, else its float32 log of k + 1
__device__ float log1p_count(float k) {
  if (k == 0.0f) return 0.0f;
  const float y = __fadd_rn(k, 1.0f);
  const int32_t bits = __float_as_int(y);
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  float e = __fadd_rn((float)((bits >> 23) - 127), 1.0f);
  const bool small = m < 0x1.6a09e6p-1f;
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float x = __fadd_rn(__fadd_rn(m, -1.0f), small ? m : 0.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  const float y1 = __fmaf_rn(__fmaf_rn(x, 0x1.204376p-4f, -0x1.d7a37p-4f), x, 0x1.de4a34p-4f);
  const float y2 = __fmaf_rn(__fmaf_rn(x, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), x, -0x1.555cap-3f);
  const float y3 = __fmaf_rn(__fmaf_rn(x, 0x1.999d58p-3f, -0x1.fffff8p-3f), x, 0x1.555554p-2f);
  const float poly = __fmaf_rn(__fmaf_rn(y1, x3, y2), x3, y3);
  const float r = __fmaf_rn(poly, x3, __fmul_rn(e, -0x1.bd0106p-13f));
  return __fadd_rn(__fadd_rn(__fsub_rn(x, __fmul_rn(x2, 0.5f)), r), __fmul_rn(e, 0x1.63p-1f));
}

// mean free fraction over node n's capacity-bearing resources, summed in
// resource order
__device__ float emptiness(const ScoreArgs& a, const int64_t* req, int64_t n) {
  const bool valid = a.node_valid[n];
  float acc = 0.0f;
  int cnt = 0;
  for (int64_t r = 0; r < a.R; ++r) {
    const int64_t al = a.alloc[n * a.R + r];
    float ff = 0.0f;
    if (valid && al > 0) {
      ff = __fdiv_rn(__ll2float_rn(al - req[n * a.R + r]), __ll2float_rn(al));
      ++cnt;
    }
    acc = __fadd_rn(acc, ff);
  }
  return __fdiv_rn(acc, (float)(cnt > 0 ? cnt : 1));
}

// fma(beta, emptiness, alpha * closed) + extra, then the closed-node bias
// closed * n * (2 * band) fused into the add that takes it; n is the global
// node index (a shard's rows start at `offset`)
__device__ float closed_terms(const ScoreArgs& a, const float* w, const int64_t* req,
                              const int32_t* pc, int64_t n, float extra, int64_t offset) {
  const bool closed = pc[n] == 0 && a.node_valid[n];
  const float base = __fmaf_rn(w[kBeta], emptiness(a, req, n), closed ? w[kAlpha] : 0.0f);
  return __fmaf_rn(closed ? (float)(n + offset) : 0.0f, __fmul_rn(2.0f, w[kBand]),
                   __fadd_rn(base, extra));
}

// slice_occupancy's busy flags (S + 1 ints, zeroed here) from the rows req;
// the whole block takes part
__device__ void slice_busy(const ScoreArgs& a, const int64_t* req, const int32_t* slice_id,
                           int64_t S, int32_t* busy) {
  for (int64_t s = threadIdx.x; s <= S; s += blockDim.x) busy[s] = 0;
  __syncthreads();
  for (int64_t n = threadIdx.x; n < a.N; n += blockDim.x) {
    if (!a.node_valid[n]) continue;
    unsigned long long sum = 0;
    for (int64_t r = 0; r < a.R; ++r) sum += (unsigned long long)req[n * a.R + r];
    if ((int64_t)sum > 0) busy[slice_id[n]] = 1;
  }
  __syncthreads();
}

// (a) each node's penalty this round. Over a node mesh (`mode` 1, then 2):
// 1 writes the shard's busy flags, which the shards' sums combine; 2 reads
// the combined counts (busy when > 0) and writes the penalties.
__global__ void __launch_bounds__(kSortThreads, 1)
round_nodes(ScoreArgs a, const float* w, const float* lam, const int32_t* slice_id, int64_t S,
            int32_t* busy, float* pen, int mode, int64_t offset) {
  if (slice_id != nullptr && mode != 2) slice_busy(a, a.requested, slice_id, S, busy);
  if (mode == 1) return;
  for (int64_t n = threadIdx.x; n < a.N; n += blockDim.x) {
    float v = closed_terms(a, w, a.requested, a.pod_count, n, lam[n], offset);
    if (slice_id != nullptr) {
      const int32_t sid = slice_id[n];
      const bool labeled = sid < S;
      const bool b = busy[sid] != 0;
      v = __fadd_rn(v, __fsub_rn(__fmul_rn(w[kSliceFrag], labeled && !b ? 1.0f : 0.0f),
                                 __fmul_rn(w[kSliceAlign], labeled && b ? 1.0f : 0.0f)));
    }
    pen[n] = v;
  }
}

__device__ __forceinline__ int64_t utility(int64_t score, float denom, float w_score, float pen) {
  const float norm = __fdiv_rn(__ll2float_rn(score), denom);
  return __float2ll_rn(__fmul_rn(__fmaf_rn(w_score, norm, -pen), kUtilScale));
}

__device__ __forceinline__ int64_t band_of(const float* w) {
  return __float2ll_rn(__fmul_rn(w[kBand], kUtilScale));
}

// (b) per-pod largest |score|, best utility, tie count and group hash
__global__ void round_pod_stats(ScoreArgs a, const uint8_t* mask, const int64_t* total,
                                const uint8_t* active, const float* pen, const float* w,
                                int64_t* best_out, int64_t* cnt_out, int64_t* hash_out,
                                float* denom_out) {
  __shared__ int64_t s[33];
  const int64_t p = blockIdx.x;
  const int64_t N = a.N;
  if (!active[p]) {
    if (threadIdx.x == 0) {
      best_out[p] = kI64Min;
      cnt_out[p] = 0;
      hash_out[p] = 0;
      denom_out[p] = 1.0f;
    }
    return;
  }
  const uint8_t* m = mask + p * N;
  const int64_t* t = total + p * N;
  // |score| >= 0: its float bits order as the floats do
  int64_t any = 0, rm = 0;
  for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
    if (!m[n]) continue;
    any = 1;
    const int64_t bits = __float_as_int(fabsf(__ll2float_rn(t[n])));
    rm = bits > rm ? bits : rm;
  }
  any = block_reduce(any, MaxOp(), 0, s);
  rm = block_reduce(rm, MaxOp(), 0, s);
  const float denom = fmaxf(__int_as_float((int)rm), 1.0f);
  const float w_score = w[kScore];
  int64_t best = kI64Min;
  for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
    if (!m[n]) continue;
    const int64_t u = utility(t[n], denom, w_score, pen[n]);
    best = u > best ? u : best;
  }
  best = block_reduce(best, MaxOp(), kI64Min, s);
  // best - band in unsigned arithmetic (wraps as XLA's int64 does)
  const int64_t thr = (int64_t)((unsigned long long)best - (unsigned long long)band_of(w));
  int64_t cnt = 0, h = 0;
  if (any) {
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      if (!m[n] || utility(t[n], denom, w_score, pen[n]) < thr) continue;
      ++cnt;
      h = SumOp()(h, tie_weight(n));
    }
  }
  cnt = block_reduce(cnt, SumOp(), 0, s);
  h = block_reduce(h, SumOp(), 0, s);
  if (threadIdx.x == 0) {
    h = (int64_t)((unsigned long long)h ^ ((unsigned long long)best << 1));
    best_out[p] = best;
    cnt_out[p] = any ? cnt : 0;
    hash_out[p] = any ? h : 0;
    denom_out[p] = denom;
  }
}

// (b) over a node mesh, in three steps with the shards' max / sums between
// them: 1 writes the shard's largest feasible |score| as float bits (-1
// without a feasible node or for an inactive pod) into rmx; 2, from the
// combined rmx, the denominator and the shard's best utility (kI64Min
// without a feasible node) into best; 3, at the combined best, the shard's
// tie count and the wrapping sum of its tie weights at the GLOBAL node
// indices (round_rank applies the xor).
__global__ void shard_pod_stats(ScoreArgs a, const uint8_t* mask, const int64_t* total,
                                const uint8_t* active, const float* pen, const float* w,
                                int step, int64_t* rmx, int64_t* best, float* denom_out,
                                int64_t* cnt_out, int64_t* hash_out, int64_t offset) {
  __shared__ int64_t s[33];
  const int64_t p = blockIdx.x;
  const int64_t N = a.N;
  const uint8_t* m = mask + p * N;
  const int64_t* t = total + p * N;
  const bool act = active[p];
  if (step == 1) {
    int64_t any = 0, rm = 0;
    if (act) {
      for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
        if (!m[n]) continue;
        any = 1;
        const int64_t bits = __float_as_int(fabsf(__ll2float_rn(t[n])));
        rm = bits > rm ? bits : rm;
      }
    }
    any = block_reduce(any, MaxOp(), 0, s);
    rm = block_reduce(rm, MaxOp(), 0, s);
    if (threadIdx.x == 0) rmx[p] = act && any ? rm : -1;
    return;
  }
  const int64_t rc = rmx[p];
  const float denom = rc >= 0 ? fmaxf(__int_as_float((int)rc), 1.0f) : 1.0f;
  const float w_score = w[kScore];
  if (step == 2) {
    int64_t b = kI64Min;
    if (act) {
      for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
        if (!m[n]) continue;
        const int64_t u = utility(t[n], denom, w_score, pen[n]);
        b = u > b ? u : b;
      }
    }
    b = block_reduce(b, MaxOp(), kI64Min, s);
    if (threadIdx.x == 0) {
      best[p] = b;
      denom_out[p] = denom;
    }
    return;
  }
  int64_t cnt = 0, h = 0;
  if (act && rc >= 0) {
    const int64_t thr = (int64_t)((unsigned long long)best[p] - (unsigned long long)band_of(w));
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      if (!m[n] || utility(t[n], denom, w_score, pen[n]) < thr) continue;
      ++cnt;
      h = SumOp()(h, tie_weight(n + offset));
    }
  }
  cnt = block_reduce(cnt, SumOp(), 0, s);
  h = block_reduce(h, SumOp(), 0, s);
  if (threadIdx.x == 0) {
    cnt_out[p] = cnt;
    hash_out[p] = h;
  }
}

// ascending bitonic sort of (key, idx) pairs in shared memory, M a power of
// two; the whole block takes part
__device__ __forceinline__ void bitonic_sort(int64_t* key, int32_t* idx, int M) {
  for (int k = 2; k <= M; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < M; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const bool gt = key[i] > key[l] || (key[i] == key[l] && idx[i] > idx[l]);
          if (((i & k) == 0) == gt) {
            const int64_t tk = key[i];
            key[i] = key[l];
            key[l] = tk;
            const int32_t ti = idx[i];
            idx[i] = idx[l];
            idx[l] = ti;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int pow2_at_least(int64_t P) {
  int M = 1;
  while (M < P) M <<= 1;
  return M;
}

// inclusive max-scan of s over positions [0, M), M <= blockDim.x (thread i
// owns position i)
__device__ __forceinline__ void max_scan(int32_t* s, int M) {
  const int i = threadIdx.x;
  for (int off = 1; off < M; off <<= 1) {
    int32_t v = 0;
    if (i < M) v = i >= off ? max(s[i], s[i - off]) : s[i];
    __syncthreads();
    if (i < M) s[i] = v;
    __syncthreads();
  }
}

// inclusive sum-scan (wrapping) of s over positions [0, M)
__device__ __forceinline__ void sum_scan(unsigned long long* s, int M) {
  const int i = threadIdx.x;
  for (int off = 1; off < M; off <<= 1) {
    unsigned long long v = 0;
    if (i < M) v = i >= off ? s[i] + s[i - off] : s[i];
    __syncthreads();
    if (i < M) s[i] = v;
    __syncthreads();
  }
}

// the once-a-solve start: admission rank, coupled flags, lam * decay
__global__ void __launch_bounds__(kSortThreads, 1)
packing_start(ScoreArgs a, const int32_t* prio, const float* w, const float* lam_in,
              float* lam_out, int32_t* order, uint8_t* coupled) {
  __shared__ int64_t s_key[kSortThreads];
  __shared__ int32_t s_idx[kSortThreads];
  const int64_t P = a.P;
  const int M = pow2_at_least(P);
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    int64_t key = INT64_MAX;
    if (i < P) {
      const int64_t pr = prio == nullptr ? 0 : prio[i];
      key = (a.pod_valid[i] ? -pr : (1LL << 40)) * P + i;
    }
    s_key[i] = key;
    s_idx[i] = i;
  }
  __syncthreads();
  bitonic_sort(s_key, s_idx, M);
  for (int i = threadIdx.x; i < P; i += blockDim.x) order[s_idx[i]] = i;
  for (int64_t p = threadIdx.x; p < P; p += blockDim.x) {
    bool c = false;
    for (int64_t k = 0; k < a.K; ++k) c = c || a.pod_ports[p * a.K + k];
    if (a.sp_pod_match_sig != nullptr)
      for (int64_t sg = 0; sg < a.sp_S; ++sg) c = c || a.sp_pod_match_sig[p * a.sp_S + sg];
    if (a.pa_update != nullptr)
      for (int64_t row = 0; row < a.pa_R; ++row) c = c || a.pa_update[p * a.pa_R + row] != 0;
    coupled[p] = c;
  }
  for (int64_t n = threadIdx.x; n < a.N; n += blockDim.x)
    lam_out[n] = __fmul_rn(lam_in[n], w[kDecay]);
}

// (c) rank of each pod within its hash group, by queue order; r = rank mod
// ties. Over a node mesh (`best` given) the combined hash takes the best
// utility's xor here, and cnt is the combined count.
__global__ void __launch_bounds__(kSortThreads, 1)
round_rank(ScoreArgs a, const int64_t* hash, const int64_t* cnt, int32_t* r_out,
           const int64_t* best) {
  __shared__ int64_t s_key[kSortThreads];
  __shared__ int32_t s_idx[kSortThreads];
  __shared__ int32_t s_start[kSortThreads];
  const int64_t P = a.P;
  const int M = pow2_at_least(P);
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    // pads sort after every real pod of an equal hash (higher index)
    int64_t key = INT64_MAX;
    if (i < P) {
      key = hash[i];
      if (best != nullptr)
        key = cnt[i] > 0 ? (int64_t)((unsigned long long)key ^
                                     ((unsigned long long)best[i] << 1))
                         : 0;
    }
    s_key[i] = key;
    s_idx[i] = i;
  }
  __syncthreads();
  bitonic_sort(s_key, s_idx, M);
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    s_start[i] = (i == 0 || s_key[i] != s_key[i - 1]) ? i : 0;
  __syncthreads();
  max_scan(s_start, M);
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const int32_t p = s_idx[i];
    if (p < P) {
      const int64_t rank = i - s_start[i];
      const int64_t c = cnt[p];
      r_out[p] = c > 0 ? (int32_t)(rank % c) : 0;
    }
  }
}

// (d) the (r+1)-th tie column of each pod's row (-1 without a feasible node)
// Over a node mesh (`before` given: the ties of the shards before this one,
// `cnt` this shard's own) the shard whose ties cover the (r+1)-th writes
// its GLOBAL index (offset + n); the others write -1 (the shards' max
// combines them).
__global__ void round_pick(ScoreArgs a, const uint8_t* mask, const int64_t* total,
                           const float* pen, const float* w, const int64_t* best,
                           const int64_t* cnt, const float* denom, const int32_t* r,
                           int32_t* choice, const int64_t* before, int64_t offset) {
  __shared__ int32_t s_warp[kRowThreads / 32];
  __shared__ int32_t s_base;
  const int64_t p = blockIdx.x;
  const int64_t N = a.N;
  const int64_t target = (int64_t)r[p] + 1 - (before != nullptr ? before[p] : 0);
  if (cnt[p] == 0 || target < 1 || target > cnt[p]) {
    if (threadIdx.x == 0) choice[p] = -1;
    return;
  }
  const uint8_t* m = mask + p * N;
  const int64_t* t = total + p * N;
  const int64_t thr = (int64_t)((unsigned long long)best[p] - (unsigned long long)band_of(w));
  const float d = denom[p];
  const float w_score = w[kScore];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) s_base = 0;
  __syncthreads();
  for (int64_t start = 0; start < N; start += blockDim.x) {
    const int64_t n = start + threadIdx.x;
    const bool tie = n < N && m[n] && utility(t[n], d, w_score, pen[n]) >= thr;
    const unsigned ballot = __ballot_sync(0xffffffffu, tie);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int64_t before = s_base;
    for (int v = 0; v < warp; ++v) before += s_warp[v];
    const int64_t pos = before + __popc(ballot & ((1u << lane) - 1)) + 1;
    if (tie && pos == target) choice[p] = (int32_t)(n + offset);
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int v = 0; v < nwarps; ++v) sum += s_warp[v];
      s_base += sum;
    }
    __syncthreads();
    if (s_base >= target) break;
  }
}

// (e) priority-ordered multi-admission, the dual ascent, finalize and the
// commit. Over a node mesh (`offset` the shard's first global node, the
// choices global): `mode` 1 admits the pods that chose this shard's nodes
// into acc_io (P,) int32, which the shards' max combines, and runs the dual
// ascent on the shard's nodes (their overflow is the shard's own); mode 2
// takes the combined admissions, finds the first rejection in admission
// order, commits this shard's admitted pods to its rows (pa_sums is then a
// zeroed delta, which the shards' sums add into every shard's sums), and
// updates the replicated active flags, nominations, assignments and flags.
__global__ void __launch_bounds__(kSortThreads, 1)
round_accept(ScoreArgs a, const int32_t* choice, const int32_t* order, const uint8_t* coupled,
             const float* w, int64_t* req, int64_t* nz, int32_t* pc, uint8_t* ports,
             int64_t* pa_sums, int32_t* sp_counts, uint8_t* active, int32_t* assignments,
             float* lam, int32_t* over, int32_t* flags, int mode, int32_t* acc_io,
             int64_t offset) {
  __shared__ int64_t s_key[kSortThreads];
  __shared__ int32_t s_idx[kSortThreads];
  __shared__ int32_t s_seg[kSortThreads];
  __shared__ unsigned long long s_cum[kSortThreads];
  __shared__ uint8_t s_acc[kSortThreads];
  __shared__ int64_t s_red[33];
  const int64_t P = a.P, N = a.N, R = a.R, K = a.K;
  const int M = pow2_at_least(P);
  // this shard's row of pod p's choice, -1 when it chose another shard's node
  auto mine = [&](int64_t p) -> int64_t {
    const int64_t c = (int64_t)choice[p] - offset;
    return choice[p] >= 0 && c >= 0 && c < N ? c : -1;
  };
  if (mode == 2) {
    for (int i = threadIdx.x; i < M; i += blockDim.x) s_acc[i] = i < P ? acc_io[i] != 0 : 0;
  } else {
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      // (node, admission rank): the rank is a permutation, so keys are unique
      s_key[i] = i < P ? (mine(i) >= 0 ? mine(i) : N) * P + order[i] : INT64_MAX;
      s_idx[i] = i;
      s_acc[i] = 0;
    }
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) over[n] = 0;
    __syncthreads();
    bitonic_sort(s_key, s_idx, M);
    // thread i owns sorted position i
    const int i = threadIdx.x;
    const bool real = i < P;
    const int64_t node = real ? s_key[i] / P : N;
    const int32_t pod = real ? s_idx[i] : 0;
    if (i < M) s_seg[i] = (i == 0 || !real || node != s_key[i - 1] / P) ? i : 0;
    __syncthreads();
    max_scan(s_seg, M);
    const int seg = i < M ? s_seg[i] : 0;
    const int32_t seg_pod = i < M ? s_idx[seg] : 0;
    bool ok = real && node < N;
    if (a.filter_fit) {
      // segment-relative inclusive prefix sums of each resource
      for (int64_t r = 0; r < R; ++r) {
        if (i < M) s_cum[i] = real ? (unsigned long long)a.requests[pod * R + r] : 0ULL;
        __syncthreads();
        sum_scan(s_cum, M);
        if (ok) {
          const int64_t within = (int64_t)(s_cum[i] - s_cum[seg]
                                           + (unsigned long long)a.requests[seg_pod * R + r]);
          ok = within <= a.alloc[node * R + r] - req[node * R + r];
        }
        __syncthreads();
      }
      if (ok) ok = (int64_t)(i - seg + 1) <= (int64_t)a.allowed_pods[node] - pc[node];
    }
    // one coupled pod a segment (rejected coupled choosers count too)
    if (i < M) s_cum[i] = real ? (unsigned long long)coupled[pod] : 0ULL;
    __syncthreads();
    sum_scan(s_cum, M);
    if (ok && coupled[pod]) ok = s_cum[i] - s_cum[seg] + coupled[seg_pod] == 1;
    if (real) s_acc[pod] = ok;
    if (real && node < N && !ok) atomicAdd(over + node, 1);
    __syncthreads();
    // dual ascent on every node: the overflow is the node's rejected choosers
    const float step = w[kStep];
    const float cap = __fmul_rn(w[kAlpha], w[kCapFrac]);
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      const float v = __fmaf_rn(step, log1p_count((float)over[n]), lam[n]);
      lam[n] = fminf(fmaxf(v, 0.0f), cap);
    }
    if (mode == 1) {
      for (int64_t p = threadIdx.x; p < P; p += blockDim.x) acc_io[p] = s_acc[p];
      return;
    }
  }
  __syncthreads();
  // the first rejection in admission order
  int64_t first_rej = P;
  for (int64_t p = threadIdx.x; p < P; p += blockDim.x)
    if (active[p] && choice[p] >= 0 && !s_acc[p] && order[p] < first_rej) first_rej = order[p];
  first_rej = block_reduce(first_rej, MinOp(), P, s_red);
  int64_t progress = 0, still = 0;
  for (int64_t p = threadIdx.x; p < P; p += blockDim.x) {
    if (!active[p]) continue;
    const int32_t c_global = choice[p];
    const int64_t c = mine(p);  // the row this shard writes, or none
    const bool commit = s_acc[p];
    const bool finalize = c_global < 0 && order[p] < first_rej;
    if (commit && c >= 0) {
      for (int64_t r = 0; r < R; ++r) {
        atomicAdd(reinterpret_cast<unsigned long long*>(req + c * R + r),
                  (unsigned long long)a.requests[p * R + r]);
        atomicAdd(reinterpret_cast<unsigned long long*>(nz + c * R + r),
                  (unsigned long long)a.nonzero_requests[p * R + r]);
      }
      atomicAdd(pc + c, 1);
      for (int64_t k = 0; k < K; ++k)
        if (a.pod_ports[p * K + k]) ports[c * K + k] = 1;
      if (pa_sums != nullptr) {
        for (int64_t row = 0; row < a.pa_R; ++row) {
          const int32_t dom = a.pa_node_domain[row * N + c];
          if (dom < 0) continue;
          atomicAdd(reinterpret_cast<unsigned long long*>(pa_sums + row * a.pa_D + dom),
                    (unsigned long long)a.pa_update[p * a.pa_R + row]);
        }
      }
      if (sp_counts != nullptr) {
        for (int64_t sg = 0; sg < a.sp_S; ++sg)
          if (a.sp_pod_match_sig[p * a.sp_S + sg] && a.sp_eligible[sg * N + c])
            atomicAdd(sp_counts + sg * N + c, 1);
      }
    }
    if (commit) {
      if (a.nom_node != nullptr) {
        for (int64_t g = 0; g < a.G; ++g)
          if (a.nom_pod_idx[g] == p) a.nom_active[g] = 0;
      }
      assignments[p] = c_global;
    }
    if (commit || finalize) {
      active[p] = 0;
      progress = 1;
    } else {
      still = 1;
    }
  }
  progress = block_reduce(progress, MaxOp(), 0, s_red);
  still = block_reduce(still, MaxOp(), 0, s_red);
  if (threadIdx.x == 0) {
    flags[0] = (int32_t)progress;
    flags[1] = (int32_t)still;
  }
}

// the once-a-solve end: equalization prices, nodes used, objective. Over a
// node mesh (`mode` 1, then 2; `offset` the shard's first global node): 1
// writes the shard's partials: the least start utility over its used
// nodes and its fragmentation sum into endf (2,) float32, whether it used a
// node and its nodes used into endi (2,) int64, and its busy flags at the
// start and at the end into busy (2 (S + 1),) int32; the shards' min, sum,
// max and sums combine them. 2 reads the combined partials, writes the
// shard's equalization prices, and the objective and nodes used (every
// shard alike).
__global__ void __launch_bounds__(kSortThreads, 1)
packing_end(ScoreArgs a, const int64_t* req0, const int32_t* pc0, const int64_t* req,
            const int32_t* pc, const int32_t* assignments, const int32_t* prio, const float* w,
            float* lam, const int32_t* slice_id, int64_t S, int32_t* busy, float* objective,
            int32_t* nodes_used, int mode, float* endf, int64_t* endi, int64_t offset) {
  __shared__ int64_t s_red[33];
  __shared__ float s_f[33];
  const int64_t N = a.N, P = a.P;
  const float pos_inf = __int_as_float(0x7f800000);
  float vmin = pos_inf, frag = 0.0f, adm = 0.0f;
  int64_t any = 0, used_nodes = 0;
  int32_t* busy0 = busy;
  int32_t* busy1 = busy + (S + 1);
  if (mode == 2) {
    vmin = endf[0];
    frag = endf[1];
    any = endi[0];
    used_nodes = endi[1];
  } else {
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      const bool valid = a.node_valid[n];
      if (pc[n] > pc0[n] && valid) {
        vmin = fminf(vmin, -closed_terms(a, w, req0, pc0, n, 0.0f, offset));
        any = 1;
      }
      if (pc[n] > 0 && valid) {
        ++used_nodes;
        frag = __fadd_rn(frag, emptiness(a, req, n));
      }
    }
    vmin = block_reduce_f(vmin, FMin(), pos_inf, s_f);
    frag = block_reduce_f(frag, FSum(), 0.0f, s_f);
    any = block_reduce(any, MaxOp(), 0, s_red);
    used_nodes = block_reduce(used_nodes, SumOp(), 0, s_red);
    if (slice_id != nullptr) {
      // busy flags at the start and at the end
      slice_busy(a, req0, slice_id, S, busy0);
      slice_busy(a, req, slice_id, S, busy1);
    }
    if (mode == 1) {
      if (threadIdx.x == 0) {
        endf[0] = vmin;
        endf[1] = frag;
        endi[0] = any;
        endi[1] = used_nodes;
      }
      return;
    }
  }
  if (any) {
    const float cap = __fmul_rn(w[kAlpha], w[kCapFrac]);
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      const float v0 = -closed_terms(a, w, req0, pc0, n, 0.0f, offset);
      lam[n] = fminf(fmaxf(__fsub_rn(v0, vmin), 0.0f), cap);
    }
  }
  for (int64_t p = threadIdx.x; p < P; p += blockDim.x) {
    if (assignments[p] < 0 || !a.pod_valid[p]) continue;
    const float pr = prio == nullptr ? 0.0f : (float)prio[p];
    adm = __fadd_rn(adm, __fadd_rn(1.0f, __fmul_rn(w[kPrio], pr)));
  }
  adm = block_reduce_f(adm, FSum(), 0.0f, s_f);
  int64_t newly = 0;
  if (slice_id != nullptr) {
    // slices opened from fully free: busy at the end, not at the start
    for (int64_t s = threadIdx.x; s < S; s += blockDim.x) newly += busy1[s] && !busy0[s];
    newly = block_reduce(newly, SumOp(), 0, s_red);
  }
  if (threadIdx.x == 0) {
    float obj = __fsub_rn(__fsub_rn(adm, __fmul_rn(w[kAlpha], (float)used_nodes)),
                          __fmul_rn(w[kBeta], frag));
    if (slice_id != nullptr) obj = __fsub_rn(obj, __fmul_rn(w[kSliceFrag], (float)newly));
    *objective = obj;
    *nodes_used = (int32_t)used_nodes;
  }
}

__global__ void packing_log1p(const float* k, float* ours, float* cuda, int64_t n) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  ours[i] = log1p_count(k[i]);
  cuda[i] = log1pf(k[i]);
}

}  // namespace

// Once a solve, before the rounds: order (P,) int32 each pod's admission
// rank, coupled (P,) uint8 its coupled flag, lam_out (N,) = lam_in * decay.
// prio (P,) int32 or null (all 0); w the (10,) float32 weights.
extern "C" int kt_packing_start(const ScoreArgs* args, const void* prio, const void* w,
                                const void* lam_in, void* lam_out, void* order, void* coupled,
                                void* stream) {
  const ScoreArgs a = *args;
  if (a.P > kSortThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  packing_start<<<1, kSortThreads, 0, s>>>(
      a, static_cast<const int32_t*>(prio), static_cast<const float*>(w),
      static_cast<const float*>(lam_in), static_cast<float*>(lam_out),
      static_cast<int32_t*>(order), static_cast<uint8_t*>(coupled));
  return (int)cudaGetLastError();
}

// The node pass alone, (a): pen (N,) float32 each node's penalty against
// the state args->requested / args->pod_count and lam (N,); slice_id (N,)
// int32 or null, S slices, busy (S + 1,) int32 scratch.
extern "C" int kt_packing_nodes(const ScoreArgs* args, const void* w, const void* lam,
                                const void* slice_id, int64_t S, void* busy, void* pen,
                                void* stream) {
  const ScoreArgs a = *args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  round_nodes<<<1, kSortThreads, 0, s>>>(a, static_cast<const float*>(w),
                                          static_cast<const float*>(lam),
                                          static_cast<const int32_t*>(slice_id), S,
                                          static_cast<int32_t*>(busy), static_cast<float*>(pen),
                                          0, 0);
  return (int)cudaGetLastError();
}

// One round on `stream`, after filter_score wrote `mask` and `total` (P, N)
// against the round's state. req / nz / pc / ports / pa_sums / sp_counts are
// the running state (pa_sums null without affinity rows, sp_counts without
// a spread leaf), updated in place; active (P,), assignments (P,) and lam
// (N,) likewise. order and coupled come from kt_packing_start; slice_id /
// S / busy as for kt_packing_nodes. Scratch: pen (N,) float32, stats64 (3,
// P) int64, stats32 (2, P) int32, denom (P,) float32, over (N,) int32.
// flags (2,) int32 receives (progress, any pod still active). Returns the
// cudaError_t of the launches (0 = all were accepted).
extern "C" int kt_packing_round(const ScoreArgs* args, const void* mask, const void* total,
                                void* req, void* nz, void* pc, void* ports, void* pa_sums,
                                void* sp_counts, void* active, void* assignments, void* lam,
                                const void* w, const void* order, const void* coupled,
                                const void* slice_id, int64_t S, void* busy, void* pen,
                                void* stats64, void* stats32, void* denom, void* over,
                                void* flags, void* stream) {
  const ScoreArgs a = *args;
  if (a.P == 0) return 0;
  if (a.P > kSortThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int64_t* t = static_cast<const int64_t*>(total);
  float* pn = static_cast<float*>(pen);
  int64_t* best = static_cast<int64_t*>(stats64);
  int64_t* cnt = best + a.P;
  int64_t* hash = cnt + a.P;
  int32_t* r = static_cast<int32_t*>(stats32);
  int32_t* choice = r + a.P;
  float* dn = static_cast<float*>(denom);
  uint8_t* act = static_cast<uint8_t*>(active);
  round_nodes<<<1, kSortThreads, 0, s>>>(a, wf, static_cast<const float*>(lam),
                                          static_cast<const int32_t*>(slice_id), S,
                                          static_cast<int32_t*>(busy), pn, 0, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  round_pod_stats<<<(unsigned)a.P, kRowThreads, 0, s>>>(a, m, t, act, pn, wf, best, cnt, hash,
                                                        dn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  round_rank<<<1, kSortThreads, 0, s>>>(a, hash, cnt, r, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  round_pick<<<(unsigned)a.P, kRowThreads, 0, s>>>(a, m, t, pn, wf, best, cnt, dn, r, choice,
                                                    nullptr, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  round_accept<<<1, kSortThreads, 0, s>>>(
      a, choice, static_cast<const int32_t*>(order), static_cast<const uint8_t*>(coupled), wf,
      static_cast<int64_t*>(req), static_cast<int64_t*>(nz), static_cast<int32_t*>(pc),
      static_cast<uint8_t*>(ports), static_cast<int64_t*>(pa_sums),
      static_cast<int32_t*>(sp_counts), act, static_cast<int32_t*>(assignments),
      static_cast<float*>(lam), static_cast<int32_t*>(over), static_cast<int32_t*>(flags), 0,
      nullptr, 0);
  return (int)cudaGetLastError();
}

// Once a solve, after the rounds: lam (N,) in place (the equalization
// prices when any node was used), objective () float32 and nodes_used ()
// int32. req0 / pc0 are the batch's start rows, req / pc the final state;
// busy is (2 * (S + 1),) int32 scratch when slice_id is given.
extern "C" int kt_packing_end(const ScoreArgs* args, const void* req0, const void* pc0,
                              const void* req, const void* pc, const void* assignments,
                              const void* prio, const void* w, void* lam, const void* slice_id,
                              int64_t S, void* busy, void* objective, void* nodes_used,
                              void* stream) {
  const ScoreArgs a = *args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  packing_end<<<1, kSortThreads, 0, s>>>(
      a, static_cast<const int64_t*>(req0), static_cast<const int32_t*>(pc0),
      static_cast<const int64_t*>(req), static_cast<const int32_t*>(pc),
      static_cast<const int32_t*>(assignments), static_cast<const int32_t*>(prio),
      static_cast<const float*>(w), static_cast<float*>(lam),
      static_cast<const int32_t*>(slice_id), S, static_cast<int32_t*>(busy),
      static_cast<float*>(objective), static_cast<int32_t*>(nodes_used), 0, nullptr, nullptr,
      0);
  return (int)cudaGetLastError();
}

namespace {

// One tile's buffers of a tiled solve (kernels K8 and K5); mirror of
// PackShard in kubetpu_torch/kernels/__init__.py (8-byte fields). Node-
// indexed arrays hold the tile's column of N / NG rows; stats, denom and
// mask the tile's Pb = P / PG pods; the other pod-indexed arrays all P.
struct PackShard {
  const uint8_t* mask;      // (Pb, N) this round's filter_score of the tile
  const int64_t* total;
  int64_t* req;             // running state, the shard's rows
  int64_t* nz;
  int32_t* pc;
  uint8_t* ports;
  int64_t* pa_delta;        // (RA, D) zeroed before step 7, or null
  int32_t* sp_counts;       // (S, N) or null
  uint8_t* active;          // (P,)
  int32_t* assignments;     // (P,) global node indices
  float* lam;               // (N,) the shard's duals, in place
  const float* w;           // (10,)
  int32_t* order;           // (P,)
  uint8_t* coupled;         // (P,)
  const int32_t* slice_id;  // (N,) or null
  int64_t S;
  int32_t* busy;            // (2 (S + 1),)
  float* pen;               // (N,)
  int64_t* stats;           // (7, Pb): rmx, best, cnt, hash, cnt_all, hash_all, before
  float* denom;             // (Pb,)
  int32_t* r;               // (P,)
  int32_t* choice;          // (2, P): this tile's picks (its pod row), the combined
  int32_t* acc;             // (2, P): this tile's admissions, the combined ones
  int32_t* over;            // (N,)
  int32_t* flags;           // (2,)
  const int64_t* req0;      // the shard's start rows
  const int32_t* pc0;
  const int32_t* prio;      // (P,) or null
  float* endf;              // (2,)
  int64_t* endi;            // (2,)
  float* objective;         // ()
  int32_t* nodes_used;      // ()
  const int64_t* fbest;     // (P,) every pod row's best, hash and tie count joined in
  const int64_t* fhash;     // pod order (on one pod row: stats' rows 1, 5, 4)
  const int64_t* fcount;
  int64_t pod_offset;       // the tile's first pod
  int64_t offset;           // the tile's first global node
};

}  // namespace

// One step of a tiled solve (kernel K8; on one pod row, a node mesh, kernel
// K5) on one tile, after its pod row's sharded filter_score wrote `mask`
// and `total`; the host combines the tiles' partials between the steps.
// `tile` is the tile's arguments (its Pb pods), `full` its node column with
// every pod's pod-major leaves (on one pod row, `tile` itself). 0: the
// start (order, coupled, lam *= decay) over every pod; each round: 1 the
// tile's busy flags (with a topology leaf); 2 its penalties (from the
// combined busy counts) and its pods' row maxima of |score| into stats[0];
// 3 their best utility into stats[1]; 4 their tie counts into stats[2] and
// hashes into stats[3]; 5 the ranks over every pod (from the joined fbest,
// fhash, fcount), then its pods' picks (stats[6] the ties before it) into
// its pod row's part of choice[0]; 6 the admissions of its column's
// choosers over every pod (from the combined choice[1]) into acc[0], and
// the dual ascent on its copy of the column's nodes; 7 the commit of every
// pod of its column (from the combined acc[1]) to its copy; at the end: 8
// its column's partials into endf, endi and busy; 9 its prices and the
// objective. Returns the cudaError_t of the launch.
extern "C" int kt_packing_tile(const ScoreArgs* tile, const ScoreArgs* full, int step,
                               const void* shard, void* stream) {
  const ScoreArgs at = *tile;
  const ScoreArgs af = *full;
  const PackShard& h = *static_cast<const PackShard*>(shard);
  if (af.P > kSortThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned Pb = (unsigned)at.P;
  int64_t *rmx = h.stats, *best = h.stats + at.P, *cnt = h.stats + 2 * at.P,
          *hash = h.stats + 3 * at.P, *before = h.stats + 6 * at.P;
  uint8_t* act = h.active + h.pod_offset;
  switch (step) {
    case 0:
      packing_start<<<1, kSortThreads, 0, s>>>(af, h.prio, h.w, h.lam, h.lam, h.order,
                                               h.coupled);
      break;
    case 1:
      round_nodes<<<1, kSortThreads, 0, s>>>(at, h.w, h.lam, h.slice_id, h.S, h.busy, h.pen, 1,
                                              h.offset);
      break;
    case 2: {
      round_nodes<<<1, kSortThreads, 0, s>>>(at, h.w, h.lam, h.slice_id, h.S, h.busy, h.pen, 2,
                                              h.offset);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      if (Pb) shard_pod_stats<<<Pb, kRowThreads, 0, s>>>(at, h.mask, h.total, act, h.pen, h.w,
                                                       1, rmx, best, h.denom, cnt, hash, h.offset);
      break;
    }
    case 3:
    case 4:
      if (Pb) shard_pod_stats<<<Pb, kRowThreads, 0, s>>>(at, h.mask, h.total, act, h.pen, h.w,
                                                       step - 1, rmx, best, h.denom, cnt, hash,
                                                       h.offset);
      break;
    case 5: {
      if (!af.P) break;
      round_rank<<<1, kSortThreads, 0, s>>>(af, h.fhash, h.fcount, h.r, h.fbest);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      if (Pb) round_pick<<<Pb, kRowThreads, 0, s>>>(at, h.mask, h.total, h.pen, h.w, best, cnt,
                                                  h.denom, h.r + h.pod_offset,
                                                  h.choice + h.pod_offset, before, h.offset);
      break;
    }
    case 6:
    case 7:
      if (af.P) round_accept<<<1, kSortThreads, 0, s>>>(
          af, h.choice + af.P, h.order, h.coupled, h.w, h.req, h.nz, h.pc, h.ports, h.pa_delta,
          h.sp_counts, h.active, h.assignments, h.lam, h.over, h.flags, step - 5,
          step == 6 ? h.acc : h.acc + af.P, h.offset);
      break;
    case 8:
    case 9:
      packing_end<<<1, kSortThreads, 0, s>>>(af, h.req0, h.pc0, h.req, h.pc, h.assignments,
                                              h.prio, h.w, h.lam, h.slice_id, h.S, h.busy,
                                              h.objective, h.nodes_used, step - 7, h.endf,
                                              h.endi, h.offset);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_packing_round_shard_size() { return (int64_t)sizeof(PackShard); }

// The dual ascent's log1p alone, for checking: ours (n,) float32 the
// kernel's log1p_count of each whole-number count k (n,) float32, and
// cuda (n,) float32 CUDA's log1pf of the same counts.
extern "C" int kt_packing_log1p(const void* k, void* ours, void* cuda, int64_t n,
                                void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  packing_log1p<<<(unsigned)((n + kRowThreads - 1) / kRowThreads), kRowThreads, 0, s>>>(
      static_cast<const float*>(k), static_cast<float*>(ours), static_cast<float*>(cuda), n);
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_packing_round_args_size() { return (int64_t)sizeof(ScoreArgs); }

extern "C" const char* kt_packing_round_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
