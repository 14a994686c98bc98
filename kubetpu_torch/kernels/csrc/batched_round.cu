// batched_round: one round of the batched engine, after filter_score has
// scored the whole batch against the round's state.
//
// Replaces the body of kubetpu/assign/batched.py:135 batched_assign_device
// (jit, a lax.while_loop of rounds), with :55 _tie_spread_choice and :94
// _accept, which XLA ran as one program per round. Each round:
//   (1) round_pod_stats, one block per pod: over the pod's feasible row
//       (mask AND the pod still active), the best score, the number of
//       nodes that tie at it, and the group hash: the wrapping sum over
//       the tie row of the per-node weights (n * 2654435761 + 1) mod 2^32,
//       xor the best score shifted left by one. The reference hashes in
//       uint64; int64 two's-complement arithmetic gives the same bits, and
//       only equality of hashes is read.
//   (2) round_rank, one block: sorts (hash, pod) pairs with its own bitonic
//       sort in shared memory, so each pod's rank within its hash group in
//       queue order is its sorted position minus its group's first
//       position (a max-scan); then r = rank mod tie count.
//   (3) round_pick, one block per pod: the (r+1)-th tie column of the pod's
//       row, by a block-wide running count of tie flags.
//   (4) round_accept, one block: sorts (chosen node, pod) pairs; the first
//       pod of each node group is accepted when its request fits the node's
//       free resources and a pod slot is left (only when the profile
//       filters on NodeResourcesFit); the queue-order prefix before the
//       first rejected pod commits, and pods with no feasible node inside
//       it finalize. Each committed pod then writes its node's state and
//       clears its own nominations (a.nom_active, which the next round's
//       filter_score reads).
//
// Bound: latency. The work that needs the whole card is filter_score's; the
// round body is four short launches with P blocks at most. Design notes:
// each node takes at most one pod a round, so the resource, pod-count,
// port and spread-count updates are plain writes by the pod's thread (the
// next round's filter_score derives the spread domain sums afresh from the
// counts); the affinity sums
// take 64-bit atomic adds, since several pods can land in one domain
// (integer adds, so the order does not change the result). P <= 1024: one
// thread per pod in the sorting blocks. The loop over rounds runs on the
// host, which reads two flags a round (progress, any pod still active).
#include "score_common.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kSortThreads = 1024;
constexpr int64_t kI64Min = -(1LL << 62);  // the reference's I64_MIN

using kt::block_reduce;
using kt::MaxOp;
using kt::MinOp;
using kt::SumOp;

__device__ __forceinline__ int64_t tie_weight(int64_t n) {
  return (n * 2654435761LL + 1) & 0xFFFFFFFFLL;
}

// (1) per-pod best score, tie count and group hash
__global__ void round_pod_stats(ScoreArgs a, const uint8_t* mask, const int64_t* total,
                                const uint8_t* active, int64_t* best_out, int64_t* cnt_out,
                                int64_t* hash_out) {
  __shared__ int64_t s[33];
  const int64_t p = blockIdx.x;
  const int64_t N = a.N;
  const bool act = active[p];
  const uint8_t* m = mask + p * N;
  const int64_t* t = total + p * N;
  int64_t any = 0, best = kI64Min;
  if (act) {
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      if (!m[n]) continue;
      any = 1;
      best = t[n] > best ? t[n] : best;
    }
  }
  any = block_reduce(any, MaxOp(), 0, s);
  best = block_reduce(best, MaxOp(), kI64Min, s);
  int64_t cnt = 0, h = 0;
  if (any) {
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      if (!m[n] || t[n] != best) continue;
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

// (2) rank of each pod within its hash group, by queue order; r = rank mod
// ties
__global__ void __launch_bounds__(kSortThreads, 1)
round_rank(ScoreArgs a, const int64_t* hash, const int64_t* cnt, int32_t* r_out) {
  __shared__ int64_t s_key[kSortThreads];
  __shared__ int32_t s_idx[kSortThreads];
  __shared__ int32_t s_start[kSortThreads];
  const int64_t P = a.P;
  const int M = pow2_at_least(P);
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    // pads sort after every real pod of an equal hash (higher index), so
    // they change no real pod's rank
    s_key[i] = i < P ? hash[i] : INT64_MAX;
    s_idx[i] = i;
  }
  __syncthreads();
  bitonic_sort(s_key, s_idx, M);
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    s_start[i] = (i == 0 || s_key[i] != s_key[i - 1]) ? i : 0;
  __syncthreads();
  // inclusive max-scan: each position's group start (M <= blockDim.x, so
  // thread i owns position i)
  const int i0 = threadIdx.x;
  for (int off = 1; off < M; off <<= 1) {
    int v = 0;
    if (i0 < M) v = i0 >= off ? max(s_start[i0], s_start[i0 - off]) : s_start[i0];
    __syncthreads();
    if (i0 < M) s_start[i0] = v;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const int32_t p = s_idx[i];
    if (p < P) {
      const int64_t rank = i - s_start[i];
      const int64_t c = cnt[p];
      r_out[p] = c > 0 ? (int32_t)(rank % c) : 0;
    }
  }
}

// (3) the (r+1)-th tie column of each pod's row (-1 without a feasible node)
__global__ void round_pick(ScoreArgs a, const uint8_t* mask, const int64_t* total,
                           const int64_t* best, const int64_t* cnt, const int32_t* r,
                           int32_t* choice) {
  __shared__ int32_t s_warp[kRowThreads / 32];
  __shared__ int32_t s_base;
  const int64_t p = blockIdx.x;
  const int64_t N = a.N;
  if (cnt[p] == 0) {
    if (threadIdx.x == 0) choice[p] = -1;
    return;
  }
  const uint8_t* m = mask + p * N;
  const int64_t* t = total + p * N;
  const int64_t b = best[p];
  const int64_t target = (int64_t)r[p] + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) s_base = 0;
  __syncthreads();
  for (int64_t start = 0; start < N; start += blockDim.x) {
    const int64_t n = start + threadIdx.x;
    const bool tie = n < N && m[n] && t[n] == b;
    const unsigned ballot = __ballot_sync(0xffffffffu, tie);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int64_t before = s_base;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    const int64_t pos = before + __popc(ballot & ((1u << lane) - 1)) + 1;
    if (tie && pos == target) choice[p] = (int32_t)n;
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int w = 0; w < nwarps; ++w) sum += s_warp[w];
      s_base += sum;
    }
    __syncthreads();
    if (s_base >= target) break;
  }
}

// (4) one-per-node acceptance, prefix commit, finalize and the state update
__global__ void __launch_bounds__(kSortThreads, 1)
round_accept(ScoreArgs a, const int32_t* choice, int64_t* req, int64_t* nz, int32_t* pc,
             uint8_t* ports, int64_t* pa_sums, int32_t* sp_counts, uint8_t* active,
             int32_t* assignments, int32_t* flags) {
  __shared__ int64_t s_key[kSortThreads];
  __shared__ int32_t s_idx[kSortThreads];
  __shared__ uint8_t s_acc[kSortThreads];
  __shared__ int64_t s_red[33];
  const int64_t P = a.P, N = a.N, R = a.R, K = a.K;
  const int M = pow2_at_least(P);
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    s_key[i] = i < P ? (choice[i] >= 0 ? choice[i] : N) : INT64_MAX;  // none last
    s_idx[i] = i;
    s_acc[i] = 0;
  }
  __syncthreads();
  bitonic_sort(s_key, s_idx, M);
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const int32_t p = s_idx[i];
    if (p >= P) continue;
    const int64_t node = s_key[i];
    bool ok = (i == 0 || s_key[i] != s_key[i - 1]) && node < N;
    if (ok && a.filter_fit) {
      for (int64_t r = 0; r < R; ++r)
        ok = ok && a.requests[p * R + r] <= a.alloc[node * R + r] - req[node * R + r];
      ok = ok && a.allowed_pods[node] - pc[node] >= 1;
    }
    s_acc[p] = ok && choice[p] >= 0;
  }
  __syncthreads();
  // the queue-order prefix before the first rejection
  int64_t first_rej = P;
  for (int64_t p = threadIdx.x; p < P; p += blockDim.x)
    if (active[p] && choice[p] >= 0 && !s_acc[p]) first_rej = p < first_rej ? p : first_rej;
  first_rej = block_reduce(first_rej, MinOp(), P, s_red);
  int64_t progress = 0, still = 0;
  for (int64_t p = threadIdx.x; p < P; p += blockDim.x) {
    if (!active[p]) continue;
    const int32_t c = choice[p];
    const bool commit = s_acc[p] && p < first_rej;
    const bool finalize = c < 0 && p < first_rej;
    if (commit) {
      for (int64_t r = 0; r < R; ++r) {
        req[c * R + r] += a.requests[p * R + r];
        nz[c * R + r] += a.nonzero_requests[p * R + r];
      }
      pc[c] += 1;
      for (int64_t k = 0; k < K; ++k) ports[c * K + k] = ports[c * K + k] | a.pod_ports[p * K + k];
      if (pa_sums != nullptr) {
        for (int64_t row = 0; row < a.pa_R; ++row) {
          const int32_t dom = a.pa_node_domain[row * N + c];
          if (dom < 0) continue;
          atomicAdd(reinterpret_cast<unsigned long long*>(pa_sums + row * a.pa_D + dom),
                    (unsigned long long)a.pa_update[p * a.pa_R + row]);
        }
      }
      if (sp_counts != nullptr) {
        // spread updateWithPod: +1 at node c in every signature the pod
        // matches and c is eligible for; c takes no other pod this round
        for (int64_t sg = 0; sg < a.sp_S; ++sg)
          if (a.sp_pod_match_sig[p * a.sp_S + sg] && a.sp_eligible[sg * N + c])
            sp_counts[sg * N + c] += 1;
      }
      if (a.nom_node != nullptr) {
        // the accepted nominee spends its nomination (batched.py:222-225)
        for (int64_t g = 0; g < a.G; ++g)
          if (a.nom_pod_idx[g] == p) a.nom_active[g] = 0;
      }
      assignments[p] = c;
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

}  // namespace

// One round on `stream`, after filter_score wrote `mask` and `total` (P, N)
// against the round's state. req / nz / pc / ports / pa_sums / sp_counts
// are the running state (pa_sums null without affinity rows, sp_counts
// without a spread leaf), updated in place;
// active (P,) and assignments (P,) likewise. stats64 is (3, P) int64 and
// stats32 (2, P) int32 scratch; flags (2,) int32 receives (progress, any
// pod still active). Returns the cudaError_t of the launches (0 = all were
// accepted).
extern "C" int kt_batched_round(const ScoreArgs* args, const void* mask, const void* total,
                                void* req, void* nz, void* pc, void* ports, void* pa_sums,
                                void* sp_counts, void* active, void* assignments,
                                void* stats64, void* stats32, void* flags, void* stream) {
  const ScoreArgs a = *args;
  if (a.P == 0) return 0;
  if (a.P > kSortThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int64_t* t = static_cast<const int64_t*>(total);
  int64_t* best = static_cast<int64_t*>(stats64);
  int64_t* cnt = best + a.P;
  int64_t* hash = cnt + a.P;
  int32_t* r = static_cast<int32_t*>(stats32);
  int32_t* choice = r + a.P;
  uint8_t* act = static_cast<uint8_t*>(active);
  round_pod_stats<<<(unsigned)a.P, kRowThreads, 0, s>>>(a, m, t, act, best, cnt, hash);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  round_rank<<<1, kSortThreads, 0, s>>>(a, hash, cnt, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  round_pick<<<(unsigned)a.P, kRowThreads, 0, s>>>(a, m, t, best, cnt, r, choice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  round_accept<<<1, kSortThreads, 0, s>>>(
      a, choice, static_cast<int64_t*>(req), static_cast<int64_t*>(nz),
      static_cast<int32_t*>(pc), static_cast<uint8_t*>(ports), static_cast<int64_t*>(pa_sums),
      static_cast<int32_t*>(sp_counts), act, static_cast<int32_t*>(assignments),
      static_cast<int32_t*>(flags));
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_batched_round_args_size() { return (int64_t)sizeof(ScoreArgs); }

extern "C" const char* kt_batched_round_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
