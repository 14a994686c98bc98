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
// On a pods x nodes grid (kernel K6) and under a node mesh, the grid of one
// pod row (kernel K2), the same kernels run a step a launch on each tile,
// with the mesh's combines between the steps (kt_tiled_round,
// kt_shard_combine below).
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

// (1) per-pod best score, tie count and group hash. Over a node mesh
// (`mode` 1, then 2; `offset` the shard's first global node): 1 writes the
// shard's best (kI64Min without a feasible node), which the shards' max
// combines into best_in; 2 writes, at that global best, the shard's tie
// count and the wrapping sum of the tie weights of the GLOBAL node
// indices, which the shards' sums combine (round_rank applies the xor).
__global__ void round_pod_stats(ScoreArgs a, const uint8_t* mask, const int64_t* total,
                                const uint8_t* active, int64_t* best_out, int64_t* cnt_out,
                                int64_t* hash_out, int mode, const int64_t* best_in,
                                int64_t offset) {
  __shared__ int64_t s[33];
  const int64_t p = blockIdx.x;
  const int64_t N = a.N;
  const bool act = active[p];
  const uint8_t* m = mask + p * N;
  const int64_t* t = total + p * N;
  int64_t any = 0, best = kI64Min;
  if (mode == 2) {
    best = best_in[p];
    any = act && best > kI64Min;
  } else {
    if (act) {
      for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
        if (!m[n]) continue;
        any = 1;
        best = t[n] > best ? t[n] : best;
      }
    }
    any = block_reduce(any, MaxOp(), 0, s);
    best = block_reduce(best, MaxOp(), kI64Min, s);
    if (mode == 1) {
      if (threadIdx.x == 0) best_out[p] = any ? best : kI64Min;
      return;
    }
  }
  int64_t cnt = 0, h = 0;
  if (any) {
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      if (!m[n] || t[n] != best) continue;
      ++cnt;
      h = SumOp()(h, tie_weight(n + offset));
    }
  }
  cnt = block_reduce(cnt, SumOp(), 0, s);
  h = block_reduce(h, SumOp(), 0, s);
  if (threadIdx.x == 0) {
    if (mode == 2) {
      cnt_out[p] = cnt;
      hash_out[p] = h;
      return;
    }
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
round_rank(ScoreArgs a, const int64_t* hash, const int64_t* cnt, int32_t* r_out,
           const int64_t* best) {
  __shared__ int64_t s_key[kSortThreads];
  __shared__ int32_t s_idx[kSortThreads];
  __shared__ int32_t s_start[kSortThreads];
  const int64_t P = a.P;
  const int M = pow2_at_least(P);
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    // pads sort after every real pod of an equal hash (higher index), so
    // they change no real pod's rank. Over a node mesh (`best` given) the
    // combined hash takes the best score's xor here; cnt is the combined
    // count.
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
// Over a node mesh (`before` given: the ties of the shards before this one,
// `cnt` this shard's own) the shard whose ties cover the (r+1)-th writes
// its GLOBAL index (offset + n); the others write -1 (the shards' max
// combines them).
__global__ void round_pick(ScoreArgs a, const uint8_t* mask, const int64_t* total,
                           const int64_t* best, const int64_t* cnt, const int32_t* r,
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
  const int64_t b = best[p];
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
    if (tie && pos == target) choice[p] = (int32_t)(n + offset);
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
// Over a node mesh (`offset` the shard's first global node, choices
// global): `mode` 1 admits the pods that chose this shard's nodes into
// acc_io (P,) int32, which the shards' max combines; mode 2 takes the
// combined admissions, commits the prefix, applies this shard's committed
// pods to its rows and counts, adds their affinity increments into pa_sums
// (a zeroed delta the shards' sums then add into every shard's sums), and
// updates the replicated active flags, nominations, assignments and flags.
__global__ void __launch_bounds__(kSortThreads, 1)
round_accept(ScoreArgs a, const int32_t* choice, int64_t* req, int64_t* nz, int32_t* pc,
             uint8_t* ports, int64_t* pa_sums, int32_t* sp_counts, uint8_t* active,
             int32_t* assignments, int32_t* flags, int mode, int32_t* acc_io,
             int64_t offset) {
  __shared__ int64_t s_key[kSortThreads];
  __shared__ int32_t s_idx[kSortThreads];
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
      s_key[i] = i < P ? (mine(i) >= 0 ? mine(i) : N) : INT64_MAX;  // none last
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
    if (mode == 1) {
      __syncthreads();
      for (int64_t p = threadIdx.x; p < P; p += blockDim.x) acc_io[p] = s_acc[p];
      return;
    }
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
    const int32_t c_global = choice[p];
    const bool commit = s_acc[p] && p < first_rej;
    const bool finalize = c_global < 0 && p < first_rej;
    // the row this shard writes: the chosen node's own row, or none
    const int64_t c = mode == 2 ? mine(p) : c_global;
    if (commit && c >= 0) {
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
    }
    if (commit) {
      if (a.nom_node != nullptr) {
        // the accepted nominee spends its nomination (batched.py:222-225)
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
  round_pod_stats<<<(unsigned)a.P, kRowThreads, 0, s>>>(a, m, t, act, best, cnt, hash, 0,
                                                         nullptr, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  round_rank<<<1, kSortThreads, 0, s>>>(a, hash, cnt, r, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  round_pick<<<(unsigned)a.P, kRowThreads, 0, s>>>(a, m, t, best, cnt, r, choice, nullptr, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  round_accept<<<1, kSortThreads, 0, s>>>(
      a, choice, static_cast<int64_t*>(req), static_cast<int64_t*>(nz),
      static_cast<int32_t*>(pc), static_cast<uint8_t*>(ports), static_cast<int64_t*>(pa_sums),
      static_cast<int32_t*>(sp_counts), act, static_cast<int32_t*>(assignments),
      static_cast<int32_t*>(flags), 0, nullptr, 0);
  return (int)cudaGetLastError();
}

namespace {

// One tile's buffers of a round over a pods x nodes grid (kernel K6);
// mirror of TileRound in kubetpu_torch/kernels/__init__.py (8-byte
// fields). Pb = P / PG pods a pod row, N = the tile's node column.
struct TileRound {
  const uint8_t* mask;     // (Pb, N) this round's filter_score of the tile
  const int64_t* total;
  int64_t* req;            // the tile's copy of its column's running rows
  int64_t* nz;
  int32_t* pc;
  uint8_t* ports;
  int64_t* pa_delta;       // (RA, D) zeroed before step 5, or null
  int32_t* sp_counts;      // (S, N) or null
  uint8_t* active;         // (P,) every pod's
  int32_t* assignments;    // (P,) global node indices
  int64_t* tstats;         // (5, Pb): best, count, hash, the row's count, ties before
  const int64_t* fbest;    // (P,) every pod row's best, hash and tie count joined
  const int64_t* fhash;    // in pod order (on one pod row: tstats' rows 0, 2, 3)
  const int64_t* fcount;
  int32_t* r;              // (P,)
  int32_t* choice;         // (2, P): this tile's picks (its pod row), the combined
  int32_t* acc;            // (2, P): this tile's admissions, the combined
  int32_t* flags;          // (2,)
  int64_t pod_offset;      // the tile's first pod
  int64_t offset;          // the tile's first global node
};

}  // namespace

// One step of a round over a pods x nodes grid (kernel K6; on one pod row,
// a node mesh, kernel K2) on one tile, after its pod row's sharded
// filter_score wrote `mask` and `total`; the host combines between the
// steps: within the pod row after steps 1 and 2 (the best score's max, the
// tie counts' prefix and sums, the hashes' sums), then across the pod rows
// (the rows' best, hash and count joined in pod order into fbest, fhash,
// fcount; on one pod row these are the row's own), after step 3 the picks'
// max over every tile, after step 4 the admissions' max, and after step 5
// the affinity increments' sum within each pod row. `tile` is the tile's
// arguments (its Pb pods), `full` the same node column with every pod's
// pod-major leaves (the rank, the admissions and the commit read every
// pod; on one pod row, `tile` itself). 1: the tile's best into tstats[0];
// 2: at the row's best its counts and hashes into tstats[1], tstats[2]; 3:
// the ranks over every pod, then the tile's picks into its pod row's part
// of choice[0]; 4: its column's admissions into acc[0]; 5: the commit to
// its column's rows (every pod row's copy takes every pod of the column).
// Returns the cudaError_t of the launch.
extern "C" int kt_tiled_round(const ScoreArgs* tile, const ScoreArgs* full, int step,
                              const void* bufs, void* stream) {
  const ScoreArgs at = *tile;
  const ScoreArgs af = *full;
  const TileRound& h = *static_cast<const TileRound*>(bufs);
  if (af.P == 0) return 0;
  if (af.P > kSortThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t Pb = at.P, P = af.P;
  int64_t *best = h.tstats, *cnt = h.tstats + Pb, *hash = h.tstats + 2 * Pb,
          *before = h.tstats + 4 * Pb;
  uint8_t* act = h.active + h.pod_offset;
  if (step == 1 || step == 2) {
    if (Pb) round_pod_stats<<<(unsigned)Pb, kRowThreads, 0, s>>>(
        at, h.mask, h.total, act, best, cnt, hash, step, best, h.offset);
  } else if (step == 3) {
    round_rank<<<1, kSortThreads, 0, s>>>(af, h.fhash, h.fcount, h.r, h.fbest);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (Pb) round_pick<<<(unsigned)Pb, kRowThreads, 0, s>>>(
        at, h.mask, h.total, best, cnt, h.r + h.pod_offset, h.choice + h.pod_offset, before,
        h.offset);
  } else if (step == 4 || step == 5) {
    round_accept<<<1, kSortThreads, 0, s>>>(
        af, h.choice + P, h.req, h.nz, h.pc, h.ports, h.pa_delta, h.sp_counts, h.active,
        h.assignments, h.flags, step - 3, step == 4 ? h.acc : h.acc + P, h.offset);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_batched_round_tile_size() { return (int64_t)sizeof(TileRound); }

namespace {

// Mirror of CombineArgs in kubetpu_torch/kernels/__init__.py
struct CombineArgs {
  const void* src[8];  // each shard's partial (n elements; `piece` for a gather)
  void* dst[8];        // each shard's result
  int64_t G, n, op, elem;  // elem: 8 (int64) or 4 (int32) bytes
  int64_t nsrc;        // a gather's sources
  int64_t piece;       // a gather's elements a source
};

template <typename T>
__device__ __forceinline__ void combine_one(const CombineArgs& c, int64_t i) {
  const T* const* src = reinterpret_cast<const T* const*>(c.src);
  T* const* dst = reinterpret_cast<T* const*>(c.dst);
  if (c.op == 4) {
    // exclusive prefix sum in shard order: each shard gets the sum before it
    T run = 0;
    for (int64_t h = 0; h < c.G; ++h) {
      const T v = src[h][i];
      dst[h][i] = run;
      run = (T)((unsigned long long)run + (unsigned long long)v);
    }
    return;
  }
  if (c.op == 6) {
    // gather: element i of the joined vector is element i mod piece of
    // source i / piece (the pod rows' per-pod vectors, in pod order)
    const T v = src[i / c.piece][i % c.piece];
    for (int64_t h = 0; h < c.G; ++h) dst[h][i] = v;
    return;
  }
  T v = src[0][i];
  for (int64_t h = 1; h < c.G; ++h) {
    const T w = src[h][i];
    if (c.op == 0) v = v > w ? v : w;
    else if (c.op == 3) v = v < w ? v : w;
    else if (c.op == 2) v = v | w;
    else v = (T)((unsigned long long)v + (unsigned long long)w);
  }
  for (int64_t h = 0; h < c.G; ++h)
    dst[h][i] = c.op == 5 ? (T)((unsigned long long)dst[h][i] + (unsigned long long)v) : v;
}

// The mesh's combine (kernels K2's and K6's cross-shard reductions): element
// i of every shard's partial, reduced, written to every shard's result
// (peer pointers for other cards). op 0 max, 1 sum (wrapping), 2 or, 3
// min, 4 exclusive prefix sum in shard order, 5 add the sum into the
// results, 6 gather (the G results each take the nsrc sources joined).
__global__ void shard_combine_kernel(CombineArgs c) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < c.n;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (c.elem == 8)
      combine_one<int64_t>(c, i);
    else
      combine_one<int32_t>(c, i);
  }
}

}  // namespace

// Launches the combine on `stream` (the caller orders every shard's stream
// before it, and after it every stream that reads the results). Returns
// the cudaError_t of the launch.
extern "C" int kt_shard_combine(const void* args, void* stream) {
  const CombineArgs c = *static_cast<const CombineArgs*>(args);
  if (c.n <= 0) return 0;
  if (c.G < 1 || c.G > 8 || (c.elem != 4 && c.elem != 8)) return (int)cudaErrorInvalidValue;
  if (c.op == 6 && (c.nsrc < 1 || c.nsrc > 8 || c.piece < 1 || c.nsrc * c.piece != c.n))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (c.n + 255) / 256;
  shard_combine_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(c);
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_batched_round_combine_size() { return (int64_t)sizeof(CombineArgs); }

extern "C" int64_t kt_batched_round_args_size() { return (int64_t)sizeof(ScoreArgs); }

extern "C" const char* kt_batched_round_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
