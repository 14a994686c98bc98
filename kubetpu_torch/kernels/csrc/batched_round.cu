// batched_round: the batched engine's whole solve on the card, one launch a
// solve on each card (kernel B6 unsharded; K2 over a node mesh, K6 over a
// pods x nodes grid); and the mesh's combine (shard_combine below).
//
// Replaces kubetpu/assign/batched.py:135 batched_assign_device (jit, a
// lax.while_loop of rounds), with :55 _tie_spread_choice and :94 _accept
// and the Filter + Score each round reads (kubetpu/framework/runtime.py:1578
// filter_score_batch, as filter_score.cu computes it, through
// filter_pass.cuh); under a mesh kubetpu/parallel/mesh.py:352
// sharded_batched (with pod_axis="pods" on a grid). XLA ran the loop as one
// program, its stop rule (`cond`: any(active) & progress & (rounds < cap))
// on the device.
//
// Bound: latency. A round is a chain of dependent steps, each a reduction
// over the nodes or over the pods that the next step reads: the Filter +
// Score of the round's state, each pod's best score, tie count and group
// hash, the rank in its hash group, the pick, the admissions, the commit.
// Design: ONE cooperative launch a solve on each card, holding every tile
// of the card (bpt blocks a tile, all co-resident), the round loop and its
// stop rule inside it; the steps are separated by a grid-wide barrier
// (solve_sync.cuh's card_sync, shared with the packing solve), and, where
// a step reads other cards' partials, by the mesh's exchange (exchange.cuh's
// sequence words, once a barrier, bounded by EXCHANGE_BUDGET). The host
// reads once a solve: the rounds and the error word.
//
// Pod classes (runtime.PodClasses): two pods of one class have equal
// Filter + Score rows, so every per-pod statistic of a round depends only
// on the pod's class and on whether it is still active. The solve keeps one
// row a class (its first pod's): the verdicts and totals, the best score,
// and the tie nodes in node order with their count and hash (the wrapping
// sum over the ties of the per-node weights (n * 2654435761 + 1) mod 2^32
// of the GLOBAL node index n, xor the best score shifted left by one, once,
// after the sum). A batch without classes (extender rows) is one class a
// pod. A pod's group key is its class's hash when it is active and its
// class has a feasible node, else 0; its rank is the count of the earlier
// pods of an equal key, every pod counting (kubetpu's stable sort of
// (key, pod)), and its pick the (rank mod ties)-th tie node of its class.
// The admissions need no sort either: a node's first chooser in queue order
// (an atomic minimum over its choosers' indices) is admitted when the
// profile does not filter on NodeResourcesFit, or when its request fits the
// node's free resources and a pod slot is left. The queue-order prefix
// before the first rejected pod commits, and the pods in it without a pick
// finalize. The reference hashes in uint64; int64 two's-complement
// arithmetic gives the same bits, and only equality of keys is read.
//
// Each node takes at most one pod a round, so the resource, pod-count,
// port and spread-count updates of the commit are plain writes (the next
// round's spread domain sums are derived afresh from the counts); the
// affinity sums take 64-bit atomic adds, since several pods can land in
// one domain (integer adds: the order does not change the sums).
// Copied from the reference: the spread filter is not re-checked between
// the pods of one round.
//
// Under a mesh each tile runs the steps on its own node column; every
// reduction over nodes combines the partials of the tiles of its pod row,
// each tile reading them (on this card or on peer cards, through their
// pointers) in column order: the spread domain sums, the spread-scored
// counts and bitmaps, the normalize maxima, the best score, the tie counts
// (their prefix in column order for the pick) and the hash sums, and the
// affinity increments. Every pod-indexed vector (keys, picks, admissions,
// active flags, assignments) is replicated: each tile computes it alike
// over every pod, the picks from every pod row's class rows, so that the
// rank runs over every pod in queue order and each column admits the
// choosers of every pod row; every tile of a column commits its column's
// pods to its own copy of the column's rows, so the copies stay equal down
// the pod rows.
#include "filter_pass.cuh"
#include "solve_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTiles = 8;
constexpr int64_t kI64Min = -(1LL << 62);  // the reference's I64_MIN

// a class's statistics of the round (BatchTile.cstats rows): its best score
// over the tile's nodes (kI64Min without a feasible node), the pod row's
// best, the tie count and hash over the tile's nodes
enum { kBestCol, kBestRow, kCnt, kHash, kStats };
// the parts of a solve that BatchSet.split times (block 0's wall clock
// from one mark to the next, barrier waits included): the start; each
// round's spread sums, minMatch and affinity row totals (steps 0-2), the
// verdicts and base scores (3), the normalize pass (4), the totals with
// each class's best over the column (5), the ties (6), the rank and pick
// (7), the admissions (8), the commit (9); the end
enum { kSplitStart, kSplit02, kSplit3, kSplit4, kSplit5, kSplit6, kSplit7, kSplit8, kSplit9,
       kSplitEnd, kSplit };
// BatchTile.scal: the round's progress and whether any pod is still active
enum { kProgress, kStill, kScalars };

using kt::block_reduce;
using kt::card_sync;
using kt::ldv;
using kt::MaxOp;
using kt::mesh_sync;
using kt::MinOp;
using kt::SumOp;

__device__ __forceinline__ int64_t tie_weight(int64_t n) {
  return (n * 2654435761LL + 1) & 0xFFFFFFFFLL;
}

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// One tile of a solve (mirror of BatchTile in kubetpu_torch/kernels/
// __init__.py; 8-byte fields). Node-indexed arrays hold the tile's column
// of N rows, class-indexed ones the tile's C classes, pod-indexed ones all
// P pods of the solve (each tile's own copy).
struct BatchTile {
  ScoreArgs a;              // the tile's Pb pods against its column, over the running state
  ScoreArgs af;             // its column with every pod's pod-major leaves (one pod row: a)
  const int32_t* reps;      // (C,) each class's first pod, in the tile
  const int32_t* class_of;  // (Pb,) each pod's class
  int64_t C;
  uint8_t* mask;            // (C, N) each class's verdicts this round
  int64_t* total;           // (C, N) its base score, then its total
  int32_t* ties;            // (C, N) its tie nodes this round, in node order
  int64_t* cstats;          // (kStats, C)
  int64_t* sc;              // (2, C): spread-scored count, this tile's and the row's
  int64_t* bits;            // (2, C, CW): spread domain bitmaps, likewise
  int64_t* mx;              // (2, C, kNorm): normalize maxima, likewise
  int64_t* sums_part;       // (S, D + 1) this tile's spread domain sums, or null
  int32_t* first;           // (N,) each node's first chooser this round (P: none)
  int64_t* req;             // running state: (N, R), (N, R), (N,), (N, K)
  int64_t* nz;
  int32_t* pc;
  uint8_t* ports;
  int64_t* pa_sums;         // (RA, D) or null
  int64_t* pa_delta;        // (RA, D) the round's increments on this column, or null
  int32_t* sp_counts;       // (S, N) or null
  const int64_t* req0;      // the batch's start state, copied into the running
  const int64_t* nz0;       // state at the start
  const int32_t* pc0;
  const uint8_t* ports0;
  const int64_t* pa0;
  const int32_t* sp0;
  uint8_t* active;          // (P,)
  int32_t* assignments;     // (P,) global node indices
  int32_t* choice;          // (P,) pick of the round (global), -1 none
  int32_t* acc;             // (P,) admitted, for the pods that chose this column
  int64_t* scal;            // (kScalars,)
  int64_t offset;           // the tile's first global node
  int64_t row, col;         // its pod row and node column
};

// One card's launch (mirror of BatchSet; its fields after `t` are the
// packing solve's SolveSet's, which the host fills alike)
struct BatchSet {
  BatchTile t[kMaxTiles];   // every tile of the solve, tile (i, j) at i * NG + j
  int64_t PG, NG;
  int64_t local[kMaxTiles]; // this card's tiles
  int64_t nlocal;
  int64_t bpt;              // blocks a tile
  int64_t cap;              // rounds at most
  unsigned long long* bar;  // this card's barrier counter (zeroed by the entry)
  int32_t* abort;           // set when a peer card timed out (zeroed by the entry)
  int64_t* out;             // (2,) rounds, error
  int64_t* split;           // (kSplit,) ns in each part of the solve, or null
  Exchange x;               // the cards' sequence words, one slot a card (x.G cards)
  int64_t card;             // this card's slot
};

// class c's group key this round over a pod row (`pr` its NG tiles): its
// tie hash, summed over the row, xor the row's best << 1 when it has a tie
// node, else 0 (an active pod of the class takes it; kubetpu's rank sorts
// inactive pods with key 0 too)
__device__ __forceinline__ int64_t class_key(const BatchTile* pr, int64_t NG, int64_t c) {
  const int64_t C = pr[0].C;
  int64_t cnt = 0, h = 0;
  for (int64_t j = 0; j < NG; ++j) {
    cnt += ldv(pr[j].cstats + kCnt * C + c);
    h = SumOp()(h, ldv(pr[j].cstats + kHash * C + c));
  }
  if (cnt == 0) return 0;
  return (int64_t)((unsigned long long)h ^
                   ((unsigned long long)ldv(pr[0].cstats + kBestRow * C + c) << 1));
}

// the solve of this block's tile; `rounds` counts the rounds. Returns false
// when a wait timed out.
__device__ bool solve(const BatchSet& S, int64_t& rounds, unsigned char* s_dyn) {
  __shared__ int s_flag;
  __shared__ int64_t s_red[33];
  __shared__ int64_t s_m[kt::kNorm][33];
  __shared__ int32_t s_warp[kThreads / 32];
  __shared__ int64_t s_base;
  const int64_t li = blockIdx.x / S.bpt;
  const int64_t rank = blockIdx.x % S.bpt;
  const BatchTile& T = S.t[S.local[li]];
  const ScoreArgs& a = T.a;
  const ScoreArgs& af = T.af;
  const int64_t N = a.N, Pb = a.P, P = af.P, C = T.C, R = a.R, K = a.K;
  const int64_t tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t gtid = rank * blockDim.x + tid, gstride = S.bpt * blockDim.x;
  const int64_t gwarp = rank * (kThreads / 32) + warp, nwarps = S.bpt * (kThreads / 32);
  const BatchTile* rowt = S.t + T.row * S.NG;  // this pod row's tiles
  const bool pa = a.pa_node_domain != nullptr;
  const bool sp_sums = a.sp_node_domain != nullptr && (a.sp_filter || a.w_spread) && a.sp_S > 0;
  const bool norm = a.na_raw != nullptr || a.tt_raw != nullptr || a.w_interpod || a.w_spread ||
                    a.dra_raw != nullptr;
  const int64_t D1 = a.sp_D + 1, CW = a.sp_C * ((a.sp_D + 31) / 32);
  // the affinity increments: straight into the sums when the column is the
  // pod row's only one, else summed over the row's columns after the commit
  int64_t* const pa_into = S.NG == 1 ? T.pa_sums : T.pa_delta;
  int64_t k = 0, xk = 0;
  // the split's marks: block 0, thread 0, when BatchSet.split is given
  const bool timing = S.split != nullptr && blockIdx.x == 0 && tid == 0;
  uint64_t t_mark = 0;
  auto mark = [&](int part) {
    if (!timing) return;
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (part >= 0) S.split[part] += (int64_t)(t - t_mark);
    t_mark = t;
  };
  mark(-1);
  // pod p's admission by the tile of this pod row that holds global node
  // `node` (columns are N rows each)
  auto acc_of = [&](int64_t p, int32_t node) -> bool {
    return node >= 0 && ldv(rowt[node / N].acc + p) != 0;
  };

  // ---- the start: the running state from the batch's, every nomination
  // live, active flags, assignments, scratch
  for (int64_t i = gtid; i < N * R; i += gstride) {
    T.req[i] = T.req0[i];
    T.nz[i] = T.nz0[i];
  }
  for (int64_t n = gtid; n < N; n += gstride) T.pc[n] = T.pc0[n];
  for (int64_t i = gtid; i < N * K; i += gstride) T.ports[i] = T.ports0[i];
  if (pa)
    for (int64_t i = gtid; i < a.pa_R * a.pa_D; i += gstride) T.pa_sums[i] = T.pa0[i];
  if (T.sp_counts != nullptr)
    for (int64_t i = gtid; i < a.sp_S * N; i += gstride) T.sp_counts[i] = T.sp0[i];
  if (af.nom_node != nullptr)
    for (int64_t g = gtid; g < af.G; g += gstride) af.nom_active[g] = 1;
  for (int64_t p = gtid; p < P; p += gstride) {
    T.active[p] = af.pod_valid[p];
    T.assignments[p] = -1;
  }
  for (int64_t n = gtid; n < N; n += gstride) T.first[n] = (int32_t)P;
  if (sp_sums)
    for (int64_t i = gtid; i < a.sp_S * D1; i += gstride) T.sums_part[i] = 0;
  if (gtid < kScalars) T.scal[gtid] = 0;
  int64_t still = 0;
  for (int64_t p = tid; p < P; p += blockDim.x) still |= af.pod_valid[p];
  still = block_reduce(still, MaxOp(), 0, s_red);
  if (!card_sync(S, k, &s_flag)) return false;
  mark(kSplitStart);

  bool progress = true;
  while (progress && still && rounds < S.cap) {
    // ---- 0: this tile's spread domain sums
    if (sp_sums) {
      kt::sp_accumulate(a, T.sp_counts, T.sums_part, rank, S.bpt);
      if (!mesh_sync(S, k, xk, &s_flag)) return false;
      // ---- 1: the row's domain sums
      for (int64_t i = gtid; i < a.sp_S * D1; i += gstride) {
        int64_t v = 0;
        for (int64_t j = 0; j < S.NG; ++j) v += ldv(rowt[j].sums_part + i);
        a.sp_sums[i] = v;
      }
    }
    if (pa && S.NG > 1)
      for (int64_t i = gtid; i < a.pa_R * a.pa_D; i += gstride) T.pa_delta[i] = 0;
    if (sp_sums || pa) {
      // ---- 2: minMatch, the affinity row totals
      if (sp_sums && !card_sync(S, k, &s_flag)) return false;
      if (sp_sums)
        for (int64_t sg = rank; sg < a.sp_S; sg += S.bpt) {
          const int64_t mm = kt::sp_min_over_domains(a, a.sp_sums, sg, s_red);
          if (tid == 0) a.sp_min_match[sg] = mm;
        }
      if (pa) kt::pa_row_totals(a, a.pa_sums, a.pa_row_total, gtid, gstride);
      if (!card_sync(S, k, &s_flag)) return false;
    }
    mark(kSplit02);
    // ---- 3: each class's verdicts and base scores (filter_score's pass (a))
    for (int64_t i = gtid; i < C * N; i += gstride) {
      const int64_t c = i / N, n = i - c * N;
      kt::pair_pass(a, T.reps[c], n, pa, 0, T.mask + i, T.total + i);
    }
    if (!card_sync(S, k, &s_flag)) return false;
    mark(kSplit3);
    // Steps 4-6 run class c on block c % bpt, so that without other columns
    // (NG 1) each step reads only its own block's writes: their barriers
    // join the row's columns.
    auto row_sync = [&]() -> bool {
      __syncthreads();
      return S.NG == 1 || mesh_sync(S, k, xk, &s_flag);
    };
    if (norm) {
      // ---- 4: the normalize pass (pass (b)) in the mesh's three phases
      if (a.w_spread) {
        for (int64_t c = rank; c < C; c += S.bpt)
          kt::normalize_pass(a, T.reps[c], T.mask + c * N, T.total + c * N, T.total + c * N, 1,
                             T.sc + c, T.bits + c * CW, nullptr, s_dyn, s_m);
        if (!row_sync()) return false;
      }
      for (int64_t c = rank; c < C; c += S.bpt) {
        if (a.w_spread) {
          for (int64_t i = tid; i < CW; i += blockDim.x) {
            int64_t v = 0;
            for (int64_t j = 0; j < S.NG; ++j) v |= ldv(rowt[j].bits + c * CW + i);
            T.bits[C * CW + c * CW + i] = v;
          }
          if (tid == 0) {
            int64_t v = 0;
            for (int64_t j = 0; j < S.NG; ++j) v += ldv(rowt[j].sc + c);
            T.sc[C + c] = v;
          }
          __syncthreads();
        }
        kt::normalize_pass(a, T.reps[c], T.mask + c * N, T.total + c * N, T.total + c * N, 2,
                           T.sc + C + c, T.bits + C * CW + c * CW, T.mx + c * kt::kNorm, s_dyn,
                           s_m);
      }
      if (!row_sync()) return false;
    }
    mark(kSplit4);
    // ---- 5: the totals; each class's best score over this column
    for (int64_t c = rank; c < C; c += S.bpt) {
      int64_t* t = T.total + c * N;
      const uint8_t* m = T.mask + c * N;
      if (norm) {
        int64_t* mxr = T.mx + (C + c) * kt::kNorm;
        if (tid < kt::kNorm) {
          int64_t v = ldv(rowt[0].mx + c * kt::kNorm + tid);
          for (int64_t j = 1; j < S.NG; ++j) v = kt::imax(v, ldv(rowt[j].mx + c * kt::kNorm + tid));
          mxr[tid] = v;
        }
        __syncthreads();
        kt::normalize_pass(a, T.reps[c], m, t, t, 3, T.sc + C + c, T.bits + C * CW + c * CW, mxr,
                           s_dyn, s_m);
      }
      int64_t b = kI64Min;
#pragma unroll 4
      for (int64_t n = tid; n < N; n += blockDim.x)
        if (m[n]) b = kt::imax(b, t[n]);
      b = block_reduce(b, MaxOp(), kI64Min, s_red);
      if (tid == 0) T.cstats[kBestCol * C + c] = b;
    }
    if (!row_sync()) return false;
    mark(kSplit5);
    // ---- 6: the row's best; each class's tie nodes, count and hash here
    for (int64_t c = rank; c < C; c += S.bpt) {
      int64_t best = kI64Min;
      for (int64_t j = 0; j < S.NG; ++j) best = kt::imax(best, ldv(rowt[j].cstats + kBestCol * C + c));
      const int64_t* t = T.total + c * N;
      const uint8_t* m = T.mask + c * N;
      int32_t* ties = T.ties + c * N;
      int64_t h = 0;
      if (tid == 0) s_base = 0;
      __syncthreads();
      if (best > kI64Min) {
        for (int64_t start = 0; start < N; start += blockDim.x) {
          const int64_t n = start + tid;
          const bool tie = n < N && m[n] && t[n] == best;
          const unsigned ballot = __ballot_sync(0xffffffffu, tie);
          if (lane == 0) s_warp[warp] = __popc(ballot);
          __syncthreads();
          int64_t pos = s_base;
          for (int64_t v = 0; v < warp; ++v) pos += s_warp[v];
          pos += __popc(ballot & ((1u << lane) - 1));
          if (tie) {
            ties[pos] = (int32_t)n;
            h = SumOp()(h, tie_weight(n + T.offset));
          }
          __syncthreads();
          if (tid == 0)
            for (int v = 0; v < kThreads / 32; ++v) s_base += s_warp[v];
          __syncthreads();
        }
      }
      h = block_reduce(h, SumOp(), 0, s_red);
      if (tid == 0) {
        T.cstats[kBestRow * C + c] = best;
        T.cstats[kCnt * C + c] = s_base;
        T.cstats[kHash * C + c] = h;
      }
    }
    if (!mesh_sync(S, k, xk, &s_flag)) return false;
    mark(kSplit6);
    // ---- 7: each pod's rank in its group (pods of an equal group key
    // before it, in queue order, every pod counting) and its pick, the
    // (rank mod ties)-th tie node of its class over its pod row; each
    // node's first chooser. The blocks that rank a pod stage every pod row's
    // class keys, then every pod's key, in their dynamic shared memory (8
    // bytes a pod and a class).
    int64_t* s_key = reinterpret_cast<int64_t*>(s_dyn);
    if (rank * (kThreads / 32) < P) {
      int64_t* s_ckey = s_key + P;
      for (int64_t i = 0, off = 0; i < S.PG; off += S.t[i * S.NG].C, ++i)
        for (int64_t c = tid; c < S.t[i * S.NG].C; c += blockDim.x)
          s_ckey[off + c] = class_key(S.t + i * S.NG, S.NG, c);
      __syncthreads();
      for (int64_t q = tid; q < P; q += blockDim.x) {
        const int64_t i = q / Pb;
        int64_t off = 0;
        for (int64_t h = 0; h < i; ++h) off += S.t[h * S.NG].C;
        s_key[q] = T.active[q] ? s_ckey[off + S.t[i * S.NG].class_of[q % Pb]] : 0;
      }
      __syncthreads();
    }
    for (int64_t p = gwarp; p < P; p += nwarps) {
      const int64_t kp = s_key[p];
      int64_t before = 0;
      for (int64_t q = lane; q < p; q += 32) before += s_key[q] == kp;
      before = warp_sum(before);
      // the pick: lane j < NG reads column j's tie count of the pod's class
      int32_t pick = -1;
      if (T.active[p]) {
        const BatchTile* pr = S.t + (p / Pb) * S.NG;
        const int64_t pc_ = pr[0].C, c = pr[0].class_of[p % Pb];
        const int64_t cj = lane < S.NG ? ldv(pr[lane].cstats + kCnt * pc_ + c) : 0;
        int64_t incl = cj;
        for (int off = 1; off < 32; off <<= 1) {
          const int64_t y = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += y;
        }
        const int64_t cnt = __shfl_sync(0xffffffffu, incl, 31);
        if (cnt > 0) {
          const int64_t r = before % cnt;
          const bool mine = lane < S.NG && r < incl && r >= incl - cj;
          if (mine) pick = (int32_t)(ldv(pr[lane].ties + c * N + (r - (incl - cj))) +
                                     pr[lane].offset);
          pick = __shfl_sync(0xffffffffu, pick,
                             __ffs(__ballot_sync(0xffffffffu, mine)) - 1);
        }
      }
      if (lane == 0) {
        T.choice[p] = pick;
        const int64_t n = (int64_t)pick - T.offset;
        if (pick >= 0 && n >= 0 && n < N) atomicMin(T.first + n, (int32_t)p);
      }
    }
    __syncthreads();
    if (gtid == 0) {
      T.scal[kProgress] = 0;
      T.scal[kStill] = 0;
    }
    if (!card_sync(S, k, &s_flag)) return false;
    mark(kSplit7);
    // ---- 8: the admissions of the pods that chose this column's nodes:
    // each node's first chooser, when it fits (with the fit filter on)
    for (int64_t p = gtid; p < P; p += gstride) {
      const int64_t c = (int64_t)T.choice[p] - T.offset;
      if (T.choice[p] < 0 || c < 0 || c >= N) continue;
      bool ok = T.first[c] == p;
      if (ok && af.filter_fit) {
        for (int64_t r = 0; r < R; ++r)
          ok = ok && af.requests[p * R + r] <= af.alloc[c * R + r] - T.req[c * R + r];
        ok = ok && af.allowed_pods[c] - T.pc[c] >= 1;
      }
      T.acc[p] = ok;
    }
    if (!mesh_sync(S, k, xk, &s_flag)) return false;
    mark(kSplit8);
    // ---- 9: the first rejection in queue order (each block over every
    // pod); the commit of every admitted pod of this column to its rows;
    // the next round's first choosers and partials cleared
    for (int64_t n = gtid; n < N; n += gstride) T.first[n] = (int32_t)P;
    if (sp_sums)
      for (int64_t i = gtid; i < a.sp_S * D1; i += gstride) T.sums_part[i] = 0;
    // (a pod with a pick is active: the commit below clears its flag, so
    // the pick alone says it)
    int64_t first_rej = P;
    for (int64_t p = tid; p < P; p += blockDim.x)
      if (T.choice[p] >= 0 && !acc_of(p, T.choice[p])) first_rej = kt::imin(first_rej, p);
    first_rej = block_reduce(first_rej, MinOp(), P, s_red);
    int64_t prog = 0, left = 0;
    for (int64_t p = gtid; p < P; p += gstride) {
      if (!T.active[p]) continue;
      const int32_t ch = T.choice[p];
      const bool commit = p < first_rej && acc_of(p, ch);
      const bool finalize = ch < 0 && p < first_rej;
      const int64_t c = (int64_t)ch - T.offset;
      if (commit && c >= 0 && c < N) {
        for (int64_t r = 0; r < R; ++r) {
          T.req[c * R + r] += af.requests[p * R + r];
          T.nz[c * R + r] += af.nonzero_requests[p * R + r];
        }
        T.pc[c] += 1;
        for (int64_t kk = 0; kk < K; ++kk)
          if (af.pod_ports[p * K + kk]) T.ports[c * K + kk] = 1;
        if (pa) {
          for (int64_t r = 0; r < af.pa_R; ++r) {
            const int32_t dom = af.pa_node_domain[r * N + c];
            if (dom < 0) continue;
            atomicAdd(reinterpret_cast<unsigned long long*>(pa_into + r * af.pa_D + dom),
                      (unsigned long long)af.pa_update[p * af.pa_R + r]);
          }
        }
        if (T.sp_counts != nullptr) {
          // spread updateWithPod: +1 at node c in every signature the pod
          // matches and c is eligible for
          for (int64_t sg = 0; sg < af.sp_S; ++sg)
            if (af.sp_pod_match_sig[p * af.sp_S + sg] && af.sp_eligible[sg * N + c])
              T.sp_counts[sg * N + c] += 1;
        }
      }
      if (commit) {
        // the accepted nominee spends its nomination
        if (af.nom_node != nullptr)
          for (int64_t g = 0; g < af.G; ++g)
            if (af.nom_pod_idx[g] == p) af.nom_active[g] = 0;
        T.assignments[p] = ch;
      }
      if (commit || finalize) {
        T.active[p] = 0;
        prog = 1;
      } else {
        left = 1;
      }
    }
    prog = block_reduce(prog, MaxOp(), 0, s_red);
    left = block_reduce(left, MaxOp(), 0, s_red);
    if (tid == 0) {
      if (prog) atomicExch(reinterpret_cast<unsigned long long*>(T.scal + kProgress), 1ULL);
      if (left) atomicExch(reinterpret_cast<unsigned long long*>(T.scal + kStill), 1ULL);
    }
    if (pa && S.NG > 1) {
      // the row's affinity increments, into this tile's sums (the next
      // round clears the increments once every tile has read them)
      if (!mesh_sync(S, k, xk, &s_flag)) return false;
      for (int64_t i = gtid; i < a.pa_R * a.pa_D; i += gstride) {
        int64_t v = 0;
        for (int64_t j = 0; j < S.NG; ++j) v += ldv(rowt[j].pa_delta + i);
        T.pa_sums[i] += v;
      }
      if (!mesh_sync(S, k, xk, &s_flag)) return false;
    } else if (!mesh_sync(S, k, xk, &s_flag)) {
      return false;
    }
    progress = ldv(T.scal + kProgress) != 0;
    still = ldv(T.scal + kStill) != 0;
    rounds += 1;
    mark(kSplit9);
  }
  mark(kSplitEnd);
  return true;
}

__global__ void __launch_bounds__(kThreads, 1) batched_solve_kernel(const __grid_constant__ BatchSet S) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  int64_t rounds = 0;
  const bool ok = solve(S, rounds, s_dyn);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    S.out[0] = rounds;
    S.out[1] = ok ? (int64_t)(ldv(S.x.error) != 0) : 1;
  }
}

}  // namespace

// Launches one card's part of a batched solve on `stream`: `set` (host
// memory) holds every tile of the solve and this card's (set->local,
// set->nlocal; at most 8 tiles in all), set->bpt blocks a tile, all in one
// cooperative launch (they spin on each other at every barrier, so all must
// be resident). Before the launch the entry zeroes the card's barrier
// counter, abort word, error word (set->x.error) and output. `smem` is the
// dynamic shared memory: the spread weights (8 bytes a constraint slot)
// and, at the rank, the group keys (8 bytes a pod and a class); the larger
// of the two. On a mesh of several cards each card's entry is called in
// turn (without waiting: their launches meet at the exchange). Each tile's
// running state, nominations, active flags and assignments are written in
// place (the running state from the start state the tiles point to);
// set->out receives the rounds and the error flag (a wait past the
// budget). Returns cudaErrorCooperativeLaunchTooLarge when the tiles'
// blocks cannot all be resident on this card, else the cudaError_t of the
// launch.
extern "C" int kt_batched_round(const void* set, int64_t smem, void* stream) {
  const BatchSet& in = *static_cast<const BatchSet*>(set);
  if (in.nlocal < 1 || in.nlocal > kMaxTiles || in.bpt < 1 || in.PG * in.NG > kMaxTiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute((const void*)batched_solve_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, batched_solve_kernel, kThreads,
                                                        (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)occ * sms < in.bpt * in.nlocal) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(in.bar, 0, sizeof(unsigned long long), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(in.abort, 0, sizeof(int32_t), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(in.x.error, 0, sizeof(int32_t), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(in.out, 0, 2 * sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  BatchSet sv = in;
  void* args[] = {&sv};
  err = cudaLaunchCooperativeKernel((const void*)batched_solve_kernel,
                                    dim3((unsigned)(in.bpt * in.nlocal)), dim3(kThreads), args,
                                    (size_t)smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_batched_round_set_size() { return (int64_t)sizeof(BatchSet); }

namespace {

// Mirror of CombineArgs in kubetpu_torch/kernels/__init__.py
struct CombineArgs {
  const void* src[8];  // each shard's partial (n elements)
  void* dst[8];        // each shard's result
  int64_t G, n, op, elem;  // elem: 8 (int64) or 4 (int32) bytes
};

template <typename T>
__device__ __forceinline__ void combine_one(const CombineArgs& c, int64_t i) {
  const T* const* src = reinterpret_cast<const T* const*>(c.src);
  T* const* dst = reinterpret_cast<T* const*>(c.dst);
  T v = src[0][i];
  for (int64_t h = 1; h < c.G; ++h) {
    const T w = src[h][i];
    if (c.op == 0) v = v > w ? v : w;
    else if (c.op == 2) v = v | w;
    else v = (T)((unsigned long long)v + (unsigned long long)w);
  }
  for (int64_t h = 0; h < c.G; ++h) dst[h][i] = v;
}

// The mesh's combine (the cross-shard reductions of the sharded
// filter_score passes and of the sharded potential mask's spread sums):
// element i of every shard's partial, reduced, written to every shard's
// result (peer pointers for other cards). op 0 max, 1 sum (wrapping), 2 or.
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
  if (c.G < 1 || c.G > 8 || (c.elem != 4 && c.elem != 8) || c.op < 0 || c.op > 2)
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
