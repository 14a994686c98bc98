// packing_round: the packing engine's whole solve on the card, one launch a
// solve on each card (kernel B14 unsharded; K5 over a node mesh, K8 over a
// pods x nodes grid).
//
// Replaces kubetpu/assign/packing.py:259 packing_assign_device (jit, a
// lax.while_loop of rounds), with :146 _banded_tie_choice, :187
// _priority_order and :198 _accept_packed, the Filter + Score each round
// reads (kubetpu/framework/runtime.py:1578 filter_score_batch, as
// filter_score.cu computes it, through filter_pass.cuh), and, fused into
// the node pass and the end, kubetpu/ops/topology.py:64 slice_occupancy
// (B12); under a mesh kubetpu/parallel/mesh.py:369 sharded_packing (with
// pod_axis="pods" on a grid). XLA ran the loop as one program, its stop
// rule (`cond`: any(active) & progress & (iters < cap)) on the device.
//
// Bound: latency. A round is a chain of a dozen dependent steps, each a
// reduction over the nodes or over the pods that the next step reads: the
// Filter + Score of the round's state, the node penalties, each pod's
// largest |score|, best utility, tie count and hash, the rank in its hash
// group, the pick, the admissions with the dual ascent, the commit. A host
// loop paid each step as a launch (about 45 host-ordered launches a round
// at four shards). Design: ONE cooperative launch a solve on each card,
// holding every tile of the card (bpt blocks a tile, all co-resident), the
// round loop and its stop rule inside it; the steps are separated by a
// grid-wide barrier (solve_sync.cuh's card_sync: an arrival counter in
// device memory), and, where a step reads other cards' partials, by the
// mesh's exchange (exchange.cuh's sequence words, once a barrier, bounded
// by EXCHANGE_BUDGET). The host reads once a solve: the iterations and the
// error word.
//
// Pod classes (runtime.PodClasses): two pods of one class have equal
// Filter + Score rows, so every per-pod statistic of a round depends only
// on the pod's class and on whether it is still active. The solve keeps one
// row a class (its first pod's): the verdicts and totals, the largest
// |score|, the best utility, and the tie nodes in node order with their
// count and hash. A pod's group key, rank and pick then read its class's
// row: the rank counts the earlier pods of an equal key (the stable sort
// of (key, pod) that kubetpu's rank is), the pick is the (rank mod ties)-th
// tie node. The admissions need no sort either: a chooser of node n is
// admitted when the requests of the choosers of n up to it in admission
// order (every chooser counting, rejected ones too) fit n's free
// resources and pod room, and no earlier chooser of n is coupled when it is.
//
// Under a mesh each tile runs the steps on its own node column; every
// reduction over nodes combines the partials of the tiles of its pod row,
// each tile reading them (its pod row's tiles are on this card or on peer
// cards, read through their pointers) in column order: the slice
// occupancy, the spread domain sums, the spread-scored counts and bitmaps,
// the normalize maxima, the row maximum of |score| (its float bits), the
// best utility, the tie counts and the wrapping sums of the tie weights of
// the GLOBAL node indices (the xor with best << 1 once, after the sum), the
// affinity increments, and at the end the marginal utility (float min),
// whether any node was used, the nodes used and the fragmentation (a
// float32 sum, in column order). The closed-node bias uses the GLOBAL node
// index. Every pod-indexed vector (the admission order, coupled flags,
// keys, picks, active flags, assignments) is replicated: each tile computes
// it alike over every pod, the picks from every pod row's class rows, so
// that a pod row's rank runs over every pod in queue order and each column
// admits the choosers of every pod row; every tile of a column commits its
// column's admitted pods to its own copy of the column's rows and duals,
// so the copies stay equal down the pod rows.
//
// Float32 rounding: the reference's arithmetic runs through XLA on the
// CPU, which fuses a multiply into the add that takes it (FMA). This file
// rounds each step as the plain version (kubetpu_torch/assign/packing.py)
// does, which follows XLA: __fmaf_rn where XLA fuses, __fmul_rn / __fadd_rn
// / __fdiv_rn elsewhere (built with -fmad=false, so nothing else fuses).
// The score converts with __ll2float_rn, the utility rounds half to even
// with __float2ll_rn (as jnp.round; never roundf). log1p of the integer
// overflow count is XLA's own float32 log of k + 1 (a Cephes polynomial,
// its multiply-adds fused), not log1pf: the two differ at some counts. The
// objective's float sums are taken in another order than the plain
// version's (it agrees within rtol 1e-5); every other output is exact.
#include "filter_pass.cuh"
#include "solve_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTiles = 8;
constexpr int64_t kI64Min = -(1LL << 62);  // the reference's I64_MIN
constexpr float kUtilScale = 1048576.0f;    // 2^20

// the PackingWeights tensor's index order
enum { kScore, kPrio, kAlpha, kBeta, kStep, kDecay, kBand, kCapFrac, kSliceFrag, kSliceAlign };
// a class's statistics of the round (SolveTile.cstats rows): its largest
// |score| over the tile's nodes (float bits, -1 without a feasible node),
// its best utility there, the pod row's best, the tie count and hash there
enum { kRmx, kBest, kBestRow, kCnt, kHash, kStats };
// the parts of a solve that SolveSet.split times (block 0's wall clock
// from one mark to the next, barrier waits included): the start; each
// round's partials, penalties, minMatch and row totals (steps 0-2), the
// verdicts and base scores (3), the normalize pass (4), the totals with
// the |score| maxima (5), the best utilities (6), the ties (7), the rank
// and pick (8), the admissions (9), the dual ascent and commit (10); the
// end
enum { kSplitStart, kSplit02, kSplit3, kSplit4, kSplit5, kSplit6, kSplit7, kSplit8, kSplit9,
       kSplit10, kSplitEnd, kSplit };

// SolveTile.scal: the round's progress and whether any pod is still
// active; at the end, any node used and the nodes used
enum { kProgress, kStill, kAny, kUsed, kScalars };

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

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
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
// node index (a tile's rows start at `offset`)
__device__ float closed_terms(const ScoreArgs& a, const float* w, const int64_t* req,
                              const int32_t* pc, int64_t n, float extra, int64_t offset) {
  const bool closed = pc[n] == 0 && a.node_valid[n];
  const float base = __fmaf_rn(w[kBeta], emptiness(a, req, n), closed ? w[kAlpha] : 0.0f);
  return __fmaf_rn(closed ? (float)(n + offset) : 0.0f, __fmul_rn(2.0f, w[kBand]),
                   __fadd_rn(base, extra));
}

// node n is busy for slice_occupancy: valid with a positive request sum
__device__ __forceinline__ bool node_busy(const ScoreArgs& a, const int64_t* req, int64_t n) {
  if (!a.node_valid[n]) return false;
  unsigned long long sum = 0;
  for (int64_t r = 0; r < a.R; ++r) sum += (unsigned long long)req[n * a.R + r];
  return (int64_t)sum > 0;
}

__device__ __forceinline__ int64_t utility(int64_t score, float denom, float w_score, float pen) {
  const float norm = __fdiv_rn(__ll2float_rn(score), denom);
  return __float2ll_rn(__fmul_rn(__fmaf_rn(w_score, norm, -pen), kUtilScale));
}

__device__ __forceinline__ int64_t band_of(const float* w) {
  return __float2ll_rn(__fmul_rn(w[kBand], kUtilScale));
}

// One tile of a solve (mirror of SolveTile in kubetpu_torch/kernels/
// __init__.py; 8-byte fields). Node-indexed arrays hold the tile's column
// of N rows, class-indexed ones the tile's C classes, pod-indexed ones all
// P pods of the solve (each tile's own copy).
struct SolveTile {
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
  int32_t* busy;            // (3, S + 1): slice flags of the round, the start, the end
  float* pen;               // (N,)
  float* lam;               // (N,) the duals, in place
  int32_t* over;            // (N,) rejected choosers
  int32_t* chosen;          // (N,) a pod picked the node this round
  float* endf;              // (2, bpt): each block's least start utility, fragmentation
  int64_t* req;             // running state: (N, R), (N, R), (N,), (N, K)
  int64_t* nz;
  int32_t* pc;
  uint8_t* ports;
  int64_t* pa_sums;         // (RA, D) or null
  int64_t* pa_delta;        // (RA, D) the round's increments on this column, or null
  int32_t* sp_counts;       // (S, N) or null
  const float* w;           // (10,)
  const int32_t* slice_id;  // (N,) or null
  int64_t S;
  int32_t* order;           // (P,) admission rank
  int32_t* byorder;         // (P,) the pod of each admission rank
  uint8_t* coupled;         // (P,)
  uint8_t* active;          // (P,)
  int32_t* assignments;     // (P,) global node indices
  int32_t* choice;          // (P,) pick of the round (global), -1 none
  int32_t* acc;             // (P,) admitted, for the pods that chose this column
  const int64_t* req0;      // the column's start rows
  const int32_t* pc0;
  const int32_t* prio;      // (P,) or null
  int64_t* scal;            // (kScalars,)
  float* objective;         // ()
  int32_t* nodes_used;      // ()
  int64_t offset;           // the tile's first global node
  int64_t row, col;         // its pod row and node column
};

// One card's launch (mirror of SolveSet)
struct SolveSet {
  SolveTile t[kMaxTiles];   // every tile of the solve, tile (i, j) at i * NG + j
  int64_t PG, NG;
  int64_t local[kMaxTiles]; // this card's tiles
  int64_t nlocal;
  int64_t bpt;              // blocks a tile
  int64_t cap;              // iterations at most
  unsigned long long* bar;  // this card's barrier counter (zeroed by the entry)
  int32_t* abort;           // set when a peer card timed out (zeroed by the entry)
  int64_t* out;             // (2,) iterations, error
  int64_t* split;           // (kSplit,) ns in each part of the solve, or null
  Exchange x;               // the cards' sequence words, one slot a card (x.G cards)
  int64_t card;             // this card's slot
};

// class c's group key this round over a pod row (`pr` its NG tiles): its
// tie hash, summed over the row, xor the row's best utility << 1 when it
// has a tie node, else 0 (an active pod of the class takes it; kubetpu's
// rank sorts inactive pods with key 0 too)
__device__ __forceinline__ int64_t class_key(const SolveTile* pr, int64_t NG, int64_t c) {
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

// the node column of a global node index (columns are N rows each)
__device__ __forceinline__ int64_t column_of(int64_t node, int64_t N) { return node / N; }

// the solve of this block's tile; `iters` counts the rounds. Returns false
// when a wait timed out.
__device__ bool solve(const SolveSet& S, int64_t& iters, unsigned char* s_dyn) {
  __shared__ int s_flag;
  __shared__ int64_t s_red[33];
  __shared__ float s_f[33];
  __shared__ int64_t s_m[kt::kNorm][33];
  __shared__ int32_t s_warp[kThreads / 32];
  __shared__ int64_t s_base;
  const int64_t li = blockIdx.x / S.bpt;
  const int64_t rank = blockIdx.x % S.bpt;
  const SolveTile& T = S.t[S.local[li]];
  const ScoreArgs& a = T.a;
  const ScoreArgs& af = T.af;
  const int64_t N = a.N, Pb = a.P, P = af.P, C = T.C, R = a.R, K = a.K;
  const int64_t tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t gtid = rank * blockDim.x + tid, gstride = S.bpt * blockDim.x;
  const int64_t gwarp = rank * (kThreads / 32) + warp, nwarps = S.bpt * (kThreads / 32);
  const SolveTile* rowt = S.t + T.row * S.NG;  // this pod row's tiles
  const float* w = T.w;
  const bool pa = a.pa_node_domain != nullptr;
  const bool sp_sums = a.sp_node_domain != nullptr && (a.sp_filter || a.w_spread) && a.sp_S > 0;
  const bool norm = a.na_raw != nullptr || a.tt_raw != nullptr || a.w_interpod || a.w_spread ||
                    a.dra_raw != nullptr;
  const int64_t D1 = a.sp_D + 1, CW = a.sp_C * ((a.sp_D + 31) / 32);
  const int64_t S1 = T.S + 1;
  const int64_t band = band_of(w);
  const float w_score = w[kScore];
  const float cap_lam = __fmul_rn(w[kAlpha], w[kCapFrac]);
  int64_t k = 0, xk = 0;
  // the split's marks: block 0, thread 0, when SolveSet.split is given
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
  // the tile of this pod row that holds global node `node`, and pod p's
  // admission by it
  auto acc_of = [&](int64_t p, int32_t node) -> bool {
    return node >= 0 && ldv(rowt[column_of(node, N)].acc + p) != 0;
  };

  // ---- the start: admission rank, coupled flags, lam * decay, scratch
  for (int64_t p = gtid; p < P; p += gstride) {
    const int64_t kp = (af.pod_valid[p] ? -(int64_t)(T.prio ? T.prio[p] : 0) : (1LL << 40)) * P + p;
    int32_t before = 0;
    for (int64_t q = 0; q < P; ++q) {
      const int64_t kq =
          (af.pod_valid[q] ? -(int64_t)(T.prio ? T.prio[q] : 0) : (1LL << 40)) * P + q;
      before += kq < kp;
    }
    T.order[p] = before;
    T.byorder[before] = (int32_t)p;
    bool c = false;
    for (int64_t kk = 0; kk < K; ++kk) c = c || af.pod_ports[p * K + kk];
    if (af.sp_pod_match_sig != nullptr)
      for (int64_t sg = 0; sg < af.sp_S; ++sg) c = c || af.sp_pod_match_sig[p * af.sp_S + sg];
    if (af.pa_update != nullptr)
      for (int64_t r = 0; r < af.pa_R; ++r) c = c || af.pa_update[p * af.pa_R + r] != 0;
    T.coupled[p] = c;
    T.active[p] = af.pod_valid[p];
    T.assignments[p] = -1;
  }
  for (int64_t n = gtid; n < N; n += gstride) {
    T.lam[n] = __fmul_rn(T.lam[n], w[kDecay]);
    T.over[n] = 0;
    T.chosen[n] = 0;
  }
  for (int64_t i = gtid; i < 3 * S1; i += gstride) T.busy[i] = 0;
  if (sp_sums)
    for (int64_t i = gtid; i < a.sp_S * D1; i += gstride) T.sums_part[i] = 0;
  if (gtid < kScalars) T.scal[gtid] = 0;
  int64_t still = 0;
  for (int64_t p = tid; p < P; p += blockDim.x) still |= af.pod_valid[p];
  still = block_reduce(still, MaxOp(), 0, s_red);
  if (!card_sync(S, k, &s_flag)) return false;
  mark(kSplitStart);

  bool progress = true;
  while (progress && still && iters < S.cap) {
    // ---- 0: this tile's spread domain sums and slice flags
    if (sp_sums) kt::sp_accumulate(a, T.sp_counts, T.sums_part, rank, S.bpt);
    if (T.slice_id != nullptr)
      for (int64_t n = gtid; n < N; n += gstride)
        if (node_busy(a, T.req, n)) T.busy[T.slice_id[n]] = 1;
    if ((sp_sums || T.slice_id != nullptr) && !mesh_sync(S, k, xk, &s_flag)) return false;
    // ---- 1: the row's domain sums, the node penalties (first read at 6)
    if (sp_sums)
      for (int64_t i = gtid; i < a.sp_S * D1; i += gstride) {
        int64_t v = 0;
        for (int64_t j = 0; j < S.NG; ++j) v += ldv(rowt[j].sums_part + i);
        a.sp_sums[i] = v;
      }
    for (int64_t n = gtid; n < N; n += gstride) {
      float v = closed_terms(a, w, T.req, T.pc, n, T.lam[n], T.offset);
      if (T.slice_id != nullptr) {
        const int32_t sid = T.slice_id[n];
        const bool labeled = sid < T.S;
        bool b = false;
        for (int64_t j = 0; j < S.NG; ++j) b = b || ldv(rowt[j].busy + sid) != 0;
        v = __fadd_rn(v, __fsub_rn(__fmul_rn(w[kSliceFrag], labeled && !b ? 1.0f : 0.0f),
                                   __fmul_rn(w[kSliceAlign], labeled && b ? 1.0f : 0.0f)));
      }
      T.pen[n] = v;
    }
    if (pa)
      for (int64_t i = gtid; i < a.pa_R * a.pa_D; i += gstride) T.pa_delta[i] = 0;
    if (sp_sums || pa) {
      // ---- 2: minMatch, the affinity row totals
      if (!card_sync(S, k, &s_flag)) return false;
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
    // Steps 4-7 run class c on block c % bpt, so that without other columns
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
    // ---- 5: the totals; each class's largest |score| over this column
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
      // |score| >= 0: its float bits order as the floats do
      int64_t any = 0, rm = 0;
#pragma unroll 4
      for (int64_t n = tid; n < N; n += blockDim.x) {
        if (!m[n]) continue;
        any = 1;
        rm = kt::imax(rm, __float_as_int(fabsf(__ll2float_rn(t[n]))));
      }
      any = block_reduce(any, MaxOp(), 0, s_red);
      rm = block_reduce(rm, MaxOp(), 0, s_red);
      if (tid == 0) T.cstats[kRmx * C + c] = any ? rm : -1;
    }
    if (!row_sync()) return false;
    mark(kSplit5);
    // ---- 6: each class's best utility over this column, at the row's denominator
    for (int64_t c = rank; c < C; c += S.bpt) {
      int64_t rc = -1;
      for (int64_t j = 0; j < S.NG; ++j) rc = kt::imax(rc, ldv(rowt[j].cstats + kRmx * C + c));
      const float denom = rc >= 0 ? fmaxf(__int_as_float((int)rc), 1.0f) : 1.0f;
      const int64_t* t = T.total + c * N;
      const uint8_t* m = T.mask + c * N;
      int64_t b = kI64Min;
#pragma unroll 4
      for (int64_t n = tid; n < N; n += blockDim.x)
        if (m[n]) b = kt::imax(b, utility(t[n], denom, w_score, T.pen[n]));
      b = block_reduce(b, MaxOp(), kI64Min, s_red);
      if (tid == 0) T.cstats[kBest * C + c] = b;
    }
    if (!row_sync()) return false;
    mark(kSplit6);
    // ---- 7: the row's best; each class's tie nodes, count and hash here
    for (int64_t c = rank; c < C; c += S.bpt) {
      int64_t rc = -1, best = kI64Min;
      for (int64_t j = 0; j < S.NG; ++j) {
        rc = kt::imax(rc, ldv(rowt[j].cstats + kRmx * C + c));
        best = kt::imax(best, ldv(rowt[j].cstats + kBest * C + c));
      }
      const float denom = rc >= 0 ? fmaxf(__int_as_float((int)rc), 1.0f) : 1.0f;
      // best - band in unsigned arithmetic (wraps as XLA's int64 does)
      const int64_t thr = (int64_t)((unsigned long long)best - (unsigned long long)band);
      const int64_t* t = T.total + c * N;
      const uint8_t* m = T.mask + c * N;
      int32_t* ties = T.ties + c * N;
      int64_t h = 0;
      if (tid == 0) s_base = 0;
      __syncthreads();
      if (rc >= 0) {
        for (int64_t start = 0; start < N; start += blockDim.x) {
          const int64_t n = start + tid;
          const bool tie = n < N && m[n] && utility(t[n], denom, w_score, T.pen[n]) >= thr;
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
    mark(kSplit7);
    // ---- 8: each pod's rank in its group (pods of an equal group key
    // before it, in queue order) and its pick, the (rank mod ties)-th tie
    // node of its class over its pod row
    // by a block that ranks a pod: every pod row's class keys, then every
    // pod's key, staged in the block's dynamic shared memory (8 bytes a
    // pod and a class)
    int64_t* s_key = reinterpret_cast<int64_t*>(s_dyn);
    const bool ranks = rank * (kThreads / 32) < P;
    if (ranks) {
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
        const SolveTile* pr = S.t + (p / Pb) * S.NG;
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
        if (pick >= 0 && n >= 0 && n < N) T.chosen[n] = 1;
      }
    }
    __syncthreads();
    if (gtid == 0) {
      T.scal[kProgress] = 0;
      T.scal[kStill] = 0;
    }
    if (!card_sync(S, k, &s_flag)) return false;
    mark(kSplit8);
    // ---- 9: the admissions of the pods that chose this column's nodes,
    // over every pod row's choosers, and each node's rejected choosers: a
    // warp a chosen node, its lanes over the pods in admission order, 32 at
    // a time (the picks and the order staged in the block's shared
    // memory), its choosers' prefix sums of each resource, count and
    // coupled count by warp scans, carried over from one 32 to the next (a
    // resource's carry in shared memory)
    int32_t* s_choice = reinterpret_cast<int32_t*>(s_dyn);
    int32_t* s_byorder = s_choice + P;
    unsigned long long* s_carry = reinterpret_cast<unsigned long long*>(s_byorder + P) +
                                  warp * R;
    if (rank * (kThreads / 32) < N) {
      for (int64_t q = tid; q < P; q += blockDim.x) {
        s_choice[q] = T.choice[q];
        s_byorder[q] = T.byorder[q];
      }
      __syncthreads();
    }
    for (int64_t n = gwarp; n < N; n += nwarps) {
      if (!T.chosen[n]) continue;
      const int32_t node = (int32_t)(n + T.offset);
      for (int64_t r = lane; r < R; r += 32) s_carry[r] = 0;
      __syncwarp();
      int64_t seen = 0, seen_cpl = 0, rejected = 0;
      // the sums only grow along the order: once a chooser fails the fit,
      // every later one does (rejected without its sums)
      bool unfit = false;
      for (int64_t base = 0; base < P; base += 32) {
        const int64_t o = base + lane;
        const int32_t q = o < P ? s_byorder[o] : 0;
        const bool match = o < P && s_choice[q] == node;
        const unsigned mm = __ballot_sync(0xffffffffu, match);
        if (mm == 0) continue;
        if (unfit) {
          if (match) T.acc[q] = 0;
          rejected += __popc(mm);
          continue;
        }
        const bool cq = match && T.coupled[q];
        const unsigned mc = __ballot_sync(0xffffffffu, cq);
        const unsigned upto = lane == 31 ? 0xffffffffu : (2u << lane) - 1;
        // every chooser of n up to this one in admission order counts,
        // rejected ones too
        bool fit = true;
        if (af.filter_fit) {
          for (int64_t r = 0; r < R; ++r) {
            unsigned long long incl =
                match ? (unsigned long long)af.requests[(int64_t)q * R + r] : 0ULL;
            for (int off = 1; off < 32; off <<= 1) {
              const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, off);
              if (lane >= off) incl += y;
            }
            const unsigned long long within = s_carry[r] + incl;
            fit = fit && (int64_t)within <= af.alloc[n * R + r] - T.req[n * R + r];
            __syncwarp();
            if (lane == 31) s_carry[r] = within;
            __syncwarp();
          }
          fit = fit && seen + __popc(mm & upto) <= (int64_t)af.allowed_pods[n] - T.pc[n];
          unfit = __ballot_sync(0xffffffffu, match && !fit) != 0;
        }
        // one coupled pod a node (rejected coupled choosers count too)
        const bool ok = fit && (!cq || seen_cpl + __popc(mc & upto) == 1);
        if (match) T.acc[q] = ok;
        rejected += __popc(__ballot_sync(0xffffffffu, match && !ok));
        seen += __popc(mm);
        seen_cpl += __popc(mc);
      }
      if (lane == 0) T.over[n] = (int32_t)rejected;
    }
    if (!mesh_sync(S, k, xk, &s_flag)) return false;
    mark(kSplit9);
    // ---- 10: the dual ascent on this column's nodes; the next round's
    // partials cleared; the first rejection in admission order (each block
    // over every pod); the commit of every admitted pod of this column to
    // its rows
    for (int64_t n = gtid; n < N; n += gstride) {
      const float v = __fmaf_rn(w[kStep], log1p_count((float)T.over[n]), T.lam[n]);
      T.lam[n] = fminf(fmaxf(v, 0.0f), cap_lam);
      T.over[n] = 0;
      T.chosen[n] = 0;
    }
    for (int64_t i = gtid; i < S1; i += gstride) T.busy[i] = 0;
    if (sp_sums)
      for (int64_t i = gtid; i < a.sp_S * D1; i += gstride) T.sums_part[i] = 0;
    // (a pod with a pick is active: the commit below clears its flag, so
    // the pick alone says it)
    int64_t first_rej = P;
    for (int64_t p = tid; p < P; p += blockDim.x)
      if (T.choice[p] >= 0 && !acc_of(p, T.choice[p]))
        first_rej = kt::imin(first_rej, (int64_t)T.order[p]);
    first_rej = block_reduce(first_rej, MinOp(), P, s_red);
    int64_t prog = 0, left = 0;
    for (int64_t p = gtid; p < P; p += gstride) {
      if (!T.active[p]) continue;
      const int32_t ch = T.choice[p];
      const bool commit = acc_of(p, ch);
      const bool finalize = ch < 0 && T.order[p] < first_rej;
      const int64_t c = (int64_t)ch - T.offset;
      if (commit && c >= 0 && c < N) {
        for (int64_t r = 0; r < R; ++r) {
          atomicAdd(reinterpret_cast<unsigned long long*>(T.req + c * R + r),
                    (unsigned long long)af.requests[p * R + r]);
          atomicAdd(reinterpret_cast<unsigned long long*>(T.nz + c * R + r),
                    (unsigned long long)af.nonzero_requests[p * R + r]);
        }
        atomicAdd(T.pc + c, 1);
        for (int64_t kk = 0; kk < K; ++kk)
          if (af.pod_ports[p * K + kk]) T.ports[c * K + kk] = 1;
        if (pa) {
          for (int64_t r = 0; r < af.pa_R; ++r) {
            const int32_t dom = af.pa_node_domain[r * N + c];
            if (dom < 0) continue;
            atomicAdd(reinterpret_cast<unsigned long long*>(T.pa_delta + r * af.pa_D + dom),
                      (unsigned long long)af.pa_update[p * af.pa_R + r]);
          }
        }
        if (T.sp_counts != nullptr) {
          for (int64_t sg = 0; sg < af.sp_S; ++sg)
            if (af.sp_pod_match_sig[p * af.sp_S + sg] && af.sp_eligible[sg * N + c])
              atomicAdd(T.sp_counts + sg * N + c, 1);
        }
      }
      if (commit) {
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
    if (pa) {
      // the row's affinity increments, into this tile's sums (the next
      // round clears the increments once every tile has read them)
      if (!mesh_sync(S, k, xk, &s_flag)) return false;
      for (int64_t i = gtid; i < a.pa_R * a.pa_D; i += gstride) {
        int64_t v = 0;
        for (int64_t j = 0; j < S.NG; ++j) v += ldv(rowt[j].pa_delta + i);
        T.pa_sums[i] += v;
      }
      if (!mesh_sync(S, k, xk, &s_flag)) return false;
    } else if (!card_sync(S, k, &s_flag)) {
      return false;
    }
    progress = T.scal[kProgress] != 0;
    still = T.scal[kStill] != 0;
    iters += 1;
    mark(kSplit10);
  }

  // ---- the end: this column's partials
  {
    const float pos_inf = __int_as_float(0x7f800000);
    float vmin = pos_inf, frag = 0.0f;
    int64_t any = 0, used = 0;
    for (int64_t n = gtid; n < N; n += gstride) {
      const bool valid = a.node_valid[n];
      if (T.pc[n] > T.pc0[n] && valid) {
        vmin = fminf(vmin, -closed_terms(a, w, T.req0, T.pc0, n, 0.0f, T.offset));
        any = 1;
      }
      if (T.pc[n] > 0 && valid) {
        ++used;
        frag = __fadd_rn(frag, emptiness(a, T.req, n));
      }
      if (T.slice_id != nullptr) {
        if (node_busy(a, T.req0, n)) T.busy[S1 + T.slice_id[n]] = 1;
        if (node_busy(a, T.req, n)) T.busy[2 * S1 + T.slice_id[n]] = 1;
      }
    }
    vmin = block_reduce_f(vmin, FMin(), pos_inf, s_f);
    frag = block_reduce_f(frag, FSum(), 0.0f, s_f);
    any = block_reduce(any, MaxOp(), 0, s_red);
    used = block_reduce(used, SumOp(), 0, s_red);
    if (tid == 0) {
      T.endf[rank] = vmin;
      T.endf[S.bpt + rank] = frag;
      if (any) atomicExch(reinterpret_cast<unsigned long long*>(T.scal + kAny), 1ULL);
      atomicAdd(reinterpret_cast<unsigned long long*>(T.scal + kUsed), (unsigned long long)used);
    }
  }
  if (!mesh_sync(S, k, xk, &s_flag)) return false;
  // ---- the row's partials: the prices of this column, the objective
  {
    const float pos_inf = __int_as_float(0x7f800000);
    float vmin = pos_inf;
    int64_t any = 0;
    for (int64_t j = 0; j < S.NG; ++j) {
      any |= ldv(rowt[j].scal + kAny);
      for (int64_t b = 0; b < S.bpt; ++b) vmin = fminf(vmin, ldv(rowt[j].endf + b));
    }
    if (any)
      for (int64_t n = gtid; n < N; n += gstride) {
        const float v0 = -closed_terms(a, w, T.req0, T.pc0, n, 0.0f, T.offset);
        T.lam[n] = fminf(fmaxf(__fsub_rn(v0, vmin), 0.0f), cap_lam);
      }
    if (rank == 0) {
      float adm = 0.0f;
      for (int64_t p = tid; p < P; p += blockDim.x) {
        if (T.assignments[p] < 0 || !af.pod_valid[p]) continue;
        const float pr = T.prio == nullptr ? 0.0f : (float)T.prio[p];
        adm = __fadd_rn(adm, __fadd_rn(1.0f, __fmul_rn(w[kPrio], pr)));
      }
      adm = block_reduce_f(adm, FSum(), 0.0f, s_f);
      int64_t newly = 0;
      if (T.slice_id != nullptr) {
        // slices opened from fully free: busy at the end, not at the start
        for (int64_t sl = tid; sl < T.S; sl += blockDim.x) {
          bool b0 = false, b1 = false;
          for (int64_t j = 0; j < S.NG; ++j) {
            b0 = b0 || ldv(rowt[j].busy + S1 + sl) != 0;
            b1 = b1 || ldv(rowt[j].busy + 2 * S1 + sl) != 0;
          }
          newly += b1 && !b0;
        }
        newly = block_reduce(newly, SumOp(), 0, s_red);
      }
      if (tid == 0) {
        float frag = 0.0f;
        int64_t used = 0;
        for (int64_t j = 0; j < S.NG; ++j) {
          float fj = 0.0f;
          for (int64_t b = 0; b < S.bpt; ++b) fj = __fadd_rn(fj, ldv(rowt[j].endf + S.bpt + b));
          frag = __fadd_rn(frag, fj);
          used += ldv(rowt[j].scal + kUsed);
        }
        float obj = __fsub_rn(__fsub_rn(adm, __fmul_rn(w[kAlpha], (float)used)),
                              __fmul_rn(w[kBeta], frag));
        if (T.slice_id != nullptr) obj = __fsub_rn(obj, __fmul_rn(w[kSliceFrag], (float)newly));
        *T.objective = obj;
        *T.nodes_used = (int32_t)used;
      }
    }
  }
  mark(kSplitEnd);
  return true;
}

__global__ void __launch_bounds__(kThreads, 1) packing_solve_kernel(const __grid_constant__ SolveSet S) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  int64_t iters = 0;
  const bool ok = solve(S, iters, s_dyn);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    S.out[0] = iters;
    S.out[1] = ok ? (int64_t)(ldv(S.x.error) != 0) : 1;
  }
}

__global__ void packing_log1p(const float* k, float* ours, float* cuda, int64_t n) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  ours[i] = log1p_count(k[i]);
  cuda[i] = log1pf(k[i]);
}

}  // namespace

// Launches one card's part of a packing solve on `stream`: `set` (host
// memory) holds every tile of the solve and this card's (set->local,
// set->nlocal; at most 8 tiles in all), set->bpt blocks a tile, all in one
// cooperative launch (they spin on each other at every barrier, so all must
// be resident). Before the launch the entry zeroes the card's barrier
// counter, abort word, error word (set->x.error) and output. `smem` is the
// dynamic shared memory: the spread weights (8 bytes a constraint slot)
// and, at other steps, the group keys (8 bytes a pod and a class) and the
// picks with the admission order (8 bytes a pod) and each warp's resource
// carries (8 bytes a resource); the largest of these. On a mesh of several cards
// each card's entry is called in turn (without waiting: their launches meet
// at the exchange). Each tile's running state, duals, assignments,
// objective and nodes used are written in place; set->out receives the
// iterations and the error flag (a wait past the budget). Returns
// cudaErrorCooperativeLaunchTooLarge when the tiles' blocks cannot all be
// resident on this card, else the cudaError_t of the launch.
extern "C" int kt_packing_round(const void* set, int64_t smem, void* stream) {
  const SolveSet& in = *static_cast<const SolveSet*>(set);
  if (in.nlocal < 1 || in.nlocal > kMaxTiles || in.bpt < 1 || in.PG * in.NG > kMaxTiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute((const void*)packing_solve_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, packing_solve_kernel, kThreads,
                                                        (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)occ * sms < in.bpt * in.nlocal) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(in.bar, 0, sizeof(unsigned long long), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(in.abort, 0, sizeof(int32_t), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(in.x.error, 0, sizeof(int32_t), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(in.out, 0, 2 * sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  SolveSet sv = in;
  void* args[] = {&sv};
  err = cudaLaunchCooperativeKernel((const void*)packing_solve_kernel,
                                    dim3((unsigned)(in.bpt * in.nlocal)), dim3(kThreads), args,
                                    (size_t)smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_packing_round_set_size() { return (int64_t)sizeof(SolveSet); }

// The dual ascent's log1p alone, for checking: ours (n,) float32 the
// kernel's log1p_count of each whole-number count k (n,) float32, and
// cuda (n,) float32 CUDA's log1pf of the same counts.
extern "C" int kt_packing_log1p(const void* k, void* ours, void* cuda, int64_t n,
                                void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  packing_log1p<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const float*>(k), static_cast<float*>(ours), static_cast<float*>(cuda), n);
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_packing_round_args_size() { return (int64_t)sizeof(ScoreArgs); }

extern "C" const char* kt_packing_round_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
