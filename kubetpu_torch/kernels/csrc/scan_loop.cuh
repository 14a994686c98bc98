// The greedy scan's loop, shared by greedy_scan.cu (one block, the batch
// itself) and hypothesis_scan.cu (one block per hypothesis: the batch under
// a node mask, and for the gang dry run with an eviction's freed rows).
// greedy_scan.cu's header comment describes the design. The hypothesis
// parts are compiled only into hypothesis_scan.cu (`if constexpr` on
// Hyp::kOn): greedy_scan's instantiations have none of them.
//
// The steps run one after another, and a step's time is the latency of its
// critical path, not its work (PERF.md §6, the step split of `chip_smoke.py
// --time-basic`). So the loop keeps device-memory loads and repeated work
// off that path:
// - each node's verdict is taken ONCE a step (pass 1) and stays in a
//   register bitmask; a touched node's recomputed base score waits in
//   shared memory (`s_base`), an untouched one's is read from `base0` in
//   the score pass;
// - the loads of a pass go out together: every untouched node's
//   `mask0` byte, a chunk of kChunk nodes' normalize raws and base scores;
//   a raw table's row with nothing above 0 is not read at all, and a term
//   normalized against a 0 maximum, the same on every node, is left out of
//   the score;
// - pod p's own inputs (requests, nonzero requests, host ports, its flag and
//   signature rows) are staged in shared memory (`cp.async`, a ring of
//   three) while step p - 1 runs, and the params table once;
// - the touched flags live in the owner's registers (bit i: node tid + i *
//   kThreads), written back to `touched` at the end of the call;
// - a touched node keeps its verdict (a register bit) and base score (its
//   `s_base` entry) while the pods' own inputs stay the same (every staged
//   word, and with nominations their gate rows; never with extender rows)
//   and the node does not change: only the nodes an assignment or a
//   released nomination changed are recomputed (recomputing every touched
//   node every step took half of a Basic step);
// - that recompute, one node a step on a batch of one class, is the step's
//   longest chain: the owner's whole warp takes it (a resource a lane,
//   base_score_warp), without an early return (pair_feasible_eager), and
//   from the rows the warp read and held at the end of the step before
//   (Held) rather than reading them after the owner's atomics;
// - each block reduction takes one barrier: every warp reduces the 16 warp
//   partials itself, from two scratch slots that alternate, and the spread
//   weights take one (sp_weights1);
// - the owner adds the pod to its node with fire-and-forget atomics (no
//   load of the old row on the path).
// A thread owns at most kPer nodes: a block takes N <= kMaxNodes, 16384
// nodes (the wrappers raise above it). That is a deviation from kubetpu,
// whose scan takes any N: the unsharded greedy engine, the placement
// search and the gang dry run, and each shard of K1 and K7, refuse a
// larger block, and such a cluster needs a mesh (no scheduler_perf case
// exceeds 15000 nodes). The block is 512 threads, one a warp lane of 16
// warps.
//
// Under a node mesh (X = MeshShard, greedy_scan.cu's sharded kernel) the
// block is shard g of G and N is its own rows; the exchange (exchange.cuh)
// makes the steps' reductions over nodes global: the spread domain sums at
// the start (then kept replicated: every shard applies the same increment,
// so minMatch needs no exchange), each spread-scored pod's scored count and
// domain bitmaps, the normalize maxima, and the pick by (score, -global
// index), which carries the chosen node's affinity domains and spread
// domains from its owner to every shard. Without a mesh (NoExchange) none
// of this is compiled.
#pragma once

#include <type_traits>

#include "exchange.cuh"
#include "score_common.cuh"

namespace kt {

// 512 threads: at 1024 a thread has 64 registers, and the loop's state
// spilled some 500 bytes a thread, whose local memory (0.5 MB a block)
// missed in L1 on every step; at 512 it has 128
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 32;                                 // nodes a thread owns at most
constexpr int64_t kMaxNodes = (int64_t)kThreads * kPer;  // N a block takes
constexpr int kChunk = 8;        // feasible nodes whose raws are loaded together
constexpr int kRelease = 32;     // released nominations a step keeps by node
constexpr int kStages = 3;       // staged pods: p - 1 (its update), p, p + 1
// the spread bitmaps of all soft slots, two steps' worth, kept in shared
// memory when they take at most this many bytes (sp_weights1)
constexpr int64_t kFastBitmapBytes = 32768;

#ifdef KT_SCAN_SPLIT
// The step split of the timing build (chip_smoke.py --time-basic /
// --time-spread; built with -DKT_SCAN_SPLIT, never on a path): thread 0's
// clock64() cycles summed over the steps between the step's marks: [0]
// the next pod's staging started, [1] the comparison with the pod before,
// minMatch and the untouched verdicts, [2] the stale touched nodes
// recomputed and the moving filters, [3] with a spread leaf the slot
// weights, [4] the normalize fold, [5] its reduction, [6] the score pass,
// [7] the staging's end and the argmax, [8] the owner's update and the end
// of the step; [9] the most cycles any thread spent recomputing touched
// nodes, [10] the mean over threads, [11] the kernel's cycles and [12] its
// nanoseconds (%globaltimer), which convert cycles to time; [13] the mean
// over threads of the recompute's verdict part.
constexpr int kSplitParts = 9;
__device__ unsigned long long kt_split[16];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define KT_SPLIT(...) __VA_ARGS__
#else
#define KT_SPLIT(...)
#endif

// (score, node) with node < 0 meaning "none"; better = higher score, then
// lower node index
__device__ __forceinline__ bool better(int64_t s, int64_t n, int64_t bs, int64_t bn) {
  if (n < 0) return false;
  if (bn < 0) return true;
  return s > bs || (s == bs && n < bn);
}

// the warp's best (score, -node) in lane 0
__device__ __forceinline__ void warp_best(int64_t& s, int64_t& n) {
  for (int off = 16; off > 0; off >>= 1) {
    int64_t os = __shfl_down_sync(0xffffffffu, s, off);
    int64_t on = __shfl_down_sync(0xffffffffu, n, off);
    if (better(os, on, s, n)) {
      s = os;
      n = on;
    }
  }
}

// the best of the kWarps warp partials in every lane (lane l and l + 16
// read the same partial)
__device__ __forceinline__ void partials_best(int64_t& s, int64_t& n) {
  for (int off = kWarps / 2; off > 0; off >>= 1) {
    int64_t os = __shfl_xor_sync(0xffffffffu, s, off);
    int64_t on = __shfl_xor_sync(0xffffffffu, n, off);
    if (better(os, on, s, n)) {
      s = os;
      n = on;
    }
  }
}

__device__ __forceinline__ int64_t partials_max(int64_t v) {
  for (int off = kWarps / 2; off > 0; off >>= 1)
    v = imax(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The loop's block reductions, one barrier each: every warp writes its
// partials into slot k & 1 and, after the barrier, reduces the kWarps
// partials itself. A warp writes slot k & 1 again only at reduction k + 2,
// past the barrier of reduction k + 1, which no warp reaches before it has
// read reduction k's partials.
struct Reducer {
  int64_t (*s)[kNorm + 1][32];  // shared [2][kNorm + 1][32]
  int k;
};

// max over the block of the values v[I...]; every thread gets them
template <int... I>
__device__ __forceinline__ void max1(int64_t (&v)[kNorm], Reducer& red) {
  static_assert(kWarps == 16, "lanes l and l + 16 read warp l's partial");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t(*slot)[32] = red.s[red.k & 1];
  ((v[I] = warp_max(v[I])), ...);
  if (lane == 0) ((slot[I][warp] = v[I]), ...);
  __syncthreads();
  ((v[I] = partials_max(slot[I][lane & (kWarps - 1)])), ...);
  ++red.k;
}

// block_max_norm's selection of the fold_norm maxima, one barrier
__device__ __forceinline__ void max_norm1(const ScoreArgs& a, bool sp_score,
                                          int64_t (&m)[kNorm], Reducer& red) {
  const bool dra = a.dra_raw != nullptr;
  if (sp_score) {
    if (dra)
      max1<0, 1, 2, 3, 4, 5, 6>(m, red);
    else
      max1<0, 1, 2, 3, 4, 5>(m, red);
  } else if (a.w_interpod) {
    if (dra)
      max1<0, 1, 2, 3, 4, 5, 6>(m, red);
    else
      max1<0, 1, 2, 3>(m, red);
  } else if (dra) {
    max1<0, 1, 6>(m, red);
  } else {
    max1<0, 1>(m, red);
  }
}

// the block's best (score, -node); every thread gets it
__device__ __forceinline__ void best1(int64_t& s, int64_t& n, Reducer& red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t(*slot)[32] = red.s[red.k & 1];
  warp_best(s, n);
  if (lane == 0) {
    slot[0][warp] = s;
    slot[1][warp] = n;
  }
  __syncthreads();
  s = slot[0][lane & (kWarps - 1)];
  n = slot[1][lane & (kWarps - 1)];
  partials_best(s, n);
  ++red.k;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// A staged pod, in int64 words: requests [0, R), nonzero requests [R, 2R),
// then six int32 (static_sig, score_sig, dra_sig, img_sig, img_count, and
// pod_valid's byte), then the K host-port bytes.
__host__ __device__ constexpr int64_t stage_words(int64_t R, int64_t K) {
  return 2 * R + 3 + (K + 7) / 8;
}

// Pod p's own inputs from its staged copy (score_common.cuh PodAt's
// members, read from shared memory).
struct StagedPod {
  const ScoreArgs& a;
  int64_t p;
  const int64_t* st;   // the staged words
  const int64_t* prm;  // the staged params table
  __device__ __forceinline__ const int32_t* s32() const {
    return reinterpret_cast<const int32_t*>(st + 2 * a.R);
  }
  __device__ __forceinline__ int64_t req(int64_t r) const { return st[r]; }
  __device__ __forceinline__ int64_t nzr(int64_t r) const { return st[a.R + r]; }
  __device__ __forceinline__ bool port(int64_t k) const {
    return reinterpret_cast<const uint8_t*>(st + 2 * a.R + 3)[k];
  }
  __device__ __forceinline__ bool valid() const {
    return *reinterpret_cast<const uint8_t*>(s32() + 5);
  }
  __device__ __forceinline__ int64_t static_row() const { return (int64_t)s32()[0] * a.N; }
  __device__ __forceinline__ int64_t score_row() const { return (int64_t)s32()[1] * a.N; }
  __device__ __forceinline__ int64_t dra_row() const { return (int64_t)s32()[2] * a.N; }
  __device__ __forceinline__ int64_t img_row() const { return (int64_t)s32()[3] * a.N; }
  __device__ __forceinline__ int64_t img_count() const { return s32()[4]; }
  __device__ __forceinline__ const int64_t* params() const { return prm; }
};

// A byte of the staged pod that this thread loaded into a register, to
// store when the copy is finished (`at` < 0: none).
struct StageHold {
  int at;
  uint8_t v;
};

// Start staging pod p (p < P) into `st`: the int64 rows and int32 signature
// entries by cp.async, the bytes (pod_valid, the host ports) through a
// register held until stage_finish. Every thread calls it.
__device__ __forceinline__ StageHold stage_start(const ScoreArgs& a, int64_t p, int64_t* st) {
  StageHold hold{-1, 0};
  if (p >= a.P) return hold;
  const int64_t R = a.R, K = a.K;
  int32_t* s32 = reinterpret_cast<int32_t*>(st + 2 * R);
  uint8_t* s8 = reinterpret_cast<uint8_t*>(st + 2 * R);
  for (int64_t j = threadIdx.x; j < 2 * R + 6 + K; j += kThreads) {
    if (j < R) {
      cp_async(st + j, a.requests + p * R + j, 8);
    } else if (j < 2 * R) {
      cp_async(st + j, a.nonzero_requests + p * R + (j - R), 8);
    } else if (j < 2 * R + 5) {
      const int64_t e = j - 2 * R;
      const int32_t* src = e == 0   ? a.static_sig
                           : e == 1 ? a.score_sig
                           : e == 2 ? a.dra_sig
                           : e == 3 ? a.img_sig
                                    : a.img_count;
      if (src != nullptr)
        cp_async(s32 + e, src + p, 4);
      else
        s32[e] = 0;
    } else {
      // byte 20 of the int32 block is pod_valid, the ports follow at 24
      const int64_t b = j - 2 * R - 5;
      const int at = b == 0 ? 20 : (int)(23 + b);
      const uint8_t v = b == 0 ? a.pod_valid[p] : a.pod_ports[p * K + (b - 1)];
      if (j < kThreads) {
        hold.at = at;
        hold.v = v;
      } else {
        s8[at] = v;
      }
    }
  }
  return hold;
}

// Finish this thread's part of a staging (visible to the block after its
// next barrier)
__device__ __forceinline__ void stage_finish(const ScoreArgs& a, int64_t* st, StageHold hold) {
  cp_async_wait_all();
  if (hold.at >= 0) reinterpret_cast<uint8_t*>(st + 2 * a.R)[hold.at] = hold.v;
}

// sp_weights1 takes the batch's spread weights: its bitmaps are in shared
// memory (a.sp_bits null), two steps of every soft slot's fit in
// kFastBitmapBytes, and no mesh exchanges them
__device__ __forceinline__ bool sp_fast(const ScoreArgs& a) {
  return a.sp_bits == nullptr && 8 * a.sp_C * ((a.sp_D + 31) / 32) <= kFastBitmapBytes;
}

// The scan's dynamic shared memory: the spread region (kSP: a copy of the
// sp_C slot weights for each warp, then, when a.sp_bits is null, two
// steps' bitmaps of every slot under sp_fast, else one domain bitmap), the
// params
// table, kStages staged pods, then N base scores (a touched node's kept
// one at its index).
struct ScanSmem {
  double* weight;
  uint32_t* bits;
  int64_t* params;
  int64_t* stage;
  int64_t stride;  // int64 words a staged pod
  int64_t* base;
};

__host__ __device__ constexpr int64_t round16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

__device__ __forceinline__ ScanSmem scan_smem(const ScoreArgs& a, bool sp, unsigned char* dyn) {
  const int64_t W = (a.sp_D + 31) / 32;
  const int64_t bitmaps = a.sp_bits != nullptr ? 0 : sp_fast(a) ? 8 * a.sp_C * W : 4 * W;
  const int64_t spread = sp ? round16(8 * a.sp_C * kWarps + bitmaps) : 0;
  const int64_t params = round16(8 * (3 * a.R + 2 * a.B));
  const int64_t stride = stage_words(a.R, a.K);
  ScanSmem m;
  m.weight = reinterpret_cast<double*>(dyn);
  m.bits = reinterpret_cast<uint32_t*>(dyn + 8 * a.sp_C * kWarps);
  m.params = reinterpret_cast<int64_t*>(dyn + spread);
  m.stage = reinterpret_cast<int64_t*>(dyn + spread + params);
  m.stride = stride;
  m.base = m.stage + kStages * stride;
  return m;
}

// sp_weights of pod p in one barrier (sp_fast; kt::sp_weights takes
// three to nine): each warp ORs the domain bits of its scored nodes (ok
// and not ignored; `ok` holds this thread's J verdicts) into this step's
// bitmaps `sbits` (one a soft slot, zeroed a step before), its lanes
// first (set_domain_bits' aggregation), and leaves its scored count in the
// reducer's slot; after the barrier every warp sums the counts and
// popcounts the bitmaps itself into its own copy of the slot weights
// (`wmine`), then the other step's bitmaps (`nbits`) are zeroed for the
// next step (read last a step before, before its later barriers).
__device__ __forceinline__ void sp_weights1(const ScoreArgs& a, int64_t p, uint32_t ok, int J,
                                            uint32_t* sbits, uint32_t* nbits, double* wmine,
                                            Reducer& red) {
  const unsigned all = 0xffffffffu;
  const int64_t N = a.N, C = a.sp_C, W = (a.sp_D + 31) / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* ig = a.sp_ignored + p * N;
  uint32_t scored = 0;
  for (int i = 0; i < J; ++i)
    if ((ok >> i & 1) && !ig[tid + (int64_t)i * kThreads]) scored |= 1u << i;
  for (int64_t c = 0; c < C; ++c) {
    const int32_t sid = a.sp_sig_idx[p * C + c];
    if (sid < 0 || a.sp_action[p * C + c] != 1 || a.sp_is_hostname[sid]) continue;
    for (int i = 0; i < kPer; ++i) {
      const int32_t dom =
          (scored >> i & 1) ? a.sp_node_domain[sid * N + tid + (int64_t)i * kThreads] : -1;
      const unsigned on = __ballot_sync(all, dom >= 0);
      if (dom < 0) continue;
      const unsigned peers = __match_any_sync(on, dom >> 5);
      const unsigned word = __reduce_or_sync(peers, 1u << (dom & 31));
      if (lane == __ffs(peers) - 1) atomicOr(sbits + c * W + (dom >> 5), word);
    }
  }
  int64_t(*slot)[32] = red.s[red.k & 1];
  int64_t cnt = __popc(scored);
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_down_sync(all, cnt, off);
  if (lane == 0) slot[kNorm][warp] = cnt;
  __syncthreads();
  int64_t total = slot[kNorm][lane & (kWarps - 1)];
  for (int off = kWarps / 2; off > 0; off >>= 1) total += __shfl_xor_sync(all, total, off);
  ++red.k;
  for (int64_t c = 0; c < C; ++c) {
    const int32_t sid = a.sp_sig_idx[p * C + c];
    if (sid < 0 || a.sp_action[p * C + c] != 1) {
      if (lane == 0) wmine[c] = 0.0;
      continue;
    }
    int64_t size = total;
    if (!a.sp_is_hostname[sid]) {
      int64_t bitsum = 0;
      for (int64_t w = lane; w < W; w += 32) bitsum += __popc(sbits[c * W + w]);
      for (int off = 16; off > 0; off >>= 1) bitsum += __shfl_xor_sync(all, bitsum, off);
      size = bitsum;
    }
    if (lane == 0) wmine[c] = log(__dadd_rn(__ll2double_rn(size), 2.0));
  }
  __syncwarp();
  for (int64_t j = tid; j < C * W; j += kThreads) nbits[j] = 0;
}

// The normalize raws a step reads: a table's row is skipped when no entry
// of it is above 0 (zero_rows): the masked maximum over the feasible nodes
// then stays 0 and a normalize against a 0 maximum reads no raw, so the
// skipped raw's 0 scores as the raw would.
struct RawLoads {
  bool na, tt, dra;
};

__device__ __forceinline__ NormRaws raws_of(const ScoreArgs& a, const RawLoads& rl, int64_t row,
                                            int64_t drow, int64_t n) {
  NormRaws v;
  if (rl.na) v.na = a.na_raw[row + n];
  if (rl.tt) v.tt = a.tt_raw[row + n];
  if (rl.dra) v.dra = a.dra_raw[drow + n];
  return v;
}

// the node-affinity, taint and DRA terms of a feasible pair, each only
// where `use` names its table (an unnamed term is the same on every node)
__device__ __forceinline__ int64_t norm_used(const ScoreArgs& a, const RawLoads& use,
                                             const NormRaws& v, const int64_t (&m)[kNorm]) {
  int64_t s = 0;
  if (use.na) s += a.w_na * normalize(v.na, m[0], false);
  if (use.tt) s += a.w_taint * normalize(v.tt, m[1], true);
  if (use.dra) s += a.w_dra * normalize(v.dra, m[6], false);
  return s;
}

struct OrOp {
  __device__ int64_t operator()(int64_t x, int64_t y) const { return x | y; }
};

// Bit s of `zero` for a row s < 32 of `table` (N columns) that some pod's
// sig[p] names and that holds nothing above 0. Every thread of the block
// calls it (block reductions) and gets the same bits.
__device__ __forceinline__ uint32_t zero_rows(const ScoreArgs& a, const int64_t* table,
                                              const int32_t* sig, int64_t* red) {
  if (table == nullptr) return 0;
  int64_t named = 0;
  for (int64_t p = threadIdx.x; p < a.P; p += kThreads)
    if (sig[p] >= 0 && sig[p] < 32) named |= int64_t{1} << sig[p];
  named = block_reduce(named, OrOp(), 0, red);
  uint32_t zero = 0;
  for (int s = 0; s < 32; ++s) {
    if (!(named >> s & 1)) continue;
    int64_t v = INT64_MIN;
    for (int64_t n = threadIdx.x; n < a.N; n += kThreads) v = imax(v, table[s * a.N + n]);
    if (block_reduce(v, MaxOp(), INT64_MIN, red) <= 0) zero |= 1u << s;
  }
  return zero;
}

// The rows of the node a step placed its pod on, read by its owner's warp
// at the end of that step and held for the next step's recompute of it
// (lane r < R: resource r's allocatable, running requested and nonzero;
// every lane: the running pod count, allowed pods and validity). `node`
// is -1 when this warp holds none.
struct Held {
  int64_t node = -1;
  int64_t cap = 0, req = 0, nz = 0;
  int32_t pc = 0, allowed = 0;
  bool valid = false;
};

// pair_feasible_eager of the held node for pod q, in a batch without
// nominations or extender rows (where those tests pass): the same tests,
// ANDed, resource r's fit taken by lane r. Every lane of the warp calls it.
template <class Q>
__device__ __forceinline__ bool held_verdict(const ScoreArgs& a, const Q& q, const Held& h,
                                             const uint8_t* ports) {
  const int64_t n = h.node;
  bool ok = h.valid && q.valid();
  if (a.static_mask != nullptr) ok &= a.static_mask[q.static_row() + n] != 0;
  if (a.filter_fit) {
    ok &= h.pc + 1 <= h.allowed;
    bool fits = true;
    const int64_t r = threadIdx.x & 31;
    if (r < a.R) {
      const int64_t v = q.req(r);
      fits = v == 0 || v <= h.cap - h.req;
    }
    ok &= __all_sync(0xffffffffu, fits) != 0;
  }
  if (a.filter_ports) ok &= !ports_conflict(a, q, ports + n * a.K);
  return ok;
}

// No hypothesis: the scan runs over the batch's own nodes and state.
struct NoHypothesis {
  static constexpr bool kOn = false;
};

// No exchange: the block scans the whole batch.
struct NoExchange {
  static constexpr bool kOn = false;
};

// Shard g of a node mesh: this thread's view of the exchange (its count of
// exchanges lives with the caller, so that a scan run in segments, one a
// pod row of a pods x nodes grid, keeps counting), the shard's first global
// node, and the block's shared scratch for the exchange.
struct MeshShard {
  static constexpr bool kOn = true;
  Xchg* e;
  int64_t offset;
  int* flag;     // shared: the last wait's outcome
  int* win;      // shared: the last pick's winning shard
  int64_t* red;  // shared: kNorm reduced words
};

// sp_weights over the mesh: the scored count sums and each soft slot's
// domain bitmap ORs across the shards before `size` is taken. Payload:
// the scored count, then C bitmaps of ceil(D / 32) words. False on an
// exchange timeout.
__device__ __forceinline__ bool sp_weights_mesh(const ScoreArgs& a, int64_t p,
                                                const uint8_t* ok, uint32_t* bits,
                                                double* weight, int64_t* red, MeshShard& x) {
  const int64_t N = a.N, C = a.sp_C, W = (a.sp_D + 31) / 32;
  const uint8_t* ig = a.sp_ignored + p * N;
  int64_t scored = 0;
  for (int64_t n = threadIdx.x; n < N; n += blockDim.x) scored += ok[n] && !ig[n];
  scored = block_reduce(scored, SumOp(), 0, red);
  int64_t* w = x.e->mine();
  if (threadIdx.x == 0) w[0] = scored;
  for (int64_t c = 0; c < C; ++c) {
    int64_t* wc = w + 1 + c * W;
    const int32_t sid = a.sp_sig_idx[p * C + c];
    const bool bitmap = sid >= 0 && a.sp_action[p * C + c] == 1 && !a.sp_is_hostname[sid];
    if (!bitmap) {
      for (int64_t j = threadIdx.x; j < W; j += blockDim.x) wc[j] = 0;
      continue;
    }
    for (int64_t j = threadIdx.x; j < W; j += blockDim.x) bits[j] = 0;
    __syncthreads();
    set_domain_bits(a, sid, ok, ig, bits);
    __syncthreads();
    for (int64_t j = threadIdx.x; j < W; j += blockDim.x) wc[j] = (int64_t)bits[j];
  }
  if (!xchg_sync(*x.e, x.flag)) return false;
  const int64_t G = x.e->x->G;
  int64_t total = 0;
  if (threadIdx.x == 0)
    for (int64_t h = 0; h < G; ++h) total += xchg_payload(*x.e, h)[0];
  total = block_reduce(total, SumOp(), 0, red);
  for (int64_t c = 0; c < C; ++c) {
    const int32_t sid = a.sp_sig_idx[p * C + c];
    if (sid < 0 || a.sp_action[p * C + c] != 1) {
      if (threadIdx.x == 0) weight[c] = 0.0;
      continue;
    }
    int64_t size = total;
    if (!a.sp_is_hostname[sid]) {
      int64_t cnt = 0;
      for (int64_t j = threadIdx.x; j < W; j += blockDim.x) {
        int64_t v = 0;
        for (int64_t h = 0; h < G; ++h) v |= xchg_payload(*x.e, h)[1 + c * W + j];
        cnt += __popc((uint32_t)v);
      }
      size = block_reduce(cnt, SumOp(), 0, red);
    }
    if (threadIdx.x == 0) weight[c] = log(__dadd_rn(__ll2double_rn(size), 2.0));
  }
  __syncthreads();
  return true;
}

// One hypothesis of hypothesis_scan.cu: the scan runs over the nodes of
// `mask` (node_valid & mask, as the reference's `one` sets it) and, when
// freed_req is not null, starts from requested - freed_req,
// nonzero_requested - freed_req and pod_count - freed_count, each clamped
// at 0. The freed nodes start touched: their verdict and base score are
// recomputed from the reduced rows, every other node reuses mask0 / base0.
struct Hypothesis {
  static constexpr bool kOn = true;
  const uint8_t* mask;         // (N,)
  const int64_t* freed_req;    // (N, R), null = nothing freed
  const int32_t* freed_count;  // (N,), null with freed_req
};

// The scan of one block over the batch's pods. kPA: the batch has
// affinity rows; kSP: it has a spread leaf; kDRA: it has the
// DynamicResources score leaf. Each kernel that runs it is built eight
// times, so that a batch without them runs code with no affinity, spread
// or DRA branches at all. Dynamic shared memory: scan_smem's layout
// (scan_smem_bytes in kubetpu_torch/kernels/__init__.py). Every thread of
// the block calls it; the scratch and outputs are the block's own. With
// `carry` the running state (the rows, touched flags, affinity sums and row
// totals, spread counts and domain sums, live nominations) is not started
// from the batch's: it goes on from what an earlier call left in the same
// buffers (the grid's scan, one call a pod row).
template <bool kPA, bool kSP, bool kDRA, class Hyp, class X = NoExchange, class A = ScoreArgs>
__device__ __forceinline__ void scan_loop(A& a, const Hyp& h, X x, const uint8_t* mask0,
                                          const int64_t* base0, uint8_t* touched,
                                          int32_t* assignments, int64_t* req, int64_t* nz,
                                          int32_t* pc, uint8_t* ports, int64_t* pa_sums,
                                          int64_t* row_total, int32_t* sp_counts,
                                          uint8_t* ok_buf, bool carry = false) {
  __shared__ int64_t s_red[2][kNorm + 1][32];
  __shared__ int64_t s_x[33];
  __shared__ int s_rel_n[2];
  __shared__ int32_t s_rel[2][kRelease];
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int64_t N = a.N, R = a.R, K = a.K;
  const int tid = threadIdx.x, lane = tid & 31;
  if constexpr (!std::is_const_v<A>) {
    // (the sharded kernel reads its arguments in place, from its
    // __grid_constant__ parameter: there the host leaves these fields
    // zero whenever the batch lacks the leaf)
    if (!kPA) a.w_interpod = 0;
    if (!kDRA) a.dra_raw = nullptr;
    if (!kSP) {
      a.w_spread = 0;
      a.sp_filter = 0;
    }
  }
  const bool pa = kPA;
  const bool pa_filter = kPA && a.pa_filter;
  const bool nom = a.nom_node != nullptr && a.G > 0;
  const int64_t S = a.sp_S, D1 = a.sp_D + 1;
  const ScanSmem sm = scan_smem(a, kSP, s_dyn);
  double* weight = sm.weight;
  uint32_t* bits = a.sp_bits != nullptr ? a.sp_bits : sm.bits;
  // sp_weights1's bitmaps (two steps' of every slot) and this warp's
  // copy of the slot weights
  const bool fast = kSP && !X::kOn && sp_fast(a);
  const int64_t CW = a.sp_C * ((a.sp_D + 31) / 32);
  double* const wsp = fast ? weight + (tid >> 5) * a.sp_C : weight;
  int64_t* s_base = sm.base;
  // this thread's nodes: n = tid + i * kThreads for i < J (J <= kPer)
  const int J = tid < N ? (int)((N - 1 - tid) / kThreads) + 1 : 0;
  uint32_t own = J >= 32 ? ~0u : (1u << J) - 1;  // the nodes the scan may place on
  uint32_t tb = 0;  // touched: bit i of node i
  uint32_t dd = 0;  // touched nodes whose kept verdict and base score are stale
  uint32_t cv = 0;  // the kept verdicts of the touched nodes

  // the running state starts as the batch's node state (owner rows only)
  if (carry) {
    // goes on from the buffers as they are
    for (int i = 0; i < J; ++i) tb |= (uint32_t)(touched[tid + (int64_t)i * kThreads] != 0) << i;
  } else if constexpr (Hyp::kOn) {
    // less what the hypothesis frees, clamped at 0 (the reference's
    // jnp.maximum(... - freed, 0)); a freed node starts touched
    for (int i = 0; i < J; ++i) {
      const int64_t n = tid + (int64_t)i * kThreads;
      bool freed = false;
      for (int64_t r = 0; r < R; ++r) {
        int64_t rq = a.requested[n * R + r], z = a.nonzero_requested[n * R + r];
        if (h.freed_req != nullptr) {
          const int64_t f = h.freed_req[n * R + r];
          freed = freed || f != 0;
          rq = kt::imax(rq - f, 0);
          z = kt::imax(z - f, 0);
        }
        req[n * R + r] = rq;
        nz[n * R + r] = z;
      }
      int32_t c = a.pod_count[n];
      if (h.freed_req != nullptr) {
        const int32_t f = h.freed_count[n];
        freed = freed || f != 0;
        c = c - f > 0 ? c - f : 0;
      }
      pc[n] = c;
      for (int64_t k = 0; k < K; ++k) ports[n * K + k] = a.node_ports[n * K + k];
      tb |= (uint32_t)freed << i;
    }
  } else {
    for (int64_t n = tid; n < N; n += kThreads) {
      for (int64_t r = 0; r < R; ++r) {
        req[n * R + r] = a.requested[n * R + r];
        nz[n * R + r] = a.nonzero_requested[n * R + r];
      }
      pc[n] = a.pod_count[n];
      for (int64_t k = 0; k < K; ++k) ports[n * K + k] = a.node_ports[n * K + k];
    }
  }
  if constexpr (Hyp::kOn) {
    // the hypothesis's mask joins the owner's registers once
    for (int i = 0; i < J; ++i)
      if (!h.mask[tid + (int64_t)i * kThreads]) own &= ~(1u << i);
  }
  if (pa && !carry) {
    for (int64_t i = tid; i < a.pa_R * a.pa_D; i += kThreads) pa_sums[i] = a.pa_sums[i];
    kt::pa_row_totals(a, a.pa_sums, row_total, tid, kThreads);
    __syncthreads();
  }
  if constexpr (kSP) {
    if (!carry) {
      // the running counts start as the batch's, their domain sums from them
      for (int64_t i = tid; i < S * N; i += kThreads) sp_counts[i] = a.sp_counts[i];
      for (int64_t i = tid; i < S * D1; i += kThreads) a.sp_sums[i] = 0;
      __syncthreads();
      kt::sp_accumulate(a, sp_counts, a.sp_sums, 0, 1);
      __syncthreads();
      if constexpr (X::kOn) {
        // the shards' partial domain sums, summed: replicated from here on
        int64_t* w = x.e->mine();
        for (int64_t i = tid; i < S * D1; i += kThreads) w[i] = a.sp_sums[i];
        if (!xchg_reduce(*x.e, S * D1, 1, a.sp_sums, x.flag)) return;
      }
    }
  }
  // the params table once, and the first pod, staged before the loop (the
  // stages zeroed first: their padding takes part in the comparison below;
  // and sp_weights1's bitmaps, which each step zeroes for the next)
  for (int64_t j = tid; j < 3 * R + 2 * a.B; j += kThreads) sm.params[j] = a.params[j];
  for (int64_t j = tid; j < kStages * sm.stride; j += kThreads) sm.stage[j] = 0;
  if (fast)
    for (int64_t j = tid; j < 2 * CW; j += kThreads) bits[j] = 0;
  __syncthreads();
  stage_finish(a, sm.stage, stage_start(a, 0, sm.stage));
  if (tid < 2) s_rel_n[tid] = 0;
  __syncthreads();
  const bool reuse = a.ext_mask == nullptr && a.ext_score == nullptr;
  const bool hold_rows = reuse && !nom && R <= 32;
  Held held;

  Reducer red{s_red, 0};
  const bool na_tt = a.na_raw != nullptr || a.tt_raw != nullptr;
  const bool normalize = na_tt || a.w_interpod || a.dra_raw != nullptr;
  // the raw rows no step needs to read (not under a mesh: a shard's row
  // can be all 0 where another's is not, and the maxima are global)
  uint32_t zna = 0, ztt = 0, zdra = 0;
  if constexpr (!X::kOn) {
    zna = zero_rows(a, a.na_raw, a.score_sig, s_x);
    ztt = zero_rows(a, a.tt_raw, a.score_sig, s_x);
    zdra = zero_rows(a, a.dra_raw, a.dra_sig, s_x);
  }
  KT_SPLIT(unsigned long long acc[kSplitParts] = {}; long long touch = 0, touch_v = 0;
           const long long k0 = clock64(); const unsigned long long ns0 = global_ns();
           long long mark = k0;
           auto split = [&](int i) {
             const long long now = clock64();
             acc[i] += now - mark;
             mark = now;
           };)
  for (int64_t p = 0; p < a.P; ++p) {
    KT_SPLIT(mark = clock64();)
    const StagedPod q{a, p, sm.stage + (p % kStages) * sm.stride, sm.params};
    const int64_t row = na_tt ? q.score_row() : 0;
    const int64_t drow = a.dra_raw != nullptr ? q.dra_row() : 0;
    const uint32_t sg = (uint32_t)q.s32()[1], dg = (uint32_t)q.s32()[2];
    const RawLoads rl{a.na_raw != nullptr && !(sg < 32 && (zna >> sg & 1)),
                      a.tt_raw != nullptr && !(sg < 32 && (ztt >> sg & 1)),
                      a.dra_raw != nullptr && !(dg < 32 && (zdra >> dg & 1))};
    const uint8_t* m0 = mask0 + p * N;
    const int64_t* b0 = base0 + p * N;
    const uint32_t live = own & ~tb;  // the untouched nodes
    // pod p + 1's own inputs staged while this step runs
    int64_t* next = sm.stage + ((p + 1) % kStages) * sm.stride;
    const StageHold hold = stage_start(a, p + 1, next);
    KT_SPLIT(split(0);)
    // pod p's own inputs equal pod p - 1's: a touched node that no
    // assignment or release changed keeps its verdict and base score
    bool same = reuse && p > 0;
    if (same) {
      // every staged word but the score and DRA signatures (int32 1 and
      // 2 of the signature block), which only the normalize terms read
      const int64_t* prev = sm.stage + ((p + kStages - 1) % kStages) * sm.stride;
      const int32_t* x = q.s32();
      const int32_t* y = reinterpret_cast<const int32_t*>(prev + 2 * R);
      for (int64_t j = 0; j < sm.stride; ++j)
        if (j < 2 * R || j > 2 * R + 1) same &= q.st[j] == prev[j];
      same &= x[0] == y[0] && x[3] == y[3];
    }
    if (nom) {
      int diff = !same;
      for (int64_t g = tid; g < a.G && p > 0; g += kThreads)
        diff |= a.nom_gate[p * a.G + g] != a.nom_gate[(p - 1) * a.G + g];
      same = !__syncthreads_or(diff);
    }
    if (!same) dd = tb;
    const bool escape = pa_filter && kt::pa_escape(a, row_total, p);
    const bool sp_score = kSP && a.w_spread && kt::sp_any_soft(a, p);
    // the rounded spread raw of a feasible node, -1 when it is not scored
    auto spread_raw = [&](int64_t n) {
      return kt::sp_scored_raw(a, sp_score, sp_counts, a.sp_sums, wsp, p, n);
    };
    if constexpr (kSP) {
      // every signature's minMatch against the running sums
      if (a.sp_filter) {
        for (int64_t sg = 0; sg < S; ++sg) {
          const int64_t mm = kt::sp_min_over_domains(a, a.sp_sums, sg, s_x);
          if (tid == 0) a.sp_min_match[sg] = mm;
        }
        __syncthreads();
      }
    }
    // (1) every node's verdict against the running state, once: the stale
    // touched nodes' rows fetched first, then the untouched nodes' mask0
    // bytes, loaded together, then the stale recomputed (verdict and base
    // score, kept)
    uint32_t ok = 0;
    for (uint32_t t = own & dd; t; t &= t - 1) {
      // (the running rows, which the owner's atomics changed, are read
      // after the warp's __syncwarp below, not prefetched)
      const int64_t n = tid + (int64_t)(__ffs(t) - 1) * kThreads;
      prefetch_l1(a.node_valid + n);
      prefetch_l1(a.allowed_pods + n);
      prefetch_l1(a.alloc + n * R);
      if (a.static_mask != nullptr) prefetch_l1(a.static_mask + q.static_row() + n);
    }
    {
      uint8_t mk[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        mk[i] = (live >> i & 1) ? m0[tid + (int64_t)i * kThreads] : 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) ok |= (uint32_t)(mk[i] != 0) << i;
    }
    KT_SPLIT(split(1);)
    // the stale touched nodes: a warp's only one by the whole warp of its
    // owner (every lane tests the verdict, the same loads, broadcast, and
    // takes a resource of the base score, base_score_warp), from the rows
    // the warp holds for the node the step before placed on, else from
    // memory; several in a warp (a new pod class) each by its owner lane,
    // in parallel. The warp's barrier orders the owner's updates of the
    // rows (its atomics) before the other lanes read them.
    __syncwarp();
    const unsigned stale = __ballot_sync(0xffffffffu, (own & dd) != 0);
    if (__popc(stale) > 1 || (stale && __popc(__shfl_sync(0xffffffffu, own & dd,
                                                            __ffs(stale) - 1)) > 1)) {
      for (uint32_t t = own & dd; t; t &= t - 1) {
        const int i = __ffs(t) - 1;
        const int64_t n = tid + (int64_t)i * kThreads;
        KT_SPLIT(const long long t0 = clock64();)
        cv &= ~(1u << i);
        if (kt::pair_feasible_eager(a, q, n, req, pc, ports)) {
          cv |= 1u << i;
          s_base[n] = kt::base_score_of(a, q, n, req, nz);
        }
        KT_SPLIT(touch += clock64() - t0;)
      }
      dd &= ~own;
    }
    for (unsigned todo = __ballot_sync(0xffffffffu, (own & dd) != 0); todo;
         todo = __ballot_sync(0xffffffffu, (own & dd) != 0)) {
      const int src = __ffs(todo) - 1;
      const int i = __ffs(__shfl_sync(0xffffffffu, own & dd, src)) - 1;
      const int64_t n = (tid - lane + src) + (int64_t)i * kThreads;
      KT_SPLIT(const long long t0 = clock64();)
      // the base score taken whatever the verdict, so that its loads and
      // divisions overlap the verdict's (kept only for a feasible node)
      const bool from_held = n == held.node;
      const bool fits = from_held ? held_verdict(a, q, held, ports)
                                  : kt::pair_feasible_eager(a, q, n, req, pc, ports);
      KT_SPLIT(const long long t1 = clock64(); touch_v += t1 - t0;)
      const int64_t base =
          from_held ? kt::base_score_warp_v(a, q, n, held.cap, held.req, held.nz)
          : R <= 32 ? kt::base_score_warp(a, q, n, req, nz)
                    : kt::base_score_of(a, q, n, req, nz);
      if (lane == src) {
        cv = fits ? cv | (1u << i) : cv & ~(1u << i);
        if (fits) s_base[n] = base;
        dd &= ~(1u << i);
      }
      KT_SPLIT(touch += clock64() - t0;)
    }
    ok |= cv & own & tb;
    // the filters that move with each assignment
    if (pa_filter || (kSP && a.sp_filter)) {
      for (uint32_t t = ok; t; t &= t - 1) {
        const int i = __ffs(t) - 1;
        const int64_t n = tid + (int64_t)i * kThreads;
        bool keep = true;
        if (pa_filter) keep = kt::pa_feasible(a, pa_sums, escape, p, n);
        if (kSP && keep && a.sp_filter) keep = kt::sp_feasible(a, a.sp_sums, a.sp_min_match, p, n);
        if (!keep) ok &= ~(1u << i);
      }
    }
    KT_SPLIT(split(2);)
    if constexpr (kSP) {
      // each soft slot's size from the verdicts
      if (fast) {
        if (sp_score)
          sp_weights1(a, p, ok, J, bits + (p & 1) * CW, bits + ((p + 1) & 1) * CW, wsp, red);
      } else {
        for (int i = 0; i < J; ++i) ok_buf[tid + (int64_t)i * kThreads] = ok >> i & 1;
        __syncthreads();
        if (sp_score) {
          if constexpr (X::kOn) {
            if (!sp_weights_mesh(a, p, ok_buf, bits, weight, s_x, x)) return;
          } else {
            kt::sp_weights(a, p, ok_buf, bits, weight, s_x);
          }
        }
      }
    }
    KT_SPLIT(split(3);)
    // the normalize inputs over the feasible nodes (without affinity and
    // spread terms, none when the step skips every raw row: the maxima
    // stay 0)
    int64_t mx[kt::kNorm];
    kt::init_norm(mx);
    if ((kPA || kSP) ? (normalize || sp_score) : (rl.na || rl.tt || rl.dra)) {
      if constexpr (kPA || kSP) {
        for (uint32_t t = ok; t; t &= t - 1) {
          const int64_t n = tid + (int64_t)(__ffs(t) - 1) * kThreads;
          const int64_t pa_r = a.w_interpod ? kt::pa_raw(a, pa_sums, p, n) : 0;
          const NormRaws v = raws_of(a, rl, row, drow, n);
          kt::fold_norm_vals(a, v.na, v.tt, v.dra, pa_r, spread_raw(n), mx);
        }
      } else {
        // the raws of a chunk of nodes loaded together (feasible or not: the
        // loads then carry no branch), then folded
        for (int c = 0; c < J; c += kChunk) {
          kt::NormRaws v[kChunk];
#pragma unroll
          for (int k = 0; k < kChunk; ++k)
            if (c + k < J) v[k] = raws_of(a, rl, row, drow, tid + (int64_t)(c + k) * kThreads);
#pragma unroll
          for (int k = 0; k < kChunk; ++k)
            if (c + k < J && (ok >> (c + k) & 1))
              kt::fold_norm_vals(a, v[k].na, v[k].tt, v[k].dra, 0, -1, mx);
        }
      }
      KT_SPLIT(split(4);)
      max_norm1(a, sp_score, mx, red);
      if constexpr (X::kOn) {
        int64_t* w = x.e->mine();
        if (tid == 0)
          for (int i = 0; i < kt::kNorm; ++i) w[i] = mx[i];
        if (!xchg_reduce(*x.e, kt::kNorm, 0, x.red, x.flag)) return;
        for (int i = 0; i < kt::kNorm; ++i) mx[i] = x.red[i];
      }
    }
    KT_SPLIT(split(5);)
    // (2) best feasible node of this thread, then of the block: an
    // untouched node's base score from base0, a touched one's kept
    int64_t best_s = 0, best_n = -1;
    if constexpr (kPA || kSP) {
      for (uint32_t t = ok; t; t &= t - 1) {
        const int i = __ffs(t) - 1;
        const int64_t n = tid + (int64_t)i * kThreads;
        int64_t s = (tb >> i & 1) ? s_base[n] : b0[n];
        if (normalize || sp_score) {
          const int64_t pa_r = a.w_interpod ? kt::pa_raw(a, pa_sums, p, n) : 0;
          s += kt::norm_terms_vals(a, raws_of(a, rl, row, drow, n), true, pa_r, spread_raw(n),
                                   mx);
        }
        if (better(s, n, best_s, best_n)) {
          best_s = s;
          best_n = n;
        }
      }
    } else {
      // a chunk's base scores and raws loaded together, then scored. A
      // term normalized against a 0 maximum is the same on every feasible
      // node (0, or the taint term's w_taint * 100), on every shard of a
      // mesh too: it is left out, which moves no pick (only the
      // assignments leave the scan)
      const RawLoads use{rl.na && mx[0] > 0, rl.tt && mx[1] > 0, rl.dra && mx[6] > 0};
      const bool terms = use.na || use.tt || use.dra;
      for (int c = 0; c < J; c += kChunk) {
        int64_t bs[kChunk];
        kt::NormRaws v[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (c + k >= J) continue;
          const int64_t n = tid + (int64_t)(c + k) * kThreads;
          bs[k] = (tb >> (c + k) & 1) ? s_base[n] : b0[n];
          if (terms) v[k] = raws_of(a, use, row, drow, n);
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (c + k >= J || !(ok >> (c + k) & 1)) continue;
          const int64_t n = tid + (int64_t)(c + k) * kThreads;
          int64_t s = bs[k];
          if (terms) s += norm_used(a, use, v[k], mx);
          if (better(s, n, best_s, best_n)) {
            best_s = s;
            best_n = n;
          }
        }
      }
    }
    KT_SPLIT(split(6);)
    stage_finish(a, next, hold);
    best1(best_s, best_n, red);
    if constexpr (!X::kOn) {
      if (tid == 0) assignments[p] = (int32_t)best_n;  // -1 when no node is feasible
    }
    KT_SPLIT(split(7);)
    // (3) the owner of the chosen node assumes the pod onto it. Under a
    // mesh, each shard offers its best with its node's affinity domains and
    // spread domains (-1: not eligible), and the pick's winner owns it.
    int64_t chosen = best_n;  // global index, -1 for none
    int64_t local = chosen;   // the shard's row, -1 when another shard's
    const volatile int64_t* pub = nullptr;
    if constexpr (X::kOn) {
      if (tid == 0) {
        x.e->mine()[0] = best_s;
        x.e->mine()[1] = best_n >= 0 ? best_n + x.offset : -1;
      }
      int64_t* w = x.e->mine() + 2;
      for (int64_t r = tid; r < (kPA ? a.pa_R : 0); r += kThreads)
        w[r] = local >= 0 ? a.pa_node_domain[r * N + local] : -1;
      if constexpr (kSP) {
        for (int64_t sg = tid; sg < S; sg += kThreads) {
          int64_t enc = -1;
          if (local >= 0 && a.sp_eligible[sg * N + local]) {
            const int32_t dom = a.sp_node_domain[sg * N + local];
            enc = dom >= 0 ? dom : a.sp_D;
          }
          w[(kPA ? a.pa_R : 0) + sg] = enc;
        }
      }
      if (!xchg_pick(*x.e, x.win, x.flag)) return;
      const int win = *x.win;
      chosen = win >= 0 ? xchg_payload(*x.e, win)[1] : -1;
      local = (chosen >= x.offset && chosen < x.offset + N) ? chosen - x.offset : -1;
      if (win >= 0) pub = xchg_payload(*x.e, win) + 2;
      if (tid == 0) assignments[p] = (int32_t)chosen;
    }
    if (local >= 0 && local % kThreads == tid) {
      tb |= 1u << (int)(local / kThreads);
      dd |= 1u << (int)(local / kThreads);
      for (int64_t r = 0; r < R; ++r) {
        atomicAdd(reinterpret_cast<unsigned long long*>(req + local * R + r),
                  (unsigned long long)q.req(r));
        atomicAdd(reinterpret_cast<unsigned long long*>(nz + local * R + r),
                  (unsigned long long)q.nzr(r));
      }
      atomicAdd(pc + local, 1);
      for (int64_t k = 0; k < K; ++k)
        if (q.port(k)) ports[local * K + k] = 1;
    }
    // the owner's warp reads the node's new rows now and holds them for
    // the next step, which recomputes the node (a batch with nominations or
    // extender rows, or more than 32 resources, reads them then)
    held.node = -1;
    if (hold_rows && local >= 0 && (local % kThreads) >> 5 == tid >> 5) {
      __syncwarp();
      held.node = local;
      if (lane < R) {
        held.cap = a.alloc[local * R + lane];
        held.req = req[local * R + lane];
        held.nz = nz[local * R + lane];
      }
      held.pc = pc[local];
      held.allowed = a.allowed_pods[local];
      held.valid = a.node_valid[local];
    }
    if (pa) {
      // interpodaffinity updateWithPod: row r at the chosen node's domain
      if (chosen >= 0) {
        for (int64_t r = tid; r < a.pa_R; r += kThreads) {
          int32_t dom;
          if constexpr (X::kOn) {
            dom = (int32_t)pub[r];
          } else {
            dom = a.pa_node_domain[r * N + chosen];
          }
          if (dom < 0) continue;
          const int64_t inc = a.pa_update[p * a.pa_R + r];
          pa_sums[r * a.pa_D + dom] += inc;
          row_total[r] += inc;
        }
      }
    }
    if constexpr (kSP) {
      // spread updateWithPod (filtering.go:181): +1 at the chosen node in
      // every signature the pod matches and the node is eligible for
      if (chosen >= 0) {
        for (int64_t sg = tid; sg < S; sg += kThreads) {
          if constexpr (X::kOn) {
            // every shard adds the owner's published domain to its sums
            const int64_t enc = pub[(kPA ? a.pa_R : 0) + sg];
            if (!a.sp_pod_match_sig[p * S + sg] || enc < 0) continue;
            if (local >= 0) sp_counts[sg * N + local] += 1;
            a.sp_sums[sg * D1 + enc] += 1;
          } else {
            if (!a.sp_pod_match_sig[p * S + sg] || !a.sp_eligible[sg * N + chosen]) continue;
            sp_counts[sg * N + chosen] += 1;
            const int32_t dom = a.sp_node_domain[sg * N + chosen];
            a.sp_sums[sg * D1 + (dom >= 0 ? dom : a.sp_D)] += 1;
          }
        }
      }
    }
    const int rel = (int)(p & 1);
    if (nom) {
      // assume deletes the nomination (schedule_one.go:307); its node's
      // owner marks the node touched after the barrier below
      if (tid == 0) s_rel_n[rel ^ 1] = 0;  // last read in step p - 1
      if (chosen >= 0) {
        for (int64_t g = tid; g < a.G; g += kThreads) {
          if (a.nom_pod_idx[g] != p || !a.nom_active[g]) continue;
          a.nom_active[g] = 0;
          const int32_t nn = a.nom_node[g];
          if (nn < 0) continue;
          const int slot = atomicAdd(s_rel_n + rel, 1);
          if (slot < kRelease) s_rel[rel][slot] = nn;
        }
      }
    }
    if (pa || kSP || nom) __syncthreads();
    if (nom) {
      const int cnt = s_rel_n[rel];
      if (cnt > kRelease) {
        tb = dd = ~0u;  // more releases than the list holds: recompute every node
      } else {
        for (int j = 0; j < cnt; ++j) {
          if (s_rel[rel][j] % kThreads != tid) continue;
          tb |= 1u << (int)(s_rel[rel][j] / kThreads);
          dd |= 1u << (int)(s_rel[rel][j] / kThreads);
        }
      }
    }
    KT_SPLIT(split(8);)
  }
  // the touched flags back to their buffer (a grid's next pod row goes on
  // from them)
  for (int i = 0; i < J; ++i) touched[tid + (int64_t)i * kThreads] = tb >> i & 1;
  KT_SPLIT({
    const long long k1 = clock64();
    const unsigned long long ns1 = global_ns();
    const int64_t most = kt::block_reduce(touch, kt::MaxOp(), 0, s_x);
    const int64_t sum = kt::block_reduce(touch, kt::SumOp(), 0, s_x);
    const int64_t sum_v = kt::block_reduce(touch_v, kt::SumOp(), 0, s_x);
    if (tid == 0) {
      for (int i = 0; i < kSplitParts; ++i) kt_split[i] = acc[i];
      kt_split[9] = (unsigned long long)most;
      kt_split[10] = (unsigned long long)(sum / kThreads);
      kt_split[11] = (unsigned long long)(k1 - k0);
      kt_split[12] = ns1 - ns0;
      kt_split[13] = (unsigned long long)(sum_v / kThreads);
    }
  })
}

#ifdef KT_SCAN_SPLIT
// The step floor of the timing build: P steps of the loop's block shape
// that keep only its reductions and barriers (the normalize maxima of
// `norm` values, 0 for none, and the argmax) over register values, no
// memory load on the way.
__global__ void __launch_bounds__(kThreads, 1) scan_floor_kernel(int64_t P, int64_t N, int norm,
                                                                 int64_t* out) {
  __shared__ int64_t s_red[2][kNorm + 1][32];
  const int tid = threadIdx.x;
  Reducer red{s_red, 0};
  int64_t acc = 0;
  for (int64_t p = 0; p < P; ++p) {
    int64_t mx[kt::kNorm];
    kt::init_norm(mx);
    for (int64_t n = tid; n < N; n += kThreads) {
      mx[0] = kt::imax(mx[0], (n * 7 + p) & 63);
      mx[1] = kt::imax(mx[1], (n * 5 + p) & 31);
    }
    if (norm == 2) max1<0, 1>(mx, red);
    else if (norm) max1<0, 1, 2, 3, 4, 5>(mx, red);
    int64_t best_s = 0, best_n = -1;
    for (int64_t n = tid; n < N; n += kThreads) {
      const int64_t s = (n * 13 + p + mx[0]) & 255;
      if (better(s, n, best_s, best_n)) {
        best_s = s;
        best_n = n;
      }
    }
    best1(best_s, best_n, red);
    acc += best_n;
  }
  if (tid == 0) *out = acc;
}
#endif

}  // namespace kt
