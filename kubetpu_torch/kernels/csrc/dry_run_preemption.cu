// dry_run_preemption: the preemption victim search over every node at once,
// then the choice of one node (kernel B9), in one launch.
//
// Replaces kubetpu/ops/preemption.py:186 dry_run_preemption (jit): :63
// select_victims_node vmapped over the node axis (eligibility by priority,
// fit with every eligible victim removed, a PDB-violation scan in
// importance order, then a reprieve scan), gated by the caller's potential
// mask, and :156 pick_node, the lexicographic refinement of
// pickOneNodeForPreemption. The plain PyTorch version is
// kubetpu_torch/ops/preemption.py dry_run_preemption_plain, and
// dry_run_preemption_ranked_plain mirrors this decomposition.
//
// Bound: memory. Each input byte is read once: the (N, K) victim slots
// with their (N, K, R) requests, (N, K, Kp) ports and (N, K, D) PDB flags,
// the node rows, and the (N, K) victims written back; the arithmetic per
// slot is a handful of integer compares. At the main path's shapes
// (N = 5120, K = 8) that is about 2 MB, under a microsecond at the card's
// bandwidth, so the kernel is latency bound in practice.
//
// Design: one warp a node, a block as many nodes (warps, at most 8) as
// 47 KiB of shared memory holds (a node alone opts in to more). The warp
// stages its node into shared memory with asynchronous copies (cp.async),
// all in flight at once and coalesced: a copy of the preemptor's rows, the
// slots' priorities, valid flags and starts, and the node's contiguous
// v_req, v_ports and v_pdb rows (where one node's rows do not fit a block,
// `stage` is 0 and the same loops read those through the same pointers
// from global memory). Then, all on shared memory:
//  - the importance order (priority desc, start asc, ineligible last, the
//    lower slot first on equal keys: lax.sort's stable order) as ranks by
//    counting, the lanes sharing the K x K compares: a slot's rank is the
//    number of slots whose (key, start) is lower, or equal with a lower
//    slot, each compare one 128-bit subtraction of the sign-flipped pair
//    with the slot order as its borrow-in; order[rank] = slot;
//  - the PDB flags by prefix counts: walking the ranks 32 at a time, each
//    PDB d's count of matched eligible slots up to a slot's rank is a
//    ballot's prefix popcount plus the count so far, and the slot violates
//    when some d it is matched to has budget_d - count < 0;
//  - the reprieve order (violating slots first, then the others, each
//    group in importance order) as ranks by counting too, ballot prefix
//    counts over the importance ranks, so that the walk visits the
//    eligible slots only;
//  - the reprieve, sequential since each decision changes the state for the
//    next: a step's R resource and Kp port compares are spread over the
//    lanes, a warp vote decides, and each lane keeps its own resources'
//    free room and ports' counts (its first entry in a register);
//  - max, sum, count and earliest start by warp reductions.
// The pick is fused: each block leaves its best candidate under pick_node's
// order (-n_pdb, -max_prio, -sum_prio, -n_victims, earliest, -index: its
// maximum is pick_node's refinement followed by its first candidate), the
// last block to finish (an atomic ticket, zeroed by the launch's memset)
// reduces them and writes the node, -1 when no node is ok, and its keys.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// a candidate node for pick_node; idx < 0 = none (mirror of the 48 bytes a
// block's best takes in kubetpu_torch/kernels/__init__.py)
struct Cand {
  int64_t pdb, maxp, sump, nv, early, idx;
};

}  // namespace

// Mirror of DryRunArgs in kubetpu_torch/kernels/__init__.py: every field is
// 8 bytes wide.
struct DryRunArgs {
  const int64_t* pod_req;      // (R,) the preemptor's requests
  const uint8_t* wants_conf;   // (Kp,) triples the preemptor conflicts with
  const uint8_t* potential;    // (N,) nodes whose failure is resolvable
  const int64_t* alloc;        // (N, R)
  const int64_t* requested;    // (N, R)
  const int32_t* pod_count;    // (N,)
  const int32_t* allowed;      // (N,)
  const int32_t* port_counts;  // (N, Kp)
  const uint8_t* v_valid;      // (N, K)
  const int64_t* v_prio;       // (N, K)
  const int64_t* v_start;      // (N, K)
  const int64_t* v_req;        // (N, K, R)
  const int8_t* v_ports;       // (N, K, Kp)
  const uint8_t* v_pdb;        // (N, K, D)
  const int64_t* pdb_allowed;  // (D,)
  int32_t* node_idx;           // () the chosen node, -1 = none
  uint8_t* victims;            // (N, K)
  uint8_t* ok;                 // (N,)
  int64_t* n_pdb;              // (N,)
  Cand* best;                  // () the chosen node's keys (K3 reads them)
  Cand* parts;                 // (blocks,) each block's best
  unsigned int* ticket;        // () blocks done
  int64_t pod_prio, N, K, R, Kp, D;
  int64_t warps;               // nodes a block, one a warp
  int64_t stage;               // the slots' rows staged in shared memory
  int64_t smem;                // the block's dynamic shared memory
};

namespace {

constexpr int kMaxWarps = 8;
// dynamic shared memory a block takes without opting in: 48 KiB less the
// kernel's static arrays (a warp's candidate each, the last-block flag)
constexpr int64_t kDefaultSmem = 48 * 1024 - 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kI64Min = -(1LL << 62);  // the reference's I64_MIN
constexpr int64_t kI64Max = 1LL << 62;     // I64_MAX
constexpr int64_t kPrioOffset = 1LL << 31; // PRIO_OFFSET
// flag bits of a slot
constexpr uint8_t kEligible = 1, kViolating = 2, kVictim = 4;

__host__ __device__ constexpr int64_t r16(int64_t x) { return (x + 15) / 16 * 16; }

// a node's (a warp's) shared memory: a copy of the preemptor's requests
// (R int64), the PDB budgets (D int64) and the preemptor's triples (Kp
// bytes); the node's running state (R + Kp int64), the slots' keys and
// starts (K int64 each), importance order and reprieve order (K int32
// each) and flags (K bytes); staged, the slots' requests (K R int64),
// ports (K Kp) and PDB flags (K D). Each region from a 16-byte boundary.
__host__ __device__ int64_t node_bytes(int64_t K, int64_t R, int64_t Kp, int64_t D, bool stage) {
  int64_t b = r16(8 * R) + r16(8 * D) + r16(Kp) + r16(8 * (R + Kp)) + 2 * r16(8 * K) +
              2 * r16(4 * K) + r16(K);
  if (stage) b += r16(8 * K * R) + r16(K * Kp) + r16(K * D);
  return b;
}

__device__ __forceinline__ int64_t warp_sum(int64_t x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ int64_t warp_max(int64_t x) {
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t o = __shfl_xor_sync(kFull, x, off);
    x = o > x ? o : x;
  }
  return x;
}

__device__ __forceinline__ int64_t warp_min(int64_t x) {
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t o = __shfl_xor_sync(kFull, x, off);
    x = o < x ? o : x;
  }
  return x;
}

// x better than y: fewer PDB violations, lower highest priority, lower sum,
// fewer victims, later earliest start, lower index
__device__ __forceinline__ bool better(const Cand& x, const Cand& y) {
  if (x.idx < 0) return false;
  if (y.idx < 0) return true;
  if (x.pdb != y.pdb) return x.pdb < y.pdb;
  if (x.maxp != y.maxp) return x.maxp < y.maxp;
  if (x.sump != y.sump) return x.sump < y.sump;
  if (x.nv != y.nv) return x.nv < y.nv;
  if (x.early != y.early) return x.early > y.early;
  return x.idx < y.idx;
}

__device__ __forceinline__ Cand shfl_down(const Cand& c, int off) {
  return Cand{__shfl_down_sync(kFull, c.pdb, off), __shfl_down_sync(kFull, c.maxp, off),
              __shfl_down_sync(kFull, c.sump, off), __shfl_down_sync(kFull, c.nv, off),
              __shfl_down_sync(kFull, c.early, off), __shfl_down_sync(kFull, c.idx, off)};
}

// lane 0 receives the warp's best
__device__ __forceinline__ Cand warp_best(Cand c) {
  for (int off = 16; off > 0; off >>= 1) {
    const Cand o = shfl_down(c, off);
    if (better(o, c)) c = o;
  }
  return c;
}

__device__ __forceinline__ Cand no_cand() { return Cand{0, 0, 0, 0, 0, -1}; }

// Staging: asynchronous copies from global into shared memory
// (cp.async), so that a warp has all of its node's loads in flight at
// once; cp_wait() waits for the lane's own copies, a __syncwarp() after it
// shows them to the other lanes.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// a warp's copy of n int64
__device__ __forceinline__ void stage_words(int64_t* dst, const int64_t* src, int64_t n,
                                            int lane) {
  for (int64_t i = lane; i < n; i += 32) cp_async(dst + i, src + i, 8);
}

// a warp's copy of n bytes, 4 at a time where both ends allow (else a byte
// at a time through registers)
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src, int64_t n,
                                            int lane) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 3) == 0 &&
      n % 4 == 0) {
    for (int64_t i = lane; i < n / 4; i += 32) cp_async(dst + 4 * i, src + 4 * i, 4);
  } else {
    for (int64_t i = lane; i < n; i += 32) dst[i] = __ldg(src + i);
  }
}

__device__ __forceinline__ int64_t ldg64(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

// x with its sign bit flipped: signed order becomes unsigned order
__device__ __forceinline__ int64_t flip(int64_t x) {
  return (int64_t)((uint64_t)x ^ (1ULL << 63));
}

// (ah, al) before (bh, bl), the flipped pairs compared lexicographically,
// or equal to it when `or_equal`: the borrow out of the 128-bit
// difference a - b - or_equal
__device__ __forceinline__ bool pair_before(int64_t ah, int64_t al, int64_t bh, int64_t bl,
                                            unsigned or_equal) {
  unsigned borrow;
  asm("{\n\t.reg .u32 z, t32;\n\t.reg .u64 t;\n\tmov.u32 z, 0;\n\t"
      "sub.cc.u32 t32, z, %5;\n\tsubc.cc.u64 t, %1, %3;\n\tsubc.cc.u64 t, %2, %4;\n\t"
      "subc.u32 %0, z, z;\n\t}"
      : "=r"(borrow)
      : "l"(al), "l"(ah), "l"(bl), "l"(bh), "r"(or_equal));
  return borrow != 0;
}

// One node's search: its rows on its warp's shared memory (or, unstaged,
// the global rows through the same pointers). The running state is R + Kp
// entries, t < R the free room of resource t, t >= R the count of triple
// t - R (int32, wrapping as the reference's); lane l owns entries l,
// l + 32, ..., its first in a register and the others in `state`.
struct NodeView {
  const int64_t* pod_req;  // (R,) block copy
  const uint8_t* wants;    // (Kp,) block copy
  int64_t* state;          // (R + Kp,)
  int64_t* key;            // (K,) importance key, flipped
  int64_t* start;          // (K,) start, flipped
  int32_t* order;          // (K,) slot at each importance rank
  int32_t* rep;            // (K,) slot at each reprieve step
  uint8_t* flags;          // (K,)
  const int64_t* req;      // (K, R)
  const int8_t* ports;     // (K, Kp)
  const uint8_t* pdb;      // (K, D)
  int R, Kp, T;            // T = R + Kp
};

// entry t's verdict for the preemptor with slot k (k < 0: none) added back
__device__ __forceinline__ bool entry_ok(const NodeView& v, int t, int64_t val, int k) {
  if (t < v.R) {
    const int64_t q = v.pod_req[t];
    return q == 0 || q <= val - (k >= 0 ? v.req[k * v.R + t] : 0);
  }
  if (!v.wants[t - v.R]) return true;
  return (int32_t)((uint32_t)val + (uint32_t)(k >= 0 ? (int32_t)v.ports[k * v.Kp + t - v.R] : 0))
         <= 0;
}

// entry t with slot k taken back onto the node
__device__ __forceinline__ int64_t entry_taken(const NodeView& v, int t, int64_t val, int k) {
  if (t < v.R) return val - v.req[k * v.R + t];
  return (int32_t)((uint32_t)val + (uint32_t)(int32_t)v.ports[k * v.Kp + t - v.R]);
}

// does the preemptor fit, with slot k (k < 0: none) added back and `cnt`
// pods on the node? Each lane takes its own entries, a vote decides
__device__ __forceinline__ bool fits(const NodeView& v, int64_t own, int k, int64_t cnt,
                                     int64_t allowed, int lane) {
  bool ok = lane >= v.T || entry_ok(v, lane, own, k);
  for (int t = lane + 32; t < v.T; t += 32) ok = ok && entry_ok(v, t, v.state[t], k);
  return __all_sync(kFull, ok) && cnt + 1 <= allowed;
}

__global__ void __launch_bounds__(kMaxWarps * 32, 4)
    dry_run_nodes(DryRunArgs a) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ Cand s_cand[kMaxWarps];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = (int)a.K, R = (int)a.R, Kp = (int)a.Kp, D = (int)a.D;
  const bool stage = a.stage != 0;

  const int64_t n = (int64_t)blockIdx.x * a.warps + warp;
  Cand mine = no_cand();
  if (n < a.N) {
    // the node's scalars and the lane's first state entry, loaded first
    const int64_t allowed = __ldg(a.allowed + n);
    const int64_t pods = __ldg(a.pod_count + n);
    const bool potential = __ldg(a.potential + n);
    unsigned char* seg = s_dyn + warp * node_bytes(K, R, Kp, D, stage);
    // the warp's copy of the preemptor's requests and triples, and of the
    // PDB budgets
    auto* pod_req = reinterpret_cast<int64_t*>(seg);
    seg += r16(8 * R);
    auto* budget = reinterpret_cast<int64_t*>(seg);
    seg += r16(8 * D);
    auto* wants = seg;
    seg += r16(Kp);
    NodeView v;
    v.pod_req = pod_req;
    v.wants = wants;
    v.R = R;
    v.Kp = Kp;
    v.T = R + Kp;
    v.state = reinterpret_cast<int64_t*>(seg);
    seg += r16(8 * (R + Kp));
    v.key = reinterpret_cast<int64_t*>(seg);
    seg += r16(8 * K);
    v.start = reinterpret_cast<int64_t*>(seg);
    seg += r16(8 * K);
    v.order = reinterpret_cast<int32_t*>(seg);
    seg += r16(4 * K);
    v.rep = reinterpret_cast<int32_t*>(seg);
    seg += r16(4 * K);
    v.flags = seg;
    seg += r16(K);
    // alloc - requested, or the triple's count, uint64 / uint32 wrapping
    auto base_entry = [&](int t) -> int64_t {
      if (t < R)
        return (int64_t)((uint64_t)ldg64(a.alloc + n * R + t) -
                         (uint64_t)ldg64(a.requested + n * R + t));
      return __ldg(a.port_counts + n * Kp + t - R);
    };
    // every copy in flight together: the preemptor's rows, the slots'
    // priorities (into key), valid flags (into flags) and starts, and,
    // staged, their requests, ports and PDB flags
    stage_words(pod_req, a.pod_req, R, lane);
    stage_words(budget, a.pdb_allowed, D, lane);
    stage_bytes(wants, a.wants_conf, Kp, lane);
    stage_words(v.key, a.v_prio + n * K, K, lane);
    stage_bytes(v.flags, a.v_valid + n * K, K, lane);
    stage_words(v.start, a.v_start + n * K, K, lane);
    if (stage) {
      auto* rq = reinterpret_cast<int64_t*>(seg);
      seg += r16(8 * (int64_t)K * R);
      auto* pt = reinterpret_cast<int8_t*>(seg);
      seg += r16((int64_t)K * Kp);
      auto* pd = seg;
      stage_words(rq, a.v_req + n * K * R, (int64_t)K * R, lane);
      stage_bytes(reinterpret_cast<uint8_t*>(pt),
                  reinterpret_cast<const uint8_t*>(a.v_ports + n * K * Kp), (int64_t)K * Kp,
                  lane);
      stage_bytes(pd, a.v_pdb + n * K * D, (int64_t)K * D, lane);
      v.req = rq;
      v.ports = pt;
      v.pdb = pd;
    } else {
      v.req = a.v_req + n * K * R;
      v.ports = a.v_ports + n * K * Kp;
      v.pdb = a.v_pdb + n * K * D;
    }
    int64_t own = lane < v.T ? base_entry(lane) : 0;
    for (int t = lane + 32; t < v.T; t += 32) v.state[t] = base_entry(t);
    cp_wait();
    __syncwarp();
    // eligibility and the importance keys (both keys flipped, to compare
    // as unsigned); the eligible count
    int n_elig = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      bool e = false;
      if (k < K) {
        const int64_t pr = v.key[k];
        e = v.flags[k] && pr < a.pod_prio;
        v.key[k] = flip(e ? -pr : kI64Max);
        v.start[k] = flip(v.start[k]);
        v.flags[k] = e ? kEligible : 0;
      }
      n_elig += __popc(__ballot_sync(kFull, e));
    }
    __syncwarp();
    // the state with every eligible victim removed: each entry's sum over
    // the eligible slots, added to the free room or taken from the count.
    // With T <= 16 entries the slots split over G = 32 / T groups of
    // lanes, lane t + T g summing entry t over slots g, g + G, ..., and the
    // owner adding the groups' sums; else each owner sums its entries.
    auto slot_sum = [&](int t, int k0, int stride) -> int64_t {
      int64_t sum = 0;
#pragma unroll 4
      for (int k = k0; k < K; k += stride) {
        const int64_t y = t < R ? v.req[k * R + t] : v.ports[k * Kp + t - R];
        sum += (v.flags[k] & kEligible) ? y : 0;
      }
      return sum;
    };
    auto removed = [&](int t, int64_t x, int64_t sum) -> int64_t {
      return t < R ? (int64_t)((uint64_t)x + (uint64_t)sum)
                   : (int64_t)(int32_t)((uint32_t)x - (uint32_t)sum);
    };
    if (v.T > 0 && v.T <= 16) {
      const int G = 32 / v.T, t = lane % v.T, g = lane / v.T;
      int64_t sum = g < G ? slot_sum(t, g, G) : 0;
      for (int h = 1; h < G; ++h) {
        const int64_t o = __shfl_sync(kFull, sum, (lane + h * v.T) & 31);
        if (lane < v.T) sum += o;
      }
      if (lane < v.T) own = removed(lane, own, sum);
    } else {
      if (lane < v.T) own = removed(lane, own, slot_sum(lane, 0, 1));
      for (int t = lane + 32; t < v.T; t += 32)
        v.state[t] = removed(t, v.state[t], slot_sum(t, 0, 1));
    }
    int64_t cnt = pods - n_elig;
    const bool fits_base = fits(v, own, -1, cnt, allowed, lane);

    // importance ranks by counting: the slots before k are those with a
    // lower (key, start), or an equal one and a lower slot
    for (int k = lane; k < K; k += 32) {
      const int64_t kk = v.key[k], sk = v.start[k];
      int rank = 0;
#pragma unroll 4
      for (int j = 0; j < K; ++j) rank += pair_before(v.key[j], v.start[j], kk, sk, j < k);
      v.order[rank] = k;
    }
    __syncwarp();

    // PDB flags by prefix counts over the importance ranks
    const unsigned le = 0xffffffffu >> (31 - lane), lt = (1u << lane) - 1;
    for (int d = 0; d < D; ++d) {
      int64_t count = 0;
      for (int r0 = 0; r0 < K; r0 += 32) {
        const int rk = r0 + lane;
        const int k = rk < K ? v.order[rk] : -1;
        const bool m = k >= 0 && (v.flags[k] & kEligible) && v.pdb[(int64_t)k * D + d];
        const unsigned ball = __ballot_sync(kFull, m);
        if (m && budget[d] - (count + __popc(ball & le)) < 0) v.flags[k] |= kViolating;
        count += __popc(ball);
      }
      __syncwarp();
    }

    // the reprieve order, by counting: the violating slots in rank order,
    // then the other eligible ones; a slot's step is the number of its
    // group's slots before it, after the violating ones for the others
    int steps = 0, n_violating = 0;
    for (int g = 0; g < 2; ++g) {
      const uint8_t want = g == 0 ? (kEligible | kViolating) : kEligible;
      for (int r0 = 0; r0 < K; r0 += 32) {
        const int rk = r0 + lane;
        const int k = rk < K ? v.order[rk] : -1;
        const bool m = k >= 0 && (v.flags[k] & (kEligible | kViolating)) == want;
        const unsigned ball = __ballot_sync(kFull, m);
        if (m) v.rep[steps + __popc(ball & lt)] = k;
        steps += __popc(ball);
      }
      if (g == 0) n_violating = steps;
    }
    __syncwarp();

    // the reprieve: a victim stays on the node iff the preemptor still
    // fits. A lane holds what its first entry needs of the preemptor (an
    // unwanted triple's count is never read, so it is not kept); the next
    // step's slot is read ahead
    const bool own_r = lane < R, own_p = !own_r && lane < v.T && v.wants[lane - R];
    const int64_t q = own_r ? v.pod_req[lane] : 0;
    int64_t n_viol = 0, n_victims = 0;
    int k_next = steps > 0 ? v.rep[0] : 0;
    for (int i = 0; i < steps; ++i) {
      const int k = k_next;
      if (i + 1 < steps) k_next = v.rep[i + 1];
      const int64_t d = own_r ? v.req[k * R + lane] : own_p ? v.ports[k * Kp + lane - R] : 0;
      bool ok = own_r ? (q == 0 || q <= own - d)
                      : !own_p || (int32_t)((uint32_t)own + (uint32_t)d) <= 0;
      for (int t = lane + 32; t < v.T; t += 32) ok = ok && entry_ok(v, t, v.state[t], k);
      if (__all_sync(kFull, ok) && cnt + 2 <= allowed) {
        own = own_r ? own - d : own_p ? (int32_t)((uint32_t)own + (uint32_t)d) : own;
        for (int t = lane + 32; t < v.T; t += 32) v.state[t] = entry_taken(v, t, v.state[t], k);
        cnt += 1;
      } else {
        if (lane == 0) v.flags[k] |= kVictim;
        ++n_victims;
        if (i < n_violating) ++n_viol;
      }
    }
    __syncwarp();

    // the victims row, and pick_node's keys
    int64_t max_prio = kI64Min, sum_prio = 0;
    for (int k = lane; k < K; k += 32) {
      const bool vic = v.flags[k] & kVictim;
      a.victims[n * K + k] = vic;
      if (vic) {
        const int64_t pr = -flip(v.key[k]);
        max_prio = pr > max_prio ? pr : max_prio;
        sum_prio += pr + kPrioOffset;
      }
    }
    max_prio = warp_max(max_prio);
    sum_prio = warp_sum(sum_prio);
    int64_t earliest = kI64Max;
    for (int k = lane; k < K; k += 32) {
      if ((v.flags[k] & kVictim) && -flip(v.key[k]) == max_prio) {
        const int64_t s = flip(v.start[k]);
        earliest = s < earliest ? s : earliest;
      }
    }
    earliest = warp_min(earliest);
    const bool ok = n_elig > 0 && fits_base && n_victims > 0 && potential;
    if (lane == 0) {
      a.ok[n] = ok;
      a.n_pdb[n] = n_viol;
    }
    if (ok) mine = Cand{n_viol, max_prio, sum_prio, n_victims, earliest, n};
  }

  // the block's best, then the last block's merge of every block's
  if (lane == 0) s_cand[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    Cand b = no_cand();
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
      if (better(s_cand[w], b)) b = s_cand[w];
    a.parts[blockIdx.x] = b;
    __threadfence();
    s_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  Cand b = no_cand();
  for (int64_t i = threadIdx.x; i < gridDim.x; i += blockDim.x) {
    const Cand* p = a.parts + i;
    const Cand c{__ldcg(reinterpret_cast<const long long*>(&p->pdb)),
                 __ldcg(reinterpret_cast<const long long*>(&p->maxp)),
                 __ldcg(reinterpret_cast<const long long*>(&p->sump)),
                 __ldcg(reinterpret_cast<const long long*>(&p->nv)),
                 __ldcg(reinterpret_cast<const long long*>(&p->early)),
                 __ldcg(reinterpret_cast<const long long*>(&p->idx))};
    if (better(c, b)) b = c;
  }
  b = warp_best(b);
  __syncthreads();
  if (lane == 0) s_cand[warp] = b;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      if (better(s_cand[w], b)) b = s_cand[w];
    *a.best = b;
    *a.node_idx = (int32_t)b.idx;
  }
}

// One shard's dry run, for the cross-shard pick (mirror of PickShard in
// kubetpu_torch/kernels/__init__.py; 8-byte fields)
struct PickShard {
  const Cand* best;  // the shard's best node (local index, -1 = none) and keys
  int64_t offset;    // global index of the shard's first node
};

// Kernel K3 (the dry run under a node mesh): one warp, lane h reads shard
// h's best node and its five keys, which its B9 launch left (through peer
// pointers for other cards), and the warp keeps the best by pick_node's
// order with -global index, so the first node of the global refinement
// wins.
struct PickSet {
  PickShard sh[8];
};

__global__ void dry_run_shard_pick(const __grid_constant__ PickSet set, int64_t G, int32_t* out) {
  const int lane = threadIdx.x;
  Cand c = no_cand();
  if (lane < G) {
    const volatile int64_t* w = reinterpret_cast<const volatile int64_t*>(set.sh[lane].best);
    if (w[5] >= 0) c = Cand{w[0], w[1], w[2], w[3], w[4], set.sh[lane].offset + w[5]};
  }
  c = warp_best(c);
  if (lane == 0) *out = (int32_t)c.idx;
}

}  // namespace

// Launches kernel K3 on `stream` over the G (<= 8) entries of `shards`
// (host memory); every shard's dry run must be complete (the caller orders
// the streams). *out receives the global node, -1 for none. Returns the
// cudaError_t of the launch.
extern "C" int kt_dry_run_shard_pick(const void* shards, int64_t G, void* out, void* stream) {
  if (G <= 0 || G > 8) return (int)cudaErrorInvalidValue;
  PickSet set{};
  const PickShard* in = static_cast<const PickShard*>(shards);
  for (int64_t g = 0; g < G; ++g) set.sh[g] = in[g];
  dry_run_shard_pick<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      set, G, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_dry_run_preemption_pick_size() { return (int64_t)sizeof(PickShard); }

// The dynamic shared memory of a block of `warps` nodes (stage: the slots'
// rows staged); kubetpu_torch.kernels.dry_run_layout mirrors it.
extern "C" int64_t kt_dry_run_preemption_smem(int64_t K, int64_t R, int64_t Kp, int64_t D,
                                              int64_t stage, int64_t warps) {
  return warps * node_bytes(K, R, Kp, D, stage != 0);
}

// Launches the search and the pick on `stream`: the ticket's memset, then
// one launch of ceil(N / warps) blocks (with N = 0, node_idx and best are
// set to -1 and nothing launches). Every output is written whole. Returns
// the cudaError_t of the memset and launch (0 = both were accepted).
extern "C" int kt_dry_run_preemption(const DryRunArgs* args, void* stream) {
  const DryRunArgs a = *args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.warps < 1 || a.warps > kMaxWarps ||
      a.smem != kt_dry_run_preemption_smem(a.K, a.R, a.Kp, a.D, a.stage, a.warps))
    return (int)cudaErrorInvalidValue;
  if (a.N == 0) {
    cudaError_t err = cudaMemsetAsync(a.node_idx, 0xff, sizeof(int32_t), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(a.best, 0xff, sizeof(Cand), s);
    return (int)err;
  }
  const int64_t blocks = (a.N + a.warps - 1) / a.warps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (a.smem > kDefaultSmem)
    err = cudaFuncSetAttribute(dry_run_nodes, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)a.smem);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.ticket, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  dry_run_nodes<<<(unsigned)blocks, (unsigned)(32 * a.warps), (size_t)a.smem, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_dry_run_preemption_args_size() { return (int64_t)sizeof(DryRunArgs); }

extern "C" const char* kt_dry_run_preemption_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
