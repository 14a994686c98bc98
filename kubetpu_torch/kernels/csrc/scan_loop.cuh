// The greedy scan's loop, shared by greedy_scan.cu (one block, the batch
// itself) and hypothesis_scan.cu (one block per hypothesis: the batch under
// a node mask, and for the gang dry run with an eviction's freed rows).
// greedy_scan.cu's header comment describes the design. The hypothesis
// parts are compiled only into hypothesis_scan.cu (`if constexpr` on
// Hyp::kOn): greedy_scan's instantiations are the scan as it was.
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

constexpr int kThreads = 1024;

// (score, node) with node < 0 meaning "none"; better = higher score, then
// lower node index
__device__ __forceinline__ bool better(int64_t s, int64_t n, int64_t bs, int64_t bn) {
  if (n < 0) return false;
  if (bn < 0) return true;
  return s > bs || (s == bs && n < bn);
}

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
    for (int64_t n = threadIdx.x; n < N; n += blockDim.x) {
      if (!ok[n] || ig[n]) continue;
      const int32_t dom = a.sp_node_domain[sid * N + n];
      if (dom >= 0) atomicOr(bits + (dom >> 5), 1u << (dom & 31));
    }
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
// or DRA branches at all. Dynamic shared memory (kSP only):
// sp_C doubles of slot weights, then the domain bitmap when a.sp_bits is
// null. Every thread of the block calls it; the scratch and outputs are
// the block's own. With `carry` the running state (the rows, touched flags,
// affinity sums and row totals, spread counts and domain sums, live
// nominations) is not started from the batch's: it goes on from what an
// earlier call left in the same buffers (the grid's scan, one call a pod
// row).
template <bool kPA, bool kSP, bool kDRA, class Hyp, class X = NoExchange, class A = ScoreArgs>
__device__ __forceinline__ void scan_loop(A& a, const Hyp& h, X x, const uint8_t* mask0,
                                          const int64_t* base0, uint8_t* touched,
                                          int32_t* assignments, int64_t* req, int64_t* nz,
                                          int32_t* pc, uint8_t* ports, int64_t* pa_sums,
                                          int64_t* row_total, int32_t* sp_counts,
                                          uint8_t* ok_buf, bool carry = false) {
  __shared__ int64_t s_m[kt::kNorm][33];
  __shared__ int64_t s_x[33];
  __shared__ int64_t s_y[33];
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int64_t N = a.N, R = a.R, K = a.K;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
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
  double* weight = reinterpret_cast<double*>(s_dyn);
  uint32_t* bits = a.sp_bits != nullptr
                       ? a.sp_bits
                       : reinterpret_cast<uint32_t*>(s_dyn + a.sp_C * sizeof(double));

  // the running state starts as the batch's node state (owner rows only)
  if (carry) {
    // goes on from the buffers as they are
  } else if constexpr (Hyp::kOn) {
    // less what the hypothesis frees, clamped at 0 (the reference's
    // jnp.maximum(... - freed, 0)); a freed node starts touched
    for (int64_t n = tid; n < N; n += kThreads) {
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
      touched[n] = freed;
    }
  } else {
    for (int64_t n = tid; n < N; n += kThreads) {
      for (int64_t r = 0; r < R; ++r) {
        req[n * R + r] = a.requested[n * R + r];
        nz[n * R + r] = a.nonzero_requested[n * R + r];
      }
      pc[n] = a.pod_count[n];
      for (int64_t k = 0; k < K; ++k) ports[n * K + k] = a.node_ports[n * K + k];
      touched[n] = 0;
    }
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

  const bool na_tt = a.na_raw != nullptr || a.tt_raw != nullptr;
  const bool normalize = na_tt || a.w_interpod || a.dra_raw != nullptr;
  for (int64_t p = 0; p < a.P; ++p) {
    const uint8_t* m0 = mask0 + p * N;
    const int64_t* b0 = base0 + p * N;
    const int64_t row = na_tt ? (int64_t)a.score_sig[p] * N : 0;
    const int64_t drow = kt::dra_row(a, p);
    const bool escape = pa_filter && kt::pa_escape(a, row_total, p);
    const bool sp_score = kSP && a.w_spread && kt::sp_any_soft(a, p);
    // the pair's verdict against the running state
    auto feasible = [&](int64_t n) {
      if constexpr (Hyp::kOn) {
        if (!h.mask[n]) return false;
      }
      bool ok = touched[n] ? kt::pair_feasible(a, p, n, req, pc, ports) : m0[n];
      if (ok && pa_filter) ok = kt::pa_feasible(a, pa_sums, escape, p, n);
      if (kSP && ok && a.sp_filter) ok = kt::sp_feasible(a, a.sp_sums, a.sp_min_match, p, n);
      return ok;
    };
    // the rounded spread raw of a feasible node, -1 when it is not scored
    auto spread_raw = [&](int64_t n) {
      return kt::sp_scored_raw(a, sp_score, sp_counts, a.sp_sums, weight, p, n);
    };
    if constexpr (kSP) {
      // (0) every signature's minMatch against the running sums, then
      // every node's verdict and each soft slot's size
      if (a.sp_filter) {
        for (int64_t sg = 0; sg < S; ++sg) {
          const int64_t mm = kt::sp_min_over_domains(a, a.sp_sums, sg, s_x);
          if (tid == 0) a.sp_min_match[sg] = mm;
        }
        __syncthreads();
      }
      for (int64_t n = tid; n < N; n += kThreads) ok_buf[n] = feasible(n);
      __syncthreads();
      if (sp_score) {
        if constexpr (X::kOn) {
          if (!sp_weights_mesh(a, p, ok_buf, bits, weight, s_x, x)) return;
        } else {
          kt::sp_weights(a, p, ok_buf, bits, weight, s_x);
        }
      }
    }
    // (1) the normalize inputs over the feasible nodes
    int64_t mx[kt::kNorm];
    kt::init_norm(mx);
    if (normalize || sp_score) {
      for (int64_t n = tid; n < N; n += kThreads) {
        if (!(kSP ? ok_buf[n] : feasible(n))) continue;
        const int64_t pa_r = a.w_interpod ? kt::pa_raw(a, pa_sums, p, n) : 0;
        kt::fold_norm(a, row, drow, n, pa_r, spread_raw(n), mx);
      }
      kt::block_max_norm(a, sp_score, mx, s_m);
      if constexpr (X::kOn) {
        int64_t* w = x.e->mine();
        if (tid == 0)
          for (int i = 0; i < kt::kNorm; ++i) w[i] = mx[i];
        if (!xchg_reduce(*x.e, kt::kNorm, 0, x.red, x.flag)) return;
        for (int i = 0; i < kt::kNorm; ++i) mx[i] = x.red[i];
      }
    }
    // (2) best feasible node of this thread, then of the block
    int64_t best_s = 0, best_n = -1;
    for (int64_t n = tid; n < N; n += kThreads) {
      if (!(kSP ? ok_buf[n] : feasible(n))) continue;
      int64_t s = touched[n] ? kt::base_score(a, p, n, req, nz) : b0[n];
      if (normalize || sp_score) {
        const int64_t pa_r = a.w_interpod ? kt::pa_raw(a, pa_sums, p, n) : 0;
        s += kt::norm_terms(a, row, drow, n, true, pa_r, spread_raw(n), mx);
      }
      if (better(s, n, best_s, best_n)) {
        best_s = s;
        best_n = n;
      }
    }
    warp_best(best_s, best_n);
    if (lane == 0) {
      s_x[warp] = best_s;
      s_y[warp] = best_n;
    }
    __syncthreads();
    if (warp == 0) {
      int64_t s = s_x[lane], n = s_y[lane];  // kThreads / 32 == 32 warps
      warp_best(s, n);
      if (lane == 0) {
        s_y[32] = n;
        if constexpr (X::kOn) {
          x.e->mine()[0] = s;
          x.e->mine()[1] = n >= 0 ? n + x.offset : -1;
        } else {
          assignments[p] = (int32_t)n;  // -1 when no node is feasible
        }
      }
    }
    __syncthreads();
    // (3) the owner of the chosen node assumes the pod onto it. Under a
    // mesh, each shard offers its best with its node's affinity domains and
    // spread domains (-1: not eligible), and the pick's winner owns it.
    int64_t chosen = s_y[32];  // global index, -1 for none
    int64_t local = chosen;    // the shard's row, -1 when another shard's
    const volatile int64_t* pub = nullptr;
    if constexpr (X::kOn) {
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
      for (int64_t r = 0; r < R; ++r) {
        req[local * R + r] += a.requests[p * R + r];
        nz[local * R + r] += a.nonzero_requests[p * R + r];
      }
      pc[local] += 1;
      for (int64_t k = 0; k < K; ++k)
        ports[local * K + k] = ports[local * K + k] | a.pod_ports[p * K + k];
      touched[local] = 1;
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
    if (nom && chosen >= 0) {
      // assume deletes the nomination (schedule_one.go:307)
      for (int64_t g = tid; g < a.G; g += kThreads) {
        if (a.nom_pod_idx[g] != p || !a.nom_active[g]) continue;
        a.nom_active[g] = 0;
        if (a.nom_node[g] >= 0) touched[a.nom_node[g]] = 1;
      }
    }
    if (pa || kSP || nom) __syncthreads();
  }
}

}  // namespace kt
