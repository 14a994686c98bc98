// The cross-shard exchange of a node mesh's kernels: the G blocks that run
// one node shard each (G blocks of one cooperative launch on one card, or
// one block a card) swap small partials at every point where a step
// reduces over nodes.
//
// Replaces the collectives XLA inserts into kubetpu's sharded programs
// (kubetpu/parallel/mesh.py:234 sharded_greedy, :327
// measure_collective_wall): the cross-shard maximum of the normalize
// inputs, the spread domain bitmaps, and the (score, -index) pick.
//
// Design: each shard owns one slot in its own device memory: a sequence
// word, then two payload buffers used in turn. To exchange, the block
// writes its partial into its buffer (k & 1), then thread 0 fences, stores
// the sequence (epoch << 32 | k) with system-scope release, and waits,
// with system-scope acquire loads, until every peer's sequence reaches the
// same value; the peers' payloads are then read with volatile loads (peer
// pointers over NVLink for shards on other cards, plain global memory for
// logical shards on one card). Two buffers suffice: a peer can write
// buffer (k + 1) & 1 only after every shard published k, which each does
// only after it finished reading k - 1. The epoch (a launch counter kept
// by the host) makes the sequence words of an earlier launch stale, so the
// slots are never cleared. Every wait is bounded by a clock64 budget: past
// it the block sets the error word and leaves, and the host raises.
//
// Bound: latency, a few hundred nanoseconds a round trip on one card and a
// few microseconds over NVLink; the payloads are tens of words.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Mirror of Exchange in kubetpu_torch/kernels/__init__.py (8-byte fields)
struct Exchange {
  int64_t* slot[8];   // each shard's slot: sequence word, then two payloads
  int64_t G;          // shards (slots used)
  int64_t words;      // payload capacity in int64 words
  int64_t epoch;      // this launch's epoch
  int64_t budget;     // clock64 cycles one wait may take
  int32_t* error;     // set to 1 on a timeout (this card's word)
};

namespace kt {

constexpr int64_t kSlotHead = 16;  // words before the payloads (one 128-byte line)

__device__ __forceinline__ void st_release_sys(int64_t* p, int64_t v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"((unsigned long long)v)
               : "memory");
}

__device__ __forceinline__ int64_t ld_acquire_sys(const int64_t* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return (int64_t)v;
}

// one block's view of the exchange: its shard g and its count of
// exchanges so far
struct Xchg {
  const Exchange* x;
  int64_t g;
  int64_t k;

  // the buffer this block fills for its next exchange
  __device__ __forceinline__ int64_t* mine() const {
    return x->slot[g] + kSlotHead + (k & 1) * x->words;
  }
};

// Publish this block's payload (written into e.mine() before the call) and
// wait for every peer's. Every thread of the block calls it; returns false
// on all threads when a wait ran past the budget. `flag` is shared memory.
__device__ __forceinline__ bool xchg_sync(Xchg& e, int* flag) {
  e.k += 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    const Exchange& x = *e.x;
    const int64_t want = (x.epoch << 32) | e.k;
    __threadfence_system();
    st_release_sys(x.slot[e.g], want);
    int ok = 1;
    const long long t0 = clock64();
    for (int64_t h = 0; h < x.G && ok; ++h) {
      if (h == e.g) continue;
      while (ld_acquire_sys(x.slot[h]) < want) {
        if (clock64() - t0 > x.budget) {
          ok = 0;
          atomicExch(x.error, 1);
          break;
        }
      }
    }
    *flag = ok;
  }
  __syncthreads();
  // exchange k's payloads sit in buffer (k - 1) & 1 (xchg_payload)
  return *flag != 0;
}

// Exchange n words of each shard (the block wrote them into e.mine()) and
// reduce them: out[i] = op over the shards of word i, for i < n, with out
// in shared or global memory of the block. op: 0 max, 1 sum (wrapping),
// 2 bitwise or.
__device__ __forceinline__ bool xchg_reduce(Xchg& e, int64_t n, int op, int64_t* out,
                                            int* flag) {
  if (!xchg_sync(e, flag)) return false;
  const int64_t G = e.x->G, base = ((e.k - 1) & 1) * e.x->words + kSlotHead;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    int64_t v = 0;
    for (int64_t h = 0; h < G; ++h) {
      const int64_t w = ((const volatile int64_t*)(e.x->slot[h] + base))[i];
      if (h == 0) v = w;
      else if (op == 0) v = v > w ? v : w;
      else if (op == 1) v = (int64_t)((unsigned long long)v + (unsigned long long)w);
      else v = v | w;
    }
    out[i] = v;
  }
  __syncthreads();
  return true;
}

// The payload written by this block before the last xchg_sync (to fill
// the next exchange's buffer, call e.mine() after it).
__device__ __forceinline__ const volatile int64_t* xchg_payload(const Xchg& e, int64_t h) {
  return e.x->slot[h] + kSlotHead + ((e.k - 1) & 1) * e.x->words;
}

// Exchange each shard's pick (score, global node, n_more more words, in
// e.mine()) and keep the best by (score, -node), node < 0 meaning none: a
// later shard wins only with a strictly higher score or, at an equal
// score, a lower node, so ties keep the first maximum across shards.
// Returns the winning shard in *win (-1 when no shard has a node) through
// shared memory; every thread gets it.
__device__ __forceinline__ bool xchg_pick(Xchg& e, int* win, int* flag) {
  if (!xchg_sync(e, flag)) return false;
  if (threadIdx.x == 0) {
    int best = -1;
    int64_t bs = 0, bn = -1;
    for (int64_t h = 0; h < e.x->G; ++h) {
      const volatile int64_t* p = xchg_payload(e, h);
      const int64_t s = p[0], n = p[1];
      if (n < 0) continue;
      if (bn < 0 || s > bs || (s == bs && n < bn)) {
        bs = s;
        bn = n;
        best = (int)h;
      }
    }
    *win = best;
  }
  __syncthreads();
  return true;
}

}  // namespace kt
