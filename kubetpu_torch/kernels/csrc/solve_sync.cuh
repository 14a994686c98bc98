// The grid-wide barriers of a solve held in one cooperative launch a card
// (packing_round.cu's packing solve, batched_round.cu's batched solve):
// every block of the card's launch arrives on a counter in device memory
// and waits for all; across the cards of a mesh, block 0 then swaps
// sequence words with the peer cards through exchange.cuh's slots. Every
// wait is bounded by the exchange's clock64 budget: past it the error
// word and the card's abort word are set and the solve leaves.
//
// `Set` is the solve's launch struct; the barrier reads its fields `bar`
// (this card's arrival counter, zeroed by the entry before the launch),
// `abort` (set when a peer card timed out, zeroed likewise), `x` (the
// cards' Exchange, x.G cards) and `card` (this card's slot).
#pragma once

#include "exchange.cuh"

namespace kt {

// another tile's partial, written before the last barrier (on this card or
// a peer's): never from a cached line
template <typename T>
__device__ __forceinline__ T ldv(const T* p) {
  return *reinterpret_cast<const volatile T*>(p);
}

__device__ __forceinline__ uint64_t ld_acquire_gpu(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Every block of this card's launch arrives, then waits for all (bounded
// by the exchange's budget: past it the error word is set). Thread 0
// fences the block's writes before it arrives (system scope when the mesh
// spans cards, so that peers may read them). Returns false on every thread
// when a wait timed out or a peer card did. `k` counts the block's
// barriers; `flag` is shared memory.
template <typename Set>
__device__ bool card_sync(const Set& S, int64_t& k, int* flag) {
  __syncthreads();
  k += 1;
  if (threadIdx.x == 0) {
    if (S.x.G > 1)
      __threadfence_system();
    else
      __threadfence();
    atomicAdd(S.bar, 1ULL);
    const unsigned long long want = (unsigned long long)k * gridDim.x;
    int ok = 1;
    const long long t0 = clock64();
    while (ld_acquire_gpu(S.bar) < want) {
      if (clock64() - t0 > S.x.budget) {
        ok = 0;
        atomicExch(S.x.error, 1);
        atomicExch(S.abort, 1);
        break;
      }
    }
    __threadfence();
    *flag = ok && !ldv(S.abort);
  }
  __syncthreads();
  return *flag != 0;
}

// card_sync, and across the cards of the mesh: block 0 publishes the
// barrier's sequence and waits for every peer card's, then the card syncs
// again, so that every block may read what any tile wrote before it.
// `xk` counts the block's cross-card barriers.
template <typename Set>
__device__ bool mesh_sync(const Set& S, int64_t& k, int64_t& xk, int* flag) {
  if (!card_sync(S, k, flag)) return false;
  if (S.x.G <= 1) return true;
  xk += 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int64_t want = (S.x.epoch << 32) | xk;
    st_release_sys(S.x.slot[S.card], want);
    const long long t0 = clock64();
    for (int64_t h = 0; h < S.x.G; ++h) {
      if (h == S.card) continue;
      while (ld_acquire_sys(S.x.slot[h]) < want) {
        if (clock64() - t0 > S.x.budget) {
          atomicExch(S.x.error, 1);
          atomicExch(S.abort, 1);
          h = S.x.G;
          break;
        }
      }
    }
    __threadfence_system();
  }
  return card_sync(S, k, flag);
}

}  // namespace kt
