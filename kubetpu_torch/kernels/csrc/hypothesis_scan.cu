// hypothesis_scan: the greedy scan of one batch under H node-set
// hypotheses at once, with the slice-alignment of each hypothesis's
// result fused into its epilogue.
//
// Replaces, on the greedy engine:
//   kubetpu/assign/placement.py:38 placement_assign_device (jit): vmap of
//     the greedy scan over D (N,) placement masks, each run with
//     node_valid & mask_d (B11);
//   kubetpu/ops/preemption.py:219 dry_run_gang_preemption (jit): vmap of
//     the greedy scan over C eviction hypotheses, each with node_valid &
//     mask_c and requested / nonzero_requested / pod_count less the
//     victims' freed rows, clamped at 0 (B13);
//   kubetpu/ops/topology.py:19 slice_counts and :41 alignment_score, fused
//     into the epilogue: each hypothesis's assigned count and
//     alignment = sum over labeled slices of c_s^2 (B12).
//
// Design: one launch, a grid of H blocks, one block a hypothesis. Each
// block is the greedy_scan design (scan_loop.cuh: 512 threads, each owning
// its nodes' running rows, and a block reduction of the key (score,
// -index)), over its own (N, R) / (N,) running state and scratch. Nothing
// crosses hypotheses on the card; the pick among them stays on the host,
// as in the reference.
//
// One filter_score launch serves every hypothesis. A node that no earlier
// pod of the hypothesis landed on still has the batch's starting state, so
// its verdict and base score are filter_score's mask0 / base0, ANDed with
// the hypothesis's mask inside the scan. That is exact because node_valid
// feeds nothing but the pair's static verdict (score_common.cuh
// pair_static; the reference's `static` at kubetpu/framework/
// runtime.py:1388): the spread pre-launch and domain sums read `eligible`,
// minMatch reads `domain_present`, and the per-step normalize maxima, the
// spread `size` bitmaps and the affinity min-max all run over the
// feasible set, which the mask already shrank. The gang dry run's freed
// nodes start touched with their reduced rows, so the pair function
// recomputes them; spread counts and affinity sums are not reduced by an
// eviction, and neither are the reference's
// (kubetpu/ops/preemption.py:244-250).
#include "scan_loop.cuh"

namespace {

constexpr int kThreads = kt::kThreads;

// The epilogue of block h: its assigned count and, when slice_id is not
// null, its per-slice counts (S + 1 buckets, the last the unlabeled one)
// in `cnt` and alignment = sum over s < S of cnt[s]^2. Every thread of the
// block calls it.
__device__ __forceinline__ void slice_epilogue(int64_t P, const uint8_t* pod_valid,
                                               const int32_t* assignments,
                                               const int32_t* slice_id, int64_t num_slices,
                                               int32_t* cnt, int32_t* count_out,
                                               int32_t* align_out) {
  __shared__ int64_t s_red[33];
  const int tid = threadIdx.x;
  __syncthreads();  // the scan's last assignment is visible to every thread
  if (slice_id != nullptr)
    for (int64_t s = tid; s <= num_slices; s += kThreads) cnt[s] = 0;
  __syncthreads();
  int64_t c = 0;
  for (int64_t p = tid; p < P; p += kThreads) {
    const int32_t j = assignments[p];
    if (j < 0 || !pod_valid[p]) continue;
    ++c;
    if (slice_id != nullptr) atomicAdd(cnt + slice_id[j], 1);
  }
  c = kt::block_reduce(c, kt::SumOp(), 0, s_red);  // its barriers order the adds
  int64_t al = 0;
  if (slice_id != nullptr) {
    for (int64_t s = tid; s < num_slices; s += kThreads) al += (int64_t)cnt[s] * cnt[s];
    al = kt::block_reduce(al, kt::SumOp(), 0, s_red);
  }
  if (tid == 0) {
    *count_out = (int32_t)c;
    *align_out = (int32_t)al;
  }
}

// Block h runs hypothesis h: its mask row, its freed rows (null for the
// placement search), and its slices of every scratch and output buffer.
// The dynamic shared memory is the scan's (spread weights and bitmap)
// and, after the scan, the epilogue's S + 1 counts unless slice_buf (H,
// S + 1) is given.
template <bool kPA, bool kSP, bool kDRA>
__global__ void __launch_bounds__(kThreads, 1)
hypothesis_scan_kernel(ScoreArgs a, const uint8_t* mask0, const int64_t* base0,
                       const uint8_t* hmask, const int64_t* freed_req,
                       const int32_t* freed_count, uint8_t* touched, int32_t* assignments,
                       int64_t* req, int64_t* nz, int32_t* pc, uint8_t* ports,
                       int64_t* pa_sums, int64_t* row_total, int32_t* sp_counts,
                       uint8_t* ok_buf, const int32_t* slice_id, int64_t num_slices,
                       int32_t* slice_buf, int32_t* counts, int32_t* align) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int64_t h = blockIdx.x, N = a.N, R = a.R, P = a.P;
  if (kSP) {
    const int64_t S = a.sp_S;
    a.sp_sums += h * S * (a.sp_D + 1);
    a.sp_min_match += h * S;
    if (a.sp_bits != nullptr) a.sp_bits += h * ((a.sp_D + 31) / 32);
    sp_counts += h * S * N;
    ok_buf += h * N;
  }
  if (kPA) {
    pa_sums += h * a.pa_R * a.pa_D;
    row_total += h * a.pa_R;
  }
  if (a.nom_active != nullptr) a.nom_active += h * a.G;
  const kt::Hypothesis hyp{hmask + h * N, freed_req == nullptr ? nullptr : freed_req + h * N * R,
                           freed_count == nullptr ? nullptr : freed_count + h * N};
  int32_t* const mine = assignments + h * P;
  kt::scan_loop<kPA, kSP, kDRA>(a, hyp, kt::NoExchange{}, mask0, base0, touched + h * N, mine,
                                req + h * N * R, nz + h * N * R, pc + h * N,
                                ports + h * N * a.K, pa_sums, row_total, sp_counts, ok_buf);
  int32_t* cnt = slice_buf != nullptr ? slice_buf + h * (num_slices + 1)
                                      : reinterpret_cast<int32_t*>(s_dyn);
  slice_epilogue(P, a.pod_valid, mine, slice_id, num_slices, cnt, counts + h, align + h);
}

// the instantiation for a batch with (kDRA) or without the DRA leaf
template <bool kPA, bool kSP>
auto hypothesis_for(bool dra) {
  return dra ? hypothesis_scan_kernel<kPA, kSP, true> : hypothesis_scan_kernel<kPA, kSP, false>;
}

// The batched engine's hypotheses (B11 / B13 on engine="batched"): the
// engine's own kernels run once a hypothesis, so the per-hypothesis node
// rows and the epilogue are launches of their own.
//
// hypothesis_rows: element i = h * N + n of every hypothesis at once:
// valid[i] = node_valid[n] & hmask[i] and, when freed_req is not null,
// req[i, r] = max(requested[n, r] - freed_req[i, r], 0), nz[i, r] the same
// from nonzero_requested (the reference subtracts the freed requests from
// both), pc[i] = max(pod_count[n] - freed_count[i], 0). The differences
// wrap like the plain version's tensor arithmetic.
__global__ void hypothesis_rows_kernel(int64_t HN, int64_t N, int64_t R,
                                       const uint8_t* node_valid, const uint8_t* hmask,
                                       const int64_t* requested, const int64_t* nonzero,
                                       const int32_t* pod_count, const int64_t* freed_req,
                                       const int32_t* freed_count, uint8_t* valid, int64_t* req,
                                       int64_t* nz, int32_t* pc) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < HN;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t n = i % N;
    valid[i] = node_valid[n] & hmask[i];
    if (freed_req == nullptr) continue;
    for (int64_t r = 0; r < R; ++r) {
      const uint64_t f = (uint64_t)freed_req[i * R + r];
      const int64_t dr = (int64_t)((uint64_t)requested[n * R + r] - f);
      const int64_t dz = (int64_t)((uint64_t)nonzero[n * R + r] - f);
      req[i * R + r] = dr > 0 ? dr : 0;
      nz[i * R + r] = dz > 0 ? dz : 0;
    }
    const int32_t dc = (int32_t)((uint32_t)pod_count[n] - (uint32_t)freed_count[i]);
    pc[i] = dc > 0 ? dc : 0;
  }
}

// slice_epilogue over H finished (H, P) assignment rows, one block a row:
// the same epilogue as the scan's (counts and, with slice_id, alignment).
__global__ void __launch_bounds__(kThreads, 1)
slice_epilogue_kernel(int64_t P, const uint8_t* pod_valid, const int32_t* assignments,
                      const int32_t* slice_id, int64_t num_slices, int32_t* slice_buf,
                      int32_t* counts, int32_t* align) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int64_t h = blockIdx.x;
  int32_t* cnt = slice_buf != nullptr ? slice_buf + h * (num_slices + 1)
                                      : reinterpret_cast<int32_t*>(s_dyn);
  slice_epilogue(P, pod_valid, assignments + h * P, slice_id, num_slices, cnt, counts + h,
                 align + h);
}

}  // namespace

// Launches H hypotheses of the scan on `stream`, one block each. mask0 and
// base0 are filter_score's (P, N) mask (without the affinity and spread
// filters) and base score of the batch; hmask is (H, N); freed_req (H, N,
// R) and freed_count (H, N) are null for the placement search. Scratch,
// one slice per hypothesis: touched (H, N), req and nz (H, N, R), pc (H,
// N), ports (H, N, K); with affinity rows pa_sums (H, RA, D) and row_total
// (H, RA), else null; with a spread leaf sp_counts (H, S, N) and ok_buf
// (H, N), and a.sp_sums (H, S, D+1), a.sp_min_match (H, S) and a.sp_bits
// (H, ceil(D / 32)) when not null, else null; with nominations
// a.nom_active (H, G), all set on entry. Outputs: assignments (H, P)
// int32, counts (H,) and align (H,) int32. slice_id (N,) is the topology
// leaf's, null without one (align is then 0); slice_buf (H, S + 1) is
// scratch when the counts do not fit in `smem`, else null. `smem` is the
// dynamic shared memory in bytes (the scan's, scan_loop.cuh scan_smem, or
// the epilogue's counts, the larger). N may not exceed kt::kMaxNodes.
// Returns the cudaError_t of the launch (0 = accepted).
extern "C" int kt_hypothesis_scan(const ScoreArgs* args, const void* mask0, const void* base0,
                                  const void* hmask, const void* freed_req,
                                  const void* freed_count, void* touched, void* assignments,
                                  void* req, void* nz, void* pc, void* ports, void* pa_sums,
                                  void* row_total, void* sp_counts, void* ok_buf,
                                  const void* slice_id, int64_t num_slices, void* slice_buf,
                                  void* counts, void* align, int64_t H, int64_t smem,
                                  void* stream) {
  const ScoreArgs a = *args;
  if (H == 0) return 0;
  if (a.N > kt::kMaxNodes) return (int)cudaErrorInvalidValue;
  const bool pa = pa_sums != nullptr, sp = sp_counts != nullptr, dra = a.dra_raw != nullptr;
  auto kernel = pa ? (sp ? hypothesis_for<true, true>(dra) : hypothesis_for<true, false>(dra))
                   : (sp ? hypothesis_for<false, true>(dra) : hypothesis_for<false, false>(dra));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)H, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint8_t*>(mask0), static_cast<const int64_t*>(base0),
      static_cast<const uint8_t*>(hmask), static_cast<const int64_t*>(freed_req),
      static_cast<const int32_t*>(freed_count), static_cast<uint8_t*>(touched),
      static_cast<int32_t*>(assignments), static_cast<int64_t*>(req),
      static_cast<int64_t*>(nz), static_cast<int32_t*>(pc), static_cast<uint8_t*>(ports),
      static_cast<int64_t*>(pa_sums), static_cast<int64_t*>(row_total),
      static_cast<int32_t*>(sp_counts), static_cast<uint8_t*>(ok_buf),
      static_cast<const int32_t*>(slice_id), num_slices, static_cast<int32_t*>(slice_buf),
      static_cast<int32_t*>(counts), static_cast<int32_t*>(align));
  return (int)cudaGetLastError();
}

// Launches hypothesis_rows over H hypotheses of N nodes and R resources:
// node_valid (N,), hmask (H, N), requested and nonzero (N, R), pod_count
// (N,); freed_req (H, N, R) and freed_count (H, N), or both null (then
// only valid (H, N) is written and requested, nonzero, pod_count, req, nz
// and pc may be null). Returns the cudaError_t of the launch.
extern "C" int kt_hypothesis_rows(int64_t H, int64_t N, int64_t R, const void* node_valid,
                                  const void* hmask, const void* requested, const void* nonzero,
                                  const void* pod_count, const void* freed_req,
                                  const void* freed_count, void* valid, void* req, void* nz,
                                  void* pc, void* stream) {
  const int64_t HN = H * N;
  if (HN == 0) return 0;
  const int64_t blocks = (HN + 255) / 256 < 4096 ? (HN + 255) / 256 : 4096;
  hypothesis_rows_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      HN, N, R, static_cast<const uint8_t*>(node_valid), static_cast<const uint8_t*>(hmask),
      static_cast<const int64_t*>(requested), static_cast<const int64_t*>(nonzero),
      static_cast<const int32_t*>(pod_count), static_cast<const int64_t*>(freed_req),
      static_cast<const int32_t*>(freed_count), static_cast<uint8_t*>(valid),
      static_cast<int64_t*>(req), static_cast<int64_t*>(nz), static_cast<int32_t*>(pc));
  return (int)cudaGetLastError();
}

// Launches slice_epilogue over assignments (H, P) int32 with pod_valid
// (P,); slice_id (N,) and num_slices as for kt_hypothesis_scan (null: the
// alignment is 0); slice_buf (H, S + 1) when the S + 1 counts do not fit
// in `smem` bytes of dynamic shared memory, else null. Outputs counts (H,)
// and align (H,) int32. Returns the cudaError_t of the launch.
extern "C" int kt_slice_epilogue(int64_t H, int64_t P, const void* pod_valid,
                                 const void* assignments, const void* slice_id,
                                 int64_t num_slices, void* slice_buf, void* counts, void* align,
                                 int64_t smem, void* stream) {
  if (H == 0) return 0;
  slice_epilogue_kernel<<<(unsigned)H, kThreads, (size_t)smem,
                          static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const uint8_t*>(pod_valid), static_cast<const int32_t*>(assignments),
      static_cast<const int32_t*>(slice_id), num_slices, static_cast<int32_t*>(slice_buf),
      static_cast<int32_t*>(counts), static_cast<int32_t*>(align));
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_hypothesis_scan_args_size() { return (int64_t)sizeof(ScoreArgs); }

extern "C" const char* kt_hypothesis_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
