// filter_score: the one-shot Filter+Score of a batch, every pod against the
// same node state: the (P, N) mask, the (P, N) int64 base score (fit,
// balanced and image terms, weighted) and, when asked for, the (P, N) int64
// total (base plus the normalized node-affinity, taint, InterPodAffinity
// PodTopologySpread and DynamicResources terms).
//
// Replaces kubetpu/framework/runtime.py:1578 filter_score_batch (jit), i.e.
// :1471 feasible_and_scores with :1363 filter_components and :1356
// masked_normalize, and the vmapped kubetpu/ops/podaffinity.py:32
// affinity_filter_pod / :75 affinity_score_pod and kubetpu/ops/spread.py:40
// spread_filter_pod / :69 spread_score_pod (with :32 _domain_sums) inside
// them, which XLA fused into one device program. On the main path it is the parallel half
// of the greedy engine: greedy_scan reads its mask (without the affinity
// filter, which moves with every assignment) and base score for every node
// that no earlier pod of the batch landed on (the batched and packing
// solves run the same passes inside their launch, through filter_pass.cuh).
// The scan's start mask leaves out the affinity and spread filters, which
// move with every assignment.
//
// Bound: memory. Per pair the kernel reads a few int64 node rows and the
// pod's affinity slots, which stay in L2 across the pod axis; what must
// reach device memory is the (P, N) outputs (9 bytes a pair: the mask and
// the base, or the mask and the total), so the least time is those bytes
// over the card's bandwidth.
// Design (launches (0) and (0s) live in score_prelaunch.cuh, which
// filter_component_masks.cu shares): launch (0), only with affinity rows, sums each (RA, D) row over
// its domains (the self-affinity escape reads the total); launch (0s),
// only with a spread leaf, is one block per signature that sums its
// counts over eligible nodes into the (S, D+1) domain sums (slot D is
// domain -1's bucket) and reduces its minMatch over present domains;
// launch (a) is one thread per pair on a 2-D grid (x = nodes, y = pods),
// so neighbouring threads touch neighbouring node rows and the writes
// coalesce; launch (b), only when the total is asked for, is one block per
// pod that reduces the feasible maxima of the node-affinity and taint raw
// rows, the feasible min and max of the affinity raw score and, for a
// spread-scored pod, each soft slot's domain count `size` (a bitmap over
// the domains, in shared memory when it fits, else in global scratch) and
// the scored min and max of the rounded spread raw, and writes the total.
//
// Pod classes: pods come from templates, so most pods of a batch repeat
// another's row exactly (SchedulingBasic's 1024 pods are one template).
// The host splits a batch into classes of pods equal in every pod-indexed
// input of the pair function and the normalize pass
// (kubetpu_torch/framework/runtime.py POD_CLASS_KEY; exact by
// construction, the rows compared value for value) and hands the kernel each
// class's first pod (`reps`) and each pod's (`rep_of`). Launches (a) and
// (b) then run on the C representatives alone, in place in their own rows
// (launch (a) in 64-thread blocks, so that one class's node tiles spread
// over many SMs; launch (b) in 1024-thread blocks when the classes are
// fewer than the SMs, halving each block's walks over the nodes), and
// launch (c) copies each representative's rows to the other pods of its
// class: a block takes eight pod rows and a thread two 16-byte columns of
// them (the grid one wave), loading the eight source units of a column
// (one row a class, so mostly one address, in L1 and L2) before it
// stores them, with streaming stores. The pair function runs
// C x N times instead of P x N, and the bytes written stay the 9 a pair of
// the bound (with the total, the other pods' base rows are not written:
// nothing reads them). What remains above the bound is the chain of three
// dependent launches: (a) and (b) are latency, one class's work on a few
// SMs. Without classes, or when every pod is a class of its own (the
// extender's per-pod answers), the launches are the ones above.
//
// With extender leaves the webhook's mask joins launch (a)'s verdict and its
// score the base, so launch (b)'s maxima run over the shrunk feasible set.
//
// Potential mode (the preemption evaluator's _potential_mask,
// kubetpu/framework/preemption.py:124, on a one-pod view): launch (a)
// writes, for each node, "every victim-independent filter passes (static
// row, PodTopologySpread, InterPodAffinity) and NodeResourcesFit or
// NodePorts fails" against the state given, and no score. The extender
// leaves play no part in it, as in the reference's filter_components.
#include "filter_pass.cuh"
#include "score_prelaunch.cuh"

namespace {

constexpr int kPairThreads = 256;
// pass (a) over few classes: small blocks spread one class's node tiles
// over more SMs
constexpr int kClassPairThreads = 64;
constexpr int kRowThreads = 512;
// pass (b) over few classes: a block's loops over the nodes are its time,
// so it takes twice the threads (the kernel fits 64 registers a thread)
constexpr int kClassRowThreads = 1024;
constexpr int kFewClasses = 132;
constexpr int kCopyThreads = 256;
constexpr int kCopyRows = 8;
constexpr int kCopyCols = 2;

// kRep: grid.y runs over the classes and block y scores class y's
// representative, reps[y], into that pod's rows; else over the pods.
template <bool kRep>
__global__ void filter_score_pairs(ScoreArgs a, uint8_t* mask, int64_t* base, int with_pa,
                                   int potential, const int32_t* reps) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t p = kRep ? (int64_t)reps[blockIdx.y] : (int64_t)blockIdx.y;
  if (n >= a.N) return;
  kt::pair_pass(a, p, n, with_pa, potential, mask + p * a.N + n,
                potential ? nullptr : base + p * a.N + n);
}

// the partial row p of `buf` (W int64 a pod), just written by the block,
// copied to the other pods of p's class (rep_of (P,) each pod's
// representative); every thread of the block calls it
__device__ __forceinline__ void copy_partial(int64_t* buf, int64_t W, int64_t p,
                                             const int32_t* rep_of, int64_t P) {
  __syncthreads();
  for (int64_t q = threadIdx.x; q < P; q += blockDim.x)
    if (q != p && rep_of[q] == p)
      for (int64_t w = 0; w < W; ++w) buf[q * W + w] = buf[p * W + w];
}

// pass (b) (kt::normalize_pass) of block x's pod, `phase` as there, with
// the partials in pod rows: sc_buf (P,), bits_buf (P, C * ceil(D / 32)),
// mx_buf (P, kNorm). kRep: block x normalizes class x's representative,
// reps[x], as kRep does in filter_score_pairs; the partials of phases 1
// and 2 go to every pod of the class (rep_of), the total only to the
// representative's row.
template <bool kRep>
__global__ void __launch_bounds__(1024)
    filter_score_normalize(ScoreArgs a, const uint8_t* mask, const int64_t* base, int64_t* total,
                           int phase, int64_t* sc_buf, int64_t* bits_buf, int64_t* mx_buf,
                           const int32_t* reps, const int32_t* rep_of) {
  __shared__ int64_t s_m[kt::kNorm][33];
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int64_t p = kRep ? (int64_t)reps[blockIdx.x] : (int64_t)blockIdx.x;
  const int64_t N = a.N;
  const int64_t CW = a.sp_C * ((a.sp_D + 31) / 32);
  kt::normalize_pass(a, p, mask + p * N, base + p * N, total + p * N, phase,
                     sc_buf == nullptr ? nullptr : sc_buf + p,
                     bits_buf == nullptr ? nullptr : bits_buf + p * CW,
                     mx_buf == nullptr ? nullptr : mx_buf + p * kt::kNorm, s_dyn, s_m);
  if (!kRep) return;
  if (phase == 1 && a.w_spread && kt::sp_any_soft(a, p)) {
    copy_partial(sc_buf, 1, p, rep_of, a.P);
    copy_partial(bits_buf, CW, p, rep_of, a.P);
  }
  if (phase == 2) copy_partial(mx_buf, kt::kNorm, p, rep_of, a.P);
}

// The (P, W) row buffers that broadcast_rows copies, W bytes a row, each
// in units of `unit` bytes (16, 8 or 1: what its address and row width
// allow).
struct RowSet {
  unsigned char* buf[2];
  int64_t bytes[2];
  int64_t unit[2];
  int n;
};

template <typename T>
__device__ __forceinline__ void copy_rows(unsigned char* buf, int64_t W, int64_t k,
                                          int64_t p0, const int32_t* rep) {
  T v[kCopyRows];
#pragma unroll
  for (int j = 0; j < kCopyRows; ++j)
    if (rep[j] >= 0) v[j] = reinterpret_cast<const T*>(buf + rep[j] * W)[k];
#pragma unroll
  for (int j = 0; j < kCopyRows; ++j)
    if (rep[j] >= 0) __stcs(reinterpret_cast<T*>(buf + (p0 + j) * W) + k, v[j]);
}

// Pass (c): row p of every buffer takes its representative's row,
// rep_of[p]. Block y copies pod rows [8y, 8y + 8) (a representative's
// own row is skipped), each thread columns of units: it loads the eight
// source units of a column (one row a class, so mostly one address, in L1
// and L2) before it stores them, so that eight stores are in flight a
// thread.
__global__ void broadcast_rows(RowSet r, const int32_t* rep_of, int64_t P) {
  __shared__ int32_t s_rep[kCopyRows];
  const int64_t p0 = (int64_t)blockIdx.y * kCopyRows;
  if (threadIdx.x < kCopyRows) {
    const int64_t p = p0 + threadIdx.x;
    const int32_t q = p < P ? rep_of[p] : -1;
    s_rep[threadIdx.x] = q == p ? -1 : q;
  }
  __syncthreads();
  int32_t rep[kCopyRows];
#pragma unroll
  for (int j = 0; j < kCopyRows; ++j) rep[j] = s_rep[j];
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int i = 0; i < r.n; ++i) {
    const int64_t W = r.bytes[i], units = W / r.unit[i];
    for (int64_t k = t; k < units; k += stride) {
      if (r.unit[i] == 16) copy_rows<uint4>(r.buf[i], W, k, p0, rep);
      else if (r.unit[i] == 8) copy_rows<unsigned long long>(r.buf[i], W, k, p0, rep);
      else copy_rows<unsigned char>(r.buf[i], W, k, p0, rep);
    }
  }
}

// the classes of a launch: C of them, reps (C,) their representatives and
// rep_of (P,) each pod's; reps null when every pod is a class of its own
struct Classes {
  const int32_t* reps;
  const int32_t* rep_of;
  int64_t C;
};

// launch pass (c) over the mask's rows (N bytes) and, when not null, those
// of `wide` (8 N bytes: the base or the total), P rows each
cudaError_t broadcast(const Classes& c, int64_t P, int64_t N, void* mask, void* wide,
                      cudaStream_t s) {
  RowSet r{};
  int64_t most = 0;
  auto add = [&](void* buf, int64_t W) {
    const uint64_t align = (uint64_t)(uintptr_t)buf | (uint64_t)W;
    const int64_t unit = align % 16 == 0 ? 16 : align % 8 == 0 ? 8 : 1;
    r.buf[r.n] = static_cast<unsigned char*>(buf);
    r.bytes[r.n] = W;
    r.unit[r.n++] = unit;
    most = W / unit > most ? W / unit : most;
  };
  add(mask, N);
  if (wide != nullptr) add(wide, 8 * N);
  // kCopyCols columns a thread, so that the grid is one wave of the card
  const int64_t cols = kCopyThreads * kCopyCols;
  const dim3 grid((unsigned)((most + cols - 1) / cols),
                  (unsigned)((P + kCopyRows - 1) / kCopyRows));
  broadcast_rows<<<grid, kCopyThreads, 0, s>>>(r, c.rep_of, P);
  return cudaGetLastError();
}

// pass (a) on the pods, or on the classes' representatives
cudaError_t launch_pairs(const ScoreArgs& a, const Classes& c, void* mask, void* base, int pa,
                         int potential, cudaStream_t s) {
  if (c.reps == nullptr) {
    dim3 grid((unsigned)((a.N + kPairThreads - 1) / kPairThreads), (unsigned)a.P);
    filter_score_pairs<false><<<grid, kPairThreads, 0, s>>>(
        a, static_cast<uint8_t*>(mask), static_cast<int64_t*>(base), pa, potential, nullptr);
  } else {
    dim3 grid((unsigned)((a.N + kClassPairThreads - 1) / kClassPairThreads), (unsigned)c.C);
    filter_score_pairs<true><<<grid, kClassPairThreads, 0, s>>>(
        a, static_cast<uint8_t*>(mask), static_cast<int64_t*>(base), pa, potential, c.reps);
  }
  return cudaGetLastError();
}

// pass (b) (one of its phases) on the pods, or on the representatives
cudaError_t launch_normalize(const ScoreArgs& a, const Classes& c, const void* mask,
                             const void* base, void* total, int phase, void* sc, void* bits,
                             void* mx, int64_t smem, cudaStream_t s) {
  auto m = static_cast<const uint8_t*>(mask);
  auto b = static_cast<const int64_t*>(base);
  auto t = static_cast<int64_t*>(total);
  auto scp = static_cast<int64_t*>(sc), bp = static_cast<int64_t*>(bits),
       mxp = static_cast<int64_t*>(mx);
  if (c.reps == nullptr)
    filter_score_normalize<false><<<(unsigned)a.P, kRowThreads, (size_t)smem, s>>>(
        a, m, b, t, phase, scp, bp, mxp, nullptr, nullptr);
  else
    filter_score_normalize<true>
        <<<(unsigned)c.C, c.C < kFewClasses ? kClassRowThreads : kRowThreads, (size_t)smem, s>>>(
            a, m, b, t, phase, scp, bp, mxp, c.reps, c.rep_of);
  return cudaGetLastError();
}

}  // namespace

// Launches pass (0) when `dynamic` and the batch has affinity rows, pass
// (0s) when `dynamic` and the batch has a spread leaf, pass (a), and pass
// (b) when `total` is not null, on `stream`. Without `dynamic` the mask
// leaves out the InterPodAffinity and PodTopologySpread filters, the ones
// that move with each assignment (greedy_scan evaluates them per step).
// With `potential` the mask is the potential mode's (see above; `dynamic`
// is implied, `base` and `total` are not written and may be null).
// `smem` is pass (b)'s dynamic shared memory in bytes (at most 40 KiB).
// `reps` (C,) and `rep_of` (P,) int32 are the pod classes (null: every pod
// its own): passes (a) and (b) then run on the C representatives, and
// pass (c) copies their rows to the other pods: the mask and the base
// without a total, the mask and the total with one (the base rows of the
// other pods are then left unwritten; nothing reads them).
// Returns the cudaError_t of the launches (0 = all were accepted); the
// caller raises on anything else.
extern "C" int kt_filter_score(const ScoreArgs* args, void* mask, void* base, void* total,
                               int dynamic, int potential, int64_t smem, const void* reps,
                               const void* rep_of, int64_t C, void* stream) {
  ScoreArgs a = *args;
  if (potential) {
    dynamic = 1;
    total = nullptr;
    a.w_interpod = 0;
    a.w_spread = 0;
    a.ext_mask = nullptr;
    a.ext_score = nullptr;
  }
  const int pa = dynamic && a.pa_node_domain != nullptr;
  if (!pa) a.w_interpod = 0;
  const int sp = dynamic && a.sp_node_domain != nullptr;
  if (!sp) {
    a.sp_filter = 0;
    a.w_spread = 0;
  }
  if (a.P == 0 || a.N == 0) return 0;
  const Classes c{static_cast<const int32_t*>(reps), static_cast<const int32_t*>(rep_of), C};
  if (c.reps != nullptr && (C <= 0 || C > a.P || rep_of == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = kt::prelaunch(a, pa, sp, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_pairs(a, c, mask, base, pa, potential, s);
  if (err != cudaSuccess) return (int)err;
  if (total != nullptr) {
    err = launch_normalize(a, c, mask, base, total, 0, nullptr, nullptr, nullptr, smem, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (c.reps == nullptr) return 0;
  return (int)broadcast(c, a.P, a.N, mask, total != nullptr ? total : potential ? nullptr : base,
                        s);
}

// The sharded filter_score of one node shard (kernel K2's first half; the
// batch's node rows are the shard's, its spread counts and bitmaps the
// shard's own). `step` 0: the shard's partial spread domain sums into
// a.sp_sums (the mesh sums them into every shard's a.sp_sums); 1: minMatch
// from the summed sums, the affinity row totals and pass (a), mask and base
// with every filter; 2, 3, 4: the normalize pass's phases 1, 2, 3
// (filter_score_normalize; sc (P,), bits (P, C * ceil(D / 32)) and mx (P,
// kNorm) int64 are combined over the shards between them). With the pod
// classes (`reps`, `rep_of`, `C` as in kt_filter_score) steps 1-4 run on
// the representatives: steps 2 and 3 write their partials (sc and bits;
// mx) into every pod's row of the class from the same block, and step 4
// copies the mask and the total rows to the other pods (pass (c)).
// With `potential` (steps 0 and 1 only, on a one-pod view: the preemption
// evaluator's mask over a node mesh) step 1's mask is the potential mode's
// (see kt_filter_score) and `base` is not written; the spread filter's
// domain sums are step 0's, summed over the shards, so its verdict reads
// the constraint's global minimum.
// Returns the cudaError_t of the launches.
extern "C" int kt_filter_score_shard(const ScoreArgs* args, void* mask, void* base, void* total,
                                     int step, int potential, void* sc, void* bits, void* mx,
                                     int64_t smem, const void* reps, const void* rep_of,
                                     int64_t C, void* stream) {
  ScoreArgs a = *args;
  if (potential) {
    if (step > 1) return (int)cudaErrorInvalidValue;
    a.w_interpod = 0;
    a.w_spread = 0;
    a.ext_mask = nullptr;
    a.ext_score = nullptr;
  }
  const int pa = a.pa_node_domain != nullptr;
  if (!pa) a.w_interpod = 0;
  const int sp = a.sp_node_domain != nullptr;
  if (!sp) {
    a.sp_filter = 0;
    a.w_spread = 0;
  }
  if (a.P == 0 || a.N == 0) return 0;
  const Classes c{static_cast<const int32_t*>(reps), static_cast<const int32_t*>(rep_of), C};
  if (c.reps != nullptr && (C <= 0 || C > a.P || rep_of == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (step == 0) {
    if (sp && (a.sp_filter || a.w_spread) && a.sp_S > 0)
      kt::prelaunch_spread_sums<<<(unsigned)a.sp_S, kt::kPreRowThreads, 0, s>>>(a, 1);
    return (int)cudaGetLastError();
  }
  if (step == 1) {
    err = kt::prelaunch(a, pa, sp, s, 2);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_pairs(a, c, mask, base, pa, potential, s);
  }
  if (step < 2 || step > 4) return (int)cudaErrorInvalidValue;
  err = launch_normalize(a, c, mask, base, total, step - 1, sc, bits, mx, smem, s);
  if (err != cudaSuccess || c.reps == nullptr || step != 4) return (int)err;
  return (int)broadcast(c, a.P, a.N, mask, total, s);
}

extern "C" int64_t kt_filter_score_args_size() { return (int64_t)sizeof(ScoreArgs); }

extern "C" const char* kt_filter_score_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
