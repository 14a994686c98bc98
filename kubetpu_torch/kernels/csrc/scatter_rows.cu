// scatter_rows: write the dirty node rows of a cycle into the six buffers
// of the device-resident node block, in place.
//
// Replaces kubetpu/framework/runtime.py:240 _scatter_node_rows (jit, its
// six state buffers donated), the serial and pipelined cycles' delta
// upload: alloc, requested and nonzero_requested are (N, R) int64,
// pod_count and allowed_pods (N,) int32, node_valid (N,) bool. idx holds
// M slots: the distinct dirty row indices, then pads; an index outside
// [0, N) is a pad and its writes are dropped (the reference's
// mode="drop").
//
// Bound: memory. The work reads idx once, and for each in-range slot its
// update row once and its block row written once: 4 bytes a slot, plus
// 24 R + 9 read and 24 R + 9 written an in-range slot (81 each at R = 3;
// a pad slot returns before it reads its row), about 167 KB in all for a
// 1024-slot delta with 1008 rows in range, so launch latency decides its
// time on the card, and the host's part of a call decides a call.
// Design: the block's six destinations, N and R are a launch plan
// (ScatterPlan) that the resident block builds and validates once, when it
// allocates its buffers (a full upload); a delta call hands the plan, the
// delta's place in the cycle's packed upload (the index's address and the
// six update rows' offsets from it) and M, and launches once. One thread
// per (slot, unit) of a row: an int64 field's row in 16-byte units when R
// is even (a row then starts on a 16-byte boundary in the block and in the
// upload, whose arrays upload_packed aligns to 16 bytes), else in 8-byte
// ones, then one unit each for the three narrow fields; slot-major, so
// neighbouring threads write neighbouring bytes of one row. Nothing is
// staged in shared memory and nothing is reduced.
#include <cstdint>
#include <cuda_runtime.h>

// the block's buffers and sizes (kubetpu_torch.kernels.ScatterPlanArgs
// mirrors it)
struct ScatterPlan {
  int64_t* alloc;
  int64_t* req;
  int64_t* nz;
  int32_t* pc;
  int32_t* al;
  uint8_t* vd;
  int64_t N, R;
};

namespace {

constexpr int kThreads = 256;

struct Delta {
  const int32_t* idx;
  const int64_t* u[3];  // alloc, requested, nonzero_requested (M, R)
  const int32_t* pc;
  const int32_t* al;
  const uint8_t* vd;
  int64_t M;
};

template <typename U>
__global__ void scatter_rows_kernel(ScatterPlan p, Delta d) {
  // units of U a row of each int64 field
  constexpr int64_t kPer = sizeof(U) / sizeof(int64_t);
  const int64_t Ru = p.R / kPer, W = 3 * Ru + 3;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= d.M * W) return;
  const int64_t slot = t / W, c = t % W;
  const int64_t row = d.idx[slot];
  if (row < 0 || row >= p.N) return;  // a pad: dropped
  if (c < 3 * Ru) {
    const int64_t f = c / Ru, j = c % Ru;
    int64_t* dst = f == 0 ? p.alloc : f == 1 ? p.req : p.nz;
    const int64_t* src = f == 0 ? d.u[0] : f == 1 ? d.u[1] : d.u[2];
    reinterpret_cast<U*>(dst + row * p.R)[j] = reinterpret_cast<const U*>(src + slot * p.R)[j];
  } else if (c == 3 * Ru) {
    p.pc[row] = d.pc[slot];
  } else if (c == 3 * Ru + 1) {
    p.al[row] = d.al[slot];
  } else {
    p.vd[row] = d.vd[slot];
  }
}

}  // namespace

// Launches the scatter of one delta on `stream`: `plan` the block's, `idx`
// the delta's (M,) int32 index and off[0..5] the byte offsets from it of
// its six update rows in runtime.NODE_FIELDS order (alloc, requested,
// nonzero_requested (M, R) int64; pod_count, allowed_pods (M,) int32;
// node_valid (M,) bool). Returns the cudaError_t of the launch (0 =
// accepted).
extern "C" int kt_scatter_rows(const ScatterPlan* plan, const void* idx, const int64_t* off,
                               int64_t M, void* stream) {
  const ScatterPlan p = *plan;
  const auto* base = static_cast<const unsigned char*>(idx);
  Delta d{static_cast<const int32_t*>(idx),
          {reinterpret_cast<const int64_t*>(base + off[0]),
           reinterpret_cast<const int64_t*>(base + off[1]),
           reinterpret_cast<const int64_t*>(base + off[2])},
          reinterpret_cast<const int32_t*>(base + off[3]),
          reinterpret_cast<const int32_t*>(base + off[4]),
          reinterpret_cast<const uint8_t*>(base + off[5]),
          M};
  bool wide = p.R % 2 == 0;
  for (int f = 0; f < 3; ++f)
    wide = wide && (uintptr_t)d.u[f] % 16 == 0;
  wide = wide && (uintptr_t)p.alloc % 16 == 0 && (uintptr_t)p.req % 16 == 0 &&
         (uintptr_t)p.nz % 16 == 0;
  const int64_t W = 3 * (wide ? p.R / 2 : p.R) + 3, total = M * W;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    scatter_rows_kernel<longlong2><<<(unsigned)blocks, kThreads, 0, s>>>(p, d);
  else
    scatter_rows_kernel<long long><<<(unsigned)blocks, kThreads, 0, s>>>(p, d);
  return (int)cudaGetLastError();
}

extern "C" int64_t kt_scatter_rows_plan_size() { return (int64_t)sizeof(ScatterPlan); }

extern "C" const char* kt_scatter_rows_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
