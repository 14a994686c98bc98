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
// time on the card.
// Design: one thread per (slot, column) of the 3 R + 3 columns of a row,
// slot-major, so neighbouring threads write neighbouring int64 columns of
// one row; nothing is staged in shared memory and nothing is reduced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_rows_kernel(int64_t M, int64_t N, int64_t R, const int32_t* idx,
                                    const int64_t* u_alloc, const int64_t* u_req,
                                    const int64_t* u_nz, const int32_t* u_pc,
                                    const int32_t* u_al, const uint8_t* u_vd, int64_t* alloc,
                                    int64_t* req, int64_t* nz, int32_t* pc, int32_t* al,
                                    uint8_t* vd) {
  const int64_t W = 3 * R + 3;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= M * W) return;
  const int64_t slot = t / W, c = t % W;
  const int64_t row = idx[slot];
  if (row < 0 || row >= N) return;  // a pad: dropped
  if (c < R) {
    alloc[row * R + c] = u_alloc[slot * R + c];
  } else if (c < 2 * R) {
    req[row * R + (c - R)] = u_req[slot * R + (c - R)];
  } else if (c < 3 * R) {
    nz[row * R + (c - 2 * R)] = u_nz[slot * R + (c - 2 * R)];
  } else if (c == 3 * R) {
    pc[row] = u_pc[slot];
  } else if (c == 3 * R + 1) {
    al[row] = u_al[slot];
  } else {
    vd[row] = u_vd[slot];
  }
}

}  // namespace

extern "C" int kt_scatter_rows(int64_t M, int64_t N, int64_t R, const void* idx,
                               const void* u_alloc, const void* u_req, const void* u_nz,
                               const void* u_pc, const void* u_al, const void* u_vd,
                               void* alloc, void* req, void* nz, void* pc, void* al, void* vd,
                               void* stream) {
  const int64_t total = M * (3 * R + 3);
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  scatter_rows_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      M, N, R, static_cast<const int32_t*>(idx), static_cast<const int64_t*>(u_alloc),
      static_cast<const int64_t*>(u_req), static_cast<const int64_t*>(u_nz),
      static_cast<const int32_t*>(u_pc), static_cast<const int32_t*>(u_al),
      static_cast<const uint8_t*>(u_vd), static_cast<int64_t*>(alloc),
      static_cast<int64_t*>(req), static_cast<int64_t*>(nz), static_cast<int32_t*>(pc),
      static_cast<int32_t*>(al), static_cast<uint8_t*>(vd));
  return (int)cudaGetLastError();
}

extern "C" const char* kt_scatter_rows_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
