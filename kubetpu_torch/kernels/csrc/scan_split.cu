// The timing build of greedy_scan.cu: the same kernels with the scan's step
// split compiled in (scan_loop.cuh, KT_SCAN_SPLIT), and the step floor.
// Built only by `chip_smoke.py --time-basic` / `--time-spread`, never by
// kernels.build(): no path loads it.
//
//   nvcc <kernels.NVCC_FLAGS> -o libscan_split.so scan_split.cu
//
// kt_greedy_scan is greedy_scan.cu's entry; after a launch, kt_scan_split
// copies the split of its last scan (kt_split, 16 words) to host memory.
// kt_scan_floor launches P steps of the loop's reductions and barriers
// alone (scan_floor_kernel) on N nodes, `norm` normalize values.
#define KT_SCAN_SPLIT
#include "greedy_scan.cu"

extern "C" int kt_scan_split(void* host) {
  return (int)cudaMemcpyFromSymbol(host, kt::kt_split, 16 * sizeof(unsigned long long));
}

extern "C" int kt_scan_floor(int64_t P, int64_t N, int norm, void* out, void* stream) {
  kt::scan_floor_kernel<<<1, kt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      P, N, norm, static_cast<int64_t*>(out));
  return (int)cudaGetLastError();
}
