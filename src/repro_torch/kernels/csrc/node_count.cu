// node_count — in-flight catch-up counts per (trial, node), the §6
// bandwidth-contended rebuild reduction.
//
// Replaces the Pallas TPU kernel repro/kernels/pac_eval.py:
// _node_count_kernel (:200, wrapper node_count, pallas_call at :250).
//   cnt[b, node] = #{p : active[b, p] and recruit[b, p] == node}
// recruit (B, P) int32, active (B, P) bool, cnt (B, n_real) int32, zeroed
// by the caller.  Ids outside [0, n_real) — the engine's no-recruit
// sentinel among them — count nowhere.
//
// Bound: launch latency.  The call reads 5 bytes per partition and writes
// 4 per node (about 0.17 MB at the paper tile, 0.05 us at 3.35 TB/s), far
// less than the few microseconds a launch costs.
// Design: blocks over (partition slice, trial).  Each block keeps an
// n_real-entry histogram in shared memory, adds one shared atomicAdd per
// active in-range recruit of its slice, then flushes the non-zero entries
// with one global atomicAdd each.  Integer atomics commute, so the counts
// are exact whatever order the blocks run in.  The reference's one-hot
// compare over 128-lane padded node and partition axes is TPU layout and
// is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 1024;                // partitions per block

__global__ void __launch_bounds__(kThreads)
node_count_kernel(const int32_t* __restrict__ recruit,
                  const uint8_t* __restrict__ active,
                  int32_t* __restrict__ cnt, int P, int n_real) {
  extern __shared__ int hist[];
  const long long b = blockIdx.y;
  for (int i = threadIdx.x; i < n_real; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int p0 = blockIdx.x * kSlice;
  const int p1 = min(p0 + kSlice, P);
  for (int p = p0 + threadIdx.x; p < p1; p += kThreads) {
    const long long i = b * P + p;
    const int r = recruit[i];
    if (active[i] != 0 && r >= 0 && r < n_real) atomicAdd(&hist[r], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_real; i += kThreads)
    if (hist[i] != 0) atomicAdd(&cnt[b * n_real + i], hist[i]);
}

}  // namespace

extern "C" int node_count_launch(const void* recruit, const void* active,
                                 void* cnt, int B, int P, int n_real,
                                 void* stream) {
  if (B <= 0 || P <= 0) return 0;
  const dim3 grid((P + kSlice - 1) / kSlice, B);
  node_count_kernel<<<grid, kThreads, n_real * sizeof(int),
                      (cudaStream_t)stream>>>(
      (const int32_t*)recruit, (const uint8_t*)active, (int32_t*)cnt, P,
      n_real);
  return (int)cudaGetLastError();
}
