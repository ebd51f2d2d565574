// rglru_scan — the RG-LRU linear recurrence of Griffin / RecurrentGemma,
// per channel:
//   h_t = a_t h_{t-1} + b_t,   a_t = exp(log_a_t),
//   b_t = sqrt(max(1 - exp(2 log_a_t), 0)) x_t,   h_{-1} = 0.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py: _rglru_kernel
// (:20, wrapper rglru_scan :47), and follows the oracle
// repro/kernels/ref.py: rglru_scan_ref where the Pallas wrapper falls
// short: any S and W (the wrapper there asserts S % block_s == 0).
// x, log_a (B, S, W) float32 (the Python wrapper casts other float types),
// h (B, S, W) float32.
//
// Bound: bytes.  At the recurrentgemma-9b serve shape (B = 4, S = 3072,
// W = 4096) one call must move 604 MB (x and log_a in, h out, 201 MB each),
// 180 us at 3.35 TB/s; its arithmetic is two exp, a sqrt and a few
// multiply-adds per element.
//
// Design.  One thread per (b, w) channel walking S would be right and
// coalesced, but gives B * W = 16,384 threads with S dependent steps each:
// about one block per SM, too few loads in flight to cover HBM latency.
// The TPU kernel vectorises a block of S by Hillis-Steele shifts and
// carries h across blocks in its sequential grid axis; on Hopper blocks
// run in no order, so the scan is split into three launches over chunks
// of kChunk positions:
//   1. rglru_chunk_kernel, one thread per (b, chunk, w): the chunk's
//      composed pair (A, Bc), A the product of its a_t and Bc its h from
//      h = 0, into (B, NC, W) scratch;
//   2. rglru_carry_kernel, one thread per (b, w): walks the NC pairs and
//      writes each chunk's incoming h;
//   3. rglru_apply_kernel, one thread per (b, chunk, w): reruns the chunk
//      from its incoming h and writes h.
// Launches 1 and 3 give B * NC * W threads (786,432 at the serve shape)
// with kChunk dependent steps each; a warp reads 32 neighbouring channels
// of one position, 128 contiguous bytes.  x and log_a are read twice, so a
// call moves 1.0 GB where 0.6 GB would do: a later PR can keep the chunk
// in registers between passes.  Nothing carries between blocks except
// through the scratch written by an earlier launch, and there are no
// atomics, so a launch repeats bitwise.  Arithmetic is float32 with FMA
// contraction allowed (the kernel is held at a tolerance); expf and sqrtf
// are the accurate ones (never --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;     // positions per chunk
constexpr int kThreads = 256;  // channels per block

__device__ __forceinline__ float rglru_a(float la) { return expf(la); }

__device__ __forceinline__ float rglru_b(float la, float x) {
  return sqrtf(fmaxf(1.f - expf(2.f * la), 0.f)) * x;
}

// 1. each chunk's composed (A, Bc) from h = 0
__global__ void rglru_chunk_kernel(const float* __restrict__ x,
                                   const float* __restrict__ log_a,
                                   float* __restrict__ Ac,
                                   float* __restrict__ Bc, int S, int W,
                                   int NC) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (w >= W) return;
  const int t0 = c * kChunk, t1 = min(S, t0 + kChunk);
  const size_t base = (size_t)b * S * W + w;
  float A = 1.f, h = 0.f;
  for (int t = t0; t < t1; ++t) {
    const size_t i = base + (size_t)t * W;
    const float la = log_a[i];
    const float a = rglru_a(la);
    h = a * h + rglru_b(la, x[i]);
    A *= a;
  }
  const size_t o = ((size_t)b * NC + c) * W + w;
  Ac[o] = A;
  Bc[o] = h;
}

// 2. the incoming h of every chunk, carried across the chunks in order
__global__ void rglru_carry_kernel(const float* __restrict__ Ac,
                                   const float* __restrict__ Bc,
                                   float* __restrict__ Hin, int W, int NC,
                                   int BW) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= BW) return;
  const int b = i / W, w = i - b * W;
  float h = 0.f;
  for (int c = 0; c < NC; ++c) {
    const size_t o = ((size_t)b * NC + c) * W + w;
    Hin[o] = h;
    h = Ac[o] * h + Bc[o];
  }
}

// 3. every chunk rerun from its incoming h, writing h
__global__ void rglru_apply_kernel(const float* __restrict__ x,
                                   const float* __restrict__ log_a,
                                   const float* __restrict__ Hin,
                                   float* __restrict__ out, int S, int W,
                                   int NC) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (w >= W) return;
  const int t0 = c * kChunk, t1 = min(S, t0 + kChunk);
  const size_t base = (size_t)b * S * W + w;
  float h = Hin[((size_t)b * NC + c) * W + w];
  for (int t = t0; t < t1; ++t) {
    const size_t i = base + (size_t)t * W;
    const float la = log_a[i];
    h = rglru_a(la) * h + rglru_b(la, x[i]);
    out[i] = h;
  }
}

}  // namespace

extern "C" {

// x, log_a, h: (B, S, W) float32, contiguous; Ac, Bc, Hin: scratch of
// (B, ceil(S / kChunk), W) float32 each (kernels/rglru_scan.py CHUNK).
// Returns the cudaError_t of the first launch that fails, else of the
// last.
int rglru_scan_launch(const float* x, const float* log_a, float* h,
                      float* Ac, float* Bc, float* Hin, int B, int S, int W,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int NC = (S + kChunk - 1) / kChunk;
  const dim3 grid((W + kThreads - 1) / kThreads, NC, B);
  rglru_chunk_kernel<<<grid, kThreads, 0, st>>>(x, log_a, Ac, Bc, S, W, NC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int BW = B * W;
  rglru_carry_kernel<<<(BW + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      Ac, Bc, Hin, W, NC, BW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rglru_apply_kernel<<<grid, kThreads, 0, st>>>(x, log_a, Hin, h, S, W, NC);
  return (int)cudaGetLastError();
}

}  // extern "C"
