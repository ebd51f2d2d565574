// rglru_scan_bwd — the gradient of the RG-LRU linear recurrence
// (csrc/rglru_scan.cu) with respect to x and log_a, per channel:
//   a_t = exp(la_t),  e_t = exp(2 la_t),  s_t = sqrt(max(1 - e_t, 0)),
//   g_t = dh_t + a_{t+1} g_{t+1}   (g past the last position 0),
//   dx_t  = g_t s_t,
//   dla_t = g_t h_{t-1} a_t - g_t x_t e_t / s_t   (second term 0 where
//           s_t = 0: the derivative of the clamped branch).
//
// Replaces no TPU kernel: the reference trains by jax.value_and_grad
// through the oracle repro/kernels/ref.py: rglru_scan_ref (the Pallas
// kernel repro/kernels/rglru_scan.py: rglru_scan has no custom_vjp), and
// the port's card cannot run that autodiff without running the plain
// version.  kernels/rglru_scan.py: rglru_scan_bwd_plain is its plain
// version.  x, log_a, h (the forward's output), dh: (B, S, W) float32;
// dx, dla: (B, S, W) float32.
//
// Bound: bytes.  Four inputs read once and two outputs written once,
// 24 bytes an element; at the recurrentgemma-9b train shape (B = 2,
// S = 2048, W = 4096) 403 MB, 120 us at 3.35 TB/s.  The arithmetic is
// two exp, a sqrt, a divide and a few multiply-adds an element.
//
// Design: the forward's, run backwards.  g is a linear recurrence in
// reverse, so S is cut into chunks of kChunk positions and the carry
// between chunks is a chain across blocks of one persistent launch.  A
// unit of work is (b, tile of kThreads channels, chunk c); a thread owns
// one channel.  Tickets (atomicAdd on a global counter) are chunk-major
// from the LAST chunk, so the unit of chunk c + 1 of the same channels
// holds an earlier ticket and the earliest unfinished ticket always
// belongs to a running block.  Per unit, a thread
//   1. loads its column of log_a and dh into registers (a warp reads 128
//      contiguous bytes of one position);
//   2. walks the chunk from the last position to the first from G = 0 for
//      the pair (A, Bc): A the product of its a_t, Bc = a_{t0} g_{t0};
//      the carry a chunk hands the one before it is A Gin + Bc, with Gin
//      what it received from the chunk after it;
//   3. waits for chunk c + 1's carry (0 for the last chunk), publishes its
//      own, so a hop of the chain is one multiply-add and a publish;
//   4. walks the chunk again from Gin, reading x and h_{t-1}, and stores
//      dx and dla: the elementwise tail is fused into this walk.
// A carry is one 64-bit word per (b, chunk, channel), the float's bits
// below and the tag c + 1 above, stored with one 64-bit store and polled
// from L2 (ld.relaxed.gpu); the launcher zeroes the words and the ticket
// on the stream first.  A poll that waits about a second traps, so a
// broken chain fails the launch and cannot hang the card.  Every float
// operation has one order, so two launches give the same bits.  expf and
// sqrtf are the accurate ones (never --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;      // positions per chunk (rglru_scan.py CHUNK)
constexpr int kThreads = 128;   // channels per block (rglru_scan.py TILE)
constexpr uint32_t kMaxPolls = 1u << 24;   // then trap: the chain is broken

__device__ __forceinline__ uint64_t poll(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void publish(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ log_a,
                      const float* __restrict__ h,
                      const float* __restrict__ dh, float* __restrict__ dx,
                      float* __restrict__ dla, uint64_t* __restrict__ carry,
                      unsigned* __restrict__ ticket, int B, int S, int W,
                      int NC, unsigned units) {
  __shared__ unsigned s_ticket;
  const int tiles = (W + kThreads - 1) / kThreads;
  const unsigned per_chunk = static_cast<unsigned>(B) * tiles;
  for (;;) {
    if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1u);
    __syncthreads();
    const unsigned mine = s_ticket;
    __syncthreads();                        // read before the next write
    if (mine >= units) return;              // block-uniform
    const int c = NC - 1 - static_cast<int>(mine / per_chunk);
    const int rest = static_cast<int>(mine % per_chunk);
    const int b = rest / tiles;
    const int w = (rest - b * tiles) * kThreads + threadIdx.x;
    if (w >= W) continue;
    const int t0 = c * kChunk;
    const int n = min(kChunk, S - t0);
    const size_t base = (static_cast<size_t>(b) * S + t0) * W + w;

    float la[kChunk], gout[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const size_t i = base + static_cast<size_t>(j) * W;
      la[j] = j < n ? log_a[i] : 0.f;
      gout[j] = j < n ? dh[i] : 0.f;
    }
    float A = 1.f, Bc = 0.f;     // the chunk's pair from G = 0
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      if (j < n) {
        const float a = expf(la[j]);
        Bc = a * (gout[j] + Bc);
        A = A * a;
      }
    }

    const size_t cw = static_cast<size_t>(b) * NC * W + w;   // chunk 0
    const int next = c + 1;                 // the successor chunk
    float gin = 0.f;
    if (next < NC) {
      const uint64_t* src = carry + cw + static_cast<size_t>(next) * W;
      uint64_t word = poll(src);
      for (uint32_t tries = 0; static_cast<int>(word >> 32) != next + 1;
           ++tries) {
        if (tries == kMaxPolls) __trap();
        __nanosleep(64);
        word = poll(src);
      }
      gin = __uint_as_float(static_cast<uint32_t>(word));
    }
    publish(carry + cw + static_cast<size_t>(c) * W,
            (static_cast<uint64_t>(c + 1) << 32) |
                __float_as_uint(fmaf(A, gin, Bc)));

    float G = gin;                          // a_{t+1} g_{t+1}
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      if (j < n) {
        const size_t i = base + static_cast<size_t>(j) * W;
        const float a = expf(la[j]);
        const float e = expf(2.f * la[j]);
        const float s = sqrtf(fmaxf(1.f - e, 0.f));
        const float g = gout[j] + G;
        const float h_prev = t0 + j > 0 ? h[i - W] : 0.f;
        dx[i] = g * s;
        const float clamped = s > 0.f ? g * x[i] * e / s : 0.f;
        dla[i] = g * h_prev * a - clamped;
        G = a * g;
      }
    }
  }
}

// blocks of rglru_scan_bwd_kernel the card holds at once, per device
int resident_blocks(int* out) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rglru_scan_bwd_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < 64) cached[dev] = *out;
  return 0;
}

}  // namespace

extern "C" {

// x, log_a, h, dh, dx, dla: (B, S, W) float32, contiguous; carry: scratch
// of B * ceil(S / kChunk) * W + 1 64-bit words (the last holds the
// ticket), zeroed here on the stream.  B * ceil(S / kChunk) *
// ceil(W / kThreads) must be below 2^31 (kernels/rglru_scan.py checks).
// Returns the cudaError_t of the first call that fails, else of the
// launch.
int rglru_scan_bwd_launch(const float* x, const float* log_a, const float* h,
                          const float* dh, float* dx, float* dla, void* carry,
                          int B, int S, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int NC = (S + kChunk - 1) / kChunk;
  const long long units = static_cast<long long>(B) * NC *
                          ((W + kThreads - 1) / kThreads);
  if (units <= 0) return 0;
  int blocks = 0;
  int code = resident_blocks(&blocks);
  if (code != 0) return code;
  const size_t words = static_cast<size_t>(B) * NC * W;
  cudaError_t err = cudaMemsetAsync(carry, 0, (words + 1) * sizeof(uint64_t),
                                    st);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint64_t* words_p = static_cast<uint64_t*>(carry);
  const unsigned grid = static_cast<unsigned>(
      units < blocks ? units : static_cast<long long>(blocks));
  rglru_scan_bwd_kernel<<<grid, kThreads, 0, st>>>(
      x, log_a, h, dh, dx, dla, words_p,
      reinterpret_cast<unsigned*>(words_p + words), B, S, W, NC,
      static_cast<unsigned>(units));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
