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
// 24 bytes an element; at the recurrentgemma-9b train path's microbatch
// (B = 1, S = 2048, W = 4096) 201 MB, 60 us at 3.35 TB/s (B = 2: 403 MB,
// 120 us).  The arithmetic is three exp, a sqrt, a divide and a few
// multiply-adds an element.
//
// Design: the forward's, run backwards.  g is a linear recurrence in
// reverse, so S is cut into chunks of kChunk positions and the carry
// between chunks is a chain across blocks of one persistent launch (six
// blocks an SM).  A unit of work is (b, tile of kThreads channels, chunk
// c); a thread owns one channel.  Tickets (atomicAdd on a global counter)
// are chunk-major from the LAST chunk, so the unit of chunk c + 1 of the
// same channels holds an earlier ticket and the earliest unfinished
// ticket always belongs to a running block.  A block's shared-memory
// stage holds one unit's four inputs, [log_a, dh, x, h_{t-1}][kChunk]
// [kThreads] floats (32 KB); a thread copies and reads only its own
// column (4-byte cp.async: a warp moves 128 contiguous bytes of one
// position, and no block barrier guards the stage).  Per unit, a thread
//   1. waits for its column's copies and walks the chunk from the last
//      position to the first from G = 0 for the pair (A, Bc), reading
//      log_a and dh from the stage: A the product of its a_t,
//      Bc = a_{t0} g_{t0}; the carry a chunk hands the one before it is
//      A Gin + Bc, with Gin what it received from the chunk after it;
//   2. waits for chunk c + 1's carry (0 for the last chunk) and publishes
//      its own, so a hop of the chain is one multiply-add and a publish;
//   3. takes the block's next ticket only now, so the next units go to
//      the blocks the chain has released, whose loads start at once (a
//      ticket taken before the wait may hand the chain's next chunk to a
//      block that still waits for this one; rglru_check's
//      probe_ticket_first times that order);
//   4. walks the chunk again from Gin, reading all four inputs from the
//      stage, and streams dx and dla out (__stcs); as soon as a row of
//      the stage is read, the copies of the next unit's same row start
//      into it, so the next unit's loads fly while this one finishes and
//      the walks keep no array in registers.
// A carry is one 64-bit word per (b, chunk, channel), the float's bits
// below and the tag c + 1 above, stored with one 64-bit store and polled
// from L2 (ld.relaxed.gpu); the launcher zeroes the words and the ticket
// on the stream first.  A poll that waits about a second traps, so a
// broken chain fails the launch and cannot hang the card.  Every float
// operation is an explicit intrinsic in one order, so two launches give
// the same bits; expf and sqrtf are the accurate ones (never
// --use_fast_math), and e_t is expf(2 la_t), not a_t a_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;      // positions per chunk (rglru_scan.py BWD_CHUNK)
constexpr int kThreads = 128;   // channels per block (rglru_scan.py TILE)
constexpr int kMinBlocks = 6;   // blocks an SM holds: the stage's 32 KB each
constexpr uint32_t kMaxPolls = 1u << 24;   // then trap: the chain is broken
// the stage's inputs, in its order
enum { kLogA, kDh, kX, kHPrev, kInputs };
constexpr int kStageBytes = kInputs * kChunk * kThreads * sizeof(float);

__device__ __forceinline__ float rglru_a(float la) { return expf(la); }

__device__ __forceinline__ float rglru_e(float la) { return expf(2.f * la); }

__device__ __forceinline__ float rglru_s(float e) {
  return sqrtf(fmaxf(__fsub_rn(1.f, e), 0.f));
}

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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// where a ticket's unit lies, for this thread's channel
struct Unit {
  int b, c, w, n;   // batch row, chunk, channel, positions in the chunk
  size_t base;      // element (b, c * kChunk, w)
};

__device__ __forceinline__ Unit unit_of(unsigned ticket, int B, int S, int W,
                                        int NC) {
  const int tiles = (W + kThreads - 1) / kThreads;
  const unsigned per_chunk = static_cast<unsigned>(B) * tiles;
  Unit u;
  u.c = NC - 1 - static_cast<int>(ticket / per_chunk);   // from the last
  const int rest = static_cast<int>(ticket % per_chunk);
  u.b = rest / tiles;
  u.w = (rest - u.b * tiles) * kThreads + threadIdx.x;
  const int t0 = u.c * kChunk;
  u.n = min(kChunk, S - t0);
  u.base = (static_cast<size_t>(u.b) * S + t0) * W + u.w;
  return u;
}

// row j of input k in this thread's column of the stage
__device__ __forceinline__ float* slot(float* col, int k, int j) {
  return col + (k * kChunk + j) * kThreads;
}

// start the copies of row j of unit u's column into the stage: log_a, dh
// and x at position t0 + j, h at t0 + j - 1 (0 before the first position)
__device__ __forceinline__ void fetch_row(const Unit& u, int j, float* col,
                                          const float* __restrict__ x,
                                          const float* __restrict__ log_a,
                                          const float* __restrict__ h,
                                          const float* __restrict__ dh,
                                          int W) {
  const size_t i = u.base + static_cast<size_t>(j) * W;   // position t0 + j
  cp_async4(slot(col, kLogA, j), log_a + i);
  cp_async4(slot(col, kDh, j), dh + i);
  cp_async4(slot(col, kX, j), x + i);
  if (u.c > 0 || j > 0)
    cp_async4(slot(col, kHPrev, j), h + i - W);
  else
    *slot(col, kHPrev, j) = 0.f;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
rglru_scan_bwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ log_a,
                      const float* __restrict__ h,
                      const float* __restrict__ dh, float* __restrict__ dx,
                      float* __restrict__ dla, uint64_t* __restrict__ carry,
                      unsigned* __restrict__ ticket, int B, int S, int W,
                      int NC, unsigned units) {
  extern __shared__ float stage[];
  __shared__ unsigned s_ticket[2];
  float* col = stage + threadIdx.x;         // this thread's column
  if (threadIdx.x == 0) s_ticket[0] = atomicAdd(ticket, 1u);
  __syncthreads();
  unsigned mine = s_ticket[0];
  if (mine >= units) return;                // block-uniform
  {
    const Unit u = unit_of(mine, B, S, W, NC);
    if (u.w < W)
      for (int j = 0; j < u.n; ++j) fetch_row(u, j, col, x, log_a, h, dh, W);
  }

  for (int round = 1;; ++round) {
    const Unit u = unit_of(mine, B, S, W, NC);
    const bool live = u.w < W;
    cp_async_wait_all();                    // this column's copies landed
    // input k at row j of this unit
    auto in = [&](int k, int j) -> float {
      return *slot(col, k, j);
    };

    float A = 1.f, Bc = 0.f;     // the chunk's pair from G = 0
    if (live) {
#pragma unroll
      for (int j = kChunk - 1; j >= 0; --j) {
        if (j < u.n) {
          const float a = rglru_a(in(kLogA, j));
          Bc = __fmul_rn(a, __fadd_rn(in(kDh, j), Bc));
          A = __fmul_rn(A, a);
        }
      }
    }

    float G = 0.f;                          // a_{t+1} g_{t+1}
    if (live) {
      const size_t cw = static_cast<size_t>(u.b) * NC * W + u.w;  // chunk 0
      const int succ = u.c + 1;             // the successor chunk
      float gin = 0.f;
      if (succ < NC) {
        const uint64_t* src = carry + cw + static_cast<size_t>(succ) * W;
        uint64_t word = poll(src);
        for (uint32_t tries = 0; static_cast<int>(word >> 32) != succ + 1;
             ++tries) {
          if (tries == kMaxPolls) __trap();
          __nanosleep(64);
          word = poll(src);
        }
        gin = __uint_as_float(static_cast<uint32_t>(word));
      }
      publish(carry + cw + static_cast<size_t>(u.c) * W,
              (static_cast<uint64_t>(u.c + 1) << 32) |
                  __float_as_uint(__fmaf_rn(A, gin, Bc)));
      G = gin;
    }
    // the next ticket, once the chain has released this block
    if (threadIdx.x == 0) s_ticket[round & 1] = atomicAdd(ticket, 1u);
    __syncthreads();
    const unsigned next = s_ticket[round & 1];
    const bool more = next < units;         // block-uniform
    const Unit v = unit_of(more ? next : mine, B, S, W, NC);
    const bool fetch = more && v.w < W;

#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      if (live && j < u.n) {
        const size_t i = u.base + static_cast<size_t>(j) * W;
        const float la = in(kLogA, j);
        const float a = rglru_a(la);
        const float e = rglru_e(la);
        const float s = rglru_s(e);
        const float g = __fadd_rn(in(kDh, j), G);
        const float clamped =
            s > 0.f ? __fdiv_rn(__fmul_rn(__fmul_rn(g, in(kX, j)), e), s)
                    : 0.f;
        __stcs(dx + i, __fmul_rn(g, s));
        __stcs(dla + i, __fmaf_rn(__fmul_rn(g, in(kHPrev, j)), a, -clamped));
        G = __fmul_rn(a, g);
      }
      // row j is read (the stores above waited for its values): the next
      // unit's copies of row j may land there
      if (fetch && j < v.n) fetch_row(v, j, col, x, log_a, h, dh, W);
    }
    if (!more) break;                       // block-uniform
    mine = next;
  }
}

// blocks of rglru_scan_bwd_kernel the card holds at once, per device; set
// up (the dynamic shared-memory limit raised) on a device's first call, so
// a call inside a CUDA graph capture makes no attribute call
int resident_blocks(int* out) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return 0;
  }
  err = cudaFuncSetAttribute(rglru_scan_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStageBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rglru_scan_bwd_kernel, kThreads, kStageBytes);
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
  rglru_scan_bwd_kernel<<<grid, kThreads, kStageBytes, st>>>(
      x, log_a, h, dh, dx, dla, words_p,
      reinterpret_cast<unsigned*>(words_p + words), B, S, W, NC,
      static_cast<unsigned>(units));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
