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
// 180.29 us at 3.35 TB/s; its arithmetic is two exp, a sqrt and a few
// multiply-adds per element.
//
// Design: one launch, one chained pass.  The TPU kernel vectorises a block
// of S by Hillis-Steele shifts and carries h across blocks in its
// sequential grid axis; on Hopper blocks run in no order, so S is cut into
// chunks of kChunk positions and the carry between chunks is a chain
// across blocks.  A unit of work is (b, tile of kThreads channels, chunk
// c); a thread owns one channel w of it.  The launch is persistent: as
// many blocks as the card holds at once (three an SM), each walking units
// in the order it takes them from a global ticket (atomicAdd).  Tickets
// are chunk-major, so the unit of chunk c - 1 of the same channels holds
// an earlier ticket, and the earliest unfinished ticket always belongs to
// a block that is working on it: no block waits on one that cannot run.
// Per unit, a thread
//   1. copies its column of the unit's log_a and x (a warp reads 128
//      contiguous bytes of one position) from the block's shared-memory
//      stage into registers, where the copies were started one unit
//      earlier (4-byte cp.async, each thread its own column, so no block
//      barrier guards the stage), and forms a_t and b_t there (2 x kChunk
//      floats a thread): x and log_a are read once;
//   2. takes the block's next ticket and starts that unit's copies into
//      the stage, so its loads are in flight through steps 3-5;
//   3. walks the chunk from h = 0 for the pair (A, Bc): A the product of
//      its a_t, Bc its h;
//   4. waits for chunk c - 1's finished carry H_{c-1} (0 for c = 0),
//      forms H_c = A H_{c-1} + Bc and publishes it before its own walk, so
//      a hop of the chain is one FMA and a publish;
//   5. walks the chunk again from H_{c-1}, from registers, and stores h.
// A carry is one 64-bit word per (b, chunk, channel): the float's bits
// below, the tag c + 1 above, stored with one 64-bit store and polled with
// ld.relaxed.gpu, which reads L2 (L1 is not coherent across SMs), so the
// value and its flag arrive together and the chain needs no block barrier.
// The launcher zeroes the words and the ticket on the stream first, so a
// call never reads an earlier call's tags.  A poll that waits about a
// second traps, so a broken chain fails the launch and cannot hang the card.
//
// Why it repeats bitwise.  A decoupled look-back would compose the
// aggregates of unfinished predecessors, and which path it takes depends
// on timing; the two paths round differently.  The chain has one order,
// that of the three-launch design this kernel replaced: each chunk's
// (A, Bc) from h = 0 (its chunk kernel), H_c = A H_{c-1} + Bc from c = 0
// with H_{-1} = 0 (its carry kernel), then each chunk rerun from H_{c-1}
// (its apply kernel).  The multiply-adds nvcc contracted there, a * h + b
// and A * H + Bc, are written here as the same __fmaf_rn, so the two
// designs agree bit for bit (rglru_check --parent compares them); expf
// and sqrtf are the accurate ones (never --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;      // positions per chunk (rglru_scan.py CHUNK)
constexpr int kThreads = 128;   // channels per block (rglru_scan.py TILE)
constexpr int kMinBlocks = 3;   // blocks an SM holds: <= 170 registers
constexpr uint32_t kMaxPolls = 1u << 24;   // then trap: the chain is broken
// the shared-memory stage of one unit: [log_a, x][kChunk][kThreads] floats
constexpr int kStageBytes = 2 * kChunk * kThreads * sizeof(float);

__device__ __forceinline__ float rglru_a(float la) { return expf(la); }

__device__ __forceinline__ float rglru_b(float la, float x) {
  return sqrtf(fmaxf(1.f - expf(2.f * la), 0.f)) * x;
}

// a carry word, read from L2 at gpu scope
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

__device__ __forceinline__ Unit unit_of(unsigned ticket, int B, int S,
                                        int W) {
  const int tiles = (W + kThreads - 1) / kThreads;
  const unsigned per_chunk = static_cast<unsigned>(B) * tiles;
  Unit u;
  u.c = static_cast<int>(ticket / per_chunk);               // chunk-major
  const int rest = static_cast<int>(ticket - u.c * per_chunk);
  u.b = rest / tiles;
  u.w = (rest - u.b * tiles) * kThreads + threadIdx.x;
  const int t0 = u.c * kChunk;
  u.n = min(kChunk, S - t0);
  u.base = (static_cast<size_t>(u.b) * S + t0) * W + u.w;
  return u;
}

// start the copies of this thread's column of a unit into the stage
__device__ __forceinline__ void prefetch(const Unit& u, float* col,
                                         const float* __restrict__ x,
                                         const float* __restrict__ log_a,
                                         int W) {
  if (u.w >= W) return;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (j < u.n) {
      const size_t i = u.base + static_cast<size_t>(j) * W;
      cp_async4(col + j * kThreads, log_a + i);
      cp_async4(col + (kChunk + j) * kThreads, x + i);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
rglru_scan_kernel(const float* __restrict__ x,
                  const float* __restrict__ log_a, float* __restrict__ out,
                  uint64_t* __restrict__ carry, unsigned* __restrict__ ticket,
                  int B, int S, int W, int NC, unsigned units) {
  extern __shared__ float stage[];
  __shared__ unsigned s_ticket[2];
  float* col = stage + threadIdx.x;         // this thread's column
  if (threadIdx.x == 0) s_ticket[0] = atomicAdd(ticket, 1u);
  __syncthreads();
  unsigned mine = s_ticket[0];
  if (mine >= units) return;                // block-uniform
  prefetch(unit_of(mine, B, S, W), col, x, log_a, W);

  for (int round = 1;; ++round) {
    const Unit u = unit_of(mine, B, S, W);
    cp_async_wait_all();
    float a[kChunk], bx[kChunk];   // log_a and x, then a_t and b_t
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      a[j] = j < u.n ? col[j * kThreads] : 0.f;
      bx[j] = j < u.n ? col[(kChunk + j) * kThreads] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float la = a[j];
      a[j] = rglru_a(la);
      bx[j] = rglru_b(la, bx[j]);
    }

    // the next unit's loads fly while this one runs (the stage's values
    // are all in registers and used above)
    if (threadIdx.x == 0) s_ticket[round & 1] = atomicAdd(ticket, 1u);
    __syncthreads();
    const unsigned next = s_ticket[round & 1];
    if (next < units) prefetch(unit_of(next, B, S, W), col, x, log_a, W);

    if (u.w < W) {
      float A = 1.f, Bc = 0.f;     // the chunk's pair from h = 0
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < u.n) {
          Bc = __fmaf_rn(a[j], Bc, bx[j]);
          A = __fmul_rn(A, a[j]);
        }
      }

      const int c = u.c;
      const size_t cw = static_cast<size_t>(u.b) * NC * W + u.w;  // chunk 0
      const int p = c - 1;                  // the predecessor chunk
      float hin = 0.f;
      if (p >= 0) {
        const uint64_t* src = carry + cw + static_cast<size_t>(p) * W;
        uint64_t word = poll(src);
        for (uint32_t tries = 0; static_cast<int>(word >> 32) != p + 1;
             ++tries) {
          if (tries == kMaxPolls) __trap();
          __nanosleep(64);
          word = poll(src);
        }
        hin = __uint_as_float(static_cast<uint32_t>(word));
      }
      publish(carry + cw + static_cast<size_t>(c) * W,
              (static_cast<uint64_t>(c + 1) << 32) |
                  __float_as_uint(__fmaf_rn(A, hin, Bc)));

      float h = hin;
      const size_t base = u.base;
      const int n = u.n;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < n) {
          h = __fmaf_rn(a[j], h, bx[j]);
          __stcs(out + base + static_cast<size_t>(j) * W, h);
        }
      }
    }
    if (next >= units) break;               // block-uniform
    mine = next;
  }
}

// blocks of rglru_scan_kernel the card holds at once, per device; set up
// (the dynamic shared-memory limit raised) on a device's first call, so a
// call inside a CUDA graph capture makes no attribute call
int resident_blocks(int* out) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return 0;
  }
  err = cudaFuncSetAttribute(rglru_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStageBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rglru_scan_kernel, kThreads, kStageBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < 64) cached[dev] = *out;
  return 0;
}

}  // namespace

extern "C" {

// x, log_a, h: (B, S, W) float32, contiguous; carry: scratch of
// B * ceil(S / kChunk) * W + 1 64-bit words (the last holds the ticket),
// zeroed here on the stream.  B * ceil(S / kChunk) * ceil(W / kThreads)
// must be below 2^31 (kernels/rglru_scan.py checks).  Returns the
// cudaError_t of the first call that fails, else of the launch.
int rglru_scan_launch(const float* x, const float* log_a, float* h,
                      void* carry, int B, int S, int W, void* stream) {
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
  rglru_scan_kernel<<<grid, kThreads, kStageBytes, st>>>(
      x, log_a, h, words_p, reinterpret_cast<unsigned*>(words_p + words), B,
      S, W, NC, static_cast<unsigned>(units));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
