// fused_downtime_eval — the §6 per-step evaluation on bit-packed cluster
// state, with the roster select and the in-flight node counts fused in.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_step.py:
// _fused_downtime_kernel (:121) with its _node_count_block (:102)
// (wrapper fused_downtime_eval, pallas_call at :245), which runs
// repro/kernels/bitpack.py's downtime_eval_packed on (block_t, W,
// block_p) tiles.  State is (B, W, P) 32-bit words (carried as int32 by
// the port): bit b of word k of (trial t, partition p) is succession rank
// 32k+b.  Outputs, each (B, P): lark, qmaj, leader, lfull, nrep, then
// repmask and rleader when asked for, the refreshed holder words crepsw
// (B, W, P), and, when recruit/active are given, the per-(trial, node)
// in-flight counts (B, n_real), zeroed by the caller.  Rosters are read
// as the engine carries them, (B, P, rf) int32.
//
// Bound: bytes.  Each thread reads 2W words (+ rf roster ranks, a recruit
// id and an active byte) and writes W words + 11 bytes (+ 4 per extra);
// per word it does a few popcounts and masks.
// Design: one thread per (trial, partition), as fused_step.cu: word k of
// neighbouring partitions is contiguous, so loads and stores coalesce.
// The leader is 32k + __ffs(w) - 1 of the first non-zero word, its
// latest-copy bit that bit of the full word.  A roster rank r selects bit
// r & 31 of word r >> 5 (re-read from global memory, where L1 holds it),
// and reads 0 outside [0, n_real), as bitpack.select_bit does on masked
// words.  The creps walk keeps the lowest `remaining` set bits of each
// word in order, as fused_pac_eval.  The counts: the grid's y axis is the
// trial, so every block's partitions belong to one trial; the block fills
// an n_real-entry shared histogram with shared atomicAdds and flushes its
// non-zero entries with global atomicAdds — the CUDA form of the
// reference's accumulation across the partition tiles of a trial block.
// Integer atomics commute: exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t prefix_mask(int count, int base) {
  const int bits = count - base;
  if (bits <= 0) return 0u;
  if (bits >= 32) return 0xFFFFFFFFu;
  return (1u << bits) - 1u;
}

__global__ void __launch_bounds__(kThreads)
fused_downtime_kernel(const uint32_t* __restrict__ upw,
                      const uint32_t* __restrict__ fullw,
                      const int32_t* __restrict__ roster,
                      const int32_t* __restrict__ recruit,
                      const uint8_t* __restrict__ active,
                      uint8_t* __restrict__ lark, uint8_t* __restrict__ qmaj,
                      int32_t* __restrict__ leader,
                      uint8_t* __restrict__ lfull,
                      int32_t* __restrict__ nrep,
                      int32_t* __restrict__ repmask,
                      int32_t* __restrict__ rleader,
                      uint32_t* __restrict__ crepsw,
                      int32_t* __restrict__ cnt, int W, int P, int n_real,
                      int rf) {
  extern __shared__ int hist[];
  const long long b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (cnt != nullptr) {                     // block-uniform
    for (int i = threadIdx.x; i < n_real; i += kThreads) hist[i] = 0;
    __syncthreads();
  }
  if (p < P) {
    const long long row = b * P + p;
    const long long base = b * W * P + p;
    int n_up = 0, n_first = 0, ldr = -1, remaining = rf;
    bool full_up = false, ldr_full = false;
    uint32_t first_word = 0u;
    for (int k = 0; k < W; ++k) {
      const int lo = 32 * k;
      const uint32_t real = prefix_mask(n_real, lo);
      const uint32_t u = upw[base + (long long)k * P] & real;
      const uint32_t f = fullw[base + (long long)k * P] & real;
      if (k == 0) first_word = u;
      n_up += __popc(u);
      n_first += __popc(u & prefix_mask(rf, lo));
      full_up = full_up || (u & f) != 0u;
      if (ldr < 0 && u != 0u) {
        const int bit = __ffs(u) - 1;
        ldr = lo + bit;
        ldr_full = ((f >> bit) & 1u) != 0u;
      }
      uint32_t keep = 0u, v = u;
      while (remaining > 0 && v != 0u) {    // lowest set bits, lane order
        keep |= v & (0u - v);
        v &= v - 1u;
        --remaining;
      }
      crepsw[base + (long long)k * P] = keep;
    }
    int n_rep = n_first;
    if (roster != nullptr) {
      int lo_rank = n_real;
      n_rep = 0;
      for (int j = 0; j < rf; ++j) {
        const int r = roster[row * rf + j];
        if (r >= 0 && r < n_real &&
            ((upw[base + (long long)(r >> 5) * P] >> (r & 31)) & 1u)) {
          ++n_rep;
          lo_rank = min(lo_rank, r);
        }
      }
      if (rleader != nullptr) rleader[row] = lo_rank;
    }
    lark[row] = (2 * n_up > n_real && n_first > 0 && full_up) ? 1 : 0;
    qmaj[row] = (2 * n_rep > rf) ? 1 : 0;
    nrep[row] = n_rep;
    leader[row] = ldr < 0 ? n_real : ldr;
    lfull[row] = (ldr >= 0 && ldr_full) ? 1 : 0;
    if (repmask != nullptr)                 // rf <= 30, checked by caller
      repmask[row] = (int32_t)(first_word & ((1u << rf) - 1u));
    if (cnt != nullptr) {
      const int r = recruit[row];
      if (active[row] != 0 && r >= 0 && r < n_real) atomicAdd(&hist[r], 1);
    }
  }
  if (cnt != nullptr) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_real; i += kThreads)
      if (hist[i] != 0) atomicAdd(&cnt[b * n_real + i], hist[i]);
  }
}

}  // namespace

extern "C" int fused_downtime_eval_launch(
    const void* upw, const void* fullw, const void* roster,
    const void* recruit, const void* active, void* lark, void* qmaj,
    void* leader, void* lfull, void* nrep, void* repmask, void* rleader,
    void* crepsw, void* cnt, int B, int W, int P, int n_real, int rf,
    void* stream) {
  if (B <= 0 || P <= 0) return 0;
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  const size_t smem = cnt != nullptr ? n_real * sizeof(int) : 0;
  fused_downtime_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)upw, (const uint32_t*)fullw, (const int32_t*)roster,
      (const int32_t*)recruit, (const uint8_t*)active, (uint8_t*)lark,
      (uint8_t*)qmaj, (int32_t*)leader, (uint8_t*)lfull, (int32_t*)nrep,
      (int32_t*)repmask, (int32_t*)rleader, (uint32_t*)crepsw,
      (int32_t*)cnt, W, P, n_real, rf);
  return (int)cudaGetLastError();
}
