// pac_eval — §5.1 per-row PAC evaluation on boolean rank-space tiles.
//
// Replaces the Pallas TPU kernel repro/kernels/pac_eval.py:_pac_kernel
// (wrapper pac_eval, pallas_call at :64).  Inputs are (R, n_pad) bool
// tiles in succession-rank space (R = trials * partitions): up[r, i] is
// whether the node at rank i of row r's succession list is up, full[r, i]
// whether it holds the latest copy.  Columns >= n_real are padding.
// Outputs, per row:
//   lark  = cluster majority up  AND  some first-rf lane up
//           AND  some latest-copy holder up
//   maj   = majority of the first `voters` lanes up (the 2f+1 baseline)
//   creps = the first rf up lanes (cumsum rank <= rf) — the refreshed
//           holder mask; padding columns write 0.
//
// Bound: bytes.  Each row is read once (2 * n_pad bytes) and written once
// (n_pad + 2 bytes); the arithmetic is a handful of integer ops per byte.
// Design: one warp per row.  The warp walks the row in 32-column chunks;
// each lane loads one byte of up and full (32 consecutive bytes per warp,
// one sector), __ballot_sync turns the chunk into a 32-bit word, __popc
// of the word (under prefix masks) gives the up, roster and voter counts,
// and a lane's cumsum rank is running + popc(word & lanemask_lt) + 1.
// Nothing is staged in shared memory: every byte is touched exactly once.
// All integer and bit math: the result is exact, held bitwise against the
// plain PyTorch version.  The reference pads n to 128 lanes for the TPU's
// vector unit; this kernel takes n_pad as it is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // 8 warps = 8 rows per block

__device__ __forceinline__ unsigned prefix_mask(int count, int base) {
  // bits of the 32-lane chunk starting at column `base` that lie below
  // column `count`
  const int bits = count - base;
  if (bits <= 0) return 0u;
  if (bits >= 32) return 0xFFFFFFFFu;
  return (1u << bits) - 1u;
}

__global__ void __launch_bounds__(kThreads)
pac_eval_kernel(const uint8_t* __restrict__ up,
                const uint8_t* __restrict__ full,
                uint8_t* __restrict__ lark, uint8_t* __restrict__ maj,
                uint8_t* __restrict__ creps, int R, int n_pad, int n_real,
                int rf, int voters) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= R) return;                     // warp-uniform
  const long long base = (long long)row * n_pad;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  int n_up = 0, n_roster = 0, n_voter = 0;
  bool full_up = false;
  for (int c0 = 0; c0 < n_pad; c0 += 32) {
    const int col = c0 + lane;
    bool u = false, f = false;
    if (col < n_real) {                     // n_real <= n_pad
      u = up[base + col] != 0;
      f = full[base + col] != 0;
    }
    const unsigned word = __ballot_sync(0xFFFFFFFFu, u);
    const unsigned both = __ballot_sync(0xFFFFFFFFu, u && f);
    const int rank = n_up + __popc(word & lanemask_lt) + 1;
    if (col < n_pad) creps[base + col] = (u && rank <= rf) ? 1 : 0;
    n_up += __popc(word);
    n_roster += __popc(word & prefix_mask(rf, c0));
    n_voter += __popc(word & prefix_mask(voters, c0));
    full_up = full_up || both != 0u;
  }
  if (lane == 0) {
    lark[row] = (2 * n_up > n_real && n_roster > 0 && full_up) ? 1 : 0;
    maj[row] = (2 * n_voter > voters) ? 1 : 0;
  }
}

}  // namespace

extern "C" int pac_eval_launch(const void* up, const void* full, void* lark,
                               void* maj, void* creps, int R, int n_pad,
                               int n_real, int rf, int voters,
                               void* stream) {
  if (R <= 0) return 0;
  const int rows_per_block = kThreads / 32;
  const int blocks = (R + rows_per_block - 1) / rows_per_block;
  pac_eval_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)up, (const uint8_t*)full, (uint8_t*)lark,
      (uint8_t*)maj, (uint8_t*)creps, R, n_pad, n_real, rf, voters);
  return (int)cudaGetLastError();
}
