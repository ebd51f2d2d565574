// downtime_eval — §6 per-row evaluation on boolean rank-space tiles,
// plain and roster variants.
//
// Replaces the Pallas TPU kernels of repro/kernels/pac_eval.py:
// _downtime_kernel (:87) and _downtime_roster_kernel (:131), both called
// by downtime_eval (pallas_call at :405).  Inputs are (R, n_pad) bool
// tiles in succession-rank space (R = trials * partitions); columns
// >= n_real are padding.  Outputs, per row:
//   lark   = cluster majority up AND some first-rf lane up AND some
//            latest-copy holder up (PAC; the first rf lanes even in the
//            roster variant, as the reference)
//   nrep   = up count of the replica set: the first rf lanes, or the
//            roster's rf ranks (a rank outside [0, n_real) reads as down);
//            qmaj = 2 * nrep > rf
//   leader = lowest up rank (n_real when none is up); lfull = that lane's
//            latest-copy bit
//   repmask (optional) = bit j set iff lane j < rf is up
//   rleader (optional, roster only) = lowest up roster rank, n_real when
//            none
//   creps  = the first rf up lanes (the refreshed holder mask)
//
// Bound: bytes.  Each row is read once (2 * n_pad bytes, + 4 * rf roster
// bytes) and written once (n_pad + 11 bytes, + 4 per extra); the
// arithmetic is a few integer ops per byte.
// Design: one warp per row, as pac_eval.cu.  Each 32-column chunk becomes
// a word by __ballot_sync (up, and up & full); __popc of the word under
// prefix masks gives the up count and the first-rf count, __ffs of the
// first non-zero word gives the leader, and a lane's cumsum rank is
// running + popc(word & lanemask_lt) + 1.  The roster variant has lanes
// j < rf read rank roster[row, j] and its up byte (the row was just read,
// so the byte comes from L1), then reduces count and minimum over the warp
// with __reduce_add_sync / __reduce_min_sync.  The reference's 128-lane
// node and roster padding is TPU layout and is not carried over.  Integer
// and bit math only: exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // 8 warps = 8 rows per block

__device__ __forceinline__ unsigned prefix_mask(int count, int base) {
  const int bits = count - base;
  if (bits <= 0) return 0u;
  if (bits >= 32) return 0xFFFFFFFFu;
  return (1u << bits) - 1u;
}

template <bool kRoster>
__global__ void __launch_bounds__(kThreads)
downtime_eval_kernel(const uint8_t* __restrict__ up,
                     const uint8_t* __restrict__ full,
                     const int32_t* __restrict__ roster,
                     uint8_t* __restrict__ lark, uint8_t* __restrict__ qmaj,
                     int32_t* __restrict__ leader,
                     uint8_t* __restrict__ lfull,
                     int32_t* __restrict__ nrep,
                     int32_t* __restrict__ repmask,
                     int32_t* __restrict__ rleader,
                     uint8_t* __restrict__ creps, int R, int n_pad,
                     int n_real, int rf) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= R) return;                     // warp-uniform
  const long long base = (long long)row * n_pad;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  int n_up = 0, n_first = 0, ldr = -1;
  bool full_up = false, ldr_full = false;
  unsigned first_word = 0u;
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
    if (c0 == 0) first_word = word;
    if (ldr < 0 && word != 0u) {            // warp-uniform
      const int bit = __ffs(word) - 1;
      ldr = c0 + bit;
      ldr_full = ((both >> bit) & 1u) != 0u;
    }
    n_up += __popc(word);
    n_first += __popc(word & prefix_mask(rf, c0));
    full_up = full_up || both != 0u;
  }
  int n_rep = n_first, r_lead = n_real;
  if (kRoster) {
    int cnt = 0, lo = n_real;
    for (int j = lane; j < rf; j += 32) {
      const int r = roster[(long long)row * rf + j];
      if (r >= 0 && r < n_real && up[base + r] != 0) {
        ++cnt;
        lo = min(lo, r);
      }
    }
    n_rep = (int)__reduce_add_sync(0xFFFFFFFFu, (unsigned)cnt);
    r_lead = __reduce_min_sync(0xFFFFFFFFu, lo);
  }
  if (lane == 0) {
    lark[row] = (2 * n_up > n_real && n_first > 0 && full_up) ? 1 : 0;
    qmaj[row] = (2 * n_rep > rf) ? 1 : 0;
    nrep[row] = n_rep;
    leader[row] = ldr < 0 ? n_real : min(ldr, n_real);
    lfull[row] = (ldr >= 0 && ldr_full) ? 1 : 0;
    if (repmask != nullptr)                 // rf <= 30, checked by caller
      repmask[row] = (int32_t)(first_word & ((1u << rf) - 1u));
    if (kRoster && rleader != nullptr) rleader[row] = r_lead;
  }
}

template <bool kRoster>
int launch(const void* up, const void* full, const void* roster,
           void* lark, void* qmaj, void* leader, void* lfull, void* nrep,
           void* repmask, void* rleader, void* creps, int R, int n_pad,
           int n_real, int rf, void* stream) {
  if (R <= 0) return 0;
  const int rows_per_block = kThreads / 32;
  const int blocks = (R + rows_per_block - 1) / rows_per_block;
  downtime_eval_kernel<kRoster><<<blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
      (const uint8_t*)up, (const uint8_t*)full, (const int32_t*)roster,
      (uint8_t*)lark, (uint8_t*)qmaj, (int32_t*)leader, (uint8_t*)lfull,
      (int32_t*)nrep, (int32_t*)repmask, (int32_t*)rleader,
      (uint8_t*)creps, R, n_pad, n_real, rf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int downtime_eval_launch(const void* up, const void* full,
                                    const void* roster, void* lark,
                                    void* qmaj, void* leader, void* lfull,
                                    void* nrep, void* repmask,
                                    void* rleader, void* creps, int R,
                                    int n_pad, int n_real, int rf,
                                    void* stream) {
  return launch<false>(up, full, roster, lark, qmaj, leader, lfull, nrep,
                       repmask, rleader, creps, R, n_pad, n_real, rf,
                       stream);
}

extern "C" int downtime_roster_launch(const void* up, const void* full,
                                      const void* roster, void* lark,
                                      void* qmaj, void* leader, void* lfull,
                                      void* nrep, void* repmask,
                                      void* rleader, void* creps, int R,
                                      int n_pad, int n_real, int rf,
                                      void* stream) {
  return launch<true>(up, full, roster, lark, qmaj, leader, lfull, nrep,
                      repmask, rleader, creps, R, n_pad, n_real, rf,
                      stream);
}
