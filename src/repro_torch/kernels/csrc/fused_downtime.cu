// fused_downtime_eval and fused_pac_eval — the §6 and the §5.1
// per-step evaluations on bit-packed cluster state, the §6 one with the
// roster select and the in-flight node counts fused in; one kernel body,
// templated on its mode.
//
// Replaces the Pallas TPU kernels repro/kernels/fused_step.py:
// _fused_downtime_kernel (:121) with its _node_count_block (:102)
// (wrapper fused_downtime_eval, pallas_call at :245), which runs
// repro/kernels/bitpack.py's downtime_eval_packed on (block_t, W,
// block_p) tiles, and _fused_pac_kernel (:62; wrapper fused_pac_eval,
// pallas_call at :88), which runs bitpack.pac_eval_packed on them.  State
// is (B, W, P) 32-bit words (carried as int32 by the port): bit b of word
// k of (trial t, partition p) is succession rank 32k+b.
// The downtime mode writes, each (B, P): lark, qmaj, leader, lfull, nrep,
// then repmask and rleader when asked for, the refreshed holder words
// crepsw (B, W, P), and, when recruit/active are given, the per-(trial,
// node) in-flight counts (B, n_real), zeroed by the caller.  Rosters are
// read as the engine carries them, (B, P, rf) int32.  The pac mode writes
// lark and maj (B, P) and crepsw: the packed image of pac_eval, bit for
// bit.
//
// Bound: bytes.  Each thread reads 2W words (+ rf roster ranks, a recruit
// id and an active byte) and writes W words + 11 bytes (+ 4 per extra):
// 12 B W P + 11 B P (+ 4 B P rf + 5 B P + 4 B n_real) bytes, 2,757,472
// with an rf = 2 roster and the counts at the paper tile (B = 8, W = 5,
// P = 4096), 0.82 us at 3.35 TB/s; the pac mode 12 B W P + 2 B P,
// 2,031,616 bytes, 0.61 us.  Per word it does a few popcounts and masks.
// So a launch is its latency: the grid's ramp and one chain of dependent
// memory round trips per thread.
// Design: one thread per (trial, partition): word k of neighbouring
// partitions is contiguous, so loads and stores coalesce.  The kernel is
// templated on the mode (pac / downtime), so each instantiation carries
// only its own work (the pac mode loads no roster, recruit or active and
// counts nothing), and on W for 1 <= W <= 8 (n <= 256): a thread issues
// every load it needs before any arithmetic that depends on one — its 2W
// words into register arrays, its roster ranks (one int2 at rf = 2 where
// aligned, else the first kSeats as separate loads), its recruit id and
// active byte — so the whole thread waits on one round trip.  A roster
// rank r selects bit r & 31 of register word r >> 5 by an unrolled
// compare-select over the W words, and reads 0 outside [0, n_real), as
// bitpack.select_bit does on masked words.  W > 8 walks the words in a
// loop (the generic instantiation), reading a roster rank's word from
// global memory.  The leader is 32k + __ffs(w) - 1 of the first non-zero
// word, its latest-copy bit that bit of the full word.  The creps walk
// keeps the lowest `remaining` set bits of each word in order: the
// reference's rf rounds of lowest-set-bit extraction in one pass.  The
// pac mode counts the up lanes below `voters` (which may cross a word and
// pass n_real: padding reads as down) beside the lanes below rf.  The
// counts: the grid's y axis is the trial, so every block's partitions
// belong to one trial; the lanes of a warp that count the same node find
// each other with __match_any_sync, and the lowest of them adds their
// number with one global atomicAdd — the CUDA form of the reference's
// accumulation across the partition tiles of a trial block.  No shared
// histogram: its zeroing, two barriers and flush took 0.51 us of a
// 2.60 us launch at the paper tile on an H100 (kernels/mc_check.py
// --ablate).  Integer math and commuting integer atomics only: exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSeats = 4;   // roster ranks loaded up front

__device__ __forceinline__ uint32_t prefix_mask(int count, int base) {
  const int bits = count - base;
  if (bits <= 0) return 0u;
  if (bits >= 32) return 0xFFFFFFFFu;
  return (1u << bits) - 1u;
}

// the per-(trial, partition) outputs of one launch
struct Outs {
  uint8_t* lark;
  uint8_t* qmaj;      // the pac mode's maj

  int32_t* leader;
  uint8_t* lfull;
  int32_t* nrep;
  int32_t* repmask;   // optional
  int32_t* rleader;   // optional, roster only
  uint32_t* crepsw;
};

// the lowest `remaining` set bits of u, lowest first; remaining counts down
__device__ __forceinline__ uint32_t first_set(uint32_t u, int& remaining) {
  uint32_t keep = 0u;
  while (remaining > 0 && u != 0u) {
    keep |= u & (0u - u);
    u &= u - 1u;
    --remaining;
  }
  return keep;
}

__device__ __forceinline__ void store_row(const Outs& o, long long row,
                                          int n_up, int n_first, int n_rep,
                                          bool full_up, int ldr,
                                          bool ldr_full, uint32_t first_word,
                                          int lo_rank, int n_real, int rf) {
  o.lark[row] = (2 * n_up > n_real && n_first > 0 && full_up) ? 1 : 0;
  o.qmaj[row] = (2 * n_rep > rf) ? 1 : 0;
  o.nrep[row] = n_rep;
  o.leader[row] = ldr < 0 ? n_real : ldr;
  o.lfull[row] = (ldr >= 0 && ldr_full) ? 1 : 0;
  if (o.repmask != nullptr)               // rf <= 30, checked by caller
    o.repmask[row] = static_cast<int32_t>(first_word & ((1u << rf) - 1u));
  if (o.rleader != nullptr) o.rleader[row] = lo_rank;
}

__device__ __forceinline__ void store_pac(const Outs& o, long long row,
                                          int n_up, int n_first, int n_vote,
                                          bool full_up, int n_real,
                                          int voters) {
  o.lark[row] = (2 * n_up > n_real && n_first > 0 && full_up) ? 1 : 0;
  o.qmaj[row] = (2 * n_vote > voters) ? 1 : 0;
}

// One (trial, partition) with its kW words in registers; returns the node
// this row adds to the counts, or -1 (always in the pac mode).
template <int kW, bool kPac>
__device__ __forceinline__ int eval_registers(
    const uint32_t* __restrict__ upw, const uint32_t* __restrict__ fullw,
    const int32_t* __restrict__ roster, const int32_t* __restrict__ recruit,
    const uint8_t* __restrict__ active, bool counting, const Outs& o,
    long long b, int p, int P, int n_real, int rf, int voters) {
  const long long row = b * P + p;
  const long long base = b * kW * P + p;
  uint32_t u[kW], f[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    u[k] = __ldg(upw + base + static_cast<long long>(k) * P);
    f[k] = __ldg(fullw + base + static_cast<long long>(k) * P);
  }
  const int32_t* seats =
      (!kPac && roster != nullptr) ? roster + row * rf : nullptr;
  int seat[kSeats];                         // -1 (reads down) past rf
  if (seats != nullptr && rf == 2 &&
      (reinterpret_cast<uintptr_t>(seats) & 7) == 0) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(seats));
    seat[0] = v.x;
    seat[1] = v.y;
#pragma unroll
    for (int j = 2; j < kSeats; ++j) seat[j] = -1;
  } else {
#pragma unroll
    for (int j = 0; j < kSeats; ++j)
      seat[j] = (seats != nullptr && j < rf) ? __ldg(seats + j) : -1;
  }
  int rc = -1;
  bool act = false;
  if (!kPac && counting) {
    rc = __ldg(recruit + row);
    act = active[row] != 0;
  }

  int n_up = 0, n_first = 0, n_vote = 0, ldr = -1, remaining = rf;
  bool full_up = false, ldr_full = false;
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    u[k] &= prefix_mask(n_real, 32 * k);
    n_up += __popc(u[k]);
    n_first += __popc(u[k] & prefix_mask(rf, 32 * k));
    full_up = full_up || (u[k] & f[k]) != 0u;
    if constexpr (kPac) {
      n_vote += __popc(u[k] & prefix_mask(voters, 32 * k));
    } else if (ldr < 0 && u[k] != 0u) {
      const int bit = __ffs(u[k]) - 1;
      ldr = 32 * k + bit;
      ldr_full = ((f[k] >> bit) & 1u) != 0u;
    }
    o.crepsw[base + static_cast<long long>(k) * P] = first_set(u[k],
                                                               remaining);
  }
  if constexpr (kPac) {
    store_pac(o, row, n_up, n_first, n_vote, full_up, n_real, voters);
    return -1;
  }
  int n_rep = n_first, lo_rank = n_real;
  if (seats != nullptr) {
    n_rep = 0;
    auto take = [&](int r) {                // bit r of the words in u
      if (r < 0 || r >= n_real) return;     // out of range: reads down
      const int wi = r >> 5;
      uint32_t w = 0u;
#pragma unroll
      for (int k = 0; k < kW; ++k) w = k == wi ? u[k] : w;
      if ((w >> (r & 31)) & 1u) {
        ++n_rep;
        lo_rank = min(lo_rank, r);
      }
    };
#pragma unroll
    for (int j = 0; j < kSeats; ++j) take(seat[j]);
    for (int j = kSeats; j < rf; ++j) take(__ldg(seats + j));
  }
  store_row(o, row, n_up, n_first, n_rep, full_up, ldr, ldr_full, u[0],
            lo_rank, n_real, rf);
  return (act && rc >= 0 && rc < n_real) ? rc : -1;
}

// The same for any W, the words walked in a loop and a roster rank's word
// read from global memory.
template <bool kPac>
__device__ __forceinline__ int eval_loop(
    const uint32_t* __restrict__ upw, const uint32_t* __restrict__ fullw,
    const int32_t* __restrict__ roster, const int32_t* __restrict__ recruit,
    const uint8_t* __restrict__ active, bool counting, const Outs& o,
    long long b, int p, int W, int P, int n_real, int rf, int voters) {
  const long long row = b * P + p;
  const long long ws = P;                   // word stride
  const long long base = b * W * ws + p;
  int n_up = 0, n_first = 0, n_vote = 0, ldr = -1, remaining = rf;
  bool full_up = false, ldr_full = false;
  uint32_t first_word = 0u;
  for (int k = 0; k < W; ++k) {
    const int lo = 32 * k;
    const uint32_t u = upw[base + k * ws] & prefix_mask(n_real, lo);
    const uint32_t f = fullw[base + k * ws];
    if (k == 0) first_word = u;
    n_up += __popc(u);
    n_first += __popc(u & prefix_mask(rf, lo));
    full_up = full_up || (u & f) != 0u;
    if constexpr (kPac) {
      n_vote += __popc(u & prefix_mask(voters, lo));
    } else if (ldr < 0 && u != 0u) {
      const int bit = __ffs(u) - 1;
      ldr = lo + bit;
      ldr_full = ((f >> bit) & 1u) != 0u;
    }
    o.crepsw[base + k * ws] = first_set(u, remaining);
  }
  if constexpr (kPac) {
    store_pac(o, row, n_up, n_first, n_vote, full_up, n_real, voters);
    return -1;
  }
  int n_rep = n_first, lo_rank = n_real;
  if (roster != nullptr) {
    n_rep = 0;
    for (int j = 0; j < rf; ++j) {
      const int r = roster[row * rf + j];
      if (r >= 0 && r < n_real &&
          ((upw[base + (r >> 5) * ws] >> (r & 31)) & 1u)) {
        ++n_rep;
        lo_rank = min(lo_rank, r);
      }
    }
  }
  store_row(o, row, n_up, n_first, n_rep, full_up, ldr, ldr_full,
            first_word, lo_rank, n_real, rf);
  const int rc = counting ? recruit[row] : -1;
  return (counting && active[row] != 0 && rc >= 0 && rc < n_real) ? rc : -1;
}

// kW: words per (trial, partition) held in registers, 0 walks W in a
// loop; kPac: the pac mode (voters used), else the downtime mode
template <int kW, bool kPac>
__global__ void __launch_bounds__(kThreads)
fused_downtime_kernel(const uint32_t* __restrict__ upw,
                      const uint32_t* __restrict__ fullw,
                      const int32_t* __restrict__ roster,
                      const int32_t* __restrict__ recruit,
                      const uint8_t* __restrict__ active, Outs o,
                      int32_t* __restrict__ cnt, int W, int P, int n_real,
                      int rf, int voters) {
  const long long b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool counting = !kPac && cnt != nullptr;   // block-uniform
  int node = -1;                            // the node this row counts
  if (p < P) {
    if constexpr (kW > 0)
      node = eval_registers<kW, kPac>(upw, fullw, roster, recruit, active,
                                      counting, o, b, p, P, n_real, rf,
                                      voters);
    else
      node = eval_loop<kPac>(upw, fullw, roster, recruit, active, counting,
                             o, b, p, W, P, n_real, rf, voters);
  }
  if (counting) {                           // every lane of the warp
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, node);
    if (node >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&cnt[b * n_real + node], __popc(peers));
  }
}

template <int kW, bool kPac>
int launch(const void* upw, const void* fullw, const void* roster,
           const void* recruit, const void* active, const Outs& o, void* cnt,
           int B, int W, int P, int n_real, int rf, int voters,
           void* stream) {
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  fused_downtime_kernel<kW, kPac><<<grid, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(upw), static_cast<const uint32_t*>(fullw),
      static_cast<const int32_t*>(roster),
      static_cast<const int32_t*>(recruit),
      static_cast<const uint8_t*>(active), o, static_cast<int32_t*>(cnt), W,
      P, n_real, rf, voters);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for W: registers for W <= 8, else the loop
template <bool kPac>
int dispatch(const void* upw, const void* fullw, const void* roster,
             const void* recruit, const void* active, const Outs& o,
             void* cnt, int B, int W, int P, int n_real, int rf, int voters,
             void* stream) {
  if (B <= 0 || P <= 0) return 0;
  switch (W) {
#define FDT_CASE(w)                                                         \
  case w:                                                                   \
    return launch<w, kPac>(upw, fullw, roster, recruit, active, o, cnt, B,  \
                           W, P, n_real, rf, voters, stream);
    FDT_CASE(1) FDT_CASE(2) FDT_CASE(3) FDT_CASE(4)
    FDT_CASE(5) FDT_CASE(6) FDT_CASE(7) FDT_CASE(8)
#undef FDT_CASE
    default:
      return launch<0, kPac>(upw, fullw, roster, recruit, active, o, cnt, B,
                             W, P, n_real, rf, voters, stream);
  }
}

}  // namespace

extern "C" int fused_downtime_eval_launch(
    const void* upw, const void* fullw, const void* roster,
    const void* recruit, const void* active, void* lark, void* qmaj,
    void* leader, void* lfull, void* nrep, void* repmask, void* rleader,
    void* crepsw, void* cnt, int B, int W, int P, int n_real, int rf,
    void* stream) {
  const Outs o{static_cast<uint8_t*>(lark), static_cast<uint8_t*>(qmaj),
               static_cast<int32_t*>(leader), static_cast<uint8_t*>(lfull),
               static_cast<int32_t*>(nrep), static_cast<int32_t*>(repmask),
               static_cast<int32_t*>(rleader),
               static_cast<uint32_t*>(crepsw)};
  return dispatch<false>(upw, fullw, roster, recruit, active, o, cnt, B, W,
                         P, n_real, rf, rf, stream);
}

// the pac mode: lark and maj (B, P) bytes, crepsw (B, W, P) words
extern "C" int fused_pac_eval_launch(const void* upw, const void* fullw,
                                     void* lark, void* maj, void* crepsw,
                                     int B, int W, int P, int n_real, int rf,
                                     int voters, void* stream) {
  const Outs o{static_cast<uint8_t*>(lark), static_cast<uint8_t*>(maj),
               nullptr, nullptr, nullptr, nullptr, nullptr,
               static_cast<uint32_t*>(crepsw)};
  return dispatch<true>(upw, fullw, nullptr, nullptr, nullptr, o, nullptr, B,
                        W, P, n_real, rf, voters, stream);
}
