// fused_pac_eval — §5.1 PAC evaluation on bit-packed cluster state.
//
// Replaces the Pallas TPU kernel
// repro/kernels/fused_step.py:_fused_pac_kernel (wrapper fused_pac_eval,
// pallas_call at :88), which runs repro/kernels/bitpack.py's
// pac_eval_packed on (block_t, W, block_p) tiles.  State is (B, W, P)
// 32-bit words (carried as int32 by the port): bit b of word k of
// (trial t, partition p) is succession rank 32k+b.  Outputs: lark and
// maj (B, P) bool and the refreshed holder words crepsw (B, W, P) — the
// packed image of pac_eval, bit for bit.
//
// Bound: bytes.  Each thread reads 2W words and writes W words + 2 bytes;
// per word it does a few popcounts and masks.
// Design: one thread per (trial, partition).  Word k of neighbouring
// partitions sits at neighbouring addresses (stride P between words), so
// each load and store of a warp is one coalesced 128-byte line.  Prefix
// masks are built from n_real, rf and voters in registers (the TPU kernel
// folds them in as constants).  The reference's rf rounds of
// lowest-set-bit extraction become one walk over the words in order that
// keeps the lowest `remaining` set bits of each word — the same bits, in
// one pass, with no per-word arrays.  Integer math only: exact.

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
fused_pac_eval_kernel(const uint32_t* __restrict__ upw,
                      const uint32_t* __restrict__ fullw,
                      uint8_t* __restrict__ lark, uint8_t* __restrict__ maj,
                      uint32_t* __restrict__ crepsw, int B, int W, int P,
                      int n_real, int rf, int voters) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)B * P) return;
  const long long b = idx / P;
  const long long p = idx - b * P;
  const long long base = b * W * P + p;
  int n_up = 0, n_voter = 0, remaining = rf;
  bool any_roster = false, full_up = false;
  for (int k = 0; k < W; ++k) {
    const int lo = 32 * k;
    const uint32_t real = prefix_mask(n_real, lo);
    const uint32_t u = upw[base + (long long)k * P] & real;
    const uint32_t f = fullw[base + (long long)k * P] & real;
    n_up += __popc(u);
    n_voter += __popc(u & prefix_mask(voters, lo));
    any_roster = any_roster || (u & prefix_mask(rf, lo)) != 0u;
    full_up = full_up || (u & f) != 0u;
    uint32_t keep = 0u, v = u;
    while (remaining > 0 && v != 0u) {      // lowest set bits, lane order
      keep |= v & (0u - v);
      v &= v - 1u;
      --remaining;
    }
    crepsw[base + (long long)k * P] = keep;
  }
  lark[idx] = (2 * n_up > n_real && any_roster && full_up) ? 1 : 0;
  maj[idx] = (2 * n_voter > voters) ? 1 : 0;
}

}  // namespace

extern "C" int fused_pac_eval_launch(const void* upw, const void* fullw,
                                     void* lark, void* maj, void* crepsw,
                                     int B, int W, int P, int n_real, int rf,
                                     int voters, void* stream) {
  const long long total = (long long)B * P;
  if (total <= 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  fused_pac_eval_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)upw, (const uint32_t*)fullw, (uint8_t*)lark,
      (uint8_t*)maj, (uint32_t*)crepsw, B, W, P, n_real, rf, voters);
  return (int)cudaGetLastError();
}
